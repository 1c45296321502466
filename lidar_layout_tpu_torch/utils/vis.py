"""A self-contained HTML viewer of LiDAR clouds (vanilla JS and a canvas, no
network): orbit and zoom a cloud coloured by height or intensity.

Counterpart of ``lidar_layout_tpu/utils/vis.py`` (``save_pcd_html``,
``save_scene_grid_html``); the same inputs write the same file.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>LiDAR cloud</title><style>
 body{margin:0;background:#0b0e14;color:#ccc;font:12px monospace;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;user-select:none}
 canvas{display:block}
</style></head><body>
<div id="hud">drag: orbit &nbsp; wheel: zoom &nbsp; shift-drag: pan<br>
 __NPTS__ points</div>
<canvas id="c"></canvas>
<script>
const PTS = __POINTS__;   // [x,y,z,v] flat
const N = PTS.length / 4;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let yaw = 0.8, pitch = 0.5, dist = 80, cx = 0, cy = 0;
function resize(){ cv.width = innerWidth; cv.height = innerHeight; }
addEventListener('resize', () => { resize(); draw(); }); resize();
function turbo(t){ t = Math.min(1, Math.max(0, t));
 const r = Math.round(255*Math.min(1,Math.max(0,34.61+t*(1172.33+t*(-10793.56+t*(33300.12+t*(-38394.49+t*14825.05)))))/255));
 const g = Math.round(255*Math.min(1,Math.max(0,23.31+t*(557.33+t*(1225.33+t*(-3574.96+t*(1073.77+t*707.56)))))/255));
 const b = Math.round(255*Math.min(1,Math.max(0,27.2+t*(3211.1+t*(-15327.97+t*(27814+t*(-22569.18+t*6838.66)))))/255));
 return `rgb(${r},${g},${b})`; }
function draw(){
 ctx.fillStyle = '#0b0e14'; ctx.fillRect(0, 0, cv.width, cv.height);
 const sy = Math.sin(yaw), cyw = Math.cos(yaw), sp = Math.sin(pitch), cp = Math.cos(pitch);
 const f = cv.height * 0.9, ox = cv.width/2 + cx, oy = cv.height/2 + cy;
 for (let i = 0; i < N; i++){
  const x = PTS[4*i], y = PTS[4*i+1], z = PTS[4*i+2], v = PTS[4*i+3];
  const rx = cyw*x + sy*y, ry = -sy*x + cyw*y;
  const rz = cp*z - sp*ry, rd = sp*z + cp*ry + dist;
  if (rd < 1) continue;
  ctx.fillStyle = turbo(v);
  ctx.fillRect(ox + f*rx/rd, oy - f*rz/rd, 1.6, 1.6);
 }
}
let drag = null;
cv.onmousedown = e => drag = {x: e.clientX, y: e.clientY, shift: e.shiftKey};
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => { if (!drag) return;
 const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
 if (drag.shift){ cx += dx; cy += dy; } else { yaw += dx*0.005; pitch += dy*0.005; }
 drag.x = e.clientX; drag.y = e.clientY; draw(); });
cv.onwheel = e => { dist *= Math.exp(e.deltaY*0.001); draw(); e.preventDefault(); };
draw();
</script></body></html>"""


def save_pcd_html(path: str, points: np.ndarray,
                  values: Optional[np.ndarray] = None,
                  max_points: int = 120_000) -> str:
    """Write an interactive, dependency-free HTML viewer for a point cloud.

    points: (N, 3); values: (N,) color scalar (default: height). Returns path.
    """
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    if values is None:
        z = pts[:, 2]
        lo, hi = np.percentile(z, 2), np.percentile(z, 98)
        values = (z - lo) / max(hi - lo, 1e-6)
    v = np.clip(np.asarray(values, np.float32).reshape(-1), 0, 1)
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points,
                                              replace=False)
        pts, v = pts[sel], v[sel]
    flat = np.concatenate([pts, v[:, None]], 1).reshape(-1)
    payload = json.dumps(np.round(flat, 3).tolist())
    html = _HTML.replace("__POINTS__", payload) \
                .replace("__NPTS__", str(len(pts)))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path


def save_scene_grid_html(path: str, clouds: Sequence[np.ndarray],
                         spacing: float = 110.0, **kw) -> str:
    """Tile several clouds side by side in one viewer (sample galleries)."""
    shifted = []
    for i, c in enumerate(clouds):
        c = np.asarray(c, np.float32).reshape(-1, 3).copy()
        c[:, 0] += (i % 4) * spacing
        c[:, 1] += (i // 4) * spacing
        shifted.append(c)
    return save_pcd_html(path, np.concatenate(shifted, 0), **kw)
