"""Synthetic street scenes generated and projected on the device.

Counterpart of ``lidar_layout_tpu/data/device_synthetic.py``: the family of
scenes of ``data/synthetic.synthetic_scene`` (a ground annulus, 6-13 boxes,
poles) redrawn as surfaces, as LiDAR returns are: each box samples its
four sides and its top (area-weighted), each of 24 poles is a vertical
cylinder. Shapes are static: 14 box slots, the unused ones repainted as
ground at z = -1.88, and the points left over after the poles as ground at
z = -1.9. ``scene_image_batch`` projects a batch straight into model-space
range images and ray-drop masks, so only images leave the device.

The draws come from an explicit ``torch.Generator`` on the device, batched
over the scenes. JAX's PRNG stream cannot be matched, so a scene is of the
same family as JAX's (the same point counts and layout, the same
distributions), not the same bits. ``host_range2pcd`` is the numpy twin of
``ops.lidar.range2pcd`` for images already on the host.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..ops import lidar as L
from ..ops.lidar import KITTI_GEOMETRY, LidarGeometry

MAX_BOXES = 14
N_POLES = 24


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def _ground(gen: torch.Generator, shape, z: torch.Tensor) -> torch.Tensor:
    r = torch.sqrt(_uniform(gen, shape, 4.0, 2500.0))
    th = _uniform(gen, shape, -math.pi, math.pi)
    return torch.stack([r * torch.cos(th), r * torch.sin(th), z.expand(shape)], dim=-1)


def synthetic_scenes_device(gen: torch.Generator, batch: int,
                            n_points: int = 120000) -> torch.Tensor:
    """(batch, N, 3) float32 synthetic street scenes on the generator's device."""
    dev = gen.device
    n_ground = int(n_points * 0.6)
    per_box = int(n_points * 0.3) // MAX_BOXES
    n_pole = n_points - n_ground - per_box * MAX_BOXES

    z = -1.9 + 0.05 * torch.randn((batch, n_ground), generator=gen, device=dev)
    ground = _ground(gen, (batch, n_ground), z)

    n_box = torch.randint(6, 14, (batch, 1, 1), generator=gen, device=dev)
    centers = _uniform(gen, (batch, MAX_BOXES, 2), -40.0, 40.0)
    dims = torch.rand((batch, MAX_BOXES, 3), generator=gen, device=dev)
    lwh = torch.stack([1.5 + dims[..., 0] * 6.5, 1.5 + dims[..., 1] * 1.5,
                       1.0 + dims[..., 2] * 2.0], dim=-1)
    l, w, h = lwh[..., 0], lwh[..., 1], lwh[..., 2]
    # one of 5 visible faces (+-x, +-y, top) a point, area-weighted
    areas = torch.stack([w * h, w * h, l * h, l * h, l * w], dim=-1) + 1e-6
    face = torch.multinomial(areas.reshape(-1, 5), per_box, replacement=True,
                             generator=gen).reshape(batch, MAX_BOXES, per_box)
    u = torch.rand((batch, MAX_BOXES, per_box, 2), generator=gen, device=dev) - 0.5
    u0, u1 = u[..., 0], u[..., 1]
    half, one = torch.full_like(u0, 0.5), torch.ones_like(u0)
    fx = torch.stack([half, -half, u0, u0, u0], dim=-1)
    fy = torch.stack([u1, u1, half, -half, u1], dim=-1)
    fz = torch.stack([u0 + 0.5, u0 + 0.5, u1 + 0.5, u1 + 0.5, one], dim=-1)

    def pick(f):
        return torch.gather(f, -1, face[..., None])[..., 0]

    box_pts = torch.stack([pick(fx) * l[..., None] + centers[..., 0:1],
                           pick(fy) * w[..., None] + centers[..., 1:2],
                           -2.0 + pick(fz) * h[..., None]], dim=-1)
    fill = _ground(gen, (batch, MAX_BOXES, per_box), torch.tensor(-1.88, device=dev))
    slot_ok = (torch.arange(MAX_BOXES, device=dev)[None, :, None] < n_box)[..., None]
    boxes = torch.where(slot_ok, box_pts, fill).reshape(batch, -1, 3)

    per_pole = n_pole // N_POLES
    rest = n_pole - N_POLES * per_pole
    pole_xy = _uniform(gen, (batch, N_POLES, 1, 2), -30.0, 30.0)
    pole_h = _uniform(gen, (batch, N_POLES, 1), 2.0, 6.0)
    pole_r = _uniform(gen, (batch, N_POLES, 1), 0.08, 0.3)
    ang = _uniform(gen, (batch, N_POLES, per_pole), -math.pi, math.pi)
    zz = -2.0 + torch.rand((batch, N_POLES, per_pole), generator=gen, device=dev) * pole_h
    poles = torch.stack([pole_xy[..., 0] + pole_r * torch.cos(ang),
                         pole_xy[..., 1] + pole_r * torch.sin(ang), zz],
                        dim=-1).reshape(batch, -1, 3)
    parts = [ground, boxes, poles]
    if rest:   # round off with ground points
        parts.append(_ground(gen, (batch, rest), torch.tensor(-1.9, device=dev)))
    return torch.cat(parts, dim=1).float()


def scene_image_batch(gen: torch.Generator, batch: int, n_points: int = 120000,
                      geom: LidarGeometry = KITTI_GEOMETRY
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) model-space images and (B, H, W) {+1, -1} ray-drop masks of
    ``batch`` scenes, generated and projected on the generator's device."""
    img, _ = L.pcd2range(synthetic_scenes_device(gen, batch, n_points), geom)
    return L.process_scan(img, geom)


def host_range2pcd(img, geom: LidarGeometry = KITTI_GEOMETRY) -> np.ndarray:
    """Numpy twin of ``ops.lidar.range2pcd`` for one model-space (H, W) image:
    the (k, 3) points of its valid pixels."""
    img = np.asarray(img, np.float32)
    dirs = np.asarray(geom.ray_dirs(), np.float32)
    depth = (img * 0.5 + 0.5) * geom.depth_scale
    if geom.log_scale:
        depth = np.exp2(depth) - 1.0
    valid = (depth > geom.depth_range[0]) & (depth < geom.depth_range[1])
    xyz = dirs * depth[..., None]
    return xyz.reshape(-1, 3)[valid.reshape(-1)]
