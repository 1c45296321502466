"""Synthetic LiDAR scenes for tests, smoke runs and training without a dataset.

Counterpart of ``lidar_layout_tpu/data/synthetic.py``: street-like scans
(ground plane, random boxes, poles) drawn with numpy, with the same random
number consumption as the JAX package, then projected through the port's
``pcd2range`` and ``process_scan``; the 13-slot layouts of the
layout-conditioned LiDM; its training batches, scenes and layouts, as
the JAX package's ``data/factory._synthetic_layout_range_batch`` draws them;
and ``synthetic_latent_batch``, standard-normal latents with JAX's draws.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..ops import lidar as L
from ..ops.lidar import KITTI_GEOMETRY, LidarGeometry
from .readers import NUSC_CLASS_NAMES, build_layout13


def synthetic_scene(rng: np.random.Generator, n_points: int = 120000) -> np.ndarray:
    """(N, 3) float32 points of a synthetic street scene (the same geometry
    as ``synthetic_scene_labeled`` for the same generator state)."""
    return synthetic_scene_labeled(rng, n_points)[0]


def synthetic_scene_labeled(rng: np.random.Generator, n_points: int = 120000
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 3) points and (N,) int32 labels (0 ground, 1 box, 2 pole)."""
    n_ground = int(n_points * 0.6)
    r = np.sqrt(rng.uniform(4.0, 2500.0, n_ground))
    th = rng.uniform(-np.pi, np.pi, n_ground)
    ground = np.stack([r * np.cos(th), r * np.sin(th),
                       rng.normal(-1.9, 0.05, n_ground)], axis=-1)

    boxes = []
    n_box = rng.integers(6, 14)
    per_box = int(n_points * 0.3) // max(n_box, 1)
    for _ in range(n_box):
        cx, cy = rng.uniform(-40, 40, 2)
        l, w, h = rng.uniform(1.5, 8), rng.uniform(1.5, 3), rng.uniform(1.0, 3.0)
        boxes.append(np.stack([rng.uniform(-l / 2, l / 2, per_box) + cx,
                               rng.uniform(-w / 2, w / 2, per_box) + cy,
                               rng.uniform(-2.0, -2.0 + h, per_box)], axis=-1))

    n_pole = n_points - n_ground - per_box * n_box
    px, py = rng.uniform(-30, 30, (2, max(n_pole, 1)))
    poles = np.stack([px, py, rng.uniform(-2.0, 4.0, max(n_pole, 1))], axis=-1)

    pts = np.concatenate([ground] + boxes + [poles]).astype(np.float32)
    labels = np.concatenate([np.zeros(n_ground, np.int32),
                             np.ones(per_box * n_box, np.int32),
                             np.full(max(n_pole, 1), 2, np.int32)])
    return pts[:n_points], labels[:n_points]


def project_batch(points: torch.Tensor, geom: LidarGeometry,
                  mask: torch.Tensor = None) -> Dict[str, torch.Tensor]:
    """(B, N, 3) clouds -> {"image", "mask"}, each (B, H, W, 1) float32:
    the model-space range image and the ray-drop mask."""
    img, _ = L.pcd2range(points, geom, mask=mask)
    model, drop = L.process_scan(img, geom)
    return {"image": model[..., None], "mask": drop[..., None]}


def synthetic_range_batch(rng: np.random.Generator, batch: int,
                          geom: LidarGeometry = KITTI_GEOMETRY, with_pcd: bool = False,
                          device: Union[str, torch.device] = "cpu",
                          rows: Optional[slice] = None) -> Dict[str, torch.Tensor]:
    """A batch in the reference dataset contract: image (B, H, W, 1) in
    [-1, 1] and mask (B, H, W, 1) in {-1, +1}, projected on ``device``; with
    ``with_pcd`` also the (B, N, 3) numpy points. ``rows`` keeps those rows of
    the batch (a rank's share): every scene is drawn, so the generator moves
    on as for the whole batch, and only these are projected."""
    pts = np.stack([synthetic_scene(rng) for _ in range(batch)])
    if rows is not None:
        pts = pts[rows]
    out: Dict = project_batch(torch.from_numpy(pts).to(device), geom)
    if with_pcd:
        out["points"] = pts
    return out


def synthetic_layouts(rng: np.random.Generator, batch: int, geom: LidarGeometry
                      ) -> np.ndarray:
    """(B, 13, 13) float32 layouts of 1-7 random nuScenes boxes each, with the
    JAX package's draws in its order (``_synthetic_layout_range_batch`` draws
    them right after the batch's scenes)."""
    layouts = np.zeros((batch, 13, 13), np.float32)
    for b in range(batch):
        k = int(rng.integers(1, 8))
        boxes7 = np.stack([
            rng.uniform(-30, 30, k), rng.uniform(-30, 30, k),
            rng.uniform(-2, 1, k), rng.uniform(1.5, 8, k),
            rng.uniform(1.5, 3, k), rng.uniform(1, 3, k),
            rng.uniform(-np.pi, np.pi, k)], 1).astype(np.float32)
        names = [NUSC_CLASS_NAMES[int(i)]
                 for i in rng.integers(0, len(NUSC_CLASS_NAMES), k)]
        layouts[b] = build_layout13(boxes7, names, geom, (-50, 50), (-50, 50), (-4, 2))
    return layouts


def synthetic_layout_range_batch(rng: np.random.Generator, batch: int, geom: LidarGeometry,
                                 device: Union[str, torch.device] = "cpu"
                                 ) -> Dict[str, torch.Tensor]:
    """A ``nusc_layout_range`` training batch: ``image`` and ``mask`` of
    ``batch`` synthetic scenes, then their (B, 13, 13) layouts as ``layout``
    and ``cond``, on ``device``; the JAX package's draws in its order."""
    out = synthetic_range_batch(rng, batch, geom, device=device)
    out["layout"] = out["cond"] = torch.from_numpy(synthetic_layouts(rng, batch, geom)).to(device)
    return out


def synthetic_latent_batch(rng: np.random.Generator, batch: int,
                           shape: Tuple[int, int, int] = (16, 128, 8),
                           device: Union[str, torch.device] = "cpu") -> Dict[str, torch.Tensor]:
    """{"image": (B, *shape) float32 standard normals} on ``device``, the JAX
    package's draws."""
    return {"image": torch.from_numpy(
        rng.standard_normal((batch, *shape)).astype(np.float32)).to(device)}

