"""LiDAR cloud augmentations for the transform pipeline, in numpy.

Counterpart of ``random_flip``, ``random_rotate`` and ``keypoint_drop`` of
``lidar_layout_tpu/data/aug.py`` (the reference's aug_utils): the same draws
from the caller's ``numpy.random.Generator`` in the same order, with
optional matching box transforms.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def random_flip(points: np.ndarray, boxes: Optional[np.ndarray], rng: np.random.Generator
                ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Flip across the x axis (y negated), then across the y axis, each with
    probability 0.5; box yaws follow."""
    pts = points.copy()
    bxs = None if boxes is None else boxes.copy()
    if rng.random() < 0.5:
        pts[:, 1] = -pts[:, 1]
        if bxs is not None:
            bxs[:, 1] = -bxs[:, 1]
            bxs[:, 6] = -bxs[:, 6]
    if rng.random() < 0.5:
        pts[:, 0] = -pts[:, 0]
        if bxs is not None:
            bxs[:, 0] = -bxs[:, 0]
            bxs[:, 6] = np.pi - bxs[:, 6]
    return pts, bxs


def random_rotate(points: np.ndarray, boxes: Optional[np.ndarray], rng: np.random.Generator,
                  angle_range: Tuple[float, float] = (-np.pi / 4, np.pi / 4)
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """A global rotation about z by an angle drawn uniformly from
    ``angle_range``; box yaws follow."""
    a = rng.uniform(*angle_range)
    c, s = np.cos(a), np.sin(a)
    rot = np.asarray([[c, -s], [s, c]], points.dtype)
    pts = points.copy()
    pts[:, :2] = pts[:, :2] @ rot.T
    bxs = None
    if boxes is not None:
        bxs = boxes.copy()
        bxs[:, :2] = bxs[:, :2] @ rot.T
        bxs[:, 6] = bxs[:, 6] + a
    return pts, bxs


def keypoint_drop(points: np.ndarray, rng: np.random.Generator,
                  drop_range: Tuple[int, int] = (5, 20), radius: float = 2.0) -> np.ndarray:
    """Drop random spherical neighbourhoods (occlusion holes): a count in
    ``drop_range``, then for each a centre point and a radius of
    ``radius`` times U(0.3, 1); the points farther than every radius stay."""
    n_drop = int(rng.integers(*drop_range))
    keep = np.ones(len(points), bool)
    for _ in range(n_drop):
        center = points[rng.integers(0, len(points))]
        d = np.linalg.norm(points - center, axis=-1)
        keep &= d > radius * rng.uniform(0.3, 1.0)
    return points[keep]
