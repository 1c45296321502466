"""LiDAR range-image geometry: projection config and range image -> points.

Counterpart of ``lidar_layout_tpu/ops/lidar.py`` (``LidarGeometry``,
``model_to_depth``, ``range2xyz``, ``range2pcd``). Angle grids are built in
numpy float64, as in the JAX package, and moved to the image's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LidarGeometry:
    """Static per-dataset projection configuration (the reference dataset
    config block: size, fov, depth_range, depth_scale, log_scale)."""

    size: Tuple[int, int] = (64, 1024)          # (H, W)
    fov: Tuple[float, float] = (3.0, -25.0)     # (up, down) in degrees
    depth_range: Tuple[float, float] = (1.0, 56.0)
    depth_scale: float = 5.84                   # log2(depth_max + 1) when log_scale
    log_scale: bool = True

    @property
    def fov_up(self) -> float:
        return self.fov[0] / 180.0 * math.pi

    @property
    def fov_down(self) -> float:
        return self.fov[1] / 180.0 * math.pi

    @property
    def fov_range(self) -> float:
        return abs(self.fov_down) + abs(self.fov_up)

    @property
    def depth_thresh(self) -> float:
        """Ray-drop threshold in model space."""
        if self.log_scale:
            return (math.log2(1.0 / 255.0 + 1) / self.depth_scale) * 2.0 - 1 + 1e-6
        return (1.0 / 255.0 / self.depth_scale) * 2.0 - 1 + 1e-6

    def angle_grids(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-pixel (yaw, pitch) in radians, float64."""
        h, w = self.size
        scan_x = np.arange(w, dtype=np.float64) / w
        scan_y = np.arange(h, dtype=np.float64) / h
        yaw = np.pi * (scan_x * 2.0 - 1.0)
        pitch = (1.0 - scan_y) * self.fov_range - abs(self.fov_down)
        return (np.broadcast_to(yaw[None, :], (h, w)),
                np.broadcast_to(pitch[:, None], (h, w)))

    def ray_dirs(self) -> np.ndarray:
        """(H, W, 3) unit ray directions for every pixel, float64."""
        yaw, pitch = self.angle_grids()
        return np.stack([np.cos(yaw) * np.cos(pitch),
                         -np.sin(yaw) * np.cos(pitch),
                         np.sin(pitch)], axis=-1)


KITTI_GEOMETRY = LidarGeometry(size=(64, 1024), fov=(3.0, -25.0),
                               depth_range=(1.0, 56.0), depth_scale=5.84, log_scale=True)
NUSCENES_GEOMETRY = LidarGeometry(size=(32, 1024), fov=(10.0, -30.0),
                                  depth_range=(1.0, 56.0), depth_scale=5.84, log_scale=True)


def model_to_depth(img: torch.Tensor, geom: LidarGeometry,
                   clamp: bool = True) -> torch.Tensor:
    """Model space [-1, 1] -> metric depth."""
    d = (img * 0.5 + 0.5) * geom.depth_scale
    if geom.log_scale:
        d = torch.exp2(d) - 1.0
    if clamp:
        d = d.clamp(geom.depth_range[0], geom.depth_range[1])
    return d


def range2xyz(range_img: torch.Tensor, geom: LidarGeometry,
              from_model_space: bool = True,
              fill: float = -1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., H, W) range image -> ((..., H, W, 3) xyz, (..., H, W) validity)."""
    dirs = torch.as_tensor(geom.ray_dirs(), dtype=range_img.dtype,
                           device=range_img.device)
    if from_model_space:
        depth = (range_img * 0.5 + 0.5) * geom.depth_scale
        if geom.log_scale:
            depth = torch.exp2(depth) - 1.0
    else:
        depth = range_img
    valid = (depth > geom.depth_range[0]) & (depth < geom.depth_range[1])
    xyz = dirs * depth[..., None]
    xyz = torch.where(valid[..., None], xyz, torch.full_like(xyz, fill))
    return xyz, valid


def range2pcd(range_img: torch.Tensor, geom: LidarGeometry,
              from_model_space: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., H, W) range image -> ((..., H*W, 3) xyz, (..., H*W) validity);
    fixed shape, invalid rows zeroed."""
    xyz, valid = range2xyz(range_img, geom, from_model_space=from_model_space,
                           fill=0.0)
    lead = range_img.shape[:-2]
    return xyz.reshape(*lead, -1, 3), valid.reshape(*lead, -1)
