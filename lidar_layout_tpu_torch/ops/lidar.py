"""LiDAR range-image geometry: projection config, points -> range image and
range image -> points.

Counterpart of ``lidar_layout_tpu/ops/lidar.py`` (``LidarGeometry``,
``depth_to_model``, ``model_to_depth``, ``raydrop_mask``, ``process_scan``,
``project_coords``, ``pcd2coord2d``, ``pcd2range``, ``range2xyz``,
``range2pcd``, ``pcd2bev``, ``box_corners_3d``, ``box2coord2dx2``,
``batch_range2xyz``). Angle grids are built in numpy float64, as in the JAX
package, and moved to the image's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

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


def depth_to_model(depth: torch.Tensor, geom: LidarGeometry) -> torch.Tensor:
    """Metric depth -> model space [-1, 1] (negative depth counts as 0)."""
    d = torch.where(depth < 0, torch.zeros_like(depth), depth)
    if geom.log_scale:
        d = torch.log2(d + 0.0001 + 1.0)
    return (d / geom.depth_scale * 2.0 - 1.0).clamp(-1.0, 1.0)


def raydrop_mask(img: torch.Tensor, geom: LidarGeometry) -> torch.Tensor:
    """+1 where a return exists, -1 where the ray dropped."""
    return torch.where(img < geom.depth_thresh, -1.0, 1.0).to(img.dtype)


def process_scan(range_img: torch.Tensor, geom: LidarGeometry
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw metric range image -> (model-space image, ray-drop mask)."""
    img = depth_to_model(range_img, geom)
    return img, raydrop_mask(img, geom)


def project_coords(points: torch.Tensor, geom: LidarGeometry
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-point (col, row, depth): continuous image coords in [0, 1] x [0, 1]
    and the range. ``points`` is (..., 3)."""
    depth = torch.linalg.vector_norm(points, dim=-1)
    yaw = -torch.atan2(points[..., 1], points[..., 0])
    sin_pitch = torch.where(depth > 0, points[..., 2] / depth.clamp(min=1e-8),
                            torch.zeros_like(depth))
    pitch = torch.asin(sin_pitch)
    proj_x = 0.5 * (yaw / math.pi + 1.0)
    proj_y = 1.0 - (pitch + abs(geom.fov_down)) / geom.fov_range
    return proj_x, proj_y, depth


def pcd2coord2d(points: torch.Tensor, geom: LidarGeometry,
                clip: bool = True) -> torch.Tensor:
    """(..., 3) points -> (..., 2) normalised (x, y) image coords."""
    px, py, _ = project_coords(points, geom)
    if clip:
        px, py = px.clamp(0.0, 1.0), py.clamp(0.0, 1.0)
    return torch.stack([px, py], dim=-1)


def pcd2range(points: torch.Tensor, geom: LidarGeometry,
              mask: Optional[torch.Tensor] = None,
              features: Optional[torch.Tensor] = None,
              fill: float = -1.0, feature_fill: float = -1.0
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Project (..., N, 3) clouds into (..., H, W) range images; the nearest
    return wins.

    A scatter-min on depth (``scatter_reduce(..., "amin")``) with invalid
    points routed to a dump slot one past each image, as the JAX package does;
    the optional (..., N) feature channel takes the largest feature among the
    points at the winning depth. ``mask`` (..., N) marks real points.
    Returns (range images, feature images or None).
    """
    h, w = geom.size
    lead = points.shape[:-2]
    n = points.shape[-2]
    pts = points.reshape(-1, n, 3).float()
    nb = pts.shape[0]
    px, py, depth = project_coords(pts, geom)
    valid = (depth > geom.depth_range[0]) & (depth < geom.depth_range[1])
    if mask is not None:
        valid = valid & mask.reshape(nb, n)
    xi = torch.floor(px * w).clamp(0, w - 1).long()
    yi = torch.floor(py * h).clamp(0, h - 1).long()
    slots = h * w + 1
    pix = torch.where(valid, yi * w + xi, h * w)
    pix = (pix + torch.arange(nb, device=pts.device)[:, None] * slots).reshape(-1)
    big = torch.finfo(torch.float32).max
    d = torch.where(valid, depth, big).reshape(-1)
    dmin = torch.full((nb * slots,), big, dtype=torch.float32, device=pts.device)
    dmin = dmin.scatter_reduce(0, pix, d, reduce="amin", include_self=True)
    img = dmin.reshape(nb, slots)[:, : h * w]
    range_img = torch.where(img < big, img, fill).reshape(*lead, h, w)

    feat_img = None
    if features is not None:
        neg = -big
        winner = valid.reshape(-1) & (d <= dmin[pix])
        fvals = torch.where(winner, features.reshape(-1).float(), neg)
        fmax = torch.full((nb * slots,), neg, dtype=torch.float32, device=pts.device)
        fmax = fmax.scatter_reduce(0, pix, fvals, reduce="amax", include_self=True)
        f = fmax.reshape(nb, slots)[:, : h * w]
        feat_img = torch.where(f > neg, f, feature_fill).reshape(*lead, h, w)
    return range_img, feat_img


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


def pcd2bev(points: torch.Tensor, mask: Optional[torch.Tensor] = None,
            x_range: Tuple[float, float] = (-50.0, 50.0),
            y_range: Tuple[float, float] = (-50.0, 50.0),
            z_range: Tuple[float, float] = (-3.0, 1.0),
            resolution: float = 1.0) -> torch.Tensor:
    """(..., N, 3) points -> (..., nx, ny) binary f32 BEV occupancy; strict
    range bounds, floor((x - x0) / resolution) cells."""
    nx = math.ceil((x_range[1] - x_range[0]) // resolution)
    ny = math.ceil((y_range[1] - y_range[0]) // resolution)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    valid = ((x > x_range[0]) & (x < x_range[1]) & (y > y_range[0]) & (y < y_range[1])
             & (z > z_range[0]) & (z < z_range[1]))
    if mask is not None:
        valid = valid & mask
    res = torch.tensor(resolution, dtype=points.dtype, device=points.device)
    bx = torch.floor((x - x_range[0]) / res).clamp(0, nx - 1).to(torch.int64)
    by = torch.floor((y - y_range[0]) / res).clamp(0, ny - 1).to(torch.int64)
    idx = torch.where(valid, bx * ny + by, nx * ny)
    lead = points.shape[:-2]
    grid = torch.zeros((*lead, nx * ny + 1), dtype=torch.float32, device=points.device)
    grid = grid.scatter_reduce(-1, idx, valid.to(torch.float32), "amax")
    return grid[..., : nx * ny].reshape(*lead, nx, ny)


def box_corners_3d(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) boxes [cx, cy, cz, l, w, h, yaw] -> (..., 8, 3) corners."""
    cx, cy, cz = boxes[..., 0:1], boxes[..., 1:2], boxes[..., 2:3]
    l, w, h, yaw = boxes[..., 3:4], boxes[..., 4:5], boxes[..., 5:6], boxes[..., 6:7]
    kw = dict(dtype=boxes.dtype, device=boxes.device)
    sx = torch.tensor([1, 1, -1, -1, 1, 1, -1, -1], **kw) * 0.5
    sy = torch.tensor([1, -1, -1, 1, 1, -1, -1, 1], **kw) * 0.5
    sz = torch.tensor([1, 1, 1, 1, -1, -1, -1, -1], **kw) * 0.5
    xc, yc, zc = l * sx, w * sy, h * sz
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([c * xc - s * yc + cx, s * xc + c * yc + cy, zc + cz], dim=-1)


def box2coord2dx2(boxes: torch.Tensor, geom: LidarGeometry) -> torch.Tensor:
    """(..., 7) 3-D boxes -> (..., 4) range-view [xmin, ymin, xmax, ymax] in [0, 1]."""
    c2d = pcd2coord2d(box_corners_3d(boxes), geom, clip=True)      # (..., 8, 2)
    lo, hi = c2d.amin(dim=-2), c2d.amax(dim=-2)
    return torch.stack([lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1]], dim=-1)


def batch_range2xyz(imgs: torch.Tensor, geom: LidarGeometry) -> torch.Tensor:
    """(B, H, W) model-space images -> (B, H, W, 3) xyz, invalid pixels -1."""
    return range2xyz(imgs, geom, from_model_space=True)[0]
