"""Differentiable range-image geometry for the autoencoder's losses, NCHW.

Counterpart of ``lidar_layout_tpu/losses/geometric.py`` (the reference's
GeoConverter): range -> xyz with the geometry's angle grids
(``LidarGeometry.angle_grids``), normals from central differences, curve-wise
average-pool compression, and the squared-distance, smoothness and
normal-consistency losses. Images are (B, C, H, W); coordinates and normals
(B, 3, H, W).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.lidar import LidarGeometry
from ..parallel.collectives import global_denominator


@functools.lru_cache(maxsize=16)
def _trig_tables(geom: LidarGeometry, dtype: torch.dtype, device: torch.device
                 ) -> Tuple[torch.Tensor, ...]:
    """cos/sin of yaw and pitch, (H, W) each: made once per geometry, dtype
    and device (a copy from the host would wait for the device each step)."""
    yaw, pitch = geom.angle_grids()
    return tuple(torch.as_tensor(np.ascontiguousarray(f(a)), dtype=dtype, device=device)
                 for a in (yaw, pitch) for f in (np.cos, np.sin))


@dataclasses.dataclass(frozen=True)
class GeoConverter:
    """Range images in model space ([-1, 1]) or [0, 1] -> metric geometry."""

    geom: LidarGeometry
    curve_length: int = 4

    def rescale_depth(self, imgs01: torch.Tensor) -> torch.Tensor:
        """[0, 1]-scaled image -> metric depth, clamped to the depth range."""
        d = imgs01 * self.geom.depth_scale
        if self.geom.log_scale:
            d = torch.exp2(d) - 1.0
        return torch.clamp(d, self.geom.depth_range[0], self.geom.depth_range[1])

    def range2xyz(self, imgs01: torch.Tensor) -> torch.Tensor:
        """(B, 1, H, W) in [0, 1] -> (B, 3, H, W) xyz."""
        cos_yaw, sin_yaw, cos_pitch, sin_pitch = _trig_tables(self.geom, imgs01.dtype,
                                                              imgs01.device)
        depth = self.rescale_depth(imgs01)[:, 0]
        return torch.stack([cos_yaw * cos_pitch * depth, -sin_yaw * cos_pitch * depth,
                            sin_pitch * depth], dim=1)

    def range2normal(self, coord: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) xyz -> (B, 3, H, W) unit normals, zero on the border."""
        dx = coord[:, :, 2:, 1:-1] - coord[:, :, :-2, 1:-1]
        dy = coord[:, :, 1:-1, 2:] - coord[:, :, 1:-1, :-2]
        n = torch.linalg.cross(dx, dy, dim=1)
        n = n / torch.clamp(torch.linalg.vector_norm(n, dim=1, keepdim=True), min=1e-12)
        return F.pad(n, (1, 1, 1, 1))

    def curve_compress(self, coord: torch.Tensor) -> torch.Tensor:
        """(1, curve_length) average pooling along the scan line."""
        if self.curve_length <= 1:
            return coord
        return F.avg_pool2d(coord, (1, self.curve_length), (1, self.curve_length))

    def __call__(self, imgs: torch.Tensor) -> torch.Tensor:
        """Model-space (B, 1, H, W) -> compressed coordinates."""
        return self.curve_compress(self.range2xyz(imgs * 0.5 + 0.5))

    def depth_from_model(self, imgs: torch.Tensor) -> torch.Tensor:
        """Model-space [-1, 1] -> metric depth (the smoothness loss's input)."""
        return self.rescale_depth(imgs * 0.5 + 0.5)


def square_dist_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distance summed over the coordinate (channel) axis, kept."""
    return torch.sum((x - y) ** 2, dim=1, keepdim=True)


def smoothness_loss(pred_depth: torch.Tensor, gt_depth: torch.Tensor,
                    grad_clip: float = 0.01) -> torch.Tensor:
    """Masked first-difference L1 on metric depth: only pixel pairs whose
    ground-truth difference is under ``grad_clip`` and which both have
    returns count. Under an initialised process group it is a collective
    (``global_denominator`` all-reduces the counts): every rank must call
    it, and each returns its share of the global masked mean."""
    p, g = pred_depth[:, 0], gt_depth[:, 0]
    gx = g[:, :, :-1] - g[:, :, 1:]
    gy = g[:, :-1, :] - g[:, 1:, :]
    mx = (g[:, :, :-1] > 0) & (g[:, :, 1:] > 0) & (gx.abs() < grad_clip)
    my = (g[:, :-1, :] > 0) & (g[:, 1:, :] > 0) & (gy.abs() < grad_clip)
    px = p[:, :, :-1] - p[:, :, 1:]
    py = p[:, :-1, :] - p[:, 1:, :]
    lx = torch.sum((px - gx).abs() * mx) / global_denominator(mx.sum(), minimum=1)
    ly = torch.sum((py - gy).abs() * my) / global_denominator(my.sum(), minimum=1)
    return lx + ly


def normal_consistency_loss(geo: GeoConverter, input_coord: torch.Tensor,
                            rec_coord: torch.Tensor) -> torch.Tensor:
    """1 - <n_gt, n_pred>, averaged over the interior."""
    dot = torch.sum(geo.range2normal(input_coord) * geo.range2normal(rec_coord), dim=1)
    return torch.mean(1.0 - dot[:, 1:-1, 1:-1])
