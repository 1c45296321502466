"""Gaussian-surfel dense decoder: point features -> surfels -> rendered range.

Counterpart of ``lidar_layout_tpu/models/gs_decoder.py`` (``GSDecoderConfig``,
``GSDecoder``, ``render_surfels``, ``gs_loss``, ``DenseDecoder``): PT-v3
features of each point go through five two-layer MLPs into ``n_offsets``
surfels (sigmoid offsets around the point, exp 2D scales, a quaternion
biased to the identity, clipped tanh opacity, sigmoid colour and ray-drop),
which ``render_surfels`` rasterizes into the range image; ``gs_loss`` is
the masked L1 on metric range plus the ray-drop BCE. Modules keep the flax
names (``mlp_offset_in``, ``neck``, ``backbone``, ...).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.gaussian_raster import RasterConfig, SurfelConfig, rasterize, rasterize_surfels
from ..ops.gaussian_raster_tiled import BandedConfig, rasterize_banded
from ..ops.lidar import LidarGeometry
from ..parallel.collectives import global_denominator
from .ptv3 import PTv3, PTv3Config


@dataclasses.dataclass(frozen=True)
class GSDecoderConfig:
    feat_dim: int = 64
    n_offsets: int = 6
    hidden: int = 32
    color_channel: int = 2     # [intensity, raydrop]
    offset_scale: float = 1.0  # metres spanned by the sigmoid offset
    min_surfel_scale: float = 1e-3


class GSDecoder(nn.Module):
    """(N, 3) coords and (N, feat_dim) features -> a dict of per-surfel
    Gaussian parameters, N * n_offsets rows each."""

    HEADS = (("mlp_offset", 3), ("mlp_opacity", 1), ("mlp_cov", 6), ("mlp_color", None),
             ("mlp_raydrop", 1))

    def __init__(self, cfg: GSDecoderConfig = GSDecoderConfig()):
        super().__init__()
        self.cfg = cfg
        for name, per in self.HEADS:
            out = cfg.n_offsets * (cfg.color_channel - 1 if per is None else per)
            self.add_module(f"{name}_in", nn.Linear(cfg.feat_dim, cfg.hidden))
            self.add_module(f"{name}_out", nn.Linear(cfg.hidden, out))

    def _mlp(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"{name}_out")(torch.relu(getattr(self, f"{name}_in")(x)))

    def forward(self, coords: torch.Tensor, feats: torch.Tensor, mask: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        c, k, n = self.cfg, self.cfg.n_offsets, coords.shape[0]
        offset = torch.sigmoid(self._mlp("mlp_offset", feats))
        opacity = torch.tanh(self._mlp("mlp_opacity", feats))
        scale_rot = self._mlp("mlp_cov", feats)
        color = torch.sigmoid(self._mlp("mlp_color", feats))
        raydrop = torch.sigmoid(self._mlp("mlp_raydrop", feats))

        off = (offset.reshape(n, k, 3) - 0.5) * 2.0 * c.offset_scale
        anchors = (coords[:, None, :] + off).reshape(n * k, 3)
        sr = scale_rot.reshape(n, k, 6)
        scales2d = torch.exp(sr[..., :2].clamp(-6.0, 3.0)).reshape(n * k, 2)
        scales = torch.cat([scales2d, scales2d.new_full((n * k, 1), c.min_surfel_scale)], -1)
        quats = sr[..., 2:].reshape(n * k, 4) + torch.tensor([1.0, 0.0, 0.0, 0.0],
                                                             device=sr.device)
        return {"means": anchors, "scales": scales, "quats": quats,
                "opacities": opacity.reshape(n * k).clamp(0.0, 1.0),
                "color": color.reshape(n * k, c.color_channel - 1),
                "raydrop": raydrop.reshape(n * k),
                "mask": mask.repeat_interleave(k)}


def render_surfels(surfels: Dict[str, torch.Tensor], geom: LidarGeometry,
                   raster_cfg=RasterConfig()) -> Dict[str, torch.Tensor]:
    """Rasterize decoder surfels -> pred_range, pred_intensity,
    pred_raydrop (alpha-normalised) and alpha, each (H, W). The config's
    type picks the rasterizer: ``SurfelConfig`` the exact ray-disc one,
    ``BandedConfig`` the banded one, ``RasterConfig`` the dense flattened
    3D one."""
    feats = torch.cat([surfels["color"], surfels["raydrop"][:, None]], dim=-1)
    if isinstance(raster_cfg, SurfelConfig):
        impl = rasterize_surfels
    elif isinstance(raster_cfg, BandedConfig):
        impl = rasterize_banded
    else:
        impl = rasterize
    out = impl(surfels["means"], surfels["quats"], surfels["scales"], surfels["opacities"],
               feats, geom, mask=surfels["mask"], cfg=raster_cfg)
    alpha = out["alpha"].clamp(min=1e-6)
    return {"pred_range": out["depth"] / alpha,
            "pred_intensity": out["feature"][..., 0] / alpha,
            "pred_raydrop": out["feature"][..., -1] / alpha,
            "alpha": out["alpha"]}


def gs_loss(render: Dict[str, torch.Tensor], gt_range: torch.Tensor, gt_mask: torch.Tensor,
            range_weight: float = 1.0, raydrop_weight: float = 0.1
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked L1 on metric range plus the ray-drop BCE (target 1 where the
    ray has no return); gt_mask is True where a return exists. Under an
    initialised process group it is a collective (``global_denominator``
    all-reduces the count of returns): every rank must call it, and each
    returns its share of the global masked mean."""
    m = gt_mask.float()
    l_range = torch.sum((render["pred_range"] - gt_range).abs() * m) / global_denominator(m.sum())
    rd = render["pred_raydrop"].clamp(1e-6, 1 - 1e-6)
    drop = 1.0 - m
    l_raydrop = -torch.mean(drop * torch.log(rd) + (1 - drop) * torch.log(1 - rd))
    loss = range_weight * l_range + raydrop_weight * l_raydrop
    return loss, {"loss": loss, "loss_range": l_range, "loss_raydrop": l_raydrop}


class DenseDecoder(nn.Module):
    """DenseDecoderV0: the PT-v3 ``backbone``, a ``neck`` Dense to
    ``feat_dim``, then ``gs_decoder``."""

    def __init__(self, backbone_cfg: PTv3Config, gs_cfg: GSDecoderConfig = GSDecoderConfig(),
                 capacity: Optional[int] = None):
        super().__init__()
        self.backbone = PTv3(backbone_cfg, capacity=capacity)
        self.neck = nn.Linear(backbone_cfg.dec_channels[0], gs_cfg.feat_dim)
        self.gs_decoder = GSDecoder(gs_cfg)

    def forward(self, points: torch.Tensor, feats: torch.Tensor, mask: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        h, _ = self.backbone(points, feats, mask)
        return self.gs_decoder(points, self.neck(h), mask)
