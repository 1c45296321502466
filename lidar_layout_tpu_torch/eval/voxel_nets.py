"""The depth-sector descriptor of FSVD/FPVD, and the small sparse voxel net.

Counterpart of ``lidar_layout_tpu/eval/voxel_nets.py``
(``depth_sector_descriptor``, ``VoxelNetConfig``, ``SparseVoxelNet``),
batched over a leading cloud dimension. The descriptor pools per-point
logits into 16 radial depth bands around the cloud's centre (the reference's
'depth' aggregation); FSVD and FPVD feed it MinkowskiNet's and SPVCNN's
logits (``eval/sparse_seg_nets``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.sparse_vae import SparseConvBlock
from ..ops.voxel import (OFFSETS_27, gather_rows, lookup, neighbor_table, pool_to_parent,
                         scatter_mean, voxelize_points)

NUM_SECTORS = 16


def sector_edges(depth_range: Tuple[float, float] = (1.0, 56.0),
                 num_sectors: int = NUM_SECTORS) -> np.ndarray:
    """The sector edges in float32: ``jnp.linspace(lo, hi, num_sectors + 1)``
    as JAX computes it (start * (1 - step) + stop * step, step = i / div)
    with lo = depth_range[0] + 3 and the first edge set to 0. At every
    depth range of the repository, (1, 56), each edge is a multiple of 1/4,
    so it is exact."""
    lo, hi = np.float32(depth_range[0] + 3.0), np.float32(depth_range[1])
    step = np.arange(num_sectors, dtype=np.float32) / np.float32(num_sectors)
    edges = np.append(lo * (np.float32(1.0) - step) + hi * step, hi).astype(np.float32)
    edges[0] = 0.0
    return edges


def depth_sector_descriptor(points: torch.Tensor, logits: torch.Tensor, mask: torch.Tensor,
                            depth_range: Tuple[float, float] = (1.0, 56.0),
                            num_sectors: int = NUM_SECTORS) -> torch.Tensor:
    """(B, N, 3) anchors, (B, N, C) logits, (B, N) mask -> (B, C * num_sectors):
    for each band of BEV distance from the masked anchors' mean, the mean
    logit of the masked anchors in it (0 in an empty band), bands in order."""
    w = mask.to(logits.dtype)
    xy = points[..., :2]
    centre = (xy * w[..., None]).sum(dim=1) / w.sum(dim=1).clamp(min=1.0)[:, None]
    bev_depth = torch.sqrt(((xy - centre[:, None, :]) ** 2).sum(dim=-1))
    edges = torch.from_numpy(sector_edges(depth_range, num_sectors)).to(bev_depth.device)
    sel = ((bev_depth[..., None] >= edges[:-1]) & (bev_depth[..., None] < edges[1:])
           & mask[..., None]).to(logits.dtype)                       # (B, N, S)
    total = torch.einsum("bns,bnc->bsc", sel, logits)
    mean = total / sel.sum(dim=1).clamp(min=1.0)[..., None]
    return torch.nan_to_num(mean).reshape(mean.shape[0], -1)


@dataclasses.dataclass(frozen=True)
class VoxelNetConfig:
    in_channels: int = 4        # xyz and an intensity placeholder
    channels: Tuple[int, ...] = (32, 64, 128)
    out_channels: int = 48      # logits: 48 x 16 sectors = a 768-wide descriptor
    voxel_size: float = 0.05
    capacity: int = 16384
    bits: int = 10
    point_branch: bool = False  # SPVCNN-style per-point MLP added to the logits


class SparseVoxelNet(nn.Module):
    """A Minkowski/SPVCNN-style encoder over a fixed-capacity grid: a stem,
    two ``SparseConvBlock`` a level, mean pooling to the next, skip adds on
    the way back up, a head, and the head's voxel logits at the points.
    Module names are flax's (``stem``, ``conv{i}a``/``b``, ``down{i}``,
    ``up{i}``, ``head``, ``pt_mlp1``, ``pt_head``)."""

    def __init__(self, cfg: VoxelNetConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.channels
        self.stem = nn.Linear(cfg.in_channels, ch[0])
        for i, c in enumerate(ch):
            setattr(self, f"conv{i}a", SparseConvBlock(c, c, cfg.bits))
            setattr(self, f"conv{i}b", SparseConvBlock(c, c, cfg.bits))
            if i < len(ch) - 1:
                setattr(self, f"down{i}", nn.Linear(c, ch[i + 1]))
                setattr(self, f"up{i}", nn.Linear(ch[i + 1], c))
        self.head = nn.Linear(ch[0], cfg.out_channels)
        if cfg.point_branch:
            self.pt_mlp1 = nn.Linear(cfg.in_channels, ch[0])
            self.pt_head = nn.Linear(ch[0], cfg.out_channels)

    def forward(self, points: torch.Tensor, feats: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, N, 3) points, (B, N, in) feats, (B, N) mask -> (per-point
        logits (B, N, out), mask)."""
        cfg = self.cfg
        grid, p2v, _ = voxelize_points(points, mask, cfg.voxel_size, cfg.capacity, bits=cfg.bits)
        x = scatter_mean(p2v, feats, mask.to(feats.dtype), cfg.capacity)
        x = self.stem(x) * grid.mask[..., None]
        g, levels, grids = grid, [], [grid]
        for i in range(len(cfg.channels)):
            table = neighbor_table(g, OFFSETS_27, cfg.bits)
            x = getattr(self, f"conv{i}a")(g, x, table)
            x = getattr(self, f"conv{i}b")(g, x, table)
            levels.append((g, x))
            if i < len(cfg.channels) - 1:
                g, x, _ = pool_to_parent(g, x, max(cfg.capacity >> (i + 1), 8), cfg.bits)
                x = getattr(self, f"down{i}")(x) * g.mask[..., None]
                grids.append(g)
        for i in reversed(range(len(cfg.channels) - 1)):
            fine_g, fine_x = levels[i]
            pidx, phit = lookup(grids[i + 1], fine_g.coords >> 1, cfg.bits)
            up = torch.where(phit[..., None], gather_rows(x, pidx), 0.0)
            x = (fine_x + getattr(self, f"up{i}")(up)) * fine_g.mask[..., None]
        out = gather_rows(self.head(x), p2v) * mask[..., None]
        if cfg.point_branch:
            pb = F.relu(self.pt_mlp1(feats))
            out = out + self.pt_head(pb) * mask[..., None]
        return out, mask
