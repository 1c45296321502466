"""The hierarchical sparse-voxel VAE of the cube stage ("Ours" stage 2).

Counterpart of ``lidar_layout_tpu/models/sparse_vae.py``: ``SparseConvBlock``,
``SparseVAEConfig``, ``SparseVAE``, ``struct_loss`` and
``optax_sigmoid_bce``. Every module batches over a leading cloud dimension
(``ops/voxel``), where JAX ``vmap``s one cloud at a time; each cloud's result
is JAX's for that cloud alone. Module names are flax's, so a JAX tree
carries across with ``utils/convert.dense_tree_state_dict``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.voxel import (OFFSETS_27, VoxelGrid, gather_rows, gather_table, lookup,
                         neighbor_table, occupancy_targets, pool_to_parent, scatter_mean,
                         voxelize_points)
from ..parallel.collectives import rank_rows

Table = Tuple[torch.Tensor, torch.Tensor]


class SparseConvBlock(nn.Module):
    """3^3 sparse convolution: the 27 neighbours (``OFFSETS_27``, 0 where
    missing) gathered into one row, one ``Linear``, LayerNorm in f32 (flax's
    eps 1e-6), SiLU, a residual when the widths match, padding rows zeroed.
    Module names are flax's: ``w``, ``norm``."""

    def __init__(self, in_features: int, features: int, bits: int = 10):
        super().__init__()
        self.features, self.bits = features, bits
        self.w = nn.Linear(27 * in_features, features)
        self.norm = nn.LayerNorm(features, eps=1e-6)

    def forward(self, grid: VoxelGrid, x: torch.Tensor,
                table: Optional[Table] = None) -> torch.Tensor:
        """``x`` (B, cap, C); ``table`` is ``neighbor_table(grid, OFFSETS_27)``,
        built here when not given."""
        b, cap, c = x.shape
        idx, hit = table if table is not None else neighbor_table(grid, OFFSETS_27, self.bits)
        h = self.w(gather_table(x, idx, hit).reshape(b, cap, 27 * c))
        h = F.silu(self.norm(h.float()))
        if c == self.features:
            h = h + x
        return h * grid.mask[..., None]


@dataclasses.dataclass(frozen=True)
class SparseVAEConfig:
    num_levels: int = 3
    base_capacity: int = 4096       # finest-level voxel capacity
    channels: Tuple[int, ...] = (32, 64, 128)
    latent_dim: int = 16
    voxel_size: float = 0.1
    bits: int = 10
    kl_weight: float = 1e-3

    def capacity(self, level: int) -> int:
        return max(self.base_capacity >> level, 8)


class SparseVAE(nn.Module):
    """Encode point clouds into a coarse sparse latent; decode structure.

    ``forward(points (B, N, 3), feats (B, N, in_features), mask (B, N))``
    returns JAX's dict, batched: ``latent_mean``, ``latent_logvar``,
    ``latent`` (B, cap_top, latent_dim), ``latent_grid``, per-level
    ``struct_logits`` (B, cap_p, 8) and ``struct_targets``, ``grids`` (fine
    to coarse) and ``decoded_feats``. The decoder descends the true grids
    (teacher forcing, as the reference trains). Each level's 27-offset
    table is built once and serves its encoder and decoder convolutions."""

    def __init__(self, cfg: SparseVAEConfig, in_features: int = 4):
        super().__init__()
        self.cfg = cfg
        ch, bits, n = cfg.channels, cfg.bits, cfg.num_levels
        self.stem = nn.Linear(in_features, ch[0])
        for lvl in range(n):
            setattr(self, f"enc{lvl}_conv1", SparseConvBlock(ch[lvl], ch[lvl], bits))
            setattr(self, f"enc{lvl}_conv2", SparseConvBlock(ch[lvl], ch[lvl], bits))
            if lvl < n - 1:
                setattr(self, f"enc{lvl}_down", nn.Linear(ch[lvl], ch[lvl + 1]))
        self.to_moments = nn.Linear(ch[-1], 2 * cfg.latent_dim)
        self.from_latent = nn.Linear(cfg.latent_dim, ch[-1])
        for lvl in range(n - 1):
            setattr(self, f"dec{lvl}_conv", SparseConvBlock(ch[lvl + 1], ch[lvl + 1], bits))
            setattr(self, f"dec{lvl}_struct", nn.Linear(ch[lvl + 1], 8))
            setattr(self, f"dec{lvl}_up", nn.Linear(ch[lvl + 1], ch[lvl]))

    def forward(self, points: torch.Tensor, feats: torch.Tensor, mask: torch.Tensor,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict:
        """``noise`` (B, cap_top, latent_dim) is the reparameterisation's
        draw; without it one is drawn from ``generator``."""
        cfg = self.cfg
        bits = cfg.bits
        grid0, p2v, _ = voxelize_points(points, mask, cfg.voxel_size, cfg.capacity(0),
                                        bits=bits)
        x = scatter_mean(p2v, feats, mask.to(feats.dtype), cfg.capacity(0))
        x = self.stem(x) * grid0.mask[..., None]

        grids: List[VoxelGrid] = [grid0]
        tables: List[Table] = []
        for lvl in range(cfg.num_levels):
            tables.append(neighbor_table(grids[lvl], OFFSETS_27, bits))
            x = getattr(self, f"enc{lvl}_conv1")(grids[lvl], x, tables[lvl])
            x = getattr(self, f"enc{lvl}_conv2")(grids[lvl], x, tables[lvl])
            if lvl < cfg.num_levels - 1:
                pgrid, x, _ = pool_to_parent(grids[lvl], x, cfg.capacity(lvl + 1), bits)
                x = getattr(self, f"enc{lvl}_down")(x) * pgrid.mask[..., None]
                grids.append(pgrid)

        top = grids[-1]
        mean, logvar = self.to_moments(x).chunk(2, dim=-1)
        logvar = logvar.clamp(-30.0, 20.0)
        if noise is None:
            noise = rank_rows(lambda n: torch.randn((n, *mean.shape[1:]), generator=generator,
                                                    device=mean.device), mean.shape[0])
        z = (mean + torch.exp(0.5 * logvar) * noise) * top.mask[..., None]

        h = self.from_latent(z) * top.mask[..., None]
        struct_logits, targets = [], []
        for lvl in reversed(range(cfg.num_levels - 1)):
            g, child = grids[lvl + 1], grids[lvl]
            h = getattr(self, f"dec{lvl}_conv")(g, h, tables[lvl + 1])
            struct_logits.append(getattr(self, f"dec{lvl}_struct")(h))
            targets.append(occupancy_targets(g, child, bits))
            pidx, phit = lookup(g, child.coords >> 1, bits)
            h = torch.where(phit[..., None], gather_rows(h, pidx), 0.0)
            h = getattr(self, f"dec{lvl}_up")(h) * child.mask[..., None]

        return {"latent_mean": mean, "latent_logvar": logvar, "latent": z,
                "latent_grid": top, "struct_logits": struct_logits,
                "struct_targets": targets, "grids": grids, "decoded_feats": h}


def struct_loss(out: Dict, kl_weight: float = 1e-3
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per cloud, as JAX's: the mean BCE over every row of each level's
    child-occupancy logits (padding rows included), plus ``kl_weight``
    times the KL over the latent grid's valid rows. Returns (total (B,),
    logs of (B,) tensors)."""
    total = 0.0
    logs = {}
    for i, (logits, target) in enumerate(zip(out["struct_logits"], out["struct_targets"])):
        ce = optax_sigmoid_bce(logits, target).mean(dim=(1, 2))
        total = total + ce
        logs[f"struct_ce_{i}"] = ce
    mean, logvar = out["latent_mean"], out["latent_logvar"]
    m = out["latent_grid"].mask[..., None].to(mean.dtype)
    kl = (0.5 * ((mean ** 2 + torch.exp(logvar) - 1.0 - logvar) * m).sum(dim=(1, 2))
          / m.sum(dim=(1, 2)).clamp(min=1.0))
    total = total + kl_weight * kl
    logs["kl"] = kl
    logs["loss"] = total
    return total, logs


def optax_sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's sigmoid binary cross-entropy, in the log-sigmoid form."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)
