"""The sparse-voxel VAE's convolution block.

Counterpart of ``SparseConvBlock`` in ``lidar_layout_tpu/models/sparse_vae.py``
(``SparseVAE`` comes with the cube stage: ROADMAP queue 1, "Cube stage").
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.voxel import OFFSETS_27, VoxelGrid, gather_table, neighbor_table


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
                table: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """``x`` (B, cap, C); ``table`` is ``neighbor_table(grid, OFFSETS_27)``,
        built here when not given."""
        b, cap, c = x.shape
        idx, hit = table if table is not None else neighbor_table(grid, OFFSETS_27, self.bits)
        h = self.w(gather_table(x, idx, hit).reshape(b, cap, 27 * c))
        h = F.silu(self.norm(h.float()))
        if c == self.features:
            h = h + x
        return h * grid.mask[..., None]
