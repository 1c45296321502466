"""SpUNet-v1m1: a sparse-convolution U-Net over fixed-capacity voxel grids.

Counterpart of ``lidar_layout_tpu/models/spunet.py`` (``SpUNetConfig``,
``SubMConv``, ``DownConv``, ``UpConv``, ``BasicBlock``, ``SpUNet``) over one
padded cloud: (N, 3) points, (N, C) features, an (N,) mask. Modules keep the
flax names (``conv_input.w``, ``down0.w``, ``enc0_block0.conv1.w``,
``up1_norm``, ``final.w``, ...), so ``utils/convert.dense_tree_state_dict``
carries a JAX tree in.

The points are voxelised at ``voxel_size`` into a grid of ``capacity`` rows
(``ops/voxel``, one cloud as a batch of 1) with their features' mean. A
submanifold convolution gathers each voxel's k^3 neighbours (a table built
once a grid and kernel size) into one (cap, k^3 C) x (k^3 C, C') matmul; a
stride-2 convolution gathers each parent's 8 children from the fine grid;
the inverse convolution gives each voxel of the saved fine grid its
parent's features through its octant's weight slice. Norms are LayerNorm
with flax's eps 1e-6, in place of the reference's BatchNorm.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.voxel import (VoxelGrid, build_grid, gather_rows, gather_table, lookup,
                         neighbor_table, scatter_mean, subdivide, voxelize_points)

LN_EPS = 1e-6   # flax LayerNorm's


@dataclasses.dataclass(frozen=True)
class SpUNetConfig:
    in_channels: int = 4
    num_classes: int = 13
    base_channels: int = 32
    channels: Tuple[int, ...] = (32, 64, 128, 256, 256, 128, 96, 96)
    layers: Tuple[int, ...] = (2, 3, 4, 6, 2, 2, 2, 2)
    cls_mode: bool = False
    stem_kernel: int = 5
    voxel_size: float = 0.05
    capacity: int = 32768   # the finest grid's rows; overflow merges into the last
    bits: int = 10

    def __post_init__(self):
        if len(self.layers) % 2 != 0:
            raise ValueError(f"len(layers)={len(self.layers)} must be even "
                             "(encoder/decoder halves)")
        if len(self.layers) != len(self.channels):
            raise ValueError(f"len(layers)={len(self.layers)} must equal "
                             f"len(channels)={len(self.channels)}")

    @property
    def num_stages(self) -> int:
        return len(self.layers) // 2


def stencil(kernel: int) -> torch.Tensor:
    """(k^3, 3) offsets, dx slowest."""
    r = kernel // 2
    return torch.tensor([[dx, dy, dz] for dx in range(-r, r + 1) for dy in range(-r, r + 1)
                         for dz in range(-r, r + 1)], dtype=torch.int32)


def _norm(c: int) -> nn.LayerNorm:
    return nn.LayerNorm(c, eps=LN_EPS)


class Tables:
    """A grid with its neighbour tables, built once a kernel size."""

    def __init__(self, grid: VoxelGrid, bits: int):
        self.grid, self.bits = grid, bits
        self._tables: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def mask(self) -> torch.Tensor:
        return self.grid.mask[0]

    def gather(self, x: torch.Tensor, kernel: int) -> torch.Tensor:
        """(cap, C) -> (cap, k^3, C) neighbour rows, 0 where missing."""
        if kernel not in self._tables:
            self._tables[kernel] = neighbor_table(self.grid, stencil(kernel), self.bits)
        return gather_table(x[None], *self._tables[kernel])[0]


class SubMConv(nn.Module):
    """Submanifold convolution: outputs at the grid's own voxels."""

    def __init__(self, c_in: int, features: int, kernel: int = 3, bias: bool = False):
        super().__init__()
        self.kernel = kernel
        self.w = nn.Linear(c_in * kernel ** 3, features, bias=bias)

    def forward(self, grid: Tables, x: torch.Tensor) -> torch.Tensor:
        h = x if self.kernel == 1 else grid.gather(x, self.kernel).flatten(1)
        return self.w(h) * grid.mask[:, None]


class DownConv(nn.Module):
    """Stride-2 convolution of kernel 2: each parent's 8 children."""

    def __init__(self, c_in: int, features: int, capacity: int, bits: int = 10):
        super().__init__()
        self.capacity, self.bits = capacity, bits
        self.w = nn.Linear(8 * c_in, features, bias=False)

    def forward(self, grid: Tables, x: torch.Tensor) -> Tuple[Tables, torch.Tensor]:
        g = grid.grid
        pgrid, _ = build_grid(g.coords >> 1, g.mask, self.capacity, self.bits)
        child, _ = subdivide(pgrid)
        idx, hit = lookup(g, child, self.bits)
        cf = torch.where(hit[0, :, None], gather_rows(x[None], idx)[0], 0.0)
        h = self.w(cf.reshape(self.capacity, -1))
        return Tables(pgrid, self.bits), h * pgrid.mask[0, :, None]


class UpConv(nn.Module):
    """Inverse convolution of kernel 2 onto the saved fine grid."""

    def __init__(self, c_in: int, features: int, bits: int = 10):
        super().__init__()
        self.bits = bits
        self.w = nn.Linear(8 * c_in, features, bias=False)

    def forward(self, pgrid: Tables, px: torch.Tensor, cgrid: Tables) -> torch.Tensor:
        coords = cgrid.grid.coords
        pidx, hit = lookup(pgrid.grid, coords >> 1, self.bits)
        pf = torch.where(hit[0, :, None], gather_rows(px[None], pidx)[0], 0.0)
        octant = coords[0] & 1
        onehot = F.one_hot((octant[:, 0] * 4 + octant[:, 1] * 2 + octant[:, 2]).long(), 8
                           ).to(pf.dtype)
        h = (onehot[:, :, None] * pf[:, None, :]).reshape(pf.shape[0], -1)
        return self.w(h) * cgrid.mask[:, None]


class BasicBlock(nn.Module):
    """Two 3^3 submanifold convolutions and the residual (projected when the
    width changes)."""

    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.conv1, self.bn1 = SubMConv(c_in, features), _norm(features)
        self.conv2, self.bn2 = SubMConv(features, features), _norm(features)
        if c_in != features:
            self.proj, self.proj_norm = nn.Linear(c_in, features, bias=False), _norm(features)

    def forward(self, grid: Tables, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(grid, x)))
        h = self.bn2(self.conv2(grid, h))
        res = self.proj_norm(self.proj(x)) if hasattr(self, "proj") else x
        return torch.relu(h + res) * grid.mask[:, None]


class SpUNet(nn.Module):
    """``forward(coord (N, 3), feat (N, Cin), mask (N,))`` -> (N,
    num_classes) logits, (N, channels[-1]) features when ``num_classes`` is
    0, or one (num_classes,) vector (the mean over voxels) in ``cls_mode``."""

    def __init__(self, cfg: SpUNetConfig):
        super().__init__()
        self.cfg = cfg
        ns, ch = cfg.num_stages, cfg.channels
        self.conv_input = SubMConv(cfg.in_channels, cfg.base_channels, cfg.stem_kernel)
        self.stem_norm = _norm(cfg.base_channels)
        width, skip_widths = cfg.base_channels, [cfg.base_channels]
        for s in range(ns):
            self.add_module(f"down{s}", DownConv(width, ch[s], cfg.capacity, cfg.bits))
            self.add_module(f"down{s}_norm", _norm(ch[s]))
            width = ch[s]
            for i in range(cfg.layers[s]):
                self.add_module(f"enc{s}_block{i}", BasicBlock(width, ch[s]))
            skip_widths.append(width)
        skip_widths.pop()
        if cfg.cls_mode:
            self.final = SubMConv(width, max(cfg.num_classes, 1), 1, bias=True)
            return
        for s in reversed(range(ns)):
            dec_ch = ch[len(ch) - s - 1]
            self.add_module(f"up{s}", UpConv(width, dec_ch, cfg.bits))
            self.add_module(f"up{s}_norm", _norm(dec_ch))
            width = dec_ch + skip_widths.pop()
            for i in range(cfg.layers[len(ch) - s - 1]):
                self.add_module(f"dec{s}_block{i}", BasicBlock(width, dec_ch))
                width = dec_ch
        if cfg.num_classes > 0:
            self.final = SubMConv(width, cfg.num_classes, 1, bias=True)

    def forward(self, coord: torch.Tensor, feat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        ns, ch = cfg.num_stages, cfg.channels
        vgrid, p2v, _ = voxelize_points(coord[None], mask[None], cfg.voxel_size, cfg.capacity,
                                        bits=cfg.bits)
        grid = Tables(vgrid, cfg.bits)
        x = scatter_mean(p2v, feat[None], mask[None].to(feat.dtype), cfg.capacity)[0]
        x = torch.relu(self.stem_norm(self.conv_input(grid, x))) * grid.mask[:, None]
        skips, g = [(grid, x)], grid
        for s in range(ns):
            g, x = getattr(self, f"down{s}")(g, x)
            x = torch.relu(getattr(self, f"down{s}_norm")(x)) * g.mask[:, None]
            for i in range(cfg.layers[s]):
                x = getattr(self, f"enc{s}_block{i}")(g, x)
            skips.append((g, x))
        g, x = skips.pop(-1)
        if cfg.cls_mode:
            h = self.final(g, x)
            wm = g.mask.to(h.dtype)
            return (h * wm[:, None]).sum(0) / torch.clamp(wm.sum(), min=1.0)
        for s in reversed(range(ns)):
            sgrid, sx = skips.pop(-1)
            x = getattr(self, f"up{s}")(g, x, sgrid)
            x = torch.relu(getattr(self, f"up{s}_norm")(x)) * sgrid.mask[:, None]
            g = sgrid
            x = torch.cat([x, sx], dim=-1)
            for i in range(cfg.layers[len(ch) - s - 1]):
                x = getattr(self, f"dec{s}_block{i}")(g, x)
        if cfg.num_classes > 0:
            x = self.final(g, x)
        return x[p2v[0]] * mask[:, None]
