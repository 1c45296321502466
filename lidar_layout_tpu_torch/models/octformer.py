"""OctFormer (OctFormer-v1m1): patch attention along the octree's z-order.

Counterpart of ``lidar_layout_tpu/models/octformer.py``
(``OctFormerConfig``, ``OctreeDWConv``, ``OctreeAttention``,
``OctFormerBlock``, ``Downsample``, ``OctFormer``) over one padded cloud:
(N, 3) points, (N, C) features, an (N,) mask. Modules keep the flax names
(``stem_conv.w``, ``stage0_block1.attn.rpe_table``, ``down0.w``,
``fpn_lat2``, ``head_fc2``, ...), so ``utils/convert.dense_tree_state_dict``
carries a JAX tree in.

An octree level is a z-order-sorted voxel grid (``ops/voxel``, one cloud
as a batch of 1); coarsening is ``coords >> 1`` with each parent gathering
its 8 children into one matmul. A block's positional encoding is a
depthwise 27-stencil convolution; its attention splits the level's rows
into patches of ``patch_size`` (every ``dilation``-th row in the dilated
blocks, which alternate with plain ones), plain matmuls and a softmax in
f32 as JAX's einsums, with a relative-position bias of the clipped integer
offsets. The FPN decoder sums each level with its coarser neighbour's
parent, and the points read the finest stage's voxel. Norms are LayerNorm
with flax's eps 1e-6, GELU the tanh approximation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.voxel import (VoxelGrid, build_grid, gather_neighbors, gather_rows, lookup,
                         scatter_mean, voxelize_points)
from .ptv3 import _drop_rows

LN_EPS = 1e-6   # flax LayerNorm's
_CHILDREN = [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)]


@dataclasses.dataclass(frozen=True)
class OctFormerConfig:
    in_channels: int = 4
    num_classes: int = 13
    fpn_channels: int = 168
    channels: Tuple[int, ...] = (96, 192, 384, 384)
    num_blocks: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24, 24)
    patch_size: int = 26
    dilation: int = 4
    drop_path: float = 0.5
    stem_down: int = 2
    voxel_size: float = 0.05
    capacity: int = 8192
    bits: int = 10
    rpe_quant: int = 8

    @property
    def num_stages(self) -> int:
        return len(self.channels)


def _norm(c: int) -> nn.LayerNorm:
    return nn.LayerNorm(c, eps=LN_EPS)


def _rows(x: torch.Tensor, idx: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    """(cap, C) rows at (1, M) indices, 0 where missed: (M, C)."""
    return torch.where(hit[0, :, None], gather_rows(x[None], idx)[0], 0.0)


class OctreeDWConv(nn.Module):
    """Depthwise 27-stencil convolution, then a norm."""

    def __init__(self, features: int, bits: int = 10):
        super().__init__()
        self.bits = bits
        self.w = nn.Parameter(torch.randn(27, features) * 0.02)
        self.bn = _norm(features)

    def forward(self, grid: VoxelGrid, x: torch.Tensor) -> torch.Tensor:
        nb = gather_neighbors(grid, x[None], bits=self.bits)[0]      # (cap, 27, C)
        return self.bn((nb * self.w[None]).sum(dim=1)) * grid.mask[0, :, None]


class OctreeAttention(nn.Module):
    """Attention within patches of ``patch_size`` rows (with ``dilation``,
    every D-th row of a block of K D), with a relative-position bias."""

    def __init__(self, dim: int, num_heads: int, patch_size: int, dilation: int = 1,
                 use_rpe: bool = True, rpe_quant: int = 8, bits: int = 10):
        super().__init__()
        self.num_heads, self.patch_size, self.dilation = num_heads, patch_size, dilation
        self.rpe_quant = rpe_quant
        self.qkv, self.proj = nn.Linear(dim, 3 * dim), nn.Linear(dim, dim)
        if use_rpe:
            self.rpe_table = nn.Parameter(torch.randn(2 * rpe_quant + 1, num_heads, 3) * 0.02)

    def _part(self, t: torch.Tensor, pad: int, fill) -> torch.Tensor:
        K, D = self.patch_size, self.dilation
        t = torch.cat([t, t.new_full((pad,) + tuple(t.shape[1:]), fill)], dim=0)
        if D > 1:
            t = t.reshape(-1, K, D, *t.shape[1:]).transpose(1, 2)
        return t.reshape(-1, K, *t.shape[(3 if D > 1 else 1):])

    def forward(self, grid: VoxelGrid, x: torch.Tensor) -> torch.Tensor:
        cap, c = x.shape
        K, D, H = self.patch_size, self.dilation, self.num_heads
        hd = c // H
        pad = (-cap) % (K * D)
        mask = grid.mask[0]
        xm = self._part(x, pad, 0.0)
        vm = self._part(mask, pad, False)
        cm = self._part(grid.coords[0], pad, 0)
        qkv = self.qkv(xm).reshape(-1, K, 3, H, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))      # (P, H, K, hd)
        attn = torch.einsum("phkd,phmd->phkm", q * hd ** -0.5, k)
        if hasattr(self, "rpe_table"):
            L = self.rpe_quant
            rel = (cm[:, :, None, :] - cm[:, None, :, :] + L).clamp(0, 2 * L).long()
            bias = sum(self.rpe_table[rel[..., a], :, a] for a in range(3))   # (P, K, K, H)
            attn = attn + bias.permute(0, 3, 1, 2)
        attn = torch.where(vm[:, None, None, :], attn, torch.finfo(attn.dtype).min)
        attn = torch.where(vm[:, None, :, None], torch.softmax(attn, dim=-1), 0.0)
        out = torch.einsum("phkm,phmd->phkd", attn, v).transpose(1, 2).reshape(-1, c)
        if D > 1:
            out = out.reshape(-1, D, K, c).transpose(1, 2).reshape(-1, c)
        return self.proj(out[:cap]) * mask[:, None]


class OctFormerBlock(nn.Module):
    """The depthwise positional encoding, attention and MLP, with residuals."""

    def __init__(self, cfg: OctFormerConfig, dim: int, num_heads: int, dilation: int,
                 drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        self.cpe = OctreeDWConv(dim, cfg.bits)
        self.norm1 = _norm(dim)
        self.attn = OctreeAttention(dim, num_heads, cfg.patch_size, dilation,
                                    rpe_quant=cfg.rpe_quant, bits=cfg.bits)
        self.norm2 = _norm(dim)
        self.mlp_fc1, self.mlp_fc2 = nn.Linear(dim, 4 * dim), nn.Linear(4 * dim, dim)

    def forward(self, grid: VoxelGrid, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = 0.0 if deterministic else self.drop_path
        x = x + self.cpe(grid, x)
        x = x + _drop_rows(self.attn(grid, self.norm1(x)), rate, generator)
        m = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)), approximate="tanh"))
        return (x + _drop_rows(m, rate, generator)) * grid.mask[0, :, None]


class Downsample(nn.Module):
    """8 children -> their parent, one matmul, then a norm."""

    def __init__(self, c_in: int, features: int, capacity: int, bits: int = 10):
        super().__init__()
        self.capacity, self.bits = capacity, bits
        self.w = nn.Linear(8 * c_in, features, bias=False)
        self.norm = _norm(features)

    def forward(self, grid: VoxelGrid, x: torch.Tensor) -> Tuple[VoxelGrid, torch.Tensor]:
        pgrid, _ = build_grid(grid.coords >> 1, grid.mask, self.capacity, self.bits)
        offs = torch.tensor(_CHILDREN, dtype=torch.int32, device=x.device)
        parts = [_rows(x, *lookup(grid, (pgrid.coords << 1) + offs[o], self.bits))
                 for o in range(8)]
        h = self.w(torch.cat(parts, dim=-1))
        return pgrid, self.norm(h) * pgrid.mask[0, :, None]


class OctFormer(nn.Module):
    """``forward(coord (N, 3), feat (N, C), mask (N,))`` -> (N, num_classes)
    logits, 0 on padding."""

    def __init__(self, cfg: OctFormerConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.channels
        self.stem_conv = OctreeDWConv(cfg.in_channels, cfg.bits)
        self.stem_proj, self.stem_norm = nn.Linear(cfg.in_channels, ch[0]), _norm(ch[0])
        for s in range(cfg.stem_down):
            self.add_module(f"stem_down{s}", Downsample(ch[0], ch[0],
                                                        max(cfg.capacity >> (s + 1), 64),
                                                        cfg.bits))
        dpr = [cfg.drop_path * i / max(sum(cfg.num_blocks) - 1, 1)
               for i in range(sum(cfg.num_blocks))]
        cap = max(cfg.capacity >> cfg.stem_down, 64)
        for i in range(cfg.num_stages):
            for b in range(cfg.num_blocks[i]):
                self.add_module(f"stage{i}_block{b}", OctFormerBlock(
                    cfg, ch[i], cfg.num_heads[i], 1 if b % 2 == 0 else cfg.dilation,
                    dpr[sum(cfg.num_blocks[:i]) + b]))
            if i < cfg.num_stages - 1:
                cap = max(cap >> 1, 64)
                self.add_module(f"down{i}", Downsample(ch[i], ch[i + 1], cap, cfg.bits))
        for i in range(cfg.num_stages):
            self.add_module(f"fpn_lat{i}", nn.Linear(ch[i], cfg.fpn_channels))
        self.fpn_norm = _norm(cfg.fpn_channels)
        self.head_fc1 = nn.Linear(cfg.fpn_channels, cfg.fpn_channels)
        self.head_norm = _norm(cfg.fpn_channels)
        self.head_fc2 = nn.Linear(cfg.fpn_channels, cfg.num_classes)

    def forward(self, coord: torch.Tensor, feat: torch.Tensor, mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        grid, p2v, _ = voxelize_points(coord[None], mask[None], cfg.voxel_size, cfg.capacity,
                                       bits=cfg.bits)
        x = scatter_mean(p2v, feat[None], mask[None].to(feat.dtype), cfg.capacity)[0]
        x = self.stem_proj(self.stem_conv(grid, x))
        x = torch.relu(self.stem_norm(x)) * grid.mask[0, :, None]
        g = grid
        for s in range(cfg.stem_down):
            g, x = getattr(self, f"stem_down{s}")(g, x)
        feats, grids = [], []
        for i in range(cfg.num_stages):
            for b in range(cfg.num_blocks[i]):
                x = getattr(self, f"stage{i}_block{b}")(g, x, deterministic, generator)
            feats.append(x)
            grids.append(g)
            if i < cfg.num_stages - 1:
                g, x = getattr(self, f"down{i}")(g, x)
        out = None
        for i in reversed(range(cfg.num_stages)):
            lat = getattr(self, f"fpn_lat{i}")(feats[i]) * grids[i].mask[0, :, None]
            if out is None:
                out = lat
            else:
                out = lat + _rows(out, *lookup(grids[i + 1], grids[i].coords >> 1, cfg.bits))
        g0 = grids[0]
        out = torch.relu(self.fpn_norm(out)) * g0.mask[0, :, None]
        origin = torch.where(mask[:, None], coord, torch.inf).amin(dim=0)
        size = torch.tensor(cfg.voxel_size, dtype=coord.dtype, device=coord.device)
        pcoords = torch.floor((coord - origin) / size).to(torch.int32).clamp(
            0, (1 << cfg.bits) - 1) >> cfg.stem_down
        idx, hit = lookup(g0, pcoords[None], cfg.bits)
        pf = torch.where((hit[0] & mask)[:, None], gather_rows(out[None], idx)[0], 0.0)
        h = torch.relu(self.head_norm(self.head_fc1(pf)))
        return self.head_fc2(h) * mask[:, None]
