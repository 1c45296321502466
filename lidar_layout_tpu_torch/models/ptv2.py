"""Point Transformer V2 (m2): grouped vector attention over kNN.

Counterpart of ``lidar_layout_tpu/models/ptv2.py`` (``PTv2Config``,
``GroupedVectorAttention``, ``PTv2Block``, ``PTv2BlockSequence``,
``GridPool``, ``UnpoolWithSkip``, ``PointTransformerV2``) over one padded
cloud: (N, 3) points, (N, C) features, an (N,) mask. Modules keep the flax
names (``patch_proj.fc``, ``enc0_pool.fc``, ``enc1_blocks.block0.attn.
linear_p_bias.fc1``, ``dec0_up.proj_skip``, ``head_fc2``, ...), so
``utils/convert.dense_tree_state_dict`` carries a JAX tree in.

Grid pooling sorts the cells' codes into at most ``ceil(N * pool_ratio)``
segments (``ptv3.grid_pool_segments``; the overflow merges into the last),
takes the features' maximum (``_segment_max``: ``scatter_reduce(amax)``,
ties sharing the gradient as in JAX, an empty segment 0) and the points'
mean. Unpooling maps each point back through its segment ("map") or
interpolates its 3 nearest coarse points ("interp"). Invalid kNN slots take
-inf before the softmax; norms are LayerNorm with flax's eps 1e-6. With
``deterministic=False`` attention weights and whole rows of each block's
branch drop at the config's rates, drawn from ``generator``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.pointops import knn_query, three_nn_interpolate
from .ptv1 import masked_softmax
from .ptv3 import _drop_rows, grid_pool_segments, segment_mean

LN_EPS = 1e-6   # flax LayerNorm's


@dataclasses.dataclass(frozen=True)
class PTv2Config:
    in_channels: int = 4
    num_classes: int = 13
    patch_embed_depth: int = 1
    patch_embed_channels: int = 48
    patch_embed_groups: int = 6
    patch_embed_neighbours: int = 8
    enc_depths: Tuple[int, ...] = (2, 2, 6, 2)
    enc_channels: Tuple[int, ...] = (96, 192, 384, 512)
    enc_groups: Tuple[int, ...] = (12, 24, 48, 64)
    enc_neighbours: Tuple[int, ...] = (16, 16, 16, 16)
    dec_depths: Tuple[int, ...] = (1, 1, 1, 1)
    dec_channels: Tuple[int, ...] = (48, 96, 192, 384)
    dec_groups: Tuple[int, ...] = (6, 12, 24, 48)
    dec_neighbours: Tuple[int, ...] = (16, 16, 16, 16)
    grid_sizes: Tuple[float, ...] = (0.06, 0.12, 0.24, 0.48)
    pe_multiplier: bool = False
    pe_bias: bool = True
    attn_drop: float = 0.0
    drop_path: float = 0.0
    pool_ratios: Tuple[float, ...] = (0.5, 0.25, 0.125, 0.0625)
    unpool_backend: str = "map"   # "map" | "interp"


def _norm(c: int) -> nn.LayerNorm:
    return nn.LayerNorm(c, eps=LN_EPS)


class _LinearNormReLU(nn.Module):
    def __init__(self, c_in: int, c_out: int, bias: bool = True):
        super().__init__()
        self.fc, self.norm = nn.Linear(c_in, c_out, bias=bias), _norm(c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.norm(self.fc(x)))


class _PosMLP(nn.Module):
    """3 -> C -> norm, ReLU -> C."""

    def __init__(self, c: int):
        super().__init__()
        self.fc1, self.norm, self.fc2 = nn.Linear(3, c), _norm(c), nn.Linear(c, c)

    def forward(self, pos: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.norm(self.fc1(pos))))


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class GroupedVectorAttention(nn.Module):
    """Vector attention with a scalar weight per channel group:
    (N, C) features, (N, K) neighbour rows and their validity -> (N, C)."""

    def __init__(self, channels: int, groups: int, pe_multiplier: bool = False,
                 pe_bias: bool = True, attn_drop: float = 0.0):
        super().__init__()
        assert channels % groups == 0, f"channels {channels} not divisible by groups {groups}"
        c, g = channels, groups
        self.channels, self.groups, self.attn_drop = c, g, attn_drop
        self.pe_multiplier, self.pe_bias = pe_multiplier, pe_bias
        self.linear_q, self.linear_k = _LinearNormReLU(c, c), _LinearNormReLU(c, c)
        self.linear_v = nn.Linear(c, c)
        if pe_multiplier:
            self.linear_p_multiplier = _PosMLP(c)
        if pe_bias:
            self.linear_p_bias = _PosMLP(c)
        self.weight_fc1, self.weight_norm, self.weight_fc2 = nn.Linear(c, g), _norm(g), nn.Linear(g, g)

    def forward(self, feat, coord, ref_idx, ref_valid, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c, g = self.channels, self.groups
        q, k, v = self.linear_q(feat), self.linear_k(feat), self.linear_v(feat)
        pos = coord[ref_idx] - coord[:, None, :]
        rel = k[ref_idx] - q[:, None, :]
        if self.pe_multiplier:
            rel = rel * self.linear_p_multiplier(pos)
        val = v[ref_idx]
        if self.pe_bias:
            peb = self.linear_p_bias(pos)
            rel, val = rel + peb, val + peb
        w = self.weight_fc2(torch.relu(self.weight_norm(self.weight_fc1(rel))))
        w = masked_softmax(w, ref_valid[..., None])
        if not deterministic:
            w = _dropout(w, self.attn_drop, generator)
        val = val.reshape(val.shape[0], val.shape[1], g, c // g)
        return torch.einsum("nkgi,nkg->ngi", val, w).reshape(-1, c)


class PTv2Block(nn.Module):
    """fc1, grouped attention, fc3 and the residual, with stochastic depth."""

    def __init__(self, channels: int, groups: int, pe_multiplier: bool = False,
                 pe_bias: bool = True, attn_drop: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        c = channels
        self.drop_path = drop_path
        self.fc1, self.norm1 = nn.Linear(c, c, bias=False), _norm(c)
        self.attn = GroupedVectorAttention(c, groups, pe_multiplier, pe_bias, attn_drop)
        self.norm2 = _norm(c)
        self.fc3, self.norm3 = nn.Linear(c, c, bias=False), _norm(c)

    def forward(self, feat, coord, ref_idx, ref_valid, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = torch.relu(self.norm1(self.fc1(feat)))
        h = self.attn(h, coord, ref_idx, ref_valid, deterministic, generator)
        h = self.norm3(self.fc3(torch.relu(self.norm2(h))))
        if not deterministic:
            h = _drop_rows(h, self.drop_path, generator)
        return torch.relu(feat + h)


class PTv2BlockSequence(nn.Module):
    """One kNN a stage, then ``depth`` blocks over it."""

    def __init__(self, depth: int, channels: int, groups: int, neighbours: int,
                 pe_multiplier: bool = False, pe_bias: bool = True, attn_drop: float = 0.0,
                 drop_path_rates: Sequence[float] = ()):
        super().__init__()
        self.depth, self.neighbours = depth, neighbours
        rates = list(drop_path_rates) or [0.0] * depth
        for b in range(depth):
            self.add_module(f"block{b}", PTv2Block(channels, groups, pe_multiplier, pe_bias,
                                                   attn_drop, rates[b]))

    def forward(self, feat, coord, mask, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ref_idx, _ = knn_query(coord, coord, min(self.neighbours, coord.shape[0]),
                               points_mask=mask)
        ref_valid = mask[ref_idx] & mask[:, None]
        for b in range(self.depth):
            feat = getattr(self, f"block{b}")(feat, coord, ref_idx, ref_valid, deterministic,
                                              generator)
        return feat * mask[:, None]


def _segment_max(x: torch.Tensor, seg: torch.Tensor, mask: torch.Tensor,
                 capacity: int) -> torch.Tensor:
    """Per-segment maximum of the masked rows (the dtype's least value
    stands for padding and reads 0)."""
    neg = torch.finfo(x.dtype).min
    vals = torch.where(mask[:, None], x, neg)
    out = x.new_full((capacity, x.shape[-1]), neg).scatter_reduce(
        0, seg[:, None].expand_as(vals), vals, "amax", include_self=True)
    return torch.where(torch.isfinite(out) & (out > neg / 2), out, 0.0)


class GridPool(nn.Module):
    """fc, then pooling on a grid of ``grid_size`` cells: features by their
    maximum, points by their mean, into ``capacity`` segments. Returns
    ((points, features, mask), each row's segment)."""

    def __init__(self, c_in: int, channels: int, grid_size: float):
        super().__init__()
        self.grid_size = grid_size
        self.fc, self.norm = nn.Linear(c_in, channels, bias=False), _norm(channels)

    def forward(self, feat, coord, mask, capacity: int):
        feat = torch.relu(self.norm(self.fc(feat)))
        origin = torch.where(mask[:, None], coord, torch.inf).amin(dim=0)
        size = torch.tensor(self.grid_size, dtype=coord.dtype, device=coord.device)
        cell = torch.floor((coord - origin) / size).to(torch.int32).clamp(0, (1 << 10) - 1)
        code = (cell[:, 0] << 20) | (cell[:, 1] << 10) | cell[:, 2]
        seg, seg_valid, _ = grid_pool_segments(code, mask, capacity)
        new_feat = _segment_max(feat, seg, mask, capacity)
        new_coord = segment_mean(coord, seg, mask, capacity)
        return (new_coord, new_feat * seg_valid[:, None], seg_valid), seg


class UnpoolWithSkip(nn.Module):
    """proj(coarse) mapped ("map") or interpolated ("interp") to the fine
    rows, plus proj_skip(fine)."""

    def __init__(self, c_in: int, c_skip: int, channels: int, backend: str = "map"):
        super().__init__()
        self.backend = backend
        self.proj = _LinearNormReLU(c_in, channels)
        self.proj_skip = _LinearNormReLU(c_skip, channels)

    def forward(self, feat, coord, mask, skip_feat, skip_coord, skip_mask, cluster):
        h = self.proj(feat)
        if self.backend == "map" and cluster is not None:
            h = h[cluster]
        else:
            h = three_nn_interpolate(skip_coord, coord, h, points_mask=mask)
        return (h + self.proj_skip(skip_feat)) * skip_mask[:, None]


class PointTransformerV2(nn.Module):
    """U-shaped PT-v2: ``forward(coord (N, 3), feat (N, Cin), mask (N,))``
    -> (N, num_classes) logits, or (N, dec_channels[0]) features when
    ``num_classes`` is 0; 0 on padding."""

    def __init__(self, cfg: PTv2Config):
        super().__init__()
        self.cfg = cfg
        stages = len(cfg.enc_depths)
        enc_dpr, dec_dpr = self._rates(cfg.enc_depths), self._rates(cfg.dec_depths)
        pe = (cfg.pe_multiplier, cfg.pe_bias, cfg.attn_drop)
        self.patch_proj = _LinearNormReLU(cfg.in_channels, cfg.patch_embed_channels, bias=False)
        self.patch_blocks = PTv2BlockSequence(cfg.patch_embed_depth, cfg.patch_embed_channels,
                                              cfg.patch_embed_groups,
                                              cfg.patch_embed_neighbours, *pe)
        widths = [cfg.patch_embed_channels]
        for i in range(stages):
            self.add_module(f"enc{i}_pool", GridPool(widths[-1], cfg.enc_channels[i],
                                                     cfg.grid_sizes[i]))
            base = sum(cfg.enc_depths[:i])
            self.add_module(f"enc{i}_blocks", PTv2BlockSequence(
                cfg.enc_depths[i], cfg.enc_channels[i], cfg.enc_groups[i],
                cfg.enc_neighbours[i], *pe, enc_dpr[base:base + cfg.enc_depths[i]]))
            widths.append(cfg.enc_channels[i])
        width = widths[-1]
        for i in reversed(range(stages)):
            self.add_module(f"dec{i}_up", UnpoolWithSkip(width, widths[i], cfg.dec_channels[i],
                                                         cfg.unpool_backend))
            base = sum(cfg.dec_depths[:i])
            self.add_module(f"dec{i}_blocks", PTv2BlockSequence(
                cfg.dec_depths[i], cfg.dec_channels[i], cfg.dec_groups[i],
                cfg.dec_neighbours[i], *pe, dec_dpr[base:base + cfg.dec_depths[i]]))
            width = cfg.dec_channels[i]
        if cfg.num_classes > 0:
            c0 = cfg.dec_channels[0]
            self.head_fc1, self.head_norm = nn.Linear(c0, c0), _norm(c0)
            self.head_fc2 = nn.Linear(c0, cfg.num_classes)

    def _rates(self, depths: Sequence[int]) -> List[float]:
        tot = sum(depths)
        return [self.cfg.drop_path * i / max(tot - 1, 1) for i in range(tot)]

    def forward(self, coord: torch.Tensor, feat: torch.Tensor, mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        n = coord.shape[0]
        h = self.patch_blocks(self.patch_proj(feat), coord, mask, deterministic, generator)
        skips = []
        cur_coord, cur_mask = coord, mask
        for i in range(len(cfg.enc_depths)):
            (new_coord, pooled, new_mask), cluster = getattr(self, f"enc{i}_pool")(
                h, cur_coord, cur_mask, max(int(n * cfg.pool_ratios[i]), 1))
            skips.append((h, cur_coord, cur_mask, cluster))
            h = getattr(self, f"enc{i}_blocks")(pooled, new_coord, new_mask, deterministic,
                                                generator)
            cur_coord, cur_mask = new_coord, new_mask
        for i in reversed(range(len(cfg.enc_depths))):
            skip_feat, skip_coord, skip_mask, cluster = skips[i]
            h = getattr(self, f"dec{i}_up")(h, cur_coord, cur_mask, skip_feat, skip_coord,
                                            skip_mask,
                                            cluster if cfg.unpool_backend == "map" else None)
            h = getattr(self, f"dec{i}_blocks")(h, skip_coord, skip_mask, deterministic,
                                                generator)
            cur_coord, cur_mask = skip_coord, skip_mask
        if cfg.num_classes > 0:
            h = self.head_fc2(torch.relu(self.head_norm(self.head_fc1(h))))
        return h * mask[:, None]
