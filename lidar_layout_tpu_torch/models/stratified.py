"""Stratified Transformer (ST-v1m1): window attention over an edge list.

Counterpart of ``lidar_layout_tpu/models/stratified.py`` (``StratifiedConfig``,
``window_buckets``, ``dense_window_edges``, ``stratified_edges``, ``KPConv``,
``KPConvSimpleBlock``, ``KPConvResBlock``, ``WindowAttention``,
``SwinBlock``, ``TransitionDown``, ``Upsample``, ``BasicLayer``,
``StratifiedTransformer``) over one padded cloud: (N, 3) points, (N, C)
features, an (N,) mask. Modules keep the flax names (``stem0.kpconv.w``,
``layer1.block0.attn.rel_query_table``, ``down1.linear``, ``up2.linear2``,
``cls_fc2``, ...), so ``utils/convert.dense_tree_state_dict`` carries a JAX
tree in.

Windows are fixed-capacity buckets of z-order window codes: the points
sorted by code (stably, as ``jnp.argsort``), each window a segment, a point's
rank in its window its slot; windows past ``n_windows`` merge into the last
row and points past ``window_capacity`` get no slot (they keep their
residual path). Dense edges are every slot pair of a window; stratified
edges join each query to the FPS-sampled keys of its enclosing 2x window
(found by a binary search of the sampled windows' sorted codes), less keys
that share its fine window. A layer attends over the valid edges alone
(``valid_edges``; JAX keeps the fixed capacity under a mask): the same sums
without the memory of the masked ones. Relative positions index the tables by
``floor((rel + 2 w - 1e-4) / q)`` (``torch.div(..., rounding_mode="floor")``,
``jnp``'s ``//``). Attention is ``ops/pointops2``. The KPConv stem uses
Fibonacci-sphere kernel points and the linear correlation
``max(0, 1 - d / sigma)``. Norms are LayerNorm with flax's eps 1e-6, GELU
the tanh approximation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pointops import farthest_point_sample, knn_query, three_nn_interpolate
from ..ops.pointops2 import (attention_step1, attention_step2,
                             attention_step2_with_rel_pos_value, dot_prod_with_idx,
                             segment_softmax)
from ..ops.serialization import z_order_code
from ..ops.voxel import PAD_CODE
from .ptv1 import masked_max
from .ptv3 import _drop_rows

LN_EPS = 1e-6   # flax LayerNorm's


@dataclasses.dataclass(frozen=True)
class StratifiedConfig:
    in_channels: int = 3
    num_classes: int = 13
    channels: Tuple[int, ...] = (48, 96, 192, 384)
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: Tuple[float, ...] = (0.8, 1.6, 3.2, 6.4)
    quant_size: Tuple[float, ...] = (0.04, 0.08, 0.16, 0.32)
    rel_query: bool = True
    rel_key: bool = True
    rel_value: bool = True
    drop_path_rate: float = 0.2
    mlp_ratio: float = 4.0
    up_k: int = 3
    ratio: float = 0.25
    k: int = 16
    downsample_scale: int = 8
    stem_transformer: bool = False
    prev_grid_size: float = 0.04
    sigma: float = 1.0
    kp_neighbors: int = 16
    kp_kernel_points: int = 15
    n_windows: int = 128
    window_capacity: int = 48
    sample_capacity: int = 16
    bits: int = 10

    @property
    def num_layers(self) -> int:
        return len(self.channels)


def _norm(c: int) -> nn.LayerNorm:
    return nn.LayerNorm(c, eps=LN_EPS)


def _cells(coord: torch.Tensor, origin: torch.Tensor, offset: float, size: float,
           bits: int) -> torch.Tensor:
    """Integer cells of ``size`` from ``origin`` (less ``offset``), clipped."""
    size_t = torch.tensor(size, dtype=coord.dtype, device=coord.device)
    return torch.floor((coord - origin + offset) / size_t).to(torch.int32).clamp(
        0, (1 << bits) - 1)


def window_buckets(coord: torch.Tensor, mask: torch.Tensor, win: float, n_windows: int,
                   cap: int, bits: int = 10, shift: bool = False):
    """(bucket (n_windows, cap) point rows with ``N`` for an empty slot,
    bucket_valid, the windows' sorted codes (PAD_CODE past the last), each
    point's window code). ``shift`` moves the windows by half a window."""
    n = coord.shape[0]
    dev = coord.device
    origin = torch.where(mask[:, None], coord, torch.inf).amin(dim=0)
    codes = z_order_code(_cells(coord, origin, win / 2.0 if shift else 0.0, win, bits), bits)
    keyed = torch.where(mask, codes, PAD_CODE)
    order = torch.argsort(keyed, stable=True)
    sc = keyed[order]
    sm = sc != PAD_CODE
    head = torch.cat([sm.new_ones(1), sc[1:] != sc[:-1]]) & sm
    seg = (torch.cumsum(head.long(), 0) - 1).clamp(0, n_windows - 1)
    pos = torch.arange(n, device=dev)
    rank = pos - torch.cummax(torch.where(head, pos, -1), 0).values
    win_codes = torch.full((n_windows,), PAD_CODE, dtype=torch.int32, device=dev).scatter_reduce(
        0, seg, torch.where(sm, sc, PAD_CODE), "amin")
    ok = sm & (rank < cap)
    slot = torch.where(ok, seg, n_windows - 1) * cap + torch.where(ok, rank, cap - 1)
    bucket = torch.full((n_windows * cap,), -1, dtype=torch.long, device=dev).scatter_reduce(
        0, slot, torch.where(ok, order, -1), "amax").view(n_windows, cap)
    valid = bucket >= 0
    return torch.where(valid, bucket, n), valid, win_codes, keyed


def dense_window_edges(bucket: torch.Tensor, bucket_valid: torch.Tensor, n: int):
    """Every slot pair of each window: (M,) index0, index1 and mask, M =
    n_windows cap^2; a masked edge points at row 0."""
    w, cap = bucket.shape
    i0 = bucket[:, :, None].expand(w, cap, cap).reshape(-1)
    i1 = bucket[:, None, :].expand(w, cap, cap).reshape(-1)
    m = (bucket_valid[:, :, None] & bucket_valid[:, None, :]).reshape(-1)
    return torch.where(m, i0, 0), torch.where(m, i1, 0), m


def valid_edges(index0: torch.Tensor, index1: torch.Tensor, mask: torch.Tensor):
    """The edges ``mask`` keeps, their mask all true: every op of
    ``ops/pointops2`` adds a masked edge as an exact 0, so the sums are the
    same, without the memory of the masked tail (the fixed capacity is
    n_windows cap^2 edges however few points a level holds)."""
    keep = mask.nonzero().squeeze(1)
    return index0[keep], index1[keep], mask[keep]


def stratified_edges(coord: torch.Tensor, mask: torch.Tensor, fine_code: torch.Tensor,
                     win: float, cfg: StratifiedConfig, n_sampled: int, shift: bool):
    """Each query to the FPS-sampled keys of its enclosing 2x window, less
    those in its own fine window: (N * sample_capacity,) edges."""
    n = coord.shape[0]
    sidx = farthest_point_sample(coord, n_sampled, mask)
    scoord, smask = coord[sidx], mask[sidx]
    sbucket, sb_valid, swin_codes, _ = window_buckets(scoord, smask, 2.0 * win, cfg.n_windows,
                                                      cfg.sample_capacity, cfg.bits, shift)
    origin = torch.where(smask[:, None], scoord, torch.inf).amin(dim=0)
    qcode = z_order_code(_cells(coord, origin, win if shift else 0.0, 2.0 * win, cfg.bits),
                         cfg.bits)
    row = torch.searchsorted(swin_codes, qcode).clamp(0, cfg.n_windows - 1)
    row_hit = (swin_codes[row] == qcode) & mask
    keys = sidx[sbucket[row].clamp(max=n_sampled - 1)]          # (N, cap_s)
    kvalid = sb_valid[row] & row_hit[:, None] & (fine_code[keys] != fine_code[:, None])
    i0 = torch.arange(n, device=coord.device)[:, None].expand_as(keys).reshape(-1)
    i1, m = keys.reshape(-1), kvalid.reshape(-1)
    return torch.where(m, i0, 0), torch.where(m, i1, 0), m


def fibonacci_sphere(n: int, device=None) -> torch.Tensor:
    """The centre and n - 1 points on the unit sphere: (n, 3)."""
    i = torch.arange(1, n, dtype=torch.float32, device=device)
    phi = math.pi * (3.0 - math.sqrt(5.0))
    y = 1.0 - 2.0 * i / max(n - 1, 1)
    r = torch.sqrt(torch.clamp(1.0 - y * y, 0.0, 1.0))
    pts = torch.stack([r * torch.cos(phi * i), y, r * torch.sin(phi * i)], dim=-1)
    return torch.cat([torch.zeros((1, 3), device=device), pts], dim=0)


class KPConv(nn.Module):
    """Kernel-point convolution over each point's kNN: one (N, P C) x
    (P C, C') matmul of correlation-weighted neighbour features."""

    def __init__(self, c_in: int, features: int, influence: float, n_kernel: int = 15,
                 k: int = 16):
        super().__init__()
        self.influence, self.n_kernel, self.k = influence, n_kernel, k
        self.w = nn.Linear(n_kernel * c_in, features, bias=False)

    def forward(self, coord, feat, mask):
        idx, _ = knn_query(coord, coord, self.k, mask)
        rel = coord[idx] - coord[:, None, :]
        kp = fibonacci_sphere(self.n_kernel, coord.device) * self.influence
        d = torch.linalg.vector_norm(rel[:, :, None, :] - kp[None, None], dim=-1)
        corr = torch.clamp(1.0 - d / self.influence, min=0.0)           # (N, K, P)
        nf = feat[idx] * mask[idx][..., None]
        agg = torch.einsum("nkp,nkc->npc", corr, nf).reshape(coord.shape[0], -1)
        return self.w(agg) * mask[:, None]


class KPConvSimpleBlock(nn.Module):
    def __init__(self, c_in, features, influence, n_kernel=15, k=16):
        super().__init__()
        self.kpconv = KPConv(c_in, features, influence, n_kernel, k)
        self.bn = _norm(features)

    def forward(self, coord, feat, mask):
        return F.leaky_relu(self.bn(self.kpconv(coord, feat, mask)), 0.2) * mask[:, None]


class KPConvResBlock(nn.Module):
    """unary (C/4), KPConv, unary (C), and the (projected) shortcut."""

    def __init__(self, c_in, features, influence, n_kernel=15, k=16):
        super().__init__()
        d2 = features // 4
        self.unary1, self.n1 = nn.Linear(c_in, d2, bias=False), _norm(d2)
        self.kpconv = KPConv(d2, d2, influence, n_kernel, k)
        self.unary2, self.n2 = nn.Linear(d2, features, bias=False), _norm(features)
        if c_in != features:
            self.shortcut, self.nsc = nn.Linear(c_in, features, bias=False), _norm(features)

    def forward(self, coord, feat, mask):
        h = F.leaky_relu(self.n1(self.unary1(feat)), 0.2)
        h = self.kpconv(coord, h, mask)
        h = F.leaky_relu(self.n2(self.unary2(h)), 0.2)
        sc = self.nsc(self.shortcut(feat)) if hasattr(self, "shortcut") else feat
        return (h + sc) * mask[:, None]


def _table(length: int, heads: int, d: int) -> nn.Parameter:
    t = torch.empty((length, heads, d, 3))
    nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04)
    return nn.Parameter(t)


class WindowAttention(nn.Module):
    """Edge-list attention with quantised relative-position tables for the
    query, the key and the value."""

    def __init__(self, dim: int, num_heads: int, window_size: float, quant_size: float,
                 rel_query: bool = True, rel_key: bool = True, rel_value: bool = True):
        super().__init__()
        self.num_heads, self.window_size, self.quant_size = num_heads, window_size, quant_size
        self.qkv, self.proj = nn.Linear(dim, 3 * dim), nn.Linear(dim, dim)
        self.L = int((2.0 * window_size + 1e-4) // quant_size)
        d = dim // num_heads
        for name, on in (("rel_query_table", rel_query), ("rel_key_table", rel_key),
                         ("rel_value_table", rel_value)):
            if on:
                self.register_parameter(name, _table(2 * self.L, num_heads, d))

    def forward(self, coord, feat, index0, index1, emask):
        n, c = feat.shape
        h = self.num_heads
        d = c // h
        scale = d ** -0.5
        qkv = self.qkv(feat).reshape(n, 3, h, d)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        rel = coord[index0] - coord[index1]
        quant = torch.tensor(self.quant_size, dtype=rel.dtype, device=rel.device)
        rel_idx = torch.div(rel + 2.0 * self.window_size - 1e-4, quant,
                            rounding_mode="floor").to(torch.int32).clamp(0, 2 * self.L - 1)
        attn = attention_step1(q * scale, k, index0, index1, emask)
        if hasattr(self, "rel_query_table"):
            attn = attn + dot_prod_with_idx(q * scale, index0, self.rel_query_table, rel_idx,
                                            emask)
        if hasattr(self, "rel_key_table"):
            attn = attn + dot_prod_with_idx(k, index1, self.rel_key_table, rel_idx, emask)
        attn = segment_softmax(attn, index0, n, emask)
        if hasattr(self, "rel_value_table"):
            out = attention_step2_with_rel_pos_value(attn, v, index0, index1,
                                                     self.rel_value_table, rel_idx, n, emask)
        else:
            out = attention_step2(attn, v, index0, index1, n, emask)
        return self.proj(out.reshape(n, c))


class SwinBlock(nn.Module):
    """LN, window attention, LN, MLP, with stochastic depth on both branches."""

    def __init__(self, cfg: StratifiedConfig, dim: int, num_heads: int, window_size: float,
                 quant_size: float, drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = _norm(dim)
        self.attn = WindowAttention(dim, num_heads, window_size, quant_size, cfg.rel_query,
                                    cfg.rel_key, cfg.rel_value)
        self.norm2 = _norm(dim)
        hidden = int(dim * cfg.mlp_ratio)
        self.mlp_fc1, self.mlp_fc2 = nn.Linear(dim, hidden), nn.Linear(hidden, dim)

    def forward(self, coord, feat, mask, index0, index1, emask, deterministic=True,
                generator=None):
        rate = 0.0 if deterministic else self.drop_path
        h = self.attn(coord, self.norm1(feat), index0, index1, emask)
        feat = feat + _drop_rows(h, rate, generator)
        m = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(feat)), approximate="tanh"))
        return (feat + _drop_rows(m, rate, generator)) * mask[:, None]


class TransitionDown(nn.Module):
    """FPS to ``n_out`` rows, each the maximum of its kNN's linear(norm(x))."""

    def __init__(self, c_in: int, features: int, k: int = 16):
        super().__init__()
        self.k = k
        self.norm, self.linear = _norm(c_in), nn.Linear(c_in, features, bias=False)

    def forward(self, coord, feat, mask, n_out: int):
        sidx = farthest_point_sample(coord, n_out, mask)
        scoord, smask = coord[sidx], mask[sidx]
        idx, _ = knn_query(scoord, coord, self.k, mask)
        pooled = masked_max(self.linear(self.norm(feat))[idx], mask[idx][..., None])
        return scoord, pooled * smask[:, None], smask


class Upsample(nn.Module):
    """linear1(skip) plus the 3-NN interpolation of linear2(x)."""

    def __init__(self, c_in: int, c_up: int, features: int):
        super().__init__()
        self.n1, self.linear1 = _norm(c_up), nn.Linear(c_up, features)
        self.n2, self.linear2 = _norm(c_in), nn.Linear(c_in, features)

    def forward(self, coord, feat, mask, up_coord, up_feat, up_mask):
        a = self.linear1(self.n1(up_feat))
        b = three_nn_interpolate(up_coord, coord, self.linear2(self.n2(feat)), mask)
        return (a + b) * up_mask[:, None]


class BasicLayer(nn.Module):
    """Swin blocks over two edge lists (windows unshifted, then shifted),
    alternating."""

    def __init__(self, cfg: StratifiedConfig, dim: int, depth: int, num_heads: int,
                 window_size: float, quant_size: float, drop_paths: Tuple[float, ...]):
        super().__init__()
        self.cfg, self.depth, self.window_size = cfg, depth, window_size
        for i in range(depth):
            self.add_module(f"block{i}", SwinBlock(cfg, dim, num_heads, window_size,
                                                   quant_size, drop_paths[i]))

    def forward(self, coord, feat, mask, deterministic=True, generator=None):
        cfg = self.cfg
        n = coord.shape[0]
        n_sampled = max(n // cfg.downsample_scale, 1)
        edges = []
        for shift in (False, True):
            bucket, bvalid, _, pcode = window_buckets(coord, mask, self.window_size,
                                                      cfg.n_windows, cfg.window_capacity,
                                                      cfg.bits, shift)
            dense = dense_window_edges(bucket, bvalid, n)
            strat = stratified_edges(coord, mask, pcode, self.window_size, cfg, n_sampled, shift)
            edges.append(valid_edges(*(torch.cat([a, b]) for a, b in zip(dense, strat))))
        for i in range(self.depth):
            feat = getattr(self, f"block{i}")(coord, feat, mask, *edges[i % 2], deterministic,
                                              generator)
        return feat


def level_counts(n: int, levels: int, ratio: float) -> list:
    """Rows a level: N, then ``int(previous * ratio) + 1`` each."""
    counts = [n]
    for _ in range(levels - 1):
        counts.append(max(int(counts[-1] * ratio) + 1, 1))
    return counts


def _drop_path_rates(rate: float, depths) -> list:
    tot = sum(depths)
    return [rate * i / max(tot - 1, 1) for i in range(tot)]


class StratifiedTransformer(nn.Module):
    """``forward(coord (N, 3), feat (N, C), mask (N,))`` -> (N, num_classes)
    logits, 0 on padding."""

    def __init__(self, cfg: StratifiedConfig):
        super().__init__()
        self.cfg = cfg
        ch, L = cfg.channels, cfg.num_layers
        dpr = _drop_path_rates(cfg.drop_path_rate, cfg.depths)
        influence = cfg.prev_grid_size * cfg.sigma
        kp = (influence, cfg.kp_kernel_points, cfg.kp_neighbors)
        self.stem0 = KPConvSimpleBlock(cfg.in_channels, ch[0], *kp)
        self.layer_start = 0 if cfg.stem_transformer else 1
        if not cfg.stem_transformer:
            self.stem1 = KPConvResBlock(ch[0], ch[0], *kp)
        if self.layer_start == 1:
            self.down0 = TransitionDown(ch[0], ch[1], cfg.k)
        for i in range(self.layer_start, L):
            self.add_module(f"layer{i}", BasicLayer(
                cfg, ch[i], cfg.depths[i], cfg.num_heads[i], cfg.window_size[i],
                cfg.quant_size[i], tuple(dpr[sum(cfg.depths[:i]):sum(cfg.depths[:i + 1])])))
            if i < L - 1:
                self.add_module(f"down{i}", TransitionDown(ch[i], ch[i + 1], cfg.k))
        for i in range(L - 1, 0, -1):
            self.add_module(f"up{i}", Upsample(ch[i], ch[i - 1], ch[i - 1]))
        self.cls_fc1, self.cls_norm = nn.Linear(ch[0], ch[0]), _norm(ch[0])
        self.cls_fc2 = nn.Linear(ch[0], cfg.num_classes)

    def forward(self, coord: torch.Tensor, feat: torch.Tensor, mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        counts = level_counts(coord.shape[0], cfg.num_layers, cfg.ratio)
        h = self.stem0(coord, feat, mask)
        if not cfg.stem_transformer:
            h = self.stem1(coord, h, mask)
        skips = []
        c, f, m = coord, h, mask
        if self.layer_start == 1:
            skips.append((c, f, m))
            c, f, m = self.down0(c, f, m, counts[1])
        for i in range(self.layer_start, cfg.num_layers):
            f = getattr(self, f"layer{i}")(c, f, m, deterministic, generator)
            skips.append((c, f, m))
            if i < cfg.num_layers - 1:
                c, f, m = getattr(self, f"down{i}")(c, f, m, counts[i + 1])
        c, f, m = skips.pop(-1)
        for i in range(cfg.num_layers - 1, 0, -1):
            uc, uf, um = skips.pop(-1)
            f = getattr(self, f"up{i}")(c, f, m, uc, uf, um)
            c, m = uc, um
        f = torch.relu(self.cls_norm(self.cls_fc1(f)))
        return self.cls_fc2(f) * mask[:, None]
