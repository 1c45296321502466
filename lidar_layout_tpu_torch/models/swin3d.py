"""Swin3D (Swin3D-v1m1): shifted-window voxel attention with cRSE.

Counterpart of ``lidar_layout_tpu/models/swin3d.py`` (``Swin3DConfig``,
``CRSEWindowAttention``, ``Swin3DBlock``, ``BasicLayer``, ``Swin3DUNet``)
over one padded cloud: (N, 3) points, (N, C) features, an (N,) mask.
Modules keep the flax names (``stem_conv``, ``layer0.block0.attn.
query_xyz_table``, ``down0.linear``, ``up1.linear2``, ``head_fc2``, ...), so
``utils/convert.dense_tree_state_dict`` carries a JAX tree in.

The cloud is voxelised at ``base_grid_size`` into ``capacity`` rows (voxel
centres and features as means); a 27-stencil convolution is the stem. Each
layer attends over the valid dense edges of fixed-capacity windows of
``window_sizes[i]`` voxels (``stratified.window_buckets``, ``valid_edges``),
unshifted and shifted in turn, with contextual relative signal encoding:
query, key and value tables indexed by the quantised relative position and, with
``crse="XYZ_RGB"``, by the relative colour (the features' first 3
channels), through ``ops/pointops2``. Down-sampling is FPS with a kNN
maximum (the colour rides along by the samples), up-sampling 3-NN
interpolation (``stratified.TransitionDown``, ``Upsample``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pointops import farthest_point_sample
from ..ops.pointops2 import (attention_step1, attention_step2_with_rel_pos_value,
                             dot_prod_with_idx, segment_softmax)
from ..ops.voxel import gather_neighbors, scatter_mean, voxelize_points
from .ptv3 import _drop_rows
from .stratified import (TransitionDown, Upsample, _drop_path_rates, _table,
                         dense_window_edges, level_counts, valid_edges, window_buckets)

LN_EPS = 1e-6   # flax LayerNorm's


@dataclasses.dataclass(frozen=True)
class Swin3DConfig:
    in_channels: int = 6            # xyz-signal features (rgb in [-1, 1])
    num_classes: int = 13
    channels: Tuple[int, ...] = (48, 96, 192, 384, 384)
    depths: Tuple[int, ...] = (2, 4, 9, 4, 4)
    num_heads: Tuple[int, ...] = (6, 6, 12, 24, 24)
    window_sizes: Tuple[int, ...] = (5, 7, 7, 7, 7)
    quant_size: int = 4
    base_grid_size: float = 0.04
    ratio: float = 0.25
    k: int = 16
    up_k: int = 3
    drop_path_rate: float = 0.2
    crse: str = "XYZ_RGB"
    stem_transformer: bool = True
    capacity: int = 8192
    n_windows: int = 128
    window_capacity: int = 48
    bits: int = 10

    @property
    def num_layers(self) -> int:
        return len(self.channels)


def _norm(c: int) -> nn.LayerNorm:
    return nn.LayerNorm(c, eps=LN_EPS)


class CRSEWindowAttention(nn.Module):
    """Edge-list window attention with per-modality (xyz, rgb) query, key
    and value tables of shape (L, heads, head dim, 3)."""

    def __init__(self, dim: int, num_heads: int, window_size: int, quant_size: int,
                 grid_size: float, crse: str = "XYZ_RGB"):
        super().__init__()
        self.num_heads, self.window_size, self.quant_size = num_heads, window_size, quant_size
        self.grid_size, self.use_rgb = grid_size, "RGB" in crse
        self.qkv, self.proj = nn.Linear(dim, 3 * dim), nn.Linear(dim, dim)
        d = dim // num_heads
        self.lengths = {"xyz": 2 * window_size * quant_size}
        if self.use_rgb:
            self.lengths["rgb"] = 2 * (2 * (quant_size * 2))
        for name, length in self.lengths.items():
            for role in ("query", "key", "value"):
                self.register_parameter(f"{role}_{name}_table", _table(length, num_heads, d))

    def forward(self, xyz, sig, feat, index0, index1, emask):
        n, c = feat.shape
        h = self.num_heads
        d = c // h
        scale = d ** -0.5
        qkv = self.qkv(feat).reshape(n, 3, h, d)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        attn = attention_step1(q * scale, k, index0, index1, emask)
        grid = torch.tensor(self.grid_size, dtype=xyz.dtype, device=xyz.device)
        rel = (xyz[index0] - xyz[index1]) / grid
        ridx = {"xyz": ((rel + self.window_size) * self.quant_size).to(torch.int32).clamp(
            0, self.lengths["xyz"] - 1)}
        if self.use_rgb and sig is not None:
            rels = sig[index0, :3] - sig[index1, :3]
            ridx["rgb"] = ((rels + 2.0) * (self.quant_size * 2)).to(torch.int32).clamp(
                0, self.lengths["rgb"] - 1)
        for name, r in ridx.items():
            attn = attn + dot_prod_with_idx(q * scale, index0, getattr(self, f"query_{name}_table"),
                                            r, emask)
            attn = attn + dot_prod_with_idx(k, index1, getattr(self, f"key_{name}_table"), r,
                                            emask)
        attn = segment_softmax(attn, index0, n, emask)
        names = list(ridx)
        out = attention_step2_with_rel_pos_value(attn, v, index0, index1,
                                                 self.value_xyz_table, ridx["xyz"], n, emask)
        zero_v = torch.zeros_like(v)
        for name in names[1:]:
            out = out + attention_step2_with_rel_pos_value(
                attn, zero_v, index0, index1, getattr(self, f"value_{name}_table"), ridx[name],
                n, emask)
        return self.proj(out.reshape(n, c))


class Swin3DBlock(nn.Module):
    """LN, cRSE window attention, LN, MLP (4x), stochastic depth."""

    def __init__(self, cfg: Swin3DConfig, dim: int, num_heads: int, window_size: int,
                 drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = _norm(dim)
        self.attn = CRSEWindowAttention(dim, num_heads, window_size, cfg.quant_size,
                                        cfg.base_grid_size, cfg.crse)
        self.norm2 = _norm(dim)
        self.mlp_fc1, self.mlp_fc2 = nn.Linear(dim, 4 * dim), nn.Linear(4 * dim, dim)

    def forward(self, xyz, sig, feat, mask, index0, index1, emask, deterministic=True,
                generator=None):
        rate = 0.0 if deterministic else self.drop_path
        feat = feat + _drop_rows(self.attn(xyz, sig, self.norm1(feat), index0, index1, emask),
                                 rate, generator)
        m = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(feat)), approximate="tanh"))
        return (feat + _drop_rows(m, rate, generator)) * mask[:, None]


class BasicLayer(nn.Module):
    """Blocks over the unshifted and the shifted windows' dense edges, in turn."""

    def __init__(self, cfg: Swin3DConfig, dim: int, depth: int, num_heads: int,
                 window_size: int, drop_paths: Tuple[float, ...]):
        super().__init__()
        self.cfg, self.depth, self.window_size = cfg, depth, window_size
        for i in range(depth):
            self.add_module(f"block{i}", Swin3DBlock(cfg, dim, num_heads, window_size,
                                                     drop_paths[i]))

    def forward(self, xyz, sig, feat, mask, deterministic=True, generator=None):
        cfg = self.cfg
        win = self.window_size * cfg.base_grid_size
        edges = []
        for shift in (False, True):
            bucket, bvalid, _, _ = window_buckets(xyz, mask, win, cfg.n_windows,
                                                  cfg.window_capacity, cfg.bits, shift)
            edges.append(valid_edges(*dense_window_edges(bucket, bvalid, xyz.shape[0])))
        for i in range(self.depth):
            feat = getattr(self, f"block{i}")(xyz, sig, feat, mask, *edges[i % 2],
                                              deterministic, generator)
        return feat


class Swin3DUNet(nn.Module):
    """``forward(coord (N, 3), feat (N, C), mask (N,))`` -> (N, num_classes)
    logits, 0 on padding."""

    def __init__(self, cfg: Swin3DConfig):
        super().__init__()
        self.cfg = cfg
        ch, L = cfg.channels, cfg.num_layers
        dpr = _drop_path_rates(cfg.drop_path_rate, cfg.depths)
        self.stem_conv = nn.Linear(27 * cfg.in_channels, ch[0], bias=False)
        self.stem_norm = _norm(ch[0])
        for i in range(L):
            self.add_module(f"layer{i}", BasicLayer(
                cfg, ch[i], cfg.depths[i], cfg.num_heads[i], cfg.window_sizes[i],
                tuple(dpr[sum(cfg.depths[:i]):sum(cfg.depths[:i + 1])])))
            if i < L - 1:
                self.add_module(f"down{i}", TransitionDown(ch[i], ch[i + 1], cfg.k))
        for i in range(L - 1, 0, -1):
            self.add_module(f"up{i}", Upsample(ch[i], ch[i - 1], ch[i - 1]))
        self.head_fc1, self.head_norm = nn.Linear(ch[0], ch[0]), _norm(ch[0])
        self.head_fc2 = nn.Linear(ch[0], cfg.num_classes)

    def forward(self, coord: torch.Tensor, feat: torch.Tensor, mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        grid, p2v, _ = voxelize_points(coord[None], mask[None], cfg.base_grid_size, cfg.capacity,
                                       bits=cfg.bits)
        w = mask[None].to(feat.dtype)
        vx = scatter_mean(p2v, coord[None], w, cfg.capacity)[0]
        vf = scatter_mean(p2v, feat[None], w, cfg.capacity)
        vm = grid.mask[0]
        sig = vf[0, :, :3] if "RGB" in cfg.crse else None
        nb = gather_neighbors(grid, vf, bits=cfg.bits)[0]
        x = torch.relu(self.stem_norm(self.stem_conv(nb.flatten(1)))) * vm[:, None]
        counts = level_counts(cfg.capacity, cfg.num_layers, cfg.ratio)
        skips = []
        c, s, f, m = vx, sig, x, vm
        for i in range(cfg.num_layers):
            f = getattr(self, f"layer{i}")(c, s, f, m, deterministic, generator)
            skips.append((c, f, m))
            if i < cfg.num_layers - 1:
                c2, f, m2 = getattr(self, f"down{i}")(c, f, m, counts[i + 1])
                if s is not None:
                    s = s[farthest_point_sample(c, counts[i + 1], m)]
                c, m = c2, m2
        c, f, m = skips.pop(-1)
        for i in range(cfg.num_layers - 1, 0, -1):
            uc, uf, um = skips.pop(-1)
            f = getattr(self, f"up{i}")(c, f, m, uc, uf, um)
            c, m = uc, um
        pf = torch.where(mask[:, None], f[p2v[0]], 0.0)
        h = torch.relu(self.head_norm(self.head_fc1(pf)))
        return self.head_fc2(h) * mask[:, None]
