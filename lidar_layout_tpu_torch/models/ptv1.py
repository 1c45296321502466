"""Point Transformer V1: vector attention over kNN, an FPS/kNN pyramid.

Counterpart of ``lidar_layout_tpu/models/ptv1.py`` (``PTv1Config``,
``PointTransformerLayer``, ``TransitionDown``, ``TransitionUp``,
``Bottleneck``, ``PointTransformerSeg``, ``seg26``/``seg38``/``seg50``) over
one padded cloud: (N, 3) points, (N, C) features, an (N,) mask. Modules keep
the flax names (``enc0_down.linear``, ``enc1_block0.transformer.p_fc1``,
``dec4_up.linear2``, ``cls_fc2``, ...), so ``utils/convert.dense_tree_state_dict``
carries a JAX tree in.

A level of stride s keeps ``N // s`` rows: farthest-point samples (the first
``min(rows, valid points)`` are distinct valid points, which defines the
level's mask), each pooling its kNN by a maximum. kNN is a dense distance
matrix sorted stably (``ops/pointops``), as JAX's; norms are LayerNorm with
flax's eps 1e-6, in place of the reference's BatchNorm. Plain PyTorch: the
JAX module reaches no Pallas kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

from ..ops.pointops import farthest_point_sample, knn_query, three_nn_interpolate

LN_EPS = 1e-6   # flax LayerNorm's


@dataclasses.dataclass(frozen=True)
class PTv1Config:
    in_channels: int = 6
    num_classes: int = 13
    blocks: Tuple[int, ...] = (1, 2, 3, 5, 2)       # Seg50
    planes: Tuple[int, ...] = (32, 64, 128, 256, 512)
    strides: Tuple[int, ...] = (1, 4, 4, 4, 4)
    nsamples: Tuple[int, ...] = (8, 16, 16, 16, 16)
    share_planes: int = 8


def _norm(c: int) -> nn.LayerNorm:
    return nn.LayerNorm(c, eps=LN_EPS)


def masked_softmax(w: torch.Tensor, valid: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Softmax over ``dim`` with invalid slots at -inf, then 0 (a row with
    no valid slot is all 0)."""
    w = torch.softmax(torch.where(valid, w, -torch.inf), dim=dim)
    return torch.where(valid, w, 0.0)


def masked_max(h: torch.Tensor, valid: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Maximum over ``dim`` of the valid slots (ties share the gradient, as
    JAX's max does); 0 where none is valid."""
    h = torch.amax(torch.where(valid, h, -torch.inf), dim=dim)
    return torch.where(torch.isfinite(h), h, 0.0)


class PointTransformerLayer(nn.Module):
    """Vector attention over each point's kNN with a positional encoding."""

    def __init__(self, planes: int, share_planes: int = 8, nsample: int = 16):
        super().__init__()
        c, s = planes, share_planes
        self.planes, self.share_planes, self.nsample = c, s, nsample
        self.linear_q, self.linear_k, self.linear_v = (nn.Linear(c, c) for _ in range(3))
        self.p_fc1, self.p_norm, self.p_fc2 = nn.Linear(3, 3), _norm(3), nn.Linear(3, c)
        self.w_norm1, self.w_fc1 = _norm(c), nn.Linear(c, c // s)
        self.w_norm2, self.w_fc2 = _norm(c // s), nn.Linear(c // s, c // s)

    def forward(self, coord: torch.Tensor, feat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        c, s = self.planes, self.share_planes
        k = min(self.nsample, coord.shape[0])
        idx, _ = knn_query(coord, coord, k, points_mask=mask)
        valid = (mask[idx] & mask[:, None])[..., None]
        q, key, v = self.linear_q(feat), self.linear_k(feat), self.linear_v(feat)
        pr = self.p_fc2(torch.relu(self.p_norm(self.p_fc1(coord[idx] - coord[:, None, :]))))
        r_qk = key[idx] - q[:, None, :] + pr
        w = self.w_fc1(torch.relu(self.w_norm1(r_qk)))
        w = masked_softmax(self.w_fc2(torch.relu(self.w_norm2(w))), valid)   # (N, K, c/s)
        val = (v[idx] + pr).reshape(*idx.shape, s, c // s)
        return torch.einsum("nksi,nki->nsi", val, w).reshape(-1, c)


class TransitionDown(nn.Module):
    """Stride 1: a linear map. Stride s: FPS to ``N // s`` rows, then each
    row's kNN (relative xyz and features) through a linear map, max-pooled."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1, nsample: int = 16):
        super().__init__()
        self.stride, self.nsample = stride, nsample
        self.linear = nn.Linear(in_channels if stride == 1 else 3 + in_channels, planes,
                                bias=False)
        self.norm = _norm(planes)

    def forward(self, coord: torch.Tensor, feat: torch.Tensor, mask: torch.Tensor):
        if self.stride == 1:
            return coord, torch.relu(self.norm(self.linear(feat))) * mask[:, None], mask
        m = max(coord.shape[0] // self.stride, 1)
        new_coord = coord[farthest_point_sample(coord, m, mask=mask)]
        n_valid = torch.clamp(mask.sum(), max=m)
        new_mask = torch.arange(m, device=coord.device) < n_valid
        nbr, _ = knn_query(new_coord, coord, min(self.nsample, coord.shape[0]), points_mask=mask)
        grouped = torch.cat([coord[nbr] - new_coord[:, None, :], feat[nbr]], dim=-1)
        h = torch.relu(self.norm(self.linear(grouped)))
        h = masked_max(h, (mask[nbr] & new_mask[:, None])[..., None])
        return new_coord, h * new_mask[:, None], new_mask


class TransitionUp(nn.Module):
    """The head: features beside their masked mean's projection. Else the
    level's features plus the coarser level's, 3-NN interpolated."""

    def __init__(self, planes: int, coarse_planes: int = 0, is_head: bool = False):
        super().__init__()
        self.is_head = is_head
        if is_head:
            self.linear2 = nn.Linear(planes, planes)
            self.linear1, self.norm1 = nn.Linear(2 * planes, planes), _norm(planes)
        else:
            self.linear1, self.norm1 = nn.Linear(planes, planes), _norm(planes)
            self.linear2, self.norm2 = nn.Linear(coarse_planes, planes), _norm(planes)

    def forward(self, coord, feat, mask, coarse_coord=None, coarse_feat=None, coarse_mask=None):
        if self.is_head:
            w = mask.to(feat.dtype)
            mean = (feat * w[:, None]).sum(dim=0) / torch.clamp(w.sum(), min=1.0)
            ctx = torch.relu(self.linear2(mean)).expand(feat.shape[0], -1)
            h = self.linear1(torch.cat([feat, ctx], dim=-1))
            return torch.relu(self.norm1(h)) * mask[:, None]
        h1 = torch.relu(self.norm1(self.linear1(feat)))
        h2 = torch.relu(self.norm2(self.linear2(coarse_feat)))
        up = three_nn_interpolate(coord, coarse_coord, h2, points_mask=coarse_mask)
        return (h1 + up) * mask[:, None]


class Bottleneck(nn.Module):
    """linear, vector attention, linear, and the residual."""

    def __init__(self, planes: int, share_planes: int = 8, nsample: int = 16):
        super().__init__()
        self.linear1, self.norm1 = nn.Linear(planes, planes, bias=False), _norm(planes)
        self.transformer = PointTransformerLayer(planes, share_planes, nsample)
        self.norm2 = _norm(planes)
        self.linear3, self.norm3 = nn.Linear(planes, planes, bias=False), _norm(planes)

    def forward(self, coord, feat, mask):
        h = torch.relu(self.norm1(self.linear1(feat)))
        h = torch.relu(self.norm2(self.transformer(coord, h, mask)))
        h = self.norm3(self.linear3(h))
        return torch.relu(feat + h) * mask[:, None]


class PointTransformerSeg(nn.Module):
    """The five-level U-shaped PT-v1: ``forward(coord (N, 3), feat (N, Cin),
    mask (N,))`` -> (N, num_classes) logits, 0 on padding."""

    def __init__(self, cfg: PTv1Config):
        super().__init__()
        self.cfg = cfg
        p, L = cfg.planes, len(cfg.planes)
        width = cfg.in_channels
        for i in range(L):
            self.add_module(f"enc{i}_down", TransitionDown(width, p[i], cfg.strides[i],
                                                           cfg.nsamples[i]))
            for b in range(cfg.blocks[i]):
                self.add_module(f"enc{i}_block{b}",
                                Bottleneck(p[i], cfg.share_planes, cfg.nsamples[i]))
            width = p[i]
        self.add_module(f"dec{L - 1}_up", TransitionUp(p[-1], is_head=True))
        self.add_module(f"dec{L - 1}_block", Bottleneck(p[-1], cfg.share_planes, cfg.nsamples[-1]))
        for i in reversed(range(L - 1)):
            self.add_module(f"dec{i}_up", TransitionUp(p[i], p[i + 1]))
            self.add_module(f"dec{i}_block", Bottleneck(p[i], cfg.share_planes, cfg.nsamples[i]))
        self.cls_fc1, self.cls_norm = nn.Linear(p[0], p[0]), _norm(p[0])
        self.cls_fc2 = nn.Linear(p[0], cfg.num_classes)

    def forward(self, coord: torch.Tensor, feat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        L = len(cfg.planes)
        levels = []
        c, f, m = coord, feat, mask
        for i in range(L):
            c, f, m = getattr(self, f"enc{i}_down")(c, f, m)
            for b in range(cfg.blocks[i]):
                f = getattr(self, f"enc{i}_block{b}")(c, f, m)
            levels.append((c, f, m))
        c, f, m = levels[-1]
        f = getattr(self, f"dec{L - 1}_block")(c, getattr(self, f"dec{L - 1}_up")(c, f, m), m)
        coarse = (c, f, m)
        for i in reversed(range(L - 1)):
            c, f, m = levels[i]
            f = getattr(self, f"dec{i}_up")(c, f, m, *coarse)
            f = getattr(self, f"dec{i}_block")(c, f, m)
            coarse = (c, f, m)
        h = torch.relu(self.cls_norm(self.cls_fc1(f)))
        return self.cls_fc2(h) * mask[:, None]


def seg26(**kw) -> PointTransformerSeg:
    return PointTransformerSeg(PTv1Config(blocks=(1, 1, 1, 1, 1), **kw))


def seg38(**kw) -> PointTransformerSeg:
    return PointTransformerSeg(PTv1Config(blocks=(1, 2, 2, 2, 2), **kw))


def seg50(**kw) -> PointTransformerSeg:
    return PointTransformerSeg(PTv1Config(blocks=(1, 2, 3, 5, 2), **kw))
