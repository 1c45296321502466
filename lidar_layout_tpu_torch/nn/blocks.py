"""Backbone blocks of the range-image autoencoder, NCHW.

Counterpart of ``lidar_layout_tpu/nn/blocks.py`` (reference model_lidm.py):
GroupNorm (kernel K3), asymmetric-stride ResNet blocks with circular convs,
bilinear(align_corners)+conv upsampling, strided-conv downsampling, the
single-head spatial self-attention and its linear variant. Parameter names follow the reference
state_dict (``norm1``, ``conv1``, ``nin_shortcut``, ``q``/``k``/``v``, ...).

Under the spatial (``sp``) axis (``parallel/mesh.spatial_sharding``) a
``Normalize`` takes K3's split form over the shards and an ``AttnBlock``
attends from its shard's positions to the gathered keys of every shard;
the bilinear ``Upsample`` and ``LinearAttnBlock``, which no sharded path
runs, raise there.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.groupnorm import group_norm, group_norm_split
from ..parallel.collectives import all_gather_along, spatial_plan
from .conv import CircularConv, Conv1x1

# stride-specific kernels/pads (reference model_lidm.py); pads are
# (left, right, top, bottom)
UPSAMPLE_KERNEL = {(1, 2): (1, 5), (1, 4): (1, 7), (2, 1): (5, 1), (2, 2): (3, 3)}
UPSAMPLE_PAD = {(1, 2): (2, 2, 0, 0), (1, 4): (3, 3, 0, 0), (2, 1): (0, 0, 2, 2), (2, 2): (1, 1, 1, 1)}
DOWNSAMPLE_KERNEL = {(1, 2): (3, 3), (1, 4): (3, 5), (2, 1): (3, 3), (2, 2): (3, 3)}
DOWNSAMPLE_PAD = {(1, 2): (0, 1, 1, 1), (1, 4): (1, 1, 1, 1), (2, 1): (1, 1, 1, 1), (2, 2): (0, 1, 0, 1)}
# uniform kernel -> pad for ResnetBlock convs
KERNEL_PAD = {(3, 3): (1, 1, 1, 1), (1, 4): (1, 2, 0, 0)}


def num_groups_for(c: int, num_groups: int = 32) -> int:
    """Largest divisor of C not exceeding num_groups."""
    g = min(num_groups, c)
    while c % g:
        g -= 1
    return g


class Normalize(nn.Module):
    """GroupNorm(32, eps=1e-6) with f32 statistics and f32 affine whatever
    the activation dtype; ``act=True`` fuses the SiLU that follows."""

    eps = 1e-6

    def __init__(self, channels: int, num_groups: int = 32, act: bool = False):
        super().__init__()
        self.num_groups = num_groups_for(channels, num_groups)
        self.act = act
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        plan = spatial_plan()
        if plan is not None:
            return group_norm_split(x, self.weight, self.bias, self.num_groups, self.eps,
                                    self.act, plan.group)
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps, self.act)


def resize_align_corners(x: torch.Tensor, scale: Tuple[int, int]) -> torch.Tensor:
    """Bilinear upsample by integer (sh, sw) with align_corners=True."""
    if scale == (1, 1):
        return x
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(h * scale[0], w * scale[1]), mode="bilinear",
                         align_corners=True)


class Upsample(nn.Module):
    """Bilinear(align_corners) x stride, then the stride-specific circular conv."""

    def __init__(self, channels: int, stride: Tuple[int, int],
                 with_conv: bool = True, wrap: bool = True):
        super().__init__()
        self.stride = tuple(stride)
        self.conv = (CircularConv(channels, channels, UPSAMPLE_KERNEL[self.stride],
                                  (1, 1), UPSAMPLE_PAD[self.stride], wrap=wrap)
                     if with_conv else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if spatial_plan() is not None and self.stride != (1, 1):
            raise NotImplementedError("a bilinear (align_corners) upsample reads the whole "
                                      "width: no sp path runs it")
        x = resize_align_corners(x, self.stride)
        return self.conv(x) if self.conv is not None else x


class Downsample(nn.Module):
    """Strided circular conv (or average pool) with stride-specific kernel/pad."""

    def __init__(self, channels: int, stride: Tuple[int, int],
                 with_conv: bool = True, wrap: bool = True):
        super().__init__()
        self.stride = tuple(stride)
        self.conv = (CircularConv(channels, channels, DOWNSAMPLE_KERNEL[self.stride],
                                  self.stride, DOWNSAMPLE_PAD[self.stride], wrap=wrap)
                     if with_conv else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv is not None:
            return self.conv(x)
        return F.avg_pool2d(x, self.stride, self.stride)


class ResnetBlock(nn.Module):
    """norm-swish-cconv x2 with optional timestep projection; dropout (in
    train mode) before the second conv, as the JAX block."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 kernel_size: Tuple[int, int] = (3, 3), conv_shortcut: bool = False,
                 temb_channels: int = 0, dropout: float = 0.0, wrap: bool = True):
        super().__init__()
        out_channels = out_channels or in_channels
        pad = KERNEL_PAD[tuple(kernel_size)]
        self.norm1 = Normalize(in_channels, act=True)
        self.conv1 = CircularConv(in_channels, out_channels, kernel_size, (1, 1), pad,
                                  wrap=wrap)
        self.temb_proj = nn.Linear(temb_channels, out_channels) if temb_channels else None
        self.norm2 = Normalize(out_channels, act=True)
        self.dropout = nn.Dropout(dropout) if dropout > 0 else nn.Identity()
        self.conv2 = CircularConv(out_channels, out_channels, kernel_size, (1, 1), pad,
                                  wrap=wrap)
        self.nin_shortcut = self.conv_shortcut = None
        if in_channels != out_channels:
            if conv_shortcut:
                self.conv_shortcut = CircularConv(in_channels, out_channels,
                                                  kernel_size, (1, 1), pad, wrap=wrap)
            else:
                self.nin_shortcut = Conv1x1(in_channels, out_channels)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if temb is not None and self.temb_proj is not None:
            h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.dropout(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        elif self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Single-head (B, S, C) attention in plain torch, f32 logits and softmax."""
    s = torch.bmm(q.float(), k.float().transpose(1, 2)) * q.shape[-1] ** -0.5
    p = torch.softmax(s, dim=-1)
    return torch.bmm(p.to(v.dtype), v).to(q.dtype)


class AttnBlock(nn.Module):
    """Single-head full self-attention over H*W positions (plain torch: the
    JAX package leaves this one to XLA, not to a kernel)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = Normalize(channels)
        self.q = Conv1x1(channels, channels)
        self.k = Conv1x1(channels, channels)
        self.v = Conv1x1(channels, channels)
        self.proj_out = Conv1x1(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.norm(x)
        q, k, v = (m(y).reshape(b, c, h * w).transpose(1, 2)
                   for m in (self.q, self.k, self.v))
        plan = spatial_plan()
        if plan is not None:   # this shard's queries, every shard's keys
            k, v = all_gather_along(torch.stack([k, v]), 2, plan.group).unbind(0)
        out = plain_attention(q, k, v).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


class LinearAttnBlock(nn.Module):
    """Linear attention with one head over H*W positions (the reference's
    LinAttnBlock, JAX's ``LinearAttnBlock``): softmax of q over its
    channels, of k over the positions, context = k v^T, out = context^T q,
    no norm; plain torch in both packages."""

    def __init__(self, channels: int):
        super().__init__()
        self.to_qkv = Conv1x1(channels, 3 * channels, bias=False)
        self.to_out = Conv1x1(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if spatial_plan() is not None:
            raise NotImplementedError("linear attention's softmax over positions reads the "
                                      "whole width: no sp path runs it")
        b, c, h, w = x.shape
        q, k, v = self.to_qkv(x).reshape(b, 3 * c, h * w).split(c, dim=1)
        q = torch.softmax(q, dim=1)
        k = torch.softmax(k, dim=2)
        context = torch.bmm(k, v.transpose(1, 2))                 # (B, C_k, C_v)
        out = torch.bmm(context.transpose(1, 2), q).reshape(b, c, h, w)
        return x + self.to_out(out)


def make_attn(channels: int, attn_type: str = "vanilla") -> nn.Module:
    if attn_type == "vanilla":
        return AttnBlock(channels)
    if attn_type == "linear":
        return LinearAttnBlock(channels)
    if attn_type == "none":
        return nn.Identity()
    raise ValueError(f"unknown attn_type {attn_type!r}")
