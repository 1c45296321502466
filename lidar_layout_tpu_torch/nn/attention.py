"""Transformer blocks for cross-attention conditioning.

Counterpart of ``GEGLU``, ``FeedForward``, ``CrossAttention`` and
``BasicTransformerBlock`` and ``SpatialTransformer`` in
``lidar_layout_tpu/nn/attention.py``, on (B, N, C) tokens. ``CrossAttention`` goes through ``ops.attention.attend``
as the JAX one does: self-attention-shaped q, k and v go to kernel K1, other
shapes to plain attention. It follows flax's defaults where torch's differ:
LayerNorm eps 1e-6 and the tanh GELU (``jax.nn.gelu``). Modules keep the
flax names (``to_q``, ``attn1``, ``ff.geglu.proj``, ``norm1``, ...). The
settings are those of the blocks the JAX models build: no dropout, the
gated feed-forward. ``CrossAttention`` takes JAX's (B, S) key ``mask``
(True = attend), which reaches ``attend`` as a (B, 1, 1, S) key-padding mask.

``SpatialTransformer`` wraps the blocks for an NCHW feature map: GroupNorm
(32 groups, eps 1e-6, f32 statistics and affine), a 1x1 ``proj_in``, the
blocks over the (B, H*W, inner) tokens, a zero-initialised 1x1 ``proj_out``
and the residual. Its GroupNorm is plain PyTorch, as JAX's is flax's
``nn.GroupNorm`` and not the Pallas kernel; its blocks are
``transformer_blocks.i``, the reference openaimodel's name.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import attend

LN_EPS = 1e-6   # flax LayerNorm


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """The gated (GEGLU) feed-forward of width 4x, as the blocks use it."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.geglu = GEGLU(dim, dim * mult)
        self.out = nn.Linear(dim * mult, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(self.geglu(x))


class CrossAttention(nn.Module):
    """Multi-head attention over ``context`` (self-attention when None);
    ``context_dim`` is the width of the context's tokens."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, N, C); context (B, S, C_ctx); mask (B, S) boolean, True =
        attend."""
        b, n, _ = x.shape
        ctx = x if context is None else context
        q = self.to_q(x).reshape(b, n, self.heads, self.dim_head)
        k = self.to_k(ctx).reshape(b, ctx.shape[1], self.heads, self.dim_head)
        v = self.to_v(ctx).reshape(b, ctx.shape[1], self.heads, self.dim_head)
        out = attend(q, k, v, None if mask is None else mask[:, None, None, :])
        return self.to_out(out.reshape(b, n, self.heads * self.dim_head))


class BasicTransformerBlock(nn.Module):
    """Self-attention, cross-attention to ``context``, gated feed-forward,
    each pre-normed and residual."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: Optional[int] = None):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, heads, dim_head)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim, eps=LN_EPS) for _ in range(3))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context=context, mask=context_mask)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """norm -> 1x1 in -> ``depth`` blocks -> zero-initialised 1x1 out, plus
    the residual, over an NCHW map of ``channels``; ``context_dim`` is the
    width of the cross-attention's context tokens."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int = 1,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, context_dim) for _ in range(depth)])
        self.proj_out = nn.Conv2d(inner, channels, 1)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def f32_parameters(self):
        """The norm's affine, which stays float32 under ``cast_``."""
        return self.norm.parameters()

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, c, h, w = x.shape
        n = self.norm
        y = F.group_norm(x.float(), n.num_groups, n.weight.float(), n.bias.float(),
                         n.eps).to(x.dtype)
        y = self.proj_in(y)
        y = y.reshape(b, y.shape[1], h * w).transpose(1, 2)
        for block in self.transformer_blocks:
            y = block(y, context, context_mask)
        y = y.transpose(1, 2).reshape(b, y.shape[2], h, w)
        return self.proj_out(y) + x
