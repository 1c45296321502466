"""Transformer blocks for cross-attention conditioning.

Counterpart of ``GEGLU``, ``FeedForward``, ``CrossAttention`` and
``BasicTransformerBlock`` in ``lidar_layout_tpu/nn/attention.py``, on
(B, N, C) tokens. ``CrossAttention`` goes through ``ops.attention.attend``
as the JAX one does: self-attention-shaped q, k and v go to kernel K1, other
shapes to plain attention. It follows flax's defaults where torch's differ:
LayerNorm eps 1e-6 and the tanh GELU (``jax.nn.gelu``). Modules keep the
flax names (``to_q``, ``attn1``, ``ff.geglu.proj``, ``norm1``, ...). The
settings are those of the blocks LayoutDiffusion builds: no dropout, no
mask, the gated feed-forward.
``SpatialTransformer`` is not ported yet (ROADMAP queue 1, "Conditioning").
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

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, N, C); context (B, S, C_ctx)."""
        b, n, _ = x.shape
        ctx = x if context is None else context
        q = self.to_q(x).reshape(b, n, self.heads, self.dim_head)
        k = self.to_k(ctx).reshape(b, ctx.shape[1], self.heads, self.dim_head)
        v = self.to_v(ctx).reshape(b, ctx.shape[1], self.heads, self.dim_head)
        return self.to_out(attend(q, k, v).reshape(b, n, self.heads * self.dim_head))


class BasicTransformerBlock(nn.Module):
    """Self-attention, cross-attention to ``context``, gated feed-forward,
    each pre-normed and residual."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: Optional[int] = None):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, heads, dim_head)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim, eps=LN_EPS) for _ in range(3))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context=context)
        return x + self.ff(self.norm3(x))
