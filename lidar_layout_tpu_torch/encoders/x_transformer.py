"""The x-transformers feature set: the encoder stack behind the BERT embedder.

Counterpart of ``lidar_layout_tpu/encoders/x_transformer.py`` (``ScaleNorm``,
``RMSNorm``, ``fixed_positional_embedding``, ``GEGLU``, ``FeedForward``,
``Attention``, ``AttentionLayers``, ``Encoder``, ``Decoder``,
``TransformerWrapper``). Modules keep the flax names (``to_q``, ``mem_k``,
``pre_softmax_proj``, ``norm_attn0``, ``rezero_ff0``, ``gru_attn0.ir``,
``ff_pre0``, ``final_norm``, ``token_emb``, ``memory_tokens``, ...), so
``utils/convert`` carries a JAX tree in with Dense kernels reversed.

Attention is plain matmuls and a softmax in f32, as JAX's einsums are: no
Pallas kernel computes it there, so no CUDA kernel computes it here. As in
JAX: GELU is the tanh approximation, LayerNorm's eps is 1e-6, masked logits
take the dtype's least value (a row masked throughout attends uniformly),
the memory key/values come before the sequence's keys (their mask, all
true, too), the causal mask is ``tril(ones(n, m), m - n)``, talking heads
mix the heads before the mask and after the softmax, and sparse top-k keeps
the logits at or above the k-th largest value (a value, so ties need no
rule). A gated residual is flax's ``GRUCell`` with the old stream as the
carry and the branch as the input.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

DEFAULT_DIM_HEAD = 64
LN_EPS = 1e-6   # flax LayerNorm's


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu


def _normal(shape, std: float = 0.02) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape) * std)


class ScaleNorm(nn.Module):
    """g * x / max(||x|| d^-1/2, eps), one scalar gain."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x / torch.clamp(n * x.shape[-1] ** -0.5, min=self.eps) * self.g


class RMSNorm(ScaleNorm):
    """g * x / max(rms(x), eps), a gain a channel."""

    def __init__(self, dim: int, eps: float = 1e-8):
        super().__init__(dim, eps)
        self.g = nn.Parameter(torch.ones(dim))


def make_norm(kind: str, dim: int) -> nn.Module:
    if kind == "scale":
        return ScaleNorm(dim)
    if kind == "rms":
        return RMSNorm(dim)
    return nn.LayerNorm(dim, eps=LN_EPS)


def fixed_positional_embedding(n: int, dim: int, offset: int = 0,
                               device=None) -> torch.Tensor:
    """The sinusoidal table: (n, dim) [sin | cos]."""
    inv_freq = 1.0 / (10000 ** (torch.arange(0, dim, 2, device=device, dtype=torch.float32)
                                / dim))
    t = torch.arange(n, device=device, dtype=torch.float32) + offset
    sinusoid = t[:, None] * inv_freq[None, :]
    return torch.cat([torch.sin(sinusoid), torch.cos(sinusoid)], dim=-1)


class GEGLU(nn.Module):
    """a * gelu(gate) of one projection to twice the width."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, g = self.proj(x).chunk(2, dim=-1)
        return a * _gelu(g)


class FeedForward(nn.Module):
    """fc1 (or GEGLU with ``glu``), GELU, dropout, fc2."""

    def __init__(self, dim: int, mult: int = 4, glu: bool = False, dropout: float = 0.0):
        super().__init__()
        inner = dim * mult
        self.glu = glu
        if glu:
            self.geglu = GEGLU(dim, inner)
        else:
            self.fc1 = nn.Linear(dim, inner)
        self.dropout = nn.Dropout(dropout)
        self.fc2 = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.geglu(x) if self.glu else _gelu(self.fc1(x))
        return self.fc2(self.dropout(h))


class Attention(nn.Module):
    """Multi-head attention with talking heads, sparse top-k, memory
    key/values and attention-on-attention."""

    def __init__(self, dim: int, dim_head: int = DEFAULT_DIM_HEAD, heads: int = 8,
                 causal: bool = False, talking_heads: bool = False,
                 sparse_topk: Optional[int] = None, num_mem_kv: int = 0,
                 dropout: float = 0.0, on_attn: bool = False, context_dim: Optional[int] = None):
        super().__init__()
        self.heads, self.dim_head, self.causal = heads, dim_head, causal
        self.talking_heads, self.sparse_topk, self.num_mem_kv = talking_heads, sparse_topk, num_mem_kv
        self.on_attn = on_attn
        inner = heads * dim_head
        kv_dim = context_dim or dim
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim, inner, bias=False)
        if num_mem_kv > 0:
            self.mem_k = _normal((heads, num_mem_kv, dim_head))
            self.mem_v = _normal((heads, num_mem_kv, dim_head))
        if talking_heads:
            self.pre_softmax_proj = _normal((heads, heads))
            self.post_softmax_proj = _normal((heads, heads))
        self.dropout = nn.Dropout(dropout)
        self.to_out = nn.Linear(inner, dim * 2 if on_attn else dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None,
                pia_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        kv_in = x if context is None else context
        if pia_emb is not None:        # position-infused attention
            x = x + pia_emb[None, :n]
            if context is None:
                kv_in = x
        m = kv_in.shape[1]
        q = self.to_q(x).reshape(b, n, h, d).transpose(1, 2)
        k = self.to_k(kv_in).reshape(b, m, h, d).transpose(1, 2)
        v = self.to_v(kv_in).reshape(b, m, h, d).transpose(1, 2)

        if self.num_mem_kv > 0:        # learned memory key/values, first
            k = torch.cat([self.mem_k.expand(b, -1, -1, -1), k], dim=2)
            v = torch.cat([self.mem_v.expand(b, -1, -1, -1), v], dim=2)
            m = m + self.num_mem_kv
            if context_mask is None and mask is not None and context is None:
                context_mask = mask
            if context_mask is not None:
                context_mask = torch.cat([context_mask.new_ones((b, self.num_mem_kv)),
                                          context_mask], dim=1)
        elif context_mask is None and context is None:
            context_mask = mask

        dots = torch.einsum("bhid,bhjd->bhij", q, k) * (d ** -0.5)
        big_neg = torch.finfo(dots.dtype).min
        if self.talking_heads:         # head mixing before the softmax
            dots = torch.einsum("bhij,hk->bkij", dots, self.pre_softmax_proj)
        if context_mask is not None:
            dots = torch.where(context_mask[:, None, None, :], dots, big_neg)
        if self.causal:
            causal = torch.ones((n, m), dtype=torch.bool, device=x.device).tril(m - n)
            dots = torch.where(causal[None, None], dots, big_neg)
        if self.sparse_topk is not None and self.sparse_topk < m:
            kth = torch.topk(dots, self.sparse_topk, dim=-1).values[..., -1:]
            dots = torch.where(dots >= kth, dots, big_neg)

        attn = self.dropout(torch.softmax(dots, dim=-1))
        if self.talking_heads:         # and after it
            attn = torch.einsum("bhij,hk->bkij", attn, self.post_softmax_proj)
        out = torch.einsum("bhij,bhjd->bhid", attn, v).transpose(1, 2).reshape(b, n, h * d)
        out = self.to_out(out)
        if self.on_attn:               # attention-on-attention
            a, gate = out.chunk(2, dim=-1)
            return a * torch.sigmoid(gate)
        return out


class GRUGate(nn.Module):
    """flax ``GRUCell`` over (old stream as carry, branch as input): the
    input projections ``ir``, ``iz``, ``in`` carry biases, of the recurrent
    ones only ``hn``."""

    def __init__(self, dim: int):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, nn.Linear(dim, dim))
        self.hr, self.hz = nn.Linear(dim, dim, bias=False), nn.Linear(dim, dim, bias=False)
        self.hn = nn.Linear(dim, dim)

    def forward(self, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
        r = torch.sigmoid(self.ir(new) + self.hr(old))
        z = torch.sigmoid(self.iz(new) + self.hz(old))
        c = torch.tanh(getattr(self, "in")(new) + r * self.hn(old))
        return (1.0 - z) * c + z * old


class AttentionLayers(nn.Module):
    """Encoder/decoder stack with the library's layout flags: pre or post
    norm ("layer", "scale", "rms"), rezero, macaron (a half-step feed-forward
    before attention), gated residuals, cross-attention, position-infused
    attention, and the attention flags of ``Attention``."""

    default_causal = False

    def __init__(self, dim: int, depth: int, heads: int = 8,
                 dim_head: int = DEFAULT_DIM_HEAD, causal: Optional[bool] = None,
                 cross_attend: bool = False, norm: str = "layer", use_rezero: bool = False,
                 position_infused_attn: bool = False, macaron: bool = False,
                 pre_norm: bool = True, residual_attn: bool = False,
                 gate_residual: bool = False, ff_glu: bool = False, ff_mult: int = 4,
                 attn_talking_heads: bool = False, attn_sparse_topk: Optional[int] = None,
                 attn_num_mem_kv: int = 0, dropout: float = 0.0,
                 context_dim: Optional[int] = None):
        super().__init__()
        causal = self.default_causal if causal is None else causal
        self.dim, self.depth, self.pre_norm, self.use_rezero = dim, depth, pre_norm, use_rezero
        self.position_infused_attn, self.gate_residual = position_infused_attn, gate_residual
        self.cross_attend, self.macaron = cross_attend, macaron

        def attn(is_causal, ctx=None):
            return Attention(dim, dim_head, heads, is_causal, attn_talking_heads,
                             attn_sparse_topk, attn_num_mem_kv, dropout, context_dim=ctx)

        self.kinds = []
        for i in range(depth):
            blocks = []
            if macaron:
                blocks.append(("ff_pre", FeedForward(dim, ff_mult, ff_glu, dropout), 0.5))
            blocks.append(("attn", attn(causal), 1.0))
            if cross_attend:
                blocks.append(("cross", attn(False, context_dim), 1.0))
            blocks.append(("ff", FeedForward(dim, ff_mult, ff_glu, dropout), 1.0))
            for kind, block, scale in blocks:
                if use_rezero:
                    self.register_parameter(f"rezero_{kind}{i}", nn.Parameter(torch.zeros(1)))
                else:
                    self.add_module(f"norm_{kind}{i}", make_norm(norm, dim))
                self.add_module(f"{kind}{i}", block)
                if gate_residual:
                    self.add_module(f"gru_{kind}{i}", GRUGate(dim))
                self.kinds.append((i, kind, scale))
        if pre_norm and not use_rezero:
            self.final_norm = make_norm(norm, dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        pia = (fixed_positional_embedding(x.shape[1], self.dim, device=x.device).to(x.dtype)
               if self.position_infused_attn else None)
        for i, kind, scale in self.kinds:
            norm = None if self.use_rezero else getattr(self, f"norm_{kind}{i}")
            block = getattr(self, f"{kind}{i}")
            h = x
            if norm is not None and self.pre_norm:
                h = norm(h)
            if kind == "attn":
                h = block(h, mask=mask, pia_emb=pia)
            elif kind == "cross":
                h = block(h, context=context, mask=mask, context_mask=context_mask)
            else:
                h = block(h)
            h = h * scale
            if self.use_rezero:
                h = h * getattr(self, f"rezero_{kind}{i}")
            x = getattr(self, f"gru_{kind}{i}")(h, x) if self.gate_residual else h + x
            if norm is not None and not self.pre_norm:
                x = norm(x)
        if self.pre_norm and not self.use_rezero:
            x = self.final_norm(x)
        return x


class Encoder(AttentionLayers):
    """Non-causal ``AttentionLayers``."""

    default_causal = False


class Decoder(AttentionLayers):
    """Causal ``AttentionLayers``."""

    default_causal = True


class TransformerWrapper(nn.Module):
    """Token embedding, absolute positions (none with position-infused
    attention), memory tokens, ``attn_layers`` and a logits head
    (``to_logits``, or the token table itself when tied)."""

    def __init__(self, num_tokens: int, max_seq_len: int, attn_layers: AttentionLayers,
                 emb_dim: Optional[int] = None, num_memory_tokens: int = 0,
                 tie_embedding: bool = False, use_pos_emb: bool = True,
                 emb_dropout: float = 0.0, return_logits: bool = True):
        super().__init__()
        dim = attn_layers.dim
        emb_dim = emb_dim or dim
        self.num_memory_tokens, self.tie_embedding = num_memory_tokens, tie_embedding
        self.return_logits = return_logits
        self.token_emb = _normal((num_tokens, emb_dim))
        self.use_pos = use_pos_emb and not attn_layers.position_infused_attn
        if self.use_pos:
            self.pos_emb = _normal((max_seq_len, emb_dim))
        self.emb_dropout = nn.Dropout(emb_dropout)
        if emb_dim != dim:
            self.project_emb = nn.Linear(emb_dim, dim)
        if num_memory_tokens > 0:
            self.memory_tokens = _normal((num_memory_tokens, dim))
        self.attn_layers = attn_layers
        if return_logits and not tie_embedding:
            self.to_logits = nn.Linear(dim, num_tokens)

    def forward(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None,
                return_embeddings: bool = False) -> torch.Tensor:
        b, n = tokens.shape
        x = self.token_emb[tokens.long()]
        if self.use_pos:
            x = x + self.pos_emb[None, :n]
        x = self.emb_dropout(x)
        if hasattr(self, "project_emb"):
            x = self.project_emb(x)
        if self.num_memory_tokens > 0:
            x = torch.cat([self.memory_tokens.expand(b, -1, -1), x], dim=1)
            if mask is not None:
                mask = torch.cat([mask.new_ones((b, self.num_memory_tokens)), mask], dim=1)
        x = self.attn_layers(x, mask=mask)
        x = x[:, self.num_memory_tokens:]
        if return_embeddings or not self.return_logits:
            return x
        if self.tie_embedding:
            return x @ self.token_emb.T
        return self.to_logits(x)
