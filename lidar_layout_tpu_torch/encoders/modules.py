"""Conditioning encoders.

Counterpart of ``lidar_layout_tpu/encoders/modules.py``: ``ClassEmbedder``,
``SpatialRescaler`` (a one-hot semantic map down to the latent grid, NHWC
as in JAX), the CLIP text and image towers (``TextTransformerEncoder``,
``ImageTransformerEncoder``: QuickGELU, LayerNorm eps 1e-5, the text tower
causal with EOT pooling) and their wrappers (``FrozenCLIPTextEmbedder``,
``FrozenClipMultiTextEmbedder``, ``FrozenClipImageEmbedder``,
``FrozenClipMultiImageEmbedder``), the trainable ``TransformerEmbedder``
(flax's LayerNorm eps 1e-6 and tanh GELU) and ``BERTEmbedder``, and the
host tokenizers ``simple_tokenize`` and ``bert_tokenize``.

The towers' attention is plain PyTorch with an f32 softmax
(``ops/attention._dot_product_attention``), as JAX's is flax's
``MultiHeadDotProductAttention`` on XLA, not the Pallas kernel. Modules keep
the flax names (``token_embedding``, ``positional_embedding``, ``ln_final``,
``text_projection``, ``patch_embed``, ``cls``, ``pos``, ``ln_pre``,
``ln_post``, ``proj``, ``projection``, ``clip_text``, ``clip_image``, ...)
but the per-layer ``ln1_i``, ``attn_i``, ``ln2_i``, ``mlp_in_i`` and
``mlp_out_i`` of a flax tower are ``layers.i.ln1`` ... ``layers.i.mlp_out``
here, and an attention's ``query``, ``key``, ``value`` and ``out`` are
linear layers over the heads' concatenated width (``utils/convert`` and
``encoders/clip_convert`` carry weights in). The CLIP wrappers take a
``tower`` argument, the tower they wrap (by default CLIP ViT-L/14's, as in
JAX, whose wrappers fix it); the repository holds no CLIP weights, so the
towers start from torch's initialisation (ROADMAP queue 1, "Conditioning").

``bert_tokenize`` is the JAX function's hash-bucket fallback only (the
WordPiece vocabulary needs ``transformers`` and a download; ROADMAP
section 3). ``XTransformerBERTEmbedder`` is the BERT embedder over
``encoders/x_transformer`` (its feature flags through ``attn_flags``).

``resize`` is ``jax.image.resize``: "nearest" takes pixel centres, and
every other method ("linear"/"bilinear"/"trilinear"/"triangle",
"cubic"/"bicubic"/"tricubic" with Keys' a = -0.5, "lanczos3", "lanczos5")
contracts each axis whose size changes with a weight matrix built on the
device as ``jax.image.scale_and_translate`` builds it: the kernel widened by
the shrink factor (antialiasing), columns normalised, samples outside the
input zeroed.
"""
from __future__ import annotations

import math
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import _dot_product_attention

CLIP_LN_EPS = 1e-5
FLAX_LN_EPS = 1e-6


class ClassEmbedder(nn.Module):
    """Label -> embedding ('adm'-style conditioning)."""

    def __init__(self, embed_dim: int, n_classes: int = 1000):
        super().__init__()
        self.embedding = nn.Embedding(n_classes, embed_dim)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return self.embedding(y)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _lanczos(radius: float):
    def kernel(x: torch.Tensor) -> torch.Tensor:
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        out = torch.where(x > 1e-3, y / torch.where(x != 0, math.pi ** 2 * x ** 2, 1.0), 1.0)
        return torch.where(x > radius, 0.0, out)
    return kernel


RESIZE_KERNELS = {**dict.fromkeys(("linear", "bilinear", "trilinear", "triangle"), _triangle),
                  **dict.fromkeys(("cubic", "bicubic", "tricubic"), _keys_cubic),
                  "lanczos3": _lanczos(3.0), "lanczos5": _lanczos(5.0)}
RESIZE_METHODS = ("nearest",) + tuple(RESIZE_KERNELS)


def resize_weights(in_size: int, out_size: int, method: str, device=None) -> torch.Tensor:
    """(in_size, out_size) f32 weights of one axis (``compute_weight_mat``
    of ``jax.image.scale_and_translate`` at translation 0, antialiased)."""
    inv_scale = torch.tensor(in_size / out_size, dtype=torch.float32, device=device)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None]
         ).abs() / kernel_scale
    w = RESIZE_KERNELS[method](x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize(x: torch.Tensor, size: Tuple[int, int], method: str) -> torch.Tensor:
    """``jax.image.resize`` of an NHWC map to (h, w); f32."""
    if method not in RESIZE_METHODS:
        raise ValueError(f"unknown resize method {method!r}; methods: {RESIZE_METHODS}")
    x = x.float()
    for axis, out in zip((1, 2), size):
        n = x.shape[axis]
        if n == out:
            continue
        if method == "nearest":
            idx = torch.floor((torch.arange(out, dtype=torch.float32, device=x.device) + 0.5)
                              * n / out).long()
            x = x.index_select(axis, idx)
        else:
            w = resize_weights(n, out, method, x.device)
            x = torch.einsum("bhwc,hk->bkwc" if axis == 1 else "bhwc,wk->bhkc", x, w)
    return x


class SpatialRescaler(nn.Module):
    """Downsample an NHWC map ``n_stages`` times by ``wh_factors`` (the size
    is ``max(int(h * f), 1)``, as JAX computes it) with ``resize``, then an
    optional 1x1 ``channel_mapper`` without bias. ``method`` is any of
    ``RESIZE_METHODS``. ``in_channels`` is the map's width, which flax infers
    (by default ``out_channels``)."""

    def __init__(self, n_stages: int = 1, method: str = "bilinear",
                 out_channels: Optional[int] = None, wh_factors: Tuple[float, float] = (0.5, 0.5),
                 in_channels: Optional[int] = None):
        super().__init__()
        if method not in RESIZE_METHODS:
            raise ValueError(f"SpatialRescaler method {method!r}; methods: {RESIZE_METHODS}")
        self.n_stages, self.method, self.wh_factors = n_stages, method, tuple(wh_factors)
        self.channel_mapper = (nn.Conv2d(in_channels or out_channels, out_channels, 1, bias=False)
                               if out_channels is not None else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        for _ in range(self.n_stages):
            h = max(int(h * self.wh_factors[0]), 1)
            w = max(int(w * self.wh_factors[1]), 1)
            x = resize(x, (h, w), self.method)
        if self.channel_mapper is not None:
            x = self.channel_mapper(x.float().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return x.float()


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP's QuickGELU, x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, biased q, k, v
    and out projections) with an optional boolean mask broadcastable to
    (B, H, S, S)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value, self.out = (nn.Linear(width, width) for _ in range(4))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, w = x.shape
        q, k, v = (proj(x).reshape(b, n, self.heads, w // self.heads)
                   for proj in (self.query, self.key, self.value))
        return self.out(_dot_product_attention(q, k, v, mask).reshape(b, n, w))


class TransformerLayer(nn.Module):
    """Pre-LN block: x + attn(ln1(x)), then x + mlp_out(act(mlp_in(ln2(x))))."""

    def __init__(self, width: int, heads: int, eps: float, act):
        super().__init__()
        self.act = act
        self.ln1 = nn.LayerNorm(width, eps=eps)
        self.attn = MultiHeadAttention(width, heads)
        self.ln2 = nn.LayerNorm(width, eps=eps)
        self.mlp_in = nn.Linear(width, 4 * width)
        self.mlp_out = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), mask)
        return x + self.mlp_out(self.act(self.mlp_in(self.ln2(x))))


def _tanh_gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu


class TextTransformerEncoder(nn.Module):
    """The CLIP ViT-L/14 text tower: 77 tokens, a causal mask, QuickGELU,
    ``ln_final`` and, pooled, the EOT token (the largest id) through
    ``text_projection``."""

    def __init__(self, vocab_size: int = 49408, max_len: int = 77, width: int = 768,
                 layers: int = 12, heads: int = 12):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.randn(max_len, width) * 0.01)
        self.layers = nn.ModuleList([TransformerLayer(width, heads, CLIP_LN_EPS, quick_gelu)
                                     for _ in range(layers)])
        self.ln_final = nn.LayerNorm(width, eps=CLIP_LN_EPS)
        self.text_projection = nn.Linear(width, width, bias=False)

    def forward(self, tokens: torch.Tensor, pool: bool = True) -> torch.Tensor:
        b, n = tokens.shape
        x = self.token_embedding(tokens) + self.positional_embedding[None, :n]
        mask = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()[None, None]
        for layer in self.layers:
            x = layer(x, mask)
        x = self.ln_final(x)
        if pool:
            x = self.text_projection(x[torch.arange(b, device=x.device), tokens.argmax(dim=-1)])
        return x


def simple_tokenize(texts: Sequence[str], max_len: int = 77) -> np.ndarray:
    """The byte-level fallback tokenizer: [SOT] + UTF-8 bytes (capped at
    49405) + [EOT], zero-padded to ``max_len``, int32."""
    sot, eot = 49406, 49407
    out = np.zeros((len(texts), max_len), dtype=np.int32)
    for i, t in enumerate(texts):
        ids = [sot] + [min(b, 49405) for b in t.encode("utf-8")[: max_len - 2]] + [eot]
        out[i, : len(ids)] = ids
    return out


class TransformerEmbedder(nn.Module):
    """Token embedding + learned positions + ``n_layer`` pre-LN blocks
    (tanh GELU, flax's LayerNorm eps) + ``ln_final``: per-token
    embeddings."""

    def __init__(self, n_embed: int = 640, n_layer: int = 32, vocab_size: int = 30522,
                 max_seq_len: int = 77, heads: int = 8, embedding_dropout: float = 0.0):
        super().__init__()
        self.token_emb = nn.Embedding(vocab_size, n_embed)
        self.pos_emb = nn.Parameter(torch.randn(max_seq_len, n_embed) * 0.01)
        self.emb_dropout = nn.Dropout(embedding_dropout)
        self.layers = nn.ModuleList([TransformerLayer(n_embed, heads, FLAX_LN_EPS, _tanh_gelu)
                                     for _ in range(n_layer)])
        self.ln_final = nn.LayerNorm(n_embed, eps=FLAX_LN_EPS)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.token_emb(tokens) + self.pos_emb[None, :tokens.shape[1]]
        x = self.emb_dropout(x)
        for layer in self.layers:
            x = layer(x)
        return self.ln_final(x)


def bert_tokenize(texts: Sequence[str], max_len: int = 77) -> np.ndarray:
    """JAX's hash-bucket WordPiece substitute: [CLS] = 101, each lower-cased
    word to 1000 + crc32 % 29000, [SEP] = 102, zero-padded, int32."""
    out = np.zeros((len(texts), max_len), dtype=np.int32)
    for i, t in enumerate(texts):
        words = t.lower().split()[: max_len - 2]
        ids = [101] + [1000 + (zlib.crc32(w.encode()) % 29000) for w in words] + [102]
        out[i, : len(ids)] = ids
    return out


class BERTEmbedder(nn.Module):
    """``bert_tokenize``'s tokens through a ``TransformerEmbedder``."""

    def __init__(self, n_embed: int = 640, n_layer: int = 32, vocab_size: int = 30522,
                 max_seq_len: int = 77, embedding_dropout: float = 0.0):
        super().__init__()
        self.transformer = TransformerEmbedder(n_embed, n_layer, vocab_size, max_seq_len,
                                               embedding_dropout=embedding_dropout)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.transformer(tokens)


class XTransformerBERTEmbedder(nn.Module):
    """``bert_tokenize``'s tokens through ``x_transformer.TransformerWrapper``
    over an ``Encoder`` of ``n_layer`` layers, ``heads`` heads of 64 and
    the x-transformers flags in ``attn_flags``: per-token embeddings. The
    stack is ``transformer.attn_layers`` (``Encoder_0`` in JAX's tree)."""

    def __init__(self, n_embed: int = 640, n_layer: int = 32, vocab_size: int = 30522,
                 max_seq_len: int = 77, embedding_dropout: float = 0.0, heads: int = 8,
                 attn_flags: Optional[dict] = None):
        super().__init__()
        from .x_transformer import Encoder, TransformerWrapper

        layers = Encoder(dim=n_embed, depth=n_layer, heads=heads, **(attn_flags or {}))
        # no logits head: JAX calls the wrapper for embeddings, so flax never
        # makes its to_logits
        self.transformer = TransformerWrapper(num_tokens=vocab_size, max_seq_len=max_seq_len,
                                              attn_layers=layers, emb_dropout=embedding_dropout,
                                              return_logits=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.transformer(tokens, return_embeddings=True)


class FrozenCLIPTextEmbedder(nn.Module):
    """Tokens -> (B, 1, width) CLIP text embedding, L2-normalised."""

    def __init__(self, normalize: bool = True, tower: Optional[nn.Module] = None):
        super().__init__()
        self.normalize = normalize
        self.clip_text = tower if tower is not None else TextTransformerEncoder()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        z = self.clip_text(tokens, pool=True)
        if self.normalize:
            z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
        return z[:, None, :]


class FrozenClipMultiTextEmbedder(nn.Module):
    """The text embedding repeated over ``n_views`` camera views:
    (B, n_views, width)."""

    def __init__(self, n_views: int = 4, normalize: bool = True,
                 tower: Optional[nn.Module] = None):
        super().__init__()
        self.n_views = n_views
        self.text = FrozenCLIPTextEmbedder(normalize, tower)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.text(tokens).repeat_interleave(self.n_views, dim=1)


class ImageTransformerEncoder(nn.Module):
    """The CLIP ViT-L/14 image tower on NHWC images: a stride-``patch``
    patch conv without bias, the class token, learned positions, ``ln_pre``,
    the blocks (QuickGELU), ``ln_post`` and, pooled, the class token
    through ``proj``."""

    def __init__(self, image_size: int = 224, patch: int = 14, width: int = 1024,
                 layers: int = 24, heads: int = 16, out_dim: int = 768):
        super().__init__()
        self.width, self.out_dim = width, out_dim
        self.patch_embed = nn.Conv2d(3, width, patch, stride=patch, bias=False)
        self.cls = nn.Parameter(torch.randn(1, 1, width) * 0.01)
        self.pos = nn.Parameter(torch.randn(1, (image_size // patch) ** 2 + 1, width) * 0.01)
        self.ln_pre = nn.LayerNorm(width, eps=CLIP_LN_EPS)
        self.layers = nn.ModuleList([TransformerLayer(width, heads, CLIP_LN_EPS, quick_gelu)
                                     for _ in range(layers)])
        self.ln_post = nn.LayerNorm(width, eps=CLIP_LN_EPS)
        self.proj = nn.Linear(width, out_dim, bias=False)

    def forward(self, images: torch.Tensor, pool: bool = True) -> torch.Tensor:
        b = images.shape[0]
        x = self.patch_embed(images.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls.expand(b, 1, self.width), x], dim=1) + self.pos
        x = self.ln_pre(x)
        for layer in self.layers:
            x = layer(x)
        x = self.ln_post(x)
        return self.proj(x[:, 0]) if pool else x


class FrozenClipImageEmbedder(nn.Module):
    """NHWC images -> (B, out_dim) CLIP image embedding."""

    def __init__(self, tower: Optional[nn.Module] = None):
        super().__init__()
        self.clip_image = tower if tower is not None else ImageTransformerEncoder()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.clip_image(images, pool=True)


class FrozenClipMultiImageEmbedder(nn.Module):
    """Per-view CLIP and a learned ``projection``: (B, V, H, W, 3) camera
    views -> (B, V, out_dim) tokens."""

    def __init__(self, out_dim: int = 512, tower: Optional[nn.Module] = None):
        super().__init__()
        self.out_dim = out_dim
        self.clip_image = tower if tower is not None else ImageTransformerEncoder()
        self.projection = nn.Linear(self.clip_image.out_dim, out_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b, v = images.shape[:2]
        z = self.clip_image(images.reshape(b * v, *images.shape[2:]).float(), pool=True)
        return self.projection(z).reshape(b, v, self.out_dim)
