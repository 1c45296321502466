"""Layout (object box) encoder of the layout-conditioned range LiDM.

Counterpart of ``lidar_layout_tpu/encoders/layout_encoder.py``
(``LayoutEncoderConfig``, ``patch_bboxes``, ``LayoutTransformerEncoder``).
A (B, L, 13) layout, rows [bbox8 | bbox2d4 | class1], becomes the dict that
the object-aware cross-attention U-Net reads: ``xf_out``, ``xf_proj``,
``obj_class_embedding``, ``obj_bbox_embedding``, ``key_padding_mask`` (True
where a slot holds an object) and ``image_patch_bbox_embedding_res{r}`` per
attention resolution.

It follows flax's defaults where torch's differ: LayerNorm eps 1e-6, the
tanh GELU, and an attention with no mask (padding slots attend too), q scaled
by dh^-1/2. The image-patch boxes go through the same ``obj_bbox_embedding``
layer as the objects' boxes. Modules keep the JAX names (``ln1_0``,
``attn_0.query``, ``mlp_in_0``, ``transformer_proj``, ...). It runs in
float32 in a model of any dtype, as the JAX package builds it without one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

LN_EPS = 1e-6   # flax LayerNorm


@dataclasses.dataclass(frozen=True)
class LayoutEncoderConfig:
    layout_length: int = 13
    hidden_dim: int = 256
    output_dim: int = 1024
    num_layers: int = 6
    num_heads: int = 8
    num_classes: int = 9
    use_final_ln: bool = True
    use_positional_embedding: bool = False
    feature_map_size: Tuple[int, int] = (8, 128)
    resolution_to_attention: Tuple[int, ...] = (8, 4, 2)  # H of each level


def patch_bboxes(h: int, w: int) -> np.ndarray:
    """(h*w, 4) normalised [x0, y0, x1, y1] of each feature-map cell."""
    iy, ix = 1.0 / h, 1.0 / w
    out = [(ix * j, iy * i, ix * (j + 1), iy * (i + 1))
           for i in range(h) for j in range(w)]
    return np.asarray(out, np.float32)


class SelfAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` over one sequence, no mask:
    ``query``/``key``/``value`` project to (heads, dh) and ``out`` back."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value, self.out = (nn.Linear(dim, dim) for _ in range(4))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        b, l, d = h.shape
        dh = d // self.heads
        q, k, v = (m(h).view(b, l, self.heads, dh) for m in (self.query, self.key, self.value))
        logits = torch.einsum("bqhd,bkhd->bhqk", q / dh ** 0.5, k)
        wgt = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", wgt, v).reshape(b, l, d))


class LayoutTransformerEncoder(nn.Module):
    def __init__(self, cfg: LayoutEncoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_dim
        self.obj_class_embedding = nn.Embedding(cfg.num_classes, d)
        self.obj_bbox_embedding = nn.Linear(4, d)
        self.obj_bbox_encoding = nn.Linear(8, d)
        if cfg.use_positional_embedding:
            self.positional_embedding = nn.Parameter(
                0.01 * torch.randn(cfg.layout_length, d))
        for i in range(cfg.num_layers):
            self.add_module(f"ln1_{i}", nn.LayerNorm(d, eps=LN_EPS))
            self.add_module(f"attn_{i}", SelfAttention(d, cfg.num_heads))
            self.add_module(f"ln2_{i}", nn.LayerNorm(d, eps=LN_EPS))
            self.add_module(f"mlp_in_{i}", nn.Linear(d, 4 * d))
            self.add_module(f"mlp_out_{i}", nn.Linear(4 * d, d))
        if cfg.use_final_ln:
            self.final_ln = nn.LayerNorm(d, eps=LN_EPS)
        self.transformer_proj = nn.Linear(d, cfg.output_dim)
        hh, ww = cfg.feature_map_size
        for res in cfg.resolution_to_attention:
            self.register_buffer(f"patch_bbox_res{res}", torch.from_numpy(
                patch_bboxes(res, int(ww / (hh / res)))), persistent=False)

    def f32_parameters(self) -> Iterator[nn.Parameter]:
        """Parameters that stay float32 in a model of another dtype: all."""
        return self.parameters()

    def forward(self, layout: torch.Tensor) -> Dict[str, torch.Tensor]:
        """layout (B, L, 13) = [bbox8 | bbox2d4 | class1] -> the conditioning
        dict, float32 (the mask bool)."""
        cfg = self.cfg
        layout = layout.float()
        obj_bbox, obj_bbox_2d, obj_class = layout.split([8, 4, 1], dim=-1)
        obj_class = obj_class[..., 0].to(torch.int32)
        cls_emb = self.obj_class_embedding(obj_class)
        bbox_emb = self.obj_bbox_embedding(obj_bbox_2d)
        xf = cls_emb + bbox_emb + self.obj_bbox_encoding(obj_bbox)
        if cfg.use_positional_embedding:
            xf = xf + self.positional_embedding[None]
        for i in range(cfg.num_layers):
            xf = xf + getattr(self, f"attn_{i}")(getattr(self, f"ln1_{i}")(xf))
            h = getattr(self, f"mlp_in_{i}")(getattr(self, f"ln2_{i}")(xf))
            xf = xf + getattr(self, f"mlp_out_{i}")(F.gelu(h, approximate="tanh"))
        if cfg.use_final_ln:
            xf = self.final_ln(xf)
        out = {"xf_out": xf, "xf_proj": self.transformer_proj(xf[:, 0]),
               "obj_class_embedding": cls_emb, "obj_bbox_embedding": bbox_emb,
               "key_padding_mask": obj_class > 0}
        for res in cfg.resolution_to_attention:
            emb = self.obj_bbox_embedding(getattr(self, f"patch_bbox_res{res}"))
            out[f"image_patch_bbox_embedding_res{res}"] = emb[None].expand(
                layout.shape[0], *emb.shape)
        return out
