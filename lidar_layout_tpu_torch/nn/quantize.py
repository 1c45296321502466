"""Vector quantization with taming VectorQuantizer2 semantics (forward).

Counterpart of ``lidar_layout_tpu/nn/quantize.VectorQuantizer``: the nearest
code comes from one distance matmul in f32 (a plain large product, left to
``torch.matmul`` as the JAX package leaves it to XLA). NCHW in and out.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn


class VectorQuantizer(nn.Module):
    """Nearest-codebook lookup over the channel axis of NCHW input. The
    codebook stays float32 whatever the activation dtype."""

    def __init__(self, n_embed: int, embed_dim: int, beta: float = 0.25):
        super().__init__()
        self.n_embed, self.embed_dim, self.beta = n_embed, embed_dim, beta
        self.embedding = nn.Embedding(n_embed, embed_dim)

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """z (B, C, H, W) -> (z_q in z's dtype, codebook loss, indices (B, H, W))."""
        zl = z.permute(0, 2, 3, 1)                      # channels last, as JAX
        flat = zl.reshape(-1, self.embed_dim).float()
        cb = self.embedding.weight.float()
        # ||z - e||^2 = ||z||^2 + ||e||^2 - 2 z.e
        d = (flat.square().sum(dim=1, keepdim=True) + cb.square().sum(dim=1)[None, :]
             - 2.0 * torch.matmul(flat, cb.t()))
        idx = torch.argmin(d, dim=1)
        z_q = cb[idx].reshape(zl.shape).to(z.dtype)
        loss = self.beta * torch.mean((z_q - zl) ** 2) + torch.mean((z_q - zl) ** 2)
        z_q = zl + (z_q - zl)                           # straight-through value
        return (z_q.permute(0, 3, 1, 2).contiguous(), loss,
                idx.reshape(zl.shape[:-1]))
