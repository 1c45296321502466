"""Vector quantization with taming VectorQuantizer2 semantics.

Counterpart of ``lidar_layout_tpu/nn/quantize.py`` (``VectorQuantizer``,
``perplexity``): the nearest code comes from one distance matmul in f32 (a
plain large product, left to ``torch.matmul`` as the JAX package leaves it
to XLA). NCHW in and out. The codebook starts uniform in +-1/n_embed, the
JAX package's default ("taming"). The loss and the straight-through value
stop gradients where JAX's ``stop_gradient``s do: the commitment term
trains the encoder, the embedding term the codebook, and the decoder's
gradient reaches the encoder unchanged.
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
        nn.init.uniform_(self.embedding.weight, -1.0 / n_embed, 1.0 / n_embed)

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """z (B, C, H, W) -> (z_q in z's dtype, codebook loss, indices (B, H, W)).

        loss = beta * mean((sg[z_q] - z)^2) + mean((z_q - sg[z])^2)."""
        zl = z.permute(0, 2, 3, 1)                      # channels last, as JAX
        flat = zl.reshape(-1, self.embed_dim).float()
        cb = self.embedding.weight.float()
        # ||z - e||^2 = ||z||^2 + ||e||^2 - 2 z.e, in f32 under autocast too
        with torch.autocast(z.device.type, enabled=False):
            d = (flat.square().sum(dim=1, keepdim=True) + cb.square().sum(dim=1)[None, :]
                 - 2.0 * torch.matmul(flat, cb.t()))
        idx = torch.argmin(d, dim=1)
        z_q = self.embed_code(idx).reshape(zl.shape).to(z.dtype)
        commit = torch.mean((z_q.detach() - zl) ** 2)
        embed = torch.mean((z_q - zl.detach()) ** 2)
        loss = self.beta * commit + embed
        z_q = zl + (z_q - zl).detach()                  # straight-through estimator
        return (z_q.permute(0, 3, 1, 2).contiguous(), loss,
                idx.reshape(zl.shape[:-1]))

    def embed_code(self, idx: torch.Tensor) -> torch.Tensor:
        """Codebook rows of ``idx`` (any shape) -> idx.shape + (embed_dim,)."""
        return self.embedding.weight[idx]


def perplexity(indices: torch.Tensor, n_embed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codebook usage: (exp of the entropy of the codes' frequencies, the
    number of codes used), each a 0-d tensor."""
    avg = torch.bincount(indices.reshape(-1), minlength=n_embed).float() / indices.numel()
    perp = torch.exp(-torch.sum(avg * torch.log(avg + 1e-10)))
    return perp, (avg > 0).sum()
