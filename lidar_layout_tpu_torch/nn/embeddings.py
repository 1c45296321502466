"""Sinusoidal timestep embeddings.

Counterpart of ``lidar_layout_tpu/nn/embeddings.timestep_embedding``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True) -> torch.Tensor:
    """(N,) timesteps -> (N, dim) float32. ``flip_sin_to_cos=True`` is the
    U-Net convention [cos, sin]; False gives [sin, cos]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device)
                      / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    if flip_sin_to_cos:
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    else:
        emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb
