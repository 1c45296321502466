"""Latent diffusion over sparse-voxel latents (the cube stage).

Counterpart of ``lidar_layout_tpu/models/cube_diffusion.py``:
``SparseUNetConfig``, ``VoxelAttention``, ``SparseUNet``,
``CubeDiffusionConfig`` and ``CubeDiffusion`` (``p_losses``,
``ddim_sample``). Batched over a leading grid dimension, where JAX ``vmap``s
one grid at a time; each grid's result is JAX's for that grid alone:

- one timestep per grid, broadcast to its voxels;
- the positional input ``coords / max(coords.max(), 1)`` takes each grid's
  own maximum over its whole coords array, padding rows included (a
  per-grid ``amax``, never the batch's);
- ``VoxelAttention`` is global attention over a grid's voxels with the
  padding keys masked. JAX computes it with ``jax.nn.dot_product_attention``
  (plain XLA, no Pallas kernel), so here it is plain matmuls and softmax.

The config builder gives the model its frozen first stage
(``first_stage_model``, a ``SparseVAE``) as the port's ``LatentDiffusion``
holds its autoencoder; the JAX trainer builds it beside the model. Module
names are flax's (``unet.time_0``, ``unet.conv_1.w``, ``unet.attn_1.qkv``, ...).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.embeddings import timestep_embedding
from ..ops.voxel import OFFSETS_27, VoxelGrid, neighbor_table
from ..parallel.collectives import rank_rows
from .schedules import DDIMSchedule, DiffusionSchedule, q_sample
from .sparse_vae import SparseConvBlock, SparseVAE

# jax.nn.dot_product_attention's logit for a masked key
_MASKED_LOGIT = -0.7 * float(torch.finfo(torch.float32).max)


@dataclasses.dataclass(frozen=True)
class SparseUNetConfig:
    in_channels: int = 16
    model_channels: int = 64
    num_blocks: int = 4
    num_heads: int = 4
    bits: int = 10


class VoxelAttention(nn.Module):
    """Global self-attention over each grid's valid voxels: LayerNorm (f32,
    eps 1e-6), ``qkv`` as [q, k, v] each split into heads, padding keys
    masked, ``proj`` (zero-initialised, so a fresh block is the identity on
    valid rows), residual, padding rows zeroed."""

    def __init__(self, channels: int, heads: int):
        super().__init__()
        self.heads = heads
        self.norm = nn.LayerNorm(channels, eps=1e-6)
        self.qkv = nn.Linear(channels, 3 * channels)
        self.proj = nn.Linear(channels, channels)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        d = c // self.heads
        qkv = self.qkv(self.norm(x.float())).view(b, n, 3, self.heads, d)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))   # (B, H, N, D)
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        logits = logits.masked_fill(~mask[:, None, None, :], _MASKED_LOGIT)
        out = torch.matmul(torch.softmax(logits, dim=-1), v)
        out = self.proj(out.transpose(1, 2).reshape(b, n, c))
        return (x + out) * mask[..., None]


class SparseUNet(nn.Module):
    """Sparse denoiser: timestep MLP, ijk positional input, per-block FiLM,
    ``SparseConvBlock``s with ``VoxelAttention`` after every odd block, a
    final LayerNorm and a zero-initialised projection. The conditional input (``cond_proj``)
    has no caller in the repository's configs and is not ported."""

    def __init__(self, cfg: SparseUNetConfig):
        super().__init__()
        self.cfg = cfg
        mc, td = cfg.model_channels, 4 * cfg.model_channels
        self.time_0 = nn.Linear(mc, td)
        self.time_2 = nn.Linear(td, td)
        self.in_proj = nn.Linear(cfg.in_channels, mc)
        self.pos_proj = nn.Linear(3, mc)
        for i in range(cfg.num_blocks):
            setattr(self, f"film_{i}", nn.Linear(td, 2 * mc))
            setattr(self, f"conv_{i}", SparseConvBlock(mc, mc, cfg.bits))
            if i % 2 == 1:
                setattr(self, f"attn_{i}", VoxelAttention(mc, cfg.num_heads))
        self.norm_out = nn.LayerNorm(mc, eps=1e-6)
        self.out = nn.Linear(mc, cfg.in_channels)
        nn.init.zeros_(self.out.weight)
        nn.init.zeros_(self.out.bias)

    def forward(self, grid: VoxelGrid, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """``x`` (B, cap, in_channels), ``t`` (B, cap) timesteps."""
        cfg = self.cfg
        b, cap, _ = x.shape
        emb = timestep_embedding(t.reshape(-1), cfg.model_channels).view(b, cap, -1)
        emb = F.silu(self.time_2(F.silu(self.time_0(emb))))
        pos = grid.coords.float()
        pos = pos / pos.amax(dim=(1, 2), keepdim=True).clamp(min=1.0)
        mask = grid.mask[..., None]
        h = (self.in_proj(x) + self.pos_proj(pos)) * mask
        table = neighbor_table(grid, OFFSETS_27, cfg.bits)
        for i in range(cfg.num_blocks):
            scale, shift = getattr(self, f"film_{i}")(emb).chunk(2, dim=-1)
            h = h * (1 + scale) + shift
            h = getattr(self, f"conv_{i}")(grid, h, table)
            if i % 2 == 1:
                h = getattr(self, f"attn_{i}")(h, grid.mask)
        return self.out(self.norm_out(h.float())) * mask


@dataclasses.dataclass(frozen=True)
class CubeDiffusionConfig:
    timesteps: int = 1000
    linear_start: float = 1e-4
    linear_end: float = 2e-2
    latent_dim: int = 16


class CubeDiffusion(nn.Module):
    """Diffusion over (grid, latent) pairs, one timestep per grid."""

    def __init__(self, cfg: CubeDiffusionConfig, unet_cfg: SparseUNetConfig,
                 first_stage: Optional[SparseVAE] = None):
        super().__init__()
        self.cfg = cfg
        self.schedule = DiffusionSchedule.create(timesteps=cfg.timesteps,
                                                 linear_start=cfg.linear_start,
                                                 linear_end=cfg.linear_end)
        self.unet = SparseUNet(unet_cfg)
        self.first_stage_model = first_stage

    def p_losses(self, grid: VoxelGrid, z0: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The masked MSE between the U-Net's output and the noise, over the
        valid rows and ``latent_dim``, per grid: (loss (B,), {"loss"}).
        ``t`` (B,) and ``noise`` (B, cap, latent_dim) are drawn from
        ``generator`` unless given (under an initialised process group, this
        rank's rows of the global batch's draws: ``rank_rows``)."""
        b, cap, c = z0.shape
        if t is None:   # under dp: this rank's rows of the global batch's draws
            t = rank_rows(lambda n: torch.randint(0, self.cfg.timesteps, (n,),
                                                  generator=generator, device=z0.device), b)
        if noise is None:
            noise = rank_rows(lambda n: torch.randn((n, cap, c), generator=generator,
                                                    device=z0.device), b)
        t = t.to(z0.device)
        m = grid.mask[..., None].to(z0.dtype)
        z_noisy = q_sample(self.schedule, z0, t, noise) * m
        out = self.unet(grid, z_noisy, t[:, None].expand(b, cap))
        loss = (((out - noise) ** 2) * m).sum(dim=(1, 2)) / (m.sum(dim=(1, 2)).clamp(min=1.0)
                                                             * c)
        return loss, {"loss": loss}

    @torch.no_grad()
    def ddim_sample(self, grid: VoxelGrid, steps: int = 50,
                    generator: Optional[torch.Generator] = None,
                    x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Deterministic DDIM (eta 0, JAX's default, which no caller
        changes) over the given grids (their topology is fixed): (B, cap,
        latent_dim) latents. ``x_T`` is the only draw (from ``generator``
        unless given; under an initialised process group, this rank's rows
        of the global batch's draw: ``rank_rows``)."""
        b, cap = grid.mask.shape
        dev = grid.mask.device
        m = grid.mask[..., None].float()
        d = DDIMSchedule.create(self.schedule, steps)
        f32 = [torch.tensor(a[::-1].copy(), dtype=torch.float32, device=dev)
               for a in (d.alphas, d.alphas_prev, d.sqrt_one_minus_alphas)]
        if x_T is None:
            x_T = rank_rows(lambda n: torch.randn((n, cap, self.cfg.latent_dim),
                                                  generator=generator, device=dev), b)
        z = x_T.to(dev).float() * m
        for i, tt in enumerate(d.timesteps[::-1]):
            at, ap, s = (a[i] for a in f32)
            e = self.unet(grid, z, torch.full((b, cap), int(tt), device=dev))
            x0 = (z - s * e) / torch.sqrt(at)
            z = (torch.sqrt(ap) * x0 + torch.sqrt((1.0 - ap).clamp(min=0.0)) * e) * m
        return z
