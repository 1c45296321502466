"""Noisy-latent classifier for classifier guidance.

Counterpart of ``lidar_layout_tpu/models/classifier.py``: ``EncoderUNetModel``
(the downsampling half of the diffusion U-Net, a spatial mean and a linear
head) over q_sample'd NHWC latents, and ``NoisyLatentClassifier`` with its
cross-entropy ``loss`` and ``guidance_grad``, d log p(y | z_t) / d z_t. Its
ResBlocks and ``norm_out`` go through kernel K3, forward and backward. The
modules keep the flax names (``t0``, ``t2``, ``conv_in``, ``enc_l_i``,
``down_l``, ``norm_out``, ``head``); a ResBlock's layers are those of
``models/unet.ResBlock``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.blocks import Normalize
from ..nn.embeddings import timestep_embedding
from .schedules import DiffusionSchedule, q_sample
from .unet import ResBlock, UNetDown, _conv3


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    in_channels: int = 8
    model_channels: int = 64
    num_classes: int = 10
    num_res_blocks: int = 1
    channel_mult: Tuple[int, ...] = (1, 2, 4)
    timesteps: int = 1024
    cconv: bool = True


class EncoderUNetModel(nn.Module):
    """NCHW latents and timesteps -> (B, num_classes) logits."""

    def __init__(self, cfg: ClassifierConfig):
        super().__init__()
        self.cfg = cfg
        mc, ted = cfg.model_channels, cfg.model_channels * 4
        self.t0, self.t2 = nn.Linear(mc, ted), nn.Linear(ted, ted)
        self.conv_in = _conv3(cfg.in_channels, mc, cfg.cconv)
        ch = mc
        for level, mult in enumerate(cfg.channel_mult):
            for i in range(cfg.num_res_blocks):
                setattr(self, f"enc_{level}_{i}", ResBlock(ch, ted, mc * mult, cconv=cfg.cconv))
                ch = mc * mult
            if level != len(cfg.channel_mult) - 1:
                setattr(self, f"down_{level}", UNetDown(ch, cfg.cconv))
        self.norm_out = Normalize(ch, act=True)
        self.head = nn.Linear(ch, cfg.num_classes)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        emb = self.t2(F.silu(self.t0(timestep_embedding(timesteps, cfg.model_channels))))
        h = self.conv_in(x)
        for level in range(len(cfg.channel_mult)):
            for i in range(cfg.num_res_blocks):
                h = getattr(self, f"enc_{level}_{i}")(h, emb)
            if level != len(cfg.channel_mult) - 1:
                h = getattr(self, f"down_{level}")(h)
        return self.head(self.norm_out(h).mean(dim=(2, 3)))


class NoisyLatentClassifier(nn.Module):
    """The classifier over noised NHWC latents and its guidance gradient."""

    def __init__(self, cfg: ClassifierConfig, diffusion_schedule: Optional[DiffusionSchedule] = None):
        super().__init__()
        self.cfg = cfg
        self.schedule = diffusion_schedule or DiffusionSchedule.create(
            timesteps=cfg.timesteps, linear_start=0.0015, linear_end=0.0195)
        self.net = EncoderUNetModel(cfg)

    def logits(self, z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.net(z.permute(0, 3, 1, 2), t)

    def loss(self, z0: torch.Tensor, labels: torch.Tensor,
             generator: Optional[torch.Generator] = None, t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Cross-entropy on z0 noised at uniform timesteps: t, then the
        noise, drawn from ``generator`` on its device unless given."""
        if t is None:
            t = torch.randint(0, self.cfg.timesteps, (z0.shape[0],), generator=generator,
                              device=generator.device).to(z0.device)
        if noise is None:
            noise = torch.randn(z0.shape, generator=generator,
                                device=generator.device).to(z0.device)
        logits = self.logits(q_sample(self.schedule, z0, t, noise), t)
        rows = torch.arange(len(labels), device=logits.device)
        loss = -F.log_softmax(logits, dim=-1)[rows, labels].mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"loss": loss.detach(), "acc": acc}

    def guidance_grad(self, z: torch.Tensor, t: torch.Tensor,
                      target: torch.Tensor) -> torch.Tensor:
        """d sum_i log p(target_i | z_t) / d z_t, the shape of ``z``."""
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            logits = self.logits(zz, t)
            rows = torch.arange(len(target), device=logits.device)
            logp = F.log_softmax(logits, dim=-1)[rows, target].sum()
            return torch.autograd.grad(logp, zz)[0]
