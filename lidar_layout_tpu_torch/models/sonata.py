"""Sonata (Sonata-v1m1): self-distillation pre-training of a PT-v3.

Counterpart of ``lidar_layout_tpu/models/sonata.py`` (``SonataConfig``,
``OnlineCluster``, ``SonataNet``, ``ball_mask``, ``Sonata`` with ``loss`` and
``make_pretrain_step``). A student and a teacher ``SonataNet`` (a PT-v3 and
two prototype heads, flax names kept) and the prototype ``center``; the
student sees the cloud with ball-masked features zeroed, the teacher (no
gradient) the whole cloud, and the loss is DINO's cross-entropy of the
teacher's centred, sharpened assignments against the student's, over the
masked and the unmasked points. A step updates the student with the
caller's torch optimiser, then moves the teacher to its EMA (momentum from
``momentum_base`` to ``momentum_final`` over ``total_steps``) and the
center by ``center_momentum``. The mask size and ratio and the teacher's
temperature warm up linearly over ``warmup_ratio`` of the steps.

PT-v3's attention is kernels K1 (both towers) and K2 (the student's
backward) on the card (``models/ptv3``). ``ball_mask`` draws its 32 seeds
with ``torch.randperm`` on the caller's generator; the JAX function draws
them with ``jax.random.choice``, so the tests feed JAX's seeds in.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .ptv3 import PTv3, PTv3Config


@dataclasses.dataclass(frozen=True)
class SonataConfig:
    head_in_channels: int = 64
    head_hidden_channels: int = 256     # the reference: 4096
    head_embed_channels: int = 64       # the reference: 512
    head_num_prototypes: int = 256      # the reference: 4096
    mask_size_start: float = 0.1
    mask_size_base: float = 0.4
    mask_ratio_start: float = 0.3
    mask_ratio_base: float = 0.7
    warmup_ratio: float = 0.05
    teacher_temp_start: float = 0.04
    teacher_temp_base: float = 0.07
    student_temp: float = 0.1
    mask_loss_weight: float = 0.25
    unmask_loss_weight: float = 0.5
    momentum_base: float = 0.996
    momentum_final: float = 1.0
    center_momentum: float = 0.9
    total_steps: int = 10_000


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    """x * rsqrt(|x|^2 + 1e-12) a row (finite gradient at a zero row)."""
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + 1e-12)


class OnlineCluster(nn.Module):
    """MLP, L2 normalisation, cosine similarity to unit-norm prototypes."""

    def __init__(self, c_in: int, hidden: int, embed: int, num_prototypes: int):
        super().__init__()
        self.mlp1, self.mlp2 = nn.Linear(c_in, hidden), nn.Linear(hidden, embed)
        self.prototype_v = nn.Parameter(torch.randn(num_prototypes, embed) * 0.02)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        h = _unit_rows(self.mlp2(F.gelu(self.mlp1(feat), approximate="tanh")))
        return h @ _unit_rows(self.prototype_v).T


class SonataNet(nn.Module):
    """PT-v3 backbone and the mask / unmask heads: {feat, mask_sim, unmask_sim}."""

    def __init__(self, backbone_cfg: PTv3Config, cfg: SonataConfig):
        super().__init__()
        self.backbone = PTv3(backbone_cfg)
        c_in = backbone_cfg.dec_channels[0]
        heads = (cfg.head_hidden_channels, cfg.head_embed_channels, cfg.head_num_prototypes)
        self.mask_head = OnlineCluster(c_in, *heads)
        self.unmask_head = OnlineCluster(c_in, *heads)

    def forward(self, coord, feat, mask) -> Dict[str, torch.Tensor]:
        h, _ = self.backbone(coord, feat, mask)
        return {"feat": h, "mask_sim": self.mask_head(h), "unmask_sim": self.unmask_head(h)}


def warmup(step: float, start: float, base: float, warm: float) -> float:
    """start -> base linearly over ``warm`` steps, then base."""
    return start + (base - start) * min(max(step / max(warm, 1), 0.0), 1.0)


def ball_mask(coord: torch.Tensor, mask: torch.Tensor, mask_size: float, mask_ratio: float,
              generator: Optional[torch.Generator] = None,
              seed_idx: Optional[torch.Tensor] = None, n_seeds: int = 32) -> torch.Tensor:
    """Points within ``mask_size`` of a prefix of ``n_seeds`` random seed
    points (the prefix whose valid coverage is nearest ``mask_ratio``); the
    seeds are distinct rows drawn from ``generator`` unless given."""
    n = coord.shape[0]
    if seed_idx is None:
        seed_idx = torch.randperm(n, generator=generator, device=generator.device
                                  if generator is not None else "cpu")[:n_seeds]
    seed_idx = seed_idx.to(coord.device)
    d2 = ((coord[:, None] - coord[seed_idx][None]) ** 2).sum(dim=-1)
    size = torch.tensor(mask_size, dtype=coord.dtype, device=coord.device)
    cum = torch.cumsum((d2 <= size ** 2).int(), dim=1) > 0
    frac = (cum & mask[:, None]).sum(dim=0) / torch.clamp(mask.sum(), min=1)
    k = torch.argmin((frac - torch.tensor(mask_ratio, dtype=frac.dtype)).abs())
    return cum[:, k] & mask


def _dino_ce(s_sim, t_sim, center, t_temp, s_temp, sel) -> torch.Tensor:
    t_prob = torch.softmax((t_sim - center) / t_temp, dim=-1)
    ce = -(t_prob * torch.log_softmax(s_sim / s_temp, dim=-1)).sum(dim=-1)
    w = sel.to(ce.dtype)
    return (ce * w).sum() / torch.clamp(w.sum(), min=1.0)


class Sonata(nn.Module):
    """The student, its EMA teacher and the prototype center."""

    def __init__(self, backbone_cfg: PTv3Config, cfg: SonataConfig):
        super().__init__()
        self.cfg = cfg
        self.student = SonataNet(backbone_cfg, cfg)
        self.teacher = copy.deepcopy(self.student).requires_grad_(False)
        self.register_buffer("center", torch.zeros(cfg.head_num_prototypes))

    def schedules(self, step: int) -> Tuple[float, float, float]:
        """(mask size, mask ratio, teacher temperature) at ``step``."""
        c = self.cfg
        warm = c.total_steps * c.warmup_ratio
        return (warmup(step, c.mask_size_start, c.mask_size_base, warm),
                warmup(step, c.mask_ratio_start, c.mask_ratio_base, warm),
                warmup(step, c.teacher_temp_start, c.teacher_temp_base, warm))

    def loss(self, coord, feat, mask, step: int, generator: Optional[torch.Generator] = None,
             seed_idx: Optional[torch.Tensor] = None):
        """(loss, the teacher's batch center, the ball mask)."""
        c = self.cfg
        m_size, m_ratio, t_temp = self.schedules(step)
        masked = ball_mask(coord, mask, m_size, m_ratio, generator, seed_idx)
        s_out = self.student(coord, torch.where(masked[:, None], 0.0, feat), mask)
        with torch.no_grad():
            t_out = self.teacher(coord, feat, mask)
        loss = (c.mask_loss_weight * _dino_ce(s_out["mask_sim"], t_out["mask_sim"], self.center,
                                              t_temp, c.student_temp, masked)
                + c.unmask_loss_weight * _dino_ce(s_out["unmask_sim"], t_out["unmask_sim"],
                                                  self.center, t_temp, c.student_temp,
                                                  mask & ~masked))
        w = mask.to(coord.dtype)
        batch_center = (t_out["unmask_sim"] * w[:, None]).sum(0) / torch.clamp(w.sum(), min=1.0)
        return loss, batch_center, masked

    @torch.no_grad()
    def update_teacher(self, step: int, batch_center: torch.Tensor) -> None:
        """The teacher to its EMA of the (updated) student, the center to
        its EMA of the batch's."""
        c = self.cfg
        mom = c.momentum_base + (c.momentum_final - c.momentum_base) * min(
            max(step / c.total_steps, 0.0), 1.0)
        t, s = list(self.teacher.parameters()), list(self.student.parameters())
        torch._foreach_mul_(t, mom)
        torch._foreach_add_(t, s, alpha=1.0 - mom)
        self.center.mul_(c.center_momentum).add_((1.0 - c.center_momentum) * batch_center)

    def make_pretrain_step(self, optimizer: torch.optim.Optimizer) -> Callable:
        """step_fn(coord, feat, mask, step, generator=None, seed_idx=None)
        -> the loss (a 0-d tensor): backward, ``optimizer`` on the student,
        then ``update_teacher``."""

        def step_fn(coord, feat, mask, step: int, generator=None, seed_idx=None):
            self.student.train()
            optimizer.zero_grad(set_to_none=True)
            loss, batch_center, _ = self.loss(coord, feat, mask, step, generator, seed_idx)
            loss.backward()
            optimizer.step()
            self.update_teacher(step, batch_center)
            return loss.detach()

        return step_fn
