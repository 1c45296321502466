"""The KL autoencoder's objective (the reference's LPIPSWithDiscriminator).

Counterpart of ``lidar_layout_tpu/losses/contperceptual.py``: the
reconstruction NLL under a fixed log-variance plus the weighted KL of the
posterior to N(0, I). The GAN terms are the trainer's
(``train/family_trainer.make_kl_train_step``). JAX's config also carries
``pixelloss_weight`` (read, never used) and ``perceptual_weight`` (never
set, so its perceptual term never runs); the port keeps neither.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..models.autoencoder import DiagonalGaussian


@dataclasses.dataclass(frozen=True)
class KLLossConfig:
    kl_weight: float = 1e-6
    logvar_init: float = 0.0


def kl_autoencoder_loss(cfg: KLLossConfig, inputs: torch.Tensor, reconstructions: torch.Tensor,
                        posterior: DiagonalGaussian, logvar: float
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """rec = |x - x_rec|; nll = sum(rec / exp(logvar) + logvar) / B;
    loss = nll + kl_weight * sum(KL) / B. Parts ``loss``, ``nll_loss``,
    ``kl_loss``, ``rec_loss`` (the mean of rec)."""
    lv = torch.as_tensor(logvar, dtype=torch.float32)
    rec = (inputs - reconstructions).abs()
    b = inputs.shape[0]
    nll = (rec / torch.exp(lv) + lv).sum() / b
    kl = posterior.kl().sum() / posterior.mean.shape[0]
    loss = nll + cfg.kl_weight * kl
    return loss, {"loss": loss, "nll_loss": nll, "kl_loss": kl, "rec_loss": rec.mean()}
