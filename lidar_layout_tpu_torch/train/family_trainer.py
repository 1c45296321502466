"""Trainers of the R2DM, object-AE and KL-AE families.

Counterpart of the ``AutoencoderKL``, ``R2DMDiffusion`` and ``VQModelObject``
branches of ``build_family_trainer`` and of ``make_kl_train_step`` in
``lidar_layout_tpu/train/build.py`` (its cube branches are
``train/cube_trainer``, whose ``create_simple_state`` and ``_update`` these
share: ``optax.adamw(lr)`` with optax's defaults, weight decay 1e-4 on every
parameter and no clipping, then the EMA with LitEma's warm-up
``min(0.9999, (1 + step) / (10 + step))`` taken before the increment).

- R2DM: ``p_losses`` of the batch's (B, H, W, 2) ``image``; validation is
  the loss on the EMA weights (``val/loss_simple_ema``).
- Object AE: the mean over objects of ``object_ae_loss`` on the batch's
  (B, P, 3) ``fg_points`` (the port runs the batch at once where JAX vmaps
  one object); validation is the chamfer loss on the EMA weights
  (``val/rec_loss``). JAX's branch has no ``MultiSteps``, so the YAML's
  ``accumulate_grad_batches: 2`` only scales the learning rate.
- KL AE: two Adams (0.5, 0.9), as the VQ-GAN's (``train/ae_trainer``): the
  generator takes the NLL and KL at ``logvar_init`` plus half the
  discriminator's hinge generator loss, the discriminator the hinge loss
  of the image against the reconstruction before the update; validation
  is the reconstruction loss at logvar 0 (``val/rec_loss``). The
  discriminator is JAX's ``LiDARNLayerDiscriminator()`` on the
  reconstruction's channels.

Each step is ``step(state, batch, generator, ...)``; the draws (R2DM's t and
noise, the KL posterior's noise) come from the generator unless given.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..losses.contperceptual import KLLossConfig, kl_autoencoder_loss
from ..losses.discriminator import LiDARNLayerDiscriminator, hinge_d_loss
from ..models.autoencoder import AutoencoderKL
from ..models.object_ae import VQModelObject, object_ae_loss
from ..models.r2dm import R2DMDiffusion
from .ae_trainer import AETrainState, create_ae_state
from .cube_trainer import _update, create_simple_state
from .diffusion_trainer import DiffusionTrainState, _autocast


# ------------------------------------------------------------------ R2DM
def make_r2dm_train_step(model: R2DMDiffusion) -> Callable:
    """step(state, batch, generator, t=None, noise=None) -> (state, logs
    ``loss``, ``grad_norm``)."""

    def step(state: DiffusionTrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator], t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None):
        model.train()
        loss, _ = model.p_losses(batch["image"].float(), generator, t=t, noise=noise)
        loss.backward()
        logs = {"loss": loss.detach()}
        _update(state, logs)
        return state, logs

    return step


def make_r2dm_val_step(model: R2DMDiffusion) -> Callable:
    def val_step(state: DiffusionTrainState, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.no_grad(), state.ema.swapped_in(state.params):
            loss, _ = model.p_losses(batch["image"].float(), generator)
        return {"loss_simple_ema": loss}

    return val_step


# ------------------------------------------------------------- object AE
def object_batch_loss(model: VQModelObject, points: torch.Tensor
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mean over objects of ``object_ae_loss`` and of each part."""
    rec, qloss, _ = model(points)
    losses, parts = object_ae_loss(rec, points, qloss)
    return losses.mean(), {k: v.mean() for k, v in parts.items()}


def make_object_train_step(model: VQModelObject) -> Callable:
    """step(state, batch, generator) -> (state, logs ``loss``, ``rec_loss``,
    ``quant_loss``, ``grad_norm``)."""

    def step(state: DiffusionTrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator]):
        model.train()
        loss, parts = object_batch_loss(model, batch["fg_points"].float())
        loss.backward()
        logs = {k: v.detach() for k, v in parts.items()}
        _update(state, logs)
        return state, logs

    return step


def make_object_val_step(model: VQModelObject) -> Callable:
    def val_step(state: DiffusionTrainState, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.no_grad(), state.ema.swapped_in(state.params):
            _, parts = object_batch_loss(model, batch["fg_points"].float())
        return {"rec_loss": parts["rec_loss"]}

    return val_step


# ----------------------------------------------------------------- KL AE
def kl_loss_config(model_cfg: Dict[str, Any]) -> KLLossConfig:
    """The loss block's ``kl_weight``: JAX also reads ``pixelloss_weight``
    and never uses it."""
    lc = (model_cfg.get("params") or {}).get("lossconfig") or {}
    lp = lc.get("params", {}) if isinstance(lc, dict) else {}
    return KLLossConfig(kl_weight=float(lp.get("kl_weight", 1e-6)))


def _nchw(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return batch["image"].permute(0, 3, 1, 2).float()


def make_kl_train_step(model: AutoencoderKL, disc: torch.nn.Module,
                       loss_cfg: KLLossConfig,
                       autocast_dtype: Optional[torch.dtype] = None) -> Callable:
    """step(state, batch, generator, noise=None) -> (state, logs): the loss
    parts, ``g_loss``, ``total_loss`` and ``disc_loss`` (0-d tensors). With
    ``autocast_dtype`` the model's forward runs under autocast, as the
    VQ-GAN's (``train/ae_trainer``); the loss and the discriminator see the
    reconstruction in float32."""
    params_g, params_d = list(model.parameters()), list(disc.parameters())

    def step(state: AETrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator], noise: Optional[torch.Tensor] = None):
        model.train()
        disc.train()
        x = _nchw(batch)
        with _autocast(model, autocast_dtype):
            dec, posterior = model(x, generator, noise=noise)
        dec = dec.float()
        loss, parts = kl_autoencoder_loss(loss_cfg, x, dec, posterior, loss_cfg.logvar_init)
        g_loss = -torch.mean(disc(dec))
        total = loss + 0.5 * g_loss
        grads_g = list(torch.autograd.grad(total, params_g))
        d_loss = hinge_d_loss(disc(x), disc(dec.detach()))
        grads_d = list(torch.autograd.grad(d_loss, params_d))
        state.opt_g.step(grads_g)
        state.opt_d.step(grads_d)
        state.step += 1
        logs = {k: v.detach() for k, v in parts.items()}
        logs.update(g_loss=g_loss.detach(), total_loss=total.detach(), disc_loss=d_loss.detach())
        return state, logs

    return step


def make_kl_val_step(model: AutoencoderKL, loss_cfg: KLLossConfig,
                     autocast_dtype: Optional[torch.dtype] = None) -> Callable:
    def val_step(state: AETrainState, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        model.eval()
        x = _nchw(batch)
        with torch.no_grad():
            with _autocast(model, autocast_dtype):
                dec, posterior = model(x, generator)
            _, parts = kl_autoencoder_loss(loss_cfg, x, dec.float(), posterior, 0.0)
        return {"rec_loss": parts["rec_loss"], "kl_loss": parts["kl_loss"]}

    return val_step


# ------------------------------------------------------------- dispatcher
def family_training(model: torch.nn.Module, model_cfg: Dict[str, Any], lr: float,
                    accumulate: int = 1, lr_lambda: Optional[Callable[[int], float]] = None,
                    autocast_dtype: Optional[torch.dtype] = None
                    ) -> Tuple[Any, Callable, Callable, str]:
    """(state, step, val_step, monitored metric) of an R2DM, object-AE or
    KL-AE model, as JAX's ``build_family_trainer`` builds them; the KL
    discriminator starts from torch's current generator. ``autocast_dtype``
    reaches the KL AE alone (JAX's builders drop the dtype of the others)."""
    if isinstance(model, R2DMDiffusion):
        return (create_simple_state(model, dict(model.named_parameters()), lr, lr_lambda),
                make_r2dm_train_step(model), make_r2dm_val_step(model), "val/loss_simple_ema")
    if isinstance(model, VQModelObject):
        return (create_simple_state(model, dict(model.named_parameters()), lr, lr_lambda),
                make_object_train_step(model), make_object_val_step(model), "val/rec_loss")
    if isinstance(model, AutoencoderKL):
        loss_cfg = kl_loss_config(model_cfg)
        dev = next(model.parameters()).device
        disc = LiDARNLayerDiscriminator(model.cfg.out_ch).to(dev)
        state = create_ae_state(model, disc, lr, lr, accumulate, lr_lambda)
        return (state, make_kl_train_step(model, disc, loss_cfg, autocast_dtype),
                make_kl_val_step(model, loss_cfg, autocast_dtype), "val/rec_loss")
    raise TypeError(f"no family trainer for {type(model).__name__}")
