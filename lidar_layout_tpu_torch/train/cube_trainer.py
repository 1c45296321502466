"""Trainers of the cube stage: the sparse-voxel VAE and the cube latent
diffusion over its latents.

Counterpart of ``SimpleTrainState``, ``_simple_state``, ``_simple_update``
and the ``SparseVAE`` and ``CubeDiffusion`` branches of
``build_family_trainer`` in ``lidar_layout_tpu/train/build.py``. A state is a
``DiffusionTrainState``: the model, the trained parameters by state_dict
name, ``optax.adamw(lr)`` with optax's defaults (weight decay 1e-4 on every
parameter, eps 1e-8, betas 0.9/0.999, no clipping) and an EMA with LitEma's
warm-up counted before the update (``layout_trainer.ema_decay``). JAX's cube
branch has no ``MultiSteps``, so a YAML's ``accumulate_grad_batches`` does
not reach these optimizers (ROADMAP section 3).

- ``SparseVAE``: the mean over clouds of ``struct_loss``; AdamW and the EMA
  cover every parameter; validation is ``struct_loss`` on the EMA weights
  (``val/struct_loss``).
- ``CubeDiffusion``: the frozen first stage encodes the clouds (its latent
  draw from the step's generator), then ``p_losses`` per grid; AdamW and
  the EMA cover the U-Net only; validation is the loss on the EMA weights
  (``val/loss_simple_ema``). The first stage's weights come from
  ``first_stage_config.params.ckpt_path`` when it is set: a cube-AE run
  directory (``load_cube_first_stage``).

Batches are ``{"points" (B, N, 3), "feats" (B, N, F), "mask" (B, N)}``.
The steps run in float32, as JAX's cube models do whatever the CLI's dtype.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models.cube_diffusion import CubeDiffusion
from ..models.sparse_vae import SparseVAE, struct_loss
from ..nn.ema import Ema
from .checkpoint import checkpoint_path, latest_step
from .diffusion_trainer import DiffusionTrainState, make_optimizer
from .layout_trainer import WEIGHT_DECAY, ema_decay


def create_simple_state(model: torch.nn.Module, params: Dict[str, torch.nn.Parameter],
                        lr: float, lr_lambda: Optional[Callable[[int], float]] = None
                        ) -> DiffusionTrainState:
    """``_simple_state``: AdamW over ``params`` and the EMA started at them."""
    optimizer = make_optimizer(params, lr, weight_decay=WEIGHT_DECAY, lr_lambda=lr_lambda)
    return DiffusionTrainState(model=model, params=params, optimizer=optimizer,
                               ema=Ema(params))


def _update(state: DiffusionTrainState, logs: Dict[str, torch.Tensor]) -> None:
    """``_simple_update`` after the backward: AdamW, then the EMA."""
    logs["grad_norm"] = state.optimizer.step()
    state.ema.update(state.params, ema_decay(state.step))
    state.step += 1


def vae_batch_loss(model: SparseVAE, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mean over clouds of ``struct_loss`` and of each of its parts."""
    out = model(batch["points"], batch["feats"], batch["mask"], noise=noise,
                generator=generator)
    losses, parts = struct_loss(out, kl_weight=model.cfg.kl_weight)
    return losses.mean(), {k: v.mean() for k, v in parts.items()}


def make_vae_train_step(model: SparseVAE) -> Callable:
    """step(state, batch, generator, noise=None) -> (state, logs): logs
    hold 0-d tensors ``loss``, ``struct_ce_<i>``, ``kl`` and ``grad_norm``."""

    def step(state: DiffusionTrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator], noise: Optional[torch.Tensor] = None):
        model.train()
        loss, parts = vae_batch_loss(model, batch, generator, noise)
        loss.backward()
        logs = {k: v.detach() for k, v in parts.items()}
        logs["loss"] = loss.detach()
        _update(state, logs)
        return state, logs

    return step


def make_vae_val_step(model: SparseVAE) -> Callable:
    def val_step(state: DiffusionTrainState, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.no_grad(), state.ema.swapped_in(state.params):
            loss, _ = vae_batch_loss(model, batch, generator)
        return {"struct_loss": loss}

    return val_step


def encode_clouds(model: CubeDiffusion, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """The frozen first stage's output for a batch of clouds (no gradient)."""
    fs = model.first_stage_model.eval()
    with torch.no_grad():
        return fs(batch["points"], batch["feats"], batch["mask"], noise=noise,
                  generator=generator)


def cube_batch_loss(model: CubeDiffusion, batch: Dict[str, torch.Tensor],
                    generator: Optional[torch.Generator] = None,
                    latent_noise: Optional[torch.Tensor] = None,
                    t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Encode, then the mean over grids of ``p_losses``."""
    out = encode_clouds(model, batch, generator, latent_noise)
    losses, _ = model.p_losses(out["latent_grid"], out["latent"], generator, t=t, noise=noise)
    return losses.mean(), {"loss": losses.mean()}


def make_cube_train_step(model: CubeDiffusion) -> Callable:
    """step(state, batch, generator, latent_noise=None, t=None, noise=None)
    -> (state, logs ``loss``, ``grad_norm``): the draws come from
    ``generator`` (the latent's, then t's, then the noise) unless given."""

    def step(state: DiffusionTrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator], latent_noise: Optional[torch.Tensor] = None,
             t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
        model.unet.train()
        loss, parts = cube_batch_loss(model, batch, generator, latent_noise, t, noise)
        loss.backward()
        logs = {k: v.detach() for k, v in parts.items()}
        _update(state, logs)
        return state, logs

    return step


def make_cube_val_step(model: CubeDiffusion) -> Callable:
    def val_step(state: DiffusionTrainState, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.no_grad(), state.ema.swapped_in(state.params):
            loss, _ = cube_batch_loss(model, batch, generator)
        return {"loss_simple_ema": loss}

    return val_step


def unet_params(model: CubeDiffusion) -> Dict[str, torch.nn.Parameter]:
    """The trained set of the cube diffusion: the U-Net's parameters."""
    return {f"unet.{n}": p for n, p in model.unet.named_parameters()}


def load_cube_first_stage(path: str, vae: SparseVAE) -> None:
    """The latest checkpoint of a cube-AE run into ``vae``: its trained
    weights (the ``model`` state_dict, not the EMA, as JAX's
    ``load_first_stage_params`` reads ``params``). ``path`` is the run
    directory or its ``ckpt/`` directory, as in JAX."""
    ckpt_dir = os.path.join(path, "ckpt") if os.path.isdir(os.path.join(path, "ckpt")) else path
    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no cube-AE checkpoint under {path}")
    ckpt = torch.load(checkpoint_path(ckpt_dir, step), map_location="cpu", weights_only=True)
    vae.load_state_dict(ckpt["model"])


def cube_training(model: torch.nn.Module, model_cfg: Dict[str, Any], lr: float,
                  lr_lambda: Optional[Callable[[int], float]] = None
                  ) -> Tuple[DiffusionTrainState, Callable, Callable, str]:
    """(state, step, val_step, monitored metric) of a cube family model."""
    if isinstance(model, SparseVAE):
        return (create_simple_state(model, dict(model.named_parameters()), lr, lr_lambda),
                make_vae_train_step(model), make_vae_val_step(model), "val/struct_loss")
    fsp = (model_cfg.get("params") or {}).get("first_stage_config", {}).get("params", {})
    if fsp.get("ckpt_path"):
        load_cube_first_stage(fsp["ckpt_path"], model.first_stage_model)
        print(f"first_stage weights <- {fsp['ckpt_path']}")
    model.first_stage_model.requires_grad_(False).eval()
    return (create_simple_state(model, unet_params(model), lr, lr_lambda),
            make_cube_train_step(model), make_cube_val_step(model), "val/loss_simple_ema")
