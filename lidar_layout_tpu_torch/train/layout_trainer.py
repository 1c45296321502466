"""LayoutDiffusion training: one step is the box loss, backward, AdamW, EMA.

Counterpart of the train state and step of ``scripts/train_layout.py``
(``train/build._simple_state`` and ``_simple_update`` in the JAX package):
``optax.chain(clip_by_global_norm(1.0), adamw(lr))`` over every parameter,
the U-Net1D's and the scene-graph encoder's, and an EMA of all of them with
LitEma's warm-up. It reuses ``diffusion_trainer.Optimizer`` and
``nn/ema.Ema``; three things differ from the LiDM's step:

- the weight decay is optax.adamw's default, 1e-4 (the LiDM's AdamW takes
  1e-2);
- the EMA's decay at step s is ``min(0.9999, (1 + s) / (10 + s))`` with s
  counted before the update (0.1 at the first), as ``_simple_update`` takes
  it; ``Ema`` counts after its increment, so the step hands it that value as
  its ``decay``, which is the smaller of the two;
- the model stays in eval mode: JAX's ``apply_model`` never passes
  ``deterministic=False``, so the U-Net1D's dropout is off in its training.

The step runs in float32, the reference's dtype: K1 carries the 22
``CrossAttention``s of a U-Net eval forward and K2 their backward, at
(N boxes, 8, 1, 64).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from ..encoders.scene_graph import Graph, graph_tensors
from ..models.layout_diffusion import LayoutDiffusion
from ..nn.ema import Ema
from .diffusion_trainer import DiffusionTrainState, make_optimizer

WEIGHT_DECAY = 1e-4   # optax.adamw's default
GRAD_CLIP = 1.0
EMA_DECAY = 0.9999


def layout_params(model: LayoutDiffusion) -> Dict[str, torch.nn.Parameter]:
    """Every parameter (``unet.*`` and ``cond_stage.*``): AdamW and the EMA
    cover them all."""
    return dict(model.named_parameters())


def create_layout_train_state(model: LayoutDiffusion, lr: float) -> DiffusionTrainState:
    """AdamW with clipping over ``layout_params(model)``, and the EMA
    started at the current weights."""
    params = layout_params(model)
    optimizer = make_optimizer(params, lr, weight_decay=WEIGHT_DECAY, grad_clip=GRAD_CLIP)
    return DiffusionTrainState(model=model, params=params, optimizer=optimizer,
                               ema=Ema(params))


def ema_decay(step: int) -> float:
    """The EMA's decay at ``step`` (counted before the update), as
    ``_simple_update`` takes it."""
    return min(EMA_DECAY, (1.0 + step) / (10.0 + step))


def make_layout_train_step(model: LayoutDiffusion, timed: bool = False) -> Callable:
    """step(state, graph, generator, t_scene=None, noise=None,
    change_noise=None) -> (state, logs).

    The change noise, the per-scene t and the noise come from ``generator``
    in the JAX order unless given. ``logs`` holds 0-d device tensors: loss,
    loss_simple and grad_norm (before clipping). With ``timed`` the step
    synchronises the device at its phase boundaries and adds
    ``seconds_fwd_bwd`` and ``seconds_opt_ema``."""
    sync = torch.cuda.synchronize if model.device.type == "cuda" else (lambda: None)

    def step(state: DiffusionTrainState, graph: Graph, generator: torch.Generator,
             t_scene: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
             change_noise: Optional[torch.Tensor] = None):
        marks = []

        def mark():
            if timed:
                sync()
                marks.append(time.perf_counter())

        model.eval()
        g = graph_tensors(graph, model.device)
        mark()
        loss, logs = model.p_losses(g, generator, t_scene=t_scene, noise=noise,
                                    change_noise=change_noise)
        loss.backward()
        mark()
        logs["grad_norm"] = state.optimizer.step()
        state.ema.update(state.params, ema_decay(state.step))
        state.step += 1
        mark()
        if timed:
            logs["seconds_fwd_bwd"] = marks[1] - marks[0]
            logs["seconds_opt_ema"] = marks[2] - marks[1]
        return state, logs

    return step
