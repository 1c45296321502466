"""Latent-diffusion training: one step is encode (frozen), p_losses, backward,
AdamW, EMA.

Counterpart of ``lidar_layout_tpu/train/diffusion_trainer.py``. The JAX step
is one jitted program; here it runs eagerly, the kernels K1/K2/K3 carrying
the attention and GroupNorm of the U-Net forward and backward. Parameters
stay float32; ``autocast_dtype=torch.bfloat16`` runs the loss under
``torch.autocast``, which is what the JAX trainer's model dtype does. The
chunked ``lax.scan`` loop (``chunk_steps``) has no eager counterpart: its
successor is a CUDA graph over the step (ROADMAP).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..models.diffusion import LatentDiffusion
from ..nn.ema import Ema
from ..parallel.collectives import all_reduce_grads


def trainable_keys(model: LatentDiffusion) -> Tuple[str, ...]:
    """The U-Net, the conditioning stage when it is trainable, and logvar
    when it is learned (the JAX ``trainable_keys``)."""
    keys = ["unet"]
    if model.cfg.cond_stage_trainable and model.cond_stage_model is not None:
        keys.append("cond_stage")
    if model.cfg.learn_logvar:
        keys.append("logvar")
    return tuple(keys)


def trainable_params(model: LatentDiffusion) -> Dict[str, torch.nn.Parameter]:
    """The trained parameters under their state_dict names; AdamW and the
    EMA cover exactly these."""
    out: Dict[str, torch.nn.Parameter] = {}
    for key in trainable_keys(model):
        if key == "unet":
            out.update({f"model.diffusion_model.{n}": p
                        for n, p in model.unet.named_parameters()})
        elif key == "cond_stage":
            out.update({f"cond_stage_model.{n}": p
                        for n, p in model.cond_stage_model.named_parameters()})
        else:
            out["logvar"] = model.logvar
    return out


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, a 0-d f32 tensor (no sync). A
    DTensor's norm is over the whole tensor, every shard's part reduced,
    not over this rank's shard."""
    from torch.distributed.tensor import DTensor

    norms = [torch.linalg.vector_norm(t).full_tensor() if isinstance(t, DTensor) else None
             for t in tensors]
    plain = [t for t, n in zip(tensors, norms) if n is None]
    it = iter(torch._foreach_norm(plain) if plain else [])
    return torch.linalg.vector_norm(torch.stack(
        [(n if n is not None else next(it)).float() for n in norms]))


def _scaled(grads: List[torch.Tensor], scale: torch.Tensor) -> List[torch.Tensor]:
    """Each gradient times the 0-d ``scale``; a DTensor's shard is scaled
    on its own rank (a DTensor does not mix with a plain tensor)."""
    from torch.distributed.tensor import DTensor

    plain = [g for g in grads if not isinstance(g, DTensor)]
    it = iter(torch._foreach_mul(plain, scale) if plain else [])
    return [DTensor.from_local(g.to_local() * scale, g.device_mesh, g.placements,
                               shape=g.shape, stride=g.stride())
            if isinstance(g, DTensor) else next(it) for g in grads]


class Optimizer:
    """optax's ``MultiSteps(chain(clip_by_global_norm, adamw))`` in torch.

    AdamW (``betas`` 0.9 and 0.999 unless given, eps 1e-8, decoupled weight
    decay) is the same update as ``optax.adamw``; with ``weight_decay`` 0 it
    is ``optax.adam``. Clipping scales the gradients by
    ``c / max(|g|, c)``, optax's formula (torch's ``clip_grad_norm_`` adds
    1e-6). With ``accumulate = k`` an update happens every k-th call, with
    the mean of the k gradients; the other calls leave the parameters as
    they are. ``lr_lambda`` multiplies ``lr`` by f(number of updates so far).

    Under torch.distributed each step first averages its gradients over
    the ranks (``parallel.collectives.all_reduce_grads``), so the norm, the
    clipping and the update are the global batch's on every rank.
    """

    def __init__(self, params: Dict[str, torch.nn.Parameter], lr: float,
                 weight_decay: float = 1e-2, grad_clip: Optional[float] = None,
                 accumulate: int = 1, lr_lambda: Optional[Callable[[int], float]] = None,
                 betas: Tuple[float, float] = (0.9, 0.999)):
        from torch.distributed.tensor import DTensor

        self.params = list(params.values())
        # a foreach update does not mix FSDP's DTensors with plain tensors:
        # with both, AdamW updates one tensor at a time (one parameter group,
        # so that the state_dict is the same at any world size)
        mixed = 0 < sum(isinstance(p, DTensor) for p in self.params) < len(self.params)
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=betas, eps=1e-8,
                                       weight_decay=weight_decay,
                                       foreach=False if mixed else None)
        self.scheduler = (torch.optim.lr_scheduler.LambdaLR(self.adamw, lr_lambda)
                          if lr_lambda is not None else None)
        self.grad_clip = grad_clip
        self.accumulate = accumulate
        self.mini_step = 0
        self._acc: Optional[List[torch.Tensor]] = None

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """Consume one micro-step's gradients (default: each parameter's
        ``.grad``, which is cleared) and return their global norm before
        clipping, as a 0-d tensor."""
        if grads is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
        all_reduce_grads(grads)
        norm = global_norm(grads)
        if self.accumulate > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in self.params]
            torch._foreach_add_(self._acc, grads)
            self.mini_step += 1
            self._clear()
            if self.mini_step < self.accumulate:
                return norm
            self.mini_step = 0
            grads = torch._foreach_div(self._acc, float(self.accumulate))
            torch._foreach_zero_(self._acc)
        if self.grad_clip:
            c = float(self.grad_clip)
            grads = _scaled(grads, c / torch.clamp(global_norm(grads), min=c))
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adamw.step()
        self._clear()
        if self.scheduler is not None:
            self.scheduler.step()
        return norm

    def _clear(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> Dict:
        return {"adamw": self.adamw.state_dict(), "mini_step": self.mini_step,
                "acc": self._acc,
                "scheduler": None if self.scheduler is None else self.scheduler.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.mini_step = int(state["mini_step"])
        self._acc = state["acc"]
        if self.scheduler is not None and state["scheduler"] is not None:
            self.scheduler.load_state_dict(state["scheduler"])


def make_optimizer(params: Dict[str, torch.nn.Parameter], lr: float,
                   weight_decay: float = 1e-2, grad_clip: Optional[float] = None,
                   accumulate: int = 1,
                   lr_lambda: Optional[Callable[[int], float]] = None) -> Optimizer:
    """AdamW as the reference's configure_optimizers, with optional clipping,
    accumulation and learning-rate multiplier (see ``Optimizer``)."""
    return Optimizer(params, lr, weight_decay, grad_clip, accumulate, lr_lambda)


@dataclasses.dataclass
class DiffusionTrainState:
    model: torch.nn.Module                  # LatentDiffusion; LayoutDiffusion in layout_trainer
    params: Dict[str, torch.nn.Parameter]   # the trained ones, by state_dict name
    optimizer: Optimizer
    ema: Ema                                # over ``params``
    step: int = 0

    def state_dict(self) -> Dict:
        """What a checkpoint holds besides the step (``train/checkpoint``)."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "ema": self.ema.state_dict()}

    def load_state_dict(self, ckpt: Dict) -> None:
        self.model.load_state_dict(ckpt["model"])
        self.optimizer.load_state_dict(ckpt["optimizer"])
        self.ema.load_state_dict(ckpt["ema"])


def create_train_state(model: LatentDiffusion, optimizer: Optimizer,
                       params: Optional[Dict[str, torch.nn.Parameter]] = None
                       ) -> DiffusionTrainState:
    """Freeze the first stage, and start the EMA at the current weights.
    ``params`` defaults to ``trainable_params(model)``; pass the dict the
    optimizer was built from."""
    if model.first_stage_model is not None:
        model.first_stage_model.requires_grad_(False).eval()
    params = params if params is not None else trainable_params(model)
    return DiffusionTrainState(model=model, params=params, optimizer=optimizer,
                               ema=Ema(params))


def _autocast(model: LatentDiffusion, dtype: Optional[torch.dtype]):
    if dtype is None:
        return contextlib.nullcontext()
    return torch.autocast(next(model.parameters()).device.type, dtype=dtype)


def make_train_step(model: LatentDiffusion, ema_decay: float = 0.9999,
                    autocast_dtype: Optional[torch.dtype] = None,
                    timed: bool = False) -> Callable:
    """step(state, batch, generator) -> (state, logs).

    t and the noise come from ``generator``; dropout (when the U-Net config
    has any, as the layout model's 0.1) from torch's default generator of the
    device. A conditioned model encodes the batch's raw ``cond`` inside the
    forward+backward phase, so a trainable encoder gets its gradient; it
    runs in float32 under autocast. ``logs`` holds
    0-d device tensors: loss, loss_simple, loss_vlb and grad_norm (before
    clipping). With ``timed`` the step synchronises the device at its phase
    boundaries and adds ``seconds_encode``, ``seconds_fwd_bwd`` and
    ``seconds_opt_ema``.
    """
    dev = next(model.parameters()).device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def step(state: DiffusionTrainState, batch: Dict[str, torch.Tensor],
             generator: torch.Generator):
        marks = []

        def mark():
            if timed:
                sync()
                marks.append(time.perf_counter())

        model.train()
        if model.first_stage_model is not None:
            model.first_stage_model.eval()
        mark()
        with _autocast(model, autocast_dtype):
            z = model.encode_first_stage(batch["image"])
        mark()
        with _autocast(model, autocast_dtype):
            cond = model.batch_conditioning(batch)
            loss, logs = model.p_losses(z, *model.draw_t_noise(z, generator), cond)
        loss.backward()
        mark()
        logs["grad_norm"] = state.optimizer.step()
        state.ema.update(state.params, ema_decay)
        state.step += 1
        mark()
        if timed:
            for name, (a, b) in zip(("encode", "fwd_bwd", "opt_ema"),
                                    zip(marks, marks[1:])):
                logs[f"seconds_{name}"] = b - a
        return state, logs

    return step


def ema_params(model: LatentDiffusion, state: DiffusionTrainState) -> Dict[str, torch.Tensor]:
    """The model's state_dict with the EMA weights in place of the trained ones."""
    sd = model.state_dict()
    for k, v in state.ema.params.items():
        if k in sd:
            sd[k] = v.to(sd[k].dtype)
    return sd


def make_val_step(model: LatentDiffusion,
                  autocast_dtype: Optional[torch.dtype] = None) -> Callable:
    """val_step(state, batch, generator) -> {loss_simple, loss,
    loss_simple_ema}: the training loss with the current and with the EMA
    weights, dropout off, the same t and noise for both."""

    def val_step(state: DiffusionTrainState, batch: Dict[str, torch.Tensor],
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
        model.eval()
        gen_state = generator.get_state()
        with torch.no_grad(), _autocast(model, autocast_dtype):
            _, logs = model.training_loss(batch, generator)
            generator.set_state(gen_state)
            with state.ema.swapped_in(state.params):
                _, logs_ema = model.training_loss(batch, generator)
        return {"loss_simple": logs["loss_simple"], "loss": logs["loss"],
                "loss_simple_ema": logs_ema["loss_simple"]}

    return val_step
