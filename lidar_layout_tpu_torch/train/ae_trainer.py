"""VQ-GAN autoencoder training: two Adams and the adaptive GAN weight.

Counterpart of ``lidar_layout_tpu/train/ae_trainer.py`` (``AETrainState``,
``make_ae_optimizers``, ``create_ae_state``, ``make_ae_train_step``,
``make_ae_val_step``). One step runs the generator pass (reconstruction NLL,
the discriminator's view of the reconstruction, the codebook loss), then
the discriminator on the same, pre-update reconstruction, then both Adam
updates: Lightning's optimizer_idx 0 and 1 of one batch. The JAX step is one
jitted program; here it runs eagerly, K3 (``ops/groupnorm``) carrying the
GroupNorms of the autoencoder and the discriminator forward and backward.

The adaptive weight needs the norms of d(nll)/dw and d(g_loss)/dw for the
decoder's last conv weight w alone. JAX takes them by re-running that conv
on the stopped pre-final activation; here they are ``torch.autograd.grad``
of each loss with respect to ``decoder.conv_out.weight`` over the step's
own graph (kept with ``retain_graph``), which is the same gradient. Every
gradient is taken with ``torch.autograd.grad`` for the parameters it
updates, so the generator pass leaves the discriminator's untouched, as
JAX's ``value_and_grad`` of ``params_g`` does.

With ``s2_render`` (the Gaussian range autoencoder, ``VQModelGaus``) the
generator also decodes per-pixel Gaussians, renders the panorama again
(``models/autoencoder_gaus.render_range_from_gaussians``) and adds the s2
loss to the NLL; the adaptive weight still reads the reconstruction NLL
alone, as JAX's does.

``perceptual_fn`` (``losses/perceptual``) adds the RangeNet perceptual term
to the NLL, as JAX's ``perceptual_fn`` does. With ``autocast_dtype``
(``train_lidm --bf16``) the autoencoder's forward runs under autocast in
that dtype, which is JAX's policy for a model built in bf16: convolutions
and matmuls in bf16 on float32 weights, GroupNorm statistics and affine in
float32 (K3 in bf16), the codebook search in float32; the losses, the
perceptual net and the discriminator (JAX builds it without a dtype) run
in float32 on the bf16 reconstruction. The adaptive weight's gradients are
taken over the step's own graph in both dtypes: under autocast the last
conv runs in bf16 and its weight's gradient comes back in float32, where
JAX runs that conv again in float32 (its rounding moves ``d_weight`` by
tens of percent at random weights; ``tests/test_torch_ae_bf16.py``).

The scan-chunked step (``make_chunked_ae_train_step``) is not ported: its
successor is a CUDA graph over the step (ROADMAP).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..losses.discriminator import hinge_d_loss, vanilla_d_loss
from ..losses.geometric import GeoConverter
from ..losses.vq_loss import (VQLossConfig, adaptive_weight_from_grads,
                              assemble_disc_input, disc_factor_at, reconstruction_nll)
from ..models.autoencoder import VQModel
from ..ops.lidar import LidarGeometry, depth_to_model
from ..parallel.collectives import all_reduce_grads
from .diffusion_trainer import Optimizer, _autocast

DISC_PREFIX = "loss.discriminator."   # where a Lightning AE checkpoint keeps it


@dataclasses.dataclass
class AETrainState:
    model: VQModel
    disc: torch.nn.Module
    opt_g: Optimizer
    opt_d: Optimizer
    step: int = 0

    def state_dict(self) -> Dict:
        """What a checkpoint holds besides the step: the model's and the
        discriminator's weights in one Lightning-style ``state_dict``, and
        both optimizers."""
        sd = dict(self.model.state_dict())
        sd.update({DISC_PREFIX + k: v for k, v in self.disc.state_dict().items()})
        return {"state_dict": sd, "optimizer_g": self.opt_g.state_dict(),
                "optimizer_d": self.opt_d.state_dict()}

    def load_state_dict(self, ckpt: Dict) -> None:
        sd = ckpt["state_dict"]
        self.model.load_state_dict({k: v for k, v in sd.items() if not k.startswith("loss.")})
        self.disc.load_state_dict({k[len(DISC_PREFIX):]: v for k, v in sd.items()
                                   if k.startswith(DISC_PREFIX)})
        self.opt_g.load_state_dict(ckpt["optimizer_g"])
        self.opt_d.load_state_dict(ckpt["optimizer_d"])


def make_ae_optimizers(model: VQModel, disc: torch.nn.Module, lr_g: float, lr_d: float,
                       accumulate: int = 1,
                       lr_lambda: Optional[Callable[[int], float]] = None
                       ) -> Tuple[Optimizer, Optimizer]:
    """Adam(0.5, 0.9) for each model, as optax's ``adam``; ``accumulate`` > 1
    averages that many steps' gradients into one update (optax's
    ``MultiSteps``); ``lr_lambda`` scales both learning rates by the update
    count."""
    return tuple(Optimizer(dict(m.named_parameters()), lr, weight_decay=0.0,
                           accumulate=accumulate, lr_lambda=lr_lambda, betas=(0.5, 0.9))
                 for m, lr in ((model, lr_g), (disc, lr_d)))


def create_ae_state(model: VQModel, disc: torch.nn.Module, lr_g: float, lr_d: float,
                    accumulate: int = 1,
                    lr_lambda: Optional[Callable[[int], float]] = None) -> AETrainState:
    """The train state at step 0 over the modules' current weights."""
    return AETrainState(model, disc, *make_ae_optimizers(model, disc, lr_g, lr_d, accumulate,
                                                         lr_lambda))


def disc_in_channels(out_ch: int, loss_cfg: VQLossConfig, geo: GeoConverter) -> int:
    """Channels the discriminator sees: those of ``assemble_disc_input`` of
    a reconstruction of ``out_ch`` channels (JAX's ``create_ae_state`` inits
    the discriminator on one)."""
    dec = torch.zeros((1, out_ch, *geo.geom.size))
    return assemble_disc_input(loss_cfg, geo, dec, None, is_recon=True).shape[1]


def _nchw(batch: Dict[str, torch.Tensor], loss_cfg: VQLossConfig):
    """The batch's image (and, with the mask term, its mask) as NCHW f32."""
    x = batch["image"].permute(0, 3, 1, 2).float()
    mask = batch.get("mask") if loss_cfg.mask_factor > 0 else None
    return x, None if mask is None else mask.permute(0, 3, 1, 2).to(x.dtype)


@contextlib.contextmanager
def _dropout_draws(generator: torch.Generator, on: bool):
    """Dropout's draws from ``generator``: the device's default generator,
    seeded from it for the block and restored after."""
    if not on:
        yield
        return
    dev = generator.device
    seed = int(torch.randint(2 ** 62, (1,), generator=generator, device=dev))
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        (torch.cuda.manual_seed if dev.type == "cuda" else torch.manual_seed)(seed)
        yield


def make_ae_train_step(model: VQModel, disc: torch.nn.Module, loss_cfg: VQLossConfig,
                       geo: GeoConverter, timed: bool = False, s2_render: bool = False,
                       s2_geom: Optional[LidarGeometry] = None,
                       perceptual_fn: Optional[Callable] = None,
                       autocast_dtype: Optional[torch.dtype] = None) -> Callable:
    """step(state, batch, generator) -> (state, logs).

    ``batch["image"]`` is (B, H, W, 1), as the data factory gives it.
    ``generator`` feeds dropout when the config has any. ``logs`` holds 0-d
    device tensors: the NLL's parts, ``total_loss``, ``quant_loss``,
    ``g_loss``, ``d_weight``, ``nll_loss``, ``disc_loss``, ``logits_real``
    and ``logits_fake``. With ``timed`` the step synchronises the device at
    its phase boundaries and adds ``seconds_gen`` (the generator's forward
    and backward with the adaptive weight), ``seconds_disc`` and
    ``seconds_opt`` (both Adam updates). ``s2_render`` adds the s2 loss of
    the Gaussian tower rendered in ``s2_geom`` (its parts ``s2_l1``,
    ``s2_smooth``, ``s2_normal`` and ``s2_loss`` are logged)."""
    if s2_render:
        from ..models.autoencoder_gaus import render_range_from_gaussians, s2_loss
        assert s2_geom is not None, "s2_render needs the LidarGeometry"
    d_loss_fn = hinge_d_loss if loss_cfg.disc_loss == "hinge" else vanilla_d_loss
    params_g, params_d = list(model.parameters()), list(disc.parameters())
    w_last = model.decoder.conv_out.weight
    dev = w_last.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def step(state: AETrainState, batch: Dict[str, torch.Tensor],
             generator: torch.Generator):
        marks = []

        def mark():
            if timed:
                sync()
                marks.append(time.perf_counter())

        model.train()
        disc.train()
        x, masks = _nchw(batch, loss_cfg)
        disc_factor = disc_factor_at(loss_cfg, state.step)
        mark()
        with _dropout_draws(generator, model.cfg.dropout > 0), _autocast(model, autocast_dtype):
            if s2_render:
                dec, qloss, _, _, gaus = model.forward_with_prefinal_gaus(x)
            else:
                dec, qloss, _ = model(x)
        dec, qloss = dec.float(), qloss.float()
        nll, parts = reconstruction_nll(loss_cfg, geo, x, dec, masks, perceptual_fn)
        g_loss = -torch.mean(disc(assemble_disc_input(loss_cfg, geo, dec, masks, True)))
        (nll_g,) = torch.autograd.grad(nll, w_last, retain_graph=True)
        (gan_g,) = torch.autograd.grad(g_loss, w_last, retain_graph=True)
        all_reduce_grads([nll_g, gan_g])   # the weight reads the global batch's gradients
        d_weight = adaptive_weight_from_grads(torch.linalg.vector_norm(nll_g),
                                              torch.linalg.vector_norm(gan_g),
                                              loss_cfg.disc_weight).detach()
        if s2_render:
            rend = render_range_from_gaussians(dec[:, 0], gaus, s2_geom)
            s2, s2_parts = s2_loss(geo, x, depth_to_model(rend["rendered_range"], s2_geom)[:, None])
            nll = nll + s2
            parts.update(s2_parts)
        loss = nll + d_weight * disc_factor * g_loss + loss_cfg.codebook_weight * qloss
        # the s2 loss reads the rendered range alone: the SH head gets zeros
        grads_g = [torch.zeros_like(p) if g is None else g for p, g in zip(
            params_g, torch.autograd.grad(loss, params_g, allow_unused=s2_render))]
        mark()
        # the discriminator, on the reconstruction before the generator's update
        logits_real = disc(assemble_disc_input(loss_cfg, geo, x, masks, False))
        logits_fake = disc(assemble_disc_input(loss_cfg, geo, dec.detach(), masks, True))
        d_loss = d_loss_fn(logits_real, logits_fake) * disc_factor
        grads_d = list(torch.autograd.grad(d_loss, params_d))
        mark()
        state.opt_g.step(grads_g)
        state.opt_d.step(grads_d)
        state.step += 1
        mark()
        logs = {**{k: v.detach() for k, v in parts.items()}, "total_loss": loss.detach(),
                "quant_loss": qloss.detach(), "g_loss": g_loss.detach(), "d_weight": d_weight,
                "nll_loss": nll.detach(), "disc_loss": d_loss.detach(),
                "logits_real": logits_real.detach().mean(),
                "logits_fake": logits_fake.detach().mean()}
        if timed:
            for name, (a, b) in zip(("gen", "disc", "opt"), zip(marks, marks[1:])):
                logs[f"seconds_{name}"] = b - a
        return state, logs

    return step


def make_ae_val_step(model: VQModel, loss_cfg: VQLossConfig, geo: GeoConverter,
                     perceptual_fn: Optional[Callable] = None,
                     autocast_dtype: Optional[torch.dtype] = None) -> Callable:
    """val_step(state, batch, generator) -> {rec_loss, nll_loss, quant_loss}:
    the reconstruction NLL and codebook loss, dropout off, no GAN terms."""

    def val_step(state: AETrainState, batch: Dict[str, torch.Tensor],
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
        model.eval()
        x, masks = _nchw(batch, loss_cfg)
        with torch.no_grad():
            with _autocast(model, autocast_dtype):
                dec, qloss = model(x)[:2]   # VQModelGaus also returns its Gaussians
            nll, parts = reconstruction_nll(loss_cfg, geo, x, dec.float(), masks,
                                            perceptual_fn)
        return {"rec_loss": parts["rec_loss"], "nll_loss": nll, "quant_loss": qloss.float()}

    return val_step
