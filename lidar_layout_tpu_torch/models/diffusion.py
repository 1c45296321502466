"""Latent diffusion over range-image latents.

Counterpart of ``lidar_layout_tpu/models/diffusion.py``: ``DiffusionConfig``
and ``LatentDiffusion`` with ``apply_model``, ``encode_first_stage``,
``decode_first_stage``, ``eps_from_model_out``, ``predict_eps_from_x``, the
training loss (``p_losses``, ``training_loss``) and the ``scale_by_std``
calibration. With ``split_ks`` set (on ``DiffusionConfig``, as the JAX
package takes it; no YAML sets it) a latent wider or taller than
``split_ks`` runs patched (``ops/foldunfold``, the reference's
``split_input_params``): the U-Net once per crop of ``split_ks`` at
``split_stride``, in patch order, a concat conditioning cropped with the
latent and the context and labels shared; encode and decode on crops
scaled by the first stage's factor, stitched back circularly along the
azimuth.
Latents at this API are NHWC (B, 16, 128, 8) and images (B, H, W, 1), as in
the JAX package; the modules inside are NCHW. Inside a ``with plan:`` block
of the spatial (``sp``) axis (``parallel/mesh.spatial_sharding``)
``encode_first_stage`` and ``apply_model`` take and return this rank's W
shard, as JAX's take a W-sharded array (``parallel/dryrun``), forward only.

With ``conditioning_key: layout_crossattn`` the U-Net is the object-aware
cross-attention one (``models/object_cross_unet.py``, passed as ``unet``) and
the conditioning stage the layout encoder: ``get_learned_conditioning``
encodes layouts and ``apply_model`` hands the encoder's dict to the U-Net.
Training encodes the batch's raw layout inside the graph
(``batch_conditioning``), so the gradient reaches a trainable encoder.

The openaimodel keys follow JAX's ``_split_cond`` / ``_cond_views`` rule
(the reference DiffusionWrapper): a dict gives ``c_crossattn`` (context),
``c_concat`` (channels concatenated to the latent) and ``c_adm`` (class
labels); a bare tensor is the concat for ``concat``, the context for the
``*crossattn`` keys and the label for ``adm``.

The state_dict uses the reference LatentDiffusion checkpoint prefixes,
``model.diffusion_model.`` for the U-Net, ``first_stage_model.`` for the
autoencoder and ``cond_stage_model.`` for the conditioning stage. ``logvar``
is a non-persistent buffer, or a parameter when ``learn_logvar`` is set, as
in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..nn.blocks import Normalize
from ..nn.quantize import VectorQuantizer
from ..ops.foldunfold import fold_patches, patched_apply_scaled, unfold_patches
from ..parallel.collectives import all_gather, rank_rows, spatial_plan
from .autoencoder import AEConfig, VQModelInterface
from .schedules import DiffusionSchedule, extract, q_sample
from .unet import UNetConfig, UNetModel

CONDITIONING_KEYS = (None, "concat", "crossattn", "hybrid", "adm", "layout_crossattn",
                     "graph_crossattn")


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """model.params block of the reference LiDM configs."""

    timesteps: int = 1024
    beta_schedule: str = "linear"
    linear_start: float = 0.0015
    linear_end: float = 0.0195
    cosine_s: float = 8e-3
    parameterization: str = "eps"       # "eps" | "x0"
    loss_type: str = "l2"
    l_simple_weight: float = 1.0
    original_elbo_weight: float = 0.0
    v_posterior: float = 0.0
    learn_logvar: bool = False
    logvar_init: float = 0.0
    conditioning_key: Optional[str] = None
    scale_factor: float = 1.0
    scale_by_std: bool = False
    cond_stage_trainable: bool = False
    latent_shape: Tuple[int, int, int] = (16, 128, 8)  # (H, W, C) of z
    split_ks: Optional[Tuple[int, int]] = None
    split_stride: Optional[Tuple[int, int]] = None


class DiffusionWrapper(nn.Module):
    """Holds the U-Net under the reference's ``model.diffusion_model`` name."""

    def __init__(self, unet: nn.Module):
        super().__init__()
        self.diffusion_model = unet


class LatentDiffusion(nn.Module):
    """U-Net + frozen VQ first stage + optional conditioning stage. ``dtype``
    is the activation and weight dtype of the convs and linears; norms, the
    codebook, softmax and the modules' ``f32_parameters`` stay f32.

    ``unet`` overrides the openaimodel U-Net built from ``unet_cfg`` (the
    layout model's object-aware U-Net takes the encoder's dict)."""

    def __init__(self, cfg: DiffusionConfig, unet_cfg: Optional[UNetConfig],
                 first_stage_cfg: Optional[AEConfig] = None, n_embed: int = 16384,
                 embed_dim: int = 8, use_mask: bool = True,
                 cond_stage: Optional[nn.Module] = None, unet: Optional[nn.Module] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.conditioning_key not in CONDITIONING_KEYS:
            raise NotImplementedError(
                f"conditioning_key {cfg.conditioning_key!r} is not ported yet "
                f'(ROADMAP queue 1, "Conditioning")')
        self.cfg = cfg
        self.schedule = DiffusionSchedule.create(
            timesteps=cfg.timesteps, beta_schedule=cfg.beta_schedule,
            linear_start=cfg.linear_start, linear_end=cfg.linear_end,
            cosine_s=cfg.cosine_s, v_posterior=cfg.v_posterior,
            parameterization=cfg.parameterization)
        self.model = DiffusionWrapper(unet if unet is not None else UNetModel(unet_cfg))
        self.first_stage_model = (VQModelInterface(first_stage_cfg, n_embed=n_embed,
                                                   embed_dim=embed_dim, use_mask=use_mask)
                                  if first_stage_cfg is not None else None)
        self.cond_stage_model = cond_stage
        logvar = torch.full((cfg.timesteps,), float(cfg.logvar_init))
        if cfg.learn_logvar:
            self.logvar = nn.Parameter(logvar)
        else:
            self.register_buffer("logvar", logvar, persistent=False)
        self.cast_(dtype)

    @property
    def unet(self) -> nn.Module:
        return self.model.diffusion_model

    def cast_(self, dtype: torch.dtype) -> "LatentDiffusion":
        """Put conv/linear weights in ``dtype``; GroupNorm affines, the VQ
        codebook and a learned logvar stay float32. (The trainer keeps f32
        weights and runs bf16 under autocast instead: AdamW updates of a
        small learning rate vanish in bf16 weights.)"""
        keep = {id(p) for m in self.modules() if isinstance(m, (Normalize, VectorQuantizer))
                for p in m.parameters()}
        keep.update(id(p) for m in self.modules() if hasattr(m, "f32_parameters")
                    for p in m.f32_parameters())
        if isinstance(self.logvar, nn.Parameter):
            keep.add(id(self.logvar))
        for p in self.parameters():
            p.data = p.data.float() if id(p) in keep else p.data.to(dtype)
        self.dtype = dtype
        return self

    # -------------------------------------------------------- first stage io
    def _first_stage_factor(self) -> Tuple[int, int]:
        """The first stage's total (H, W) downsampling (the reference's vqf)."""
        fh = fw = 1
        for sh, sw in self.first_stage_model.cfg.strides:
            fh, fw = fh * sh, fw * sw
        return fh, fw

    def _split_active(self, h: int, w: int) -> bool:
        """The patched path runs iff ``split_ks`` is set and a latent of (h, w)
        is larger than it. It does not combine with the sp axis (a W shard's
        crops would wrap inside the shard): a model with ``split_ks`` raises
        there."""
        ks = self.cfg.split_ks
        if ks is not None and spatial_plan() is not None:
            raise ValueError("the patched split_ks path does not combine with the sp axis")
        return ks is not None and (h > ks[0] or w > ks[1])

    def encode_first_stage(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 1) image -> scaled NHWC latent. The first stage is
        frozen: no gradient flows through it (JAX's stop_gradient)."""
        if self.first_stage_model is None:
            return x
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        fh, fw = self._first_stage_factor()
        with torch.no_grad():
            if self._split_active(x.shape[2] // fh, x.shape[3] // fw):
                (kh, kw), (sh, sw) = self.cfg.split_ks, self._split_stride()
                z = patched_apply_scaled(self.first_stage_model.encode_latent, x,
                                         (kh * fh, kw * fw), (sh * fh, sw * fw),
                                         scale=(1.0 / fh, 1.0 / fw))
            else:
                z = self.first_stage_model.encode_latent(x)
        return (self.cfg.scale_factor * z.float()).permute(0, 2, 3, 1)

    def decode_first_stage(self, z: torch.Tensor,
                           force_not_quantize: bool = False) -> torch.Tensor:
        """NHWC latent -> (B, H, W, C) float32 image (ray-drop applied)."""
        if self.first_stage_model is None:
            return z
        z = (z / self.cfg.scale_factor).permute(0, 3, 1, 2).to(self.dtype)

        def dec(zi):
            return self.first_stage_model.decode_latent(zi, force_not_quantize)

        if self._split_active(*z.shape[2:]):
            fh, fw = self._first_stage_factor()
            img = patched_apply_scaled(dec, z, self.cfg.split_ks, self._split_stride(),
                                       scale=(float(fh), float(fw)))
        else:
            img = dec(z)
        return img.float().permute(0, 2, 3, 1)

    def _split_stride(self) -> Tuple[int, int]:
        return self.cfg.split_stride or self.cfg.split_ks

    # ---------------------------------------------------------- conditioning
    def get_learned_conditioning(self, cond: Any) -> Any:
        """Encode raw conditioning (a (B, L, 13) layout, a one-hot map, text
        tokens, images, labels; tensor or numpy) with the conditioning stage,
        on the model's device, in float32. Without a gradient unless
        ``cond_stage_trainable``, so that in training the gradient reaches
        the encoder when it is trainable. Without a stage: ``cond``."""
        if self.cond_stage_model is None:
            return cond
        dev = next(self.parameters()).device
        # float32 under autocast too: the JAX package builds the encoder
        # without a dtype
        with torch.autocast(dev.type, enabled=False), \
                torch.set_grad_enabled(torch.is_grad_enabled()
                                       and self.cfg.cond_stage_trainable):
            return self.cond_stage_model(torch.as_tensor(cond, device=dev))

    # ------------------------------------------------------------- the model
    @staticmethod
    def _split_cond(cond: Any) -> Tuple[Any, Any, Any]:
        """Conditioning as (context, concat, label)."""
        if cond is None:
            return None, None, None
        if isinstance(cond, dict):
            return cond.get("c_crossattn"), cond.get("c_concat"), cond.get("c_adm")
        return cond, None, None

    def _cond_views(self, cond: Any) -> Tuple[Any, Any, Any]:
        """(context, concat, label) by ``conditioning_key``: a bare tensor is
        the concat for 'concat', the context for '*crossattn' and the label
        for 'adm' (JAX's rule, the reference DiffusionWrapper's)."""
        key = self.cfg.conditioning_key
        context = concat = y = None
        if key == "concat":
            concat = self._split_cond(cond)[1]
            concat = cond if concat is None else concat
        elif key in ("crossattn", "layout_crossattn", "graph_crossattn"):
            context = self._split_cond(cond)[0]
        elif key == "hybrid":
            context, concat, _ = self._split_cond(cond)
        elif key == "adm":
            y = self._split_cond(cond)[2]
            y = cond if y is None else y
        return context, concat, y

    def apply_model(self, x_noisy: torch.Tensor, t: torch.Tensor,
                    cond: Any = None) -> torch.Tensor:
        """One U-Net eval: NHWC float32 latent in, NHWC float32 out. The
        layout model takes the encoder's dict as ``cond``; the other keys
        take ``cond`` by ``_cond_views``, a concat as NHWC channels."""
        key = self.cfg.conditioning_key
        x = x_noisy.permute(0, 3, 1, 2)
        if key == "layout_crossattn":
            if not (isinstance(cond, dict) and "xf_proj" in cond):
                raise ValueError("the layout model needs the encoded layout "
                                 "(get_learned_conditioning) as cond")
            out = self.unet(x, t, cond)
        else:
            if key is None and cond is not None:
                raise ValueError("an unconditional model takes no cond")
            context, concat, y = self._cond_views(cond)
            if concat is not None:
                concat = concat.permute(0, 3, 1, 2).to(x.dtype)

            def core(xi, ci):
                if ci is not None:
                    xi = torch.cat([xi, ci], dim=1)
                if key is None:
                    return self.unet(xi, t)
                return self.unet(xi, t, context=context, y=y)

            if self._split_active(*x.shape[2:]):
                # one U-Net eval a crop, in patch order: the concat is cropped
                # with the latent, the context and labels are shared
                ks, stride = self.cfg.split_ks, self._split_stride()
                tiles, coords = unfold_patches(x, ks, stride)
                ctiles = None if concat is None else unfold_patches(concat, ks, stride)[0]
                outs = torch.stack([core(tiles[:, i], None if ctiles is None else ctiles[:, i])
                                    for i in range(tiles.shape[1])], dim=1)
                out = fold_patches(outs, coords, (x.shape[0], outs.shape[2], *x.shape[2:]))
            else:
                out = core(x, concat)
        return out.permute(0, 2, 3, 1)

    # ----------------------------------------------------------------- loss
    def p_losses(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
                 cond: Any = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The reference's LatentDiffusion.p_losses at the given ``t`` and
        ``noise``: (loss, detached logs)."""
        x_noisy = q_sample(self.schedule, x_start, t, noise)
        model_out = self.apply_model(x_noisy, t, cond)
        target = noise if self.cfg.parameterization == "eps" else x_start
        if self.cfg.loss_type == "l2":
            per = (model_out - target) ** 2
        else:
            per = (model_out - target).abs()
        loss_simple = per.mean(dim=tuple(range(1, per.ndim)))      # (B,)
        logvar_t = self.logvar[t]
        loss = loss_simple / torch.exp(logvar_t) + logvar_t
        loss = self.cfg.l_simple_weight * loss.mean()
        lvlb = torch.as_tensor(np.asarray(self.schedule.lvlb_weights, np.float32),
                               device=t.device)[t]
        loss_vlb = (lvlb * loss_simple).mean()
        loss = loss + self.cfg.original_elbo_weight * loss_vlb
        logs = {"loss_simple": loss_simple.mean(), "loss_vlb": loss_vlb, "loss": loss}
        return loss, {k: v.detach() for k, v in logs.items()}

    def training_loss(self, batch: Dict[str, torch.Tensor], generator: torch.Generator
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One shared step: encode (frozen), draw t and the noise from
        ``generator`` (on its device, then moved to the batch's), encode the
        batch's raw conditioning, p_losses. Under an initialised process
        group the draws are this rank's rows of the global batch's
        (``draw_t_noise``): the same call in one process draws others."""
        z = self.encode_first_stage(batch["image"])
        return self.p_losses(z, *self.draw_t_noise(z, generator), self.batch_conditioning(batch))

    def batch_conditioning(self, batch: Dict[str, Any]) -> Any:
        """A training batch's conditioning: its raw ``cond`` through
        ``get_learned_conditioning``, inside the graph; None for an
        unconditional model."""
        if self.cfg.conditioning_key is None:
            return None
        return self.get_learned_conditioning(batch["cond"])

    def draw_t_noise(self, z: torch.Tensor, generator: torch.Generator
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Uniform timesteps, then Gaussian noise shaped like ``z``, both drawn
        on the generator's device and moved to z's. Under dp each rank draws
        the global batch's t and noise and keeps its rows
        (``parallel.collectives.rank_rows``), so a sharded step sees what one
        process stepping the whole batch would."""
        b, gd = z.shape[0], generator.device
        t = rank_rows(lambda n: torch.randint(0, self.cfg.timesteps, (n,), generator=generator,
                                              device=gd), b)
        noise = rank_rows(lambda n: torch.randn((n, *z.shape[1:]), generator=generator,
                                                device=gd, dtype=z.dtype), b)
        return t.to(z.device), noise.to(z.device)

    # ------------------------------------------------------------- sampling
    def predict_eps_from_x(self, x_t: torch.Tensor, t: torch.Tensor,
                           pred_x0: torch.Tensor) -> torch.Tensor:
        s = self.schedule
        return ((extract(s.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t - pred_x0)
                / extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.ndim))

    def eps_from_model_out(self, x_t: torch.Tensor, t: torch.Tensor,
                           out: torch.Tensor) -> torch.Tensor:
        """Model output -> epsilon, whatever the parameterization."""
        if self.cfg.parameterization == "eps":
            return out
        return self.predict_eps_from_x(x_t, t, out)


def calibrate_scale_factor(z: torch.Tensor) -> float:
    """scale_by_std calibration: 1 / std(z) (population std) over a batch.
    Under dp ``z`` is this rank's part of the global batch: the parts are
    gathered first, so every rank computes the global batch's factor from
    the same numbers (a rank's own std would train a model of its own)."""
    z = all_gather(z.detach()).flatten(0, 1)
    return float(1.0 / z.float().std(correction=0))


def apply_scale_by_std(model: LatentDiffusion, first_batch_image: torch.Tensor) -> float:
    """When ``scale_by_std`` is set and the scale factor is still 1.0,
    replace it with 1/std(encode(first batch)); returns the factor in use."""
    if not model.cfg.scale_by_std or model.cfg.scale_factor != 1.0:
        return model.cfg.scale_factor
    s = calibrate_scale_factor(model.encode_first_stage(first_batch_image))
    model.cfg = dataclasses.replace(model.cfg, scale_factor=s)
    return s
