"""VQ-GAN objective for range-image autoencoders, NCHW.

Counterpart of ``lidar_layout_tpu/losses/vq_loss.py`` (the reference's
VQGeoLPIPSWithDiscriminator): pixel L1 (or L2), ray-drop mask L1, BEV
squared distance, depth smoothness and normal consistency (``parts``), the
channel stack the discriminator sees, the GAN gate and the adaptive weight
from last-layer gradient norms. The two-optimizer step that takes those
gradients is ``train/ae_trainer.py``.

The gate keeps the reference's behaviour: the GAN terms are on only while
``step <= disc_start``, the opposite of the usual VQ-GAN warm-up. The
perceptual term is ``perceptual_fn`` (``losses/perceptual``) times
``perceptual_factor``; every shipped YAML sets the factor to 0.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from .geometric import (GeoConverter, normal_consistency_loss, smoothness_loss,
                        square_dist_loss)


@dataclasses.dataclass(frozen=True)
class VQLossConfig:
    codebook_weight: float = 1.0
    pixel_loss: str = "l1"          # "l1" | "l2"
    mask_factor: float = 0.0
    geo_factor: float = 1.0
    perceptual_factor: float = 0.0
    smooth_factor: float = 0.1
    norm_factor: float = 0.1
    disc_start: int = 1
    disc_weight: float = 0.6
    disc_loss: str = "hinge"        # "hinge" | "vanilla"
    curve_length: int = 4

    @property
    def rec_scale(self) -> float:
        """Normaliser over the active reconstruction terms."""
        return 1.0 + sum(f > 0 for f in (self.mask_factor, self.geo_factor,
                                         self.perceptual_factor))


def _pixel_loss(cfg: VQLossConfig, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs() if cfg.pixel_loss == "l1" else (x - y) ** 2


def disc_factor_at(cfg: VQLossConfig, global_step: int) -> float:
    """The GAN terms' factor at ``global_step`` (see the module's doc)."""
    return 0.0 if global_step > cfg.disc_start else 1.0


def reconstruction_nll(cfg: VQLossConfig, geo: GeoConverter, inputs: torch.Tensor,
                       reconstructions: torch.Tensor, masks: Optional[torch.Tensor] = None,
                       perceptual_fn: Optional[Callable[[torch.Tensor, torch.Tensor],
                                                        torch.Tensor]] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The generator loss's reconstruction side: (nll, parts).

    inputs (B, 1, H, W) model-space range; reconstructions (B, C, H, W), C = 2
    with the mask head; masks (B, 1, H, W) ray-drop targets (+1 return, -1
    drop). The caller adds the GAN and codebook terms."""
    rec_range = reconstructions[:, 0:1]
    input_coord, rec_coord = geo(inputs), geo(rec_range)
    gt_depth, pred_depth = geo.depth_from_model(inputs), geo.depth_from_model(rec_range)
    zero = inputs.new_zeros(())
    if cfg.mask_factor > 0 and masks is not None:
        pixel_rec = _pixel_loss(cfg, inputs, rec_range)
        mask_rec = _pixel_loss(cfg, masks, reconstructions[:, 1:2]) * cfg.mask_factor
    else:
        pixel_rec = _pixel_loss(cfg, inputs, reconstructions)
        mask_rec = torch.zeros_like(pixel_rec)
    geo_rec = (square_dist_loss(input_coord[:, :2], rec_coord[:, :2]) * cfg.geo_factor
               if cfg.geo_factor > 0 else zero)
    perceptual = zero
    if cfg.perceptual_factor > 0 and perceptual_fn is not None:
        perceptual = perceptual_fn(inputs, rec_range) * cfg.perceptual_factor
    smooth = (smoothness_loss(pred_depth, gt_depth) * cfg.smooth_factor
              if cfg.smooth_factor > 0 else zero)
    normal = (normal_consistency_loss(geo, input_coord, rec_coord) * cfg.norm_factor
              if cfg.norm_factor > 0 else zero)
    rec_loss = (pixel_rec.mean() + mask_rec.mean() + geo_rec.mean()
                + perceptual.mean()) / cfg.rec_scale
    parts = {"rec_loss": rec_loss, "pix_rec_loss": pixel_rec.mean(),
             "mask_rec_loss": mask_rec.mean(), "geo_rec_loss": geo_rec.mean(),
             "perceptual_loss": perceptual.mean(), "smooth_loss": smooth,
             "normal_loss": normal}
    return rec_loss + smooth + normal, parts


def assemble_disc_input(cfg: VQLossConfig, geo: GeoConverter, imgs: torch.Tensor,
                        masks: Optional[torch.Tensor], is_recon: bool) -> torch.Tensor:
    """The discriminator's input: the image (a reconstruction with all its
    channels; a real image with its mask when the mask term is on), then the
    uncompressed xy coordinates of its range channel when ``geo_factor`` > 0."""
    feats = [imgs]
    rng_ch = imgs[:, 0:1] if is_recon else imgs
    if not is_recon and cfg.mask_factor > 0 and masks is not None:
        feats.append(masks)
    if cfg.geo_factor > 0:
        feats.append(geo.range2xyz(rng_ch * 0.5 + 0.5)[:, :2])
    return torch.cat(feats, dim=1) if len(feats) > 1 else feats[0]


def adaptive_weight_from_grads(nll_grad_norm: torch.Tensor, g_grad_norm: torch.Tensor,
                               disc_weight: float) -> torch.Tensor:
    """|grad nll| / (|grad g| + 1e-4), clipped to [0, 1e4], times disc_weight."""
    return torch.clamp(nll_grad_norm / (g_grad_norm + 1e-4), 0.0, 1e4) * disc_weight
