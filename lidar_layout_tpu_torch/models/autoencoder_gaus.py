"""VQ autoencoder with a Gaussian-splat decoder tower (VQModel_Gaus), NCHW.

Counterpart of ``lidar_layout_tpu/models/autoencoder_gaus.py``
(``GausParamHead``, ``GausDecoder``, ``VQModelGaus`` with
``decode_gaussians`` and ``forward_with_prefinal_gaus``,
``render_range_from_gaussians``, ``s2_loss``). A second full decoder tower
(``gaus_decoder.tower``, ending before its norm) emits per-pixel Gaussian
parameters: a rotation quaternion, three scales, an opacity and SH
coefficients of degree 3 for four channels [aux0, aux1, intensity,
raydrop]. One Gaussian sits at each pixel's unprojected range decode and
the panorama is rendered again in one spherical pass of
``ops/gaussian_raster.rasterize`` (the reference's two 180-degree pinhole
cameras are not needed). The module names are the JAX package's, so
``utils/convert.vq_state_dict`` carries a JAX ``VQModelGaus`` tree in.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn as nn

from ..losses.geometric import GeoConverter, normal_consistency_loss, smoothness_loss
from ..nn.blocks import Normalize
from ..nn.conv import CircularConv
from ..ops.gaussian_raster import RasterConfig, rasterize
from ..ops.lidar import LidarGeometry, range2xyz
from ..ops.sh import eval_sh
from .autoencoder import AEConfig, Decoder, VQModel

SH_DEGREE = 3
SH_CHANNELS = 4  # [aux0, aux1, intensity, raydrop]


class GausParamHead(nn.Module):
    """conv(1, 4) -> ReLU -> conv(1, 4), circular along the scan line."""

    def __init__(self, channels: int, out_ch: int):
        super().__init__()
        self.conv1 = CircularConv(channels, channels, (1, 4), (1, 1), (1, 2, 0, 0))
        self.conv2 = CircularConv(channels, out_ch, (1, 4), (1, 1), (1, 2, 0, 0))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.relu(self.conv1(h)))


class GausDecoder(nn.Module):
    """The second decoder tower: quantized latent -> per-pixel Gaussian
    parameters, channels last: rot (B, H, W, 4), scale (B, H, W, 3), opacity
    (B, H, W), sh (B, H, W, 4, 16)."""

    def __init__(self, cfg: AEConfig):
        super().__init__()
        ch = cfg.ch * cfg.ch_mult[0]
        self.tower = Decoder(dataclasses.replace(cfg, give_pre_end=True))
        self.norm_out = Normalize(ch, act=True)
        self.rot_out = GausParamHead(ch, 4)
        self.scale_out = GausParamHead(ch, 3)
        self.opacity_out = GausParamHead(ch, 1)
        self.sh_out = GausParamHead(ch, SH_CHANNELS * (SH_DEGREE + 1) ** 2)

    def forward(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = self.norm_out(self.tower(z))

        def last(t):
            return t.permute(0, 2, 3, 1)
        rot = last(self.rot_out(h)) + torch.tensor([1.0, 0.0, 0.0, 0.0], device=h.device)
        scale = torch.exp(last(self.scale_out(h)).clamp(-6.0, 2.0))
        opacity = torch.sigmoid(self.opacity_out(h))[:, 0]
        sh = last(self.sh_out(h))
        b, hh, ww, _ = sh.shape
        return {"rot": rot, "scale": scale, "opacity": opacity,
                "sh": sh.reshape(b, hh, ww, SH_CHANNELS, (SH_DEGREE + 1) ** 2)}


class VQModelGaus(VQModel):
    """VQModel with the Gaussian tower: ``forward`` returns (reconstruction,
    codebook loss, indices, Gaussian parameters)."""

    def __init__(self, cfg: AEConfig, n_embed: int = 16384, embed_dim: int = 8,
                 use_mask: bool = False):
        super().__init__(cfg, n_embed, embed_dim, use_mask)
        self.gaus_decoder = GausDecoder(cfg)

    def decode_gaussians(self, quant: torch.Tensor):
        hq = self.post_quant_conv(quant)
        return self.decoder(hq), self.gaus_decoder(hq)

    def forward(self, x: torch.Tensor):
        quant, diff, ind = self.encode(x)
        dec, gaus = self.decode_gaussians(quant)
        return dec, diff, ind, gaus

    def forward_with_prefinal_gaus(self, x: torch.Tensor):
        """(reconstruction, codebook loss, indices, the decoder's last-layer
        input, Gaussian parameters): the s2 branch of the VQ-GAN step."""
        quant, diff, ind = self.encode(x)
        hq = self.post_quant_conv(quant)
        dec, prefinal = self.decoder(hq, return_prefinal=True)
        return dec, diff, ind, prefinal, self.gaus_decoder(hq)


def render_range_from_gaussians(dec_range: torch.Tensor, gaus: Dict[str, torch.Tensor],
                                geom: LidarGeometry,
                                raster_cfg: RasterConfig = RasterConfig()
                                ) -> Dict[str, torch.Tensor]:
    """One Gaussian a pixel at the unprojected model-space range decode
    ``dec_range`` (B, H, W) (pixels outside the depth range masked), its SH
    evaluated along its bearing, rendered one image at a time: rendered_range
    (B, H, W) metric, alpha, rendered_feat (B, H, W, 4), rendered_intensity
    and rendered_raydrop."""
    xyz, valid = range2xyz(dec_range, geom, from_model_space=True, fill=0.0)
    out = []
    for i in range(dec_range.shape[0]):
        means = xyz[i].reshape(-1, 3)
        v = valid[i].reshape(-1)
        dirs = means / torch.linalg.vector_norm(means, dim=-1, keepdim=True).clamp(min=1e-6)
        n = means.shape[0]
        feats = eval_sh(SH_DEGREE, gaus["sh"][i].reshape(n, SH_CHANNELS, -1), dirs)
        r = rasterize(means, gaus["rot"][i].reshape(-1, 4), gaus["scale"][i].reshape(-1, 3),
                      gaus["opacity"][i].reshape(-1) * v, feats, geom, mask=v, cfg=raster_cfg)
        alpha = r["alpha"].clamp(min=1e-6)
        out.append((r["depth"] / alpha, r["alpha"], r["feature"] / alpha[..., None]))
    rng_img, alpha, feats = (torch.stack(t) for t in zip(*out))
    return {"rendered_range": rng_img, "alpha": alpha, "rendered_feat": feats,
            "rendered_intensity": feats[..., 2], "rendered_raydrop": feats[..., 3]}


def s2_loss(geo: GeoConverter, inputs: torch.Tensor, rendered_model: torch.Tensor,
            smooth_factor: float = 0.1, norm_factor: float = 0.1
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """forward_s2 on (B, 1, H, W) model-space images: L1 on the rendered
    range, smoothness and normal consistency (no chamfer term, the
    reference's default)."""
    l1 = torch.mean((inputs - rendered_model).abs())
    sm = smoothness_loss(geo.depth_from_model(rendered_model),
                         geo.depth_from_model(inputs)) * smooth_factor
    nc = normal_consistency_loss(geo, geo(inputs), geo(rendered_model)) * norm_factor
    loss = l1 + sm + nc
    return loss, {"s2_l1": l1, "s2_smooth": sm, "s2_normal": nc, "s2_loss": loss}
