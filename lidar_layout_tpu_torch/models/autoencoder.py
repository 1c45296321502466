"""Range-image VQ autoencoder with curve-wise convs, NCHW.

Counterpart of ``lidar_layout_tpu/models/autoencoder.py`` (``AEConfig``,
``Encoder``, ``Decoder``, ``apply_raydrop``, ``VQModel``,
``VQModelInterface``, ``DiagonalGaussian``, ``AutoencoderKL``,
``IdentityFirstStage``). Modules carry the reference model_lidm state_dict
names (``encoder.down.i.block.j.norm1``, ``decoder.up.i.upsample.conv``,
``quantize.embedding``, ``post_quant_conv``, ...), so the JAX package's
``utils/torch_convert.convert_vq_autoencoder`` reads a port state_dict.
``VQModel.forward_with_prefinal`` also returns the decoder's last-layer
input, for the adaptive GAN weight of ``train/ae_trainer``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..nn.blocks import Downsample, Normalize, ResnetBlock, Upsample, make_attn
from ..nn.conv import CircularConv, Conv1x1
from ..nn.quantize import VectorQuantizer
from ..parallel.collectives import rank_rows


@dataclasses.dataclass(frozen=True)
class AEConfig:
    """ddconfig of the reference (configs/autoencoder/kitti/autoencoder_c2_p4.yaml)."""

    ch: int = 64
    out_ch: int = 1
    ch_mult: Tuple[int, ...] = (1, 2, 2, 4)
    strides: Tuple[Tuple[int, int], ...] = ((1, 2), (2, 2), (2, 2))
    num_res_blocks: int = 2
    attn_levels: Tuple[int, ...] = ()
    dropout: float = 0.0
    in_channels: int = 1
    z_channels: int = 8
    double_z: bool = False
    resamp_with_conv: bool = True
    attn_type: str = "vanilla"
    tanh_out: bool = False
    give_pre_end: bool = False
    circular: bool = True  # False = the model_ldm plain-conv variant


class _Level(nn.Module):
    """One resolution level: ``block``, ``attn`` and the optional resampler."""

    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()


class _Mid(nn.Module):
    def __init__(self, ch: int, attn_type: str, wrap: bool, dropout: float):
        super().__init__()
        self.block_1 = ResnetBlock(ch, dropout=dropout, wrap=wrap)
        self.attn_1 = make_attn(ch, attn_type)
        self.block_2 = ResnetBlock(ch, dropout=dropout, wrap=wrap)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(h)))


class Encoder(nn.Module):
    """Downsampling tower with asymmetric strides."""

    def __init__(self, cfg: AEConfig):
        super().__init__()
        self.cfg = cfg
        wrap = cfg.circular
        self.conv_in = CircularConv(cfg.in_channels, cfg.ch, (3, 3), (1, 1), 1, wrap=wrap)
        in_mult = (1,) + tuple(cfg.ch_mult)
        self.down = nn.ModuleList()
        for i, mult in enumerate(cfg.ch_mult):
            level = _Level()
            block_in, block_out = cfg.ch * in_mult[i], cfg.ch * mult
            for _ in range(cfg.num_res_blocks):
                level.block.append(ResnetBlock(block_in, block_out, dropout=cfg.dropout,
                                               wrap=wrap))
                block_in = block_out
                if i in cfg.attn_levels:
                    level.attn.append(make_attn(block_out, cfg.attn_type))
            if i != len(cfg.ch_mult) - 1:
                level.downsample = Downsample(block_out, cfg.strides[i],
                                              cfg.resamp_with_conv, wrap=wrap)
            self.down.append(level)
        ch = cfg.ch * cfg.ch_mult[-1]
        self.mid = _Mid(ch, cfg.attn_type, wrap, cfg.dropout)
        self.norm_out = Normalize(ch, act=True)
        z_ch = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = CircularConv(ch, z_ch, (3, 3), (1, 1), 1, wrap=wrap)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            for j, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[j](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(self.norm_out(h))


class Decoder(nn.Module):
    """Upsampling tower; each level's kernel, (1,4) or (3,3), follows the
    stride that feeds that level."""

    def __init__(self, cfg: AEConfig):
        super().__init__()
        self.cfg = cfg
        wrap = cfg.circular
        stride2kernel = {(2, 2): (3, 3), (1, 2): (1, 4)}
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = CircularConv(cfg.z_channels, block_in, (3, 3), (1, 1), 1, wrap=wrap)
        self.mid = _Mid(block_in, cfg.attn_type, wrap, cfg.dropout)
        levels = {}
        for i in reversed(range(len(cfg.ch_mult))):
            stride = tuple(cfg.strides[i - 1]) if i > 0 else None
            kernel = stride2kernel.get(stride, (1, 4)) if stride is not None else (1, 4)
            block_out = cfg.ch * cfg.ch_mult[i]
            level = _Level()
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, block_out, kernel_size=kernel,
                                               dropout=cfg.dropout, wrap=wrap))
                block_in = block_out
                if i in cfg.attn_levels:
                    level.attn.append(make_attn(block_out, cfg.attn_type))
            if stride is not None:
                level.upsample = Upsample(block_out, stride, cfg.resamp_with_conv,
                                          wrap=wrap)
            levels[i] = level
        self.up = nn.ModuleList([levels[i] for i in range(len(cfg.ch_mult))])
        if not cfg.give_pre_end:   # a tower that ends before its norm has no head
            self.norm_out = Normalize(block_in, act=True)
            self.conv_out = CircularConv(block_in, cfg.out_ch, (1, 4), (1, 1), (1, 2, 0, 0),
                                         wrap=wrap)

    def forward(self, z: torch.Tensor, return_prefinal: bool = False):
        """The decoded image; with ``return_prefinal`` also conv_out's input
        (after ``norm_out`` and SiLU), as ``(image, prefinal)``."""
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for j, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[j](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        if self.cfg.give_pre_end:
            return h
        prefinal = self.norm_out(h)
        h = self.conv_out(prefinal)
        h = torch.tanh(h) if self.cfg.tanh_out else h
        return (h, prefinal) if return_prefinal else h


def apply_raydrop(dec: torch.Tensor) -> torch.Tensor:
    """(B, 2, H, W) decode -> (B, 1, H, W) range: channel 1 < 0 means the
    ray dropped, and the pixel becomes -1."""
    return torch.where(dec[:, 1:2] < 0.0, torch.full_like(dec[:, :1], -1.0), dec[:, :1])


class VQModel(nn.Module):
    """VQ autoencoder over range images: ``forward`` returns (reconstruction,
    codebook loss, indices). The VQ-GAN objective is ``losses/vq_loss.py``
    and its two-optimizer step ``train/ae_trainer.py``."""

    def __init__(self, cfg: AEConfig, n_embed: int = 16384, embed_dim: int = 8,
                 use_mask: bool = False):
        super().__init__()
        if use_mask and cfg.out_ch != cfg.in_channels + 1:
            raise ValueError("use_mask requires out_ch == in_channels + 1")
        self.cfg, self.use_mask = cfg, use_mask
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quantize = VectorQuantizer(n_embed, embed_dim)
        self.quant_conv = Conv1x1(cfg.z_channels, embed_dim)
        self.post_quant_conv = Conv1x1(embed_dim, cfg.z_channels)

    def encode(self, x: torch.Tensor):
        return self.quantize(self.quant_conv(self.encoder(x)))  # (quant, loss, idx)

    def encode_to_prequant(self, x: torch.Tensor) -> torch.Tensor:
        return self.quant_conv(self.encoder(x))

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(quant))

    def forward(self, x: torch.Tensor):
        quant, diff, ind = self.encode(x)
        return self.decode(quant), diff, ind

    def forward_with_prefinal(self, x: torch.Tensor):
        """(reconstruction, codebook loss, indices, decoder's last-layer input)."""
        quant, diff, ind = self.encode(x)
        dec, prefinal = self.decoder(self.post_quant_conv(quant), return_prefinal=True)
        return dec, diff, ind, prefinal


class VQModelInterface(VQModel):
    """First-stage interface of latent diffusion: encode returns pre-quant
    latents; decode quantizes first, then applies ray-drop with use_mask."""

    def encode_latent(self, x: torch.Tensor) -> torch.Tensor:
        return self.encode_to_prequant(x)

    def decode_latent(self, h: torch.Tensor, force_not_quantize: bool = False) -> torch.Tensor:
        quant = h if force_not_quantize else self.quantize(h)[0]
        dec = self.decode(quant)
        return apply_raydrop(dec) if self.use_mask else dec


class DiagonalGaussian:
    """Reparameterised diagonal Gaussian over NCHW moments [mean | logvar]
    (logvar clipped to [-30, 20])."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = moments.chunk(2, dim=1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * noise; the noise is drawn from ``generator`` unless given."""
        if noise is None:
            noise = rank_rows(lambda n: torch.randn(  # under dp: this rank's rows
                (n, *self.mean.shape[1:]), generator=generator, device=self.mean.device,
                dtype=self.mean.dtype), self.mean.shape[0])
        return self.mean + self.std * noise.to(self.mean.dtype)

    def kl(self) -> torch.Tensor:
        """KL to N(0, I) per sample, (B,)."""
        return 0.5 * torch.sum(self.mean ** 2 + self.var - 1.0 - self.logvar,
                               dim=tuple(range(1, self.mean.ndim)))

    def mode(self) -> torch.Tensor:
        return self.mean


class AutoencoderKL(nn.Module):
    """KL-regularised autoencoder: the VQ model's Encoder (``double_z``) and
    Decoder around a diagonal Gaussian. ``forward`` returns (reconstruction,
    posterior)."""

    def __init__(self, cfg: AEConfig, embed_dim: int = 8):
        super().__init__()
        if not cfg.double_z:
            raise ValueError("AutoencoderKL needs ddconfig.double_z: true")
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv1x1(2 * cfg.z_channels, 2 * embed_dim)
        self.post_quant_conv = Conv1x1(embed_dim, cfg.z_channels)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        return DiagonalGaussian(self.quant_conv(self.encoder(x)))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                sample_posterior: bool = True, noise: Optional[torch.Tensor] = None):
        posterior = self.encode(x)
        z = posterior.sample(generator, noise) if sample_posterior else posterior.mode()
        return self.decode(z), posterior


class IdentityFirstStage(nn.Module):
    """Pass-through first stage."""

    def forward(self, x: torch.Tensor, *a, **k) -> torch.Tensor:
        return x

    def encode_latent(self, x: torch.Tensor, *a, **k) -> torch.Tensor:
        return x

    def decode_latent(self, x: torch.Tensor, *a, **k) -> torch.Tensor:
        return x
