"""R2DM: pixel-space range diffusion with an efficient ring-conv U-Net, NCHW.

Counterpart of ``lidar_layout_tpu/models/r2dm.py``: ``R2DMConfig``, the three
coordinate encodings (Fourier features, real spherical harmonics of the view
direction, raw polar directions), ``EffSelfAttention``, ``EffResBlock``,
``EfficientUNet`` and ``R2DMDiffusion`` over 2-channel (depth, intensity)
32x1024 range images.

Every GroupNorm is ``nn/blocks.Normalize``, so on the card each runs kernel
K3 (61 a U-Net eval at the YAML's config, in f32). The self-attention at the
deepest level is flax's ``MultiHeadDotProductAttention`` in JAX, plain XLA,
and plain here too (``encoders/modules.MultiHeadAttention``).

Images at this API are NHWC (B, H, W, 2), as in the JAX package, and the
samplers of ``models/samplers`` drive ``R2DMDiffusion`` as they drive a
LiDM, in pixel space with no first stage. The modules keep the flax names
(``t0``, ``conv_in``, ``down_<l>_<i>.n1``, ``down_3_attn.attn.query``,
``up_<l>_conv``, ``conv_out``, ...): ``utils/convert.r2dm_state_dict``
carries a JAX tree over. ``conv_out`` starts at zero, as flax's, so a fresh
model predicts exactly 0.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..encoders.modules import MultiHeadAttention
from ..nn.blocks import Normalize
from ..nn.conv import CircularConv
from ..nn.embeddings import timestep_embedding
from ..parallel.collectives import rank_rows
from .schedules import DiffusionSchedule, q_sample


@dataclasses.dataclass(frozen=True)
class R2DMConfig:
    image_size: Tuple[int, int] = (32, 1024)
    channels: int = 2                  # depth + intensity
    base_channels: int = 64
    channel_mult: Tuple[int, ...] = (1, 2, 4, 8)
    num_res_blocks: Union[int, Tuple[int, ...]] = 2
    coord_bands: int = 6               # Fourier coordinate encoding bands
    # "fourier_features" | "spherical_harmonics" | "polar_coordinates" | None
    coords_encoding: Optional[str] = "fourier_features"
    sh_levels: int = 5
    attn_levels: Tuple[int, ...] = (3,)
    attn_num_heads: int = 8
    timesteps: int = 1024
    beta_schedule: str = "cosine"
    loss_type: str = "l2"
    parameterization: str = "eps"

    def blocks_at(self, lvl: int) -> int:
        n = self.num_res_blocks
        return n[lvl] if isinstance(n, (tuple, list)) else n


def coord_encoding(h: int, w: int, bands: int) -> np.ndarray:
    """(H, W, 4 * bands) f32 Fourier features of the pixel coordinates; the
    azimuth uses the full angle, so the encoding wraps at 360 degrees."""
    yy = (np.arange(h) + 0.5) / h
    xx = (np.arange(w) + 0.5) / w * 2 * np.pi
    feats = []
    for b in range(bands):
        k = 2.0 ** b
        feats.append(np.broadcast_to(np.sin(k * xx)[None, :], (h, w)))
        feats.append(np.broadcast_to(np.cos(k * xx)[None, :], (h, w)))
        feats.append(np.broadcast_to(np.sin(k * np.pi * yy)[:, None], (h, w)))
        feats.append(np.broadcast_to(np.cos(k * np.pi * yy)[:, None], (h, w)))
    return np.stack(feats, -1).astype(np.float32)


def polar_dirs(h: int, w: int) -> np.ndarray:
    """(H, W, 3) unit view directions of the range grid: elevation from +pi/2
    at the top row to -pi/2, azimuth across the columns."""
    el = (0.5 - (np.arange(h) + 0.5) / h) * np.pi
    az = ((np.arange(w) + 0.5) / w * 2 - 1) * np.pi
    el, az = np.meshgrid(el, az, indexing="ij")
    return np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], -1)


def sh_coord_encoding(h: int, w: int, levels: int) -> np.ndarray:
    """(H, W, levels**2) f32 real spherical harmonics of each pixel's view
    direction, from scipy (``sph_harm_y`` from scipy 1.15, ``sph_harm``
    before it)."""
    try:
        from scipy.special import sph_harm_y

        def _sh(m, l, az, pol):
            return sph_harm_y(l, m, pol, az)
    except ImportError:
        from scipy.special import sph_harm

        def _sh(m, l, az, pol):
            return sph_harm(m, l, az, pol)

    d = polar_dirs(h, w)
    theta = np.arccos(np.clip(d[..., 2], -1, 1))
    phi = np.arctan2(d[..., 1], d[..., 0])
    feats = []
    for l in range(levels):
        for m in range(-l, l + 1):
            y = _sh(abs(m), l, phi, theta)
            feats.append(np.sqrt(2) * y.imag if m < 0 else y.real if m == 0
                         else np.sqrt(2) * y.real)
    return np.stack(feats, -1).astype(np.float32)


def polar_coord_encoding(h: int, w: int) -> np.ndarray:
    """The raw (H, W, 3) unit directions."""
    return polar_dirs(h, w).astype(np.float32)


def coords_for(cfg: R2DMConfig, h: int, w: int) -> Optional[np.ndarray]:
    """The configured (H, W, F) encoding, or None."""
    if cfg.coords_encoding == "spherical_harmonics":
        return sh_coord_encoding(h, w, cfg.sh_levels)
    if cfg.coords_encoding == "polar_coordinates":
        return polar_coord_encoding(h, w)
    if cfg.coords_encoding == "fourier_features":
        return coord_encoding(h, w, cfg.coord_bands)
    return None


def coord_channels(cfg: R2DMConfig) -> int:
    return {"spherical_harmonics": cfg.sh_levels ** 2, "polar_coordinates": 3,
            "fourier_features": 4 * cfg.coord_bands}.get(cfg.coords_encoding, 0)


class EffSelfAttention(nn.Module):
    """GroupNorm, multi-head self-attention over the flattened pixels, residual."""

    def __init__(self, channels: int, num_heads: int = 8):
        super().__init__()
        self.norm = Normalize(channels)
        self.attn = MultiHeadAttention(channels, num_heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.norm(x).flatten(2).transpose(1, 2)
        return x + self.attn(y).transpose(1, 2).reshape(b, c, h, w)


class EffResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, emb_dim: int):
        super().__init__()
        self.n1 = Normalize(in_channels, act=True)
        self.c1 = CircularConv(in_channels, out_channels, (3, 3), (1, 1), 1)
        self.emb = nn.Linear(emb_dim, out_channels)
        self.n2 = Normalize(out_channels, act=True)
        self.c2 = CircularConv(out_channels, out_channels, (3, 3), (1, 1), 1)
        if in_channels != out_channels:
            self.skip = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.c1(self.n1(x)) + self.emb(F.silu(emb))[:, :, None, None]
        h = self.c2(self.n2(h))
        return (self.skip(x) if hasattr(self, "skip") else x) + h


class EfficientUNet(nn.Module):
    """(B, C, H, W) image and (B,) timesteps -> (B, C, H, W) noise estimate."""

    def __init__(self, cfg: R2DMConfig):
        super().__init__()
        self.cfg = cfg
        base, time_dim = cfg.base_channels, cfg.base_channels * 4
        self.t0 = nn.Linear(base, time_dim)
        self.t2 = nn.Linear(time_dim, time_dim)
        self.conv_in = CircularConv(cfg.channels + coord_channels(cfg), base, (3, 3), (1, 1), 1)
        skips, cur = [base], base
        for lvl, mult in enumerate(cfg.channel_mult):
            ch = base * mult
            for i in range(cfg.blocks_at(lvl)):
                self.add_module(f"down_{lvl}_{i}", EffResBlock(cur, ch, time_dim))
                cur = ch
                skips.append(ch)
            if lvl in cfg.attn_levels:
                self.add_module(f"down_{lvl}_attn", EffSelfAttention(ch, cfg.attn_num_heads))
            if lvl != len(cfg.channel_mult) - 1:
                self.add_module(f"down_{lvl}_pool",
                                CircularConv(ch, ch, (3, 3), (2, 2), (0, 1, 0, 1)))
                skips.append(ch)
        self.mid = EffResBlock(cur, cur, time_dim)
        for lvl in reversed(range(len(cfg.channel_mult))):
            ch = base * cfg.channel_mult[lvl]
            for i in range(cfg.blocks_at(lvl) + 1):
                self.add_module(f"up_{lvl}_{i}", EffResBlock(cur + skips.pop(), ch, time_dim))
                cur = ch
            if lvl in cfg.attn_levels:
                self.add_module(f"up_{lvl}_attn", EffSelfAttention(ch, cfg.attn_num_heads))
            if lvl != 0:
                self.add_module(f"up_{lvl}_conv", CircularConv(ch, ch, (3, 3), (1, 1), 1))
        self.norm_out = Normalize(cur, act=True)
        self.conv_out = nn.Conv2d(cur, cfg.channels, 3, padding=1)
        nn.init.zeros_(self.conv_out.weight)
        nn.init.zeros_(self.conv_out.bias)
        self._coords: Dict[Tuple[int, int, str], Optional[torch.Tensor]] = {}

    def coords(self, h: int, w: int, device) -> Optional[torch.Tensor]:
        """The (F, H, W) encoding on ``device``, computed once a size."""
        key = (h, w, str(device))
        if key not in self._coords:
            enc = coords_for(self.cfg, h, w)
            self._coords[key] = (None if enc is None else
                                 torch.from_numpy(enc).permute(2, 0, 1).contiguous().to(device))
        return self._coords[key]

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, _, h, w = x.shape
        coords = self.coords(h, w, x.device)
        if coords is not None:
            x = torch.cat([x, coords.to(x.dtype).expand(b, *coords.shape)], dim=1)
        emb = self.t2(F.silu(self.t0(timestep_embedding(timesteps, cfg.base_channels))))
        hh = self.conv_in(x)
        skips = [hh]
        n = len(cfg.channel_mult)
        for lvl in range(n):
            for i in range(cfg.blocks_at(lvl)):
                hh = getattr(self, f"down_{lvl}_{i}")(hh, emb)
                skips.append(hh)
            if lvl in cfg.attn_levels:      # the attention's output replaces the last skip
                hh = getattr(self, f"down_{lvl}_attn")(hh)
                skips[-1] = hh
            if lvl != n - 1:
                hh = getattr(self, f"down_{lvl}_pool")(hh)
                skips.append(hh)
        hh = self.mid(hh, emb)
        for lvl in reversed(range(n)):
            for i in range(cfg.blocks_at(lvl) + 1):
                hh = getattr(self, f"up_{lvl}_{i}")(torch.cat([hh, skips.pop()], dim=1), emb)
            if lvl in cfg.attn_levels:
                hh = getattr(self, f"up_{lvl}_attn")(hh)
            if lvl != 0:   # jax.image.resize "nearest" at 2x: output pixel i reads i // 2
                hh = getattr(self, f"up_{lvl}_conv")(F.interpolate(hh, scale_factor=2.0,
                                                                   mode="nearest"))
        return self.conv_out(self.norm_out(hh))


class R2DMDiffusion(nn.Module):
    """Pixel-space DDPM over NHWC (depth, intensity) range images."""

    def __init__(self, cfg: R2DMConfig):
        super().__init__()
        self.cfg = cfg
        self.schedule = DiffusionSchedule.create(timesteps=cfg.timesteps,
                                                 beta_schedule=cfg.beta_schedule)
        self.unet = EfficientUNet(cfg)

    def apply_model(self, x: torch.Tensor, t: torch.Tensor, cond=None) -> torch.Tensor:
        """The U-Net's noise estimate for NHWC ``x`` at timesteps ``t``."""
        return self.unet(x.permute(0, 3, 1, 2), t).permute(0, 2, 3, 1)

    def p_losses(self, x0: torch.Tensor, generator: Optional[torch.Generator] = None,
                 t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The simple loss (L2, or L1 with ``loss_type`` "l1") between the
        noise estimate and the noise. ``t`` (B,) and ``noise`` are drawn from
        ``generator``, in that order, unless given."""
        b = x0.shape[0]
        if t is None:   # under dp: this rank's rows of the global batch's draws
            t = rank_rows(lambda n: torch.randint(0, self.cfg.timesteps, (n,),
                                                  generator=generator, device=x0.device), b)
        if noise is None:
            noise = rank_rows(lambda n: torch.randn((n, *x0.shape[1:]), generator=generator,
                                                    device=x0.device), b)
        t = t.to(x0.device)
        out = self.apply_model(q_sample(self.schedule, x0, t, noise), t)
        loss = ((out - noise) ** 2).mean() if self.cfg.loss_type == "l2" else \
            (out - noise).abs().mean()
        return loss, {"loss": loss}

    def eps_from_model_out(self, x_t: torch.Tensor, t: torch.Tensor,
                           out: torch.Tensor) -> torch.Tensor:
        """The model predicts the noise: the samplers' eps is its output."""
        return out
