"""Azimuth-banded Gaussian rasterization (the tiled path), plain PyTorch.

Counterpart of ``lidar_layout_tpu/ops/gaussian_raster_tiled.py``
(``BandedConfig``, ``rasterize_banded``): the panorama splits into bands of
``band_w`` columns; each Gaussian is copied into the bands its 3-sigma
azimuth support touches (at most ``max_span``, wrap-aware); one stable sort
by (band, depth rank) gives each band a depth-ordered list of ``capacity``
Gaussians (overflow drops the farthest, and is counted); every band
composites only its list over its (H, band_w) pixels. The bands run as one
batch (JAX vmaps over them), the chunks of a band as ``gaussian_raster``'s
checkpointed loop.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from .gaussian_raster import (build_covariance, composite_step, gaussian_alpha,
                              inverse_cov2d, project_covariance, run_chunks,
                              spherical_project)
from .lidar import LidarGeometry


@dataclasses.dataclass(frozen=True)
class BandedConfig:
    band_w: int = 32          # columns a band
    capacity: int = 512       # Gaussians a band
    max_span: int = 5         # bands one Gaussian may touch (odd)
    chunk: int = 128          # compositing chunk within a band
    alpha_thresh: float = 1.0 / 255.0
    max_alpha: float = 0.99
    cutoff_sigma2: float = 9.0
    blur: float = 0.3


def rasterize_banded(means: torch.Tensor, quats: torch.Tensor, scales: torch.Tensor,
                     opacities: torch.Tensor, features: torch.Tensor, geom: LidarGeometry,
                     mask: Optional[torch.Tensor] = None,
                     cfg: BandedConfig = BandedConfig()) -> Dict[str, torch.Tensor]:
    """``gaussian_raster.rasterize``'s contract, banded; also ``overflow``,
    the band entries that capacity dropped (0-d int)."""
    h, w = geom.size
    n, f_dim = features.shape
    assert w % cfg.band_w == 0
    n_bands, span, cap = w // cfg.band_w, cfg.max_span, cfg.capacity
    dev = means.device

    u, v, depth = spherical_project(means, geom)
    valid = depth > 1e-3
    if mask is not None:
        valid = valid & mask
    cov2d = project_covariance(build_covariance(quats, scales), means, geom, cfg.blur)
    inv = inverse_cov2d(cov2d)

    # copies of each Gaussian in the bands it touches
    r_u = 3.0 * torch.sqrt(cov2d[:, 0, 0].clamp(min=1e-8))
    r_bands = torch.ceil(r_u / cfg.band_w).clamp(max=span // 2).to(torch.int64)
    center_band = torch.floor(u / cfg.band_w).to(torch.int64) % n_bands
    offs = torch.arange(span, device=dev) - span // 2
    bands = (center_band[:, None] + offs[None, :]) % n_bands
    entry_valid = (offs.abs()[None, :] <= r_bands[:, None]) & valid[:, None]

    # one sort by (band, depth rank): per-band depth-ordered lists
    depth_rank = torch.argsort(torch.argsort(torch.where(valid, depth, math.inf), stable=True),
                               stable=True)
    key = torch.where(entry_valid, bands * n + depth_rank[:, None], n_bands * n).reshape(-1)
    order = torch.argsort(key, stable=True)
    sorted_band = key[order] // n
    sorted_gauss = torch.arange(n, device=dev).repeat_interleave(span)[order]
    band_start = torch.searchsorted(sorted_band, torch.arange(n_bands, device=dev))
    pos = torch.arange(n * span, device=dev) - band_start[sorted_band.clamp(0, n_bands - 1)]
    keep = (sorted_band < n_bands) & (pos < cap)
    slot = torch.where(keep, sorted_band * cap + pos, n_bands * cap)
    table = torch.zeros((n_bands * cap + 1,), dtype=torch.int64, device=dev).scatter_reduce(
        0, slot, torch.where(keep, sorted_gauss + 1, 0), reduce="amax", include_self=True)
    idx = table[: n_bands * cap].reshape(n_bands, cap) - 1
    idx = torch.where(idx >= 0, idx, n)                      # n = the zero row

    def gathered(x):
        return torch.cat([x, x.new_zeros((1, *x.shape[1:]))])[idx]

    bu, bv, bd = gathered(u), gathered(v), gathered(depth)
    bop, binv, bfeat = gathered(torch.where(valid, opacities, 0.0)), gathered(inv), \
        gathered(features)

    # every band over its pixels, all bands at once
    px = ((torch.arange(cfg.band_w, dtype=torch.float32, device=dev) + 0.5)[None, :]
          + (torch.arange(n_bands, device=dev) * cfg.band_w)[:, None])       # (B, wb)
    py = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    pxf = px[:, None, :].expand(n_bands, h, cfg.band_w).reshape(n_bands, -1)  # (B, P)
    pyf = py[None, :, None].expand(n_bands, h, cfg.band_w).reshape(n_bands, -1)
    p = h * cfg.band_w
    ch = cfg.chunk
    chunks = list(zip(*(x.split(ch, dim=1) for x in (bu, bv, bd, bop, binv, bfeat))))

    def body(t, acc_f, acc_d, acc_a, ku, kv, kd, kop, kinv, kfeat):
        alpha = gaussian_alpha(pxf[:, :, None] - ku[:, None, :], pyf[:, :, None] - kv[:, None, :],
                               kinv, kop, w, cfg)
        return composite_step(alpha, kd, kfeat, (t, acc_f, acc_d, acc_a))

    carry = (torch.ones((n_bands, p), device=dev), torch.zeros((n_bands, p, f_dim), device=dev),
             torch.zeros((n_bands, p), device=dev), torch.zeros((n_bands, p), device=dev))
    t, acc_f, acc_d, acc_a = run_chunks(body, carry, chunks)

    def stitch(x):   # (B, H*wb, ...) -> (H, W, ...)
        x = x.reshape(n_bands, h, cfg.band_w, *x.shape[2:]).movedim(0, 1)
        return x.reshape(h, w, *x.shape[3:])

    overflow = ((sorted_band < n_bands) & (pos >= cap)).sum().to(torch.int32)
    return {"feature": stitch(acc_f), "depth": stitch(acc_d), "alpha": stitch(acc_a),
            "transmittance": stitch(t), "overflow": overflow}
