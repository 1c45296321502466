"""Patched (fold/unfold) inference for inputs wider than the training size.

Counterpart of ``lidar_layout_tpu/ops/foldunfold.py`` (the reference's
``split_input_params`` path): the U-Net, encode and decode run on
overlapping crops that are stitched back with border-weighted averaging.
The azimuth axis wraps, so patches taken past the right edge continue from
the left (a circular unfold). Tensors here are NCHW; the crops, their order,
the border weights and the wrap are the JAX package's.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch


def _weight_kernel(ph: int, pw: int, clip_min: float = 0.01) -> np.ndarray:
    """Border-decay weighting (the reference's delta_border/weighting)."""
    wy = np.minimum(np.arange(ph) + 1, np.arange(ph)[::-1] + 1) / (ph / 2)
    wx = np.minimum(np.arange(pw) + 1, np.arange(pw)[::-1] + 1) / (pw / 2)
    return np.clip(np.outer(wy, wx), clip_min, 1.0).astype(np.float32)


def unfold_patches(x: torch.Tensor, patch: Tuple[int, int], stride: Tuple[int, int]
                   ) -> Tuple[torch.Tensor, List[Tuple[int, int]]]:
    """(B, C, H, W) -> ((B, n_patches, C, ph, pw), their (y0, x0)), circular
    along W; rows first, then columns."""
    h, w = x.shape[-2:]
    ph, pw = patch
    sh, sw = stride
    ys = list(range(0, max(h - ph, 0) + 1, sh)) or [0]
    if ys[-1] != h - ph:
        ys.append(h - ph)
    xs = list(range(0, w, sw))
    xpad = torch.cat([x, x[..., :pw]], dim=-1)   # the last patches wrap
    coords = [(y0, x0) for y0 in ys for x0 in xs]
    tiles = torch.stack([xpad[..., y0:y0 + ph, x0:x0 + pw] for y0, x0 in coords], dim=1)
    return tiles, coords


def fold_patches(tiles: torch.Tensor, coords: List[Tuple[int, int]],
                 out_shape: Tuple[int, int, int, int]) -> torch.Tensor:
    """Weighted overlap-add of (B, n, C, ph, pw) tiles back onto a (B, C, H, W)
    canvas, the wrapped strip folded onto the left edge; float32."""
    b, c, h, w = out_shape
    ph, pw = tiles.shape[-2:]
    wgt = torch.from_numpy(_weight_kernel(ph, pw)).to(tiles.device)
    acc = torch.zeros((b, c, h, w + pw), dtype=torch.float32, device=tiles.device)
    den = torch.zeros((1, 1, h, w + pw), dtype=torch.float32, device=tiles.device)
    for i, (y0, x0) in enumerate(coords):
        acc[..., y0:y0 + ph, x0:x0 + pw] += tiles[:, i].float() * wgt
        den[..., y0:y0 + ph, x0:x0 + pw] += wgt
    acc[..., :pw] += acc[..., w:]
    den[..., :pw] += den[..., w:]
    return acc[..., :w] / torch.clamp(den[..., :w], min=1e-8)


def patched_apply_scaled(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                         patch: Tuple[int, int], stride: Tuple[int, int],
                         scale: Tuple[float, float] = (1.0, 1.0)) -> torch.Tensor:
    """Patch-wise apply of a resolution-changing ``fn`` (the first stage's
    encode or decode): unfold at the input's resolution, fold the outputs on
    a canvas ``scale`` times the input's spatial size (1/vqf for encode, vqf
    for decode)."""
    h, w = x.shape[-2:]
    sh, sw = scale
    tiles, coords = unfold_patches(x, patch, stride)
    b, n = tiles.shape[:2]
    # every tile at once, the patches folded into the batch (JAX vmaps ``fn``)
    outs = fn(tiles.reshape(b * n, *tiles.shape[2:]))
    outs = outs.reshape(b, n, *outs.shape[1:])
    oh, ow = int(round(h * sh)), int(round(w * sw))
    ocoords = [(int(round(y0 * sh)), int(round(x0 * sw))) for y0, x0 in coords]
    return fold_patches(outs, ocoords, (x.shape[0], outs.shape[2], oh, ow))
