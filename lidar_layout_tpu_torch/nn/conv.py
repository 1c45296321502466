"""Curve-wise (circular) convolutions for panoramic range images, NCHW.

Counterpart of ``lidar_layout_tpu/nn/conv.py``: wrap padding on W (the 360
degree azimuth) and zero padding on H, then a VALID convolution. Padding
tuples are ``(left, right, top, bottom)``. The modules are ``nn.Conv2d``s, so
their state_dict holds ``weight`` (OIHW) and ``bias`` as the reference's.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

PadSpec = Union[int, Tuple[int, int, int, int]]


def circular_pad(x: torch.Tensor, pad: Tuple[int, int, int, int],
                 wrap: bool = True) -> torch.Tensor:
    """Pad NCHW: wrap on W (zeros when ``wrap=False``), zeros on H. Two calls,
    since ``F.pad(mode="circular")`` on a 4-D tensor would also wrap H."""
    left, right, top, bottom = pad
    if left or right:
        x = F.pad(x, (left, right, 0, 0), mode="circular" if wrap else "constant")
    if top or bottom:
        x = F.pad(x, (0, 0, top, bottom))
    return x


def _norm_pad(padding: PadSpec) -> Tuple[int, int, int, int]:
    if isinstance(padding, int):
        return (padding, padding, padding, padding)
    return tuple(padding)  # type: ignore[return-value]


class CircularConv(nn.Conv2d):
    """2D conv with horizontal circular + vertical zero padding; kernel and
    stride in (kh, kw) order, as the reference's stride/kernel tables."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int] = (3, 3),
                 stride: Tuple[int, int] = (1, 1), padding: PadSpec = 0,
                 bias: bool = True, wrap: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding=0, bias=bias)
        self.pad = _norm_pad(padding)
        self.wrap = wrap

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(circular_pad(x, self.pad, self.wrap))


class Conv1x1(nn.Conv2d):
    """Pointwise conv."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True):
        super().__init__(in_channels, out_channels, 1, bias=bias)
