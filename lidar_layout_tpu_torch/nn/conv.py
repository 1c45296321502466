"""Curve-wise (circular) convolutions for panoramic range images, NCHW.

Counterpart of ``lidar_layout_tpu/nn/conv.py``: wrap padding on W (the 360
degree azimuth) and zero padding on H, then a VALID convolution. Padding
tuples are ``(left, right, top, bottom)``. The modules are ``nn.Conv2d``s, so
their state_dict holds ``weight`` (OIHW) and ``bias`` as the reference's.

Under the spatial (``sp``) axis (``parallel/mesh.spatial_sharding``) a
``CircularConv`` sees one W shard: its W padding becomes the halo ring of
its neighbours' edge columns (``collectives.halo_exchange``), of the widths
``halo_widths`` derives from its kernel, stride and padding; H keeps its
zero padding, locally.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.collectives import halo_exchange, spatial_plan

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


def halo_widths(kernel: int, stride: int, left: int, right: int, width: int,
                shards: int) -> Tuple[int, int]:
    """(left, right) halo columns of one of ``shards`` W shards of ``width``
    columns for a conv of ``kernel`` columns, ``stride`` and W padding
    (``left``, ``right``) over the whole width: the shard's outputs are the
    whole output's columns width / stride * [index, index + 1), which read
    the ``left`` columns before the shard and ``kernel - stride - left``
    after it (0 for JAX's stride-2 tables with a left pad of 1, 1 for
    ``DOWNSAMPLE_PAD[(2, 2)]``'s (0, 1)). Raises unless the stride divides
    the shard and the whole output is width * shards / stride wide."""
    total = width * shards
    out = (total + left + right - kernel) // stride + 1
    if width % stride or out * stride != total:
        raise ValueError(f"a W-sharded conv needs a shard width ({width}) its stride "
                         f"({stride}) divides and an output of the whole width / stride "
                         f"({total} wide, kernel {kernel}, pad ({left}, {right}): {out})")
    return left, kernel - stride - left


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
        plan = spatial_plan()
        if plan is None:
            return super().forward(circular_pad(x, self.pad, self.wrap))
        halo = self.halo(x.shape[-1], plan.sp)
        return self.forward_halo(halo_exchange(x, *halo, plan.group, self.wrap))

    def halo(self, width: int, shards: int) -> Tuple[int, int]:
        """(left, right) halo columns of a shard ``width`` wide of ``shards``."""
        left, right = self.pad[:2]
        return halo_widths(self.kernel_size[1], self.stride[1], left, right, width, shards)

    def forward_halo(self, x: torch.Tensor) -> torch.Tensor:
        """The conv of a W shard given with its halo columns (``halo``) on
        either side: H zero-padded, W as it is."""
        top, bottom = self.pad[2:]
        return super().forward(F.pad(x, (0, 0, top, bottom)) if top or bottom else x)


class Conv1x1(nn.Conv2d):
    """Pointwise conv."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True):
        super().__init__(in_channels, out_channels, 1, bias=bias)



class ZeroPaddedConv(nn.Module):
    """A plain 1-, 2- or 3-D conv after zero padding of each side; its
    state_dict holds ``weight`` and ``bias`` as the torch conv's."""

    def __init__(self, dims: int, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, ...], stride: Tuple[int, ...],
                 pairs: Tuple[Tuple[int, int], ...]):
        super().__init__()
        conv = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}[dims](
            in_channels, out_channels, kernel_size, stride)
        self.weight, self.bias = conv.weight, conv.bias
        self.stride = stride
        self.conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[dims]
        # F.pad takes the last dimension first
        self.pad = tuple(v for lo_hi in reversed(pairs) for v in lo_hi)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, self.pad), self.weight, self.bias, self.stride)


def conv_nd(dims: int, in_channels: int, out_channels: int, kernel_size, *,
            cconv: bool = False, strides=None, padding: PadSpec = 0) -> nn.Module:
    """The reference's ``conv_nd(..., cconv=)`` dispatch (JAX ``nn/conv.conv_nd``):
    a circular conv for a 2-D ``cconv``, else a plain conv of ``dims``
    dimensions with zero padding. A 2-D padding is ``(left, right, top,
    bottom)`` (an int pads every side); 1-D and 3-D take an int or one
    (low, high) pair for each spatial dimension in order."""
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size,) * dims
    if strides is None:
        strides = (1,) * dims
    elif isinstance(strides, int):
        strides = (strides,) * dims
    if dims == 2 and cconv:
        return CircularConv(in_channels, out_channels, tuple(kernel_size), tuple(strides),
                            padding)
    if dims == 2:
        left, right, top, bottom = _norm_pad(padding)
        pairs = ((top, bottom), (left, right))
    elif isinstance(padding, int):
        pairs = ((padding, padding),) * dims
    else:
        pairs = tuple(tuple(p) for p in padding)
    return ZeroPaddedConv(dims, in_channels, out_channels, tuple(kernel_size),
                          tuple(strides), pairs)
