"""PatchGAN discriminators of the VQ-GAN objective, NCHW, and their losses.

Counterpart of ``lidar_layout_tpu/losses/discriminator.py``:
``NLayerDiscriminator`` (v0, pix2pix: stride-2 4x4 convs) and
``LiDARNLayerDiscriminator`` (v1: circular 4x4 convs with (1, 2) strides, so
only the azimuth is downsampled and the receptive field wraps around the
panorama), the ``DISCRIMINATORS`` table, ``hinge_d_loss`` and
``vanilla_d_loss``. Modules keep the JAX names (``conv_in``, ``conv_<n>``,
``norm_<n>``, ``conv_last``, ``norm_last``, ``conv_out``). The norms are the
JAX package's GroupNorm(32, eps 1e-5) with f32 statistics in place of the
reference's BatchNorm; they run through K3 (``ops/groupnorm.group_norm``,
SiLU off), the same function. The input channels are a constructor argument
(flax infers them). ``PointNetDiscriminator`` waits for the object AE.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.conv import CircularConv
from ..ops.groupnorm import group_norm


class GroupNorm32(nn.Module):
    """GroupNorm(32, eps 1e-5), f32 statistics and affine (K3, no SiLU)."""

    num_groups, eps, act = 32, 1e-5, False

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps, self.act)


class _PatchGAN(nn.Module):
    """conv_in, leaky ReLU; (n_layers - 1) x [conv, norm, leaky ReLU] with
    strides; conv_last, norm_last, leaky ReLU; conv_out. ``conv(cin, cout,
    stride, bias)`` makes each 4x4 conv."""

    def __init__(self, conv, in_channels: int, ndf: int, n_layers: int, out_channels: int,
                 stride):
        super().__init__()
        self.n_layers = n_layers
        self.conv_in = conv(in_channels, ndf, stride, True)
        nf = 1
        for n in range(1, n_layers):
            prev, nf = nf, min(2 ** n, 8)
            setattr(self, f"conv_{n}", conv(ndf * prev, ndf * nf, stride, False))
            setattr(self, f"norm_{n}", GroupNorm32(ndf * nf))
        prev, nf = nf, min(2 ** n_layers, 8)
        self.conv_last = conv(ndf * prev, ndf * nf, (1, 1), False)
        self.norm_last = GroupNorm32(ndf * nf)
        self.conv_out = conv(ndf * nf, out_channels, (1, 1), True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.conv_in(x), 0.2)
        for n in range(1, self.n_layers):
            h = F.leaky_relu(getattr(self, f"norm_{n}")(getattr(self, f"conv_{n}")(h)), 0.2)
        h = F.leaky_relu(self.norm_last(self.conv_last(h)), 0.2)
        return self.conv_out(h)


class NLayerDiscriminator(_PatchGAN):
    """pix2pix PatchGAN (v0): 4x4 convs, stride 2 then 1, zero padding 1."""

    def __init__(self, in_channels: int = 1, ndf: int = 64, n_layers: int = 3,
                 out_channels: int = 1):
        def conv(cin, cout, stride, bias):
            return nn.Conv2d(cin, cout, 4, stride, padding=1, bias=bias)
        super().__init__(conv, in_channels, ndf, n_layers, out_channels, (2, 2))


class LiDARNLayerDiscriminator(_PatchGAN):
    """LiDAR PatchGAN (v1): circular 4x4 convs padded (1, 2, 1, 2), stride
    (1, 2) then 1."""

    def __init__(self, in_channels: int = 1, ndf: int = 64, n_layers: int = 3,
                 out_channels: int = 1):
        def conv(cin, cout, stride, bias):
            return CircularConv(cin, cout, (4, 4), stride, (1, 2, 1, 2), bias=bias)
        super().__init__(conv, in_channels, ndf, n_layers, out_channels, (1, 2))


DISCRIMINATORS = {"v0": NLayerDiscriminator, "v1": LiDARNLayerDiscriminator}


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real)) + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.softplus(-logits_real)) + torch.mean(F.softplus(logits_fake)))
