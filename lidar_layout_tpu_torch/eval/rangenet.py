"""RangeNet++ (DarkNet21 U-Net): the FRID feature extractor.

Counterpart of ``lidar_layout_tpu/eval/rangenet.py``: a 5-stage DarkNet
encoder whose strides halve only the azimuth axis, a ConvTranspose decoder
with additive skips, LeakyReLU(0.1), BatchNorm with running statistics. The
FRID descriptor is the decoder's last feature map pooled into
``num_sectors`` row bands ("depth" aggregation).

The module has the reference's two parts under their torch names,
``backbone`` (``conv1``, ``bn1``, ``enc{i}.conv``, ``enc{i}.bn``,
``enc{i}.residual_{j}.*``) and ``decoder`` (``dec{i}.upconv``, ``dec{i}.bn``,
``dec{i}.residual.*``), so the reference's ``backbone`` and
``segmentation_decoder`` files load as they are (``load_reference_weights``).
It runs NCHW inside and keeps the JAX package's (B, H, W, C) at its input
and outputs.
"""
from __future__ import annotations

import warnings
from collections import OrderedDict
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

MODEL_BLOCKS = {21: [1, 1, 2, 2, 1], 53: [1, 2, 8, 8, 4]}
ENC_PLANES = [(32, 64), (64, 128), (128, 256), (256, 512), (512, 1024)]
DEC_PLANES = [(1024, 512), (512, 256), (256, 128), (128, 64), (64, 32)]


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5)


class BasicBlock(nn.Module):
    """1x1 conv to planes[0], 3x3 conv to planes[1], each BN + LeakyReLU,
    added to the input."""

    def __init__(self, inplanes: int, planes: Tuple[int, int]):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes[0], 1, bias=False)
        self.bn1 = _bn(planes[0])
        self.relu1 = nn.LeakyReLU(0.1)
        self.conv2 = nn.Conv2d(planes[0], planes[1], 3, padding=1, bias=False)
        self.bn2 = _bn(planes[1])
        self.relu2 = nn.LeakyReLU(0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.relu1(self.bn1(self.conv1(x)))
        return x + self.relu2(self.bn2(self.conv2(h)))


class Backbone(nn.Module):
    def __init__(self, layers: int = 21, in_channels: int = 4):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 32, 3, padding=1, bias=False)
        self.bn1 = _bn(32)
        self.relu1 = nn.LeakyReLU(0.1)
        for i, (p, blocks) in enumerate(zip(ENC_PLANES, MODEL_BLOCKS[layers])):
            stage = [("conv", nn.Conv2d(p[0], p[1], 3, stride=(1, 2), padding=1, bias=False)),
                     ("bn", _bn(p[1])), ("relu", nn.LeakyReLU(0.1))]
            stage += [(f"residual_{j}", BasicBlock(p[1], p)) for j in range(blocks)]
            self.add_module(f"enc{i + 1}", nn.Sequential(OrderedDict(stage)))


class Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        for i, p in enumerate(DEC_PLANES):
            # doubles W: the flax ConvTranspose((1, 4), (1, 2), "SAME") with
            # its kernel flipped along W (utils/convert.rangenet_state_dict)
            stage = [("upconv", nn.ConvTranspose2d(p[0], p[1], (1, 4), stride=(1, 2),
                                                   padding=(0, 1))),
                     ("bn", _bn(p[1])), ("relu", nn.LeakyReLU(0.1)),
                     ("residual", BasicBlock(p[1], p))]
            self.add_module(f"dec{5 - i}", nn.Sequential(OrderedDict(stage)))


class RangeNet(nn.Module):
    """Input (B, H, W, C) with channels [range, x, y, z(, remission)]."""

    def __init__(self, layers: int = 21, in_channels: int = 4, num_sectors: int = 16):
        super().__init__()
        self.num_sectors = num_sectors
        self.backbone = Backbone(layers, in_channels)
        self.decoder = Decoder()

    def forward(self, x: torch.Tensor, return_final_logits: bool = False,
                agg_type: str = "depth", return_features: bool = False):
        bb = self.backbone
        h = bb.relu1(bb.bn1(bb.conv1(x.permute(0, 3, 1, 2))))
        features: Dict[str, torch.Tensor] = {}
        skips: Dict[int, torch.Tensor] = {}
        os = 1
        for i in range(5):
            y = getattr(bb, f"enc{i + 1}")(h)
            skips[os] = h
            os *= 2
            h = y
            features[f"enc_{i}"] = h
        for i in range(5):
            h = getattr(self.decoder, f"dec{5 - i}")(h)
            os //= 2
            h = h + skips[os]
            features[f"dec_{4 - i}"] = h
        if return_features:
            return {k: v.permute(0, 2, 3, 1) for k, v in features.items()}
        if not return_final_logits:
            return h.permute(0, 2, 3, 1)          # (B, H, W, 32) pre-dropout features

        b, c, hh, ww = h.shape
        n = self.num_sectors
        if agg_type == "all":
            return h.mean(dim=(2, 3))
        if agg_type == "sector":                  # column bands
            out = h.reshape(b, c, hh, n, ww // n).mean(dim=(2, 4))
        elif agg_type == "depth":                 # row bands
            out = h.reshape(b, c, n, hh // n, ww).mean(dim=(3, 4))
        else:
            raise NotImplementedError(agg_type)
        return out.transpose(1, 2).reshape(b, -1)  # (B, n * C), band-major


def preprocess_range_batch(pcds: Sequence[np.ndarray], geom) -> np.ndarray:
    """Clouds -> (B, H, W, 4) [depth, x, y, z] images, metric depth (not log
    scale), nearest return per pixel. Host numpy: eval clouds are ragged."""
    h, w = geom.size
    lo, hi = geom.depth_range
    dirs = geom.ray_dirs().astype(np.float32)  # (H, W, 3)
    big = np.float32(np.finfo(np.float32).max)

    out = np.empty((len(pcds), h, w, 4), np.float32)
    for i, pcd in enumerate(pcds):
        p = np.asarray(pcd, np.float32)[:, :3]
        depth = np.linalg.norm(p, axis=-1)
        yaw = -np.arctan2(p[:, 1], p[:, 0])
        pitch = np.arcsin(np.where(depth > 0, p[:, 2] / np.maximum(depth, 1e-8), 0.0))
        px = 0.5 * (yaw / np.pi + 1.0)
        py = 1.0 - (pitch + abs(geom.fov_down)) / geom.fov_range
        valid = (depth > lo) & (depth < hi)
        xi = np.clip(np.floor(px * w), 0, w - 1).astype(np.int64)
        yi = np.clip(np.floor(py * h), 0, h - 1).astype(np.int64)
        pix = np.where(valid, yi * w + xi, h * w)

        img = np.full(h * w + 1, big, np.float32)
        np.minimum.at(img, pix, np.where(valid, depth, big).astype(np.float32))
        img = np.where(img[: h * w] < big, img[: h * w], -1.0).reshape(h, w)

        v = (img > lo) & (img < hi)
        out[i, ..., 0] = img
        out[i, ..., 1:] = np.where(v[..., None], dirs * img[..., None], -1.0)
    return out


def load_reference_weights(net: RangeNet, backbone_path: str, decoder_path: str) -> RangeNet:
    """Load the reference's ``backbone`` and ``segmentation_decoder`` torch
    state dicts into ``net``. Raises KeyError if any parameter or running
    statistic of ``net`` is missing from the files (``num_batches_tracked``,
    which eval mode never reads, may be absent); warns on keys it does not
    use."""
    sd = {f"backbone.{k}": v for k, v in
          torch.load(backbone_path, map_location="cpu", weights_only=True).items()}
    sd.update({f"decoder.{k}": v for k, v in
               torch.load(decoder_path, map_location="cpu", weights_only=True).items()})
    result = net.load_state_dict(sd, strict=False)
    missing = [k for k in result.missing_keys if not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"RangeNet weights missing from {backbone_path} / {decoder_path}: "
                       f"{missing[:8]}{' ...' if len(missing) > 8 else ''} "
                       f"({len(missing)} in all)")
    if result.unexpected_keys:
        warnings.warn(f"RangeNet weight files hold {len(result.unexpected_keys)} keys the "
                      f"network does not use: {result.unexpected_keys[:8]}")
    return net
