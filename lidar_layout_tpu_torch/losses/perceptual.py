"""RangeNet-based perceptual loss for the range-image autoencoders.

Counterpart of ``lidar_layout_tpu/losses/perceptual.py`` (the reference's
PerceptualLoss): channel-normalised L1 between RangeNet decoder features of
the reconstruction and of the input at ``dec_0`` .. ``dec_4``, scaled per
stage by (5.0, 3.39, 2.29, 1.61, 0.895), averaged over space and summed;
``descriptor_weight`` adds the mean squared difference of the depth-
aggregated final logits (the FRID descriptor).

The feature net is frozen: its parameters take no gradient and run in
eval mode (BatchNorm on its running statistics), but the loss
backpropagates through it to the reconstruction. It runs in float32 with
autocast off, as JAX builds it in f32 whatever the AE's dtype. Without
weights it starts from ``rng_seed`` (the reference's pretrained weights
load with ``eval.rangenet.load_reference_weights``).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..eval.rangenet import RangeNet
from ..ops.lidar import LidarGeometry

STAGE_SCALES = (5.0, 3.39, 2.29, 1.61, 0.895)
DEFAULT_STAGES = ("dec_0", "dec_1", "dec_2", "dec_3", "dec_4")


def normalize_channels(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """x over its channel L2 norm (channels last)."""
    return x / (torch.sqrt(torch.sum(x ** 2, dim=-1, keepdim=True)) + eps)


def make_perceptual_fn(geom: LidarGeometry, net: Optional[RangeNet] = None,
                       stages: Sequence[str] = DEFAULT_STAGES, rng_seed: int = 0,
                       stage_scales: Optional[Sequence[float]] = None,
                       descriptor_weight: float = 0.0,
                       device: Optional[torch.device] = None
                       ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """perceptual_fn(inputs, recon) for ``losses.vq_loss.reconstruction_nll``:
    both (B, 1, H, W) model-space range images; the features are computed
    on [metric depth, xyz] as the reference's preprocess does. ``net``
    defaults to a RangeNet-21 drawn from ``rng_seed`` on ``device``."""
    if net is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(rng_seed)
            net = RangeNet(layers=21)
    if device is not None:
        net = net.to(device)
    net = net.eval().requires_grad_(False)
    dev = next(net.parameters()).device
    dirs = torch.as_tensor(geom.ray_dirs(), dtype=torch.float32, device=dev)
    if stage_scales is None:   # a stage subset keeps each stage's own scale
        stage_scales = [STAGE_SCALES[DEFAULT_STAGES.index(s)] for s in stages]

    def preprocess(img: torch.Tensor) -> torch.Tensor:
        depth = (img[:, 0].float() * 0.5 + 0.5) * geom.depth_scale
        if geom.log_scale:
            depth = torch.exp2(depth) - 1.0
        return torch.cat([depth[..., None], dirs * depth[..., None]], dim=-1)

    def perceptual_fn(target: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
        with torch.autocast(dev.type, enabled=False):
            x0, x1 = preprocess(recon), preprocess(target)
            f0 = net(x0, return_features=True)
            with torch.no_grad():
                f1 = net(x1, return_features=True)
            total = recon.new_zeros((), dtype=torch.float32)
            for scale, name in zip(stage_scales, stages):
                diff = (normalize_channels(f1[name]) - normalize_channels(f0[name])).abs()
                total = total + scale * diff.mean(dim=-1).mean()
            if descriptor_weight:
                d0 = net(x0, return_final_logits=True, agg_type="depth")
                with torch.no_grad():
                    d1 = net(x1, return_final_logits=True, agg_type="depth")
                total = total + descriptor_weight * torch.mean((d0 - d1) ** 2)
        return total

    perceptual_fn.net = net
    return perceptual_fn
