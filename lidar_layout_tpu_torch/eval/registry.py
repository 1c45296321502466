"""Frozen feature nets of the perceptual metrics, and ``feature_fn`` for evaluate.

Counterpart of ``lidar_layout_tpu/eval/registry.py``: the ``range``
modality (RangeNet, FRID), and the ``voxel`` (MinkowskiNet, FSVD) and
``point_voxel`` (SPVCNN, FPVD) modalities. The nets load the reference's
pretrained files from ``<weights_root>/<dataset>/<model>/`` when they exist;
without them the metric runs on the same architecture with seeded random
weights, which serves relative comparisons only (and says so).

The voxel modalities follow the JAX package's definition of FSVD/FPVD: each
cloud keeps its first ``MAX_POINTS`` (30000) points, rounded to 0.05 m voxels
shifted to their minimum corner, with features [xyz, -1]; the nets run at
``SEG_NET_CFG`` (cr 0.5, 32768 level-0 voxels, 10-bit codes), so coords past
1023 cells share clipped codes and each level's overflow merges into its
last row (``ops/voxel``); the descriptor's anchors are the level-0 voxel
coords x 0.05 m (``voxel``) or the points (``point_voxel``).
"""
from __future__ import annotations

import hashlib
import os
from typing import Callable, Dict, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.lidar import KITTI_GEOMETRY, NUSCENES_GEOMETRY
from ..utils.convert import load_torchsparse_checkpoint
from ..utils.device import resolve_device
from .device_metrics import in_groups, voxel_feature_inputs
from .rangenet import RangeNet, load_reference_weights, preprocess_range_batch
from .sparse_seg_nets import SPVCNN, MinkowskiNet, SegNetConfig
from .voxel_nets import depth_sector_descriptor

MODALITY2MODEL = {"range": "rangenet", "voxel": "minkowskinet", "point_voxel": "spvcnn"}
# cr 0.5 gives the published 768-wide descriptors (16 sectors x 48)
SEG_NET_CFG = SegNetConfig(cr=0.5, capacity=32768, bits=10)
MAX_POINTS = 30000   # the points of each cloud that FSVD/FPVD keep


def params_hash(net: Union[torch.nn.Module, Dict[str, torch.Tensor]]) -> str:
    """16 hex digits over a net's sorted state_dict (names and f32 values):
    recorded beside random-feature FRID numbers, so two of them are known to
    share one extractor."""
    sd = net.state_dict() if isinstance(net, torch.nn.Module) else net
    h = hashlib.sha256()
    for key in sorted(sd):
        h.update(key.encode())
        h.update(np.ascontiguousarray(sd[key].detach().float().cpu().numpy()).tobytes())
    return h.hexdigest()[:16]


def _weights_dir(weights_root: str, data_type: str, modality: str) -> str:
    return os.path.join(weights_root, "kitti" if data_type == "64" else "nuscenes",
                        MODALITY2MODEL[modality])


def build_range_feature_net(data_type: str = "64", weights_root: str = "./pretrained_weights",
                            device: Union[str, torch.device] = "cuda",
                            seed: int = 0) -> RangeNet:
    """DarkNet21 RangeNet in eval mode on ``device``: the reference's weights
    when they exist, else torch's initialisers under ``seed``."""
    dev = resolve_device(device)
    wdir = _weights_dir(weights_root, data_type, "range")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = RangeNet(layers=21)
    if os.path.isdir(wdir):
        load_reference_weights(net, os.path.join(wdir, "backbone"),
                               os.path.join(wdir, "segmentation_decoder"))
    else:
        print(f"[eval] no pretrained weights at {wdir}: rangenet features are randomly "
              f"initialised (relative comparisons only)")
    return net.to(dev).eval()


def build_voxel_feature_net(data_type: str = "64", modality: str = "voxel",
                            weights_root: str = "./pretrained_weights",
                            device: Union[str, torch.device] = "cuda") -> Callable:
    """The frozen MinkowskiNet (``voxel``) or SPVCNN (``point_voxel``) as
    ``apply_fn(xyz, valid) -> (B, 768)`` descriptors of (B, N, 3) points and
    (B, N) validity (each cloud's first ``MAX_POINTS`` valid points, through
    ``device_metrics.voxel_feature_inputs``), with ``apply_fn.param_hash``
    and ``apply_fn.net``: the reference's ``model.ckpt`` when it exists, else
    torch's initialisers under seed 0. ``build_feature_fn`` and
    ``device_metrics.make_voxel_descriptor_fn`` both run it."""
    dev = resolve_device(device)
    geom = KITTI_GEOMETRY if data_type == "64" else NUSCENES_GEOMETRY
    wdir = _weights_dir(weights_root, data_type, modality)
    cfg = SEG_NET_CFG
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = (SPVCNN if modality == "point_voxel" else MinkowskiNet)(cfg)
    if os.path.isdir(wdir):
        load_torchsparse_checkpoint(net, os.path.join(wdir, "model.ckpt"))
    else:
        print(f"[eval] no pretrained weights at {wdir}: {MODALITY2MODEL[modality]} features "
              f"are randomly initialised (relative comparisons only)")
    net = net.to(dev).eval()

    def apply_fn(xyz: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            vox, pts, fts, msk = voxel_feature_inputs(xyz, valid, MAX_POINTS, cfg.voxel_size)
            out = net(vox, fts, msk, return_final_logits=True)
            anchor = out["coords"].float() * cfg.voxel_size if modality == "voxel" else pts
            return depth_sector_descriptor(anchor, out["logits"], out["mask"],
                                           depth_range=geom.depth_range)

    apply_fn.param_hash = params_hash(net)
    apply_fn.net = net
    return apply_fn


def build_feature_fn(data_type: str = "64", modality: str = "range",
                     weights_root: str = "./pretrained_weights", feat_batch: int = 32,
                     device: Union[str, torch.device] = "cuda") -> Callable:
    """``feature_fn(pcds) -> (B, D)`` descriptors for ``evaluate``, with
    ``feature_fn.param_hash``. Every modality runs in fixed batches of
    ``feat_batch`` (``device_metrics.in_groups``: the last one padded by
    repeating its last input, the pad rows dropped), which bounds the
    activations and keeps each cloud's descriptor apart from the batch it
    rode in."""
    if modality != "range":
        return _voxel_feature_fn(data_type, modality, weights_root, feat_batch, device)
    geom = KITTI_GEOMETRY if data_type == "64" else NUSCENES_GEOMETRY
    net = build_range_feature_net(data_type, weights_root, device)
    dev = next(net.parameters()).device

    def feature_fn(pcds: Sequence[np.ndarray]) -> np.ndarray:
        imgs = torch.from_numpy(preprocess_range_batch(pcds, geom)).to(dev)
        with torch.inference_mode():
            (feats,) = in_groups(
                lambda x: (net(x, return_final_logits=True, agg_type="depth"),), feat_batch, imgs)
        return feats.cpu().numpy()

    feature_fn.param_hash = params_hash(net)
    feature_fn.net = net
    return feature_fn


def pad_clouds(pcds: Sequence[np.ndarray]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged host clouds -> (B, N, 3) f32 points and (B, N) bool validity
    on the CPU: each cloud's first ``MAX_POINTS`` points, zero rows after
    them, as ``range2pcd`` gives the device twin its points."""
    n = min(max(len(p) for p in pcds), MAX_POINTS)
    xyz = np.zeros((len(pcds), n, 3), np.float32)
    valid = np.zeros((len(pcds), n), bool)
    for i, p in enumerate(pcds):
        k = min(len(p), n)
        xyz[i, :k], valid[i, :k] = p[:k, :3], True
    return torch.from_numpy(xyz), torch.from_numpy(valid)


def _voxel_feature_fn(data_type, modality, weights_root, feat_batch, device):
    """The voxel modalities on ragged host clouds, padded (``pad_clouds``)
    and run as the device twin runs them."""
    apply_fn = build_voxel_feature_net(data_type, modality, weights_root, device)
    dev = next(apply_fn.net.parameters()).device

    def feature_fn(pcds: Sequence[np.ndarray]) -> np.ndarray:
        (desc,) = in_groups(lambda x, v: (apply_fn(x, v),), feat_batch,
                            *(t.to(dev) for t in pad_clouds(pcds)))
        return desc.cpu().numpy()

    feature_fn.param_hash = apply_fn.param_hash
    feature_fn.net = apply_fn.net
    return feature_fn
