"""Frozen feature nets of the perceptual metrics, and ``feature_fn`` for evaluate.

Counterpart of ``lidar_layout_tpu/eval/registry.py`` for the ``range``
modality (RangeNet, FRID). The nets load the reference's pretrained files
from ``<weights_root>/<dataset>/<model>/`` when they exist; without them the
metric runs on the same architecture with seeded random weights, which
serves relative comparisons only (and says so). The ``voxel`` and
``point_voxel`` modalities (FSVD, FPVD) wait for the sparse nets.
"""
from __future__ import annotations

import hashlib
import os
from typing import Callable, Dict, Sequence, Union

import numpy as np
import torch

from ..ops.lidar import KITTI_GEOMETRY, NUSCENES_GEOMETRY
from ..utils.device import resolve_device
from .rangenet import RangeNet, load_reference_weights, preprocess_range_batch

MODALITY2MODEL = {"range": "rangenet", "voxel": "minkowskinet", "point_voxel": "spvcnn"}


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


def build_feature_fn(data_type: str = "64", modality: str = "range",
                     weights_root: str = "./pretrained_weights", feat_batch: int = 32,
                     device: Union[str, torch.device] = "cuda") -> Callable:
    """``feature_fn(pcds) -> (B, D)`` descriptors for ``evaluate``, with
    ``feature_fn.param_hash``. The range modality runs in fixed batches of
    ``feat_batch`` (the last one padded by repeating its last image, the pad
    rows dropped), which bounds the activations."""
    if modality != "range":
        raise NotImplementedError(
            f"the {modality} feature net ({MODALITY2MODEL[modality]}) is not ported yet: "
            f'FSVD/FPVD wait for the sparse nets (ROADMAP queue 1, "Main-path remainder")')
    geom = KITTI_GEOMETRY if data_type == "64" else NUSCENES_GEOMETRY
    net = build_range_feature_net(data_type, weights_root, device)
    dev = next(net.parameters()).device

    def feature_fn(pcds: Sequence[np.ndarray]) -> np.ndarray:
        imgs = preprocess_range_batch(pcds, geom)
        out = []
        with torch.inference_mode():
            for i in range(0, len(imgs), feat_batch):
                chunk = imgs[i: i + feat_batch]
                pad = feat_batch - len(chunk)
                if pad:
                    chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
                feats = net(torch.from_numpy(chunk).to(dev), return_final_logits=True,
                            agg_type="depth")
                out.append(feats.cpu().numpy()[: feat_batch - pad])
        return np.concatenate(out)

    feature_fn.param_hash = params_hash(net)
    feature_fn.net = net
    return feature_fn
