"""Autoencoder reconstruction evaluation: validation batches -> reconstruct ->
reproject -> CD / EMD / JSD / MMD between the inputs' and the
reconstructions' clouds.

    python -m lidar_layout_tpu_torch.eval_ae -b <config.yaml> [-r <run dir>] \\
        [-d <data root>] -n 4 --metrics cd jsd [--cpu]

Counterpart of ``scripts/eval_ae.py``, with its behaviour:

- the geometry is ``KITTI_GEOMETRY`` and the dataset the KITTI-360
  ``RangeImageDataset`` (validation split, the YAML's batch size), whatever
  the YAML's dataset block says; without scans under ``-d`` the batches
  are synthetic scenes. Scores are ``evaluate(..., "64")``;
- ``-r`` loads the model's weights from a ``train_lidm`` run directory (the
  latest checkpoint under ``<run>/ckpt``; the discriminator's ``loss.*``
  entries are skipped); without it the AE keeps its initial weights (torch's
  initialisers under seed 0) and a warning says so;
- a ``use_mask`` model's reconstruction goes through ``apply_raydrop``.

CD runs through K4 (``ops/chamfer``) on the card. The result prints as one
JSON line, each value rounded to 6 places.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-b", "--base", required=True, help="the autoencoder's YAML")
    p.add_argument("-r", "--resume", default=None, help="a train_lidm run directory")
    p.add_argument("-d", "--data-root", default=None)
    p.add_argument("-n", "--n-batches", type=int, default=4)
    p.add_argument("--metrics", nargs="+", default=["cd", "jsd"])
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    return p.parse_args(argv)


def load_ae_run(model: torch.nn.Module, run_dir: str) -> int:
    """The latest checkpoint of a ``train_lidm`` AE run into ``model``;
    returns its step."""
    from .train.checkpoint import latest_run_weights

    step, sd = latest_run_weights(run_dir, key="state_dict")
    model.load_state_dict({k: v for k, v in sd.items() if not k.startswith("loss.")})
    return step


@torch.no_grad()
def reconstruct(model, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) images -> (B, H, W, 1) reconstructions, ray-drop applied
    when the model has the mask head."""
    from .models.autoencoder import apply_raydrop

    dec = model(x.permute(0, 3, 1, 2).float())[0]
    dec = apply_raydrop(dec) if model.use_mask else dec
    return dec.permute(0, 2, 3, 1)


def reconstruction_clouds(model, batches, geom, n_batches: int
                          ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """The inputs' and the reconstructions' reprojected clouds over
    ``n_batches`` batches."""
    from .ops.lidar import range2pcd

    gt, rec = [], []
    for _ in range(n_batches):
        x = next(batches)["image"]
        for imgs, acc in ((x, gt), (reconstruct(model, x), rec)):
            xyz, valid = (t.cpu().numpy() for t in range2pcd(imgs[..., 0], geom))
            acc.extend(p[v] for p, v in zip(xyz, valid))
    return gt, rec


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    args = parse_args(argv)
    from .config import instantiate_from_config, load_yaml
    from .data.datasets import RangeImageDataset
    from .eval.metrics import evaluate
    from .ops.lidar import KITTI_GEOMETRY
    from .utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = load_yaml(args.base)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = instantiate_from_config(cfg["model"])
    geom = KITTI_GEOMETRY
    ds = RangeImageDataset(args.data_root, split="val",
                           batch_size=cfg["data"]["params"].get("batch_size", 4), geom=geom,
                           device=device)
    if args.resume:
        load_ae_run(model, args.resume)
        print(f"loaded weights from {args.resume}")
    else:
        print("WARNING: evaluating randomly initialized AE")
    model = model.to(device).eval()
    gt, rec = reconstruction_clouds(model, ds.batches(shuffle=False), geom, args.n_batches)
    out = evaluate(gt, rec, args.metrics, "64", device=device)
    print(json.dumps({k: round(v, 6) for k, v in out.items()}))
    return out


if __name__ == "__main__":
    main()
