"""Evaluation driver over the TESTERS registry.

    python -m lidar_layout_tpu_torch.run_tester -b <config.yaml> --tester ReconTester \\
        [-d <data root>] [-r <run dir>] --n-batches 16 [--synthetic] [--cpu]

Counterpart of ``scripts/run_tester.py``, with its flags: the model from the
YAML (torch's initialisers under seed 0, or the latest checkpoint of a
``train_lidm`` autoencoder run with ``-r``), the KITTI-360 ``RangeImageDataset`` in the
geometry of the YAML's dataset block (seed 0; synthetic scenes with
``--synthetic`` or without scans under ``-d``), ``--n-batches`` batches of
``--batch-size`` through the tester, and the summary printed as one JSON
line. ``ReconTester`` feeds each batch's image to the model and scores its
first output (the reconstruction); every other tester hands the model the
batch as it is, with ``--num-classes``. On the card unless ``--cpu``.
"""
from __future__ import annotations

import argparse
import itertools
import json
from typing import Dict, Optional, Sequence

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-b", "--base", required=True, help="model YAML config")
    p.add_argument("--tester", default="ReconTester",
                   help="SemSegTester | DINOSemSegTester | ClsTester | ClsVotingTester | "
                        "PartSegTester | ReconTester")
    p.add_argument("-d", "--data-root", default=None)
    p.add_argument("-r", "--resume", default=None, help="run dir with ckpt/")
    p.add_argument("--n-batches", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--num-classes", type=int, default=19)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    args = parse_args(argv)
    from .config import instantiate_from_config, load_yaml
    from .data.datasets import RangeImageDataset
    from .eval_ae import load_ae_run
    from .pipeline import geometry_from_config
    from .train.tester import TESTERS
    from .utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = load_yaml(args.base)
    geom = geometry_from_config(cfg)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = instantiate_from_config(cfg["model"])
    if args.resume:
        print(f"loaded step {load_ae_run(model, args.resume)} of {args.resume}")
    model = model.to(device).eval()

    if args.tester == "ReconTester":
        @torch.no_grad()
        def apply_fn(batch):
            out = model(batch["image"].permute(0, 3, 1, 2).float())
            return (out[0] if isinstance(out, tuple) else out).permute(0, 2, 3, 1)

        tester = TESTERS[args.tester](apply_fn)
    else:
        @torch.no_grad()
        def apply_fn(batch):
            return model(batch)

        tester = TESTERS[args.tester](apply_fn, num_classes=args.num_classes)
    ds = RangeImageDataset(None if args.synthetic else args.data_root,
                           batch_size=args.batch_size, geom=geom, seed=0, device=device)
    out = tester.test(itertools.islice(ds.batches(), args.n_batches))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
