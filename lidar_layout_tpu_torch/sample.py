"""Sample a latent-diffusion model and, optionally, evaluate the samples.

    python -m lidar_layout_tpu_torch.sample -b configs/lidar_diffusion/kitti/uncond_c2_p4.yaml \\
        -n 32 --batch 16 --sampler dpm --steps 20 --bf16 --eval --metrics cd,jsd,mmd,frid,fsvd,fpvd

Counterpart of ``scripts/sample.py`` with the same flags (``-b -r -d -n
--batch --steps --eta --sampler --eval -f --metrics --data-root
--weights-root --outdir --bf16 --html``) and outputs (``samples_range.npy``,
``samples_pcd.npz``, ``eval.json``, ``viewer.html``); ``--cpu`` runs on the
CPU. The
evaluation scores the samples against an equal reference set, real scans
under ``--data-root`` or else synthetic scenes, each range-roundtripped
(``pcd2range`` -> ``process_scan`` -> ``range2pcd``) as the reference's
``example['reproj']`` is. ``evaluate_samples`` is that step as a function.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .eval.metrics import evaluate
from .ops import lidar as L
from .utils.device import resolve_device

MODALITIES = {"frid": "range", "fsvd": "voxel", "fpvd": "point_voxel"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-b", "--base", required=True, help="model YAML config")
    p.add_argument("-r", "--resume", default=None, help="run directory with ckpt/")
    p.add_argument("-d", "--dataset", default="64", choices=["32", "64"])
    p.add_argument("-n", "--n-samples", type=int, default=16)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--eta", type=float, default=0.0)
    p.add_argument("--sampler", default="ddim", choices=["ddim", "plms", "ddpm", "dpm"])
    p.add_argument("--eval", action="store_true")
    p.add_argument("-f", "--file", default=None,
                   help="evaluate these pre-generated samples instead of sampling: an "
                        ".npz of clouds or an .npy of range images")
    p.add_argument("--metrics", default="jsd,mmd,frid",
                   help="comma list of cd,emd,jsd,mmd,frid,fsvd,fpvd")
    p.add_argument("--data-root", default=None, help="real scans for the reference set")
    p.add_argument("--weights-root", default="./pretrained_weights")
    p.add_argument("--outdir", default="./samples")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--html", action="store_true",
                   help="also write an interactive viewer.html of the first 16 samples")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    return p.parse_args(argv)


def load_reference(n: int, data_root: Optional[str] = None) -> List[np.ndarray]:
    """``n`` raw reference clouds: KITTI-360, SemanticKITTI or nuScenes
    validation scans under ``data_root``, else synthetic scenes (then the
    metrics serve relative comparisons only, and it says so)."""
    if data_root and os.path.isdir(data_root):
        from .data.datasets import (list_kitti360_scans, list_semantic_kitti_scans,
                                    read_velodyne_bin)
        from .data.readers import list_nuscenes_sweeps, read_nuscenes_bin

        files = list_kitti360_scans(data_root, "val") or list_semantic_kitti_scans(data_root,
                                                                                   "val")
        reader = read_velodyne_bin
        if not files:
            files, reader = list_nuscenes_sweeps(data_root, "val", "samples"), read_nuscenes_bin
        if files:
            return [reader(f)[:, :3] for f in files[:n]]
    from .data.synthetic import synthetic_scene

    print("[eval] no --data-root scans found: synthetic reference set (relative "
          "comparisons only, not the published tables)")
    return [synthetic_scene(np.random.default_rng(i)) for i in range(n)]


def range_roundtrip(clouds: Sequence[np.ndarray], geom: L.LidarGeometry,
                    device: Union[str, torch.device] = "cuda", batch: int = 16
                    ) -> List[np.ndarray]:
    """Each cloud through ``pcd2range`` -> ``process_scan`` -> ``range2pcd`` on
    ``device``, ``batch`` clouds at a time, zero-padded to the longest."""
    dev = resolve_device(device)
    out: List[np.ndarray] = []
    for i in range(0, len(clouds), batch):
        part = clouds[i:i + batch]
        cap = max(len(p) for p in part)
        pts = np.zeros((len(part), cap, 3), np.float32)
        mask = np.zeros((len(part), cap), bool)
        for j, p in enumerate(part):
            pts[j, :len(p)] = p[:, :3]
            mask[j, :len(p)] = True
        with torch.inference_mode():
            img, _ = L.pcd2range(torch.from_numpy(pts).to(dev), geom,
                                 mask=torch.from_numpy(mask).to(dev))
            model_img, _ = L.process_scan(img, geom)
            xyz, valid = (t.cpu().numpy() for t in L.range2pcd(model_img, geom))
        out.extend(x[v] for x, v in zip(xyz, valid))
    return out


def evaluate_samples(samples: Sequence[np.ndarray], reference: Sequence[np.ndarray],
                     metrics: Sequence[str], device: Union[str, torch.device] = "cuda",
                     feature_fn=None, data_type: str = "64",
                     geom: Optional[L.LidarGeometry] = None,
                     verbose: bool = False) -> Dict[str, float]:
    """Score ``samples`` against the range-roundtripped ``reference`` clouds:
    ``evaluate`` with CD and EMD on ``device``; ``feature_fn`` (or a dict of
    them by metric) gives the FRID features."""
    geom = geom or (L.KITTI_GEOMETRY if data_type == "64" else L.NUSCENES_GEOMETRY)
    ref = range_roundtrip(reference, geom, device)
    return evaluate(ref, samples, metrics, data_type, feature_fn=feature_fn, verbose=verbose,
                    device=device)


def _load_samples(path: str, geom: L.LidarGeometry, device: torch.device) -> List[np.ndarray]:
    if path.endswith(".npz"):
        data = np.load(path)
        return [np.asarray(data[k], np.float32) for k in sorted(data.files)]
    if path.endswith(".npy"):
        imgs = torch.from_numpy(np.load(path)[..., 0]).to(device)
        xyz, valid = (t.cpu().numpy() for t in L.range2pcd(imgs, geom))
        return [x[v] for x, v in zip(xyz, valid)]
    raise SystemExit(f"unsupported sample file {path!r} (.npz of clouds or .npy of "
                     "range images)")


def main(argv=None) -> Dict[str, float]:
    args = parse_args(argv)
    from .config import load_yaml
    from .pipeline import GenerationPipeline, geometry_from_config

    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = load_yaml(args.base)
    geom = geometry_from_config(cfg, args.dataset)
    if args.file:
        samples = _load_samples(args.file, geom, device)
        print(f"loaded {len(samples)} pre-generated samples from {args.file}")
    else:
        kw = dict(dataset=args.dataset, bf16=args.bf16, device=device,
                  sampler=args.sampler, steps=args.steps, eta=args.eta)
        if args.resume:
            pipe = GenerationPipeline.from_run_dir(args.resume, base_config=args.base, **kw)
            print(f"loaded EMA weights from {args.resume}")
        else:
            pipe = GenerationPipeline.from_config(cfg, **kw)
            print("WARNING: sampling from randomly initialised weights")
        t0 = time.perf_counter()
        res = pipe.generate(args.n_samples, seed=42, batch=args.batch)
        print(f"{args.n_samples} samples in {time.perf_counter() - t0:.1f} s "
              f"({res.samples_per_sec:.2f} samples/s; phases {res.phase_seconds})")
        os.makedirs(args.outdir, exist_ok=True)
        np.save(os.path.join(args.outdir, "samples_range.npy"), res.images)
        np.savez(os.path.join(args.outdir, "samples_pcd.npz"),
                 **{f"pcd_{i}": p for i, p in enumerate(res.clouds)})
        print(f"wrote {len(res.images)} samples to {args.outdir}")
        samples = res.clouds
    if args.html:
        from .utils.vis import save_scene_grid_html

        out = save_scene_grid_html(os.path.join(args.outdir, "viewer.html"), samples[:16])
        print(f"interactive viewer: {out}")
    if not args.eval:
        return {}

    from .eval.registry import build_feature_fn

    metrics = [m.strip() for m in args.metrics.split(",") if m.strip()]
    feature_fn = {m: build_feature_fn(args.dataset, MODALITIES[m], args.weights_root,
                                      device=device)
                  for m in metrics if m in MODALITIES}
    out = evaluate_samples(samples, load_reference(len(samples), args.data_root), metrics,
                           device, feature_fn, args.dataset, geom, verbose=True)
    print(json.dumps(out))
    os.makedirs(args.outdir, exist_ok=True)
    with open(os.path.join(args.outdir, "eval.json"), "w") as f:
        json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
