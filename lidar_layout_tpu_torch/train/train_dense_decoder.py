"""Train the Gaussian-surfel dense decoder ("Ours" stage 3) on one CUDA card.

    python -m lidar_layout_tpu_torch.train.train_dense_decoder \\
        -b configs/ours/nuscenes/dense_decoder/gaus_10cm.yaml --synthetic --steps 100
    python -m lidar_layout_tpu_torch.train.train_dense_decoder --cpu --synthetic --tiny --steps 2

Counterpart of ``scripts/train_dense_decoder.py`` with its flags:
``-b/--base`` (default ``gaus_10cm.yaml``), ``-d/--data-root``, ``--steps``,
``--workdir``, ``--n-points`` (8192), ``--batch-size`` (1), ``-s/--seed``,
``--tiny`` (PT-v3 16/32 wide, one block a level, patch 64, a 16x64 image,
512 points, chunk 128), ``--synthetic``, ``--cpu`` and trailing
``a.b.c=value`` overrides. One cloud a step: the batch's first cloud, its
ground-truth range from ``pcd2range`` unless the batch has a
``range_img``. The model is ``dense_decoder`` from the YAML, built once the
first batch gives the width of its ``feats`` (4; the YAML says 3), under
``--seed``; it renders through ``RasterConfig(chunk=512)`` (128 tiny) and
trains on ``gs_loss`` with ``clip_by_global_norm(1.0)`` then AdamW at the
YAML's ``lr`` and ``weight_decay``, as the JAX script does: the YAML's
``scheduler`` and ``batch_size`` are not read, and the step runs with drop
path and order shuffling off (JAX's ``DenseDecoder`` takes no
``deterministic``). The hooks are ``IterationTimer``, ``InformationWriter``
and ``CheckpointSaver(max(steps // 5, 1))``. It runs on CUDA unless
``--cpu`` is given, and raises when there is no card.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Dict

import torch

DEFAULT_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "configs", "ours", "nuscenes", "dense_decoder", "gaus_10cm.yaml")
TINY_BACKBONE = dict(enc_depths=[1, 1], enc_channels=[16, 32], enc_num_head=[2, 4],
                     enc_patch_size=[64, 64], dec_depths=[1], dec_channels=[16],
                     dec_num_head=[2], drop_path=0.0)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-b", "--base", default=DEFAULT_CONFIG, help="YAML config")
    p.add_argument("-d", "--data-root", default=None)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--workdir", default=None)
    p.add_argument("--n-points", type=int, default=8192)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="shrink backbone + geometry for smoke runs")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args, unknown = p.parse_known_args(argv)
    bad = [u for u in unknown if "=" not in u]
    if bad:
        p.error(f"unrecognized arguments: {' '.join(bad)}")
    args.overrides = unknown
    return args


@dataclasses.dataclass
class DenseTrainState:
    model: torch.nn.Module
    optimizer: object   # diffusion_trainer.Optimizer
    step: int = 0

    def state_dict(self) -> Dict:
        return {"state_dict": self.model.state_dict(), "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, ckpt: Dict) -> None:
        self.model.load_state_dict(ckpt["state_dict"])
        self.optimizer.load_state_dict(ckpt["optimizer"])


def create_dense_state(model: torch.nn.Module, lr: float, weight_decay: float
                       ) -> DenseTrainState:
    """``chain(clip_by_global_norm(1.0), adamw(lr, weight_decay))`` over every
    parameter."""
    from .diffusion_trainer import Optimizer

    return DenseTrainState(model, Optimizer(dict(model.named_parameters()), lr,
                                            weight_decay=weight_decay, grad_clip=1.0))


def dense_geometry(dset_cfg: Dict):
    """The render geometry of a config's dataset block (nuScenes' 32x1024
    defaults)."""
    from ..ops.lidar import LidarGeometry

    return LidarGeometry(size=tuple(dset_cfg.get("size", (32, 1024))),
                         fov=tuple(dset_cfg.get("fov", (10, -30))),
                         depth_range=tuple(dset_cfg.get("depth_range", (1.0, 56.0))),
                         depth_scale=dset_cfg.get("depth_scale", 5.84),
                         log_scale=dset_cfg.get("log_scale", True))


def to_sample(batch: Dict[str, torch.Tensor], geom) -> Dict[str, torch.Tensor]:
    """The batch's first cloud with its ground truth: ``gt_range`` (the
    batch's ``range_img``, else ``pcd2range`` of the cloud), 0 where
    ``gt_mask`` (a return) is False."""
    from ..ops.lidar import pcd2range

    pts, feats, mask = batch["points"][0], batch["feats"][0], batch["mask"][0]
    gt = batch["range_img"][0] if "range_img" in batch else pcd2range(pts, geom, mask=mask)[0]
    gt_mask = gt > 0
    return {"points": pts, "feats": feats, "mask": mask,
            "gt_range": torch.where(gt_mask, gt, 0.0), "gt_mask": gt_mask}


def make_dense_train_step(model: torch.nn.Module, geom, raster_cfg,
                          timed: bool = False) -> Callable:
    """step(state, sample, generator) -> (state, logs): surfels, render,
    ``gs_loss`` (``loss``, ``loss_range``, ``loss_raydrop``, 0-d tensors),
    the gradient of every parameter, one update. With ``timed`` the device
    is synchronised at the phase boundaries and ``seconds_ptv3`` (PT-v3, the
    neck and the surfel heads), ``seconds_raster``, ``seconds_backward``
    (the loss and the backward) and ``seconds_opt`` are added."""
    from ..models.gs_decoder import gs_loss, render_surfels

    params = list(model.parameters())
    dev = params[0].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def step(state: DenseTrainState, sample: Dict[str, torch.Tensor], generator):
        marks = []

        def mark():
            if timed:
                sync()
                marks.append(time.perf_counter())

        model.train()
        mark()
        surfels = model(sample["points"], sample["feats"], sample["mask"])
        mark()
        render = render_surfels(surfels, geom, raster_cfg)
        mark()
        loss, logs = gs_loss(render, sample["gt_range"], sample["gt_mask"])
        grads = list(torch.autograd.grad(loss, params))
        mark()
        state.optimizer.step(grads)
        state.step += 1
        mark()
        logs = {k: v.detach() for k, v in logs.items()}
        if timed:
            for name, (a, b) in zip(("ptv3", "raster", "backward", "opt"),
                                    zip(marks, marks[1:])):
                logs[f"seconds_{name}"] = b - a
        return state, logs

    return step


def main(argv=None):
    args = parse_args(argv)

    from ..config import apply_dotlist, instantiate_from_config, load_yaml
    from ..utils.init import jax_init_
    from ..data.factory import build_batches
    from ..ops.gaussian_raster import RasterConfig
    from ..ops.lidar import LidarGeometry
    from ..utils.device import resolve_device
    from .trainer import CheckpointSaver, InformationWriter, IterationTimer, Trainer

    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = load_yaml(args.base)
    if args.overrides:
        apply_dotlist(cfg, args.overrides)
        print(f"dotlist overrides: {args.overrides}")
    model_cfg = cfg["model"]
    data_cfg = cfg.get("data", {}).get("params", {})
    dset_cfg = data_cfg.get("dataset", {})
    name = os.path.splitext(os.path.basename(args.base))[0]
    workdir = args.workdir or f"./runs/{name}"
    if args.tiny:
        model_cfg["params"]["backbone"]["params"].update(TINY_BACKBONE)
        model_cfg["params"]["head"] = {"params": {"feat_dim": 16}}
        geom = LidarGeometry(size=(16, 64), fov=(10, -30))
        n_pts = 512
    else:
        geom = dense_geometry(dset_cfg)
        n_pts = args.n_points
    raster_cfg = RasterConfig(chunk=128 if args.tiny else 512)

    train_blk = data_cfg.get("train", {"target": "nusc_cube_decode", "params": {}})
    blk_params = dict(train_blk.get("params", {}))
    blk_params.setdefault("max_points", n_pts)
    blk_params.setdefault("transform", data_cfg.get("transform"))
    raw = build_batches(train_blk.get("target", "nusc_cube_decode"), blk_params, dset_cfg,
                        args.data_root, args.batch_size or 1, seed=args.seed,
                        force_synthetic=args.synthetic, device=device)
    b0 = to_sample(next(raw), geom)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = jax_init_(instantiate_from_config(
            model_cfg, in_features=b0["feats"].shape[-1]).to(device), args.seed)
    opt_cfg = cfg.get("optimizer", {})
    state = create_dense_state(model, opt_cfg.get("lr", 1e-4), opt_cfg.get("weight_decay", 1e-2))
    trainer = Trainer(make_dense_train_step(model, geom, raster_cfg), state,
                      (to_sample(b, geom) for b in raw), workdir=workdir, max_steps=args.steps,
                      hooks=[IterationTimer(), InformationWriter(),
                             CheckpointSaver(max(args.steps // 5, 1))],
                      seed=args.seed)
    trainer.train()
    print(f"done -> {workdir}")
    return trainer


if __name__ == "__main__":
    main()
