"""Train LayoutDiffusion (scene graph -> boxes) from a YAML config, on one CUDA card.

    python -m lidar_layout_tpu_torch.train.train_layout --synthetic --steps 100

Counterpart of ``scripts/train_layout.py`` with its flags: ``-b/--base``
(default ``configs/layout_diffusion/nuscenes/layout_nusc.yaml``),
``-t/--train``, ``-d/--data-root``, ``-r/--resume``, ``-s/--seed``,
``--steps``, ``--workdir``, ``--batch-scenes``, ``--synthetic``, ``--cpu``
and trailing ``a.b.c=value`` overrides. The dataset is built first
(``data/factory``, target ``nusc_layout_graph``: the nuScenes scene graphs
under the root, else synthetic graphs) and its first batch sets the
vocabulary, ``max(max + 1, 32)`` objects and ``max(max + 1, 16)``
predicates; ``lr = scale_lr(base_learning_rate, batch_scenes, 1)``. The step
is ``layout_trainer.make_layout_train_step``, in float32, under the
``Trainer`` with ``IterationTimer``, ``InformationWriter`` and
``CheckpointSaver(max(steps // 5, 1))``. The run directory keeps the config
with the vocabulary it used (``config.yaml``), which
``lidar_layout_tpu_torch.sample_layout -r <run dir>`` reads to sample with
the EMA weights. ``-r`` continues from a run directory's latest checkpoint
(the JAX script parses the flag and does not use it). It runs on CUDA
unless ``--cpu`` is given, and raises when there is no card.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

LAYOUT_DIFFUSION_YAML = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "configs", "layout_diffusion", "nuscenes", "layout_nusc.yaml")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-b", "--base", default=LAYOUT_DIFFUSION_YAML, help="YAML config")
    p.add_argument("-t", "--train", action="store_true")
    p.add_argument("-d", "--data-root", default=None)
    p.add_argument("-r", "--resume", default=None, help="run directory to continue")
    p.add_argument("-s", "--seed", type=int, default=23)
    p.add_argument("--steps", type=int, default=5000)
    p.add_argument("--workdir", default=None)
    p.add_argument("--batch-scenes", type=int, default=None)
    p.add_argument("--synthetic", action="store_true", help="synthetic scene graphs only")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args, unknown = p.parse_known_args(argv)
    bad = [u for u in unknown if "=" not in u]
    if bad:
        p.error(f"unrecognized arguments: {' '.join(bad)}")
    args.overrides = unknown
    return args


def vocab_of(graph) -> dict:
    """The vocabulary a first batch implies: at least 32 objects and 16
    predicates."""
    return {"num_objs": int(max(np.max(graph["enc_objs"]) + 1, 32)),
            "num_preds": int(max(np.max(graph["enc_triples"][:, 1]) + 1, 16))}


def main(argv=None):
    args = parse_args(argv)

    from ..config import apply_dotlist, instantiate_from_config, load_yaml
    from ..utils.init import jax_init_
    from ..data.factory import build_batches
    from ..utils.device import resolve_device
    from .checkpoint import restore_checkpoint
    from .layout_trainer import create_layout_train_state, make_layout_train_step
    from .lr_schedule import scale_lr
    from .trainer import CheckpointSaver, InformationWriter, IterationTimer, Trainer

    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = load_yaml(args.base)
    if args.overrides:
        apply_dotlist(cfg, args.overrides)
        print(f"dotlist overrides: {args.overrides}")
    model_cfg = cfg["model"]
    data_cfg = cfg.get("data", {}).get("params", {})
    train_blk = data_cfg.get("train", {"target": "nusc_layout_graph", "params": {}})
    batch_scenes = args.batch_scenes or data_cfg.get("batch_size", 8)
    name = os.path.splitext(os.path.basename(args.base))[0]
    workdir = args.workdir or f"./runs/{name}"

    # the dataset first: its vocabulary sizes the scene-graph encoder
    batches = build_batches(train_blk.get("target", "nusc_layout_graph"),
                            train_blk.get("params") or {}, data_cfg.get("dataset", {}),
                            args.data_root, batch_scenes, seed=args.seed,
                            force_synthetic=args.synthetic)
    g0 = next(batches)
    model_cfg.setdefault("params", {})["vocab"] = vocab_of(g0)
    # n_scenes sizes the per-scene t: one value for the run, as JAX's closure
    n_scenes = int(g0.get("n_scenes", batch_scenes))

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = jax_init_(instantiate_from_config(model_cfg).to(device), args.seed)
    lr = scale_lr(model_cfg.get("base_learning_rate", 1e-6), batch_scenes, 1)
    state = create_layout_train_state(model, lr)
    if args.resume:
        restore_checkpoint(os.path.join(args.resume, "ckpt"), state)
        print(f"resumed from {args.resume} at step {state.step}")
    print(f"LayoutDiffusion: {sum(p.numel() for p in state.params.values())} parameters, "
          f"vocab {model_cfg['params']['vocab']}, {batch_scenes} scenes a batch, lr {lr:g}, "
          f"on {device}")

    def graphs():
        for g in batches:
            yield {**g, "n_scenes": n_scenes}

    trainer = Trainer(make_layout_train_step(model), state, graphs(), workdir=workdir,
                      max_steps=args.steps,
                      hooks=[IterationTimer(), InformationWriter(),
                             CheckpointSaver(max(args.steps // 5, 1))],
                      seed=args.seed)
    import yaml

    with open(os.path.join(workdir, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    trainer.train()
    print(f"done -> {workdir}")
    return trainer


if __name__ == "__main__":
    main()
