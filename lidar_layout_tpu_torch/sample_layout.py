"""Sample object layouts (3-D boxes) from scene graphs with LayoutDiffusion.

    python -m lidar_layout_tpu_torch.sample_layout -n 16 --steps 100 --outdir ./samples_layout

Counterpart of ``scripts/sample_layout.py`` with its flags (``-r/--resume
-n/--n-scenes --steps --outdir -s/--seed``) and output: ``layouts.npz`` with
``boxes`` (N, 7) [size3, loc3, yaw], ``scene_ids``, ``classes`` and
``obj_mask``. ``--cpu`` runs on the CPU. The model is built from
``configs/layout_diffusion/nuscenes/layout_nusc.yaml`` (``-b`` for another)
with the vocabulary {32 objects, 16 predicates} injected, as the training
script injects its dataset's. ``--resume`` takes a run directory of
``train.train_layout``, whose saved config (with the vocabulary the trainer
injected) builds the model and whose latest checkpoint gives the EMA
weights, as the JAX script samples with its run's EMA; or a ``.pt`` file
holding the model's state_dict (``utils/convert.layout_diffusion_state_dict``
makes one from a JAX tree). Without it the weights are random, from
``--seed``. The scene graphs are synthetic (``data/layout_synthetic``), at
the nuScenes dataset's capacity of 16 objects and 32 triples a scene.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

LAYOUT_DIFFUSION_YAML = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "layout_diffusion", "nuscenes", "layout_nusc.yaml")
VOCAB = {"num_objs": 32, "num_preds": 16}
MAX_OBJS, MAX_TRIPLES = 16, 32    # a scene's capacity in the nuScenes layout dataset


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-b", "--base", default=LAYOUT_DIFFUSION_YAML, help="model YAML config")
    p.add_argument("-r", "--resume", default=None,
                   help="a train_layout run directory, or a state_dict .pt file")
    p.add_argument("-n", "--n-scenes", type=int, default=4)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--outdir", default="./samples_layout")
    p.add_argument("-s", "--seed", type=int, default=42)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    return p.parse_args(argv)


def build_model(base: str = LAYOUT_DIFFUSION_YAML, device: Union[str, torch.device] = "cuda",
                seed: int = 0):
    """The LayoutDiffusion of ``base`` on ``device`` in eval mode, with
    torch's initial weights under ``seed``; the vocabulary is the config's
    (a training run's) or ``VOCAB``."""
    from .config import instantiate_from_config, load_yaml
    from .utils.device import resolve_device

    dev = resolve_device(device)
    cfg = load_yaml(base)["model"]
    cfg.setdefault("params", {}).setdefault("vocab", dict(VOCAB))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = instantiate_from_config(cfg)
    return model.to(dev).eval()


def sample_layouts(model, graph: Dict[str, np.ndarray], steps: int = 100, seed: int = 0,
                   x_T: Optional[torch.Tensor] = None) -> Dict[str, np.ndarray]:
    """One request: DDIM over every box of ``graph`` and the boxes back in
    [size3, loc3, yaw]; the change noise and x_T from a generator seeded
    with ``seed`` on the model's device (or the given ``x_T``)."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    boxes8 = model.ddim_sample(graph, steps=steps, x_T=x_T, generator=gen)
    return {"boxes": model.postprocess_boxes(boxes8).cpu().numpy(),
            "scene_ids": np.asarray(graph["dec_objs_to_scene"]),
            "classes": np.asarray(graph["dec_objs"]),
            "obj_mask": np.asarray(graph["obj_mask"])}


def load_run_ema(model, run_dir: str) -> int:
    """The EMA weights of the latest checkpoint of a ``train_layout`` run
    into ``model``; returns the checkpoint's step."""
    from .train.checkpoint import latest_run_weights

    step, sd = latest_run_weights(run_dir, use_ema=True)
    model.load_state_dict(sd)
    return step


def main(argv=None):
    from .data.layout_synthetic import synthetic_graph_batch

    args = parse_args(argv)
    run_dir = args.resume if args.resume and os.path.isdir(args.resume) else None
    base = args.base
    if run_dir and os.path.isfile(os.path.join(run_dir, "config.yaml")):
        base = os.path.join(run_dir, "config.yaml")   # the vocabulary the trainer injected
    model = build_model(base, "cpu" if args.cpu else "cuda", args.seed)
    if run_dir:
        step = load_run_ema(model, run_dir)
        print(f"loaded EMA weights from {run_dir} (step {step})")
    elif args.resume:
        sd = torch.load(args.resume, map_location="cpu", weights_only=True)
        model.load_state_dict(sd.get("state_dict", sd))
        print(f"loaded weights from {args.resume}")
    else:
        print("WARNING: sampling from randomly initialized weights")
    graph = synthetic_graph_batch(np.random.default_rng(args.seed), n_scenes=args.n_scenes,
                                  max_objs_per_scene=MAX_OBJS,
                                  max_triples_per_scene=MAX_TRIPLES)
    t0 = time.perf_counter()
    out = sample_layouts(model, graph, args.steps, args.seed)
    seconds = time.perf_counter() - t0
    os.makedirs(args.outdir, exist_ok=True)
    path = os.path.join(args.outdir, "layouts.npz")
    np.savez(path, **out)
    print(f"wrote {out['boxes'].shape[0]} boxes over {args.n_scenes} scenes in "
          f"{seconds:.2f} s -> {path}")
    return out


if __name__ == "__main__":
    main()
