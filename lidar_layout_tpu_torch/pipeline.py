"""Serving surface: generate range images and point clouds from a LiDM.

Counterpart of ``lidar_layout_tpu/pipeline.py`` (``geometry_from_config``,
``GenerationResult``, ``GenerationPipeline.from_config`` / ``.generate``):

    pipe = GenerationPipeline.from_config("configs/lidar_diffusion/kitti/uncond_c2_p4.yaml")
    out = pipe.generate(64, seed=0)          # out.images, out.clouds

    # the layout-conditioned model, with classifier-free guidance
    pipe = GenerationPipeline.from_config(
        "configs/lidar_diffusion/nuscenes/layout_cond_c2_p4.yaml", dataset="32")
    c = pipe.model.get_learned_conditioning(layouts)          # (n, 13, 13)
    u = pipe.model.get_learned_conditioning(np.zeros_like(layouts))
    out = pipe.generate(len(layouts), cond=c, uncond=u, cfg_scale=2.0)

Each batch runs sample -> VQ decode -> reprojection on the device. Samplers
are cached per (batch, conditioning shapes, cfg_scale, sampler, steps, eta)
key. ``from_run_dir`` loads a run that ``train.train_lidm`` wrote: its
``config.yaml`` and latest checkpoint.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .config import instantiate_from_config, load_yaml
from .models import samplers as S
from .models.diffusion import LatentDiffusion
from .ops.lidar import KITTI_GEOMETRY, NUSCENES_GEOMETRY, LidarGeometry, range2pcd
from .parallel.collectives import get_rank, get_world_size, host_all_gather
from .utils.device import resolve_device

__all__ = ["GenerationPipeline", "GenerationResult", "geometry_from_config"]


def geometry_from_config(cfg: Dict[str, Any], dataset: str = "64") -> LidarGeometry:
    """Projection geometry from a config's data.params.dataset block, else the
    per-dataset default."""
    dset = (cfg or {}).get("data", {}).get("params", {}).get("dataset", {})
    if dset:
        return LidarGeometry(
            size=tuple(dset.get("size", (64, 1024))),
            fov=tuple(dset.get("fov", (3, -25))),
            depth_range=tuple(dset.get("depth_range", (1.0, 56.0))),
            depth_scale=dset.get("depth_scale", 5.84),
            log_scale=dset.get("log_scale", True))
    return KITTI_GEOMETRY if dataset == "64" else NUSCENES_GEOMETRY


@dataclass
class GenerationResult:
    """``images``: (n, H, W, C) model-space range images; ``clouds``: per-scene
    (k_i, 3) reprojected xyz; ``seconds``: wall time of the batches;
    ``phase_seconds``: that time split into sample / decode / reproject."""
    images: np.ndarray
    clouds: List[np.ndarray]
    seconds: float
    phase_seconds: Dict[str, float] = field(default_factory=dict)

    @property
    def samples_per_sec(self) -> float:
        return len(self.images) / max(self.seconds, 1e-9)


@dataclass
class GenerationPipeline:
    """A LatentDiffusion model on its device plus its cached samplers."""
    model: LatentDiffusion
    geom: LidarGeometry
    # DPM-Solver++(2M) at 20 steps is the serving default, as in the JAX package
    sampler: str = "dpm"
    steps: int = 20
    eta: float = 0.0
    _cache: Dict[Tuple, Callable] = field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @classmethod
    def from_config(cls, cfg: Union[str, Dict[str, Any]],
                    state_dict: Optional[Dict[str, torch.Tensor]] = None,
                    dataset: str = "64", bf16: bool = False, seed: int = 0,
                    device: Union[str, torch.device] = "cuda",
                    **kw) -> "GenerationPipeline":
        """Build from a config path or dict, with the given reference-named
        ``state_dict`` or fresh weights initialised under ``seed``."""
        dev = resolve_device(device)
        if isinstance(cfg, str):
            cfg = load_yaml(cfg)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = instantiate_from_config(
                cfg["model"], dtype=torch.bfloat16 if bf16 else torch.float32)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        return cls(model=model.to(dev).eval(), geom=geometry_from_config(cfg, dataset),
                   **kw)

    @classmethod
    def from_run_dir(cls, run_dir: str, base_config: Optional[str] = None,
                     dataset: str = "64", use_ema: bool = True, bf16: bool = False,
                     device: Union[str, torch.device] = "cuda", **kw) -> "GenerationPipeline":
        """Load a training run: its saved ``config.yaml`` (or ``base_config``)
        and the latest checkpoint under ``<run_dir>/ckpt``, with the EMA
        weights by default."""
        from .train.checkpoint import latest_run_weights

        cfg = load_yaml(base_config or os.path.join(run_dir, "config.yaml"))
        _, sd = latest_run_weights(run_dir, use_ema=use_ema)
        return cls.from_config(cfg, state_dict=sd, dataset=dataset, bf16=bf16,
                               device=device, **kw)

    def _program(self, batch: int, cond_shapes: Tuple, cfg_scale: float
                 ) -> Callable[[torch.Generator, Any, Any], torch.Tensor]:
        key = (batch, cond_shapes, cfg_scale, self.sampler, self.steps, self.eta)
        if key not in self._cache:
            lh, lw, lc = self.model.cfg.latent_shape
            shape = (batch, lh, lw, lc)
            dev = self.device
            if self.sampler == "ddim":
                def draw(gen, c, u):
                    return S.ddim_sample(self.model, shape, steps=self.steps, eta=self.eta,
                                         cond=c, uncond=u, cfg_scale=cfg_scale,
                                         generator=gen, device=dev)
            elif self.sampler == "dpm":
                def draw(gen, c, u):
                    return S.dpm_solver_sample(self.model, shape, steps=self.steps, cond=c,
                                               uncond=u, cfg_scale=cfg_scale, generator=gen,
                                               device=dev)
            elif self.sampler == "plms":
                def draw(gen, c, u):
                    return S.plms_sample(self.model, shape, steps=self.steps, cond=c,
                                         uncond=u, cfg_scale=cfg_scale, generator=gen,
                                         device=dev)
            elif self.sampler == "ddpm":
                def draw(gen, c, u):
                    return S.ddpm_sample(self.model, shape, cond=c, generator=gen, device=dev)
            else:
                raise NotImplementedError(
                    f"sampler {self.sampler!r} is not ported yet (ROADMAP queue 1)")
            self._cache[key] = draw
        return self._cache[key]

    def generate(self, n: int, seed: int = 0, batch: int = 16, cond: Any = None,
                 uncond: Any = None, cfg_scale: float = 1.0) -> GenerationResult:
        """Generate ``n`` scenes, ``batch`` at a time, from ``seed``.

        ``cond``/``uncond`` are conditioning pytrees, already encoded and
        batch-leading (``model.get_learned_conditioning``); ``cfg_scale`` > 1
        with an ``uncond`` turns on classifier-free guidance. A pytree whose
        leaves hold ``batch`` rows serves every batch; one of ``n`` rows is
        cut into the batches in order (the last one wraps to the first rows
        when ``batch`` does not divide ``n``).

        Under torch.distributed ``batch`` is the global batch: each rank
        samples its rows of every batch from its slice of the global noise,
        and the images and clouds are gathered through the host, so that
        every rank returns what one process would."""
        b = min(batch, n)
        world, rank = get_world_size(), get_rank()
        if b % world:
            raise ValueError(f"batch {b} does not divide over {world} ranks")
        bl = b // world
        mine = slice(rank * bl, (rank + 1) * bl)
        dev = self.device
        draw = self._program(bl, _shapes(cond), cfg_scale)
        gen = torch.Generator(device=dev).manual_seed(seed)
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        imgs_all, clouds = [], []
        phases = {"sample": 0.0, "decode": 0.0, "reproject": 0.0}
        with torch.inference_mode():
            for i in range((n + b - 1) // b):
                rows = (torch.arange(i * b, i * b + b, device=dev) % n)[mine]
                t0 = time.perf_counter()
                z = draw(gen, _rows(cond, rows, mine, b, n, dev),
                         _rows(uncond, rows, mine, b, n, dev))
                sync()
                t1 = time.perf_counter()
                imgs = self.model.decode_first_stage(z)
                sync()
                t2 = time.perf_counter()
                xyz, valid = range2pcd(imgs[..., 0], self.geom)
                imgs_np, xyz_np, valid_np = (
                    host_all_gather(t.cpu().numpy()).reshape(b, *t.shape[1:])
                    for t in (imgs, xyz, valid))
                t3 = time.perf_counter()
                phases["sample"] += t1 - t0
                phases["decode"] += t2 - t1
                phases["reproject"] += t3 - t2
                imgs_all.append(imgs_np)
                clouds.extend(pc[v] for pc, v in zip(xyz_np, valid_np))
        return GenerationResult(images=np.concatenate(imgs_all)[:n], clouds=clouds[:n],
                                seconds=sum(phases.values()), phase_seconds=phases)


def _shapes(tree: Any) -> Tuple:
    """The leaf shapes of a conditioning pytree (nested dicts of tensors)."""
    if tree is None:
        return ()
    if isinstance(tree, dict):
        return tuple((k, _shapes(tree[k])) for k in sorted(tree))
    return tuple(tree.shape)


def _rows(tree: Any, rows: torch.Tensor, mine: slice, b: int, n: int,
          dev: torch.device) -> Any:
    """This rank's part of one batch of a batch-leading conditioning pytree,
    on ``dev``: the leaf's ``mine`` rows when it has ``b`` (the batch's), the
    given rows when it has ``n``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rows(v, rows, mine, b, n, dev) for k, v in tree.items()}
    leaf = torch.as_tensor(tree, device=dev)
    if leaf.shape[0] == b:
        return leaf[mine]
    if leaf.shape[0] == n:
        return leaf[rows]
    raise ValueError(f"a conditioning leaf has {leaf.shape[0]} rows; expected the batch "
                     f"({b}) or n ({n})")
