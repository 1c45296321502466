"""Sample and reconstruction logging: the training CLI's image logger.

Counterpart of ``lidar_layout_tpu/train/sample_logger.py`` (the reference's
ImageLogger): ``SampleLogger`` calls a ``render_fn`` every ``every_steps``
steps and writes each image set under ``<workdir>/images`` as ``.npy``, and
as PNGs through matplotlib when it is installed (``save_range_png`` returns
False without it, as the JAX package's does). ``lidm_log_images`` is the
LiDM's suite: inputs, reconstruction, a noising row, DDIM samples and
DDIM inpainting and outpainting of the latent's left half.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..models import samplers
from ..models.schedules import q_sample
from ..parallel.collectives import is_main_process
from .trainer import HookBase


def save_range_png(path: str, img: np.ndarray) -> bool:
    """Render a range image to PNG; False when matplotlib is absent."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    fig, ax = plt.subplots(figsize=(12, 2))
    ax.imshow(img, cmap="turbo", vmin=-1, vmax=1, aspect="auto")
    ax.axis("off")
    fig.savefig(path, bbox_inches="tight", dpi=100)
    plt.close(fig)
    return True


@torch.no_grad()
def lidm_log_images(model, batch: Dict[str, Any], generator: Optional[torch.Generator],
                    n_row: int = 4, sample_steps: int = 20) -> Dict[str, torch.Tensor]:
    """The LatentDiffusion.log_images suite, with the model's current
    weights: dict of (B, H, W, 1) model-space range images (the noising row
    is its four decodes stacked along H). Every Gaussian draw goes through
    ``samplers._randn`` from ``generator``, in JAX's order: the noising
    row's noise, the samples' start, the inpainting's start and its one
    draw a step, then the outpainting's, the same as the inpainting's (JAX
    splits one key for both)."""
    model.eval()
    x = batch["image"][:n_row]
    n_row = x.shape[0]   # the batch may be smaller than asked
    out = {"inputs": x}
    z = model.encode_first_stage(x)
    out["reconstruction"] = model.decode_first_stage(z)[..., :1]
    cond = None
    if model.cfg.conditioning_key is not None and "cond" in batch:
        cond = model.get_learned_conditioning(batch["cond"][:n_row])

    dev = z.device
    ts = np.linspace(0, model.cfg.timesteps - 1, 4).astype(np.int32)
    noise = samplers._randn(tuple(z.shape), generator, dev)
    out["diffusion_row"] = torch.cat([
        model.decode_first_stage(q_sample(model.schedule, z, torch.full(
            (n_row,), int(t), dtype=torch.long, device=dev), noise))[..., :1]
        for t in ts], dim=1)

    shape = (n_row, *model.cfg.latent_shape)
    z_s = samplers.ddim_sample(model, shape, steps=sample_steps, cond=cond,
                               generator=generator, device=dev)
    out["samples"] = model.decode_first_stage(z_s)[..., :1]
    h, w = model.cfg.latent_shape[:2]
    mask = torch.zeros((n_row, h, w, 1), device=dev)
    mask[:, :, : w // 2] = 1.0
    state = generator.get_state() if generator is not None else None
    for name, m in (("samples_inpainting", mask), ("samples_outpainting", 1.0 - mask)):
        if state is not None:
            generator.set_state(state)
        z_in = samplers.ddim_sample(model, shape, steps=sample_steps, cond=cond, mask=m, x0=z,
                                    generator=generator, device=dev)
        out[name] = model.decode_first_stage(z_in)[..., :1]
    return out


class SampleLogger(HookBase):
    """Every ``every_steps`` steps: ``render_fn(state, generator) ->
    dict[name -> (B, H, W, 1) images]`` (the trainer's generator), written
    to ``<workdir>/images/<name>_<step>.npy`` and, with matplotlib, one PNG
    an image, the first ``max_images`` of each set."""

    def __init__(self, render_fn: Callable, every_steps: int = 1000, max_images: int = 4):
        self.render_fn = render_fn
        self.every_steps = every_steps
        self.max_images = max_images

    def after_step(self, logs):
        step = self.trainer.global_step
        if step % self.every_steps != 0:
            return
        # every rank renders, so that the step generator advances alike on
        # each; rank 0 writes
        images = self.render_fn(self.trainer.state, self.trainer.generator)
        if not is_main_process():
            return
        out_dir = os.path.join(self.trainer.workdir, "images")
        os.makedirs(out_dir, exist_ok=True)
        for name, imgs in images.items():
            imgs = imgs[: self.max_images].detach().float().cpu().numpy()
            np.save(os.path.join(out_dir, f"{name}_{step:07d}.npy"), imgs)
            for i, img in enumerate(imgs[..., 0]):
                save_range_png(os.path.join(out_dir, f"{name}_{step:07d}_{i}.png"), img)
