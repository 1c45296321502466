"""Conditional sampling: semantic map or camera views -> LiDAR.

    python -m lidar_layout_tpu_torch.sample_cond --task map2lidar -n 4 --steps 50
    python -m lidar_layout_tpu_torch.sample_cond --task cam2lidar --outdir ./samples_cond
    python -m lidar_layout_tpu_torch.sample_cond --task map2lidar --tiny --device cpu

Counterpart of ``scripts/sample_cond.py``, with its flags and defaults
(``--task -r/--resume -n/--n-samples --steps --outdir --tiny``) and its
output, ``<outdir>/<task>_samples.npy``, the decoded (n, 64, 1024, 1) range
images (16x128 with ``--tiny``). It runs on the card unless ``--device cpu``
is given. The model is the JAX script's:

- map2lidar: a 19-class one-hot map (64x1024) through
  ``SpatialRescaler(n_stages=1, out_channels=19, wh_factors=(0.25, 0.125))``
  to the 16x128 latent grid, concatenated to the latent (``concat``); the
  U-Net 256 wide, ``in_channels`` 27, ``channel_mult`` (1, 2, 4), 2 res
  blocks, self-attention at ds 4, 2, 1 with head dim 32;
- cam2lidar: 2 camera views of 224x224 a sample through
  ``FrozenClipMultiImageEmbedder(out_dim=512)`` (CLIP ViT-L/14) to (n, 2,
  512) tokens, the U-Net with SpatialTransformers over them (``crossattn``,
  ``context_dim`` 512);

then DDIM (``--steps``, x_T from a generator seeded with ``XT_SEED``) and
the VQ decode with the ray-drop mask. The conditions are synthetic, drawn
with numpy from seed 0 as the JAX script draws them. ``--resume`` takes a
training run's directory, as the JAX script's does: the latest
``ckpt/step_<n>.pt`` through ``train/checkpoint.latest_run_weights``, its
model weights with the EMA weights over the ones they shadow, as
``pipeline.GenerationPipeline.from_run_dir`` and ``sample_layout`` load a
run. Without it the weights are torch's initial ones under ``WEIGHT_SEED``,
as the JAX script samples from its initial ones under ``key(0)``.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

NUM_SEM = 19
CAM_VIEWS, CAM_SIZE = 2, 224
WEIGHT_SEED, XT_SEED = 0, 1     # the JAX scripts' key(0) and key(1)


def sizes(tiny: bool) -> Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[Any, ...]]:
    """(latent (H, W, C), image (H, W, 1), (model_channels, channel_mult,
    num_res_blocks)) of the JAX scripts, full or ``--tiny``."""
    if tiny:
        return (4, 16, 8), (16, 128, 1), (32, (1, 2), 1)
    return (16, 128, 8), (64, 1024, 1), (256, (1, 2, 4), 2)


def build_model(conditioning_key: str, make_stage: Callable[[], torch.nn.Module],
                tiny: bool = False, in_channels: Optional[int] = None,
                context_dim: Optional[int] = None, device="cuda"):
    """The scripts' conditional LiDM in eval mode, f32, its parameters made
    on ``device``: the openaimodel U-Net (SpatialTransformers when
    ``context_dim`` is given), the c2_p4 VQ first stage with the mask
    channel, and ``make_stage()`` as the conditioning stage; torch's initial
    weights, the stage's under ``WEIGHT_SEED + 1`` and the rest under
    ``WEIGHT_SEED``."""
    from .models.autoencoder import AEConfig
    from .models.diffusion import DiffusionConfig, LatentDiffusion
    from .models.unet import UNetConfig
    from .utils.device import resolve_device

    dev = resolve_device(device)
    latent, _, (mc, mult, nrb) = sizes(tiny)
    unet_cfg = UNetConfig(in_channels=in_channels or latent[2], model_channels=mc,
                          out_channels=latent[2], num_res_blocks=nrb,
                          attention_resolutions=(4, 2, 1), channel_mult=mult,
                          num_head_channels=32, use_spatial_transformer=context_dim is not None,
                          context_dim=context_dim)
    with torch.random.fork_rng(devices=[dev.index or 0] if dev.type == "cuda" else []), dev:
        torch.manual_seed(WEIGHT_SEED + 1)
        stage = make_stage()
        torch.manual_seed(WEIGHT_SEED)
        model = LatentDiffusion(
            DiffusionConfig(timesteps=1024, linear_start=0.0015, linear_end=0.0195,
                            conditioning_key=conditioning_key, latent_shape=latent),
            unet_cfg,
            first_stage_cfg=AEConfig(ch=16 if tiny else 64, ch_mult=(1, 2, 2, 4),
                                     strides=((1, 2), (2, 2), (2, 2)), z_channels=8,
                                     out_ch=2, num_res_blocks=nrb),
            use_mask=True, cond_stage=stage)
    return model.eval()


def build_task_model(task: str, tiny: bool = False, device="cuda"):
    """map2lidar's or cam2lidar's model (``build_model``)."""
    from .encoders.modules import FrozenClipMultiImageEmbedder, SpatialRescaler

    if task == "map2lidar":
        # one asymmetric stage lands on the latent grid: H/4 x W/8
        return build_model("concat", lambda: SpatialRescaler(
            n_stages=1, out_channels=NUM_SEM, wh_factors=(0.25, 0.125)),
            tiny, in_channels=sizes(tiny)[0][2] + NUM_SEM, device=device)
    return build_model("crossattn", lambda: FrozenClipMultiImageEmbedder(out_dim=512), tiny,
                       context_dim=512, device=device)


def synthetic_conditions(task: str, n: int, tiny: bool = False) -> np.ndarray:
    """The JAX script's conditions, drawn from numpy seed 0: a one-hot NHWC
    map of NUM_SEM classes at the image size, or (n, 2, 224, 224, 3)
    Gaussian camera views."""
    rng = np.random.default_rng(0)
    if task == "map2lidar":
        h, w, _ = sizes(tiny)[1]
        return np.eye(NUM_SEM, dtype=np.float32)[rng.integers(0, NUM_SEM, (n, h, w))]
    return rng.standard_normal((n, CAM_VIEWS, CAM_SIZE, CAM_SIZE, 3)).astype(np.float32)


def sample(model, cond_key: str, cond_in: Any, n: int, steps: int = 50,
           uncond_in: Any = None, cfg_scale: float = 1.0,
           x_T: Optional[torch.Tensor] = None) -> Tuple[np.ndarray, float]:
    """One request: encode the raw conditions (``uncond_in`` too, for
    classifier-free guidance), DDIM over the latent from x_T (drawn from a
    generator seeded with ``XT_SEED`` on the model's device unless given) and
    decode. Returns the (n, H, W, 1) images and the request's seconds."""
    from .models.samplers import ddim_sample

    dev = next(model.parameters()).device
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        cond = {cond_key: model.get_learned_conditioning(cond_in)}
        uncond = (None if uncond_in is None
                  else {cond_key: model.get_learned_conditioning(uncond_in)})
        z = ddim_sample(model, (n, *model.cfg.latent_shape), steps=steps, cond=cond,
                        uncond=uncond, cfg_scale=cfg_scale, x_T=x_T, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(XT_SEED))
        imgs = model.decode_first_stage(z).cpu().numpy()
    return imgs, time.perf_counter() - t0


def prepare(model, resume: Optional[str]) -> None:
    """``--resume``'s run directory into ``model``, the EMA weights over
    the trained ones."""
    if resume:
        from .train.checkpoint import latest_run_weights

        step, sd = latest_run_weights(resume, use_ema=True)
        model.load_state_dict(sd)
        print(f"loaded step {step} (EMA) from {resume}")
    else:
        print("WARNING: sampling from randomly initialized weights")


def save(outdir: str, name: str, imgs: np.ndarray) -> str:
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, name)
    np.save(path, imgs)
    return path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--task", choices=["map2lidar", "cam2lidar"], default="map2lidar")
    p.add_argument("-r", "--resume", default=None, help="a training run's directory")
    p.add_argument("-n", "--n-samples", type=int, default=4)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--outdir", default="./samples_cond")
    p.add_argument("--tiny", action="store_true", help="CPU-sized model")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> Dict[str, Any]:
    """Returns the images, the request's seconds and the model."""
    args = parse_args(argv)
    model = build_task_model(args.task, args.tiny, args.device)
    prepare(model, args.resume)
    key = "c_concat" if args.task == "map2lidar" else "c_crossattn"
    imgs, seconds = sample(model, key, synthetic_conditions(args.task, args.n_samples, args.tiny),
                           args.n_samples, args.steps)
    save(args.outdir, f"{args.task}_samples.npy", imgs)
    print(f"wrote {imgs.shape} -> {args.outdir} ({seconds:.2f} s)")
    return {"samples": imgs, "seconds": seconds, "model": model}


if __name__ == "__main__":
    main()
