"""Text -> LiDAR through CLIP text conditioning.

    python -m lidar_layout_tpu_torch.text2lidar --prompt "a busy intersection with cars"
    python -m lidar_layout_tpu_torch.text2lidar --cfg-scale 2.0 -n 2 --steps 50
    python -m lidar_layout_tpu_torch.text2lidar --tiny --device cpu

Counterpart of ``scripts/text2lidar.py``, with its flags and defaults
(``--prompt -r/--resume -n/--n-samples --steps --cfg-scale --outdir
--tiny``) and its output, ``<outdir>/text2lidar_samples.npy``. It runs on
the card unless ``--device cpu`` is given. The model is the JAX script's:
the prompt's tokens (``encoders/modules.simple_tokenize``, the byte-level
fallback: the repository holds no BPE vocabulary) through
``FrozenClipMultiTextEmbedder(n_views=2)`` (the CLIP text tower, EOT
pooling, L2-normalised, repeated over 2 views) to (n, 2, 768) tokens, and
``sample_cond.build_model``'s U-Net with SpatialTransformers over them
(``crossattn``, ``context_dim`` 768). DDIM runs with classifier-free
guidance at ``--cfg-scale``, the unconditional tokens those of
``simple_tokenize([""] * n)``; a scale of 1 evaluates the conditional branch
alone, as the JAX sampler does. ``--resume`` reads a training run's
directory as ``sample_cond.prepare`` does (the EMA weights).
"""
from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np


def build_text_model(tiny: bool = False, device="cuda"):
    from .encoders.modules import FrozenClipMultiTextEmbedder
    from .sample_cond import build_model

    return build_model("crossattn", lambda: FrozenClipMultiTextEmbedder(n_views=2), tiny,
                       context_dim=768, device=device)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--prompt", default="a busy intersection with cars")
    p.add_argument("-r", "--resume", default=None, help="a training run's directory")
    p.add_argument("-n", "--n-samples", type=int, default=2)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--cfg-scale", type=float, default=1.0)
    p.add_argument("--outdir", default="./samples_text")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> Dict[str, Any]:
    """Returns the images, the request's seconds and the model."""
    from .encoders.modules import simple_tokenize
    from .sample_cond import prepare, sample, save

    args = parse_args(argv)
    model = build_text_model(args.tiny, args.device)
    prepare(model, args.resume)
    tokens = np.tile(simple_tokenize([args.prompt]), (args.n_samples, 1))
    imgs, seconds = sample(model, "c_crossattn", tokens, args.n_samples, args.steps,
                           uncond_in=simple_tokenize([""] * args.n_samples),
                           cfg_scale=args.cfg_scale)
    save(args.outdir, "text2lidar_samples.npy", imgs)
    print(f"prompt={args.prompt!r} -> {imgs.shape} -> {args.outdir} ({seconds:.2f} s)")
    return {"samples": imgs, "seconds": seconds, "model": model}


if __name__ == "__main__":
    main()
