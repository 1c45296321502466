"""Train a range autoencoder or a latent-diffusion model from a YAML config,
on one CUDA card or, under ``torchrun``, on several.

    python -m lidar_layout_tpu_torch.train.train_lidm \\
        -b configs/lidar_diffusion/kitti/uncond_c2_p4.yaml --synthetic --steps 100 --bf16
    python -m lidar_layout_tpu_torch.train.train_lidm \\
        -b configs/autoencoder/kitti/autoencoder_c2_p4.yaml --synthetic --steps 100

Counterpart of ``scripts/train_lidm.py`` with the same flags:
``-b/--base -t/--train -r/--resume -d/--data-root -s/--seed --steps
--workdir --synthetic --bf16`` and trailing ``a.b.c=value`` overrides;
``--cpu`` runs on the CPU. Under ``torchrun --nproc-per-node N -m
lidar_layout_tpu_torch.train.train_lidm ...`` each rank joins the process
group (NCCL on CUDA, gloo with ``--cpu``; ``parallel/mesh.init_from_env``),
the global batch is ``max(batch_size, world)``, as JAX's one sample a chip,
and each rank reads its share of every global batch; the learning rate is
scaled by the global batch; ``scale_by_std`` is computed over the global
first batch; each step averages its gradients over the ranks; rank 0 alone
writes. Without ``torchrun``'s environment it is the one-process run.
Every family of JAX's ``train_lidm`` trains:

- ``vq_model`` (``configs/autoencoder/*/autoencoder_c2_p4.yaml``,
  ``range_flow.yaml``, ``configs/ours/nuscenes/coarse_range/range_256x8.yaml``):
  the VQ-GAN step of ``train/ae_trainer`` in float32, or under bf16
  autocast with ``--bf16`` (JAX's dtype policy, that module's doc), with
  JAX's ``LiDARNLayerDiscriminator()`` (v1, 64 filters, 3 layers, float32)
  whatever the loss block's ``disc_version`` or ``disc_num_layers`` say, as
  the JAX CLI builds it, and the RangeNet perceptual loss
  (``losses/perceptual``, a RangeNet-21 drawn from ``--seed``) when the loss
  block's ``perceptual_factor`` is above 0; monitored on ``val/rec_loss``.
  Its checkpoints hold a
  Lightning-style ``state_dict`` that a LiDM's
  ``first_stage_config.params.ckpt_path`` reads as it is.
- ``vq_model_gaus`` (``configs/autoencoder/nuscenes/autoencoder_c2_p4_gaus.yaml``):
  the same step with the s2 branch (the Gaussian tower rendered in the
  YAML's geometry, ``make_ae_train_step(s2_render=True)``), as JAX's
  ``build_family_trainer`` trains it, in float32 whatever ``--bf16`` says;
  no image logger, as there.
- LatentDiffusion, unconditional or layout-conditioned
  (``configs/lidar_diffusion/nuscenes/layout_cond_c2_p4.yaml``, whose
  encoder trains with the U-Net).
- ``cube_ae`` and ``cube_latent_diffusion`` (``voxel_1024.yaml``,
  ``autoencoder_cube.yaml``, ``voxel_uncond_diffusion_256.yaml``) through
  ``train/cube_trainer``, in float32 whatever ``--bf16`` says (JAX's cube
  builders take no dtype); the model is built once the first batch gives
  the width of its point features.
- ``r2dm_diffusion`` (``configs/r2dm/r2dm_diffusion.yaml``),
  ``vq_model_object`` (``configs/autoencoder/nuscenes_objects/g2sd_32.yaml``)
  and ``autoencoder_kl`` (no YAML names it: e.g. the kitti AE's YAML with
  ``model.target=autoencoder_kl model.params.ddconfig.double_z=true``)
  through ``train/family_trainer``; R2DM and the object AE in float32
  whatever ``--bf16`` says (JAX's builders drop the dtype), the KL AE under
  bf16 autocast with it.

Every ``ckpt_every_steps`` of the data block (default a fifth of
``--steps``) and at the end a checkpoint goes under ``<workdir>/ckpt``; a
step whose validation loss is among the best three is kept under
``ckpt_best`` (a link to the step's checkpoint where one was written).
Every ``sample_every_steps`` (default a fifth of ``--steps``) the image
logger (``train/sample_logger``) writes the AE's inputs and reconstructions,
or the LiDM's ``lidm_log_images`` with the EMA weights, under
``<workdir>/images``; the R2DM, object and KL families log no images, as in
JAX. LayoutDiffusion trains with ``train_layout`` and the dense decoder
with ``train_dense_decoder``.
Dataset targets come from ``data/factory`` (synthetic with
``--synthetic``). Weights start as the JAX package's initialisers draw
them (``utils/init.jax_init_``), under ``--seed``, the discriminator's
too, unless a first stage names a ``ckpt_path``.
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict

import torch

LDM_TARGETS = ("latent_diffusion", "lidm.models.diffusion.ddpm.LatentDiffusion")
AE_TARGETS = ("vq_model", "lidm.models.autoencoder.VQModel", "lidm.models.ae.autoencoder.VQModel",
              "vq_model_gaus", "lidm.models.ae.autoencoder_gaus.VQModel_Gaus")
LAYOUT_DIFFUSION_TARGETS = ("layout_diffusion", "lidm.models.diffusion.ddpm.LayoutDiffusion")
LAYOUT_RANGE_TARGETS = ("nusc_layout_range", "lidm.data.nusc_dataset.nuScenesLayoutTrain",
                        "lidm.data.nusc_dataset.nuScenesLayoutValidation")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-b", "--base", required=True, help="YAML config")
    p.add_argument("-t", "--train", action="store_true")
    p.add_argument("-r", "--resume", default=None, help="run directory to resume")
    p.add_argument("-d", "--data-root", default=None)
    p.add_argument("-s", "--seed", type=int, default=23)
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--workdir", default=None)
    p.add_argument("--synthetic", action="store_true", help="synthetic scenes only")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--bf16", action="store_true", help="bf16 autocast, f32 weights")
    args, unknown = p.parse_known_args(argv)
    bad = [u for u in unknown if "=" not in u]
    if bad:
        p.error(f"unrecognized arguments: {' '.join(bad)}")
    args.overrides = unknown
    return args


def _merge(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


def _lr_lambda(model_cfg: Dict[str, Any], steps: int):
    """The config's warmup-cosine scheduler as a multiplier, or None."""
    from .lr_schedule import lambda_warmup_cosine

    sched = model_cfg.get("scheduler_config") or model_cfg["params"].get("scheduler_config")
    if not sched:
        return None
    sp = sched.get("params", sched)

    def scalar(key, default, alt=None):
        v = sp.get(key, sp.get(alt) if alt else None)
        if isinstance(v, (list, tuple)):   # LambdaLinearScheduler lists
            v = v[0] if v else None
        return default if v is None else float(v)

    return lambda_warmup_cosine(
        warm_up_steps=int(scalar("warm_up_steps", 1000)),
        lr_min=scalar("f_min", 0.0, "lr_min"), lr_max=scalar("f_max", 1.0, "lr_max"),
        lr_start=scalar("f_start", 1e-6, "lr_start"),
        max_decay_steps=int(scalar("cycle_lengths", steps)))


def main(argv=None):
    """Train (``prepare``, then ``Trainer.train``); returns the trainer."""
    import torch.distributed as dist

    joined = dist.is_available() and dist.is_initialized()
    trainer = prepare(argv)
    trainer.train()
    print(f"done: {trainer.global_step} steps -> {trainer.workdir}")
    if not joined and dist.is_initialized():   # the group this run made
        dist.destroy_process_group()
    return trainer


def prepare(argv=None):
    """Everything ``main`` does before the first step: join the process
    group, build the data, the model, its train state and the hooks, seed
    each rank's default generator, write the config. Returns the
    ``Trainer``."""
    args = parse_args(argv)

    from ..config import (CUBE_AE_TARGETS, CUBE_LDM_TARGETS, GAUS_AE_TARGETS, KL_AE_TARGETS,
                          OBJECT_AE_TARGETS, R2DM_TARGETS, apply_dotlist,
                          instantiate_from_config, load_yaml)
    from ..data.datasets import RangeImageDataset
    from ..data.factory import build_batches
    from ..parallel.collectives import get_world_size, is_main_process
    from ..parallel.mesh import (init_from_env, local_batch_slice, replicate, seed_rank,
                                 shard_batch)
    from ..pipeline import geometry_from_config
    from ..utils.device import resolve_device
    from ..utils.init import jax_init_
    from .checkpoint import restore_checkpoint
    from .lr_schedule import scale_lr
    from .trainer import (BestCheckpointSaver, CheckpointSaver, InformationWriter,
                          IterationTimer, Trainer, ValidationHook)

    device = init_from_env(resolve_device("cpu" if args.cpu else "cuda"))
    world = get_world_size()
    cfg = load_yaml(args.base)
    if args.resume:   # a resumed run reloads its own config; -b overrides it
        saved = os.path.join(args.resume, "config.yaml")
        if os.path.isfile(saved):
            base = load_yaml(saved)
            _merge(base, cfg)
            cfg = base
            print(f"re-merged config from {saved}")
    if args.overrides:
        apply_dotlist(cfg, args.overrides)
        print(f"dotlist overrides: {args.overrides}")
    model_cfg = cfg["model"]
    if model_cfg["target"] in LAYOUT_DIFFUSION_TARGETS:
        raise NotImplementedError(
            "LayoutDiffusion trains with its own CLI, as scripts/train_layout.py in the "
            "JAX package: python -m lidar_layout_tpu_torch.train.train_layout -b <config>")
    is_ae = model_cfg["target"] in AE_TARGETS
    is_cube = model_cfg["target"] in CUBE_AE_TARGETS + CUBE_LDM_TARGETS
    family = model_cfg["target"] in R2DM_TARGETS + OBJECT_AE_TARGETS + KL_AE_TARGETS
    if model_cfg["target"] in ("dense_decoder", "DenseDecoderV0"):
        raise NotImplementedError(
            "the dense decoder trains with its own CLI, as scripts/train_dense_decoder.py in "
            "the JAX package: python -m lidar_layout_tpu_torch.train.train_dense_decoder")
    if not (is_ae or is_cube or family or model_cfg["target"] in LDM_TARGETS):
        raise NotImplementedError(f"no trainer for model family {model_cfg['target']!r}")
    data_cfg = cfg.get("data", {}).get("params", {})
    name = os.path.splitext(os.path.basename(args.base))[0]
    workdir = args.workdir or f"./runs/{name}"
    geom = geometry_from_config(cfg)
    # the global batch, at least one sample a rank; each rank takes its share
    batch_size = max(int(data_cfg.get("batch_size", 4)), world)
    rows = local_batch_slice(batch_size)   # asserts that the ranks share it evenly
    accumulate = int(data_cfg.get("accumulate_grad_batches", 1))

    def make_batches(split: str, seed: int):
        """The rank's share of each global batch: the range datasets read
        only its rows; the factory's targets build the global batch, then
        keep them."""
        blk = data_cfg.get(split) or data_cfg.get("train") or {}
        if blk.get("target") in LAYOUT_RANGE_TARGETS:
            raw = layout_batches(blk.get("params") or {}, split, seed)
        elif blk.get("target"):
            params = dict(blk.get("params") or {})
            params.setdefault("split", "val" if split == "validation" else split)
            raw = build_batches(blk["target"], params, data_cfg.get("dataset", {}),
                                args.data_root, batch_size, seed,
                                force_synthetic=args.synthetic, device=device)
        else:
            return RangeImageDataset(None if args.synthetic else args.data_root,
                                     batch_size=batch_size, geom=geom, seed=seed, device=device,
                                     rows=rows).batches()
        return (shard_batch(b, batch_size) for b in raw)

    def layout_batches(params: Dict[str, Any], split: str, seed: int):
        """nuScenes layout batches from the data factory: synthetic scenes
        and layouts, or the reader over ``--data-root``'s infos pickle."""
        if not args.synthetic and not args.data_root:
            raise ValueError("the nusc_layout_range dataset needs --data-root (a nuScenes "
                             "root with nuscenes_infos_<split>.pkl) or --synthetic")
        params = {**params, "split": params.get("split", "train" if split == "train" else "val")}
        return build_batches("nusc_layout_range", params, data_cfg.get("dataset", {}),
                             args.data_root, batch_size, seed, force_synthetic=args.synthetic,
                             device=device)

    train_batches = make_batches("train", args.seed)
    val_every = max(int(data_cfg.get("val_every_steps", args.steps // 10 or 1)), 1)
    val_iter = make_batches("validation", args.seed + 1000)
    val_cache = [next(val_iter) for _ in range(int(data_cfg.get("num_val_batches", 4)))]

    lr = scale_lr(model_cfg.get("base_learning_rate", 4.5e-6), batch_size, 1, accumulate)
    lr_lambda = _lr_lambda(model_cfg, args.steps)
    # a cube model is built once the first batch gives its feature width
    kw = {"in_features": val_cache[0]["feats"].shape[-1]} if is_cube else {}
    amp = torch.bfloat16 if args.bf16 else None
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = jax_init_(instantiate_from_config(model_cfg, **kw).to(device), args.seed)
        replicate(model)   # rank 0's weights on every rank, before the EMA copies them
        if is_ae:   # the discriminator starts from the seed too
            if args.bf16 and model_cfg["target"] in GAUS_AE_TARGETS:
                print("the Gaussian range AE trains in float32; --bf16 is not read for it")
                amp = None
            state, step, val_step, monitor = _ae_training(model, model_cfg, geom, lr,
                                                          accumulate, lr_lambda, amp,
                                                          args.seed)
        elif family:
            from .family_trainer import family_training

            if args.bf16 and model_cfg["target"] not in KL_AE_TARGETS:
                print("R2DM and the object AE train in float32; --bf16 is not read for them")
            state, step, val_step, monitor = family_training(model, model_cfg, lr, accumulate,
                                                             lr_lambda, amp)
            if getattr(state, "disc", None) is not None:
                jax_init_(state.disc, args.seed + 1)
    render_fn = None
    if is_cube:
        from .cube_trainer import cube_training

        if args.bf16:
            print("the cube families train in float32; --bf16 is not read for them")
        state, step, val_step, monitor = cube_training(model, model_cfg, lr, lr_lambda)
    elif is_ae:
        if model_cfg["target"] not in GAUS_AE_TARGETS:   # JAX logs no gaus images
            render_fn = _ae_render(model, val_cache)
    elif not family:
        state, step, val_step, monitor = _ldm_training(model, model_cfg, val_cache, lr,
                                                       accumulate, lr_lambda, args.bf16)
        if model.first_stage_model is not None:
            render_fn = _ldm_render(model, val_cache, args.bf16)
    if getattr(state, "disc", None) is not None:
        replicate(state.disc)
    if args.resume:
        restore_checkpoint(os.path.join(args.resume, "ckpt"), state)
        print(f"resumed from {args.resume} at step {state.step}")
    if world > 1:   # dropout and other default-generator draws differ between ranks;
        seed_rank(args.seed, device)   # after the seeded build, which reseeds every card

    # ValidationHook comes first: the writer and savers read its val/* metrics
    hooks = [IterationTimer(),
             ValidationHook(val_step, lambda: iter(val_cache), every_steps=val_every),
             InformationWriter(),
             CheckpointSaver(every_steps=int(data_cfg.get("ckpt_every_steps",
                                                          max(args.steps // 5, 1)))),
             BestCheckpointSaver(monitor=monitor, top_k=3)]
    if render_fn is not None:
        from .sample_logger import SampleLogger

        hooks.append(SampleLogger(render_fn, every_steps=int(
            data_cfg.get("sample_every_steps", max(args.steps // 5, 1)))))
    trainer = Trainer(step, state, train_batches, workdir=workdir, max_steps=args.steps,
                      hooks=hooks, seed=args.seed)
    if is_main_process():
        try:
            import yaml

            with open(os.path.join(workdir, "config.yaml"), "w") as f:
                yaml.safe_dump(cfg, f)
        except ImportError as e:
            print(f"config save skipped: {e}")
    return trainer


def _ae_training(model, model_cfg: Dict[str, Any], geom, lr: float, accumulate: int,
                 lr_lambda, amp=None, seed: int = 0):
    """(state, step, val_step, monitored metric) of the VQ-GAN: the loss
    block's config (the default ``VQLossConfig`` without one), JAX's
    discriminator on the model's device, two Adams; the perceptual loss
    when the config asks for it; autocast in ``amp``; the s2 branch for a
    ``VQModelGaus``."""
    from ..config import instantiate_from_config
    from ..losses.discriminator import LiDARNLayerDiscriminator
    from ..losses.geometric import GeoConverter
    from ..losses.perceptual import make_perceptual_fn
    from ..losses.vq_loss import VQLossConfig
    from ..models.autoencoder_gaus import VQModelGaus
    from ..utils.init import jax_init_
    from .ae_trainer import (create_ae_state, disc_in_channels, make_ae_train_step,
                             make_ae_val_step)

    lc = model_cfg["params"].get("lossconfig")
    loss_cfg = (instantiate_from_config(lc)
                if isinstance(lc, dict) and lc.get("target") not in (None, "torch.nn.Identity")
                else VQLossConfig())
    geo = GeoConverter(geom, curve_length=loss_cfg.curve_length)
    dev = next(model.parameters()).device
    perceptual_fn = None
    if loss_cfg.perceptual_factor > 0:
        # no converted RangeNet weights here: a fixed RangeNet-21 from the seed
        perceptual_fn = make_perceptual_fn(geom, rng_seed=seed, device=dev)
        print(f"perceptual loss active (factor={loss_cfg.perceptual_factor}; a random "
              f"RangeNet-21 from seed {seed})")
    disc = jax_init_(LiDARNLayerDiscriminator(
        disc_in_channels(model.cfg.out_ch, loss_cfg, geo)).to(dev), seed + 1)
    state = create_ae_state(model, disc, lr, lr, accumulate, lr_lambda)
    s2 = isinstance(model, VQModelGaus)
    return (state, make_ae_train_step(model, disc, loss_cfg, geo, s2_render=s2, s2_geom=geom,
                                      perceptual_fn=perceptual_fn, autocast_dtype=amp),
            make_ae_val_step(model, loss_cfg, geo, perceptual_fn, amp), "val/rec_loss")


def _ae_render(model, val_cache):
    """The AE's image set: the first validation batch and its reconstruction."""

    def render(state, generator):
        x = val_cache[0]["image"]
        model.eval()
        with torch.no_grad():
            dec = model(x.permute(0, 3, 1, 2).float())[0]
        return {"inputs": x, "reconstructions": dec[:, :1].permute(0, 2, 3, 1)}

    return render


def _ldm_render(model, val_cache, bf16: bool):
    """The LiDM's ``lidm_log_images`` on the first validation batch, with the
    EMA weights swapped in."""
    from .diffusion_trainer import _autocast
    from .sample_logger import lidm_log_images

    def render(state, generator):
        with state.ema.swapped_in(state.params), \
                _autocast(model, torch.bfloat16 if bf16 else None):
            return lidm_log_images(model, val_cache[0], generator)

    return render


def _ldm_training(model, model_cfg: Dict[str, Any], val_cache, lr: float, accumulate: int,
                  lr_lambda, bf16: bool):
    """(state, step, val_step, monitored metric) of latent diffusion: the
    first stage from its ``ckpt_path`` when the config names one,
    scale_by_std, AdamW and the EMA over the trainable set."""
    from ..models.diffusion import apply_scale_by_std
    from .checkpoint import load_first_stage_params
    from .diffusion_trainer import (create_train_state, make_optimizer, make_train_step,
                                    make_val_step, trainable_params)

    fsc = model_cfg["params"].get("first_stage_config")
    fs_ckpt = fsc.get("params", {}).get("ckpt_path") if isinstance(fsc, dict) else None
    if fs_ckpt and model.first_stage_model is not None:
        load_first_stage_params(fs_ckpt, model)
        print(f"first_stage weights <- {fs_ckpt}")
    if model.cfg.scale_by_std:
        print(f"scale_by_std: scale_factor={apply_scale_by_std(model, val_cache[0]['image']):.4f}")

    params = trainable_params(model)
    optimizer = make_optimizer(params, lr, accumulate=accumulate, lr_lambda=lr_lambda)
    amp = torch.bfloat16 if bf16 else None
    return (create_train_state(model, optimizer, params),
            make_train_step(model, autocast_dtype=amp), make_val_step(model, autocast_dtype=amp),
            "val/loss_simple_ema")


if __name__ == "__main__":
    main()
