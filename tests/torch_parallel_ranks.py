"""Rank bodies of tests/test_torch_parallel*.py: each runs in a process of
its own (``parallel.dryrun.spawn``, gloo on the CPU) and imports torch and
the port alone; the test holds what rank 0 returns against JAX or against
one process. Inputs arrive as numpy arrays or torch state dicts, results
leave as numpy arrays and floats."""
from __future__ import annotations

import os

import torch

from lidar_layout_tpu_torch.parallel import collectives as C
from lidar_layout_tpu_torch.parallel.dryrun import params_equal_across_ranks
from lidar_layout_tpu_torch.parallel.mesh import local_batch_slice, shard_batch
from torch_port_helpers import seed_weights


def jobs(todo):
    """Each ``(key, name, args)`` of ``todo``, a rank body of this module by
    name, run in turn in this rank (one process start for many checks):
    {key: result}."""
    return {key: globals()[name](*args) for key, name, args in todo}


def collectives(xs, grads):
    """reduce_dict (mean, sum), all_gather and host_all_gather of this
    rank's entry of ``xs``; all_reduce_grads of its entry of ``grads`` (None
    kept) in buckets of 64 bytes, so that they span several."""
    x = torch.from_numpy(xs[C.get_rank()])
    d = {"a": x.sum(), "b": x.max(), "c": 2.0}
    mine = [None if g is None else torch.from_numpy(g.copy()) for g in grads[C.get_rank()]]
    C.BUCKET_BYTES = 64
    C.all_reduce_grads(mine)
    return {"grads": [None if g is None else g.numpy() for g in mine],
            "mean": {k: float(v) for k, v in C.reduce_dict(d).items()},
            "sum": {k: float(v) for k, v in C.reduce_dict(d, average=False).items()},
            "gather": C.all_gather(x).numpy(), "host": C.host_all_gather(x.numpy() * 3),
            "world": C.get_world_size()}


def tiny_flagship(seed):
    from lidar_layout_tpu_torch.flagship import flagship

    model, _ = flagship(tiny=True, device="cpu")
    return seed_weights(model, seed)


def flagship_grads(seed, x0, gen_seed, lr):
    """The tiny flagship's p_losses on this rank's rows of the global latents
    ``x0``, t and noise drawn at the global batch from ``gen_seed``; then
    the averaged U-Net gradients (through the optimizer's all-reduce) and
    one AdamW step. Returns the loss averaged over the ranks, the averaged
    gradients by name, the t and noise this rank drew and whether the
    replicas agree after the step."""
    from lidar_layout_tpu_torch.train.diffusion_trainer import make_optimizer, trainable_params

    model = tiny_flagship(seed)
    model.train()
    z = torch.from_numpy(x0)[local_batch_slice(len(x0))]
    t, noise = model.draw_t_noise(z, torch.Generator().manual_seed(gen_seed))
    loss, _ = model.p_losses(z, t, noise)
    loss.backward()
    params = trainable_params(model)
    opt = make_optimizer(params, lr)
    grads = {n: p.grad for n, p in params.items()}
    real = opt.adamw.step
    seen = {}

    def spy():   # the gradients as AdamW sees them: all-reduced
        seen.update({n: p.grad.detach().clone().numpy() for n, p in params.items()})
        return real()
    opt.adamw.step = spy
    norm = float(opt.step())
    assert set(seen) == set(grads)
    return {"loss": float(C.reduce_mean(loss.detach())), "grads": seen, "norm": norm,
            "t": t.numpy(), "noise": noise.numpy(),
            "replicas_equal": params_equal_across_ranks(model.unet)}


def scale_by_std(seed, images):
    """apply_scale_by_std on this rank's rows of ``images`` (the global
    first batch), and the factor of this rank's rows alone."""
    from lidar_layout_tpu_torch.models.diffusion import apply_scale_by_std
    import dataclasses

    model = tiny_flagship(seed)
    model.cfg = dataclasses.replace(model.cfg, scale_by_std=True)
    mine = torch.from_numpy(images)[local_batch_slice(len(images))]
    local = float(1.0 / model.encode_first_stage(mine).float().std(correction=0))
    return {"factor": apply_scale_by_std(model, mine), "local": local}


def fsdp_step(seed, images, gen_seed, clip, ckpt_dir):
    """One flagship step with the U-Net under FSDP on a (dp, fsdp) mesh of
    (world / 2, 2): the spec, the placements FSDP holds, the loss, the
    norm before clipping, the parameters after the step (full tensors) and
    a checkpoint under ``ckpt_dir`` (rank 0 writes)."""
    from torch.distributed.tensor import DTensor

    from lidar_layout_tpu_torch.parallel.mesh import fully_shard_module, make_mesh
    from lidar_layout_tpu_torch.train.checkpoint import full_tensors, save_checkpoint
    from lidar_layout_tpu_torch.train.diffusion_trainer import (create_train_state,
                                                                make_optimizer,
                                                                make_train_step,
                                                                trainable_params)

    model = tiny_flagship(seed)
    mesh = make_mesh(fsdp=2)
    spec = fully_shard_module(mesh, model.unet)
    held = {n: (p.placements[1].dim if p.placements[1].is_shard() else None)
            for n, p in model.unet.named_parameters() if isinstance(p, DTensor)}
    params = trainable_params(model)
    state = create_train_state(model, make_optimizer(params, 1e-3, grad_clip=clip), params)
    batch = shard_batch({"image": torch.from_numpy(images)}, len(images))
    state, logs = make_train_step(model)(state, batch, torch.Generator().manual_seed(gen_seed))
    after = {n: t.numpy() for n, t in full_tensors(
        {n: p.detach() for n, p in params.items()}).items()}
    save_checkpoint(ckpt_dir, 1, state)
    return {"spec": spec, "held": held, "loss": float(C.reduce_mean(logs["loss"])),
            "norm": float(logs["grad_norm"]), "after": after,
            "plain": sorted(n for n, p in model.unet.named_parameters()
                            if not isinstance(p, DTensor))}


def ae_step(sd_g, sd_d, kw, batch):
    """One VQ-GAN step on this rank's rows of ``batch``: the logs averaged
    over the ranks, d_weight as the step computed it, the parameters after
    both Adams and whether the replicas agree."""
    from lidar_layout_tpu_torch.losses import discriminator as PD
    from lidar_layout_tpu_torch.losses import geometric as PG
    from lidar_layout_tpu_torch.losses import vq_loss as PV
    from lidar_layout_tpu_torch.models import autoencoder as PAE
    from lidar_layout_tpu_torch.ops.lidar import LidarGeometry
    from lidar_layout_tpu_torch.train import ae_trainer as PT

    model = PAE.VQModel(PAE.AEConfig(**kw["ae"]), n_embed=kw["n_embed"],
                        embed_dim=kw["embed_dim"], use_mask=True)
    model.load_state_dict(sd_g)
    cfg = PV.VQLossConfig(**kw["loss"])
    geo = PG.GeoConverter(LidarGeometry(size=kw["size"]), curve_length=1)
    disc = PD.LiDARNLayerDiscriminator(PT.disc_in_channels(kw["ae"]["out_ch"], cfg, geo),
                                       ndf=16, n_layers=2)
    disc.load_state_dict(sd_d)
    state = PT.create_ae_state(model, disc, kw["lr"], kw["lr"])
    mine = shard_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                       len(batch["image"]))
    state, logs = PT.make_ae_train_step(model, disc, cfg, geo)(state, mine, torch.Generator())
    return {"logs": {k: float(v) for k, v in C.reduce_dict(logs).items()},
            "d_weight": float(logs["d_weight"]),
            "g": {n: p.detach().numpy() for n, p in model.named_parameters()},
            "d": {n: p.detach().numpy() for n, p in disc.named_parameters()},
            "replicas_equal": params_equal_across_ranks(model)
            and params_equal_across_ranks(disc)}


def layout_loss(sd, graph, t_scene, noise, change_noise):
    """LayoutDiffusion's loss on this rank's whole scenes of ``graph``, JAX's
    draws sliced to them, averaged over the ranks; the graph each rank
    held."""
    from lidar_layout_tpu_torch.parallel.dryrun import layout_model
    from lidar_layout_tpu_torch.parallel.mesh import shard_scene_graph

    model = layout_model("cpu")
    model.load_state_dict(sd)
    mine = shard_scene_graph(graph)
    scenes = local_batch_slice(int(graph["n_scenes"]))
    objs = local_batch_slice(len(graph["dec_objs"]))
    with torch.no_grad():
        loss, _ = model.p_losses(mine, t_scene=torch.from_numpy(t_scene[scenes]),
                                 noise=torch.from_numpy(noise[objs]),
                                 change_noise=torch.from_numpy(change_noise[objs]))
    return {"loss": float(C.reduce_mean(loss)), "n_scenes": int(mine["n_scenes"])}


def cli(argv, workdir):
    """train_lidm's main in this rank; the files under ``workdir`` after, and
    a draw from the rank's default generator (dropout's)."""
    from lidar_layout_tpu_torch.train.train_lidm import main

    trainer = main(argv)
    C.synchronize()   # rank 0 may still be writing its last checkpoint
    files = sorted(os.path.relpath(os.path.join(d, f), workdir)
                   for d, _, fs in os.walk(workdir) for f in fs)
    return {"step": trainer.global_step, "files": files,
            "replicas_equal": params_equal_across_ranks(trainer.state.model),
            "default_draw": torch.randn(4).numpy()}


def spatial(seed, image, latent, t, ring):
    """The sp axis in this rank of a (dp, 1, sp) mesh (sp = 4 in 4 ranks):
    the tiny flagship's W-sharded encode of ``image`` and ``apply_model`` of
    ``latent`` at ``t``, gathered; the circular and the zero-padded halo
    ring of this rank's shard of ``ring`` (..., W); the plan's place."""
    from lidar_layout_tpu_torch.parallel.dryrun import spatial_forward
    from lidar_layout_tpu_torch.parallel.mesh import make_mesh, spatial_sharding

    model = tiny_flagship(seed)
    mesh = make_mesh(sp=4)
    z, eps = spatial_forward(model, mesh, torch.from_numpy(image), torch.from_numpy(latent),
                             torch.from_numpy(t))
    plan = spatial_sharding(mesh)
    mine = plan.shard(torch.from_numpy(ring))
    return {"z": z.numpy(), "eps": eps.numpy(),
            "ring": C.halo_exchange(mine, 2, 3, plan.group).numpy(),
            "ring_zero": C.halo_exchange(mine, 3, 1, plan.group, wrap=False).numpy(),
            "mesh": {k: mesh[k].size() for k in mesh.mesh_dim_names},
            "plan": (plan.sp, plan.index, plan.batch, plan.batch_index),
            "sp_ranks": torch.distributed.get_process_group_ranks(plan.group),
            "region_after": C.spatial_plan() is None}
