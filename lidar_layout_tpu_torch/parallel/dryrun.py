"""Multi-process dry run of the sharded paths, and the spawner it runs on.

Counterpart of ``__graft_entry__.dryrun_multichip`` / ``_dryrun_body`` in
the JAX package. ``dryrun_multichip(n, device)`` starts ``n`` ranks
(``spawn``) and checks, on the tiny flagship and the families' small
configs:

- one flagship training step on a dp x fsdp mesh (fsdp 2 when n >= 4 and
  even, as JAX's), the sharded parameters as ``fsdp_param_sharding`` says,
  the updated parameters equal on every replica;
- a fixed-batch trajectory whose loss falls;
- the spatial (``sp``) part, JAX's rule: sp = 4 when 4 divides n, else 2
  when n is even, else none. On a (dp, fsdp 1, sp) mesh, with the trained
  weights, the W-sharded first-stage encode of a (2, 16, 128, 1) image
  and ``apply_model`` at t = T/2 on a random (2, 4, 16, 8) latent
  (``spatial_forward``), each gathered to the whole width and held against
  the unsharded forward within rtol = atol = 2e-4;
- dp-sharded DDIM gathered over the ranks, returned for the caller to hold
  against one process's DDIM;
- the cube, layout (scene-sharded) and dense families under dp: a few
  steps each, parameters equal across ranks, the layout overfit falling,
  the cube sampler gathered.

On the CPU the ranks talk over gloo; on CUDA over NCCL, one card a rank.

    python -m lidar_layout_tpu_torch.parallel.dryrun --n 4 --device cpu
"""
from __future__ import annotations

import argparse
import os
import socket
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .collectives import all_gather, get_rank, get_world_size, host_all_gather, reduce_mean
from .mesh import (fully_shard_module, init_from_env, local_batch_slice, make_mesh, replicate,
                   seed_rank, shard_batch, spatial_sharding)


# ------------------------------------------------------------------ spawn
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, device, backend, store, args, queue, env):
    os.environ.update(env)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    try:
        init_from_env(device, backend=backend, init_method=store)
        queue.put((rank, True, fn(*args)))
    except BaseException:   # reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence = (), device: str = "cpu",
          backend: Optional[str] = None, env_store: bool = False,
          timeout: float = 600.0) -> List[Any]:
    """Run ``fn(*args)`` in ``world`` new processes, each a rank of one
    process group (``init_from_env``; ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK`` set as ``torchrun`` sets them), and return their results
    in rank order. Results travel pickled after the rank has exited: return
    numpy arrays, not tensors (whose storage the queue would share). The
    ranks meet at a ``file://`` store in a temporary directory, or with
    ``env_store`` at ``MASTER_ADDR``/``MASTER_PORT`` on localhost (a free
    port), as under ``torchrun``. Raises if a rank fails or the ranks
    outlast ``timeout`` seconds; every process is joined or killed."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    env = ({"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port())} if env_store
           else {})
    with tempfile.TemporaryDirectory() as tmp:
        store = None if env_store else f"file://{os.path.join(tmp, 'store')}"
        procs = [ctx.Process(target=_entry, args=(fn, r, world, device, backend, store, args,
                                                  q, env), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        results: Dict[int, Any] = {}
        errors = []
        try:
            while len(results) + len(errors) < world:   # drain before joining
                try:
                    rank, ok, out = q.get(timeout=timeout)
                except queue_mod.Empty:
                    raise RuntimeError(f"spawn: {world - len(results)} rank(s) gave no result "
                                       f"in {timeout} s") from None
                if ok:
                    results[rank] = out
                else:
                    errors.append(f"rank {rank}:\n{out}")
                    break
        finally:
            for p in procs:
                p.join(timeout=30 if not errors else 5)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("spawn: a rank failed\n" + "\n".join(errors))
    return [results[r] for r in range(world)]


# ----------------------------------------------------------------- checks
def params_equal_across_ranks(module: torch.nn.Module) -> bool:
    """Every rank holds bit for bit the same parameters (a gathered copy of
    each full tensor compared with rank 0's)."""
    from ..train.checkpoint import full_tensors

    flat = torch.cat([t.detach().float().reshape(-1).cpu() for t in
                      full_tensors(dict(module.named_parameters())).values()])
    every = host_all_gather(flat.numpy())
    return bool(all(np.array_equal(every[0], e) for e in every[1:]))


def _flagship_batch(global_batch: int, image_shape, seed: int, device) -> Dict[str, torch.Tensor]:
    img = np.random.default_rng(seed).uniform(-1, 1, (global_batch, *image_shape))
    return shard_batch({"image": torch.tensor(img, dtype=torch.float32, device=device)},
                       global_batch)


def dryrun_body(device: str) -> Dict[str, Any]:
    """The dry run in this rank of an initialised process group (every rank
    calls it): rank 0's results (``check_dryrun`` holds them), ``{}`` on the
    others."""
    from ..flagship import flagship
    from ..models.samplers import ddim_sample
    from ..train.diffusion_trainer import (create_train_state, make_optimizer,
                                           make_train_step, trainable_params)
    from ..utils.init import jax_init_

    n, rank = get_world_size(), get_rank()
    dev = torch.device(device) if torch.device(device).type == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())
    seed_rank(0, dev)
    out: Dict[str, Any] = {"world": n}

    # the flagship step on the dp x fsdp mesh
    fsdp = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh(fsdp, device_type=dev.type)
    torch.manual_seed(0)
    model, image_shape = flagship(tiny=True, device=dev)
    jax_init_(model, 0)
    replicate(model)
    spec = fully_shard_module(mesh, model.unet)
    out["mesh"] = {"dp": n // fsdp, "fsdp": fsdp}
    out["sharded"] = sorted(k for k, ax in spec.items() if ax is not None)
    params = trainable_params(model)
    state = create_train_state(model, make_optimizer(params, 1e-4, grad_clip=1.0), params)
    step = make_train_step(model)
    gen = torch.Generator(device=dev).manual_seed(1)
    gb = 2 * n
    state, logs = step(state, _flagship_batch(gb, image_shape, 0, dev), gen)
    out["loss"] = float(logs["loss"])
    out["step_replicas_equal"] = params_equal_across_ranks(model.unet)

    # a fixed-batch trajectory: 8 steps on one global batch must learn
    batch = _flagship_batch(gb, image_shape, 2, dev)
    losses = []
    for i in range(8):
        state, logs = step(state, batch, torch.Generator(device=dev).manual_seed(10 + i % 2))
        losses.append(float(logs["loss"]))
    out["trajectory"] = losses
    out.update(_spatial(dev, model))

    # dp-sharded DDIM (replicated weights), gathered in rank order
    ddim_model, _ = flagship(tiny=True, device=dev)
    jax_init_(ddim_model, 3)
    replicate(ddim_model)
    z = ddim_sample(ddim_model, (gb // n, *ddim_model.cfg.latent_shape), steps=8,
                    generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    out["ddim"] = all_gather(z).flatten(0, 1).cpu().numpy()
    out.update(_cube_family(dev))
    out.update(_layout_family(dev))
    out.update(_dense_family(dev))
    return out if rank == 0 else {}


def sp_size(n: int) -> int:
    """JAX's dry run's sp axis for n ranks: 4 when 4 divides n, else 2 when
    n is even, else 1 (no sp part)."""
    return 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)


@torch.no_grad()
def spatial_forward(model, mesh, image: torch.Tensor, latent: torch.Tensor,
                    t: torch.Tensor):
    """The flagship's first-stage encode of ``image`` (B, H, W, 1) and
    ``apply_model`` of ``latent`` (B, h, w, C) at ``t`` (B,), each run on
    this rank's W shard of ``mesh``'s sp axis (``spatial_sharding``) and
    gathered to the whole width on every rank: (latent, model output),
    NHWC. Every rank of the mesh calls it with the same whole tensors."""
    plan = spatial_sharding(mesh)
    with plan:
        z = model.encode_first_stage(plan.shard(image, 2))
        out = model.apply_model(plan.shard(latent, 2), plan.rows(t))
    return plan.gather(z, 2), plan.gather(out, 2)


def _spatial(dev, trained) -> Dict[str, Any]:
    """The sp part on a copy of the trained flagship (its full tensors):
    the sharded encode and ``apply_model`` gathered, and one process's
    unsharded forward on the same inputs, as numpy."""
    from ..flagship import flagship
    from ..train.checkpoint import full_tensors

    sp = sp_size(get_world_size())
    weights = full_tensors(trained.state_dict())   # a collective: every rank
    if sp == 1:
        return {}
    model, image_shape = flagship(tiny=True, device=dev)
    model.load_state_dict(weights)
    mesh = make_mesh(sp=sp, device_type=dev.type)
    x = torch.tensor(np.random.default_rng(1).standard_normal((2, *image_shape)),
                     dtype=torch.float32, device=dev)
    z_in = torch.tensor(np.random.default_rng(3).standard_normal((2, *model.cfg.latent_shape)),
                        dtype=torch.float32, device=dev)
    t = torch.full((2,), model.cfg.timesteps // 2, dtype=torch.long, device=dev)
    z, eps = spatial_forward(model, mesh, x, z_in, t)
    with torch.no_grad():
        z_ref, eps_ref = model.encode_first_stage(x), model.apply_model(z_in, t)
    return {"sp_mesh": {k: mesh[k].size() for k in mesh.mesh_dim_names},
            **{f"sp_{k}": v.float().cpu().numpy() for k, v in
               (("z", z), ("z_ref", z_ref), ("eps", eps), ("eps_ref", eps_ref))}}


CUBE = dict(cap=64, npts=96, ldim=8, steps=8)


def cube_inputs(global_batch: int, device):
    """The JAX dry run's cube inputs: grids of 64 rows from random clouds
    and latents masked by them (``_dryrun_cube_family``)."""
    from ..ops.voxel import build_grid

    rng = np.random.default_rng(5)
    coords = rng.integers(0, 12, (global_batch, CUBE["npts"], 3))
    pmask = np.arange(CUBE["npts"])[None, :] < rng.integers(60, CUBE["npts"], (global_batch, 1))
    grids = build_grid(torch.tensor(coords, dtype=torch.int32, device=device),
                       torch.tensor(pmask, device=device), CUBE["cap"])[0]
    z0 = torch.tensor(rng.standard_normal((global_batch, CUBE["cap"], CUBE["ldim"])),
                      dtype=torch.float32, device=device) * grids.mask[..., None]
    return grids, z0


def cube_model(device):
    from ..models.cube_diffusion import CubeDiffusion, CubeDiffusionConfig, SparseUNetConfig

    torch.manual_seed(8)
    return CubeDiffusion(CubeDiffusionConfig(timesteps=64, latent_dim=CUBE["ldim"]),
                         SparseUNetConfig(in_channels=CUBE["ldim"], model_channels=16,
                                          num_blocks=1, num_heads=2)).to(device)


def _cube_family(dev) -> Dict[str, Any]:
    from ..ops.voxel import VoxelGrid
    from ..train.diffusion_trainer import Optimizer

    n = get_world_size()
    gb = 2 * n
    grids, z0 = cube_inputs(gb, dev)
    sl = local_batch_slice(gb)
    mine = VoxelGrid(*(f[sl] for f in grids))
    model = replicate(cube_model(dev))
    opt = Optimizer(dict(model.unet.named_parameters()), 3e-3, weight_decay=0.0)
    gen = torch.Generator(device=dev)
    losses = []
    for i in range(CUBE["steps"]):
        gen.manual_seed(100 + i)
        loss, _ = model.p_losses(mine, z0[sl], gen)
        loss.mean().backward()
        opt.step()
        losses.append(float(all_gather(loss.detach()).mean()))
    sample = model.ddim_sample(mine, steps=4, generator=gen.manual_seed(9))
    return {"cube_losses": losses, "cube_replicas_equal": params_equal_across_ranks(model.unet),
            "cube_sample": all_gather(sample).flatten(0, 1).cpu().numpy(),
            "cube_state": {k: v.cpu().numpy() for k, v in model.state_dict().items()}}


def layout_model(device):
    """The JAX dry run's LayoutDiffusion (``_dryrun_layout_family``) without
    the CLIP features: the port's encoder sizes its graph convs for 512-wide
    CLIP features (14.5 M parameters here, against 0.7 M without)."""
    from ..models.layout_diffusion import LayoutDiffusion, LayoutDiffusionConfig
    from ..models.unet1d import UNet1DConfig
    from ..utils.init import jax_init_

    torch.manual_seed(0)
    unet_cfg = UNet1DConfig(model_channels=32, num_res_blocks=1, channel_mult=(1, 1),
                            attention_resolutions=(1,), num_heads=2, concat_dim=64,
                            crossattn_dim=64, gconv_dim=16)
    model = LayoutDiffusion(LayoutDiffusionConfig(timesteps=64), unet_cfg, num_objs=16,
                            num_preds=8, sg_embedding_dim=16, use_clip=False).to(device)
    return jax_init_(model, 0)


def layout_graph(n_scenes: int):
    """Synthetic scene graphs as the JAX dry run draws them (seed 42; the
    CLIP features, which ``layout_model`` does not read, 8 wide)."""
    from ..data.layout_synthetic import synthetic_graph_batch

    return synthetic_graph_batch(np.random.default_rng(42), n_scenes=n_scenes,
                                 num_obj_classes=16, num_pred_classes=8, clip_dim=8)


def _layout_family(dev) -> Dict[str, Any]:
    from ..models.layout_diffusion import angle_to_sincos
    from ..models.schedules import q_sample
    from ..encoders.scene_graph import graph_tensors
    from ..train.diffusion_trainer import Optimizer
    from ..train.layout_trainer import create_layout_train_state, make_layout_train_step
    from .mesh import shard_scene_graph

    n = get_world_size()
    graph = layout_graph(2 * n)
    mine = shard_scene_graph(graph)
    model = replicate(layout_model(dev))
    # the sharded loss at a fixed generator, for the caller to hold against one process's
    gen = torch.Generator(device=dev).manual_seed(3)
    with torch.no_grad():
        loss = float(reduce_mean(model.p_losses(mine, gen)[0]))
    # a fixed-(t, noise) overfit, as JAX's: the rank's boxes of one global draw
    g = graph_tensors(mine, dev)
    boxes = g["dec_boxes"]
    x_start = torch.cat([boxes[:, :-1], angle_to_sincos(boxes[:, -1:])], -1)
    t = torch.full((x_start.shape[0],), 32, dtype=torch.long, device=dev)
    rows = local_batch_slice(len(graph["dec_boxes"]))
    noise = torch.randn((len(graph["dec_boxes"]), x_start.shape[1]),
                        generator=torch.Generator(device=dev).manual_seed(7),
                        device=dev)[rows]
    x_noisy = q_sample(model.schedule, x_start, t, noise)
    opt = Optimizer(dict(model.named_parameters()), 1e-3, weight_decay=0.0)
    losses = []
    for _ in range(8):
        latent, obj_embed = model.encode_graph(g)
        out = model.apply_model(x_noisy, t, obj_embed, g["dec_triples"], latent,
                                g.get("dec_pred_mask"))
        l = ((out - noise) ** 2).mean()
        l.backward()
        opt.step()
        losses.append(float(all_gather(l.detach()).mean()))
    # a few steps of the trainer's own step, then the replicas
    state = create_layout_train_state(model, 1e-4)
    step = make_layout_train_step(model)
    for i in range(2):
        state, _ = step(state, mine, torch.Generator(device=dev).manual_seed(20 + i))
    return {"layout_loss": loss, "layout_overfit": losses,
            "layout_replicas_equal": params_equal_across_ranks(model)}


def _dense_family(dev) -> Dict[str, Any]:
    from ..config import build_ptv3_cfg
    from ..models.gs_decoder import DenseDecoder, GSDecoderConfig
    from ..ops.gaussian_raster import RasterConfig
    from ..ops.lidar import LidarGeometry
    from ..train.train_dense_decoder import (TINY_BACKBONE, create_dense_state,
                                             make_dense_train_step, to_sample)
    from ..utils.init import jax_init_

    geom = LidarGeometry(size=(16, 64), fov=(10, -30))
    torch.manual_seed(0)
    model = DenseDecoder(build_ptv3_cfg(TINY_BACKBONE, in_features=4),
                         GSDecoderConfig(feat_dim=16)).to(dev)
    replicate(jax_init_(model, 0))
    rng = np.random.default_rng(11)
    n = get_world_size()
    pts = rng.uniform(-20, 20, (n, 256, 3)) * np.array([1, 1, 0.1])
    feats = rng.standard_normal((n, 256, 4))
    r = get_rank()
    batch = {"points": torch.tensor(pts[r:r + 1], dtype=torch.float32, device=dev),
             "feats": torch.tensor(feats[r:r + 1], dtype=torch.float32, device=dev),
             "mask": torch.ones((1, 256), dtype=torch.bool, device=dev)}
    state = create_dense_state(model, 1e-4, 1e-2)
    step = make_dense_train_step(model, geom, RasterConfig(chunk=128))
    losses = []
    for i in range(2):
        state, logs = step(state, to_sample(batch, geom), None)
        losses.append(float(reduce_mean(logs["loss"])))
    return {"dense_losses": losses, "dense_replicas_equal": params_equal_across_ranks(model)}


def dryrun_multichip(n: int, device: str = "cpu", timeout: float = 900.0) -> Dict[str, Any]:
    """The dry run in ``n`` ranks on ``device`` ("cpu": gloo; "cuda": NCCL,
    one card a rank); rank 0's results, each check already asserted."""
    return check_dryrun(spawn(dryrun_body, n, (device,), device=device, timeout=timeout)[0])


def check_dryrun(out: Dict[str, Any]) -> Dict[str, Any]:
    """Raise unless the dry run's replicas agree after each step and its
    trajectories fall (the dense losses finite); return ``out``."""
    n = out["world"]
    if not (out["step_replicas_equal"] and out["cube_replicas_equal"]
            and out["layout_replicas_equal"] and out["dense_replicas_equal"]):
        raise AssertionError(f"dryrun_multichip({n}): replicas differ after a step: {out}")
    tr = out["trajectory"]
    if not (np.all(np.isfinite(tr)) and np.mean(tr[-3:]) < np.mean(tr[:3])):
        raise AssertionError(f"dryrun_multichip({n}): the trajectory did not fall: {tr}")
    for key in ("cube_losses", "layout_overfit"):
        c = out[key]
        if not (np.all(np.isfinite(c)) and np.mean(c[-2:]) < np.mean(c[:2])):
            raise AssertionError(f"dryrun_multichip({n}): {key} did not fall: {c}")
    if not np.all(np.isfinite(out["dense_losses"])):
        raise AssertionError(f"dryrun_multichip({n}): dense losses {out['dense_losses']}")
    if ("sp_mesh" in out) != (sp_size(n) > 1):
        raise AssertionError(f"dryrun_multichip({n}): no sp part where JAX's rule gives one")
    for key in ("z", "eps") if "sp_mesh" in out else ():
        got, want = out[f"sp_{key}"], out[f"sp_{key}_ref"]
        if got.shape != want.shape or not np.allclose(got, want, rtol=2e-4, atol=2e-4):
            raise AssertionError(f"dryrun_multichip({n}): the W-sharded {key} differs from "
                                 f"the unsharded forward by {np.abs(got - want).max()}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    out = dryrun_multichip(args.n, args.device)
    sp = (f", sp mesh {out['sp_mesh']}: encode and apply_model W-sharded within "
          f"{max(np.abs(out[f'sp_{k}'] - out[f'sp_{k}_ref']).max() for k in ('z', 'eps')):.2e} "
          f"of the unsharded forward" if "sp_mesh" in out else "")
    print(f"dryrun_multichip({args.n}, {args.device}): mesh {out['mesh']}{sp}, loss "
          f"{out['loss']:.4f}, trajectory {out['trajectory'][0]:.4f} -> "
          f"{out['trajectory'][-1]:.4f}, cube {out['cube_losses'][0]:.4f} -> "
          f"{out['cube_losses'][-1]:.4f}, layout overfit {out['layout_overfit'][0]:.4f} -> "
          f"{out['layout_overfit'][-1]:.4f}, dense {out['dense_losses']}: ok")


if __name__ == "__main__":
    main()
