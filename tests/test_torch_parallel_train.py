"""PyTorch port on torch.distributed: FSDP, the VQ-GAN's adaptive weight,
the multi-process dry run and the ``train_lidm`` CLI in several ranks.

Ranks are processes over gloo (``parallel.dryrun.spawn``); their bodies are
``tests/torch_parallel_ranks.py``. Held: the (dp 2, fsdp 2) flagship step
against one process, its sharding against JAX's ``fsdp_param_sharding``
through the converter's names, its clip norm and its checkpoint; the
VQ-GAN step in 2 ranks against JAX's jitted step on the global batch (its
``d_weight`` reads the global batch's gradients); dp-sharded DDIM and the
cube sampler against one process; the CLI's files and its resume.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lidar_layout_tpu.parallel.mesh import fsdp_param_sharding as jax_fsdp_param_sharding
from lidar_layout_tpu.parallel.mesh import make_mesh as jax_make_mesh
from lidar_layout_tpu.utils.torch_convert import convert_unet
from lidar_layout_tpu_torch import config as PC
from lidar_layout_tpu_torch.flagship import flagship
from lidar_layout_tpu_torch.models.samplers import ddim_sample
from lidar_layout_tpu_torch.parallel import dryrun as D
from lidar_layout_tpu_torch.train import checkpoint as CK
from lidar_layout_tpu_torch.train import diffusion_trainer as DT
from lidar_layout_tpu_torch.utils.convert import unet_state_dict
from lidar_layout_tpu_torch.utils.init import jax_init_
from lidar_layout_tpu_torch.losses.vq_loss import (adaptive_weight_from_grads, assemble_disc_input,
                                                   reconstruction_nll)
from test_torch_ae_train import (AE_KW, EMBED_DIM, LOSS_KW, LR, N_EMBED, SIZE, _batch,  # noqa: F401
                                 _port_ae, jax_ae)
from torch_port_helpers import one_intra_op_thread

import torch_parallel_ranks as R

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX = "model.diffusion_model."


def _unet_tree(sd, cfg):
    return convert_unet({k[len(PREFIX):] if k.startswith(PREFIX) else k: np.asarray(v)
                         for k, v in sd.items()},
                        cfg.num_res_blocks, cfg.channel_mult, cfg.num_head_channels, prefix="")


# ----------------------------------------------------------------- FSDP
def test_fsdp_step_matches_one_rank_with_jax_sharding_and_global_clip_norm(tmp_path):
    """(dp 2, fsdp 2) in 4 ranks, global batch 4: the sharded set and axes
    are JAX's ``fsdp_param_sharding`` through the converter's names; the
    loss and the norm before clipping are one process's (a norm of a local
    shard reads about 1/sqrt(2) of it); the parameters after the clipped
    AdamW step are one process's to f32 rounding; the checkpoint the 4 ranks
    wrote restores in one process and crosses to JAX's tree."""
    seed, gen_seed, clip = 31, 5, 0.05
    images = np.random.default_rng(36).uniform(-1, 1, (4, 16, 128, 1)).astype(np.float32)
    ranks = D.spawn(R.fsdp_step, 4, (seed, images, gen_seed, clip, str(tmp_path / "ckpt")))
    r0 = ranks[0]
    port = R.tiny_flagship(seed)
    params = DT.trainable_params(port)
    state = DT.create_train_state(port, DT.make_optimizer(params, 1e-3, grad_clip=clip), params)
    state, logs = DT.make_train_step(port)(state, {"image": torch.from_numpy(images)},
                                           torch.Generator().manual_seed(gen_seed))
    assert float(logs["grad_norm"]) > clip   # the clip is active
    for r in ranks:
        assert r["norm"] == pytest.approx(float(logs["grad_norm"]), rel=1e-5)
        assert r["loss"] == pytest.approx(float(logs["loss"]), rel=1e-5)
    # AdamW's first update is about lr * sign(g): each element within 2 lr,
    # under 1e-3 of them off by more than 0.01 lr (g within rounding of 0,
    # reduced in FSDP's order)
    diff = np.concatenate([np.abs(r0["after"][n] - p.detach().numpy()).ravel()
                           for n, p in params.items()])
    assert diff.max() <= 2e-3 and (diff > 1e-5).sum() <= 1e-3 * diff.size
    # the sharding: FSDP holds what the spec says, and the spec is JAX's
    assert {n for n, ax in r0["spec"].items() if ax is not None} == set(r0["held"])
    assert all(r0["held"][n] == ax for n, ax in r0["spec"].items() if ax is not None)
    assert r0["held"] and r0["plain"]
    names = [n for n, _ in port.unet.named_parameters()]
    cfg = port.unet.cfg
    ids = _unet_tree({n: np.full(p.shape, i, np.float32)
                      for i, (n, p) in enumerate(port.unet.named_parameters())}, cfg)
    jspec = jax_fsdp_param_sharding(jax_make_mesh(jax.devices()[:4], fsdp=2), ids)
    pairs = zip(jax.tree_util.tree_leaves(ids), jax.tree_util.tree_leaves(
        jspec, is_leaf=lambda x: hasattr(x, "spec")))
    seen = set()
    for leaf, sh in pairs:
        name = names[int(np.asarray(leaf).flat[0])]
        seen.add(name)
        spec = tuple(sh.spec) + (None,) * (leaf.ndim - len(sh.spec))
        jax_ax = next((i for i, a in enumerate(spec) if a == "fsdp"), None)
        ax = r0["spec"][name]
        assert (jax_ax is None) == (ax is None), name
        if ax is not None:
            assert leaf.shape[jax_ax] == dict(port.unet.named_parameters())[name].shape[ax], name
    assert seen == set(names)
    # the checkpoint: one file, the one-process format
    files = os.listdir(tmp_path / "ckpt")
    assert files == ["step_00000001.pt"], files
    fresh = R.tiny_flagship(99)
    fp = DT.trainable_params(fresh)
    fstate = DT.create_train_state(fresh, DT.make_optimizer(fp, 1e-3, grad_clip=clip), fp)
    CK.restore_checkpoint(str(tmp_path / "ckpt"), fstate)
    for name, p in fp.items():
        np.testing.assert_array_equal(p.detach().numpy(), r0["after"][name], err_msg=name)
        assert not isinstance(fstate.ema.params[name], type(None))
    sd = CK.latest_run_weights(str(tmp_path))[1]
    tree = _unet_tree({k: v.numpy() for k, v in sd.items() if k.startswith(PREFIX)}, cfg)
    back = unet_state_dict(jax.tree.map(np.asarray, tree), cfg)
    for k, v in back.items():
        assert torch.equal(v, sd[PREFIX + k]), k


# ------------------------------------------------------ the 2-rank checks
def _tiny_yaml(tmp_path):
    cfg = PC.load_yaml(os.path.join(ROOT, "configs/lidar_diffusion/kitti/uncond_c2_p4.yaml"))
    p = cfg["model"]["params"]
    p.update(timesteps=64, image_size=[4, 16])
    p["unet_config"]["params"].update(model_channels=32, num_res_blocks=1,
                                      attention_resolutions=[2], channel_mult=[1, 2],
                                      num_head_channels=8)
    p["first_stage_config"]["params"]["n_embed"] = 256
    p["first_stage_config"]["params"]["ddconfig"].update(ch=16, num_res_blocks=1)
    cfg["data"]["params"]["dataset"]["size"] = [16, 128]
    base = tmp_path / "tiny.yaml"
    base.write_text(yaml.safe_dump(cfg))
    return str(base)


def _cli_argv(base, steps, workdir, *resume):
    return ["-b", base, "--cpu", "--synthetic", "--steps", str(steps), "--workdir", str(workdir),
            "-s", "3", *resume, "data.params.batch_size=2", "data.params.num_val_batches=1",
            "data.params.sample_every_steps=100"]


@pytest.fixture(scope="module")
def two_ranks(jax_ae, tmp_path_factory):
    """Every 2-rank check of this file in one spawn, in order: the VQ-GAN
    step, then train_lidm for 2 steps and its resume to 3 ({key: [rank 0's,
    rank 1's]}, and the CLI's directory)."""
    from lidar_layout_tpu_torch.utils.convert import ae_train_state_dicts

    state0 = jax_ae[4]
    sd_g, sd_d = ae_train_state_dicts(jax.tree.map(np.array, state0))
    kw = dict(ae=AE_KW, n_embed=N_EMBED, embed_dim=EMBED_DIM, loss=LOSS_KW, size=SIZE, lr=LR)
    tmp = tmp_path_factory.mktemp("cli")
    base, work, resumed = _tiny_yaml(tmp), tmp / "run", tmp / "run2"
    todo = [("ae", "ae_step", (sd_g, sd_d, kw, _batch())),
            ("cli", "cli", (_cli_argv(base, 2, work), str(work))),
            ("resume", "cli", (_cli_argv(base, 3, resumed, "-r", str(work)), str(resumed)))]
    ranks = D.spawn(R.jobs, 2, (todo,))
    return {key: [r[key] for r in ranks] for key, _, _ in todo}, tmp


def test_vqgan_step_in_two_ranks_matches_jax_on_the_global_batch(jax_ae, two_ranks):
    """JAX's jitted VQ-GAN step (backend optimisations off, as in
    test_torch_ae_train) on the global batch of 2; the port in 2 ranks of 1:
    every log averaged over the ranks and d_weight, which each rank reads
    from the all-reduced last-layer gradients, within 1e-5 relative (a
    rank-local d_weight is off by far more); both models' parameters after
    Adam within 2 lr of JAX's, and bit-equal across the ranks."""
    from lidar_layout_tpu_torch.utils.convert import (ae_train_state_dicts,
                                                      discriminator_state_dict, vq_state_dict)

    jmodel, jdisc, jcfg, jgeo, state0, jstep = jax_ae
    batch = _batch()
    jstate, jlogs = jstep(state0, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.key(3))
    ranks = two_ranks[0]["ae"]
    assert all(r["replicas_equal"] for r in ranks)
    # d_weight divides two norms of a gradient summed over pixels and images
    # that cancel about 100x: in f32 one batch's conv backward and two
    # ranks' halves summed by the all-reduce round it apart by 7e-4, while
    # in float64 they are equal to the last bit. So it is held to the port's
    # float64 one-process step within 2e-4 and to JAX's f32 step within 2e-3;
    # each rank's own d_weight is 7-30% off (201.9 and 273.4 against 289.6
    # at one state, float64)
    model64, disc64, cfg, geo, _ = _port_ae(state0)
    model64.double().train(), disc64.double().train()
    x, m = (torch.from_numpy(batch[k]).double().permute(0, 3, 1, 2) for k in ("image", "mask"))
    dec = model64(x)[0]
    nll = reconstruction_nll(cfg, geo, x, dec, m)[0]
    g_loss = -torch.mean(disc64(assemble_disc_input(cfg, geo, dec, m, True)))
    w = model64.decoder.conv_out.weight
    d64 = float(adaptive_weight_from_grads(
        *(torch.linalg.vector_norm(torch.autograd.grad(l, w, retain_graph=True)[0])
          for l in (nll, g_loss)), cfg.disc_weight))
    for r in ranks:
        assert abs(r["d_weight"] - d64) <= 2e-4 * d64, (r["d_weight"], d64)
        assert abs(r["d_weight"] - float(jlogs["d_weight"])) <= 2e-3 * d64
        for k in jlogs:
            if k in ("d_weight", "total_loss"):   # total_loss carries d_weight * g_loss
                continue
            w, g = float(jlogs[k]), r["logs"][k]
            assert abs(g - w) <= 1e-5 * abs(w) + 1e-7, (k, g, w)
    after_g, after_d = ae_train_state_dicts(jstate)
    # Adam's first update is about lr * sign(g): a sign flipped where g is
    # within rounding of 0 moves an element by 2 lr (plus the parameter's
    # own f32 rounding). The generator's g carries d_weight times the GAN
    # gradient, and d_weight is 7e-4 apart (above), so an element may flip
    # only where JAX's gradient (2 mu) is within 2e-3 of the model's largest
    # (931 of 135,438 elements do, the largest at 8.8e-4)
    def first_grad(opt):
        return jax.tree.map(lambda m: 2.0 * np.asarray(m), opt[0].mu)
    want_g = vq_state_dict(first_grad(jstate.opt_g))
    want_d = discriminator_state_dict(first_grad(jstate.opt_d))
    for got, after, want in ((ranks[0]["g"], after_g, want_g), (ranks[0]["d"], after_d, want_d)):
        diff = np.concatenate([np.abs(v - after[n].numpy()).ravel() for n, v in got.items()])
        ref = np.abs(np.concatenate([want[n].numpy().ravel() for n in got]))
        off = diff > 0.01 * LR
        assert diff.max() <= 2 * LR + 1e-6
        assert not off.any() or ref[off].max() <= 2e-3 * ref.max()


# ------------------------------------------------------------- the dry run
def test_dryrun_two_ranks_samplers_and_families_match_one_process():
    """The dry run in 2 ranks: the flagship step's replicas, a falling
    trajectory, the cube, layout and dense families; its dp-sharded DDIM-8
    and cube DDIM-4, gathered, equal one process's within 2e-4, and the
    sharded layout loss one process's; its sp part at sp = 2 (JAX's rule
    for 2 devices): the W-sharded encode and apply_model, gathered, within
    2e-4 of the unsharded forward."""
    out = D.dryrun_multichip(2, "cpu")
    assert out["mesh"] == {"dp": 2, "fsdp": 1}
    assert out["sp_mesh"] == {"dp": 1, "fsdp": 1, "sp": 2}
    for key, shape in (("z", (2, 4, 16, 8)), ("eps", (2, 4, 16, 8))):
        assert out[f"sp_{key}"].shape == shape and np.abs(out[f"sp_{key}_ref"]).max() > 0
        np.testing.assert_allclose(out[f"sp_{key}"], out[f"sp_{key}_ref"], rtol=2e-4, atol=2e-4)
    model, _ = flagship(tiny=True, device="cpu")
    jax_init_(model, 3)
    want = ddim_sample(model, (4, *model.cfg.latent_shape), steps=8,
                       generator=torch.Generator().manual_seed(7), device="cpu")
    np.testing.assert_allclose(out["ddim"], want.detach().numpy(), rtol=2e-4, atol=2e-4)
    cube = D.cube_model("cpu")
    cube.load_state_dict({k: torch.from_numpy(v) for k, v in out["cube_state"].items()})
    grids, _ = D.cube_inputs(4, "cpu")
    gen = torch.Generator()
    for i in range(D.CUBE["steps"]):   # the ranks' generator, as the dry run left it
        gen.manual_seed(100 + i)
        torch.randint(0, 64, (4,), generator=gen), torch.randn((4, 64, 8), generator=gen)
    want = cube.ddim_sample(grids, steps=4, generator=gen.manual_seed(9))
    np.testing.assert_allclose(out["cube_sample"], want.numpy(), rtol=2e-4, atol=2e-4)
    lay = D.layout_model("cpu")
    with torch.no_grad():
        want = float(lay.p_losses(D.layout_graph(4), torch.Generator().manual_seed(3))[0])
    assert out["layout_loss"] == pytest.approx(want, rel=2e-4)


# ------------------------------------------------------------------- CLI
def test_train_lidm_in_two_ranks_writes_one_run_that_one_process_reads(two_ranks):
    """train_lidm in 2 ranks (global batch 2): one copy of every file, rank
    0's; the replicas equal; a resume in 2 ranks; the checkpoint read in one
    process (a fresh model loads it strictly) and through the converters."""
    results, tmp = two_ranks
    ranks, work = results["cli"], tmp / "run"
    assert [r["step"] for r in ranks] == [2, 2] and all(r["replicas_equal"] for r in ranks)
    # each rank's default generator is seeded with seed + rank: dropout differs
    assert not np.array_equal(ranks[0]["default_draw"], ranks[1]["default_draw"])
    # a checkpoint (and a best one) a step, no temporary file of another
    # rank, one metrics line a step
    assert ranks[0]["files"] == ranks[1]["files"] == [
        "ckpt/step_00000001.pt", "ckpt/step_00000002.pt", "ckpt_best/step_00000001.pt",
        "ckpt_best/step_00000002.pt", "config.yaml", "metrics.jsonl"]
    # the best checkpoint of a step that wrote one is a link to it: one write
    assert os.path.samefile(work / "ckpt/step_00000002.pt", work / "ckpt_best/step_00000002.pt")
    logged = [json.loads(l) for l in (work / "metrics.jsonl").read_text().splitlines() if l]
    assert [l["step"] for l in logged] == [1, 2] and "val/loss_simple_ema" in logged[0]
    assert [r["step"] for r in results["resume"]] == [3, 3]
    assert all(r["replicas_equal"] for r in results["resume"])
    step, sd = CK.latest_run_weights(str(work))
    model = PC.instantiate_from_config(PC.load_yaml(str(tmp / "tiny.yaml"))["model"])
    model.load_state_dict(sd)
    cfg = model.unet.cfg
    tree = _unet_tree({k: v.numpy() for k, v in sd.items() if k.startswith(PREFIX)}, cfg)
    back = unet_state_dict(jax.tree.map(np.asarray, tree), cfg)
    assert step == 2 and all(torch.equal(v, sd[PREFIX + k]) for k, v in back.items())
