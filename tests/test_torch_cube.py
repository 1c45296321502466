"""PyTorch port vs the JAX package: the cube stage ("Ours" stage 2).

``SparseVAE``, ``struct_loss``, ``VoxelAttention``, ``SparseUNet``,
``CubeDiffusion`` (``p_losses``, ``ddim_sample``), the two family trainers,
the ``nusc_cube`` data target and the CLI, at small sizes: 512 points a
cloud, ``base_capacity`` 128 (levels of 128, 64 and 32 rows), widths 8-32, a
U-Net of width 16. The port batches over clouds; each cloud is held to
JAX's result for that cloud alone. Integers (grids, point-to-voxel maps,
occupancy targets) must be equal, with one cloud past its level-0 capacity
(the overflow merges into the last row) and one within it. Floats are f32
and sum in other orders: outputs within 1e-5 relative L2, losses within
1e-5 relative, gradients within 1e-4 relative L2 (per-cloud means over
rows that cancel), parameters after AdamW within 2 lr, the EMA within 2 lr.
JAX's draws are fed to the port.
"""
import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lidar_layout_tpu.config import instantiate_from_config as jax_instantiate
from lidar_layout_tpu.data import factory as JF
from lidar_layout_tpu.models import cube_diffusion as JCD
from lidar_layout_tpu.models import sparse_vae as JSV
from lidar_layout_tpu.ops import voxel as JV
from lidar_layout_tpu.train.build import SimpleTrainState, build_family_trainer
from lidar_layout_tpu_torch.config import instantiate_from_config, load_yaml
from lidar_layout_tpu_torch.data import factory as PF
from lidar_layout_tpu_torch.models import cube_diffusion as PCD
from lidar_layout_tpu_torch.models import sparse_vae as PSV
from lidar_layout_tpu_torch.ops import voxel as PV
from lidar_layout_tpu_torch.train import cube_trainer as CT
from lidar_layout_tpu_torch.train import train_lidm as TL
from lidar_layout_tpu_torch.utils.convert import (cube_diffusion_state_dict,
                                                  dense_tree_state_dict)
from torch_port_helpers import one_intra_op_thread, random_flax_params

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
T = torch.from_numpy
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, B, LR = 512, 2, 1e-3
OUT_TOL, LOSS_TOL, GRAD_TOL = 1e-5, 1e-5, 1e-4
CUBE_AE = {"target": "cube_ae", "params": {
    "base_capacity": 128, "geoconfig": {"voxel_size": 0.5, "tree_depth": 3},
    "unetconfig": {"params": {"f_maps": 8, "cut_ratio": 16}},
    "lossconfig": {"params": {"baseconfig": {"kl_weight": 0.3}}}}}
CUBE_LDM = {"target": "cube_latent_diffusion", "params": {
    "linear_start": 0.0015, "linear_end": 0.0195, "timesteps": 1000,
    "unet_config": {"params": {"model_channels": 16, "num_res_blocks": 2, "num_heads": 2}},
    "first_stage_config": CUBE_AE}}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _clouds(seed=0):
    """Two clouds of N points, their last 50 masked out: the first within 64
    cells of 0.5 m (under the 128 rows of level 0), the second spread over
    80 m (every point its own cell: past 128)."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-1, 1, (N, 3)), rng.uniform(-40, 40, (N, 3))]).astype(np.float32)
    feats = np.concatenate([pts, rng.uniform(0, 1, (B, N, 1)).astype(np.float32)], -1)
    mask = np.ones((B, N), bool)
    mask[:, -50:] = False
    return {"points": pts, "feats": feats, "mask": mask}


def _same(a, b):
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def _jgrid(grid, b):
    return JV.VoxelGrid(*(jnp.asarray(t[b].numpy()) for t in grid))


@pytest.fixture(scope="module")
def vae_pair():
    """The JAX SparseVAE (from the JAX config) and its tree (seeded values,
    ``to_moments`` scaled by 0.1 to keep the latent's scale moderate), the
    port's from the port config with the same weights, and the clouds."""
    jmodel = jax_instantiate(CUBE_AE)
    clouds = _clouds()
    c0 = {k: jnp.asarray(v[0]) for k, v in clouds.items()}
    params = random_flax_params(jmodel.init, 1, jax.random.key(0), c0["points"], c0["feats"],
                                c0["mask"], jax.random.key(1))
    params = jax.tree.map(np.array, params)
    params["params"]["to_moments"]["kernel"] *= 0.1
    port = instantiate_from_config(CUBE_AE)
    port.load_state_dict(dense_tree_state_dict(params), strict=True)
    return jmodel, params, port, clouds


def _vae_noise(keys, port):
    top = port.cfg.capacity(port.cfg.num_levels - 1)
    return T(np.stack([np.array(jax.random.normal(k, (top, port.cfg.latent_dim)))
                       for k in keys]))


def test_sparse_vae_matches_jax_per_cloud(vae_pair):
    jmodel, params, port, clouds = vae_pair
    assert _same(port.cfg, jmodel.cfg) and port.cfg.channels == (8, 16, 32)
    keys = list(jax.random.split(jax.random.key(5), B))
    with torch.no_grad():
        out = port(*(T(clouds[k]) for k in ("points", "feats", "mask")),
                   noise=_vae_noise(keys, port))
    _, p2v, cells = PV.voxelize_points(T(clouds["points"]), T(clouds["mask"]), 0.5, 128)
    apply = jax.jit(jmodel.apply)
    counts = PV.count_unique(cells, T(clouds["mask"]))
    assert counts[0] <= 128 < counts[1]            # one cloud fits level 0, one overflows
    for b in range(B):
        c = {k: jnp.asarray(v[b]) for k, v in clouds.items()}
        want = apply(params, c["points"], c["feats"], c["mask"], keys[b])
        _, want_p2v, _ = JV.voxelize_points(c["points"], c["mask"], 0.5, 128)
        np.testing.assert_array_equal(p2v[b].numpy(), np.asarray(want_p2v))
        for lvl in range(3):
            for got_t, want_t in zip(out["grids"][lvl], want["grids"][lvl]):
                np.testing.assert_array_equal(got_t[b].numpy(), np.asarray(want_t))
        for got_t, want_t in zip(out["struct_targets"], want["struct_targets"]):
            np.testing.assert_array_equal(got_t[b].numpy(), np.asarray(want_t))
        for key in ("latent_mean", "latent_logvar", "latent", "decoded_feats"):
            assert _rel_l2(out[key][b].numpy(), want[key]) <= OUT_TOL, key
        for got_t, want_t in zip(out["struct_logits"], want["struct_logits"]):
            assert _rel_l2(got_t[b].numpy(), want_t) <= OUT_TOL
        want_loss, want_logs = JSV.struct_loss(want, kl_weight=0.3)
        got_loss, got_logs = PSV.struct_loss(out, kl_weight=0.3)
        np.testing.assert_allclose(float(got_loss[b]), float(want_loss), rtol=LOSS_TOL)
        for k, v in want_logs.items():
            np.testing.assert_allclose(float(got_logs[k][b]), float(v), rtol=LOSS_TOL)
    assert int(out["grids"][0].mask[1].sum()) == 128        # full, as at full config


def test_optax_sigmoid_bce_is_the_log_sigmoid_form():
    logits = np.array([-120.0, -3.0, 0.0, 2.5, 120.0], np.float32)
    labels = np.array([0.0, 1.0, 1.0, 0.0, 1.0], np.float32)
    want = np.asarray(JSV.optax_sigmoid_bce(jnp.asarray(logits), jnp.asarray(labels)))
    got = PSV.optax_sigmoid_bce(T(logits), T(labels)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.isfinite(got).all() and got[0] == 0.0 and got[4] == 0.0


def _jax_vae_state(params):
    tx = optax.adamw(LR)
    return SimpleTrainState(params=params, opt_state=tx.init(params), ema=params,
                            step=jnp.zeros((), jnp.int32))


def _check_step(state, grads, logs, want_loss, want_state, want_grads, convert, prefix=""):
    """The port's step against JAX's: loss, gradients (relative L2 over all),
    parameters after AdamW, EMA (decay 0.1 at step 0)."""
    np.testing.assert_allclose(float(logs["loss"]), float(want_loss), rtol=LOSS_TOL)
    want_g = {prefix + k: v for k, v in convert(want_grads).items()}
    assert sorted(want_g) == sorted(grads)
    num = sum(float((grads[k] - want_g[k]).square().sum()) for k in grads)
    den = sum(float(want_g[k].square().sum()) for k in grads)
    assert den > 0 and (num / den) ** 0.5 <= GRAD_TOL
    want_p = {prefix + k: v for k, v in convert(jax.tree.map(np.asarray, want_state.params))
              .items()}
    want_e = {prefix + k: v for k, v in convert(jax.tree.map(np.asarray, want_state.ema))
              .items()}
    upd = torch.cat([(state.params[k].detach() - want_p[k]).abs().flatten() for k in want_g])
    assert float(upd.max()) <= 2 * LR and float((upd > 0.01 * LR).float().mean()) <= 1e-2
    eerr = max(float((state.ema.params[k] - want_e[k]).abs().max()) for k in want_g)
    assert eerr <= 2 * LR and state.step == 1 and CT.ema_decay(0) == pytest.approx(0.1)


def _spy(state):
    grads = {}
    real = state.optimizer.step

    def spy():
        grads.update({k: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                      for k, p in state.params.items()})
        return real()
    state.optimizer.step = spy
    return grads


def test_struct_loss_gradients_and_vae_trainer_step_match_jax(vae_pair):
    """One step of the SparseVAE trainer against JAX's (``build_family_trainer``:
    the mean over clouds of ``struct_loss``, ``optax.adamw``, the EMA);
    JAX's gradients read from Adam's first moment (0.1 g after one step)."""
    jmodel, params, port, clouds = vae_pair
    ft = build_family_trainer(jmodel, CUBE_AE, seed=0, lr=LR, accumulate=2, geom=None)
    assert ft.monitor == "val/struct_loss"
    key = jax.random.key(7)
    jbatch = {k: jnp.asarray(v) for k, v in clouds.items()}
    want_state, want_logs = ft.step(_jax_vae_state(params), jbatch, key)
    want_grads = jax.tree.map(lambda m: np.asarray(m) * 10.0, want_state.opt_state[0].mu)

    port = copy.deepcopy(port)
    state, step, val_step, monitor = CT.cube_training(port, CUBE_AE, LR)
    assert monitor == "val/struct_loss" and set(state.params) == set(port.state_dict())
    assert state.optimizer.adamw.defaults["weight_decay"] == 1e-4
    grads = _spy(state)
    state, logs = step(state, {k: T(v) for k, v in clouds.items()}, None,
                       noise=_vae_noise(list(jax.random.split(key, B)), port))
    for k in ("kl", "struct_ce_0", "struct_ce_1"):
        np.testing.assert_allclose(float(logs[k]), float(want_logs[k]), rtol=LOSS_TOL)
    _check_step(state, grads, logs, want_logs["loss"], want_state, want_grads,
                dense_tree_state_dict)
    val = val_step(state, {k: T(v) for k, v in clouds.items()}, torch.Generator())
    assert np.isfinite(float(val["struct_loss"]))


def test_voxel_attention_with_padded_grids_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 40, 8)).astype(np.float32)
    mask = np.ones((B, 40), bool)
    mask[0, 30:] = False                   # a padded grid
    mask[1, 1:] = False                    # one valid voxel
    jatt = JCD.VoxelAttention(2)
    params = random_flax_params(jatt.init, 4, jax.random.key(0), jnp.asarray(x[0]),
                                jnp.asarray(mask[0]))
    att = PCD.VoxelAttention(8, 2)
    att.load_state_dict(dense_tree_state_dict(params), strict=True)
    with torch.no_grad():
        got = att(T(x), T(mask)).numpy()
    for b in range(B):
        want = np.asarray(jatt.apply(params, jnp.asarray(x[b]), jnp.asarray(mask[b])))
        assert _rel_l2(got[b], want) <= OUT_TOL
        assert not got[b][~mask[b]].any()


@pytest.fixture(scope="module")
def ldm_pair(vae_pair):
    """The JAX CubeDiffusion (JAX config) and its tree, the port's (port
    config) with the same U-Net and first stage, and the first stage's
    latent grids of the clouds."""
    _, vae_params, vae, clouds = vae_pair
    jmodel = jax_instantiate(CUBE_LDM)
    port = instantiate_from_config(CUBE_LDM)
    with torch.no_grad():
        out = vae(*(T(clouds[k]) for k in ("points", "feats", "mask")),
                  noise=torch.zeros(B, 32, 4))
    grid = out["latent_grid"]
    params = jax.tree.map(np.array, random_flax_params(
        lambda k, g: jmodel.init(k, g), 2, jax.random.key(0), _jgrid(grid, 0)))
    port.load_state_dict(cube_diffusion_state_dict(params, vae_params), strict=True)
    return jmodel, params, port, grid, out["latent"]


def test_sparse_unet_takes_each_grid_own_position_scale(ldm_pair):
    jmodel, params, port, grid, z = ldm_pair
    maxima = grid.coords.amax(dim=(1, 2))
    assert maxima[0] != maxima[1]          # the batch's max would rescale the first grid
    t = torch.tensor([[17] * 32, [901] * 32])
    with torch.no_grad():
        got = port.unet(grid, z, t).numpy()
        alone = port.unet(PV.VoxelGrid(*(a[:1] for a in grid)), z[:1], t[:1]).numpy()
    np.testing.assert_allclose(alone[0], got[0], rtol=1e-6, atol=1e-6)
    for b in range(B):
        want = jmodel.unet.apply(params["unet"], _jgrid(grid, b), jnp.asarray(z[b].numpy()),
                                 jnp.asarray(t[b].numpy()))
        assert _rel_l2(got[b], want) <= OUT_TOL


def test_fresh_cube_diffusion_starts_where_jax_init_does(ldm_pair):
    """JAX initialises ``VoxelAttention.proj`` and the U-Net's ``out`` at
    zero: a fresh denoiser outputs zeros and every attention block is the
    identity on valid rows. The port's fresh model zeros the same Dense
    layers (weights and biases), and both hold exactly."""
    jmodel, _, _, grid, z = ldm_pair
    jinit = jmodel.init(jax.random.key(1), _jgrid(grid, 0))
    zero_j = {k for k, v in dense_tree_state_dict(jinit["unet"]).items()
              if k.endswith(".weight") and not v.any()}
    torch.manual_seed(0)
    fresh = instantiate_from_config(CUBE_LDM)
    sd = fresh.unet.state_dict()
    zero_p = {k for k, v in sd.items() if k.endswith(".weight") and not v.any()}
    attn = [f"attn_{i}" for i in range(1, fresh.unet.cfg.num_blocks, 2)]
    assert attn and zero_j == zero_p == {f"{a}.proj.weight" for a in attn} | {"out.weight"}
    assert not any(sd[k[:-len("weight")] + "bias"].any() for k in zero_p)
    t = torch.tensor([[17] * 32, [901] * 32])
    x = torch.randn(z.shape[:2] + (16,))
    with torch.no_grad():
        assert not fresh.unet(grid, z, t).any()
        for name in attn:
            got = getattr(fresh.unet, name)(x, grid.mask)
            assert torch.equal(got, x * grid.mask[..., None])


def test_p_losses_and_ddim_sample_match_jax_with_fed_draws(ldm_pair):
    jmodel, params, port, grid, z = ldm_pair
    keys = list(jax.random.split(jax.random.key(11), B))
    with torch.no_grad():
        for b in range(B):
            jg, jz = _jgrid(grid, b), jnp.asarray(z[b].numpy())
            want, _ = jmodel.p_losses(params, keys[b], jg, jz)
            r_t, r_n = jax.random.split(keys[b])
            t = int(jax.random.randint(r_t, (), 0, 1000))
            noise = np.array(jax.random.normal(r_n, z[b].shape))
            got, logs = port.p_losses(PV.VoxelGrid(*(a[b:b + 1] for a in grid)), z[b:b + 1],
                                      t=torch.tensor([t]), noise=T(noise)[None])
            np.testing.assert_allclose(float(got[0]), float(want), rtol=LOSS_TOL)
        x_t = np.stack([np.array(jax.random.normal(jax.random.split(k)[1], (32, 4)))
                        for k in keys])
        got = port.ddim_sample(grid, steps=5, x_T=T(x_t))
    for b in range(B):
        want = jmodel.ddim_sample(params, keys[b], _jgrid(grid, b), steps=5)
        assert _rel_l2(got[b].numpy(), want) <= OUT_TOL
        assert not got[b][~grid.mask[b]].any()


def test_cube_diffusion_trainer_step_matches_jax(ldm_pair, vae_pair):
    """One step of the CubeDiffusion trainer against JAX's: encode with the
    frozen first stage, ``p_losses`` per grid, AdamW and the EMA over the
    U-Net only."""
    jmodel, params, port, _, _ = ldm_pair
    _, vae_params, _, clouds = vae_pair
    ft = build_family_trainer(jmodel, CUBE_LDM, seed=0, lr=LR, accumulate=2, geom=None)
    assert ft.monitor == "val/loss_simple_ema"
    tx = optax.adamw(LR)
    dp = jax.tree.map(jnp.asarray, params)
    jstate = SimpleTrainState(params={"diffusion": dp, "first_stage": vae_params},
                              opt_state=tx.init(dp), ema=dp, step=jnp.zeros((), jnp.int32))
    key = jax.random.key(13)
    want_state, want_logs = ft.step(jstate, {k: jnp.asarray(v) for k, v in clouds.items()}, key)
    want_grads = jax.tree.map(lambda m: np.asarray(m) * 10.0, want_state.opt_state[0].mu)
    want_state = want_state.replace(params=want_state.params["diffusion"])

    # JAX's draws: the latents' from split(key, B), t's and the noise's from
    # split(fold_in(key, 1), B), each split in two
    latent_noise = _vae_noise(list(jax.random.split(key, B)), port.first_stage_model)
    ts, noise = [], []
    for k in jax.random.split(jax.random.fold_in(key, 1), B):
        r_t, r_n = jax.random.split(k)
        ts.append(int(jax.random.randint(r_t, (), 0, 1000)))
        noise.append(np.array(jax.random.normal(r_n, (32, 4))))
    port = copy.deepcopy(port)
    state, step, val_step, monitor = CT.cube_training(port, CUBE_LDM, LR)
    assert monitor == "val/loss_simple_ema"
    assert set(state.params) == {k for k in port.state_dict() if k.startswith("unet.")}
    grads = _spy(state)
    fs0 = {k: v.clone() for k, v in port.first_stage_model.state_dict().items()}
    state, logs = step(state, {k: T(v) for k, v in clouds.items()}, None,
                       latent_noise=latent_noise, t=torch.tensor(ts), noise=T(np.stack(noise)))
    _check_step(state, grads, logs, want_logs["loss"], want_state, want_grads,
                lambda p: cube_diffusion_state_dict(p), prefix="")
    assert all(torch.equal(v, port.first_stage_model.state_dict()[k]) for k, v in fs0.items())
    val = val_step(state, {k: T(v) for k, v in clouds.items()}, torch.Generator())
    assert np.isfinite(float(val["loss_simple_ema"]))


def test_nusc_cube_synthetic_batches_equal_jax(capsys):
    params = {"split": "train", "max_points": 700}
    want = next(JF.build_batches("nusc_cube", params, {}, None, 2, seed=3))
    got = next(PF.build_batches("nusc_cube", params, {}, None, 2, seed=3))
    assert "nusc_cube: no sweeps under None — synthetic fallback" in capsys.readouterr().out
    assert sorted(got) == sorted(want) == ["feats", "mask", "points"]
    for k in want:
        assert got[k].dtype == T(want[k]).dtype
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def _write_sweeps(root, n=5, seed=0):
    """A nuScenes-like root: sample_data.json naming ``n`` sweeps and 2
    samples; N x 5 float32 scans, some points outside the crop."""
    rng = np.random.default_rng(seed)
    meta = os.path.join(root, "v1.0-trainval", "v1.0-trainval")
    os.makedirs(meta)
    entries = []
    for kind, count in (("sweeps", n), ("samples", 2)):
        d = os.path.join(root, "v1.0-trainval", kind, "LIDAR_TOP")
        os.makedirs(d)
        for i in range(count):
            name = f"{kind}/LIDAR_TOP/scan_{i}.pcd.bin"
            scan = rng.uniform(-80, 80, (int(rng.integers(600, 900)), 5)).astype(np.float32)
            scan.tofile(os.path.join(root, "v1.0-trainval", name))
            entries.append({"filename": name})
    with open(os.path.join(meta, "sample_data.json"), "w") as f:
        json.dump(entries, f)


def test_nusc_cube_reads_sweeps_as_jax(tmp_path):
    _write_sweeps(str(tmp_path))
    params = {"split": "train", "max_points": 800}
    dset = {"point_cloud_range": [-51.2, -51.2, -51.2, 51.2, 51.2, 51.2]}
    want = JF.build_batches("nusc_cube", params, dset, str(tmp_path), 2, seed=4)
    got = PF.build_batches("nusc_cube", params, dset, str(tmp_path), 2, seed=4)
    for _ in range(3):
        w, g = next(want), next(got)
        assert w["mask"].sum(1).max() < 800 and not w["mask"].all()   # cropped, padded
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    ds = PF.CloudDataset([os.path.join(str(tmp_path), "v1.0-trainval", "samples", "LIDAR_TOP",
                                       "scan_0.pcd.bin")], None, 100,
                         lambda p: np.fromfile(p, np.float32).reshape(-1, 5)[:, :3])
    item = ds[0]
    assert item["feats"].shape == (100, 3) and item["mask"].all()


@pytest.mark.parametrize("yaml", ["refine_voxel/voxel_1024.yaml", "autoencoder_cube.yaml"])
def test_registry_builds_the_cube_yamls_as_jax(yaml):
    path = (os.path.join(ROOT, "configs", "ours", "nuscenes", yaml) if "/" in yaml else
            os.path.join(ROOT, "configs", "autoencoder", "nuscenes", yaml))
    cfg = load_yaml(path)["model"]
    port, jmodel = instantiate_from_config(cfg), jax_instantiate(cfg)
    assert _same(port.cfg, jmodel.cfg)
    ldm = load_yaml(os.path.join(ROOT, "configs", "ours", "nuscenes", "refine_voxel",
                                 "voxel_uncond_diffusion_256.yaml"))["model"]
    p, j = instantiate_from_config(ldm), jax_instantiate(ldm)
    assert _same(p.cfg, j.cfg) and _same(p.unet.cfg, j.unet.cfg)
    assert _same(p.first_stage_model.cfg, jax_instantiate(ldm["params"]["first_stage_config"]).cfg)
    assert sum(x.numel() for x in p.first_stage_model.parameters()) > 0


SHRINK = ["model.params.base_capacity=128", "model.params.unetconfig.params.f_maps=8",
          "data.params.batch_size=2", "data.params.num_val_batches=1",
          "data.params.train.params.max_points=600",
          "data.params.validation.params.max_points=600"]


def test_train_lidm_cli_trains_the_cube_stage(tmp_path, capsys):
    """voxel_1024.yaml, then voxel_uncond_diffusion_256.yaml over that run
    (its first stage loads the run's weights), then autoencoder_cube.yaml;
    shrunk by dotlist overrides, on the CPU."""
    refine = os.path.join(ROOT, "configs", "ours", "nuscenes", "refine_voxel")
    ae_run, ldm_run = str(tmp_path / "ae"), str(tmp_path / "ldm")
    trainer = TL.main(["-b", os.path.join(refine, "voxel_1024.yaml"), "--cpu", "--synthetic",
                       "--steps", "2", "--workdir", ae_run, *SHRINK])
    assert trainer.global_step == 2 and isinstance(trainer.state.model, PSV.SparseVAE)
    assert sorted(os.listdir(os.path.join(ae_run, "ckpt"))) == ["step_00000001.pt",
                                                                  "step_00000002.pt"]
    lines = [json.loads(x) for x in open(os.path.join(ae_run, "metrics.jsonl"))]
    assert np.isfinite(lines[-1]["val/struct_loss"])
    fs = "model.params.first_stage_config.params."
    trainer = TL.main(["-b", os.path.join(refine, "voxel_uncond_diffusion_256.yaml"), "--cpu",
                       "--synthetic", "--steps", "2", "--workdir", ldm_run,
                       f"{fs}ckpt_path={ae_run}", f"{fs}base_capacity=128",
                       f"{fs}unetconfig.params.f_maps=8",
                       "model.params.unet_config.params.model_channels=16", *SHRINK[2:]])
    assert f"first_stage weights <- {ae_run}" in capsys.readouterr().out
    ae_sd = torch.load(os.path.join(ae_run, "ckpt", "step_00000002.pt"),
                       weights_only=True)["model"]
    fs_sd = trainer.state.model.first_stage_model.state_dict()
    assert all(torch.equal(fs_sd[k], v) for k, v in ae_sd.items())
    lines = [json.loads(x) for x in open(os.path.join(ldm_run, "metrics.jsonl"))]
    assert np.isfinite(lines[-1]["val/loss_simple_ema"])
    trainer = TL.main(["-b", os.path.join(ROOT, "configs", "autoencoder", "nuscenes",
                                          "autoencoder_cube.yaml"), "--cpu", "--synthetic",
                       "--steps", "1", "--workdir", str(tmp_path / "cube"), *SHRINK])
    assert trainer.global_step == 1 and trainer.state.model.cfg.voxel_size == 0.2
