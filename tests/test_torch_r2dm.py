"""PyTorch port vs the JAX package: R2DM (``r2dm_diffusion.yaml``).

The three coordinate encodings; the ``EfficientUNet`` at a 16x64 image, base
width 8, ``channel_mult`` (1, 2, 4, 8), one block a level, for each
``coords_encoding`` (None, Fourier, spherical harmonics, polar), on JAX's
weights (``random_flax_params``: ``conv_out`` live) carried by
``utils/convert.r2dm_state_dict``, within 1e-5 relative L2; the 2x nearest
upsampling against ``jax.image.resize``; ``p_losses`` with JAX's t and noise
fed in; DDIM-4 from JAX's x_T (``models/samplers`` in pixel space); one
trainer step against ``build_family_trainer``'s (gradients within 1e-4
relative L2, parameters and EMA after AdamW within 2 lr, the EMA at its
warm-up decay 0.1); the registry reading what JAX reads of the YAML; the
factory's ``nusc_r2dm``, synthetic and read from sweeps. JAX's GroupNorm
runs its ``_ref`` on the CPU, the port's K3's plain version.
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
import torch.nn.functional as F

from lidar_layout_tpu.config import instantiate_from_config as jax_instantiate
from lidar_layout_tpu.data import factory as JF
from lidar_layout_tpu.models import r2dm as JR
from lidar_layout_tpu.models.samplers import ddim_sample as jax_ddim
from lidar_layout_tpu.train.build import SimpleTrainState, build_family_trainer
from lidar_layout_tpu_torch.config import instantiate_from_config, load_yaml
from lidar_layout_tpu_torch.data import factory as PF
from lidar_layout_tpu_torch.models import r2dm as PR
from lidar_layout_tpu_torch.models.samplers import ddim_sample
from lidar_layout_tpu_torch.train import family_trainer as FT
from lidar_layout_tpu_torch.utils.convert import r2dm_state_dict
from torch_port_helpers import one_intra_op_thread, random_flax_params, rel_l2

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
T = torch.from_numpy
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, B, LR = 16, 64, 2, 1e-3
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
ENCODINGS = [None, "fourier_features", "spherical_harmonics", "polar_coordinates"]


def _cfg(encoding="fourier_features", **kw):
    return {**dict(image_size=(H, W), base_channels=8, channel_mult=(1, 2, 4, 8),
                   num_res_blocks=1, coords_encoding=encoding, timesteps=100), **kw}


def _pair(encoding, seed=0, **kw):
    jmodel = JR.R2DMDiffusion(JR.R2DMConfig(**_cfg(encoding, **kw)))
    params = jax.tree.map(np.array, random_flax_params(jmodel.init, seed, jax.random.key(0)))
    port = PR.R2DMDiffusion(PR.R2DMConfig(**_cfg(encoding, **kw)))
    port.load_state_dict(r2dm_state_dict(params), strict=True)
    return jmodel, params, port.eval()


def _images(seed=1, b=B):
    return np.random.default_rng(seed).uniform(-1, 1, (b, H, W, 2)).astype(np.float32)


def test_coordinate_encodings_match_jax():
    np.testing.assert_array_equal(PR.coord_encoding(8, 32, 6),
                                  np.asarray(JR.coord_encoding(8, 32, 6)))
    np.testing.assert_array_equal(PR.polar_coord_encoding(8, 32),
                                  np.asarray(JR.polar_coord_encoding(8, 32)))
    got, want = PR.sh_coord_encoding(8, 32, 5), np.asarray(JR.sh_coord_encoding(8, 32, 5))
    assert got.shape == (8, 32, 25)
    np.testing.assert_array_equal(got, want)


def test_nearest_upsampling_matches_jax_image_resize():
    x = np.random.default_rng(2).normal(size=(2, 3, 5, 7)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 6, 10, 7), "nearest")
    got = F.interpolate(T(x).permute(0, 3, 1, 2), scale_factor=2.0, mode="nearest")
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_efficient_unet_matches_jax(encoding):
    jmodel, params, port = _pair(encoding)
    x, t = _images(), np.array([3, 71])
    # jitted: op by op, the first eval of a process takes 24 s on the CPU
    want = jax.jit(jmodel.apply_model)(params, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = port.apply_model(T(x), T(t))
    assert float(np.abs(np.asarray(want)).mean()) > 1e-3      # conv_out is live
    assert rel_l2(got.numpy(), want) <= OUT_TOL
    norms = sum(isinstance(m, PR.Normalize) for m in port.unet.modules())
    assert norms == 2 * 4 + 1 + 2 + 2 * 4 * 2 + 1 + 1    # down, attn, mid, up, attn, out


def test_fresh_port_model_predicts_zero_and_counts_61_norms_at_the_yaml():
    cfg = load_yaml(os.path.join(ROOT, "configs", "r2dm", "r2dm_diffusion.yaml"))["model"]
    model = instantiate_from_config(cfg)
    assert sum(isinstance(m, PR.Normalize) for m in model.unet.modules()) == 61
    small = PR.R2DMDiffusion(PR.R2DMConfig(**_cfg()))
    with torch.no_grad():
        out = small.apply_model(T(_images()), torch.tensor([5, 9]))
    assert torch.count_nonzero(out) == 0


def test_p_losses_with_jax_draws_matches_jax():
    jmodel, params, port = _pair("fourier_features", seed=3)
    x0 = _images(4)
    key = jax.random.key(11)
    want, _ = jax.jit(jmodel.p_losses)(params, key, jnp.asarray(x0))
    r_t, r_n = jax.random.split(key)
    t = np.asarray(jax.random.randint(r_t, (B,), 0, 100))
    noise = np.asarray(jax.random.normal(r_n, x0.shape))
    with torch.no_grad():
        got, logs = port.p_losses(T(x0), t=T(t), noise=T(noise))
    np.testing.assert_allclose(float(got), float(want), rtol=OUT_TOL)
    assert float(logs["loss"]) == float(got)


def test_ddim_from_jax_x_t_matches_jax():
    jmodel, params, port = _pair("fourier_features", seed=5)
    key = jax.random.key(13)
    want = jax_ddim(jmodel, params, key, (B, H, W, 2), steps=4)
    _, r_init = jax.random.split(key)
    x_t = np.asarray(jax.random.normal(r_init, (B, H, W, 2), dtype=jnp.float32))
    with torch.no_grad():
        got = ddim_sample(port, (B, H, W, 2), steps=4, x_T=T(x_t), device="cpu")
    assert got.shape == (B, H, W, 2) and rel_l2(got.numpy(), want) <= OUT_TOL


def test_r2dm_trainer_step_matches_jax():
    """One step of the R2DM trainer against JAX's (``p_losses``,
    ``optax.adamw``, the EMA), JAX's t and noise fed to the port; JAX's
    gradients read from Adam's first moment. A two-level U-Net with its
    attention at level 1 (JAX's jitted step of the four-level one compiles
    for a minute on the CPU)."""
    jmodel, params, port = _pair("fourier_features", seed=6, channel_mult=(1, 2),
                                 attn_levels=(1,))
    cfg = {"target": "r2dm_diffusion", "params": {}}
    ft = build_family_trainer(jmodel, cfg, seed=0, lr=LR, accumulate=1, geom=None)
    assert ft.monitor == "val/loss_simple_ema"
    tx = optax.adamw(LR)
    jstate = SimpleTrainState(params=params, opt_state=tx.init(params), ema=params,
                              step=jnp.zeros((), jnp.int32))
    x0, key = _images(7), jax.random.key(17)
    want_state, want_logs = ft.step(jstate, {"image": jnp.asarray(x0)}, key)
    r_t, r_n = jax.random.split(key)
    t = T(np.asarray(jax.random.randint(r_t, (B,), 0, 100)))
    noise = T(np.asarray(jax.random.normal(r_n, x0.shape)))
    want_g = r2dm_state_dict(jax.tree.map(lambda m: np.asarray(m) * 10.0,
                                          want_state.opt_state[0].mu))

    model = copy.deepcopy(port)
    state, step, val_step, monitor = FT.family_training(model, {}, LR)
    assert monitor == "val/loss_simple_ema" and state.optimizer.grad_clip is None
    assert state.optimizer.adamw.defaults["weight_decay"] == 1e-4
    grads = {}
    real = state.optimizer.step

    def spy():
        grads.update({k: p.grad.detach().clone() for k, p in state.params.items()})
        return real()
    state.optimizer.step = spy
    state, logs = step(state, {"image": T(x0)}, None, t=t, noise=noise)
    np.testing.assert_allclose(float(logs["loss"]), float(want_logs["loss"]), rtol=OUT_TOL)
    assert sorted(grads) == sorted(want_g)
    num = sum(float((grads[k] - want_g[k]).square().sum()) for k in grads)
    den = sum(float(want_g[k].square().sum()) for k in grads)
    assert den > 0 and (num / den) ** 0.5 <= GRAD_TOL
    want_p = r2dm_state_dict(jax.tree.map(np.asarray, want_state.params))
    want_e = r2dm_state_dict(jax.tree.map(np.asarray, want_state.ema))
    perr = max(float((state.params[k].detach() - want_p[k]).abs().max()) for k in want_p)
    eerr = max(float((state.ema.params[k] - want_e[k]).abs().max()) for k in want_e)
    assert perr <= 2 * LR and eerr <= 2 * LR and state.step == 1
    # the EMA after one step: 0.1 of the old weights, 0.9 of the new
    k = "unet.conv_in.weight"
    np.testing.assert_allclose(state.ema.params[k].numpy(),
                               0.1 * params_of(port)[k] + 0.9 * state.params[k].detach().numpy(),
                               rtol=1e-5, atol=1e-7)
    val = val_step(state, {"image": T(x0)}, torch.Generator().manual_seed(0))
    assert np.isfinite(float(val["loss_simple_ema"]))


def params_of(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def test_registry_reads_what_jax_reads():
    cfg = load_yaml(os.path.join(ROOT, "configs", "r2dm", "r2dm_diffusion.yaml"))["model"]
    port, jmodel = instantiate_from_config(cfg), jax_instantiate(cfg)
    assert dataclasses.asdict(port.cfg) == {k: (tuple(v) if isinstance(v, list) else v)
                                            for k, v in dataclasses.asdict(jmodel.cfg).items()}
    assert port.cfg.num_res_blocks == 3 and port.cfg.beta_schedule == "cosine"
    np.testing.assert_array_equal(port.schedule.betas, jmodel.schedule.betas)
    # keys JAX does not read change nothing
    other = copy.deepcopy(cfg)
    other["params"].update(linear_start=0.5, linear_end=0.9)
    other["params"]["unet_config"]["params"].update(attn_num_heads=2,
                                                    coords_encoding="spherical_harmonics")
    assert instantiate_from_config(other).cfg == port.cfg
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == sum(
        p.numel() for p in port.parameters())
    assert instantiate_from_config({"target": "identity"}) is None
    assert instantiate_from_config(cfg["params"]["unet_config"]) == \
        cfg["params"]["unet_config"]["params"]


def _write_samples(root, n=4, seed=0):
    rng = np.random.default_rng(seed)
    meta = os.path.join(root, "v1.0-trainval", "v1.0-trainval")
    os.makedirs(meta)
    d = os.path.join(root, "v1.0-trainval", "samples", "LIDAR_TOP")
    os.makedirs(d)
    entries = []
    for i in range(n):
        name = f"samples/LIDAR_TOP/scan_{i}.pcd.bin"
        scan = np.concatenate([rng.uniform(-40, 40, (2000, 2)), rng.uniform(-3, 2, (2000, 1)),
                               rng.uniform(0, 255, (2000, 1)), np.zeros((2000, 1))], 1)
        scan.astype(np.float32).tofile(os.path.join(root, "v1.0-trainval", name))
        entries.append({"filename": name})
    with open(os.path.join(meta, "sample_data.json"), "w") as f:
        json.dump(entries, f)


def test_nusc_r2dm_batches_equal_jax(tmp_path, capsys):
    dset = {"size": [32, 1024], "fov": [10, -30]}
    want = next(JF.build_batches("nusc_r2dm", {"split": "train"}, dset, None, 2, seed=3))
    got = next(PF.build_batches("nusc_r2dm", {"split": "train"}, dset, None, 2, seed=3))
    assert "nusc_r2dm: no data under None — synthetic fallback" in capsys.readouterr().out
    assert list(got) == ["image"] and got["image"].shape == (2, 32, 1024, 2)
    np.testing.assert_allclose(got["image"].numpy(), want["image"], rtol=0, atol=2e-6)
    _write_samples(str(tmp_path))
    want = JF.build_batches("nusc_r2dm", {"split": "train"}, dset, str(tmp_path), 2, seed=4)
    got = PF.build_batches("nusc_r2dm", {"split": "train"}, dset, str(tmp_path), 2, seed=4)
    for _ in range(3):
        w, g = next(want), next(got)
        assert sorted(g) == sorted(w) == ["image", "proj_points"]
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    assert (w["image"][..., 0] > -1).mean() > 0.05
