"""PyTorch port vs the JAX package: "Ours" stage 1, the coarse 8x256 range
stage, and the AE eval CLI.

At the real widths of ``configs/ours/nuscenes/coarse_range/`` on the CPU in
float32, batch 2: one VQ-GAN step of ``range_256x8.yaml`` (14.4 M
parameters; loss parts, d_weight and both models' gradients) at steps 0
(GAN terms on) and 2 (off), against JAX's step compiled at
``xla_backend_optimization_level`` 0 as ``tests/test_torch_ae_train.py``
does; the LiDM of ``range_uncond_diffusion_64x4.yaml`` (40.6 M parameters):
``apply_model``, a DDIM-3 from JAX's x_T and the decode with its ray-drop
head; ``train/sample_logger.lidm_log_images`` against JAX's with JAX's draws
fed in; ``eval_ae``'s reconstructions and clouds against JAX's on the same
weights; the ``train_lidm`` and ``eval_ae`` CLIs with ``--cpu``. Weights are
seeded (``seed_weights``) or drawn (``random_flax_params``) and carried
across by the converters. Tolerances: loss parts 1e-5 relative, d_weight
1e-4, gradients 1e-4 relative L2 (3e-4 for the generator with the GAN term
on: d_weight's cancellation enters it), model outputs 1e-5 relative L2.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lidar_layout_tpu.config import instantiate_from_config as jax_instantiate
from lidar_layout_tpu.config import load_yaml as jax_load_yaml
from lidar_layout_tpu.data.synthetic import synthetic_range_batch as jax_range_batch
from lidar_layout_tpu.losses import discriminator as JD
from lidar_layout_tpu.losses import geometric as JG
from lidar_layout_tpu.losses import vq_loss as JV
from lidar_layout_tpu.models import samplers as JS
from lidar_layout_tpu.models.autoencoder import apply_raydrop as jax_raydrop
from lidar_layout_tpu.ops import lidar as JL
from lidar_layout_tpu.train import ae_trainer as JT
from lidar_layout_tpu.train.sample_logger import lidm_log_images as jax_log_images
from lidar_layout_tpu_torch import eval_ae as EA
from lidar_layout_tpu_torch.config import instantiate_from_config, load_yaml
from lidar_layout_tpu_torch.losses.discriminator import LiDARNLayerDiscriminator
from lidar_layout_tpu_torch.losses.geometric import GeoConverter
from lidar_layout_tpu_torch.models import samplers as PS
from lidar_layout_tpu_torch.ops import lidar as PL
from lidar_layout_tpu_torch.pipeline import GenerationPipeline, geometry_from_config
from lidar_layout_tpu_torch.train import ae_trainer as PT
from lidar_layout_tpu_torch.train import sample_logger as SL
from lidar_layout_tpu_torch.train import train_lidm as TL
from lidar_layout_tpu_torch.utils.convert import (ae_train_state_dicts,
                                                  discriminator_state_dict, vq_state_dict)
from torch_port_helpers import (jax_ldm_params, jax_vq_params, one_intra_op_thread,
                                random_flax_params, seed_weights)

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
T = torch.from_numpy
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COARSE = os.path.join(ROOT, "configs", "ours", "nuscenes", "coarse_range")
AE_YAML = os.path.join(COARSE, "range_256x8.yaml")
LDM_YAML = os.path.join(COARSE, "range_uncond_diffusion_64x4.yaml")
LR, SIZE, LATENT = 1e-3, (8, 256), (2, 4, 32, 8)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / den if den else np.linalg.norm(got)


def _images(seed, b=2):
    """8x256 model-space range images in runs of 8 equal pixels along the
    scan line, with no-return pixels."""
    rng = np.random.default_rng(seed)
    img = np.repeat(rng.uniform(-0.6, 0.8, (b, SIZE[0], SIZE[1] // 8, 1)), 8, axis=2)
    img[rng.random(img.shape) < 0.1] = -1.0
    return img.astype(np.float32)


# ------------------------------------------------------------- the coarse AE
@pytest.fixture(scope="module")
def coarse_ae():
    """The YAML's VQModel, loss config and 8x256 geometry, JAX's
    discriminator (v1, as its CLI builds it), a train state of drawn
    parameters and JAX's step compiled at optimisation level 0."""
    cfg = jax_load_yaml(AE_YAML)
    model = jax_instantiate(cfg["model"])
    loss_cfg = jax_instantiate(cfg["model"]["params"]["lossconfig"])
    geo = JG.GeoConverter(JL.LidarGeometry(size=SIZE, fov=(10, -30)),
                          curve_length=loss_cfg.curve_length)
    disc = JD.LiDARNLayerDiscriminator()
    x = jnp.zeros((1, *SIZE, 1))
    params_g = random_flax_params(model.init, 21, jax.random.key(0), x)
    params_d = random_flax_params(disc.init, 22, jax.random.key(1),
                                  JV.assemble_disc_input(loss_cfg, geo, x, None, False))
    tx_g, tx_d = JT.make_ae_optimizers(LR, LR)
    state = JT.AETrainState(params_g=params_g, params_d=params_d, opt_g=tx_g.init(params_g),
                            opt_d=tx_d.init(params_d), step=jnp.zeros((), jnp.int32))
    b = jnp.zeros((2, *SIZE, 1))
    args = (state, {"image": b, "mask": b}, jax.random.key(0))
    step = JT.make_ae_train_step(model, disc, loss_cfg, geo, tx_g, tx_d).lower(*args).compile(
        {"xla_backend_optimization_level": 0})
    return state, step


@pytest.mark.parametrize("step_no", [0, 2])
def test_coarse_ae_step_matches_jax(coarse_ae, step_no):
    state0, jstep = coarse_ae
    state0 = dataclasses.replace(state0, step=jnp.asarray(step_no, jnp.int32))
    x = _images(5)
    batch = {"image": x, "mask": np.where(x > -1, 1.0, -1.0).astype(np.float32)}
    jstate, jlogs = jstep(state0, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.key(3))

    cfg = load_yaml(AE_YAML)
    model = instantiate_from_config(cfg["model"])
    assert sum(p.numel() for p in model.parameters()) == 14_431_385
    loss_cfg = instantiate_from_config(cfg["model"]["params"]["lossconfig"])
    geo = GeoConverter(geometry_from_config(cfg), curve_length=loss_cfg.curve_length)
    assert geo.geom.size == SIZE
    disc = LiDARNLayerDiscriminator(PT.disc_in_channels(1, loss_cfg, geo))
    sd_g, sd_d = ae_train_state_dicts(jax.tree.map(np.array, state0))
    model.load_state_dict(sd_g)
    disc.load_state_dict(sd_d)
    state = PT.create_ae_state(model, disc, LR, LR)
    state.step = step_no
    grads = {}
    for name, opt in (("g", state.opt_g), ("d", state.opt_d)):
        def spy(gs, real=opt.step, name=name):
            grads[name] = [g_.clone() for g_ in gs]
            return real(gs)
        opt.step = spy
    state, logs = PT.make_ae_train_step(model, disc, loss_cfg, geo)(
        state, {k: T(v) for k, v in batch.items()}, torch.Generator())
    on = step_no <= loss_cfg.disc_start
    assert (float(logs["disc_loss"]) != 0) == on and set(jlogs) <= set(logs)
    for k in jlogs:
        w, g = float(jlogs[k]), float(logs[k])
        tol = 1e-4 if k == "d_weight" else 1e-5
        assert abs(g - w) <= tol * abs(w) + 1e-7, (k, g, w)
    for name, module, want, tol in (
            ("g", model, vq_state_dict, 3e-4 if on else 1e-4),
            ("d", disc, discriminator_state_dict, 1e-4)):
        opt = jstate.opt_g if name == "g" else jstate.opt_d
        want = want(jax.tree.map(lambda m: 2.0 * np.asarray(m), opt[0].mu))  # (1 - b1) g
        got = torch.cat([g_.flatten() for g_ in grads[name]]).numpy()
        ref = torch.cat([want[n].flatten() for n, _ in module.named_parameters()]).numpy()
        if name == "d" and not on:
            assert not got.any() and not ref.any()
        else:
            assert _rel(got, ref) <= tol, name


# ------------------------------------------------------------ the coarse LiDM
@pytest.fixture(scope="module")
def coarse_ldm():
    cfg = load_yaml(LDM_YAML)
    port = seed_weights(instantiate_from_config(cfg["model"]), 31).eval()
    assert sum(p.numel() for p in port.unet.parameters()) == 26_181_640
    assert sum(p.numel() for p in port.parameters()) // 100_000 == 406   # with the first stage
    jmodel = jax_instantiate(jax_load_yaml(LDM_YAML)["model"])
    return port, jmodel, jax_ldm_params(port)


def test_coarse_ldm_apply_model_ddim3_and_decode_match_jax(coarse_ldm):
    port, jmodel, params = coarse_ldm
    x = np.random.default_rng(2).standard_normal(LATENT).astype(np.float32)
    t = np.array([17, 903])
    with torch.no_grad():
        got = port.apply_model(T(x), T(t)).numpy()
    want = np.asarray(jax.jit(jmodel.apply_model)(params, jnp.asarray(x), jnp.asarray(t)))
    assert _rel(got, want) <= 1e-5
    key = jax.random.key(4)
    x_t = np.array(jax.random.normal(jax.random.split(key)[1], LATENT))
    want_z = JS.ddim_sample(jmodel, params, key, LATENT, steps=3)
    with torch.no_grad():
        z = PS.ddim_sample(port, LATENT, steps=3, x_T=T(x_t), device="cpu")
        img = port.decode_first_stage(z).numpy()
    assert _rel(z.numpy(), want_z) <= 1e-5
    want_img = np.asarray(jax.jit(jmodel.decode_first_stage)(params, jnp.asarray(z.numpy())))
    # use_mask with out_ch 2: the ray-drop head sets its pixels to -1, as JAX's
    assert img.shape == want_img.shape == (2, *SIZE, 1)
    drop, want_drop = img == -1.0, want_img == -1.0
    assert 0 < drop.sum() < drop.size and (drop == want_drop).mean() >= 0.999
    both = ~drop & ~want_drop
    assert _rel(img[both], want_img[both]) <= 1e-5


def test_from_config_takes_the_yaml_geometry():
    pipe = GenerationPipeline.from_config(LDM_YAML, device="cpu")
    g = pipe.geom
    assert (g.size, g.fov, g.depth_range) == ((8, 256), (10, -30), (1.0, 56.0))
    assert pipe.model.first_stage_model.use_mask and pipe.model.cfg.latent_shape == (4, 32, 8)


class _JittedFirstStage:
    """A JAX LatentDiffusion whose encode and decode run jitted: run op by
    op, lidm_log_images' eight decodes take 13 s longer on the CPU."""

    def __init__(self, model):
        self._model = model
        self.encode_first_stage = jax.jit(model.encode_first_stage)
        self.decode_first_stage = jax.jit(model.decode_first_stage)

    def __getattr__(self, name):
        return getattr(self._model, name)


def test_sample_logger_matches_lidm_log_images(coarse_ldm, monkeypatch, tmp_path):
    """Every image set of JAX's ``lidm_log_images`` (DDIM-3 samples,
    inpainting and outpainting) with JAX's draws fed in order."""
    port, jmodel, params = coarse_ldm
    img = _images(7)
    key = jax.random.key(8)
    want = jax_log_images(_JittedFirstStage(jmodel), params, {"image": jnp.asarray(img)}, key,
                          n_row=2, sample_steps=3)
    r_noise, r_samp, r_inp = jax.random.split(key, 3)
    draws = [np.array(jax.random.normal(r_noise, LATENT)),
             np.array(jax.random.normal(jax.random.split(r_samp)[1], LATENT))]
    r_steps, r_init = jax.random.split(r_inp)
    inpaint = [np.array(jax.random.normal(r_init, LATENT))] + [
        np.array(jax.random.normal(k, LATENT)) for k in jax.random.split(r_steps, 4)]
    draws = [T(d) for d in draws + inpaint + inpaint]
    monkeypatch.setattr(PS, "_randn", lambda shape, gen, dev: draws.pop(0))
    got = SL.lidm_log_images(port, {"image": T(img)}, None, n_row=2, sample_steps=3)
    assert not draws and sorted(got) == sorted(want)
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        assert g.shape == w.shape, k
        drop, wdrop = g == -1.0, w == -1.0
        assert (drop == wdrop).mean() >= 0.999, k
        assert _rel(g[~drop & ~wdrop], w[~drop & ~wdrop]) <= 1e-5, k
    assert got["diffusion_row"].shape == (2, 4 * SIZE[0], SIZE[1], 1)
    wrote = SL.save_range_png(str(tmp_path / "x.png"), got["samples"][0, ..., 0].numpy())
    try:
        import matplotlib  # noqa: F401
        assert wrote and os.path.getsize(tmp_path / "x.png") > 0
    except ImportError:
        assert wrote is False


# ------------------------------------------------------------------- eval_ae
def test_eval_ae_reconstructions_match_jax():
    """A ``use_mask`` AE at the coarse widths (the LiDM's first stage) on
    KITTI-geometry scans, as ``scripts/eval_ae.py`` reads them: the
    reconstruction (ray-drop applied) and both clouds against JAX's."""
    fsc = load_yaml(LDM_YAML)["model"]["params"]["first_stage_config"]
    ae_cfg = {"target": "vq_model", "params": {k: v for k, v in fsc["params"].items()
                                                if k != "lossconfig"}}
    port = seed_weights(instantiate_from_config(ae_cfg), 41).eval()
    jmodel = jax_instantiate(ae_cfg)
    params = jax_vq_params(port)
    x = np.array(jax_range_batch(np.random.default_rng(3), 1, JL.KITTI_GEOMETRY)["image"])
    want = np.asarray(jax.jit(lambda p, a: jax_raydrop(jmodel.apply(p, a)[0]))(
        params, jnp.asarray(x)))
    got = EA.reconstruct(port, T(x)).numpy()
    drop, wdrop = got == -1.0, want == -1.0
    assert 0 < drop.sum() and (drop == wdrop).mean() >= 0.999
    assert _rel(got[~drop & ~wdrop], want[~drop & ~wdrop]) <= 1e-5
    gt, rec = EA.reconstruction_clouds(port, iter([{"image": T(x)}]), PL.KITTI_GEOMETRY, 1)
    xyz, valid = JL.range2pcd(jnp.asarray(x[0, ..., 0]), JL.KITTI_GEOMETRY)
    np.testing.assert_allclose(gt[0], np.asarray(xyz)[np.asarray(valid)], atol=1e-5)
    xyz, valid = JL.range2pcd(jnp.asarray(want[0, ..., 0]), JL.KITTI_GEOMETRY)
    assert abs(len(rec[0]) - int(np.asarray(valid).sum())) <= 1e-3 * valid.size


# ----------------------------------------------------------------------- CLIs
def test_train_lidm_cli_coarse_stage_then_eval_ae(tmp_path, capsys):
    """range_256x8.yaml at full width (batch 4, accumulate 2) for 2 steps
    with the image logger; the coarse LiDM over that run's checkpoint (with
    the AE YAML's ddconfig and no mask head, as the flagship's), batch 2, 2
    steps (its image set is ``lidm_log_images``, held to JAX above); then
    eval_ae on the AE run, and without a run on a narrow copy of the YAML.
    eval_ae scores JSD here: CD of one pair of 64x1024 scans (about 60,000
    points each) takes 45 s in K4's plain version on one CPU thread;
    ``chip_smoke.py``'s ``ae_eval`` phase scores CD through K4 on the card."""
    ae_run, ldm_run = str(tmp_path / "ae"), str(tmp_path / "ldm")
    trainer = TL.main(["-b", AE_YAML, "--cpu", "--synthetic", "--steps", "2", "--workdir",
                       ae_run, "data.params.num_val_batches=1",
                       "data.params.sample_every_steps=2"])
    assert trainer.global_step == 2 and trainer.state.opt_g.accumulate == 2
    images = sorted(os.listdir(os.path.join(ae_run, "images")))
    assert {"inputs_0000002.npy", "reconstructions_0000002.npy"} <= set(images)
    assert np.load(os.path.join(ae_run, "images", "reconstructions_0000002.npy")).shape == (
        4, *SIZE, 1)
    ckpt = os.path.join(ae_run, "ckpt", "step_00000002.pt")
    fs = "model.params.first_stage_config.params."
    trainer = TL.main(["-b", LDM_YAML, "--cpu", "--synthetic", "--steps", "2", "--workdir",
                       ldm_run, "data.params.batch_size=2", "data.params.num_val_batches=1",
                       "data.params.sample_every_steps=1000", f"{fs}ckpt_path={ckpt}",
                       f"{fs}use_mask=false", f"{fs}ddconfig.out_ch=1"])
    out = capsys.readouterr().out
    assert f"first_stage weights <- {ckpt}" in out and trainer.global_step == 2
    sd = torch.load(ckpt, weights_only=True)["state_dict"]
    assert all(torch.equal(v, sd[k]) for k, v in
               trainer.state.model.first_stage_model.state_dict().items())
    lines = [json.loads(x) for x in open(os.path.join(ldm_run, "metrics.jsonl"))]
    assert np.isfinite(lines[-1]["val/loss_simple_ema"])

    cfg = load_yaml(AE_YAML)
    cfg["data"]["params"]["batch_size"] = 1        # one 64x1024 scan a batch on the CPU
    small = tmp_path / "ae_b1.yaml"
    small.write_text(yaml.safe_dump(cfg))
    res = EA.main(["-b", str(small), "-r", ae_run, "-n", "1", "--metrics", "jsd", "--cpu"])
    out = capsys.readouterr().out
    assert f"loaded weights from {ae_run}" in out and sorted(res) == ["jsd"]
    assert json.loads(out.strip().splitlines()[-1]) == {k: round(v, 6) for k, v in res.items()}
    assert all(np.isfinite(v) and v >= 0 for v in res.values())
    # narrow, and down to a 16x256 latent: its mid-block attention over
    # 4096 positions, not the 32768 of a single (1, 2) stride
    cfg["model"]["params"]["ddconfig"].update(ch=8, ch_mult=[1, 2, 2], strides=[[2, 2], [2, 2]])
    small.write_text(yaml.safe_dump(cfg))
    res = EA.main(["-b", str(small), "-n", "1", "--metrics", "jsd", "--cpu"])
    assert "WARNING: evaluating randomly initialized AE" in capsys.readouterr().out
    assert np.isfinite(res["jsd"])
