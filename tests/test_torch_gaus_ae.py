"""PyTorch port vs the JAX package: the Gaussian range autoencoder.

``VQModelGaus`` (its reconstruction and every Gaussian parameter),
``render_range_from_gaussians``, ``s2_loss``, one whole VQ-GAN step with the
s2 branch at steps 0 (GAN terms on) and 2 (off), the val step, and the
``train_lidm`` CLI on ``autoencoder_c2_p4_gaus.yaml``, at small widths
(``ch`` 8, ``ch_mult`` (1, 2), 16x64 images, batch 2) with the YAML's loss
settings (no mask or geometric term, curve 1, disc_weight 0.6). JAX's
jitted step is compiled at ``xla_backend_optimization_level`` 0, as in
``test_torch_ae_train.py``. The JAX trees are drawn with numpy
(``random_flax_params``) and carried by ``ae_train_state_dicts``.
Tolerances: outputs 1e-5 relative L2; loss parts and d_weight 1e-5
relative and 1e-7 absolute (the smoothness term, about 1e-4, sums
differences of neighbouring depths, which cancel); gradients 1e-4
relative L2 (JAX's from Adam's first moment); parameters after Adam within 2 lr, under 1e-3 of the elements with a live
gradient off by more than 0.01 lr.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_layout_tpu.config import instantiate_from_config as jax_instantiate
from lidar_layout_tpu.losses import discriminator as JD
from lidar_layout_tpu.losses import geometric as JGe
from lidar_layout_tpu.losses import vq_loss as JV
from lidar_layout_tpu.models import autoencoder as JAE
from lidar_layout_tpu.models import autoencoder_gaus as JGA
from lidar_layout_tpu.ops.lidar import LidarGeometry as JGeom
from lidar_layout_tpu.train import ae_trainer as JT
from lidar_layout_tpu_torch.config import instantiate_from_config, load_yaml
from lidar_layout_tpu_torch.losses import discriminator as PD
from lidar_layout_tpu_torch.losses import geometric as PGe
from lidar_layout_tpu_torch.losses import vq_loss as PV
from lidar_layout_tpu_torch.models import autoencoder as PAE
from lidar_layout_tpu_torch.models import autoencoder_gaus as PGA
from lidar_layout_tpu_torch.ops.lidar import LidarGeometry as PGeom
from lidar_layout_tpu_torch.train import ae_trainer as PT
from lidar_layout_tpu_torch.train import train_lidm as TL
from lidar_layout_tpu_torch.utils.convert import (ae_train_state_dicts,
                                                  discriminator_state_dict, vq_state_dict)
from torch_port_helpers import nchw, nhwc, one_intra_op_thread, random_flax_params

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "autoencoder", "nuscenes", "autoencoder_c2_p4_gaus.yaml")
SIZE = (16, 64)
JGEO = JGeom(size=SIZE, fov=(10, -30))
PGEO = PGeom(size=SIZE, fov=(10, -30))
AE_KW = dict(ch=8, ch_mult=(1, 2), strides=((1, 2),), z_channels=4, out_ch=1,
             num_res_blocks=1)
N_EMBED, EMBED_DIM, LR = 64, 4, 1e-3
LOSS_KW = dict(mask_factor=0.0, geo_factor=0.0, disc_start=1, curve_length=1, disc_weight=0.6)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / den if den else np.linalg.norm(got)


def _images(seed, b=2):
    """Model-space range images in runs of 8 equal pixels along the scan
    line (so the smoothness mask keeps pixels), some without a return."""
    rng = np.random.default_rng(seed)
    img = np.repeat(rng.uniform(-0.2, 0.8, (b, SIZE[0], SIZE[1] // 8, 1)), 8, axis=2)
    img[rng.uniform(size=img.shape) < 0.1] = -1.0
    return img.astype(np.float32)


@pytest.fixture(scope="module")
def jax_ae():
    model = JGA.VQModelGaus(JAE.AEConfig(**AE_KW), n_embed=N_EMBED, embed_dim=EMBED_DIM)
    disc = JD.LiDARNLayerDiscriminator(ndf=16, n_layers=2)
    cfg = JV.VQLossConfig(**LOSS_KW)
    geo = JGe.GeoConverter(JGEO, curve_length=1)
    params_g = random_flax_params(model.init, 21, jax.random.key(0), jnp.zeros((1, *SIZE, 1)))
    params_d = random_flax_params(disc.init, 22, jax.random.key(1), JV.assemble_disc_input(
        cfg, geo, jnp.zeros((1, *SIZE, 1)), None, True))
    tx_g, tx_d = JT.make_ae_optimizers(LR, LR)
    state = JT.AETrainState(params_g=params_g, params_d=params_d, opt_g=tx_g.init(params_g),
                            opt_d=tx_d.init(params_d), step=jnp.zeros((), jnp.int32))
    b = jnp.zeros((2, *SIZE, 1))
    step = JT.make_ae_train_step(model, disc, cfg, geo, tx_g, tx_d, s2_render=True,
                                 s2_geom=JGEO).lower(state, {"image": b}, jax.random.key(0)
                                                     ).compile(
        {"xla_backend_optimization_level": 0})
    return model, disc, cfg, geo, state, step


def _port_ae(state):
    sd_g, sd_d = ae_train_state_dicts(jax.tree.map(np.array, state))
    model = PGA.VQModelGaus(PAE.AEConfig(**AE_KW), n_embed=N_EMBED, embed_dim=EMBED_DIM)
    model.load_state_dict(sd_g)
    cfg, geo = PV.VQLossConfig(**LOSS_KW), PGe.GeoConverter(PGEO, curve_length=1)
    disc = PD.LiDARNLayerDiscriminator(PT.disc_in_channels(1, cfg, geo), ndf=16, n_layers=2)
    disc.load_state_dict(sd_d)
    return model, disc, cfg, geo, PT.create_ae_state(model, disc, LR, LR)


def test_vq_model_gaus_render_and_s2_loss_match_jax(jax_ae):
    jmodel, _, _, jgeo, state0, _ = jax_ae
    x = _images(3)
    jdec, jdiff, jind, jgaus = jax.jit(lambda p, v: jmodel.apply(p, v))(
        state0.params_g, jnp.asarray(x))
    model, _, _, geo, _ = _port_ae(state0)
    with torch.no_grad():
        dec, diff, ind, gaus = model(nchw(x))
    assert _rel(nhwc(dec), jdec) <= 1e-5 and abs(float(diff) - float(jdiff)) <= 1e-5 * float(jdiff)
    np.testing.assert_array_equal(ind.numpy().reshape(-1), np.asarray(jind).reshape(-1))
    for k in jgaus:
        assert gaus[k].shape == jgaus[k].shape and _rel(gaus[k].numpy(), jgaus[k]) <= 1e-5, k

    want = JGA.render_range_from_gaussians(jdec[..., :1], jgaus, JGEO)
    with torch.no_grad():
        got = PGA.render_range_from_gaussians(dec[:, 0], gaus, PGEO)
    for k in want:
        assert _rel(got[k].numpy(), want[k]) <= 1e-5, k
    assert float(got["alpha"].mean()) > 0.1
    rend = np.clip(np.asarray(want["rendered_range"]), 1.0, 56.0)
    rmodel = (np.log2(rend + 1.0001) / 5.84 * 2 - 1).astype(np.float32)[..., None]
    jl, jparts = JGA.s2_loss(jgeo, jnp.asarray(x), jnp.asarray(rmodel))
    pl, pparts = PGA.s2_loss(geo, nchw(x), nchw(rmodel))
    for k in jparts:   # s2_smooth sums differences of neighbouring depths: 1e-7 absolute
        assert abs(float(pparts[k]) - float(jparts[k])) <= 1e-5 * abs(float(jparts[k])) + 1e-7, k


@pytest.mark.parametrize("step_no", [0, 2])
def test_s2_ae_step_matches_jax(jax_ae, step_no):
    """One step with the s2 branch from the same weights and batch: every
    logged part (the s2 parts included), the generator's and the
    discriminator's gradients and both models after Adam."""
    import dataclasses

    jmodel, jdisc, jcfg, jgeo, state0, jstep = jax_ae
    state0 = dataclasses.replace(state0, step=jnp.asarray(step_no, jnp.int32))
    x = _images(9)
    jstate, jlogs = jstep(state0, {"image": jnp.asarray(x)}, jax.random.key(3))
    model, disc, cfg, geo, state = _port_ae(state0)
    state.step = step_no
    grads = {}
    for name, opt in (("g", state.opt_g), ("d", state.opt_d)):
        def spy(gs, real=opt.step, name=name):
            grads[name] = [g_.clone() for g_ in gs]
            return real(gs)
        opt.step = spy
    state, logs = PT.make_ae_train_step(model, disc, cfg, geo, s2_render=True, s2_geom=PGEO)(
        state, {"image": torch.from_numpy(x)}, torch.Generator())
    assert {"s2_l1", "s2_smooth", "s2_normal", "s2_loss"} <= set(jlogs) <= set(logs)
    for k in jlogs:
        w, g = float(jlogs[k]), float(logs[k])
        assert abs(g - w) <= 1e-5 * abs(w) + 1e-7, (k, g, w)
    on = step_no <= LOSS_KW["disc_start"]

    def first_grad(opt):
        return jax.tree.map(lambda m: 2.0 * np.asarray(m), opt[0].mu)
    want = {"g": vq_state_dict(first_grad(jstate.opt_g)),
            "d": discriminator_state_dict(first_grad(jstate.opt_d))}
    after_g, after_d = ae_train_state_dicts(jstate)
    for name, module, after in (("g", model, after_g), ("d", disc, after_d)):
        names = [n for n, _ in module.named_parameters()]
        got = torch.cat([g_.flatten() for g_ in grads[name]])
        ref = torch.cat([want[name][n].flatten() for n in names])
        if name == "d" and not on:
            assert not got.abs().any() and not ref.abs().any()
            continue
        assert _rel(got.numpy(), ref.numpy()) <= 1e-4, name
        diff = torch.cat([(p.detach() - after[n]).abs().flatten()
                          for n, p in module.named_parameters()])
        live = ref.abs() > 1e-6 * ref.abs().max()
        assert float(diff.max()) <= 2 * LR, name
        assert int((diff[live] > 0.01 * LR).sum()) <= 1e-3 * int(live.sum()), name


def test_gaus_val_step_matches_jax(jax_ae):
    jmodel, _, jcfg, jgeo, state0, _ = jax_ae
    x = {"image": _images(10)}
    want = JT.make_ae_val_step(jmodel, jcfg, jgeo)(
        state0, {k: jnp.asarray(v) for k, v in x.items()}, jax.random.key(0))
    model, _, cfg, geo, state = _port_ae(state0)
    got = PT.make_ae_val_step(model, cfg, geo)(
        state, {k: torch.from_numpy(v) for k, v in x.items()}, torch.Generator())
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * abs(float(want[k])), k


def test_registry_builds_the_gaus_yaml_as_jax():
    cfg = load_yaml(YAML)["model"]
    jm, pm = jax_instantiate(cfg), instantiate_from_config(cfg)
    assert isinstance(pm, PGA.VQModelGaus) and isinstance(jm, JGA.VQModelGaus)
    assert (pm.cfg.ch, pm.cfg.ch_mult, pm.cfg.strides) == (jm.cfg.ch, jm.cfg.ch_mult,
                                                           jm.cfg.strides)
    assert not hasattr(pm.gaus_decoder.tower, "conv_out")   # the tower ends before its head


def test_train_lidm_trains_the_gaus_autoencoder(tmp_path, capsys):
    tiny = ["model.params.ddconfig.ch=8", "model.params.ddconfig.ch_mult=[1,2]",
            "model.params.ddconfig.strides=[[1,2]]", "model.params.ddconfig.num_res_blocks=1",
            "model.params.n_embed=64", "data.params.dataset.size=[16,64]",
            "data.params.batch_size=2", "data.params.num_val_batches=1"]
    run = tmp_path / "run"
    trainer = TL.main(["-b", YAML, "--cpu", "--synthetic", "--steps", "1", "--workdir", str(run)]
                      + tiny)
    state = trainer.state
    assert trainer.global_step == 1 and isinstance(state.model, PGA.VQModelGaus)
    assert (state.opt_g.accumulate, state.opt_d.accumulate) == (2, 2)
    assert not os.path.isdir(run / "images")   # no image logger, as JAX's gaus trainer
    ckpt = torch.load(run / "ckpt" / "step_00000001.pt", weights_only=True)
    assert any(k.startswith("gaus_decoder.tower.") for k in ckpt["state_dict"])
