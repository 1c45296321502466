"""PyTorch port vs the JAX package: "Ours" stage 3, the dense decoder.

``eval_sh``; the three rasterizers (``rasterize``, ``rasterize_surfels``,
``rasterize_banded``) on a 16x64 panorama with 300 Gaussians, with and
without one on the azimuth seam, forward and gradients; ``GSDecoder``,
``render_surfels`` under each raster config and ``gs_loss``; one
``train_dense_decoder`` step at the CLI's ``--tiny`` config (loss, every
gradient, the parameters after clip + AdamW) and the CLI itself; the
transform pipeline and the ``nusc_cube_decode`` data target, including
``gaus_10cm.yaml``'s ``transform`` block, which raises TypeError in both
packages. The same numpy inputs on both sides; JAX trees drawn with numpy
(``random_flax_params``) and carried by ``dense_tree_state_dict``.
Tolerances (f32, sums in other orders): outputs 1e-5 relative L2,
gradients 1e-4 relative L2, losses 1e-5 relative, the rasterizers'
integer outputs (the banded overflow) equal.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lidar_layout_tpu.config import instantiate_from_config as jax_instantiate
from lidar_layout_tpu.data import factory as JF
from lidar_layout_tpu.data import transforms as JT
from lidar_layout_tpu.models import gs_decoder as JG
from lidar_layout_tpu.ops import gaussian_raster as JR
from lidar_layout_tpu.ops import gaussian_raster_tiled as JRT
from lidar_layout_tpu.ops.lidar import LidarGeometry as JGeom
from lidar_layout_tpu.ops.lidar import pcd2range as j_pcd2range
from lidar_layout_tpu.ops.sh import eval_sh as j_eval_sh
from lidar_layout_tpu_torch.config import instantiate_from_config, load_yaml
from lidar_layout_tpu_torch.data import factory as PF
from lidar_layout_tpu_torch.data import transforms as PT
from lidar_layout_tpu_torch.models import gs_decoder as PG
from lidar_layout_tpu_torch.ops import gaussian_raster as PR
from lidar_layout_tpu_torch.ops import gaussian_raster_tiled as PRT
from lidar_layout_tpu_torch.ops.lidar import LidarGeometry as PGeom
from lidar_layout_tpu_torch.ops.sh import eval_sh
from lidar_layout_tpu_torch.train import train_dense_decoder as TD
from lidar_layout_tpu_torch.utils.convert import dense_tree_state_dict
from test_torch_cube import _write_sweeps
from torch_port_helpers import one_intra_op_thread, random_flax_params

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "ours", "nuscenes", "dense_decoder", "gaus_10cm.yaml")
SIZE = (16, 64)
JGEO, PGEO = JGeom(size=SIZE, fov=(10, -30)), PGeom(size=SIZE, fov=(10, -30))
OUT_TOL, GRAD_TOL, LOSS_TOL = 1e-5, 1e-4, 1e-5
RASTERS = {"rasterize": (JR.rasterize, PR.rasterize, JR.RasterConfig(chunk=64),
                         PR.RasterConfig(chunk=64)),
           "rasterize_surfels": (JR.rasterize_surfels, PR.rasterize_surfels,
                                 JR.SurfelConfig(chunk=64), PR.SurfelConfig(chunk=64)),
           "rasterize_banded": (JRT.rasterize_banded, PRT.rasterize_banded,
                                JRT.BandedConfig(band_w=16, capacity=96, chunk=32),
                                PRT.BandedConfig(band_w=16, capacity=96, chunk=32))}


def T(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _gaussians(seed, n=300, seam=False):
    """n Gaussians 3-20 m out within the field of view, the last 20 masked;
    with ``seam`` the first sits on the azimuth seam (behind the sensor,
    u within a pixel of 0 and W) and is large enough to cover both edges."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(3, 20, n)
    az = rng.uniform(-np.pi, np.pi, n)
    el = np.deg2rad(rng.uniform(-28, 8, n))
    means = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                      r * np.sin(el)], -1)
    quats = rng.standard_normal((n, 4))
    scales = rng.uniform(0.05, 0.6, (n, 3))
    if seam:
        means[0] = [-8.0, 0.01, -0.5]
        scales[0] = [0.5, 0.5, 0.5]
    opac = rng.uniform(0.2, 0.95, n)
    feats = rng.uniform(0, 1, (n, 2))
    mask = np.ones(n, bool)
    mask[-20:] = False
    return [a.astype(np.float32) for a in (means, quats, scales, opac, feats)] + [mask]


def test_eval_sh_matches_jax():
    rng = np.random.default_rng(0)
    sh = rng.standard_normal((50, 4, 16)).astype(np.float32)
    d = rng.standard_normal((50, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    for deg in range(4):
        want = np.asarray(j_eval_sh(deg, jnp.asarray(sh), jnp.asarray(d)))
        assert _rel(eval_sh(deg, T(sh), T(d)).numpy(), want) <= 1e-6


@pytest.mark.parametrize("seam", [False, True])
@pytest.mark.parametrize("name", sorted(RASTERS))
def test_rasterizers_and_their_gradients_match_jax(name, seam):
    """Every output, and the gradients for every input of a weighted sum of
    them (the azimuth-wrapped offsets and the surfels' hit depths
    included)."""
    jfn, pfn, jcfg, pcfg = RASTERS[name]
    *arrays, mask = _gaussians(1, seam=seam)
    keys = ("feature", "alpha", "depth", "transmittance")
    wts = {k: np.random.default_rng(2).standard_normal(
        (*SIZE, 2) if k == "feature" else SIZE).astype(np.float32) for k in keys}

    def jloss(*a):
        out = jfn(*a, JGEO, mask=jnp.asarray(mask), cfg=jcfg)
        return sum(jnp.sum(out[k] * wts[k]) for k in keys), out
    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(a) for a in arrays))
    ins = [T(a).requires_grad_() for a in arrays]
    got = pfn(*ins, PGEO, mask=T(mask), cfg=pcfg)
    loss = sum(torch.sum(got[k] * T(wts[k])) for k in keys)
    grads = torch.autograd.grad(loss, ins)
    for k in keys:
        assert _rel(got[k].detach().numpy(), want[k]) <= OUT_TOL, k
    if name == "rasterize_banded":
        assert int(got["overflow"]) == int(want["overflow"]) > 0
    for part, g, w in zip(("means", "quats", "scales", "opacities", "features"), grads, jgrads):
        assert _rel(g.numpy(), w) <= GRAD_TOL, part
    if seam:   # the seam Gaussian lights both edge columns
        a = got["alpha"].detach()
        assert float(a[:, 0].max()) > 0.1 and float(a[:, -1].max()) > 0.1


def test_render_range_image_matches_jax():
    means, quats, scales, opac, feats, mask = _gaussians(3)
    want = JR.render_range_image(*(jnp.asarray(a) for a in (means, quats, scales, opac)),
                                 jnp.asarray(feats[:, 0]), JGEO, jnp.asarray(mask),
                                 JR.RasterConfig(chunk=64))
    got = PR.render_range_image(T(means), T(quats), T(scales), T(opac), T(feats[:, 0]), PGEO,
                                T(mask), PR.RasterConfig(chunk=64))
    for k in want:
        assert _rel(got[k].numpy(), want[k]) <= OUT_TOL, k


def _cloud(seed, n=200):
    rng = np.random.default_rng(seed)
    r, az = rng.uniform(3, 25, n), rng.uniform(-np.pi, np.pi, n)
    z = rng.uniform(-1.5, 1.0, n)
    pts = np.stack([r * np.cos(az), r * np.sin(az), z], -1).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-10:] = False
    return pts, mask


@pytest.mark.parametrize("raster", ["RasterConfig", "SurfelConfig", "BandedConfig"])
def test_gs_decoder_render_surfels_and_gs_loss_match_jax(raster):
    pts, mask = _cloud(4)
    feats = np.random.default_rng(5).standard_normal((len(pts), 16)).astype(np.float32)
    cfg = JG.GSDecoderConfig(feat_dim=16)
    jm = JG.GSDecoder(cfg)
    params = random_flax_params(jm.init, 6, jax.random.key(0), jnp.asarray(pts),
                                jnp.asarray(feats), jnp.asarray(mask))
    pm = PG.GSDecoder(PG.GSDecoderConfig(feat_dim=16))
    pm.load_state_dict(dense_tree_state_dict(jax.tree.map(np.asarray, params)))
    jcfg, pcfg = {"RasterConfig": (JR.RasterConfig(chunk=128), PR.RasterConfig(chunk=128)),
                  "SurfelConfig": (JR.SurfelConfig(chunk=128), PR.SurfelConfig(chunk=128)),
                  "BandedConfig": (JRT.BandedConfig(band_w=16, capacity=512, chunk=64),
                                   PRT.BandedConfig(band_w=16, capacity=512, chunk=64))}[raster]
    gt_range, _ = j_pcd2range(jnp.asarray(pts), JGEO, mask=jnp.asarray(mask))
    gt_mask = np.asarray(gt_range) > 0
    gt = np.where(gt_mask, np.asarray(gt_range), 0.0).astype(np.float32)

    def jfn(p):
        s = jm.apply(p, jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(mask))
        r = JG.render_surfels(s, JGEO, jcfg)
        return JG.gs_loss(r, jnp.asarray(gt), jnp.asarray(gt_mask))[0], (s, r)
    (jl, (js, jr)), jgrads = jax.value_and_grad(jfn, has_aux=True)(params)
    surfels = pm(T(pts), T(feats), T(mask))
    for k in js:
        if k == "mask":
            np.testing.assert_array_equal(surfels[k].numpy(), np.asarray(js[k]))
        else:
            assert _rel(surfels[k].detach().numpy(), js[k]) <= OUT_TOL, k
    rend = PG.render_surfels(surfels, PGEO, pcfg)
    for k in jr:
        assert _rel(rend[k].detach().numpy(), jr[k]) <= OUT_TOL, k
    loss, logs = PG.gs_loss(rend, T(gt), T(gt_mask))
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_TOL * abs(float(jl))
    assert set(logs) == {"loss", "loss_range", "loss_raydrop"}
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad(loss, list(pm.parameters()))
    want = dense_tree_state_dict(jax.tree.map(np.asarray, jgrads))
    got = torch.cat([g.flatten() for g in grads]).numpy()
    assert _rel(got, torch.cat([want[n].flatten() for n in names]).numpy()) <= GRAD_TOL


# ------------------------------------------------------- one training step
TINY = dict(enc_depths=(1, 1), enc_channels=(16, 32), enc_heads=(2, 4), patch_size=64,
            dec_depths=(1,), dec_channels=(16,), dec_heads=(2,), drop_path=0.0)
LR, WD = 2e-3, 5e-3


def test_dense_decoder_train_step_matches_jax():
    """The JAX script's step at its --tiny config (512 synthetic points,
    16x64, chunk 128): loss parts, every gradient, the parameters after
    clip_by_global_norm(1.0) + adamw."""
    rng = np.random.default_rng(7)
    batch = PF.synthetic_cloud_batch(rng, 1, 512)
    batch["mask"][0, -30:] = False
    pts, feats, mask = (jnp.asarray(batch[k][0]) for k in ("points", "feats", "mask"))
    from lidar_layout_tpu.models.ptv3 import PTv3Config as JCfg
    jm = JG.DenseDecoder(JCfg(in_channels=4, **TINY), JG.GSDecoderConfig(feat_dim=16))
    params = random_flax_params(jm.init, 8, jax.random.key(0), pts, feats, mask)
    rc = JR.RasterConfig(chunk=128)
    gt_range, _ = j_pcd2range(pts, JGEO, mask=mask)
    gt_mask = gt_range > 0
    gt = jnp.where(gt_mask, gt_range, 0.0)

    def loss_fn(p):
        r = JG.render_surfels(jm.apply(p, pts, feats, mask), JGEO, rc)
        return JG.gs_loss(r, gt, gt_mask)
    (jl, jlogs), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR, weight_decay=WD))
    # jitted: op by op, the update compiles each leaf's few ops apart (20 s)
    jafter = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        jgrads, params)

    from lidar_layout_tpu_torch.models.ptv3 import PTv3Config as PCfg
    pm = PG.DenseDecoder(PCfg(in_channels=4, **TINY), PG.GSDecoderConfig(feat_dim=16))
    pm.load_state_dict(dense_tree_state_dict(jax.tree.map(np.asarray, params)))
    state = TD.create_dense_state(pm, LR, WD)
    seen = {}
    real = state.optimizer.step

    def spy(gs):
        seen["grads"] = [g.clone() for g in gs]
        return real(gs)
    state.optimizer.step = spy
    sample = TD.to_sample({k: T(v) for k, v in batch.items()}, PGEO)
    np.testing.assert_array_equal(sample["gt_mask"].numpy(), np.asarray(gt_mask))
    state, logs = TD.make_dense_train_step(pm, PGEO, PR.RasterConfig(chunk=128), timed=True)(
        state, sample, torch.Generator())
    assert state.step == 1 and {"seconds_ptv3", "seconds_raster"} <= set(logs)
    for k in jlogs:
        assert abs(float(logs[k]) - float(jlogs[k])) <= LOSS_TOL * abs(float(jlogs[k])), k
    names = [n for n, _ in pm.named_parameters()]
    want = dense_tree_state_dict(jax.tree.map(np.asarray, jgrads))
    got = torch.cat([g.flatten() for g in seen["grads"]]).numpy()
    assert _rel(got, torch.cat([want[n].flatten() for n in names]).numpy()) <= GRAD_TOL
    # AdamW's first update is about lr * sign(g): within 2 lr, and under 1e-3
    # of the elements with a live gradient off by more than 0.01 lr. The key
    # projections' biases get a gradient of 0 in exact arithmetic (softmax
    # ignores a shift shared by every key), so both sides step them by lr
    # times the sign of rounding noise: those are held by their gradient
    after = dense_tree_state_dict(jax.tree.map(np.asarray, jafter))
    diff = torch.cat([(p.detach() - after[n]).abs().flatten() for n, p in pm.named_parameters()])
    ref = torch.cat([want[n].flatten() for n in names])
    live = ref.abs() > 1e-6 * ref.abs().max()
    assert float(diff.max()) <= 2 * LR
    assert int((diff[live] > 0.01 * LR).sum()) <= 1e-3 * int(live.sum())
    assert float(torch.from_numpy(got)[~live].abs().max()) <= 1e-5 * float(ref.abs().max())


def test_train_dense_decoder_cli_tiny_synthetic(tmp_path, capsys):
    run = str(tmp_path / "run")
    trainer = TD.main(["--cpu", "--synthetic", "--tiny", "--steps", "2", "--workdir", run])
    out = capsys.readouterr().out
    assert "nusc_cube_decode: no sweeps under None — synthetic fallback" in out
    assert trainer.global_step == 2 and f"done -> {run}" in out
    model = trainer.state.model
    assert model.backbone.embed.in_features == 4 and model.backbone.cfg.enc_channels == (16, 32)
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == ["step_00000001.pt",
                                                              "step_00000002.pt"]
    ckpt = torch.load(os.path.join(run, "ckpt", "step_00000002.pt"), weights_only=True)
    assert set(ckpt) == {"step", "state_dict", "optimizer"}


# ----------------------------------------------------- transforms and data
def _sample(seed=0, n=300):
    rng = np.random.default_rng(seed)
    coord = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
    coord[:40] = np.round(coord[:40])       # shared voxels for GridSample
    return {"coord": coord, "feat": np.concatenate([coord, rng.uniform(0, 1, (n, 1))], -1)
            .astype(np.float32)}


@pytest.mark.parametrize("spec", [
    {"type": "FiltPoint", "point_range": [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]},
    {"type": "CoordConvert"}, {"type": "ToRange"}, {"type": "GridSample", "grid_size": 0.5},
    {"type": "RandomRotate", "angle": [-1, 1], "p": 0.9, "seed": 3},
    {"type": "RandomFlip", "p": 0.9, "seed": 4}, {"type": "Collect", "keys": ["coord"]}])
def test_each_transform_matches_jax(spec):
    jt, pt = JT.build_pipeline([spec]), PT.build_pipeline([spec])
    for i in range(3):   # the random ones draw anew each call
        data = _sample(i)
        want, got = jt(dict(data)), pt(dict(data))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-5)


def test_gaus_10cm_transform_block_raises_as_in_jax():
    """Five of the block's six entries name arguments the constructors do
    not take (FiltPoint's point_cloud_range, RandomRotate's axis, ToRange's
    size, CoordConvert's any, GridSample's mode): TypeError in both
    packages, for the same entries; RandomFlip builds."""
    block = load_yaml(YAML)["data"]["params"]["transform"]
    raised = {}
    for spec in block:
        for name, pkg in (("jax", JT), ("port", PT)):
            try:
                pkg.build_pipeline([spec])
            except TypeError:
                raised.setdefault(name, []).append(spec["type"])
    assert raised["jax"] == raised["port"] == [
        "FiltPoint", "RandomRotate", "ToRange", "CoordConvert", "GridSample"]
    for pkg in (JT, PT):
        with pytest.raises(TypeError):
            pkg.build_pipeline(block)


def test_nusc_cube_decode_batches_equal_jax(tmp_path, capsys):
    dset = {"point_cloud_range": [-51.2, -51.2, -51.2, 51.2, 51.2, 51.2]}
    params = {"split": "train", "max_points": 700}
    want = next(JF.build_batches("nusc_cube_decode", params, dset, None, 1, seed=3))
    got = next(PF.build_batches("nusc_cube_decode", params, dset, None, 1, seed=3))
    assert "nusc_cube_decode: no sweeps under None — synthetic fallback" in capsys.readouterr().out
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    _write_sweeps(str(tmp_path))
    block = [{"type": "FiltPoint", "point_range": [-40, -40, -30, 40, 40, 30]},
             {"type": "RandomFlip", "p": 0.7, "seed": 1}, {"type": "ToRange"},
             {"type": "GridSample", "grid_size": 0.3}]
    params = {"split": "train", "max_points": 800, "transform": block}
    want = JF.build_batches("nusc_cube_decode", params, dset, str(tmp_path), 2, seed=4)
    got = PF.build_batches("nusc_cube_decode", params, dset, str(tmp_path), 2, seed=4)
    for _ in range(2):
        w, g = next(want), next(got)
        assert sorted(g) == sorted(w) == ["feats", "mask", "points", "range_img"]
        for k in w:
            np.testing.assert_allclose(g[k].numpy(), w[k], rtol=1e-6, atol=1e-5)
    params["transform"] = load_yaml(YAML)["data"]["params"]["transform"]
    for pkg in (JF, PF):
        with pytest.raises(TypeError):
            next(pkg.build_batches("nusc_cube_decode", params, dset, str(tmp_path), 2, seed=4))


def test_registry_builds_gaus_10cm_as_jax():
    cfg = load_yaml(YAML)["model"]
    jm = jax_instantiate(cfg)
    pm = instantiate_from_config(cfg, in_features=4)
    assert dataclasses.asdict(pm.gs_decoder.cfg) == dataclasses.asdict(jm.gs_cfg)
    assert jax_instantiate({"target": "gs_decoder_head", "params": {"feat_dim": 32}}) == \
        JG.GSDecoderConfig(feat_dim=32)
    assert dataclasses.asdict(instantiate_from_config(
        {"target": "gs_decoder_head", "params": {"feat_dim": 32}})) == \
        dataclasses.asdict(JG.GSDecoderConfig(feat_dim=32))
