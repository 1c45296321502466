"""PyTorch port vs the JAX package: the sample-and-evaluate slice.

Same numpy inputs, made from a seed, go through the JAX function and its port
on the CPU in float32: the chamfer distance (against the XLA path and the
Pallas kernel in interpret mode), the auction EMD, the host metrics and
``evaluate``, the device-side statistics, RangeNet with the JAX init tree
carried across, the reference-weight loader, the PLMS and DDPM samplers,
the nuScenes readers and the range round trip. Then the port's own surface:
``GenerationPipeline.from_run_dir`` on a tiny training run and the sample
CLI with ``--eval``.
"""
import json
import os
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship as jax_flagship
from lidar_layout_tpu.data import readers as JRD
from lidar_layout_tpu.eval import device_metrics as JD
from lidar_layout_tpu.eval import metrics as JM
from lidar_layout_tpu.eval import rangenet as JR
from lidar_layout_tpu.models import samplers as JS
from lidar_layout_tpu.ops import chamfer as JC
from lidar_layout_tpu.ops import emd as JE
from lidar_layout_tpu.ops import lidar as JL
from lidar_layout_tpu.ops.pallas_chamfer import chamfer_pallas, nn_dist_pallas
from lidar_layout_tpu_torch import config as PC
from lidar_layout_tpu_torch import sample as PSAMPLE
from lidar_layout_tpu_torch.data import readers as PRD
from lidar_layout_tpu_torch.eval import device_metrics as PD
from lidar_layout_tpu_torch.eval import metrics as PM
from lidar_layout_tpu_torch.eval import rangenet as PR
from lidar_layout_tpu_torch.eval import registry as PREG
from lidar_layout_tpu_torch.flagship import flagship
from lidar_layout_tpu_torch.models import samplers as PS
from lidar_layout_tpu_torch.ops import chamfer as PCH
from lidar_layout_tpu_torch.ops import emd as PE
from lidar_layout_tpu_torch.ops import lidar as PL
from lidar_layout_tpu_torch.pipeline import GenerationPipeline
from lidar_layout_tpu_torch.train import checkpoint as CK
from lidar_layout_tpu_torch.train.train_lidm import main as train_main
from lidar_layout_tpu_torch.utils.convert import rangenet_state_dict
from torch_port_helpers import jax_ldm_params, one_intra_op_thread, seed_weights

ROOT = pathlib.Path(__file__).resolve().parent.parent
T = torch.from_numpy
_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)


def _pts(n, seed, scale=20.0):
    return (np.random.default_rng(seed).standard_normal((n, 3)) * scale).astype(np.float32)


def _clouds(n, seed, shift=0.0, points=2000):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = rng.standard_normal((points, 3)).astype(np.float32) * 10
        p[:, 0] += shift
        out.append(p)
    return out


# ------------------------------------------------------------------ chamfer
EPS32 = float(np.finfo(np.float32).eps)


def _assert_expansion_close(got, want, a, b):
    """Both sides form |a|^2 + |b|^2 - 2 a.b in f32, summed in other orders:
    each may be off by a few eps32 (|a|^2 + |b|^2) from the true distance."""
    bound = 8 * EPS32 * ((a.astype(np.float64) ** 2).sum(1) + (b.astype(np.float64) ** 2)
                         .sum(1).max())
    assert np.all(np.abs(got.astype(np.float64) - want) <= bound + 1e-6 * np.abs(want))


@pytest.mark.parametrize("masks", ["none", "y", "both"])
def test_chamfer_matches_jax_xla_path(masks):
    x, y = _pts(333, 1), _pts(517, 2)
    rng = np.random.default_rng(3)
    xm = rng.random(333) < 0.8 if masks == "both" else None
    ym = rng.random(517) < 0.6 if masks != "none" else None
    jxm, jym = (None if m is None else jnp.asarray(m) for m in (xm, ym))
    pxm, pym = (None if m is None else T(m) for m in (xm, ym))
    want = np.asarray(JC.nn_dist_one_way(jnp.asarray(x), jnp.asarray(y), jym, chunk=100))
    got = PCH.nn_dist_one_way(T(x), T(y), pym, chunk=100).numpy()
    _assert_expansion_close(got, want, x, y)
    assert (got >= 0).all()
    wx, wy = JC.chamfer_distance(jnp.asarray(x), jnp.asarray(y), jxm, jym)
    gx, gy = PCH.chamfer_distance(T(x), T(y), pxm, pym)
    _assert_expansion_close(gx.numpy(), np.asarray(wx), x, y)
    _assert_expansion_close(gy.numpy(), np.asarray(wy), y, x)
    # a mean over hundreds of points: the errors above average out
    np.testing.assert_allclose(float(PCH.pairwise_cd(T(x), T(y), pxm, pym)),
                               float(JC.pairwise_cd(jnp.asarray(x), jnp.asarray(y), jxm, jym)),
                               rtol=1e-5)
    # float64 brute force
    d64 = ((x[:, None].astype(np.float64) - y[None]) ** 2).sum(-1)
    if ym is not None:
        d64 = np.where(ym[None], d64, PCH.BIG)
    _assert_expansion_close(got, d64.min(1), x, y)


def test_batch_chamfer_matches_jax():
    xs = np.stack([_pts(200, 10 + i) for i in range(3)])
    ys = np.stack([_pts(150, 20 + i) for i in range(3)])
    rng = np.random.default_rng(4)
    xm, ym = rng.random((3, 200)) < 0.9, rng.random((3, 150)) < 0.7
    want = np.asarray(JC.batch_chamfer(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(xm),
                                       jnp.asarray(ym)))
    got = PCH.batch_chamfer(T(xs), T(ys), T(xm), T(ym)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    want = np.asarray(JC.batch_chamfer(jnp.asarray(xs), jnp.asarray(ys)))
    np.testing.assert_allclose(PCH.batch_chamfer(T(xs), T(ys)).numpy(), want, rtol=1e-5)


def test_chamfer_against_pallas_kernel_in_interpret_mode():
    x, y = _pts(300, 5), _pts(700, 6)
    x[:40] = y[:40]                       # exact matches: the expansion may go below 0
    ym = np.random.default_rng(7).random(700) < 0.5
    ym[:40] = True
    got = PCH.nn_dist_one_way(T(x), T(y), T(ym)).numpy()
    pallas = np.asarray(nn_dist_pallas(jnp.asarray(x), jnp.asarray(y), jnp.asarray(ym),
                                       interpret=True))
    # the Pallas kernel does not clamp at 0: compare against its clamped values
    _assert_expansion_close(got, np.maximum(pallas, 0.0), x, y)
    assert (got >= 0).all()
    # an all-masked y: BIG for the port (the XLA path's answer), the
    # kernel's sentinel point (1e4, 1e4, 1e4) about 3e8 away for Pallas
    none = np.zeros(700, bool)
    got = PCH.nn_dist_one_way(T(x), T(y), T(none)).numpy()
    pallas = np.asarray(nn_dist_pallas(jnp.asarray(x), jnp.asarray(y), jnp.asarray(none),
                                       interpret=True))
    want = np.asarray(JC.nn_dist_one_way(jnp.asarray(x), jnp.asarray(y), jnp.asarray(none)))
    assert (got == np.float32(PCH.BIG)).all() and (want == got).all()
    assert (pallas > 1e8).all() and (pallas < 1e9).all()
    # the two-way semantics of chamfer_pallas: masked x rows give 0
    xm = np.random.default_rng(8).random(300) < 0.5
    wx, wy = chamfer_pallas(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xm), jnp.asarray(ym),
                            interpret=True)
    gx, gy = PCH.chamfer_distance(T(x), T(y), T(xm), T(ym))
    _assert_expansion_close(gx.numpy(), np.maximum(np.asarray(wx), 0), x, y)
    _assert_expansion_close(gy.numpy(), np.maximum(np.asarray(wy), 0), y, x)
    assert (gx.numpy()[~xm] == 0).all()


def test_chamfer_is_forward_only():
    x, y = T(_pts(50, 1)), T(_pts(60, 2))
    with pytest.raises(RuntimeError, match="chamfer_loss"):
        PCH.nn_dist_one_way(x.clone().requires_grad_(), y)
    with pytest.raises(RuntimeError, match="forward-only"):
        PCH.pairwise_cd(x, y.clone().requires_grad_())
    with torch.no_grad():
        assert PCH.nn_dist_one_way(x.clone().requires_grad_(), y).shape == (50,)
    with pytest.raises(ValueError, match="at least one"):
        PCH.nn_dist_one_way(x, y[:0])


# ---------------------------------------------------------------------- EMD
def test_auction_match_recovers_a_permutation_as_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((128, 3)).astype(np.float32)
    y = x[rng.permutation(128)]
    want = np.asarray(JE.auction_match(jnp.asarray(x), jnp.asarray(y), eps=1e-4, iters=200))
    got = PE.auction_match(T(x), T(y), eps=1e-4, iters=200).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 120


@pytest.mark.parametrize("n, iters", [(200, 200), (1100, 8)])
def test_emd_distance_matches_jax_on_random_clouds(n, iters):
    # 200 points: kept whole at the default 200 rounds; 1100 points: cut to
    # 1024, at 8 rounds (JAX's 200 top-k rounds take a minute there on a CPU)
    x, y = _pts(n, 30, 1.0), _pts(n, 31, 1.0) + 0.5
    m = min(n, 1024)
    # eps passed, as emd_distance passes it: JAX then traces it and scales
    # it in f32 (a default eps would be folded as a float64 constant)
    want_a = np.asarray(JE.auction_match(jnp.asarray(x[:m]), jnp.asarray(y[:m]), eps=0.005,
                                         iters=iters))
    got_a = PE.auction_match(T(x[:m]), T(y[:m]), iters=iters).numpy()
    want = float(JE.emd_distance(jnp.asarray(x), jnp.asarray(y), iters=iters))
    got = float(PE.emd_distance(T(x), T(y), iters=iters))
    # the distance matrix is rounded as XLA rounds it, so the auctions take
    # the same bids; the mean of the matched distances sums in another order
    np.testing.assert_array_equal(got_a, want_a)
    assert got == pytest.approx(want, rel=1e-6)


# ------------------------------------------------------------- host metrics
def test_histograms_jsd_mmd_frechet_match_jax():
    ref, smp = _clouds(3, 40), _clouds(4, 41, shift=2.0)
    np.testing.assert_array_equal(PM.bev_count_histogram(ref), JM.bev_count_histogram(ref))
    for a, b in zip(PM.bev_bin_clouds(smp), JM.bev_bin_clouds(smp)):
        np.testing.assert_array_equal(a, b)
    # numpy and scipy on both sides: equal to the last bits
    assert PM.compute_jsd(ref, smp) == JM.compute_jsd(ref, smp)
    assert PM.compute_mmd(ref, smp) == pytest.approx(JM.compute_mmd(ref, smp), rel=1e-12)
    empty = [np.full((10, 3), 1e4, np.float32)]
    assert PM.compute_mmd(ref, empty) == pytest.approx(JM.compute_mmd(ref, empty), rel=1e-12)
    rng = np.random.default_rng(42)
    f1, f2 = rng.standard_normal((300, 16)), rng.standard_normal((300, 16)) + 1.0
    assert PM.frechet_distance(f1, f2) == pytest.approx(JM.frechet_distance(f1, f2), rel=1e-12)


def test_evaluate_matches_jax():
    ref, smp = _clouds(2, 50, points=200), _clouds(2, 51, shift=0.5, points=200)

    def feats(pcds):
        return np.stack([np.concatenate([p.mean(0), p.std(0), p.min(0)]) for p in pcds])

    metrics = ["cd", "emd", "jsd", "mmd", "frid"]
    want = JM.evaluate(ref, smp, metrics, feature_fn=feats)
    got = PM.evaluate(ref, smp, metrics, feature_fn={"frid": feats}, device="cpu")
    assert set(got) == set(want)
    # cd: f32 expansion in other summation orders; emd: see the EMD test
    assert got["cd"] == pytest.approx(want["cd"], rel=1e-5)
    assert got["emd"] == pytest.approx(want["emd"], rel=1e-6)
    for k in ("jsd", "mmd", "frid"):
        assert got[k] == pytest.approx(want[k], rel=1e-12)
    with pytest.raises(ValueError, match="feature extractor"):
        PM.evaluate(ref, smp, ["frid"], device="cpu")


# ----------------------------------------------------------- device metrics
def _fixed_points():
    rng = np.random.default_rng(60)
    xyz = rng.uniform(-60, 60, (2, 3000, 3)).astype(np.float32)
    valid = rng.random((2, 3000)) < 0.8
    return xyz, valid


def test_device_metrics_match_jax():
    xyz, valid = _fixed_points()
    jx, jv, px, pv = jnp.asarray(xyz), jnp.asarray(valid), T(xyz), T(valid)
    pix, nx, ny = PD._cell_index(px, pv, "64", 0.5)
    want_pix, wnx, wny = JD._cell_index(jx, jv, "64", 0.5)
    assert (nx, ny) == (wnx, wny) and PD._grid_dims("64", 0.05) == JD._grid_dims("64", 0.05)
    np.testing.assert_array_equal(pix.numpy(), np.asarray(want_pix))
    bits = PD.bev_occupancy_bitmaps(px, pv).numpy()
    np.testing.assert_array_equal(bits, np.asarray(JD.bev_occupancy_bitmaps(jx, jv)))
    packed = PD.bev_occupancy_packed(px, pv).numpy()
    np.testing.assert_array_equal(packed, np.asarray(JD.bev_occupancy_packed(jx, jv)))
    np.testing.assert_array_equal(PD.unpack_bitmaps(packed, nx * ny), bits)
    np.testing.assert_array_equal(PD.pack_bitmaps(T(bits[:, :37])).numpy(),
                                  np.asarray(JD.pack_bitmaps(jnp.asarray(bits[:, :37]))))
    hist = PD.bev_hist_accumulate(px, pv).numpy()
    np.testing.assert_array_equal(hist, np.asarray(JD.bev_hist_accumulate(jx, jv)))
    # against the host metrics on the valid clouds
    host = [p[v] for p, v in zip(xyz, valid)]
    np.testing.assert_array_equal(hist, PM.bev_count_histogram(host))
    other = PD.bev_hist_accumulate(px.flip(1) * 0.5, pv).numpy()
    assert PD.jsd_from_hists(hist, other) == JD.jsd_from_hists(hist, other)
    assert PD.mmd_from_packed(packed[:1], packed[1:]) == pytest.approx(
        JD.mmd_from_packed(packed[:1], packed[1:]), rel=1e-12)
    assert PD.mmd_from_bitmaps(bits[:1], bits[1:]) == pytest.approx(
        PM.compute_mmd(host[:1], host[1:]), rel=1e-12)
    for a, b in zip(PD._edt_from_bitmaps(bits, nx, ny), JD._edt_from_bitmaps(bits, nx, ny)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cap", [1000, 5000])
def test_compaction_and_voxel_inputs_match_jax(cap):
    xyz, valid = _fixed_points()
    for got, want in zip(PD.compact_valid_points(T(xyz[0]), T(valid[0]), cap),
                         JD.compact_valid_points(jnp.asarray(xyz[0]), jnp.asarray(valid[0]),
                                                 cap)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(PD.voxel_feature_inputs(T(xyz[1]), T(valid[1]), cap, 0.05),
                         JD.voxel_feature_inputs(jnp.asarray(xyz[1]), jnp.asarray(valid[1]),
                                                 cap)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rangenet_input_from_model_images_matches_jax():
    imgs = np.random.default_rng(61).uniform(-1, 1, (2, 16, 128)).astype(np.float32)
    got = PD.rangenet_input_from_model_imgs(T(imgs), PL.LidarGeometry(size=(16, 128)))
    want = JD.rangenet_input_from_model_imgs(jnp.asarray(imgs), JL.LidarGeometry(size=(16, 128)))
    # exp2 and the ray directions in f32 on both sides: depth up to 56 m
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


# ----------------------------------------------------------------- RangeNet
def _jax_rangenet_variables(shape=(1, 16, 64, 4)):
    """The JAX init tree with the BatchNorm affines and running statistics
    and the upconv biases drawn at random, so that every leaf shows."""
    net = JR.RangeNet(layers=21)
    variables = jax.tree.map(np.asarray, jax.jit(net.init)(jax.random.key(0), jnp.zeros(shape)))
    rng = np.random.default_rng(70)

    def fill(path, v):
        leaf = path[-1].key
        r = rng.standard_normal(v.shape).astype(np.float32)
        if leaf == "scale" or leaf == "var":
            return 1.0 + 0.1 * np.abs(r) if leaf == "var" else 1.0 + 0.1 * r
        if leaf in ("bias", "mean"):
            return 0.1 * r
        return v
    return net, jax.tree_util.tree_map_with_path(fill, variables)


@pytest.fixture(scope="module")
def rangenet_pair():
    jnet, variables = _jax_rangenet_variables()
    sd = rangenet_state_dict(variables)
    net = PR.RangeNet(layers=21).eval()
    net.load_state_dict(sd)          # strict: every port key comes from the tree
    apply = jax.jit(jnet.apply, static_argnames=("return_final_logits", "agg_type",
                                                 "return_features"))
    return apply, variables, net, sd


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_rangenet_matches_jax_with_carried_weights(rangenet_pair):
    apply, variables, net, _ = rangenet_pair
    x = np.random.default_rng(71).standard_normal((2, 16, 64, 4)).astype(np.float32) * 5
    with torch.inference_mode():
        for agg in ("depth", "sector", "all"):
            want = np.asarray(apply(variables, jnp.asarray(x), return_final_logits=True,
                                    agg_type=agg))
            got = net(T(x), return_final_logits=True, agg_type=agg).numpy()
            assert got.shape == want.shape
            # 40 f32 convolutions summed in other orders
            assert _rel_l2(got, want) <= 1e-4, agg
        want = apply(variables, jnp.asarray(x), return_features=True)
        got = net(T(x), return_features=True)
        assert set(got) == set(want) and len(got) == 10
        for k in got:
            assert _rel_l2(got[k].numpy(), np.asarray(want[k])) <= 1e-4, k
        logits = net(T(x)).numpy()
    assert logits.shape == (2, 16, 64, 32)


def test_rangenet_upconv_needs_the_w_flip(rangenet_pair):
    apply, variables, _, sd = rangenet_pair
    unflipped = {k: (v.flip(-1) if k.endswith("upconv.weight") else v) for k, v in sd.items()}
    net = PR.RangeNet(layers=21).eval()
    net.load_state_dict(unflipped)
    x = np.random.default_rng(72).standard_normal((2, 16, 64, 4)).astype(np.float32) * 5
    want = np.asarray(apply(variables, jnp.asarray(x), return_final_logits=True))
    with torch.inference_mode():
        got = net(T(x), return_final_logits=True).numpy()
    assert _rel_l2(got, want) > 1e-2


def test_load_reference_weights_round_trip(tmp_path):
    src = PR.RangeNet(layers=21)
    with torch.no_grad():
        for p in src.parameters():
            p.add_(0.01)
    sd = src.state_dict()
    for part in ("backbone", "decoder"):
        torch.save({k[len(part) + 1:]: v for k, v in sd.items() if k.startswith(part + ".")
                    and not k.endswith("num_batches_tracked")}, tmp_path / part)
    dst = PREG.build_range_feature_net(weights_root=str(tmp_path / "none"), device="cpu")
    PR.load_reference_weights(dst, str(tmp_path / "backbone"), str(tmp_path / "decoder"))
    assert all(torch.equal(v, dst.state_dict()[k]) for k, v in sd.items()
               if not k.endswith("num_batches_tracked"))
    assert PREG.params_hash(dst) == PREG.params_hash(src)
    # the reference's layout: <root>/kitti/rangenet/{backbone,segmentation_decoder}
    wdir = tmp_path / "w" / "kitti" / "rangenet"
    wdir.mkdir(parents=True)
    (tmp_path / "backbone").rename(wdir / "backbone")
    dec = torch.load(tmp_path / "decoder")
    torch.save(dec, wdir / "segmentation_decoder")
    net = PREG.build_range_feature_net(weights_root=str(tmp_path / "w"), device="cpu")
    assert PREG.params_hash(net) == PREG.params_hash(src)
    # a missing key raises (the JAX loader kept the init value silently)
    torch.save({k: v for k, v in dec.items() if k != "dec3.bn.running_var"},
               wdir / "segmentation_decoder")
    with pytest.raises(KeyError, match="dec3.bn.running_var"):
        PREG.build_range_feature_net(weights_root=str(tmp_path / "w"), device="cpu")
    torch.save(dict(dec, extra=torch.zeros(1)), wdir / "segmentation_decoder")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        PREG.build_range_feature_net(weights_root=str(tmp_path / "w"), device="cpu")
    assert any("extra" in str(w.message) for w in caught)


def test_preprocess_range_batch_matches_jax():
    clouds = [np.random.default_rng(80 + i).uniform(-40, 40, (3000, 3)).astype(np.float32)
              for i in range(2)]
    want = JR.preprocess_range_batch(clouds, JL.LidarGeometry(size=(16, 128)))
    got = PR.preprocess_range_batch(clouds, PL.LidarGeometry(size=(16, 128)))
    np.testing.assert_array_equal(got, want)


def test_feature_fn_padding_and_modalities():
    clouds = [np.random.default_rng(90 + i).uniform(-40, 40, (3000, 3)).astype(np.float32)
              for i in range(3)]
    fn = PREG.build_feature_fn("64", weights_root="/nonexistent", feat_batch=2, device="cpu")
    one = PREG.build_feature_fn("64", weights_root="/nonexistent", feat_batch=1, device="cpu")
    assert fn.param_hash == one.param_hash and len(fn.param_hash) == 16
    a, b = fn(clouds), one(clouds)
    assert a.shape == (3, 16 * 32)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    # the voxel modalities build their nets (FSVD, FPVD; run in test_torch_seg_nets.py)
    for modality, cls in (("voxel", "MinkowskiNet"), ("point_voxel", "SPVCNN")):
        fn = PREG.build_feature_fn("64", modality, weights_root="/nonexistent", device="cpu")
        assert type(fn.net).__name__ == cls and len(fn.param_hash) == 16


# ----------------------------------------------------------------- samplers
SHAPE = (2, 4, 16, 8)


@pytest.fixture(scope="module")
def tiny_pair():
    port, _ = flagship(tiny=True, device="cpu")
    seed_weights(port, 43)
    jmodel, _ = jax_flagship(tiny=True)
    return port, jmodel, jax_ldm_params(port)


def test_plms_sample_matches_jax(tiny_pair):
    port, jmodel, params = tiny_pair
    key = jax.random.key(11)
    x_T = np.asarray(jax.random.normal(jax.random.split(key)[1], SHAPE, jnp.float32))
    want = np.asarray(JS.plms_sample(jmodel, params, key, SHAPE, steps=6))
    with torch.inference_mode():
        got = PS.plms_sample(port, SHAPE, steps=6, x_T=T(x_T), device="cpu").numpy()
    # 7 U-Net evals in series, f32 in other summation orders
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=1e-4)


def test_ddpm_sample_matches_jax_with_its_noise(tiny_pair, monkeypatch):
    port, jmodel, params = tiny_pair
    key = jax.random.key(12)
    rng, r_init = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(r_init, SHAPE, jnp.float32))
    steps = jax.random.split(rng, port.schedule.num_timesteps)
    noise = [T(np.asarray(jax.random.normal(k, SHAPE))) for k in steps]
    monkeypatch.setattr(PS, "_randn", lambda shape, gen, dev: noise.pop(0))
    want = np.asarray(JS.ddpm_sample(jmodel, params, key, SHAPE))
    with torch.inference_mode():
        got = PS.ddpm_sample(port, SHAPE, x_T=T(x_T), device="cpu").numpy()
    assert not noise                       # one draw per step, as the JAX scan
    # 64 ancestral steps; the clip to [-1, 1] keeps errors from growing
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=1e-4)


# ------------------------------------------------------- readers, roundtrip
def test_nuscenes_readers_match_jax(tmp_path):
    meta = tmp_path / "v1.0-trainval" / "v1.0-mini"
    meta.mkdir(parents=True)
    names = ["samples/LIDAR_TOP/b.bin", "samples/LIDAR_TOP/a.bin", "sweeps/LIDAR_TOP/c.bin",
             "samples/CAM_FRONT/d.jpg"]
    (meta / "sample_data.json").write_text(json.dumps([{"filename": n} for n in names]))
    for kind in ("samples", "sweeps"):
        got = PRD.list_nuscenes_sweeps(str(tmp_path), "val", kind)
        assert got == JRD.list_nuscenes_sweeps(str(tmp_path), "val", kind) and got
    assert PRD.list_nuscenes_sweeps(str(tmp_path), "train") == []
    scan = np.random.default_rng(0).standard_normal((7, 5)).astype(np.float32)
    scan.tofile(tmp_path / "scan.bin")
    np.testing.assert_array_equal(PRD.read_nuscenes_bin(str(tmp_path / "scan.bin")),
                                  JRD.read_nuscenes_bin(str(tmp_path / "scan.bin")))


def test_range_roundtrip_matches_jax():
    from lidar_layout_tpu.data.synthetic import synthetic_scene

    clouds = [synthetic_scene(np.random.default_rng(i), 20000) for i in range(3)]
    clouds[1] = clouds[1][:15000]
    geom, jgeom = PL.LidarGeometry(size=(16, 128)), JL.LidarGeometry(size=(16, 128))
    got = PSAMPLE.range_roundtrip(clouds, geom, "cpu", batch=2)
    for cloud, mine in zip(clouds, got):
        img, _ = JL.pcd2range(jnp.asarray(cloud), jgeom)
        xyz, valid = JL.range2pcd(JL.process_scan(img, jgeom)[0], jgeom)
        want = np.asarray(xyz)[np.asarray(valid)]
        assert mine.shape == want.shape
        np.testing.assert_allclose(mine, want, atol=1e-4, rtol=1e-5)


# ----------------------------------------------------- the port's own surface
def _tiny_config():
    cfg = PC.load_yaml(str(ROOT / "configs/lidar_diffusion/kitti/uncond_c2_p4.yaml"))
    p = cfg["model"]["params"]
    p.update(timesteps=64, image_size=[4, 16])
    p["unet_config"]["params"].update(model_channels=32, num_res_blocks=1,
                                      attention_resolutions=[2], channel_mult=[1, 2],
                                      num_head_channels=8)
    p["first_stage_config"]["params"]["n_embed"] = 256
    p["first_stage_config"]["params"]["ddconfig"].update(ch=16, num_res_blocks=1)
    cfg["data"]["params"]["dataset"]["size"] = [16, 128]
    return cfg


def _write_tiny_config(tmp_path):
    import yaml

    base = tmp_path / "tiny.yaml"
    base.write_text(yaml.safe_dump(_tiny_config()))
    return base


def test_from_run_dir_loads_a_training_run(tmp_path):
    base = _write_tiny_config(tmp_path)
    work = tmp_path / "run"
    train_main(["-b", str(base), "--cpu", "--synthetic", "--steps", "2", "--workdir", str(work),
                "-s", "3", "data.params.batch_size=2", "data.params.num_val_batches=1"])
    ckpt = torch.load(CK.checkpoint_path(str(work / "ckpt"), CK.latest_step(str(work / "ckpt"))))
    ema = GenerationPipeline.from_run_dir(str(work), device="cpu", steps=2)
    sd = ema.model.state_dict()
    assert set(ckpt["ema"]["params"]) < set(sd)
    for k, v in ckpt["ema"]["params"].items():
        assert torch.equal(sd[k], v), k
    trained = GenerationPipeline.from_run_dir(str(work), use_ema=False, device="cpu")
    for k, v in ckpt["model"].items():
        assert torch.equal(trained.model.state_dict()[k], v), k
    assert any(not torch.equal(ckpt["model"][k], v) for k, v in ckpt["ema"]["params"].items())
    out = ema.generate(2, seed=1, batch=2)
    assert out.images.shape == (2, 16, 128, 1) and np.isfinite(out.images).all()
    with pytest.raises(FileNotFoundError):
        GenerationPipeline.from_run_dir(str(tmp_path), base_config=str(base), device="cpu")


@pytest.mark.parametrize("sampler", ["plms", "ddpm"])
def test_pipeline_runs_the_remaining_samplers(sampler):
    pipe = GenerationPipeline.from_config(_tiny_config(), device="cpu", sampler=sampler, steps=3)
    seed_weights(pipe.model, 44)
    out = pipe.generate(2, seed=5, batch=2)
    again = pipe.generate(2, seed=5, batch=2)
    assert out.images.shape == (2, 16, 128, 1) and np.isfinite(out.images).all()
    np.testing.assert_array_equal(out.images, again.images)


def test_sample_cli_evaluates_on_the_cpu(tmp_path, monkeypatch):
    from lidar_layout_tpu_torch.eval import registry

    # two images a RangeNet batch keeps the 64x1024 FRID features cheap here
    build = registry.build_feature_fn
    monkeypatch.setattr(registry, "build_feature_fn",
                        lambda *a, **kw: build(*a, **dict(kw, feat_batch=2)))
    base = _write_tiny_config(tmp_path)
    out = tmp_path / "out"
    metrics = "cd,emd,jsd,mmd,frid"
    common = ["-b", str(base), "--cpu", "--eval", "--metrics", metrics,
              "--weights-root", str(tmp_path / "none")]
    res = PSAMPLE.main(common + ["-n", "2", "--batch", "2", "--steps", "2", "--sampler", "dpm",
                                 "--outdir", str(out)])
    assert set(res) == set(metrics.split(",")) and all(np.isfinite(v) for v in res.values())
    assert json.loads((out / "eval.json").read_text()) == pytest.approx(res)
    imgs = np.load(out / "samples_range.npy")
    assert imgs.shape == (2, 16, 128, 1)
    assert len(np.load(out / "samples_pcd.npz").files) == 2
    # -f: the saved clouds, and the saved images reprojected, score the same
    for name in ("samples_pcd.npz", "samples_range.npy"):
        again = PSAMPLE.main(common + ["-f", str(out / name), "--outdir", str(tmp_path / name)])
        assert again == pytest.approx(res, rel=1e-6)
    # FSVD and FPVD, their nets at 2048 level-0 voxels (the CPU's share), and the viewer
    from lidar_layout_tpu_torch.eval.sparse_seg_nets import SegNetConfig

    monkeypatch.setattr(registry, "SEG_NET_CFG", SegNetConfig(cr=0.5, capacity=2048, bits=10))
    voxel = PSAMPLE.main(common[:5] + ["fsvd,fpvd", "--weights-root", str(tmp_path / "none"),
                                       "-f", str(out / "samples_pcd.npz"), "--html",
                                       "--outdir", str(tmp_path / "voxel")])
    assert set(voxel) == {"fsvd", "fpvd"} and all(np.isfinite(v) for v in voxel.values())
    assert (tmp_path / "voxel" / "viewer.html").exists()
    assert not os.path.exists(tmp_path / "none")
