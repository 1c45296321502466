"""PyTorch port vs the JAX package: the point-backbone zoo and its ops.

``ops/pointops2`` (each op and its input gradients within 1e-4 absolute, as
JAX's own ``tests/test_pointops2.py`` holds them against torch autograd),
``ops/cluster`` (labels equal), ``data/aug.keypoint_drop`` (equal, from
the same generator state), and the six segmentation backbones (PT-v1
Seg26, PT-v2m2 with both unpool backends, the interp one forward only,
SpUNet, the Stratified Transformer, Swin3D, OctFormer; Sonata, the
seventh, is ``tests/test_torch_sonata.py``) at the tiny configs of JAX's
tests (``TINY`` in ``tests/test_ptv1.py`` and the others): the logits and
every parameter's gradient of a seeded weighted sum of them within 1e-4
relative L2 (the integer structure they hang on, windows, edges, segments
and kNN, equal where the test reads it), padding rows 0, and padding
invariance where the levels are fixed tables (SpUNet, Swin3D, OctFormer:
extra padding rows change no valid logit by more than 1e-5 of the
largest; PT-v1, PT-v2 and ST size their levels by N, so there the logits
stay finite and the padding rows 0). JAX
trees come from ``random_flax_params`` (the structure of ``jax.eval_shape``
of ``init``, numpy values) and cross through
``utils/convert.dense_tree_state_dict``; the JAX forward and gradient run
in one jitted program compiled with HLO fusion off (fused, XLA recomputes
PT-v1's pooled features with other roundings, and the max's gradient,
which finds the maximum by equality, misses some of them: finite
differences side with the port). The registry builds each target in both
packages with the same config.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_layout_tpu.config import instantiate_from_config as jax_instantiate
from lidar_layout_tpu.data import aug as JA
from lidar_layout_tpu.models import octformer as JO
from lidar_layout_tpu.models import ptv1 as J1
from lidar_layout_tpu.models import ptv2 as J2
from lidar_layout_tpu.models import spunet as JU
from lidar_layout_tpu.models import stratified as JS
from lidar_layout_tpu.models import swin3d as JW
from lidar_layout_tpu.ops import cluster as JC
from lidar_layout_tpu.ops import pointops2 as JP
from lidar_layout_tpu_torch.config import instantiate_from_config
from lidar_layout_tpu_torch.data import aug as PA
from lidar_layout_tpu_torch.models import octformer as PO
from lidar_layout_tpu_torch.models import ptv1 as P1
from lidar_layout_tpu_torch.models import ptv2 as P2
from lidar_layout_tpu_torch.models import spunet as PU
from lidar_layout_tpu_torch.models import stratified as PS
from lidar_layout_tpu_torch.models import swin3d as PW
from lidar_layout_tpu_torch.ops import cluster as PC
from lidar_layout_tpu_torch.ops import pointops2 as PP
from lidar_layout_tpu_torch.utils.convert import dense_tree_state_dict
from torch_port_helpers import one_intra_op_thread, random_flax_params

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)

OPS_TOL = 1e-4      # absolute, pointops2's ops and input gradients
NET_TOL = 1e-4      # relative L2, logits and parameter gradients
PAD_TOL = 1e-5      # padding invariance, of the largest logit


def T(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ------------------------------------------------------------------ pointops2

def _edges(rng, n=24, m=96, h=2, d=4, L=6):
    q, k, v = (rng.normal(size=(n, h, d)).astype(np.float32) for _ in range(3))
    i0 = rng.integers(0, n - 2, m).astype(np.int32)   # the last two queries get no edge
    i1 = rng.integers(0, n, m).astype(np.int32)
    mask = rng.random(m) < 0.8
    table = rng.normal(size=(L, h, d, 3)).astype(np.float32)
    rel = rng.integers(0, L, (m, 3)).astype(np.int32)
    attn = rng.normal(size=(m, h)).astype(np.float32)
    return dict(q=q, k=k, v=v, i0=i0, i1=i1, mask=mask, table=table, rel=rel, attn=attn, n=n)


def _op_cases(e):
    """name -> (JAX fn, port fn, differentiable input names)."""
    n = e["n"]
    return {
        "attention_step1": (lambda q, k: JP.attention_step1(q, k, e["i0"], e["i1"], e["mask"]),
                            lambda q, k: PP.attention_step1(q, k, T(e["i0"]), T(e["i1"]),
                                                            T(e["mask"])), ("q", "k")),
        "attention_step2": (lambda attn, v: JP.attention_step2(attn, v, e["i0"], e["i1"], n,
                                                               e["mask"]),
                            lambda attn, v: PP.attention_step2(attn, v, T(e["i0"]), T(e["i1"]),
                                                               n, T(e["mask"])), ("attn", "v")),
        "dot_prod_with_idx": (lambda q, table: JP.dot_prod_with_idx(q, e["i0"], table, e["rel"],
                                                                    e["mask"]),
                              lambda q, table: PP.dot_prod_with_idx(q, T(e["i0"]), table,
                                                                    T(e["rel"]), T(e["mask"])),
                              ("q", "table")),
        "relative_pos_value": (lambda table: JP.relative_pos_value(table, e["rel"]),
                               lambda table: PP.relative_pos_value(table, T(e["rel"])),
                               ("table",)),
        "attention_step2_with_rel_pos_value": (
            lambda attn, v, table: JP.attention_step2_with_rel_pos_value(
                attn, v, e["i0"], e["i1"], table, e["rel"], n, e["mask"]),
            lambda attn, v, table: PP.attention_step2_with_rel_pos_value(
                attn, v, T(e["i0"]), T(e["i1"]), table, T(e["rel"]), n, T(e["mask"])),
            ("attn", "v", "table")),
        "segment_softmax": (lambda attn: JP.segment_softmax(attn, e["i0"], n, e["mask"]),
                            lambda attn: PP.segment_softmax(attn, T(e["i0"]), n, T(e["mask"])),
                            ("attn",)),
        "window_attention": (
            lambda q, k, v, table: JP.window_attention(q, k, v, e["i0"], e["i1"], n, table,
                                                       table * 0.5, e["rel"], e["mask"]),
            lambda q, k, v, table: PP.window_attention(q, k, v, T(e["i0"]), T(e["i1"]), n, table,
                                                       table * 0.5, T(e["rel"]), T(e["mask"])),
            ("q", "k", "v", "table")),
    }


@pytest.mark.parametrize("op", ["attention_step1", "attention_step2", "dot_prod_with_idx",
                                "relative_pos_value", "attention_step2_with_rel_pos_value",
                                "segment_softmax", "window_attention"])
def test_pointops2_op_and_input_gradients_match_jax(op):
    e = _edges(np.random.default_rng(0))
    jfn, pfn, names = _op_cases(e)[op]
    ins = [e[k] for k in names]
    want = np.asarray(jfn(*ins))
    w = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)
    jgrads = jax.grad(lambda *a: jnp.sum(jfn(*a) * w), argnums=tuple(range(len(ins))))(*ins)
    tins = [T(a).requires_grad_(True) for a in ins]
    got = pfn(*tins)
    (got * T(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=OPS_TOL, rtol=0)
    for t, g in zip(tins, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=OPS_TOL, rtol=0)
    if op == "segment_softmax":       # edge-free queries and masked edges read 0
        assert np.all(got.detach().numpy()[~e["mask"]] == 0)


# ----------------------------------------------------------- cluster and aug

def test_cluster_points_labels_equal_jax():
    rng = np.random.default_rng(2)
    blobs = [rng.normal(c, 0.15, (60, 3)) for c in ([0, 0, 0], [3, 0, 0], [0, 3, 1], [3.2, 3, 0])]
    pts = np.concatenate(blobs + [rng.uniform(-1, 5, (40, 3))]).astype(np.float32)
    mask = np.ones(len(pts), bool)
    mask[-25:] = False
    want_p, want_v = JC.cluster_points(jnp.asarray(pts), jnp.asarray(mask), 0.3, 512, 10)
    got_p, got_v = PC.cluster_points(T(pts), T(mask), 0.3, 512, 10)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert len(np.unique(got_p.numpy()[mask])) >= 4 and (got_p.numpy()[~mask] == 512).all()


def test_keypoint_drop_equals_jax_from_the_same_generator_state():
    pts = np.random.default_rng(3).uniform(-20, 20, (3000, 4)).astype(np.float32)
    for seed in range(3):
        want = JA.keypoint_drop(pts, np.random.default_rng(seed))
        got = PA.keypoint_drop(pts, np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
        assert 0 < len(got) < len(pts)


# ----------------------------------------------------------------- backbones

def _cloud(seed, n, valid, in_ch, lo=0.0, hi=None, dist="uniform", feat_lo=None):
    rng = np.random.default_rng(seed)
    coord = (rng.normal(size=(n, 3)) if dist == "normal"
             else rng.uniform(lo, hi, size=(n, 3))).astype(np.float32)
    feat = (rng.uniform(feat_lo, 1, size=(n, in_ch)) if feat_lo is not None
            else rng.normal(size=(n, in_ch))).astype(np.float32)
    return coord, feat, np.arange(n) < valid


# name -> (JAX model, port model, cloud kwargs); the tiny configs of JAX's tests
BACKBONES = {
    "ptv1_seg26": (lambda: J1.PointTransformerSeg(J1.PTv1Config(
        in_channels=4, num_classes=5, blocks=(1, 1, 1, 1, 1), planes=(8, 12, 16, 20, 24),
        strides=(1, 2, 2, 2, 2), nsamples=(4, 4, 4, 4, 4), share_planes=4)),
        lambda c: P1.PointTransformerSeg(P1.PTv1Config(**dataclasses.asdict(c))),
        dict(n=64, valid=56, in_ch=4, dist="normal")),
    "ptv2_map": (lambda: J2.PointTransformerV2(J2.PTv2Config(
        in_channels=4, num_classes=5, patch_embed_depth=1, patch_embed_channels=12,
        patch_embed_groups=3, patch_embed_neighbours=4, enc_depths=(1, 1),
        enc_channels=(24, 48), enc_groups=(6, 12), enc_neighbours=(4, 4), dec_depths=(1, 1),
        dec_channels=(12, 24), dec_groups=(3, 6), dec_neighbours=(4, 4),
        grid_sizes=(0.12, 0.24), pool_ratios=(0.5, 0.25))),
        lambda c: P2.PointTransformerV2(P2.PTv2Config(**dataclasses.asdict(c))),
        dict(n=64, valid=48, in_ch=4, dist="normal")),
    "spunet": (lambda: JU.SpUNet(JU.SpUNetConfig(
        in_channels=4, num_classes=5, base_channels=8, channels=(8, 16, 16, 8),
        layers=(1, 1, 1, 1), stem_kernel=3, voxel_size=0.2, capacity=256)),
        lambda c: PU.SpUNet(PU.SpUNetConfig(**dataclasses.asdict(c))),
        dict(n=128, valid=100, in_ch=4, hi=6.0)),
    "stratified": (lambda: JS.StratifiedTransformer(JS.StratifiedConfig(
        in_channels=4, num_classes=5, channels=(8, 16, 16, 16), depths=(1, 1, 1, 1),
        num_heads=(2, 2, 2, 2), window_size=(0.8, 1.6, 3.2, 6.4),
        quant_size=(0.2, 0.4, 0.8, 1.6), k=4, kp_neighbors=4, kp_kernel_points=5,
        downsample_scale=4, n_windows=32, window_capacity=12, sample_capacity=4)),
        lambda c: PS.StratifiedTransformer(PS.StratifiedConfig(**dataclasses.asdict(c))),
        dict(n=128, valid=100, in_ch=4, hi=4.0)),
    "swin3d": (lambda: JW.Swin3DUNet(JW.Swin3DConfig(
        in_channels=6, num_classes=5, channels=(8, 16, 16, 16, 16), depths=(1, 1, 1, 1, 1),
        num_heads=(2, 2, 2, 2, 2), window_sizes=(3, 3, 3, 3, 3), quant_size=2,
        base_grid_size=0.25, k=4, capacity=512, n_windows=32, window_capacity=12)),
        lambda c: PW.Swin3DUNet(PW.Swin3DConfig(**dataclasses.asdict(c))),
        dict(n=200, valid=170, in_ch=6, hi=6.0, feat_lo=-1.0)),
    "octformer": (lambda: JO.OctFormer(JO.OctFormerConfig(
        in_channels=4, num_classes=5, fpn_channels=16, channels=(8, 16, 16, 16),
        num_blocks=(1, 1, 1, 1), num_heads=(2, 2, 2, 2), patch_size=8, dilation=2,
        stem_down=1, voxel_size=0.25, capacity=512, rpe_quant=4)),
        lambda c: PO.OctFormer(PO.OctFormerConfig(**dataclasses.asdict(c))),
        dict(n=256, valid=220, in_ch=4, hi=8.0)),
}


def _build(name, seed=0):
    make_j, make_p, cloud = BACKBONES[name]
    jm = make_j()
    coord, feat, mask = _cloud(seed, **cloud)
    params = random_flax_params(jm.init, seed + 11, jax.random.key(0), jnp.asarray(coord),
                                jnp.asarray(feat), jnp.asarray(mask))
    pm = make_p(jm.cfg)
    pm.load_state_dict(dense_tree_state_dict(jax.tree.map(np.asarray, params)))
    return jm, params, pm, (coord, feat, mask)


@pytest.mark.parametrize("name", list(BACKBONES))
def test_backbone_logits_and_parameter_gradients_match_jax(name):
    jm, params, pm, (coord, feat, mask) = _build(name)
    args = [jnp.asarray(a) for a in (coord, feat, mask)]
    w = np.random.default_rng(5).normal(size=(len(coord), jm.cfg.num_classes)).astype(np.float32)

    def loss(p):
        out = jm.apply(p, *args)
        return jnp.sum(out * w), out
    # fused, XLA recomputes PT-v1's pooled features with other roundings and
    # the max's gradient, which finds the maximum by equality, misses some of
    # them (finite differences side with the port): compiled without fusion
    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True)).lower(params).compile(
        {"xla_disable_hlo_passes": "fusion", "xla_backend_optimization_level": 0})(params)
    want = np.asarray(want)

    got = pm(T(coord), T(feat), T(mask))
    (got * T(w)).sum().backward()
    assert got.shape == want.shape and np.isfinite(want).all()
    assert _rel(got.detach().numpy(), want) < NET_TOL
    assert np.abs(got.detach().numpy()[~mask]).max() == 0.0
    want_g = dense_tree_state_dict(jax.tree.map(np.asarray, jgrads))
    got_g = {k: p.grad for k, p in pm.named_parameters()}
    assert set(got_g) == set(want_g)
    flat_w = np.concatenate([want_g[k].numpy().ravel() for k in sorted(want_g)])
    flat_g = np.concatenate([(got_g[k] if got_g[k] is not None
                              else torch.zeros_like(want_g[k])).numpy().ravel()
                             for k in sorted(want_g)])
    assert np.linalg.norm(flat_w) > 0 and _rel(flat_g, flat_w) < NET_TOL


@pytest.mark.parametrize("name", list(BACKBONES))
def test_backbone_padding_invariance(name):
    """Extra padding rows (random coords and features) change no valid
    logit of the port beyond PAD_TOL of the largest."""
    make_j, make_p, cloud = BACKBONES[name]
    torch.manual_seed(1)
    pm = make_p(make_j().cfg)
    coord, feat, mask = _cloud(1, **cloud)
    rng = np.random.default_rng(9)
    extra = 24
    coord2 = np.concatenate([coord, rng.uniform(-50, 50, (extra, 3)).astype(np.float32)])
    feat2 = np.concatenate([feat, rng.normal(size=(extra, feat.shape[1])).astype(np.float32)])
    mask2 = np.concatenate([mask, np.zeros(extra, bool)])
    with torch.no_grad():
        a = pm(T(coord), T(feat), T(mask)).numpy()
        b = pm(T(coord2), T(feat2), T(mask2)).numpy()
    if name in ("ptv1_seg26", "ptv2_map", "stratified"):
        # capacities follow N (N // stride, N * pool ratio, FPS counts), so
        # extra rows move the levels: the valid logits stay finite, padding 0
        assert np.isfinite(b).all() and np.abs(b[len(coord):]).max() == 0
        return
    np.testing.assert_allclose(b[:len(coord)][mask], a[mask], atol=PAD_TOL * np.abs(a).max())
    assert np.abs(b[~mask2]).max() == 0


def test_ptv2_interp_unpool_matches_jax():
    base = BACKBONES["ptv2_map"][0]().cfg
    for cfg in (dataclasses.replace(base, unpool_backend="interp"),):
        jm = J2.PointTransformerV2(cfg)
        coord, feat, mask = _cloud(0, **BACKBONES["ptv2_map"][2])
        args = [jnp.asarray(a) for a in (coord, feat, mask)]
        params = random_flax_params(jm.init, 4, jax.random.key(0), *args)
        pm = P2.PointTransformerV2(P2.PTv2Config(**dataclasses.asdict(cfg)))
        pm.load_state_dict(dense_tree_state_dict(jax.tree.map(np.asarray, params)))
        want = np.asarray(jax.jit(jm.apply)(params, *args))
        with torch.no_grad():
            got = pm(T(coord), T(feat), T(mask)).numpy()
        assert got.shape == want.shape and _rel(got, want) < NET_TOL


def test_stratified_windows_and_edges_equal_jax():
    """window_buckets (both shifts, with capacity overflow) and
    stratified_edges integer for integer."""
    cfg = BACKBONES["stratified"][0]().cfg
    coord, _, mask = _cloud(0, **BACKBONES["stratified"][2])
    buckets = jax.jit(JS.window_buckets, static_argnums=(2, 3, 4, 5, 6))
    edges = jax.jit(JS.stratified_edges, static_argnums=(3, 4, 5, 6))
    for shift in (False, True):
        want = buckets(jnp.asarray(coord), jnp.asarray(mask), 0.8, 32, 6, 10, shift)
        got = PS.window_buckets(T(coord), T(mask), 0.8, 32, 6, 10, shift)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert (~np.asarray(want[1])).any() and np.asarray(want[1]).any()
        we = edges(jnp.asarray(coord), jnp.asarray(mask), want[3], 0.8, cfg, 32, shift)
        ge = PS.stratified_edges(T(coord), T(mask), got[3], 0.8, cfg, 32, shift)
        for g, w in zip(ge, we):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert np.asarray(we[2]).any()


@pytest.mark.parametrize("target, params", [
    ("ptv1_seg26", {"in_channels": 4, "planes": [8, 16, 16, 24, 32], "num_classes": 5,
                    "not_a_key": 1}),
    ("ptv1_seg38", {"in_channels": 4, "planes": [8, 16, 16, 24, 32]}),
    ("ptv1_seg50", {"in_channels": 4, "planes": [8, 16, 16, 24, 32]}),
    ("ptv2", {"in_channels": 4, "enc_channels": [24, 48, 96, 96], "enc_groups": [6, 12, 24, 24],
              "dec_channels": [12, 24, 48, 48], "dec_groups": [3, 6, 12, 12], "extra": True}),
    ("spunet", {"in_channels": 4, "channels": [8, 16, 16, 8], "layers": [1, 1, 1, 1]}),
    ("stratified", {"in_channels": 4, "channels": [8, 16, 16, 16], "num_heads": [2, 2, 2, 2],
                    "k": 4, "kp_neighbors": 4}),
    ("octformer", {"in_channels": 4, "channels": [8, 16, 16, 16], "num_heads": [2, 2, 2, 2],
                   "fpn_channels": 16}),
    ("swin3d", {"channels": [8, 16, 16, 16, 16], "num_heads": [2, 2, 2, 2, 2]}),
])
def test_registry_builds_the_zoo_as_jax(target, params):
    """The same config in both packages (extra keys dropped, lists as
    tuples); the backbone tests load JAX trees into these classes strictly."""
    jm = jax_instantiate({"target": target, "params": params})
    pm = instantiate_from_config({"target": target, "params": params})
    assert type(pm).__name__ == type(jm).__name__
    assert dataclasses.asdict(pm.cfg) == dataclasses.asdict(jm.cfg)
