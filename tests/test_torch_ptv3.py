"""PyTorch port vs the JAX package: Point Transformer V3.

``grid_pool_segments``, ``segment_mean``, ``PatchAttention`` (a patch of
padding alone, and ``enable_rpe``), the PT-v3 forward (encoder-decoder and
``encoder_only``) and ``PTv3Segmentor`` at the JAX tests' small config
(widths 16-64, patch 64, 8 bits) with a 0.5 m grid (at 0.05 m, 8 bits
span 12.8 m and most of a scene clips to the edge) on one synthetic cloud
of 512 rows, 40 of them padding: level 1 holds at most 256 segments and
the cloud has more cells, so it overflows into its last row. The same
numpy inputs and a JAX tree drawn with numpy (``random_flax_params``), carried to the port by
``utils/convert.dense_tree_state_dict``. Integers (segment ids, validity,
sort orders, the curve orders of a level) must be equal; f32 outputs
within 1e-6 relative L2 (the port reads 4e-7). An erf GELU and a LayerNorm eps of 1e-5 each fail
that comparison. Also: the registry builds the dense-decoder YAMLs'
backbones as JAX's ``build_ptv3_cfg`` does, and ``voxel_1024_pt.yaml``
(whose ``edconfig`` names PT-v3) as the same ``SparseVAE`` in both packages.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lidar_layout_tpu.config import instantiate_from_config as jax_instantiate
from lidar_layout_tpu.models import ptv3 as J
from lidar_layout_tpu.ops.serialization import argsort_with_mask as j_argsort
from lidar_layout_tpu.ops.serialization import serialize_code as j_code
from lidar_layout_tpu_torch.config import instantiate_from_config, load_yaml
from lidar_layout_tpu_torch.data.synthetic import synthetic_scene
from lidar_layout_tpu_torch.models import ptv3 as P
from lidar_layout_tpu_torch.train import train_lidm as TL
from lidar_layout_tpu_torch.utils.convert import dense_tree_state_dict
from torch_port_helpers import one_intra_op_thread, random_flax_params

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)


def T(a):
    return torch.from_numpy(np.array(a))


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, PAD = 512, 40
TOL = 1e-6
SMALL = dict(in_channels=4, patch_size=64, enc_depths=(1, 1, 1), enc_channels=(16, 32, 64),
             enc_heads=(2, 4, 8), dec_depths=(1, 1), dec_channels=(16, 32), dec_heads=(2, 4),
             bits=8, grid_size=0.5)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _cloud(seed=0):
    """One synthetic scene of N rows, the last PAD of them padding; feats
    are [xyz, U(0, 1)] as the factory's."""
    rng = np.random.default_rng(seed)
    pts = synthetic_scene(rng, N).astype(np.float32)
    feats = np.concatenate([pts, rng.uniform(0, 1, (N, 1))], -1).astype(np.float32)
    mask = np.ones(N, bool)
    mask[-PAD:] = False
    return pts, feats, mask


def _jax_apply(model, params, *args):
    return jax.jit(lambda p, *a: model.apply(p, *a))(params, *(jnp.asarray(a) for a in args))


def _port(module, params):
    module.load_state_dict(dense_tree_state_dict(jax.tree.map(np.asarray, params)))
    return module.eval()


def test_grid_pool_segments_and_segment_mean_match_jax_with_overflow():
    pts, feats, mask = _cloud(1)
    grid = np.clip(np.floor((pts - pts[mask].min(0)) / 0.5), 0, 255).astype(np.int32)
    codes = np.asarray(j_code(jnp.asarray(grid >> 1), "z", 8))
    for cap in (N // 2, 64):
        want = J.grid_pool_segments(jnp.asarray(codes), jnp.asarray(mask), cap)
        got = P.grid_pool_segments(T(codes), T(mask), cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert len(np.unique(codes[mask])) > cap and bool(got[1].all())   # overflowed
        seg = np.asarray(want[0])
        wm = J.segment_mean(jnp.asarray(feats), jnp.asarray(seg), jnp.asarray(mask), cap)
        gm = P.segment_mean(T(feats), T(seg).long(), T(mask), cap)
        assert _rel(gm.numpy(), wm) <= 1e-6
    # no valid point: no valid segment
    none = P.grid_pool_segments(T(codes), T(np.zeros(N, bool)), 16)
    assert not bool(none[1].any())


@pytest.mark.parametrize("rpe", [False, True])
def test_patch_attention_with_a_padding_patch_matches_jax(rpe):
    """Three patches of 64 (the last of padding alone, so every key gets
    -1e9) with a ragged tail of padding in the second."""
    rng = np.random.default_rng(2)
    n, c, heads, p = 150, 32, 4, 64
    x = rng.standard_normal((n, c)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[100:] = False
    grid = rng.integers(0, 60, (n, 3)).astype(np.int32)
    jm = J.PatchAttention(heads, p, enable_rpe=rpe)
    params = random_flax_params(jm.init, 3, jax.random.key(0), jnp.asarray(x), jnp.asarray(mask),
                                jnp.asarray(grid))
    want = _jax_apply(jm, params, x, mask, grid)
    got = _port(P.PatchAttention(c, heads, p if rpe else None), params)(
        T(x), T(mask), p, T(grid) if rpe else None)
    assert _rel(got.detach().numpy(), want) <= TOL
    # the padding patch (rows 128-149) attends uniformly: mean of its v
    assert bool(torch.isfinite(got).all())


def test_patch_attention_gradients_with_a_padding_patch_match_jax():
    """Patches of 128 (JAX's fused path: -1e9 key bias, the vjp of
    ``_attend_ref``): the third patch is padding alone, so its logits all
    round to -1e9 and it attends uniformly. The gradients of a weighted sum
    of every output row (padding rows too) for the input and the weights
    match JAX's. The saved log-sum-exp is taken less the row's largest key
    bias: at -1e9 + log 128 in f32 it would lose log 128, and the padding
    patch's recomputed probabilities would be 1, not 1/128."""
    rng = np.random.default_rng(4)
    n, c, heads, p = 300, 32, 2, 128
    x = rng.standard_normal((n, c)).astype(np.float32)
    w = rng.standard_normal((n, c)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[200:] = False
    jm = J.PatchAttention(heads, p)
    params = random_flax_params(jm.init, 8, jax.random.key(0), jnp.asarray(x), jnp.asarray(mask))

    def loss(prm, xx):
        return jnp.sum(jm.apply(prm, xx, jnp.asarray(mask)) * w)
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    pm = _port(P.PatchAttention(c, heads), params)
    xt = T(x).requires_grad_()
    out = pm(xt, T(mask), p)
    grads = torch.autograd.grad(torch.sum(out * T(w)), [xt] + list(pm.parameters()))
    assert _rel(grads[0].numpy(), gx) <= 1e-5
    want = dense_tree_state_dict(jax.tree.map(np.asarray, gp))
    for (name, _), g in zip(pm.named_parameters(), grads[1:]):
        assert _rel(g.numpy(), want[name]) <= 1e-5, name
    assert float(grads[0][256:].abs().max()) > 0   # the padding patch has a gradient


@pytest.fixture(scope="module")
def pair():
    pts, feats, mask = _cloud()
    cfg_j, cfg_p = J.PTv3Config(**SMALL), P.PTv3Config(**SMALL)
    jm = J.PTv3(cfg_j)
    params = random_flax_params(jm.init, 5, jax.random.key(0), jnp.asarray(pts),
                                jnp.asarray(feats), jnp.asarray(mask))
    return (pts, feats, mask), jm, params, _port(P.PTv3(cfg_p), params)


def test_ptv3_orders_and_forward_match_jax(pair):
    (pts, feats, mask), jm, params, pm = pair
    grid = pm._grid(T(pts), T(mask))
    origin = np.min(np.where(mask[:, None], pts, np.inf), 0)
    want_grid = np.clip(np.asarray(jnp.floor((jnp.asarray(pts) - origin) / 0.5)
                                   .astype(jnp.int32)), 0, 255)
    np.testing.assert_array_equal(grid.numpy(), want_grid)
    orders, inverses = P._serial_orders(grid, T(mask), SMALL_ORDERS, 8)
    for o, got in zip(SMALL_ORDERS, orders):
        want = j_argsort(j_code(jnp.asarray(want_grid), o, 8), jnp.asarray(mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(torch.gather(orders, 1, inverses), torch.arange(N).expand(4, N))
    wx, wmask = _jax_apply(jm, params, pts, feats, mask)
    with torch.no_grad():
        gx, gmask = pm(T(pts), T(feats), T(mask))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    assert gx.shape == (N, 16) and _rel(gx.numpy(), wx) <= TOL
    fill = [(int(m.sum()), m.shape[0]) for _, m, _ in pm.pooled_levels(T(pts), T(mask))]
    assert fill[0] == (N - PAD, N) and fill[1] == (N // 2, N // 2)   # level 1 full


SMALL_ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")


def test_ptv3_encoder_only_and_segmentor_match_jax():
    pts, feats, mask = _cloud(3)
    cfg_j, cfg_p = J.PTv3Config(**SMALL), P.PTv3Config(**SMALL)
    je = J.PTv3(cfg_j, encoder_only=True)
    params = random_flax_params(je.init, 6, jax.random.key(0), jnp.asarray(pts),
                                jnp.asarray(feats), jnp.asarray(mask))
    wx, wm = _jax_apply(je, params, pts, feats, mask)
    with torch.no_grad():
        gx, gm = _port(P.PTv3(cfg_p, encoder_only=True), params)(T(pts), T(feats), T(mask))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert gx.shape == (N // 4, 64) and _rel(gx.numpy(), wx) <= TOL

    js = J.PTv3Segmentor(cfg_j, num_classes=5, backbone_out_channels=24)
    params = random_flax_params(js.init, 7, jax.random.key(0), jnp.asarray(pts),
                                jnp.asarray(feats), jnp.asarray(mask))
    want = _jax_apply(js, params, pts, feats, mask)
    with torch.no_grad():
        got = _port(P.PTv3Segmentor(cfg_p, 5, 24), params)(T(pts), T(feats), T(mask))
    assert got.shape == (N, 5) and _rel(got.numpy(), want) <= TOL
    assert not got[~T(mask)].any()


@pytest.mark.parametrize("fault", ["erf GELU", "LayerNorm eps 1e-5"])
def test_erf_gelu_or_torch_layernorm_eps_fails_the_comparison(pair, fault, monkeypatch):
    (pts, feats, mask), jm, params, pm = pair
    wx, _ = _jax_apply(jm, params, pts, feats, mask)
    if fault == "erf GELU":
        gelu = F.gelu
        monkeypatch.setattr(P.F, "gelu", lambda x, approximate="none": gelu(x))
    else:
        for m in pm.modules():
            if isinstance(m, torch.nn.LayerNorm):
                monkeypatch.setattr(m, "eps", 1e-5)
    with torch.no_grad():
        gx, _ = pm(T(pts), T(feats), T(mask))
    assert _rel(gx.numpy(), wx) > TOL


def test_drop_path_and_shuffled_orders_draw_from_the_generator(pair):
    (pts, feats, mask), _, _, pm = pair
    cfg = dataclasses.replace(pm.cfg, drop_path=0.5)
    m = P.PTv3(cfg)
    m.load_state_dict(pm.state_dict())
    args = (T(pts), T(feats), T(mask))
    with torch.no_grad():
        det = m(*args)[0]
        a = m(*args, deterministic=False, generator=torch.Generator().manual_seed(1))[0]
        b = m(*args, deterministic=False, generator=torch.Generator().manual_seed(1))[0]
        c = m(*args, deterministic=False, generator=torch.Generator().manual_seed(2))[0]
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, det)
    assert torch.allclose(det, pm(*args)[0])


@pytest.mark.parametrize("yaml", ["gaus_10cm.yaml", "ptv3.yaml"])
def test_registry_builds_the_dense_decoder_backbones_as_jax(yaml):
    cfg = load_yaml(os.path.join(ROOT, "configs", "ours", "nuscenes", "dense_decoder", yaml))
    jmodel = jax_instantiate(cfg["model"])
    port = instantiate_from_config(cfg["model"])
    assert dataclasses.asdict(port.backbone.cfg) == dataclasses.asdict(jmodel.backbone_cfg)
    wide = instantiate_from_config(cfg["model"], in_features=4)
    assert wide.backbone.embed.in_features == 4
    assert wide.backbone.cfg.patch_size == 1024 and wide.backbone.cfg.grid_size == 0.05


def test_voxel_1024_pt_builds_the_same_sparse_vae_in_both_packages(tmp_path):
    """Neither package reads ``edconfig``: the YAML that names PT-v3 as the
    cube encoder builds voxel_1024.yaml's SparseVAE; it trains one step."""
    refine = os.path.join(ROOT, "configs", "ours", "nuscenes", "refine_voxel")
    pt = load_yaml(os.path.join(refine, "voxel_1024_pt.yaml"))["model"]
    plain = load_yaml(os.path.join(refine, "voxel_1024.yaml"))["model"]
    assert "ptv3" in str(pt["params"].get("edconfig"))
    port, jmodel = instantiate_from_config(pt), jax_instantiate(pt)
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(jmodel.cfg)
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(instantiate_from_config(plain).cfg)
    trainer = TL.main(["-b", os.path.join(refine, "voxel_1024_pt.yaml"), "--cpu", "--synthetic",
                       "--steps", "1", "--workdir", str(tmp_path),
                       "model.params.base_capacity=128", "model.params.unetconfig.params.f_maps=8",
                       "data.params.batch_size=2", "data.params.num_val_batches=1",
                       "data.params.train.params.max_points=600",
                       "data.params.validation.params.max_points=600"])
    assert trainer.global_step == 1
