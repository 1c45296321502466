"""PyTorch port vs the JAX package: point ops, the differentiable chamfer
loss and the G2SD object autoencoder (``g2sd_32.yaml``).

``ops/pointops`` on clouds with exact ties (small-integer coordinates, so
every distance is exact in f32): indices equal, ties broken by the lower
index as ``jax.lax.top_k``. ``chamfer_loss`` and its gradient on dyadic
clouds with tied minima and zero distances (exact, where JAX splits the
gradient evenly over tied minima and halves it at the clamp) and on random
clouds (1e-5 relative). ``VQModelObject`` at small size (3 objects of 128
points, 64 folded points), on JAX's weights carried by
``utils/convert.dense_tree_state_dict``: the forward (1e-5 relative L2),
the loss and gradients (1e-4 relative L2) and one trainer step against
JAX's ``build_family_trainer`` (parameters and EMA within 2 lr), with
crops padded by repetition as the reader pads them. The factory's
``nusc_object`` equals JAX's, synthetic and read from a dbinfos pickle.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lidar_layout_tpu.config import instantiate_from_config as jax_instantiate
from lidar_layout_tpu.data import factory as JF
from lidar_layout_tpu.models import object_ae as JO
from lidar_layout_tpu.ops import chamfer as JC
from lidar_layout_tpu.ops import pointops as JP
from lidar_layout_tpu.train.build import SimpleTrainState, build_family_trainer
from lidar_layout_tpu_torch.config import instantiate_from_config, load_yaml
from lidar_layout_tpu_torch.data import factory as PF
from lidar_layout_tpu_torch.models import object_ae as PO
from lidar_layout_tpu_torch.ops import chamfer as PC
from lidar_layout_tpu_torch.ops import pointops as PP
from lidar_layout_tpu_torch.train import cube_trainer as CT
from lidar_layout_tpu_torch.train import family_trainer as FT
from lidar_layout_tpu_torch.utils.convert import dense_tree_state_dict
from torch_port_helpers import one_intra_op_thread, random_flax_params, rel_l2

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
T = torch.from_numpy
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, P, G, LR = 3, 128, 64, 1e-3
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
CFG = {"target": "vq_model_object", "params": {
    "num_points": P, "embed_dim": 1024, "n_embed": 64,
    "modelconfig": {"params": {"num_grids": G}}}}


def _grid_cloud(rng, n, span=3):
    """Points on a small integer lattice: many exact distance ties."""
    return rng.integers(-span, span + 1, (n, 3)).astype(np.float32)


# ------------------------------------------------------------- pointops
def test_knn_query_breaks_ties_by_the_lower_index_as_jax():
    rng = np.random.default_rng(0)
    pts, query = _grid_cloud(rng, 200), _grid_cloud(rng, 40)
    mask = rng.uniform(size=200) > 0.2
    for k, m in ((9, None), (17, mask)):
        want_i, want_d = JP.knn_query(jnp.asarray(query), jnp.asarray(pts), k,
                                      None if m is None else jnp.asarray(m))
        got_i, got_d = PP.knn_query(T(query), T(pts), k, None if m is None else T(m))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
        d = got_d.numpy()
        assert (d[:, 1:] == d[:, :-1]).any()            # ties inside the k nearest
    # batched: each cloud is its own query set
    clouds = np.stack([_grid_cloud(rng, 64) for _ in range(2)])
    got_i, _ = PP.knn_query(T(clouds), T(clouds), 5)
    for b in range(2):
        want_i, _ = JP.knn_query(jnp.asarray(clouds[b]), jnp.asarray(clouds[b]), 5)
        np.testing.assert_array_equal(got_i[b].numpy(), np.asarray(want_i))


def test_other_point_ops_match_jax():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    mask = rng.uniform(size=300) > 0.3
    mask[0] = False                                       # FPS starts at the first valid
    feats = rng.normal(size=(300, 5)).astype(np.float32)
    query = rng.normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        PP.farthest_point_sample(T(pts), 32, T(mask)).numpy(),
        np.asarray(JP.farthest_point_sample(jnp.asarray(pts), 32, jnp.asarray(mask))))
    got_i, got_in = PP.ball_query(T(query), T(pts), 0.6, 12, T(mask))
    want_i, want_in = JP.ball_query(jnp.asarray(query), jnp.asarray(pts), 0.6, 12,
                                    jnp.asarray(mask))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    assert not got_in.all() and got_in.any()
    grouped = PP.group_points(T(pts), T(feats), got_i, T(query))
    want = JP.group_points(jnp.asarray(pts), jnp.asarray(feats), want_i, jnp.asarray(query))
    np.testing.assert_allclose(grouped.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    got = PP.three_nn_interpolate(T(query), T(pts), T(feats), T(mask))
    want = JP.three_nn_interpolate(jnp.asarray(query), jnp.asarray(pts), jnp.asarray(feats),
                                   jnp.asarray(mask))
    assert rel_l2(got.numpy(), want) <= OUT_TOL
    got = PP.three_nn_interpolate(T(query), T(pts[:2]), T(feats[:2]))   # k clamps to 2
    want = JP.three_nn_interpolate(jnp.asarray(query), jnp.asarray(pts[:2]),
                                   jnp.asarray(feats[:2]))
    assert rel_l2(got.numpy(), want) <= OUT_TOL
    nb = rng.normal(size=(50, 12, 5)).astype(np.float32)
    np.testing.assert_array_equal(PP.subtraction(T(feats[:50]), T(nb)).numpy(),
                                  np.asarray(JP.subtraction(jnp.asarray(feats[:50]),
                                                            jnp.asarray(nb))))
    w = rng.normal(size=(50, 12, 1)).astype(np.float32)
    np.testing.assert_allclose(PP.aggregation(T(nb), T(w)).numpy(),
                               np.asarray(JP.aggregation(jnp.asarray(nb), jnp.asarray(w))),
                               rtol=1e-6, atol=1e-6)


# -------------------------------------------------------- chamfer_loss
def _chamfer_pair(x, y):
    loss, grads = jax.value_and_grad(JC.chamfer_loss, argnums=(0, 1))(jnp.asarray(x),
                                                                       jnp.asarray(y))
    xt, yt = T(x).requires_grad_(), T(y).requires_grad_()
    got = PC.chamfer_loss(xt, yt)
    got.backward()
    return got, (xt.grad, yt.grad), loss, grads


def test_chamfer_loss_gradient_splits_ties_and_halves_at_zero_as_jax():
    """Dyadic clouds: y holds a twin pair (x_0's minimum ties over them),
    x_1 sits equidistant from three y, x_2 lies on a y (distance exactly 0).
    Every distance is exact, so the gradients must be JAX's to rounding
    (the shares of a tie are thirds, summed in another order). The
    clamp's gradient at 0 is held alone: at a coincident pair the
    expansion's own gradient 2 (x - y) is 0 whatever the clamp passes."""
    x = np.array([[0.5, 0, 0], [0, 0, 0], [2, 2, 2], [-1, 1, 0.25]], np.float32)
    y = np.array([[1, 0, 0], [1, 0, 0], [-1, 0, 0], [2, 2, 2], [0, -3, 0.5]], np.float32)
    got, (gx, gy), want, (wx, wy) = _chamfer_pair(x, y)
    assert float(got.detach()) == float(want)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=1e-6, atol=1e-7)
    # the tied twins share x_0's pull; the zero distance passes half its gradient
    assert gy[0, 0] == gy[1, 0] != 0
    assert float(gx[2].abs().sum()) == 0.0 and float(gy[3].abs().sum()) == 0.0
    d0 = np.array([0.0, 1.0, -1.0], np.float32)
    want_clamp = jax.grad(lambda d: jnp.maximum(d, 0.0).sum())(jnp.asarray(d0))
    dt = T(d0).requires_grad_()
    torch.maximum(dt, torch.zeros(())).sum().backward()
    np.testing.assert_array_equal(dt.grad.numpy(), np.asarray(want_clamp))
    assert dt.grad[0] == 0.5
    # a min(dim) that sends the whole gradient to one twin disagrees with JAX
    xt, yt = T(x).requires_grad_(), T(y).requires_grad_()
    d = ((xt[:, None] - yt[None]) ** 2).sum(-1)
    (d.min(dim=1).values.mean() + d.min(dim=0).values.mean()).backward()
    assert not np.allclose(yt.grad.numpy(), np.asarray(wy), rtol=1e-3, atol=1e-3)


def test_chamfer_loss_and_gradient_match_jax_on_random_clouds():
    rng = np.random.default_rng(2)
    x, y = (rng.normal(size=(n, 3)).astype(np.float32) for n in (200, 300))
    got, (gx, gy), want, (wx, wy) = _chamfer_pair(x, y)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=OUT_TOL)
    assert rel_l2(gx.numpy(), wx) <= GRAD_TOL and rel_l2(gy.numpy(), wy) <= GRAD_TOL
    xs, ys = (rng.normal(size=(2, n, 3)).astype(np.float32) for n in (50, 70))
    batched = PC.chamfer_loss(T(xs), T(ys))
    for b in range(2):
        np.testing.assert_allclose(float(batched[b]), float(JC.chamfer_loss(
            jnp.asarray(xs[b]), jnp.asarray(ys[b]))), rtol=OUT_TOL)
    with pytest.raises(RuntimeError, match="chamfer_loss"):
        PC.nn_dist_one_way(T(x).requires_grad_(), T(y))


# ---------------------------------------------------------- the model
def _objects(seed=3):
    """B crops of P points: the first two resampled with repeats from 40
    and 100 points (as the reader pads a small crop), the third distinct."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (40, 100, P):
        crop = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        out.append(crop[rng.integers(0, n, P)] if n < P else crop)
    return np.stack(out)


@pytest.fixture(scope="module")
def object_pair():
    jmodel = jax_instantiate(CFG)
    params = jax.tree.map(np.array, random_flax_params(
        jmodel.init, 4, jax.random.key(0), jnp.zeros((P, 3))))
    port = instantiate_from_config(CFG)
    port.load_state_dict(dense_tree_state_dict(params), strict=True)
    return jmodel, params, port, _objects()


def test_object_ae_forward_and_loss_match_jax(object_pair):
    jmodel, params, port, pts = object_pair
    assert (port.cfg.num_points, port.cfg.num_grids, port.cfg.cdw_dim) == (P, G, 1024)
    assert all(m.eps == 1e-6 for m in port.modules() if isinstance(m, torch.nn.LayerNorm))
    with torch.no_grad():
        cdw = port.encode(T(pts))
        rec, qloss, _ = port(T(pts))
        loss, parts = PO.object_ae_loss(rec, T(pts), qloss)
    # jitted: op by op, the first forward of a process compiles each primitive
    encode = jax.jit(lambda p, v: jmodel.apply(p, v, method=jmodel.encode))
    apply = jax.jit(jmodel.apply)
    for b in range(B):
        x = jnp.asarray(pts[b])
        want_cdw = encode(params, x)
        want_rec, want_q, _ = apply(params, x)
        assert rel_l2(cdw[b].numpy(), want_cdw) <= OUT_TOL
        assert rel_l2(rec[b].numpy(), want_rec) <= OUT_TOL
        want_loss, want_parts = JO.object_ae_loss(want_rec, x, want_q)
        np.testing.assert_allclose(float(loss[b]), float(want_loss), rtol=OUT_TOL)
        np.testing.assert_allclose(float(parts["rec_loss"][b]), float(want_parts["rec_loss"]),
                                   rtol=OUT_TOL)
    np.testing.assert_array_equal(PO.build_lattice(8), JO.build_lattice(8))
    # an encoder that took the first duplicate as the point itself still agrees:
    # NbrAgg reads only coordinates
    assert len(np.unique(pts[0], axis=0)) < P


def test_object_ae_step_matches_jax(object_pair):
    """One object-AE trainer step against JAX's (the mean over objects of
    ``object_ae_loss``, ``optax.adamw``, the EMA): loss, gradients (JAX's
    from Adam's first moment), parameters and EMA."""
    jmodel, params, port, pts = object_pair
    ft = build_family_trainer(jmodel, CFG, seed=0, lr=LR, accumulate=2, geom=None)
    assert ft.monitor == "val/rec_loss"
    tx = optax.adamw(LR)
    jstate = SimpleTrainState(params=params, opt_state=tx.init(params), ema=params,
                              step=jnp.zeros((), jnp.int32))
    want_state, want_logs = ft.step(jstate, {"fg_points": jnp.asarray(pts)}, jax.random.key(0))
    want_g = dense_tree_state_dict(jax.tree.map(lambda m: np.asarray(m) * 10.0,
                                               want_state.opt_state[0].mu))

    import copy

    model = copy.deepcopy(port)
    state, step, val_step, monitor = FT.family_training(model, CFG, LR, accumulate=2)
    assert monitor == "val/rec_loss" and state.optimizer.accumulate == 1
    assert state.optimizer.adamw.defaults["weight_decay"] == 1e-4
    grads = {}
    real = state.optimizer.step

    def spy():
        grads.update({k: p.grad.detach().clone() for k, p in state.params.items()})
        return real()
    state.optimizer.step = spy
    state, logs = step(state, {"fg_points": T(pts)}, None)
    np.testing.assert_allclose(float(logs["loss"]), float(want_logs["loss"]), rtol=OUT_TOL)
    np.testing.assert_allclose(float(logs["rec_loss"]), float(want_logs["rec_loss"]),
                               rtol=OUT_TOL)
    num = sum(float((grads[k] - want_g[k]).square().sum()) for k in grads)
    den = sum(float(want_g[k].square().sum()) for k in grads)
    assert sorted(grads) == sorted(want_g) and den > 0 and (num / den) ** 0.5 <= GRAD_TOL
    want_p = dense_tree_state_dict(jax.tree.map(np.asarray, want_state.params))
    want_e = dense_tree_state_dict(jax.tree.map(np.asarray, want_state.ema))
    perr = max(float((state.params[k].detach() - want_p[k]).abs().max()) for k in want_p)
    eerr = max(float((state.ema.params[k] - want_e[k]).abs().max()) for k in want_e)
    assert perr <= 2 * LR and eerr <= 2 * LR and state.step == 1
    assert CT.ema_decay(0) == pytest.approx(0.1)
    want_val = ft.val_step(want_state, {"fg_points": jnp.asarray(pts)}, jax.random.key(1))
    got_val = val_step(state, {"fg_points": T(pts)}, None)
    np.testing.assert_allclose(float(got_val["rec_loss"]), float(want_val["rec_loss"]),
                               rtol=1e-3)


def test_object_ae_quantizer_path_matches_jax():
    cfg = JO.ObjectAEConfig(num_points=64, num_grids=16, quantize_latent=True, n_embed=32,
                            embed_dim=64)
    jmodel = JO.VQModelObject(cfg)
    params = jax.tree.map(np.array, random_flax_params(jmodel.init, 5, jax.random.key(0),
                                                       jnp.zeros((64, 3))))
    port = PO.VQModelObject(PO.ObjectAEConfig(**{k: getattr(cfg, k) for k in (
        "num_points", "num_grids", "quantize_latent", "n_embed", "embed_dim")}))
    port.load_state_dict(dense_tree_state_dict(params), strict=True)
    pts = np.random.default_rng(6).uniform(-1, 1, (2, 64, 3)).astype(np.float32)
    with torch.no_grad():
        rec, qloss, ind = port(T(pts))
    for b in range(2):
        want_rec, want_q, want_ind = jax.jit(jmodel.apply)(params, jnp.asarray(pts[b]))
        assert rel_l2(rec[b].numpy(), want_rec) <= OUT_TOL
        np.testing.assert_allclose(float(qloss[b]), float(want_q), rtol=OUT_TOL)
        np.testing.assert_array_equal(ind[b].numpy(), np.asarray(want_ind))


# ---------------------------------------------------------- data, YAML
def test_nusc_object_batches_equal_jax(tmp_path, capsys):
    params = {"split": "train", "num_samples": 96}
    want = next(JF.build_batches("nusc_object", params, {}, None, 2, seed=3))
    got = next(PF.build_batches("nusc_object", params, {}, None, 2, seed=3))
    assert "nusc_object: no dbinfos at None — synthetic fallback" in capsys.readouterr().out
    for k in ("fg_points", "fg_class"):
        assert got[k].dtype == T(want[k]).dtype
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    # a dbinfos pickle and crops under the root, one too small (re-drawn)
    rng = np.random.default_rng(7)
    db = {}
    for i, name in enumerate(("car", "pedestrian", "car", "bus", "truck")):
        path = f"crops/{i}.bin"
        os.makedirs(tmp_path / "crops", exist_ok=True)
        n = 30 if i == 2 else 200 + 10 * i
        rng.normal(size=(n, 5)).astype(np.float32).tofile(str(tmp_path / path))
        db.setdefault(name, []).append({"path": path, "num_points_in_gt": n,
                                        "box3d_lidar": rng.uniform(0.5, 3, 7).tolist()})
    pkl = str(tmp_path / "dbinfos.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(db, f)
    params = {"split": "train", "pkl_path": pkl, "num_samples": 128}
    want = JF.build_batches("nusc_object", params, {}, str(tmp_path), 2, seed=4)
    got = PF.build_batches("nusc_object", params, {}, str(tmp_path), 2, seed=4)
    for _ in range(3):
        w, g = next(want), next(got)
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_registry_builds_g2sd_32_as_jax():
    cfg = load_yaml(os.path.join(ROOT, "configs", "autoencoder", "nuscenes_objects",
                                 "g2sd_32.yaml"))["model"]
    port, jmodel = instantiate_from_config(cfg), jax_instantiate(cfg)
    fields = ("num_points", "num_grids", "num_neighbors", "cdw_dim", "quantize_latent",
              "n_embed", "embed_dim")
    assert {f: getattr(port.cfg, f) for f in fields} == {f: getattr(jmodel.cfg, f)
                                                         for f in fields}
    assert port.cfg.num_grids == 256 and not port.cfg.quantize_latent
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((512, 3)))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == sum(
        p.numel() for p in port.parameters())
