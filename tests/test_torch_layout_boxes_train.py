"""PyTorch port vs the JAX package: training LayoutDiffusion (scene graph -> boxes).

The scene-graph data (the manipulations of ``data/graph_aug``, the nuScenes
layout dataset on a tiny infos pickle and CLIP pickles, the traffic
distribution and its relation metrics, the data factory's
``nusc_layout_graph`` target) is numpy in both packages and must be equal
bit for bit from the same seeds. The model parts run at small widths (U-Net
64 channels, scene-graph embedding 16, relation token 96; 2 scenes of up to
4 objects) on the CPU in float32: the U-Net1D's ``concat`` and ``hybrid``
conditioning, one attention at S = 1 and its gradients, and one training
step (loss, gradients, AdamW with clipping, EMA) against
``jax.value_and_grad(model.p_losses)`` and ``train/build._simple_update``
with JAX's draws fed in. Last, the ``train_layout`` CLI and ``sample_layout``
on its run directory.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lidar_layout_tpu.data import factory as jax_factory
from lidar_layout_tpu.data import graph_aug as JG
from lidar_layout_tpu.data import layout_synthetic as JS
from lidar_layout_tpu.data import nuscenes_layout as JN
from lidar_layout_tpu.models.layout_diffusion import LayoutDiffusion as JaxLD
from lidar_layout_tpu.models.layout_diffusion import LayoutDiffusionConfig as JaxLDC
from lidar_layout_tpu.models.unet1d import UNet1DConfig as JaxU1C
from lidar_layout_tpu.nn import attention as JA
from lidar_layout_tpu.train.build import _simple_state, _simple_update
from lidar_layout_tpu.utils import memory as JM
from lidar_layout_tpu_torch.data import factory as PF
from lidar_layout_tpu_torch.data import graph_aug as PG
from lidar_layout_tpu_torch.data import layout_synthetic as PS
from lidar_layout_tpu_torch.data import nuscenes_layout as PN
from lidar_layout_tpu_torch.encoders.scene_graph import graph_tensors
from lidar_layout_tpu_torch.models.layout_diffusion import LayoutDiffusion, LayoutDiffusionConfig
from lidar_layout_tpu_torch.models.unet1d import UNet1DConfig
from lidar_layout_tpu_torch.nn import attention as PA
from lidar_layout_tpu_torch.ops import attention as A
from lidar_layout_tpu_torch.train import layout_trainer as LT
from lidar_layout_tpu_torch.utils import memory as PM
from lidar_layout_tpu_torch.utils.convert import (layout_diffusion_state_dict,
                                                  layout_train_state_dicts)
from torch_port_helpers import one_intra_op_thread, random_flax_params

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
UNET = dict(model_channels=64, num_heads=8, concat_dim=96, crossattn_dim=96)
# the training step's U-Net: two levels of one block (4 Transformer1Ds);
# JAX's jitted step compiles for 19 s on the CPU at this depth, 40 s at four
STEP_UNET = dict(UNET, channel_mult=(1, 1), num_res_blocks=1)
SG_DIM = 16
UNET_TOL = 2.5e-6   # one U-Net eval, f32 on one CPU (test_torch_layout_diffusion's)
LOSS_TOL = 1e-6     # the loss of one step, relative
GRAD_TOL = 1e-5     # each module's whole gradient, relative L2
LR = 1e-3


def _equal_graphs(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _graph(seed=0, n_scenes=2, objs=4, triples=6, with_changes=False):
    return PS.synthetic_graph_batch(np.random.default_rng(seed), n_scenes=n_scenes,
                                    max_objs_per_scene=objs, max_triples_per_scene=triples,
                                    with_changes=with_changes)


# ------------------------------------------------------------ graph_aug
def test_remove_node_and_modify_relationship_as_jax():
    g = _graph(3, n_scenes=3, objs=5, triples=8)
    _equal_graphs(PG.remove_node(g, 6), JG.remove_node(g, 6))
    for interpretable in (False, True):
        for node_range in (None, (5, 10)):
            kw = dict(num_preds=16, interpretable=interpretable, node_range=node_range)
            got, tg = PG.modify_relationship(g, np.random.default_rng(4), **kw)
            want, tw = JG.modify_relationship(g, np.random.default_rng(4), **kw)
            assert tg == tw
            _equal_graphs(got, want)
    # the input graph is left as it was
    _equal_graphs(g, _graph(3, n_scenes=3, objs=5, triples=8))
    assert PG.CHANGED_REL == JG.CHANGED_REL and PG.INTERPRETABLE_RELS == JG.INTERPRETABLE_RELS


@pytest.mark.parametrize("mode", [None, "addition", "relationship", "none"])
def test_random_manipulations_draw_as_jax(mode):
    g = _graph(5, n_scenes=4, objs=6, triples=9)
    seen = set()
    for seed in range(6):
        for interpretable in (None, True, False):
            pi, ji = [], []
            kw = dict(max_objs=6, n_scenes=4, mode=mode, interpretable=interpretable)
            got = PG.random_manipulation_batched(g, np.random.default_rng(seed), infos=pi, **kw)
            want = JG.random_manipulation_batched(g, np.random.default_rng(seed), infos=ji, **kw)
            _equal_graphs(got, want)
            assert pi == ji
            seen |= {i["type"] for i in pi}
        # one scene of a batched graph, and a single-scene graph
        info_p, info_j = {}, {}
        kw = dict(num_preds=16, max_objs=6, mode=mode, scene=(6, 12))
        _equal_graphs(PG.random_manipulation(g, np.random.default_rng(seed), info=info_p, **kw),
                      JG.random_manipulation(g, np.random.default_rng(seed), info=info_j, **kw))
        assert info_p == info_j
        _equal_graphs(PG.random_manipulation(g, np.random.default_rng(seed), mode=mode),
                      JG.random_manipulation(g, np.random.default_rng(seed), mode=mode))
    if mode is None:   # training draws every type
        assert seen == {"addition", "relationship", "none"}
    else:
        assert mode in seen


# -------------------------------------------------------------- dataset
def test_scale_and_rescale_box_as_jax():
    rng = np.random.default_rng(0)
    boxes = np.stack([rng.uniform(-50, 50, 6), rng.uniform(-50, 50, 6), rng.uniform(-4, 2, 6),
                      rng.uniform(0, 6, 6), rng.uniform(0, 3, 6), rng.uniform(0, 3, 6),
                      rng.uniform(-3, 3, 6)], 1).astype(np.float32)
    boxes[0, 3] = 0.0     # a zero size: clamped before the log
    scaled = PN.scale_box(boxes)
    np.testing.assert_array_equal(scaled, JN.scale_box(boxes))
    np.testing.assert_array_equal(PN.rescale_box(scaled), JN.rescale_box(scaled))
    np.testing.assert_allclose(PN.rescale_box(scaled)[1:, :3], boxes[:, :3], atol=1e-4)
    assert PN.BOX_RANGE == JN.BOX_RANGE and (scaled[0] == -1).all()


NAMES = ["car", "pedestrian", "truck", "barrier", "bus"]


def _write_infos(root, n=5, clip_for=(0, 2)):
    """A tiny infos pickle (train and val) of n scene graphs, and CLIP
    feature pickles for the scenes ``clip_for`` of each split."""
    rng = np.random.default_rng(11)
    infos = []
    for i in range(n):
        k = 2 + i * 4                      # scene 4 has 18 objects: past the 16 slots
        boxes = np.stack([rng.uniform(-40, 40, k), rng.uniform(-40, 40, k),
                          rng.uniform(-3, 1, k), rng.uniform(1, 6, k), rng.uniform(1, 3, k),
                          rng.uniform(1, 3, k), rng.uniform(-3, 3, k)], 1).astype(np.float32)
        n_rel = 3 + 5 * i                  # scene 4 has 23, some reaching past slot 16
        rel = [[int(a), int(p), int(b)] for a, p, b in
               zip(rng.integers(0, k + 1, n_rel), rng.integers(0, 16, n_rel),
                   rng.integers(0, k + 1, n_rel))]
        infos.append({"scene_graph": {"keep_box": boxes, "keep_box_relationships": rel,
                                      "keep_box_names": [NAMES[j] for j in
                                                         rng.integers(0, len(NAMES), k)]}})
    for split in ("train", "val"):
        with open(os.path.join(root, f"nuscenes_infos_{split}.pkl"), "wb") as f:
            pickle.dump(infos, f)
        for i in clip_for:
            fid = str(i).zfill(7)
            d = os.path.join(root, split, "CLIP", fid)
            os.makedirs(d, exist_ok=True)
            sg = infos[i]["scene_graph"]
            feats = {"clip_obj_feats": rng.standard_normal((len(sg["keep_box"]) + 1, 512)),
                     "clip_rel_feats": rng.standard_normal((len(sg["keep_box_relationships"]),
                                                            512))}
            with open(os.path.join(d, f"CLIP_{fid}.pkl"), "wb") as f:
                pickle.dump(feats, f)
    return infos


@pytest.mark.parametrize("split,with_changes,eval_type",
                         [("train", True, None), ("train", False, None),
                          ("val", False, "relationship"), ("val", False, "addition")])
def test_nuscenes_layout_dataset_scene_and_collate_as_jax(tmp_path, split, with_changes,
                                                          eval_type):
    root = str(tmp_path)
    _write_infos(root)
    kw = dict(with_changes=with_changes, eval_type=eval_type, seed=3, cache_features=True)
    got, want = PN.NuScenesLayoutDataset(root, split, **kw), JN.NuScenesLayoutDataset(root, split,
                                                                                      **kw)
    assert len(got) == len(want) == 5 and got.obj_vocab == want.obj_vocab
    for i in range(len(got)):
        a, b = got.scene(i), want.scene(i)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"scene {i} {k}")
    assert np.abs(got.scene(0)["text_feat"]).max() > 0 and not got.scene(1)["text_feat"].any()
    for indices in ([0, 1], [4, 2, 3], [1, 1, 4, 0]):
        _equal_graphs(got.collate(indices), want.collate(indices))
    g = got.collate([4, 0])
    assert g["obj_mask"][:16].all() and g["dec_boxes"].shape == (32, 7)
    manipulated = (g["enc_to_dec"] < 0).any() or g["changed_mask"].any()
    assert not manipulated or with_changes or eval_type
    assert got.with_changes == (with_changes and split == "train")


def test_clip_cache_is_gated_by_available_memory(tmp_path, monkeypatch):
    root = str(tmp_path)
    _write_infos(root)
    meminfo = tmp_path / "meminfo"
    info_old = tmp_path / "meminfo_old"     # an old kernel: no MemAvailable
    info_old.write_text("MemTotal: 8000000 kB\nMemFree:  1000000 kB\nBuffers:  500000 kB\n"
                        "Cached:   2000000 kB\n")
    assert PM.meminfo(str(info_old)) == JM.meminfo(str(info_old))
    assert PM.available_gb(str(info_old)) == JM.available_gb(str(info_old)) == pytest.approx(
        3.5e6 / 2 ** 20)
    assert PM.available_gb(str(tmp_path / "missing")) == JM.available_gb(
        str(tmp_path / "missing")) == 0.0
    for mem in (PM, JM):   # the datasets read the host's memory through available_gb()
        monkeypatch.setattr(mem, "available_gb",
                            lambda real=mem.available_gb: real(str(meminfo)))
    for avail_kb, cached in ((1_000_000, False), (10_000_000, True)):
        meminfo.write_text(f"MemTotal: 16000000 kB\nMemAvailable: {avail_kb} kB\n")
        caches = []
        for ds_mod in (PN, JN):
            ds = ds_mod.NuScenesLayoutDataset(root, "train", with_changes=False)
            for i in range(3):
                ds.scene(i)
            caches.append(sorted(ds._feat_cache))
        assert caches[0] == caches[1] == (["0000000", "0000002"] if cached else [])


# ------------------------------------------------------ synthetic traffic
@pytest.mark.parametrize("with_changes", [False, True])
def test_traffic_graphs_and_relation_metrics_as_jax(with_changes):
    kw = dict(n_scenes=5, max_objs_per_scene=8, max_triples_per_scene=12,
              with_changes=with_changes)
    got = PS.traffic_graph_batch(np.random.default_rng(2), **kw)
    want = JS.traffic_graph_batch(np.random.default_rng(2), **kw)
    _equal_graphs(got, want)
    assert (got["enc_to_dec"] < 0).any() == with_changes
    boxes = PS.denormalize_boxes7(got["dec_boxes"])
    np.testing.assert_array_equal(boxes, JS.denormalize_boxes7(got["dec_boxes"]))
    np.testing.assert_array_equal(PS.normalize_boxes7(boxes), JS.normalize_boxes7(boxes))
    noisy = boxes + np.random.default_rng(3).normal(0, 8, boxes.shape).astype(np.float32)
    for b in (boxes, noisy):
        assert PS.relation_satisfaction(b, got) == JS.relation_satisfaction(b, got)
        assert (PS.added_relation_satisfaction(b, got)
                == JS.added_relation_satisfaction(b, got))
    assert PS.relation_satisfaction(boxes, got) == 1.0       # true relations hold
    assert PS.relation_satisfaction(noisy, got) < 1.0


# -------------------------------------------------------------- factory
def test_factory_nusc_layout_graph_as_jax(tmp_path, capsys):
    target = "lidm.data.nuscenes_layout_dataset.nuScenesLayoutTrain"
    dset = {"size": [64, 1024], "fov": [3, -25]}
    # no root: the synthetic fallback, and its line
    got = PF.build_batches(target, {"root": None}, dset, None, 3, seed=5)
    want = jax_factory.build_batches(target, {"root": None}, dset, None, 3, seed=5)
    for _ in range(2):
        _equal_graphs(next(got), next(want))
    out = capsys.readouterr().out.splitlines()
    assert out == ["[data] nusc_layout_graph: no infos pkl under None — synthetic fallback"] * 2
    # a root: the dataset, every scene manipulated (JAX's default)
    root = str(tmp_path)
    _write_infos(root)
    got = PF.build_batches(target, {}, dset, root, 4, seed=6)
    want = jax_factory.build_batches(target, {}, dset, root, 4, seed=6)
    for _ in range(2):
        _equal_graphs(next(got), next(want))
    # the YAML's with_changes: false reaches the port's dataset; the JAX
    # factory drops it (its dataset's default manipulates every scene)
    got = next(PF.build_batches(target, {"with_changes": False}, dset, root, 4, seed=6))
    want = next(jax_factory.build_batches(target, {"with_changes": False}, dset, root, 4, seed=6))
    idx = np.random.default_rng(6).integers(0, 5, 4)
    plain = JN.NuScenesLayoutDataset(root, "train", with_changes=False).collate(
        [int(i) for i in idx])
    _equal_graphs(got, plain)
    assert not np.array_equal(want["enc_to_dec"], plain["enc_to_dec"]) or not np.array_equal(
        want["enc_triples"], plain["enc_triples"])
    assert (got["enc_to_dec"] >= 0).all() and not got["changed_mask"].any()
    assert capsys.readouterr().out == ""


def test_factory_other_targets():
    from lidar_layout_tpu_torch.data.synthetic import (synthetic_layout_range_batch,
                                                       synthetic_range_batch)
    from lidar_layout_tpu_torch.ops.lidar import LidarGeometry

    dset = {"size": [32, 1024], "fov": [10, -30]}
    got = next(PF.build_batches("lidm.data.nusc_dataset.nuScenesLayoutTrain", {}, dset, None, 1,
                                seed=2, force_synthetic=True))
    want = synthetic_layout_range_batch(np.random.default_rng(2), 1,
                                        LidarGeometry(size=(32, 1024), fov=(10, -30)))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert PF.ALIASES == jax_factory.ALIASES
    got = next(PF.build_batches("nusc_object", {"num_samples": 8}, {}, None, 1, seed=2))
    want = next(jax_factory.build_batches("nusc_object", {"num_samples": 8}, {}, None, 1, seed=2))
    assert all(np.array_equal(got[k].numpy(), want[k]) for k in want)
    # the KITTI targets are ported: without a root, JAX's synthetic fallback
    got = next(PF.build_batches("lidm.data.kitti.SemanticKITTITrain", {}, dset, None, 1, seed=2))
    want = synthetic_range_batch(np.random.default_rng(2), 1,
                                 LidarGeometry(size=(32, 1024), fov=(10, -30)))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(KeyError, match="unknown"):
        next(PF.build_batches("nope", {}, {}, None, 1))


# ------------------------------------------------------------ the U-Net1D
@pytest.mark.parametrize("key", ["concat", "hybrid"])
def test_unet1d_concat_and_hybrid_match_jax(key):
    jmodel = JaxLD(JaxLDC(), JaxU1C(**STEP_UNET, conditioning_key=key), sg_embedding_dim=SG_DIM)
    graph = _graph(1)
    jg = {k: jnp.asarray(v) for k, v in graph.items()}
    params = random_flax_params(jmodel.init, 30, jax.random.key(0), jg)
    port = LayoutDiffusion(LayoutDiffusionConfig(), UNet1DConfig(**STEP_UNET, conditioning_key=key),
                           sg_embedding_dim=SG_DIM).eval()
    port.load_state_dict(layout_diffusion_state_dict(jax.tree.map(np.asarray, params)))
    latent, obj = jax.jit(jmodel.encode_graph)(params, jg, jax.random.key(1))
    rng = np.random.default_rng(8)
    box_t = rng.standard_normal((8, 8)).astype(np.float32)
    t = rng.integers(0, 1000, 8)
    want = np.asarray(jax.jit(jmodel.apply_model)(params, jnp.asarray(box_t), jnp.asarray(t),
                                                  obj, jg["dec_triples"], latent,
                                                  jg["dec_pred_mask"]))
    g = graph_tensors(graph, "cpu")
    args = [torch.from_numpy(box_t), torch.from_numpy(t), torch.from_numpy(np.array(obj)),
            g["dec_triples"], torch.from_numpy(np.array(latent)), g["dec_pred_mask"]]
    with torch.no_grad():
        got = port.apply_model(*args).numpy()
        args[4] = args[4].flip(0)           # "concat" attends to the latent, "hybrid" does not
        other = port.apply_model(*args).numpy()
    assert port.unet.conv_in.in_channels == 8 + UNET["concat_dim"]
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=UNET_TOL * max(1.0, np.abs(want).max()),
                               rtol=UNET_TOL)
    assert (np.abs(other - got).max() > 1e-4) == (key == "concat")
    with pytest.raises(ValueError, match="conditioning_key"):
        LayoutDiffusion(LayoutDiffusionConfig(), UNet1DConfig(**UNET, conditioning_key="adm"))


# ------------------------------------------------- attention at S = 1
def test_attention_at_one_key_gives_jax_zero_q_and_k_gradients():
    """With one key the softmax is exactly 1 and JAX's vjp gives dq = dk = 0
    exactly: (g - g * 1) * 1. The port's plain backward (what K2 is held to)
    gives the same zeros, so AdamW moves to_q and to_k by weight decay
    alone, as in JAX. At LayoutDiffusion's 8 heads of 64, K2's delta =
    rowsum(dO * O) and dP = dO v, two sums of the same products in other
    orders on the CPU, differ in the last bit: the plain version took that
    delta until it was repaired, and gave every to_q weight a gradient."""
    rng = np.random.default_rng(12)
    n, dim, cdim = 16, 64, 48
    x = rng.standard_normal((n, 1, dim)).astype(np.float32)
    ctx = rng.standard_normal((n, 1, cdim)).astype(np.float32)
    gout = rng.standard_normal((n, 1, dim)).astype(np.float32)
    for context in (None, ctx):        # attn1 (self) and attn2 (cross) of the blocks
        jattn = JA.CrossAttention(heads=8, dim_head=64)
        cj = None if context is None else jnp.asarray(context)
        p = random_flax_params(jattn.init, 13, jax.random.key(2), jnp.asarray(x), cj)
        jgrad = jax.grad(lambda p_: jnp.sum(jattn.apply(p_, jnp.asarray(x), cj)
                                            * jnp.asarray(gout)))(p)["params"]
        attn = PA.CrossAttention(dim, None if context is None else cdim, heads=8, dim_head=64)
        sd = layout_diffusion_state_dict({"unet": {"params": jax.tree.map(np.asarray, p)["params"]},
                                          "cond_stage": {}})
        attn.load_state_dict({k[len("unet."):]: v for k, v in sd.items()})
        ct = None if context is None else torch.from_numpy(context)
        (attn(torch.from_numpy(x), ct) * torch.from_numpy(gout)).sum().backward()
        for name in ("to_q", "to_k"):
            assert not np.asarray(jgrad[name]["kernel"]).any(), f"JAX {name}"
            assert not attn.get_submodule(name).weight.grad.any(), f"port {name}"
        for name in ("to_v", "to_out"):
            want = np.asarray(jgrad[name]["kernel"]).T
            got = attn.get_submodule(name).weight.grad.numpy()
            assert np.abs(want).max() > 0.1
            np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=1e-5)
    # the plain backward on its own at (256, 8, 1, 64): dq and dk exactly 0,
    # dv = dO; K2's two sums differ here
    q, k, v, do = (torch.from_numpy(rng.standard_normal((256, 8, 1, 64)).astype(np.float32))
                   for _ in range(4))
    o, lse = A._attend_ref(q, k, v), A._lse_ref(q, k)
    dq, dk, dv = A._attend_bwd_ref(q, k, v, o, do, lse)
    assert not dq.any() and not dk.any() and torch.equal(dv, do)
    delta_from_o = (do * o).sum(-1, keepdim=True)
    assert (torch.matmul(do, v.transpose(-1, -2)) != delta_from_o).any()


# ------------------------------------------------------ one training step
@pytest.fixture(scope="module")
def step_pair():
    """The JAX model and its tree (seeded values), and the port model with
    the same weights."""
    jmodel = JaxLD(JaxLDC(), JaxU1C(**STEP_UNET), sg_embedding_dim=SG_DIM)
    graph = _graph(2, with_changes=True)
    jg = {k: jnp.asarray(v) for k, v in graph.items()}
    params = random_flax_params(jmodel.init, 31, jax.random.key(0), jg)
    port = LayoutDiffusion(LayoutDiffusionConfig(), UNet1DConfig(**STEP_UNET),
                           sg_embedding_dim=SG_DIM)
    port.load_state_dict(layout_diffusion_state_dict(jax.tree.map(np.asarray, params)))
    return jmodel, params, port


def test_one_training_step_matches_jax(step_pair):
    jmodel, params, port = step_pair
    graph = _graph(6, with_changes=True)        # changed nodes, and padding slots 3 and 7
    graph["enc_to_dec"][1] = -1                 # an added node too
    assert graph["changed_mask"].any() and not graph["obj_mask"].all()
    key = jax.random.key(9)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR))
    state0 = jax.jit(lambda p: _simple_state(p, tx))(params)

    @jax.jit
    def jstep(state, g, k):   # the CLI's step; n_scenes static, as there
        (loss, _), grads = jax.value_and_grad(jmodel.p_losses, has_aux=True)(
            state.params, k, {**g, "n_scenes": 2})
        return _simple_update(state, grads, tx), loss, grads, optax.global_norm(grads)

    jg = {k: jnp.asarray(v) for k, v in graph.items() if k != "n_scenes"}
    state1, want_loss, jgrads, jnorm = jstep(state0, jg, key)
    # JAX's draws: p_losses splits its key in three (conditioning, t, noise);
    # the encoder's change noise comes from make_rng("change") under the first
    r_cond, r_t, r_noise = jax.random.split(key, 3)
    change_key = jmodel.cond_stage.apply(params["cond_stage"], rngs={"change": r_cond},
                                         method=lambda m: m.make_rng("change"))
    change = np.array(jax.random.normal(change_key, (8, SG_DIM)))
    t_scene = np.array(jax.random.randint(r_t, (2,), 0, 1000))
    noise = np.array(jax.random.normal(r_noise, (8, 8)))

    state = LT.create_layout_train_state(port, LR)
    assert set(state.params) == set(dict(port.named_parameters()))
    grads = {}
    opt_step = state.optimizer.step

    def spy():
        grads.update({k: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                      for k, p in state.params.items()})
        return opt_step()
    state.optimizer.step = spy
    ema0 = {k: v.clone() for k, v in state.ema.params.items()}
    state, logs = LT.make_layout_train_step(port)(
        state, graph, None, t_scene=torch.from_numpy(t_scene), noise=torch.from_numpy(noise),
        change_noise=torch.from_numpy(change))
    np.testing.assert_allclose(float(logs["loss"]), float(want_loss), rtol=LOSS_TOL)

    want_g = layout_diffusion_state_dict(jax.tree.map(np.asarray, jgrads))
    assert sorted(want_g) == sorted(grads)
    for part in ("unet.", "cond_stage."):
        keys = [k for k in grads if k.startswith(part)]
        num = sum(float((grads[k] - want_g[k]).square().sum()) for k in keys)
        den = sum(float(want_g[k].square().sum()) for k in keys)
        assert den > 0 and (num / den) ** 0.5 <= GRAD_TOL, part
    # one key: to_q and to_k get exactly no gradient, in both
    qk = [k for k in grads if k.endswith(("to_q.weight", "to_k.weight"))]
    assert len(qk) == 4 * sum(isinstance(m, PA.BasicTransformerBlock)
                              for m in port.modules()) == 16 and not any(grads[k].any() or want_g[k].any() for k in qk)

    want_p, want_ema = layout_train_state_dicts(jax.tree.map(np.asarray, state1))
    upd = torch.cat([(state.params[k].detach() - want_p[k]).abs().flatten() for k in want_p])
    moved = torch.cat([(state.params[k].detach() - ema0[k]).abs().flatten() for k in want_p])
    # Adam's first update is about lr * sign(g): where a gradient is within
    # rounding of 0 the two may step in opposite directions (up to 2 lr)
    assert float(upd.max()) <= 2 * LR and float((upd > 0.01 * LR).float().mean()) <= 1e-3
    assert float(moved.mean()) > 0.1 * LR
    eerr = max(float((state.ema.params[k] - want_ema[k]).abs().max()) for k in want_ema)
    assert eerr <= 2 * LR
    # the EMA's decay at step 0 is 0.1, as _simple_update takes it
    assert LT.ema_decay(0) == pytest.approx(0.1) and state.step == 1
    for k in list(want_p)[:5]:
        torch.testing.assert_close(state.ema.params[k],
                                   0.1 * ema0[k] + 0.9 * state.params[k].detach(),
                                   rtol=1e-6, atol=1e-7)
    assert float(logs["grad_norm"]) == pytest.approx(float(jnorm), rel=1e-4)


def test_training_step_keeps_dropout_off_as_jax(step_pair):
    """JAX's apply_model never passes deterministic=False: a U-Net1D with
    dropout trains as one without."""
    _, _, port = step_pair
    graph = _graph(6)
    draws = dict(t_scene=torch.tensor([3, 500]), noise=torch.randn(8, 8,
                                                                  generator=torch.Generator()
                                                                  .manual_seed(1)))
    losses = []
    for p in (0.0, 0.5):
        model = LayoutDiffusion(LayoutDiffusionConfig(), UNet1DConfig(**STEP_UNET, dropout=p),
                                sg_embedding_dim=SG_DIM)
        model.load_state_dict(port.state_dict())
        model.train()
        _, logs = LT.make_layout_train_step(model)(LT.create_layout_train_state(model, LR),
                                                   graph, None, **draws)
        losses.append(float(logs["loss"]))
    assert losses[0] == losses[1]


# ------------------------------------------------------------------ CLI
def test_train_layout_cli_then_sample_layout_from_its_run(tmp_path):
    import yaml

    from lidar_layout_tpu_torch import sample_layout as SL
    from lidar_layout_tpu_torch.config import load_yaml
    from lidar_layout_tpu_torch.train import checkpoint as CK
    from lidar_layout_tpu_torch.train.train_layout import LAYOUT_DIFFUSION_YAML, main

    cfg = load_yaml(LAYOUT_DIFFUSION_YAML)
    cfg["model"]["params"]["unet_config"]["params"].update(
        model_channels=64, concat_dim=96, crossattn_dim=96)
    cfg["model"]["params"]["cond_stage_config"]["params"]["embedding_dim"] = SG_DIM
    base = tmp_path / "tiny.yaml"
    base.write_text(yaml.safe_dump(cfg))
    work = tmp_path / "run"
    trainer = main(["-b", str(base), "--cpu", "--synthetic", "--steps", "2", "--workdir",
                    str(work), "-s", "3", "data.params.batch_size=2",
                    "model.base_learning_rate=5e-4"])
    assert trainer.global_step == 2 and CK.latest_step(str(work / "ckpt")) == 2
    saved = load_yaml(str(work / "config.yaml"))
    assert saved["model"]["params"]["vocab"] == {"num_objs": 32, "num_preds": 16}
    ckpt = torch.load(CK.checkpoint_path(str(work / "ckpt"), 2), weights_only=True)
    assert sorted(ckpt["ema"]["params"]) == sorted(k for k in ckpt["model"]
                                                    if k.startswith(("unet.", "cond_stage.")))
    assert ckpt["ema"]["step"] == 2
    # sample_layout -r <run dir> samples with the EMA weights
    out = SL.main(["-r", str(work), "--cpu", "-n", "2", "--steps", "2", "-s", "4", "--outdir",
                   str(tmp_path / "s")])
    model = SL.build_model(str(work / "config.yaml"), "cpu", 4)
    sd = dict(ckpt["model"])
    sd.update(ckpt["ema"]["params"])
    model.load_state_dict(sd)
    graph = PS.synthetic_graph_batch(np.random.default_rng(4), n_scenes=2,
                                     max_objs_per_scene=SL.MAX_OBJS,
                                     max_triples_per_scene=SL.MAX_TRIPLES)
    np.testing.assert_array_equal(out["boxes"], SL.sample_layouts(model, graph, 2, 4)["boxes"])
    model.load_state_dict(ckpt["model"])      # the trained weights give other boxes
    assert np.abs(SL.sample_layouts(model, graph, 2, 4)["boxes"] - out["boxes"]).max() > 1e-6
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.cuda, "is_available", lambda: False)
            main(["-b", str(base), "--synthetic", "--steps", "1", "--workdir",
                  str(tmp_path / "x")])
