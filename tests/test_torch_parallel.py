"""PyTorch port vs the JAX package: ``parallel/`` on torch.distributed.

Ranks are processes (``parallel.dryrun.spawn``) over gloo, meeting at a
``file://`` store in a temporary directory, on one intra-op thread each;
their bodies are ``tests/torch_parallel_ranks.py``. JAX runs on its 8-device
CPU mesh (``tests/conftest.py``) with the batch placed by ``shard_batch``,
as its own multi-chip dry run does. Held: the collectives against
``shard_map``; the tiny flagship's 2-rank gradients against
``jax.value_and_grad`` on the global batch; ``scale_by_std`` over the
global first batch; the scene-sharded LayoutDiffusion loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from __graft_entry__ import _flagship as jax_flagship
from lidar_layout_tpu.data.layout_synthetic import synthetic_graph_batch as jax_graph_batch
from lidar_layout_tpu.models import schedules as JSCH
from lidar_layout_tpu.models.diffusion import calibrate_scale_factor as jax_calibrate
from lidar_layout_tpu.models.layout_diffusion import LayoutDiffusion as JaxLD
from lidar_layout_tpu.models.layout_diffusion import LayoutDiffusionConfig as JaxLDC
from lidar_layout_tpu.models.unet1d import UNet1DConfig as JaxU1C
from lidar_layout_tpu.parallel.mesh import make_mesh as jax_make_mesh
from lidar_layout_tpu.parallel.mesh import shard_batch as jax_shard_batch
from lidar_layout_tpu.utils.torch_convert import convert_unet
from lidar_layout_tpu_torch.parallel import dryrun as D
from lidar_layout_tpu_torch.parallel import mesh as M
from lidar_layout_tpu_torch.utils.convert import layout_diffusion_state_dict
from torch_parallel_ranks import tiny_flagship
from torch_port_helpers import jax_ldm_params, random_flax_params

import torch_parallel_ranks as R


# the checks' inputs, made from seeds
XS = [np.random.default_rng(i).standard_normal((3, 4)).astype(np.float32) for i in range(2)]
GRADS = [[rng.standard_normal(shape).astype(dt) if shape else None
          for shape, dt in (((5, 3), np.float32), ((), None), ((40,), np.float32),
                            ((7,), np.float64), ((2, 2), np.float32))]
         for rng in map(np.random.default_rng, (10, 11))]
FLAGSHIP_SEED, GEN_SEED = 31, 5
X0 = np.random.default_rng(32).standard_normal((4, 4, 16, 8)).astype(np.float32)
STD_SEED = 34
STD_IMAGES = np.random.default_rng(35).uniform(-1, 1, (4, 16, 128, 1)).astype(np.float32)
N_SCENES = 4


@pytest.fixture(scope="module")
def jax_layout():
    """The dry run's LayoutDiffusion in JAX (``dryrun.layout_model``), random
    weights, a graph of 4 scenes, and JAX's draws for its loss."""
    g_np = jax_graph_batch(np.random.default_rng(42), n_scenes=N_SCENES, num_obj_classes=16,
                           num_pred_classes=8, clip_dim=8)
    graph = {k: v for k, v in g_np.items() if k != "n_scenes"}
    jmodel = JaxLD(JaxLDC(timesteps=64), JaxU1C(
        model_channels=32, num_res_blocks=1, channel_mult=(1, 1), attention_resolutions=(1,),
        num_heads=2, concat_dim=64, crossattn_dim=64, gconv_dim=16),
        num_objs=16, num_preds=8, sg_embedding_dim=16, use_clip=False)
    jg = {k: jnp.asarray(v) for k, v in graph.items()}
    params = random_flax_params(jmodel.init, 0, jax.random.key(0), {**jg, "n_scenes": N_SCENES})
    key = jax.random.key(3)
    _, r_t, r_noise = jax.random.split(key, 3)
    draws = (np.asarray(jax.random.randint(r_t, (N_SCENES,), 0, 64)),
             np.asarray(jax.random.normal(r_noise, (len(graph["dec_boxes"]), 8))),
             np.zeros((len(graph["dec_boxes"]), 16), np.float32))   # no node is touched
    assert not g_np["changed_mask"].any() and (g_np["enc_to_dec"] >= 0).all()
    return jmodel, params, key, g_np, jg, draws


@pytest.fixture(scope="module")
def two_ranks(jax_layout):
    """Every 2-rank check of this file in one spawn: {job: [rank 0's, rank 1's]}."""
    _, params, _, g_np, _, draws = jax_layout
    sd = layout_diffusion_state_dict(jax.tree.map(np.asarray, params))
    todo = [(name, name, args) for name, args in (
        ("collectives", (XS, GRADS)), ("flagship_grads", (FLAGSHIP_SEED, X0, GEN_SEED, 1e-4)),
        ("scale_by_std", (STD_SEED, STD_IMAGES)), ("layout_loss", (sd, g_np, *draws)))]
    ranks = D.spawn(R.jobs, 2, (todo,))
    return {key: [r[key] for r in ranks] for key, _, _ in todo}


def _mesh2():
    return jax_make_mesh(jax.devices()[:2])


# ------------------------------------------------------------ collectives
def test_collectives_match_jax_shard_map(two_ranks):
    xs, grads, got = XS, GRADS, two_ranks["collectives"]
    mesh = _mesh2()

    def body(x):   # one device's (1, 3, 4) block
        x = x[0]
        a, b = x.sum(), x.max()
        return (jax.lax.pmean(a, "dp")[None], jax.lax.psum(a, "dp")[None],
                jax.lax.pmean(b, "dp")[None], jax.lax.psum(b, "dp")[None],
                jax.lax.all_gather(x, "dp")[None])

    out = jax.shard_map(body, mesh=mesh, in_specs=P("dp"), out_specs=P("dp"))(
        jnp.asarray(np.stack(xs)))
    a_mean, a_sum, b_mean, b_sum, gathered = (np.asarray(o)[0] for o in out)
    for r in got:   # every rank holds the reduced values
        assert r["world"] == 2
        np.testing.assert_allclose([r["mean"]["a"], r["sum"]["a"]], [a_mean, a_sum], rtol=1e-6)
        np.testing.assert_allclose([r["mean"]["b"], r["sum"]["b"]], [b_mean, b_sum], rtol=1e-6)
        assert r["mean"]["c"] == 2.0 and r["sum"]["c"] == 4.0
        np.testing.assert_array_equal(r["gather"], gathered)
        np.testing.assert_array_equal(r["host"], np.stack(xs) * 3)
        # the gradients' mean, bucket by bucket: (a + b) / 2 exactly
        for g, a, b in zip(r["grads"], *grads):
            assert (g is None) == (a is None)
            if g is not None:
                np.testing.assert_array_equal(g, (a + b) / 2)


# -------------------------------------------------- the flagship under dp
def test_flagship_two_rank_gradients_match_jax_on_the_global_batch(two_ranks):
    """Global batch 4, 2 a rank: the ranks' t and noise are the one-process
    draws at batch 4, the all-reduced U-Net gradients and the loss are
    JAX's ``value_and_grad`` on the sharded global batch (the tolerances of
    test_torch_train's single-process comparison), and after one AdamW
    step the replicas are bit-equal."""
    seed, gen_seed, x0 = FLAGSHIP_SEED, GEN_SEED, X0
    ranks = two_ranks["flagship_grads"]
    port = tiny_flagship(seed)
    t1, n1 = port.draw_t_noise(torch.from_numpy(x0), torch.Generator().manual_seed(gen_seed))
    t = np.concatenate([r["t"] for r in ranks])
    noise = np.concatenate([r["noise"] for r in ranks])
    np.testing.assert_array_equal(t, t1.numpy())
    np.testing.assert_array_equal(noise, n1.numpy())
    assert all(r["replicas_equal"] for r in ranks)
    assert ranks[0]["loss"] == ranks[1]["loss"] and ranks[0]["norm"] == ranks[1]["norm"]

    jmodel, _ = jax_flagship(tiny=True)
    params = jax_ldm_params(port)
    x_noisy = np.asarray(JSCH.q_sample(jmodel.schedule, x0, jnp.asarray(t), noise))
    batch = jax_shard_batch({"x": jnp.asarray(x_noisy), "t": jnp.asarray(t),
                             "noise": jnp.asarray(noise)}, _mesh2())

    def mse(unet_params, b):
        out = jmodel.apply_model({**params, "unet": unet_params}, b["x"], b["t"])
        return jnp.mean((out - b["noise"]) ** 2)

    want_loss, want_grads = jax.jit(jax.value_and_grad(mse))(params["unet"], batch)
    np.testing.assert_allclose(ranks[0]["loss"], float(want_loss), rtol=1e-5)
    cfg = port.unet.cfg
    prefix = "model.diffusion_model."
    got = convert_unet({k[len(prefix):]: v for k, v in ranks[0]["grads"].items()},
                       cfg.num_res_blocks, cfg.channel_mult, cfg.num_head_channels, prefix="")
    flat_w = jax.tree_util.tree_leaves_with_path(want_grads)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_w) == len(flat_g) > 20
    gmax = max(float(np.abs(np.asarray(w)).max()) for _, w in flat_w)
    for path, w in flat_w:
        np.testing.assert_allclose(flat_g[path], np.asarray(w), atol=1e-5 * gmax, rtol=1e-3,
                                   err_msg=jax.tree_util.keystr(path))


def test_scale_by_std_over_the_global_first_batch_matches_jax(two_ranks):
    seed, images, ranks = STD_SEED, STD_IMAGES, two_ranks["scale_by_std"]
    z = tiny_flagship(seed).encode_first_stage(torch.from_numpy(images))
    want = float(jax_calibrate(jnp.asarray(z.detach().numpy())))
    for r in ranks:
        assert r["factor"] == pytest.approx(want, rel=1e-6)
    # a rank's own std would give each rank its own factor
    assert all(abs(r["local"] - want) > 1e-4 * want for r in ranks)


# ---------------------------------------------- LayoutDiffusion by scenes
def test_scene_sharded_layout_loss_matches_jax_sharded_loss(jax_layout, two_ranks):
    jmodel, params, key, _, jg, _ = jax_layout
    seg = NamedSharding(_mesh2(), P("dp"))
    want = float(jax.jit(lambda p, k, g: jmodel.p_losses(p, k, {**g, "n_scenes": N_SCENES})[0])(
        params, key, {k: jax.device_put(v, seg) for k, v in jg.items()}))
    ranks = two_ranks["layout_loss"]
    assert [r["n_scenes"] for r in ranks] == [2, 2]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], want, rtol=2e-4)


def test_shard_scene_graph_rebases_indices_to_the_rank_scenes(monkeypatch):
    g = jax_graph_batch(np.random.default_rng(1), n_scenes=4, num_obj_classes=16,
                        num_pred_classes=8, clip_dim=8)
    monkeypatch.setattr(M, "get_world_size", lambda: 2)
    monkeypatch.setattr(M, "get_rank", lambda: 1)
    mine = M.shard_scene_graph(g)
    assert mine["n_scenes"] == 2 and len(mine["dec_objs"]) == len(g["dec_objs"]) // 2
    np.testing.assert_array_equal(mine["dec_objs_to_scene"], g["dec_objs_to_scene"][16:] - 2)
    live = mine["dec_pred_mask"]
    np.testing.assert_array_equal(mine["dec_triples"][live][:, [0, 2]],
                                  g["dec_triples"][24:][live][:, [0, 2]] - 16)
    assert (mine["dec_triples"][live][:, [0, 2]] < 16).all()


# ------------------------------------------------------- a rank's data rows
@pytest.mark.parametrize("source", ["synthetic", "native", "python"])
def test_range_dataset_reads_only_a_rank_rows(source, tmp_path):
    """RangeImageDataset with ``rows`` (a rank's share of the global batch)
    gives those rows of the whole batch's, across a reshuffle: the same
    order and draws, only these rows read and projected."""
    from lidar_layout_tpu_torch.data.datasets import RangeImageDataset
    from lidar_layout_tpu_torch.ops.lidar import LidarGeometry

    root = None
    if source != "synthetic":
        drive = tmp_path / "data_3d_raw" / "2013_05_28_drive_0000_sync" / "velodyne_points" / "data"
        drive.mkdir(parents=True)
        rng = np.random.default_rng(6)
        for i in range(8):
            pts = np.concatenate([rng.uniform(-30, 30, (700, 2)), rng.uniform(-2, 1, (700, 1)),
                                  rng.uniform(0, 1, (700, 1))], 1).astype(np.float32)
            pts.tofile(drive / f"{i:010d}.bin")
        root = str(tmp_path)
    geom = LidarGeometry(size=(16, 64), fov=(3, -25))
    kw = dict(batch_size=4, geom=geom, seed=7, max_points=1000)
    whole = RangeImageDataset(root, **kw).batches(use_native=source == "native")
    mine = RangeImageDataset(root, rows=slice(2, 4), **kw).batches(use_native=source == "native")
    for _ in range(3):
        w, m = next(whole), next(mine)
        assert set(w) == set(m)
        for k in w:
            assert m[k].shape[0] == 2 and torch.equal(m[k], w[k][2:4]), k
