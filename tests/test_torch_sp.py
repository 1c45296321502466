"""PyTorch port vs the JAX package: the spatial (``sp``) axis of parallel/.

The range image's azimuth (W) sharded over ranks, as JAX's
``mesh.spatial_sharding`` shards it for GSPMD; the port writes by hand what
GSPMD writes for JAX. Held in one process: each circular conv of the
tables in ``nn/blocks.py`` and the U-Net's stride-2 ``Downsample``, fed a
shard with its halo columns, against the unsharded conv's columns; K3's
split form (plain versions) merged over 2 and 4 shards against JAX's
``_ref``; the cross-length attention of a shard's queries over the keys
gathered in shard order against JAX's ``_attend_ref`` over the whole
sequence. In 4 gloo ranks (sp = 4, one spawn; bodies in
``tests/torch_parallel_ranks.py``): the tiny flagship's W-sharded
``encode_first_stage`` and ``apply_model`` against JAX's unsharded forward
on the same weights (``torch_port_helpers.jax_ldm_params``), and the halo
ring itself. Float32 on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship as jax_flagship
from lidar_layout_tpu.models.diffusion import LatentDiffusion as JLatentDiffusion
from lidar_layout_tpu.ops.pallas_attention import _attend_ref as jax_attend_ref
from lidar_layout_tpu.ops.pallas_groupnorm import _ref as jax_group_norm_ref
from lidar_layout_tpu_torch.flagship import flagship
from lidar_layout_tpu_torch.nn import blocks as PB
from lidar_layout_tpu_torch.nn.conv import CircularConv, halo_widths
from lidar_layout_tpu_torch.ops import attention as PA
from lidar_layout_tpu_torch.ops import groupnorm as PG
from lidar_layout_tpu_torch.parallel import collectives as C
from lidar_layout_tpu_torch.parallel import dryrun as D
from lidar_layout_tpu_torch.parallel.mesh import SpatialPlan
from torch_port_helpers import jax_ldm_params, one_intra_op_thread, seed_weights

import torch_parallel_ranks as R

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
SEED, SP = 23, 4

# every W kernel, stride and pad of the AE's tables and the U-Net's Downsample.op
CONVS = ([(k, (1, 1), p) for k, p in PB.KERNEL_PAD.items()]
         + [(PB.UPSAMPLE_KERNEL[s], (1, 1), PB.UPSAMPLE_PAD[s]) for s in PB.UPSAMPLE_KERNEL]
         + [(PB.DOWNSAMPLE_KERNEL[s], s, PB.DOWNSAMPLE_PAD[s]) for s in PB.DOWNSAMPLE_KERNEL]
         + [((3, 3), (2, 2), (1, 1, 1, 1))])


def _shards(x: np.ndarray, n: int):
    return np.split(x, n, axis=-1)


@pytest.mark.parametrize("wrap", [True, False], ids=["circular", "zero"])
@pytest.mark.parametrize("kernel,stride,pad", CONVS, ids=[f"{k}s{s}p{p}" for k, s, p in CONVS])
def test_halo_conv_equals_the_unsharded_columns(kernel, stride, pad, wrap):
    """Each of 2 and 4 shards with its halo (``CircularConv.halo``: the
    left pad, and kernel - stride - left columns on the right) taken from
    its neighbours, around the ring or zeros past the edges, gives the
    unsharded conv's columns of that shard."""
    torch.manual_seed(1)
    conv = CircularConv(3, 4, kernel, stride, pad, wrap=wrap)
    x = np.random.default_rng(2).standard_normal((2, 3, 8, 64)).astype(np.float32)
    with torch.no_grad():
        want = conv(torch.from_numpy(x)).numpy()
        for n in (2, 4):
            w = 64 // n
            left, right = conv.halo(w, n)
            assert (left, right) == (pad[0], kernel[1] - stride[1] - pad[0])
            parts = []
            for r in range(n):
                cols = np.arange(r * w - left, (r + 1) * w + right)
                xh = x[..., cols % 64] * (1.0 if wrap else ((cols >= 0) & (cols < 64)))
                parts.append(conv.forward_halo(torch.from_numpy(xh.astype(np.float32))).numpy())
            np.testing.assert_allclose(np.concatenate(parts, -1), want, atol=1e-5, rtol=1e-5)


def test_halo_widths_refuse_a_stride_that_does_not_divide_the_shard():
    assert halo_widths(3, 2, 0, 1, 8, 4) == (0, 1)
    with pytest.raises(ValueError, match="stride"):
        halo_widths(3, 2, 0, 1, 7, 4)
    with pytest.raises(ValueError, match="whole width"):
        halo_widths(3, 2, 1, 2, 8, 4)   # an output wider than the width / stride


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("act", [False, True])
def test_split_group_norm_merged_over_shards_equals_jax_ref(shards, act):
    """Each shard's (mean, M2) (``_stats_ref``), merged by Chan's formula in
    shard order (``collectives.merge_shard_stats``), then each shard
    normalised from the merge (``_apply_ref``): JAX's ``_ref`` on the whole
    tensor to f32 rounding, with a large common offset; the merged
    statistics are float64's."""
    rng = np.random.default_rng(4)
    x = (50.0 + rng.standard_normal((2, 64, 4, 32))).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(64)).astype(np.float32)
    g, count = 32, 2 * 4 * 32 // shards
    parts = [torch.from_numpy(s.copy()) for s in _shards(x, shards)]
    stats = C.merge_shard_stats(torch.stack([PG._stats_ref(p, g) for p in parts]), count)
    x64 = x.astype(np.float64).reshape(2, g, -1)
    np.testing.assert_allclose(stats[..., 0].numpy(), x64.mean(-1), rtol=1e-6)
    np.testing.assert_allclose(stats[..., 1].numpy() / (count * shards), x64.var(-1), rtol=1e-4)
    got = np.concatenate([PG._apply_ref(p, stats, torch.from_numpy(gamma),
                                        torch.from_numpy(beta), g, count * shards, 1e-6,
                                        act).numpy() for p in parts], -1)
    want = np.asarray(jax_group_norm_ref(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                         jnp.asarray(gamma), jnp.asarray(beta), g, 1e-6, act))
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=2e-5, rtol=2e-5)


def test_cross_length_attention_over_gathered_keys_equals_jax_on_the_whole():
    """A (4, 16) level of 2 heads of 16 over 4 shards of its width: each
    shard's queries (its positions, row-major) against the keys and values
    of every shard gathered in shard order (a permutation of the whole
    sequence's) through ``flash_attention_xl``: JAX's ``_attend_ref`` over
    the whole sequence, row for row."""
    rng = np.random.default_rng(5)
    b, h, d, hh, ww = 2, 2, 16, 4, 16
    q, k, v = (rng.standard_normal((b, h, hh, ww, d)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_attend_ref(*(jnp.asarray(t.reshape(b, h, hh * ww, d))
                                       for t in (q, k, v)))).reshape(b, h, hh, ww, d)
    w = ww // SP

    def seq(t, r):   # shard r's positions, row-major over (height, its columns)
        return torch.from_numpy(t[:, :, :, r * w:(r + 1) * w].reshape(b, h, hh * w, d).copy())

    k_all = torch.cat([seq(k, r) for r in range(SP)], dim=2)
    v_all = torch.cat([seq(v, r) for r in range(SP)], dim=2)
    with torch.no_grad():
        got = np.concatenate([PA.flash_attention_xl(seq(q, r), k_all, v_all).numpy()
                              .reshape(b, h, hh, w, d) for r in range(SP)], axis=3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    with pytest.raises(RuntimeError, match="forward-only"):
        PA.flash_attention_xl(seq(q, 0).requires_grad_(), k_all, v_all)


def test_split_ks_does_not_combine_with_sp():
    """A patched (``split_ks``) model raises inside an sp region; the plan
    of one shard opens no region."""
    model, _ = flagship(tiny=True, device="cpu", split=True)
    plan = SpatialPlan(sp=2, index=0, group=None, batch=1, batch_index=0, batch_group=None)
    with plan, pytest.raises(ValueError, match="split_ks"):
        model.encode_first_stage(torch.zeros((1, 16, 128, 1)))
    assert C.spatial_plan() is None
    with SpatialPlan(sp=1, index=0, group=None, batch=1, batch_index=0, batch_group=None):
        assert C.spatial_plan() is None


@pytest.fixture(scope="module")
def sp_ranks():
    """The tiny flagship (seeded weights) W-sharded in 4 gloo ranks, and
    JAX's unsharded forward on the same weights and inputs."""
    rng = np.random.default_rng(6)
    image = rng.uniform(-1, 1, (2, 16, 128, 1)).astype(np.float32)
    latent = rng.standard_normal((2, 4, 16, 8)).astype(np.float32)
    t = np.array([32, 9])
    ring = np.arange(2 * 3 * 16, dtype=np.float32).reshape(2, 3, 16)
    ranks = D.spawn(R.spatial, SP, (SEED, image, latent, t, ring))
    port, _ = flagship(tiny=True, device="cpu")
    seed_weights(port, SEED)
    jbase, _ = jax_flagship(tiny=True)
    jmodel = JLatentDiffusion(jbase.cfg, jbase.unet.cfg, first_stage_cfg=jbase.first_stage.cfg,
                              use_mask=True)
    params = jax_ldm_params(port)
    want_z = np.asarray(jax.jit(jmodel.encode_first_stage)(params, jnp.asarray(image)))
    want_eps = np.asarray(jax.jit(jmodel.apply_model)(params, jnp.asarray(latent),
                                                      jnp.asarray(t)))
    return ranks, want_z, want_eps, ring


def test_w_sharded_encode_and_apply_model_equal_jax_unsharded(sp_ranks):
    """Every rank gathers the same whole-width latent and model output, each
    within rtol = atol = 2e-4 of JAX's unsharded forward (the dry run's
    tolerance); the seeded weights make attention and the output conv
    count (a fresh U-Net's start at zero)."""
    ranks, want_z, want_eps, _ = sp_ranks
    assert np.abs(want_eps).max() > 0.1 and np.abs(want_z).max() > 0.1
    for r in ranks:
        np.testing.assert_array_equal(r["z"], ranks[0]["z"])
        np.testing.assert_array_equal(r["eps"], ranks[0]["eps"])
    np.testing.assert_allclose(ranks[0]["z"], want_z, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ranks[0]["eps"], want_eps, rtol=2e-4, atol=2e-4)


def test_sp_mesh_plan_and_halo_ring(sp_ranks):
    """The ("dp", "fsdp", "sp") mesh of 4 ranks is (1, 1, 4), each rank's
    plan its own shard; the ring brings each shard 2 columns of its left
    neighbour's end and 3 of its right neighbour's start, wrapping from the
    last shard to the first, or zeros past the edges without wrap."""
    ranks, _, _, ring = sp_ranks
    w = ring.shape[-1] // SP
    for i, r in enumerate(ranks):
        assert r["mesh"] == {"dp": 1, "fsdp": 1, "sp": SP} and r["sp_ranks"] == list(range(SP))
        assert r["plan"] == (SP, i, 1, 0) and r["region_after"]
        cols = np.arange(i * w - 2, (i + 1) * w + 3)
        np.testing.assert_array_equal(r["ring"], ring[..., cols % ring.shape[-1]])
        cols = np.arange(i * w - 3, (i + 1) * w + 1)
        keep = (cols >= 0) & (cols < ring.shape[-1])
        np.testing.assert_array_equal(r["ring_zero"], ring[..., cols % ring.shape[-1]] * keep)
