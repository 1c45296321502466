"""PyTorch port vs the JAX package, module by module (geometry, schedules,
embeddings, convs, norms, resampling, ResNet/attention blocks, VQ).

Same numpy inputs from a seed go through both packages on the CPU in
float32. Weights go from the port to flax through the JAX package's own
``convert_vq_autoencoder``, under the reference state_dict names.
Tolerance per module: 1e-4 abs / 1e-5 rel: only summation order differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_layout_tpu.models import schedules as JS
from lidar_layout_tpu.nn import blocks as JB
from lidar_layout_tpu.nn import conv as JC
from lidar_layout_tpu.nn.embeddings import timestep_embedding as j_temb
from lidar_layout_tpu.nn.quantize import VectorQuantizer as JVQ
from lidar_layout_tpu.ops import lidar as JL
from lidar_layout_tpu.utils.torch_convert import convert_vq_autoencoder
from lidar_layout_tpu_torch.models import schedules as PS
from lidar_layout_tpu_torch.nn import blocks as PB
from lidar_layout_tpu_torch.nn import conv as PC
from lidar_layout_tpu_torch.nn.embeddings import timestep_embedding as p_temb
from lidar_layout_tpu_torch.nn.quantize import VectorQuantizer as PVQ
from lidar_layout_tpu_torch.ops import lidar as PL
from torch_port_helpers import nchw, nhwc, numpy_state_dict, seed_weights

ATOL, RTOL = 1e-4, 1e-5


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _flax_params(module, prefix, *path):
    """Port module -> its flax params, through convert_vq_autoencoder under a
    reference name prefix, e.g. ('encoder.mid.block_1.', 'encoder', 'mid_block_1')."""
    tree = convert_vq_autoencoder(numpy_state_dict(module, prefix))["params"]
    for p in path:
        tree = tree[p]
    return {"params": tree}


def _close(got_nchw, want_nhwc):
    np.testing.assert_allclose(nhwc(got_nchw), np.asarray(want_nhwc), atol=ATOL, rtol=RTOL)


def test_lidar_geometry_and_reprojection():
    geom = PL.LidarGeometry(size=(16, 64))
    jgeom = JL.LidarGeometry(size=(16, 64))
    assert geom.depth_thresh == jgeom.depth_thresh
    np.testing.assert_array_equal(geom.ray_dirs(), jgeom.ray_dirs())
    img = np.random.default_rng(1).uniform(-1, 1, (2, 16, 64)).astype(np.float32)
    np.testing.assert_allclose(PL.model_to_depth(torch.from_numpy(img), geom).numpy(),
                               np.asarray(JL.model_to_depth(jnp.asarray(img), jgeom)),
                               atol=ATOL, rtol=RTOL)
    xyz, valid = PL.range2xyz(torch.from_numpy(img), geom)
    jxyz, jvalid = JL.range2xyz(jnp.asarray(img), jgeom)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(xyz.numpy(), np.asarray(jxyz), atol=ATOL, rtol=RTOL)
    pc, pvalid = PL.range2pcd(torch.from_numpy(img[0]), geom)
    jpc, jpvalid = JL.range2pcd(jnp.asarray(img[0]), jgeom)
    assert pc.shape == (16 * 64, 3)
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jpvalid))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jpc), atol=ATOL, rtol=RTOL)


def test_schedules_tables_are_the_jax_tables():
    kw = dict(timesteps=1024, linear_start=0.0015, linear_end=0.0195)
    ps, js = PS.DiffusionSchedule.create(**kw), JS.DiffusionSchedule.create(**kw)
    for f in ("betas", "alphas_cumprod", "sqrt_recip_alphas_cumprod",
              "sqrt_recipm1_alphas_cumprod", "posterior_variance", "lvlb_weights"):
        np.testing.assert_array_equal(getattr(ps, f), getattr(js, f))
    for steps, method in ((50, "uniform"), (20, "uniform"), (8, "quad")):
        np.testing.assert_array_equal(PS.make_ddim_timesteps(method, steps, 1024),
                                      JS.make_ddim_timesteps(method, steps, 1024))
        pd, jd = PS.DDIMSchedule.create(ps, steps, 0.5, method), \
            JS.DDIMSchedule.create(js, steps, 0.5, method)
        for f in ("timesteps", "alphas", "alphas_prev", "sqrt_one_minus_alphas", "sigmas"):
            np.testing.assert_array_equal(getattr(pd, f), getattr(jd, f))
    t = np.array([0, 5, 1023])
    np.testing.assert_array_equal(
        PS.extract(ps.sqrt_alphas_cumprod, torch.from_numpy(t), 4).numpy(),
        np.asarray(JS.extract(js.sqrt_alphas_cumprod, jnp.asarray(t), 4)))
    for sched in ("cosine", "sqrt_linear", "sqrt"):
        np.testing.assert_array_equal(PS.make_beta_schedule(sched, 100),
                                      JS.make_beta_schedule(sched, 100))


@pytest.mark.parametrize("flip", [True, False])
def test_timestep_embedding(flip):
    t = np.array([0, 1, 17, 999, 1023])
    for dim in (32, 33):
        np.testing.assert_allclose(
            p_temb(torch.from_numpy(t), dim, flip_sin_to_cos=flip).numpy(),
            np.asarray(j_temb(jnp.asarray(t), dim, flip_sin_to_cos=flip)), atol=ATOL, rtol=RTOL)


def test_circular_pad_and_conv():
    x = _x((2, 5, 8, 6), 2)                              # NHWC
    for pad in ((1, 1, 1, 1), (0, 1, 1, 1), (1, 2, 0, 0), (0, 1, 0, 1)):
        for wrap in (True, False):
            np.testing.assert_array_equal(
                nhwc(PC.circular_pad(nchw(x), pad, wrap)),
                np.asarray(JC.circular_pad(jnp.asarray(x), pad, wrap)))
    for k, stride, pad in (((3, 3), (1, 1), 1), ((3, 3), (2, 2), (0, 1, 0, 1)),
                           ((1, 4), (1, 1), (1, 2, 0, 0)), ((3, 3), (1, 2), (0, 1, 1, 1))):
        conv = seed_weights(PC.CircularConv(6, 7, k, stride, pad), 3)
        p = _flax_params(conv, "encoder.conv_in.", "encoder", "conv_in")
        want = JC.CircularConv(7, k, stride, pad).apply(p, jnp.asarray(x))
        with torch.no_grad():
            _close(conv(nchw(x)), want)


@pytest.mark.parametrize("c,act", [(64, True), (40, False)])
def test_normalize_group_rule_and_values(c, act):
    norm = seed_weights(PB.Normalize(c, act=act), 4)
    assert norm.num_groups == (32 if c == 64 else 20)
    x = _x((2, 4, 8, c), 5, 3.0) + 1.0
    p = _flax_params(norm, "encoder.norm_out.", "encoder", "norm_out")
    want = JB.Normalize(act=act).apply(p, jnp.asarray(x))
    with torch.no_grad():
        _close(norm(nchw(x)), want)


@pytest.mark.parametrize("scale", [(1, 2), (2, 2)])
def test_resize_align_corners_is_interpolate(scale):
    x = _x((2, 4, 8, 3), 6)
    _close(PB.resize_align_corners(nchw(x), scale),
           JB.resize_align_corners(jnp.asarray(x), scale))


@pytest.mark.parametrize("stride", [(1, 2), (2, 2)])
def test_upsample_and_downsample(stride):
    x = _x((2, 4, 8, 6), 7)
    up = seed_weights(PB.Upsample(6, stride), 8)
    p = _flax_params(up, "decoder.up.1.upsample.", "decoder", "up_1_upsample")
    with torch.no_grad():
        _close(up(nchw(x)), JB.Upsample(stride).apply(p, jnp.asarray(x)))
    down = seed_weights(PB.Downsample(6, stride), 9)
    p = _flax_params(down, "encoder.down.0.downsample.", "encoder", "down_0_downsample")
    with torch.no_grad():
        _close(down(nchw(x)), JB.Downsample(stride).apply(p, jnp.asarray(x)))


@pytest.mark.parametrize("cin,cout,kernel", [(32, 64, (3, 3)), (64, 64, (1, 4))])
def test_resnet_block(cin, cout, kernel):
    blk = seed_weights(PB.ResnetBlock(cin, cout, kernel_size=kernel), 10)
    x = _x((2, 4, 16, cin), 11)
    p = _flax_params(blk, "encoder.mid.block_1.", "encoder", "mid_block_1")
    want = JB.ResnetBlock(out_channels=cout, kernel_size=kernel).apply(p, jnp.asarray(x))
    with torch.no_grad():
        _close(blk(nchw(x)), want)


def test_attn_block():
    blk = seed_weights(PB.AttnBlock(32), 12)
    x = _x((2, 4, 8, 32), 13)
    p = _flax_params(blk, "encoder.mid.attn_1.", "encoder", "mid_attn_1")
    want = JB.AttnBlock().apply(p, jnp.asarray(x))
    with torch.no_grad():
        _close(blk(nchw(x)), want)
    assert isinstance(PB.make_attn(8, "none"), torch.nn.Identity)


def test_vector_quantizer():
    vq = seed_weights(PVQ(512, 8), 14)
    z = _x((2, 4, 16, 8), 15, 2.0)
    p = _flax_params(vq, "quantize.", "quantize")
    jq, jloss, jidx = JVQ(512, 8).apply(p, jnp.asarray(z))
    with torch.no_grad():
        zq, loss, idx = vq(nchw(z))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(zq, jq)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
