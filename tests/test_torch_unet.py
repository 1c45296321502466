"""PyTorch port vs the JAX package: the latent-diffusion U-Net.

The tiny flagship U-Net (and a scale-shift-norm variant, the other ResBlock
emb form) gets seeded weights in the port, crosses to flax through the JAX
package's ``convert_unet``, and both run the same numpy latents and
timesteps on the CPU in float32. Seeded weights include the zero-initialised
``proj_out`` / ``out_layers.3`` / ``out.2``, so attention and every block
reach the output. Also: the port's weight carrier (``utils.convert``) is
the exact inverse of ``convert_unet``, which pins the heads-major qkv layout.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_layout_tpu.models.unet import UNetConfig as JUNetConfig
from lidar_layout_tpu.models.unet import UNetModel as JUNetModel
from lidar_layout_tpu_torch.models.unet import SelfAttentionBlock, UNetConfig, UNetModel
from lidar_layout_tpu_torch.utils.convert import unet_state_dict
from torch_port_helpers import jax_unet_params, nchw, nhwc, seed_weights

TINY = dict(in_channels=8, model_channels=32, out_channels=8, num_res_blocks=1,
            attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=8)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("scale_shift", [False, True])
def test_tiny_unet_matches_jax(scale_shift):
    cfg = UNetConfig(**TINY, use_scale_shift_norm=scale_shift)
    unet = seed_weights(UNetModel(cfg), 21).eval()
    params = jax_unet_params(unet, cfg)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, 4, 16, 8)).astype(np.float32)      # NHWC latent
    t = np.array([3, 57])
    want = jax.jit(JUNetModel(JUNetConfig(**TINY, use_scale_shift_norm=scale_shift)).apply)(
        params, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = unet(nchw(x), torch.from_numpy(t))
    want = np.asarray(want)
    assert np.abs(want).max() > 0.1            # the seeded network is not degenerate
    # 1e-4: a dozen conv/norm/attention layers of f32 summed in other orders
    np.testing.assert_allclose(nhwc(got), want, atol=1e-4, rtol=1e-4)


def test_attention_heads_are_split_heads_major():
    # one SelfAttentionBlock with 4 heads against a per-head reference built
    # from the reference conv1d layout [h0:(q, k, v), h1:(q, k, v), ...]
    blk = seed_weights(SelfAttentionBlock(32, 4), 23).eval()
    x = torch.from_numpy(np.random.default_rng(24).standard_normal((2, 32, 4, 8))
                         .astype(np.float32))
    with torch.no_grad():
        got = blk(x)
        y = blk.norm(x).reshape(2, 32, 32)
        qkv = torch.nn.functional.conv1d(y, blk.qkv.weight, blk.qkv.bias)
        q, k, v = qkv.reshape(2 * 4, 3 * 8, 32).split(8, dim=1)       # QKVAttentionLegacy
        w = torch.softmax(torch.einsum("bct,bcs->bts", q, k) / 8 ** 0.5, dim=-1)
        a = torch.einsum("bts,bcs->bct", w, v).reshape(2, 32, 32)
        want = x + torch.nn.functional.conv1d(a, blk.proj_out.weight,
                                              blk.proj_out.bias).reshape(x.shape)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_weight_carrier_round_trip_is_exact():
    cfg = JUNetConfig(**TINY)
    shapes = jax.eval_shape(lambda: JUNetModel(cfg).init(
        jax.random.key(0), jnp.zeros((1, 4, 16, 8)), jnp.zeros((1,), jnp.int32)))
    jparams = jax.tree.map(lambda a: np.random.default_rng(a.size).standard_normal(
        a.shape).astype(np.float32), shapes)
    sd = unet_state_dict(jparams, UNetConfig(**TINY))
    port = UNetModel(UNetConfig(**TINY))
    port.load_state_dict(sd)                   # strict: every name carried, none extra
    back = jax_unet_params(port, UNetConfig(**TINY))
    want = dict(_flat(jparams["params"]))
    got = dict(_flat(back["params"]))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg="/".join(k))


def test_unported_branches_raise():
    # the SpatialTransformer and class-label branches are ported (their
    # parity tests are in test_torch_cond.py), and the x-transformers BERT
    # (test_torch_xt.py); a conditioning key that is not ported raises with
    # a ROADMAP pointer
    from lidar_layout_tpu_torch.encoders.modules import XTransformerBERTEmbedder
    from lidar_layout_tpu_torch.models.diffusion import DiffusionConfig, LatentDiffusion
    from lidar_layout_tpu_torch.nn.attention import SpatialTransformer

    st = UNetModel(dataclasses.replace(UNetConfig(**TINY), use_spatial_transformer=True,
                                       context_dim=16))
    assert isinstance(st.middle_block[1], SpatialTransformer)
    assert UNetModel(dataclasses.replace(UNetConfig(**TINY), num_classes=10)).label_emb.num_embeddings == 10
    # split_ks is ported: a latent larger than it runs patched
    patched = LatentDiffusion(DiffusionConfig(split_ks=(4, 4)), UNetConfig(**TINY))
    assert patched._split_active(4, 8) and not patched._split_active(4, 4)
    xt = XTransformerBERTEmbedder(n_embed=16, n_layer=1, heads=2, max_seq_len=8)
    assert xt(torch.zeros((1, 8), dtype=torch.long)).shape == (1, 8, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LatentDiffusion(DiffusionConfig(conditioning_key="not_a_key"), UNetConfig(**TINY))
