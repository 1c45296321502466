"""PyTorch port vs the JAX package: the range-image VQ autoencoder.

The port's ``VQModelInterface`` gets seeded weights (codebook N(0, 1), so the
nearest-code search has no near-ties at the origin), crosses to flax through
the JAX package's ``convert_vq_autoencoder`` under the reference names, and
both run the same numpy inputs on the CPU in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_layout_tpu.models import autoencoder as JAE
from lidar_layout_tpu_torch.models import autoencoder as PAE
from lidar_layout_tpu_torch.utils.convert import vq_state_dict
from torch_port_helpers import jax_vq_params, nchw, nhwc, seed_weights

# the tiny flagship's first stage (16x128 images, 4x16 latents), and one with
# attention at a level, which the flagship leaves out
CONFIGS = {
    "tiny_flagship": dict(ch=16, ch_mult=(1, 2, 2, 4), strides=((1, 2), (2, 2), (2, 2)),
                          z_channels=8, out_ch=2, num_res_blocks=1),
    "level_attn": dict(ch=16, ch_mult=(1, 2, 2), strides=((1, 2), (2, 2)),
                       z_channels=8, out_ch=2, num_res_blocks=1, attn_levels=(2,)),
}
N_EMBED = 1024
# a dozen conv/norm layers of f32 summed in other orders
ATOL, RTOL = 1e-4, 1e-4


def _pair(name):
    kw = CONFIGS[name]
    port = PAE.VQModelInterface(PAE.AEConfig(**kw), n_embed=N_EMBED, embed_dim=8,
                                use_mask=True)
    seed_weights(port, 31).eval()
    jmod = JAE.VQModelInterface(JAE.AEConfig(**kw), n_embed=N_EMBED, embed_dim=8,
                                use_mask=True)
    return port, jmod, jax_vq_params(port)


def _factor(kw):
    fh = fw = 1
    for sh, sw in kw["strides"]:
        fh, fw = fh * sh, fw * sw
    return fh, fw


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_and_forward_match_jax(name):
    port, jmod, params = _pair(name)
    x = np.random.default_rng(32).uniform(-1, 1, (2, 16, 128, 1)).astype(np.float32)
    want_z = jax.jit(lambda p, v: jmod.apply(p, v, method=lambda m, v: m.encode_latent(v)))(
        params, jnp.asarray(x))
    want_dec, want_loss, want_idx = jax.jit(jmod.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got_z = port.encode_latent(nchw(x))
        got_dec, got_loss, got_idx = port(nchw(x))
    fh, fw = _factor(CONFIGS[name])
    assert got_z.shape == (2, 8, 16 // fh, 128 // fw)
    np.testing.assert_allclose(nhwc(got_z), np.asarray(want_z), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(nhwc(got_dec), np.asarray(want_dec), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-4)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_latent_with_raydrop_matches_jax(name):
    port, jmod, params = _pair(name)
    fh, fw = _factor(CONFIGS[name])
    h = (np.random.default_rng(33).standard_normal((2, 16 // fh, 128 // fw, 8))
         .astype(np.float32))
    def run(method, *args):
        return jax.jit(lambda p, *a: jmod.apply(p, *a, method=method))(params, *args)

    want_raw = np.asarray(run(lambda m, v: m.decode_latent(v, True), jnp.asarray(h)))
    quant, _, _ = run(lambda m, v: m.quantize(v), jnp.asarray(h))
    want_dec = np.asarray(run(lambda m, v: m.decode(v), quant))
    want = np.asarray(run(lambda m, v: m.decode_latent(v), jnp.asarray(h)))
    with torch.no_grad():
        got_raw = nhwc(port.decode_latent(nchw(h), force_not_quantize=True))
        got = nhwc(port.decode_latent(nchw(h)))
    assert got.shape == want.shape == (2, 16, 128, 1)
    np.testing.assert_allclose(got_raw, want_raw, atol=ATOL, rtol=RTOL)
    # ray-drop is a sign test on the mask channel: a pixel whose mask logit is
    # within the tolerance of 0 may fall either way, every other pixel agrees
    sure = np.abs(want_dec[..., 1:2]) > 10 * ATOL
    assert sure.mean() > 0.99 and (want == -1.0).any() and (want != -1.0).any()
    np.testing.assert_allclose(got[sure], want[sure], atol=ATOL, rtol=RTOL)


def test_apply_raydrop_matches_jax():
    dec = np.random.default_rng(34).standard_normal((2, 8, 16, 2)).astype(np.float32)
    np.testing.assert_array_equal(nhwc(PAE.apply_raydrop(nchw(dec))),
                                  np.asarray(JAE.apply_raydrop(jnp.asarray(dec))))


def test_vq_weight_carrier_round_trip_is_exact():
    port, _, params = _pair("tiny_flagship")
    back = PAE.VQModelInterface(PAE.AEConfig(**CONFIGS["tiny_flagship"]),
                                n_embed=N_EMBED, embed_dim=8, use_mask=True)
    back.load_state_dict(vq_state_dict(params))   # strict: every name, none extra
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(back.state_dict()[k].numpy(), v.numpy(), err_msg=k)
