"""PyTorch port, the routing of ``attend`` and the partials of K2's dq sum.

``attend`` sends what the kernels K1/K2 take to ``flash_attention`` and the
rest to plain attention, by a rule on shapes and dtypes alone, as JAX's
``attend`` sends what its kernel does not take to XLA. Where JAX's ``attend``
returns a result, the port's returns the same (float32, CPU).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_layout_tpu.ops.pallas_attention import attend as jax_attend
from lidar_layout_tpu_torch.ops import attention as A


def _bshd(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_attend_with_v_of_another_width_matches_jax(masked):
    # S = 128 takes JAX's kernel route, whose reference formula contracts
    # P with a v of any head width; the port's kernels need v shaped as q
    rng = np.random.default_rng(11)
    q, k = _bshd(rng, (2, 128, 4, 16)), _bshd(rng, (2, 128, 4, 16))
    v = _bshd(rng, (2, 128, 4, 24))
    mask = None
    if masked:
        mask = rng.random((2, 1, 1, 128)) > 0.25
        mask[..., 0] = True
    want = np.asarray(jax_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 None if mask is None else jnp.asarray(mask)))
    qt, kt, vt = (torch.from_numpy(t) for t in (q, k, v))
    assert not A._supports_flash(qt, kt, vt)
    got = A.attend(qt, kt, vt, None if mask is None else torch.from_numpy(mask))
    assert got.shape == want.shape == (2, 128, 4, 24)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_supports_flash_is_a_shape_and_dtype_rule():
    q = torch.zeros((2, 100, 4, 32))
    assert A._supports_flash(q, q, q)
    assert A._supports_flash(q.bfloat16(), q.bfloat16(), q.bfloat16())
    assert not A._supports_flash(q, q, q[..., :16])            # v narrower
    assert not A._supports_flash(q, q[:, :50], q[:, :50])      # cross-length
    assert not A._supports_flash(q[..., :12], q[..., :12], q[..., :12])   # D % 8
    assert not A._supports_flash(q.half(), q.half(), q.half())            # no fp16 kernel
    assert not A._supports_flash(q, q, q.bfloat16())                      # mixed dtypes
    # B*H above 65535 stays on the kernel route: K1/K2 put B*H on gridDim.x
    big = torch.zeros((1, 16, 1, 32)).expand(70000, 16, 1, 32)
    assert A._supports_flash(big, big, big)


@pytest.mark.parametrize("s,partials", [
    (1, 1), (127, 1), (128, 1), (129, 2), (333, 3), (512, 4), (1000, 8), (2048, 16), (2049, 17)])
def test_dq_partials(s, partials):
    # K2's bf16 dq: an f32 partial for each key block of 128 keys, summed in
    # index order; one key block writes dq itself
    assert A.dq_partials(s) == partials
