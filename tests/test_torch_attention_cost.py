"""PyTorch port, the kernels' interface and the work counts of K1, K2 and K3.

The C entry points of the CUDA kernels are called through ctypes with the
argument types of ``ops/_build.SIGNATURES``; a mismatch with the prototype in
the source that holds it (``csrc/<source>.cu``) would show only on the card,
as a crash. Here each entry is held to its prototype, parsed as text.
``ops/attention.attention_cost`` and ``ops/groupnorm.group_norm_cost`` give
the operations, bytes and exponentials that ``chip_smoke.py`` divides by the
card's rates; they are held to the ``pl.CostEstimate`` of the JAX package's
Pallas kernels, captured from a run in interpret mode.
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from lidar_layout_tpu.ops.pallas_attention import _flash_bwd_tpu, _flash_fwd_tpu
from lidar_layout_tpu.ops.pallas_groupnorm import _fused_fwd
from lidar_layout_tpu_torch.ops import _build
from lidar_layout_tpu_torch.ops import attention as A
from lidar_layout_tpu_torch.ops import groupnorm as G


def _prototype(name, symbol):
    """[kinds] of the ``extern "C"`` function ``symbol`` in the source of the
    entry ``name``: 'p' for a pointer, 'i' for int, 'f' for float."""
    source = f"{_build.source(name)}.cu"
    text = (_build.SOURCE_DIR / source).read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert m, f"no extern \"C\" int {symbol} in {source}"
    kinds = []
    for arg in m.group(1).split(","):
        arg = " ".join(arg.split())
        if "*" in arg:
            kinds.append("p")
        elif re.match(r"(const )?int \w+$", arg):
            kinds.append("i")
        elif re.match(r"(const )?float \w+$", arg):
            kinds.append("f")
        else:
            raise AssertionError(f"{source}: argument of unknown kind {arg!r}")
    return kinds


_KIND = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_c_prototype(name):
    symbol, argtypes = _build.SIGNATURES[name]
    assert [_KIND[t] for t in argtypes] == _prototype(name, symbol)


def _pallas_cost(monkeypatch, fn, *args):
    """The CostEstimate that ``fn`` hands to pl.pallas_call (run in interpret
    mode, so the kernel also runs on the CPU)."""
    seen = []
    real = pl.pallas_call

    def spy(*a, **kw):
        seen.append(kw["cost_estimate"])
        return real(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", spy)
    out = fn(*args, interpret=True)
    assert len(seen) == 1
    return seen[0], out


@pytest.mark.parametrize("shape", [(1, 2, 128, 32), (2, 1, 256, 16)])
def test_forward_cost_matches_pallas_cost_estimate(monkeypatch, shape):
    b, h, s, d = shape
    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.standard_normal(shape), jnp.bfloat16) for _ in range(3))
    est, out = _pallas_cost(monkeypatch, _flash_fwd_tpu, q, k, v, None)
    assert out.shape == shape
    got = A.attention_cost(b, h, s, d, 2)
    assert got["flops"] == est.flops
    assert got["transcendentals"] == est.transcendentals
    assert got["bytes"] == est.bytes_accessed


@pytest.mark.parametrize("shape", [(1, 2, 128, 32), (2, 1, 256, 16)])
def test_backward_cost_matches_pallas_cost_estimate(monkeypatch, shape):
    b, h, s, d = shape
    rng = np.random.default_rng(1)
    q, k, v, o, do = (jnp.asarray(rng.standard_normal(shape), jnp.bfloat16) for _ in range(5))
    est, out = _pallas_cost(monkeypatch, _flash_bwd_tpu, q, k, v, o, do, None)
    assert [t.shape for t in out] == [shape] * 3
    got = A.attention_cost(b, h, s, d, 2, backward=True)
    assert got["flops"] == est.flops
    assert got["transcendentals"] == est.transcendentals
    # the TPU kernel writes dq, dk and dv in f32, the port in the input dtype
    bhsd = b * h * s * d
    assert got["bytes"] == est.bytes_accessed - 3 * bhsd * 4 + 3 * bhsd * 2


@pytest.mark.parametrize("shape,groups,act", [((2, 4, 8, 128), 32, False),
                                              ((1, 8, 4, 256), 16, True)])
def test_group_norm_forward_cost_matches_pallas_cost_estimate(monkeypatch, shape, groups, act):
    b, h, w, c = shape                       # NHWC, as the JAX package lays it out
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    gamma, beta = jnp.ones(c), jnp.zeros(c)
    est, out = _pallas_cost(monkeypatch, _fused_fwd, x, gamma, beta, groups, 1e-6, act)
    assert out.shape == shape
    got = G.group_norm_cost(b, c, h * w, groups, 2, act)
    assert got["flops"] == est.flops
    assert got["transcendentals"] == est.transcendentals
    # the TPU estimate leaves out the f32 gamma and beta, which the port counts
    assert got["bytes"] == est.bytes_accessed + 2 * c * 4


def test_group_norm_backward_cost_counts_x_dy_dx_and_the_affines():
    got = G.group_norm_cost(16, 256, 2048, 32, 2, True, backward=True)
    assert got["bytes"] == 3 * 16 * 256 * 2048 * 2 + 4 * 256 * 4
    assert got["transcendentals"] == 16 * 256 * 2048
    with pytest.raises(ValueError):
        G.group_norm_cost(2, 40, 16, 32, 2, False)
