"""PyTorch port, kernels K1 (attention forward) and K3 (GroupNorm+SiLU).

On the CPU each wrapper takes its plain version, which is held here to the
JAX package's spec (``_attend_ref`` / ``_ref``) and to the Pallas kernel in
interpret mode, on the same numpy inputs, float32. The CUDA kernels
themselves are compiled and compared on the card (tests marked ``gpu``, and
``chip_smoke.py``); here a CUDA tensor handed to a wrapper must raise, never
fall back.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_layout_tpu.ops.pallas_attention import _attend_ref as jax_attend_ref
from lidar_layout_tpu.ops.pallas_attention import _flash_fwd_tpu
from lidar_layout_tpu.ops.pallas_groupnorm import _ref as jax_gn_ref
from lidar_layout_tpu.ops.pallas_groupnorm import group_norm_interpret
from lidar_layout_tpu_torch.ops import _build
from lidar_layout_tpu_torch.ops import attention as A
from lidar_layout_tpu_torch.ops import groupnorm as G

# f32 on one CPU: only summation order differs between the two frameworks
ATOL, RTOL = 1e-5, 1e-5


def _qkv(b, h, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3)]


def _kbias(b, s, seed):
    m = np.random.default_rng(seed).random((b, s)) > 0.3
    m[:, 0] = True
    return np.where(m, 0.0, -1e9).astype(np.float32)


@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_plain_matches_jax_ref_and_pallas_interpret(with_bias):
    q, k, v = _qkv(2, 3, 128, 32, seed=1)
    kb = _kbias(2, 128, 2) if with_bias else None
    jb = None if kb is None else jnp.asarray(kb)
    want_ref = np.asarray(jax_attend_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb))
    want_pl = np.asarray(_flash_fwd_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb,
                                        interpret=True))
    got = A.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                            None if kb is None else torch.from_numpy(kb)).numpy()
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=RTOL)
    # the Pallas kernel pre-scales q and sums in its own blocks: 2e-5, as the
    # JAX package's own interpret-mode test
    np.testing.assert_allclose(got, want_pl, atol=2e-5, rtol=2e-5)


def test_attend_routes_like_jax():
    # ragged S (no longer needs S % 128) and key-padding masks go to the kernel
    # path; cross-length attention and other masks go to plain attention
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 100, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 100, 4, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 100, 4, 16)).astype(np.float32))
    assert A._supports_flash(q, k, v)
    assert not A._supports_flash(q, k[:, :50], v[:, :50])
    assert not A._supports_flash(q[..., :12], k[..., :12], v[..., :12])
    mask = torch.from_numpy(rng.random((2, 1, 1, 100)) > 0.2)
    mask[:, :, :, 0] = True
    kb = A._key_padding_bias(mask, 2, 100)
    assert kb.shape == (2, 100) and kb.dtype == torch.float32
    assert A._key_padding_bias(torch.ones(2, 4, 100, 100, dtype=torch.bool), 2, 100) is None
    got = A.attend(q, k, v, mask)
    want = A._dot_product_attention(q, k, v, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)
    full = torch.ones(2, 4, 100, 100, dtype=torch.bool).tril()
    np.testing.assert_allclose(A.attend(q, k, v, full).numpy(),
                               A._dot_product_attention(q, k, v, full).numpy())


@pytest.mark.parametrize("c,groups", [(128, 32), (40, 20)])
@pytest.mark.parametrize("act", [False, True])
def test_group_norm_plain_matches_jax_ref_and_pallas_interpret(c, groups, act):
    from lidar_layout_tpu_torch.nn.blocks import num_groups_for

    assert num_groups_for(c) == groups      # largest divisor of C <= 32
    rng = np.random.default_rng(c + act)
    x = (rng.standard_normal((2, 8, 16, c)) * 2 + 0.3).astype(np.float32)   # NHWC
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups, 1e-6, act)
    want_ref = np.asarray(jax_gn_ref(*args))
    want_pl = np.asarray(group_norm_interpret(*args))
    got = G.group_norm(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                       torch.from_numpy(gamma), torch.from_numpy(beta), groups, 1e-6, act)
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=RTOL)
    # the Pallas kernel's one-pass E[x^2] - E[x]^2 statistics: 1e-4
    np.testing.assert_allclose(got, want_pl, atol=1e-4, rtol=1e-4)


class _CudaStub(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the kernel path."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


def _stub(t):
    return torch.Tensor._make_subclass(_CudaStub, t)


@pytest.mark.parametrize("which", ["flash_attention", "flash_attention_bwd", "group_norm",
                                   "group_norm_bwd"])
def test_cuda_tensor_with_kernel_unbuilt_raises(which, monkeypatch, tmp_path):
    # no nvcc here: the kernel cannot be built, so the wrapper must raise and
    # must not take the plain version
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LAUNCHERS", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))

    def forbidden(*a, **k):
        raise AssertionError("plain version taken for a CUDA tensor")

    wrapper = {"flash_attention": A.flash_attention, "flash_attention_bwd": A.flash_attention_bwd,
               "group_norm": G.group_norm, "group_norm_bwd": G.group_norm_bwd}[which]
    launches = wrapper.launches
    if which == "flash_attention":
        monkeypatch.setattr(A, "_attend_ref", forbidden)
        q = _stub(torch.zeros(1, 2, 64, 32))
        with pytest.raises(RuntimeError, match="nvcc"):
            A.flash_attention(q, q, q)
    elif which == "flash_attention_bwd":
        monkeypatch.setattr(A, "_attend_bwd_ref", forbidden)
        q = _stub(torch.zeros(1, 2, 64, 32, dtype=torch.bfloat16))
        lse = _stub(torch.zeros(1, 2, 64))
        with pytest.raises(RuntimeError, match="nvcc"):
            A.flash_attention_bwd(q, q, q, q, q, lse)
    elif which == "group_norm":
        monkeypatch.setattr(G, "_ref", forbidden)
        x = _stub(torch.zeros(1, 64, 4, 4))
        with pytest.raises(RuntimeError, match="nvcc"):
            G.group_norm(x, torch.ones(64), torch.zeros(64))
    else:
        monkeypatch.setattr(G, "_group_norm_bwd_ref", forbidden)
        x = _stub(torch.zeros(1, 64, 4, 4, dtype=torch.bfloat16))
        with pytest.raises(RuntimeError, match="nvcc"):
            G.group_norm_bwd(x, torch.ones(64), torch.zeros(64), x, 32, 1e-6, True)
    assert wrapper.launches == launches
