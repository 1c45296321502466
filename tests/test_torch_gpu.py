"""PyTorch port, the hand-written CUDA kernels against their plain versions on
the card.

Every test here is marked ``gpu`` and skips without a CUDA card. The file
imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import pytest
import torch

from lidar_layout_tpu_torch.nn.blocks import num_groups_for
from lidar_layout_tpu_torch.ops import attention as A
from lidar_layout_tpu_torch.ops import groupnorm as G


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_attention_kernel_matches_plain(cuda_device, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for (b, h, s, d) in [(2, 8, 2048, 32), (2, 4, 1000, 64), (1, 2, 77, 16)]:
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=cuda_device).to(dt)
                   for _ in range(3))
        kb = torch.zeros((b, s), device=cuda_device)
        kb[0, -s // 4:] = -1e9
        launches = A.flash_attention.launches
        got = A.flash_attention(q, k, v, kb)
        want = A._attend_ref(q, k, v, kb)
        torch.cuda.synchronize()
        assert A.flash_attention.launches == launches + 1
        # f32: summation order only; bf16: the kernel rounds the unnormalised
        # probabilities to bf16 before P.V, the plain version the normalised ones
        tol = 1e-4 if dt == torch.float32 else 3e-2
        assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_group_norm_kernel_matches_plain(cuda_device, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for (b, c, h, w) in [(2, 256, 16, 128), (2, 128, 64, 1024), (2, 40, 5, 7)]:
        x = (torch.randn((b, c, h, w), generator=gen, device=cuda_device) * 2 + 0.3).to(dt)
        gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=cuda_device)
        beta = 0.1 * torch.randn(c, generator=gen, device=cuda_device)
        g = num_groups_for(c)
        for act in (False, True):
            launches = G.group_norm.launches
            got = G.group_norm(x, gamma, beta, g, 1e-6, act)
            want = G._ref(x, gamma, beta, g, 1e-6, act)
            torch.cuda.synchronize()
            assert G.group_norm.launches == launches + 1
            # f32: summation order only; bf16: one output rounding (|y| < 8)
            tol = 1e-4 if dt == torch.float32 else 5e-2
            assert (got.float() - want.float()).abs().max().item() <= tol
