"""GroupNorm(+SiLU) with f32 statistics: kernel K3 and its plain version.

Counterpart of ``lidar_layout_tpu/ops/pallas_groupnorm.py``. The kernel is
``csrc/group_norm.cu`` (CUDA C++ for sm_90a; its header says what bounds it
and how it is built around that). Tensors here are NCHW, where each
(batch, group) is one contiguous span.

``group_norm`` takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises. When a gradient is needed it
runs through ``_GroupNorm``, whose backward is ``_group_norm_bwd_ref``: the
analytic GroupNorm(+SiLU) backward that the JAX package writes in plain jnp
(``_fused_vjp_bwd``), here in plain PyTorch for NCHW.
"""
from __future__ import annotations

import torch

from . import _build

def _ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
         num_groups: int, eps: float, act: bool) -> torch.Tensor:
    """Plain GroupNorm(+SiLU) with two-pass f32 statistics (the JAX ``_ref``)."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, num_groups, -1)
    mean = xf.mean(dim=2, keepdim=True)
    var = (xf - mean).square().mean(dim=2, keepdim=True)
    xhat = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, c, -1)
    y = xhat * gamma.float()[None, :, None] + beta.float()[None, :, None]
    if act:
        y = y * torch.sigmoid(y)
    return y.reshape(x.shape).to(x.dtype)


def _group_norm_bwd_ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        dy: torch.Tensor, num_groups: int, eps: float, act: bool):
    """(dx, dgamma, dbeta) of GroupNorm(+SiLU), f32 arithmetic, each in its
    input's dtype: the JAX ``_fused_vjp_bwd`` for NCHW, where each (batch,
    group) is one contiguous span."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, num_groups, -1)
    mean = xf.mean(dim=2, keepdim=True)
    var = (xf - mean).square().mean(dim=2, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = ((xf - mean) * rstd).reshape(b, c, -1)
    gf = gamma.float()[None, :, None]
    g = dy.float().reshape(b, c, -1)
    if act:
        y = xhat * gf + beta.float()[None, :, None]
        sig = torch.sigmoid(y)
        g = g * (sig * (1.0 + y * (1.0 - sig)))        # d silu(y) / dy
    dgamma = (g * xhat).sum(dim=(0, 2)).to(gamma.dtype)
    dbeta = g.sum(dim=(0, 2)).to(beta.dtype)
    dxhat = (g * gf).reshape(b, num_groups, -1)
    xhat = xhat.reshape(b, num_groups, -1)
    m1 = dxhat.mean(dim=2, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=2, keepdim=True)
    dx = (dxhat - m1 - xhat * m2) * rstd
    return dx.reshape(x.shape).to(x.dtype), dgamma, dbeta


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launch(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            num_groups: int, eps: float, act: bool) -> torch.Tensor:
    if not x.is_cuda:
        raise ValueError(f"group_norm kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"group_norm kernel takes float32/bfloat16, got {x.dtype}")
    launch = _build.launcher("group_norm")
    b, c = x.shape[:2]
    if c % num_groups:
        raise ValueError(f"C={c} is not divisible by num_groups={num_groups}")
    hw = x.numel() // (b * c)
    if c * hw >= 2 ** 31:
        raise ValueError(f"group span {c // num_groups}x{hw} too large")
    x = x.contiguous()
    gamma, beta = (p if p.dtype == torch.float32 and p.device == x.device
                   and p.is_contiguous() else
                   p.to(device=x.device, dtype=torch.float32).contiguous()
                   for p in (gamma, beta))
    y = torch.empty_like(x)
    status = launch(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        _DTYPES[x.dtype], b, c, num_groups, hw, eps, int(act),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "group_norm")
    group_norm.launches += 1
    return y


def _forward(x, gamma, beta, num_groups, eps, act):
    if x.device.type == "cpu":
        return _ref(x, gamma, beta, num_groups, eps, act)
    return _launch(x, gamma, beta, num_groups, eps, act)


class _GroupNorm(torch.autograd.Function):
    """K3 forward (the plain version on the CPU), plain analytic backward."""

    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps, act):
        ctx.save_for_backward(x, gamma, beta)
        ctx.cfg = (num_groups, eps, act)
        return _forward(x, gamma, beta, num_groups, eps, act)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta = ctx.saved_tensors
        dx, dgamma, dbeta = _group_norm_bwd_ref(x, gamma, beta, dy, *ctx.cfg)
        return dx, dgamma, dbeta, None, None, None


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-6,
               act: bool = False) -> torch.Tensor:
    """GroupNorm over NCHW ``x`` (any trailing spatial dims) with f32
    statistics and affine, optionally fused with SiLU; output in x's dtype.
    Differentiable in x, gamma and beta."""
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _GroupNorm.apply(x, gamma, beta, num_groups, eps, act)
    return _forward(x, gamma, beta, num_groups, eps, act)


group_norm.launches = 0
