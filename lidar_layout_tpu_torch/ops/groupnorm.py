"""GroupNorm(+SiLU) with f32 statistics: kernel K3 and its plain version.

Counterpart of ``lidar_layout_tpu/ops/pallas_groupnorm.py``. The kernel is
``csrc/group_norm.cu`` (CUDA C++ for sm_90a; its header says what bounds it
and how it is built around that). Tensors here are NCHW, where each
(batch, group) is one contiguous span.

``group_norm`` takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises. When a gradient is needed it
runs through ``_GroupNorm``, whose backward is ``group_norm_bwd``: the
analytic GroupNorm(+SiLU) backward that the JAX package writes in plain jnp
(``_fused_vjp_bwd``), a kernel in the same source on the card, and its plain
version ``_group_norm_bwd_ref`` on the CPU.

``group_norm_split`` is K3 in split form for a W shard (the spatial ``sp``
axis), whose groups span every shard: this shard's statistics
(``group_norm_stats``), merged across the shards
(``collectives.all_reduce_group_stats``), then the normalisation from them
(``group_norm_apply``); two kernels of the same source, each with its plain
version. Forward only.
"""
from __future__ import annotations

import torch

from ..parallel.collectives import all_reduce_group_stats, get_world_size
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


def group_norm_cost(b: int, c: int, hw: int, groups: int, itemsize: int, act: bool,
                    backward: bool = False) -> dict:
    """Work of one call of K3 (or its backward when ``backward``) on (B, C,
    H*W) in a dtype of ``itemsize`` bytes. Forward, as the JAX package's
    ``pl.CostEstimate`` counts it: ``flops`` 10 an element, ``transcendentals``
    one an element with SiLU; ``bytes`` x read and y written, plus the f32
    gamma and beta that the estimate leaves out. Backward: about 16 flops an
    element (26 with SiLU), x and dy read and dx written, gamma and beta read
    and dgamma and dbeta written in f32."""
    if c % groups:
        raise ValueError(f"C={c} is not divisible by groups={groups}")
    n = b * c * hw
    if backward:
        return {"flops": (26 if act else 16) * n, "transcendentals": n if act else 0,
                "bytes": 3 * n * itemsize + 4 * c * 4}
    return {"flops": 10 * n, "transcendentals": n if act else 0,
            "bytes": 2 * n * itemsize + 2 * c * 4}


def _shape(x: torch.Tensor, num_groups: int):
    """(B, C, H*W) of x after the checks the kernels need."""
    if not x.is_cuda:
        raise ValueError(f"group_norm kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"group_norm kernel takes float32/bfloat16, got {x.dtype}")
    b, c = x.shape[:2]
    if c % num_groups:
        raise ValueError(f"C={c} is not divisible by num_groups={num_groups}")
    hw = x.numel() // (b * c)
    if c * hw >= 2 ** 31:
        raise ValueError(f"group span {c // num_groups}x{hw} too large")
    return b, c, hw


def _f32_on(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """An affine parameter as the kernels take it: contiguous f32 on x's device."""
    if p.dtype == torch.float32 and p.device == x.device and p.is_contiguous():
        return p
    return p.to(device=x.device, dtype=torch.float32).contiguous()


def _launch(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            num_groups: int, eps: float, act: bool) -> torch.Tensor:
    b, c, hw = _shape(x, num_groups)
    launch = _build.launcher("group_norm")
    x = x.contiguous()
    gamma, beta = _f32_on(gamma, x), _f32_on(beta, x)
    y = torch.empty_like(x)
    _build.launch(
        launch, x.device, "group_norm",
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        _DTYPES[x.dtype], b, c, num_groups, hw, eps, int(act),
        torch.cuda.current_stream(x.device).cuda_stream)
    group_norm.launches += 1
    return y


def _launch_bwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, dy: torch.Tensor,
                num_groups: int, eps: float, act: bool):
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} does not match x {tuple(x.shape)}")
    b, c, hw = _shape(x, num_groups)
    launch = _build.launcher("group_norm_bwd")
    xc = x.contiguous()
    gamma32, beta32 = _f32_on(gamma, xc), _f32_on(beta, xc)
    dy = dy.to(device=xc.device, dtype=xc.dtype).contiguous()
    dx = torch.empty_like(xc)
    part = torch.empty((2, b, c), device=xc.device, dtype=torch.float32)
    dgamma = torch.empty(c, device=xc.device, dtype=torch.float32)
    dbeta = torch.empty(c, device=xc.device, dtype=torch.float32)
    _build.launch(
        launch, xc.device, "group_norm_bwd",
        xc.data_ptr(), gamma32.data_ptr(), beta32.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        part.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), _DTYPES[xc.dtype], b, c,
        num_groups, hw, eps, int(act), torch.cuda.current_stream(xc.device).cuda_stream)
    group_norm_bwd.launches += 1
    return dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype)


def kernel_path(dtype: torch.dtype, c: int, hw: int, num_groups: int,
                backward: bool = False) -> int:
    """The path the kernel takes for (C, H*W) with 16-byte aligned tensors:
    the blocks of the cluster that holds a span on chip (1: one block), or 0
    for the two-sweep path. Launches nothing."""
    query = _build.launcher("group_norm_path")
    return query(_DTYPES[dtype], c, num_groups, hw, int(backward))


def _forward(x, gamma, beta, num_groups, eps, act):
    if x.device.type == "cpu":
        return _ref(x, gamma, beta, num_groups, eps, act)
    return _launch(x, gamma, beta, num_groups, eps, act)


def group_norm_bwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   dy: torch.Tensor, num_groups: int = 32, eps: float = 1e-6,
                   act: bool = False):
    """(dx, dgamma, dbeta) of GroupNorm(+SiLU) at x for the output gradient
    dy: the kernel for a CUDA tensor, the plain version on the CPU."""
    if x.device.type == "cpu":
        return _group_norm_bwd_ref(x, gamma, beta, dy, num_groups, eps, act)
    return _launch_bwd(x, gamma, beta, dy, num_groups, eps, act)


class _GroupNorm(torch.autograd.Function):
    """K3 forward and its backward kernel (the plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps, act):
        ctx.save_for_backward(x, gamma, beta)
        ctx.cfg = (num_groups, eps, act)
        return _forward(x, gamma, beta, num_groups, eps, act)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta = ctx.saved_tensors
        dx, dgamma, dbeta = group_norm_bwd(x, gamma, beta, dy, *ctx.cfg)
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
group_norm_bwd.launches = 0


# ---------------------------------------------------- split form (the sp axis)
def _stats_ref(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """(B, G, 2) f32: each (batch, group)'s mean and M2 (the sum of squares
    about that mean) over this shard, ``_ref``'s two passes."""
    xf = x.float().reshape(x.shape[0], num_groups, -1)
    mean = xf.mean(dim=2)
    return torch.stack([mean, (xf - mean[..., None]).square().sum(dim=2)], dim=-1)


def _apply_ref(x: torch.Tensor, stats: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               num_groups: int, count: int, eps: float, act: bool) -> torch.Tensor:
    """GroupNorm(+SiLU) of ``x`` from the (B, G, 2) (mean, M2) of ``count``
    elements a group (the whole width's), f32 arithmetic, in x's dtype."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, num_groups, -1)
    mean, m2 = stats[..., :1].float(), stats[..., 1:].float()
    xhat = ((xf - mean) * torch.rsqrt(m2 / count + eps)).reshape(b, c, -1)
    y = xhat * gamma.float()[None, :, None] + beta.float()[None, :, None]
    if act:
        y = y * torch.sigmoid(y)
    return y.reshape(x.shape).to(x.dtype)


def group_norm_stats(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """(B, G, 2) f32 (mean, M2) of each (batch, group) of ``x`` (B, C, H,
    W): the kernel for a CUDA tensor, the plain version on the CPU."""
    if x.device.type == "cpu":
        return _stats_ref(x, num_groups)
    b, c, hw = _shape(x, num_groups)
    launch = _build.launcher("group_norm_stats")
    x = x.contiguous()
    stats = torch.empty((b, num_groups, 2), dtype=torch.float32, device=x.device)
    _build.launch(launch, x.device, "group_norm_stats", x.data_ptr(), stats.data_ptr(),
                  _DTYPES[x.dtype], b, c, num_groups, hw,
                  torch.cuda.current_stream(x.device).cuda_stream)
    group_norm_stats.launches += 1
    return stats


def group_norm_apply(x: torch.Tensor, stats: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, num_groups: int, count: int, eps: float = 1e-6,
                     act: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU) of ``x`` from ``stats`` (B, G, 2), the (mean, M2) of
    ``count`` elements a group: the kernel for a CUDA tensor, the plain
    version on the CPU; output in x's dtype."""
    if x.device.type == "cpu":
        return _apply_ref(x, stats, gamma, beta, num_groups, count, eps, act)
    b, c, hw = _shape(x, num_groups)
    if stats.shape != (b, num_groups, 2):
        raise ValueError(f"stats {tuple(stats.shape)} is not ({b}, {num_groups}, 2)")
    launch = _build.launcher("group_norm_apply")
    x = x.contiguous()
    stats = stats.to(device=x.device, dtype=torch.float32).contiguous()
    gamma, beta = _f32_on(gamma, x), _f32_on(beta, x)
    y = torch.empty_like(x)
    _build.launch(launch, x.device, "group_norm_apply", x.data_ptr(), stats.data_ptr(),
                  gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], b, c,
                  num_groups, hw, float(count), eps, int(act),
                  torch.cuda.current_stream(x.device).cuda_stream)
    group_norm_apply.launches += 1
    return y


def group_norm_split(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     num_groups: int, eps: float, act: bool, group=None) -> torch.Tensor:
    """GroupNorm(+SiLU) of a W shard ``x`` whose groups span the shards of
    the ranks of ``group``, forward only: this shard's (mean, M2), merged
    with the others' in rank order, then the normalisation with the merge.
    Every shard holds as many columns."""
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        raise RuntimeError("the split GroupNorm (the sp axis) is forward-only: run it "
                           "under torch.no_grad()")
    count = x[0].numel() // num_groups
    stats = all_reduce_group_stats(group_norm_stats(x, num_groups), count, group)
    return group_norm_apply(x, stats, gamma, beta, num_groups, count * get_world_size(group),
                            eps, act)


group_norm_stats.launches = 0
group_norm_apply.launches = 0
