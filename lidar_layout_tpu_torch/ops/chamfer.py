"""Chamfer distance (squared, masked): kernel K4 and its plain version.

Counterpart of ``lidar_layout_tpu/ops/chamfer.py`` (the XLA path) and
``lidar_layout_tpu/ops/pallas_chamfer.py`` (the TPU kernel). The kernel is
``csrc/chamfer_nn.cu`` (CUDA C++ for sm_90a; its header says what bounds it
and how it is built around that).

``nn_dist_one_way`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. The spec is the clamped XLA
path: distances are never negative, and a masked-out y is ``BIG`` away (the
Pallas kernel neither clamps nor uses ``BIG``: its sentinel coordinate puts
a masked y about 3e8 away). K4 is forward-only, as on the TPU: with grad
mode on and an input that requires grad, ``nn_dist_one_way`` raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

BIG = 1e10


def _sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(N, D), (M, D) -> (N, M) squared distances by the expansion
    |x|^2 + |y|^2 - 2 x.y^T, clamped at 0. The f32 product must run in full
    f32, the counterpart of JAX's Precision.HIGHEST: TF32 keeps about three
    digits, which is visible on the small distances the metric measures."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain chamfer needs full-f32 matmuls on the card: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    x2 = (x * x).sum(dim=-1)[:, None]
    y2 = (y * y).sum(dim=-1)[None, :]
    return (x2 + y2 - 2.0 * (x @ y.T)).clamp_min(0.0)


def _nn_dist_ref(x: torch.Tensor, y: torch.Tensor, y_mask: Optional[torch.Tensor] = None,
                 chunk: int = 4096) -> torch.Tensor:
    """Per-x squared distance to the nearest y, rows in chunks of ``chunk``
    so the (chunk, M) tile bounds memory; masked y rows are BIG away."""
    out = []
    for i in range(0, max(x.shape[0], 1), chunk):
        d = _sq_dists(x[i:i + chunk], y)
        if y_mask is not None:
            d = torch.where(y_mask[None, :], d, BIG)
        out.append(d.amin(dim=-1))
    return torch.cat(out)


def _launch(x: torch.Tensor, y: torch.Tensor, y_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if not (x.is_cuda and y.is_cuda and x.device == y.device):
        raise ValueError(f"chamfer_nn kernel needs x and y on one CUDA device, got "
                         f"{x.device} and {y.device}")
    x = x.to(torch.float32).contiguous()
    y = y.to(torch.float32).contiguous()
    n, m = x.shape[0], y.shape[0]
    if y_mask is not None:
        if y_mask.shape != (m,):
            raise ValueError(f"y_mask has shape {tuple(y_mask.shape)}, expected ({m},)")
        y_mask = y_mask.to(device=x.device, dtype=torch.bool).contiguous()
    # no valid y: BIG with a mask (as the XLA path's where), else +inf
    out = torch.full((n,), BIG if y_mask is not None else float("inf"),
                     dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    launch = _build.launcher("chamfer_nn")
    status = launch(x.data_ptr(), y.data_ptr(), 0 if y_mask is None else y_mask.data_ptr(),
                    out.data_ptr(), n, m, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "chamfer_nn")
    nn_dist_one_way.launches += 1
    return out


def nn_dist_one_way(x: torch.Tensor, y: torch.Tensor, y_mask: Optional[torch.Tensor] = None,
                    chunk: int = 4096) -> torch.Tensor:
    """(N, 3), (M, 3) -> (N,) f32 squared distance from each x to its nearest
    valid y. ``chunk`` bounds the plain version's memory; the kernel streams
    y and needs none. Forward-only: it raises where a gradient is asked for."""
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        raise RuntimeError("nn_dist_one_way is forward-only (kernel K4 has no backward); "
                           "chamfer_loss with its gradient is open in ROADMAP queue 1, "
                           "item 9")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != 3 or y.shape[1] != 3:
        raise ValueError(f"expected (N, 3) and (M, 3) points, got {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")
    if y.shape[0] == 0:
        raise ValueError("nn_dist_one_way needs at least one y point")
    if x.device.type == "cpu":
        return _nn_dist_ref(x.float(), y.float(), y_mask, chunk)
    return _launch(x, y, y_mask)


nn_dist_one_way.launches = 0


def chamfer_distance(x: torch.Tensor, y: torch.Tensor,
                     x_mask: Optional[torch.Tensor] = None,
                     y_mask: Optional[torch.Tensor] = None,
                     chunk: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional squared chamfer (dist_x (N,), dist_y (M,)), the
    semantics of JAX's ``chamfer_distance`` and ``chamfer_pallas``: masked x
    rows give 0 (leave them out of a mean with the mask)."""
    d_x = nn_dist_one_way(x, y, y_mask, chunk)
    d_y = nn_dist_one_way(y, x, x_mask, chunk)
    if x_mask is not None:
        d_x = torch.where(x_mask, d_x, 0.0)
    if y_mask is not None:
        d_y = torch.where(y_mask, d_y, 0.0)
    return d_x, d_y


def _masked_mean(d: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return d.mean()
    m = mask.to(d.dtype)
    return (d * m).sum() / m.sum().clamp_min(1.0)


def pairwise_cd(x: torch.Tensor, y: torch.Tensor, x_mask: Optional[torch.Tensor] = None,
                y_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scalar CD as the reference's eval toolbox defines it: (mean_i d1 +
    mean_j d2) / 2 over squared distances."""
    d_x, d_y = chamfer_distance(x, y, x_mask, y_mask)
    return (_masked_mean(d_x, x_mask) + _masked_mean(d_y, y_mask)) / 2.0


def batch_chamfer(xs: torch.Tensor, ys: torch.Tensor, x_masks: Optional[torch.Tensor] = None,
                  y_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N, 3) vs (B, M, 3) -> (B,) scalar CDs, one pair at a time."""
    return torch.stack([
        pairwise_cd(xs[b], ys[b], None if x_masks is None else x_masks[b],
                    None if y_masks is None else y_masks[b])
        for b in range(xs.shape[0])])
