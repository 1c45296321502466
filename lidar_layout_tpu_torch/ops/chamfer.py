"""Chamfer distance (squared, masked): kernel K4, its plain version, and a
plain emulation of the kernel's two stages.

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
``chamfer_loss``, the training loss with its gradient (the object
autoencoder's), is plain PyTorch, as JAX's is plain XLA, and launches no
kernel.

K4 finds candidates with TF32 tensor-core products of the expanded distance
and re-checks them in the direct form ``(x - y)^2``; ``_nn_dist_emulated``
repeats both stages in plain PyTorch, with the kernel's TF32 operands and
error bound, for the tests and ``chip_smoke.py`` only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

BIG = 1e10
_TILE_Y = 512           # y records a shared-memory stage (kTileY in chamfer_nn.cu)
_CENTRE_SAMPLES = 64    # y sampled for the centre c (kCentreSamples)
RECHECK = 16           # direct forms a lane's re-check of one chunk forms (kChunk / 4)


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


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 with its low 13 mantissa bits cleared: a TF32 value, exact."""
    return (t.view(torch.int32) & -8192).view(torch.float32)


def _centre(y: torch.Tensor, y_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """K4's centre c: the mean of the valid y among 64 at fixed indices
    (0 if none is valid). Any c keeps K4 exact; a c inside the cloud keeps
    its error bound small."""
    m = y.shape[0]
    idx = torch.arange(_CENTRE_SAMPLES, device=y.device) * m // _CENTRE_SAMPLES
    pts = y[idx]
    if y_mask is not None:
        pts = pts[y_mask[idx]]
    c = pts.mean(dim=0) if len(pts) else torch.zeros(3, device=y.device)
    return torch.where(torch.isfinite(c).all(), c, torch.zeros_like(c))


def _direct(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """f32 points (..., 3) and (..., 3) -> (...) f32 direct form ((dx dx +
    dy dy) + dz dz), as K4 forms it: f32 differences, each sum rounded once
    as an FMA rounds it (the products are exact in f64)."""
    d = (x - y).double()
    acc = (d[..., 0] * d[..., 0]).float()
    acc = (d[..., 1] * d[..., 1] + acc.double()).float()
    return (d[..., 2] * d[..., 2] + acc.double()).float()


def _fma_square_sum(p: torch.Tensor) -> torch.Tensor:
    """(..., 3) f32 -> (...) f32 |p|^2 as K4 forms it: p0 p0, then two FMAs."""
    acc = p[..., 0] * p[..., 0]
    acc = (p[..., 1].double() * p[..., 1] + acc.double()).float()
    return (p[..., 2].double() * p[..., 2] + acc.double()).float()


def _candidate_values(xp: torch.Tensor, yp: torch.Tensor) -> torch.Tensor:
    """(N, 3), (M, 3) f32 points already translated by the centre -> (N, M)
    f32 candidate values ~|x' - y'|^2 - |xh|^2: the depth-8 dot product of
    K4's TF32 operands, [-2xh, 1, 1, 0, 0, 0] . [yh, sh, sl, ...] with
    s = |yh|^2 = sh + sl, summed in f64 and rounded once."""
    xh, yh = _tf32(xp), _tf32(yp)
    s = _fma_square_sum(yh)
    sh = _tf32(s)
    sl = _tf32(s - sh)
    return ((-2 * xh).double() @ yh.double().T + (sh.double() + sl.double())[None, :]).float()


def candidate_bound(r: torch.Tensor, big_r: torch.Tensor) -> torch.Tensor:
    """K4's bound e(r) on |candidate + |xh|^2 - D| for a y at distance
    r = sqrt(D) from an x at distance R = ``big_r`` from the centre, with its
    margins: 1.1 (2^-9 (2R + r) r + 2^-16 (2R + r)^2) (the header of
    chamfer_nn.cu derives it)."""
    w = 2 * big_r + r
    return 1.1 * (2.0 ** -9 * w * r + 2.0 ** -16 * w * w)


def _tau(m: torch.Tensor, big_r: torch.Tensor, xh2: torch.Tensor) -> torch.Tensor:
    """The re-check threshold m + 2 e(r_max): r_max is the farthest a y can
    lie and still have a candidate value <= m."""
    a, b = 2.0 ** -9, 2.0 ** -16
    a2, a1, a0 = 1.1 * (a + b), 1.1 * (2 * a + 4 * b) * big_r, 1.1 * 4 * b * big_r * big_r
    dm = (m + xh2).clamp_min(0)
    r = (a1 + torch.sqrt(a1 * a1 + 4 * (1 - a2) * (a0 + dm))) / (2 * (1 - a2))
    return m + 2 * (r * (a2 * r + a1) + a0)


def _nn_dist_emulated(x: torch.Tensor, y: torch.Tensor, y_mask: Optional[torch.Tensor] = None,
                      chunk: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's two stages in plain PyTorch (tests and chip_smoke.py only):
    (the (N,) f32 distances, filled as the kernel's wrapper fills them where
    no y is valid, and the (N,) count of y re-checked in the direct form).
    Every valid y whose candidate value is at most tau(m), m the least
    candidate value, is re-checked in the direct form, and the least of
    those is the answer. The kernel re-checks a superset of these y (its
    running m only falls to m), so it returns the same value."""
    x, y = x.float(), y.float()
    c = _centre(y, y_mask)
    xp, yp = x - c, y - c
    valid = (torch.ones(y.shape[0], dtype=torch.bool, device=y.device) if y_mask is None
             else y_mask.to(torch.bool))
    out, counts = [], []
    for i in range(0, x.shape[0], chunk):
        xc, xpc = x[i:i + chunk], xp[i:i + chunk]
        v = torch.where(valid[None, :], _candidate_values(xpc, yp), float("inf"))
        m = v.amin(dim=1, keepdim=True)
        big_r = torch.sqrt(_fma_square_sum(xpc))[:, None]
        tau = _tau(m, big_r, _fma_square_sum(_tf32(xpc))[:, None])
        cand = (v <= tau) & torch.isfinite(v)
        rows, cols = cand.nonzero(as_tuple=True)
        d = torch.full((len(xc),), BIG if y_mask is not None else float("inf"),
                       device=x.device)
        d.scatter_reduce_(0, rows, _direct(xc[rows], y[cols]), "amin")
        out.append(d)
        counts.append(cand.sum(dim=1))
    return torch.cat(out), torch.cat(counts)


def _launch(x: torch.Tensor, y: torch.Tensor, y_mask: Optional[torch.Tensor],
            counts: Optional[torch.Tensor] = None) -> torch.Tensor:
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
    m_pad = -(-m // _TILE_Y) * _TILE_Y
    rec = torch.empty((m_pad, 12), dtype=torch.float32, device=x.device)  # y's records, points
    centre = torch.empty(4, dtype=torch.float32, device=x.device)
    _build.launch(launch, x.device, "chamfer_nn",
                  x.data_ptr(), y.data_ptr(), None if y_mask is None else y_mask.data_ptr(),
                  out.data_ptr(), rec.data_ptr(), centre.data_ptr(),
                  None if counts is None else counts.data_ptr(), n, m,
                  torch.cuda.current_stream(x.device).cuda_stream)
    nn_dist_one_way.launches += 1
    return out


def nn_dist_one_way(x: torch.Tensor, y: torch.Tensor, y_mask: Optional[torch.Tensor] = None,
                    chunk: int = 4096) -> torch.Tensor:
    """(N, 3), (M, 3) -> (N,) f32 squared distance from each x to its nearest
    valid y. ``chunk`` bounds the plain version's memory; the kernel streams
    y and needs none. Forward-only: it raises where a gradient is asked for."""
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        raise RuntimeError("nn_dist_one_way is forward-only (kernel K4 has no backward); "
                           "chamfer_loss is the differentiable chamfer")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != 3 or y.shape[1] != 3:
        raise ValueError(f"expected (N, 3) and (M, 3) points, got {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")
    if y.shape[0] == 0:
        raise ValueError("nn_dist_one_way needs at least one y point")
    if x.device.type == "cpu":
        return _nn_dist_ref(x.float(), y.float(), y_mask, chunk)
    return _launch(x, y, y_mask)


nn_dist_one_way.launches = 0


def nn_dist_stats(x: torch.Tensor, y: torch.Tensor, y_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, int, float]:
    """One launch of K4 on CUDA tensors that also counts (measurement only):
    (the distances, the (N,) direct forms formed for each x over all splits,
    the number of splits, the largest |candidate - direct| over the
    re-checked pairs as a share of the summation model's bound)."""
    counts = torch.zeros(x.shape[0] + 2, dtype=torch.int32, device=x.device)
    out = _launch(x, y, y_mask, counts)
    worst = float(counts[-1:].view(torch.float32).item())
    return out, counts[:-2], int(counts[-2].item()), worst


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


def chamfer_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The differentiable symmetric chamfer loss of JAX's ``chamfer_loss``:
    mean_i min_j |x_i - y_j|^2 + mean_j min_i |x_i - y_j|^2 over (..., N, 3)
    and (..., M, 3), one value per leading index. Its gradient is JAX's: the
    expansion clamped by ``torch.maximum`` (half the gradient where a
    distance is exactly 0) and the minimum by ``amin`` (the gradient split
    evenly over tied minima). Plain PyTorch on every device."""
    x2 = (x * x).sum(dim=-1)[..., :, None]
    y2 = (y * y).sum(dim=-1)[..., None, :]
    xy = (x[..., :, None, :] * y[..., None, :, :]).sum(dim=-1)
    d = torch.maximum(x2 + y2 - 2.0 * xy, torch.zeros((), dtype=x.dtype, device=x.device))
    return d.amin(dim=-1).mean(dim=-1) + d.amin(dim=-2).mean(dim=-1)
