"""Point-cloud operators: FPS, kNN, ball query, grouping, 3-NN interpolation.

Counterpart of ``lidar_layout_tpu/ops/pointops.py`` (the reference's
``pointops`` CUDA library rewritten there in plain XLA; no Pallas kernel), in
plain PyTorch. Each function takes one cloud, as JAX's, or a batch of clouds
with a leading dimension where the shapes below say ``(..., N, 3)``: the
object autoencoder runs its whole batch at once.

The squared distances are the expansion |x|^2 + |y|^2 - 2 x.y, clamped at 0,
with the product summed in f32 over the three coordinates (never TF32), the
counterpart of JAX's ``Precision.HIGHEST``. ``knn_query`` orders neighbours
by distance and ties by the lower index, as ``jax.lax.top_k``: a stable sort,
since ``torch.topk`` promises no order among ties.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

BIG = 1e10


def _sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(..., M, 3), (..., N, 3) -> (..., M, N) squared distances."""
    x2 = (x * x).sum(dim=-1)[..., :, None]
    y2 = (y * y).sum(dim=-1)[..., None, :]
    xy = (x[..., :, None, :] * y[..., None, :, :]).sum(dim=-1)
    return (x2 + y2 - 2.0 * xy).clamp_min(0.0)


def farthest_point_sample(points: torch.Tensor, n_samples: int,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, 3) -> (n_samples,) int64 indices by iterative FPS, starting at the
    first valid point; invalid points are never selected. The selected row
    is read with ``index_select``: indexing with a 0-d tensor would copy the
    index to the host, a synchronisation each iteration on the card."""
    n = points.shape[0]
    valid = mask if mask is not None else torch.ones(n, dtype=torch.bool, device=points.device)
    dist = torch.where(valid, BIG, -1.0).to(points.dtype)
    last = torch.argmax(valid.to(torch.int8)).view(1)
    idx = torch.zeros(n_samples, dtype=torch.long, device=points.device)
    idx[0] = last[0]
    for i in range(1, n_samples):
        d = ((points - points.index_select(0, last)) ** 2).sum(dim=-1)
        dist = torch.minimum(dist, torch.where(valid, d, -1.0))
        last = torch.argmax(dist).view(1)
        idx[i] = last[0]
    return idx


def knn_query(query: torch.Tensor, points: torch.Tensor, k: int,
              points_mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., M, 3) queries against (..., N, 3) points -> (..., M, k) int64
    indices and their squared distances, nearest first, ties by the lower
    index; masked points are ``BIG`` away."""
    d = _sq_dists(query, points)
    if points_mask is not None:
        d = torch.where(points_mask[..., None, :], d, BIG)
    d, idx = torch.sort(d, dim=-1, stable=True)
    return idx[..., :k], d[..., :k]


def ball_query(query: torch.Tensor, points: torch.Tensor, radius: float, k: int,
               points_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to k neighbours within ``radius``; a missing slot repeats the
    nearest neighbour. Returns (idx (..., M, k), inside (..., M, k))."""
    idx, d2 = knn_query(query, points, k, points_mask)
    inside = d2 <= radius * radius
    return torch.where(inside, idx, idx[..., :1]), inside


def _gather(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values (..., N, C) at idx (..., M, k) -> (..., M, k, C)."""
    if idx.ndim == 2:
        return values[idx]
    b = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
    return values[b, idx]


def group_points(points: torch.Tensor, feats: Optional[torch.Tensor], idx: torch.Tensor,
                 centers: torch.Tensor) -> torch.Tensor:
    """Gathered neighbourhoods less their centres, features appended:
    (..., M, k, 3 [+ C])."""
    grouped = _gather(points, idx) - centers[..., :, None, :]
    if feats is not None:
        grouped = torch.cat([grouped, _gather(feats, idx)], dim=-1)
    return grouped


def three_nn_interpolate(query: torch.Tensor, points: torch.Tensor, feats: torch.Tensor,
                         points_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-squared-distance weighted features of the 3 nearest points
    (fewer when the source has fewer): (..., M, C)."""
    idx, d2 = knn_query(query, points, min(3, points.shape[-2]), points_mask)
    w = 1.0 / d2.clamp_min(1e-8)
    w = w / w.sum(dim=-1, keepdim=True)
    return (w[..., None] * _gather(feats, idx)).sum(dim=-2)


def subtraction(query_feats: torch.Tensor, neighbor_feats: torch.Tensor) -> torch.Tensor:
    """Vector-attention subtraction: (M, C) - (M, k, C)."""
    return query_feats[..., :, None, :] - neighbor_feats


def aggregation(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted neighbourhood sum: (M, k, C) x (M, k, C | 1) -> (M, C)."""
    return (values * weights).sum(dim=-2)
