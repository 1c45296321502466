"""Approximate Earth Mover's Distance by auction assignment, in plain PyTorch.

Counterpart of ``lidar_layout_tpu/ops/emd.py`` (which has no Pallas kernel):
Bertsekas' auction with epsilon scaling, each Jacobi round vectorised (top-2
benefits, scatter-max bid resolution), 4 phases x ``iters // 4`` rounds as a
Python loop. The object-owner array is the only state besides the prices;
points left unassigned fall back to their nearest neighbour.

Ties go the JAX package's way: ``lax.top_k`` puts the lower index first, and
so does ``torch.argmax``, so the top two are the argmax and the max of the
rest; the scatters are max / min, which do not depend on order. The auction
is chaotic (one flipped near-tie bid changes every later round), so the
distance matrix is rounded as the compiled JAX program rounds it, and
the same on every device: see ``_sq_dists``.

The (N, N) distance matrix is held whole: 17 GB at N = 65,536, so callers
cut clouds to a few thousand points.
"""
from __future__ import annotations

import numpy as np
import torch

BIG = 1e10
EPS_PHASES = (50.0, 10.0, 2.0, 1.0)  # epsilon-scaling multipliers


def _sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(N, 3), (M, 3) f32 -> (N, M) f32 squared distances, summed as
    fma(dz, dz, fma(dy, dy, dx * dx)), the form XLA compiles the JAX
    package's sum to. Each fma is done in float64, where the product of two
    f32 values is exact, and rounded to f32: the same bits on the CPU and
    the card, whatever each fuses on its own."""
    diff = (x[:, None, :] - y[None, :, :]).double()
    d = (diff[..., 0] * diff[..., 0]).float()
    d = (diff[..., 1] * diff[..., 1] + d.double()).float()
    return (diff[..., 2] * diff[..., 2] + d.double()).float()


def _derive_assign(owner: torch.Tensor, ar: torch.Tensor) -> torch.Tensor:
    """assign[i] = the object bidder i owns, or -1."""
    n = owner.shape[0]
    own = owner >= 0
    return torch.full((n,), -1, dtype=torch.int32, device=owner.device).scatter_reduce(
        0, torch.where(own, owner, n - 1).long(), torch.where(own, ar, -1),
        reduce="amax", include_self=True)


def auction_match(x: torch.Tensor, y: torch.Tensor, eps: float = 0.005,
                  iters: int = 200) -> torch.Tensor:
    """(N, D) vs (N, D) -> (N,) int64 mapping each x to a (mostly) distinct y."""
    n = x.shape[0]
    dev = x.device
    x, y = x.float(), y.float()
    d = _sq_dists(x, y)                                          # (N, N)
    ar = torch.arange(n, dtype=torch.int32, device=dev)
    rows = torch.arange(n, device=dev)
    neg_big = torch.tensor(-BIG, dtype=torch.float32, device=dev)
    prices = torch.zeros((n,), dtype=torch.float32, device=dev)
    owner = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for scale in EPS_PHASES:
        eps_k = float(np.float32(eps) * np.float32(scale))   # in f32, as JAX traces it
        owner = torch.full((n,), -1, dtype=torch.int32, device=dev)  # re-match
        for _ in range(max(iters // len(EPS_PHASES), 1)):
            unassigned = _derive_assign(owner, ar) < 0
            benefit = -d - prices[None, :]
            best_y = benefit.argmax(dim=1)
            top1 = benefit[rows, best_y]
            top2 = benefit.scatter(1, best_y[:, None], float("-inf")).amax(dim=1)
            bid = torch.where(unassigned, top1 - top2 + eps_k, neg_big)

            best_bid = torch.full((n,), -BIG, dtype=torch.float32, device=dev).scatter_reduce(
                0, best_y, bid, reduce="amax", include_self=True)   # per object
            won = unassigned & (bid >= best_bid[best_y]) & (bid > -BIG)
            # ties go to the lowest bidder index
            winner = torch.full((n,), n, dtype=torch.int32, device=dev).scatter_reduce(
                0, torch.where(won, best_y, n - 1), torch.where(won, ar, n),
                reduce="amin", include_self=True)
            got_bid = winner < n
            owner = torch.where(got_bid, winner.clamp(0, n - 1), owner)
            prices = prices + torch.where(got_bid, best_bid, 0.0)
    assign = _derive_assign(owner, ar).long()
    return torch.where(assign >= 0, assign, d.argmin(dim=-1))


def emd_distance(x: torch.Tensor, y: torch.Tensor, eps: float = 0.005,
                 iters: int = 200) -> torch.Tensor:
    """The reference wrapper's semantics: cut both clouds to a multiple of
    1024 points, match, return the mean distance of the matched pairs."""
    n = min(x.shape[0], y.shape[0])
    n = n - n % 1024 or min(x.shape[0], y.shape[0])
    x, y = x[:n].float(), y[:n].float()
    assign = auction_match(x, y, eps, iters)
    return ((x - y[assign]) ** 2).sum(dim=-1).sqrt().mean()
