"""Collective helpers over torch.distributed.

Counterpart of ``lidar_layout_tpu/parallel/collectives.py`` (the pointcept
``utils/comm.py`` surface). Where JAX reduces inside one SPMD program, each
rank here is a process and the reductions are NCCL (CUDA) or gloo (CPU)
calls over a process group (``None``: the default group, every rank).
Without an initialised process group every helper is the one-process
identity, so the trainers call them unconditionally.

``all_reduce_grads`` is the counterpart of the gradient all-reduce that XLA
inserts into JAX's jitted step: ``diffusion_trainer.Optimizer.step`` calls
it on every step's gradients, whichever way they were taken (``backward``
or ``torch.autograd.grad``, which ``DistributedDataParallel``'s reducer
never sees). ``global_denominator`` makes a masked mean the global sum over
the global count; ``rank_rows`` gives each rank its rows of a draw made at
the global batch's size, so that a sharded run draws what one process
would.

The spatial (``sp``) axis: ``spatial_plan`` is the W-shard plan of the
enclosing ``with plan:`` block (``mesh.spatial_sharding``), which the
modules that cross the azimuth consult; ``halo_exchange`` is the circular
ring of a W-sharded conv's edge columns, ``all_gather_along`` the K and V
of a sharded attention level, and ``all_reduce_group_stats`` the merge of
GroupNorm's per-shard statistics. A CUDA tensor under gloo goes through
the host in each (gloo moves host tensors only: ranks sharing one card).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

BUCKET_BYTES = 64 << 20   # gradients flattened into all-reduces of at most this size


def _active() -> bool:
    """A process group exists: the collectives run over the group they are
    given, at world size 1 too (a one-card run under ``torchrun`` goes
    through NCCL as a larger one does)."""
    return dist.is_available() and dist.is_initialized()


def get_world_size(group=None) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def get_rank(group=None) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_rank(group)


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize(group=None) -> None:
    """A barrier across the ranks (comm.synchronize)."""
    if _active():
        dist.barrier(group)


def _via_host(x: torch.Tensor, group=None) -> bool:
    """Whether ``x`` travels through the host: a CUDA tensor under gloo,
    which moves host tensors only (the rehearsal of several ranks on one
    card). Raises for a tensor that the group's backend cannot move."""
    backend = dist.get_backend(group)
    if backend == "nccl" and not x.is_cuda:
        raise ValueError(f"NCCL moves CUDA tensors only, got one on {x.device}")
    if backend == "gloo" and x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gloo cannot move a tensor on {x.device}")
    return x.is_cuda and backend == "gloo"


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` stacked along a new leading axis of ranks
    (``jax.lax.all_gather``); ``x[None]`` in one process."""
    if not _active():
        return x[None]
    host = _via_host(x, group)
    src = x.detach().to("cpu" if host else x.device).reshape(-1).clone()
    world = get_world_size(group)
    out = torch.empty((world, x.numel()), dtype=x.dtype, device=src.device)
    with torch.no_grad():
        dist.all_gather(list(out.unbind()), src, group=group)
    out = out.view(world, *x.shape)
    return out.to(x.device) if host else out


def reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the ranks (``jax.lax.pmean``), a new tensor."""
    y = x.detach().clone()
    if _active():
        dist.all_reduce(y, group=group)
        y /= get_world_size(group)
    return y


def reduce_dict(d: Dict[str, Any], group=None, average: bool = True) -> Dict[str, torch.Tensor]:
    """comm.reduce_dict: the scalars of ``d`` summed, or averaged, over the
    ranks in one all-reduce, as float64 0-d tensors (a Python float keeps
    its value) on the device the backend reduces on (the current card for
    NCCL, else the CPU)."""
    keys = sorted(d)
    if not keys:
        return {}
    dev = (torch.device("cuda", torch.cuda.current_device())
           if _active() and dist.get_backend(group) == "nccl" else torch.device("cpu"))
    vals = torch.stack([torch.as_tensor(d[k], dtype=torch.float64, device=dev).detach().reshape(())
                        for k in keys])
    if _active():
        dist.all_reduce(vals, group=group)
        if average:
            vals /= get_world_size(group)
    return dict(zip(keys, vals.unbind()))


def host_all_gather(x: np.ndarray, group=None) -> np.ndarray:
    """Every rank's numpy array stacked along a leading axis of ranks,
    through the host (comm.all_gather's pickle path); ``x[None]`` in one
    process."""
    x = np.asarray(x)
    if not _active():
        return x[None]
    out: List[Any] = [None] * get_world_size(group)
    dist.all_gather_object(out, x, group=group)
    return np.stack(out)


def all_reduce_grads(grads: List[Optional[torch.Tensor]], group=None) -> None:
    """Average ``grads`` over the ranks in place: flattened into buckets of
    one dtype and device, one all-reduce (sum) a bucket, then divided by the
    world size. ``None`` entries and DTensors (whose gradients FSDP has
    already reduced) are left as they are."""
    if not _active():
        return
    from torch.distributed.tensor import DTensor

    world = float(get_world_size(group))
    buckets: Dict[Any, List[List[torch.Tensor]]] = {}   # (dtype, device) -> runs
    filled: Dict[Any, int] = {}   # bytes in each key's last run
    for g in grads:
        if g is None or isinstance(g, DTensor):
            continue
        key, size = (g.dtype, g.device), g.numel() * g.element_size()
        runs = buckets.setdefault(key, [[]])
        if runs[-1] and filled[key] + size > BUCKET_BYTES:
            runs.append([])
            filled[key] = 0
        runs[-1].append(g)
        filled[key] = filled.get(key, 0) + size
    for runs in buckets.values():
        for run in runs:
            flat = torch.cat([t.reshape(-1) for t in run])
            dist.all_reduce(flat, group=group)
            flat /= world
            torch._foreach_copy_(run, [f.view_as(t) for f, t in
                                       zip(flat.split([t.numel() for t in run]), run)])


def global_denominator(count: torch.Tensor, minimum: float = 1.0) -> torch.Tensor:
    """The denominator that turns a rank's masked sum into its share of the
    global masked mean: ``max(global count, minimum) / world``. Each rank's
    ``sum / global_denominator(count)`` averages over the ranks (as the
    gradients do) to ``global sum / global count``, whatever each rank's own
    count; in one process it is ``max(count, minimum)``. The count carries
    no gradient."""
    n = count.detach().clone()
    if not _active():
        return torch.clamp(n, min=minimum)
    n = n.to(torch.float32)
    dist.all_reduce(n)
    n = torch.clamp(n, min=minimum) / get_world_size()
    return n.to(count.dtype) if count.is_floating_point() else n


def rank_rows(draw: Callable[[int], torch.Tensor], rows: int) -> torch.Tensor:
    """This rank's ``rows`` rows of ``draw(rows * world)``: a draw made at the
    global batch's size, so that every rank draws from the same generator
    what one process drawing the whole batch would, and keeps its slice
    (ranks in order). ``draw(rows)`` in one process."""
    world = get_world_size()
    if world == 1:
        return draw(rows)
    r = get_rank()
    return draw(rows * world)[r * rows:(r + 1) * rows]


# ----------------------------------------------------------- the sp axis
_SPATIAL: List[Any] = []   # the plans of the enclosing ``with plan:`` blocks


def spatial_plan():
    """The W-shard plan (``mesh.SpatialPlan``) of the innermost ``with
    plan:`` block, or None outside one."""
    return _SPATIAL[-1] if _SPATIAL else None


def halo_exchange(x: torch.Tensor, left: int, right: int, group=None,
                  wrap: bool = True) -> torch.Tensor:
    """``x`` (..., W), a W shard, with ``left`` columns of its left
    neighbour's end before it and ``right`` of its right neighbour's start
    after it: the ring of the ranks of ``group`` in order, the last shard's
    right neighbour the first (a circular pad of the whole width). Without
    ``wrap`` the first shard's left halo and the last shard's right halo are
    zeros (a zero pad). One ``batch_isend_irecv`` of the edge columns."""
    w = x.shape[-1]
    if left > w or right > w:
        raise ValueError(f"a halo of ({left}, {right}) columns is wider than the shard's {w}")
    n, i = get_world_size(group), get_rank(group)
    if n == 1:
        halos = [x[..., w - left:], x[..., :right]]
    else:
        host = _via_host(x, group)
        dev = torch.device("cpu") if host else x.device

        def peer(r):
            return dist.get_global_rank(group, r % n) if group is not None else r % n

        halos = [x.new_empty((*x.shape[:-1], c), device=dev) for c in (left, right)]
        sends, recvs = [], []
        # the same pair may be both neighbours (two shards): sends and
        # receives are listed in one order on every rank, and tagged
        for tag, (edge, to, buf, frm) in enumerate(((x[..., w - left:], i + 1, halos[0], i - 1),
                                                     (x[..., :right], i - 1, halos[1], i + 1))):
            if buf.shape[-1]:
                sends.append(dist.P2POp(dist.isend, edge.to(dev).contiguous(), peer(to), group,
                                        tag))
                recvs.append(dist.P2POp(dist.irecv, buf, peer(frm), group, tag))
        if sends:
            for req in dist.batch_isend_irecv(sends + recvs):
                req.wait()
        halos = [h.to(x.device) for h in halos]
    if not wrap:
        if i == 0:
            halos[0] = torch.zeros_like(halos[0])
        if i == n - 1:
            halos[1] = torch.zeros_like(halos[1])
    return torch.cat([halos[0], x, halos[1]], dim=-1)


def all_gather_along(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in rank
    order: the keys and values of every position of a W-sharded level."""
    return torch.cat(all_gather(x, group).unbind(0), dim=dim)


def merge_shard_stats(parts: torch.Tensor, count: int) -> torch.Tensor:
    """Chan's merge of shards of equal size: ``parts`` (n, ..., 2) holds each
    shard's (mean, M2) over ``count`` elements; returns (..., 2), the
    (mean, M2) over all n * count: the mean of the means, and M2 = sum M2_r
    + count * sum (mean_r - mean)^2, summed over the shards in order."""
    means, m2s = parts[..., 0], parts[..., 1]
    mean = means.sum(0) / parts.shape[0]
    m2 = m2s.sum(0) + count * (means - mean).square().sum(0)
    return torch.stack([mean, m2], dim=-1)


def all_reduce_group_stats(stats: torch.Tensor, count: int, group=None) -> torch.Tensor:
    """GroupNorm's statistics over the whole width from each shard's
    (``stats`` (..., 2): the shard's (mean, M2) over ``count`` elements a
    group): gathered over ``group`` and merged (``merge_shard_stats``) in
    rank order, so every rank holds the same bits."""
    return merge_shard_stats(all_gather(stats, group), count)
