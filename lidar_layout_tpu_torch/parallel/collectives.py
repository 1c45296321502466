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


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` stacked along a new leading axis of ranks
    (``jax.lax.all_gather``); ``x[None]`` in one process."""
    if not _active():
        return x[None]
    # gloo gathers host tensors only: a CUDA tensor under gloo (the
    # rehearsal of several ranks on one card) goes through the host
    host = x.is_cuda and dist.get_backend(group) == "gloo"
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
