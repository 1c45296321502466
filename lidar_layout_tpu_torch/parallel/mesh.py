"""Process groups, the device mesh and parameter sharding.

Counterpart of ``lidar_layout_tpu/parallel/mesh.py``. JAX runs one program
over a ``Mesh`` and lets XLA place the transfers; here one process runs on
each device, as ``torchrun --nproc-per-node N`` starts them, and the mesh is
a ``DeviceMesh`` over those processes.

Axes, as JAX's:
  dp    data parallel: the batch is cut over every rank (``local_batch_slice``),
        the parameters are replicated (``replicate``) and the gradients
        averaged (``collectives.all_reduce_grads``).
  fsdp  ZeRO-style parameter sharding (``fsdp_param_sharding``) through
        FSDP2's ``fully_shard``; the batch is cut over it too, as JAX's
        ``batch_sharding`` folds it into dp.

  sp    the range image's azimuth (W) cut over ranks (``spatial_sharding``):
        a ``with plan:`` block around the forward makes the same model code
        run on this rank's columns. Where GSPMD writes JAX's collectives,
        the modules write their own: the circular convs' halo ring
        (``nn/conv``), GroupNorm's statistics merged across shards around a
        split K3 (``nn/blocks.Normalize``), and the keys and values of an
        attention level gathered for a cross-length K1 (``models/unet``) or
        the plain attention (``nn/blocks.AttnBlock``). Forward only: JAX
        shards the first-stage encode and the denoiser so, and nothing else.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from . import collectives as C
from .collectives import all_gather_along, get_rank, get_world_size

FSDP_MIN_SIZE = 2 ** 16   # JAX's rule: a parameter this large or larger is sharded


def init_from_env(device: Union[str, torch.device] = "cuda", backend: Optional[str] = None,
                  init_method: Optional[str] = None) -> torch.device:
    """Join the process group and return this rank's device.

    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``
    come from the environment as ``torchrun`` sets them; ``init_method`` (a
    ``file://`` store in the tests) takes the place of ``MASTER_*``. Without
    ``RANK`` no group is made and ``device`` is returned: the one-process
    run. On CUDA the rank's card (``LOCAL_RANK``) becomes the
    current device before anything else, and the backend is NCCL; on the CPU
    it is gloo. A CUDA run whose NCCL init fails raises. ``backend="gloo"``
    on CUDA is the rehearsal of several ranks on one card: ranks past the
    card count share the cards, and the log says so."""
    dev = torch.device(device)
    if dist.is_available() and dist.is_initialized():   # joined already (a test's ranks)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if "RANK" not in os.environ:
        return dev
    rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        n_cards = torch.cuda.device_count()
        backend = backend or "nccl"
        if local_rank >= n_cards:
            if backend != "gloo":
                raise RuntimeError(f"local rank {local_rank} has no card of its own "
                                   f"({n_cards} visible); NCCL takes one card a rank")
            if local_rank == n_cards:
                cards = "one device" if n_cards == 1 else f"{n_cards} devices"
                print(f"rehearsal: {world_size} ranks share {cards} (gloo)", flush=True)
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
    else:
        backend = backend or "gloo"
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend=backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size, **kw)
    return dev


def seed_rank(seed: int, device: torch.device) -> None:
    """Seed the default generator of ``device`` with ``seed + rank``: the
    draws that no step generator feeds (dropout) differ between ranks."""
    s = seed + get_rank()
    if device.type == "cuda":
        torch.cuda.manual_seed(s)
    else:
        torch.manual_seed(s)


def make_mesh(fsdp: int = 1, sp: int = 1, device_type: Optional[str] = None):
    """A DeviceMesh over every rank, of ``device_type`` (default: "cuda"
    under NCCL, else "cpu"): ``("dp", "fsdp", "sp")`` (world / (fsdp * sp)
    by fsdp by sp) when sp > 1, else ``("dp", "fsdp")``, as JAX's."""
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    n = get_world_size()
    assert n % (fsdp * sp) == 0, f"{n} ranks not divisible by fsdp={fsdp} * sp={sp}"
    if sp > 1:
        return init_device_mesh(device_type, (n // (fsdp * sp), fsdp, sp),
                                mesh_dim_names=("dp", "fsdp", "sp"))
    return init_device_mesh(device_type, (n // fsdp, fsdp), mesh_dim_names=("dp", "fsdp"))


def local_batch_slice(global_batch: int) -> slice:
    """This rank's rows of a global batch. The batch must divide evenly: a
    mean over a rank's rows averaged with the other ranks' is the global
    mean only when every rank holds as many rows."""
    n = get_world_size()
    assert global_batch % n == 0, f"global batch {global_batch} not divisible by {n} ranks"
    per = global_batch // n
    i = get_rank()
    return slice(i * per, (i + 1) * per)


def shard_batch(batch, global_batch: int):
    """This rank's rows (``local_batch_slice``) of every array of a batch
    whose leading axis is the global batch, in nested dicts; other values
    are kept as they are."""
    sl = local_batch_slice(global_batch)
    if isinstance(batch, dict):
        return {k: shard_batch(v, global_batch) for k, v in batch.items()}
    if hasattr(batch, "shape") and len(batch.shape) and batch.shape[0] == global_batch:
        return batch[sl]
    return batch


TRIPLE_KEYS = ("enc_triples", "enc_rel_feat", "enc_pred_mask", "dec_triples", "dec_rel_feat",
               "dec_pred_mask")


def shard_scene_graph(graph: Dict) -> Dict:
    """This rank's whole scenes of a batch of scene graphs
    (``data/layout_synthetic``, ``data/nuscenes_layout``): every scene
    holds as many object rows and triple rows (padded), so a rank takes its
    contiguous block of each axis; its triples' object indices,
    ``enc_to_dec`` and ``dec_objs_to_scene`` are rebased to its own rows
    (a padding triple, masked, points at its first object). JAX cuts the
    flat axes over dp and gathers across shards; whole scenes keep every
    gather inside a rank."""
    n_scenes = int(graph["n_scenes"])
    sl = local_batch_slice(n_scenes)
    n_obj, n_tri = len(graph["dec_objs"]), len(graph["dec_triples"])
    per_obj, per_tri = n_obj // n_scenes, n_tri // n_scenes
    o0, t0 = sl.start * per_obj, sl.start * per_tri
    out = {}
    for k, v in graph.items():
        if k == "n_scenes":
            out[k] = sl.stop - sl.start
        elif k in TRIPLE_KEYS:
            out[k] = v[t0:sl.stop * per_tri]
        else:
            out[k] = v[o0:sl.stop * per_obj]
    to_scene = np.asarray(out["dec_objs_to_scene"])
    if not ((to_scene >= sl.start) & (to_scene < sl.stop)).all():
        raise ValueError("shard_scene_graph: scenes are not padded to equal blocks")
    out["dec_objs_to_scene"] = to_scene - sl.start
    for key, mask_key in (("enc_triples", "enc_pred_mask"), ("dec_triples", "dec_pred_mask")):
        tri = np.array(out[key])
        live = np.asarray(out[mask_key], bool) if mask_key in out else np.ones(len(tri), bool)
        tri[:, [0, 2]] = np.where(live[:, None], tri[:, [0, 2]] - o0, 0)
        out[key] = tri
    e2d = np.asarray(out["enc_to_dec"])
    out["enc_to_dec"] = np.where(e2d >= 0, e2d - o0, e2d)
    return out


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer broadcast from rank 0, in place."""
    if get_world_size() > 1:
        for t in (*module.parameters(), *module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


def fsdp_param_sharding(mesh, module: torch.nn.Module) -> Dict[str, Optional[int]]:
    """JAX's ZeRO-3 rule as {parameter name: the axis sharded over "fsdp",
    or None when replicated}: a parameter of at least 2**16 elements is
    sharded along its largest axis when that axis divides by the fsdp size;
    every other parameter stays replicated. Of equal axes the last is taken:
    a flax kernel (HWIO, in-out) lists a torch weight's (OIHW, out-in) axes
    in reverse, and JAX takes the first of its own."""
    n_shard = mesh["fsdp"].size()
    spec: Dict[str, Optional[int]] = {}
    for name, p in module.named_parameters():
        ax = max(range(p.ndim), key=lambda i: (p.shape[i], i)) if p.ndim else None
        spec[name] = (ax if ax is not None and p.numel() >= FSDP_MIN_SIZE
                      and p.shape[ax] % n_shard == 0 else None)
    return spec


def fully_shard_module(mesh, module: torch.nn.Module) -> Dict[str, Optional[int]]:
    """Apply ``fsdp_param_sharding`` to ``module`` through FSDP2: the sharded
    parameters become DTensors, replicated over "dp" and sharded over
    "fsdp" along their axis (their gradients reduced by FSDP); the others
    stay plain tensors outside FSDP (``ignored_params``), their gradients
    averaged by ``collectives.all_reduce_grads``. Returns the spec."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    spec = fsdp_param_sharding(mesh, module)
    by_param = {p: spec[n] for n, p in module.named_parameters()}
    ignored = {p for p, ax in by_param.items() if ax is None}
    fully_shard(module, mesh=mesh, shard_placement_fn=lambda p: Shard(by_param[p]),
                ignored_params=ignored, reshard_after_forward=False)
    return spec


@dataclasses.dataclass
class SpatialPlan:
    """This rank's share of a W-sharded tensor (``spatial_sharding``): JAX's
    ``P(batch_axes, None, "sp", None)`` on NHWC, the batch rows over dp and
    fsdp and the columns over sp. ``with plan:`` makes it the region that
    ``collectives.spatial_plan`` returns (when sp > 1)."""

    sp: int                 # shards of the width
    index: int              # this rank's shard of the width
    group: Any              # the sp process group (None when sp == 1)
    batch: int              # shards of the batch (dp * fsdp)
    batch_index: int        # this rank's shard of the batch
    batch_group: Any        # the group over the batch axes (None when batch == 1)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's batch rows (dim 0) of a whole tensor (the timesteps)."""
        rows = x.shape[0] // self.batch
        if rows * self.batch != x.shape[0]:
            raise ValueError(f"a batch of {x.shape[0]} does not split into {self.batch} shards")
        return x[self.batch_index * rows:(self.batch_index + 1) * rows]

    def shard(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's batch rows (dim 0) and columns (``dim``: -1 for NCHW,
        2 for NHWC) of a whole tensor."""
        cols = x.shape[dim] // self.sp
        if cols * self.sp != x.shape[dim]:
            raise ValueError(f"{tuple(x.shape)} does not split into {self.sp} shards of "
                             f"dim {dim}")
        return self.rows(x).narrow(dim, self.index * cols, cols)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The whole tensor from every rank's shard (``shard``'s inverse)."""
        if self.sp > 1:
            x = all_gather_along(x, dim, self.group)
        if self.batch > 1:
            x = all_gather_along(x, 0, self.batch_group)
        return x

    def __enter__(self) -> "SpatialPlan":
        if self.sp > 1:
            C._SPATIAL.append(self)
        return self

    def __exit__(self, *exc) -> None:
        if self.sp > 1:
            C._SPATIAL.remove(self)


def spatial_sharding(mesh) -> SpatialPlan:
    """This rank's W-shard plan on ``mesh`` (``make_mesh``): columns over
    its "sp" axis, batch rows over "dp" and "fsdp"; on a mesh without "sp"
    the batch rows alone, as JAX's ``spatial_sharding`` degrades to batch
    sharding. Every rank of the mesh calls it (it makes the batch groups)."""
    names = mesh.mesh_dim_names
    sp = mesh["sp"].size() if "sp" in names else 1
    grid = mesh.mesh.reshape(-1, sp)   # rows: the batch shards; columns: the sp shards
    me = get_rank()
    row, col = (int(v) for v in (grid == me).nonzero()[0])
    batch_group = None
    if grid.shape[0] > 1:
        for c in range(sp):   # every rank makes every group, in one order
            g = dist.new_group(grid[:, c].tolist())
            if c == col:
                batch_group = g
    return SpatialPlan(sp=sp, index=col, group=mesh.get_group("sp") if sp > 1 else None,
                       batch=grid.shape[0], batch_index=row, batch_group=batch_group)
