"""Fixed-capacity sparse voxel grids, batched over a leading cloud dimension.

Counterpart of ``lidar_layout_tpu/ops/voxel.py`` (``VoxelGrid``,
``build_grid``, ``lookup``, ``count_unique``, ``gather_neighbors``,
``pool_to_parent``, ``subdivide``, ``occupancy_targets``,
``voxelize_points``). A grid holds ``capacity`` rows per cloud: voxel coords,
z-order codes sorted ascending with padding rows at ``PAD_CODE``, and an
occupancy mask. A neighbour lookup is a binary search of the codes
(``torch.searchsorted``, batched over clouds), and a sparse convolution is a
gather of neighbour rows followed by one matmul.

Each cloud's result equals the JAX function's on that cloud alone, integer
for integer, including what the JAX package does at its limits:
- codes clip coords to ``[0, 2**bits)`` (``ops/serialization``), so voxels
  past that range share codes and merge;
- segments past ``capacity`` merge into row ``capacity - 1``, whose code is
  their least and whose coords their greatest (``count_unique`` finds the
  true count);
- ``lookup`` misses any query outside ``[0, 2**bits)``.

Scatter-adds index a flat (B * capacity) row space with ``b * capacity + i``;
scatter-min/max are ``scatter_reduce`` with ``amin``/``amax``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .serialization import z_order_code

PAD_CODE = torch.iinfo(torch.int32).max

# (dx, dy, dz), dx slowest: ops/voxel.OFFSETS_27's order
OFFSETS_27 = torch.tensor([[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                           for dz in (-1, 0, 1)], dtype=torch.int32)
_CHILD_OFFSETS = torch.tensor([[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)],
                              dtype=torch.int32)


class VoxelGrid(NamedTuple):
    coords: torch.Tensor   # (B, cap, 3) int32, valid rows sorted by code
    codes: torch.Tensor    # (B, cap) int32, padding rows PAD_CODE
    mask: torch.Tensor     # (B, cap) bool


def flat_index(idx: torch.Tensor, rows: int) -> torch.Tensor:
    """(B, ...) per-cloud row indices -> indices into the flat (B * rows) rows."""
    b = idx.shape[0]
    offset = torch.arange(b, device=idx.device) * rows
    return idx + offset.view(b, *([1] * (idx.dim() - 1)))


def gather_rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, cap, C) rows at (B, ...) indices -> (B, ..., C)."""
    b, cap, c = feats.shape
    out = feats.reshape(b * cap, c).index_select(0, flat_index(idx, cap).reshape(-1))
    return out.view(*idx.shape, c)


def scatter_sum(idx: torch.Tensor, values: torch.Tensor, rows: int) -> torch.Tensor:
    """(B, N) row indices, (B, N, ...) values -> (B, rows, ...) sums (JAX's
    ``zeros.at[idx].add(values)`` per cloud)."""
    b, n = idx.shape
    tail = values.shape[2:]
    out = torch.zeros((b * rows, *tail), dtype=values.dtype, device=values.device)
    out.index_add_(0, flat_index(idx, rows).reshape(-1), values.reshape(b * n, *tail))
    return out.view(b, rows, *tail)


def scatter_mean(idx: torch.Tensor, feats: torch.Tensor, weight: torch.Tensor,
                 rows: int) -> torch.Tensor:
    """Weighted mean of (B, N, C) feats into (B, rows, C) rows, 0 where a row
    has no weight (``num / max(den, 1)``)."""
    num = scatter_sum(idx, feats * weight[..., None], rows)
    den = scatter_sum(idx, weight, rows)
    return num / den.clamp(min=1.0)[..., None]


def build_grid(coords: torch.Tensor, mask: torch.Tensor, capacity: int,
               bits: int = 10) -> Tuple[VoxelGrid, torch.Tensor]:
    """Deduplicate (B, N, 3) integer coords into sorted grids of ``capacity``
    rows. Returns (grid, point_to_voxel (B, N) int64)."""
    b = coords.shape[0]
    codes = z_order_code(coords, bits)
    keyed = torch.where(mask, codes, PAD_CODE)
    order = torch.argsort(keyed, dim=1, stable=True)
    sc = keyed.gather(1, order)
    sm = mask.gather(1, order)
    head = torch.ones_like(sm)
    head[:, 1:] = sc[:, 1:] != sc[:, :-1]
    head &= sm
    seg = (head.long().cumsum(1) - 1).clamp(0, capacity - 1)

    n_seg = torch.where(sm.any(dim=1), seg[:, -1] + 1, 0)
    vmask = torch.arange(capacity, device=coords.device) < n_seg[:, None]
    vcodes = torch.full((b, capacity), PAD_CODE, dtype=torch.int32, device=coords.device)
    vcodes = vcodes.scatter_reduce(1, seg, torch.where(sm, sc, PAD_CODE), "amin")
    sorted_coords = coords.to(torch.int32).gather(1, order[..., None].expand(-1, -1, 3))
    vcoords = torch.zeros((b, capacity, 3), dtype=torch.int32, device=coords.device)
    vcoords = vcoords.scatter_reduce(1, seg[..., None].expand(-1, -1, 3),
                                     torch.where(sm[..., None], sorted_coords, 0), "amax")
    p2v = torch.empty_like(seg).scatter_(1, order, seg)
    return VoxelGrid(vcoords, vcodes, vmask), p2v


def lookup(grid: VoxelGrid, query: torch.Tensor, bits: int = 10
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row of each (B, M, 3) query coord in its cloud's grid: (idx (B, M)
    int64, hit (B, M)). A query outside ``[0, 2**bits)`` misses (the code
    clips it, so it would alias onto a voxel at the border)."""
    q = z_order_code(query, bits)
    idx = torch.searchsorted(grid.codes, q.contiguous())
    idx = idx.clamp(0, grid.codes.shape[1] - 1)
    in_range = ((query >= 0) & (query < (1 << bits))).all(dim=-1)
    hit = ((grid.codes.gather(1, idx) == q) & grid.mask.gather(1, idx) & (q != PAD_CODE)
           & in_range)
    return idx, hit


def neighbor_table(grid: VoxelGrid, offsets: torch.Tensor, bits: int = 10
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows of every voxel's neighbours at (K, 3) ``offsets``: (idx, hit),
    each (B, cap, K). Built once, it serves every convolution on the grid."""
    b, cap, _ = grid.coords.shape
    offs = offsets.to(device=grid.coords.device, dtype=torch.int32)
    q = grid.coords[:, :, None, :] + offs[None, None]
    idx, hit = lookup(grid, q.reshape(b, cap * len(offs), 3), bits)
    return idx.view(b, cap, len(offs)), hit.view(b, cap, len(offs))


def gather_table(feats: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """(B, cap, C) feats at a (B, R, K) table -> (B, R, K, C), 0 where not ok."""
    return torch.where(ok[..., None], gather_rows(feats, idx), 0.0)


def count_unique(coords: torch.Tensor, mask: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """(B,) number of distinct occupied codes of each cloud, not capped."""
    keyed = torch.where(mask, z_order_code(coords, bits), PAD_CODE)
    sc = torch.sort(keyed, dim=1).values
    head = torch.ones_like(sc, dtype=torch.bool)
    head[:, 1:] = sc[:, 1:] != sc[:, :-1]
    return (head & (sc != PAD_CODE)).sum(dim=1)


def gather_neighbors(grid: VoxelGrid, feats: torch.Tensor, bits: int = 10,
                     offsets: torch.Tensor = OFFSETS_27) -> torch.Tensor:
    """(B, cap, C) feats -> (B, cap, K, C) neighbour features, 0 where missing."""
    return gather_table(feats, *neighbor_table(grid, offsets, bits))


def pool_to_parent(grid: VoxelGrid, feats: torch.Tensor, capacity: int, bits: int = 10,
                   reduce: str = "mean") -> Tuple[VoxelGrid, torch.Tensor, torch.Tensor]:
    """Coarsen by 2. Returns (parent grid, parent feats (B, capacity, C),
    child_to_parent (B, cap_c))."""
    pgrid, c2p = build_grid(grid.coords >> 1, grid.mask, capacity, bits)
    w = grid.mask.to(feats.dtype)
    if reduce == "mean":
        pfeats = scatter_mean(c2p, feats, w, capacity)
    else:
        pfeats = scatter_sum(c2p, feats * w[..., None], capacity)
    return pgrid, pfeats * pgrid.mask[..., None], c2p


def subdivide(grid: VoxelGrid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each parent voxel's 8 child coords: (child_coords (B, cap_p * 8, 3),
    parent_index (cap_p * 8,)). Validity follows the parent mask."""
    b, cap_p, _ = grid.coords.shape
    child = (grid.coords[:, :, None, :] << 1) + _CHILD_OFFSETS.to(grid.coords.device)
    parent_idx = torch.arange(cap_p, device=grid.coords.device).repeat_interleave(8)
    return child.reshape(b, cap_p * 8, 3), parent_idx


def occupancy_targets(parent: VoxelGrid, child: VoxelGrid, bits: int = 10) -> torch.Tensor:
    """(B, cap_p, 8) f32: which children of each parent the child grid holds."""
    child_coords, _ = subdivide(parent)
    _, hit = lookup(child, child_coords, bits)
    b, cap_p = parent.mask.shape
    return hit.view(b, cap_p, 8).float() * parent.mask[..., None]


def voxelize_points(points: torch.Tensor, mask: torch.Tensor, voxel_size: float,
                    capacity: int, origin: Optional[torch.Tensor] = None, bits: int = 10
                    ) -> Tuple[VoxelGrid, torch.Tensor, torch.Tensor]:
    """(B, N, 3) points -> the finest grid. Returns (grid, point_to_voxel,
    clipped grid coords). ``origin`` defaults to each cloud's minimum corner
    over its masked points."""
    if origin is None:
        origin = torch.where(mask[..., None], points, float("inf")).amin(dim=1)
    size = torch.tensor(voxel_size, dtype=points.dtype, device=points.device)
    g = torch.floor((points - origin[:, None, :]) / size).to(torch.int32)
    g = g.clamp(0, (1 << bits) - 1)
    grid, p2v = build_grid(g, mask, capacity, bits)
    return grid, p2v, g
