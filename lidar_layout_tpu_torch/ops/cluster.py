"""Connected components over sparse voxels (instance clustering).

Counterpart of ``lidar_layout_tpu/ops/cluster.py``
(``voxel_connected_components``, ``cluster_points``): min-label propagation
over the 27-stencil of a fixed-capacity voxel grid (``ops/voxel``), each
sweep taking the least label among a voxel's occupied neighbours, until no
label changes or ``max_iters`` sweeps ran. A padding row's label is the
capacity.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .voxel import OFFSETS_27, VoxelGrid, build_grid, neighbor_table


def voxel_connected_components(grid: VoxelGrid, bits: int = 10,
                               max_iters: int = 64) -> torch.Tensor:
    """(B, cap) component label a voxel: the least row index of its
    component; padding rows get ``cap``."""
    b, cap = grid.mask.shape
    rows = torch.arange(cap, device=grid.mask.device)
    labels = torch.where(grid.mask, rows, cap).expand(b, cap)
    idx, hit = neighbor_table(grid, OFFSETS_27, bits)
    nbrs = torch.where(hit, idx, cap)                     # (B, cap, 27)
    for _ in range(max_iters):
        padded = torch.cat([labels, labels.new_full((b, 1), cap)], dim=1)
        nb = padded.gather(1, nbrs.reshape(b, -1)).view(b, cap, -1)
        new = torch.where(grid.mask, torch.minimum(labels, nb.amin(dim=2)), cap)
        done = bool((new == labels).all())
        labels = new
        if done:
            break
    return labels


def cluster_points(points: torch.Tensor, mask: torch.Tensor, voxel_size: float = 0.3,
                   capacity: int = 8192, bits: int = 10
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voxelise one (N, 3) cloud from its least valid corner, then label the
    components: (per-point labels (N,), per-voxel labels (capacity,));
    invalid points get ``capacity``."""
    origin = torch.where(mask[:, None], points, torch.inf).amin(dim=0)
    size = torch.tensor(voxel_size, dtype=points.dtype, device=points.device)
    g = torch.floor((points - origin) / size).to(torch.int32).clamp(0, (1 << bits) - 1)
    grid, p2v = build_grid(g[None], mask[None], capacity, bits)
    vlabels = voxel_connected_components(grid, bits)[0]
    return torch.where(mask, vlabels[p2v[0]], capacity), vlabels
