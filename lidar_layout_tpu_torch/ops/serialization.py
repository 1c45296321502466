"""Space-filling-curve codes (Morton / z-order and Hilbert) of integer grid coords.

Counterpart of ``lidar_layout_tpu/ops/serialization.py`` (``part1by2_32``,
``z_order_code``, ``hilbert_code``, ``serialize_code``, ``grid_coords``,
``argsort_with_mask``). Pure int32 bit work on tensors of any leading shape,
with the JAX package's results bit for bit: coords are clipped to
``[0, 2**bits)`` before they are encoded, so at 10 bits and 0.05 m a cloud
wider than 51.2 m shares codes in its far tail. The curves order points for
locality; ``ops/voxel`` also keys its grids by them, and that clipping is
part of what FSVD/FPVD compute.
"""
from __future__ import annotations

import torch

MAX_BITS = 10
ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")


def part1by2_32(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 x with two zero bits between each."""
    x = x.to(torch.int32) & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def z_order_code(grid: torch.Tensor, bits: int = MAX_BITS) -> torch.Tensor:
    """(..., 3) grid coords -> (...,) int32 Morton codes, x in the highest bit
    of each triplet (pointcept's z_order layout). Coords are clipped to
    ``[0, 2**bits)`` first."""
    assert bits <= MAX_BITS
    g = grid.to(torch.int32).clamp(0, (1 << bits) - 1)
    x, y, z = g[..., 0], g[..., 1], g[..., 2]
    return part1by2_32(z) | (part1by2_32(y) << 1) | (part1by2_32(x) << 2)


def hilbert_code(grid: torch.Tensor, bits: int = MAX_BITS) -> torch.Tensor:
    """(..., 3) grid coords -> (...,) int32 Hilbert indices (Skilling's
    transpose algorithm), coords clipped as in ``z_order_code``."""
    assert bits <= MAX_BITS
    n_dims = 3
    g = grid.to(torch.int32).clamp(0, (1 << bits) - 1)
    X = [g[..., i] for i in range(n_dims)]
    m = 1 << (bits - 1)

    q = m
    while q > 1:
        p = q - 1
        for i in range(n_dims):
            cond = (X[i] & q) > 0
            t = (X[0] ^ X[i]) & p
            new_x0 = torch.where(cond, X[0] ^ p, X[0] ^ t)
            if i != 0:
                X[i] = torch.where(cond, X[i], X[i] ^ t)
            X[0] = new_x0
        q >>= 1

    for i in range(1, n_dims):
        X[i] = X[i] ^ X[i - 1]
    t = torch.zeros_like(X[0])
    q = m
    while q > 1:
        t = torch.where((X[n_dims - 1] & q) > 0, t ^ (q - 1), t)
        q >>= 1
    X = [xi ^ t for xi in X]

    code = torch.zeros_like(X[0])
    for b in range(bits - 1, -1, -1):
        for i in range(n_dims):
            code = (code << 1) | ((X[i] >> b) & 1)
    return code


def serialize_code(grid: torch.Tensor, order: str, bits: int = MAX_BITS) -> torch.Tensor:
    """PT-v3's four orders; '-trans' swaps x and y first."""
    if order.endswith("-trans"):
        grid = grid[..., [1, 0, 2]]
        order = order[: -len("-trans")]
    if order == "z":
        return z_order_code(grid, bits)
    if order == "hilbert":
        return hilbert_code(grid, bits)
    raise ValueError(order)


def grid_coords(points: torch.Tensor, grid_size: float,
                origin: torch.Tensor = None) -> torch.Tensor:
    """(N, 3) points -> int32 grid coords from ``origin`` (default: the
    points' minimum corner)."""
    if origin is None:
        origin = points.amin(dim=0, keepdim=True)
    size = torch.tensor(grid_size, dtype=points.dtype, device=points.device)
    return torch.floor((points - origin) / size).to(torch.int32)


def argsort_with_mask(codes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Stable sort order along the last axis with padding (mask False) last."""
    keyed = torch.where(mask, codes, torch.iinfo(torch.int32).max)
    return torch.argsort(keyed, dim=-1, stable=True)
