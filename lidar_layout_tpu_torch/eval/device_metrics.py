"""Device-side sufficient statistics of JSD, MMD, FRID, FSVD and FPVD, per generated batch.

Counterpart of ``lidar_layout_tpu/eval/device_metrics.py``. The host
metrics (``eval/metrics.py``) take ragged numpy clouds; these take the
fixed-shape (B, N, 3) points and (B, N) validity that ``range2pcd`` gives on
the device and return only a (nx, ny) histogram, (B, nx*ny) occupancy
bitmaps, (B, H, W, 4) RangeNet inputs and (B, 768) FSVD/FPVD descriptors
(``make_voxel_descriptor_fn``). The binning is the host's: strict range
bounds, floor / voxel, min-corner shift.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..ops import lidar as L
from .metrics import DATA_CONFIG, _edt_from_bitmaps, _grid_dims, _jsd, _mmd  # noqa: F401


def _div(a: torch.Tensor, s: float) -> torch.Tensor:
    """a / s, correctly rounded on every device: on the card torch divides
    by a Python scalar as a * (1 / s), which is one ulp off now and then and
    moves a point across a cell boundary; a tensor divisor divides."""
    return a / torch.tensor(s, dtype=a.dtype, device=a.device)


def _cell_index(xyz: torch.Tensor, valid: torch.Tensor, data_type: str, voxel_size: float
                ) -> Tuple[torch.Tensor, int, int]:
    """Per-point flat BEV cell index; invalid and out-of-range points go to
    a dump slot at nx*ny."""
    cfg = DATA_CONFIG[data_type]
    (x0, x1), (y0, y1) = cfg["x"], cfg["y"]
    nx, ny, min_bx, min_by = _grid_dims(data_type, voxel_size)
    x, y = xyz[..., 0], xyz[..., 1]
    inb = valid & (x > x0) & (x < x1) & (y > y0) & (y < y1)
    vx = (torch.floor(_div(x, voxel_size)).to(torch.int32) - min_bx).clamp(0, nx - 1)
    vy = (torch.floor(_div(y, voxel_size)).to(torch.int32) - min_by).clamp(0, ny - 1)
    return torch.where(inb, vx * ny + vy, nx * ny), nx, ny


def bev_occupancy_bitmaps(xyz: torch.Tensor, valid: torch.Tensor, data_type: str = "64",
                          voxel_size: float = 0.5) -> torch.Tensor:
    """(B, N, 3) points -> (B, nx*ny) bool per-cloud BEV occupancy."""
    pix, nx, ny = _cell_index(xyz, valid, data_type, voxel_size)
    g = torch.zeros((pix.shape[0], nx * ny + 1), dtype=torch.bool, device=pix.device)
    return g.scatter_(1, pix.long(), True)[:, : nx * ny]


def pack_bitmaps(bits: torch.Tensor) -> torch.Tensor:
    """(B, G) bool -> (B, ceil(G/8)) uint8, most significant bit first (the
    np.unpackbits layout): eight times less to read back."""
    b, g = bits.shape
    bits = torch.nn.functional.pad(bits.to(torch.uint8), (0, (-g) % 8))
    w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=bits.device)
    return (bits.reshape(b, -1, 8) * w).sum(dim=-1, dtype=torch.uint8)


def unpack_bitmaps(packed: np.ndarray, n_cells: int) -> np.ndarray:
    """Host inverse of pack_bitmaps: (B, ceil(G/8)) uint8 -> (B, G) bool."""
    return np.unpackbits(np.asarray(packed, np.uint8), axis=1, count=n_cells).astype(bool)


def bev_occupancy_packed(xyz: torch.Tensor, valid: torch.Tensor, data_type: str = "64",
                         voxel_size: float = 0.5) -> torch.Tensor:
    """bev_occupancy_bitmaps, packed for the read-back."""
    return pack_bitmaps(bev_occupancy_bitmaps(xyz, valid, data_type, voxel_size))


def mmd_from_bitmaps(ref_bits: np.ndarray, smp_bits: np.ndarray, data_type: str = "64",
                     voxel_size: float = 0.5) -> float:
    """compute_mmd on occupancy bitmaps (host distance transforms)."""
    nx, ny, _, _ = _grid_dims(data_type, voxel_size)
    return _mmd(np.asarray(ref_bits), np.asarray(smp_bits), nx, ny)


def mmd_from_packed(ref_packed: np.ndarray, smp_packed: np.ndarray, data_type: str = "64",
                    voxel_size: float = 0.5) -> float:
    nx, ny, _, _ = _grid_dims(data_type, voxel_size)
    return mmd_from_bitmaps(unpack_bitmaps(ref_packed, nx * ny),
                            unpack_bitmaps(smp_packed, nx * ny), data_type, voxel_size)


def bev_hist_accumulate(xyz: torch.Tensor, valid: torch.Tensor, data_type: str = "64",
                        voxel_size: float = 0.05) -> torch.Tensor:
    """(B, N, 3) points -> (nx, ny) f32 sum over the batch of per-cloud
    occupancy: the batch's share of the JSD count histogram. One cloud at a
    time, so only one (nx*ny) bitmap is alive (4M cells at 0.05 m)."""
    nx, ny, _, _ = _grid_dims(data_type, voxel_size)
    acc = torch.zeros((nx * ny,), dtype=torch.float32, device=xyz.device)
    for i in range(xyz.shape[0]):
        acc += bev_occupancy_bitmaps(xyz[i:i + 1], valid[i:i + 1], data_type, voxel_size)[0]
    return acc.reshape(nx, ny)


def jsd_from_hists(p: np.ndarray, q: np.ndarray) -> float:
    """compute_jsd's tail on accumulated count histograms."""
    return _jsd(np.asarray(p), np.asarray(q))


def compact_valid_points(xyz: torch.Tensor, valid: torch.Tensor, cap: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., N, 3) pixel-order points and validity -> (..., cap, 3) valid-first
    points (zero rows after them) and a (..., cap) mask. A stable sort of
    ~valid keeps pixel order among the valid points, as the host's
    compaction does."""
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)[..., :cap]
    pts = xyz.gather(-2, order[..., None].expand(*order.shape, 3))
    if pts.shape[-2] < cap:
        pts = torch.nn.functional.pad(pts, (0, 0, 0, cap - pts.shape[-2]))
    mask = (torch.arange(cap, device=xyz.device)
            < valid.sum(dim=-1, keepdim=True).clamp(max=cap))
    return pts * mask[..., None], mask


def voxel_feature_inputs(xyz: torch.Tensor, valid: torch.Tensor, cap: int, voxel_size: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The host voxel preprocessing of FSVD/FPVD on the device: the first
    ``cap`` valid points, rounded to ``voxel_size`` voxels, min-corner shift
    over the valid rows, feats = [xyz, -1]. (..., N, 3) points and (..., N)
    validity -> (vox int32, pts f32, feats f32, mask bool), each
    (..., cap, ...)."""
    pts, mask = compact_valid_points(xyz, valid, cap)
    vox = torch.round(_div(pts, voxel_size))
    vmin = torch.where(mask[..., None], vox, float("inf")).amin(dim=-2, keepdim=True)
    vox = (vox - torch.where(torch.isfinite(vmin), vmin, 0.0)) * mask[..., None]
    fts = torch.cat([pts, -torch.ones_like(pts[..., :1])], dim=-1)
    return vox.to(torch.int32), pts, fts, mask


def in_groups(fn: Callable[..., Tuple[torch.Tensor, ...]], group: int, *batch: torch.Tensor
              ) -> Tuple[torch.Tensor, ...]:
    """``fn`` over the (B, ...) tensors ``batch`` in fixed groups of
    ``group`` rows, the last group padded by repeating its last row and the
    pad rows dropped: each row's result is apart from the group it rode in.
    ``fn`` returns a tuple of (group, ...) tensors; their (B, ...)
    concatenations are returned."""
    outs = []
    for i in range(0, batch[0].shape[0], group):
        part = [t[i:i + group] for t in batch]
        n = part[0].shape[0]
        if n < group:
            part = [torch.cat([t, t[-1:].expand(group - n, *t.shape[1:])]) for t in part]
        outs.append([o[:n] for o in fn(*part)])
    return tuple(torch.cat(o) for o in zip(*outs))


def make_voxel_descriptor_fn(mink_apply, spv_apply, group: int = 16):
    """FSVD/FPVD featurisation on the device, from ``range2pcd``'s (B, N, 3)
    points and (B, N) validity: ``batch_fn(xyz, valid) -> (fsvd, fpvd)``, two
    (B, 768) descriptor rows. ``mink_apply`` and ``spv_apply`` are
    ``registry.build_voxel_feature_net``'s, which the host path
    (``registry.build_feature_fn``) runs the same way; the clouds go through
    them ``group`` at a time (``in_groups``)."""

    def batch_fn(xyz: torch.Tensor, valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return in_groups(lambda x, v: (mink_apply(x, v), spv_apply(x, v)), group, xyz, valid)

    return batch_fn


def rangenet_input_from_model_imgs(imgs: torch.Tensor, geom: L.LidarGeometry) -> torch.Tensor:
    """Decoded model-space range images (B, H, W) -> the (B, H, W, 4)
    [metric depth, x, y, z] RangeNet input.

    The host path (``rangenet.preprocess_range_batch``) reprojects the cloud
    and rasterises it again; reprojected points sit on pixel-floor
    boundaries, so that round trip moves some points to a neighbouring pixel
    by float-ulp noise. Here the raster is the decoded image itself, so both
    sides of one evaluation must take the same path."""
    d = L.model_to_depth(imgs, geom, clamp=False)
    xyz, valid = L.range2xyz(imgs, geom, from_model_space=True)
    d = torch.where(valid, d, -1.0)
    return torch.cat([d[..., None], xyz], dim=-1)
