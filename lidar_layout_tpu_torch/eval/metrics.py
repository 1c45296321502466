"""Generation metrics: CD, EMD, JSD, MMD and the Fréchet distance.

Counterpart of ``lidar_layout_tpu/eval/metrics.py``: the same constants, BEV
binning, distance-transform MMD and ``evaluate`` dispatch. CD and EMD run in
PyTorch on the device passed in (CUDA unless the caller asks for the CPU),
CD through kernel K4 on the card; the histograms, the distance transforms
and the Fréchet ``sqrtm`` are numpy and scipy on the host, as in the JAX
package.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.chamfer import pairwise_cd
from ..ops.emd import emd_distance
from ..utils.device import resolve_device

# eval constants of the reference (lidm/eval/__init__.py)
VOXEL_SIZE = 0.05
NUM_SECTORS = 16
DATA_CONFIG = {"64": {"x": [-50, 50], "y": [-50, 50], "z": [-3, 1]},
               "32": {"x": [-30, 30], "y": [-30, 30], "z": [-3, 6]}}

BIG_SENTINEL = 1e10  # ops.chamfer.BIG: the empty-cloud chamfer convention


def _grid_dims(data_type: str, voxel_size: float) -> Tuple[int, int, int, int]:
    """(nx, ny, min_bx, min_by) of the BEV grid."""
    cfg = DATA_CONFIG[data_type]
    x_range, y_range = cfg["x"], cfg["y"]
    return (math.ceil((x_range[1] - x_range[0]) / voxel_size),
            math.ceil((y_range[1] - y_range[0]) / voxel_size),
            math.ceil(x_range[0] / voxel_size), math.ceil(y_range[0] / voxel_size))


def _in_range(pcd: np.ndarray, data_type: str) -> np.ndarray:
    cfg = DATA_CONFIG[data_type]
    x_range, y_range = cfg["x"], cfg["y"]
    m = ((pcd[:, 0] > x_range[0]) & (pcd[:, 0] < x_range[1])
         & (pcd[:, 1] > y_range[0]) & (pcd[:, 1] < y_range[1]))
    return pcd[m][:, :2]


def bev_count_histogram(pcds: Sequence[np.ndarray], data_type: str = "64",
                        voxel_size: float = VOXEL_SIZE) -> np.ndarray:
    """Sum over clouds of per-cloud BEV occupancy (each occupied voxel counts
    once per cloud)."""
    nx, ny, min_bx, min_by = _grid_dims(data_type, voxel_size)
    out = np.zeros((nx, ny), np.float32)
    for pcd in pcds:
        v = np.floor(_in_range(pcd, data_type) / voxel_size).astype(np.int64)
        v[:, 0] -= min_bx
        v[:, 1] -= min_by
        v = np.clip(v, 0, [nx - 1, ny - 1])
        occ = np.zeros((nx, ny), bool)
        occ[v[:, 0], v[:, 1]] = True
        out += occ
    return out


def _bev_bin_cells(pcds: Sequence[np.ndarray], data_type: str = "64",
                   voxel_size: float = 0.5) -> Tuple[List[np.ndarray], Tuple[int, int]]:
    """Per-cloud deduplicated integer BEV cells (pcd2bev_bin's binning) and
    the grid dims."""
    nx, ny, min_bx, min_by = _grid_dims(data_type, voxel_size)
    out = [(np.unique(np.floor(_in_range(pcd, data_type) / voxel_size), axis=0)
            - [min_bx, min_by]).astype(np.int64) for pcd in pcds]
    return out, (nx, ny)


def bev_bin_clouds(pcds: Sequence[np.ndarray], data_type: str = "64",
                   voxel_size: float = 0.5) -> List[np.ndarray]:
    """Per-cloud deduplicated normalised 2D voxel clouds (pcd2bev_bin)."""
    cells, (nx, ny) = _bev_bin_cells(pcds, data_type, voxel_size)
    return [(c / [nx, ny]).astype(np.float32) for c in cells]


def _jsd(p: np.ndarray, q: np.ndarray) -> float:
    """scipy's jensenshannon of two count histograms: the square root of
    the JS divergence with natural logs."""
    p = (p / p.sum()).ravel()
    q = (q / q.sum()).ravel()
    m = 0.5 * (p + q)

    def kl(a, b):
        mask = a > 0
        return float(np.sum(a[mask] * np.log(a[mask] / b[mask])))

    js = 0.5 * kl(p, m) + 0.5 * kl(q, m)
    return float(np.sqrt(max(js, 0.0)))


def compute_jsd(reference: Sequence[np.ndarray], samples: Sequence[np.ndarray],
                data_type: str = "64") -> float:
    """Jensen-Shannon distance between the summed BEV histograms."""
    return _jsd(bev_count_histogram(reference, data_type),
                bev_count_histogram(samples, data_type))


def _edt_from_bitmaps(bits: np.ndarray, nx: int, ny: int) -> Tuple[np.ndarray, np.ndarray]:
    """(N, nx*ny) bool occupancy -> (occupancy f32, squared Euclidean distance
    transform f32) in the normalised coordinates cell / (nx, ny). An empty
    cloud is BIG_SENTINEL away everywhere (the masked-chamfer convention)."""
    from scipy import ndimage

    occ = bits.astype(np.float32)
    sq = np.empty_like(occ)
    for i in range(bits.shape[0]):
        g = bits[i].reshape(nx, ny)
        if not g.any():
            sq[i] = BIG_SENTINEL
            continue
        d = ndimage.distance_transform_edt(~g, sampling=(1.0 / nx, 1.0 / ny))
        sq[i] = (d.astype(np.float32) ** 2).ravel()
    return occ, sq


def _cells_to_bitmaps(cells: Sequence[np.ndarray], nx: int, ny: int) -> np.ndarray:
    bits = np.zeros((len(cells), nx * ny), bool)
    for i, c in enumerate(cells):
        bits[i, c[:, 0] * ny + c[:, 1]] = True
    return bits


def _mmd(ref_bits: np.ndarray, smp_bits: np.ndarray, nx: int, ny: int) -> float:
    """Minimum matching distance from occupancy bitmaps: every nearest-cell
    squared distance is a lookup in the other cloud's distance transform, so
    the (R, S) chamfer matrix is two matrix products."""
    occ_r, sq_r = _edt_from_bitmaps(ref_bits, nx, ny)
    occ_s, sq_s = _edt_from_bitmaps(smp_bits, nx, ny)
    cnt_r = np.maximum(occ_r.sum(-1), 1.0)
    cnt_s = np.maximum(occ_s.sum(-1), 1.0)
    d_rs = (occ_r @ sq_s.T) / cnt_r[:, None]   # mean over r_i of the NN distance into s_j
    d_sr = (occ_s @ sq_r.T) / cnt_s[:, None]
    cd = 0.5 * (d_rs + d_sr.T)                 # (R, S) pairwise_cd values
    return float(np.mean(cd.min(axis=1)))


def compute_mmd(reference: Sequence[np.ndarray], samples: Sequence[np.ndarray],
                data_type: str = "64", voxel_size: float = 0.5) -> float:
    """Minimum matching distance over binned BEV 2D clouds: for each
    reference cloud, the least chamfer distance to any sample. Binned points
    are grid cells, so this equals the brute-force min over pairwise_cd."""
    ref_c, (nx, ny) = _bev_bin_cells(reference, data_type, voxel_size)
    smp_c, _ = _bev_bin_cells(samples, data_type, voxel_size)
    return _mmd(_cells_to_bitmaps(ref_c, nx, ny), _cells_to_bitmaps(smp_c, nx, ny), nx, ny)


def _clouds_on(pairs, dev):
    for x, y in pairs:
        yield (torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev),
               torch.from_numpy(np.ascontiguousarray(y, np.float32)).to(dev))


def compute_cd(reference: Sequence[np.ndarray], samples: Sequence[np.ndarray],
               device: Union[str, torch.device] = "cuda") -> float:
    """Mean chamfer distance over matched (reference, sample) pairs."""
    dev = resolve_device(device)
    vals = [float(pairwise_cd(x, y)) for x, y in _clouds_on(zip(reference, samples), dev)]
    return float(np.mean(vals))


def compute_emd(reference: Sequence[np.ndarray], samples: Sequence[np.ndarray],
                device: Union[str, torch.device] = "cuda") -> float:
    """Mean auction EMD over matched pairs, on whole clouds: the (N, N)
    matrix limits it to clouds of a few thousand points."""
    dev = resolve_device(device)
    vals = [float(emd_distance(x, y)) for x, y in _clouds_on(zip(reference, samples), dev)]
    return float(np.mean(vals))


def frechet_distance(feat1: np.ndarray, feat2: np.ndarray, eps: float = 1e-6) -> float:
    """Fréchet distance between two feature sets (the pytorch-fid formula)."""
    from scipy import linalg

    mu1, mu2 = feat1.mean(axis=0), feat2.mean(axis=0)
    s1 = np.cov(feat1, rowvar=False)
    s2 = np.cov(feat2, rowvar=False)
    diff = mu1 - mu2
    # no ``disp``: scipy 1.18 removed it (and the error estimate it returned)
    covmean = linalg.sqrtm(s1.dot(s2))
    if not np.isfinite(covmean).all():
        offset = np.eye(s1.shape[0]) * eps
        covmean = linalg.sqrtm((s1 + offset).dot(s2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(s1) + np.trace(s2) - 2 * np.trace(covmean))


def evaluate(reference: Sequence[np.ndarray], samples: Sequence[np.ndarray],
             metrics: Sequence[str], data_type: str = "64", feature_fn=None,
             verbose: bool = False, device: Union[str, torch.device] = "cuda"
             ) -> Dict[str, float]:
    """The reference's evaluate dispatch. ``feature_fn(pcds) -> (N, D)``, or
    a dict of them by metric, gives the features of frid/fsvd/fpvd;
    ``verbose`` prints each metric's wall seconds."""
    out: Dict[str, float] = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        if verbose:
            print(f"  [eval] {name}: {time.perf_counter() - t0:.3f} s", flush=True)

    if "cd" in metrics:
        timed("cd", lambda: compute_cd(reference, samples, device))
    if "emd" in metrics:
        timed("emd", lambda: compute_emd(reference, samples, device))
    if "jsd" in metrics:
        timed("jsd", lambda: compute_jsd(reference, samples, data_type))
    if "mmd" in metrics:
        timed("mmd", lambda: compute_mmd(reference, samples, data_type))
    for name in ("frid", "fsvd", "fpvd"):
        if name in metrics:
            fn = feature_fn.get(name) if isinstance(feature_fn, dict) else feature_fn
            if fn is None:
                raise ValueError(f"{name} needs a feature extractor")
            timed(name, lambda: frechet_distance(np.asarray(fn(reference)),
                                                 np.asarray(fn(samples))))
    return out
