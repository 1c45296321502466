"""Range-image batches from KITTI-360 / SemanticKITTI scans, or synthetic ones.

Counterpart of ``RangeImageDataset`` in ``lidar_layout_tpu/data/datasets.py``
with its readers: velodyne scans are read by the native loader
(``data/native_loader``, a C++ thread pool over ``native/lidar_io.cpp``),
or by numpy when it cannot be built (said on stdout, as JAX does; the
dataset's ``reader`` says which ran), and projected with the port's
``pcd2range`` / ``process_scan`` on the dataset's device. When no dataset
root exists the synthetic generator stands in (and says so). With
``degradation`` and ``scale_factors`` each batch also carries
``degraded_image``, the image downsampled by ``data/degradation``'s PIL
transform (the reference's SR conditioning).
``dataset_batches`` loops over a map-style dataset (``readers``'
``NuScenesRangeDataset``, ``NuScenesLayoutRangeDataset``) as the JAX
package's ``data/factory`` does; ``layout_range_batches`` adds the layout
model's ``cond``.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from ..ops.lidar import KITTI_GEOMETRY, NUSCENES_GEOMETRY, LidarGeometry
from .synthetic import project_batch, synthetic_range_batch


def read_velodyne_bin(path: str, with_remission: bool = True) -> np.ndarray:
    """KITTI velodyne format: float32 N x 4 [x, y, z, remission]."""
    scan = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return scan if with_remission else scan[:, :3]


def list_kitti360_scans(root: str, split: str = "train") -> List[str]:
    """<root>/data_3d_raw/<seq>/velodyne_points/data/*.bin, with the
    reference's sequence partition."""
    train_seqs = ["0000", "0002", "0003", "0004", "0005", "0006", "0007", "0009", "0010"]
    seqs = train_seqs if split == "train" else ["0008"]
    files: List[str] = []
    for s in seqs:
        files.extend(sorted(glob.glob(os.path.join(
            root, "data_3d_raw", f"2013_05_28_drive_{s}_sync", "velodyne_points", "data",
            "*.bin"))))
    return files


def list_semantic_kitti_scans(root: str, split: str = "train") -> List[str]:
    seqs = [f"{i:02d}" for i in range(11) if i != 8] if split == "train" else ["08"]
    files: List[str] = []
    for s in seqs:
        files.extend(sorted(glob.glob(os.path.join(root, "sequences", s, "velodyne",
                                                   "*.bin"))))
    return files


class RangeImageDataset:
    """Endless iterator over batches of projected range images (torch
    tensors on ``device``); synthetic scenes when ``root`` holds no scans."""

    def __init__(self, root: Optional[str], dataset: str = "kitti360",
                 split: str = "train", batch_size: int = 4,
                 geom: Optional[LidarGeometry] = None, seed: int = 0,
                 max_points: int = 130000, degradation: Optional[str] = None,
                 scale_factors: Optional[tuple] = None,
                 device: Union[str, torch.device] = "cpu", rows: Optional[slice] = None):
        self.geom = geom or (NUSCENES_GEOMETRY if dataset.startswith("nusc")
                             else KITTI_GEOMETRY)
        self.degradation_transform = None
        if degradation is not None and scale_factors is not None:
            from .degradation import make_degradation_transform

            self.degradation_transform = make_degradation_transform(
                self.geom.size, scale_factors, degradation)
        self.reader = None   # "native" or "python" once batches() has started
        self.batch_size = batch_size
        # the rows of each batch this reader reads (a rank's share of the
        # global batch): the order and the draws stay the whole batch's
        self.rows = slice(None) if rows is None else rows
        self.max_points = max_points
        self.device = device
        self.rng = np.random.default_rng(seed)
        self.files: List[str] = []
        if root and os.path.isdir(root):
            if dataset == "kitti360":
                self.files = list_kitti360_scans(root, split)
            elif dataset in ("kitti", "semantic_kitti"):
                self.files = list_semantic_kitti_scans(root, split)
        self.synthetic = not self.files
        if self.synthetic:
            print(f"[data] no scans under root={root!r}: using synthetic scenes")

    def __len__(self) -> int:
        return max(len(self.files) // self.batch_size, 1)

    def _attach_degraded(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.degradation_transform is not None:
            imgs = batch["image"].cpu().numpy()
            batch["degraded_image"] = torch.from_numpy(np.stack(
                [self.degradation_transform(img) for img in imgs]).astype(np.float32)
            ).to(batch["image"].device)
        return batch

    def batches(self, shuffle: bool = True, use_native: bool = True
                ) -> Iterator[Dict[str, torch.Tensor]]:
        """Endless batches: each pass shuffles the scans with the dataset's
        generator and drops the ragged tail. The native loader returns
        scans as its threads finish them; each lands in its own slot, so a
        batch is the Python reader's. Only ``rows`` of each batch are read."""
        if self.synthetic:
            while True:
                yield self._attach_degraded(synthetic_range_batch(
                    self.rng, self.batch_size, self.geom, device=self.device, rows=self.rows))
        loader = None
        if use_native:
            try:
                from .native_loader import NativeScanLoader

                loader = NativeScanLoader(self.files, self.max_points)
            except Exception as e:
                print(f"[data] native loader unavailable ({e}); python reader")
        self.reader = "python" if loader is None else "native"
        order = np.arange(len(self.files))
        while True:
            if shuffle:
                self.rng.shuffle(order)
            for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
                idxs = [int(k) for k in order[i:i + self.batch_size][self.rows]]
                clouds = np.zeros((len(idxs), self.max_points, 3), np.float32)
                masks = np.zeros((len(idxs), self.max_points), bool)
                if loader is not None:
                    for k in idxs:
                        loader.enqueue(k)
                    for _ in idxs:
                        k, xyz, _, n = loader.next()
                        j = idxs.index(k)
                        clouds[j] = xyz
                        masks[j, :n] = True
                else:
                    for j, k in enumerate(idxs):
                        pts = read_velodyne_bin(self.files[k])[:, :3]
                        n = min(len(pts), self.max_points)
                        clouds[j, :n] = pts[:n]
                        masks[j, :n] = True
                yield self._attach_degraded(project_batch(
                    torch.from_numpy(clouds).to(self.device), self.geom,
                    mask=torch.from_numpy(masks).to(self.device)))


def dataset_batches(ds, batch_size: int, seed: int = 0,
                    device: Union[str, torch.device] = "cpu"
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Endless shuffled batches of a dataset of dicts of fixed-shape numpy
    arrays, stacked, as tensors on ``device``: each pass draws a new order
    from one generator seeded with ``seed`` and drops the ragged tail."""
    if len(ds) < batch_size:
        raise ValueError(f"{len(ds)} samples are fewer than a batch of {batch_size}")
    rng = np.random.default_rng(seed)
    order = np.arange(len(ds))
    while True:
        rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            samples = [ds[int(k)] for k in order[i:i + batch_size]]
            yield {k: torch.from_numpy(np.stack([s[k] for s in samples])).to(device)
                   for k in samples[0]}


def layout_range_batches(ds, batch_size: int, seed: int = 0,
                         device: Union[str, torch.device] = "cpu"
                         ) -> Iterator[Dict[str, torch.Tensor]]:
    """``dataset_batches`` of a ``NuScenesLayoutRangeDataset``, with ``cond``
    = ``layout``."""
    for out in dataset_batches(ds, batch_size, seed, device):
        out["cond"] = out["layout"]
        yield out
