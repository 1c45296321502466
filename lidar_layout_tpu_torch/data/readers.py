"""nuScenes LiDAR sweeps: the file list and the ``.bin`` reader.

Counterpart of ``list_nuscenes_sweeps`` and ``read_nuscenes_bin`` in
``lidar_layout_tpu/data/readers.py`` (the KITTI listers and reader are in
``data/datasets.py``).
"""
from __future__ import annotations

import json
import os
from typing import List

import numpy as np


def list_nuscenes_sweeps(root: str, split: str = "train", kind: str = "sweeps") -> List[str]:
    """LIDAR_TOP files of ``sample_data.json``, as the reference walks it:
    train from the v1.0-trainval table, val from the v1.0-mini one."""
    table = "v1.0-trainval" if split == "train" else "v1.0-mini"
    meta = os.path.join(root, "v1.0-trainval", table, "sample_data.json")
    if not os.path.isfile(meta):
        return []
    with open(meta) as f:
        sample_data = json.load(f)
    tag = f"{kind}/LIDAR_TOP"
    return sorted(os.path.join(root, "v1.0-trainval", x["filename"])
                  for x in sample_data if tag in x["filename"])


def read_nuscenes_bin(path: str) -> np.ndarray:
    """nuScenes format: float32 N x 5 [x, y, z, intensity, ring]."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 5)
