"""nuScenes LiDAR sweeps and layouts: the file list, the ``.bin`` reader and
the 13-slot layout tensors of the layout-conditioned LiDM.

Counterpart of ``list_nuscenes_sweeps``, ``read_nuscenes_bin``,
``NUSC_CLASS_NAMES``, ``project_coords_np``, ``box_corners_3d``,
``boxes_to_range_bbox2d``, ``scale_boxes8`` and ``build_layout13`` in
``lidar_layout_tpu/data/readers.py`` (the KITTI listers and reader are in
``data/datasets.py``). All numpy, as there.
"""
from __future__ import annotations

import json
import os
from typing import List, Sequence, Tuple

import numpy as np

from ..ops.lidar import LidarGeometry

NUSC_CLASS_NAMES = ("car", "truck", "construction_vehicle", "bus", "trailer",
                    "motorcycle", "bicycle", "pedestrian")


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


def project_coords_np(points: np.ndarray, geom: LidarGeometry
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(..., 3) points -> normalised range-view (px, py) and depth."""
    depth = np.linalg.norm(points, axis=-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        yaw = -np.arctan2(points[..., 1], points[..., 0])
        pitch = np.arcsin(np.where(depth > 0, points[..., 2]
                                   / np.maximum(depth, 1e-8), 0.0))
    px = 0.5 * (yaw / np.pi + 1.0)
    py = 1.0 - (pitch + abs(geom.fov_down)) / geom.fov_range
    return px, py, depth


def box_corners_3d(boxes7: np.ndarray) -> np.ndarray:
    """(K, 7) [x y z l w h yaw] -> (K, 8, 3) corners."""
    b = np.asarray(boxes7, np.float32)
    l, w, h = b[:, 3], b[:, 4], b[:, 5]
    sx = np.stack([l, l, -l, -l, l, l, -l, -l], 1) / 2.0
    sy = np.stack([w, -w, -w, w, w, -w, -w, w], 1) / 2.0
    sz = np.stack([h, h, h, h, -h, -h, -h, -h], 1) / 2.0
    c, s = np.cos(b[:, 6]), np.sin(b[:, 6])
    x = c[:, None] * sx - s[:, None] * sy
    y = s[:, None] * sx + c[:, None] * sy
    corners = np.stack([x, y, sz], -1)
    return corners + b[:, None, :3]


def boxes_to_range_bbox2d(boxes7: np.ndarray, geom: LidarGeometry) -> np.ndarray:
    """(K, 7) -> (K, 4) [x0 y0 x1 y1] normalised range-view boxes."""
    corners = box_corners_3d(boxes7).reshape(-1, 3)
    px, py, _ = project_coords_np(corners, geom)
    px = np.clip(px, 0.0, 1.0).reshape(-1, 8)
    py = np.clip(py, 0.0, 1.0).reshape(-1, 8)
    return np.stack([px.min(1), py.min(1), px.max(1), py.max(1)], 1).astype(np.float32)


def scale_boxes8(boxes7: np.ndarray, x_range, y_range, z_range) -> np.ndarray:
    """(K, 7) -> (K, 8) [xyz min-max normalised, log sizes, sin, cos of yaw]."""
    b = np.asarray(boxes7, np.float32)
    out = np.zeros((b.shape[0], 8), np.float32)
    out[:, 0] = (b[:, 0] - x_range[0]) / (x_range[1] - x_range[0])
    out[:, 1] = (b[:, 1] - y_range[0]) / (y_range[1] - y_range[0])
    out[:, 2] = (b[:, 2] - z_range[0]) / (z_range[1] - z_range[0])
    out[:, 3:6] = np.log(np.maximum(b[:, 3:6], 1e-6))
    out[:, 6] = np.sin(b[:, 6])
    out[:, 7] = np.cos(b[:, 6])
    return out


def build_layout13(boxes7: np.ndarray, names: Sequence[str], geom: LidarGeometry,
                   x_range, y_range, z_range,
                   class_names: Sequence[str] = NUSC_CLASS_NAMES,
                   max_slots: int = 13) -> np.ndarray:
    """(K, 7) boxes and their class names -> the fixed (13, 13) layout
    [box8 | bbox2d4 | class1]; class ids are 1-based, 0 marks a padding slot,
    boxes of other classes are dropped."""
    out = np.zeros((max_slots, 13), np.float32)
    if len(boxes7) == 0:
        return out
    keep = [i for i, n in enumerate(names) if n in class_names]
    if not keep:
        return out
    boxes7 = np.asarray(boxes7, np.float32)[keep][:max_slots]
    cls = np.asarray([class_names.index(names[i]) + 1 for i in keep],
                     np.float32)[:max_slots]
    row = np.concatenate([scale_boxes8(boxes7, x_range, y_range, z_range),
                          boxes_to_range_bbox2d(boxes7, geom), cls[:, None]], 1)
    out[: len(row)] = row
    return out
