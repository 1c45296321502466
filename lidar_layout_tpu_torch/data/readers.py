"""nuScenes LiDAR sweeps and layouts: the file list, the ``.bin`` reader, the
13-slot layout tensors of the layout-conditioned LiDM and its dataset.

Counterpart of ``list_nuscenes_sweeps``, ``read_nuscenes_bin``,
``NUSC_CLASS_NAMES``, ``project_coords_np``, ``pcd2range_np``,
``process_scan_np``, ``box_corners_3d``, ``boxes_to_range_bbox2d``,
``scale_boxes8``, ``build_layout13``, ``balanced_infos_resampling``,
``NuScenesRangeDataset``, ``NuScenesLayoutRangeDataset``,
``NuScenesObjectDataset``, ``NuScenesR2DMDataset`` and the KITTI readers
(``load_semantic_labels``, ``SemanticKITTIRangeDataset``,
``KITTI360CameraDataset``, ``parse_kitti360_bbox_xml``,
``AnnotatedKITTI360Dataset``) in ``lidar_layout_tpu/data/readers.py`` (the
KITTI scan listers and reader are in ``data/datasets.py``). All numpy, as
there; the camera sets read PNGs with PIL, imported where it is used.
"""
from __future__ import annotations

import glob
import json
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.lidar import LidarGeometry

NUSC_CLASS_NAMES = ("car", "truck", "construction_vehicle", "bus", "trailer",
                    "motorcycle", "bicycle", "pedestrian")

# SemanticKITTI label -> train-id mapping (public dataset constant from
# semantic-kitti.yaml 'learning_map'; 0 stays unlabeled/noise).
SEM_KITTI_LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}

KITTI360_BBOX_CAT2LABEL = {"car": 0, "truck": 1, "train": 2, "bus": 3,
                           "motorcycle": 4, "bicycle": 5, "person": 6}


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


def pcd2range_np(points: np.ndarray, geom: LidarGeometry,
                 features: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(N, 3) points -> (H, W) depth image, -1 where no point falls: farthest
    first, so the nearest point of a pixel overwrites the others; and the
    (N,) ``features`` scattered the same way (None without them)."""
    h, w = geom.size
    px, py, depth = project_coords_np(points, geom)
    valid = ((depth > geom.depth_range[0]) & (depth < geom.depth_range[1])
             & np.isfinite(px) & np.isfinite(py))
    xi = np.clip(np.floor(px * w), 0, w - 1).astype(np.int64)
    yi = np.clip(np.floor(py * h), 0, h - 1).astype(np.int64)
    order = np.argsort(depth)[::-1]
    order = order[valid[order]]
    img = np.full((h, w), -1.0, np.float32)
    img[yi[order], xi[order]] = depth[order]
    feat_img = None
    if features is not None:
        feat_img = np.full((h, w), -1.0, np.float32)
        feat_img[yi[order], xi[order]] = features[order]
    return img, feat_img


def process_scan_np(range_img: np.ndarray, geom: LidarGeometry
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Metric depth -> log2 (or linear) scale -> [-1, 1], and the hit mask."""
    img = range_img.copy()
    hit = img > 0
    if geom.log_scale:
        img[hit] = np.log2(img[hit] + 1.0)
    img = np.clip(img / geom.depth_scale * 2.0 - 1.0, -1.0, 1.0)
    img[~hit] = -1.0
    return img.astype(np.float32), hit


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


class NuScenesRangeDataset:
    """Range images of nuScenes LIDAR_TOP sweeps (the reference's
    nuScenesImageTrain/Validation): ``image`` (H, W, 1), or (H, W, 2) with
    the intensity as a second channel when ``num_channels`` is 2, and the
    hit mask ``mask`` (H, W, 1), bool."""

    def __init__(self, root: str, split: str = "train", geom: Optional[LidarGeometry] = None,
                 num_channels: int = 1, kind: str = "sweeps"):
        self.geom = geom or LidarGeometry(size=(32, 1024), fov=(10.0, -30.0))
        self.files = list_nuscenes_sweeps(root, split, kind)
        self.return_remission = num_channels == 2

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        scan = read_nuscenes_bin(self.files[idx])
        feats = np.clip(scan[:, 3] / 255.0, 0.0, 1.0) if self.return_remission else None
        img, feat = pcd2range_np(scan[:, :3], self.geom, features=feats)
        model, mask = process_scan_np(img, self.geom)
        image = model[..., None]
        if self.return_remission:
            image = np.concatenate([image, np.clip(feat, 0.0, 1.0)[..., None]], -1)
        return {"image": image, "mask": mask[..., None]}


def balanced_infos_resampling(infos: List[dict], rng: np.random.Generator) -> List[dict]:
    """Class-balanced resampling (CBGS): each class's infos drawn with ratio
    (1/C) / the class's frequency, so rare classes are drawn more often."""
    class_names = NUSC_CLASS_NAMES
    cls_infos = {n: [] for n in class_names}
    for info in infos:
        for name in set(info.get("gt_names", ())):
            if name in cls_infos:
                cls_infos[name].append(info)
    total = sum(len(v) for v in cls_infos.values())
    if total == 0:
        return list(infos)
    frac = 1.0 / len(class_names)
    sampled: List[dict] = []
    for name in class_names:
        pool = cls_infos[name]
        if not pool:
            continue
        take = int(len(pool) * (frac / (len(pool) / total)))
        sampled.extend(pool[i] for i in rng.integers(0, len(pool), take))
    return sampled


class NuScenesLayoutRangeDataset:
    """Layout-conditioned range images: an infos pickle (``lidar_path`` and
    the scene graph's ``keep_box`` / ``keep_box_names``), class-balanced
    resampling for the train split, and 13-slot layout tensors."""

    def __init__(self, root: str, split: str = "train", info_path: Optional[str] = None,
                 geom: Optional[LidarGeometry] = None, x_range=(-50.0, 50.0),
                 y_range=(-50.0, 50.0), z_range=(-4.0, 2.0), seed: int = 0):
        self.root = root
        self.geom = geom or LidarGeometry(size=(32, 1024), fov=(10.0, -30.0))
        self.x_range, self.y_range, self.z_range = x_range, y_range, z_range
        info_path = info_path or os.path.join(root, f"nuscenes_infos_{split}.pkl")
        with open(info_path, "rb") as f:   # the dataset's own infos file
            self.infos = pickle.load(f)
        if split == "train":
            self.infos = balanced_infos_resampling(self.infos, np.random.default_rng(seed))

    def __len__(self) -> int:
        return len(self.infos)

    def _lidar_path(self, rel: str) -> str:
        """The reference's data root is the version directory; a root one
        level up is accepted too."""
        p = os.path.join(self.root, rel)
        if os.path.isfile(p):
            return p
        return os.path.join(self.root, "v1.0-trainval", rel)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        info = self.infos[idx]
        pts = read_nuscenes_bin(self._lidar_path(info["lidar_path"]))[:, :3]
        model, mask = process_scan_np(pcd2range_np(pts, self.geom)[0], self.geom)
        sg = info.get("scene_graph", info)
        layout = build_layout13(np.asarray(sg.get("keep_box", np.zeros((0, 7))), np.float32),
                                list(sg.get("keep_box_names", ())), self.geom,
                                self.x_range, self.y_range, self.z_range)
        return {"image": model[..., None], "mask": mask[..., None], "layout": layout}

    @staticmethod
    def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        """Stack the samples' fixed-shape arrays."""
        return {k: np.stack([s[k] for s in samples], 0) for k in samples[0]}


class NuScenesObjectDataset:
    """Per-object point crops from a dbinfos pickle (the reference's
    NuscenesObject): each crop rotated into its box frame, divided by the
    box size and resampled to ``num_samples`` points (with repeats when it
    has fewer); a crop of fewer than ``min_points`` points is re-drawn, up
    to 16 times. ``fg_points`` (num_samples, 3) f32, ``fg_class`` (1,) int32.
    The draws come from one generator seeded with ``seed``, in JAX's order."""

    def __init__(self, root: str, pkl_path: str, split: str = "train",
                 num_samples: int = 1024, min_points: int = 50,
                 class_names: Sequence[str] = NUSC_CLASS_NAMES, seed: int = 0):
        self.root = root
        self.num_samples = num_samples
        self.min_points = min_points
        self.rng = np.random.default_rng(seed)
        with open(pkl_path, "rb") as f:
            db = pickle.load(f)
        data, labels = [], []
        for ci, name in enumerate(class_names):
            for info in db.get(name, ()):
                data.append(info)
                labels.append(ci)
        order = self.rng.permutation(len(data))
        self.data = [data[i] for i in order]
        self.labels = [labels[i] for i in order]
        if split == "val":
            self.data, self.labels = self.data[:10000], self.labels[:10000]

    def __len__(self) -> int:
        return len(self.data)

    @staticmethod
    def _normalize(pts: np.ndarray, box7: np.ndarray) -> np.ndarray:
        c, s = np.cos(-box7[6]), np.sin(-box7[6])
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
        return (pts @ rot.T) / np.maximum(box7[3:6], 1e-6)

    def _sample(self, pts: np.ndarray) -> np.ndarray:
        n = len(pts)
        if n <= self.num_samples:
            return pts[self.rng.integers(0, n, self.num_samples)]
        return pts[self.rng.choice(n, self.num_samples, replace=False)]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        for _ in range(16):
            info = self.data[idx]
            if info.get("num_points_in_gt", self.min_points) >= self.min_points:
                break
            idx = int(self.rng.integers(0, len(self.data)))
        pts = np.fromfile(os.path.join(self.root, info["path"]),
                          dtype=np.float32).reshape(-1, 5)[:, :3]
        box7 = np.asarray(info["box3d_lidar"][:7], np.float32)
        pts = self._sample(self._normalize(pts, box7))
        return {"fg_points": pts.astype(np.float32),
                "fg_class": np.asarray([self.labels[idx]], np.int32)}


class NuScenesR2DMDataset:
    """R2DM's projected scans (the reference's NuScenesGen, spherical
    projection): ``proj_points`` (H, W, 6) = [x y z intensity depth mask] of
    the nearest point in each pixel, and ``image`` (H, W, 2), the model's
    input: log-scaled depth and intensity / 255, each in [-1, 1], -1 where
    no point fell. The samples' scans, else the sweeps'."""

    def __init__(self, root: str, split: str = "train", geom: Optional[LidarGeometry] = None):
        self.geom = geom or LidarGeometry(size=(32, 1024), fov=(10.0, -30.0))
        self.files = (list_nuscenes_sweeps(root, split, kind="samples")
                      or list_nuscenes_sweeps(root, split, kind="sweeps"))

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        geom = self.geom
        h, w = geom.size
        scan = read_nuscenes_bin(self.files[idx])[:, :4]
        xyz, intensity = scan[:, :3], scan[:, 3]
        px, py, depth = project_coords_np(xyz, geom)
        valid = (depth >= geom.depth_range[0]) & (depth <= geom.depth_range[1])
        xi = np.clip(np.floor(px * w), 0, w - 1).astype(np.int64)
        yi = np.clip(np.floor(py * h), 0, h - 1).astype(np.int64)
        order = np.argsort(depth)[::-1]
        img = np.zeros((h, w, 6), np.float32)
        feats = np.concatenate([xyz, intensity[:, None], depth[:, None],
                                valid[:, None].astype(np.float32)], 1)
        sel = order[valid[order]]
        img[yi[sel], xi[sel]] = feats[sel]
        return {"proj_points": img, "image": self.model_input(img)}

    def model_input(self, proj: np.ndarray) -> np.ndarray:
        """(H, W, 6) -> the (H, W, 2) training image."""
        depth, intensity, mask = proj[..., 4], proj[..., 3], proj[..., 5] > 0
        model, _ = process_scan_np(np.where(mask, depth, -1.0).astype(np.float32), self.geom)
        inten = np.clip(intensity / 255.0, 0.0, 1.0) * 2.0 - 1.0
        inten[~mask] = -1.0
        return np.stack([model, inten], -1).astype(np.float32)


# ---------------------------------------------------------------------------
# KITTI: semantic maps, cameras, 3D bboxes
# ---------------------------------------------------------------------------

def load_semantic_labels(path: str) -> np.ndarray:
    """SemanticKITTI .label: uint32, semantic id in the lower 16 bits."""
    labels = np.fromfile(path, dtype=np.uint32) & 0xFFFF
    lut = np.zeros(max(SEM_KITTI_LEARNING_MAP) + 100, np.int32)
    for k, v in SEM_KITTI_LEARNING_MAP.items():
        lut[k] = v
    return lut[labels]


class SemanticKITTIRangeDataset:
    """Range image + one-hot semantic map (kitti.py:111-124). Channel-last:
    sem map is (H, W, num_sem_cats+1)."""

    def __init__(self, root: str, split: str = "train",
                 geom: Optional[LidarGeometry] = None, num_sem_cats: int = 19,
                 filtered_map_cats: Sequence[int] = ()):
        self.geom = geom or LidarGeometry(size=(64, 1024), fov=(3.0, -25.0))
        self.num_classes = num_sem_cats + 1
        self.filtered = set(filtered_map_cats)
        seqs = ([f"{i:02d}" for i in range(11) if i != 8]
                if split == "train" else ["08"])
        self.files: List[str] = []
        for s in seqs:
            # per-sequence fallback: a root without the dataset/ prefix must
            # fall back for EVERY sequence, not only while self.files is
            # still empty (which silently kept only the first sequence)
            hits = sorted(glob.glob(os.path.join(
                root, "dataset", "sequences", s, "velodyne", "*.bin")))
            if not hits:
                hits = sorted(glob.glob(os.path.join(
                    root, "sequences", s, "velodyne", "*.bin")))
            self.files.extend(hits)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        path = self.files[idx]
        pts = np.fromfile(path, np.float32).reshape(-1, 4)[:, :3]
        labels = load_semantic_labels(
            path.replace("velodyne", "labels").replace(".bin", ".label"))
        img, lab_img = pcd2range_np(pts, self.geom,
                                    features=labels.astype(np.float32))
        sem = np.maximum(lab_img, 0).astype(np.int64)
        if self.filtered:
            sem[np.isin(sem, list(self.filtered))] = 0
        onehot = np.eye(self.num_classes, dtype=np.float32)[
            np.clip(sem, 0, self.num_classes - 1)]
        model, mask = process_scan_np(img, self.geom)
        return {"image": model[..., None], "mask": mask[..., None],
                "segmentation": onehot}


class KITTI360CameraDataset:
    """Range image + multi-view camera crops with random camera drop
    (kitti.py:141-168)."""

    def __init__(self, root: str, split: str = "train",
                 geom: Optional[LidarGeometry] = None, split_per_view: int = 4,
                 camera_drop: float = 0.5, seed: int = 0):
        self.root = root
        self.split = split
        self.geom = geom or LidarGeometry(size=(64, 1024), fov=(3.0, -25.0))
        self.split_per_view = split_per_view
        self.camera_drop = camera_drop
        self.rng = np.random.default_rng(seed)
        seqs = (["00", "02", "04", "05", "06", "07", "09", "10"]
                if split == "train" else ["03"])
        self.files: List[str] = []
        for s in seqs:
            self.files.extend(sorted(glob.glob(os.path.join(
                root, "data_3d_raw", f"2013_05_28_drive_00{s}_sync",
                "velodyne_points", "data", "*.bin"))))

    def __len__(self):
        return len(self.files)

    def load_camera(self, path: str) -> np.ndarray:
        from PIL import Image

        cam_path = (path.replace("data_3d_raw", "data_2d_camera")
                    .replace(os.path.join("velodyne_points", "data"),
                             os.path.join("image_00", "data_rect"))
                    .replace(".bin", ".png"))
        cam = np.asarray(Image.open(cam_path), np.float32) / 255.0  # (H,W,3)
        views = np.split(cam, self.split_per_view, axis=1)
        if self.split == "train" and self.rng.random() < self.camera_drop:
            mid = len(views) // 2
            views = [v if i == mid else np.zeros_like(v)
                     for i, v in enumerate(views)]
        return np.stack(views, 0)  # (V, H, W/V, 3)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        path = self.files[idx]
        pts = np.fromfile(path, np.float32).reshape(-1, 4)[:, :3]
        img, _ = pcd2range_np(pts, self.geom)
        model, mask = process_scan_np(img, self.geom)
        return {"image": model[..., None], "mask": mask[..., None],
                "camera": self.load_camera(path)}


def parse_kitti360_bbox_xml(path: str) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """KITTI-360 data_3d_bboxes XML -> {timestamp: (verts (K,8,3), labels (K,))}
    (kitti.py:190-240: opencv-matrix vertices, first 8 rows, BBOX_CAT2LABEL)."""
    import xml.etree.ElementTree as ET

    def parse_mat(node):
        rows = int(node.find("rows").text)
        cols = int(node.find("cols").text)
        vals = [float(d) for d in node.find("data").text.split() if d]
        return np.asarray(vals, np.float32).reshape(rows, cols)

    out: Dict[int, Tuple[list, list]] = {}
    for child in ET.parse(path).getroot():
        if child.find("transform") is None:
            continue
        label_name = child.find("label").text
        if label_name not in KITTI360_BBOX_CAT2LABEL:
            continue
        ts = int(child.find("timestamp").text)
        verts = parse_mat(child.find("vertices"))[:8]
        out.setdefault(ts, ([], []))
        out[ts][0].append(verts)
        out[ts][1].append(KITTI360_BBOX_CAT2LABEL[label_name])
    return {ts: (np.stack(v), np.asarray(l, np.int32))
            for ts, (v, l) in out.items()}


class AnnotatedKITTI360Dataset(KITTI360CameraDataset):
    """Adds per-scan 3D bbox annotations (condition_key 'bbox'/'center')."""

    def __init__(self, root: str, split: str = "train",
                 condition_key: str = "bbox", max_boxes: int = 16, **kw):
        super().__init__(root, split, **kw)
        self.condition_key = condition_key
        self.max_boxes = max_boxes
        self.files = [p for p in self.files
                      if "2013_05_28_drive_0008_sync" not in p]
        self.anno: Dict[str, Dict[int, Tuple[np.ndarray, np.ndarray]]] = {}
        for xml in glob.glob(os.path.join(root, "data_3d_bboxes", "train",
                                          "*.xml")):
            seq = os.path.basename(xml).split("_")[-2][-2:]
            self.anno[seq] = parse_kitti360_bbox_xml(xml)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        path = self.files[idx]
        seq = path.split(os.sep)[-4].split("_")[-2][-2:]
        ts = int(os.path.basename(path).replace(".bin", ""))
        pts = np.fromfile(path, np.float32).reshape(-1, 4)[:, :3]
        img, _ = pcd2range_np(pts, self.geom)
        model, mask = process_scan_np(img, self.geom)
        verts = np.zeros((self.max_boxes, 8, 3), np.float32)
        labels = np.full((self.max_boxes,), -1, np.int32)
        if seq in self.anno and ts in self.anno[seq]:
            v, l = self.anno[seq][ts]
            k = min(len(v), self.max_boxes)
            verts[:k], labels[:k] = v[:k], l[:k]
        if self.condition_key == "center":
            cond = (verts[:, 0] + verts[:, 6]) / 2.0
        else:
            cond = verts
        return {"image": model[..., None], "mask": mask[..., None],
                self.condition_key: cond, "bbox_labels": labels}
