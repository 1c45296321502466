"""Dataset factory: a config's ``data.params.<split>.target`` -> batches.

Counterpart of ``lidar_layout_tpu/data/factory.py`` for the targets the port
has: ``build_batches`` resolves the reference's class paths through
``ALIASES``, reads the dataset under the root when there is one, and
otherwise falls back to the family's synthetic generator and says so (the
``[data] <name>: <reason> — synthetic fallback`` line).

- ``nusc_layout_graph`` (LayoutDiffusion): ``NuScenesLayoutDataset``
  collates ``batch_size`` scenes drawn with replacement into one padded
  graph (numpy arrays; ``encoders/scene_graph.graph_tensors`` moves them);
  the fallback is ``synthetic_graph_batch`` at its default capacity of 8
  objects and 12 triples a scene, as the JAX package draws it. The params'
  ``with_changes`` reaches the dataset (its default, True, when absent);
  the JAX factory drops it, so its trainer manipulates every scene whatever
  the YAML says (ROADMAP section 3).
- ``nusc_layout_range`` (the layout-conditioned LiDM):
  ``readers.NuScenesLayoutRangeDataset`` through
  ``datasets.layout_range_batches``, or ``synthetic_layout_range_batch``;
  tensors on ``device``, with ``cond`` = ``layout``.
- ``nusc_range`` (the nuScenes autoencoder): ``readers.NuScenesRangeDataset``
  over the root's ``sample_data.json`` sweeps (``num_channels`` from the
  dataset block) through ``datasets.dataset_batches``; ``kitti_range`` (the
  KITTI-360 autoencoder): ``datasets.RangeImageDataset`` over the root's
  velodyne scans. Both fall back to ``synthetic_range_batch``; tensors on
  ``device``.
- ``nusc_cube`` (the cube stage): ``CloudDataset`` over the root's nuScenes
  sweeps (``readers.list_nuscenes_sweeps``: sweeps, else samples), each
  scan's first four columns cropped to the dataset block's
  ``point_cloud_range`` and padded to ``max_points`` (32768); the fallback
  is ``synthetic_cloud_batch``, JAX's draws. Batches of ``points`` (B, N,
  3), ``feats`` (B, N, 4) and ``mask`` (B, N) on ``device``.
- ``nusc_cube_decode`` (the dense decoder): as ``nusc_cube``, with the
  params' ``transform`` block (``data/transforms.build_pipeline``) run on
  each scan after the crop, built only when sweeps are read, as JAX
  builds it: ``gaus_10cm.yaml``'s block raises TypeError there, as in
  the JAX package. A transform's ``range_img`` joins the batch. The
  fallback is ``synthetic_cloud_batch``.

- ``nusc_object`` (the G2SD object AE): ``readers.NuScenesObjectDataset``
  over the params' ``pkl_path`` (dbinfos) under the root, crops resampled to
  ``num_samples`` points (default 1024; the YAML's ``num_points`` sizes only
  the model); the fallback draws ``fg_points`` U(-1, 1) and ``fg_class`` in
  0-7, JAX's draws. Batches of ``fg_points`` (B, P, 3) and ``fg_class``
  (B, 1) on ``device``.
- ``nusc_r2dm`` (R2DM): ``readers.NuScenesR2DMDataset`` over the root's
  samples (else sweeps): ``image`` (B, H, W, 2) and ``proj_points``; the
  fallback is ``synthetic_range_batch`` with an intensity channel U(-1, 1)
  drawn after it, as JAX's.

- ``sem_kitti`` (``readers.SemanticKITTIRangeDataset``: image, mask and the
  one-hot ``segmentation``, ``num_sem_cats`` and ``filtered_map_cats`` from
  the dataset block), ``kitti_camera`` (``readers.KITTI360CameraDataset``:
  image, mask and the ``camera`` views, ``split_per_view`` from the params)
  and ``kitti_annotated`` (``readers.AnnotatedKITTI360Dataset``: image,
  mask, the ``condition_key`` boxes and ``bbox_labels``), each through
  ``datasets.dataset_batches`` when the root holds a batch of scans, else
  ``synthetic_range_batch``, as JAX's.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Union

import numpy as np
import torch

from ..ops.lidar import LidarGeometry
from .layout_synthetic import synthetic_graph_batch

ALIASES = {
    "lidm.data.nusc_dataset.nuScenesImageTrain": "nusc_range",
    "lidm.data.nusc_dataset.nuScenesImageValidation": "nusc_range",
    "lidm.data.nusc_dataset.nuScenesLayoutTrain": "nusc_layout_range",
    "lidm.data.nusc_dataset.nuScenesLayoutValidation": "nusc_layout_range",
    "lidm.data.nuscenes_layout_dataset.nuScenesLayoutTrain": "nusc_layout_graph",
    "lidm.data.nuscenes_layout_dataset.nuScenesLayoutVal": "nusc_layout_graph",
    "lidm.data.nuscenes_object_detaset.NuscenesObject": "nusc_object",
    "lidm.data.nusc_dataset_final.NuScenesGen": "nusc_r2dm",
    "lidm.data.nuscenes_cube_dataset.NUSC_CUBE_DATASET": "nusc_cube",
    "NuScenesCubeDecodeDataset": "nusc_cube_decode",
    "lidm.data.kitti.KITTI360Train": "kitti_range",
    "lidm.data.kitti.KITTI360Validation": "kitti_range",
    "lidm.data.kitti.SemanticKITTITrain": "sem_kitti",
    "lidm.data.kitti.SemanticKITTIValidation": "sem_kitti",
}


def _geom_from_cfg(dset_cfg: Dict[str, Any]) -> LidarGeometry:
    return LidarGeometry(
        size=tuple(dset_cfg.get("size", (32, 1024))),
        fov=tuple(dset_cfg.get("fov", (10, -30))),
        depth_range=tuple(dset_cfg.get("depth_range", (1.0, 56.0))),
        depth_scale=dset_cfg.get("depth_scale", 5.84),
        log_scale=dset_cfg.get("log_scale", True))


class CloudDataset:
    """Fixed-capacity padded point clouds (JAX ``data/factory.CloudDataset``):
    ``coord`` = the scan's xyz and ``feat`` its first four columns (three
    when it has only three), kept strictly inside ``point_range`` (x0, y0,
    z0, x1, y1, z1) when given, the first ``max_points`` of them padded
    with zeros and a False mask. ``transforms`` (a callable on the sample
    dict) runs after the crop; the ``range_img`` or ``ray_drop`` it adds
    come along as f32."""

    def __init__(self, files: Sequence[str], point_range, max_points: int,
                 reader: Callable[[str], np.ndarray],
                 transforms: Optional[Callable[[Dict], Dict]] = None):
        self.files = list(files)
        self.point_range = point_range
        self.max_points = max_points
        self.reader = reader
        self.transforms = transforms

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        scan = self.reader(self.files[idx])
        data = {"coord": scan[:, :3], "feat": scan[:, :4] if scan.shape[1] >= 4 else scan[:, :3]}
        r = self.point_range
        if r is not None:
            c = data["coord"]
            m = ((c[:, 0] > r[0]) & (c[:, 0] < r[3]) & (c[:, 1] > r[1]) & (c[:, 1] < r[4])
                 & (c[:, 2] > r[2]) & (c[:, 2] < r[5]))
            data = {k: v[m] for k, v in data.items()}
        if self.transforms is not None:
            data = self.transforms(data)
        n = min(len(data["coord"]), self.max_points)
        out = {"points": np.zeros((self.max_points, 3), np.float32),
               "feats": np.zeros((self.max_points, data["feat"].shape[1]), np.float32),
               "mask": np.zeros((self.max_points,), bool)}
        out["points"][:n] = data["coord"][:n]
        out["feats"][:n] = data["feat"][:n]
        out["mask"][:n] = True
        for k in ("range_img", "ray_drop"):
            if k in data:
                out[k] = np.asarray(data[k], np.float32)
        return out


def synthetic_cloud_batch(rng: np.random.Generator, batch: int, max_points: int = 8192
                          ) -> Dict[str, np.ndarray]:
    """JAX's ``_synthetic_cloud_batch``: ``batch`` synthetic scenes of
    ``max_points`` points, feats = [xyz, U(0, 1)], every point valid."""
    from .synthetic import synthetic_scene

    out = {"points": np.zeros((batch, max_points, 3), np.float32),
           "feats": np.zeros((batch, max_points, 4), np.float32),
           "mask": np.zeros((batch, max_points), bool)}
    for b in range(batch):
        pts = synthetic_scene(rng, max_points)
        out["points"][b] = pts
        out["feats"][b, :, :3] = pts
        out["feats"][b, :, 3] = rng.uniform(0, 1, max_points)
        out["mask"][b] = True
    return out


def build_batches(target: str, params: Dict[str, Any], dset_cfg: Dict[str, Any],
                  data_root: Optional[str], batch_size: int, seed: int = 0,
                  force_synthetic: bool = False,
                  device: Union[str, torch.device] = "cpu") -> Iterator[Dict[str, Any]]:
    """An endless iterator of batches of ``target`` (see the module's doc);
    the root is ``data_root``, else the params' ``data_root`` or ``root``."""
    name = ALIASES.get(target, target)
    if name not in ("nusc_layout_graph", "nusc_layout_range", "nusc_range", "kitti_range",
                    "sem_kitti", "kitti_camera", "kitti_annotated", "nusc_cube",
                    "nusc_cube_decode", "nusc_object", "nusc_r2dm"):
        raise KeyError(f"unknown dataset target '{target}' "
                       f"(known: {sorted(set(ALIASES.values()))})")
    rng = np.random.default_rng(seed)
    geom = _geom_from_cfg(dset_cfg)
    root = data_root or params.get("data_root") or params.get("root")
    have_root = bool(root) and os.path.isdir(str(root)) and not force_synthetic
    split = params.get("split", "train")

    def synth(reason: str, gen: Callable[[], Dict[str, Any]]):
        print(f"[data] {name}: {reason} — synthetic fallback")
        while True:
            yield gen()

    if name == "nusc_layout_graph":
        if have_root and os.path.isfile(os.path.join(str(root),
                                                     f"nuscenes_infos_{split}.pkl")):
            from .nuscenes_layout import NuScenesLayoutDataset

            ds = NuScenesLayoutDataset(str(root), split,
                                       with_changes=bool(params.get("with_changes", True)))
            if len(ds):   # an empty infos pickle falls back below
                while True:
                    yield ds.collate([int(i) for i in rng.integers(0, len(ds), batch_size)])
        yield from synth(f"no infos pkl under {root!r}",
                         lambda: synthetic_graph_batch(rng, n_scenes=batch_size))
        return

    from . import readers
    from .datasets import RangeImageDataset, dataset_batches, layout_range_batches

    if name in ("nusc_cube", "nusc_cube_decode"):
        max_points = params.get("max_points", 32768)
        if have_root:
            files = (readers.list_nuscenes_sweeps(str(root), split, "sweeps")
                     or readers.list_nuscenes_sweeps(str(root), split, "samples"))
            if len(files) >= batch_size:
                transforms = None
                if name == "nusc_cube_decode" and params.get("transform"):
                    from .transforms import build_pipeline
                    transforms = build_pipeline(params["transform"])
                ds = CloudDataset(files, dset_cfg.get("point_cloud_range"), max_points,
                                  lambda p: readers.read_nuscenes_bin(p)[:, :4], transforms)
                yield from dataset_batches(ds, batch_size, seed, device)
                return
        for b in synth(f"no sweeps under {root!r}",
                       lambda: synthetic_cloud_batch(rng, batch_size, max_points)):
            yield {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        return
    from .synthetic import synthetic_layout_range_batch, synthetic_range_batch

    if name == "nusc_object":
        pkl = params.get("pkl_path")
        num = params.get("num_samples", 1024)
        if have_root and pkl and os.path.isfile(pkl):
            ds = readers.NuScenesObjectDataset(str(root), pkl, split, num_samples=num,
                                               seed=seed)
            if len(ds) >= batch_size:
                yield from dataset_batches(ds, batch_size, seed, device)
                return
        for b in synth(f"no dbinfos at {pkl!r}", lambda: {
                "fg_points": rng.uniform(-1, 1, (batch_size, num, 3)).astype(np.float32),
                "fg_class": rng.integers(0, 8, (batch_size, 1)).astype(np.int32)}):
            yield {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        return

    if name == "nusc_r2dm":
        if have_root:
            ds = readers.NuScenesR2DMDataset(str(root), split, geom)
            if len(ds) >= batch_size:
                yield from dataset_batches(ds, batch_size, seed, device)
                return

        def r2dm_synth():
            img = synthetic_range_batch(rng, batch_size, geom, device=device)["image"]
            inten = rng.uniform(-1, 1, tuple(img.shape)).astype(np.float32)
            return {"image": torch.cat([img, torch.from_numpy(inten).to(device)], dim=-1)}
        yield from synth(f"no data under {root!r}", r2dm_synth)
        return

    if name in ("sem_kitti", "kitti_camera", "kitti_annotated") and have_root:
        if name == "sem_kitti":
            ds = readers.SemanticKITTIRangeDataset(
                str(root), split, geom, num_sem_cats=dset_cfg.get("num_sem_cats", 19),
                filtered_map_cats=dset_cfg.get("filtered_map_cats", ()))
        elif name == "kitti_camera":
            ds = readers.KITTI360CameraDataset(str(root), split, geom,
                                               split_per_view=params.get("split_per_view", 4))
        else:
            ds = readers.AnnotatedKITTI360Dataset(
                str(root), split, condition_key=params.get("condition_key", "bbox"), geom=geom)
        if len(ds) >= batch_size:
            yield from dataset_batches(ds, batch_size, seed, device)
            return
    if name in ("nusc_range", "kitti_range", "sem_kitti", "kitti_camera", "kitti_annotated"):
        if have_root and name == "nusc_range":
            ds = readers.NuScenesRangeDataset(str(root), split, geom,
                                              num_channels=dset_cfg.get("num_channels", 1))
            if len(ds) >= batch_size:
                yield from dataset_batches(ds, batch_size, seed, device)
                return
        elif have_root and name == "kitti_range":
            rid = RangeImageDataset(str(root), "kitti360", split, batch_size, geom, seed,
                                    device=device)
            if not rid.synthetic:
                yield from rid.batches()
                return
        yield from synth(f"no data under {root!r}",
                         lambda: synthetic_range_batch(rng, batch_size, geom, device=device))
        return

    if have_root:
        info = params.get("info_path") or os.path.join(str(root),
                                                       f"nuscenes_infos_{split}.pkl")
        if os.path.isfile(info):
            ds = readers.NuScenesLayoutRangeDataset(
                str(root), split, info, geom,
                *(tuple(dset_cfg.get(k, d)) for k, d in (("x_range", (-50, 50)),
                                                         ("y_range", (-50, 50)),
                                                         ("z_range", (-4, 2)))), seed=seed)
            if len(ds) >= batch_size:
                yield from layout_range_batches(ds, batch_size, seed, device)
                return
    yield from synth(f"no infos pkl under {root!r}",
                     lambda: synthetic_layout_range_batch(rng, batch_size, geom, device))
