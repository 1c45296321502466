"""nuScenes scene-graph layout dataset: LayoutDiffusion's training data.

Counterpart of ``lidar_layout_tpu/data/nuscenes_layout.py``, numpy as there.
It reads the ``nuscenes_infos_<split>.pkl`` entries (``info["scene_graph"]``'s
``keep_box_names``, ``keep_box_relationships`` and ``keep_box``), puts the
"ego" node first, scales the boxes (xyz min-max to [0, 1], log sizes), and
collates a batch of scenes into one fixed-capacity padded graph (16 objects
and 32 triples a scene by default; the keys of ``encoders/scene_graph``).
CLIP text features come from the reference's cached pickles
(``<split>/CLIP/<id>/CLIP_<id>.pkl``), kept resident while the host has
memory to spare (``utils/memory.available_gb``), and are zeros when absent.
With ``with_changes`` (training) or ``eval_type`` each collated scene gets
one manipulation (``data/graph_aug``).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..utils import memory
from .graph_aug import random_manipulation_batched

BOX_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
CACHE_HEADROOM_GB = 2.0   # host memory kept free when CLIP features are cached


def scale_box(boxes: np.ndarray, box_range: Tuple[float, ...] = BOX_RANGE) -> np.ndarray:
    """(K, 7) raw boxes -> (K + 1, 7) scaled, the ego row (-1) first."""
    boxes = np.asarray(boxes, np.float32)
    x_min, y_min, z_min, x_max, y_max, z_max = box_range
    out = np.zeros((boxes.shape[0] + 1, 7), np.float32)
    b = boxes.copy()
    b[:, 0] = (b[:, 0] - x_min) / (x_max - x_min)
    b[:, 1] = (b[:, 1] - y_min) / (y_max - y_min)
    b[:, 2] = (b[:, 2] - z_min) / (z_max - z_min)
    b[:, 3:6] = np.log(np.maximum(b[:, 3:6], 1e-4))
    out[1:, :7] = b[:, :7]
    out[0, :] = -1.0
    return out


def rescale_box(boxes: np.ndarray, box_range: Tuple[float, ...] = BOX_RANGE) -> np.ndarray:
    """The inverse of ``scale_box`` (the ego row becomes zeros)."""
    x_min, y_min, z_min, x_max, y_max, z_max = box_range
    b = np.asarray(boxes, np.float32).copy()
    b[1:, 0] = b[1:, 0] * (x_max - x_min) + x_min
    b[1:, 1] = b[1:, 1] * (y_max - y_min) + y_min
    b[1:, 2] = b[1:, 2] * (z_max - z_min) + z_min
    b[1:, 3:6] = np.exp(b[1:, 3:6])
    b[0, :] = 0.0
    return b


class NuScenesLayoutDataset:
    """Reads the infos pickle of ``root`` and collates padded-graph batches.
    ``cache_features``: True keeps every CLIP pickle read, False none, "auto"
    while more than ``CACHE_HEADROOM_GB`` of host memory stays available."""

    def __init__(self, root: str, split: str = "train",
                 vocab_objects: Optional[Sequence[str]] = None,
                 max_objs: int = 16, max_triples: int = 32, clip_dim: int = 512,
                 with_changes: bool = True, eval_type: Optional[str] = None, seed: int = 0,
                 cache_features: Union[str, bool] = "auto"):
        self.root = root
        self.split = split
        self.max_objs = max_objs
        self.max_triples = max_triples
        self.clip_dim = clip_dim
        self._cache_features = cache_features
        self._feat_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        # manipulations: drawn per scene in training, forced by eval_type
        self.with_changes = with_changes and split == "train"
        self.eval_type = eval_type
        self._aug_rng = np.random.default_rng(seed)

        with open(os.path.join(root, f"nuscenes_infos_{split}.pkl"), "rb") as f:
            infos = pickle.load(f)
        self.rel, self.objs, self.boxes = {}, {}, {}
        self.scans: List[str] = []
        for i, info in enumerate(infos):
            fid = str(i).zfill(7)
            sg = info["scene_graph"]
            self.scans.append(fid)
            self.rel[fid] = sg["keep_box_relationships"]
            self.objs[fid] = sg["keep_box_names"]
            self.boxes[fid] = sg["keep_box"]
        names = sorted({n for v in self.objs.values() for n in v} | {"ego"})
        self.obj_vocab = {n: i + 1 for i, n in enumerate(vocab_objects or names)}  # 0: padding

    def __len__(self) -> int:
        return len(self.scans)

    def _cache_ok(self) -> bool:
        if self._cache_features is True:
            return True
        if not self._cache_features:
            return False
        return memory.available_gb() > CACHE_HEADROOM_GB

    def _load_clip_feats(self, fid: str, n_obj: int, n_tri: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
        hit = self._feat_cache.get(fid)
        if hit is not None:
            return hit
        split_dir = "train" if self.split == "train" else "val"
        path = os.path.join(self.root, split_dir, "CLIP", fid, f"CLIP_{fid}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                feats = pickle.load(f)
            out = (np.asarray(feats["clip_obj_feats"], np.float32),
                   np.asarray(feats["clip_rel_feats"], np.float32))
            if self._cache_ok():
                self._feat_cache[fid] = out
            return out
        return (np.zeros((n_obj, self.clip_dim), np.float32),
                np.zeros((n_tri, self.clip_dim), np.float32))

    def scene(self, index: int) -> Dict[str, np.ndarray]:
        """One scene: object ids (ego first), triples, scaled boxes and the
        text features of its objects and triples."""
        fid = self.scans[index]
        names = ["ego"] + list(self.objs[fid])
        boxes = scale_box(self.boxes[fid])
        triples = np.asarray(self.rel[fid], np.int64).reshape(-1, 3)
        objs = np.asarray([self.obj_vocab.get(n, 0) for n in names], np.int64)
        tf, rf = self._load_clip_feats(fid, len(objs), len(triples))
        return {"objs": objs, "triples": triples, "boxes": boxes, "text_feat": tf,
                "rel_feat": rf}

    def collate(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """The scenes ``indices`` as one padded graph: ``max_objs`` slots and
        ``max_triples`` triples a scene (objects and triples past them, and
        triples that reach past ``max_objs``, are dropped)."""
        n_sc = len(indices)
        n, t = n_sc * self.max_objs, n_sc * self.max_triples
        objs = np.zeros((n,), np.int32)
        obj_mask = np.zeros((n,), bool)
        boxes = np.zeros((n, 7), np.float32)
        scene_ids = np.zeros((n,), np.int32)
        triples = np.zeros((t, 3), np.int32)
        pred_mask = np.zeros((t,), bool)
        text = np.zeros((n, self.clip_dim), np.float32)
        rel = np.zeros((t, self.clip_dim), np.float32)
        for s, idx in enumerate(indices):
            sc = self.scene(idx)
            base, tbase = s * self.max_objs, s * self.max_triples
            k = min(len(sc["objs"]), self.max_objs)
            objs[base:base + k] = sc["objs"][:k]
            obj_mask[base:base + k] = True
            boxes[base:base + k] = sc["boxes"][:k]
            text[base:base + k] = sc["text_feat"][:k]
            scene_ids[base:base + self.max_objs] = s
            tt = [tr for tr in sc["triples"]
                  if tr[0] < self.max_objs and tr[2] < self.max_objs][:self.max_triples]
            for j, tr in enumerate(tt):
                triples[tbase + j] = [base + tr[0], tr[1], base + tr[2]]
                pred_mask[tbase + j] = True
                if j < len(sc["rel_feat"]):
                    rel[tbase + j] = sc["rel_feat"][j]
        graph = {
            "enc_objs": objs, "enc_triples": triples, "enc_text_feat": text,
            "enc_rel_feat": rel, "enc_pred_mask": pred_mask,
            "dec_objs": objs, "dec_triples": triples, "dec_text_feat": text,
            "dec_rel_feat": rel, "dec_pred_mask": pred_mask,
            "dec_boxes": boxes, "dec_objs_to_scene": scene_ids,
            "enc_to_dec": np.arange(n, dtype=np.int32),
            "changed_mask": np.zeros((n,), bool),
            "obj_mask": obj_mask, "n_scenes": np.int32(n_sc),
        }
        if self.with_changes or self.eval_type:
            graph = random_manipulation_batched(graph, self._aug_rng, max_objs=self.max_objs,
                                                n_scenes=n_sc, mode=self.eval_type)
        return graph
