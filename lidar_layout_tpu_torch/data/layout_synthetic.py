"""Synthetic fixed-capacity scene-graph batches for LayoutDiffusion.

Counterpart of ``synthetic_graph_batch`` in
``lidar_layout_tpu/data/layout_synthetic.py``, numpy as there, with the same
draws in the same order, so one ``np.random.Generator`` seed gives the same
graph in both packages. A batch of scenes is one padded graph: node and
predicate masks, scene ids, and the encoder/decoder pair that the
scene-graph encoder reads (see ``encoders/scene_graph``). The structured
"traffic" distribution of that module waits with LayoutDiffusion training
(ROADMAP queue 1, "LayoutDiffusion training and data").
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_graph_batch(rng: np.random.Generator, n_scenes: int = 4,
                          max_objs_per_scene: int = 8, max_triples_per_scene: int = 12,
                          num_obj_classes: int = 32, num_pred_classes: int = 16,
                          clip_dim: int = 512, with_changes: bool = False
                          ) -> Dict[str, np.ndarray]:
    """Scenes of 2..max objects (random classes, boxes [size3, loc3, yaw])
    and 1..max random triples between them, padded to the capacities;
    random text features stand in for the CLIP features; ``with_changes``
    marks one node of some scenes as changed."""
    n = n_scenes * max_objs_per_scene
    t = n_scenes * max_triples_per_scene
    objs = np.zeros((n,), np.int32)
    obj_mask = np.zeros((n,), bool)
    boxes = np.zeros((n, 7), np.float32)
    scene_ids = np.zeros((n,), np.int32)
    triples = np.zeros((t, 3), np.int32)
    pred_mask = np.zeros((t,), bool)

    for s in range(n_scenes):
        n_obj = int(rng.integers(2, max_objs_per_scene + 1))
        base = s * max_objs_per_scene
        scene_ids[base:base + max_objs_per_scene] = s
        for i in range(n_obj):
            objs[base + i] = rng.integers(1, num_obj_classes)
            obj_mask[base + i] = True
            boxes[base + i] = [*rng.uniform(0.5, 4.0, 3),    # size
                               *rng.uniform(-20, 20, 2),     # loc xy
                               rng.uniform(-2, 0),           # loc z
                               rng.uniform(-np.pi, np.pi)]   # yaw
        n_tri = int(rng.integers(1, max_triples_per_scene + 1))
        tbase = s * max_triples_per_scene
        for j in range(n_tri):
            a, b = rng.integers(0, n_obj, 2)
            triples[tbase + j] = [base + a, rng.integers(0, num_pred_classes), base + b]
            pred_mask[tbase + j] = True

    text_feat = rng.standard_normal((n, clip_dim)).astype(np.float32)
    rel_feat = rng.standard_normal((t, clip_dim)).astype(np.float32)
    enc_to_dec = np.arange(n, dtype=np.int32)
    changed = np.zeros((n,), bool)
    if with_changes:
        for s in range(n_scenes):
            k = s * max_objs_per_scene + int(rng.integers(0, max_objs_per_scene))
            if obj_mask[k]:
                changed[k] = True
    return {
        "enc_objs": objs, "enc_triples": triples, "enc_text_feat": text_feat,
        "enc_rel_feat": rel_feat, "enc_pred_mask": pred_mask,
        "dec_objs": objs, "dec_triples": triples, "dec_text_feat": text_feat,
        "dec_rel_feat": rel_feat, "dec_pred_mask": pred_mask,
        "dec_boxes": boxes, "dec_objs_to_scene": scene_ids,
        "enc_to_dec": enc_to_dec, "changed_mask": changed,
        "obj_mask": obj_mask, "n_scenes": np.int32(n_scenes),
    }
