"""Synthetic fixed-capacity scene-graph batches for LayoutDiffusion.

Counterpart of ``lidar_layout_tpu/data/layout_synthetic.py``, numpy as
there, with the same draws in the same order, so one ``np.random.Generator``
seed gives the same graph in both packages. A batch of scenes is one padded
graph: node and predicate masks, scene ids, and the encoder/decoder pair
that the scene-graph encoder reads (see ``encoders/scene_graph``).
``traffic_graph_batch`` is that module's structured "traffic" distribution,
a layout a model can learn, with its relation metrics
(``relation_satisfaction``, ``added_relation_satisfaction``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

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


# ---------------------------------------------------------------------------
# The structured "traffic" distribution: a layout a model can learn
# ---------------------------------------------------------------------------

# classes (0 = padding)
EGO, CAR, PED = 1, 2, 3
# predicates (0 = padding)
FRONT_OF, BEHIND, LEFT_OF_EGO, RIGHT_OF_EGO = 1, 2, 3, 4

# normalisation: boxes enter the diffusion roughly in [-1, 1]
SIZE_SCALE = 6.0   # sizes in [0, 6] m
XY_SCALE = 35.0    # |x|, |y| <= 35 m
Z_SCALE = 3.0      # |z| <= 3 m
_NORM = np.array([SIZE_SCALE] * 3 + [XY_SCALE, XY_SCALE, Z_SCALE], np.float32)


def normalize_boxes7(boxes: np.ndarray) -> np.ndarray:
    out = boxes.copy()
    out[..., :6] = boxes[..., :6] / _NORM
    return out


def denormalize_boxes7(boxes: np.ndarray) -> np.ndarray:
    out = np.asarray(boxes).copy()
    out[..., :6] = out[..., :6] * _NORM
    return out


def _unit_feature(seed: int, clip_dim: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(clip_dim).astype(np.float32)
            / np.sqrt(clip_dim))


def traffic_graph_batch(rng: np.random.Generator, n_scenes: int = 8,
                        max_objs_per_scene: int = 8, max_triples_per_scene: int = 12,
                        clip_dim: int = 512, with_changes: bool = False
                        ) -> Dict[str, np.ndarray]:
    """Traffic scenes: ego at the origin (slot 0); 2-5 cars on two lanes at
    y = +-2 m heading +-x; 0-2 pedestrians on the sidewalks (|y| 5-8 m). The
    triples state true relations: (a FRONT_OF b) for cars of one lane, (p
    LEFT_OF_EGO / RIGHT_OF_EGO ego) for pedestrians, so a trained model has
    to place boxes as the graph says (``relation_satisfaction``). Boxes are
    normalised (``normalize_boxes7``); the text features are fixed unit
    vectors a class and a predicate. ``with_changes`` hides one random
    non-ego node a scene from the encoder ("addition"; ``added_mask``)."""
    n = n_scenes * max_objs_per_scene
    t = n_scenes * max_triples_per_scene
    objs = np.zeros((n,), np.int32)
    obj_mask = np.zeros((n,), bool)
    boxes = np.zeros((n, 7), np.float32)
    scene_ids = np.zeros((n,), np.int32)
    triples = np.zeros((t, 3), np.int32)
    pred_mask = np.zeros((t,), bool)
    feat_of = {c: _unit_feature(1000 + c, clip_dim) for c in (0, EGO, CAR, PED)}
    pfeat_of = {p: _unit_feature(2000 + p, clip_dim)
                for p in (0, FRONT_OF, BEHIND, LEFT_OF_EGO, RIGHT_OF_EGO)}

    for s in range(n_scenes):
        base = s * max_objs_per_scene
        scene_ids[base:base + max_objs_per_scene] = s
        objs[base] = EGO
        obj_mask[base] = True
        boxes[base] = [4.5, 1.9, 1.7, 0.0, 0.0, -1.0, 0.0]
        slots: List[Tuple] = []   # (slot, class, x, y, lane)
        n_cars = int(rng.integers(2, min(6, max_objs_per_scene - 2) + 1))
        for i in range(n_cars):
            lane = int(rng.integers(0, 2))           # 0: y = -2 heading +x, 1: y = +2 heading -x
            x = float(rng.uniform(-30, 30))
            y = (-2.0 if lane == 0 else 2.0) + float(rng.normal(0, 0.3))
            yaw = (0.0 if lane == 0 else np.pi) + float(rng.normal(0, 0.1))
            size = np.array([4.5, 1.9, 1.7]) * (1 + rng.normal(0, 0.05, 3))
            k = base + 1 + i
            objs[k] = CAR
            obj_mask[k] = True
            boxes[k] = [*size, x, y, -1.0 + float(rng.normal(0, 0.1)), yaw]
            slots.append((k, CAR, x, y, lane))
        n_ped = int(rng.integers(0, min(3, max_objs_per_scene - 1 - n_cars) + 1))
        for j in range(n_ped):
            side = 1 if rng.uniform() < 0.5 else -1
            x = float(rng.uniform(-20, 20))
            y = side * float(rng.uniform(5, 8))
            k = base + 1 + n_cars + j
            objs[k] = PED
            obj_mask[k] = True
            boxes[k] = [0.6, 0.6, 1.7, x, y, -0.8, float(rng.uniform(-np.pi, np.pi))]
            slots.append((k, PED, x, y, None))
        # triples: the order of the cars of a lane, the side of each pedestrian
        tbase = s * max_triples_per_scene
        tri = []
        cars = [sl for sl in slots if sl[1] == CAR]
        for ai in range(len(cars)):
            for bi in range(ai + 1, len(cars)):
                ka, _, xa, _, la = cars[ai]
                kb, _, xb, _, lb = cars[bi]
                if la != lb:
                    continue
                tri.append((ka, FRONT_OF, kb) if xa > xb else (kb, FRONT_OF, ka))
        for (k, c, x, y, _) in slots:
            if c == PED:
                tri.append((k, LEFT_OF_EGO if y > 0 else RIGHT_OF_EGO, base))
        rng.shuffle(tri)
        for j, (a, p, b) in enumerate(tri[:max_triples_per_scene]):
            triples[tbase + j] = [a, p, b]
            pred_mask[tbase + j] = True

    boxes = normalize_boxes7(boxes)
    text_feat = np.stack([feat_of[int(c)] for c in objs])
    rel_feat = np.stack([pfeat_of[int(p)] for p in triples[:, 1]])
    enc_to_dec = np.arange(n, dtype=np.int32)
    enc_pred_mask = pred_mask.copy()
    added_mask = np.zeros((n,), bool)
    if with_changes:
        for s in range(n_scenes):
            base = s * max_objs_per_scene
            cand = [k for k in range(base + 1, base + max_objs_per_scene) if obj_mask[k]]
            if not cand:
                continue
            k = int(rng.choice(cand))
            enc_to_dec[k] = -1
            added_mask[k] = True
            enc_pred_mask &= ~((triples[:, 0] == k) | (triples[:, 2] == k))
    return {
        "enc_objs": np.where(added_mask, 0, objs).astype(np.int32),
        "enc_triples": triples, "enc_text_feat": text_feat,
        "enc_rel_feat": rel_feat, "enc_pred_mask": enc_pred_mask,
        "dec_objs": objs, "dec_triples": triples, "dec_text_feat": text_feat,
        "dec_rel_feat": rel_feat, "dec_pred_mask": pred_mask,
        "dec_boxes": boxes, "dec_objs_to_scene": scene_ids,
        "enc_to_dec": enc_to_dec, "changed_mask": np.zeros((n,), bool),
        "added_mask": added_mask, "obj_mask": obj_mask, "n_scenes": np.int32(n_scenes),
    }


def relation_satisfaction(boxes7: np.ndarray, graph: Dict[str, np.ndarray]) -> float:
    """The share of valid triples whose relation holds in ``boxes7``
    (denormalised (N, 7)), over the traffic predicates."""
    ok, total = 0, 0
    for (a, p, b), valid in zip(graph["dec_triples"], graph["dec_pred_mask"]):
        if not valid:
            continue
        xa, ya, xb = boxes7[a, 3], boxes7[a, 4], boxes7[b, 3]
        if p == FRONT_OF:
            ok += int(xa > xb)
        elif p == BEHIND:
            ok += int(xa < xb)
        elif p == LEFT_OF_EGO:
            ok += int(ya > 0)
        elif p == RIGHT_OF_EGO:
            ok += int(ya < 0)
        else:
            continue
        total += 1
    return ok / max(total, 1)


def added_relation_satisfaction(boxes7: np.ndarray, graph: Dict[str, np.ndarray]) -> float:
    """``relation_satisfaction`` over the triples that touch an added node
    (``enc_to_dec`` -1): did the model place the node it had to add as the
    graph asks?"""
    added = graph["enc_to_dec"] < 0
    tri = graph["dec_triples"]
    keep = graph["dec_pred_mask"] & (added[tri[:, 0]] | added[tri[:, 2]])
    return relation_satisfaction(boxes7, {"dec_triples": tri, "dec_pred_mask": keep})
