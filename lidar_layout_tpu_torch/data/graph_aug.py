"""Scene-graph manipulations for LayoutDiffusion's training.

Counterpart of ``lidar_layout_tpu/data/graph_aug.py``, numpy as there, with
the same draws from an ``np.random.Generator`` in the same order, so one
generator state gives the same manipulated graph in both packages. Per scene
one of {"addition", "relationship", "none"} is drawn ("none" for scenes of
two objects or fewer); the encoder sees the manipulated graph while the
decoder keeps the original, with the touched nodes flagged.

The graph keeps its fixed shape: "addition" masks the removed node's
predicates in the encoder view and marks it -1 in ``enc_to_dec`` (the
decoder has to place it); "relationship" changes one predicate and flips
``changed_mask`` on its two endpoints.

Predicates (index -> label): 0 none | 1 left | 2 right | 3 front | 4 behind
| 5 close by | 6 above | 7 standing on | 8 bigger than | 9 smaller than
| 10 taller than | 11 shorter than | 12 symmetrical to | 13 same style as
| 14 same super category as | 15 same material as.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

# the interpretable flip of the evaluation (left <-> right, front <-> behind, ...)
CHANGED_REL = {0: 0, 1: 2, 2: 1, 3: 4, 4: 3, 5: 5, 6: 6, 7: 7,
               8: 9, 9: 8, 10: 11, 11: 10, 12: 12, 13: 13, 14: 14, 15: 15}
# predicates that geometric constraints can evaluate
INTERPRETABLE_RELS = (0, 1, 2, 3, 5, 6, 7, 8)


def _copy(graph: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in graph.items()}


def remove_node(graph: Dict[str, np.ndarray], node: int) -> Dict[str, np.ndarray]:
    """The "addition" manipulation: ``node`` is hidden from the encoder view
    (its triples masked, ``enc_to_dec`` -1)."""
    g = _copy(graph)
    tri = g["enc_triples"]
    touches = (tri[:, 0] == node) | (tri[:, 2] == node)
    g["enc_pred_mask"] = g["enc_pred_mask"] & ~touches
    g["enc_to_dec"][node] = -1
    return g


def modify_relationship(graph: Dict[str, np.ndarray], rng: np.random.Generator,
                        num_preds: int = 16, interpretable: bool = False,
                        node_range: Optional[Tuple[int, int]] = None
                        ) -> Tuple[Dict[str, np.ndarray], int]:
    """Change one live predicate of the encoder view and flag its endpoints;
    returns (graph, the changed triple's index or -1).

    ``interpretable`` (the evaluation's mode) draws among the interpretable
    predicates and applies the semantic opposite; otherwise a different
    predicate in [0, 9) is drawn. ``node_range = (lo, hi)`` keeps the draw to
    one scene's slots of a batched graph."""
    g = _copy(graph)
    live = np.flatnonzero(np.asarray(g["enc_pred_mask"]))
    tri = np.asarray(g["enc_triples"])
    if node_range is not None:
        lo, hi = node_range
        live = [t for t in live if lo <= int(tri[t, 0]) < hi and lo <= int(tri[t, 2]) < hi]
    if interpretable:
        live = [t for t in live if int(tri[t, 1]) in INTERPRETABLE_RELS]
    if len(live) == 0:
        return g, -1
    t = int(rng.choice(live))
    tri = g["enc_triples"]
    old = int(tri[t, 1])
    if interpretable:
        new = CHANGED_REL.get(old, old)
        if new == old and old not in (5, 6, 7, 0):   # self-mapped spatial predicates pass
            return g, -1
    else:
        span = min(num_preds, 9)
        new = (old + int(rng.integers(1, span))) % span
    tri[t, 1] = new
    g["changed_mask"][tri[t, 0]] = True
    g["changed_mask"][tri[t, 2]] = True
    return g, t


def random_manipulation(graph: Dict[str, np.ndarray], rng: np.random.Generator,
                        num_preds: int = 16, max_objs: int = 0,
                        mode: Optional[str] = None, info: Optional[dict] = None,
                        scene: Optional[Tuple[int, int]] = None,
                        interpretable: bool = False) -> Dict[str, np.ndarray]:
    """One manipulation: its type uniform over {"relationship", "addition",
    "none"} when ``mode`` is None (training), else forced (the evaluation's
    ``eval_type``); graphs of two valid objects or fewer are left as they
    are.

    ``max_objs`` is a batched graph's slots a scene (0: one scene); slot 0
    of every scene is its ego row and is never removed. ``scene = (lo, hi)``
    keeps the draw to one scene's slots (``random_manipulation_batched``
    draws once a scene). ``info`` receives {"type", "added_node_id",
    "changed_triple"} as they apply."""
    if info is None:
        info = {}
    valid = np.flatnonzero(np.asarray(graph["obj_mask"]))
    if scene is not None:
        lo, hi = scene
        valid = valid[(valid >= lo) & (valid < hi)]
    if mode is None:
        mode = ["relationship", "addition", "none"][int(rng.integers(3))]
    if len(valid) <= 2:
        mode = "none"
    if mode == "addition":
        stride = max_objs if max_objs > 0 else len(graph["obj_mask"])
        candidates = [int(n) for n in valid if n % stride != 0]
        if candidates:
            node = int(rng.choice(candidates))
            info.update(type="addition", added_node_id=node)
            return remove_node(graph, node)
        mode = "none"
    if mode == "relationship":
        g, t = modify_relationship(graph, rng, num_preds, interpretable=interpretable,
                                   node_range=scene)
        if t >= 0:
            info.update(type="relationship", changed_triple=t)
            return g
    info.update(type="none")
    return graph


def random_manipulation_batched(graph: Dict[str, np.ndarray], rng: np.random.Generator,
                                max_objs: int, n_scenes: int, num_preds: int = 16,
                                mode: Optional[str] = None,
                                interpretable: Optional[bool] = None,
                                infos: Optional[list] = None) -> Dict[str, np.ndarray]:
    """One manipulation per scene of a collated graph, scene by scene.
    ``interpretable`` defaults to "mode is forced" (the evaluation's flip);
    ``infos`` receives each scene's record."""
    if interpretable is None:
        interpretable = mode is not None
    for s in range(n_scenes):
        info: dict = {}
        graph = random_manipulation(graph, rng, num_preds=num_preds, max_objs=max_objs,
                                    mode=mode, info=info,
                                    scene=(s * max_objs, (s + 1) * max_objs),
                                    interpretable=interpretable)
        if infos is not None:
            infos.append(info)
    return graph
