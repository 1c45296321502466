"""Annotation -> conditioning-token builders (taming-style).

Counterpart of ``lidar_layout_tpu/data/conditional_builder.py``, numpy only:
``Annotation``, ``tokenize_coord`` and the fixed-length token sequences of
object (class, bbox) and (class, center) tuples, padded with a none token to
``no_max_objects``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Annotation:
    """helper_types.Annotation equivalent."""

    category_id: int
    bbox: Tuple[float, float, float, float]  # normalized x0, y0, w, h
    center: Optional[Tuple[float, float]] = None


def tokenize_coord(v: float, num_bins: int) -> int:
    return int(np.clip(round(v * (num_bins - 1)), 0, num_bins - 1))


class ObjectsBoundingBoxBuilder:
    """(class, x0, y0, w, h) per object -> flat token sequence with a none
    token padding to ``no_max_objects`` (objects_bbox.py:53 semantics)."""

    def __init__(self, num_classes: int, num_bins: int = 256,
                 no_max_objects: int = 14):
        self.num_classes = num_classes
        self.num_bins = num_bins
        self.no_max_objects = no_max_objects
        self.none_token = num_classes + num_bins  # one past both vocabularies

    @property
    def embedding_dim(self) -> int:
        return self.num_classes + self.num_bins + 1

    def build(self, annotations: Sequence[Annotation]) -> np.ndarray:
        tokens: List[int] = []
        for a in annotations[: self.no_max_objects]:
            x0, y0, w, h = a.bbox
            tokens += [a.category_id,
                       self.num_classes + tokenize_coord(x0, self.num_bins),
                       self.num_classes + tokenize_coord(y0, self.num_bins),
                       self.num_classes + tokenize_coord(w, self.num_bins),
                       self.num_classes + tokenize_coord(h, self.num_bins)]
        pad = (self.no_max_objects - len(annotations)) * 5
        tokens += [self.none_token] * max(pad, 0)
        return np.asarray(tokens, np.int32)

    def inverse_build(self, tokens: np.ndarray) -> List[Annotation]:
        out = []
        for i in range(0, len(tokens), 5):
            grp = tokens[i: i + 5]
            if grp[0] == self.none_token:
                continue
            coords = [(t - self.num_classes) / (self.num_bins - 1)
                      for t in grp[1:]]
            out.append(Annotation(int(grp[0]), tuple(coords)))
        return out


class ObjectsCenterPointsBuilder:
    """(class, cx, cy) per object -> token sequence
    (objects_center_points.py:150 semantics)."""

    def __init__(self, num_classes: int, num_bins: int = 256,
                 no_max_objects: int = 14):
        self.num_classes = num_classes
        self.num_bins = num_bins
        self.no_max_objects = no_max_objects
        self.none_token = num_classes + num_bins

    def build(self, annotations: Sequence[Annotation]) -> np.ndarray:
        tokens: List[int] = []
        for a in annotations[: self.no_max_objects]:
            cx, cy = a.center if a.center is not None else (
                a.bbox[0] + a.bbox[2] / 2, a.bbox[1] + a.bbox[3] / 2)
            tokens += [a.category_id,
                       self.num_classes + tokenize_coord(cx, self.num_bins),
                       self.num_classes + tokenize_coord(cy, self.num_bins)]
        pad = (self.no_max_objects - len(annotations)) * 3
        tokens += [self.none_token] * max(pad, 0)
        return np.asarray(tokens, np.int32)
