"""Point-cloud transform pipeline (the pointcept transform registry's slice).

Counterpart of ``lidar_layout_tpu/data/transforms.py``: ``FiltPoint``,
``CoordConvert``, ``ToRange``, ``GridSample``, ``RandomRotate``,
``RandomFlip`` and ``Collect`` as numpy callables over a sample dict
{coord, feat, ...}, registered by name, and ``build_pipeline``. The
constructors take the JAX package's arguments and no others, so a config
block that JAX cannot build raises the same ``TypeError`` here:
``gaus_10cm.yaml``'s ``transform`` block passes ``point_cloud_range`` to
``FiltPoint``, ``axis`` to ``RandomRotate``, ``size`` to ``ToRange``,
arguments to ``CoordConvert`` and ``mode`` to ``GridSample``.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch

TRANSFORMS: Dict[str, Callable] = {}


def register(name: str):
    def deco(cls):
        TRANSFORMS[name] = cls
        return cls
    return deco


def _rows(data: Dict, keep) -> Dict:
    """The sample with every per-point array cut to ``keep``."""
    n = len(data["coord"])
    return {k: (v[keep] if isinstance(v, np.ndarray) and len(v) == n else v)
            for k, v in data.items()}


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, data: Dict) -> Dict:
        for t in self.transforms:
            data = t(data)
        return data


@register("FiltPoint")
class FiltPoint:
    """Keep the points strictly inside ``point_range`` (x0, y0, z0, x1, y1, z1)."""

    def __init__(self, point_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)):
        self.r = point_range

    def __call__(self, data):
        c, r = data["coord"], self.r
        return _rows(data, (c[:, 0] > r[0]) & (c[:, 0] < r[3]) & (c[:, 1] > r[1])
                     & (c[:, 1] < r[4]) & (c[:, 2] > r[2]) & (c[:, 2] < r[5]))


@register("CoordConvert")
class CoordConvert:
    """Shift coords to a non-negative frame; ``origin`` keeps the shift."""

    def __call__(self, data):
        data = dict(data)
        data["origin"] = data["coord"].min(axis=0)
        data["coord"] = data["coord"] - data["origin"]
        return data


@register("ToRange")
class ToRange:
    """Attach ``range_img``, the projection of ``raw_coord`` (else
    ``coord``) in ``geom`` (nuScenes' by default)."""

    def __init__(self, geom=None):
        from ..ops.lidar import NUSCENES_GEOMETRY
        self.geom = geom or NUSCENES_GEOMETRY

    def __call__(self, data):
        from ..ops.lidar import pcd2range

        data = dict(data)
        coord = data.get("raw_coord", data["coord"])
        img, _ = pcd2range(torch.as_tensor(np.asarray(coord, np.float32)), self.geom)
        data["range_img"] = img.numpy()
        return data


@register("GridSample")
class GridSample:
    """Keep the first point of each ``grid_size`` voxel, in the input order."""

    def __init__(self, grid_size: float = 0.05):
        self.grid_size = grid_size

    def __call__(self, data):
        c = data["coord"]
        v = np.floor((c - c.min(axis=0)) / self.grid_size).astype(np.int64)
        _, keep = np.unique((v[:, 0] << 40) + (v[:, 1] << 20) + v[:, 2], return_index=True)
        keep.sort()
        return _rows(data, keep)


@register("RandomRotate")
class RandomRotate:
    """With probability ``p``, rotate about z by an angle in ``angle`` x pi."""

    def __init__(self, angle=(-1.0, 1.0), p=0.5, seed=0):
        self.angle, self.p = angle, p
        self.rng = np.random.default_rng(seed)

    def __call__(self, data):
        if self.rng.random() > self.p:
            return data
        from .aug import random_rotate
        data = dict(data)
        a0, a1 = self.angle
        data["coord"], _ = random_rotate(data["coord"], None, self.rng,
                                         angle_range=(a0 * np.pi, a1 * np.pi))
        return data


@register("RandomFlip")
class RandomFlip:
    """With probability ``p``, ``aug.random_flip``."""

    def __init__(self, p=0.5, seed=0):
        self.p = p
        self.rng = np.random.default_rng(seed)

    def __call__(self, data):
        if self.rng.random() > self.p:
            return data
        from .aug import random_flip
        data = dict(data)
        data["coord"], _ = random_flip(data["coord"], None, self.rng)
        return data


@register("Collect")
class Collect:
    def __init__(self, keys: Sequence[str]):
        self.keys = list(keys)

    def __call__(self, data):
        return {k: data[k] for k in self.keys if k in data}


def build_pipeline(cfgs: Sequence[Dict]) -> Compose:
    """[{'type': 'FiltPoint', ...}, ...] -> Compose."""
    ts = []
    for c in cfgs:
        c = dict(c)
        ts.append(TRANSFORMS[c.pop("type")](**c))
    return Compose(ts)
