"""Small utilities: seeding, dict-to-namespace, parameter counts.

Counterpart of ``lidar_layout_tpu/utils/misc.py``. ``set_seed`` also seeds
torch (its CPU and CUDA generators), which the JAX package has no need of.
"""
from __future__ import annotations

import random
from types import SimpleNamespace
from typing import Any, Dict

import numpy as np
import torch


def set_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def dict2namespace(d: Dict[str, Any]) -> SimpleNamespace:
    """Nested dicts -> attribute access, recursively."""
    ns = SimpleNamespace()
    for k, v in d.items():
        setattr(ns, k, dict2namespace(v) if isinstance(v, dict) else v)
    return ns


def count_params(module: torch.nn.Module) -> int:
    """The number of parameter elements of a module."""
    return sum(p.numel() for p in module.parameters())
