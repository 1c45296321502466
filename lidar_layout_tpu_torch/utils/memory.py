"""Host RAM probe for memory-gated in-process caches.

Counterpart of ``lidar_layout_tpu/utils/memory.py``: ``/proc/meminfo`` read
by key (robust to the order of its lines). ``data/nuscenes_layout.py`` uses
``available_gb`` to decide whether to keep CLIP feature pickles resident.
"""
from __future__ import annotations

from typing import Dict

_MEMINFO = "/proc/meminfo"


def meminfo(path: str = _MEMINFO) -> Dict[str, float]:
    """``path`` (meminfo format) as {key: kB}; empty if unreadable."""
    out: Dict[str, float] = {}
    try:
        with open(path) as f:
            for line in f:
                key, _, rest = line.partition(":")
                parts = rest.split()
                if parts:
                    out[key.strip()] = float(parts[0])
    except OSError:
        pass
    return out


def available_gb(path: str = _MEMINFO) -> float:
    """Memory available for new allocations without swapping, in GB: the
    kernel's MemAvailable, else free + buffers + cached on old kernels; 0.0
    when unreadable (callers then cache nothing)."""
    info = meminfo(path)
    kb = info.get("MemAvailable")
    if kb is None:
        kb = info.get("MemFree", 0.0) + info.get("Buffers", 0.0) + info.get("Cached", 0.0)
    return kb / (1024.0 * 1024.0)
