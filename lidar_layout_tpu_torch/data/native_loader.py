"""ctypes bindings for the native (C++) velodyne loader, ``native/lidar_io.cpp``.

Counterpart of ``lidar_layout_tpu/data/native_loader.py``: a C++ thread pool
reads scans into fixed-capacity float32 buffers (xyz padded with zeros to
``max_points``, the remission, the count of valid points) and hands them to
Python through ctypes, in-process, instead of DataLoader worker processes;
the projection then runs on the card (``ops/lidar``).

The shared library is built with ``g++`` from the repository's
``native/lidar_io.cpp`` at first use into the port's ``_build/``
directory, under a name that hashes the source and the flags (the
repository's own ``native/liblidar_io.so`` is neither read nor written).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Tuple

import numpy as np

from ..ops._build import BUILD_DIR, PACKAGE_DIR

SOURCE = PACKAGE_DIR.parent / "native" / "lidar_io.cpp"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lidar_io-{digest}.so"


def build_native() -> Path:
    """The built library, compiled first if needed; raises RuntimeError with
    the compiler's output if ``g++`` fails or is missing."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: the native loader cannot be built ({e})") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)   # atomic for concurrent builders
    return so


class NativeScanLoader:
    """Threaded prefetching reader over a list of velodyne .bin files.
    ``enqueue`` indices, then ``next`` returns scans as the threads finish
    them, each with its index."""

    def __init__(self, paths: List[str], max_points: int = 130000,
                 n_threads: int = 4, prefetch: int = 16):
        lib = ctypes.CDLL(str(build_native()))
        lib.lidar_loader_create.restype = ctypes.c_void_p
        lib.lidar_loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                                            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.lidar_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.lidar_loader_enqueue.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.lidar_loader_next.restype = ctypes.c_int64
        lib.lidar_loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                          ctypes.POINTER(ctypes.c_float),
                                          ctypes.POINTER(ctypes.c_int32)]
        self.lib = lib
        self.max_points = max_points
        self._paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self.handle = lib.lidar_loader_create(self._paths, len(paths), max_points, n_threads,
                                              prefetch)
        self.n = len(paths)

    def enqueue(self, idx: int) -> None:
        self.lib.lidar_loader_enqueue(self.handle, idx)

    def next(self) -> Tuple[int, np.ndarray, np.ndarray, int]:
        """Blocking: (scan index, xyz (max_points, 3), remission (max_points,),
        valid count). A scan that cannot be read is never returned, so do not
        wait for one."""
        xyz = np.empty((self.max_points, 3), np.float32)
        rem = np.empty((self.max_points,), np.float32)
        nv = ctypes.c_int32(0)
        idx = self.lib.lidar_loader_next(self.handle,
                                         xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                         rem.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                         ctypes.byref(nv))
        return int(idx), xyz, rem, int(nv.value)

    def close(self) -> None:
        if getattr(self, "handle", None):
            self.lib.lidar_loader_destroy(self.handle)
            self.handle = None

    def __del__(self):
        self.close()
