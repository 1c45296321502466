"""Build the port's CUDA kernels from ``csrc/*.cu`` and load them with ctypes.

Each source compiles with ``nvcc`` into its own shared library with a plain C
interface (a source in ``PARTS`` in parts, side by side, then linked), on
first use, into ``lidar_layout_tpu_torch/_build/`` (listed in
``.gitignore``). A library's file name carries a hash of its source, the
shared headers ``csrc/*.cuh`` and the flags, so an edited source is rebuilt
and a stale one is never loaded. Nothing is
built or imported when this module is imported: the CPU tests import every
module and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
_P, _I = ctypes.c_void_p, ctypes.c_int
# each C entry point and its argument types (pointers and the stream as
# c_void_p, so ctypes never truncates them to 32 bits); an entry lives in
# csrc/<name>.cu unless SOURCE_OF names another source
SIGNATURES = {
    "flash_attn_fwd": ("llt_flash_attn_fwd", [_P] * 7 + [_I] * 6 + [_P]),
    "flash_attn_bwd": ("llt_flash_attn_bwd", [_P] * 13 + [_I] * 5 + [_P]),
    "group_norm": ("llt_group_norm_fwd", [_P] * 4 + [_I] * 5 + [ctypes.c_float, _I, _P]),
    "group_norm_bwd": ("llt_group_norm_bwd", [_P] * 8 + [_I] * 5 + [ctypes.c_float, _I, _P]),
    "group_norm_path": ("llt_group_norm_path", [_I] * 5),
    "group_norm_stats": ("llt_group_norm_stats", [_P] * 2 + [_I] * 5 + [_P]),
    "group_norm_apply": ("llt_group_norm_apply",
                         [_P] * 5 + [_I] * 5 + [ctypes.c_float] * 2 + [_I, _P]),
    "chamfer_nn": ("llt_chamfer_nn", [_P] * 7 + [_I] * 2 + [_P]),
}
SOURCE_OF = {"group_norm_bwd": "group_norm", "group_norm_path": "group_norm",
             "group_norm_stats": "group_norm", "group_norm_apply": "group_norm"}


def source(name: str) -> str:
    """The source (csrc/<source>.cu) that holds the entry point ``name``."""
    return SOURCE_OF.get(name, name)


SOURCES = tuple(dict.fromkeys(source(n) for n in SIGNATURES))
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# sources built in parts: one nvcc -c -DLLT_PART=<part> each, side by side,
# then linked into the one library (the source says what a part holds);
# flash_attn_fwd's kernels took 91.0 s in one process on the H100 host
PARTS = {"flash_attn_fwd": (0, 16, 32, 64, 1280, 1281, 1282)}

_LAUNCHERS: Dict[str, Callable[..., int]] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(DEFAULT_NVCC):
        return DEFAULT_NVCC
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(put the CUDA toolkit's bin directory on PATH)")


def library_path(name: str) -> Path:
    """The built library of ``csrc/<name>.cu``; its name hashes the source,
    the shared headers ``csrc/*.cuh``, the flags and the parts."""
    files = [SOURCE_DIR / f"{name}.cu", *sorted(SOURCE_DIR.glob("*.cuh"))]
    flags = " ".join(NVCC_FLAGS) + repr(PARTS.get(name))
    digest = hashlib.sha256(b"".join(f.read_bytes() for f in files)
                            + flags.encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Tuple[float, str]]:
    """Compile every named source that is not built yet, all at once (one
    ``nvcc`` process each, or one a part for the sources in PARTS, whose
    objects are then linked). Returns {job: (seconds, compiler log)} for the
    jobs it ran, a job being a source, ``<source>[<part>]`` or
    ``<source>[link]``; raises RuntimeError if any of them fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = {n: library_path(n).with_suffix(f".{os.getpid()}.tmp") for n in todo}
    jobs, objects = {}, {}
    for name in todo:
        src = str(SOURCE_DIR / f"{name}.cu")
        if name in PARTS:
            objects[name] = [tmp[name].with_suffix(f".{part}.o") for part in PARTS[name]]
            for part, obj in zip(PARTS[name], objects[name]):
                jobs[f"{name}[{part}]"] = [nvcc, *NVCC_FLAGS, "-c", f"-DLLT_PART={part}",
                                           "-o", str(obj), src]
        else:
            jobs[name] = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp[name]), src]
    logs = _run(jobs)
    links = {f"{n}[link]": [nvcc, "-shared", "-o", str(tmp[n]), *map(str, objects[n])]
             for n in objects if all(logs[f"{n}[{p}]"][2] == 0 for p in PARTS[n])}
    logs.update(_run(links))
    for obj in (o for objs in objects.values() for o in objs):
        if obj.exists():
            obj.unlink()
    for name in todo:
        if logs.get(f"{name}[link]" if name in objects else name, (0, "", 1))[2] == 0:
            os.replace(tmp[name], library_path(name))  # atomic for concurrent builders
    failed = [f"{job} (exit {rc}):\n{out}" for job, (_, out, rc) in logs.items() if rc != 0]
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {job: (sec, out) for job, (sec, out, _) in logs.items()}


def _run(jobs: Dict[str, list]) -> Dict[str, Tuple[float, str, int]]:
    """Run every command at once: {job: (its own seconds, its output, its
    exit code)}."""
    procs = {}
    for job, cmd in jobs.items():
        out = tempfile.TemporaryFile("w+", dir=BUILD_DIR)   # a full pipe would stall nvcc
        procs[job] = (out, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, text=True))
    done = {}
    while len(done) < len(procs):
        for job, (out, t0, proc) in procs.items():
            if job not in done and proc.poll() is not None:
                seconds = time.perf_counter() - t0
                out.seek(0)
                done[job] = (seconds, out.read(), proc.returncode)
                out.close()
        time.sleep(0.05)
    return done


def launcher(name: str) -> Callable[..., int]:
    """The C entry point ``name`` with its argument types set; its source is
    built first if needed. A launcher returns a CUDA error code."""
    fn = _LAUNCHERS.get(name)
    if fn is None:
        build([source(name)])
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(library_path(source(name)))), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _LAUNCHERS[name] = fn
    return fn


def check(status: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def launch(fn: Callable[..., int], device: "torch.device", what: str, *args) -> None:
    """Call the launcher ``fn`` (``launcher(name)``) with ``args`` while
    ``device`` is the CUDA runtime's current device (a launcher launches on
    the current one, whatever device its pointers lie on), and raise if it
    fails. Every kernel wrapper launches through here."""
    import torch

    with torch.cuda.device(device):
        check(fn(*args), what)
