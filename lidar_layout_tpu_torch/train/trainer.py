"""Hook-driven training loop.

Counterpart of ``lidar_layout_tpu/train/trainer.py`` (the pointcept Trainer
lifecycle): ``Trainer`` runs ``state, logs = step_fn(state, batch,
generator)`` with before/after hooks, and the hooks ``IterationTimer``,
``InformationWriter`` (stdout and ``metrics.jsonl``), ``CheckpointSaver``,
``ValidationHook``, ``BestCheckpointSaver`` and ``RuntimeProfiler`` (on
``torch.profiler``). SIGUSR1, an exception or an interrupt saves an
emergency checkpoint (the reference's ``melk``).

Under torch.distributed every rank runs the loop and the hooks; rank 0
alone writes (``metrics.jsonl``, stdout, checkpoints, images, the emergency
checkpoint). The logged scalars and the validation metrics are averaged
over the ranks (``reduce_dict``), so ``BestCheckpointSaver`` ranks by the
global validation loss on every rank.
"""
from __future__ import annotations

import json
import os
import signal
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from torch.distributed.tensor import DTensor

from ..parallel.collectives import is_main_process, reduce_dict
from .checkpoint import checkpoint_path, link_checkpoint, save_checkpoint


def _scalar(v: Any) -> Optional[float]:
    if isinstance(v, torch.Tensor):
        return float(v) if v.numel() == 1 else None
    if isinstance(v, (int, float, np.floating, np.integer)):
        return float(v)
    return None


class HookBase:
    trainer: "Trainer" = None

    def before_train(self): ...
    def before_step(self): ...
    def after_step(self, logs: Dict[str, Any]): ...
    def after_train(self): ...


class IterationTimer(HookBase):
    """Host time per step, and its mean over the last 50 after a warm-up.
    A step returns before the device finishes, so this is the enqueue time
    until the queue fills; a hook that reads a value waits for the device."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []
        self._t0 = 0.0

    def before_step(self):
        self._t0 = time.perf_counter()

    def after_step(self, logs):
        dt = time.perf_counter() - self._t0
        if self.trainer.global_step > self.warmup:
            self.times.append(dt)
        logs["iter_time"] = dt
        if self.times:
            logs["avg_iter_time"] = float(np.mean(self.times[-50:]))


class InformationWriter(HookBase):
    """Scalars to stdout and ``metrics.jsonl`` every ``log_every`` steps and
    whenever validation metrics are present."""

    def __init__(self, log_every: int = 10):
        self.log_every = log_every

    def before_train(self):
        self.path = os.path.join(self.trainer.workdir, "metrics.jsonl")

    def after_step(self, logs):
        step = self.trainer.global_step
        if step % self.log_every and not any(k.startswith("val/") for k in logs):
            return
        scal = {k: s for k, s in ((k, _scalar(v)) for k, v in logs.items()) if s is not None}
        scal = {k: float(v) for k, v in reduce_dict(scal).items()}
        if not is_main_process():
            return
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, **scal}) + "\n")
        msg = " ".join(f"{k}={v:.4g}" for k, v in sorted(scal.items())
                       if k in ("loss", "loss_simple", "grad_norm", "total_loss", "rec_loss",
                                "disc_loss", "iter_time"))
        print(f"[step {step}] {msg}", flush=True)


class CheckpointSaver(HookBase):
    """A checkpoint every ``every_steps`` steps and at the end (once, when
    the last step wrote one)."""

    def __init__(self, every_steps: int = 1000, max_to_keep: int = 3):
        self.every_steps = every_steps
        self.max_to_keep = max_to_keep

    def after_step(self, logs):
        if self.trainer.global_step % self.every_steps == 0:
            self._save()

    def after_train(self):
        self._save()

    def _save(self):
        step = self.trainer.global_step
        if self.trainer.last_checkpoint is not None and self.trainer.last_checkpoint[0] == step:
            return
        path = save_checkpoint(os.path.join(self.trainer.workdir, "ckpt"), step,
                               self.trainer.state, self.max_to_keep)
        self.trainer.last_checkpoint = (step, path)


class ValidationHook(HookBase):
    """Every ``every_steps`` steps and at the last: ``val_fn(state, batch,
    generator)`` averaged over ``val_batches_factory()``, merged into the
    step's logs as ``<prefix>/<name>``."""

    def __init__(self, val_fn: Callable, val_batches_factory: Callable,
                 every_steps: int = 1000, prefix: str = "val"):
        self.val_fn = val_fn
        self.val_batches_factory = val_batches_factory
        self.every_steps = every_steps
        self.prefix = prefix

    def after_step(self, logs):
        step = self.trainer.global_step
        if step % self.every_steps and step != self.trainer.max_steps:
            return
        sums: Dict[str, float] = {}
        n = 0
        for batch in self.val_batches_factory():
            for k, v in self.val_fn(self.trainer.state, batch, self.trainer.generator).items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        for k, v in reduce_dict({k: v / max(n, 1) for k, v in sums.items()}).items():
            logs[f"{self.prefix}/{k}"] = float(v)


class BestCheckpointSaver(HookBase):
    """Keep the ``top_k`` checkpoints that are best by ``monitor`` (saved
    whenever the metric appears in the step's logs) in ``subdir``; a step
    whose checkpoint ``CheckpointSaver`` (an earlier hook) has just written
    links that file."""

    def __init__(self, monitor: str = "val/loss_simple", top_k: int = 3, mode: str = "min",
                 subdir: str = "ckpt_best"):
        self.monitor = monitor
        self.top_k = top_k
        self.sign = 1.0 if mode == "min" else -1.0
        self.subdir = subdir
        self.kept: List[tuple] = []   # (signed value, step)

    def after_step(self, logs):
        if self.monitor not in logs:
            return
        d = os.path.join(self.trainer.workdir, self.subdir)
        step = self.trainer.global_step
        last = self.trainer.last_checkpoint
        if last is not None and last[0] == step:
            link_checkpoint(last[1], d, step)
        else:
            save_checkpoint(d, step, self.trainer.state, max_to_keep=0)
        self.kept.append((self.sign * float(logs[self.monitor]), step))
        self.kept.sort()
        for _, old in self.kept[self.top_k:] if is_main_process() else ():
            os.remove(checkpoint_path(d, old))
        self.kept = self.kept[:self.top_k]


class RuntimeProfiler(HookBase):
    """torch.profiler over ``num_steps`` steps from ``start_step``: a chrome
    trace in ``<workdir>/trace/`` and a table of device time by kernel."""

    def __init__(self, start_step: int = 10, num_steps: int = 5):
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None

    def before_step(self):
        if self.trainer.global_step == self.start_step and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()

    def after_step(self, logs):
        if self._prof is not None and self.trainer.global_step >= self.stop_step:
            self._finish()

    def after_train(self):
        if self._prof is not None:
            self._finish()

    def _finish(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        out = os.path.join(self.trainer.workdir, "trace")
        os.makedirs(out, exist_ok=True)
        self._prof.export_chrome_trace(os.path.join(out, "trace.json"))
        sort = "self_cuda_time_total" if torch.cuda.is_available() else "self_cpu_time_total"
        print(self._prof.key_averages().table(sort_by=sort, row_limit=15), flush=True)
        self._prof = None


class Trainer:
    """``state, logs = step_fn(state, batch, generator)`` for ``max_steps``
    steps with the hook lifecycle; ``generator`` lives on the state's device
    and is seeded with ``seed``."""

    def __init__(self, step_fn: Callable, state: Any, data_iter: Iterable,
                 workdir: str = "./runs/default", max_steps: int = 1000,
                 hooks: Optional[List[HookBase]] = None, seed: int = 0):
        self.step_fn = step_fn
        self.state = state
        self.data_iter = iter(data_iter)
        self.workdir = workdir
        self.max_steps = max_steps
        self.global_step = state.step
        self.last_checkpoint: Optional[Tuple[int, str]] = None   # CheckpointSaver's (step, path)
        dev = next(state.model.parameters()).device
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.hooks = hooks if hooks is not None else [IterationTimer(), InformationWriter()]
        for h in self.hooks:
            h.trainer = self
        os.makedirs(workdir, exist_ok=True)

    def _call(self, name, *a):
        for h in self.hooks:
            getattr(h, name)(*a)

    def _melk(self, *_):
        """Emergency checkpoint: on SIGUSR1 (training goes on) and on any
        exception or interrupt (re-raised). Rank 0 writes its own replica,
        with no collective (the other ranks may be gone); a state sharded
        by FSDP has no whole copy on one rank and is not written."""
        if not is_main_process():
            return
        if any(isinstance(p, DTensor) for p in self.state.model.parameters()):
            print("melk: an FSDP-sharded state is not written on one rank", flush=True)
            return
        print("melk: saving emergency checkpoint", flush=True)
        save_checkpoint(os.path.join(self.workdir, "ckpt_interrupt"), self.global_step,
                        self.state)

    def train(self):
        prev = None
        try:   # signals work only in the main thread
            prev = signal.signal(signal.SIGUSR1, self._melk)
        except (ValueError, AttributeError):
            pass
        self._call("before_train")
        try:
            while self.global_step < self.max_steps:
                self._call("before_step")
                batch = next(self.data_iter)
                self.state, logs = self.step_fn(self.state, batch, self.generator)
                self.global_step += 1
                self._call("after_step", logs)
        except (KeyboardInterrupt, Exception):
            self._melk()
            raise
        finally:
            if prev is not None:
                signal.signal(signal.SIGUSR1, prev)
        self._call("after_train")
        return self.state
