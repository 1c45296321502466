"""Learning-rate schedules (the reference's LambdaWarmUpCosine family).

Counterpart of ``lidar_layout_tpu/train/lr_schedule.py``. Each schedule is a
multiplier f(step) of the base learning rate; ``train.diffusion_trainer``
attaches one to AdamW as a ``LambdaLR`` that steps once per update, as optax
counts a schedule's steps.
"""
from __future__ import annotations

import math
from typing import Callable


def lambda_warmup_cosine(warm_up_steps: int, lr_min: float, lr_max: float,
                         lr_start: float, max_decay_steps: int) -> Callable[[int], float]:
    """Linear warmup from lr_start to lr_max, then cosine decay to lr_min."""

    def schedule(step: int) -> float:
        step = min(step, max_decay_steps)
        if step < warm_up_steps:
            return lr_start + (lr_max - lr_start) * step / max(warm_up_steps, 1)
        t = (step - warm_up_steps) / max(max_decay_steps - warm_up_steps, 1)
        t = min(max(t, 0.0), 1.0)
        return lr_min + 0.5 * (lr_max - lr_min) * (1 + math.cos(t * math.pi))

    return schedule


def lambda_linear(warm_up_steps: int, f_min: float, f_max: float, f_start: float,
                  cycle_lengths: int) -> Callable[[int], float]:
    """LambdaLinearScheduler: warmup, then linear decay."""

    def schedule(step: int) -> float:
        if step < warm_up_steps:
            return f_start + (f_max - f_start) * step / max(warm_up_steps, 1)
        t = (step - warm_up_steps) / max(cycle_lengths - warm_up_steps, 1)
        return max(f_min, f_max + (f_min - f_max) * min(t, 1.0))

    return schedule


def scale_lr(base_lr: float, batch_size: int, n_devices: int, accumulate: int = 1) -> float:
    """The reference's rule: accumulate x devices x batch size x base lr."""
    return accumulate * n_devices * batch_size * base_lr
