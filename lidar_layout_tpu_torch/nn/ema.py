"""Exponential moving average of parameters.

Counterpart of ``lidar_layout_tpu/nn/ema.py`` (the reference's LitEma): the
decay warms up as ``min(decay, (1 + step) / (10 + step))``, with ``step``
counted after the increment; the shadow copy is float32 whatever the
parameters' dtype. It is swapped in for evaluation with ``swapped_in``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch


class Ema:
    """Shadow float32 copies of named parameters and the update count."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        self.params = {k: p.detach().float().clone() for k, p in params.items()}
        self.step = 0

    @torch.no_grad()
    def update(self, new_params: Dict[str, torch.Tensor], decay: float = 0.9999) -> None:
        """ema <- ema - (1 - d) (ema - p), in place."""
        self.step += 1
        d = min(decay, (1.0 + self.step) / (10.0 + self.step))
        from torch.distributed.tensor import DTensor

        for sharded in (False, True):   # FSDP's DTensors and plain tensors go apart
            keys = [k for k, p in new_params.items() if isinstance(p, DTensor) == sharded]
            if not keys:
                continue
            shadow = [self.params[k] for k in keys]
            new = [new_params[k].detach().float() for k in keys]
            diff = torch._foreach_sub(shadow, new)
            torch._foreach_add_(shadow, diff, alpha=-(1.0 - d))

    @contextlib.contextmanager
    def swapped_in(self, params: Dict[str, torch.Tensor]) -> Iterator[None]:
        """Within the block, ``params`` hold the EMA values; restored after."""
        saved = {k: p.detach().clone() for k, p in params.items()}
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(self.params[k])
        try:
            yield
        finally:
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(saved[k])

    def state_dict(self) -> Dict:
        return {"params": self.params, "step": self.step}

    def load_state_dict(self, state: Dict) -> None:
        for k, v in state["params"].items():
            self.params[k].copy_(v)
        self.step = int(state["step"])
