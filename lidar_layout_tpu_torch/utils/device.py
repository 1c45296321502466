"""Device choice for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the
    CPU. Raises rather than falling back when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev
