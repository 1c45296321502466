"""Checkpoints of a training run with torch.save.

Counterpart of ``lidar_layout_tpu/train/checkpoint.py``: ``save_checkpoint``
keeps the newest ``max_to_keep`` files ``step_<n>.pt`` of a directory,
``latest_step`` and ``restore_checkpoint`` read them back,
``latest_run_weights`` reads the model weights of a run directory's latest
file for the CLIs that sample or evaluate a run, and
``load_first_stage_params`` loads trained autoencoder weights from a torch
``state_dict`` file (a reference ``.ckpt``/``.pt``/``.pth``). A file holds
the step and the train state's ``state_dict()``: model, optimizer and EMA
for a diffusion state; for an autoencoder state (``train/ae_trainer``) a
Lightning-style ``state_dict`` of the model with the discriminator under
``loss.discriminator.``, and both optimizers, so that a LiDM's
``first_stage_config.params.ckpt_path`` can name the file as it is.

Under torch.distributed every rank calls ``save_checkpoint`` (a state
sharded by FSDP is gathered into full tensors, a collective) and rank 0
alone writes, so a file written at any world size is the one-process file;
every rank restores.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..parallel.collectives import is_main_process

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir)) if m)


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.pt")


def full_tensors(tree: Any) -> Any:
    """``tree`` with every DTensor (a parameter, moment or EMA shard under
    FSDP) gathered into its full tensor: a collective, so every rank calls
    it; the identity on a tree of plain tensors."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_map_only

    return tree_map_only(DTensor, lambda t: t.full_tensor(), tree)


def save_checkpoint(ckpt_dir: str, step: int, state: Any, max_to_keep: int = 3) -> str:
    """Write ``state`` (a train state with ``state_dict()``) at ``step``;
    drop the oldest files beyond ``max_to_keep``. Returns the path written.
    Every rank calls it; rank 0 alone writes."""
    path = checkpoint_path(ckpt_dir, step)
    blob = {"step": step, **full_tensors(state.state_dict())}
    if not is_main_process():
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    for old in _steps(ckpt_dir)[:-max_to_keep] if max_to_keep > 0 else []:
        os.remove(checkpoint_path(ckpt_dir, old))
    return path


def link_checkpoint(src: str, ckpt_dir: str, step: int) -> str:
    """``src``, a file ``save_checkpoint`` wrote at ``step``, under
    ``ckpt_dir`` too: a hard link (a copy where the file system has none),
    so one state is written once. Rank 0 alone links. Returns the path."""
    path = checkpoint_path(ckpt_dir, step)
    if not is_main_process():
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        os.link(src, tmp)
    except OSError:
        shutil.copyfile(src, tmp)
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, state: Any, step: Optional[int] = None) -> Any:
    """Load the checkpoint at ``step`` (default: the latest) into ``state``
    in place and return it."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    dev = next(state.model.parameters()).device
    ckpt = torch.load(checkpoint_path(ckpt_dir, step), map_location=dev, weights_only=True)
    state.load_state_dict(ckpt)
    state.step = int(ckpt["step"])
    return state


def latest_run_weights(run_dir: str, key: str = "model", use_ema: bool = False
                       ) -> Tuple[int, Dict[str, torch.Tensor]]:
    """The step and the model ``state_dict`` (``ckpt[key]``) of the latest
    checkpoint under ``<run_dir>/ckpt``, loaded on the CPU; with ``use_ema``
    a diffusion run's EMA weights replace the trained ones they shadow."""
    ckpt_dir = os.path.join(run_dir, "ckpt")
    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    ckpt = torch.load(checkpoint_path(ckpt_dir, step), map_location="cpu", weights_only=True)
    sd = dict(ckpt[key])
    if use_ema:
        sd.update(ckpt["ema"]["params"])
    return step, sd


def load_first_stage_params(path: str, model: torch.nn.Module) -> None:
    """Load a trained first stage into ``model.first_stage_model`` from a
    torch file holding a ``state_dict`` (or ``{"state_dict": ...}``, as a
    Lightning checkpoint does), with or without the ``first_stage_model.``
    prefix; an autoencoder checkpoint's ``loss.*`` entries are skipped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    prefix = "first_stage_model."
    if any(k.startswith(prefix) for k in sd):
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    sd = {k: v for k, v in sd.items() if not k.startswith("loss.")}
    model.first_stage_model.load_state_dict(sd)
