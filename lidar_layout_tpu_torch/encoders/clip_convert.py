"""OpenAI CLIP checkpoint -> the port's CLIP text and image towers.

Counterpart of ``lidar_layout_tpu/encoders/clip_convert.py``
(``convert_clip_text``, ``convert_clip_image``): the released state_dict
(OpenAI names: ``transformer.resblocks.i.attn.in_proj_weight``, ``ln_1``,
``mlp.c_fc``, ``visual.conv1``, ...) becomes the state_dict of
``encoders/modules.TextTransformerEncoder`` / ``ImageTransformerEncoder``,
leaf for leaf. The fused ``in_proj`` splits into ``query``, ``key`` and
``value``; ``text_projection`` and ``visual.proj``, applied as ``x @ P``,
become linear weights ``P.T``. The repository holds no CLIP weights: the
tests run the converter on random state dicts (ROADMAP queue 1,
"Conditioning").
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _resblocks(sd: Dict[str, Any], pfx: str, layers: int) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for i in range(layers):
        blk, dst = f"{pfx}.resblocks.{i}", f"layers.{i}"
        for a, b in (("ln_1", "ln1"), ("ln_2", "ln2"), ("mlp.c_fc", "mlp_in"),
                     ("mlp.c_proj", "mlp_out"), ("attn.out_proj", "attn.out")):
            out[f"{dst}.{b}.weight"] = _t(sd[f"{blk}.{a}.weight"])
            out[f"{dst}.{b}.bias"] = _t(sd[f"{blk}.{a}.bias"])
        ws = np.split(np.asarray(sd[f"{blk}.attn.in_proj_weight"]), 3, axis=0)
        bs = np.split(np.asarray(sd[f"{blk}.attn.in_proj_bias"]), 3, axis=0)
        for name, w, b in zip(("query", "key", "value"), ws, bs):
            out[f"{dst}.attn.{name}.weight"] = _t(w)
            out[f"{dst}.attn.{name}.bias"] = _t(b)
    return out


def convert_clip_text(sd: Dict[str, Any], layers: int = 12) -> Dict[str, torch.Tensor]:
    """OpenAI CLIP state_dict -> ``TextTransformerEncoder`` state_dict."""
    out = _resblocks(sd, "transformer", layers)
    out["token_embedding.weight"] = _t(sd["token_embedding.weight"])
    out["positional_embedding"] = _t(sd["positional_embedding"])
    out["ln_final.weight"] = _t(sd["ln_final.weight"])
    out["ln_final.bias"] = _t(sd["ln_final.bias"])
    out["text_projection.weight"] = _t(np.asarray(sd["text_projection"]).T)
    return out


def convert_clip_image(sd: Dict[str, Any], layers: int = 24) -> Dict[str, torch.Tensor]:
    """OpenAI CLIP state_dict (``visual.*``) -> ``ImageTransformerEncoder``
    state_dict."""
    out = _resblocks(sd, "visual.transformer", layers)
    out["patch_embed.weight"] = _t(sd["visual.conv1.weight"])      # (W, 3, P, P)
    out["cls"] = _t(np.asarray(sd["visual.class_embedding"]).reshape(1, 1, -1))
    out["pos"] = _t(np.asarray(sd["visual.positional_embedding"])[None])
    for ln in ("ln_pre", "ln_post"):
        out[f"{ln}.weight"] = _t(sd[f"visual.{ln}.weight"])
        out[f"{ln}.bias"] = _t(sd[f"visual.{ln}.bias"])
    out["proj.weight"] = _t(np.asarray(sd["visual.proj"]).T)
    return out
