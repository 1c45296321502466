"""YAML configs with ``target:``/``params:`` instantiation, for the ported models.

Counterpart of the ``latent_diffusion``, ``unet`` and ``vq_model_interface``
builders of ``lidar_layout_tpu/config.py`` (with the reference's target-name
aliases) and of its ``load_yaml`` and ``apply_dotlist``. Targets not ported
yet raise KeyError.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from .models.autoencoder import AEConfig, VQModelInterface
from .models.diffusion import DiffusionConfig, LatentDiffusion
from .models.unet import UNetConfig, UNetModel


def _ae_cfg(dd: Dict[str, Any]) -> AEConfig:
    return AEConfig(
        ch=dd.get("ch", 64), out_ch=dd.get("out_ch", 1),
        ch_mult=tuple(dd.get("ch_mult", (1, 2, 2, 4))),
        strides=tuple(tuple(s) for s in dd.get("strides", ((1, 2), (2, 2), (2, 2)))),
        num_res_blocks=dd.get("num_res_blocks", 2),
        attn_levels=tuple(dd.get("attn_levels", ())),
        dropout=dd.get("dropout", 0.0),
        in_channels=dd.get("in_channels", 1),
        z_channels=dd.get("z_channels", 8),
        double_z=dd.get("double_z", False))


def build_unet_cfg(params: Dict[str, Any]) -> UNetConfig:
    return UNetConfig(
        in_channels=params["in_channels"],
        model_channels=params["model_channels"],
        out_channels=params["out_channels"],
        num_res_blocks=params["num_res_blocks"],
        attention_resolutions=tuple(params.get("attention_resolutions", ())),
        channel_mult=tuple(params.get("channel_mult", (1, 2, 4))),
        dropout=params.get("dropout", 0.0),
        num_heads=params.get("num_heads", -1),
        num_head_channels=params.get("num_head_channels", -1),
        use_spatial_transformer=params.get("use_spatial_transformer", False),
        transformer_depth=params.get("transformer_depth", 1),
        context_dim=params.get("context_dim"),
        num_classes=params.get("num_classes"),
        cconv=params.get("lib_name", "lidm") in ("lidm", "lidm_v0"))


def _build_vq_interface(params: Dict[str, Any], **_) -> VQModelInterface:
    return VQModelInterface(_ae_cfg(params["ddconfig"]),
                            n_embed=params.get("n_embed", 16384),
                            embed_dim=params.get("embed_dim", 8),
                            use_mask=params.get("use_mask", False))


def _build_unet(params: Dict[str, Any], **_) -> UNetModel:
    return UNetModel(build_unet_cfg(params))


def _build_latent_diffusion(params: Dict[str, Any],
                            dtype: torch.dtype = torch.float32) -> LatentDiffusion:
    image_size = params.get("image_size", [16, 128])
    diff_cfg = DiffusionConfig(
        timesteps=params.get("timesteps", 1000),
        beta_schedule=params.get("beta_schedule", "linear"),
        linear_start=params.get("linear_start", 1e-4),
        linear_end=params.get("linear_end", 2e-2),
        parameterization=params.get("parameterization", "eps"),
        loss_type=params.get("loss_type", "l2"),
        conditioning_key=params.get("conditioning_key"),
        scale_factor=params.get("scale_factor", 1.0),
        scale_by_std=params.get("scale_by_std", False),
        cond_stage_trainable=params.get("cond_stage_trainable", False),
        learn_logvar=params.get("learn_logvar", False),
        latent_shape=(image_size[0], image_size[1], params.get("channels", 8)))
    unet_target = params["unet_config"].get("target", "")
    if unet_target not in ("unet", "lidm.modules.diffusion.openaimodel.UNetModel"):
        raise NotImplementedError(f"U-Net target {unet_target!r} is not ported yet "
                                  f"(ROADMAP queue 1)")
    csc = params.get("cond_stage_config")
    if isinstance(csc, dict):
        raise NotImplementedError("conditioning stages are not ported yet "
                                  "(ROADMAP queue 1, item 11)")
    fs_cfg = None
    n_embed, embed_dim, use_mask = 16384, 8, True
    fsc = params.get("first_stage_config")
    if fsc and fsc != "__is_unconditional__":
        fsp = fsc["params"]
        fs_cfg = _ae_cfg(fsp["ddconfig"])
        n_embed = fsp.get("n_embed", 16384)
        embed_dim = fsp.get("embed_dim", 8)
        use_mask = fsp.get("use_mask", False)
    return LatentDiffusion(diff_cfg, build_unet_cfg(params["unet_config"]["params"]),
                           first_stage_cfg=fs_cfg, n_embed=n_embed,
                           embed_dim=embed_dim, use_mask=use_mask, dtype=dtype)


REGISTRY: Dict[str, Callable] = {}
for _names, _fn in (
        (("latent_diffusion", "lidm.models.diffusion.ddpm.LatentDiffusion"),
         _build_latent_diffusion),
        (("unet", "lidm.modules.diffusion.openaimodel.UNetModel"), _build_unet),
        (("vq_model_interface", "lidm.models.autoencoder.VQModelInterface",
          "lidm.models.ae.autoencoder.VQModelInterface"), _build_vq_interface)):
    for _n in _names:
        REGISTRY[_n] = _fn


def instantiate_from_config(cfg: Dict[str, Any], **kwargs) -> Any:
    """cfg = {target, params} -> model (reference misc_utils semantics)."""
    if cfg in ("__is_unconditional__", "__is_first_stage__"):
        return None
    target = cfg["target"]
    if target not in REGISTRY:
        raise KeyError(f"target {target!r} is not ported yet; ported: "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[target](cfg.get("params", {}), **kwargs)


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml  # imported here: the card machine may lack pyyaml

    with open(path) as f:
        return yaml.safe_load(f)


def apply_dotlist(cfg: Dict[str, Any], overrides) -> Dict[str, Any]:
    """Merge ``a.b.c=value`` overrides into ``cfg`` (values parsed as YAML,
    bare scientific notation as float); intermediate dicts are created as
    needed. Mutates and returns ``cfg``."""
    import yaml

    for item in overrides or []:
        if "=" not in item:
            raise ValueError(f"dotlist override '{item}' must be key=value")
        key, _, raw = item.partition("=")
        val = yaml.safe_load(raw)
        if isinstance(val, str):
            try:
                val = float(val)
            except ValueError:
                pass
        node = cfg
        parts = key.strip().split(".")
        for part in parts[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, dict):
                nxt = {}
                node[part] = nxt
            node = nxt
        node[parts[-1]] = val
    return cfg
