"""The flagship models.

``flagship``: the unconditional 64-beam LiDM over f_c2_p4 latents, the
counterpart of ``__graft_entry__._flagship``, with the same two
configurations: the full one (configs/lidar_diffusion/kitti/uncond_c2_p4.yaml)
and a tiny one for CPU tests.

``layout_flagship``: the layout-conditioned 32-beam nuScenes LiDM, built
from configs/lidar_diffusion/nuscenes/layout_cond_c2_p4.yaml, and a tiny
variant for CPU tests.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Tuple, Union

import torch

from .config import instantiate_from_config, load_yaml
from .models.autoencoder import AEConfig
from .models.diffusion import DiffusionConfig, LatentDiffusion
from .models.unet import UNetConfig
from .utils.device import resolve_device


def flagship(tiny: bool = False, dtype: torch.dtype = torch.float32,
             device: Union[str, torch.device] = "cuda", split: bool = False
             ) -> Tuple[LatentDiffusion, Tuple[int, int, int]]:
    """(model in eval mode on ``device``, image shape (H, W, C))."""
    dev = resolve_device(device)
    if tiny:
        unet_cfg = UNetConfig(in_channels=8, model_channels=32, out_channels=8,
                              num_res_blocks=1, attention_resolutions=(2,),
                              channel_mult=(1, 2), num_head_channels=8)
        ae_cfg = AEConfig(ch=16, ch_mult=(1, 2, 2, 4),
                          strides=((1, 2), (2, 2), (2, 2)), z_channels=8,
                          out_ch=2, num_res_blocks=1)
        diff_cfg = DiffusionConfig(timesteps=64, latent_shape=(4, 16, 8))
        image_shape = (16, 128, 1)
    else:
        unet_cfg = UNetConfig(in_channels=8, model_channels=256, out_channels=8,
                              num_res_blocks=2, attention_resolutions=(4, 2, 1),
                              channel_mult=(1, 2, 4), num_head_channels=32)
        ae_cfg = AEConfig(ch=64, ch_mult=(1, 2, 2, 4),
                          strides=((1, 2), (2, 2), (2, 2)), z_channels=8,
                          out_ch=2, num_res_blocks=2)
        diff_cfg = DiffusionConfig(timesteps=1024, linear_start=0.0015,
                                   linear_end=0.0195, latent_shape=(16, 128, 8))
        image_shape = (64, 1024, 1)
    if split:
        lh, lw, lc = diff_cfg.latent_shape
        diff_cfg = dataclasses.replace(diff_cfg, latent_shape=(lh, 2 * lw, lc),
                                       split_ks=(lh, lw), split_stride=(lh, lw // 2))
        image_shape = (image_shape[0], 2 * image_shape[1], 1)
    model = LatentDiffusion(diff_cfg, unet_cfg, first_stage_cfg=ae_cfg,
                            use_mask=True, dtype=dtype)
    return model.to(dev).eval(), image_shape


LAYOUT_YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs", "lidar_diffusion", "nuscenes", "layout_cond_c2_p4.yaml")


def layout_config(tiny: bool = False) -> Dict[str, Any]:
    """The config of ``LAYOUT_YAML``; ``tiny`` cuts it for CPU tests: image
    32x256 (latent 8x32), U-Net 32/64/64 channels with one ResBlock a level
    and 16-channel heads, encoder width 32 with one layer and 4 heads, VQ
    ch 16 with one ResBlock a level and 256 codes, 64 timesteps."""
    cfg = load_yaml(LAYOUT_YAML)
    if tiny:
        p = cfg["model"]["params"]
        p.update(timesteps=64, image_size=[8, 32])
        p["unet_config"]["params"].update(image_size=[8, 32], model_channels=32,
                                          encoder_channels=32, num_head_channels=16,
                                          num_res_blocks=1, channel_mult=[1, 2, 2])
        fs = p["first_stage_config"]["params"]
        fs["n_embed"] = 256
        fs["ddconfig"].update(ch=16, num_res_blocks=1)
        p["cond_stage_config"]["params"].update(feature_map_size=[8, 32], hidden_dim=32,
                                                output_dim=128, num_layers=1, num_heads=4)
        cfg["data"]["params"]["dataset"]["size"] = [32, 256]
    return cfg


def layout_flagship(tiny: bool = False, dtype: torch.dtype = torch.float32,
                    device: Union[str, torch.device] = "cuda"
                    ) -> Tuple[LatentDiffusion, Tuple[int, int, int]]:
    """(layout-conditioned model in eval mode on ``device``, image shape
    (H, W, C))."""
    dev = resolve_device(device)
    cfg = layout_config(tiny)
    model = instantiate_from_config(cfg["model"], dtype=dtype)
    return model.to(dev).eval(), (*cfg["data"]["params"]["dataset"]["size"], 1)
