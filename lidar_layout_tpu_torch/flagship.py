"""The flagship model: unconditional 64-beam LiDM over f_c2_p4 latents.

Counterpart of ``__graft_entry__._flagship``, with the same two
configurations: the full one (configs/lidar_diffusion/kitti/uncond_c2_p4.yaml)
and a tiny one for CPU tests.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from .models.autoencoder import AEConfig
from .models.diffusion import DiffusionConfig, LatentDiffusion
from .models.unet import UNetConfig
from .utils.device import resolve_device


def flagship(tiny: bool = False, dtype: torch.dtype = torch.float32,
             device: Union[str, torch.device] = "cuda"
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
    model = LatentDiffusion(diff_cfg, unet_cfg, first_stage_cfg=ae_cfg,
                            use_mask=True, dtype=dtype)
    return model.to(dev).eval(), image_shape
