"""LayoutDiffusion: denoising diffusion over object boxes, conditioned on a
scene graph.

Counterpart of ``lidar_layout_tpu/models/layout_diffusion.py``. Boxes are
8-d [size3, loc3, sin, cos] vectors (the angle through ``angle_to_sincos``);
the scene-graph encoder gives each box an object embedding (and a relation
latent); every box of a scene shares the scene's timestep; the denoiser is
``UNet1DModel``; sampling is DDIM over the (N, 8) vectors, a Python loop of
eager ops where JAX scans. The model is one ``nn.Module`` holding ``unet``
and ``cond_stage``, the two trees of the JAX params.

Randomness comes from an explicit ``torch.Generator``; ``p_losses`` and
``ddim_sample`` also take their draws as arguments (``t_scene``, ``noise``,
``x_T``, ``change_noise``) so that tests can feed the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..encoders.scene_graph import Graph, SceneGraphEncoder, graph_tensors
from ..parallel.collectives import global_denominator, rank_rows
from .schedules import DDIMSchedule, DiffusionSchedule, q_sample
from .unet1d import UNet1DConfig, UNet1DModel


def angle_to_sincos(angle: torch.Tensor) -> torch.Tensor:
    """(..., 1) angle -> (..., 2) [sin, cos]."""
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def sincos_to_angle(sincos: torch.Tensor) -> torch.Tensor:
    return torch.atan2(sincos[..., 0:1], sincos[..., 1:2])


@dataclasses.dataclass(frozen=True)
class LayoutDiffusionConfig:
    """configs/layout_diffusion/nuscenes/layout_nusc.yaml model.params."""

    timesteps: int = 1000
    beta_schedule: str = "linear"
    linear_start: float = 1e-4
    linear_end: float = 2e-2
    loss_type: str = "l2"
    l_simple_weight: float = 1.0
    parameterization: str = "eps"
    box_dim: int = 8


def _f32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64).astype(np.float32)


class LayoutDiffusion(nn.Module):
    """Box diffusion with a trainable scene-graph conditioning stage."""

    def __init__(self, cfg: LayoutDiffusionConfig, unet_cfg: UNet1DConfig,
                 num_objs: int = 32, num_preds: int = 16, sg_embedding_dim: int = 64,
                 use_clip: bool = True):
        super().__init__()
        self.cfg = cfg
        self.schedule = DiffusionSchedule.create(
            timesteps=cfg.timesteps, beta_schedule=cfg.beta_schedule,
            linear_start=cfg.linear_start, linear_end=cfg.linear_end,
            parameterization=cfg.parameterization)
        self.cond_stage = SceneGraphEncoder(num_objs, num_preds, sg_embedding_dim,
                                           use_clip=use_clip, replace_latent=True)
        self.unet = UNet1DModel(unet_cfg, self.cond_stage.out_dim)

    @property
    def device(self) -> torch.device:
        return self.unet.conv_out.weight.device

    # ------------------------------------------------------------- forward
    def encode_graph(self, graph: Graph, generator: Optional[torch.Generator] = None,
                     change_noise: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(relation latent, object embeddings), each (N, out_dim)."""
        return self.cond_stage(graph, generator, change_noise)

    def apply_model(self, box_t: torch.Tensor, t: torch.Tensor, obj_embed: torch.Tensor,
                    triples: torch.Tensor, condition_cross: torch.Tensor,
                    pred_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.unet(box_t, obj_embed, triples, t, context=condition_cross,
                         pred_mask=pred_mask)

    # ---------------------------------------------------------------- loss
    def p_losses(self, graph: Graph, generator: Optional[torch.Generator] = None,
                 t_scene: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                 change_noise: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The box loss: every box of a scene (``dec_objs_to_scene``) shares
        the scene's t; padding boxes (``obj_mask`` False) are left out. t
        (per scene) and the noise are the given ones, else drawn from
        ``generator`` after the change noise, in JAX's order. Under an
        initialised process group it is a collective: the valid boxes are
        counted over every rank (``global_denominator``), so every rank must
        call it, and the draws are this rank's rows of the global batch's
        (``rank_rows``)."""
        g = graph_tensors(graph, self.device)
        latent, obj_embed = self.encode_graph(g, generator, change_noise)
        boxes = g["dec_boxes"]
        scene_ids = g["dec_objs_to_scene"]
        n_scenes = int(g["n_scenes"]) if "n_scenes" in g else int(scene_ids.max()) + 1
        x_start = torch.cat([boxes[:, :-1], angle_to_sincos(boxes[:, -1:])], dim=-1)
        if t_scene is None:   # under dp: this rank's scenes of the global draws
            t_scene = rank_rows(lambda n: torch.randint(
                0, self.cfg.timesteps, (n,), generator=generator, device=generator.device),
                n_scenes)
        if noise is None:
            noise = rank_rows(lambda n: torch.randn((n, *x_start.shape[1:]), generator=generator,
                                                    device=generator.device), x_start.shape[0])
        t = torch.as_tensor(t_scene).to(self.device).long()[scene_ids]
        noise = torch.as_tensor(noise, dtype=torch.float32).to(self.device)
        x_noisy = q_sample(self.schedule, x_start, t, noise)
        out = self.apply_model(x_noisy, t, obj_embed, g["dec_triples"], latent,
                               g.get("dec_pred_mask"))
        target = noise if self.cfg.parameterization == "eps" else x_start
        diff = out - target
        per = (diff ** 2 if self.cfg.loss_type == "l2" else diff.abs()).mean(dim=-1)   # (N,)
        mask = g.get("obj_mask")
        if mask is not None:
            m = mask.to(per.dtype)
            loss_simple = (per * m).sum() / global_denominator(m.sum())
        else:
            loss_simple = per.mean()
        loss = self.cfg.l_simple_weight * loss_simple
        return loss, {"loss": loss.detach(), "loss_simple": loss_simple.detach()}

    # ------------------------------------------------------------- sampling
    @torch.no_grad()
    def ddim_sample(self, graph: Graph, steps: int = 100, x_T: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    change_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Deterministic DDIM (eta 0, the JAX default that its sampling
        script uses) over (N, box_dim) vectors; returns them in float32. The
        change noise and x_T come from ``generator`` unless given (under an
        initialised process group, this rank's rows of the global batch's
        draw: ``rank_rows``); the step's scalars are float32, as in the JAX
        scan."""
        g = graph_tensors(graph, self.device)
        latent, obj_embed = self.encode_graph(g, generator, change_noise)
        triples, pred_mask = g["dec_triples"], g.get("dec_pred_mask")
        n = obj_embed.shape[0]
        shape = (n, self.cfg.box_dim)
        d = DDIMSchedule.create(self.schedule, steps)
        ts = d.timesteps[::-1]
        a_t, a_prev = _f32(d.alphas[::-1]), _f32(d.alphas_prev[::-1])
        s1ma = _f32(d.sqrt_one_minus_alphas[::-1])
        if x_T is None:   # under dp: this rank's boxes of the global draw
            x_T = rank_rows(lambda k: torch.randn((k, shape[1]), generator=generator,
                                                  device=generator.device), n)
        x = torch.as_tensor(x_T, dtype=torch.float32).to(self.device)
        if tuple(x.shape) != shape:
            raise ValueError(f"x_T has shape {tuple(x.shape)}, expected {shape}")
        for i, t_scalar in enumerate(ts):
            t = torch.full((n,), int(t_scalar), dtype=torch.long, device=x.device)
            e_t = self.apply_model(x, t, obj_embed, triples, latent, pred_mask)
            pred_x0 = (x - float(s1ma[i]) * e_t) / float(np.sqrt(a_t[i]))
            dir_coef = np.sqrt(np.maximum(np.float32(1.0) - a_prev[i], np.float32(0.0)))
            x = float(np.sqrt(a_prev[i])) * pred_x0 + float(dir_coef) * e_t
        return x

    @staticmethod
    def postprocess_boxes(x: torch.Tensor) -> torch.Tensor:
        """(N, 8) [size3, loc3, sin, cos] -> (N, 7) with the angle."""
        return torch.cat([x[:, :6], sincos_to_angle(x[:, 6:8])], dim=-1)
