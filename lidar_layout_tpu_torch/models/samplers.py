"""Samplers: DDIM, PLMS, DPM-Solver++(2M) and DDPM over NHWC latents (inference).

Counterpart of ``lidar_layout_tpu/models/samplers.py`` (``_cfg_apply``,
``ddim_sample``, ``plms_sample``, ``dpm_solver_sample``, ``ddpm_sample``). The per-step tables come from numpy
float64 exactly as in the JAX package, are cast to float32 there as JAX casts
them, and each step's scalar arithmetic is done in np.float32 so that it
rounds as the JAX scan does. The loop is a Python loop over eager torch ops.

Every sampler takes an optional ``x_T``, as the reference's
``DDIMSampler.sample(x_T=...)``; without it, and for the noise of DDIM with
eta > 0 and of DDPM, it draws from the caller's ``torch.Generator`` through
``_randn``. Under an initialised process group ``shape[0]`` is this rank's
share and ``_randn`` keeps this rank's rows of the draw at the global batch's
size (``parallel.collectives.rank_rows``): the same call in one process draws
other noise, and every rank must sample in step with the others.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..parallel.collectives import rank_rows
from .diffusion import LatentDiffusion
from .schedules import DDIMSchedule, q_sample


def _tree_cat(u: Any, c: Any) -> Any:
    """``torch.cat([u, c])`` leaf by leaf over matching (nested) dicts, as
    JAX's ``jax.tree.map`` of the concatenation, booleans included."""
    if isinstance(u, dict):
        if set(u) != set(c):
            raise ValueError(f"uncond keys {sorted(u)} differ from cond keys {sorted(c)}")
        return {k: _tree_cat(u[k], c[k]) for k in c}
    return torch.cat([u, c])


def _cfg_apply(model: LatentDiffusion, x: torch.Tensor, t: torch.Tensor, cond: Any,
               uncond: Any, scale: float) -> torch.Tensor:
    """Model eval with classifier-free guidance (one doubled batch; a
    conditioning pytree is doubled leaf by leaf)."""
    if uncond is None or scale == 1.0:
        return model.apply_model(x, t, cond)
    out = model.apply_model(torch.cat([x, x]), torch.cat([t, t]), _tree_cat(uncond, cond))
    e_uncond, e_cond = out.chunk(2)
    return e_uncond + scale * (e_cond - e_uncond)


def _randn(shape: Tuple[int, ...], generator: Optional[torch.Generator],
           device) -> torch.Tensor:
    """Every Gaussian draw of the samplers, in order; under dp, this rank's
    rows of the draw at the global batch's size."""
    return rank_rows(lambda n: torch.randn((n, *shape[1:]), generator=generator, device=device,
                                           dtype=torch.float32), shape[0])


def _initial(shape: Tuple[int, ...], x_T: Optional[torch.Tensor],
             generator: Optional[torch.Generator], device) -> torch.Tensor:
    device = resolve_device(device)
    if x_T is not None:
        if tuple(x_T.shape) != tuple(shape):
            raise ValueError(f"x_T has shape {tuple(x_T.shape)}, expected {shape}")
        return x_T.to(device=device, dtype=torch.float32)
    return _randn(shape, generator, device)


def _f32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64).astype(np.float32)


def ddim_sample(model: LatentDiffusion, shape: Tuple[int, ...], steps: int = 50,
                eta: float = 0.0, cond: Any = None, uncond: Any = None,
                cfg_scale: float = 1.0, mask: Optional[torch.Tensor] = None,
                x0: Optional[torch.Tensor] = None, temperature: float = 1.0,
                method: str = "uniform", x_T: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, device="cuda",
                return_pred_x0: bool = False):
    """DDIM loop; returns the NHWC float32 latent, and with ``return_pred_x0``
    also each step's predicted x0 stacked, (steps, *shape). ``mask`` and
    ``x0`` inpaint: before each step the region where ``mask`` is 1 is set
    to ``x0`` diffused to that step (the reference keeps it on the forward
    trajectory). A step that inpaints or has eta > 0 draws one Gaussian from
    ``generator`` and uses it for both, as the JAX scan does."""
    if (mask is None) != (x0 is None):
        raise ValueError("inpainting needs both mask and x0")
    dsched = DDIMSchedule.create(model.schedule, steps, eta, method)
    ts = dsched.timesteps[::-1]
    a_t, a_prev = _f32(dsched.alphas[::-1]), _f32(dsched.alphas_prev[::-1])
    sqrt_1ma, sigmas = _f32(dsched.sqrt_one_minus_alphas[::-1]), _f32(dsched.sigmas[::-1])

    img = _initial(shape, x_T, generator, device)
    b = shape[0]
    preds = []
    for i, t_scalar in enumerate(ts):
        t = torch.full((b,), int(t_scalar), dtype=torch.long, device=img.device)
        at, aprev, s1ma, sigma = a_t[i], a_prev[i], sqrt_1ma[i], sigmas[i]
        noise = (_randn(shape, generator, img.device) if mask is not None or sigma != 0.0
                 else None)
        if mask is not None:
            img = q_sample(model.schedule, x0, t, noise) * mask + (1.0 - mask) * img
        out = _cfg_apply(model, img, t, cond, uncond, cfg_scale)
        e_t = model.eps_from_model_out(img, t, out)
        pred_x0 = (img - float(s1ma) * e_t) / float(np.sqrt(at))
        dir_coef = np.sqrt(np.maximum(np.float32(1.0) - aprev - sigma * sigma,
                                      np.float32(0.0)))
        img = float(np.sqrt(aprev)) * pred_x0 + float(dir_coef) * e_t
        if sigma != 0.0:
            img = img + float(sigma) * noise * temperature
        if return_pred_x0:
            preds.append(pred_x0)
    return (img, torch.stack(preds)) if return_pred_x0 else img


def dpm_solver_sample(model: LatentDiffusion, shape: Tuple[int, ...], steps: int = 20,
                      cond: Any = None, uncond: Any = None, cfg_scale: float = 1.0,
                      method: str = "uniform", x_T: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      device="cuda") -> torch.Tensor:
    """DPM-Solver++(2M) (Lu et al. 2022): second-order multistep in data-
    prediction form, one model eval per step, first step first-order."""
    dsched = DDIMSchedule.create(model.schedule, steps, 0.0, method)
    acp_cur = dsched.alphas[::-1].copy()
    acp_next = dsched.alphas_prev[::-1].copy()
    alpha_c, sigma_c = np.sqrt(acp_cur), np.sqrt(1.0 - acp_cur)
    alpha_n, sigma_n = np.sqrt(acp_next), np.sqrt(1.0 - acp_next)
    lam_c = np.log(alpha_c / sigma_c)
    lam_n = np.log(alpha_n / sigma_n)
    h = lam_n - lam_c
    h_prev = np.concatenate([h[:1], h[:-1]])  # unused at step 0
    # h == 0 (duplicate clipped timesteps) is an identity step; a zero h_prev
    # would blow up the 1/(2r) correction, so that step stays first-order
    r = np.where(h != 0.0, h_prev / np.where(h == 0.0, 1.0, h), 1.0)
    ms_ok = h_prev > 0.0
    r = np.maximum(r, 1e-4)
    ac_t, sc_t, an_t, sn_t, h_t, r_t = (_f32(a) for a in
                                        (alpha_c, sigma_c, alpha_n, sigma_n, h, r))
    ts = dsched.timesteps[::-1]

    img = _initial(shape, x_T, generator, device)
    b = shape[0]
    x0_prev = None
    for i, t_scalar in enumerate(ts):
        t = torch.full((b,), int(t_scalar), dtype=torch.long, device=img.device)
        out = _cfg_apply(model, img, t, cond, uncond, cfg_scale)
        e_t = model.eps_from_model_out(img, t, out)
        x0 = (img - float(sc_t[i]) * e_t) / float(ac_t[i])
        if i > 0 and ms_ok[i]:
            c2 = np.float32(1.0) / (np.float32(2.0) * r_t[i])
            d = float(np.float32(1.0) + c2) * x0 - float(c2) * x0_prev
        else:
            d = x0
        img = float(sn_t[i] / sc_t[i]) * img - float(an_t[i] * np.expm1(-h_t[i])) * d
        x0_prev = x0
    return img


def plms_sample(model: LatentDiffusion, shape: Tuple[int, ...], steps: int = 50,
                cond: Any = None, uncond: Any = None, cfg_scale: float = 1.0,
                method: str = "uniform", x_T: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                device="cuda") -> torch.Tensor:
    """PLMS: Adams-Bashforth multistep on epsilon (eta 0). The first step
    refines with a second model eval at the next timestep; the next ones use
    the 2-, 3- and then 4-tap history, as the reference does."""
    dsched = DDIMSchedule.create(model.schedule, steps, 0.0, method)
    ts = dsched.timesteps[::-1]
    ts_next = np.concatenate([ts[1:], [0]])
    a_t, a_prev = _f32(dsched.alphas[::-1]), _f32(dsched.alphas_prev[::-1])
    sqrt_1ma = _f32(dsched.sqrt_one_minus_alphas[::-1])

    img = _initial(shape, x_T, generator, device)
    b = shape[0]

    def get_prev(x, e_t, i):
        pred_x0 = (x - float(sqrt_1ma[i]) * e_t) / float(np.sqrt(a_t[i]))
        dir_coef = np.sqrt(np.maximum(np.float32(1.0) - a_prev[i], np.float32(0.0)))
        return float(np.sqrt(a_prev[i])) * pred_x0 + float(dir_coef) * e_t

    old_eps = []
    for i, t_scalar in enumerate(ts):
        t = torch.full((b,), int(t_scalar), dtype=torch.long, device=img.device)
        e_t = model.eps_from_model_out(img, t, _cfg_apply(model, img, t, cond, uncond,
                                                          cfg_scale))
        if not old_eps:
            t_next = torch.full((b,), int(ts_next[i]), dtype=torch.long, device=img.device)
            x_prev = get_prev(img, e_t, i)
            e_next = model.eps_from_model_out(
                x_prev, t_next, _cfg_apply(model, x_prev, t_next, cond, uncond, cfg_scale))
            e_prime = (e_t + e_next) / 2.0
        elif len(old_eps) == 1:
            e_prime = (3.0 * e_t - old_eps[-1]) / 2.0
        elif len(old_eps) == 2:
            e_prime = (23.0 * e_t - 16.0 * old_eps[-1] + 5.0 * old_eps[-2]) / 12.0
        else:
            e_prime = (55.0 * e_t - 59.0 * old_eps[-1] + 37.0 * old_eps[-2]
                       - 9.0 * old_eps[-3]) / 24.0
        img = get_prev(img, e_prime, i)
        old_eps = (old_eps + [e_t])[-3:]
    return img


def ddpm_sample(model: LatentDiffusion, shape: Tuple[int, ...], cond: Any = None,
                clip_denoised: bool = True, x_T: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                device="cuda") -> torch.Tensor:
    """Ancestral sampling over all T steps; each step draws its noise (the
    last step draws it too and adds none, as the JAX scan does)."""
    s = model.schedule
    c1, c2 = _f32(s.posterior_mean_coef1), _f32(s.posterior_mean_coef2)
    logvar = _f32(s.posterior_log_variance_clipped)
    sr, srm1 = _f32(s.sqrt_recip_alphas_cumprod), _f32(s.sqrt_recipm1_alphas_cumprod)

    img = _initial(shape, x_T, generator, device)
    b = shape[0]
    for t_scalar in range(s.num_timesteps - 1, -1, -1):
        t = torch.full((b,), t_scalar, dtype=torch.long, device=img.device)
        out = model.apply_model(img, t, cond)
        if model.cfg.parameterization == "eps":
            x0 = float(sr[t_scalar]) * img - float(srm1[t_scalar]) * out
        else:
            x0 = out
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
        mean = float(c1[t_scalar]) * x0 + float(c2[t_scalar]) * img
        noise = _randn(shape, generator, img.device)
        img = mean + float(t_scalar > 0) * float(np.exp(np.float32(0.5) * logvar[t_scalar])) \
            * noise
    return img
