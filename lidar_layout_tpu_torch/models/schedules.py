"""Diffusion noise schedules, computed in numpy float64 as in the JAX package.

Counterpart of ``lidar_layout_tpu/models/schedules.py``. The tables stay
numpy; ``extract`` moves the rows it needs to the caller's device as float32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def make_beta_schedule(schedule: str, n_timestep: int, linear_start: float = 1e-4,
                       linear_end: float = 2e-2, cosine_s: float = 8e-3) -> np.ndarray:
    if schedule == "linear":
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                            dtype=np.float64) ** 2
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule '{schedule}' unknown")
    return betas


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """The DDPM buffers (reference ddpm.py register_schedule), numpy float64."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    lvlb_weights: np.ndarray
    num_timesteps: int
    linear_start: float
    linear_end: float

    @classmethod
    def create(cls, timesteps: int = 1000, beta_schedule: str = "linear",
               linear_start: float = 1e-4, linear_end: float = 2e-2,
               cosine_s: float = 8e-3, v_posterior: float = 0.0,
               parameterization: str = "eps") -> "DiffusionSchedule":
        betas = make_beta_schedule(beta_schedule, timesteps, linear_start,
                                   linear_end, cosine_s)
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])

        posterior_variance = ((1 - v_posterior) * betas
                              * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
                              + v_posterior * betas)
        if parameterization == "eps":
            with np.errstate(divide="ignore"):
                lvlb = betas ** 2 / (2 * posterior_variance * alphas
                                     * (1 - alphas_cumprod))
        elif parameterization == "x0":
            lvlb = 0.5 * np.sqrt(alphas_cumprod) / (2.0 - alphas_cumprod)
        else:
            raise NotImplementedError(parameterization)
        lvlb = lvlb.copy()
        lvlb[0] = lvlb[1]

        return cls(
            betas=betas,
            alphas_cumprod=alphas_cumprod,
            alphas_cumprod_prev=alphas_cumprod_prev,
            sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
            sqrt_recip_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod),
            sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1),
            posterior_variance=posterior_variance,
            posterior_log_variance_clipped=np.log(np.maximum(posterior_variance, 1e-20)),
            posterior_mean_coef1=betas * np.sqrt(alphas_cumprod_prev) / (1 - alphas_cumprod),
            posterior_mean_coef2=(1 - alphas_cumprod_prev) * np.sqrt(alphas) / (1 - alphas_cumprod),
            lvlb_weights=lvlb,
            num_timesteps=timesteps,
            linear_start=linear_start,
            linear_end=linear_end,
        )


def extract(a: np.ndarray, t: torch.Tensor, broadcast_ndim: int) -> torch.Tensor:
    """Per-timestep coefficients (float32, on t's device) broadcast over
    trailing dims."""
    out = torch.as_tensor(np.asarray(a, np.float32), device=t.device)[t]
    return out.reshape(t.shape[0], *([1] * (broadcast_ndim - 1)))


def q_sample(sched: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion x_t = sqrt(acp_t) x_0 + sqrt(1 - acp_t) eps."""
    return (extract(sched.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
            + extract(sched.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise)


def predict_start_from_noise(sched: DiffusionSchedule, x_t: torch.Tensor,
                             t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    return (extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
            - extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * noise)


def q_posterior(sched: DiffusionSchedule, x_start: torch.Tensor, x_t: torch.Tensor,
                t: torch.Tensor):
    """Mean, variance and clipped log-variance of q(x_{t-1} | x_t, x_0)."""
    mean = (extract(sched.posterior_mean_coef1, t, x_t.ndim) * x_start
            + extract(sched.posterior_mean_coef2, t, x_t.ndim) * x_t)
    var = extract(sched.posterior_variance, t, x_t.ndim)
    log_var = extract(sched.posterior_log_variance_clipped, t, x_t.ndim)
    return mean, var, log_var


def make_ddim_timesteps(method: str, num_ddim_steps: int,
                        num_ddpm_steps: int) -> np.ndarray:
    """DDIM step ids, shifted by +1 as in the reference."""
    if method == "uniform":
        c = num_ddpm_steps // num_ddim_steps
        steps = np.asarray(list(range(0, num_ddpm_steps, c)))
    elif method == "quad":
        steps = ((np.linspace(0, np.sqrt(num_ddpm_steps * 0.8), num_ddim_steps)) ** 2
                 ).astype(int)
    else:
        raise NotImplementedError(method)
    return steps + 1


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Per-DDIM-step coefficient tables, numpy float64."""

    timesteps: np.ndarray        # ascending ddpm step ids
    alphas: np.ndarray
    alphas_prev: np.ndarray
    sqrt_one_minus_alphas: np.ndarray
    sigmas: np.ndarray

    @classmethod
    def create(cls, sched: DiffusionSchedule, num_steps: int, eta: float = 0.0,
               method: str = "uniform") -> "DDIMSchedule":
        ts = make_ddim_timesteps(method, num_steps, sched.num_timesteps)
        ts = np.clip(ts, 0, sched.num_timesteps - 1)
        acp = sched.alphas_cumprod
        alphas = acp[ts]
        alphas_prev = np.asarray([acp[0]] + acp[ts[:-1]].tolist())
        sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas)
                               * (1 - alphas / alphas_prev))
        return cls(timesteps=ts, alphas=alphas, alphas_prev=alphas_prev,
                   sqrt_one_minus_alphas=np.sqrt(1.0 - alphas), sigmas=sigmas)
