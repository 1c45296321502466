"""Differentiable panoramic (LiDAR) Gaussian rasterization in plain PyTorch.

Counterpart of ``lidar_layout_tpu/ops/gaussian_raster.py``: ``quat_to_rotmat``,
``build_covariance``, ``spherical_project``, ``projection_jacobian``,
``project_covariance``, ``RasterConfig`` and ``rasterize`` (flattened 3D
Gaussians), ``SurfelConfig``, ``pixel_ray_directions`` and
``rasterize_surfels`` (exact ray-disc surfels), ``render_range_image``.

The JAX package composites with no Pallas kernel: one global front-to-back
depth sort (stable, as ``jnp.argsort``), then a scan over fixed-size chunks of
Gaussians, each a dense (pixels, chunk) tile. Within a chunk the
transmittance is an exclusive cumprod, kept in JAX's form ``cumprod(1 - a) /
max(1 - a, 1e-8)`` so the numbers agree; across chunks a per-pixel carry.
Here the scan is a Python loop over the chunks. Autograd over that loop
would keep about ten (pixels, chunk) f32 tensors a chunk (tens of GiB at the
dense decoder's 32x1024 image and 49,152 surfels), so when a gradient is
needed each chunk runs under ``torch.utils.checkpoint``: the backward
recomputes the chunk from its inputs and the carry, and keeps only the
per-pixel carry between chunks. The values do not change.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .lidar import LidarGeometry


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(N, 4) [w, x, y, z] quaternions -> (N, 3, 3) rotations."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp(min=1e-8)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y ** 2 + z ** 2), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x ** 2 + z ** 2), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x ** 2 + y ** 2)], -1),
    ], dim=-2)


def build_covariance(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(N, 4), (N, 3) -> (N, 3, 3) Sigma = R S S^T R^T."""
    s = scales[:, None, :] * quat_to_rotmat(quats)   # R @ diag(s)
    return torch.einsum("nij,nkj->nik", s, s)


def spherical_project(means: torch.Tensor, geom: LidarGeometry
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, 3) -> (u pixel-x, v pixel-y, depth), ``ops.lidar.project_coords``
    scaled to pixels."""
    h, w = geom.size
    depth = torch.linalg.vector_norm(means, dim=-1)
    yaw = -torch.atan2(means[:, 1], means[:, 0])
    pitch = torch.asin((means[:, 2] / depth.clamp(min=1e-8)).clamp(-1, 1))
    u = 0.5 * (yaw / math.pi + 1.0) * w
    v = (1.0 - (pitch + abs(geom.fov_down)) / geom.fov_range) * h
    return u, v, depth


def projection_jacobian(means: torch.Tensor, geom: LidarGeometry) -> torch.Tensor:
    """(N, 3) -> (N, 2, 3) Jacobian d(u, v)/d(xyz) of the panoramic projection."""
    h, w = geom.size
    x, y, z = means[:, 0], means[:, 1], means[:, 2]
    r2_xy = (x ** 2 + y ** 2).clamp(min=1e-8)
    r_xy = torch.sqrt(r2_xy)
    r2 = (x ** 2 + y ** 2 + z ** 2).clamp(min=1e-8)
    ku = w / (2.0 * math.pi)
    du = torch.stack([ku * y / r2_xy, -ku * x / r2_xy, torch.zeros_like(x)], -1)
    kv = -h / geom.fov_range
    dpitch = torch.stack([-x * z / (r2 * r_xy), -y * z / (r2 * r_xy), r_xy / r2], -1)
    return torch.stack([du, kv * dpitch], dim=-2)


def project_covariance(cov3d: torch.Tensor, means: torch.Tensor, geom: LidarGeometry,
                       blur: float = 0.3) -> torch.Tensor:
    """(N, 3, 3) world covariance -> (N, 2, 2) screen covariance plus a
    ``blur`` floor on the diagonal."""
    j = projection_jacobian(means, geom)
    cov2d = torch.einsum("nij,njk,nlk->nil", j, cov3d, j)
    return cov2d + blur * torch.eye(2, dtype=cov2d.dtype, device=cov2d.device)


def inverse_cov2d(cov2d: torch.Tensor) -> torch.Tensor:
    """(N, 2, 2) -> (N, 4) flattened inverse [a, b, b, c], the determinant
    floored at 1e-8 (the JAX rasterizers' inline inverse)."""
    det = (cov2d[:, 0, 0] * cov2d[:, 1, 1] - cov2d[:, 0, 1] ** 2).clamp(min=1e-8)
    inv = torch.stack([torch.stack([cov2d[:, 1, 1], -cov2d[:, 0, 1]], -1),
                       torch.stack([-cov2d[:, 0, 1], cov2d[:, 0, 0]], -1)], -2)
    return (inv / det[:, None, None]).reshape(-1, 4)


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    chunk: int = 256           # Gaussians composited a step
    alpha_thresh: float = 1.0 / 255.0
    max_alpha: float = 0.99
    cutoff_sigma2: float = 9.0  # 3-sigma support cutoff
    blur: float = 0.3


def pixel_grid(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flattened (H*W,) pixel-centre x and y, f32, row-major."""
    px = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    py = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    return px[None, :].expand(h, w).reshape(-1), py[:, None].expand(h, w).reshape(-1)


def composite_step(alpha: torch.Tensor, depth: torch.Tensor, feat: torch.Tensor,
                   carry: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Front-to-back compositing of one chunk: alpha (..., P, K) in depth
    order, depth (K,) / (..., K) per Gaussian or (..., P, K) per pixel, feat
    (..., K, F); carry (T, feature, depth, alpha) -> the new carry."""
    t, acc_f, acc_d, acc_a = carry
    one_minus = 1.0 - alpha
    trans_in = torch.cumprod(one_minus, dim=-1) / one_minus.clamp(min=1e-8)
    wgt = alpha * trans_in * t[..., None]
    acc_f = acc_f + torch.matmul(wgt, feat)
    if depth.dim() == wgt.dim():
        acc_d = acc_d + torch.sum(wgt * depth, dim=-1)
    else:
        acc_d = acc_d + torch.matmul(wgt, depth[..., None])[..., 0]
    return t * torch.prod(one_minus, dim=-1), acc_f, acc_d, acc_a + wgt.sum(dim=-1)


def gaussian_alpha(dx: torch.Tensor, dy: torch.Tensor, inv: torch.Tensor, op: torch.Tensor,
                   w: int, cfg) -> torch.Tensor:
    """Alpha of flattened Gaussians at pixel offsets (dx, dy) (..., P, K),
    the azimuth offset wrapped to the nearest of its 360-degree copies; inv
    (..., K, 4), opacities (..., K)."""
    dx = dx - w * torch.round(dx / w)
    a, b, c = inv[..., None, :, 0], inv[..., None, :, 1], inv[..., None, :, 3]
    power = -0.5 * (a * dx * dx + 2 * b * dx * dy + c * dy * dy)
    alpha = (op[..., None, :] * torch.exp(power.clamp(max=0.0))).clamp(max=cfg.max_alpha)
    alpha = torch.where(power < -0.5 * cfg.cutoff_sigma2, 0.0, alpha)
    return torch.where(alpha < cfg.alpha_thresh, 0.0, alpha)


def run_chunks(body: Callable, carry: Tuple[torch.Tensor, ...],
               chunks: Sequence[Sequence[torch.Tensor]]) -> Tuple[torch.Tensor, ...]:
    """``carry = body(*carry, *chunk)`` for every chunk in order; each chunk
    under ``checkpoint`` when a gradient is needed (the backward recomputes
    it, keeping only the carries between chunks)."""
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for c in chunks for t in c)
    for chunk in chunks:
        if grad:
            carry = checkpoint(body, *carry, *chunk, use_reentrant=False)
        else:
            carry = body(*carry, *chunk)
    return carry


def _chunked(x: torch.Tensor, n_chunks: int, chunk: int):
    """Zero-pad the first axis to ``n_chunks * chunk`` and split it."""
    pad = n_chunks * chunk - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
    return x.split(chunk)


def _init_carry(p: int, f_dim: int, device) -> Tuple[torch.Tensor, ...]:
    return (torch.ones((p,), device=device), torch.zeros((p, f_dim), device=device),
            torch.zeros((p,), device=device), torch.zeros((p,), device=device))


def _outputs(carry, h: int, w: int) -> Dict[str, torch.Tensor]:
    t, acc_f, acc_d, acc_a = carry
    return {"feature": acc_f.reshape(h, w, -1), "alpha": acc_a.reshape(h, w),
            "depth": acc_d.reshape(h, w), "transmittance": t.reshape(h, w)}


def rasterize(means: torch.Tensor, quats: torch.Tensor, scales: torch.Tensor,
              opacities: torch.Tensor, features: torch.Tensor, geom: LidarGeometry,
              mask: Optional[torch.Tensor] = None,
              cfg: RasterConfig = RasterConfig()) -> Dict[str, torch.Tensor]:
    """Render flattened 3D Gaussians into the panorama.

    means (N, 3), quats (N, 4), scales (N, 3), opacities (N,) in [0, 1],
    features (N, F), mask (N,) for padded Gaussians. Returns feature (H, W,
    F), alpha (H, W), depth (H, W) alpha-weighted expected depth and
    transmittance (H, W)."""
    h, w = geom.size
    n = features.shape[0]
    u, v, depth = spherical_project(means, geom)
    valid = depth > 1e-3
    if mask is not None:
        valid = valid & mask
    inv = inverse_cov2d(project_covariance(build_covariance(quats, scales), means, geom,
                                           cfg.blur))
    order = torch.argsort(torch.where(valid, depth, math.inf), stable=True)
    op = torch.where(valid, opacities, 0.0)
    pxf, pyf = pixel_grid(h, w, means.device)
    n_chunks = -(-n // cfg.chunk)
    chunks = list(zip(*(_chunked(x[order], n_chunks, cfg.chunk)
                        for x in (u, v, depth, inv, op, features))))

    def body(t, acc_f, acc_d, acc_a, cu, cv, cd, cinv, cop, cfeat):
        alpha = gaussian_alpha(pxf[:, None] - cu[None, :], pyf[:, None] - cv[None, :],
                               cinv, cop, w, cfg)
        return composite_step(alpha, cd, cfeat, (t, acc_f, acc_d, acc_a))

    carry = run_chunks(body, _init_carry(h * w, features.shape[1], means.device), chunks)
    return _outputs(carry, h, w)


@dataclasses.dataclass(frozen=True)
class SurfelConfig:
    """Config of the exact ray-disc surfel rasterizer."""
    chunk: int = 256
    alpha_thresh: float = 1.0 / 255.0
    max_alpha: float = 0.99
    cutoff_sigma2: float = 9.0   # 3-sigma support cutoff (tangent-frame units)
    filter_sigma_px: float = 0.7071   # 2DGS low-pass: screen-space sigma (px)
    z_near: float = 1e-2


def pixel_ray_directions(geom: LidarGeometry, device=None) -> torch.Tensor:
    """(H*W, 3) unit ray directions through every pixel centre, f32: the
    inverse of ``spherical_project``'s pixel mapping."""
    h, w = geom.size
    px = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    py = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    yaw = (2.0 * px / w - 1.0) * math.pi
    pitch = (1.0 - py / h) * geom.fov_range - abs(geom.fov_down)
    az = -yaw
    cp = torch.cos(pitch)[:, None]
    d = torch.stack([(cp * torch.cos(az)[None, :]).expand(h, w),
                     (cp * torch.sin(az)[None, :]).expand(h, w),
                     torch.sin(pitch)[:, None].expand(h, w)], dim=-1)
    return d.reshape(h * w, 3)


def rasterize_surfels(means: torch.Tensor, quats: torch.Tensor, scales: torch.Tensor,
                      opacities: torch.Tensor, features: torch.Tensor, geom: LidarGeometry,
                      mask: Optional[torch.Tensor] = None,
                      cfg: SurfelConfig = SurfelConfig()) -> Dict[str, torch.Tensor]:
    """Exact ray-disc surfel rasterization (2DGS): each ray meets the surfel's
    plane, the Gaussian is evaluated there in the surfel's tangent frame
    (axes = the rotation's first two columns over ``scales[:, :2]``) and
    composited at the true per-ray depth, with a screen-space low-pass floor
    (min of the object- and image-space distances). Arguments and outputs
    as ``rasterize``; the third scale is not read."""
    h, w = geom.size
    n = features.shape[0]
    ucen, vcen, center_depth = spherical_project(means, geom)
    valid = center_depth > cfg.z_near
    if mask is not None:
        valid = valid & mask
    rot = quat_to_rotmat(quats)
    a_u = rot[:, :, 0] / scales[:, 0].clamp(min=1e-6)[:, None]
    a_v = rot[:, :, 1] / scales[:, 1].clamp(min=1e-6)[:, None]
    nrm = rot[:, :, 2]
    pu, pv, pn = ((means * a).sum(-1) for a in (a_u, a_v, nrm))
    order = torch.argsort(torch.where(valid, center_depth, math.inf), stable=True)
    op = torch.where(valid, opacities, 0.0)
    rays = pixel_ray_directions(geom, means.device)
    pxf, pyf = pixel_grid(h, w, means.device)
    n_chunks = -(-n // cfg.chunk)
    chunks = list(zip(*(_chunked(x[order], n_chunks, cfg.chunk)
                        for x in (a_u, a_v, nrm, pu, pv, pn, ucen, vcen, center_depth, op,
                                  features))))
    inv_filt2 = 1.0 / (cfg.filter_sigma_px ** 2)

    def body(t, acc_f, acc_d, acc_a, cau, cav, cn, cpu_, cpv, cpn, cuc, cvc, ccd, cop, cfeat):
        dn = rays @ cn.T
        du = rays @ cau.T
        dv = rays @ cav.T
        safe_dn = torch.where(dn.abs() < 1e-8, torch.where(dn < 0, -1e-8, 1e-8), dn)
        z = cpn[None, :] / safe_dn
        hit = z > cfg.z_near
        uu = z * du - cpu_[None, :]
        vv = z * dv - cpv[None, :]
        rho3d = torch.where(hit, uu * uu + vv * vv, math.inf)
        dx = pxf[:, None] - cuc[None, :]
        dx = dx - w * torch.round(dx / w)
        dy = pyf[:, None] - cvc[None, :]
        rho2d = (dx * dx + dy * dy) * inv_filt2
        rho = torch.minimum(rho3d, rho2d)
        alpha = (cop[None, :] * torch.exp(-0.5 * rho.clamp(max=87.0))).clamp(max=cfg.max_alpha)
        alpha = torch.where(rho > cfg.cutoff_sigma2, 0.0, alpha)
        alpha = torch.where(alpha < cfg.alpha_thresh, 0.0, alpha)
        zdep = torch.where(hit & (rho3d <= rho2d), z, ccd[None, :])
        return composite_step(alpha, zdep, cfeat, (t, acc_f, acc_d, acc_a))

    carry = run_chunks(body, _init_carry(h * w, features.shape[1], means.device), chunks)
    return _outputs(carry, h, w)


def render_range_image(means: torch.Tensor, quats: torch.Tensor, scales: torch.Tensor,
                       opacities: torch.Tensor, intensities: torch.Tensor,
                       geom: LidarGeometry, mask: Optional[torch.Tensor] = None,
                       cfg: RasterConfig = RasterConfig()) -> Dict[str, torch.Tensor]:
    """Expected depth as the range image, with an intensity and a ray-drop
    channel (GSDecoder's render): range and intensity alpha-normalised,
    raydrop = 1 - alpha."""
    feats = torch.stack([intensities, torch.ones_like(intensities)], dim=-1)
    out = rasterize(means, quats, scales, opacities, feats, geom, mask, cfg)
    alpha = out["alpha"].clamp(min=1e-6)
    return {"range": out["depth"] / alpha, "intensity": out["feature"][..., 0] / alpha,
            "raydrop": 1.0 - out["alpha"], "alpha": out["alpha"]}
