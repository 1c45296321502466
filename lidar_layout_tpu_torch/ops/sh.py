"""Real spherical harmonics evaluation (degree <= 3).

Counterpart of ``lidar_layout_tpu/ops/sh.py`` (``eval_sh``, the PlenOctree
polynomial basis). The sensor sits at the origin, so a Gaussian's viewing
direction is its normalised centre; the Gaussian range autoencoder collapses
its (N, 4, 16) coefficients to four feature channels with it.
"""
from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH of degree ``deg`` at unit directions: ``sh`` (..., C, (deg+1)**2)
    coefficients, ``dirs`` (..., 3) -> (..., C), in the JAX package's order
    of terms."""
    assert 0 <= deg <= 3
    assert sh.shape[-1] >= (deg + 1) ** 2

    result = C0 * sh[..., 0]
    if deg == 0:
        return result
    x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
    result = result - C1 * y * sh[..., 1] + C1 * z * sh[..., 2] - C1 * x * sh[..., 3]
    if deg == 1:
        return result
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    result = (result
              + C2[0] * xy * sh[..., 4]
              + C2[1] * yz * sh[..., 5]
              + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
              + C2[3] * xz * sh[..., 7]
              + C2[4] * (xx - yy) * sh[..., 8])
    if deg == 2:
        return result
    return (result
            + C3[0] * y * (3 * xx - yy) * sh[..., 9]
            + C3[1] * xy * z * sh[..., 10]
            + C3[2] * y * (4 * zz - xx - yy) * sh[..., 11]
            + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12]
            + C3[4] * x * (4 * zz - xx - yy) * sh[..., 13]
            + C3[5] * z * (xx - yy) * sh[..., 14]
            + C3[6] * x * (xx - 3 * yy) * sh[..., 15])
