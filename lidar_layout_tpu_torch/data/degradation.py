"""SR-style image degradation for conditioning on low-resolution range images.

Counterpart of ``lidar_layout_tpu/data/degradation.py``, kept as the port's
own copy of that host numpy (the port imports nothing of the JAX package):
the dataset-side PIL-interpolation downsample (``make_degradation_transform``,
the reference's ``degradation`` + ``scale_factors``, attached as
``degraded_image``) and the BSRGAN-style random blind-SR pipelines
(``degradation_bsrgan_variant`` and its light variant), all seeded through
an explicit ``np.random.Generator``. PIL, cv2 and scipy are imported where
they are used; a missing one raises its ``ImportError``, which names it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

# PIL interpolation modes keyed exactly as the reference's config strings
# (base.py:39-46). Resolved lazily so PIL stays an optional import.
_PIL_MODES = ("pil_nearest", "pil_bilinear", "pil_bicubic", "pil_box",
              "pil_hamming", "pil_lanczos")


def _pil_filter(name: str):
    from PIL import Image

    return {
        "pil_nearest": Image.NEAREST,
        "pil_bilinear": Image.BILINEAR,
        "pil_bicubic": Image.BICUBIC,
        "pil_box": Image.BOX,
        "pil_hamming": Image.HAMMING,
        "pil_lanczos": Image.LANCZOS,
    }[name]


def resize_image(img: np.ndarray, size: Tuple[int, int], mode: str) -> np.ndarray:
    """Resize (H, W) or (H, W, C) float image to ``size=(h, w)`` with a PIL
    filter named by the reference's config string (e.g. ``pil_bilinear``)."""
    from PIL import Image

    filt = _pil_filter(mode)
    squeeze = img.ndim == 2
    arr = img[..., None] if squeeze else img
    outs = [
        np.asarray(Image.fromarray(arr[..., c].astype(np.float32), mode="F")
                   .resize((size[1], size[0]), resample=filt))
        for c in range(arr.shape[-1])
    ]
    out = np.stack(outs, axis=-1).astype(img.dtype)
    return out[..., 0] if squeeze else out


def make_degradation_transform(
        img_size: Tuple[int, int],
        scale_factors: Sequence[float],
        degradation: str) -> Callable[[np.ndarray], np.ndarray]:
    """The dataset hook (base.py:37-47): fixed downsample by ``scale_factors``
    with the named PIL interpolation. Returns img -> degraded img."""
    if degradation not in _PIL_MODES:
        raise ValueError(f"unknown degradation {degradation!r}; "
                         f"expected one of {_PIL_MODES}")
    scaled = (int(img_size[0] / scale_factors[0]),
              int(img_size[1] / scale_factors[1]))
    return lambda img: resize_image(img, scaled, degradation)


# ---------------------------------------------------------------------------
# BSRGAN-style random blind-SR degradation (bsrgan.py:530-613, compact)
# ---------------------------------------------------------------------------


def gaussian_kernel2d(ksize: int, sigma1: float, sigma2: Optional[float] = None,
                      theta: float = 0.0) -> np.ndarray:
    """(An)isotropic 2D Gaussian kernel, unit sum. ``theta`` rotates the major
    axis (bsrgan.py ``anisotropic_Gaussian`` semantics, rebuilt from the
    covariance definition rather than the reference code)."""
    sigma2 = sigma1 if sigma2 is None else sigma2
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s], [s, c]])
    cov = rot @ np.diag([sigma1 ** 2, sigma2 ** 2]) @ rot.T
    icov = np.linalg.inv(cov)
    r = (ksize - 1) / 2.0
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    pts = np.stack([xs, ys], axis=-1)
    expo = -0.5 * np.einsum("...i,ij,...j->...", pts, icov, pts)
    k = np.exp(expo)
    return k / k.sum()


def _conv2(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    from scipy import ndimage

    if img.ndim == 2:
        return ndimage.convolve(img, kernel, mode="mirror")
    return np.stack([ndimage.convolve(img[..., c], kernel, mode="mirror")
                     for c in range(img.shape[-1])], axis=-1)


def _cv_resize(img: np.ndarray, shape_hw: Tuple[int, int],
               rng: np.random.Generator) -> np.ndarray:
    import cv2

    interp = rng.choice([cv2.INTER_LINEAR, cv2.INTER_CUBIC, cv2.INTER_AREA])
    out = cv2.resize(img, (shape_hw[1], shape_hw[0]), interpolation=int(interp))
    if img.ndim == 3 and out.ndim == 2:  # cv2 drops singleton channels
        out = out[..., None]
    return out


def add_blur(img: np.ndarray, rng: np.random.Generator, sf: int = 4,
             light: bool = False) -> np.ndarray:
    hi = 2.0 if light else 8.0
    if rng.random() < 0.5:  # anisotropic
        k = gaussian_kernel2d(2 * rng.integers(2, 6) + 3,
                              sigma1=rng.uniform(0.5, hi * 0.5),
                              sigma2=rng.uniform(0.5, hi * 0.5),
                              theta=rng.uniform(0, np.pi))
    else:
        k = gaussian_kernel2d(2 * rng.integers(2, 6) + 3,
                              sigma1=rng.uniform(0.1, hi * 0.5 / sf * 2))
    return _conv2(img, k)


def add_gaussian_noise(img: np.ndarray, rng: np.random.Generator,
                       noise_level: Tuple[float, float] = (2.0, 25.0)
                       ) -> np.ndarray:
    level = rng.uniform(*noise_level) / 255.0
    u = rng.random()
    if img.ndim == 2 or u < 0.4:  # grayscale / shared noise field
        shape = img.shape[:2] + (() if img.ndim == 2 else (1,))
        noise = rng.normal(0.0, level, shape)
    elif u < 0.8:  # per-channel iid
        noise = rng.normal(0.0, level, img.shape)
    else:  # channel-correlated: one field mixed through a random orthonormal
        c = img.shape[-1]
        q, _ = np.linalg.qr(rng.normal(size=(c, c)))
        base = rng.normal(0.0, level, img.shape)
        noise = base @ q.T
    return np.clip(img + noise, 0.0, 1.0)


def add_poisson_noise(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    vals = 10 ** rng.uniform(2.0, 4.0)
    return np.clip(rng.poisson(np.clip(img, 0, 1) * vals) / vals, 0.0, 1.0)


def add_speckle_noise(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    level = rng.uniform(2.0, 25.0) / 255.0
    return np.clip(img + img * rng.normal(0.0, level, img.shape), 0.0, 1.0)


def add_jpeg_noise(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    import cv2

    quality = int(rng.integers(30, 96))
    u8 = (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    gray = u8.ndim == 2 or u8.shape[-1] == 1
    enc_in = u8[..., 0] if (u8.ndim == 3 and gray) else u8
    ok, enc = cv2.imencode(".jpg", enc_in,
                           [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    assert ok
    dec = cv2.imdecode(enc, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    out = dec.astype(np.float32) / 255.0
    if u8.ndim == 3:
        out = out.reshape(u8.shape[:2] + (-1,))
    return out


def degradation_bsrgan_variant(image: np.ndarray, sf: int = 4,
                               rng: Optional[np.random.Generator] = None,
                               light: bool = False) -> Dict[str, np.ndarray]:
    """Random blind-SR degradation: shuffled {blur, blur, resize, noise,
    JPEG, poisson/speckle} stages with the final sf-downsample kept last, then
    a closing JPEG pass (bsrgan.py:530-613 stage structure). Returns
    ``{"image": lq, "hq": hq}`` with lq = hq spatial size / sf, both in [0,1].

    ``light`` follows bsrgan_light.py: gentler blur, no poisson/speckle.
    """
    rng = rng or np.random.default_rng()
    img = np.asarray(image, np.float32)
    if img.max() > 1.5:  # uint8-range input
        img = img / 255.0
    h, w = img.shape[:2]
    img = img[:h - h % sf, :w - w % sf]
    hq = img.copy()
    h, w = img.shape[:2]

    stages = [0, 1, 2, 3, 4, 5]
    order = list(rng.permutation(stages))
    order.remove(2)
    order.append(2)  # final downsample stays last (bsrgan.py:561-564)

    for op in order:
        if op == 0 or op == 1:
            img = add_blur(img, rng, sf=sf, light=light)
        elif op == 2:  # downsample to the target LQ size
            img = _cv_resize(img, (h // sf, w // sf), rng)
            img = np.clip(img, 0.0, 1.0)
        elif op == 3 and rng.random() < 0.5:  # intermediate random resize
            fac = rng.uniform(0.5, 1.0)
            img = _cv_resize(img, (max(int(h * fac), sf), max(int(w * fac), sf)), rng)
            img = _cv_resize(img, (h, w), rng)
            img = np.clip(img, 0.0, 1.0)
        elif op == 4:
            img = add_gaussian_noise(
                img, rng, (2.0, 8.0) if light else (2.0, 25.0))
        elif op == 5 and not light:
            if rng.random() < 0.5:
                img = add_poisson_noise(img, rng)
            if rng.random() < 0.5:
                img = add_speckle_noise(img, rng)

    if rng.random() < 0.9:  # closing JPEG (jpeg_prob, bsrgan.py:543)
        img = add_jpeg_noise(img, rng)
    if img.shape[:2] != (h // sf, w // sf):
        img = _cv_resize(img, (h // sf, w // sf), rng)
    return {"image": np.clip(img, 0.0, 1.0).astype(np.float32), "hq": hq}


def degradation_bsrgan_light(image: np.ndarray, sf: int = 4,
                             rng: Optional[np.random.Generator] = None
                             ) -> Dict[str, np.ndarray]:
    """bsrgan_light.py counterpart (exported as ``degradation_fn_bsr_light``)."""
    return degradation_bsrgan_variant(image, sf=sf, rng=rng, light=True)


# reference export names (image_degradation/__init__.py)
degradation_fn_bsr = degradation_bsrgan_variant
degradation_fn_bsr_light = degradation_bsrgan_light
