"""PyTorch port vs the JAX package: patched (``split_ks``) serving.

``ops/foldunfold`` (unfold, fold, ``patched_apply_scaled``) against JAX's to
1e-6 on seeded numpy inputs, with circular wrap and a ragged row of
patches; then the tiny flagship at twice its training azimuth, patched at
JAX's own test setting ``split_ks`` (4, 16), ``split_stride`` (4, 8)
(``tests/test_train_integration.py``): ``apply_model``, the patched encode
and the patched decode against JAX's on the same weights
(``torch_port_helpers.jax_ldm_params``), and ``GenerationPipeline`` on the
CPU through the patched path. Float32 on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship as jax_flagship
from lidar_layout_tpu.models.diffusion import LatentDiffusion as JLatentDiffusion
from lidar_layout_tpu.ops import foldunfold as JF
from lidar_layout_tpu_torch.flagship import flagship
from lidar_layout_tpu_torch.ops import foldunfold as PF
from lidar_layout_tpu_torch.ops.lidar import KITTI_GEOMETRY
from lidar_layout_tpu_torch.pipeline import GenerationPipeline
from torch_port_helpers import jax_ldm_params, nchw, nhwc, one_intra_op_thread, seed_weights

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
SPLIT_KS, SPLIT_STRIDE = (4, 16), (4, 8)


@pytest.mark.parametrize("shape,patch,stride", [
    ((2, 8, 32, 3), (8, 16), (8, 8)),      # one row, the last patch wraps
    ((1, 10, 24, 2), (4, 8), (3, 5)),      # a ragged last row, uneven wrap
])
def test_unfold_and_fold_match_jax(shape, patch, stride):
    """The tiles, their coordinates and the weighted fold equal JAX's to
    1e-6 (the same f32 sums in the same order)."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jt, jc = JF.unfold_patches(jnp.asarray(x), patch, stride)
    pt, pc = PF.unfold_patches(nchw(x), patch, stride)
    assert pc == jc
    np.testing.assert_array_equal(pt.permute(0, 1, 3, 4, 2).numpy(), np.asarray(jt))
    t = np.random.default_rng(1).standard_normal(np.asarray(jt).shape).astype(np.float32)
    want = np.asarray(JF.fold_patches(jnp.asarray(t), jc, shape))
    got = PF.fold_patches(torch.from_numpy(t).permute(0, 1, 4, 2, 3), pc,
                          (shape[0], shape[3], *shape[1:3]))
    np.testing.assert_allclose(nhwc(got), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("scale", [(1.0, 1.0), (0.5, 0.5), (2.0, 4.0)])
def test_patched_apply_scaled_matches_jax(scale):
    """A resolution-changing fn (identity, 2x2 mean pool, nearest upsample)
    patched with wrap: JAX's canvas to 1e-6."""
    x = np.random.default_rng(2).standard_normal((2, 8, 32, 2)).astype(np.float32)
    if scale == (0.5, 0.5):
        def jfn(t):
            b, h, w, c = t.shape
            return t.reshape(b, h // 2, 2, w // 2, 2, c).mean((2, 4))

        def pfn(t):
            return torch.nn.functional.avg_pool2d(t, 2)
    elif scale == (2.0, 4.0):
        def jfn(t):
            return jnp.repeat(jnp.repeat(t, 2, axis=1), 4, axis=2)

        def pfn(t):
            return t.repeat_interleave(2, dim=2).repeat_interleave(4, dim=3)
    else:
        def jfn(t):
            return t

        pfn = jfn
    want = np.asarray(JF.patched_apply_scaled(jfn, jnp.asarray(x), (8, 16), (8, 8), scale))
    got = PF.patched_apply_scaled(pfn, nchw(x), (8, 16), (8, 8), scale)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def split_pair():
    port, image_shape = flagship(tiny=True, device="cpu", split=True)
    seed_weights(port, 41)
    jbase, _ = jax_flagship(tiny=True)
    jcfg = dataclasses.replace(jbase.cfg, latent_shape=port.cfg.latent_shape,
                               split_ks=SPLIT_KS, split_stride=SPLIT_STRIDE)
    jmodel = JLatentDiffusion(jcfg, jbase.unet.cfg, first_stage_cfg=jbase.first_stage.cfg,
                              use_mask=True)
    return port, jmodel, jax_ldm_params(port), image_shape


def test_split_flagship_config(split_pair):
    port, _, _, image_shape = split_pair
    assert port.cfg.split_ks == SPLIT_KS and port.cfg.split_stride == SPLIT_STRIDE
    assert port.cfg.latent_shape == (4, 32, 8) and image_shape == (16, 256, 1)
    assert port._split_active(4, 32) and not port._split_active(4, 16)


def test_patched_apply_model_matches_jax(split_pair):
    """The U-Net over four crops of a 2x-wide latent (the last wraps), folded,
    within 1e-4 of JAX's (a dozen f32 layers summed in other orders, as the
    unpatched slice); a latent of the training size takes the plain path."""
    port, jmodel, params, _ = split_pair
    rng = np.random.default_rng(3)
    z = rng.standard_normal((2, 4, 32, 8)).astype(np.float32)
    t = np.array([5, 60])
    want = np.asarray(jax.jit(jmodel.apply_model)(params, jnp.asarray(z), jnp.asarray(t)))
    calls = []
    hook = port.unet.register_forward_hook(lambda m, a, o: calls.append(a[0].shape))
    try:
        with torch.inference_mode():
            got = port.apply_model(torch.from_numpy(z), torch.from_numpy(t)).numpy()
            plain = port.apply_model(torch.from_numpy(z[:, :, :16]), torch.from_numpy(t))
    finally:
        hook.remove()
    assert calls == [(2, 8, 4, 16)] * 4 + [(2, 8, 4, 16)]   # 4 patches, then the plain call
    assert plain.shape == (2, 4, 16, 8) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_patched_encode_and_decode_match_jax(split_pair):
    """The first stage on crops of (16, 128) image pixels at a stride of
    (16, 64), scaled by its factor (4, 8): the encoded latent within 1e-4 of
    JAX's; the decoded image (ray-drop applied) equal to JAX's where both
    keep a return, within 1e-4, on at least 99.9% of the pixels."""
    port, jmodel, params, _ = split_pair
    rng = np.random.default_rng(4)
    img = rng.uniform(-1, 1, (2, 16, 256, 1)).astype(np.float32)
    want_z = np.asarray(jax.jit(jmodel.encode_first_stage)(params, jnp.asarray(img)))
    z = rng.standard_normal((2, 4, 32, 8)).astype(np.float32)
    want_img = np.asarray(jax.jit(jmodel.decode_first_stage)(params, jnp.asarray(z)))
    with torch.inference_mode():
        got_z = port.encode_first_stage(torch.from_numpy(img)).numpy()
        got_img = port.decode_first_stage(torch.from_numpy(z)).numpy()
    assert got_z.shape == (2, 4, 32, 8) and got_img.shape == want_img.shape == (2, 16, 256, 1)
    np.testing.assert_allclose(got_z, want_z, atol=1e-4, rtol=1e-4)
    kept, want_kept = got_img != -1.0, want_img != -1.0
    assert (kept == want_kept).mean() >= 0.999
    both = kept & want_kept
    np.testing.assert_allclose(got_img[both], want_img[both], atol=1e-4, rtol=1e-4)


def test_patched_pipeline_generates_wide_scans(split_pair):
    """GenerationPipeline serves the 2x-wide model: DPM-3 over the patched
    U-Net, the patched decode, clouds reprojected at the wide geometry."""
    port, _, _, image_shape = split_pair
    geom = dataclasses.replace(KITTI_GEOMETRY, size=image_shape[:2])
    pipe = GenerationPipeline(model=port, geom=geom, steps=3)
    out = pipe.generate(2, seed=0, batch=2)
    assert out.images.shape == (2, *image_shape) and np.isfinite(out.images).all()
    assert len(out.clouds) == 2 and all(c.shape[1] == 3 for c in out.clouds)
    assert set(out.phase_seconds) == {"sample", "decode", "reproject"}
