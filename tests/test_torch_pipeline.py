"""PyTorch port vs the JAX package: the whole serving slice, and the port's rules.

The tiny flagship (``__graft_entry__._flagship(tiny=True)`` and the port's
``flagship(tiny=True)``) gets seeded weights in the port, which cross to flax
through the JAX package's converters. Both run DDIM-8 and DPM-Solver++-8 from
the same initial latent (the one the JAX sampler draws from its key), then
VQ decode with ray-drop, then ``range2pcd``, on the CPU in float32.

Port rules: no module of the port imports JAX, flax or the JAX package; its
entry points run on CUDA unless the caller asks for the CPU.
"""
import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship as jax_flagship
from lidar_layout_tpu.config import instantiate_from_config as jax_instantiate
from lidar_layout_tpu.models import samplers as JS
from lidar_layout_tpu.ops import lidar as JL
from lidar_layout_tpu_torch import config as PC
from lidar_layout_tpu_torch.flagship import flagship
from lidar_layout_tpu_torch.models import samplers as PS
from lidar_layout_tpu_torch.ops import lidar as PL
from lidar_layout_tpu_torch.pipeline import GenerationPipeline
from torch_port_helpers import jax_ldm_params, one_intra_op_thread, seed_weights

ROOT = pathlib.Path(__file__).resolve().parent.parent
_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "lidar_layout_tpu"}
SHAPE = (2, 4, 16, 8)          # batch 2 of the tiny flagship's 4x16x8 latent


@pytest.fixture(scope="module")
def tiny_pair():
    port, _ = flagship(tiny=True, device="cpu")
    seed_weights(port, 41)
    jmodel, _ = jax_flagship(tiny=True)
    return port, jmodel, jax_ldm_params(port)


def _sample(port, jmodel, params, sampler):
    key = jax.random.key(7)
    # the JAX samplers draw x_T from the second half of split(key)
    x_T = np.asarray(jax.random.normal(jax.random.split(key)[1], SHAPE, jnp.float32))
    if sampler == "ddim":
        want = JS.ddim_sample(jmodel, params, key, SHAPE, steps=8)
        got = PS.ddim_sample(port, SHAPE, steps=8, x_T=torch.tensor(x_T), device="cpu")
    else:
        want = JS.dpm_solver_sample(jmodel, params, key, SHAPE, steps=8)
        got = PS.dpm_solver_sample(port, SHAPE, steps=8, x_T=torch.tensor(x_T),
                                   device="cpu")
    return got.numpy(), np.array(want)


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_tiny_slice_matches_jax(tiny_pair, sampler):
    port, jmodel, params = tiny_pair
    with torch.inference_mode():
        z, want_z = _sample(port, jmodel, params, sampler)
        # 8 U-Net evals in series: each step carries the previous step's
        # summation-order differences forward, so 1e-4 of |z| instead of 1e-5
        np.testing.assert_allclose(z, want_z, atol=1e-4 * np.abs(want_z).max(), rtol=1e-4)

        # the same latent through both decoders (ray-drop applied), then
        # reprojection; a mask logit within rounding of 0 may drop either way
        want_img = np.asarray(jax.jit(jmodel.decode_first_stage)(params, jnp.asarray(want_z)))
        img = port.decode_first_stage(torch.from_numpy(want_z)).numpy()
        assert img.shape == want_img.shape == (2, 16, 128, 1)
        kept, want_kept = img != -1.0, want_img != -1.0
        assert (kept == want_kept).mean() >= 0.999 and want_kept.any() and (~want_kept).any()
        both = kept & want_kept
        np.testing.assert_allclose(img[both], want_img[both], atol=1e-4, rtol=1e-4)
        geom = PL.LidarGeometry(size=(16, 128))
        jgeom = JL.LidarGeometry(size=(16, 128))
        for i in range(2):
            xyz, valid = PL.range2pcd(torch.from_numpy(img[i, ..., 0]), geom)
            want_xyz, want_valid = JL.range2pcd(jnp.asarray(want_img[i, ..., 0]), jgeom)
            valid, want_valid = valid.numpy(), np.asarray(want_valid)
            assert (valid == want_valid).mean() >= 0.999
            sure = valid & want_valid
            # metric depth is 2^(5.84 x) - 1: image errors of 1e-4 grow ~4x
            np.testing.assert_allclose(xyz.numpy()[sure], np.asarray(want_xyz)[sure],
                                       atol=1e-3, rtol=1e-3)

        # each package's own latent: the nearest codes agree
        q = port.first_stage_model.quantize
        idx = q(torch.from_numpy(z).permute(0, 3, 1, 2))[2]
        want_idx = q(torch.from_numpy(want_z).permute(0, 3, 1, 2))[2]
        assert (idx == want_idx).float().mean().item() >= 0.99


def test_latent_diffusion_methods_match_jax(tiny_pair):
    port, jmodel, params = tiny_pair
    rng = np.random.default_rng(43)
    z = rng.standard_normal(SHAPE).astype(np.float32)
    t = np.array([5, 60])
    img = rng.uniform(-1, 1, (2, 16, 128, 1)).astype(np.float32)
    want_out = np.asarray(jax.jit(jmodel.apply_model)(params, jnp.asarray(z), jnp.asarray(t)))
    want_enc = np.asarray(jax.jit(jmodel.encode_first_stage)(params, jnp.asarray(img)))
    want_eps = np.asarray(jmodel.predict_eps_from_x(jnp.asarray(z), jnp.asarray(t),
                                                    jnp.asarray(want_out)))
    zt, tt = torch.from_numpy(z), torch.from_numpy(t)
    with torch.inference_mode():
        out = port.apply_model(zt, tt).numpy()
        enc = port.encode_first_stage(torch.from_numpy(img)).numpy()
        eps = port.predict_eps_from_x(zt, tt, torch.from_numpy(want_out)).numpy()
        o = torch.from_numpy(out)
        assert port.eps_from_model_out(zt, tt, o) is o     # "eps" parameterization
    assert np.abs(want_out).max() > 0.1
    # a dozen layers of f32 summed in other orders
    np.testing.assert_allclose(out, want_out, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(enc, want_enc, atol=1e-4, rtol=1e-4)
    # the same model output through both formulas: float32 rounding only
    np.testing.assert_allclose(eps, want_eps, atol=1e-5, rtol=1e-5)


def test_ddim_with_eta_draws_its_noise_from_the_generator(tiny_pair):
    port = tiny_pair[0]

    def run(seed, eta):
        gen = torch.Generator().manual_seed(seed)
        with torch.inference_mode():
            return PS.ddim_sample(port, SHAPE, steps=4, eta=eta, generator=gen,
                                  device="cpu").numpy()

    a, b, c = run(1, 0.5), run(1, 0.5), run(2, 0.5)
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and np.abs(a - c).max() > 1e-3
    # eta = 0 is deterministic given x_T: the generator only draws x_T
    x_T = torch.randn(SHAPE, generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        d = PS.ddim_sample(port, SHAPE, steps=4, x_T=x_T, device="cpu",
                           generator=torch.Generator().manual_seed(9))
        e = PS.ddim_sample(port, SHAPE, steps=4, x_T=x_T, device="cpu")
    np.testing.assert_array_equal(d.numpy(), e.numpy())


def _tiny_config():
    """The flagship YAML, cut to the tiny flagship's widths."""
    cfg = PC.load_yaml(str(ROOT / "configs/lidar_diffusion/kitti/uncond_c2_p4.yaml"))
    p = cfg["model"]["params"]
    p.update(timesteps=64, image_size=[4, 16])
    p["unet_config"]["params"].update(model_channels=32, num_res_blocks=1,
                                      attention_resolutions=[2], channel_mult=[1, 2],
                                      num_head_channels=8)
    p["first_stage_config"]["params"]["n_embed"] = 256
    p["first_stage_config"]["params"]["ddconfig"].update(ch=16, num_res_blocks=1)
    cfg["data"]["params"]["dataset"]["size"] = [16, 128]
    return cfg


def test_config_builders_match_jax():
    cfg = _tiny_config()
    port = PC.instantiate_from_config(cfg["model"])
    jmodel = jax_instantiate(cfg["model"])
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(jmodel.cfg)
    for mine, theirs in ((port.unet.cfg, jmodel.unet.cfg),
                         (port.first_stage_model.cfg, jmodel.first_stage.cfg)):
        a, b = dataclasses.asdict(mine), dataclasses.asdict(theirs)
        common = a.keys() & b.keys()
        assert len(common) >= 12 and {k: a[k] for k in common} == {k: b[k] for k in common}
    assert port.first_stage_model.quantize.n_embed == jmodel.first_stage.n_embed == 256
    assert port.first_stage_model.use_mask and jmodel.first_stage.use_mask


def test_generate_shapes_cache_and_clouds():
    pipe = GenerationPipeline.from_config(_tiny_config(), device="cpu", steps=4)
    seed_weights(pipe.model, 42)
    out = pipe.generate(5, seed=3, batch=2)
    assert out.images.shape == (5, 16, 128, 1) and out.images.dtype == np.float32
    assert np.isfinite(out.images).all() and len(out.clouds) == 5
    assert set(out.phase_seconds) == {"sample", "decode", "reproject"}
    assert len(pipe._cache) == 1
    for img, cloud in zip(out.images, out.clouds):
        xyz, valid = PL.range2pcd(torch.from_numpy(img[..., 0]), pipe.geom)
        np.testing.assert_array_equal(cloud, xyz.numpy()[valid.numpy()])
        assert cloud.ndim == 2 and cloud.shape[1] == 3 and len(cloud) > 0
    again = pipe.generate(5, seed=3, batch=2)          # same key: same program, same scenes
    np.testing.assert_array_equal(again.images, out.images)
    assert len(pipe._cache) == 1
    pipe.generate(1, seed=3, batch=2)                  # batch 1: a second program
    pipe.sampler = "ddim"
    ddim = pipe.generate(2, seed=3, batch=2)
    assert len(pipe._cache) == 3 and ddim.images.shape == (2, 16, 128, 1)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flagship(tiny=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationPipeline.from_config(_tiny_config())
    model, _ = flagship(tiny=True, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PS.ddim_sample(model, SHAPE, steps=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PS.dpm_solver_sample(model, SHAPE, steps=2)


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_source_imports_no_jax():
    files = sorted((ROOT / "lidar_layout_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    names = {str(f.relative_to(ROOT / "lidar_layout_tpu_torch")) for f in files[:-1]}
    assert len(files) > 15 and {"nn/ema.py", "data/synthetic.py", "data/datasets.py",
                                "train/trainer.py", "train/train_lidm.py", "eval/metrics.py",
                                "eval/device_metrics.py", "eval/rangenet.py",
                                "eval/registry.py", "ops/chamfer.py", "ops/emd.py",
                                "data/readers.py", "sample.py", "encoders/layout_encoder.py",
                                "models/object_cross_unet.py"} <= names
    bad = {f"{f.relative_to(ROOT)}: {m}" for f in files for m in _imported_roots(f)
           if m in FORBIDDEN}
    assert not bad


def test_port_import_loads_no_jax():
    code = f"""
import importlib.abc, sys
BAD = {sorted(FORBIDDEN)!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BAD:
            raise ImportError("the port imported " + name)
sys.meta_path.insert(0, Block())
import lidar_layout_tpu_torch.pipeline, lidar_layout_tpu_torch.flagship
import lidar_layout_tpu_torch.utils.convert, lidar_layout_tpu_torch.ops._build
import lidar_layout_tpu_torch.train.train_lidm, lidar_layout_tpu_torch.train.trainer
import lidar_layout_tpu_torch.train.diffusion_trainer, lidar_layout_tpu_torch.train.checkpoint
import lidar_layout_tpu_torch.train.lr_schedule, lidar_layout_tpu_torch.nn.ema
import lidar_layout_tpu_torch.data.datasets, lidar_layout_tpu_torch.data.synthetic
import lidar_layout_tpu_torch.eval.metrics, lidar_layout_tpu_torch.eval.device_metrics
import lidar_layout_tpu_torch.eval.rangenet, lidar_layout_tpu_torch.eval.registry
import lidar_layout_tpu_torch.ops.chamfer, lidar_layout_tpu_torch.ops.emd
import lidar_layout_tpu_torch.data.readers, lidar_layout_tpu_torch.sample
import lidar_layout_tpu_torch.encoders.layout_encoder, lidar_layout_tpu_torch.models.object_cross_unet
import lidar_layout_tpu_torch.train.train_layout, lidar_layout_tpu_torch.train.layout_trainer
import lidar_layout_tpu_torch.data.factory, lidar_layout_tpu_torch.data.nuscenes_layout
import lidar_layout_tpu_torch.data.graph_aug, lidar_layout_tpu_torch.utils.memory
assert "jax" not in sys.modules
assert not [m for m in sys.modules if m.split(".")[0] in BAD]
print("clean")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr
