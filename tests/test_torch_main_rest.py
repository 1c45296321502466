"""PyTorch port vs the JAX package: the rest of the flagship's main path.

DDIM's inpainting (``mask``/``x0``) and ``return_pred_x0`` at the tiny
flagship, with JAX's draws fed to the port (the JAX scan draws one Gaussian a
step and uses it for both the inpainting's forward diffusion and the eta
noise); the box and BEV geometry (``pcd2bev``, ``box_corners_3d``,
``box2coord2dx2``, ``batch_range2xyz``); the HTML viewer (``utils/vis``) and
``sample.py --html``. All on the CPU in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship as jax_flagship
from lidar_layout_tpu.models import samplers as JS
from lidar_layout_tpu.ops import lidar as JL
from lidar_layout_tpu.utils import vis as JVIS
from lidar_layout_tpu_torch import sample as PSAMPLE
from lidar_layout_tpu_torch.flagship import flagship
from lidar_layout_tpu_torch.models import samplers as PS
from lidar_layout_tpu_torch.models.schedules import DDIMSchedule
from lidar_layout_tpu_torch.ops import lidar as PL
from lidar_layout_tpu_torch.utils import vis as PVIS
from test_torch_eval import _write_tiny_config
from torch_port_helpers import jax_ldm_params, one_intra_op_thread, seed_weights

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
T = torch.from_numpy
SHAPE = (2, 4, 16, 8)          # batch 2 of the tiny flagship's 4x16x8 latent


@pytest.fixture(scope="module")
def tiny_pair():
    port, _ = flagship(tiny=True, device="cpu")
    seed_weights(port, 45)
    jmodel, _ = jax_flagship(tiny=True)
    return port, jmodel, jax_ldm_params(port)


def test_ddim_inpainting_and_pred_x0_match_jax(tiny_pair, monkeypatch):
    port, jmodel, params = tiny_pair
    steps, eta = 4, 0.5
    rng = np.random.default_rng(13)
    x0 = rng.standard_normal(SHAPE).astype(np.float32)
    mask = np.zeros(SHAPE, np.float32)
    mask[:, :, :8] = 1.0                                 # keep the left half
    key = jax.random.key(14)
    r_steps, r_init = jax.random.split(key)
    x_T = np.array(jax.random.normal(r_init, SHAPE, jnp.float32))
    n = len(DDIMSchedule.create(port.schedule, steps, eta, "uniform").timesteps)
    noise = [T(np.array(jax.random.normal(k, SHAPE))) for k in jax.random.split(r_steps, n)]
    monkeypatch.setattr(PS, "_randn", lambda shape, gen, dev: noise.pop(0))
    want, want_preds = JS.ddim_sample(jmodel, params, key, SHAPE, steps=steps, eta=eta,
                                      mask=jnp.asarray(mask), x0=jnp.asarray(x0),
                                      return_pred_x0=True)
    with torch.inference_mode():
        got, preds = PS.ddim_sample(port, SHAPE, steps=steps, eta=eta, mask=T(mask), x0=T(x0),
                                    x_T=T(x_T), device="cpu", return_pred_x0=True)
    assert not noise                                     # one draw a step
    assert preds.shape == (n, *SHAPE)
    want, want_preds = np.asarray(want), np.asarray(want_preds)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=1e-4)
    np.testing.assert_allclose(preds.numpy(), want_preds,
                               atol=1e-4 * np.abs(want_preds).max(), rtol=1e-4)
    with pytest.raises(ValueError, match="mask and x0"):
        PS.ddim_sample(port, SHAPE, steps=2, mask=T(mask), device="cpu")


def test_ddim_without_inpainting_draws_nothing_at_eta_0(tiny_pair, monkeypatch):
    port, _, _ = tiny_pair
    x_T = T(np.random.default_rng(15).standard_normal(SHAPE).astype(np.float32))
    with torch.inference_mode():
        plain = PS.ddim_sample(port, SHAPE, steps=3, x_T=x_T, device="cpu")
        monkeypatch.setattr(PS, "_randn", lambda *a: pytest.fail("drew noise"))
        img, preds = PS.ddim_sample(port, SHAPE, steps=3, x_T=x_T, device="cpu",
                                    return_pred_x0=True)
    assert torch.equal(img, plain) and preds.shape[1:] == SHAPE


def test_pcd2bev_matches_jax():
    rng = np.random.default_rng(16)
    pts = rng.uniform((-60, -60, -4), (60, 60, 2), (2, 5000, 3)).astype(np.float32)
    pts[0, :10, 0] = np.arange(-50, 50, 10)              # on the cell and range bounds
    mask = rng.random((2, 5000)) < 0.8
    for kw in ({}, dict(resolution=0.5, z_range=(-5.0, 5.0))):
        got = PL.pcd2bev(T(pts), T(mask), **kw).numpy()
        for b in range(2):
            np.testing.assert_array_equal(got[b], np.asarray(
                JL.pcd2bev(jnp.asarray(pts[b]), jnp.asarray(mask[b]), **kw)))
    np.testing.assert_array_equal(PL.pcd2bev(T(pts[0])).numpy(),
                                  np.asarray(JL.pcd2bev(jnp.asarray(pts[0]))))


def test_boxes_and_batch_range2xyz_match_jax():
    rng = np.random.default_rng(17)
    boxes = np.concatenate([rng.uniform(-40, 40, (12, 3)), rng.uniform(0.5, 5, (12, 3)),
                            rng.uniform(-np.pi, np.pi, (12, 1))], -1).astype(np.float32)
    np.testing.assert_allclose(PL.box_corners_3d(T(boxes)).numpy(),
                               np.asarray(JL.box_corners_3d(jnp.asarray(boxes))),
                               rtol=1e-6, atol=1e-5)
    for geom in (PL.KITTI_GEOMETRY, PL.NUSCENES_GEOMETRY):
        jgeom = JL.KITTI_GEOMETRY if geom is PL.KITTI_GEOMETRY else JL.NUSCENES_GEOMETRY
        np.testing.assert_allclose(PL.box2coord2dx2(T(boxes), geom).numpy(),
                                   np.asarray(JL.box2coord2dx2(jnp.asarray(boxes), jgeom)),
                                   rtol=0, atol=1e-6)
    imgs = rng.uniform(-1, 1, (2, 64, 1024)).astype(np.float32)
    np.testing.assert_allclose(PL.batch_range2xyz(T(imgs), PL.KITTI_GEOMETRY).numpy(),
                               np.asarray(JL.batch_range2xyz(jnp.asarray(imgs),
                                                             JL.KITTI_GEOMETRY)),
                               rtol=1e-5, atol=1e-4)


def test_viewer_html_as_jax(tmp_path):
    rng = np.random.default_rng(18)
    clouds = [rng.uniform(-30, 30, (n, 3)).astype(np.float32) for n in (500, 800, 300)]
    for name, mod in (("port", PVIS), ("jax", JVIS)):
        mod.save_scene_grid_html(str(tmp_path / name / "v.html"), clouds)
        mod.save_pcd_html(str(tmp_path / name / "one.html"), clouds[1],
                          values=np.linspace(0, 1, 800), max_points=600)
    for f in ("v.html", "one.html"):
        assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text()
    assert "1600 points" in (tmp_path / "port" / "v.html").read_text()


def test_sample_cli_writes_the_viewer(tmp_path):
    base = _write_tiny_config(tmp_path)
    rng = np.random.default_rng(19)
    clouds = {f"pcd_{i}": rng.uniform(-30, 30, (200 + i, 3)).astype(np.float32)
              for i in range(3)}
    np.savez(tmp_path / "s.npz", **clouds)
    PSAMPLE.main(["-b", str(base), "--cpu", "-f", str(tmp_path / "s.npz"), "--html",
                  "--outdir", str(tmp_path / "out")])
    html = (tmp_path / "out" / "viewer.html").read_text()
    assert "603 points" in html and "<canvas" in html
