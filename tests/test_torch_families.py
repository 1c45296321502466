"""PyTorch port vs the JAX package: the KL autoencoder, the family
registry, the testers, ``utils/misc`` and the CLIs of the last families.

``AutoencoderKL`` (``DiagonalGaussian``, ``kl_autoencoder_loss``) at a
small config (ch 8, two levels, 16x64 images) on JAX's weights carried by
``utils/convert.vq_state_dict``: the forward with JAX's posterior noise fed
in (1e-5 relative L2), the loss parts (1e-5 relative), and one step of
``make_kl_train_step`` against JAX's (generator and discriminator gradients
within 1e-4 relative L2, JAX's read from Adam's first moment; parameters
after Adam within 2 lr). The registry builds the ``autoencoder_kl``,
``efficient_unet``, ``vq_loss_1d`` and ``identity`` targets as JAX's. The
six testers' meters equal JAX's on the same outputs. ``train_lidm`` trains
``r2dm_diffusion.yaml``, ``g2sd_32.yaml`` and the KL override of the kitti
AE's YAML on the CPU (shrunk by dotlist overrides), resumes an R2DM run
from its checkpoint, and ``run_tester`` scores a run with ``ReconTester``.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lidar_layout_tpu.config import instantiate_from_config as jax_instantiate
from lidar_layout_tpu.losses import contperceptual as JCP
from lidar_layout_tpu.losses import discriminator as JD
from lidar_layout_tpu.losses import geometric as JG
from lidar_layout_tpu.models import autoencoder as JAE
from lidar_layout_tpu.ops.lidar import LidarGeometry as JGeom
from lidar_layout_tpu.train import ae_trainer as JT
from lidar_layout_tpu.train import build as JB
from lidar_layout_tpu.train import tester as JTS
from lidar_layout_tpu.utils import misc as JM
from lidar_layout_tpu_torch import run_tester
from lidar_layout_tpu_torch.config import instantiate_from_config, load_yaml
from lidar_layout_tpu_torch.eval_ae import load_ae_run
from lidar_layout_tpu_torch.losses import contperceptual as PCP
from lidar_layout_tpu_torch.models import autoencoder as PAE
from lidar_layout_tpu_torch.models.object_ae import VQModelObject
from lidar_layout_tpu_torch.models.r2dm import R2DMDiffusion
from lidar_layout_tpu_torch.train import family_trainer as FT
from lidar_layout_tpu_torch.train import tester as PTS
from lidar_layout_tpu_torch.train import train_lidm as TL
from lidar_layout_tpu_torch.utils import misc as PM
from lidar_layout_tpu_torch.utils.convert import (discriminator_state_dict,
                                                  vq_state_dict)
from torch_port_helpers import nchw, nhwc, one_intra_op_thread, random_flax_params, rel_l2

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
T = torch.from_numpy
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AE_YAML = os.path.join(ROOT, "configs", "autoencoder", "kitti", "autoencoder_c2_p4.yaml")
H, W, B, LR = 16, 64, 2, 1e-3
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
DD = dict(ch=8, ch_mult=(1, 2), strides=((2, 2),), num_res_blocks=1, z_channels=4,
          double_z=True, in_channels=1, out_ch=1)
KL_CFG = {"target": "autoencoder_kl", "params": {
    "embed_dim": 4, "ddconfig": {k: (list(map(list, v)) if k == "strides" else
                                     list(v) if isinstance(v, tuple) else v)
                                 for k, v in DD.items()},
    "lossconfig": {"params": {"kl_weight": 0.01}}}}


def _images(seed=0, b=B):
    return np.random.default_rng(seed).uniform(-1, 1, (b, H, W, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def kl_pair():
    jmodel = jax_instantiate(KL_CFG)
    x = jnp.zeros((1, H, W, 1))
    params_g = jax.tree.map(np.array, random_flax_params(jmodel.init, 1, jax.random.key(0), x,
                                                         rng=jax.random.key(1)))
    jdisc = JD.LiDARNLayerDiscriminator()
    params_d = jax.tree.map(np.array, random_flax_params(jdisc.init, 2, jax.random.key(0), x))
    port = instantiate_from_config(KL_CFG)
    port.load_state_dict(vq_state_dict(params_g), strict=True)
    return jmodel, jdisc, params_g, params_d, port


def _posterior_noise(key, b=B):
    """JAX's posterior draw for a batch, NCHW."""
    shape = (b, H // 2, W // 2, 4)
    return nchw(np.asarray(jax.random.normal(key, shape, dtype=jnp.float32)))


def test_kl_autoencoder_forward_and_loss_match_jax(kl_pair):
    jmodel, _, params_g, _, port = kl_pair
    x, key = _images(), jax.random.key(5)
    dec, post = jmodel.apply(params_g, jnp.asarray(x), rng=key)
    cfg_j = JCP.KLLossConfig(kl_weight=0.01)
    geo = JG.GeoConverter(JGeom(size=(H, W)), curve_length=1)
    want, want_parts = JCP.kl_autoencoder_loss(cfg_j, geo, jnp.asarray(x), dec, post,
                                               jnp.asarray(0.3))
    with torch.no_grad():
        got_dec, got_post = port(nchw(x), noise=_posterior_noise(key))
        got, parts = PCP.kl_autoencoder_loss(PCP.KLLossConfig(kl_weight=0.01), nchw(x),
                                             got_dec, got_post, 0.3)
    assert rel_l2(nhwc(got_dec), dec) <= OUT_TOL
    assert rel_l2(nhwc(got_post.mean), post.mean) <= OUT_TOL
    np.testing.assert_allclose(got_post.kl().numpy(), np.asarray(post.kl()), rtol=OUT_TOL)
    for k, v in want_parts.items():
        np.testing.assert_allclose(float(parts[k]), float(v), rtol=OUT_TOL)
    np.testing.assert_allclose(float(got), float(want), rtol=OUT_TOL)
    with torch.no_grad():   # the mode, and a drawn sample
        mode = port(nchw(x), sample_posterior=False)[0]
        drawn = port(nchw(x), torch.Generator().manual_seed(0))[0]
    want_mode, _ = jmodel.apply(params_g, jnp.asarray(x), sample_posterior=False)
    assert rel_l2(nhwc(mode), want_mode) <= OUT_TOL and not torch.equal(mode, drawn)
    with pytest.raises(ValueError, match="double_z"):
        PAE.AutoencoderKL(PAE.AEConfig(**{**DD, "double_z": False}))
    ident = PAE.IdentityFirstStage()
    assert ident(nchw(x)) is not None and torch.equal(ident.decode_latent(nchw(x)), nchw(x))


def test_kl_train_step_matches_jax(kl_pair):
    jmodel, jdisc, params_g, params_d, port = kl_pair
    import copy

    cfg_j = JCP.KLLossConfig(kl_weight=0.01)
    geo = JG.GeoConverter(JGeom(size=(H, W)), curve_length=1)
    tx_g, tx_d = JT.make_ae_optimizers(LR, LR, 1)
    jstate = JT.AETrainState(params_g=params_g, params_d=params_d, opt_g=tx_g.init(params_g),
                             opt_d=tx_d.init(params_d), step=jnp.zeros((), jnp.int32))
    jstep = JB.make_kl_train_step(jmodel, jdisc, cfg_j, geo, tx_g, tx_d)
    x, key = _images(3), jax.random.key(9)
    want_state, want_logs = jstep(jstate, {"image": jnp.asarray(x)}, key)

    model = copy.deepcopy(port)
    torch.manual_seed(0)
    state, step, val_step, monitor = FT.family_training(model, KL_CFG, LR)
    assert monitor == "val/rec_loss" and FT.kl_loss_config(KL_CFG).kl_weight == 0.01
    state.disc.load_state_dict(discriminator_state_dict(params_d), strict=True)
    grads = {}
    for name, opt in (("g", state.opt_g), ("d", state.opt_d)):
        real = opt.step

        def spy(gs, real=real, name=name):
            grads[name] = [g_.clone() for g_ in gs]
            return real(gs)
        opt.step = spy
    state, logs = step(state, {"image": T(x)}, None, noise=_posterior_noise(key))
    assert set(want_logs) == set(logs) and state.step == 1
    for k in want_logs:
        np.testing.assert_allclose(float(logs[k]), float(want_logs[k]), rtol=OUT_TOL, err_msg=k)

    def first_grad(opt):
        return jax.tree.map(lambda m: 2.0 * np.asarray(m), opt[0].mu)
    for name, module, want, after in (
            ("g", state.model, vq_state_dict(first_grad(want_state.opt_g)),
             vq_state_dict(jax.tree.map(np.asarray, want_state.params_g))),
            ("d", state.disc, discriminator_state_dict(first_grad(want_state.opt_d)),
             discriminator_state_dict(jax.tree.map(np.asarray, want_state.params_d)))):
        names = [n for n, _ in module.named_parameters()]
        got = torch.cat([g_.flatten() for g_ in grads[name]]).numpy()
        ref = torch.cat([want[n].flatten() for n in names]).numpy()
        assert rel_l2(got, ref) <= GRAD_TOL, name
        for n, p in module.named_parameters():
            assert float((p.detach() - after[n]).abs().max()) <= 2 * LR, n
    val = val_step(state, {"image": T(x)}, torch.Generator().manual_seed(1))
    assert set(val) == {"rec_loss", "kl_loss"} and np.isfinite(float(val["rec_loss"]))


def test_registry_builds_the_family_targets_as_jax():
    port, jmodel = instantiate_from_config(KL_CFG), jax_instantiate(KL_CFG)
    assert isinstance(port, PAE.AutoencoderKL) and isinstance(jmodel, JAE.AutoencoderKL)
    assert dataclasses.asdict(port.cfg) == {
        k: (tuple(tuple(s) for s in v) if k == "strides" else v)
        for k, v in dataclasses.asdict(jmodel.cfg).items()}
    assert port.quant_conv.out_channels == 2 * jmodel.embed_dim
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, H, W, 1)),
                            rng=jax.random.key(1))
    assert JM.count_params(shapes) == PM.count_params(port)
    for target in ("lidm.models.ae.autoencoder.AutoencoderKL",
                   "lidm.models.diffusion.ddpm_r2dm.R2DMDiffusion",
                   "lidm.models.ae.autoencoder_object.VQModel_Object"):
        assert target in __import__("lidar_layout_tpu_torch.config", fromlist=["x"]).REGISTRY
    for cfg in ({"target": "efficient_unet", "params": {"base_channels": 4}},
                {"target": "vq_loss_1d", "params": {"discriminator_config": {"pts_dim": 3}}},
                {"target": "identity"}, {"target": "torch.nn.Identity"}):
        assert instantiate_from_config(cfg) == jax_instantiate(cfg)


def test_misc_utilities_match_jax():
    PM.set_seed(3)
    a = (np.random.rand(), torch.rand(1).item())
    PM.set_seed(3)
    assert (np.random.rand(), torch.rand(1).item()) == a
    JM.set_seed(4)
    want = np.random.rand()
    PM.set_seed(4)
    assert np.random.rand() == want
    d = {"a": 1, "b": {"c": [2, 3], "d": {"e": "f"}}}
    assert PM.dict2namespace(d) == JM.dict2namespace(d)
    assert PM.dict2namespace(d).b.d.e == "f"


@pytest.mark.parametrize("name", sorted(JTS.TESTERS))
def test_tester_meters_match_jax(name):
    rng = np.random.default_rng(len(name))
    batches = []
    for i in range(3):
        if name in ("SemSegTester", "ClsTester"):
            n = 50 if name == "SemSegTester" else 6
            out = rng.normal(size=(n, 5)).astype(np.float32)
            batch = {"label": rng.integers(-1 if name == "SemSegTester" else 0, 5, n),
                     "mask": rng.uniform(size=n) > 0.1}
        elif name == "ReconTester":
            out = rng.uniform(-1, 1, (2, 4, 8, 1)).astype(np.float32)
            batch = {"image": rng.uniform(-1, 1, (2, 4, 8, 2)).astype(np.float32)}
        elif name == "DINOSemSegTester":
            frags = [{"index": rng.permutation(20)[:12], "mask": rng.uniform(size=12) > 0.2,
                      "logits": rng.normal(size=(12, 5)).astype(np.float32)} for _ in range(3)]
            batch = {"segment": rng.integers(0, 5, 20), "fragment_list": frags,
                     "dino_feat": np.zeros(3)}
            out = None
        elif name == "ClsVotingTester":
            out = rng.normal(size=(4, 5)).astype(np.float32)
            batch = {"category": np.int64(rng.integers(0, 5)), "voting": np.zeros(4)}
        else:   # PartSegTester
            out = rng.normal(size=(3, 30, 6)).astype(np.float32)
            batch = {"label": rng.integers(0, 6, 30), "category": np.int64(i % 2)}
        batches.append((out, batch))

    def run(registry, as_torch):
        outs = iter([o for o, _ in batches])

        def apply_fn(batch):
            if name == "DINOSemSegTester":
                o = batch["logits"]
            else:
                o = next(outs)
            return torch.from_numpy(o) if as_torch else o
        kw = {} if name == "ReconTester" else {"num_classes": 6 if name == "PartSegTester"
                                                else 5}
        if name == "PartSegTester":
            kw["category2part"] = {0: [0, 1, 2], 1: [3, 4, 5]}
        tester = registry[name](apply_fn, **kw)
        data = [{k: (torch.from_numpy(v) if as_torch and isinstance(v, np.ndarray)
                     and k != "fragment_list" else v) for k, v in b.items()}
                for _, b in batches]
        return tester.test(data)
    assert sorted(PTS.TESTERS) == sorted(JTS.TESTERS)
    want, got = run(JTS.TESTERS, False), run(PTS.TESTERS, True)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    if name == "ClsVotingTester":
        tester = PTS.TESTERS[name](lambda b: torch.from_numpy(batches[0][0]), num_classes=5,
                                   num_repeat=2)
        assert tester.test_repeated(lambda: [batches[0][1]])["best_pass"] == 0


# ---------------------------------------------------------------- CLIs
R2DM_SHRINK = ["model.params.unet_config.params.base_channels=8",
               "model.params.unet_config.params.num_residual_blocks=[1,1,1,1]",
               "data.params.dataset.size=[16,64]", "data.params.batch_size=2",
               "data.params.num_val_batches=1"]


def test_train_lidm_trains_r2dm_and_resumes(tmp_path, capsys):
    yaml_path = os.path.join(ROOT, "configs", "r2dm", "r2dm_diffusion.yaml")
    run = str(tmp_path / "r2dm")
    trainer = TL.main(["-b", yaml_path, "--cpu", "--synthetic", "--steps", "2",
                       "--workdir", run, *R2DM_SHRINK])
    assert trainer.global_step == 2 and isinstance(trainer.state.model, R2DMDiffusion)
    assert "nusc_r2dm: no data under None — synthetic fallback" in capsys.readouterr().out
    lines = [json.loads(x) for x in open(os.path.join(run, "metrics.jsonl"))]
    assert np.isfinite(lines[-1]["val/loss_simple_ema"])
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == ["step_00000001.pt",
                                                               "step_00000002.pt"]
    resumed = TL.main(["-b", yaml_path, "--cpu", "--synthetic", "--steps", "3", "--workdir",
                       str(tmp_path / "again"), "-r", run, *R2DM_SHRINK])
    assert resumed.global_step == 3 and resumed.state.ema.step == 3


def test_train_lidm_trains_g2sd_and_the_kl_override(tmp_path):
    trainer = TL.main(["-b", os.path.join(ROOT, "configs", "autoencoder", "nuscenes_objects",
                                          "g2sd_32.yaml"), "--cpu", "--synthetic",
                       "--steps", "2", "--workdir", str(tmp_path / "obj"),
                       "data.params.train.params.num_samples=256",
                       "data.params.validation.params.num_samples=256",
                       "data.params.num_val_batches=1"])
    assert trainer.global_step == 2 and isinstance(trainer.state.model, VQModelObject)
    # accumulate_grad_batches: 2 scales the lr and accumulates nothing, as in JAX
    assert trainer.state.optimizer.accumulate == 1
    assert trainer.state.optimizer.adamw.defaults["lr"] == pytest.approx(4.5e-6 * 4 * 2)
    lines = [json.loads(x) for x in open(tmp_path / "obj" / "metrics.jsonl")]
    assert np.isfinite(lines[-1]["val/rec_loss"])
    trainer = TL.main(["-b", AE_YAML, "--cpu", "--synthetic", "--steps", "2",
                       "--workdir", str(tmp_path / "kl"), "model.target=autoencoder_kl",
                       "model.params.ddconfig.double_z=true", "model.params.ddconfig.ch=8",
                       "data.params.dataset.size=[16,128]", "data.params.batch_size=2",
                       "data.params.num_val_batches=1"])
    assert trainer.global_step == 2 and isinstance(trainer.state.model, PAE.AutoencoderKL)
    lines = [json.loads(x) for x in open(tmp_path / "kl" / "metrics.jsonl")]
    assert np.isfinite(lines[-1]["val/rec_loss"]) and "disc_loss" in lines[-1]
    with pytest.raises(NotImplementedError, match="train_dense_decoder"):
        TL.main(["-b", os.path.join(ROOT, "configs", "ours", "nuscenes", "dense_decoder",
                                    "gaus_10cm.yaml"), "--cpu", "--synthetic", "--steps", "1",
                 "--workdir", str(tmp_path / "dd")])


def test_run_tester_scores_a_trained_autoencoder(tmp_path, capsys):
    cfg = load_yaml(AE_YAML)
    cfg["model"]["params"]["ddconfig"].update(ch=8, num_res_blocks=1)
    cfg["model"]["params"]["n_embed"] = 64
    cfg["data"]["params"]["dataset"]["size"] = [16, 128]
    base = tmp_path / "tiny.yaml"
    base.write_text(yaml.safe_dump(cfg))
    run = str(tmp_path / "ae")
    TL.main(["-b", str(base), "--cpu", "--synthetic", "--steps", "1", "--workdir", run,
             "data.params.batch_size=2", "data.params.num_val_batches=1"])
    capsys.readouterr()
    out = run_tester.main(["-b", str(base), "--cpu", "--synthetic", "-r", run,
                           "--n-batches", "2", "--batch-size", "2"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out and set(out) == {"mae", "mse", "psnr"}
    assert np.isfinite(list(out.values())).all()
    # the same meters by hand over the same batches and the run's weights
    from lidar_layout_tpu_torch.data.datasets import RangeImageDataset
    from lidar_layout_tpu_torch.ops.lidar import LidarGeometry

    model = instantiate_from_config(cfg["model"])
    load_ae_run(model, run)
    ds = RangeImageDataset(None, batch_size=2, geom=LidarGeometry(
        size=(16, 128), fov=(3, -25)), seed=0)
    it = ds.batches()
    err = []
    with torch.no_grad():
        for _ in range(2):
            x = next(it)["image"]
            err.append((nhwc(model.eval()(x.permute(0, 3, 1, 2))[0]) - x.numpy()).ravel())
    np.testing.assert_allclose(out["mae"], float(np.abs(np.concatenate(err)).mean()), rtol=1e-5)
