"""PyTorch port vs the JAX package: the layout-conditioned LiDM's training step.

The tiny variant of ``configs/lidar_diffusion/nuscenes/layout_cond_c2_p4.yaml``
(``flagship.layout_config(tiny=True)``) is built by both packages from the same
config dict; the JAX parameter tree has the structure of ``model.init(...,
cond_example=layout)`` and seeded random values, and crosses to the port
through ``utils/convert``. Both take the loss and its gradients, U-Net and
layout encoder, at fixed t, noise and layout with dropout off, on the CPU in
float32. Then the port's own training surface: the trainable set and the EMA,
dropout, the ``nusc_layout_range`` batches (synthetic and read), a checkpoint
round trip and the CLI.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_layout_tpu.config import instantiate_from_config as jax_instantiate
from lidar_layout_tpu.data import factory as jax_factory
from lidar_layout_tpu.data import readers as JR
from lidar_layout_tpu.ops import lidar as JL
from lidar_layout_tpu.train.diffusion_trainer import trainable_keys as jax_trainable_keys
from lidar_layout_tpu_torch.data import readers as PR
from lidar_layout_tpu_torch.data.datasets import layout_range_batches
from lidar_layout_tpu_torch.data.synthetic import (synthetic_layout_range_batch,
                                                   synthetic_layouts, synthetic_scene)
from lidar_layout_tpu_torch.flagship import layout_config, layout_flagship
from lidar_layout_tpu_torch.ops import lidar as PL
from lidar_layout_tpu_torch.train import checkpoint as CK
from lidar_layout_tpu_torch.train import diffusion_trainer as DT
from lidar_layout_tpu_torch.train.train_lidm import main as train_main
from lidar_layout_tpu_torch.utils.convert import (latent_diffusion_state_dict,
                                                  layout_encoder_state_dict,
                                                  layout_unet_state_dict)
from torch_port_helpers import one_intra_op_thread, random_flax_params

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
CFG = layout_config(tiny=True)
IMAGE = (32, 256, 1)
GEOM = PL.NUSCENES_GEOMETRY
JGEOM = JL.LidarGeometry(size=(32, 1024), fov=(10.0, -30.0))
LAYOUTS = np.concatenate([synthetic_layouts(np.random.default_rng(5), 1, GEOM),
                          np.zeros((1, 13, 13), np.float32)])


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_instantiate(CFG["model"])
    params = random_flax_params(
        lambda k: jmodel.init(k, IMAGE, cond_example=jnp.asarray(LAYOUTS)), 21,
        jax.random.key(0))
    params["logvar"] = jnp.zeros_like(params["logvar"])   # logvar_init, as the port's
    port, _ = layout_flagship(tiny=True, device="cpu")
    port.load_state_dict(latent_diffusion_state_dict(jax.tree.map(np.asarray, params),
                                                     port.unet.cfg))
    return jmodel, params, port


# ------------------------------------------------------------ loss and grads
def test_loss_and_unet_and_encoder_gradients_match_jax(pair):
    jmodel, params, port = pair
    rng = np.random.default_rng(22)
    z = rng.standard_normal((2, 8, 32, 8)).astype(np.float32)
    t = np.array([13, 41])
    key = jax.random.key(23)
    # deterministic p_losses draws its noise from the key unsplit
    noise = np.array(jax.random.normal(key, z.shape))
    keys = jax_trainable_keys(jmodel)
    assert keys == ("unet", "cond_stage") == DT.trainable_keys(port)

    def loss_fn(train):
        p = {**params, **train}
        cond = jmodel.get_learned_conditioning(p, jnp.asarray(LAYOUTS))
        return jmodel.p_losses(p, key, jnp.asarray(z), cond, jnp.asarray(t),
                               deterministic=True)[0]

    train = {k: params[k] for k in keys}
    want_loss, want = jax.jit(jax.value_and_grad(loss_fn)).lower(train).compile(
        {"xla_backend_optimization_level": 0})(train)
    port.eval()                        # dropout off, as deterministic=True
    port.zero_grad(set_to_none=True)
    cond = port.get_learned_conditioning(LAYOUTS)
    loss, _ = port.p_losses(torch.from_numpy(z), torch.from_numpy(t), torch.from_numpy(noise),
                            cond)
    loss.backward()
    # logvar 0 and no ELBO term: the loss is the MSE; f32, other sum orders
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for name, conv, module in (("U-Net", layout_unet_state_dict, port.unet),
                               ("encoder", layout_encoder_state_dict, port.cond_stage_model)):
        part = "unet" if name == "U-Net" else "cond_stage"
        ref = conv(jax.tree.map(np.asarray, want[part]))
        got = {n: p.grad for n, p in module.named_parameters()}
        assert sorted(got) == sorted(ref) and len(got) > 20, name
        gmax = max(float(np.abs(v.numpy()).max()) for v in ref.values())
        assert gmax > 1e-3, name
        for n in ref:
            assert got[n] is not None, f"{name} {n}: no gradient"
            # dozens of layers forward and back in f32, summed in other orders
            np.testing.assert_allclose(got[n].numpy(), ref[n].numpy(), atol=1e-5 * gmax,
                                       rtol=1e-3, err_msg=f"{name} {n}")


# -------------------------------------------------- trainable set, EMA, dropout
def _state(seed=31, lr=1e-3):
    model, _ = layout_flagship(tiny=True, device="cpu")
    from torch_port_helpers import seed_weights
    seed_weights(model, seed)
    params = DT.trainable_params(model)
    return DT.create_train_state(model, DT.make_optimizer(params, lr), params)


def _batch(seed, n=2):
    return synthetic_layout_range_batch(np.random.default_rng(seed), n, PL.LidarGeometry(
        size=(32, 256), fov=(10, -30)))


def test_trainable_set_and_ema_cover_unet_and_encoder_and_first_stage_stays_frozen():
    state = _state()
    model = state.model
    names = set(state.params)
    unet = {f"model.diffusion_model.{n}" for n, _ in model.unet.named_parameters()}
    enc = {f"cond_stage_model.{n}" for n, _ in model.cond_stage_model.named_parameters()}
    assert names == unet | enc and enc and set(state.ema.params) == names
    assert not any(k.startswith("first_stage_model.") for k in names)
    before = {k: v.clone() for k, v in state.ema.params.items()}
    enc0 = {k: state.params[k].detach().clone() for k in enc}
    seen = {}
    step_opt = state.optimizer.step

    def spy():
        seen.update({k: p.grad for k, p in state.params.items()})
        seen["first_stage"] = [p.grad for p in model.first_stage_model.parameters()]
        return step_opt()
    state.optimizer.step = spy
    state, logs = DT.make_train_step(model)(state, _batch(32), torch.Generator().manual_seed(0))
    assert np.isfinite(float(logs["loss"]))
    # the encoder got a non-zero gradient, the first stage none
    assert all(seen[k] is not None for k in names)
    assert sum(float(seen[k].abs().sum()) for k in enc) > 0
    assert all(g is None for g in seen["first_stage"])
    assert not any(p.requires_grad for p in model.first_stage_model.parameters())
    assert any(not torch.equal(enc0[k], state.params[k]) for k in enc)
    assert any(not torch.equal(before[k], state.ema.params[k]) for k in enc)


def test_dropout_is_applied_in_train_mode_only():
    model, _ = layout_flagship(tiny=True, device="cpu")
    drops = [m for m in model.unet.modules() if isinstance(m, torch.nn.Dropout)]
    assert drops and all(m.p == 0.1 for m in drops)      # the YAML's U-Net dropout
    from torch_port_helpers import seed_weights
    seed_weights(model, 33)
    z = torch.randn((2, 8, 32, 8), generator=torch.Generator().manual_seed(1))
    t = torch.tensor([3, 30])
    with torch.no_grad():
        cond = model.get_learned_conditioning(LAYOUTS)
        model.train()
        a, b = (model.apply_model(z, t, cond) for _ in range(2))
        model.eval()
        c, d = (model.apply_model(z, t, cond) for _ in range(2))
    assert (a - b).abs().max() > 1e-4 and torch.equal(c, d)
    # make_train_step puts the model in train mode, the first stage in eval
    state = _state()
    state.model.eval()
    DT.make_train_step(state.model)(state, _batch(34), torch.Generator().manual_seed(0))
    assert state.model.unet.training and not state.model.first_stage_model.training


# ------------------------------------------------------------------- data
def test_synthetic_layout_range_batch_draws_as_jax():
    want = jax_factory._synthetic_layout_range_batch(np.random.default_rng(4), 2, JGEOM)
    got = synthetic_layout_range_batch(np.random.default_rng(4), 2, GEOM)
    assert sorted(got) == sorted(want) == ["cond", "image", "layout", "mask"]
    np.testing.assert_array_equal(got["layout"].numpy(), want["layout"])
    np.testing.assert_array_equal(got["cond"].numpy(), want["cond"])
    # the same scenes projected by each package: the log-scaling differs by
    # an f32 ulp under XLA, and a pixel whose nearest points tie, or whose
    # point lies on a pixel border, may take another depth
    assert got["image"].shape == want["image"].shape == (2, 32, 1024, 1)
    diff = np.abs(got["image"].numpy() - want["image"])
    assert (diff <= 1e-6).mean() >= 0.999 and diff.max() < 0.01
    assert (got["mask"].numpy() == want["mask"]).mean() >= 0.999


def _write_nuscenes(root, n=4):
    infos = []
    names = list(PR.NUSC_CLASS_NAMES) + ["barrier"]
    rng = np.random.default_rng(6)
    for i in range(n):
        pts = synthetic_scene(np.random.default_rng(40 + i), 20000)
        scan = np.concatenate([pts, rng.uniform(0, 255, (len(pts), 1)),
                               np.zeros((len(pts), 1))], 1).astype(np.float32)
        rel = f"samples/LIDAR_TOP/scan_{i}.bin"
        os.makedirs(os.path.join(root, "samples", "LIDAR_TOP"), exist_ok=True)
        scan.tofile(os.path.join(root, rel))
        k = 3 + i
        boxes = np.stack([rng.uniform(-30, 30, k), rng.uniform(-30, 30, k), rng.uniform(-2, 1, k),
                          rng.uniform(1, 6, k), rng.uniform(1, 3, k), rng.uniform(1, 3, k),
                          rng.uniform(-3, 3, k)], 1).astype(np.float32)
        box_names = [names[j] for j in rng.integers(0, len(names), k)]
        infos.append({"lidar_path": rel, "gt_names": box_names,
                      "scene_graph": {"keep_box": boxes, "keep_box_names": box_names}})
    for split in ("train", "val"):
        with open(os.path.join(root, f"nuscenes_infos_{split}.pkl"), "wb") as f:
            pickle.dump(infos, f)


def test_layout_range_reader_matches_jax(tmp_path):
    root = str(tmp_path)
    _write_nuscenes(root)
    for split in ("train", "val"):
        want = JR.NuScenesLayoutRangeDataset(root, split, geom=JGEOM, seed=3)
        got = PR.NuScenesLayoutRangeDataset(root, split, geom=GEOM, seed=3)
        assert len(got) == len(want) > 0
        for i in range(len(got)):
            a, b = got[i], want[i]
            assert sorted(a) == sorted(b) == ["image", "layout", "mask"]
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{split} {i} {k}")
        batch = PR.NuScenesLayoutRangeDataset.collate([got[0], got[1]])
        want_b = JR.NuScenesLayoutRangeDataset.collate([want[0], want[1]])
        for k in batch:
            np.testing.assert_array_equal(batch[k], want_b[k])
    ds = PR.NuScenesLayoutRangeDataset(root, "val", geom=GEOM)
    it = layout_range_batches(ds, 2, seed=1)
    b = next(it)
    assert b["image"].shape == (2, 32, 1024, 1) and torch.equal(b["cond"], b["layout"])
    assert (b["layout"][..., 12] > 0).any()
    with pytest.raises(ValueError, match="fewer"):
        next(layout_range_batches(ds, 9))


# -------------------------------------------------------- checkpoint and CLI
def test_checkpoint_round_trip_carries_encoder_and_its_ema(tmp_path):
    state = _state()
    step = DT.make_train_step(state.model)
    for i in range(2):
        state, _ = step(state, _batch(35 + i), torch.Generator().manual_seed(i))
    CK.save_checkpoint(str(tmp_path), state.step, state)
    fresh = _state(seed=99)
    CK.restore_checkpoint(str(tmp_path), fresh)
    enc = [k for k in state.params if k.startswith("cond_stage_model.")]
    assert enc and fresh.step == state.step == 2 and fresh.ema.step == 2
    for k in state.params:
        assert torch.equal(state.params[k], fresh.params[k]), k
        assert torch.equal(state.ema.params[k], fresh.ema.params[k]), k
    # both continue identically (dropout draws from torch's default
    # generator: the same seed for both)
    outs = []
    batch = _batch(37)
    for st in (state, fresh):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(5)
            st, logs = DT.make_train_step(st.model)(st, batch, torch.Generator().manual_seed(7))
        outs.append((float(logs["loss"]), st.params[enc[0]].detach().clone(),
                     st.ema.params[enc[0]].clone()))
    assert outs[0][0] == outs[1][0]
    assert torch.equal(outs[0][1], outs[1][1]) and torch.equal(outs[0][2], outs[1][2])


def test_cli_trains_the_tiny_layout_config_on_the_cpu(tmp_path):
    import yaml

    base = tmp_path / "tiny_layout.yaml"
    base.write_text(yaml.safe_dump(CFG))
    work = tmp_path / "run"
    common = ["--cpu", "--synthetic", "data.params.batch_size=2",
              "data.params.num_val_batches=1"]
    trainer = train_main(["-b", str(base), "--steps", "2", "--workdir", str(work), "-s", "3"]
                         + common)
    assert trainer.global_step == 2 and CK.latest_step(str(work / "ckpt")) == 2
    ckpt = torch.load(CK.checkpoint_path(str(work / "ckpt"), 2), weights_only=True)
    enc = [k for k in ckpt["ema"]["params"] if k.startswith("cond_stage_model.")]
    assert enc and all(k in ckpt["model"] for k in enc)
    resumed = train_main(["-b", str(base), "--steps", "3", "--workdir", str(tmp_path / "run2"),
                          "-r", str(work)] + common)
    assert resumed.global_step == 3
    with pytest.raises(ValueError, match="--data-root"):
        train_main(["-b", str(base), "--cpu", "--steps", "1", "--workdir", str(tmp_path / "x")])
