"""PyTorch port vs the JAX package: the autoencoder's data, and its CLI.

The ``nusc_range`` and ``kitti_range`` targets of ``data/factory`` against
the JAX factory's, over a few random sweeps (``.pcd.bin`` with a
``sample_data.json``) and velodyne scans written to ``tmp_path``, and their
synthetic fallbacks; then ``train_lidm`` on both autoencoder YAMLs for two
steps on the CPU (``--synthetic``, dotlist overrides that shrink the widths
and the image), a resume, and the run's checkpoint read by
``load_first_stage_params`` as a LiDM's first stage.
"""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from lidar_layout_tpu.data import factory as jax_factory
from lidar_layout_tpu.data import native_loader as jax_native_loader
from lidar_layout_tpu_torch import config as PC
from lidar_layout_tpu_torch.data import factory as PF
from lidar_layout_tpu_torch.train import ae_trainer as PT
from lidar_layout_tpu_torch.train import checkpoint as CK
from lidar_layout_tpu_torch.train.train_lidm import main as train_main
from torch_port_helpers import one_intra_op_thread

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
ROOT = Path(__file__).resolve().parents[1]
NUSC = {"size": [16, 128], "fov": [10, -30]}
KITTI = {"size": [16, 128], "fov": [3, -25]}


def _cloud(rng, n):
    """(n, 3) points 2-50 m from the sensor, within 12 degrees of level."""
    r = rng.uniform(2, 50, n)
    th, el = rng.uniform(-np.pi, np.pi, n), rng.uniform(-0.2, 0.05, n)
    return np.stack([r * np.cos(el) * np.cos(th), r * np.cos(el) * np.sin(th),
                     r * np.sin(el)], 1)


def _write_nuscenes(root, n=5, seed=0):
    """``n`` train and 2 val sweeps (x, y, z, intensity, ring) with their
    sample_data.json tables, as the reference lays them out."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "v1.0-trainval")
    os.makedirs(os.path.join(base, "sweeps", "LIDAR_TOP"))
    for table, count in (("v1.0-trainval", n), ("v1.0-mini", 2)):
        rows = []
        for i in range(count):
            name = f"sweeps/LIDAR_TOP/{table}_{i:03d}.pcd.bin"
            pts = _cloud(rng, 4000)
            scan = np.concatenate([pts, rng.uniform(0, 255, (4000, 1)),
                                   rng.integers(0, 32, (4000, 1))], 1).astype(np.float32)
            scan.tofile(os.path.join(base, name))
            rows.append({"filename": name})
        rows.append({"filename": "samples/CAM_FRONT/x.jpg"})
        os.makedirs(os.path.join(base, table), exist_ok=True)
        with open(os.path.join(base, table, "sample_data.json"), "w") as f:
            json.dump(rows, f)


@pytest.mark.parametrize("channels", [1, 2])
def test_nusc_range_batches_match_jax_factory(tmp_path, channels):
    """The reader over the same sweeps and the same shuffles: both numpy,
    bit for bit; the val split reads the v1.0-mini table."""
    _write_nuscenes(str(tmp_path))
    dset = {**NUSC, "num_channels": channels}
    for split in ("train", "val"):
        want_it = jax_factory.build_batches("nusc_range", {"split": split}, dset, str(tmp_path),
                                            2, seed=3)
        got_it = PF.build_batches("lidm.data.nusc_dataset.nuScenesImageTrain", {"split": split},
                                  dset, str(tmp_path), 2, seed=3)
        for _ in range(3):
            want, got = next(want_it), next(got_it)
            assert set(got) == set(want) == {"image", "mask"}
            for k in want:
                assert got[k].shape == want[k].shape == (2, 16, 128, channels if k == "image"
                                                         else 1)
                np.testing.assert_array_equal(got[k].numpy(), want[k])
        assert (want["mask"]).mean() > 0.1


def test_kitti_range_batches_and_fallbacks_match_jax_factory(tmp_path, monkeypatch):
    """kitti_range over velodyne scans (projected in f32 by each package:
    a point on a pixel border may floor either way, so almost every pixel of
    the mask is bit-equal, and the log-scaling differs by an f32 ulp where
    XLA fuses it), and both targets' synthetic fallbacks without a root.
    JAX's threaded native loader hands a batch's scans over in the order its
    threads finish (``RangeImageDataset.batches`` drops the index it
    returns), so the JAX side reads through its Python reader, which keeps
    the shuffled order, as the port does."""
    def no_native_loader(*_, **__):
        raise RuntimeError("native loader left out: its batch order varies")
    monkeypatch.setattr(jax_native_loader, "NativeScanLoader", no_native_loader)
    rng = np.random.default_rng(1)
    seq = tmp_path / "data_3d_raw" / "2013_05_28_drive_0000_sync" / "velodyne_points" / "data"
    seq.mkdir(parents=True)
    for i in range(4):
        np.concatenate([_cloud(rng, 5000), rng.uniform(0, 1, (5000, 1))], 1).astype(
            np.float32).tofile(seq / f"{i:010d}.bin")
    want = next(jax_factory.build_batches("kitti_range", {}, KITTI, str(tmp_path), 2, seed=4))
    got = next(PF.build_batches("lidm.data.kitti.KITTI360Train", {}, KITTI, str(tmp_path), 2,
                                seed=4))
    assert got["image"].shape == want["image"].shape == (2, 16, 128, 1)
    np.testing.assert_allclose(got["image"].numpy(), want["image"], atol=1e-6)
    assert (got["mask"].numpy() == want["mask"]).mean() >= 0.999
    assert (want["mask"] > 0).mean() > 0.1
    for target, dset in (("nusc_range", NUSC), ("kitti_range", KITTI)):
        want = next(jax_factory.build_batches(target, {}, dset, None, 2, seed=5))
        got = next(PF.build_batches(target, {}, dset, str(tmp_path / "none"), 2, seed=5))
        np.testing.assert_allclose(got["image"].numpy(), want["image"], atol=1e-6)
        assert (got["mask"].numpy() == want["mask"]).mean() >= 0.999


# ------------------------------------------------------------------ the CLI
TINY = ["model.params.ddconfig.ch=8", "model.params.ddconfig.ch_mult=[1,2]",
        "model.params.ddconfig.strides=[[1,2]]", "model.params.ddconfig.num_res_blocks=1",
        "model.params.n_embed=64", "data.params.dataset.size=[16,128]",
        "data.params.batch_size=2", "data.params.num_val_batches=1"]


@pytest.mark.parametrize("yaml_name", ["kitti", "nuscenes"])
def test_cli_trains_the_autoencoder_and_its_file_is_a_first_stage(tmp_path, yaml_name):
    """train_lidm on the YAML (the nuScenes one accumulates 2 batches, its
    nusc_range target synthetic) for 2 steps, then a resume to 3; the
    checkpoint holds the model, the discriminator under
    ``loss.discriminator.`` and both optimizers, and loads unchanged as a
    LiDM's first stage, whose decode is finite."""
    yaml_path = str(ROOT / f"configs/autoencoder/{yaml_name}/autoencoder_c2_p4.yaml")
    work = tmp_path / "run"
    trainer = train_main(["-b", yaml_path, "--cpu", "--synthetic", "--steps", "2",
                          "--workdir", str(work), "-s", "3"] + TINY)
    state = trainer.state
    assert isinstance(state, PT.AETrainState) and trainer.global_step == 2
    assert [type(m).__name__ for m in (state.model, state.disc)] == [
        "VQModel", "LiDARNLayerDiscriminator"]
    assert state.disc.conv_in.in_channels == 1 and state.disc.norm_last.weight.numel() == 512
    assert (state.opt_g.accumulate, state.opt_d.accumulate) == ((2, 2) if yaml_name ==
                                                                "nuscenes" else (1, 1))
    metrics = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    assert "val/rec_loss" in metrics[-1] and np.isfinite(metrics[-1]["val/rec_loss"])
    path = CK.checkpoint_path(str(work / "ckpt"), 2)
    ckpt = torch.load(path, weights_only=True)
    assert {"step", "state_dict", "optimizer_g", "optimizer_d"} <= set(ckpt)
    disc_keys = {k for k in ckpt["state_dict"] if k.startswith("loss.")}
    assert disc_keys == {"loss.discriminator." + k for k in state.disc.state_dict()}
    if yaml_name == "nuscenes":
        return

    resumed = train_main(["-b", yaml_path, "--cpu", "--synthetic", "--steps", "3", "--workdir",
                          str(tmp_path / "run2"), "-r", str(work)] + TINY)
    assert resumed.global_step == 3

    lidm = PC.load_yaml(str(ROOT / "configs/lidar_diffusion/kitti/uncond_c2_p4.yaml"))
    ae = PC.apply_dotlist(PC.load_yaml(yaml_path), TINY)["model"]["params"]
    p = lidm["model"]["params"]
    p.update(timesteps=64, image_size=[16, 64])
    p["unet_config"]["params"].update(model_channels=32, num_res_blocks=1,
                                      attention_resolutions=[2], channel_mult=[1, 2],
                                      num_head_channels=8)
    p["first_stage_config"]["params"].update(
        {k: ae[k] for k in ("ddconfig", "n_embed", "embed_dim", "use_mask")}, ckpt_path=path)
    model = PC.instantiate_from_config(lidm["model"])
    CK.load_first_stage_params(p["first_stage_config"]["params"]["ckpt_path"], model)
    for k, v in model.first_stage_model.state_dict().items():
        assert torch.equal(v, ckpt["state_dict"][k]), k
    with torch.no_grad():
        img = model.decode_first_stage(torch.randn(2, 16, 64, 8))
    assert img.shape == (2, 16, 128, 1) and bool(torch.isfinite(img).all())
