"""PyTorch port vs the JAX package: the rest of the data layer.

The degradation transform (the PIL-mode downsample, and the BSRGAN
pipelines at a fixed seed) to JAX's bits; the KITTI readers
(``load_semantic_labels``, ``SemanticKITTIRangeDataset``,
``KITTI360CameraDataset``, ``parse_kitti360_bbox_xml``,
``AnnotatedKITTI360Dataset``) and the factory targets ``sem_kitti``,
``kitti_camera`` and ``kitti_annotated`` on ``.bin``, ``.label``, PNG and
bbox XML files written under ``tmp_path``, to JAX's bits; the native loader
(built from ``native/lidar_io.cpp`` into the port's build directory)
against the Python reader; ``synthetic_latent_batch`` to JAX's bits; and
``device_synthetic``, whose scenes are held to JAX's family (the PRNG
streams differ): the same shapes and point counts, the valid fraction and
the depth percentiles within the bounds stated in the test.
"""
import jax
import numpy as np
import pytest
import torch

from lidar_layout_tpu.data import degradation as JDG
from lidar_layout_tpu.data import device_synthetic as JDS
from lidar_layout_tpu.data import factory as JF
from lidar_layout_tpu.data import readers as JR
from lidar_layout_tpu.data import synthetic as JS
from lidar_layout_tpu.ops.lidar import LidarGeometry as JGeom
from lidar_layout_tpu_torch.data import datasets as PDS
from lidar_layout_tpu_torch.data import degradation as PDG
from lidar_layout_tpu_torch.data import device_synthetic as PDV
from lidar_layout_tpu_torch.data import factory as PF
from lidar_layout_tpu_torch.data import native_loader as PN
from lidar_layout_tpu_torch.data import readers as PR
from lidar_layout_tpu_torch.data import synthetic as PS
from lidar_layout_tpu_torch.ops.lidar import LidarGeometry as PGeom

SIZE = (16, 128)
DSET = {"size": list(SIZE), "fov": [3, -25]}


def _scan(rng, n=3000):
    """A scan of n points (x, y, z, remission) around the sensor."""
    r = rng.uniform(2, 40, n)
    th = rng.uniform(-np.pi, np.pi, n)
    z = rng.uniform(-2, 1, n)
    return np.stack([r * np.cos(th), r * np.sin(th), z, rng.uniform(0, 1, n)],
                    1).astype(np.float32)


# ----------------------------------------------------------- degradation
@pytest.mark.parametrize("mode", JDG._PIL_MODES)
def test_degradation_transform_matches_jax(mode):
    """The PIL-mode downsample by (2, 4) equals JAX's bit for bit."""
    img = np.random.default_rng(0).uniform(-1, 1, (*SIZE, 1)).astype(np.float32)
    want = JDG.make_degradation_transform(SIZE, (2, 4), mode)(img)
    got = PDG.make_degradation_transform(SIZE, (2, 4), mode)(img)
    assert got.shape == (8, 32, 1)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown degradation"):
        PDG.make_degradation_transform(SIZE, (2, 4), "bicubic")


@pytest.mark.parametrize("light", [False, True])
def test_bsrgan_pipelines_match_jax(light):
    """The BSRGAN variant and its light pipeline at a fixed seed: JAX's
    output bit for bit (the same numpy, cv2 and scipy calls)."""
    img = np.random.default_rng(1).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    fn_j = JDG.degradation_fn_bsr_light if light else JDG.degradation_fn_bsr
    fn_p = PDG.degradation_fn_bsr_light if light else PDG.degradation_fn_bsr
    for seed in (0, 1, 2):
        want = fn_j(img, sf=4, rng=np.random.default_rng(seed))
        got = fn_p(img, sf=4, rng=np.random.default_rng(seed))
        assert got["image"].shape == (16, 16, 3)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_range_dataset_attaches_degraded_image():
    """RangeImageDataset's hook: ``degraded_image`` is each image through
    the transform, as JAX's ``_attach_degraded``."""
    geom = PGeom(size=SIZE, fov=(3, -25))
    ds = PDS.RangeImageDataset(None, batch_size=2, geom=geom, degradation="pil_bicubic",
                               scale_factors=(2, 4))
    b = next(ds.batches())
    assert b["degraded_image"].shape == (2, 8, 32, 1)
    want = PDG.make_degradation_transform(SIZE, (2, 4), "pil_bicubic")(b["image"][1].numpy())
    np.testing.assert_array_equal(b["degraded_image"][1].numpy(), want)


# ----------------------------------------------------------- the readers
def _write_semantic_kitti(root, rng):
    for seq, n in (("00", 2), ("01", 1)):
        vel = root / "dataset" / "sequences" / seq / "velodyne"
        lab = root / "dataset" / "sequences" / seq / "labels"
        vel.mkdir(parents=True)
        lab.mkdir(parents=True)
        for i in range(n):
            scan = _scan(rng)
            scan.tofile(vel / f"{i:06d}.bin")
            keys = np.array(list(JR.SEM_KITTI_LEARNING_MAP), np.uint32)
            labels = rng.choice(keys, len(scan)) | (rng.integers(0, 9, len(scan),
                                                                  dtype=np.uint32) << 16)
            labels.astype(np.uint32).tofile(lab / f"{i:06d}.label")


def _write_kitti360(root, rng, seqs=("0000", "0003")):
    from PIL import Image

    for seq in seqs:
        drive = f"2013_05_28_drive_{seq}_sync"
        vel = root / "data_3d_raw" / drive / "velodyne_points" / "data"
        cam = root / "data_2d_camera" / drive / "image_00" / "data_rect"
        vel.mkdir(parents=True)
        cam.mkdir(parents=True)
        for ts in (3, 7):
            _scan(rng).tofile(vel / f"{ts:010d}.bin")
            Image.fromarray(rng.integers(0, 256, (8, 32, 3), dtype=np.uint8)).save(
                cam / f"{ts:010d}.png")
    boxes = root / "data_3d_bboxes" / "train"
    boxes.mkdir(parents=True)
    objects = []
    for ts, label in ((3, "car"), (3, "person"), (3, "building"), (7, "truck")):
        verts = " ".join(f"{v:.4f}" for v in rng.uniform(-10, 10, 24))
        objects.append(
            f"<object{len(objects)}><label>{label}</label><timestamp>{ts}</timestamp>"
            f"<transform><rows>4</rows><cols>4</cols><data>1 0 0 0 0 1 0 0 0 0 1 0 0 0 0 1"
            f"</data></transform><vertices><rows>8</rows><cols>3</cols><data>{verts}</data>"
            f"</vertices></object{len(objects)}>")
    objects.append("<object9><label>car</label><timestamp>3</timestamp></object9>")
    (boxes / "2013_05_28_drive_0000_sync.xml").write_text(
        "<opencv_storage>" + "".join(objects) + "</opencv_storage>")


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_kitti_readers_match_jax(tmp_path):
    """Every reader's items equal JAX's bit for bit: the semantic labels
    through the learning map (instance bits masked off), the one-hot maps
    with a filtered category, the camera views with JAX's camera drop
    (train split, the same seeded draws), the bbox XML (unknown labels and
    objects without a transform skipped) and the annotated boxes."""
    rng = np.random.default_rng(2)
    _write_semantic_kitti(tmp_path, rng)
    _write_kitti360(tmp_path, rng)
    label = str(tmp_path / "dataset" / "sequences" / "00" / "labels" / "000000.label")
    np.testing.assert_array_equal(PR.load_semantic_labels(label),
                                  JR.load_semantic_labels(label))
    jgeom, pgeom = JGeom(size=SIZE, fov=(3, -25)), PGeom(size=SIZE, fov=(3, -25))
    pairs = [
        (JR.SemanticKITTIRangeDataset(str(tmp_path), "train", jgeom, filtered_map_cats=(5,)),
         PR.SemanticKITTIRangeDataset(str(tmp_path), "train", pgeom, filtered_map_cats=(5,)),
         3),
        (JR.KITTI360CameraDataset(str(tmp_path), "train", jgeom, seed=4),
         PR.KITTI360CameraDataset(str(tmp_path), "train", pgeom, seed=4), 2),
        (JR.AnnotatedKITTI360Dataset(str(tmp_path), "train", geom=jgeom),
         PR.AnnotatedKITTI360Dataset(str(tmp_path), "train", geom=pgeom), 2),
        (JR.AnnotatedKITTI360Dataset(str(tmp_path), "train", condition_key="center",
                                     geom=jgeom),
         PR.AnnotatedKITTI360Dataset(str(tmp_path), "train", condition_key="center",
                                     geom=pgeom), 2)]
    for jds, pds, n in pairs:
        assert pds.files == jds.files and len(pds) == n
        for i in list(range(n)) * 2:   # twice: the camera drop draws anew
            _equal(pds[i], jds[i])
    xml = str(tmp_path / "data_3d_bboxes" / "train" / "2013_05_28_drive_0000_sync.xml")
    got, want = PR.parse_kitti360_bbox_xml(xml), JR.parse_kitti360_bbox_xml(xml)
    assert sorted(got) == sorted(want) == [3, 7] and len(got[3][1]) == 2
    for ts in want:
        _equal(dict(zip("vl", got[ts])), dict(zip("vl", want[ts])))
    assert int((pairs[2][1][0]["bbox_labels"] >= 0).sum()) == 2


@pytest.mark.parametrize("target,params", [
    ("lidm.data.kitti.SemanticKITTITrain", {}), ("kitti_camera", {"split": "val"}),
    ("kitti_annotated", {}), ("kitti_annotated", {"condition_key": "center"})])
def test_kitti_factory_targets_match_jax(tmp_path, target, params):
    """A batch of every scan under the root: the port's samples (in its
    shuffled order) are JAX's samples, bit for bit, as tensors; without a
    root both fall back to the synthetic range batch."""
    rng = np.random.default_rng(3)
    _write_semantic_kitti(tmp_path, rng)
    _write_kitti360(tmp_path, rng)
    n = 3 if "Semantic" in target else 2
    want = next(JF.build_batches(target, dict(params), DSET, str(tmp_path), n, seed=5))
    got = next(PF.build_batches(target, dict(params), DSET, str(tmp_path), n, seed=5))
    assert set(got) == set(want) and all(isinstance(v, torch.Tensor) for v in got.values())
    order = [next(j for j in range(n) if np.array_equal(got["image"][i].numpy(),
                                                        want["image"][j]))
             for i in range(n)]
    assert sorted(order) == list(range(n))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k][order], err_msg=k)
    fallback = next(PF.build_batches(target, dict(params), DSET, None, 2, seed=5))
    want = PS.synthetic_range_batch(np.random.default_rng(5), 2, PGeom(size=SIZE, fov=(3, -25)))
    for k in want:
        assert torch.equal(fallback[k], want[k]), k


# ---------------------------------------------------------- native loader
def test_native_loader_matches_python_reader(tmp_path):
    """The g++-built library in the port's build directory (not the
    repository's native/liblidar_io.so): each scan's xyz, remission and
    count equal the .bin file, truncated at max_points; RangeImageDataset's
    batches through it equal the Python reader's, and say which ran."""
    rng = np.random.default_rng(6)
    scans = [_scan(rng, n) for n in (500, 1200, 900, 1500)]
    drive = tmp_path / "data_3d_raw" / "2013_05_28_drive_0000_sync" / "velodyne_points" / "data"
    drive.mkdir(parents=True)
    paths = []
    for i, s in enumerate(scans):
        s.tofile(drive / f"{i:010d}.bin")
        paths.append(str(drive / f"{i:010d}.bin"))
    so = PN.build_native()
    assert so.parent == PN.BUILD_DIR and so.exists()
    loader = PN.NativeScanLoader(paths, max_points=1000)
    for k in (2, 0, 3, 1):
        loader.enqueue(k)
    seen = set()
    for _ in range(4):
        k, xyz, rem, nv = loader.next()
        want = scans[k][:1000]
        assert nv == len(want)
        np.testing.assert_array_equal(xyz[:nv], want[:, :3])
        np.testing.assert_array_equal(rem[:nv], want[:, 3])
        assert not xyz[nv:].any()
        seen.add(k)
    loader.close()
    assert seen == {0, 1, 2, 3}
    geom = PGeom(size=SIZE, fov=(3, -25))
    native = PDS.RangeImageDataset(str(tmp_path), batch_size=2, geom=geom, seed=7,
                                   max_points=1000)
    python = PDS.RangeImageDataset(str(tmp_path), batch_size=2, geom=geom, seed=7,
                                   max_points=1000)
    it_n, it_p = native.batches(), python.batches(use_native=False)
    for _ in range(3):   # across a reshuffle
        bn, bp = next(it_n), next(it_p)
        for k in bp:
            assert torch.equal(bn[k], bp[k]), k
    assert native.reader == "native" and python.reader == "python"


# -------------------------------------------------------------- synthetic
def test_synthetic_latent_batch_matches_jax():
    want = JS.synthetic_latent_batch(np.random.default_rng(8), 3, (4, 16, 8))
    got = PS.synthetic_latent_batch(np.random.default_rng(8), 3, (4, 16, 8))
    assert got["image"].dtype == torch.float32
    np.testing.assert_array_equal(got["image"].numpy(), want["image"])


def _scene_stats(img, mask):
    valid = np.asarray(mask) > 0
    depth = np.exp2((np.asarray(img) * 0.5 + 0.5) * 5.84) - 1.0
    return valid.mean(), np.percentile(depth[valid], [10, 50, 90])


def test_device_synthetic_scenes_are_jax_family():
    """Scenes of JAX's family drawn from another PRNG stream: JAX's point
    count and layout (ground, 14 box slots, 24 poles, the rest as ground),
    every point finite; over 8 KITTI scenes at 120,000 points the valid
    fraction within 0.02 of JAX's (both read 0.30-0.31 over seeds 0-2) and
    the 50th and 90th depth percentiles within 5%, the 10th (set by the
    nearest boxes) within 30%. ``host_range2pcd`` equals JAX's."""
    jpts = np.asarray(JDS.synthetic_scene_device(jax.random.key(0), 10000))
    ppts = PDV.synthetic_scenes_device(torch.Generator().manual_seed(0), 2, 10000)
    assert ppts.shape == (2, *jpts.shape) and torch.isfinite(ppts).all()
    ground = int(10000 * 0.6)
    per_box = int(10000 * 0.3) // PDV.MAX_BOXES
    z = ppts[..., 2].numpy()
    assert np.abs(z[:, :ground] + 1.9).max() < 0.5   # the ground annulus first
    assert ((z[:, ground:ground + per_box * 14] >= -2.0 - 1e-5)
            & (z[:, ground:ground + per_box * 14] <= 1.0 + 1e-5)).all()
    jimg, jmask = JDS.scene_image_batch(jax.random.key(0), 8)
    pimg, pmask = PDV.scene_image_batch(torch.Generator().manual_seed(0), 8)
    assert pimg.shape == jimg.shape == (8, 64, 1024) and pmask.shape == jmask.shape
    (jv, jp), (pv, pp) = _scene_stats(jimg, jmask), _scene_stats(pimg.numpy(), pmask.numpy())
    assert abs(pv - jv) <= 0.02, (pv, jv)
    assert np.all(np.abs(pp[1:] - jp[1:]) <= 0.05 * jp[1:]), (pp, jp)
    assert abs(pp[0] - jp[0]) <= 0.3 * jp[0], (pp, jp)
    one = np.asarray(jimg[0])
    np.testing.assert_array_equal(PDV.host_range2pcd(one), JDS.host_range2pcd(one))
