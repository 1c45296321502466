"""PyTorch port vs the JAX package: MinkowskiNet and SPVCNN, the feature nets
of FSVD and FPVD, and the voxel modalities of the eval registry.

The weights are a state_dict with the reference's torchsparse names and
shapes (JAX's ``make_template_state_dict``): JAX takes it through
``convert_torchsparse_state_dict``, the port through its inverse
(``utils/convert.seg_net_state_dict``) and, written as a ``model.ckpt``,
through the reference loader. The nets run at JAX's test config
``SegNetConfig(input_dims=4, cr=0.25, num_class=5, capacity=1024, bits=6)`` on
two clouds, one inside the 6-bit range and one past it (its codes clip, and
its pyramid overflows level by level), with and without
``return_final_logits``, held within 1e-5 relative L2; the JAX nets run op
by op (a jitted one takes a minute to compile on the CPU), each cloud once,
and the classifier logits are JAX's ``classifier`` Dense applied to the
first cloud's final features.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_layout_tpu.eval import device_metrics as JD
from lidar_layout_tpu.eval import sparse_seg_nets as J
from lidar_layout_tpu.ops import voxel as JV
from lidar_layout_tpu_torch.eval import device_metrics as PD
from lidar_layout_tpu_torch.eval import registry as PREG
from lidar_layout_tpu_torch.eval import sparse_seg_nets as P
from lidar_layout_tpu_torch.ops import voxel as PV
from lidar_layout_tpu_torch.utils.convert import load_torchsparse_checkpoint, seg_net_state_dict
from torch_port_helpers import one_intra_op_thread

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
T = torch.from_numpy
TINY = dict(input_dims=4, cr=0.25, num_class=5, capacity=1024, bits=6)
ARCHS = {"minkowskinet": (J.MinkowskiNet, P.MinkowskiNet), "spvcnn": (J.SPVCNN, P.SPVCNN)}


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _clouds(n=700):
    """(coords, feats, mask) of two clouds: voxel coords in [0, 40) and in
    [0, 90) (past 2**6), feats [0.05 coords, -1], the last 50 rows masked."""
    rng = np.random.default_rng(0)
    coords = np.stack([rng.integers(0, 40, (n, 3)), rng.integers(0, 90, (n, 3))]).astype(np.int32)
    feats = np.concatenate([coords * 0.05, -np.ones((2, n, 1))], -1).astype(np.float32)
    mask = np.ones((2, n), bool)
    mask[:, -50:] = False
    return coords, feats, mask


@pytest.fixture(scope="module")
def runs():
    """Per arch: the template state_dict, the converted flax params, and JAX's
    outputs: both clouds with final logits, the first with the classifier."""
    coords, feats, mask = _clouds()
    rng = np.random.default_rng(1)
    cfg = J.SegNetConfig(**TINY)
    out = {}
    for arch, (jcls, _) in ARCHS.items():
        sd = J.make_template_state_dict(cfg, arch, rng)
        params = J.convert_torchsparse_state_dict(sd, cfg, arch)
        net = jcls(cfg)
        jout = {(b, True): {n: np.asarray(v) for n, v in net.apply(
            params, jnp.asarray(coords[b]), jnp.asarray(feats[b]), jnp.asarray(mask[b])).items()}
            for b in range(2)}
        # return_final_logits=False is the net's ``classifier`` Dense over
        # those final features, with the same coords and mask: applied here
        # from JAX's parameters (a third op-by-op forward costs 7 s)
        head = params["params"]["classifier"]
        jout[0, False] = {**jout[0, True], "logits": jout[0, True]["logits"]
                          @ np.asarray(head["kernel"]) + np.asarray(head["bias"])}
        out[arch] = (sd, params, jout)
    return out


def _port_net(arch, params):
    net = ARCHS[arch][1](P.SegNetConfig(**TINY))
    net.load_state_dict(seg_net_state_dict(params), strict=True)
    return net.eval()


def _grid(cap=512):
    coords, _, mask = _clouds()
    return PV.build_grid(T(coords), T(mask), cap, 6)[0]


@pytest.mark.parametrize("mode", ["submanifold", "1x1", "down", "transposed"])
def test_ts_conv3d_matches_jax(mode):
    grid = _grid()
    parent = PV.build_grid(grid.coords >> 1, grid.mask, 256, 6)[0]
    rng = np.random.default_rng(2)
    ks, stride, transposed = {"submanifold": (3, 1, False), "1x1": (1, 1, False),
                              "down": (2, 2, False), "transposed": (2, 2, True)}[mode]
    src, dst = (parent, grid) if transposed else (grid, parent if ks == 2 else grid)
    x = rng.standard_normal((2, src.mask.shape[1], 5)).astype(np.float32)
    conv = P.TSConv3d(5, 7, ks, stride, transposed)
    tables = P._Tables([grid, parent], 6)
    table = {"submanifold": lambda: tables.sub(0), "1x1": lambda: None,
             "down": lambda: tables.down(0), "transposed": lambda: tables.up(0)}[mode]()
    with torch.no_grad():
        got = conv(T(x), table, dst.mask).numpy()
    jconv = J.TSConv3d(7, ks, stride, transposed, bits=6)
    params = {"params": {"kernel": jnp.asarray(conv.kernel.detach().numpy())}}
    for b in range(2):
        jsrc, jdst = (JV.VoxelGrid(*(jnp.asarray(t[b].numpy()) for t in g)) for g in (src, dst))
        want = np.asarray(jconv.apply(params, jsrc, jnp.asarray(x[b]),
                                      jdst if ks == 2 else None))
        assert _rel_l2(got[b], want) <= 1e-5


def test_pyramid_matches_jax_with_clipping_and_overflow():
    coords, _, mask = _clouds()
    cfg = P.SegNetConfig(**TINY)
    grids, p2v = P.build_pyramid(T(coords), T(mask), cfg)
    for b in range(2):
        jpyr = J._build_pyramid(jnp.asarray(coords[b]), jnp.asarray(mask[b]),
                                J.SegNetConfig(**TINY))
        np.testing.assert_array_equal(p2v[b].numpy(), np.asarray(jpyr[0][1]))
        for g, (jg, _) in zip(grids, jpyr):
            for got, want in zip(g, jg):
                np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    # the second cloud's codes clip (coords past 63) and its coarse levels overflow
    assert (coords[1][mask[1]] > 63).any()
    full = [int(g.mask[1].sum()) == g.mask.shape[1] for g in grids]
    assert full[2] and full[3] and not full[0]
    assert int(PV.count_unique(grids[2].coords[1:] >> 1, grids[2].mask[1:], 6)) > 128


@pytest.mark.parametrize("final", [True, False])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_net_matches_jax(runs, arch, final):
    _, params, jout = runs[arch]
    coords, feats, mask = _clouds()
    with torch.no_grad():
        out = _port_net(arch, params)(T(coords), T(feats), T(mask), return_final_logits=final)
    for b in (0, 1) if final else (0,):
        want = jout[b, final]
        assert _rel_l2(out["logits"][b].numpy(), want["logits"]) <= 1e-5
        np.testing.assert_array_equal(out["coords"][b].numpy(), want["coords"])
        np.testing.assert_array_equal(out["mask"][b].numpy(), want["mask"])
    assert out["logits"].shape[-1] == (P.SegNetConfig(**TINY).cs[8] if final else 5)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_reference_checkpoint_loads_strictly(runs, arch, tmp_path):
    sd, params, _ = runs[arch]
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    tensors.update({k: torch.tensor(0) for k in _port_net(arch, params).state_dict()
                    if k.endswith("num_batches_tracked")})
    path = tmp_path / "model.ckpt"
    torch.save({"state_dict": tensors, "epoch": 3}, path)
    net = load_torchsparse_checkpoint(ARCHS[arch][1](P.SegNetConfig(**TINY)), str(path)).eval()
    carried = _port_net(arch, params)
    assert set(seg_net_state_dict(params)) == set(carried.state_dict())
    for k, v in carried.state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k
    coords, feats, mask = _clouds()
    with torch.no_grad():
        a = net(T(coords), T(feats), T(mask))["logits"]
        b = carried(T(coords), T(feats), T(mask))["logits"]
    assert torch.equal(a, b)
    # strict: a missing weight or an unknown key is refused
    for broken in ({k: v for k, v in tensors.items() if k != "stem.0.kernel"},
                   {**tensors, "stem.9.kernel": tensors["stem.0.kernel"]}):
        torch.save({"state_dict": broken}, path)
        with pytest.raises(KeyError):
            load_torchsparse_checkpoint(ARCHS[arch][1](P.SegNetConfig(**TINY)), str(path))


def test_voxel_inputs_match_jax():
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-40, 40, (2, 900, 3)).astype(np.float32)
    valid = rng.random((2, 900)) < 0.6
    cap = 400
    got = PD.voxel_feature_inputs(T(xyz), T(valid), cap, PREG.SEG_NET_CFG.voxel_size)
    for b in range(2):
        want = JD.voxel_feature_inputs(jnp.asarray(xyz[b]), jnp.asarray(valid[b]), cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


@pytest.fixture
def small_registry(monkeypatch):
    """The registry's nets at 2048 level-0 voxels and 1200 points a cloud
    (the CPU's share)."""
    monkeypatch.setattr(PREG, "SEG_NET_CFG", P.SegNetConfig(cr=0.5, capacity=2048, bits=10))
    monkeypatch.setattr(PREG, "MAX_POINTS", 1200)


def _scans(n, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.uniform((-70, -70, -3), (70, 70, 2), (int(rng.integers(900, 1600)), 3))
            .astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("modality", ["voxel", "point_voxel"])
def test_feature_fn_equals_the_device_twin_per_cloud(small_registry, modality, capsys):
    clouds = _scans(3)
    fn = PREG.build_feature_fn("64", modality, "/nonexistent", feat_batch=2, device="cpu")
    assert "randomly initialised" in capsys.readouterr().out
    one = PREG.build_feature_fn("64", modality, "/nonexistent", feat_batch=1, device="cpu")
    assert fn.param_hash == one.param_hash and len(fn.param_hash) == 16
    host = fn(clouds)
    assert host.shape == (3, 768) and np.isfinite(host).all() and np.abs(host).sum() > 0
    np.testing.assert_array_equal(host, one(clouds))       # the batch a cloud rode in
    mink = PREG.build_voxel_feature_net("64", "voxel", "/nonexistent", device="cpu")
    spv = PREG.build_voxel_feature_net("64", "point_voxel", "/nonexistent", device="cpu")
    twin = PD.make_voxel_descriptor_fn(mink, spv, group=2)
    n = max(len(c) for c in clouds)
    xyz = np.zeros((3, n, 3), np.float32)
    valid = np.zeros((3, n), bool)
    for i, c in enumerate(clouds):
        xyz[i, :len(c)], valid[i, :len(c)] = c, True
    fsvd, fpvd = twin(T(xyz), T(valid))
    np.testing.assert_array_equal((fsvd if modality == "voxel" else fpvd).numpy(), host)


def test_voxel_nets_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the default without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        PREG.build_voxel_feature_net("64", "voxel", "/nonexistent")
    with pytest.raises(RuntimeError, match="CUDA"):
        PREG.build_feature_fn("64", "point_voxel", "/nonexistent")
