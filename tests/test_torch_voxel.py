"""PyTorch port vs the JAX package: serialization codes, the fixed-capacity
voxel grids, ``SparseConvBlock``, ``SparseVoxelNet`` and the depth-sector
descriptor of FSVD/FPVD.

The port batches over a leading cloud dimension; each cloud's result is held
to JAX's on that cloud alone. The integer structures (codes, grids,
point-to-voxel maps, lookups) must be equal, on inputs built to reach the
JAX package's limits: coords below 0 and past ``2**bits`` (codes clip them,
``lookup`` misses them) and clouds with more distinct voxels than the
grid's capacity (the overflow merges into its last row). Float outputs are
held within 1e-5 relative L2 (f32; the sums run in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_layout_tpu.eval import voxel_nets as JVN
from lidar_layout_tpu.models.sparse_vae import SparseConvBlock as JSparseConvBlock
from lidar_layout_tpu.ops import serialization as JSER
from lidar_layout_tpu.ops import voxel as JV
from lidar_layout_tpu_torch.eval import voxel_nets as PVN
from lidar_layout_tpu_torch.models.sparse_vae import SparseConvBlock
from lidar_layout_tpu_torch.ops import serialization as PSER
from lidar_layout_tpu_torch.ops import voxel as PV
from lidar_layout_tpu_torch.utils.convert import dense_tree_state_dict
from torch_port_helpers import one_intra_op_thread, random_flax_params

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
T = torch.from_numpy
BITS, CAP = 6, 128


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _clouds(seed=0, n=400):
    """Two clouds of int coords, their last 40 rows masked out: the first in
    [-1, 4) (at most 125 distinct voxels, duplicates, negatives clipped to
    0), the second in [-4, 100) (past 2**6 = 64 on every axis, about 350
    distinct voxels, past CAP)."""
    rng = np.random.default_rng(seed)
    coords = np.stack([rng.integers(-1, 4, (n, 3)),
                       rng.integers(-4, 100, (n, 3))]).astype(np.int32)
    mask = np.ones((2, n), bool)
    mask[:, -40:] = False
    return coords, mask


def _grid_np(grid, b):
    return [t[b].numpy() for t in grid]


@pytest.mark.parametrize("bits", [6, 10])
def test_codes_match_jax(bits):
    rng = np.random.default_rng(bits)
    g = rng.integers(-5, 1100, (2, 500, 3)).astype(np.int32)
    for order in PSER.ORDERS:
        got = PSER.serialize_code(T(g), order, bits).numpy()
        for b in range(2):
            np.testing.assert_array_equal(got[b], np.asarray(
                JSER.serialize_code(jnp.asarray(g[b]), order, bits)))
    np.testing.assert_array_equal(PSER.part1by2_32(T(g[0, :, 0])).numpy(),
                                  np.asarray(JSER.part1by2_32(jnp.asarray(g[0, :, 0]))))
    pts = rng.uniform(-30, 30, (300, 3)).astype(np.float32)
    np.testing.assert_array_equal(PSER.grid_coords(T(pts), 0.05).numpy(),
                                  np.asarray(JSER.grid_coords(jnp.asarray(pts), 0.05)))
    codes = PSER.z_order_code(T(g[0]), bits)
    mask = rng.random(500) < 0.7
    np.testing.assert_array_equal(
        PSER.argsort_with_mask(codes, T(mask)).numpy(),
        np.asarray(JSER.argsort_with_mask(jnp.asarray(codes.numpy()), jnp.asarray(mask))))


def test_build_grid_clips_and_overflows_as_jax():
    coords, mask = _clouds()
    grid, p2v = PV.build_grid(T(coords), T(mask), CAP, BITS)
    counts = PV.count_unique(T(coords), T(mask), BITS).numpy()
    assert counts[1] > CAP > counts[0]                 # the second cloud overflows
    assert (coords[mask] >= 1 << BITS).any() and (coords[mask] < 0).any()
    for b in range(2):
        jg, jp = JV.build_grid(jnp.asarray(coords[b]), jnp.asarray(mask[b]), CAP, BITS)
        for got, want in zip(_grid_np(grid, b), jg):
            np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(p2v[b].numpy(), np.asarray(jp))
        assert counts[b] == int(JV.count_unique(jnp.asarray(coords[b]), jnp.asarray(mask[b]),
                                                BITS))
    # the overflow's last row: the least code and the greatest coords merged there
    assert grid.mask[1].all() and grid.codes[1, -1] < PV.PAD_CODE


def test_lookup_misses_out_of_range_queries_as_jax():
    coords, mask = _clouds(1)
    grid, _ = PV.build_grid(T(coords), T(mask), CAP, BITS)
    rng = np.random.default_rng(2)
    query = np.concatenate([coords[:, :150] + rng.integers(-1, 2, (2, 150, 3)),
                            rng.integers(-3, 70, (2, 100, 3))], axis=1).astype(np.int32)
    query[:, :3] = [[-1, 0, 0], [0, 64, 0], [63, 63, 63]]
    idx, hit = PV.lookup(grid, T(query), BITS)
    assert hit.any() and not hit.all()
    for b in range(2):
        jidx, jhit = JV.lookup(JV.VoxelGrid(*(jnp.asarray(a) for a in _grid_np(grid, b))),
                               jnp.asarray(query[b]), BITS)
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(hit[b].numpy(), np.asarray(jhit))


@pytest.mark.parametrize("reduce", ["mean", "sum"])
def test_gather_and_pool_match_jax(reduce):
    coords, mask = _clouds(3)
    grid, _ = PV.build_grid(T(coords), T(mask), CAP, BITS)
    feats = np.random.default_rng(4).standard_normal((2, CAP, 5)).astype(np.float32)
    nb = PV.gather_neighbors(grid, T(feats), BITS).numpy()
    pgrid, pfeats, c2p = PV.pool_to_parent(grid, T(feats), 64, BITS, reduce)
    for b in range(2):
        jgrid = JV.VoxelGrid(*(jnp.asarray(a) for a in _grid_np(grid, b)))
        np.testing.assert_array_equal(nb[b], np.asarray(
            JV.gather_neighbors(jgrid, jnp.asarray(feats[b]), BITS)))
        jpg, jpf, jc2p = JV.pool_to_parent(jgrid, jnp.asarray(feats[b]), 64, BITS, reduce)
        for got, want in zip(_grid_np(pgrid, b), jpg):
            np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(c2p[b].numpy(), np.asarray(jc2p))
        np.testing.assert_allclose(pfeats[b].numpy(), np.asarray(jpf), rtol=1e-6, atol=1e-6)


def test_subdivide_occupancy_and_voxelize_match_jax():
    coords, mask = _clouds(5)
    child, _ = PV.build_grid(T(coords), T(mask), CAP, BITS)
    parent, _ = PV.build_grid(child.coords >> 1, child.mask, 64, BITS)
    sub, pidx = PV.subdivide(parent)
    occ = PV.occupancy_targets(parent, child, BITS).numpy()
    rng = np.random.default_rng(6)
    pts = rng.uniform(-20, 20, (2, 300, 3)).astype(np.float32)
    pmask = rng.random((2, 300)) < 0.9
    vgrid, vp2v, vg = PV.voxelize_points(T(pts), T(pmask), 0.5, CAP, bits=BITS)
    for b in range(2):
        jp = JV.VoxelGrid(*(jnp.asarray(a) for a in _grid_np(parent, b)))
        jc = JV.VoxelGrid(*(jnp.asarray(a) for a in _grid_np(child, b)))
        jsub, jpidx = JV.subdivide(jp, CAP, BITS)
        np.testing.assert_array_equal(sub[b].numpy(), np.asarray(jsub))
        np.testing.assert_array_equal(pidx.numpy(), np.asarray(jpidx))
        np.testing.assert_array_equal(occ[b], np.asarray(JV.occupancy_targets(jp, jc, BITS)))
        want = JV.voxelize_points(jnp.asarray(pts[b]), jnp.asarray(pmask[b]), 0.5, CAP,
                                  bits=BITS)
        for got, w in zip([*_grid_np(vgrid, b), vp2v[b].numpy(), vg[b].numpy()],
                          [*want[0], want[1], want[2]]):
            np.testing.assert_array_equal(got, np.asarray(w))


@pytest.mark.parametrize("cin,cout", [(6, 6), (6, 10)])
def test_sparse_conv_block_matches_jax(cin, cout):
    coords, mask = _clouds(7)
    grid, _ = PV.build_grid(T(coords), T(mask), CAP, BITS)
    feats = np.random.default_rng(8).standard_normal((2, CAP, cin)).astype(np.float32)
    jgrids = [JV.VoxelGrid(*(jnp.asarray(a) for a in _grid_np(grid, b))) for b in range(2)]
    jblock = JSparseConvBlock(cout, BITS)
    params = random_flax_params(jblock.init, 9, jax.random.key(0), jgrids[0],
                                jnp.asarray(feats[0]))
    block = SparseConvBlock(cin, cout, BITS)
    block.load_state_dict(dense_tree_state_dict(params), strict=True)
    with torch.no_grad():
        got = block(grid, T(feats)).numpy()
    for b in range(2):
        want = np.asarray(jblock.apply(params, jgrids[b], jnp.asarray(feats[b])))
        assert _rel_l2(got[b], want) <= 1e-5


@pytest.mark.parametrize("point_branch", [False, True])
def test_sparse_voxel_net_matches_jax(point_branch):
    cfg = dict(channels=(8, 16), out_channels=6, voxel_size=0.5, capacity=CAP, bits=BITS,
               point_branch=point_branch)
    rng = np.random.default_rng(10)
    pts = rng.uniform(-20, 20, (2, 300, 3)).astype(np.float32)  # 80 cells: past 2**6
    feats = np.concatenate([pts, -np.ones((2, 300, 1), np.float32)], -1)
    mask = rng.random((2, 300)) < 0.9
    jnet = JVN.SparseVoxelNet(JVN.VoxelNetConfig(**cfg))
    params = random_flax_params(jnet.init, 11, jax.random.key(0), jnp.asarray(pts[0]),
                                jnp.asarray(feats[0]), jnp.asarray(mask[0]))
    net = PVN.SparseVoxelNet(PVN.VoxelNetConfig(**cfg))
    net.load_state_dict(dense_tree_state_dict(params), strict=True)
    with torch.no_grad():
        got, gmask = net(T(pts), T(feats), T(mask))
    for b in range(2):
        want, wmask = jnet.apply(params, jnp.asarray(pts[b]), jnp.asarray(feats[b]),
                                 jnp.asarray(mask[b]))
        assert _rel_l2(got[b].numpy(), np.asarray(want)) <= 1e-5
        np.testing.assert_array_equal(gmask[b].numpy(), np.asarray(wmask))


def test_depth_sector_edges_and_descriptor_match_jax():
    lo, hi = 1.0 + 3.0, 56.0           # every geometry and YAML of the repository
    want = np.asarray(jnp.linspace(lo, hi, 17).at[0].set(0.0))
    np.testing.assert_array_equal(PVN.sector_edges((1.0, 56.0)), want)
    np.testing.assert_array_equal(PVN.sector_edges((1.0, 56.0)), np.asarray(
        jax.jit(lambda: jnp.linspace(lo, hi, 17).at[0].set(0.0))()))
    rng = np.random.default_rng(12)
    pts = rng.uniform(-60, 60, (2, 3000, 3)).astype(np.float32)
    logits = rng.standard_normal((2, 3000, 7)).astype(np.float32)
    mask = rng.random((2, 3000)) < 0.8
    got = PVN.depth_sector_descriptor(T(pts), T(logits), T(mask)).numpy()
    assert got.shape == (2, 16 * 7)
    for b in range(2):
        want_d = np.asarray(JVN.depth_sector_descriptor(
            jnp.asarray(pts[b]), jnp.asarray(logits[b]), jnp.asarray(mask[b])))
        np.testing.assert_allclose(got[b], want_d, rtol=1e-6, atol=1e-6)
    # an empty band reads 0
    far = PVN.depth_sector_descriptor(T(pts[:1] * 0.01), T(logits[:1]), T(mask[:1])).numpy()
    assert (far.reshape(16, 7)[1:] == 0).all()
