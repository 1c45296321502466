"""PyTorch port, kernel K4's candidate selection, emulated on the CPU.

K4 (``csrc/chamfer_nn.cu``) finds candidate y with TF32 tensor-core products
of the expanded distance and re-checks every y within its error bound in the
direct form. ``ops/chamfer._nn_dist_emulated`` repeats both stages in plain
PyTorch with the kernel's TF32 operands (low 13 mantissa bits cleared) and
the kernel's bound. Here it is held, on clouds built to trip a selection,
to the direct form's minimum over every y (bit for bit: the selection never
misses) and to float64 within 1e-6 (1 + d). The card runs the kernel itself
on the same clouds at full size (``chip_smoke.py``, phase ``kernels``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_layout_tpu.ops import chamfer as JC
from lidar_layout_tpu_torch.ops import chamfer as C
from torch_port_helpers import CHAMFER_CLOUDS, chamfer_cloud

EPS32 = float(np.finfo(np.float32).eps)
SIZES = {"near ties": 150, "duplicated y": 150, "x equal to some y": 250, "1 cm grid": 300,
         "offset by 500 m": 1500, "scene pair": 1500}


def _cloud(name, seed=0):
    # at the CPU's size: a few hundred to 1800 points a side
    return tuple(torch.from_numpy(a) for a in chamfer_cloud(name, SIZES[name], seed))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(CHAMFER_CLOUDS))
def test_emulated_selection_is_exact(name, masked):
    x, y = _cloud(name)
    mask = None
    if masked:
        mask = torch.from_numpy(np.random.default_rng(5).random(len(y)) < 0.7)
    got, rechecked = C._nn_dist_emulated(x, y, mask, chunk=128)
    direct = C._direct(x[:, None, :], y[None, :, :])
    if mask is not None:
        direct = torch.where(mask[None, :], direct, float("inf"))
    # the direct form's minimum over every y, bit for bit
    assert torch.equal(got, direct.amin(dim=1))
    d64 = C._nn_dist_ref(x.double(), y.double(), mask)
    assert bool(((got.double() - d64).abs() <= 1e-6 * (1 + d64)).all())
    assert bool((got >= 0).all()) and bool((rechecked >= 1).all())
    if name == "x equal to some y" and not masked:
        assert bool((got == 0).all())


@pytest.mark.parametrize("name", sorted(CHAMFER_CLOUDS))
def test_candidate_values_within_the_bound(name):
    # rounding x' and y' to TF32 (up to 2^-10 of each coordinate) and the f32
    # roundings of |yh|^2 stay inside K4's bound e(r) without its margin of
    # 1.1; the sum here is in f64, the tensor cores' takes the rest
    x, y = _cloud(name, seed=1)
    c = C._centre(y, None)
    xp, yp = x - c, y - c
    v = C._candidate_values(xp, yp).double()
    xh2 = (C._tf32(xp).double() ** 2).sum(1, keepdim=True)
    exact = ((xp.double()[:, None, :] - yp.double()[None, :, :]) ** 2).sum(-1)
    e = C.candidate_bound(exact.sqrt(), xp.double().norm(dim=1, keepdim=True))
    assert bool(((v + xh2 - exact).abs() <= e / 1.1).all())


def test_all_masked_and_ragged():
    x, y = _cloud("scene pair", seed=2)
    none = torch.zeros(len(y), dtype=torch.bool)
    got, rechecked = C._nn_dist_emulated(x, y, none)
    assert bool((got == C.BIG).all()) and int(rechecked.sum()) == 0
    got, _ = C._nn_dist_emulated(x[:13], y[:77])
    assert torch.equal(got, C._direct(x[:13, None], y[None, :77]).amin(dim=1))


def test_emulation_matches_jax_xla_path():
    # JAX's nn_dist_one_way forms |x|^2 + |y|^2 - 2 x.y in f32: each value
    # may be off by a few eps32 (|x|^2 + |y|^2) from the true distance
    x, y = _cloud("scene pair", seed=3)
    want = np.asarray(JC.nn_dist_one_way(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
                                         chunk=500)).astype(np.float64)
    got = C._nn_dist_emulated(x, y)[0].numpy().astype(np.float64)
    bound = 8 * EPS32 * ((x.double() ** 2).sum(1) + (y.double() ** 2).sum(1).max()).numpy()
    assert np.all(np.abs(got - want) <= bound + 1e-6 * np.abs(want))
