"""PyTorch port vs the JAX package: Sonata self-distillation pre-training.

At the config of JAX's ``tests/test_sonata.py`` (a two-level PT-v3, patch
16, heads of 16 hidden, 8 embed, 32 prototypes) on one cloud of 128 rows, 18 of them
padding: ``ball_mask`` from JAX's seeds (``jax.random.choice`` of the key's
first half, fed to the port) equal; ``OnlineCluster`` within 1e-6
relative L2; then three ``make_pretrain_step`` steps with Adam (optax's and
torch's, lr 3e-4) over the warm-up of the mask and temperature schedules,
JAX's seeds fed in: each loss within 1e-5 relative, the student's
gradients at the first step within 1e-4 relative L2 (JAX's read from
Adam's first moment), the center (the teacher's batch centers at their
momentum) within 1e-5 of its largest after each step, student and
teacher parameters at the end within 2 lr (Adam moves a weight by up to lr
a step; a near-zero gradient may flip its sign), the teacher moved and the
center live. The student's tree is drawn with numpy
(``random_flax_params``), the teacher's is it with 10% noise added, and
both cross through ``utils/convert.sonata_state_dict``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lidar_layout_tpu.models import ptv3 as JP3
from lidar_layout_tpu.models import sonata as JS
from lidar_layout_tpu_torch.models import ptv3 as PP3
from lidar_layout_tpu_torch.models import sonata as PS
from lidar_layout_tpu_torch.utils.convert import dense_tree_state_dict, sonata_state_dict
from torch_port_helpers import one_intra_op_thread, random_flax_params

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)

LOSS_TOL, GRAD_TOL, CENTER_TOL = 1e-5, 1e-4, 1e-5
LR, STEPS = 3e-4, 3
BB = dict(in_channels=4, patch_size=16, enc_depths=(1, 1), enc_channels=(8, 16),
          enc_heads=(2, 2), dec_depths=(1,), dec_channels=(8,), dec_heads=(2,),
          orders=("z", "hilbert"), grid_size=0.2)
CFG = dict(head_in_channels=8, head_hidden_channels=16, head_embed_channels=8,
           head_num_prototypes=32, total_steps=100)


def T(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _cloud(n=128, valid=110):
    rng = np.random.default_rng(0)
    coord = rng.uniform(0.0, 6.0, size=(n, 3)).astype(np.float32)
    feat = rng.normal(size=(n, 4)).astype(np.float32)
    return coord, feat, np.arange(n) < valid


def _seeds(key, n):
    """The seeds JAX's ``ball_mask`` draws inside ``Sonata.loss``."""
    r_mask, _ = jax.random.split(key)
    return np.asarray(jax.random.choice(r_mask, n, (32,), replace=False))


@pytest.fixture(scope="module")
def pair():
    jmodel = JS.Sonata(JP3.PTv3Config(**BB), JS.SonataConfig(**CFG))
    coord, feat, mask = _cloud()
    args = (jnp.asarray(coord), jnp.asarray(feat), jnp.asarray(mask))
    rng = np.random.default_rng(2)
    student = random_flax_params(jmodel.net.init, 1, jax.random.key(0), *args)
    teacher = jax.tree.map(lambda a: jnp.asarray(
        a + 0.1 * rng.standard_normal(a.shape) * np.std(np.asarray(a)), jnp.float32), student)
    state = {"student": student, "teacher": teacher,
             "center": jnp.asarray(np.random.default_rng(3).normal(0, 0.1, 32), jnp.float32)}
    port = PS.Sonata(PP3.PTv3Config(**BB), PS.SonataConfig(**CFG))
    port.load_state_dict(sonata_state_dict(jax.tree.map(np.asarray, state)))
    return jmodel, state, port, (coord, feat, mask), args


def test_ball_mask_and_online_cluster_match_jax(pair):
    _, _, port, (coord, _, mask), args = pair
    key = jax.random.key(4)
    seeds = np.asarray(jax.random.choice(key, len(coord), (32,), replace=False))
    want = np.asarray(JS.ball_mask(key, args[0], args[2], jnp.asarray(1.0), jnp.asarray(0.5)))
    got = PS.ball_mask(T(coord), T(mask), 1.0, 0.5, seed_idx=T(seeds)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < mask.sum() and not got[~mask].any()

    oc = JS.OnlineCluster(16, 8, 32)
    x = np.random.default_rng(5).normal(size=(10, 8)).astype(np.float32)
    x[3] = 0.0                                  # a zero row (padding) stays finite
    params = random_flax_params(oc.init, 6, jax.random.key(0), jnp.asarray(x))
    poc = PS.OnlineCluster(8, 16, 8, 32)
    poc.load_state_dict(dense_tree_state_dict(jax.tree.map(np.asarray, params)))
    want = np.asarray(oc.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = poc(T(x)).numpy()
    assert _rel(got, want) < 1e-6 and np.abs(got).max() <= 1.0 + 1e-5


def test_sonata_loss_gradients_and_pretrain_steps_match_jax(pair):
    """STEPS steps of each package's make_pretrain_step from the same state,
    JAX's seeds fed in: each loss (the schedules move over the warm-up), the
    student's gradients at the first step (JAX's read from Adam's first
    moment, 0.1 g), the center after each step (the teacher's batch center
    at its momentum), and the student and teacher at the end."""
    jmodel, state, port, (coord, feat, mask), args = pair
    tx = optax.adam(LR)
    opt = tx.init(state["student"])
    step_fn = jmodel.make_pretrain_step(tx)
    popt = torch.optim.Adam(port.student.parameters(), lr=LR, eps=1e-8)
    grads = {}
    real = popt.step

    def spy(*a, **k):
        if not grads:
            grads.update({n: p.grad.clone() for n, p in port.student.named_parameters()})
        return real(*a, **k)
    popt.step = spy
    pstep = port.make_pretrain_step(popt)
    teacher0 = {k: v.clone() for k, v in port.state_dict().items() if k.startswith("teacher.")}
    jstate = state
    for i in range(STEPS):
        key = jax.random.key(10 + i)
        jstate, opt, jloss = step_fn(jstate, opt, key, *args, jnp.asarray(i))
        loss = pstep(T(coord), T(feat), T(mask), i, seed_idx=T(_seeds(key, len(coord))))
        assert np.isfinite(float(loss))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL)
        center = np.asarray(jstate["center"])
        np.testing.assert_allclose(port.center.numpy(), center,
                                   atol=CENTER_TOL * np.abs(center).max(), rtol=0)
        if i == 0:
            ref = dense_tree_state_dict(jax.tree.map(lambda m: np.asarray(m) * 10.0,
                                                     opt[0].mu))
            assert sorted(grads) == sorted(ref)
            assert not any(p.grad is not None for p in port.teacher.parameters())
            names = sorted(ref)
            flat_w = np.concatenate([ref[k].numpy().ravel() for k in names])
            flat_g = np.concatenate([grads[k].numpy().ravel() for k in names])
            assert np.linalg.norm(flat_w) > 0 and _rel(flat_g, flat_w) < GRAD_TOL
    want = sonata_state_dict(jax.tree.map(np.asarray, jstate))
    got = port.state_dict()
    for k, v in want.items():
        if k != "center":
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=2 * LR, rtol=0, err_msg=k)
    moved = max(float((got[k] - teacher0[k]).abs().max()) for k in teacher0)
    assert moved > 0 and float(port.center.abs().max()) > 0
