"""PyTorch port vs the JAX package: the latent-diffusion training slice.

Same numpy inputs, made from a seed, go through the JAX function and its port
on the CPU in float32: the attention backward (the JAX vjp and the Pallas
backward kernel in interpret mode), the GroupNorm(+SiLU) backward, the
diffusion schedule maths, the U-Net loss and its gradients, the optimizer
chain (AdamW, clipping, accumulation) fed the same gradients, the EMA, the lr
schedules and the scan projection. Then the port's own loop: a Trainer run
with a checkpoint round trip, and the CLI on the tiny flagship config.
"""
import dataclasses
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _flagship as jax_flagship
from lidar_layout_tpu.data import synthetic as JSYN
from lidar_layout_tpu.models import schedules as JSCH
from lidar_layout_tpu.models.diffusion import calibrate_scale_factor as jax_calibrate
from lidar_layout_tpu.models.unet import UNetConfig as JUNetConfig
from lidar_layout_tpu.models.unet import UNetModel as JUNetModel
from lidar_layout_tpu.nn.ema import init_ema, update_ema
from lidar_layout_tpu.ops import lidar as JL
from lidar_layout_tpu.ops.pallas_attention import _attend_ref as jax_attend_ref
from lidar_layout_tpu.ops.pallas_attention import _flash_bwd_tpu
from lidar_layout_tpu.ops import pallas_groupnorm as JGN
from lidar_layout_tpu.ops.pallas_groupnorm import _fused_vjp_bwd
from lidar_layout_tpu.train import lr_schedule as JLR
from lidar_layout_tpu.train.diffusion_trainer import make_optimizer as jax_make_optimizer
from lidar_layout_tpu.utils.torch_convert import convert_unet
from lidar_layout_tpu_torch import config as PC
from lidar_layout_tpu_torch.data import synthetic as PSYN
from lidar_layout_tpu_torch.flagship import flagship
from lidar_layout_tpu_torch.models import schedules as PSCH
from lidar_layout_tpu_torch.models.diffusion import apply_scale_by_std, calibrate_scale_factor
from lidar_layout_tpu_torch.models.unet import UNetConfig, UNetModel
from lidar_layout_tpu_torch.nn.ema import Ema
from lidar_layout_tpu_torch.ops import attention as A
from lidar_layout_tpu_torch.ops import groupnorm as G
from lidar_layout_tpu_torch.ops import lidar as PL
from lidar_layout_tpu_torch.train import checkpoint as CK
from lidar_layout_tpu_torch.train import diffusion_trainer as DT
from lidar_layout_tpu_torch.train import lr_schedule as PLR
from lidar_layout_tpu_torch.train import trainer as TR
from lidar_layout_tpu_torch.train.train_lidm import main as train_main
from torch_port_helpers import (jax_ldm_params, jax_unet_params, nchw, nhwc, one_intra_op_thread,
                                seed_weights)

ROOT = pathlib.Path(__file__).resolve().parent.parent
_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
TINY_UNET = dict(in_channels=8, model_channels=32, out_channels=8, num_res_blocks=1,
                 attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=8)
TINY_GEOM = PL.LidarGeometry(size=(16, 128))


def _np(*shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _kbias(b, s, seed):
    m = np.random.default_rng(seed).random((b, s)) > 0.3
    m[:, 0] = True
    return np.where(m, 0.0, -1e9).astype(np.float32)


# ------------------------------------------------------------- attention bwd
@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_backward_matches_jax_vjp_and_pallas_interpret(with_bias):
    b, h, s, d = 2, 2, 128, 16
    q, k, v, g = (_np(b, h, s, d, seed=i) for i in range(4))
    kb = _kbias(b, s, 5) if with_bias else None
    jkb = None if kb is None else jnp.asarray(kb)
    o, vjp = jax.vjp(lambda a, b_, c: jax_attend_ref(a, b_, c, jkb),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    interp = _flash_bwd_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o,
                            jnp.asarray(g), kbias=jkb, interpret=True)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tkb = None if kb is None else torch.from_numpy(kb)
    lse = A._lse_ref(tq, tk, tkb)
    got = A._attend_bwd_ref(tq, tk, tv, A._attend_ref(tq, tk, tv, tkb), tg, lse, tkb)
    # through the autograd Function the CPU takes: the same wiring as on the card
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = A.flash_attention(*leaves, tkb)
    fn_grads = torch.autograd.grad(out, leaves, tg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(o), atol=1e-5, rtol=1e-5)
    for mine, fn, ref, pallas in zip(got, fn_grads, want, interp):
        # f32 on one CPU: P from the log-sum-exp instead of a softmax, and
        # other summation orders; the Pallas kernel also pre-scales q
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(mine.numpy(), np.asarray(pallas), atol=2e-4, rtol=2e-4)
        np.testing.assert_array_equal(fn.numpy(), mine.numpy())


def test_attention_backward_rounds_p_and_ds_in_bf16():
    # bf16 inputs: P and dS are rounded to bf16 before their products, as the
    # TPU kernel does; results come back in bf16
    q, k, v, g = (torch.from_numpy(_np(1, 2, 64, 16, seed=10 + i)).bfloat16()
                  for i in range(4))
    o, lse = A._attend_ref(q, k, v), A._lse_ref(q, k)
    dq, dk, dv = A._attend_bwd_ref(q, k, v, o, g, lse)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    p = torch.exp(A._logits_ref(q, k, None) - lse[..., None]).transpose(-1, -2)
    rounded = torch.matmul(p.bfloat16().float(), g.float()).bfloat16()
    unrounded = torch.matmul(p, g.float()).bfloat16()
    assert torch.equal(dv, rounded) and not torch.equal(dv, unrounded)


# ------------------------------------------------------------ group norm bwd
@pytest.mark.parametrize("act", [False, True])
def test_group_norm_backward_matches_jax_fused_vjp(act):
    x = _np(2, 6, 5, 64, seed=20, scale=2.0) + 0.3           # NHWC
    gamma, beta = 1 + _np(64, seed=21, scale=0.1), _np(64, seed=22, scale=0.1)
    dy = _np(2, 6, 5, 64, seed=23)
    want = _fused_vjp_bwd(16, 1e-6, act, (jnp.asarray(x), jnp.asarray(gamma),
                                          jnp.asarray(beta)), jnp.asarray(dy))
    got = G._group_norm_bwd_ref(nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta),
                                nchw(dy), 16, 1e-6, act)
    leaves = [nchw(x).requires_grad_(), torch.from_numpy(gamma).requires_grad_(),
              torch.from_numpy(beta).requires_grad_()]
    fn = torch.autograd.grad(G.group_norm(*leaves, 16, 1e-6, act), leaves, nchw(dy))
    # f32, reductions over 120 values in other orders
    np.testing.assert_allclose(nhwc(got[0]), np.asarray(want[0]), atol=1e-5, rtol=1e-5)
    for i in (1, 2):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), atol=1e-4, rtol=1e-5)
    for a, b in zip(fn, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("shape,groups,act", [((2, 6, 5, 64), 16, False),
                                              ((1, 4, 8, 96), 32, True)])
def test_group_norm_bwd_wrapper_matches_jax_vjp_through_fused(monkeypatch, shape, groups, act):
    # jax.vjp through the JAX custom_vjp `_fused`: its forward is the Pallas
    # kernel, run here in interpret mode, its backward `_fused_vjp_bwd`
    real_fwd = JGN._fused_fwd
    monkeypatch.setattr(JGN, "_fused_fwd", lambda *a: real_fwd(*a, interpret=True))
    c = shape[-1]
    x = _np(*shape, seed=24, scale=2.0) + 0.3           # NHWC
    gamma, beta = 1 + _np(c, seed=25, scale=0.1), _np(c, seed=26, scale=0.1)
    dy = _np(*shape, seed=27)
    y, vjp = jax.vjp(lambda a, g, b: JGN._fused(a, g, b, groups, 1e-6, act),
                     jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    want = vjp(jnp.asarray(dy))
    launches = G.group_norm_bwd.launches
    got = G.group_norm_bwd(nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta), nchw(dy),
                           groups, 1e-6, act)
    assert G.group_norm_bwd.launches == launches     # CPU tensors: the plain version
    assert got[0].dtype == torch.float32 and got[0].shape == nchw(x).shape
    # f32, reductions over up to 768 values in other orders
    np.testing.assert_allclose(nhwc(got[0]), np.asarray(want[0]), atol=1e-5, rtol=1e-5)
    for i in (1, 2):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), atol=1e-4, rtol=1e-5)


# -------------------------------------------------------------- schedules
def test_q_sample_posterior_and_start_from_noise_match_jax():
    js = JSCH.DiffusionSchedule.create(1024, linear_start=0.0015, linear_end=0.0195)
    ps = PSCH.DiffusionSchedule.create(1024, linear_start=0.0015, linear_end=0.0195)
    x0, xt, eps = (_np(3, 4, 16, 8, seed=30 + i) for i in range(3))
    t = np.array([0, 511, 1023])
    jt, tt = jnp.asarray(t), torch.from_numpy(t)
    pairs = [(JSCH.q_sample(js, x0, jt, eps), PSCH.q_sample(ps, torch.from_numpy(x0), tt,
                                                             torch.from_numpy(eps))),
             (JSCH.predict_start_from_noise(js, xt, jt, eps),
              PSCH.predict_start_from_noise(ps, torch.from_numpy(xt), tt, torch.from_numpy(eps)))]
    pairs += list(zip(JSCH.q_posterior(js, x0, xt, jt),
                      PSCH.q_posterior(ps, torch.from_numpy(x0), torch.from_numpy(xt), tt)))
    for want, got in pairs:
        # the same f32 coefficient tables and one multiply-add
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


# ------------------------------------------------- U-Net loss and gradients
def _grad_tree(unet, cfg):
    return convert_unet({n: p.grad.numpy() for n, p in unet.named_parameters()},
                        cfg.num_res_blocks, cfg.channel_mult, cfg.num_head_channels,
                        prefix="")


def test_unet_loss_and_gradients_match_jax_value_and_grad():
    port, _ = flagship(tiny=True, device="cpu")
    seed_weights(port, 31)
    jmodel, _ = jax_flagship(tiny=True)
    params = jax_ldm_params(port)
    x0, noise = _np(2, 4, 16, 8, seed=32), _np(2, 4, 16, 8, seed=33)
    t = np.array([7, 50])
    x_noisy = np.asarray(JSCH.q_sample(jmodel.schedule, x0, jnp.asarray(t), noise))

    def mse(unet_params):
        out = jmodel.apply_model({**params, "unet": unet_params}, jnp.asarray(x_noisy),
                                 jnp.asarray(t))
        return jnp.mean((out - noise) ** 2)

    want_loss, want_grads = jax.jit(jax.value_and_grad(mse))(params["unet"])
    port.train()
    loss, logs = port.p_losses(torch.from_numpy(x0), torch.from_numpy(t),
                               torch.from_numpy(noise))
    loss.backward()
    # logvar 0 and no ELBO term: the loss is the MSE; f32, other sum orders
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert float(logs["loss_simple"]) == pytest.approx(float(loss), rel=1e-6)
    got = _grad_tree(port.unet, port.unet.cfg)
    flat_w = jax.tree_util.tree_leaves_with_path(want_grads)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_w) == len(flat_g) > 20
    gmax = max(float(np.abs(np.asarray(w)).max()) for _, w in flat_w)
    assert gmax > 1e-3
    for path, w in flat_w:
        # a dozen layers forward and back in f32, summed in other orders
        np.testing.assert_allclose(flat_g[path], np.asarray(w), atol=1e-5 * gmax, rtol=1e-3,
                                   err_msg=jax.tree_util.keystr(path))
    assert port.first_stage_model.encoder.conv_in.weight.grad is None


def test_scale_by_std_matches_jax():
    port, _ = flagship(tiny=True, device="cpu")
    seed_weights(port, 34)
    img = np.random.default_rng(35).uniform(-1, 1, (2, 16, 128, 1)).astype(np.float32)
    z = port.encode_first_stage(torch.from_numpy(img))
    assert calibrate_scale_factor(z) == pytest.approx(jax_calibrate(jnp.asarray(z.numpy())),
                                                      rel=1e-6)
    port.cfg = dataclasses.replace(port.cfg, scale_by_std=True)
    s = apply_scale_by_std(port, torch.from_numpy(img))
    assert port.cfg.scale_factor == s == pytest.approx(calibrate_scale_factor(z))
    assert apply_scale_by_std(port, torch.from_numpy(img)) == s     # only once


# ---------------------------------------------------------------- dropout
def test_resblock_dropout_trains_and_matches_jax_in_eval():
    cfg = UNetConfig(**TINY_UNET, dropout=0.5)
    unet = seed_weights(UNetModel(cfg), 36)
    assert set(unet.state_dict()) == set(UNetModel(UNetConfig(**TINY_UNET)).state_dict())
    assert isinstance(unet.input_blocks[1][0].out_layers[2], torch.nn.Dropout)
    x = _np(2, 4, 16, 8, seed=37)
    t = np.array([3, 40])
    with torch.no_grad():
        unet.train()
        a, b = (unet(nchw(x), torch.from_numpy(t)) for _ in range(2))
        unet.eval()
        got = unet(nchw(x), torch.from_numpy(t))
    assert float((a - b).abs().max()) > 1e-3       # train mode drops
    want = JUNetModel(JUNetConfig(**TINY_UNET, dropout=0.5)).apply(
        jax_unet_params(unet, cfg), jnp.asarray(x), jnp.asarray(t), deterministic=True)
    # as the U-Net parity test: f32 in other summation orders
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------- optimizer
def _opt_pair(seed, **kw):
    rng = np.random.default_rng(seed)
    p0 = {"a": rng.standard_normal((5, 7)).astype(np.float32),
          "b": rng.standard_normal(11).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 3).astype(np.float32) for k, v in p0.items()}
             for _ in range(4)]
    return p0, grads


@pytest.mark.parametrize("clip,accumulate", [(None, 1), (0.5, 1), (None, 2), (1.0, 2)])
def test_optimizer_matches_optax_chain_on_the_same_gradients(clip, accumulate):
    p0, grads = _opt_pair(40, clip=clip)
    lr = 1e-3
    tx = jax_make_optimizer(lr, grad_clip=clip, accumulate=accumulate)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = DT.make_optimizer(tp, lr, grad_clip=clip, accumulate=accumulate)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        norm = opt.step([torch.from_numpy(g[k]) for k in tp])
        assert float(norm) == pytest.approx(float(optax.global_norm(g)), rel=1e-6)
        for k in tp:
            # the same f32 update; AdamW's 1/sqrt(v) and the running mean of
            # MultiSteps round differently by an ulp or two
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       atol=1e-7, rtol=1e-6)
    assert not np.allclose(tp["a"].detach().numpy(), p0["a"])


def test_lr_schedules_match_jax():
    args = dict(warm_up_steps=10, lr_min=0.1, lr_max=1.0, lr_start=1e-3, max_decay_steps=50)
    mine, ref = PLR.lambda_warmup_cosine(**args), JLR.lambda_warmup_cosine(**args)
    ref_optax = JLR.lambda_warmup_cosine_optax(2.0, **args)
    lin = dict(warm_up_steps=5, f_min=0.2, f_max=1.0, f_start=0.01, cycle_lengths=30)
    for step in (0, 1, 5, 9, 10, 11, 30, 49, 50, 80):
        assert mine(step) == pytest.approx(float(ref(step)), rel=1e-12, abs=1e-12)
        assert 2.0 * mine(step) == pytest.approx(float(ref_optax(step)), rel=1e-6)
        assert PLR.lambda_linear(**lin)(step) == pytest.approx(JLR.lambda_linear(**lin)(step))
    assert PLR.scale_lr(1e-6, 16, 1, 2) == JLR.scale_lr(1e-6, 16, 1, 2)
    # as a LambdaLR the multiplier follows the number of updates, like optax
    p = torch.nn.Parameter(torch.zeros(3))
    opt = DT.make_optimizer({"p": p}, 2.0, lr_lambda=mine)
    for step in range(12):
        assert opt.adamw.param_groups[0]["lr"] == pytest.approx(float(ref_optax(step)), rel=1e-6)
        opt.step([torch.ones(3)])


def test_ema_update_matches_jax():
    rng = np.random.default_rng(41)
    p0 = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
    jema = init_ema({k: jnp.asarray(v) for k, v in p0.items()})
    ema = Ema({k: torch.from_numpy(v) for k, v in p0.items()})
    for i in range(5):
        new = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
        decay = 0.9999 if i < 3 else 0.5       # the warm-up, then the cap
        jema = update_ema(jema, {k: jnp.asarray(v) for k, v in new.items()}, decay)
        ema.update({k: torch.from_numpy(v) for k, v in new.items()}, decay)
        # one f32 multiply-add per element
        np.testing.assert_allclose(ema.params["w"].numpy(), np.asarray(jema.params["w"]),
                                   atol=1e-7, rtol=1e-6)
    assert ema.step == int(jema.step) == 5 and ema.params["w"].dtype == torch.float32


# ------------------------------------------------------------- scan projection
def test_pcd2range_and_process_scan_match_jax():
    rng = np.random.default_rng(42)
    pts = (rng.standard_normal((2, 3000, 3)) * [20, 20, 2]).astype(np.float32)
    mask = rng.random((2, 3000)) > 0.1
    feat = rng.integers(0, 5, (2, 3000)).astype(np.float32)
    geom = JL.LidarGeometry(size=(16, 128))
    img, fimg = PL.pcd2range(torch.from_numpy(pts), TINY_GEOM, mask=torch.from_numpy(mask),
                             features=torch.from_numpy(feat))
    for i in range(2):
        want, wantf = JL.pcd2range(jnp.asarray(pts[i]), geom, mask=jnp.asarray(mask[i]),
                                   features=jnp.asarray(feat[i]))
        # the same f32 projection: a point on a pixel border may floor
        # either way, so almost every pixel is bit-equal
        assert (img[i].numpy() == np.asarray(want)).mean() >= 0.999
        assert (fimg[i].numpy() == np.asarray(wantf)).mean() >= 0.999
        m, d = PL.process_scan(img[i], TINY_GEOM)
        jm, jd = JL.process_scan(want, geom)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-5)
        assert (d.numpy() == np.asarray(jd)).mean() >= 0.999
    c2 = PL.pcd2coord2d(torch.from_numpy(pts[0]), TINY_GEOM)
    np.testing.assert_allclose(c2.numpy(), np.asarray(JL.pcd2coord2d(jnp.asarray(pts[0]), geom)),
                               atol=1e-6)


def test_synthetic_range_batch_matches_jax():
    geom = JL.LidarGeometry(size=(16, 128))
    want = JSYN.synthetic_range_batch(np.random.default_rng(43), 2, geom, with_pcd=True)
    got = PSYN.synthetic_range_batch(np.random.default_rng(43), 2, TINY_GEOM, with_pcd=True)
    np.testing.assert_array_equal(got["points"], want["points"])   # same numpy draws
    assert got["image"].shape == want["image"].shape == (2, 16, 128, 1)
    # the depth images are bit-equal on almost every pixel (a point on a
    # pixel border may floor either way); the log-scaling then differs by
    # an f32 ulp where XLA fuses it
    img, _ = PL.pcd2range(torch.from_numpy(got["points"]), TINY_GEOM)
    want_img = np.stack([np.asarray(JL.pcd2range(jnp.asarray(p), geom)[0])
                         for p in want["points"]])
    assert (img.numpy() == want_img).mean() >= 0.999
    np.testing.assert_allclose(got["image"].numpy(), want["image"], atol=1e-6)
    assert (got["mask"].numpy() == want["mask"]).mean() >= 0.999
    assert (want["mask"] > 0).mean() > 0.2


# ------------------------------------------------------------ the port's loop
def _tiny_state(seed=44, lr=1e-3):
    model, _ = flagship(tiny=True, device="cpu")
    seed_weights(model, seed)
    params = DT.trainable_params(model)
    return DT.create_train_state(model, DT.make_optimizer(params, lr, grad_clip=1.0), params)


def test_trainer_runs_and_checkpoints_round_trip(tmp_path):
    batches = [PSYN.synthetic_range_batch(np.random.default_rng(45 + i), 2, TINY_GEOM)
               for i in range(4)]
    state = _tiny_state()
    step = DT.make_train_step(state.model)
    val = DT.make_val_step(state.model)
    hooks = [TR.IterationTimer(), TR.ValidationHook(val, lambda: iter(batches[:1]), 2),
             TR.InformationWriter(log_every=1), TR.CheckpointSaver(every_steps=2, max_to_keep=1),
             TR.BestCheckpointSaver(monitor="val/loss_simple_ema", top_k=1)]
    tr = TR.Trainer(step, state, iter(batches[:3]), workdir=str(tmp_path), max_steps=3,
                    hooks=hooks, seed=1)
    tr.train()
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2, 3]
    assert "val/loss_simple_ema" in lines[1] and np.isfinite(lines[-1]["loss"])
    assert CK.latest_step(str(tmp_path / "ckpt")) == 3
    assert os.listdir(tmp_path / "ckpt") == ["step_00000003.pt"]     # max_to_keep=1
    assert len(os.listdir(tmp_path / "ckpt_best")) == 1
    assert state.step == 3 and state.ema.step == 3
    sd = DT.ema_params(state.model, state)
    assert sd.keys() == state.model.state_dict().keys()
    assert all(torch.equal(sd[k], v) for k, v in state.ema.params.items())

    fresh = _tiny_state(seed=99)
    CK.restore_checkpoint(str(tmp_path / "ckpt"), fresh)
    assert fresh.step == 3 and fresh.ema.step == 3
    for k, p in state.params.items():
        assert torch.equal(p, fresh.params[k]) and torch.equal(state.ema.params[k],
                                                               fresh.ema.params[k])
    # both continue identically from the restored state
    outs = []
    for st in (state, fresh):
        st, logs = DT.make_train_step(st.model)(st, batches[3],
                                                torch.Generator().manual_seed(7))
        outs.append((float(logs["loss"]), st.params["model.diffusion_model.out.2.weight"]))
    assert outs[0][0] == outs[1][0] and torch.equal(outs[0][1], outs[1][1])


def test_train_step_with_accumulation_updates_every_kth_step():
    state = _tiny_state()
    state.optimizer.accumulate = 2
    step = DT.make_train_step(state.model)
    batch = PSYN.synthetic_range_batch(np.random.default_rng(46), 2, TINY_GEOM)
    w0 = state.params["model.diffusion_model.out.2.weight"].detach().clone()
    gen = torch.Generator().manual_seed(0)
    state, logs = step(state, batch, gen)
    assert torch.equal(state.params["model.diffusion_model.out.2.weight"], w0)
    assert float(logs["grad_norm"]) > 0
    state, _ = step(state, batch, gen)
    assert not torch.equal(state.params["model.diffusion_model.out.2.weight"], w0)


def test_cli_trains_the_tiny_config_on_the_cpu(tmp_path):
    import yaml

    cfg = PC.load_yaml(str(ROOT / "configs/lidar_diffusion/kitti/uncond_c2_p4.yaml"))
    p = cfg["model"]["params"]
    p.update(timesteps=64, image_size=[4, 16])
    p["unet_config"]["params"].update(model_channels=32, num_res_blocks=1,
                                      attention_resolutions=[2], channel_mult=[1, 2],
                                      num_head_channels=8)
    p["first_stage_config"]["params"]["n_embed"] = 256
    p["first_stage_config"]["params"]["ddconfig"].update(ch=16, num_res_blocks=1)
    cfg["data"]["params"]["dataset"]["size"] = [16, 128]
    base = tmp_path / "tiny.yaml"
    base.write_text(yaml.safe_dump(cfg))
    work = tmp_path / "run"
    trainer = train_main(["-b", str(base), "--cpu", "--synthetic", "--steps", "2",
                          "--workdir", str(work), "-s", "3", "data.params.batch_size=2",
                          "data.params.num_val_batches=1"])
    assert trainer.global_step == 2
    assert CK.latest_step(str(work / "ckpt")) == 2
    assert (work / "config.yaml").exists() and (work / "metrics.jsonl").exists()
    resumed = train_main(["-b", str(base), "--cpu", "--synthetic", "--steps", "3",
                          "--workdir", str(tmp_path / "run2"), "-r", str(work),
                          "data.params.batch_size=2", "data.params.num_val_batches=1"])
    assert resumed.global_step == 3
    with pytest.raises(NotImplementedError, match="train_dense_decoder"):
        bad = dict(cfg, model=dict(cfg["model"], target="dense_decoder"))
        (tmp_path / "ae.yaml").write_text(yaml.safe_dump(bad))
        train_main(["-b", str(tmp_path / "ae.yaml"), "--cpu", "--synthetic", "--steps", "1",
                    "--workdir", str(tmp_path / "ae")])
