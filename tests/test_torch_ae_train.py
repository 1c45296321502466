"""PyTorch port vs the JAX package: training the range VQ autoencoder.

The same numpy inputs go through the JAX functions (NHWC) and the port's
(NCHW) on the CPU in float32: the quantizer's loss and gradients, the
geometric losses, ``reconstruction_nll``'s parts, ``assemble_disc_input``,
both discriminators and d-losses, and one whole VQ-GAN step on the shape of
JAX's own ``test_ae_adversarial_step`` (``ch`` 16, ``ch_mult`` (1, 2), 16x64
images with the mask head and the geometric term) at steps 0 and 2, on both
sides of the GAN gate. Parameter trees have the structure of the JAX
``init`` and values drawn with numpy (``random_flax_params``), carried to the
port by ``utils/convert.ae_train_state_dicts``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_layout_tpu.losses import discriminator as JD
from lidar_layout_tpu.losses import geometric as JG
from lidar_layout_tpu.losses import vq_loss as JV
from lidar_layout_tpu.models import autoencoder as JAE
from lidar_layout_tpu.nn import quantize as JQ
from lidar_layout_tpu.ops.lidar import LidarGeometry as JGeom
from lidar_layout_tpu.train import ae_trainer as JT
from lidar_layout_tpu_torch.losses import discriminator as PD
from lidar_layout_tpu_torch.losses import geometric as PG
from lidar_layout_tpu_torch.losses import vq_loss as PV
from lidar_layout_tpu_torch.models import autoencoder as PAE
from lidar_layout_tpu_torch.nn import quantize as PQ
from lidar_layout_tpu_torch.ops.lidar import LidarGeometry as PGeom
from lidar_layout_tpu_torch.train import ae_trainer as PT
from lidar_layout_tpu_torch.utils.convert import (ae_train_state_dicts,
                                                  discriminator_state_dict, vq_state_dict)
from torch_port_helpers import nchw, nhwc, one_intra_op_thread, random_flax_params

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
SIZE = (16, 64)
JGEO, PGEO = JGeom(size=SIZE), PGeom(size=SIZE)
# JAX's test_ae_adversarial_step shape: mask head, geometric term, curve 1
AE_KW = dict(ch=16, ch_mult=(1, 2), strides=((1, 2),), z_channels=4, out_ch=2,
             num_res_blocks=1)
N_EMBED, EMBED_DIM, LR = 64, 4, 1e-3
LOSS_KW = dict(mask_factor=1.0, geo_factor=1.0, disc_start=1, curve_length=1)


def _rel(got, want):
    """Relative L2 error of two arrays (0 when both are 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / den if den else np.linalg.norm(got)


def _images(seed, b=2, c=1):
    """Model-space range images in runs of 8 equal pixels along the scan
    line (so the smoothness mask keeps pixels), with no-return pixels."""
    rng = np.random.default_rng(seed)
    img = np.repeat(rng.uniform(-0.6, 0.8, (b, SIZE[0], SIZE[1] // 8, c)), 8, axis=2)
    img[rng.random(img.shape) < 0.1] = -1.0
    return img.astype(np.float32)


# ------------------------------------------------------------------ quantizer
def test_quantizer_loss_and_gradients_match_jax():
    """The codebook loss, the gradient reaching z through a downstream sum,
    and the codebook's gradient, equal to JAX's stop-gradient form within
    1e-6 relative (f32; sums in other orders). The straight-through value
    sends the downstream gradient to z alone; the commitment term trains z
    and the embedding term the codebook."""
    rng = np.random.default_rng(0)
    z = rng.standard_normal((2, 8, 16, EMBED_DIM)).astype(np.float32)        # NHWC
    cb = rng.standard_normal((N_EMBED, EMBED_DIM)).astype(np.float32)
    r = rng.standard_normal(z.shape).astype(np.float32)
    jq = JQ.VectorQuantizer(N_EMBED, EMBED_DIM)

    def jloss(zz, c):
        zq, loss, _ = jq.apply({"params": {"embedding": c}}, zz)
        return jnp.sum(zq * r) + loss, loss
    (_, want_loss), (want_dz, want_dcb) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        jnp.asarray(z), jnp.asarray(cb))

    pq = PQ.VectorQuantizer(N_EMBED, EMBED_DIM)
    with torch.no_grad():
        pq.embedding.weight.copy_(torch.from_numpy(cb))
    zt = nchw(z).requires_grad_()
    zq, loss, idx = pq(zt)
    (torch.sum(zq * nchw(r)) + loss).backward()
    loss = loss.detach()
    assert abs(float(loss) - float(want_loss)) <= 1e-6 * float(want_loss)
    assert _rel(nhwc(zt.grad), want_dz) <= 1e-6
    assert _rel(pq.embedding.weight.grad.numpy(), want_dcb) <= 1e-6
    # the straight-through gradient is r plus the commitment term's alone
    assert _rel(nhwc(zt.grad) - r, np.asarray(want_dz) - r) <= 1e-6
    assert np.abs(nhwc(zt.grad) - r).max() > 0
    # the forward value is z + (z_q - z): the code's row to rounding
    np.testing.assert_allclose(pq.embed_code(idx).permute(0, 3, 1, 2).detach().numpy(),
                               zq.detach().numpy(), rtol=0, atol=1e-6)

    # perplexity and codes used, on the indices JAX picks
    want_idx = jq.apply({"params": {"embedding": jnp.asarray(cb)}}, jnp.asarray(z))[2]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    got = PQ.perplexity(idx, N_EMBED)
    want = JQ.perplexity(want_idx, N_EMBED)
    assert abs(float(got[0]) - float(want[0])) <= 1e-5 * float(want[0])
    assert int(got[1]) == int(want[1])


def test_codebook_starts_uniform_in_one_over_n():
    """JAX's default codebook init ("taming"): uniform in +-1/n_embed."""
    w = PQ.VectorQuantizer(N_EMBED, EMBED_DIM).embedding.weight.detach()
    assert float(w.abs().max()) <= 1.0 / N_EMBED
    assert float(w.std()) > 0.4 / N_EMBED        # uniform's std is 0.577/n


# ------------------------------------------------------------------- geometry
@pytest.mark.parametrize("curve_length", [1, 4])
def test_geometric_converter_and_losses_match_jax(curve_length):
    """GeoConverter's xyz, normals, compression and depth, and the squared
    distance, smoothness and normal-consistency losses, within 1e-5
    relative (f32 transcendentals and sums in other orders)."""
    jgeo, pgeo = JG.GeoConverter(JGEO, curve_length), PG.GeoConverter(PGEO, curve_length)
    gt = _images(1)
    pred = np.clip(gt + 0.02 * np.random.default_rng(2).standard_normal(gt.shape),
                   -1, 1).astype(np.float32)
    pairs = [(jgeo(jnp.asarray(gt)), pgeo(nchw(gt))),
             (jgeo.range2xyz(jnp.asarray(gt) * 0.5 + 0.5), pgeo.range2xyz(nchw(gt) * 0.5 + 0.5)),
             (jgeo.depth_from_model(jnp.asarray(gt)), pgeo.depth_from_model(nchw(gt)))]
    for want, got in pairs:
        assert got.shape == tuple(np.transpose(np.asarray(want), (0, 3, 1, 2)).shape)
        np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    jc_in, jc_rec = jgeo(jnp.asarray(gt)), jgeo(jnp.asarray(pred))
    pc_in, pc_rec = pgeo(nchw(gt)), pgeo(nchw(pred))
    np.testing.assert_allclose(nhwc(pgeo.range2normal(pc_in)),
                               np.asarray(jgeo.range2normal(jc_in)), rtol=1e-4, atol=1e-5)
    losses = [
        (JG.square_dist_loss(jc_in[..., :2], jc_rec[..., :2]),
         PG.square_dist_loss(pc_in[:, :2], pc_rec[:, :2])),
        (JG.smoothness_loss(jgeo.depth_from_model(jnp.asarray(pred)),
                            jgeo.depth_from_model(jnp.asarray(gt))),
         PG.smoothness_loss(pgeo.depth_from_model(nchw(pred)), pgeo.depth_from_model(nchw(gt)))),
        (JG.normal_consistency_loss(jgeo, jc_in, jc_rec),
         PG.normal_consistency_loss(pgeo, pc_in, pc_rec))]
    # the squared distances subtract coordinates of tens of metres that agree
    # to 1e-6 relative: held elementwise to 1e-4 of the largest, in the mean
    # (what the loss takes) to 1e-5 relative
    for want, got in losses:
        got, want = (nhwc(got) if got.ndim == 4 else got.numpy()), np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4 * np.abs(want).max())
        assert abs(got.mean() - want.mean()) <= 1e-5 * abs(want.mean())
    assert float(losses[1][1]) > 0          # the smoothness mask kept pixels


NLL_CASES = {   # the kitti YAML's loss; JAX's adversarial test's; L2 with compression
    "kitti_yaml": dict(geo_factor=0.0, mask_factor=0.0, curve_length=1),
    "mask_geo": dict(geo_factor=1.0, mask_factor=1.0, curve_length=1),
    "l2_curve4": dict(geo_factor=1.0, mask_factor=0.0, curve_length=4, pixel_loss="l2")}


@pytest.mark.parametrize("case", sorted(NLL_CASES))
def test_reconstruction_nll_parts_match_jax(case):
    kw = NLL_CASES[case]
    jcfg, pcfg = JV.VQLossConfig(**kw), PV.VQLossConfig(**kw)
    assert jcfg.rec_scale == pcfg.rec_scale
    jgeo = JG.GeoConverter(JGEO, kw["curve_length"])
    pgeo = PG.GeoConverter(PGEO, kw["curve_length"])
    x = _images(3)
    rng = np.random.default_rng(4)
    c = 2 if kw["mask_factor"] else 1
    rec = np.clip(np.concatenate([x, rng.uniform(-1, 1, x.shape)], -1)[..., :c]
                  + 0.05 * rng.standard_normal((*x.shape[:3], c)), -1, 1).astype(np.float32)
    mask = np.where(x > -1, 1.0, -1.0).astype(np.float32)
    want_nll, want = JV.reconstruction_nll(jcfg, jgeo, jnp.asarray(x), jnp.asarray(rec),
                                           jnp.asarray(mask))
    got_nll, got = PV.reconstruction_nll(pcfg, pgeo, nchw(x), nchw(rec), nchw(mask))
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * abs(float(want[k])) + 1e-7, k
    assert abs(float(got_nll) - float(want_nll)) <= 1e-5 * abs(float(want_nll))


@pytest.mark.parametrize("case", sorted(NLL_CASES))
def test_assemble_disc_input_matches_jax(case):
    kw = NLL_CASES[case]
    jcfg, pcfg = JV.VQLossConfig(**kw), PV.VQLossConfig(**kw)
    jgeo, pgeo = JG.GeoConverter(JGEO, 1), PG.GeoConverter(PGEO, 1)
    x, rec = _images(5), _images(6, c=2)
    mask = np.where(x > -1, 1.0, -1.0).astype(np.float32)
    for imgs, is_recon in ((x, False), (rec, True)):
        want = JV.assemble_disc_input(jcfg, jgeo, jnp.asarray(imgs), jnp.asarray(mask), is_recon)
        got = PV.assemble_disc_input(pcfg, pgeo, nchw(imgs), nchw(mask), is_recon)
        np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert PT.disc_in_channels(2, pcfg, pgeo) == 2 + 2 * (kw["geo_factor"] > 0)


# ------------------------------------------------------------ discriminators
@pytest.mark.parametrize("version", ["v0", "v1"])
def test_discriminator_and_d_losses_match_jax(version):
    """v0 and v1 (ndf 16, 2 layers; 32 and 64 channels under GroupNorm(32,
    eps 1e-5)) on 3-channel 16x64 inputs: logits within 1e-4 relative L2
    (four convs and two norms of f32 in other orders), then both d-losses."""
    x = np.random.default_rng(7).uniform(-1, 1, (2, *SIZE, 3)).astype(np.float32)
    jd = JD.DISCRIMINATORS[version](ndf=16, n_layers=2)
    params = jax.tree.map(np.array, random_flax_params(jd.init, 8, jax.random.key(0),
                                                       jnp.asarray(x)))
    want = np.asarray(jd.apply(params, jnp.asarray(x)))
    pd = PD.DISCRIMINATORS[version](3, ndf=16, n_layers=2)
    pd.load_state_dict(discriminator_state_dict(params))
    with torch.no_grad():
        got = nhwc(pd(nchw(x)))
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-4
    fake = want[::-1].copy() + 0.3
    for jfn, pfn in ((JD.hinge_d_loss, PD.hinge_d_loss), (JD.vanilla_d_loss, PD.vanilla_d_loss)):
        w = float(jfn(jnp.asarray(want), jnp.asarray(fake)))
        g = float(pfn(torch.from_numpy(want), torch.from_numpy(fake)))
        assert abs(g - w) <= 1e-6 * abs(w)


# ------------------------------------------------------------- one whole step
@pytest.fixture(scope="module")
def jax_ae():
    """The JAX model, discriminator, loss config and a train state of seeded
    random parameters."""
    model = JAE.VQModel(JAE.AEConfig(**AE_KW), n_embed=N_EMBED, embed_dim=EMBED_DIM,
                        use_mask=True)
    disc = JD.LiDARNLayerDiscriminator(ndf=16, n_layers=2)
    cfg = JV.VQLossConfig(**LOSS_KW)
    geo = JG.GeoConverter(JGEO, curve_length=1)
    x = jnp.zeros((1, *SIZE, 1))
    params_g = random_flax_params(model.init, 11, jax.random.key(0), x)
    dec = jnp.zeros((1, *SIZE, AE_KW["out_ch"]))
    params_d = random_flax_params(disc.init, 12, jax.random.key(1),
                                  JV.assemble_disc_input(cfg, geo, dec, None, True))
    tx_g, tx_d = JT.make_ae_optimizers(LR, LR)
    state = JT.AETrainState(params_g=params_g, params_d=params_d, opt_g=tx_g.init(params_g),
                            opt_d=tx_d.init(params_d), step=jnp.zeros((), jnp.int32))
    # JAX's jitted step, compiled with the backend's optimisations off. Its
    # d_weight reads the conv_out weight-gradient of the GAN loss: sums of
    # 2048 products that cancel about 100x here. LLVM's vectorised
    # reassociation of those sums moves d_weight by 7e-4 relative (towards
    # float64), as far from JAX's own op-by-op (eager) step as from the
    # port; at level 0 the jitted step equals the eager one to 1e-7
    b = jnp.zeros((2, *SIZE, 1))
    args = (state, {"image": b, "mask": b}, jax.random.key(0))
    step = JT.make_ae_train_step(model, disc, cfg, geo, tx_g, tx_d).lower(*args).compile(
        {"xla_backend_optimization_level": 0})
    return model, disc, cfg, geo, state, step


def _port_ae(state):
    """The port's model, discriminator, loss config and state from a JAX state."""
    sd_g, sd_d = ae_train_state_dicts(jax.tree.map(np.array, state))
    model = PAE.VQModel(PAE.AEConfig(**AE_KW), n_embed=N_EMBED, embed_dim=EMBED_DIM,
                        use_mask=True)
    model.load_state_dict(sd_g)
    cfg, geo = PV.VQLossConfig(**LOSS_KW), PG.GeoConverter(PGEO, curve_length=1)
    disc = PD.LiDARNLayerDiscriminator(PT.disc_in_channels(AE_KW["out_ch"], cfg, geo),
                                       ndf=16, n_layers=2)
    disc.load_state_dict(sd_d)
    return model, disc, cfg, geo, PT.create_ae_state(model, disc, LR, LR)


def _batch(seed=9):
    x = _images(seed)
    return {"image": x, "mask": np.where(x > -1, 1.0, -1.0).astype(np.float32)}


@pytest.mark.parametrize("step_no", [0, 2])
def test_ae_step_matches_jax(jax_ae, step_no):
    """One VQ-GAN step from the same weights and batch at step 0 (GAN terms
    on) and step 2 (past ``disc_start`` 1, off): every loss part, d_weight
    and disc_loss within 1e-5 relative; the generator's and the
    discriminator's gradients within 1e-4 relative L2 (JAX's from Adam's
    first moment, which is (1 - b1) g after one update); both models'
    parameters after Adam within 2 lr (the first update is about lr * sign(g),
    which flips where g is within rounding of 0), under 1e-3 of the elements
    with a gradient off by more than 0.01 lr."""
    jmodel, jdisc, jcfg, jgeo, state0, jstep = jax_ae
    state0 = dataclasses.replace(state0, step=jnp.asarray(step_no, jnp.int32))
    batch = _batch()
    jstate, jlogs = jstep(state0, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.key(3))

    model, disc, cfg, geo, state = _port_ae(state0)
    state.step = step_no
    grads = {}
    for name, opt in (("g", state.opt_g), ("d", state.opt_d)):
        real = opt.step

        def spy(gs, real=real, name=name):
            grads[name] = [g_.clone() for g_ in gs]
            return real(gs)
        opt.step = spy
    state, logs = PT.make_ae_train_step(model, disc, cfg, geo)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator())
    assert state.step == step_no + 1
    assert set(jlogs) <= set(logs)
    for k in jlogs:
        w, g = float(jlogs[k]), float(logs[k])
        assert abs(g - w) <= 1e-5 * abs(w) + 1e-7, (k, g, w)
    on = step_no <= LOSS_KW["disc_start"]
    assert (float(logs["disc_loss"]) != 0) == on

    def first_grad(opt):
        return jax.tree.map(lambda m: 2.0 * np.asarray(m), opt[0].mu)
    want_g = vq_state_dict(first_grad(jstate.opt_g))
    want_d = discriminator_state_dict(first_grad(jstate.opt_d))
    for name, module, want in (("g", model, want_g), ("d", disc, want_d)):
        names = [n for n, _ in module.named_parameters()]
        got = torch.cat([g_.flatten() for g_ in grads[name]]).numpy()
        ref = torch.cat([want[n].flatten() for n in names]).numpy()
        if name == "d" and not on:
            assert not np.abs(got).any() and not np.abs(ref).any()
        else:
            assert _rel(got, ref) <= 1e-4, name
    # Adam's first update is about lr * sign(g): each element within 2 lr,
    # and under 1e-3 of them off by more than 0.01 lr (a sign flipped where
    # g is within rounding of 0). Elements whose gradient is zero to
    # rounding in JAX (under 1e-6 of the model's largest) are held by their
    # gradient instead, since both sides step them by lr * sign(noise): at
    # these widths every GroupNorm has one channel a group, so it removes
    # the bias of the conv before it, about 1,000 of 135,438 elements
    after_g, after_d = ae_train_state_dicts(jstate)
    for name, module, after, want in (("g", model, after_g, want_g),
                                      ("d", disc, after_d, want_d)):
        for n, p in module.named_parameters():
            assert float((p.detach() - after[n]).abs().max()) <= 2 * LR, n
        diff = torch.cat([(p.detach() - after[n]).abs().flatten()
                          for n, p in module.named_parameters()])
        ref = torch.cat([want[n].flatten() for n, _ in module.named_parameters()])
        got = torch.cat([g_.flatten() for g_ in grads[name]])
        live = ref.abs() > 1e-6 * ref.abs().max()
        assert int((diff[live] > 0.01 * LR).sum()) <= 1e-3 * int(live.sum()), name
        assert float((got.abs() * ~live).max()) <= 1e-5 * float(ref.abs().max()), name


def test_ae_val_step_and_prefinal_match_jax(jax_ae):
    """The val step (rec_loss, nll_loss, quant_loss) within 1e-5 relative,
    and forward_with_prefinal's reconstruction and last-layer input."""
    jmodel, _, jcfg, jgeo, state0, _ = jax_ae
    x = _batch(10)
    want = JT.make_ae_val_step(jmodel, jcfg, jgeo)(
        state0, {k: jnp.asarray(v) for k, v in x.items()}, jax.random.key(0))
    model, _, cfg, geo, state = _port_ae(state0)
    got = PT.make_ae_val_step(model, cfg, geo)(
        state, {k: torch.from_numpy(v) for k, v in x.items()}, torch.Generator())
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * abs(float(want[k])), k
    jdec, _, _, jpre = jax.jit(lambda p, v: jmodel.apply(
        p, v, method=JAE.VQModel.forward_with_prefinal))(state0.params_g, jnp.asarray(x["image"]))
    with torch.no_grad():
        dec, _, _, pre = model.forward_with_prefinal(nchw(x["image"]))
    assert _rel(nhwc(dec), jdec) <= 1e-5 and _rel(nhwc(pre), jpre) <= 1e-5


def test_dropout_draws_come_from_the_step_generator():
    """With dropout in the config the step's generator decides the mask:
    the same seed gives the same step, another seed another one; without
    dropout the step does not read the generator."""
    def run(seed, dropout):
        torch.manual_seed(0)
        model = PAE.VQModel(PAE.AEConfig(**AE_KW, dropout=dropout), n_embed=N_EMBED,
                            embed_dim=EMBED_DIM, use_mask=True)
        cfg, geo = PV.VQLossConfig(**LOSS_KW), PG.GeoConverter(PGEO, curve_length=1)
        disc = PD.LiDARNLayerDiscriminator(4, ndf=16, n_layers=2)
        state = PT.create_ae_state(model, disc, LR, LR)
        gen = torch.Generator().manual_seed(seed)
        _, logs = PT.make_ae_train_step(model, disc, cfg, geo)(
            state, {k: torch.from_numpy(v) for k, v in _batch().items()}, gen)
        return float(logs["rec_loss"]), gen.initial_seed(), gen.get_state()

    a, b, c = run(1, 0.5), run(1, 0.5), run(2, 0.5)
    assert a[0] == b[0] != c[0]
    untouched = torch.Generator().manual_seed(1).get_state()
    assert torch.equal(run(1, 0.0)[2], untouched)
    assert not torch.equal(a[2], untouched)
