"""PyTorch port vs the JAX package: the rest of first-stage training.

``LinearAttnBlock`` (``attn_type: linear``) and ``conv_nd`` on seeded
numpy inputs and weights; the RangeNet perceptual loss and its gradient
with respect to the reconstruction, with and without ``descriptor_weight``,
on the same RangeNet weights (``utils/convert.rangenet_state_dict``); and
one VQ-GAN step in bf16 with linear attention and the perceptual term, the
JAX model built in bf16 (``VQModel(dtype=bfloat16)``, as JAX's CLI builds it
under ``--bf16``) and the port under bf16 autocast, both on the CPU; then
the ``train_lidm`` CLI with ``--bf16``, the perceptual term and linear
attention on the kitti AE's YAML shrunk by dotlist overrides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_layout_tpu.eval import rangenet as JR
from lidar_layout_tpu.losses import discriminator as JD
from lidar_layout_tpu.losses import geometric as JG
from lidar_layout_tpu.losses import perceptual as JP
from lidar_layout_tpu.losses import vq_loss as JV
from lidar_layout_tpu.models import autoencoder as JAE
from lidar_layout_tpu.nn import blocks as JB
from lidar_layout_tpu.nn import conv as JC
from lidar_layout_tpu.ops.lidar import LidarGeometry as JGeom
from lidar_layout_tpu.train import ae_trainer as JT
from lidar_layout_tpu_torch.eval import rangenet as PR
from lidar_layout_tpu_torch.losses import discriminator as PD
from lidar_layout_tpu_torch.losses import geometric as PG
from lidar_layout_tpu_torch.losses import perceptual as PP
from lidar_layout_tpu_torch.losses import vq_loss as PV
from lidar_layout_tpu_torch.models import autoencoder as PAE
from lidar_layout_tpu_torch.nn import blocks as PB
from lidar_layout_tpu_torch.nn import conv as PC
from lidar_layout_tpu_torch.ops.lidar import LidarGeometry as PGeom
from lidar_layout_tpu_torch.train import ae_trainer as PT
from lidar_layout_tpu_torch.utils.convert import (ae_train_state_dicts, rangenet_state_dict,
                                                  vq_state_dict)
from torch_port_helpers import nchw, nhwc, one_intra_op_thread, random_flax_params

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
SIZE = (16, 64)
JGEO, PGEO = JGeom(size=SIZE), PGeom(size=SIZE)
AE_KW = dict(ch=16, ch_mult=(1, 2), strides=((1, 2),), z_channels=4, out_ch=2,
             num_res_blocks=1, attn_type="linear")
N_EMBED, EMBED_DIM, LR = 64, 4, 1e-3
LOSS_KW = dict(mask_factor=1.0, geo_factor=1.0, perceptual_factor=1.0, disc_start=1,
               curve_length=1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _images(seed, b=2):
    """Model-space range images in runs of 8 equal pixels, with no-return pixels."""
    rng = np.random.default_rng(seed)
    img = np.repeat(rng.uniform(-0.6, 0.8, (b, SIZE[0], SIZE[1] // 8, 1)), 8, axis=2)
    img[rng.random(img.shape) < 0.1] = -1.0
    return img.astype(np.float32)


# ------------------------------------------------------------ the blocks
def test_linear_attn_block_matches_jax():
    """Softmax over q's channels and k's positions, one head, no norm: the
    block's output within 1e-5 of JAX's (f32), through ``make_attn``."""
    c = 16
    x = np.random.default_rng(0).standard_normal((2, 4, 8, c)).astype(np.float32)
    jblock = JB.LinearAttnBlock()
    params = random_flax_params(jblock.init, 1, jax.random.key(0), jnp.asarray(x))
    want = np.asarray(jblock.apply(params, jnp.asarray(x)))
    block = PB.make_attn(c, "linear")
    assert isinstance(block, PB.LinearAttnBlock)
    sd = vq_state_dict({"params": {"mid_attn_1": params["params"]}})
    block.load_state_dict({k[len("mid.attn_1."):]: v for k, v in sd.items()})
    assert block.to_qkv.bias is None
    with torch.no_grad():
        got = nhwc(block(nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="unknown attn_type"):
        PB.make_attn(c, "sparse")


@pytest.mark.parametrize("dims,cconv,padding,stride", [
    (2, True, (1, 2, 0, 1), 1), (2, False, (0, 1, 1, 1), (1, 2)), (2, False, 1, 2),
    (1, False, 1, 1), (1, False, [(0, 2)], 1), (3, False, 1, 1)])
def test_conv_nd_matches_jax(dims, cconv, padding, stride):
    """The circular-or-plain dispatch: circular on W with a 2-D ``cconv``,
    zero padding otherwise, (left, right, top, bottom) in 2-D; within 1e-5
    of JAX's conv on the same HWIO kernel."""
    rng = np.random.default_rng(2)
    spatial = {1: (12,), 2: (6, 10), 3: (4, 5, 6)}[dims]
    x = rng.standard_normal((2, *spatial, 3)).astype(np.float32)
    jconv = JC.conv_nd(dims, 5, 3, cconv=cconv, strides=stride, padding=padding)
    params = random_flax_params(jconv.init, 3, jax.random.key(0), jnp.asarray(x))
    want = np.asarray(jconv.apply(params, jnp.asarray(x)))
    conv = PC.conv_nd(dims, 3, 5, 3, cconv=cconv, strides=stride, padding=padding)
    leaves = params["params"]
    leaves = leaves.get("conv", leaves)   # the circular conv's inner flax Conv
    perm = (dims + 1, dims) + tuple(range(dims))
    conv.load_state_dict({"weight": torch.from_numpy(np.transpose(np.asarray(leaves["kernel"]),
                                                                  perm).copy()),
                          "bias": torch.from_numpy(np.asarray(leaves["bias"]))})
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    with torch.no_grad():
        got = np.moveaxis(conv(xt).numpy(), 1, -1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# -------------------------------------------------------- perceptual loss
def _jax_rangenet_variables(shape):
    """RangeNet-21 variables: JAX's init with the BatchNorm leaves and the
    upconv biases drawn at random, so that every leaf shows."""
    net = JR.RangeNet(layers=21)
    variables = jax.tree.map(np.asarray, jax.jit(net.init)(jax.random.key(0), jnp.zeros(shape)))
    rng = np.random.default_rng(70)

    def fill(path, v):
        leaf = path[-1].key
        r = rng.standard_normal(v.shape).astype(np.float32)
        if leaf == "var":
            return 1.0 + 0.1 * np.abs(r)
        if leaf == "scale":
            return 1.0 + 0.1 * r
        if leaf in ("bias", "mean"):
            return 0.1 * r
        return v
    return jax.tree_util.tree_map_with_path(fill, variables)


@pytest.fixture(scope="module")
def rangenet_weights():
    variables = _jax_rangenet_variables((1, *SIZE, 4))
    net = PR.RangeNet(layers=21)
    net.load_state_dict(rangenet_state_dict(variables))
    return variables, net


@pytest.mark.parametrize("descriptor_weight", [0.0, 0.5])
def test_perceptual_loss_and_gradient_match_jax(rangenet_weights, descriptor_weight):
    """The loss within 1e-5 relative and its gradient with respect to the
    reconstruction within 1e-4 relative L2 (40 f32 convolutions forward and
    back, summed in other orders); the net stays frozen: no parameter
    gathers a gradient, and it stays in eval mode."""
    variables, net = rangenet_weights
    target, recon = _images(5), _images(6)
    jfn = JP.make_perceptual_fn(JGEO, params=variables, descriptor_weight=descriptor_weight)
    want, want_g = jax.jit(jax.value_and_grad(lambda r: jfn(jnp.asarray(target), r)))(
        jnp.asarray(recon))
    pfn = PP.make_perceptual_fn(PGEO, net=net, descriptor_weight=descriptor_weight)
    r = nchw(recon).requires_grad_()
    got = pfn(nchw(target), r)
    got.backward()
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert _rel(nhwc(r.grad), np.asarray(want_g)) <= 1e-4
    assert not pfn.net.training
    assert all(p.grad is None and not p.requires_grad for p in pfn.net.parameters())


# --------------------------------------------------------- one bf16 step
# GAN, geometric, smoothness and normal terms off, the pixel loss squared:
# the terms whose bf16 gradients rounding does not swamp at tiny widths
SMOOTH_LOSS_KW = dict(LOSS_KW, geo_factor=0.0, smooth_factor=0.0, norm_factor=0.0,
                      pixel_loss="l2", disc_start=-1)


def _jax_bf16_step(variables, loss_kw):
    """JAX's AE in bf16 (its CLI's --bf16) with linear attention, the f32
    discriminator JAX's CLI builds, the perceptual term on the shared
    RangeNet weights, and a train state of seeded random parameters."""
    model = JAE.VQModel(JAE.AEConfig(**AE_KW), n_embed=N_EMBED, embed_dim=EMBED_DIM,
                        use_mask=True, dtype=jnp.bfloat16)
    disc = JD.LiDARNLayerDiscriminator(ndf=16, n_layers=2)
    cfg = JV.VQLossConfig(**loss_kw)
    geo = JG.GeoConverter(JGEO, curve_length=1)
    x = jnp.zeros((1, *SIZE, 1))
    params_g = random_flax_params(model.init, 11, jax.random.key(0), x)
    dec = jnp.zeros((1, *SIZE, AE_KW["out_ch"]))
    params_d = random_flax_params(disc.init, 12, jax.random.key(1),
                                  JV.assemble_disc_input(cfg, geo, dec, None, True))
    tx_g, tx_d = JT.make_ae_optimizers(LR, LR)
    state = JT.AETrainState(params_g=params_g, params_d=params_d, opt_g=tx_g.init(params_g),
                            opt_d=tx_d.init(params_d), step=jnp.zeros((), jnp.int32))
    pfn = JP.make_perceptual_fn(JGEO, params=variables)
    b = jnp.zeros((2, *SIZE, 1))
    args = (state, {"image": b, "mask": b}, jax.random.key(0))
    step = JT.make_ae_train_step(model, disc, cfg, geo, tx_g, tx_d, perceptual_fn=pfn).lower(
        *args).compile({"xla_backend_optimization_level": 0})
    return state, step


@pytest.fixture(scope="module")
def jax_bf16_ae(rangenet_weights):
    return _jax_bf16_step(rangenet_weights[0], LOSS_KW)


def _port_step(state0, net, batch, amp, loss_kw=LOSS_KW):
    """The port's step from JAX's state under autocast ``amp`` (None: f32):
    (logs, generator gradients, discriminator gradients), each gradient
    flattened in ``named_parameters`` order."""
    sd_g, sd_d = ae_train_state_dicts(jax.tree.map(np.array, state0))
    model = PAE.VQModel(PAE.AEConfig(**AE_KW), n_embed=N_EMBED, embed_dim=EMBED_DIM,
                        use_mask=True)
    model.load_state_dict(sd_g)
    cfg, geo = PV.VQLossConfig(**loss_kw), PG.GeoConverter(PGEO, curve_length=1)
    disc = PD.LiDARNLayerDiscriminator(PT.disc_in_channels(AE_KW["out_ch"], cfg, geo),
                                       ndf=16, n_layers=2)
    disc.load_state_dict(sd_d)
    state = PT.create_ae_state(model, disc, LR, LR)
    grads = {}
    for name, opt in (("g", state.opt_g), ("d", state.opt_d)):
        real = opt.step

        def spy(gs, real=real, name=name):
            grads[name] = torch.cat([g_.flatten() for g_ in gs]).numpy()
            return real(gs)
        opt.step = spy
    step = PT.make_ae_train_step(model, disc, cfg, geo, perceptual_fn=PP.make_perceptual_fn(
        PGEO, net=net), autocast_dtype=amp)
    _, logs = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                   torch.Generator())
    return {k: float(v) for k, v in logs.items()}, grads["g"], grads["d"], model, disc


# d_weight's GAN gradient cancels about 100x (the f32 step's test says so),
# the smoothness and normal terms threshold and normalise differences of
# neighbouring pixels: bf16's rounding moves these by tens of percent
ILL_CONDITIONED = ("d_weight", "smooth_loss", "normal_loss", "total_loss")


def _batch():
    x = _images(9)
    return {"image": x, "mask": np.where(x > -1, 1.0, -1.0).astype(np.float32)}


def _first_grad(opt):
    """The step's gradient from Adam's first moment after one update (2 mu)."""
    return jax.tree.map(lambda m: 2.0 * np.asarray(m), opt[0].mu)


def _hold_grads(module, want, got, exact):
    """The port's bf16 gradient (``got``) lies from JAX's bf16 one (``want``,
    a state dict) no farther than 1.25 times the port's exact f32 gradient
    (``exact``) does, and that gap is at most 0.4 relative L2, so the bound
    stays under 0.5: a zero gradient reads 1.0, a random one of the right
    norm about 1.41. Two bf16 roundings of one gradient agree better than
    either does with the exact gradient (0.97-1.11x it here)."""
    ref = torch.cat([want[n].flatten() for n, _ in module.named_parameters()]).numpy()
    got_rel, exact_rel = _rel(got, ref), _rel(exact, ref)
    assert exact_rel <= 0.4, exact_rel
    assert got_rel <= 1.25 * exact_rel, (got_rel, exact_rel)


def test_bf16_ae_step_matches_jax(jax_bf16_ae, rangenet_weights):
    """One VQ-GAN step at step 0 (GAN terms on) from the same weights and
    batch, both in bf16: JAX's model built in bf16, the port's under bf16
    autocast (f32 codebook search, losses, perceptual net and
    discriminator, as JAX's dtype policy). bf16 keeps 8 significant bits (a
    rounding of 2^-9 of a value) over about 20 layers each way. Held:

    - every well-conditioned log (the NLL's parts, the perceptual term, the
      codebook, GAN and discriminator losses, the logits) within 2e-2
      relative of JAX's;
    - the ill-conditioned ones (``ILL_CONDITIONED``) within 0.5 relative
      (the port takes the adaptive weight's gradients over its bf16 last
      conv, JAX over that conv run again in f32: d_weight 0.22 apart), and
      ``total_loss`` equal to the port's own nll + d_weight * g_loss +
      codebook loss within 1e-5;
    - the discriminator's gradients (``_hold_grads``: 0.14 relative L2,
      the exact ones 0.13). The generator's gradients are held where the
      GAN, geometric, smoothness and normal terms do not swamp them
      (``test_bf16_ae_generator_gradient_matches_jax``): with them on, the
      port's own f32 gradient is 0.86 relative L2 from JAX's bf16 one."""
    state0, jstep = jax_bf16_ae
    _, net = rangenet_weights
    batch = _batch()
    jstate, jlogs = jstep(state0, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.key(3))
    logs, _, d16, _, disc = _port_step(state0, net, batch, torch.bfloat16)
    _, _, d32, _, _ = _port_step(state0, net, batch, None)
    assert set(jlogs) <= set(logs) and logs["perceptual_loss"] > 0
    for k in jlogs:
        w, g = float(jlogs[k]), logs[k]
        tol = 0.5 if k in ILL_CONDITIONED else 2e-2
        assert abs(g - w) <= tol * abs(w) + 1e-6, (k, g, w)
    total = logs["nll_loss"] + logs["d_weight"] * logs["g_loss"] + logs["quant_loss"]
    assert abs(logs["total_loss"] - total) <= 1e-5 * abs(total)
    from lidar_layout_tpu_torch.utils.convert import discriminator_state_dict
    _hold_grads(disc, discriminator_state_dict(_first_grad(jstate.opt_d)), d16, d32)


def test_bf16_ae_generator_gradient_matches_jax(rangenet_weights):
    """The generator's bf16 gradient, every leaf, against JAX's bf16 one
    (``_hold_grads``) with the pixel, mask, perceptual and codebook terms
    (``SMOOTH_LOSS_KW``): 0.28 relative L2, the exact f32 one 0.27 (the
    gradients of tiny random-weight layers cancel; JAX sums its biases'
    in bf16). The geometric term's L1 over xyz alone moves the exact one to
    0.54, and the GAN and smoothness terms to 0.86. The logs within 2e-2."""
    variables, net = rangenet_weights
    state0, jstep = _jax_bf16_step(variables, SMOOTH_LOSS_KW)
    batch = _batch()
    jstate, jlogs = jstep(state0, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.key(3))
    logs, g16, _, model, _ = _port_step(state0, net, batch, torch.bfloat16, SMOOTH_LOSS_KW)
    _, g32, _, _, _ = _port_step(state0, net, batch, None, SMOOTH_LOSS_KW)
    assert logs["perceptual_loss"] > 0 and float(jlogs["disc_loss"]) == logs["disc_loss"] == 0
    for k in set(jlogs) - {"d_weight"}:
        w, g = float(jlogs[k]), logs[k]
        assert abs(g - w) <= 2e-2 * abs(w) + 1e-6, (k, g, w)
    _hold_grads(model, vq_state_dict(_first_grad(jstate.opt_g)), g16, g32)


def test_bf16_ae_cli_with_perceptual_and_linear_attention(tmp_path, capsys):
    """train_lidm --bf16 on the kitti AE's YAML, shrunk, with the perceptual
    term and linear attention: two steps, finite logs, a checkpoint."""
    from lidar_layout_tpu_torch.train import train_lidm

    trainer = train_lidm.main([
        "-b", "configs/autoencoder/kitti/autoencoder_c2_p4.yaml", "--cpu", "--synthetic",
        "--bf16", "--steps", "2", "--workdir", str(tmp_path),
        "model.params.ddconfig.ch=8", "model.params.ddconfig.num_res_blocks=1",
        "model.params.ddconfig.attn_type=linear", "model.params.n_embed=64",
        "model.params.lossconfig.params.perceptual_factor=1.0",
        "data.params.batch_size=1", "data.params.num_val_batches=1",
        "data.params.dataset.size=[16,128]"])
    out = capsys.readouterr().out
    assert "perceptual loss active" in out
    assert trainer.global_step == 2
    model = trainer.state.model
    assert isinstance(model.encoder.mid.attn_1, PB.LinearAttnBlock)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert list((tmp_path / "ckpt").glob("step_*.pt"))


def test_bf16_kl_ae_cli(tmp_path):
    """train_lidm --bf16 trains the KL autoencoder (the kitti AE's YAML with
    JAX's override) under bf16 autocast on float32 weights: two steps,
    finite losses, float32 parameters."""
    from lidar_layout_tpu_torch.models.autoencoder import AutoencoderKL
    from lidar_layout_tpu_torch.train import train_lidm

    trainer = train_lidm.main([
        "-b", "configs/autoencoder/kitti/autoencoder_c2_p4.yaml", "--cpu", "--synthetic",
        "--bf16", "--steps", "2", "--workdir", str(tmp_path), "model.target=autoencoder_kl",
        "model.params.ddconfig.double_z=true", "model.params.ddconfig.ch=8",
        "model.params.ddconfig.num_res_blocks=1", "data.params.batch_size=1",
        "data.params.num_val_batches=1", "data.params.dataset.size=[16,128]"])
    model = trainer.state.model
    assert isinstance(model, AutoencoderKL) and trainer.global_step == 2
    assert all(p.dtype == torch.float32 and bool(torch.isfinite(p).all())
               for p in model.parameters())
