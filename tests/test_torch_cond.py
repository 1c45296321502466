"""PyTorch port vs the JAX package: conditional generation.

The same seeded numpy inputs go through the JAX modules and their ports on
the CPU in float32, with the JAX trees (``random_flax_params``: kernels at
1/sqrt(fan_in), so the zero-initialised projections are live) carried over
by ``utils/convert``: ``CrossAttention`` with a key mask, the
``SpatialTransformer``, the U-Net with SpatialTransformers and class labels,
``LatentDiffusion.apply_model`` under the keys ``concat``, ``crossattn``,
``hybrid`` and ``adm`` (bare and dict conditioning), ``p_losses`` through
``get_learned_conditioning``, the ``SpatialRescaler`` (antialiased bilinear
and "linear", and "nearest", as ``jax.image.resize``), ``ClassEmbedder``, ``TransformerEmbedder`` and
``BERTEmbedder`` with ``bert_tokenize``'s fallback, the conditioning-token
builders, the noisy-latent classifier (loss and guidance gradient) and
map2lidar end to end at the JAX script's ``--tiny`` widths.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lidar_layout_tpu.data import conditional_builder as JB
from lidar_layout_tpu.encoders import modules as JE
from lidar_layout_tpu.models import classifier as JC
from lidar_layout_tpu.models.diffusion import DiffusionConfig as JDiffusionConfig
from lidar_layout_tpu.models.diffusion import LatentDiffusion as JLatentDiffusion
from lidar_layout_tpu.models.unet import UNetConfig as JUNetConfig
from lidar_layout_tpu.models.unet import UNetModel as JUNetModel
from lidar_layout_tpu.nn import attention as JA
from lidar_layout_tpu_torch import config as PC
from lidar_layout_tpu_torch import sample_cond
from lidar_layout_tpu_torch.data import conditional_builder as PB
from lidar_layout_tpu_torch.encoders import modules as PE
from lidar_layout_tpu_torch.models import classifier as PCL
from lidar_layout_tpu_torch.models.diffusion import DiffusionConfig, LatentDiffusion
from lidar_layout_tpu_torch.models.unet import UNetConfig, UNetModel
from lidar_layout_tpu_torch.nn import attention as PA
from lidar_layout_tpu_torch.utils import convert as CV
from torch_port_helpers import (cond_end_to_end, jax_cond_ldm, nchw, nhwc,
                                one_intra_op_thread, random_flax_params, rel_l2)

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
TOL = 1e-5        # relative L2 of one module's output
LATENT = (4, 16, 2)
UNET = dict(model_channels=32, out_channels=2, num_res_blocks=1, attention_resolutions=(2,),
            channel_mult=(1, 2), num_head_channels=8)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _load(module: torch.nn.Module, sd) -> torch.nn.Module:
    module.load_state_dict(sd)          # strict: every name carried, none extra
    return module.eval()


def _tokens(rng, n, s, width):
    return rng.standard_normal((n, s, width)).astype(np.float32)


# --------------------------------------------------------------- attention
def test_cross_attention_key_mask_matches_jax():
    rng = np.random.default_rng(0)
    x, ctx = _tokens(rng, 2, 12, 32), _tokens(rng, 2, 5, 24)
    mask = np.array([[True] * 5, [True, True, False, True, False]])
    jmod = JA.CrossAttention(heads=4, dim_head=8)
    params = random_flax_params(jmod.init, 1, jax.random.key(0), jnp.asarray(x),
                                context=jnp.asarray(ctx), mask=jnp.asarray(mask))
    want = jmod.apply(params, jnp.asarray(x), context=jnp.asarray(ctx), mask=jnp.asarray(mask))
    port = _load(PA.CrossAttention(32, 24, 4, 8), CV.cond_stage_state_dict(params))
    with torch.no_grad():
        got = port(_t(x), _t(ctx), _t(mask))
        unmasked = port(_t(x), _t(ctx))
    assert rel_l2(got.numpy(), want) < TOL
    assert rel_l2(unmasked.numpy(), want) > 1e-2     # the mask reaches the softmax


@pytest.mark.parametrize("masked", [False, True])
def test_spatial_transformer_matches_jax(masked):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 6, 64)).astype(np.float32) * 2 + 0.5   # NHWC
    ctx = _tokens(rng, 2, 3, 16)
    mask = np.array([[True, False, True], [True, True, True]]) if masked else None
    jmod = JA.SpatialTransformer(heads=4, dim_head=16, depth=2)
    kw = {} if mask is None else {"context_mask": jnp.asarray(mask)}
    params = random_flax_params(jmod.init, 2, jax.random.key(0), jnp.asarray(x),
                                jnp.asarray(ctx), **kw)
    want = jmod.apply(params, jnp.asarray(x), jnp.asarray(ctx), **kw)
    port = _load(PA.SpatialTransformer(64, 4, 16, depth=2, context_dim=16),
                 CV.cond_stage_state_dict(params))
    with torch.no_grad():
        got = port(nchw(x), _t(ctx), None if mask is None else _t(mask))
    assert rel_l2(nhwc(got), want) < TOL
    assert type(port.norm) is torch.nn.GroupNorm     # plain, as flax's nn.GroupNorm


def test_spatial_transformer_starts_as_identity():
    st = PA.SpatialTransformer(32, 2, 16, context_dim=8)
    x = torch.randn(1, 32, 2, 4)
    with torch.no_grad():
        assert torch.equal(st(x, torch.randn(1, 3, 8)), x)


# -------------------------------------------------------------------- U-Net
def _jax_unet(cfg_kw, x, context=None, y=None, seed=3):
    jnet = JUNetModel(JUNetConfig(**cfg_kw))
    params = random_flax_params(jnet.init, seed, jax.random.key(0), jnp.asarray(x),
                                jnp.zeros((x.shape[0],), jnp.int32), context=context, y=y)
    return jnet, params


@pytest.mark.parametrize("variant", ["spatial", "labels", "spatial+labels"])
def test_unet_spatial_transformer_and_labels_match_jax(variant):
    rng = np.random.default_rng(4)
    kw = dict(UNET, in_channels=2)
    if "spatial" in variant:
        kw.update(use_spatial_transformer=True, context_dim=12, transformer_depth=1)
    if "labels" in variant:
        kw.update(num_classes=5)
    x = rng.standard_normal((2, *LATENT)).astype(np.float32)
    t = np.array([7, 900])
    ctx = jnp.asarray(_tokens(rng, 2, 3, 12)) if "spatial" in variant else None
    y = jnp.asarray([1, 4]) if "labels" in variant else None
    jnet, params = _jax_unet(kw, x, ctx, y)
    want = jax.jit(jnet.apply)(params, jnp.asarray(x), jnp.asarray(t), context=ctx, y=y)
    cfg = UNetConfig(**kw)
    port = _load(UNetModel(cfg), CV.unet_state_dict(params, cfg))
    with torch.no_grad():
        got = port(nchw(x), _t(t), None if ctx is None else _t(ctx),
                   y=None if y is None else _t(y).long())
    assert np.abs(want).max() > 0.1
    assert rel_l2(nhwc(got), want) < TOL


def _keyed_pair(key, seed=5):
    """The port and JAX LatentDiffusion (no first stage, no stage) under
    ``key``, the U-Net's weights shared; its example conditioning."""
    rng = np.random.default_rng(seed)
    b, (h, w, c) = 2, LATENT
    concat = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    ctx = _tokens(rng, b, 3, 12)
    labels = np.array([2, 0])
    kw = dict(UNET, in_channels=c + 3 * (key in ("concat", "hybrid")))
    if key in ("crossattn", "hybrid"):
        kw.update(use_spatial_transformer=True, context_dim=12)
    if key == "adm":
        kw.update(num_classes=4)
    x_in = np.zeros((b, h, w, kw["in_channels"]), np.float32)
    _, uparams = _jax_unet(kw, x_in, jnp.asarray(ctx) if "context_dim" in kw else None,
                           jnp.asarray(labels) if key == "adm" else None, seed=seed)
    jcfg = JDiffusionConfig(timesteps=64, conditioning_key=key, latent_shape=LATENT)
    jmodel = JLatentDiffusion(jcfg, JUNetConfig(**kw))
    params = {"unet": uparams, "first_stage": {}, "cond_stage": {},
              "logvar": jnp.zeros((64,), jnp.float32)}
    ucfg = UNetConfig(**kw)
    port = LatentDiffusion(DiffusionConfig(timesteps=64, conditioning_key=key,
                                           latent_shape=LATENT), ucfg).eval()
    port.unet.load_state_dict(CV.unet_state_dict(uparams, ucfg))
    forms = {"concat": [concat, {"c_concat": concat}],
             "crossattn": [ctx, {"c_crossattn": ctx}],
             "hybrid": [{"c_concat": concat, "c_crossattn": ctx}],
             "adm": [labels, {"c_adm": labels}]}[key]
    return port, jmodel, params, forms


def _to_port(cond):
    if isinstance(cond, dict):
        return {k: _to_port(v) for k, v in cond.items()}
    t = _t(cond)
    return t.long() if t.dtype in (torch.int32, torch.int64) else t


@pytest.mark.parametrize("key", ["concat", "crossattn", "hybrid", "adm"])
def test_apply_model_conditioning_keys_match_jax(key):
    port, jmodel, params, forms = _keyed_pair(key)
    rng = np.random.default_rng(6)
    z = rng.standard_normal((2, *LATENT)).astype(np.float32)
    t = np.array([3, 50])
    for cond in forms:
        want = jax.jit(jmodel.apply_model)(params, jnp.asarray(z), jnp.asarray(t),
                                           jax.tree.map(jnp.asarray, cond))
        with torch.no_grad():
            got = port.apply_model(_t(z), _t(t), _to_port(cond))
        assert rel_l2(got.numpy(), want) < TOL, (key, type(cond))


def test_cond_views_follow_the_jax_rule():
    a = torch.zeros(1)
    views = {}
    for key in ("concat", "crossattn", "hybrid", "adm", "layout_crossattn"):
        m = LatentDiffusion.__new__(LatentDiffusion)
        object.__setattr__(m, "cfg", DiffusionConfig(conditioning_key=key))
        views[key] = [m._cond_views(c) for c in (a, {"c_concat": a, "c_crossattn": a,
                                                      "c_adm": a})]
    assert [v is a for v in views["concat"][0]] == [False, True, False]
    assert [v is a for v in views["crossattn"][0]] == [True, False, False]
    assert [v is a for v in views["adm"][0]] == [False, False, True]
    assert [v is a for v in views["hybrid"][1]] == [True, True, False]
    assert [v is a for v in views["layout_crossattn"][1]] == [True, False, False]


def test_concat_model_sees_map_channels_and_trains_from_batch_cond():
    """tests/test_training.py's concat case in the port: the U-Net is built
    for z + map channels, the rescaled map concatenates in apply_model, and
    training reads batch["cond"] through the stage, without a gradient to
    a frozen stage; p_losses matches JAX's at JAX's noise."""
    n_sem = 4
    jcfg = JDiffusionConfig(timesteps=32, latent_shape=(4, 8, 2), conditioning_key="concat")
    ukw = dict(in_channels=2 + n_sem, model_channels=32, out_channels=2, num_res_blocks=1,
               attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=8)
    stage_kw = dict(n_stages=1, wh_factors=(0.25, 0.25), out_channels=n_sem)
    jmodel = JLatentDiffusion(jcfg, JUNetConfig(**ukw), first_stage_cfg=None,
                              cond_stage=JE.SpatialRescaler(**stage_kw))
    params = random_flax_params(jmodel.init, 7, jax.random.key(0), (4, 8, 2),
                                cond_example=jnp.zeros((1, 16, 32, n_sem)))
    params["logvar"] = jnp.zeros((32,), jnp.float32)      # the port's fixed logvar
    ucfg = UNetConfig(**ukw)
    port = LatentDiffusion(DiffusionConfig(timesteps=32, latent_shape=(4, 8, 2),
                                           conditioning_key="concat"), ucfg,
                           cond_stage=PE.SpatialRescaler(**stage_kw))
    port.load_state_dict(CV.latent_diffusion_state_dict(params, ucfg))
    assert port.unet.input_blocks[0][0].weight.shape[1] == 2 + n_sem
    rng = np.random.default_rng(8)
    raw = rng.standard_normal((3, 16, 32, n_sem)).astype(np.float32)
    z = rng.standard_normal((3, 4, 8, 2)).astype(np.float32)
    t = np.array([0, 9, 31])
    key = jax.random.key(1)
    noise = np.asarray(jax.random.normal(key, z.shape, dtype=jnp.float32))
    c_j = jmodel.get_learned_conditioning(params, jnp.asarray(raw))
    want, _ = jax.jit(jmodel.p_losses, static_argnames="deterministic")(
        params, key, jnp.asarray(z), c_j, jnp.asarray(t), deterministic=True)
    c = port.get_learned_conditioning(raw)
    assert c.shape == (3, 4, 8, n_sem) and not c.requires_grad
    got, _ = port.p_losses(_t(z), _t(t), _t(noise), c)
    assert abs(float(got.detach()) - float(want)) <= TOL * abs(float(want))
    loss, _ = port.training_loss({"image": _t(z), "cond": _t(raw)},
                                 torch.Generator().manual_seed(0))
    loss.backward()
    assert np.isfinite(float(loss))
    assert port.cond_stage_model.channel_mapper.weight.grad is None
    assert port.unet.input_blocks[0][0].weight.grad is not None
    trainable = dataclasses.replace(port.cfg, cond_stage_trainable=True)
    port.cfg = trainable
    assert port.get_learned_conditioning(raw).requires_grad


# ------------------------------------------------------------------ encoders
@pytest.mark.parametrize("method", ["bilinear", "linear", "nearest"])
@pytest.mark.parametrize("factors,out", [((0.25, 0.125), 19), ((0.5, 0.5), None),
                                         ((2.0, 0.5), 5), ((0.3, 0.7), None)])
def test_spatial_rescaler_matches_jax_resize(factors, out, method):
    rng = np.random.default_rng(9)
    c = 19 if out in (None, 19) else 7
    x = np.eye(c, dtype=np.float32)[rng.integers(0, c, (2, 64, 256))]
    jmod = JE.SpatialRescaler(n_stages=1, method=method, out_channels=out, wh_factors=factors)
    params = random_flax_params(jmod.init, 10, jax.random.key(0), jnp.asarray(x))
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    port = _load(PE.SpatialRescaler(1, method, out_channels=out, wh_factors=factors,
                                    in_channels=c),
                 CV.cond_stage_state_dict(params))
    with torch.no_grad():
        got = port(_t(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * max(1.0, np.abs(want).max())


def test_spatial_rescaler_needs_antialias():
    """jax.image.resize antialiases when it shrinks: torch's plain bilinear
    is far off on a one-hot map at map2lidar's (0.25, 0.125)."""
    rng = np.random.default_rng(11)
    x = np.eye(19, dtype=np.float32)[rng.integers(0, 19, (2, 64, 1024))]
    jmod = JE.SpatialRescaler(n_stages=1, wh_factors=(0.25, 0.125))
    want = np.asarray(jmod.apply({}, jnp.asarray(x)))
    plain = F.interpolate(_t(x).permute(0, 3, 1, 2), size=(16, 128), mode="bilinear",
                          antialias=False).permute(0, 2, 3, 1).numpy()
    with torch.no_grad():
        got = PE.SpatialRescaler(1, wh_factors=(0.25, 0.125))(_t(x)).numpy()
    assert np.abs(got - want).max() <= 1e-6
    assert np.abs(plain - want).max() > 0.1


def test_class_embedder_matches_jax():
    y = np.array([0, 3, 7])
    jmod = JE.ClassEmbedder(embed_dim=16, n_classes=8)
    params = random_flax_params(jmod.init, 12, jax.random.key(0), jnp.asarray(y))
    port = _load(PE.ClassEmbedder(16, 8), CV.cond_stage_state_dict(params))
    with torch.no_grad():
        got = port(_t(y).long()).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmod.apply(params, jnp.asarray(y))))


def test_bert_tokenize_fallback_equals_jax():
    texts = ["A car turns left", "", "pedestrians " * 100, "Ünïcode words here"]
    np.testing.assert_array_equal(PE.bert_tokenize(texts), JE.bert_tokenize(texts))
    assert PE.bert_tokenize(["x"]).dtype == np.int32


@pytest.mark.parametrize("bert", [False, True])
def test_transformer_and_bert_embedders_match_jax(bert):
    tokens = PE.bert_tokenize(["a wide road", "two parked trucks near a wall"], 16) % 1000
    kw = dict(n_embed=32, n_layer=2, vocab_size=1000, max_seq_len=16)
    jmod = JE.BERTEmbedder(**kw) if bert else JE.TransformerEmbedder(heads=4, **kw)
    params = random_flax_params(jmod.init, 13, jax.random.key(0), jnp.asarray(tokens))
    want = jmod.apply(params, jnp.asarray(tokens))
    port = PE.BERTEmbedder(**kw) if bert else PE.TransformerEmbedder(heads=4, **kw)
    _load(port, CV.cond_stage_state_dict(params))
    with torch.no_grad():
        got = port(_t(tokens).long())
    assert rel_l2(got.numpy(), want) < TOL


def test_registry_builds_the_conditioning_stages():
    built = {t: PC.instantiate_from_config({"target": t, "params": p}) for t, p in (
        ("class_embedder", {"embed_dim": 8, "n_classes": 3}),
        ("lidm.modules.encoders.modules.SpatialRescaler",
         {"n_stages": 2, "out_channels": 4, "in_channels": 19}),
        ("bert_embedder", {"n_embed": 16, "n_layer": 1}),
        ("transformer_embedder", {"n_embed": 16, "n_layer": 1}))}
    assert isinstance(built["class_embedder"], PE.ClassEmbedder)
    assert built["lidm.modules.encoders.modules.SpatialRescaler"].channel_mapper.weight.shape \
        == (4, 19, 1, 1)
    assert isinstance(built["bert_embedder"], PE.BERTEmbedder)
    assert len(built["transformer_embedder"].layers) == 1
    for target in ("clip_text", "clip_multi_text", "clip_multi_image"):
        assert target in PC.REGISTRY and \
            "lidm.modules.encoders.modules.FrozenClipMultiImageEmbedder" in PC.REGISTRY
    xt = PC.instantiate_from_config({"target": "bert_embedder", "params": {
        "backend": "x_transformer", "n_embed": 16, "n_layer": 1, "heads": 2,
        "attn_flags": {"macaron": True}}})
    assert isinstance(xt, PE.XTransformerBERTEmbedder) and xt.transformer.attn_layers.macaron
    ldm = PC.instantiate_from_config({"target": "latent_diffusion", "params": {
        "image_size": [4, 16], "channels": 2, "conditioning_key": "adm",
        "unet_config": {"target": "unet", "params": dict(UNET, in_channels=2, num_classes=3)},
        "cond_stage_config": {"target": "class_embedder",
                              "params": {"embed_dim": 8, "n_classes": 3}}}})
    assert isinstance(ldm.cond_stage_model, PE.ClassEmbedder) and ldm.unet.label_emb.num_embeddings == 3


def test_conditional_builders_equal_jax():
    rng = np.random.default_rng(14)
    anns_j, anns_p = [], []
    for i in range(5):
        box = tuple(float(v) for v in rng.uniform(0, 1, 4))
        center = None if i % 2 else tuple(float(v) for v in rng.uniform(0, 1, 2))
        anns_j.append(JB.Annotation(i, box, center))
        anns_p.append(PB.Annotation(i, box, center))
    for cls in ("ObjectsBoundingBoxBuilder", "ObjectsCenterPointsBuilder"):
        for n_max in (3, 8):
            jb, pb = getattr(JB, cls)(10, 64, n_max), getattr(PB, cls)(10, 64, n_max)
            np.testing.assert_array_equal(pb.build(anns_p), jb.build(anns_j))
    box = PB.ObjectsBoundingBoxBuilder(10, 64, 8)
    tokens = box.build(anns_p)
    assert [a.category_id for a in box.inverse_build(tokens)] == \
        [a.category_id for a in JB.ObjectsBoundingBoxBuilder(10, 64, 8).inverse_build(tokens)]
    assert box.embedding_dim == 75 and PB.tokenize_coord(1.2, 64) == JB.tokenize_coord(1.2, 64)


# ---------------------------------------------------------------- classifier
def test_noisy_latent_classifier_loss_and_guidance_match_jax():
    ccfg = dict(in_channels=8, model_channels=32, num_classes=5, channel_mult=(1, 2))
    jclf = JC.NoisyLatentClassifier(JC.ClassifierConfig(**ccfg))
    params = random_flax_params(lambda k: jclf.init(k, (4, 16, 8)), 15, jax.random.key(0))
    port = PCL.NoisyLatentClassifier(PCL.ClassifierConfig(**ccfg))
    _load(port.net, CV.classifier_state_dict(params))
    rng = np.random.default_rng(16)
    z0 = rng.standard_normal((3, 4, 16, 8)).astype(np.float32)
    labels = np.array([0, 4, 2])
    key = jax.random.key(2)
    want, _ = jax.jit(jclf.loss)(params, key, jnp.asarray(z0), jnp.asarray(labels))
    r_t, r_n = jax.random.split(key)
    t = np.asarray(jax.random.randint(r_t, (3,), 0, 1024))
    noise = np.asarray(jax.random.normal(r_n, z0.shape))
    got, logs = port.loss(_t(z0), _t(labels).long(), t=_t(t).long(), noise=_t(noise))
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))
    assert 0.0 <= float(logs["acc"]) <= 1.0
    zt = rng.standard_normal((3, 4, 16, 8)).astype(np.float32)
    tt = np.array([5, 300, 1000])
    want_g = jax.jit(jclf.guidance_grad)(params, jnp.asarray(zt), jnp.asarray(tt),
                                         jnp.asarray(labels))
    got_g = port.guidance_grad(_t(zt), _t(tt).long(), _t(labels).long())
    assert got_g.shape == zt.shape and rel_l2(got_g.numpy(), want_g) < TOL


# ------------------------------------------------------------- end to end
def test_map2lidar_end_to_end_matches_jax(tmp_path):
    n = 2
    _, image, _ = sample_cond.sizes(True)
    stage_kw = dict(n_stages=1, out_channels=sample_cond.NUM_SEM, wh_factors=(0.25, 0.125))
    jmodel, params = jax_cond_ldm("concat", JE.SpatialRescaler(**stage_kw), 8 + 19, None,
                                   jnp.zeros((1, *image[:2], sample_cond.NUM_SEM)))
    port = sample_cond.build_task_model("map2lidar", tiny=True, device="cpu")
    cond_in = sample_cond.synthetic_conditions("map2lidar", n, tiny=True)
    assert cond_in.shape == (n, 16, 128, 19) and (cond_in.sum(-1) == 1).all()
    cond_end_to_end(jmodel, params, port, "c_concat", cond_in, n)
    out = sample_cond.main(["--task", "map2lidar", "--tiny", "--device", "cpu", "--steps", "2",
                            "-n", "2", "--outdir", str(tmp_path)])
    saved = np.load(tmp_path / "map2lidar_samples.npy")
    assert saved.shape == (2, 16, 128, 1) and np.array_equal(saved, out["samples"])
