"""PyTorch port vs the JAX package: x-transformers, the BERT embedder over it,
the BERT-conditioned LiDM's training step, and every resize method.

``encoders/x_transformer``: a ``TransformerWrapper`` over an ``Encoder`` (or
a ``Decoder`` for the causal mask) with each feature flag on in turn
(talking heads, sparse top-k, memory key/values under a padding mask,
macaron, rezero, GRU gating, position-infused attention, the causal mask,
scale and RMS norms, post-norm, GEGLU, tied embeddings, memory tokens
with an embedding projection) and an
``AttentionLayers`` with cross-attention and a context mask: outputs within
1e-5 of the largest. ``XTransformerBERTEmbedder`` through both registries
(``backend: x_transformer``). The crossattn LiDM of JAX's
``tests/test_xt_consumer.py`` (``_lidm_cfg``, a 1-layer BERT, the trained
set U-Net + BERT): loss within 1e-5 relative, U-Net and BERT gradients
within 1e-5 of their largest (rtol 1e-3) at fixed t and noise against
``jax.value_and_grad``, then one port training step (the BERT's weights
move, EMA over both; other text, other loss). ``encoders/modules.resize``
for every method ``jax.image.resize`` takes, shrinking and growing, and
``SpatialRescaler`` with a channel mapper: within 1e-5 absolute (each
name of one kernel gives the same weights). JAX trees
come from ``random_flax_params`` and cross through ``utils/convert``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_layout_tpu.config import instantiate_from_config as jax_instantiate
from lidar_layout_tpu.encoders import modules as JM
from lidar_layout_tpu.encoders import x_transformer as JX
from lidar_layout_tpu.train.diffusion_trainer import trainable_keys as jax_trainable_keys
from lidar_layout_tpu_torch.config import instantiate_from_config
from lidar_layout_tpu_torch.encoders import modules as PM
from lidar_layout_tpu_torch.encoders import x_transformer as PX
from lidar_layout_tpu_torch.train import diffusion_trainer as DT
from lidar_layout_tpu_torch.utils.convert import (cond_stage_state_dict,
                                                  latent_diffusion_state_dict, unet_state_dict)
from test_xt_consumer import _lidm_cfg
from torch_port_helpers import one_intra_op_thread, random_flax_params

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)

XT_TOL = 1e-5        # of the largest output
LOSS_TOL = 1e-5      # relative
GRAD_TOL = 1e-5      # of the largest gradient, rtol 1e-3
RESIZE_TOL = 1e-5    # absolute

VOCAB, DIM = 50, 32
TOKENS = np.random.default_rng(0).integers(0, VOCAB, (2, 12)).astype(np.int32)
MASK = np.arange(12)[None, :].repeat(2, 0) < np.array([[12], [9]])

# name -> (AttentionLayers kwargs, TransformerWrapper kwargs, with the padding mask)
FLAGS = {
    "plain": ({}, {}, False),
    "talking_heads": ({"attn_talking_heads": True}, {}, True),
    "sparse_topk": ({"attn_sparse_topk": 4}, {}, False),
    "memory_kv": ({"attn_num_mem_kv": 3}, {}, True),
    "macaron": ({"macaron": True}, {}, False),
    "rezero_tied": ({"use_rezero": True}, {"tie_embedding": True}, False),
    "gate_residual": ({"gate_residual": True}, {}, False),
    "position_infused": ({"position_infused_attn": True}, {}, False),
    "causal": ({"causal": True, "attn_num_mem_kv": 2}, {}, False),
    "scale_norm_post": ({"norm": "scale", "pre_norm": False}, {}, False),
    "rms_norm_glu": ({"norm": "rms", "ff_glu": True}, {}, False),
    "memory_tokens_projected": ({}, {"num_memory_tokens": 2, "emb_dim": 16}, True),
}


def _xt_pair(layers_kw, wrap_kw, seed):
    causal = layers_kw.pop("causal", False)
    jcls, pcls = (JX.Decoder, PX.Decoder) if causal else (JX.Encoder, PX.Encoder)
    common = dict(dim=DIM, depth=2, heads=4, dim_head=8)
    jm = JX.TransformerWrapper(num_tokens=VOCAB, max_seq_len=16,
                               attn_layers=jcls(**common, **layers_kw), **wrap_kw)
    pm = PX.TransformerWrapper(num_tokens=VOCAB, max_seq_len=16,
                               attn_layers=pcls(**common, **layers_kw), **wrap_kw)
    return jm, pm


@pytest.mark.parametrize("flag", list(FLAGS))
def test_x_transformer_with_each_flag_matches_jax(flag):
    layers_kw, wrap_kw, masked = FLAGS[flag]
    jm, pm = _xt_pair(dict(layers_kw), wrap_kw, 0)
    mask = jnp.asarray(MASK) if masked else None
    params = random_flax_params(jm.init, 1, jax.random.key(0), jnp.asarray(TOKENS), mask)
    pm.load_state_dict(cond_stage_state_dict(jax.tree.map(np.asarray, params)))
    want = np.asarray(jm.apply(params, jnp.asarray(TOKENS), mask))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(TOKENS),
                        None if mask is None else torch.from_numpy(MASK)).numpy()
    assert got.shape == want.shape == (2, 12, VOCAB) and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=XT_TOL * np.abs(want).max(), rtol=0)


def test_cross_attention_layers_with_a_context_mask_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 10, DIM)).astype(np.float32)
    ctx = rng.normal(size=(2, 7, 24)).astype(np.float32)
    cmask = np.arange(7)[None].repeat(2, 0) < np.array([[7], [4]])
    kw = dict(dim=DIM, depth=2, heads=4, dim_head=8, cross_attend=True, attn_talking_heads=True)
    jm = JX.Encoder(**kw)
    args = (jnp.asarray(x), jnp.asarray(ctx), None, jnp.asarray(cmask))
    params = random_flax_params(jm.init, 3, jax.random.key(0), *args)
    pm = PX.Encoder(**kw, context_dim=24)
    pm.load_state_dict(cond_stage_state_dict(jax.tree.map(np.asarray, params)))
    want = np.asarray(jm.apply(params, *args))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(ctx), None,
                 torch.from_numpy(cmask)).numpy()
    np.testing.assert_allclose(got, want, atol=XT_TOL * np.abs(want).max(), rtol=0)


def test_xt_bert_embedder_through_both_registries_matches_jax():
    cfg = {"target": "bert_embedder",
           "params": {"n_embed": 32, "n_layer": 2, "max_seq_len": 16, "heads": 4,
                      "backend": "x_transformer",
                      "attn_flags": {"macaron": True, "attn_talking_heads": True,
                                     "gate_residual": True}}}
    jm, pm = jax_instantiate(cfg), instantiate_from_config(cfg)
    assert isinstance(jm, JM.XTransformerBERTEmbedder)
    assert isinstance(pm, PM.XTransformerBERTEmbedder)
    # the port's bert_tokenize is JAX's fallback (held in test_torch_cond.py);
    # JAX's first tries to load transformers' WordPiece tokenizer, which
    # takes seconds to import
    toks = PM.bert_tokenize(["a car on a wet road", "an empty intersection"], max_len=16)
    params = random_flax_params(jm.init, 4, jax.random.key(0), jnp.asarray(toks))
    pm.load_state_dict(cond_stage_state_dict(jax.tree.map(np.asarray, params)))
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(toks)))
    with torch.no_grad():
        got = pm(torch.from_numpy(toks)).numpy()
    assert got.shape == (2, 16, 32)
    np.testing.assert_allclose(got, want, atol=XT_TOL * np.abs(want).max(), rtol=0)


# ---------------------------------------------- the BERT-conditioned LiDM step
BERT = {"n_embed": 32, "n_layer": 1, "max_seq_len": 12, "heads": 4, "backend": "x_transformer"}
TEXTS = (["a car on a wet road", "an empty intersection"],
         ["heavy traffic at night", "a parked truck"])
IMAGE = (16, 64, 1)


@pytest.fixture(scope="module")
def lidm_pair():
    cfg = _lidm_cfg(BERT)
    jmodel = jax_instantiate(cfg)
    toks = jnp.asarray(PM.bert_tokenize(TEXTS[0], max_len=12))
    params = random_flax_params(lambda k: jmodel.init(k, image_shape=IMAGE, cond_example=toks),
                                5, jax.random.key(0))
    params["logvar"] = jnp.zeros_like(params["logvar"])
    port = instantiate_from_config(cfg)
    port.load_state_dict(latent_diffusion_state_dict(jax.tree.map(np.asarray, params),
                                                     port.unet.cfg))
    return jmodel, params, port


def test_bert_conditioned_lidm_loss_and_gradients_match_jax(lidm_pair):
    jmodel, params, port = lidm_pair
    keys = jax_trainable_keys(jmodel)
    assert keys == ("unet", "cond_stage") == DT.trainable_keys(port)
    toks = PM.bert_tokenize(TEXTS[0], max_len=12)
    z = np.random.default_rng(6).standard_normal((2, 16, 32, 4)).astype(np.float32)
    t = np.array([3, 27])
    key = jax.random.key(7)
    noise = np.array(jax.random.normal(key, z.shape))    # deterministic p_losses: key unsplit

    def loss_fn(train):
        p = {**params, **train}
        cond = jmodel.get_learned_conditioning(p, jnp.asarray(toks))
        return jmodel.p_losses(p, key, jnp.asarray(z), cond, jnp.asarray(t),
                               deterministic=True)[0]

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))({k: params[k] for k in keys})
    port.eval().zero_grad(set_to_none=True)
    loss, _ = port.p_losses(torch.from_numpy(z), torch.from_numpy(t), torch.from_numpy(noise),
                            port.batch_conditioning({"cond": torch.from_numpy(toks)}))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_TOL)
    for part, ref, module in (
            ("unet", unet_state_dict(jax.tree.map(np.asarray, want["unet"]), port.unet.cfg),
             port.unet),
            ("cond_stage", cond_stage_state_dict(jax.tree.map(np.asarray, want["cond_stage"])),
             port.cond_stage_model)):
        got = {n: p.grad for n, p in module.named_parameters()}
        assert sorted(got) == sorted(ref), part
        gmax = max(float(np.abs(v.numpy()).max()) for v in ref.values())
        assert gmax > 1e-4, part
        for n in ref:
            assert got[n] is not None, f"{part} {n}: no gradient"
            np.testing.assert_allclose(got[n].numpy(), ref[n].numpy(), atol=GRAD_TOL * gmax,
                                       rtol=1e-3, err_msg=f"{part} {n}")


def test_bert_conditioned_lidm_train_step_moves_the_bert(lidm_pair):
    _, _, port = lidm_pair
    params = DT.trainable_params(port)
    bert = {k for k in params if k.startswith("cond_stage_model.")}
    assert bert and set(params) - bert and not any(k.startswith("first_stage_model.")
                                                   for k in params)
    state = DT.create_train_state(port, DT.make_optimizer(params, 1e-3), params)
    assert set(state.ema.params) == set(params)
    before = {k: params[k].detach().clone() for k in bert}
    image = torch.from_numpy(np.random.default_rng(8).uniform(-1, 1, (2, *IMAGE))
                             .astype(np.float32))
    losses = []
    for text in TEXTS:
        gen = torch.Generator().manual_seed(0)
        batch = {"image": image, "cond": torch.from_numpy(PM.bert_tokenize(text, max_len=12))}
        state, logs = DT.make_train_step(port)(state, batch, gen)
        losses.append(float(logs["loss"]))
    assert np.isfinite(losses).all() and losses[0] != losses[1]
    assert all(float((params[k].detach() - before[k]).abs().max()) > 0 for k in bert)


# ------------------------------------------------------------------ resizing
# jax.image.resize's names: the aliases of one kernel share its weights
RESIZE_ALIASES = {"linear": ("bilinear", "trilinear", "triangle"),
                  "cubic": ("bicubic", "tricubic"), "nearest": (), "lanczos3": (),
                  "lanczos5": ()}


@pytest.mark.parametrize("method", list(RESIZE_ALIASES))
def test_resize_matches_jax_image_resize_shrinking_and_growing(method):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 32, 96, 3)).astype(np.float32)
    for size in ((8, 12), (45, 130), (32, 40)):      # shrink, grow, one axis alone
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *size, 3), method=method))
        got = PM.resize(torch.from_numpy(x), size, method).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=RESIZE_TOL, rtol=0, err_msg=str(size))
        for alias in RESIZE_ALIASES[method]:
            np.testing.assert_array_equal(PM.resize(torch.from_numpy(x), size, alias).numpy(),
                                          got, err_msg=alias)
    assert set(PM.RESIZE_METHODS) == set(RESIZE_ALIASES) | {
        a for v in RESIZE_ALIASES.values() for a in v}


@pytest.mark.parametrize("method", ["bicubic", "lanczos3"])
def test_spatial_rescaler_with_a_channel_mapper_matches_jax(method):
    onehot = np.eye(5, dtype=np.float32)[np.random.default_rng(10).integers(0, 5, (2, 32, 128))]
    cfg = {"target": "spatial_rescaler",
           "params": {"n_stages": 2, "method": method, "out_channels": 3,
                      "wh_factors": [0.5, 0.25], "in_channels": 5}}
    jm = jax_instantiate(cfg)
    params = random_flax_params(jm.init, 11, jax.random.key(0), jnp.asarray(onehot))
    pm = instantiate_from_config(cfg)
    pm.load_state_dict(cond_stage_state_dict(jax.tree.map(np.asarray, params)))
    want = np.asarray(jm.apply(params, jnp.asarray(onehot)))
    with torch.no_grad():
        got = pm(torch.from_numpy(onehot)).numpy()
    assert got.shape == want.shape == (2, 8, 8, 3)
    np.testing.assert_allclose(got, want, atol=RESIZE_TOL, rtol=0)
