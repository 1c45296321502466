"""PyTorch port vs the JAX package: LayoutDiffusion (scene graph -> boxes).

At small widths (U-Net 64 channels, scene-graph embedding 16, relation token
96) and 2 scenes of up to 4 objects, the JAX model is initialised, every
weight moved off its initial value (so the zero-initialised projections do
not hide the attention), and the tree carried to the port by
``utils/convert.layout_diffusion_state_dict``. Both then run the graph conv,
the scene-graph encoder, the attention blocks, one U-Net eval, the loss at
fixed t and noise, and a DDIM-4 request from the same x_T, on the CPU in
float32, on the same numpy inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lidar_layout_tpu.data.layout_synthetic import synthetic_graph_batch as jax_graph_batch
from lidar_layout_tpu.encoders.scene_graph import SceneGraphEncoder as JaxSGE
from lidar_layout_tpu.models.layout_diffusion import LayoutDiffusion as JaxLD
from lidar_layout_tpu.models.layout_diffusion import LayoutDiffusionConfig as JaxLDC
from lidar_layout_tpu.models.unet1d import UNet1DConfig as JaxU1C
from lidar_layout_tpu.nn import attention as JA
from lidar_layout_tpu.nn.graph import GraphTripleConv as JaxGTC
from lidar_layout_tpu_torch.data.layout_synthetic import synthetic_graph_batch
from lidar_layout_tpu_torch.encoders.scene_graph import SceneGraphEncoder, graph_tensors
from lidar_layout_tpu_torch.models import unet1d as U1
from lidar_layout_tpu_torch.models.layout_diffusion import (LayoutDiffusion,
                                                            LayoutDiffusionConfig)
from lidar_layout_tpu_torch.nn import attention as PA
from lidar_layout_tpu_torch.nn.graph import GraphTripleConv
from lidar_layout_tpu_torch.utils.convert import layout_diffusion_state_dict
from torch_port_helpers import one_intra_op_thread, random_flax_params

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
UNET = dict(model_channels=64, num_heads=8, concat_dim=96, crossattn_dim=96)
SG_DIM = 16
# f32 on one CPU, other summation orders: the encoder and the attention
# blocks, a few layers deep, to 1e-5; one U-Net eval (~40 layers) to 2.5e-6,
# where its error reads 1.0e-6 at |out| 0.87 and an erf GELU's 1.3e-5; the
# loss and a DDIM-4 request, which amplifies the U-Net's differences, to 1e-4
TOL = 1e-5
UNET_TOL = 2.5e-6
SAMPLE_TOL = 1e-4


def _graph(seed=0, **kw):
    return synthetic_graph_batch(np.random.default_rng(seed), n_scenes=2, max_objs_per_scene=4,
                                 max_triples_per_scene=6, **kw)


def _random_tree(module, seed, *args, **kw):
    return random_flax_params(module.init, seed, *args, **kw)


def _port_sd(tree, part="unet"):
    """A flax tree of one module -> the port module's state_dict."""
    sd = layout_diffusion_state_dict({"unet": {}, "cond_stage": {},
                                      part: jax.tree.map(np.asarray, tree)})
    return {k[len(part) + 1:]: v for k, v in sd.items()}


def _j(graph):
    return {k: jnp.asarray(v) for k, v in graph.items()}


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, np.abs(want).max()), rtol=tol,
                               err_msg=what)


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxLD(JaxLDC(), JaxU1C(**UNET), sg_embedding_dim=SG_DIM)
    g = _j(_graph())
    params = _random_tree(jmodel, 0, jax.random.key(0), g)
    port = LayoutDiffusion(LayoutDiffusionConfig(), U1.UNet1DConfig(**UNET),
                           sg_embedding_dim=SG_DIM).eval()
    port.load_state_dict(layout_diffusion_state_dict(jax.tree.map(np.asarray, params)))
    return jmodel, params, port


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("with_changes", [False, True])
def test_synthetic_graph_batch_draws_as_jax(with_changes):
    kw = dict(n_scenes=3, max_objs_per_scene=5, max_triples_per_scene=7,
              with_changes=with_changes)
    want = jax_graph_batch(np.random.default_rng(9), **kw)
    got = synthetic_graph_batch(np.random.default_rng(9), **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------- graph conv
@pytest.mark.parametrize("masked", [True, False])
def test_graph_triple_conv_matches_jax_and_masks_padding(masked):
    rng = np.random.default_rng(1)
    n, t = 6, 5
    obj = rng.standard_normal((n, 12)).astype(np.float32)
    pred = rng.standard_normal((t, 10)).astype(np.float32)
    edges = np.array([[1, 2], [2, 3], [3, 1], [0, 0], [0, 0]], np.int32)
    mask = np.array([True, True, True, False, False]) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    # the settings LayoutDiffusion builds: average pooling, residual
    jconv = JaxGTC(12, 10, output_dim=9, hidden_dim=16, pooling="avg", residual=True)
    params = _random_tree(jconv, 1, jax.random.key(1), jnp.asarray(obj), jnp.asarray(pred),
                          jnp.asarray(edges), jm)
    want = jconv.apply(params, jnp.asarray(obj), jnp.asarray(pred), jnp.asarray(edges), jm)
    conv = GraphTripleConv(12, 10, output_dim=9, hidden_dim=16)
    conv.load_state_dict(_port_sd(params["params"]))
    args = [torch.from_numpy(a) for a in (obj, pred, edges.astype(np.int64))]
    with torch.no_grad():
        got = conv(*args, tm)
        pred2 = args[1].clone()
        pred2[3:] = 1e3
        again = conv(args[0], pred2, args[2], tm)
    for g_, w_ in zip(got, want):
        _close(g_, w_)
    if masked:
        # whatever the padding rows hold, node 0 (their target) sees nothing
        # of it; nodes 0, 4 and 5 have no real triple: net2 of zeros plus
        # their residual
        np.testing.assert_array_equal(again[0].numpy(), got[0].numpy())
        zero = conv.net2(torch.zeros(1, 16)) + conv.proj_obj(args[0][[0, 4, 5]])
        _close(got[0][[0, 4, 5]], zero.detach().numpy())
    else:      # unmasked, the two triples on node 0 count
        assert np.abs(again[0].numpy()[0] - got[0].numpy()[0]).max() > 1e-3


# ------------------------------------------------------ scene-graph encoder
@pytest.mark.parametrize("with_changes,replace_latent", [(False, True), (True, True),
                                                          (True, False)])
def test_scene_graph_encoder_matches_jax(with_changes, replace_latent):
    graph = _graph(2, with_changes=with_changes)
    if with_changes:
        graph["enc_to_dec"][5] = -1          # an added node: a zero latent
    kw = dict(num_objs=32, num_preds=16, embedding_dim=SG_DIM, replace_latent=replace_latent)
    jenc = JaxSGE(**kw, residual=True)      # as LayoutDiffusion builds it
    key = jax.random.key(4)
    params = _random_tree(jenc, 2, {"params": jax.random.key(5), "change": key}, _j(graph))
    want = jenc.apply(params, _j(graph), rng=key)
    noise = np.array(jax.random.normal(key, (graph["dec_objs"].shape[0], SG_DIM)))
    enc = SceneGraphEncoder(**kw)
    enc.load_state_dict(_port_sd(params["params"], "cond_stage"))
    with torch.no_grad():
        got = enc(graph, change_noise=torch.from_numpy(noise))
        quiet = enc(graph)                   # no noise given and no generator: zeros
    assert (graph["changed_mask"].any() or (graph["enc_to_dec"] < 0).any()) == with_changes
    for g_, w_ in zip(got, want):
        _close(g_, w_)
    if with_changes:
        assert np.abs(quiet[0].numpy() - got[0].numpy()).max() > 1e-4
        if not replace_latent:   # untouched nodes keep the encoder's latent
            touched = (graph["enc_to_dec"] < 0) | graph["changed_mask"]
            latent_ec = enc.gconv_net_ec(
                *_ec_inputs(enc, graph))[0][graph["enc_to_dec"][~touched]]
            _close(got[0][torch.from_numpy(~touched)], latent_ec.detach().numpy())


def _ec_inputs(enc, graph):
    g = graph_tensors(graph, "cpu")
    tri = g["enc_triples"]
    obj = torch.cat([g["enc_text_feat"], enc.obj_embeddings_ec(g["enc_objs"])], -1)
    pred = torch.cat([g["enc_rel_feat"], enc.pred_embeddings_ec(tri[:, 1])], -1)
    return obj, pred, tri[:, [0, 2]], g["enc_pred_mask"]


# --------------------------------------------------------- attention blocks
@pytest.mark.parametrize("case", ["S = 1, as the U-Net", "cross-length"])
def test_cross_attention_and_transformer_block_match_jax(case):
    rng = np.random.default_rng(3)
    b, n, s = (6, 1, 1) if case.startswith("S = 1") else (2, 5, 7)
    x = rng.standard_normal((b, n, 32)).astype(np.float32)
    ctx = rng.standard_normal((b, s, 24)).astype(np.float32)
    jattn = JA.CrossAttention(heads=4, dim_head=8)
    p = _random_tree(jattn, 3, jax.random.key(2), jnp.asarray(x), jnp.asarray(ctx))
    attn = PA.CrossAttention(32, 24, heads=4, dim_head=8)
    attn.load_state_dict(_port_sd(p["params"]))
    jblock = JA.BasicTransformerBlock(heads=4, dim_head=8)
    pb = _random_tree(jblock, 4, jax.random.key(3), jnp.asarray(x), jnp.asarray(ctx))
    block = PA.BasicTransformerBlock(32, 4, 8, context_dim=24)
    block.load_state_dict(_port_sd(pb["params"]))
    with torch.no_grad():
        _close(attn(torch.from_numpy(x), torch.from_numpy(ctx)),
               jattn.apply(p, jnp.asarray(x), jnp.asarray(ctx)), what="cross")
        _close(block(torch.from_numpy(x), torch.from_numpy(ctx)),
               jblock.apply(pb, jnp.asarray(x), jnp.asarray(ctx)), what="block")


# ---------------------------------------------------------------- the U-Net
@pytest.fixture(scope="module")
def unet_case(pair):
    """One U-Net eval's inputs (port tensors) and JAX's output."""
    jmodel, params, port = pair
    graph = _graph()
    latent, obj_embed = jmodel.encode_graph(params, _j(graph), jax.random.key(1))
    rng = np.random.default_rng(7)
    box_t = rng.standard_normal((8, 8)).astype(np.float32)
    t = rng.integers(0, 1000, 8)
    want = np.asarray(jax.jit(jmodel.apply_model)(
        params, jnp.asarray(box_t), jnp.asarray(t), obj_embed, jnp.asarray(graph["dec_triples"]),
        latent, jnp.asarray(graph["dec_pred_mask"])))
    g = graph_tensors(graph, "cpu")
    args = (torch.from_numpy(box_t), torch.from_numpy(t), torch.from_numpy(np.array(obj_embed)),
            g["dec_triples"], torch.from_numpy(np.array(latent)), g["dec_pred_mask"])
    return args, want


def test_unet1d_eval_matches_jax(pair, unet_case):
    port = pair[2]
    args, want = unet_case
    with torch.no_grad():
        got = port.apply_model(*args).numpy()
        # the relation token is live: other object embeddings, other output
        other = port.apply_model(args[0], args[1], args[2].flip(0), *args[3:]).numpy()
    assert np.abs(want).max() > 0.1 and np.abs(other - got).max() > 1e-3
    _close(got, want, UNET_TOL)


@pytest.mark.parametrize("fault", ["erf GELU", "Norm32 with 32 groups"])
def test_torch_defaults_fail_the_unet_comparison(pair, unet_case, monkeypatch, fault):
    port = pair[2]
    args, want = unet_case
    if fault == "erf GELU":
        gelu = F.gelu
        monkeypatch.setattr(F, "gelu", lambda h, approximate="none": gelu(h))
    else:
        monkeypatch.setattr(U1, "norm32_groups", lambda c: min(32, c))
    wrong = LayoutDiffusion(LayoutDiffusionConfig(), U1.UNet1DConfig(**UNET),
                            sg_embedding_dim=SG_DIM).eval()
    wrong.load_state_dict(port.state_dict())
    with torch.no_grad():
        got = wrong.apply_model(*args).numpy()
    # the error over the comparison's tolerance: above 1 the comparison fails
    worst = (np.abs(got - want).max()
             / (UNET_TOL * max(1.0, np.abs(want).max()) + UNET_TOL * np.abs(want).max()))
    assert worst > 2, f"{fault}: the wrong U-Net passed the comparison ({worst:.2f})"


def test_p_losses_at_fixed_t_and_noise_matches_jax(pair):
    jmodel, params, port = pair
    graph = _graph(1)                        # 5 boxes and 3 padding slots
    key = jax.random.key(8)
    # n_scenes as a Python int, so that the loss traces under jit
    want, logs = jax.jit(lambda p, k, g: jmodel.p_losses(p, k, {**g, "n_scenes": 2}))(
        params, key, {k: v for k, v in _j(graph).items() if k != "n_scenes"})
    # p_losses splits its key in three: conditioning, per-scene t, noise
    _, r_t, r_noise = jax.random.split(key, 3)
    t_scene = np.array(jax.random.randint(r_t, (2,), 0, 1000))
    noise = np.array(jax.random.normal(r_noise, (8, 8)))
    with torch.no_grad():
        got, plogs = port.p_losses(graph, t_scene=torch.from_numpy(t_scene),
                                   noise=torch.from_numpy(noise))
        # padding boxes are out of the loss: noise there changes nothing
        pad = ~graph["obj_mask"]
        noise2 = noise.copy()
        noise2[pad] = 5.0
        same = port.p_losses(graph, t_scene=torch.from_numpy(t_scene),
                             noise=torch.from_numpy(noise2))[0]
    assert pad.any() and float(same) == float(got)
    np.testing.assert_allclose(float(got), float(want), rtol=SAMPLE_TOL)
    np.testing.assert_allclose(float(plogs["loss_simple"]), float(logs["loss_simple"]),
                               rtol=SAMPLE_TOL)


def test_ddim4_request_and_postprocess_match_jax(pair):
    jmodel, params, port = pair
    graph = _graph(5)
    key = jax.random.key(11)
    # the JAX sampler draws x_T from split(split(key)[1])[1]
    x_T = np.array(jax.random.normal(jax.random.split(jax.random.split(key)[1])[1], (8, 8)))
    want = np.asarray(jmodel.ddim_sample(params, key, _j(graph), steps=4))
    got = port.ddim_sample(graph, steps=4, x_T=torch.from_numpy(x_T))
    _close(got, want, SAMPLE_TOL, "boxes8")
    _close(port.postprocess_boxes(got), jmodel.postprocess_boxes(jnp.asarray(got.numpy())),
           TOL, "boxes7")
    other = port.ddim_sample(_graph(6), steps=4, x_T=torch.from_numpy(x_T))
    assert np.abs(other.numpy() - got.numpy()).max() > 1e-3
    with pytest.raises(ValueError, match="x_T"):
        port.ddim_sample(graph, steps=2, x_T=torch.zeros(3, 8))


def test_config_builds_layout_nusc_yaml():
    import pathlib

    from lidar_layout_tpu_torch.config import instantiate_from_config, load_yaml

    root = pathlib.Path(__file__).resolve().parent.parent
    cfg = load_yaml(str(root / "configs/layout_diffusion/nuscenes/layout_nusc.yaml"))
    cfg["model"]["params"]["vocab"] = {"num_objs": 32, "num_preds": 16}
    model = instantiate_from_config(cfg["model"])
    assert isinstance(model, LayoutDiffusion)
    ucfg = model.unet.cfg
    assert (ucfg.model_channels, ucfg.channel_mult, ucfg.attention_resolutions,
            ucfg.num_heads, ucfg.concat_dim) == (512, (1, 1, 1, 1), (4, 2), 8, 1280)
    assert model.cond_stage.out_dim == 640 and model.cfg.timesteps == 1000
    blocks = [m for m in model.unet.modules() if isinstance(m, U1.Transformer1D)]
    assert len(blocks) == 11
    assert dataclasses.asdict(ucfg)["gconv_dim"] == 64


def test_sample_layout_cli_writes_jax_keys(tmp_path):
    import yaml

    from lidar_layout_tpu_torch import sample_layout as SL
    from lidar_layout_tpu_torch.config import load_yaml

    cfg = load_yaml(SL.LAYOUT_DIFFUSION_YAML)
    cfg["model"]["params"]["unet_config"]["params"].update(
        model_channels=64, concat_dim=96, crossattn_dim=96)
    cfg["model"]["params"]["cond_stage_config"]["params"]["embedding_dim"] = SG_DIM
    base = tmp_path / "tiny.yaml"
    base.write_text(yaml.safe_dump(cfg))
    out = SL.main(["-b", str(base), "--cpu", "-n", "2", "--steps", "2", "-s", "3",
                   "--outdir", str(tmp_path / "a")])
    saved = np.load(tmp_path / "a" / "layouts.npz")
    assert sorted(saved.files) == ["boxes", "classes", "obj_mask", "scene_ids"]
    n = 2 * SL.MAX_OBJS
    assert saved["boxes"].shape == (n, 7) and np.isfinite(saved["boxes"]).all()
    assert saved["scene_ids"].shape == saved["classes"].shape == saved["obj_mask"].shape == (n,)
    np.testing.assert_array_equal(saved["boxes"], out["boxes"])
    # the same weights from a state_dict file give the same boxes
    model = SL.build_model(str(base), "cpu", 3)
    torch.save(model.state_dict(), tmp_path / "w.pt")
    again = SL.main(["-b", str(base), "--cpu", "-n", "2", "--steps", "2", "-s", "3",
                     "-r", str(tmp_path / "w.pt"), "--outdir", str(tmp_path / "b")])
    np.testing.assert_array_equal(again["boxes"], out["boxes"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.cuda, "is_available", lambda: False)
            SL.main(["-b", str(base), "-n", "1", "--steps", "1", "--outdir", str(tmp_path)])
