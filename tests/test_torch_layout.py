"""PyTorch port vs the JAX package: the layout-conditioned range LiDM.

The tiny variant of ``configs/lidar_diffusion/nuscenes/layout_cond_c2_p4.yaml``
(``flagship.layout_config(tiny=True)``: 32x256 images, 8x32 latents) is built
by both packages from the same config dict. The JAX model is initialised with
an example layout, every weight is moved off its initial value (so the
zero-initialised projections do not leave the attention dead), and the tree
crosses to the port through ``utils/convert``. Both then run the layout
encoder, one object-aware cross-attention, the whole U-Net, and a guided
DDIM + decode on the same numpy inputs, on the CPU in float32.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lidar_layout_tpu.config import instantiate_from_config as jax_instantiate
from lidar_layout_tpu.data import factory as jax_factory
from lidar_layout_tpu.data import readers as JR
from lidar_layout_tpu.models import samplers as JS
from lidar_layout_tpu.models.object_cross_unet import \
    ObjectAwareCrossAttention as JaxAttention
from lidar_layout_tpu.ops import lidar as JL
from lidar_layout_tpu_torch.data import readers as PR
from lidar_layout_tpu_torch.data.synthetic import synthetic_layouts, synthetic_range_batch
from lidar_layout_tpu_torch.encoders import layout_encoder as LE
from lidar_layout_tpu_torch.flagship import layout_config, layout_flagship
from lidar_layout_tpu_torch.models import object_cross_unet as OU
from lidar_layout_tpu_torch.models import samplers as PS
from lidar_layout_tpu_torch.ops import lidar as PL
from lidar_layout_tpu_torch.pipeline import GenerationPipeline
from lidar_layout_tpu_torch.utils.convert import latent_diffusion_state_dict
from torch_port_helpers import nchw, nhwc, one_intra_op_thread, seed_weights

ROOT = pathlib.Path(__file__).resolve().parent.parent
_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)
CFG = layout_config(tiny=True)
IMAGE = (32, 256, 1)
SHAPE = (2, 8, 32, 8)           # batch 2 of the tiny model's 8x32x8 latent
GEOM = PL.NUSCENES_GEOMETRY
# one layout of synthetic boxes, and one whose slots are all padding
LAYOUTS = np.concatenate([synthetic_layouts(np.random.default_rng(5), 1, GEOM),
                          np.zeros((1, 13, 13), np.float32)])
ENC_TOL = 1e-5


def _perturbed(params, seed=3):
    """Every leaf plus 0.02 N(0, 1), and an N(0, 1) codebook (the taming
    +-1/n codebook gives nearest-code near-ties)."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(lambda a: np.asarray(a, np.float32)
                       + np.float32(0.02) * rng.standard_normal(a.shape, np.float32), params)
    q = out["first_stage"]["params"]["quantize"]
    q["embedding"] = rng.standard_normal(q["embedding"].shape).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_instantiate(CFG["model"])
    # compiled at optimisation level 0: a third less time on the CPU, the same draws
    params = jax.jit(lambda k: jmodel.init(k, IMAGE, cond_example=jnp.asarray(LAYOUTS))).lower(
        jax.random.key(0)).compile({"xla_backend_optimization_level": 0})(jax.random.key(0))
    params = _perturbed(params)
    port, image_shape = layout_flagship(tiny=True, device="cpu")
    assert image_shape == IMAGE
    port.load_state_dict(latent_diffusion_state_dict(params, port.unet.cfg))
    jparams = jax.tree.map(jnp.asarray, params)
    with torch.no_grad():
        cond = port.get_learned_conditioning(LAYOUTS)
    return jmodel, jparams, port, cond


def _np(tree):
    return {k: v.detach().numpy() for k, v in tree.items()}


def _jax_cond(cond):
    return {k: jnp.asarray(v.detach().numpy()) for k, v in cond.items()}


# ------------------------------------------------------------------ layouts
def test_build_layout13_matches_jax():
    rng = np.random.default_rng(0)
    k = 17     # more boxes than slots, one class the layout does not know
    boxes7 = np.stack([rng.uniform(-45, 45, k), rng.uniform(-45, 45, k), rng.uniform(-3, 1, k),
                       rng.uniform(0.5, 9, k), rng.uniform(0.5, 3, k), rng.uniform(0.5, 4, k),
                       rng.uniform(-np.pi, np.pi, k)], 1).astype(np.float32)
    names = [PR.NUSC_CLASS_NAMES[i % 8] for i in range(k)]
    names[3] = "barrier"
    jgeom = JL.LidarGeometry(size=(32, 1024), fov=(10.0, -30.0))
    args = ((-50, 50), (-50, 50), (-4, 2))
    got = PR.build_layout13(boxes7, names, GEOM, *args)
    want = JR.build_layout13(boxes7, names, jgeom, *args)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 12] > 0).all()     # 16 boxes kept, the first 13 fill the slots
    for empty in ((np.zeros((0, 7), np.float32), []), (boxes7[:2], ["barrier", "cone"])):
        np.testing.assert_array_equal(PR.build_layout13(*empty, GEOM, *args),
                                      np.zeros((13, 13), np.float32))
    np.testing.assert_array_equal(PR.box_corners_3d(boxes7), JR.box_corners_3d(boxes7))
    for got_a, want_a in zip(PR.project_coords_np(boxes7[:, :3], GEOM),
                             JR.project_coords_np(boxes7[:, :3], jgeom)):
        np.testing.assert_array_equal(got_a, want_a)


def test_synthetic_layouts_draw_as_jax():
    jgeom = JL.LidarGeometry(size=(32, 1024), fov=(10.0, -30.0))
    want = jax_factory._synthetic_layout_range_batch(np.random.default_rng(4), 2, jgeom)
    rng = np.random.default_rng(4)
    synthetic_range_batch(rng, 2, GEOM)           # the scenes come first, as in JAX
    got = synthetic_layouts(rng, 2, GEOM)
    np.testing.assert_array_equal(got, want["layout"])
    assert (got[..., 12] > 0).any(axis=1).all()


# --------------------------------------------------------------- the modules
def test_layout_encoder_matches_jax(pair):
    jmodel, params, _, cond = pair
    want = jmodel.get_learned_conditioning(params, jnp.asarray(LAYOUTS))
    got = _np(cond)
    assert sorted(got) == sorted(want) and len(got) == 8
    np.testing.assert_array_equal(got["key_padding_mask"], np.asarray(want["key_padding_mask"]))
    assert got["key_padding_mask"][0].any() and not got["key_padding_mask"][1].any()
    for k in sorted(got):
        assert got[k].shape == np.asarray(want[k]).shape, k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=ENC_TOL, rtol=ENC_TOL,
                                   err_msg=k)


def _attn_case(pair, name="in_1_0_attn"):
    jmodel, params, port, cond = pair
    block = getattr(port.unet, name)
    c = block.qkv.weight.shape[1]
    x = np.random.default_rng(6).standard_normal((2, 4, 16, c)).astype(np.float32)
    want = np.asarray(JaxAttention(block.heads, res_key=block.res_key).apply(
        {"params": params["unet"]["params"][name]}, jnp.asarray(x), _jax_cond(cond)))
    return block, x, cond, want


def test_object_aware_attention_matches_jax(pair):
    block, x, cond, want = _attn_case(pair)
    assert block.res_key == 4 and block.heads == 4
    with torch.no_grad():
        got = nhwc(block(nchw(x), cond))
        # the attention is live: its output moves with the layout
        other = nhwc(block(nchw(x), {**cond, "xf_out": cond["xf_out"].flip(0)}))
    assert np.abs(want - x).max() > 1e-2 and np.abs(other - got).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


class PerHeadSplit(OU.ObjectAwareCrossAttention):
    """A wrong port: each head takes [q_h | pos_h] instead of a slice of
    [q | pos] cut after the concatenation."""

    def forward(self, x, cond):
        b, c, h, w = x.shape
        l1, heads = h * w, self.heads
        y = self.norm_qkv(x).reshape(b, c, l1).transpose(1, 2)
        q, k, v = F.linear(y, self.qkv.weight[:, :, 0, 0], self.qkv.bias).split(c, dim=-1)
        img_pos = self.norm_img_pos(self.layout_position_proj(
            cond[f"image_patch_bbox_embedding_res{self.res_key}"]))
        lay_pos = self.norm_lay_pos(self.layout_position_proj(cond["obj_bbox_embedding"]))
        content = (cond["xf_out"] + self.norm_obj_class(cond["obj_class_embedding"])) / 2.0
        k_lay, v_lay = self.layout_content_proj(content).split(c, dim=-1)

        def per_head(t, pos):
            return torch.cat([t.reshape(b, t.shape[1], heads, -1),
                              pos.reshape(b, pos.shape[1], heads, -1)], -1)
        qh = per_head(q, img_pos)
        kh = torch.cat([per_head(k, img_pos), per_head(k_lay, lay_pos)], 1)
        vh = torch.cat([v, v_lay], 1).reshape(b, kh.shape[1], heads, -1)
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / qh.shape[-1] ** 0.5
        valid = torch.cat([torch.ones((b, l1), dtype=torch.bool), cond["key_padding_mask"]], 1)
        logits = torch.where(valid[:, None, None, :], logits, -1e9)
        out = torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), vh).reshape(b, l1, c)
        return x + self.proj_out(out).transpose(1, 2).reshape(b, c, h, w)


def test_per_head_split_fails_the_comparison(pair):
    block, x, cond, want = _attn_case(pair)
    wrong = PerHeadSplit(block.qkv.weight.shape[1], block.heads, block.res_key,
                         block.layout_content_proj.in_features)
    wrong.load_state_dict(block.state_dict())
    with torch.no_grad():
        right, bad = nhwc(block(nchw(x), cond)), nhwc(wrong(nchw(x), cond))
    np.testing.assert_allclose(right, want, atol=1e-5, rtol=1e-5)
    assert np.abs(bad - want).max() > 100 * (1e-5 + 1e-5 * np.abs(want).max())


@pytest.mark.parametrize("fault", ["erf GELU", "LayerNorm eps 1e-5"])
def test_torch_defaults_fail_the_encoder_comparison(pair, monkeypatch, fault):
    jmodel, params, port, _ = pair
    want = jmodel.get_learned_conditioning(params, jnp.asarray(LAYOUTS))
    if fault == "erf GELU":
        gelu = F.gelu
        monkeypatch.setattr(F, "gelu", lambda h, approximate="none": gelu(h))
    else:
        monkeypatch.setattr(LE, "LN_EPS", 1e-5)
    enc = LE.LayoutTransformerEncoder(port.cond_stage_model.cfg)
    enc.load_state_dict(port.cond_stage_model.state_dict())
    with torch.no_grad():
        got = _np(enc(torch.from_numpy(LAYOUTS)))
    # the error over the comparison's tolerance: above 1 the comparison fails
    worst = max(np.abs(got[k] - np.asarray(want[k])).max()
                / (ENC_TOL + ENC_TOL * np.abs(np.asarray(want[k])).max())
                for k in ("xf_out", "xf_proj"))
    assert worst > 2, f"{fault}: the wrong encoder passed the comparison ({worst:.2f})"


def test_layout_unet_matches_jax(pair):
    jmodel, params, port, cond = pair
    rng = np.random.default_rng(7)
    z = rng.standard_normal(SHAPE).astype(np.float32)
    t = np.array([5, 40])
    want = np.asarray(jax.jit(jmodel.apply_model)(params, jnp.asarray(z), jnp.asarray(t),
                                                  _jax_cond(cond)))
    with torch.no_grad():
        got = port.apply_model(torch.from_numpy(z), torch.from_numpy(t), cond).numpy()
        swapped = port.apply_model(torch.from_numpy(z), torch.from_numpy(t),
                                   {k: v.flip(0) for k, v in cond.items()}).numpy()
    assert np.abs(want).max() > 0.1 and np.abs(swapped - got).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_guided_ddim_and_decode_match_jax(pair):
    jmodel, params, port, cond = pair
    with torch.no_grad():
        uncond = port.get_learned_conditioning(np.zeros_like(LAYOUTS))
    key = jax.random.key(11)
    # the JAX samplers draw x_T from the second half of split(key)
    x_T = np.array(jax.random.normal(jax.random.split(key)[1], SHAPE, jnp.float32))
    want_z = np.array(JS.ddim_sample(jmodel, params, key, SHAPE, steps=3,
                                      cond=_jax_cond(cond), uncond=_jax_cond(uncond),
                                      cfg_scale=2.0))
    with torch.inference_mode():
        z = PS.ddim_sample(port, SHAPE, steps=3, cond=cond, uncond=uncond, cfg_scale=2.0,
                           x_T=torch.from_numpy(x_T), device="cpu").numpy()
        unguided = PS.ddim_sample(port, SHAPE, steps=3, cond=cond, x_T=torch.from_numpy(x_T),
                                  device="cpu").numpy()
        img = port.decode_first_stage(torch.from_numpy(want_z)).numpy()
    assert np.abs(unguided - z).max() > 1e-3
    np.testing.assert_allclose(z, want_z, atol=1e-4 * np.abs(want_z).max(), rtol=1e-4)
    want_img = np.asarray(jax.jit(jmodel.decode_first_stage)(params, jnp.asarray(want_z)))
    assert img.shape == want_img.shape == (2, *IMAGE)
    np.testing.assert_allclose(img, want_img, atol=1e-4, rtol=1e-4)


# ----------------------------------------------------------- the new surface
class _JaxToy:
    def apply_model(self, params, x, t, c):
        gate = jnp.where(c["mask"][:, :1], 1.0, -1.0)
        return x * c["emb"].sum(-1)[:, None, None, None] + gate[:, :, None, None] \
            + t[:, None, None, None]


class _PortToy:
    def apply_model(self, x, t, c):
        gate = torch.where(c["mask"][:, :1], 1.0, -1.0)
        return x * c["emb"].sum(-1)[:, None, None, None] + gate[:, :, None, None] \
            + t[:, None, None, None]


def test_cfg_apply_concatenates_a_dict_pytree_as_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 2, 4, 1)).astype(np.float32)
    t = np.array([1.0, 2.0, 3.0], np.float32)
    trees = [{"emb": rng.standard_normal((3, 5)).astype(np.float32),
              "mask": rng.uniform(size=(3, 4)) > 0.5} for _ in range(2)]
    for scale in (1.0, 2.5):
        want = JS._cfg_apply(_JaxToy(), None, jnp.asarray(x), jnp.asarray(t),
                             jax.tree.map(jnp.asarray, trees[0]),
                             jax.tree.map(jnp.asarray, trees[1]), scale)
        got = PS._cfg_apply(_PortToy(), torch.from_numpy(x), torch.from_numpy(t),
                            {k: torch.from_numpy(v) for k, v in trees[0].items()},
                            {k: torch.from_numpy(v) for k, v in trees[1].items()}, scale)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="keys"):
        PS._tree_cat({"a": torch.ones(1)}, {"b": torch.ones(1)})


@pytest.mark.parametrize("sampler", ["ddim", "dpm", "plms", "ddpm"])
def test_cond_and_uncond_reach_the_unet(pair, monkeypatch, sampler):
    port, cond = pair[2], pair[3]
    with torch.no_grad():
        uncond = port.get_learned_conditioning(np.zeros_like(LAYOUTS))
    seen = []
    apply = port.apply_model

    def spy(x, t, c=None):
        seen.append((x.shape[0], c))
        return apply(x, t, c)
    monkeypatch.setattr(port, "apply_model", spy)
    kw = dict(x_T=torch.zeros(SHAPE), device="cpu")
    with torch.inference_mode():
        if sampler == "ddpm":      # ancestral: no guidance, as in JAX
            out = PS.ddpm_sample(port, SHAPE, cond=cond, generator=torch.Generator(), **kw)
        else:
            fn = {"ddim": PS.ddim_sample, "dpm": PS.dpm_solver_sample,
                  "plms": PS.plms_sample}[sampler]
            out = fn(port, SHAPE, steps=2, cond=cond, uncond=uncond, cfg_scale=2.0, **kw)
    assert np.isfinite(out.numpy()).all() and seen
    for rows, c in seen:
        assert set(c) == set(cond)
        if sampler == "ddpm":
            assert rows == 2 and c is cond
        else:
            assert rows == 4
            for k in cond:
                assert torch.equal(c[k], torch.cat([uncond[k], cond[k]])), k


def test_from_config_builds_the_layout_yaml(monkeypatch):
    path = str(ROOT / "configs/lidar_diffusion/nuscenes/layout_cond_c2_p4.yaml")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationPipeline.from_config(path, dataset="32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        layout_flagship(tiny=True)
    pipe = GenerationPipeline.from_config(path, dataset="32", device="cpu")
    m = pipe.model
    assert isinstance(m.unet, OU.LayoutDiffusionUNetModel)
    assert isinstance(m.cond_stage_model, LE.LayoutTransformerEncoder)
    assert m.cfg.conditioning_key == "layout_crossattn" and m.cfg.latent_shape == (8, 128, 8)
    assert m.unet.cfg.attention_ds == (8, 4, 2) and m.cond_stage_model.cfg.num_layers == 6
    attn = [b for b in m.unet.modules() if isinstance(b, OU.ObjectAwareCrossAttention)]
    assert sorted((b.heads, b.res_key) for b in attn) == [(8, 4)] * 5 + [(16, 2)] * 6
    assert pipe.geom == PL.LidarGeometry(size=(32, 1024), fov=(10, -30))
    assert not m.first_stage_model.use_mask


def test_generate_with_cond_gives_nuscenes_clouds():
    pipe = GenerationPipeline.from_config(CFG, dataset="32", device="cpu", steps=2)
    seed_weights(pipe.model, 4)
    layouts = synthetic_layouts(np.random.default_rng(2), 3, GEOM)
    with torch.no_grad():
        c = pipe.model.get_learned_conditioning(layouts)
        u = pipe.model.get_learned_conditioning(np.zeros((2, 13, 13), np.float32))
    out = pipe.generate(3, seed=1, batch=2, cond=c, uncond=u, cfg_scale=2.0)
    assert out.images.shape == (3, *IMAGE) and np.isfinite(out.images).all()
    assert pipe.geom.size == (32, 256) and pipe.geom.fov == (10, -30)
    for img, cloud in zip(out.images, out.clouds):
        xyz, valid = PL.range2pcd(torch.from_numpy(img[..., 0]), pipe.geom)
        np.testing.assert_array_equal(cloud, xyz.numpy()[valid.numpy()])
    # the third scene is generated with the first layout (the last batch wraps)
    first = pipe.generate(2, seed=1, batch=2, cond={k: v[:2] for k, v in c.items()},
                          uncond=u, cfg_scale=2.0)
    np.testing.assert_array_equal(first.images, out.images[:2])
    assert len(pipe._cache) == 2
    unguided = pipe.generate(2, seed=1, batch=2, cond={k: v[:2] for k, v in c.items()})
    assert np.abs(unguided.images - first.images).max() > 1e-4 and len(pipe._cache) == 3
    with pytest.raises(ValueError, match="rows"):
        pipe.generate(3, batch=2, cond={k: v[:1] for k, v in c.items()})
    with pytest.raises(ValueError, match="encoded layout"):
        pipe.generate(2, batch=2)


# ------------------------------------------------------- ROADMAP pointers
def test_port_messages_point_at_roadmap_titles():
    roadmap = (ROOT / "ROADMAP.md").read_text()
    queue1 = roadmap.split("### 1. Modules to port")[1].split("### 2.")[0]
    titles = set(re.findall(r"^\d+\. \*\*(.+?)\.\*\*", queue1, re.M))
    assert {"Conditioning", "Remaining families and infrastructure"} <= titles
    # ported with their raises: no pointer names them, and ROADMAP drops them
    dropped = {"Main-path remainder", "First stage and AE training"}
    assert not dropped & titles
    text = "\n".join(p.read_text() for p in (ROOT / "lidar_layout_tpu_torch").rglob("*.py"))
    text = re.sub(r"\s*\n\s*", " ", text)
    pointers = re.findall(r'ROADMAP queue 1, "([^"]+)"', text)
    assert not dropped & set(pointers), dropped & set(pointers)
    # four wait for files (the BERT and CLIP vocabularies, the CLIP weights)
    assert len(pointers) == 4 and set(pointers) <= titles, set(pointers) - titles
    assert not re.search(r"ROADMAP queue 1, item", text)
