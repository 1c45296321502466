"""PyTorch port vs the JAX package: the CLIP conditioning of cam2lidar and
text2lidar.

On the CPU in float32, on the same numpy inputs: ``quick_gelu``,
``simple_tokenize``, the OpenAI-layout converters (``clip_convert``) on a
random state dict at 2 layers and width 64 against JAX's, the text and image
towers, the text wrappers at CLIP ViT-L/14's full size, the multi-view image
wrapper over a small tower, the BPE tokenizer on a tiny merges file written
here and its fallback, and cam2lidar and text2lidar end to end at the JAX
scripts' ``--tiny`` U-Net widths, and both CLIs' ``--resume`` of a run
directory. JAX's wrappers fix their towers at full
size, so the end-to-end tests build the same wrappers over small towers
here (``SmallMultiImage``, ``SmallMultiText``).
"""
import gzip

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_layout_tpu.encoders import bpe as JBPE
from lidar_layout_tpu.encoders import clip_convert as JCC
from lidar_layout_tpu.encoders import modules as JE
from lidar_layout_tpu_torch import sample_cond, text2lidar
from lidar_layout_tpu_torch.encoders import bpe as PBPE
from lidar_layout_tpu_torch.encoders import clip_convert as PCC
from lidar_layout_tpu_torch.encoders import modules as PE
from lidar_layout_tpu_torch.utils import convert as CV
from torch_port_helpers import (cond_end_to_end, jax_cond_ldm, one_intra_op_thread,
                                random_flax_params, rel_l2)

_one_thread = pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


TOL = 1e-5
WIDTH, LAYERS, HEADS, VOCAB = 64, 2, 4, 300
SMALL_TEXT = dict(vocab_size=49408, width=WIDTH, layers=LAYERS, heads=HEADS)
SMALL_IMAGE = dict(image_size=28, patch=14, width=WIDTH, layers=LAYERS, heads=HEADS, out_dim=48)


def _openai_state_dict(seed=0, text=True):
    """A random OpenAI CLIP state dict (its names and layouts) at 2 layers,
    width 64: the text tower's, or the image tower's (``visual.*``, 28x28
    images in 14x14 patches)."""
    rng = np.random.default_rng(seed)
    w = WIDTH

    def r(*shape, scale=None):
        scale = scale if scale is not None else 1 / np.sqrt(shape[-1])
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    pfx = "transformer" if text else "visual.transformer"
    sd = {}
    for i in range(LAYERS):
        b = f"{pfx}.resblocks.{i}"
        for ln in ("ln_1", "ln_2"):
            sd[f"{b}.{ln}.weight"] = 1 + r(w, scale=0.1)
            sd[f"{b}.{ln}.bias"] = r(w, scale=0.1)
        sd[f"{b}.attn.in_proj_weight"] = r(3 * w, w)
        sd[f"{b}.attn.in_proj_bias"] = r(3 * w, scale=0.1)
        sd[f"{b}.attn.out_proj.weight"] = r(w, w)
        sd[f"{b}.attn.out_proj.bias"] = r(w, scale=0.1)
        sd[f"{b}.mlp.c_fc.weight"] = r(4 * w, w)
        sd[f"{b}.mlp.c_fc.bias"] = r(4 * w, scale=0.1)
        sd[f"{b}.mlp.c_proj.weight"] = r(w, 4 * w)
        sd[f"{b}.mlp.c_proj.bias"] = r(w, scale=0.1)
    if text:
        sd["token_embedding.weight"] = r(VOCAB, w, scale=1.0)
        sd["positional_embedding"] = r(77, w, scale=0.1)
        sd["ln_final.weight"], sd["ln_final.bias"] = 1 + r(w, scale=0.1), r(w, scale=0.1)
        sd["text_projection"] = r(w, w)
    else:
        sd["visual.conv1.weight"] = r(w, 3, 14, 14, scale=1 / np.sqrt(3 * 14 * 14))
        sd["visual.class_embedding"] = r(w, scale=1.0)
        sd["visual.positional_embedding"] = r(5, w, scale=0.1)
        for ln in ("ln_pre", "ln_post"):
            sd[f"visual.{ln}.weight"] = 1 + r(w, scale=0.1)
            sd[f"visual.{ln}.bias"] = r(w, scale=0.1)
        sd["visual.proj"] = r(w, 48)
    return sd


def _tokens(texts, vocab=VOCAB):
    """simple_tokenize ids folded into a small vocabulary, EOT kept the
    largest id of each row (EOT pooling takes the argmax)."""
    t = PE.simple_tokenize(texts).astype(np.int64)
    eot = t == 49407
    t = t % (vocab - 1)
    t[eot] = vocab - 1
    return t


def test_quick_gelu_and_simple_tokenize_equal_jax():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(PE.quick_gelu(_t(x)).numpy(), np.asarray(JE.quick_gelu(x)),
                               rtol=1e-6, atol=1e-7)
    texts = ["a busy intersection with cars", "", "x" * 200, "Straße, 東京 ünd émoji"]
    for max_len in (77, 16):
        np.testing.assert_array_equal(PE.simple_tokenize(texts, max_len),
                                      JE.simple_tokenize(texts, max_len))


@pytest.mark.parametrize("pool", [True, False])
def test_clip_text_convert_and_tower_match_jax(pool):
    sd = _openai_state_dict(1, text=True)
    jparams = JCC.convert_clip_text(sd, layers=LAYERS, heads=HEADS)
    port_sd = PCC.convert_clip_text(sd, layers=LAYERS)
    carried = CV.cond_stage_state_dict(jparams)
    assert carried.keys() == port_sd.keys()
    for k in port_sd:
        np.testing.assert_array_equal(carried[k].numpy(), port_sd[k].numpy(), err_msg=k)
    tokens = _tokens(["a car parked by a tree", "empty road at night, wet"])
    jtower = JE.TextTransformerEncoder(vocab_size=VOCAB, width=WIDTH, layers=LAYERS, heads=HEADS)
    want = jtower.apply(jparams, jnp.asarray(tokens), pool=pool)
    port = PE.TextTransformerEncoder(VOCAB, 77, WIDTH, LAYERS, HEADS)
    port.load_state_dict(port_sd)
    with torch.no_grad():
        got = port(_t(tokens), pool=pool)
    assert rel_l2(got.numpy(), want) < TOL


@pytest.mark.parametrize("pool", [True, False])
def test_clip_image_convert_and_tower_match_jax(pool):
    sd = _openai_state_dict(2, text=False)
    jparams = JCC.convert_clip_image(sd, layers=LAYERS, heads=HEADS)
    port_sd = PCC.convert_clip_image(sd, layers=LAYERS)
    carried = CV.cond_stage_state_dict(jparams)
    assert carried.keys() == port_sd.keys()
    for k in port_sd:
        np.testing.assert_array_equal(carried[k].numpy(), port_sd[k].numpy(), err_msg=k)
    images = np.random.default_rng(3).standard_normal((3, 28, 28, 3)).astype(np.float32)
    want = JE.ImageTransformerEncoder(**SMALL_IMAGE).apply(jparams, jnp.asarray(images),
                                                           pool=pool)
    port = PE.ImageTransformerEncoder(**SMALL_IMAGE)
    port.load_state_dict(port_sd)
    with torch.no_grad():
        got = port(_t(images), pool=pool)
    assert rel_l2(got.numpy(), want) < TOL


@pytest.fixture(scope="module")
def full_text_pair():
    """JAX's FrozenClipMultiTextEmbedder (the full ViT-L/14 text tower) and
    the port's, with JAX's random tree carried over."""
    jmod = JE.FrozenClipMultiTextEmbedder(n_views=2)
    tokens = PE.simple_tokenize(["a busy intersection with cars", ""])
    params = random_flax_params(jmod.init, 4, jax.random.key(0), jnp.asarray(tokens))
    port = PE.FrozenClipMultiTextEmbedder(n_views=2)
    port.load_state_dict(CV.cond_stage_state_dict(params))
    return jmod, params, port.eval(), tokens


def test_full_size_clip_text_embedder_matches_jax(full_text_pair):
    jmod, params, port, tokens = full_text_pair
    want = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(tokens)))
    with torch.no_grad():
        got = port(_t(tokens)).numpy()
    assert got.shape == want.shape == (2, 2, 768)
    assert rel_l2(got, want) < TOL
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(got[:, 0], got[:, 1])     # repeated over the views
    assert sum(p.numel() for p in port.parameters()) > 1.2e8   # ViT-L/14's text tower


def test_clip_text_embedder_pools_the_eot_token(full_text_pair):
    _, _, port, tokens = full_text_pair
    moved = tokens.copy()
    moved[0, 5] += 1          # a token before EOT: the causal tower's EOT sees it
    after = tokens.copy()
    after[1, 10] = 7           # a token after EOT (in the padding): unseen
    with torch.no_grad():
        base, a, b = (port.text(_t(t))[:, 0] for t in (tokens, moved, after))
    assert not torch.allclose(a[0], base[0]) and torch.equal(b[1], base[1])


class SmallMultiImage(fnn.Module):
    """JAX's FrozenClipMultiImageEmbedder over a small ImageTransformerEncoder."""

    out_dim: int = 512

    @fnn.compact
    def __call__(self, images):
        b, v = images.shape[:2]
        flat = images.reshape(b * v, *images.shape[2:])
        z = JE.ImageTransformerEncoder(**SMALL_IMAGE, name="clip_image")(flat, pool=True)
        z = fnn.Dense(self.out_dim, name="projection")(z)
        return z.reshape(b, v, self.out_dim)


class SmallText(fnn.Module):
    """JAX's FrozenCLIPTextEmbedder over a small TextTransformerEncoder."""

    @fnn.compact
    def __call__(self, tokens):
        z = JE.TextTransformerEncoder(**SMALL_TEXT, name="clip_text")(tokens, pool=True)
        return (z / jnp.linalg.norm(z, axis=-1, keepdims=True))[:, None, :]


class SmallMultiText(fnn.Module):
    """JAX's FrozenClipMultiTextEmbedder over SmallText."""

    n_views: int = 2

    @fnn.compact
    def __call__(self, tokens):
        return jnp.repeat(SmallText(name="text")(tokens), self.n_views, axis=1)


def _small_image_stage():
    return PE.FrozenClipMultiImageEmbedder(512, tower=PE.ImageTransformerEncoder(**SMALL_IMAGE))


def test_multi_image_embedder_over_a_small_tower_matches_jax():
    images = np.random.default_rng(5).standard_normal((2, 3, 28, 28, 3)).astype(np.float32)
    params = random_flax_params(SmallMultiImage().init, 6, jax.random.key(0),
                                jnp.asarray(images))
    want = SmallMultiImage().apply(params, jnp.asarray(images))
    port = _small_image_stage()
    port.load_state_dict(CV.cond_stage_state_dict(params))
    with torch.no_grad():
        got = port(_t(images))
    assert got.shape == (2, 3, 512) and rel_l2(got.numpy(), want) < TOL


def _merges_file(path):
    """A CLIP-format merges file: a header line, then merges over the
    byte-level alphabet, 'a b', 'ab c', 'c a</w>', ..."""
    merges = ["r o", "c a", "ca r</w>", "t h", "th e</w>", "i n", "in t", "s t", "st r",
              "e e", "ee t</w>", "o a", "ro a", "roa d</w>", "b u", "bu s", "bus y</w>"]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return str(path)


def test_bpe_tokenizer_on_a_tiny_merges_file_equals_jax(tmp_path):
    vocab = _merges_file(tmp_path / "merges.txt.gz")
    texts = ["The busy road", "car &amp; street", "It's Roads!!", "  ünïcode car 42 ",
             "the " * 40]
    got = PBPE.BPETokenizer(vocab)(texts)
    want = JBPE.BPETokenizer(vocab)(texts)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (5, 77) and (got[:, 0] == PBPE.SOT).all()
    assert PBPE.BPETokenizer(vocab).encode("the car") == JBPE.BPETokenizer(vocab).encode("the car")


def test_bpe_tokenizer_falls_back_loudly(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("LIDM_BPE_VOCAB", raising=False)
    tok = PBPE.BPETokenizer(str(tmp_path / "missing.txt.gz"))
    assert "byte-level fallback" in capsys.readouterr().out
    np.testing.assert_array_equal(tok(["a car", "b"], 20), PE.simple_tokenize(["a car", "b"], 20))


def test_cam2lidar_end_to_end_matches_jax():
    n = 2
    cond_in = np.random.default_rng(0).standard_normal((n, 2, 28, 28, 3)).astype(np.float32)
    jmodel, params = jax_cond_ldm("crossattn", SmallMultiImage(), 8, 512,
                                   jnp.zeros((1, 2, 28, 28, 3)))
    port = sample_cond.build_model("crossattn", _small_image_stage, tiny=True,
                                   context_dim=512, device="cpu")
    cond_end_to_end(jmodel, params, port, "c_crossattn", cond_in, n)
    assert sample_cond.synthetic_conditions("cam2lidar", 1).shape == (1, 2, 224, 224, 3)


@pytest.mark.parametrize("cfg_scale", [1.0, 2.0])
def test_text2lidar_end_to_end_matches_jax(cfg_scale):
    n = 2
    tokens = np.tile(PE.simple_tokenize(["a busy intersection with cars"]), (n, 1))
    jmodel, params = jax_cond_ldm("crossattn", SmallMultiText(), 8, WIDTH,
                                   jnp.asarray(tokens[:1]))
    port = sample_cond.build_model("crossattn", lambda: PE.FrozenClipMultiTextEmbedder(
        2, tower=PE.TextTransformerEncoder(**SMALL_TEXT)), tiny=True, context_dim=WIDTH,
        device="cpu")
    cond_end_to_end(jmodel, params, port, "c_crossattn", tokens, n,
               uncond_in=PE.simple_tokenize([""] * n), cfg_scale=cfg_scale)


def _small_text_model(tiny=True, device="cpu"):
    return sample_cond.build_model("crossattn", lambda: PE.FrozenClipMultiTextEmbedder(
        2, tower=PE.TextTransformerEncoder(**SMALL_TEXT)), tiny=tiny, context_dim=WIDTH,
        device=device)


@pytest.mark.parametrize("cli", ["map2lidar", "text2lidar"])
def test_cli_resume_loads_the_runs_ema_weights(cli, tmp_path, monkeypatch):
    """-r reads a run directory written by the port's own checkpoint saver:
    the model weights with the EMA's over the ones it shadows; a directory
    without a checkpoint raises. text2lidar's model is built over a small
    text tower here (the full CLIP-L checkpoint would be 0.5 GB)."""
    from lidar_layout_tpu_torch.train.checkpoint import save_checkpoint
    from lidar_layout_tpu_torch.train.diffusion_trainer import (Optimizer, create_train_state,
                                                                trainable_params)

    if cli == "text2lidar":
        monkeypatch.setattr(text2lidar, "build_text_model", _small_text_model)
        model, main, argv = _small_text_model(), text2lidar.main, []
    else:
        model = sample_cond.build_task_model("map2lidar", tiny=True, device="cpu")
        main, argv = sample_cond.main, ["--task", "map2lidar"]
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=gen))
    params = trainable_params(model)
    state = create_train_state(model, Optimizer(params, lr=1e-4), params)
    for v in state.ema.params.values():
        v.add_(0.01 * torch.randn(v.shape, generator=gen))
    run = tmp_path / "run"
    save_checkpoint(str(run / "ckpt"), 5, state)
    argv += ["--tiny", "--device", "cpu", "-n", "1", "--steps", "1",
             "--outdir", str(tmp_path / "out")]
    out = main([*argv, "-r", str(run)])
    got, want = out["model"].state_dict(), {**model.state_dict(), **state.ema.params}
    assert set(got) == set(want) and state.ema.params
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert np.isfinite(out["samples"]).all()
    with pytest.raises(FileNotFoundError):
        main([*argv, "-r", str(tmp_path / "out")])


def test_text2lidar_cli_writes_the_jax_scripts_file(tmp_path):
    out = text2lidar.main(["--tiny", "--device", "cpu", "--steps", "2", "--cfg-scale", "2.0",
                           "--outdir", str(tmp_path)])
    saved = np.load(tmp_path / "text2lidar_samples.npy")
    assert saved.shape == (2, 16, 128, 1) and np.array_equal(saved, out["samples"])
    assert np.isfinite(saved).all()
    stage = out["model"].cond_stage_model
    assert isinstance(stage, PE.FrozenClipMultiTextEmbedder) and stage.n_views == 2
    assert out["model"].unet.cfg.context_dim == 768
