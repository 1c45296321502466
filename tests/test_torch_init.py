"""Fresh weights: the port's ``utils/init.jax_init_`` against JAX's initialisers.

For each model a trainer starts from scratch (the tiny flagship LiDM, its
U-Net and VQ autoencoder; JAX's AE discriminator; a small R2DM;
LayoutDiffusion's scene-graph encoder), JAX's own ``init`` draws a
tree, carried to the port's names by ``utils/convert``, and the port's
model is built and redrawn by ``jax_init_``. Leaf by leaf:

- a leaf that JAX's init sets to all zeros or all ones is the same in the
  port, exactly (biases, norm affines, the zero-initialised output layers);
- every other leaf of n >= 16 elements: the port's mean and standard
  deviation within 6 sigma / sqrt(n) of JAX's (sigma the leaf's JAX std; the
  mean of n draws has a standard error of sigma / sqrt(n), the std about
  sigma / sqrt(2n), and the two sides are independent), and for n >= 2,000
  the largest magnitude within 15% of JAX's: lecun and he normals are cut
  at two standard deviations (2.27 sigma after flax's rescale), an
  embedding's normal is not (about 3.5 sigma at these sizes), and the
  largest of thousands of draws moves by a few percent.

torch's own initialisers fail this (a test below checks that they do).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship as jax_flagship
from lidar_layout_tpu.losses import discriminator as JD
from lidar_layout_tpu.models import r2dm as JR
from lidar_layout_tpu.data.layout_synthetic import synthetic_graph_batch
from lidar_layout_tpu.encoders.scene_graph import SceneGraphEncoder as JaxSGE
from lidar_layout_tpu_torch.flagship import flagship
from lidar_layout_tpu_torch.losses import discriminator as PD
from lidar_layout_tpu_torch.models import r2dm as PR
from lidar_layout_tpu_torch.encoders.scene_graph import SceneGraphEncoder
from lidar_layout_tpu_torch.utils.convert import (discriminator_state_dict,
                                                  latent_diffusion_state_dict,
                                                  layout_diffusion_state_dict, r2dm_state_dict)
from lidar_layout_tpu_torch.utils.init import jax_init_


def _init(init, *args):
    """JAX's ``init`` jitted at optimisation level 0: the same draws, its
    compile a third shorter on the CPU."""
    return jax.jit(init).lower(*args).compile({"xla_backend_optimization_level": 0})(*args)


def _flagship_pair():
    port, _ = flagship(tiny=True, device="cpu")
    jmodel, image_shape = jax_flagship(tiny=True)
    params = _init(lambda k: jmodel.init(k, image_shape=image_shape), jax.random.key(0))
    return port, latent_diffusion_state_dict(jax.tree.map(np.asarray, params), port.unet.cfg)


def _disc_pair():
    jdisc = JD.LiDARNLayerDiscriminator()
    params = _init(jdisc.init, jax.random.key(0), jnp.zeros((1, 64, 256, 4)))
    return PD.LiDARNLayerDiscriminator(4), discriminator_state_dict(
        jax.tree.map(np.asarray, params))


def _r2dm_pair():
    cfg = dict(image_size=(16, 64), base_channels=32, channel_mult=(1, 2, 4),
               num_res_blocks=1, coords_encoding="fourier_features", timesteps=100)
    jmodel = JR.R2DMDiffusion(JR.R2DMConfig(**cfg))
    params = _init(jmodel.init, jax.random.key(0))
    return PR.R2DMDiffusion(PR.R2DMConfig(**cfg)), r2dm_state_dict(
        jax.tree.map(np.asarray, params))


def _scene_graph_pair():
    """LayoutDiffusion's scene-graph encoder: embeddings and the graph
    convolutions' MLPs (``he_normal`` in JAX's ``build_mlp``)."""
    kw = dict(num_objs=32, num_preds=16, embedding_dim=16)
    jenc = JaxSGE(**kw, residual=True)      # as LayoutDiffusion builds it
    g = {k: jnp.asarray(v) for k, v in synthetic_graph_batch(
        np.random.default_rng(0), n_scenes=2, max_objs_per_scene=4,
        max_triples_per_scene=6).items()}
    params = _init(jenc.init, {"params": jax.random.key(0), "change": jax.random.key(1)}, g)
    sd = layout_diffusion_state_dict({"unet": {}, "cond_stage": jax.tree.map(
        np.asarray, params["params"])})
    return SceneGraphEncoder(**kw), {k[len("cond_stage."):]: v for k, v in sd.items()}


PAIRS = {"flagship": _flagship_pair, "discriminator": _disc_pair, "r2dm": _r2dm_pair,
         "scene_graph": _scene_graph_pair}


def _mismatches(port, want):
    """(leaf name, why) for every port parameter off JAX's distribution."""
    bad = []
    params = dict(port.named_parameters())
    assert set(params) <= set(want), sorted(set(params) - set(want))[:5]
    for name, p in params.items():
        got, ref = p.detach().double().numpy().ravel(), np.asarray(want[name], np.float64).ravel()
        assert got.shape == ref.shape, name
        if not ref.any() or np.all(ref == 1.0):
            if not np.array_equal(got, ref):
                bad.append((name, "constant"))
            continue
        n = ref.size
        if n < 16:
            continue
        sigma = ref.std()
        lim = 6.0 * sigma / np.sqrt(n)
        if abs(got.mean() - ref.mean()) > lim:
            bad.append((name, f"mean {got.mean():.4g} vs {ref.mean():.4g}"))
        if abs(got.std() - sigma) > lim:
            bad.append((name, f"std {got.std():.4g} vs {sigma:.4g}"))
        if n >= 2000 and abs(np.abs(got).max() - np.abs(ref).max()) > 0.15 * np.abs(ref).max():
            bad.append((name, f"max {np.abs(got).max():.4g} vs {np.abs(ref).max():.4g}"))
    return bad


@pytest.fixture(scope="module")
def flagship_pair():
    return _flagship_pair()


@pytest.mark.parametrize("model", sorted(PAIRS))
def test_fresh_weights_follow_jax_initialisers(model, flagship_pair):
    port, want = flagship_pair if model == "flagship" else PAIRS[model]()
    jax_init_(port, seed=3)
    assert _mismatches(port, want) == []


def test_torch_initialisers_do_not(flagship_pair):
    """The check above is not vacuous: torch's default initialisers (uniform
    kernels, uniform biases) fail it on the flagship."""
    want = flagship_pair[1]
    port, _ = flagship(tiny=True, device="cpu")
    bad = {name for name, _ in _mismatches(port, want)}
    assert any(n.endswith(".bias") for n in bad) and any(n.endswith(".weight") for n in bad)


def test_jax_init_is_seeded_and_keeps_explicit_inits():
    """The same seed draws the same weights; the codebook keeps its uniform
    +-1/n_embed and the zero output conv stays zero."""
    a, b = (flagship(tiny=True, device="cpu")[0] for _ in range(2))
    b.load_state_dict(a.state_dict())     # the same codebook: it is not redrawn
    codebook = a.first_stage_model.quantize.embedding.weight.detach().clone()
    jax_init_(a, 5)
    jax_init_(b, 5)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    assert torch.equal(a.first_stage_model.quantize.embedding.weight, codebook)
    assert not a.unet.out[2].weight.any()
