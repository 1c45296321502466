"""Shared helpers for the tests of the PyTorch port (tests/test_torch_*.py).

Weights go from the port to JAX through the JAX package's own converters
(``utils/torch_convert.convert_unet`` / ``convert_vq_autoencoder``), so the
parity tests also check that the port carries the reference state_dict names.
"""
from __future__ import annotations

import collections
import contextlib
import re

import numpy as np
import torch


def one_intra_op_thread():
    """Body of a module fixture that runs the module's tests on one torch
    thread. Tests that run thousands of small ops (samplers, training loops,
    CLIs) wait on their intra-op threads whenever the suite's other parallel
    workers keep those threads off the cores: a DDPM test took 60x longer so.
    Use as ``pytest.fixture(autouse=True, scope="module")(one_intra_op_thread)``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seed_weights(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Every parameter from a seeded generator at ~1/sqrt(fan_in), the
    zero-initialised output layers included (else the U-Net outputs 0 and
    attention never reaches the result); norm affines near (1, 0); codebooks
    N(0, 1) (the taming +-1/n codebook makes argmin near-ties)."""
    from lidar_layout_tpu_torch.losses.discriminator import GroupNorm32
    from lidar_layout_tpu_torch.nn.blocks import Normalize

    gen = torch.Generator().manual_seed(seed)
    norm_params = {id(p) for m in model.modules() if isinstance(m, (Normalize, GroupNorm32))
                   for p in m.parameters()}
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = torch.randn(p.shape, generator=gen)
            if id(p) in norm_params:
                r = (1.0 + 0.1 * r) if name.endswith("weight") else 0.1 * r
            elif name.endswith("embedding.weight"):
                pass
            elif p.ndim > 1:
                r = r / (p[0].numel() ** 0.5)
            else:
                r = 0.1 * r
            p.copy_(r.to(p.dtype))
    return model


@contextlib.contextmanager
def count_group_norms(*modules: torch.nn.Module):
    """Module hooks on every GroupNorm (``Normalize``, ``GroupNorm32``) of
    ``modules`` while the block runs: yields (forward calls, backward
    passes), Counters by (B, C, H, W, groups, act, eps). A norm whose output
    two gradients pass through (the discriminator's view of a
    reconstruction, under the adaptive weight and the loss) counts twice."""
    from lidar_layout_tpu_torch.losses.discriminator import GroupNorm32
    from lidar_layout_tpu_torch.nn.blocks import Normalize

    fwd, bwd, hooks = collections.Counter(), collections.Counter(), []

    def pre(mod, args):
        mod.k3_key = (*args[0].shape, mod.num_groups, mod.act, mod.eps)
        fwd[mod.k3_key] += 1

    def back(mod, grad_in, grad_out):
        bwd[mod.k3_key] += 1

    for m in (sub for mod in modules for sub in mod.modules()):
        if isinstance(m, (Normalize, GroupNorm32)):
            hooks += [m.register_forward_pre_hook(pre), m.register_full_backward_hook(back)]
    try:
        yield fwd, bwd
    finally:
        for h in hooks:
            h.remove()


# the edges of the attention kernels' bf16 tiles (128 queries; 128 keys at
# D <= 32, 64 above): one row, one short of a tile, one past a tile (a fused
# view), one past 16 tiles; D = 8 and 96 (padded to 16 and 128); a whole key
# tile masked. chip_smoke.py and tests/test_torch_gpu.py both run them.
ATTN_EDGE_CASES = [((2, 2, 1, 32), False, False), ((2, 2, 127, 32), False, True),
                   ((2, 2, 129, 32), True, False), ((1, 2, 2049, 32), False, False),
                   ((2, 2, 200, 8), False, True), ((2, 2, 300, 96), True, True),
                   ((2, 2, 384, 32), False, "tile")]


def _scene(rng: np.random.Generator, n: int) -> np.ndarray:
    from lidar_layout_tpu_torch.data.synthetic import synthetic_scene

    return synthetic_scene(np.random.default_rng(int(rng.integers(1 << 30))), n)


def _near_ties(rng, n):
    # each x has two y whose squared distances to it differ by 1e-7 relative,
    # among far filler points
    x = rng.uniform(-40, 40, (n, 3))
    u = rng.normal(size=(n, 2, 3))
    u /= np.linalg.norm(u, axis=2, keepdims=True)
    r = rng.uniform(0.05, 0.5, (n, 1))
    filler = rng.uniform(-60, 60, (n, 3))
    return x, np.concatenate([x + r * u[:, 0], x + r * np.sqrt(1 + 1e-7) * u[:, 1], filler])


def _duplicated(rng, n):
    y = rng.uniform(-30, 30, (n, 3))
    return rng.uniform(-30, 30, (2 * n, 3)), rng.permutation(np.concatenate([y, y, y]))


def _x_in_y(rng, n):
    y = rng.uniform(-50, 50, (3 * n, 3))
    return y[rng.choice(3 * n, n, replace=False)], y


def _grid_1cm(rng, n):
    side = max(int(round((n / 4) ** 0.5)), 2)
    g = np.stack(np.meshgrid(np.arange(side), np.arange(side), np.arange(4), indexing="ij"),
                 -1).reshape(-1, 3) * 0.01 + np.array([30.0, 10.0, -1.5])
    x = np.concatenate([g[rng.choice(len(g), n // 3, replace=False)],
                        g[rng.choice(len(g), n)] + rng.uniform(-0.005, 0.005, (n, 3))])
    return x, g


def _offset_500m(rng, n):
    return _scene(rng, n) + 500.0, _scene(rng, n) + 500.0


def _scene_pair(rng, n):
    return _scene(rng, n), _scene(rng, n * 6 // 5)


# clouds built to trip K4's candidate selection: name -> fn(rng, n) giving
# (x, y) of about n to 3n points each
CHAMFER_CLOUDS = {"near ties": _near_ties, "duplicated y": _duplicated,
                  "x equal to some y": _x_in_y, "1 cm grid": _grid_1cm,
                  "offset by 500 m": _offset_500m, "scene pair": _scene_pair}


def chamfer_cloud(name: str, n: int, seed: int = 0):
    """(x, y) contiguous float32 numpy arrays of CHAMFER_CLOUDS[name]."""
    x, y = CHAMFER_CLOUDS[name](np.random.default_rng(seed), n)
    return (np.ascontiguousarray(x, dtype=np.float32), np.ascontiguousarray(y, dtype=np.float32))


def attn_inputs(gen: torch.Generator, b: int, h: int, s: int, d: int, dtype: torch.dtype,
                fused: bool, masked):
    """q, k, v (B, H, S, D) and a key bias on ``gen``'s device: q, k, v as
    views of one (B, S, H, 3, D) projection when ``fused``; ``masked`` True
    pads the last ~quarter of the keys of batch 0, "tile" masks keys 128-255
    of every batch."""
    dev = gen.device
    if fused:
        qkv = torch.randn((b, s, h, 3, d), generator=gen, device=dev).to(dtype)
        q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))
    else:
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)
                   for _ in range(3))
    kb = None
    if masked:
        kb = torch.zeros((b, s), device=dev)
        if masked == "tile":
            kb[:, 128:256] = -1e9
        else:
            kb[0, s - s // 4:] = -1e9
    return q, k, v, kb


def random_flax_params(init, seed: int, *args, **kw) -> dict:
    """A flax parameter tree with the structure ``init(*args, **kw)`` gives
    (from ``jax.eval_shape``: traced, not compiled) and values drawn with
    numpy: kernels at 1/sqrt(fan_in) (so zero-initialised projections are
    live), embeddings and codebooks N(0, 1), norm scales 1 + 0.1 N(0, 1),
    every other leaf 0.1 N(0, 1). A jitted init of a whole model takes tens
    of seconds on the CPU; this takes a few."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, *args, **kw)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            a = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "embedding":
            a = rng.standard_normal(s.shape)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            a = 0.1 * rng.standard_normal(s.shape)
        return jnp.asarray(a, jnp.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def numpy_state_dict(module: torch.nn.Module, prefix: str = "") -> dict:
    return {prefix + k: v.detach().float().numpy() for k, v in module.state_dict().items()}


def jax_unet_params(unet, cfg) -> dict:
    """Port UNetModel -> flax params via the JAX package's convert_unet."""
    from lidar_layout_tpu.utils.torch_convert import convert_unet

    return convert_unet(numpy_state_dict(unet), cfg.num_res_blocks, cfg.channel_mult,
                        cfg.num_head_channels, prefix="")


_LEVEL_ATTN = re.compile(
    r"^(encoder|decoder)\.(down|up)\.(\d+)\.attn\.(\d+)\.(norm|q|k|v|proj_out)\.(weight|bias)$")


def jax_vq_params(vq) -> dict:
    """Port VQModel(Interface) -> flax params via convert_vq_autoencoder.

    That converter carries no per-level attention (``down.i.attn.j`` /
    ``up.i.attn.j``, present when ``attn_levels`` is set), so those leaves are
    filled here under the flax names the JAX blocks use."""
    from lidar_layout_tpu.utils.torch_convert import convert_vq_autoencoder

    sd = numpy_state_dict(vq)
    params = convert_vq_autoencoder(sd)
    for key, value in sd.items():
        m = _LEVEL_ATTN.match(key)
        if not m:
            continue
        tower, side, i, j, mod, leaf = m.groups()
        node = params["params"].setdefault(tower, {}).setdefault(f"{side}_{i}_attn_{j}", {})
        if mod == "norm":
            node.setdefault("norm", {}).setdefault("GroupNorm_0", {})[
                "scale" if leaf == "weight" else "bias"] = value
        else:
            node.setdefault(mod, {}).setdefault("conv", {})[
                "kernel" if leaf == "weight" else "bias"] = (
                np.transpose(value, (2, 3, 1, 0)) if leaf == "weight" else value)
    return params


def jax_ldm_params(model) -> dict:
    """Port LatentDiffusion -> the JAX LatentDiffusion params tree."""
    import jax.numpy as jnp

    return {"unet": jax_unet_params(model.unet, model.unet.cfg),
            "first_stage": jax_vq_params(model.first_stage_model),
            "cond_stage": {},
            "logvar": jnp.zeros((model.cfg.timesteps,), jnp.float32)}


def nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW torch."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t: torch.Tensor) -> np.ndarray:
    """NCHW torch -> NHWC numpy."""
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def rel_l2(got, want) -> float:
    """Relative L2 error of ``got`` against ``want`` (numpy or JAX), in float64."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def jax_cond_ldm(key, cond_stage, in_ch, context_dim, cond_example, seed=17):
    """The JAX scripts' conditional LiDM at ``--tiny`` (``scripts/sample_cond.py``,
    ``scripts/text2lidar.py``) over ``cond_stage``, and a random tree for it."""
    import jax
    from lidar_layout_tpu.models.autoencoder import AEConfig
    from lidar_layout_tpu.models.diffusion import DiffusionConfig, LatentDiffusion
    from lidar_layout_tpu.models.unet import UNetConfig
    from lidar_layout_tpu_torch.sample_cond import sizes

    latent, image, (mc, mult, nrb) = sizes(True)
    jmodel = LatentDiffusion(
        DiffusionConfig(timesteps=1024, linear_start=0.0015, linear_end=0.0195,
                        conditioning_key=key, latent_shape=latent),
        UNetConfig(in_channels=in_ch, model_channels=mc, out_channels=latent[2],
                   num_res_blocks=nrb, attention_resolutions=(4, 2, 1), channel_mult=mult,
                   num_head_channels=32, use_spatial_transformer=context_dim is not None,
                   context_dim=context_dim),
        first_stage_cfg=AEConfig(ch=16, ch_mult=(1, 2, 2, 4), strides=((1, 2), (2, 2), (2, 2)),
                                 z_channels=8, out_ch=2, num_res_blocks=nrb),
        use_mask=True, cond_stage=cond_stage)
    params = random_flax_params(lambda k: jmodel.init(k, image, cond_example=cond_example),
                                seed, jax.random.key(0))
    return jmodel, params


def cond_end_to_end(jmodel, params, port, cond_key, cond_in, n, steps=3, uncond_in=None,
                    cfg_scale=1.0, tol=1e-4):
    """JAX's conditioning, DDIM and decode against the port's
    ``sample_cond.sample`` from JAX's x_T, the JAX tree carried into
    ``port``: the decoded images within ``tol`` relative L2."""
    import jax
    import jax.numpy as jnp
    from lidar_layout_tpu.models import samplers as JS
    from lidar_layout_tpu_torch.sample_cond import sample
    from lidar_layout_tpu_torch.utils.convert import latent_diffusion_state_dict

    port.load_state_dict(latent_diffusion_state_dict(params, port.unet.cfg))
    latent = port.cfg.latent_shape
    key = jax.random.key(1)
    x_T = np.asarray(jax.random.normal(jax.random.split(key)[1], (n, *latent), jnp.float32))
    encode = jax.jit(jmodel.get_learned_conditioning)
    c = encode(params, jnp.asarray(cond_in))
    uc = None if uncond_in is None else {cond_key: encode(params, jnp.asarray(uncond_in))}
    want_z = JS.ddim_sample(jmodel, params, key, (n, *latent), steps=steps,
                            cond={cond_key: c}, uncond=uc, cfg_scale=cfg_scale)
    want = np.asarray(jax.jit(jmodel.decode_first_stage)(params, want_z))
    got, _ = sample(port, cond_key, cond_in, n, steps, uncond_in=uncond_in,
                    cfg_scale=cfg_scale, x_T=torch.from_numpy(x_T))
    assert np.abs(np.asarray(want_z) - x_T).max() > 1e-2     # the U-Net moved the latent
    assert got.shape == want.shape and np.isfinite(got).all()
    assert 0 < (want == -1).mean() < 1                      # ray drop on part of the image
    assert rel_l2(got, want) < tol
    return got
