"""Fresh weights drawn as the JAX package's initialisers draw them.

A flax module starts from its layer's defaults: ``lecun_normal`` kernels
(a normal of std sqrt(1 / fan_in) truncated at two standard deviations,
rescaled to keep that std), zero biases, unit norm scales, and embeddings
from a normal of std sqrt(1 / features). torch's defaults differ (uniform
kernels and biases of bound sqrt(1 / fan_in), N(0, 1) embeddings), so a
port model built by torch starts from another distribution.
``jax_init_`` redraws a port model's parameters leaf by leaf with JAX's:

- the weight of every convolution (plain, transposed, circular, 1- to 3-D)
  and every linear: ``lecun_normal``, or ``he_normal`` (std sqrt(2 /
  fan_in), truncated likewise) inside ``nn/graph.MLP`` (JAX's
  ``build_mlp``); fan_in is the input channels of a group times the
  kernel's taps, as flax counts it. A weight that the module set to zeros
  stays zero: those are the explicit ``initializers.zeros`` of the JAX
  package (the U-Nets' output convs and attention projections, R2DM's
  ``conv_out``, the cube and 1-D U-Nets' output layers);
- their biases: zeros;
- ``nn.Embedding`` weights: N(0, 1 / features), but the VQ codebook, which
  keeps its explicit uniform ``taming`` init;
- every other parameter (norm scales and biases, positional tables, the
  relative-position tables, a learned logvar) already starts as JAX's
  explicit or default initialiser sets it, and is left as it is.

The draws come from a ``torch.Generator`` seeded with ``seed`` on the
model's device (all its parameters on one), in the order of
``named_modules``; JAX's PRNG stream cannot be matched, so the
distributions match, not the bits.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

# flax's truncated_normal(-2, 2) has std 0.87962566103423978 before its rescale
_TRUNC_STD = 0.87962566103423978
_CONVS = (nn.Conv1d, nn.Conv2d, nn.Conv3d)
_TRANSPOSED = (nn.ConvTranspose1d, nn.ConvTranspose2d, nn.ConvTranspose3d)


def _fan_in(module: nn.Module, w: torch.Tensor) -> int:
    """Inputs a unit of the output sums over, as flax counts them."""
    if isinstance(module, _TRANSPOSED):
        # torch keeps (in, out / groups, *k); flax's kernel is (*k, in, out)
        return w.shape[0] * math.prod(w.shape[2:])
    return math.prod(w.shape[1:])   # (out, in / groups, *k) or (out, in)


def _truncated_normal_(w: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """A normal cut at two standard deviations, rescaled to ``std``: draws
    past the cut are drawn again (a twentieth of them a round), which is
    the truncated normal and, on the CPU, six times faster than
    ``nn.init.trunc_normal_``'s inverse-CDF draw."""
    draw = torch.randn(w.shape, generator=gen, device=gen.device)
    out = draw.abs() > 2.0
    while bool(out.any()):
        draw[out] = torch.randn(int(out.sum()), generator=gen, device=gen.device)
        out = draw.abs() > 2.0
    with torch.no_grad():
        w.copy_((draw * (std / _TRUNC_STD)).to(w.dtype))


def _is_kernel_module(module: nn.Module) -> bool:
    from ..nn.conv import ZeroPaddedConv

    return isinstance(module, _CONVS + _TRANSPOSED + (nn.Linear, ZeroPaddedConv))


def jax_init_(model: nn.Module, seed: int) -> nn.Module:
    """Redraw ``model``'s parameters in place as the JAX package's
    initialisers draw them (see the module's doc); returns ``model``."""
    from ..nn.graph import MLP
    from ..nn.quantize import VectorQuantizer

    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    he = {id(m) for mlp in model.modules() if isinstance(mlp, MLP) for m in mlp.children()}
    codebooks = {id(q.embedding) for q in model.modules() if isinstance(q, VectorQuantizer)}
    with torch.no_grad():
        for module in model.modules():
            if _is_kernel_module(module):
                w = module.weight
                if bool(torch.any(w != 0)):
                    scale = 2.0 if id(module) in he else 1.0
                    _truncated_normal_(w, math.sqrt(scale / _fan_in(module, w)), gen)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.Embedding) and id(module) not in codebooks:
                w = module.weight
                draw = torch.randn(w.shape, generator=gen, device=gen.device)
                w.copy_((draw / math.sqrt(w.shape[1])).to(w.dtype))
    return model
