"""Weight carrier: the JAX package's parameter tree -> the port's state_dicts.

The inverse of ``lidar_layout_tpu/utils/torch_convert.convert_unet`` and
``convert_vq_autoencoder``. Input is the tree of numpy arrays that
``LatentDiffusion.init`` returns in the JAX package
(``{"unet": {"params": ...}, "first_stage": {"params": ...}}``); output uses
the reference torch names that the port's modules carry.

Conventions: flax conv kernels HWIO -> torch OIHW; flax ``Dense`` kernels
(in, out) -> torch (out, in); GroupNorm ``scale`` -> ``weight``. The U-Net
``qkv`` projection is [q(all heads), k, v] in flax and heads-major
[h0:(q, k, v), h1:(q, k, v), ...] in the reference conv1d (QKVAttentionLegacy).
``rangenet_state_dict`` carries the JAX ``RangeNet`` init tree (``params`` and
``batch_stats``) into the port's ``eval/rangenet.RangeNet``.

The layout-conditioned model (``layout_unet_state_dict``,
``layout_encoder_state_dict``, and ``latent_diffusion_state_dict`` with a
``cond_stage`` tree): the repository holds no reference torch names for its
object-aware U-Net and layout encoder, so their port modules keep the JAX
module names (``in_1_0_attn.layout_position_proj``, ``attn_0.query``, ...),
except where the layout U-Net shares the flagship's structure: the timestep
MLP is ``time_embed.0``/``.2`` and a ResBlock's layers are ``in_layers``,
``emb_layers``, ``out_layers`` and ``skip_connection``, as above.

LayoutDiffusion (``layout_diffusion_state_dict``): the port's modules keep
every flax name, so a leaf's path is its module path: Dense ``(in, out)``
and width-3 Conv ``(3, in, out)`` kernels are reversed to torch's ``(out,
in)`` and ``(out, in, 3)``, Embed tables and the GroupNorm / LayerNorm
scale and bias carry across as ``weight`` and ``bias``.
``layout_train_state_dicts`` carries a JAX LayoutDiffusion train state's
``params`` and ``ema`` so.

The autoencoder's train state (``ae_train_state_dicts``): ``params_g``
through ``vq_state_dict``, and the discriminator's ``params_d``
(``losses/discriminator``, flax names kept): conv kernels HWIO -> OIHW, the
``conv`` level of a ``CircularConv`` dropped, GroupNorm ``scale`` ->
``weight``.

The FSVD/FPVD nets: ``seg_net_state_dict`` carries JAX's MinkowskiNet /
SPVCNN params into the reference torchsparse names the port keeps (the
inverse of ``convert_torchsparse_state_dict``), ``dense_tree_state_dict``
a tree of Dense and LayerNorm modules (``SparseVoxelNet``,
``SparseConvBlock``, the cube stage's ``SparseVAE``), and ``load_torchsparse_checkpoint`` reads the
reference's ``model.ckpt``.

The point models keep the flax names as well: ``dense_tree_state_dict``
carries a JAX ``PTv3``, ``DenseDecoder`` or ``PTv3Segmentor`` tree (Dense
kernels reversed, LayerNorm ``scale`` -> ``weight``; the CPE's depthwise
window-3 ``nn.Conv`` kernel (3, 1, C) reversed to ``Conv1d``'s (C, 1, 3);
``rpe_table`` as it is). ``vq_state_dict`` carries a ``VQModelGaus`` tree:
its ``gaus_decoder.tower`` (a Decoder that ends before its norm), the
``norm_out`` GroupNorm and the ``CircularConv`` heads (``rot_out.conv1``,
...) follow the autoencoder's rules.

The point-backbone zoo (``models/ptv1``, ``ptv2``, ``spunet``,
``stratified``, ``swin3d``, ``octformer``) keeps the flax names:
``dense_tree_state_dict`` carries each (tables, ``rpe_table`` and the
depthwise ``w`` as they are); ``sonata_state_dict`` a ``Sonata`` state's
two towers and its center.

The cube stage keeps every flax name too: ``cube_diffusion_state_dict``
carries a JAX ``CubeDiffusion`` tree (``{"unet": ...}``, under ``unet.``)
with, when given, its first stage's ``SparseVAE`` tree (under
``first_stage_model.``).

Conditioning: ``unet_state_dict`` also carries a SpatialTransformer U-Net
(flax ``norm``, ``proj_in``, ``block_i``, ``proj_out`` under an attention
slot -> ``norm``, ``proj_in``, ``transformer_blocks.i``, ``proj_out``; 1x1
conv kernels HWIO -> OIHW) and ``label_emb``. ``cond_stage_state_dict``
carries the encoders of ``encoders/modules`` (``ClassEmbedder``,
``SpatialRescaler``, the CLIP towers and wrappers, ``TransformerEmbedder``,
``BERTEmbedder``): a flax tower's ``ln1_i`` ... ``mlp_out_i`` become
``layers.i.ln1`` ... ``layers.i.mlp_out``, the attention's DenseGeneral
kernels, (in, heads, dh) and (heads, dh, out), become linear weights over
the heads' concatenated width, Embed tables ``weight``.
``latent_diffusion_state_dict`` puts such a stage under
``cond_stage_model.``. ``classifier_state_dict`` carries a JAX
``EncoderUNetModel`` (flax names kept; ResBlock layers as the U-Net's).

The last families keep the flax names too. ``r2dm_state_dict`` carries a
JAX ``R2DMDiffusion`` tree (``{"unet": ...}``, under ``unet.``): conv
kernels HWIO -> OIHW (a ``CircularConv``'s ``conv`` level and a
``Normalize``'s ``GroupNorm_0`` dropped), the attention's DenseGeneral
kernels flattened over the heads as the conditioning towers'.
``dense_tree_state_dict`` carries a ``VQModelObject`` tree (Dense kernels
reversed, LayerNorm ``scale`` -> ``weight``, the codebook to
``quantize.embedding.weight``). The KL autoencoder's tree has the VQ
model's names, so ``vq_state_dict`` (and ``ae_train_state_dicts`` for its
train state) carry it.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Tuple, Union

import numpy as np
import torch

from ..models.object_cross_unet import LayoutUNetConfig
from ..models.unet import UNetConfig

_RES = {"in_norm": "in_layers.0", "in_conv": "in_layers.2", "emb_proj": "emb_layers.1",
        "out_norm": "out_layers.0", "out_conv": "out_layers.3", "skip": "skip_connection"}
_AE = [(re.compile(r"^(down|up)_(\d+)_(block|attn)_(\d+)$"), r"\1.\2.\3.\4"),
       (re.compile(r"^(down|up)_(\d+)_(downsample|upsample)$"), r"\1.\2.\3"),
       (re.compile(r"^mid_(block_\d+|attn_\d+)$"), r"mid.\1")]


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _leaf(mods: Tuple[str, ...], leaf: str, value: np.ndarray
          ) -> Tuple[Tuple[str, ...], np.ndarray]:
    """One flax leaf below a module path -> (torch module path + name, value)."""
    mods = tuple(m for m in mods if m != "GroupNorm_0")
    if mods and mods[-1] == "conv":          # the flax Conv inside a conv module
        mods = mods[:-1]
        if leaf == "kernel":
            return mods + ("weight",), np.transpose(value, (3, 2, 0, 1))
        return mods + (leaf,), value
    if leaf == "kernel":                     # Dense
        return mods + ("weight",), value.T
    if leaf == "scale":
        return mods + ("weight",), value
    if leaf == "embedding":
        return mods + ("embedding", "weight"), value
    return mods + (leaf,), value


def _unet_names(cfg: UNetConfig) -> Dict[str, str]:
    """flax module name -> reference openaimodel prefix, in construction order."""
    names = {"time_embed_0": "time_embed.0", "time_embed_2": "time_embed.2",
             "conv_in": "input_blocks.0.0", "mid_res1": "middle_block.0",
             "mid_attn": "middle_block.1", "mid_res2": "middle_block.2",
             "norm_out": "out.0", "conv_out": "out.2"}
    levels = len(cfg.channel_mult)
    k, ds = 1, 1
    for level in range(levels):
        for i in range(cfg.num_res_blocks):
            names[f"in_{level}_{i}_res"] = f"input_blocks.{k}.0"
            if ds in cfg.attention_resolutions:
                names[f"in_{level}_{i}_attn"] = f"input_blocks.{k}.1"
            k += 1
        if level != levels - 1:
            names[f"down_{level}"] = f"input_blocks.{k}.0"
            k += 1
            ds *= 2
    k = 0
    for level in reversed(range(levels)):
        for i in range(cfg.num_res_blocks + 1):
            names[f"out_{level}_{i}_res"] = f"output_blocks.{k}.0"
            slot = 1
            if ds in cfg.attention_resolutions:
                names[f"out_{level}_{i}_attn"] = f"output_blocks.{k}.1"
                slot = 2
            if level and i == cfg.num_res_blocks:
                names[f"up_{level}"] = f"output_blocks.{k}.{slot}"
                ds //= 2
            k += 1
    return names


_TOWER_LAYER = re.compile(r"^(ln1|ln2|attn|mlp_in|mlp_out)_(\d+)$")
_ST_BLOCK = re.compile(r"^block_(\d+)$")


def _module_leaf(mods: Tuple[str, ...], leaf: str, value: np.ndarray
                 ) -> Tuple[Tuple[str, ...], np.ndarray]:
    """A flax leaf of a conditioning encoder or a SpatialTransformer -> the
    port's name and value: tower layers and transformer blocks renamed,
    conv kernels HWIO -> OIHW, DenseGeneral kernels and biases flattened
    over the heads, Dense kernels reversed, ``scale`` and ``embedding`` ->
    ``weight``, parameters (positions, class token) as they are."""
    names: Tuple[str, ...] = ()
    for m in mods:
        tower, block = _TOWER_LAYER.match(m), _ST_BLOCK.match(m)
        names += (("layers", tower[2], tower[1]) if tower
                  else ("transformer_blocks", block[1]) if block else (m,))
    if leaf == "kernel":
        if value.ndim == 4:
            value = np.transpose(value, (3, 2, 0, 1))
        elif value.ndim == 3:
            value = (value.reshape(-1, value.shape[-1]).T if mods[-1] == "out"
                     else value.reshape(value.shape[0], -1).T)
        else:
            value = value.T
        return names + ("weight",), value
    if leaf in ("scale", "embedding"):
        return names + ("weight",), value
    if leaf == "bias":
        return names + (leaf,), value.reshape(-1)
    return names + (leaf,), value


def cond_stage_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX conditioning stage's params (``ClassEmbedder``,
    ``SpatialRescaler``, a CLIP tower or wrapper, ``TransformerEmbedder``,
    ``BERTEmbedder``, ``XTransformerBERTEmbedder``, whose ``Encoder_0``
    becomes ``transformer.attn_layers``, or an ``x_transformer`` module)
    -> the port module's state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params.get("params", params)):
        if path[0] == "Encoder_0":       # XTransformerBERTEmbedder's stack
            path = ("transformer", "attn_layers") + path[1:]
        name, value = _module_leaf(path[:-1], path[-1], value)
        out[".".join(name)] = torch.from_numpy(np.array(value))
    return out


def unet_state_dict(params: Dict[str, Any], cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """JAX ``UNetModel`` params (with or without the "params" level) -> the
    port's ``UNetModel`` state_dict."""
    params = params.get("params", params)
    names = _unet_names(cfg)
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        if path[0] == "label_emb":
            out["label_emb.weight"] = torch.from_numpy(np.ascontiguousarray(value))
            continue
        top, mods, leaf = names[path[0]], path[1:-1], path[-1]
        if path[0].endswith("_attn") and cfg.use_spatial_transformer:
            name, value = _module_leaf(mods, leaf, value)
        elif path[0].endswith("_attn") and mods and mods[0] in ("qkv", "proj_out"):
            c = value.shape[0] // 3 if (mods[0], leaf) == ("qkv", "bias") else value.shape[0]
            if mods[0] == "qkv":
                heads, dh = cfg.heads_for(c)
                if leaf == "kernel":   # (C, 3C) -> (3C, C, 1) heads-major
                    value = (value.T.reshape(3, heads, dh, c).transpose(1, 0, 2, 3)
                             .reshape(3 * c, c)[:, :, None])
                else:                  # (3C,)
                    value = value.reshape(3, heads, dh).transpose(1, 0, 2).reshape(3 * c)
            elif leaf == "kernel":     # proj_out (C, C) -> (C, C, 1)
                value = value.T[:, :, None]
            name = (mods[0], "weight" if leaf == "kernel" else leaf)
        else:
            if "_res" in path[0]:
                mods = (_RES[mods[0]],) + mods[1:]
            name, value = _leaf(mods, leaf, value)
        out[".".join((top,) + name)] = torch.from_numpy(np.ascontiguousarray(value))
    return out


_LAYOUT_RES = re.compile(r"^(in_\d+_\d+|out_\d+_\d+|mid_res\d)$")


def layout_unet_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``LayoutDiffusionUNetModel`` params -> the port's
    ``models/object_cross_unet.LayoutDiffusionUNetModel`` state_dict."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        top, mods, leaf = path[0], path[1:-1], path[-1]
        if top in ("time_0", "time_2"):
            top = "time_embed." + top[-1]
        elif _LAYOUT_RES.match(top):
            mods = (_RES[mods[0]],) + mods[1:]
        name, value = _leaf(mods, leaf, value)
        out[".".join((top,) + name)] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def layout_encoder_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``LayoutTransformerEncoder`` params -> the port's
    ``encoders/layout_encoder.LayoutTransformerEncoder`` state_dict. The
    attention's ``DenseGeneral`` kernels, (in, heads, dh) for q/k/v and
    (heads, dh, out) for ``out``, become (heads*dh, in) and (out, heads*dh)."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        mods, leaf = path[:-1], path[-1]
        if leaf == "embedding":
            name = mods + ("weight",)
        elif leaf == "kernel" and value.ndim == 3:
            name = mods + ("weight",)
            value = (value.reshape(-1, value.shape[-1]).T if mods[-1] == "out"
                     else value.reshape(value.shape[0], -1).T)
        elif leaf == "bias" and value.ndim == 2:
            name, value = mods + (leaf,), value.reshape(-1)
        else:
            name, value = _leaf(mods, leaf, value)
        out[".".join(name)] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def vq_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``VQModelInterface`` params -> the port's ``VQModelInterface``
    state_dict."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        mods = []
        for m in path[:-1]:
            for pat, rep in _AE:
                m = pat.sub(rep, m)
            mods.extend(m.split("."))
        name, value = _leaf(tuple(mods), path[-1], value)
        out[".".join(name)] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def latent_diffusion_state_dict(params: Dict[str, Any], unet_cfg: Union[UNetConfig,
                                                                         LayoutUNetConfig]
                                ) -> Dict[str, torch.Tensor]:
    """JAX ``LatentDiffusion.init`` tree -> the port's ``LatentDiffusion``
    state_dict (``model.diffusion_model.*``, ``first_stage_model.*`` and, for
    the layout model, ``cond_stage_model.*``)."""
    unet = (layout_unet_state_dict(params["unet"]) if isinstance(unet_cfg, LayoutUNetConfig)
            else unet_state_dict(params["unet"], unet_cfg))
    sd = {f"model.diffusion_model.{k}": v for k, v in unet.items()}
    if params.get("first_stage"):
        sd.update({f"first_stage_model.{k}": v
                   for k, v in vq_state_dict(params["first_stage"]).items()})
    if params.get("cond_stage"):
        encoder = (layout_encoder_state_dict if isinstance(unet_cfg, LayoutUNetConfig)
                   else cond_stage_state_dict)
        sd.update({f"cond_stage_model.{k}": v
                   for k, v in encoder(params["cond_stage"]).items()})
    return sd


def classifier_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``EncoderUNetModel`` params -> the port's ``EncoderUNetModel``
    state_dict (``models/classifier``)."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params.get("params", params)):
        top, mods = path[0], path[1:-1]
        if top.startswith("enc_"):
            mods = (_RES[mods[0]],) + mods[1:]
        name, value = _leaf(mods, path[-1], value)
        out[".".join((top,) + name)] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def layout_diffusion_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``LayoutDiffusion.init`` tree ``{"unet", "cond_stage"}`` (numpy)
    -> the port's ``models/layout_diffusion.LayoutDiffusion`` state_dict
    (``unet.*``, ``cond_stage.*``)."""
    out: Dict[str, torch.Tensor] = {}
    for part in ("unet", "cond_stage"):
        tree = params[part].get("params", params[part])
        for path, value in _flatten(tree):
            mods, leaf = tuple(m for m in path[:-1] if m != "GroupNorm_0"), path[-1]
            if leaf == "kernel":
                leaf, value = "weight", value.T      # (in, out) / (3, in, out) reversed
            elif leaf in ("scale", "embedding"):
                leaf = "weight"
            out[".".join((part,) + mods + (leaf,))] = torch.from_numpy(
                np.ascontiguousarray(value))
    return out


def layout_train_state_dicts(state: Any) -> Tuple[Dict[str, torch.Tensor],
                                                   Dict[str, torch.Tensor]]:
    """A JAX ``SimpleTrainState`` of LayoutDiffusion (``train/build``; its
    ``params`` and ``ema`` trees, numpy or JAX leaves) -> (the port model's
    state_dict, its EMA's), both through ``layout_diffusion_state_dict``."""
    return (layout_diffusion_state_dict(state.params),
            layout_diffusion_state_dict(state.ema))


def discriminator_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``NLayerDiscriminator`` / ``LiDARNLayerDiscriminator`` params ->
    the port's discriminator state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params.get("params", params)):
        mods, leaf = tuple(m for m in path[:-1] if m != "conv"), path[-1]
        if leaf == "kernel":
            leaf, value = "weight", np.transpose(value, (3, 2, 0, 1))
        elif leaf == "scale":
            leaf = "weight"
        out[".".join(mods + (leaf,))] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def ae_train_state_dicts(state: Any) -> Tuple[Dict[str, torch.Tensor],
                                               Dict[str, torch.Tensor]]:
    """A JAX ``AETrainState`` (``train/ae_trainer``; its ``params_g`` and
    ``params_d``, numpy or JAX leaves) -> (the port VQModel's state_dict,
    the port discriminator's)."""
    return vq_state_dict(state.params_g), discriminator_state_dict(state.params_d)


_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def rangenet_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``RangeNet`` variables (``params`` and ``batch_stats``) -> the port's
    ``RangeNet`` state_dict. Convolutions HWIO -> OIHW; the decoder's
    ``upconv`` HWIO -> IOHW with the kernel flipped along W, which is how a
    flax ConvTranspose((1, 4), (1, 2), "SAME") equals torch's
    ConvTranspose2d(k=(1, 4), s=(1, 2), p=(0, 1)); BatchNorm
    scale/bias/mean/var -> weight/bias/running_mean/running_var."""
    out: Dict[str, torch.Tensor] = {}
    for col in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(col, {})):
            mods = tuple(m for m in path[:-1] if m != "BatchNorm_0")
            leaf = path[-1]
            scope = "decoder" if mods[0].startswith("dec") else "backbone"
            if leaf == "kernel":
                value = (np.transpose(value, (2, 3, 0, 1))[..., ::-1] if mods[-1] == "upconv"
                         else np.transpose(value, (3, 2, 0, 1)))
                name = "weight"
            elif mods[-1] == "upconv":
                name = leaf
            else:
                name = _BN_LEAVES[leaf]
            out[".".join((scope,) + mods + (name,))] = torch.from_numpy(
                np.ascontiguousarray(value))
            if leaf == "mean":
                out[".".join((scope,) + mods + ("num_batches_tracked",))] = torch.tensor(0)
    return out


_SEG_RES = {"conv0": "net.0", "bn0": "net.1", "conv1": "net.3", "bn1": "net.4",
            "down_conv": "downsample.0", "down_bn": "downsample.1"}
_SEG_MODULES = [(re.compile(r"^stem(\d)$"), lambda m: f"stem.{3 * int(m[1])}"),
                (re.compile(r"^stem_bn(\d)$"), lambda m: f"stem.{3 * int(m[1]) + 1}"),
                (re.compile(r"^stage(\d)_down$"), lambda m: f"stage{m[1]}.0.net"),
                (re.compile(r"^stage(\d)_res(\d)$"), lambda m: f"stage{m[1]}.{int(m[2]) + 1}"),
                (re.compile(r"^up(\d)_deconv$"), lambda m: f"up{m[1]}.0.net"),
                (re.compile(r"^up(\d)_res(\d)$"), lambda m: f"up{m[1]}.1.{m[2]}"),
                (re.compile(r"^pt(\d)$"), lambda m: f"point_transforms.{m[1]}"),
                (re.compile(r"^classifier$"), lambda m: "classifier.0")]
_SEG_SUB = {"conv": "0", "bn": "1", "linear": "0", **_SEG_RES}


def seg_net_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``MinkowskiNet`` / ``SPVCNN`` params (``{"params":
    ...}``, numpy or JAX leaves) -> the port's state_dict under the reference
    torchsparse names: the inverse of ``convert_torchsparse_state_dict``.
    Conv kernels copy straight across (both packages keep torchsparse's
    layout); Dense kernels (in, out) -> ``weight`` (out, in); BatchNorm
    scale/bias/mean/var -> weight/bias/running_mean/running_var, with a
    ``num_batches_tracked`` of 0."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params.get("params", params)):
        top, subs, leaf = path[0], path[1:-1], path[-1]
        name = next(fn(m) for m, fn in ((pat.match(top), fn) for pat, fn in _SEG_MODULES) if m)
        name = ".".join([name] + [_SEG_SUB[s] for s in subs])
        if leaf == "kernel" and (top.startswith("pt") or top == "classifier"):
            leaf, value = "weight", value.T
        else:
            leaf = _BN_LEAVES.get(leaf, leaf)
        out[f"{name}.{leaf}"] = torch.from_numpy(np.array(value))
        if leaf == "running_mean":
            out[f"{name}.num_batches_tracked"] = torch.tensor(0)
    return out


def dense_tree_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX tree of Dense and LayerNorm modules (``SparseVoxelNet``,
    ``SparseConvBlock``, ``PTv3``, ``DenseDecoder``, ``PTv3Segmentor``) ->
    the port's state_dict under the flax names: kernels reversed ((in, out)
    -> ``weight`` (out, in); a depthwise conv's (3, 1, C) -> (C, 1, 3)),
    LayerNorm ``scale`` -> ``weight``, other leaves as they are."""
    return {".".join(name): torch.from_numpy(np.array(value))
            for name, value in (_leaf(p[:-1], p[-1], v)
                                for p, v in _flatten(params.get("params", params)))}


def sonata_state_dict(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``Sonata`` state (``{"student", "teacher", "center"}``) -> the
    port's ``Sonata`` state_dict (``student.*``, ``teacher.*``, ``center``)."""
    out = {f"{tower}.{k}": v for tower in ("student", "teacher")
           for k, v in dense_tree_state_dict(state[tower]).items()}
    out["center"] = torch.from_numpy(np.array(state["center"]))
    return out


def cube_diffusion_state_dict(params: Dict[str, Any], first_stage: Any = None
                              ) -> Dict[str, torch.Tensor]:
    """JAX ``CubeDiffusion`` params (``{"unet": ...}``) and, optionally, its
    first stage's ``SparseVAE`` params -> the port's ``CubeDiffusion``
    state_dict."""
    out = {f"unet.{k}": v for k, v in dense_tree_state_dict(params["unet"]).items()}
    if first_stage is not None:
        out.update({f"first_stage_model.{k}": v
                    for k, v in dense_tree_state_dict(first_stage).items()})
    return out


def load_torchsparse_checkpoint(net: torch.nn.Module, path: str) -> torch.nn.Module:
    """The reference's MinkowskiNet / SPVCNN ``model.ckpt`` (its
    ``state_dict``) into ``net``, strict on every key but BatchNorm's
    ``num_batches_tracked``, which eval mode never reads."""
    sd = torch.load(path, map_location="cpu", weights_only=True)["state_dict"]
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    result = net.load_state_dict(sd, strict=False)
    missing = [k for k in result.missing_keys if not k.endswith("num_batches_tracked")]
    if missing or result.unexpected_keys:
        raise KeyError(f"{path} does not match {type(net).__name__}: missing {missing[:8]}, "
                       f"unexpected {result.unexpected_keys[:8]}")
    return net


def r2dm_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``R2DMDiffusion.init`` tree (``{"unet": {"params": ...}}``, or
    the U-Net's own) -> the port's ``R2DMDiffusion`` state_dict."""
    tree = params.get("unet", params)
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(tree.get("params", tree)):
        mods = tuple(m for m in path[:-1] if m not in ("conv", "GroupNorm_0"))
        name, value = _module_leaf(mods, path[-1], value)
        out["unet." + ".".join(name)] = torch.from_numpy(np.ascontiguousarray(value))
    return out
