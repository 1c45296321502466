"""Latent-diffusion U-Net (guided-diffusion architecture) with circular convs, NCHW.

Counterpart of ``lidar_layout_tpu/models/unet.py``. Modules carry the
reference openaimodel state_dict names (``time_embed.0``,
``input_blocks.k.0.in_layers.0``, ``middle_block.1.qkv``,
``output_blocks.k.1.proj_out``, ``out.2``, ...), so the JAX package's
``utils/torch_convert.convert_unet`` reads a port state_dict as it stands.
Every ResBlock GroupNorm goes through kernel K3 and every self-attention
through K1.

With ``use_spatial_transformer`` the attention slots hold
``nn/attention.SpatialTransformer`` (``input_blocks.k.1.norm``,
``.proj_in``, ``.transformer_blocks.i.attn1.to_q``, ...), whose
self-attention goes to K1 and whose cross-attention to the ``context``
tokens goes to plain attention, as JAX's ``attend`` sends a cross length to
XLA. With ``num_classes`` the label embedding ``label_emb`` is added to the
timestep embedding.

Under the spatial (``sp``) axis (``parallel/mesh.spatial_sharding``) the
U-Net runs on a W shard of the latent: its circular convs exchange halos,
its norms take K3's split form, each ``SelfAttentionBlock`` attends from
its shard's positions to every shard's keys (gathered) through the
cross-length K1 (``flash_attention_xl``), and the timestep embedding, the
skip concatenations and the nearest x2 upsampling stay local. A U-Net
with plain (non-circular) convs or SpatialTransformers has no sp path.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.attention import SpatialTransformer
from ..nn.blocks import Normalize
from ..nn.conv import CircularConv, Conv1x1
from ..nn.embeddings import timestep_embedding
from ..ops.attention import attend, flash_attention_xl
from ..parallel.collectives import all_gather_along, spatial_plan


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """unet_config params of the reference configs (e.g. uncond_c2_p4.yaml)."""

    in_channels: int = 8
    model_channels: int = 256
    out_channels: int = 8
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4)
    dropout: float = 0.0
    num_heads: int = -1
    num_head_channels: int = 32
    use_scale_shift_norm: bool = False
    resblock_updown: bool = False
    conv_resample: bool = True
    use_spatial_transformer: bool = False
    transformer_depth: int = 1
    context_dim: Optional[int] = None
    num_classes: Optional[int] = None
    cconv: bool = True  # lib_name == 'lidm'

    def heads_for(self, ch: int) -> Tuple[int, int]:
        """(num_heads, dim_head) resolution (openaimodel legacy rule)."""
        if self.num_head_channels == -1:
            return self.num_heads, ch // self.num_heads
        return ch // self.num_head_channels, self.num_head_channels


def _conv3(cin: int, cout: int, cconv: bool) -> nn.Module:
    if cconv:
        return CircularConv(cin, cout, (3, 3), (1, 1), 1)
    return nn.Conv2d(cin, cout, 3, padding=1)


class CircularConvZero(CircularConv):
    """Circular 3x3 conv that starts at zero (guided-diffusion zero_module)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, (3, 3), (1, 1), 1)
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)


def _zero_conv3(cin: int, cout: int, cconv: bool) -> nn.Module:
    if cconv:
        return CircularConvZero(cin, cout)
    conv = nn.Conv2d(cin, cout, 3, padding=1)
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


def _nearest_up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 2, 2)


class ResBlock(nn.Module):
    """guided-diffusion ResBlock with the timestep as a bias (or, with
    ``use_scale_shift_norm``, as a FiLM scale/shift on the second norm).

    The Sequential indices of the reference are kept for the state_dict
    (``in_layers.0`` norm, ``in_layers.2`` conv, ``emb_layers.1``,
    ``out_layers.0`` norm, ``out_layers.2`` dropout, ``out_layers.3`` conv);
    the SiLU slots are empty because kernel K3 fuses the SiLU into the norm.
    Dropout acts in train mode only, as flax's with ``deterministic=False``.
    """

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 use_scale_shift_norm: bool = False, cconv: bool = True,
                 up: bool = False, down: bool = False, dropout: float = 0.0):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down = up, down
        self.in_layers = nn.ModuleList([Normalize(channels, act=True), nn.Identity(),
                                        _conv3(channels, out_channels, cconv)])
        self.emb_layers = nn.ModuleList([nn.SiLU(), nn.Linear(
            emb_channels, 2 * out_channels if use_scale_shift_norm else out_channels)])
        self.out_layers = nn.ModuleList([
            Normalize(out_channels, act=not use_scale_shift_norm), nn.Identity(),
            nn.Dropout(dropout), _zero_conv3(out_channels, out_channels, cconv)])
        self.skip_connection = (Conv1x1(channels, out_channels)
                                if channels != out_channels else nn.Identity())

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers[0](x)
        if self.up:
            h, x = _nearest_up2(h), _nearest_up2(x)
        elif self.down:
            h, x = _avg_pool2(h), _avg_pool2(x)
        h = self.in_layers[2](h)
        emb_out = self.emb_layers[1](F.silu(emb))[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = F.silu(self.out_layers[0](h) * (1 + scale) + shift)
        else:
            h = self.out_layers[0](h + emb_out)
        h = self.out_layers[3](self.out_layers[2](h))
        return self.skip_connection(x) + h


class SelfAttentionBlock(nn.Module):
    """Multi-head self-attention over spatial positions (openaimodel
    AttentionBlock, legacy QKV order).

    ``qkv`` and ``proj_out`` are 1-D convs as in the reference state_dict. The
    qkv channels are heads-major, [h0:(q, k, v), h1:(q, k, v), ...]
    (QKVAttentionLegacy), so the projection is split per head, never as
    [q(all heads), k, v]; a wrong split would mix heads silently.
    """

    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm = Normalize(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        heads, dh = self.num_heads, c // self.num_heads
        y = self.norm(x).reshape(b, c, h * w).transpose(1, 2)          # (B, S, C)
        qkv = F.linear(y, self.qkv.weight[:, :, 0], self.qkv.bias)     # (B, S, 3C)
        qkv = qkv.view(b, h * w, heads, 3, dh)
        q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]   # BSHD views
        plan = spatial_plan()
        if plan is None:
            out = attend(q, k, v)
        else:   # this shard's queries against every shard's keys
            kv = all_gather_along(qkv[:, :, :, 1:], 1, plan.group)
            out = flash_attention_xl(q.transpose(1, 2), kv[:, :, :, 0].transpose(1, 2),
                                     kv[:, :, :, 1].transpose(1, 2)).transpose(1, 2)
        out = out.reshape(b, h * w, c)
        out = F.linear(out, self.proj_out.weight[:, :, 0], self.proj_out.bias)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class UNetDown(nn.Module):
    """Downsample: stride-2 conv (``op``) when use_conv, else average pooling."""

    def __init__(self, channels: int, cconv: bool, use_conv: bool = True):
        super().__init__()
        self.op = None
        if use_conv:
            self.op = (CircularConv(channels, channels, (3, 3), (2, 2), 1) if cconv
                       else nn.Conv2d(channels, channels, 3, 2, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _avg_pool2(x) if self.op is None else self.op(x)


class UNetUp(nn.Module):
    """Upsample: nearest x2, then a conv only when use_conv."""

    def __init__(self, channels: int, cconv: bool, use_conv: bool = True):
        super().__init__()
        self.conv = _conv3(channels, channels, cconv) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _nearest_up2(x)
        return x if self.conv is None else self.conv(x)


class _Block(nn.ModuleList):
    """TimestepEmbedSequential: a ResBlock takes (x, emb), a
    SpatialTransformer (x, context, context_mask), the rest x."""

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, context, context_mask)
            else:
                x = layer(x)
        return x


class UNetModel(nn.Module):
    """The openaimodel U-Net; ``forward`` takes and returns NCHW, output
    float32."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        ted = mc * 4
        self.time_embed = nn.Sequential(nn.Linear(mc, ted), nn.SiLU(), nn.Linear(ted, ted))
        if cfg.num_classes is not None:
            self.label_emb = nn.Embedding(cfg.num_classes, ted)

        def res(cin: int, cout: int, **kw) -> ResBlock:
            return ResBlock(cin, ted, cout, cfg.use_scale_shift_norm, cfg.cconv,
                            dropout=cfg.dropout, **kw)

        def attn(ch: int) -> nn.Module:
            heads, dim_head = cfg.heads_for(ch)
            if cfg.use_spatial_transformer:
                return SpatialTransformer(ch, heads, dim_head, cfg.transformer_depth,
                                          cfg.context_dim)
            return SelfAttentionBlock(ch, heads)

        self.input_blocks = nn.ModuleList([_Block([_conv3(cfg.in_channels, mc, cfg.cconv)])])
        chans: List[int] = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [res(ch, mc * mult)]
                ch = mc * mult
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(_Block(layers))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                down = (res(ch, ch, down=True) if cfg.resblock_updown
                        else UNetDown(ch, cfg.cconv, cfg.conv_resample))
                self.input_blocks.append(_Block([down]))
                chans.append(ch)
                ds *= 2

        self.middle_block = _Block([res(ch, ch), attn(ch), res(ch, ch)])

        self.output_blocks = nn.ModuleList()
        for level in reversed(range(len(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                layers = [res(ch + chans.pop(), mc * cfg.channel_mult[level])]
                ch = mc * cfg.channel_mult[level]
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch))
                if level and i == cfg.num_res_blocks:
                    layers.append(res(ch, ch, up=True) if cfg.resblock_updown
                                  else UNetUp(ch, cfg.cconv, cfg.conv_resample))
                    ds //= 2
                self.output_blocks.append(_Block(layers))

        self.out = nn.ModuleList([Normalize(ch, act=True), nn.Identity(),
                                  _zero_conv3(ch, cfg.out_channels, cfg.cconv)])

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, C, H, W); context (B, S, context_dim) tokens for the
        SpatialTransformers, context_mask (B, S) True = attend; y (B,)
        class labels when ``num_classes`` is set."""
        if spatial_plan() is not None and (not self.cfg.cconv
                                           or self.cfg.use_spatial_transformer):
            raise NotImplementedError("the sp axis shards a U-Net of circular convs and "
                                      "self-attention blocks only")
        dtype = self.out[2].weight.dtype
        emb = self.time_embed(timestep_embedding(timesteps, self.cfg.model_channels)
                              .to(dtype))
        if self.cfg.num_classes is not None:
            if y is None:
                raise ValueError("a class-conditional U-Net needs the labels y")
            emb = emb + self.label_emb(y)
        if context is not None:
            context = context.to(dtype)
        h = x.to(dtype)
        hs = []
        for block in self.input_blocks:
            h = block(h, emb, context, context_mask)
            hs.append(h)
        h = self.middle_block(h, emb, context, context_mask)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, context, context_mask)
        return self.out[2](self.out[0](h)).float()

