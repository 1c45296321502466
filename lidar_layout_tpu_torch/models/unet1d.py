"""1-D U-Net denoiser of LayoutDiffusion's object boxes, with graph message
passing.

Counterpart of ``lidar_layout_tpu/models/unet1d.py`` (``UNet1DConfig``,
``Norm32``, ``ResBlock1D``, ``Transformer1D``, ``UNet1DModel``). Each box is
a length-1 "sequence" of 8 channels (size3 + loc3 + sincos2). A 5-layer
GraphTripleConv over [object embedding | box embedding | box time embedding]
and the predicates gives each box a relation token. With
``conditioning_key`` "crossattn" (the YAML's) the U-Net's Transformer1Ds
attend to it; with "concat" it is concatenated to the box before
``conv_in``, and the Transformer1Ds attend to the scene-graph encoder's
latent; "hybrid" does both, attending to the token. The width-3
convolutions run over that length-1 signal, the stride-2 "downsample" too,
and the upsample is a no-op resize and a conv, as in the JAX package.
Activations are (N, L, C), as there; modules keep the flax names
(``in_0_0.in_norm``, ``in_1_0_attn.block_0``, ``box_graph_cov``, ...).

``Norm32`` is flax's ``nn.GroupNorm`` in the JAX package, not the Pallas
kernel, so here it is ``F.group_norm`` and not K3.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.attention import BasicTransformerBlock
from ..nn.embeddings import timestep_embedding
from ..nn.graph import GraphTripleConvNet


@dataclasses.dataclass(frozen=True)
class UNet1DConfig:
    """unet_config of configs/layout_diffusion/nuscenes/layout_nusc.yaml."""

    in_channels: int = 8
    model_channels: int = 512
    out_channels: int = 8
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2)
    channel_mult: Tuple[int, ...] = (1, 1, 1, 1)
    num_heads: int = 8
    transformer_depth: int = 1
    conditioning_key: str = "crossattn"
    concat_dim: int = 1280
    crossattn_dim: int = 1280
    enable_t_emb: bool = True
    dropout: float = 0.0
    gconv_dim: int = 64
    num_preds: int = 16


def norm32_groups(channels: int) -> int:
    """``min(32, C // 16)`` groups (at least 1): 32 at the reference's 512
    channels, and groups of 16 channels at narrower test widths."""
    return max(1, min(32, channels // 16))


class Norm32(nn.Module):
    """flax GroupNorm over (N, L, C), eps 1e-5, float32."""

    def __init__(self, channels: int):
        super().__init__()
        self.num_groups = norm32_groups(channels)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float().transpose(1, 2), self.num_groups, self.weight, self.bias,
                         1e-5)
        return y.transpose(1, 2).to(x.dtype)


class Conv3(nn.Conv1d):
    """flax ``nn.Conv`` of width 3, padding 1, on (N, L, C)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, zero: bool = False):
        super().__init__(cin, cout, 3, stride=stride, padding=1)
        if zero:
            nn.init.zeros_(self.weight)
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


def _zero_linear(cin: int, cout: int) -> nn.Linear:
    lin = nn.Linear(cin, cout)
    nn.init.zeros_(lin.weight)
    nn.init.zeros_(lin.bias)
    return lin


class ResBlock1D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, emb_dim: int,
                 dropout: float = 0.0):
        super().__init__()
        self.in_norm = Norm32(in_channels)
        self.in_conv = Conv3(in_channels, out_channels)
        self.emb_proj = nn.Linear(emb_dim, out_channels)
        self.out_norm = Norm32(out_channels)
        self.dropout = nn.Dropout(dropout)
        self.out_conv = Conv3(out_channels, out_channels, zero=True)
        self.skip = nn.Linear(in_channels, out_channels) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_conv(F.silu(self.in_norm(x)))
        h = h + self.emb_proj(F.silu(emb))[:, None, :]
        h = self.out_conv(self.dropout(F.silu(self.out_norm(h))))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class Transformer1D(nn.Module):
    def __init__(self, channels: int, heads: int, dim_head: int, depth: int = 1,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.depth = depth
        self.norm = Norm32(channels)
        self.proj_in = nn.Linear(channels, inner)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(inner, heads, dim_head,
                                                                context_dim))
        self.proj_out = _zero_linear(inner, channels)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.proj_in(self.norm(x))
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, context=context)
        return self.proj_out(h) + x


class UNet1DModel(nn.Module):
    """``forward(box_t (N, 8), obj_embed (N, obj_dim), triples (T, 3),
    timesteps (N,), context, pred_mask)`` -> (N, 8) eps. ``obj_dim`` is the
    scene-graph encoder's ``out_dim``."""

    def __init__(self, cfg: UNet1DConfig, obj_dim: int):
        super().__init__()
        if cfg.conditioning_key not in ("concat", "crossattn", "hybrid"):
            raise ValueError(f"unet1d conditioning_key {cfg.conditioning_key!r}: expected "
                             f"'concat', 'crossattn' or 'hybrid'")
        self.cfg = cfg
        mc = cfg.model_channels
        time_dim = mc * 4
        self.time_embed_0 = nn.Linear(mc, time_dim)
        self.time_embed_2 = nn.Linear(time_dim, time_dim)
        self.box_embeddings = nn.Linear(cfg.in_channels, cfg.gconv_dim)
        self.pred_embeddings = nn.Embedding(cfg.num_preds, cfg.gconv_dim * 2)
        gcn_in = obj_dim + cfg.gconv_dim
        if cfg.enable_t_emb:
            self.box_time_emb = nn.Linear(time_dim, cfg.gconv_dim)
            gcn_in += cfg.gconv_dim
        self.box_graph_cov = GraphTripleConvNet(gcn_in, cfg.gconv_dim * 2,
                                                hidden_dim=cfg.gconv_dim * 4,
                                                output_dim=cfg.concat_dim)
        dim_head = mc // cfg.num_heads
        concat = cfg.conditioning_key in ("concat", "hybrid")
        # the Transformer1Ds attend to the relation token, or with "concat"
        # to the context the caller passes (the encoder's latent, obj_dim wide)
        context_dim = obj_dim if cfg.conditioning_key == "concat" else cfg.concat_dim

        def res(name, cin, cout):
            self.add_module(name, ResBlock1D(cin, cout, time_dim, cfg.dropout))

        def attn(name, ch):
            self.add_module(name, Transformer1D(ch, cfg.num_heads, dim_head,
                                                cfg.transformer_depth, context_dim))

        self.conv_in = Conv3(cfg.in_channels + (cfg.concat_dim if concat else 0), mc)
        chans, ch, ds = [mc], mc, 1
        levels = len(cfg.channel_mult)
        for level, mult in enumerate(cfg.channel_mult):
            for i in range(cfg.num_res_blocks):
                res(f"in_{level}_{i}", ch, mc * mult)
                ch = mc * mult
                if ds in cfg.attention_resolutions:
                    attn(f"in_{level}_{i}_attn", ch)
                chans.append(ch)
            if level != levels - 1:
                self.add_module(f"down_{level}", Conv3(ch, ch, stride=2))
                chans.append(ch)
                ds *= 2
        res("mid_res1", ch, ch)
        attn("mid_attn", ch)
        res("mid_res2", ch, ch)
        for level in reversed(range(levels)):
            for i in range(cfg.num_res_blocks + 1):
                res(f"out_{level}_{i}", ch + chans.pop(), mc * cfg.channel_mult[level])
                ch = mc * cfg.channel_mult[level]
                if ds in cfg.attention_resolutions:
                    attn(f"out_{level}_{i}_attn", ch)
            if level != 0:
                self.add_module(f"up_{level}", Conv3(ch, ch))
                ds //= 2
        self.norm_out = Norm32(ch)
        self.conv_out = Conv3(ch, cfg.out_channels, zero=True)

    def _block(self, name: str, h: torch.Tensor, emb: torch.Tensor,
               ctx: torch.Tensor) -> torch.Tensor:
        h = getattr(self, name)(h, emb)
        attn = getattr(self, name + "_attn", None)
        return h if attn is None else attn(h, ctx)

    def forward(self, box_t: torch.Tensor, obj_embed: torch.Tensor, triples: torch.Tensor,
                timesteps: torch.Tensor, context: Optional[torch.Tensor] = None,
                pred_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        t_emb = timestep_embedding(timesteps, cfg.model_channels, flip_sin_to_cos=True)
        emb = self.time_embed_2(F.silu(self.time_embed_0(t_emb)))

        # box message passing: [object embedding | box embedding | box time embedding]
        obj_box = [obj_embed, self.box_embeddings(box_t)]
        if cfg.enable_t_emb:
            obj_box.append(self.box_time_emb(emb))
        rel, _ = self.box_graph_cov(torch.cat(obj_box, -1),
                                    self.pred_embeddings(triples[:, 1]),
                                    triples[:, [0, 2]], pred_mask)
        h, rel, ctx = box_t[:, None, :], rel[:, None, :], context
        if cfg.conditioning_key in ("concat", "hybrid"):
            h = torch.cat([h, rel], -1)             # (N, 1, 8 + concat_dim)
        if cfg.conditioning_key in ("crossattn", "hybrid"):
            ctx = rel                               # (N, 1, concat_dim)
        if ctx is not None and ctx.ndim == 2:
            ctx = ctx[:, None, :]

        levels = len(cfg.channel_mult)
        h = self.conv_in(h)
        hs = [h]
        for level in range(levels):
            for i in range(cfg.num_res_blocks):
                h = self._block(f"in_{level}_{i}", h, emb, ctx)
                hs.append(h)
            if level != levels - 1:
                h = getattr(self, f"down_{level}")(h)
                hs.append(h)
        h = self.mid_res2(self.mid_attn(self.mid_res1(h, emb), ctx), emb)
        for level in reversed(range(levels)):
            for i in range(cfg.num_res_blocks + 1):
                h = self._block(f"out_{level}_{i}", torch.cat([h, hs.pop()], -1), emb, ctx)
            if level != 0:
                h = getattr(self, f"up_{level}")(h)
        return self.conv_out(F.silu(self.norm_out(h)))[:, 0, :]
