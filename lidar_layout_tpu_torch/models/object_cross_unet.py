"""Object-aware cross-attention U-Net of the layout-conditioned range LiDM, NCHW.

Counterpart of ``lidar_layout_tpu/models/object_cross_unet.py``
(``LayoutUNetConfig``, ``ObjectAwareCrossAttention``,
``LayoutDiffusionUNetModel``). Image patches attend to [patches + layout
tokens], with bbox positional embeddings concatenated onto q and k, and
padding slots of the layout hidden from the keys. The timestep embedding is
fused with the layout's global projection ``xf_proj``.

The ResBlocks, convs and resampling are the flagship U-Net's
(``models/unet.py``); every ``Normalize`` goes through kernel K3. Modules
keep the JAX names (``conv_in``, ``in_1_0``, ``in_1_0_attn``, ``down_0``,
``mid_res1``, ``up_2``, ``norm_out``, ``conv_out``, ...), except the
timestep MLP, ``time_embed.0``/``.2`` as in the flagship. In a model of
another dtype the attention's position and content projections, its three
token GroupNorms and ``proj_out`` stay float32 (``f32_parameters``), as the
JAX package builds them without a dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.blocks import Normalize
from ..nn.conv import Conv1x1
from ..nn.embeddings import timestep_embedding
from .unet import ResBlock, UNetDown, UNetUp, _conv3, _zero_conv3


@dataclasses.dataclass(frozen=True)
class LayoutUNetConfig:
    in_channels: int = 8
    model_channels: int = 256
    out_channels: int = 8
    num_res_blocks: int = 2
    channel_mult: Tuple[int, ...] = (1, 2, 4)
    attention_ds: Tuple[int, ...] = (1, 2, 4)   # ds levels with attention
    encoder_channels: int = 256                  # layout encoder hidden dim
    num_head_channels: int = 64
    dropout: float = 0.1
    use_scale_shift_norm: bool = True
    pos_scale: float = 1.0                       # channels_scale_for_pos_emb
    image_size: Tuple[int, int] = (8, 128)
    cconv: bool = True


class TokenGroupNorm(nn.Module):
    """flax ``GroupNorm`` on (B, L, C) tokens: ``min(32, C)`` groups, eps
    1e-5, statistics over the tokens and the group's channels, float32."""

    def __init__(self, channels: int):
        super().__init__()
        self.num_groups = min(32, channels)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(t.float().transpose(1, 2), self.num_groups, self.weight,
                         self.bias, 1e-5)
        return y.transpose(1, 2)


class ObjectAwareCrossAttention(nn.Module):
    """Image patches attend to [patches + layout tokens]; q and k carry bbox
    positional channels, v does not, so the head widths differ and the
    attention is plain matmuls (as the JAX package's einsums)."""

    def __init__(self, channels: int, heads: int, res_key: int, encoder_channels: int,
                 pos_scale: float = 1.0):
        super().__init__()
        self.heads, self.res_key = heads, res_key
        pos_c = int(channels * pos_scale)
        self.norm_qkv = Normalize(channels)
        self.qkv = Conv1x1(channels, 3 * channels)
        self.layout_position_proj = nn.Linear(encoder_channels, pos_c)
        self.norm_img_pos = TokenGroupNorm(pos_c)
        self.norm_lay_pos = TokenGroupNorm(pos_c)
        self.norm_obj_class = TokenGroupNorm(encoder_channels)
        self.layout_content_proj = nn.Linear(encoder_channels, 2 * channels)
        self.proj_out = nn.Linear(channels, channels)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def f32_parameters(self) -> Iterator[nn.Parameter]:
        """Parameters that stay float32 in a model of another dtype."""
        for m in (self.layout_position_proj, self.norm_img_pos, self.norm_lay_pos,
                  self.norm_obj_class, self.layout_content_proj, self.proj_out):
            yield from m.parameters()

    def forward(self, x: torch.Tensor, cond: Dict[str, torch.Tensor]) -> torch.Tensor:
        b, c, h, w = x.shape
        l1 = h * w
        y = self.norm_qkv(x).reshape(b, c, l1).transpose(1, 2)              # (B, L1, C)
        qkv = F.linear(y, self.qkv.weight[:, :, 0, 0], self.qkv.bias)
        # [q(all heads) | k | v], not the heads-major order of SelfAttentionBlock;
        # the rest is float32, as JAX promotes it next to the f32 embeddings
        # (under autocast too)
        with torch.autocast(x.device.type, enabled=False):
            out = self._attend(qkv.float(), cond, b, c, l1)
        # in a model of another dtype the sum returns in x's dtype (JAX
        # promotes it to float32)
        return x + out.transpose(1, 2).reshape(b, c, h, w).to(x.dtype)

    def _attend(self, qkv: torch.Tensor, cond: Dict[str, torch.Tensor], b: int, c: int,
                l1: int) -> torch.Tensor:
        """(B, L1, 3C) f32 projections -> (B, L1, C) f32 attention output."""
        heads = self.heads
        dh = c // heads
        q, k, v = qkv.split(c, dim=-1)

        img_pos = self.norm_img_pos(self.layout_position_proj(
            cond[f"image_patch_bbox_embedding_res{self.res_key}"].float()))
        lay_pos = self.norm_lay_pos(self.layout_position_proj(
            cond["obj_bbox_embedding"].float()))
        content = (cond["xf_out"].float() + self.norm_obj_class(cond["obj_class_embedding"])) / 2.0
        k_lay, v_lay = self.layout_content_proj(content).split(c, dim=-1)

        # heads are cut after the positional channels are appended: head i
        # takes channels [i (dh + pos_dh), (i + 1) (dh + pos_dh)) of [q | pos]
        k_mix = torch.cat([torch.cat([k, img_pos], -1), torch.cat([k_lay, lay_pos], -1)], 1)
        qh = torch.cat([q, img_pos], -1).reshape(b, l1, heads, -1)
        kh = k_mix.reshape(b, k_mix.shape[1], heads, -1)
        vh = torch.cat([v, v_lay], 1).reshape(b, k_mix.shape[1], heads, dh)
        scale = 1.0 / math.sqrt(math.sqrt(qh.shape[-1]))
        logits = torch.einsum("bqhd,bkhd->bhqk", qh * scale, kh * scale)
        if "key_padding_mask" in cond:
            valid = torch.cat([torch.ones((b, l1), dtype=torch.bool, device=qkv.device),
                               cond["key_padding_mask"].to(torch.bool)], 1)
            logits = torch.where(valid[:, None, None, :], logits, -1e9)
        wgt = torch.softmax(logits.float(), dim=-1).to(vh.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", wgt, vh).reshape(b, l1, c)
        return self.proj_out(out)


class LayoutDiffusionUNetModel(nn.Module):
    """``forward(x NCHW, timesteps, cond dict)`` -> NCHW float32."""

    def __init__(self, cfg: LayoutUNetConfig):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        ted = mc * 4
        self.time_embed = nn.Sequential(nn.Linear(mc, ted), nn.SiLU(), nn.Linear(ted, ted))

        def res(name: str, cin: int, cout: int):
            self.add_module(name, ResBlock(cin, ted, cout, cfg.use_scale_shift_norm,
                                           cfg.cconv, dropout=cfg.dropout))

        def attn(name: str, ch: int, ds: int):
            self.add_module(name, ObjectAwareCrossAttention(
                ch, ch // cfg.num_head_channels, cfg.image_size[0] // ds,
                cfg.encoder_channels, cfg.pos_scale))

        self.conv_in = _conv3(cfg.in_channels, mc, cfg.cconv)
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for i in range(cfg.num_res_blocks):
                res(f"in_{level}_{i}", ch, mc * mult)
                ch = mc * mult
                if ds in cfg.attention_ds:
                    attn(f"in_{level}_{i}_attn", ch, ds)
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.add_module(f"down_{level}", UNetDown(ch, cfg.cconv))
                chans.append(ch)
                ds *= 2
        res("mid_res1", ch, ch)
        attn("mid_attn", ch, ds)
        res("mid_res2", ch, ch)
        for level in reversed(range(len(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                res(f"out_{level}_{i}", ch + chans.pop(), mc * cfg.channel_mult[level])
                ch = mc * cfg.channel_mult[level]
                if ds in cfg.attention_ds:
                    attn(f"out_{level}_{i}_attn", ch, ds)
            if level != 0:
                self.add_module(f"up_{level}", UNetUp(ch, cfg.cconv))
                ds //= 2
        self.norm_out = Normalize(ch, act=True)
        self.conv_out = _zero_conv3(ch, cfg.out_channels, cfg.cconv)

    def _block(self, name: str, h: torch.Tensor, emb: torch.Tensor,
               cond: Dict[str, torch.Tensor]) -> torch.Tensor:
        """ResBlock ``name``, then its attention where that level has one."""
        h = getattr(self, name)(h, emb)
        attn = getattr(self, name + "_attn", None)
        return h if attn is None else attn(h, cond)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                cond: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        levels = len(cfg.channel_mult)
        dtype = self.conv_out.weight.dtype
        t_emb = timestep_embedding(timesteps, cfg.model_channels).to(dtype)
        emb = (self.time_embed(t_emb).float() + cond["xf_proj"].float()).to(dtype)
        h = self.conv_in(x.to(dtype))
        hs = [h]
        for level in range(levels):
            for i in range(cfg.num_res_blocks):
                h = self._block(f"in_{level}_{i}", h, emb, cond)
                hs.append(h)
            if level != levels - 1:
                h = getattr(self, f"down_{level}")(h)
                hs.append(h)
        h = self.mid_res2(self.mid_attn(self.mid_res1(h, emb), cond), emb)
        for level in reversed(range(levels)):
            for i in range(cfg.num_res_blocks + 1):
                h = self._block(f"out_{level}_{i}", torch.cat([h, hs.pop()], dim=1), emb, cond)
            if level != 0:
                h = getattr(self, f"up_{level}")(h)
        return self.conv_out(self.norm_out(h)).float()
