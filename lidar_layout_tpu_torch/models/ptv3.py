"""Point Transformer V3: attention in fixed patches along space-filling curves.

Counterpart of ``lidar_layout_tpu/models/ptv3.py`` (``PTv3Config``,
``RPEBias``, ``PatchAttention``, ``SerialConvCPE``, ``PTv3Block``,
``grid_pool_segments``, ``segment_mean``, ``PTv3``, ``PTv3Segmentor``) over
one padded cloud of fixed capacity: (N, 3) points, (N, C) features and an
(N,) mask. Modules keep the flax names (``embed``, ``enc1_proj``,
``enc0_block0.attn.qkv``, ``dec3_up``, ...), so
``utils/convert.dense_tree_state_dict`` carries a JAX tree in.

Each block works in the order of one of the four curves (z, z-trans,
hilbert, hilbert-trans, rotating over the blocks): a window-3 depthwise conv
along the curve (the conditional positional encoding), then multi-head
attention within patches of ``min(patch_size, capacity)`` points. The
attention goes through ``ops/attention.attend`` with the patch's
key-padding mask, so on the card it is kernels K1 and K2 at head dim
``channels / heads`` (16 at every level of ``gaus_10cm.yaml``), with a
-1e9 key bias on padding; a patch of padding alone attends uniformly, as
JAX's does. With ``enable_rpe`` the logits are formed in plain PyTorch to
add the relative-position bias. Grid pooling halves the grid and keeps at
most ``capacity // 2`` segments a level (the overflow merges into the last
row); the grid clips at ``2**bits - 1`` cells; ``grid_size`` stays 0.05 m.

As in JAX, GELU is the tanh approximation and LayerNorm's eps is 1e-6.
``deterministic=False`` drops whole rows on each residual branch (stochastic
depth at the linspace rates) and permutes the curve orders a level, drawing
from the ``generator`` passed in; the dense decoder's training never asks
for it (JAX's ``DenseDecoder`` takes no ``deterministic``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import attend
from ..ops.serialization import argsort_with_mask, serialize_code

LN_EPS = 1e-6   # flax LayerNorm's


@dataclasses.dataclass(frozen=True)
class PTv3Config:
    in_channels: int = 4
    orders: Tuple[str, ...] = ("z", "z-trans", "hilbert", "hilbert-trans")
    patch_size: int = 1024
    enc_depths: Tuple[int, ...] = (2, 2, 2, 6, 2)
    enc_channels: Tuple[int, ...] = (32, 64, 128, 256, 512)
    enc_heads: Tuple[int, ...] = (2, 4, 8, 16, 32)
    dec_depths: Tuple[int, ...] = (2, 2, 2, 2)
    dec_channels: Tuple[int, ...] = (64, 64, 128, 256)
    dec_heads: Tuple[int, ...] = (4, 4, 8, 16)
    mlp_ratio: float = 4.0
    grid_size: float = 0.05
    bits: int = 10   # per-axis bits of the serialization codes
    drop_path: float = 0.0
    shuffle_orders: bool = True
    enable_rpe: bool = False


def _drop_rows(h: torch.Tensor, rate: float, generator: Optional[torch.Generator]
               ) -> torch.Tensor:
    """Stochastic depth on an (N, C) branch: whole rows kept with 1 - rate,
    scaled by 1 / (1 - rate) (flax Dropout with ``broadcast_dims=(1,)``)."""
    if rate <= 0.0:
        return h
    keep = torch.rand((h.shape[0], 1), generator=generator, device=h.device) >= rate
    return torch.where(keep, h / (1.0 - rate), 0.0)


class RPEBias(nn.Module):
    """Relative-position bias: a per-axis table indexed by clamped relative
    grid coords, summed over xyz."""

    def __init__(self, heads: int, patch_size: int):
        super().__init__()
        self.pos_bnd = int((4 * patch_size) ** (1 / 3) * 2)
        self.rpe_num = 2 * self.pos_bnd + 1
        self.rpe_table = nn.Parameter(torch.zeros((3 * self.rpe_num, heads)))
        nn.init.trunc_normal_(self.rpe_table, std=0.02)

    def forward(self, rel: torch.Tensor) -> torch.Tensor:
        """(np, K, K, 3) int relative coords -> (np, H, K, K) bias."""
        idx = (rel.clamp(-self.pos_bnd, self.pos_bnd) + self.pos_bnd
               + torch.arange(3, device=rel.device) * self.rpe_num)
        return self.rpe_table[idx.long()].sum(dim=3).permute(0, 3, 1, 2)


class PatchAttention(nn.Module):
    """Multi-head attention within fixed patches of the serialized sequence."""

    def __init__(self, channels: int, heads: int, rpe_patch: Optional[int] = None):
        """``rpe_patch``: the patch size the relative-position table is
        sized for; None runs without it."""
        super().__init__()
        self.heads, self.enable_rpe = heads, rpe_patch is not None
        self.qkv = nn.Linear(channels, 3 * channels)
        self.proj = nn.Linear(channels, channels)
        if self.enable_rpe:
            self.rpe = RPEBias(heads, rpe_patch)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, patch: int,
                grid: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, c = x.shape
        p = patch
        pad = (-n) % p
        xp = F.pad(x, (0, 0, 0, pad))
        mp = F.pad(mask, (0, pad))
        npatch = xp.shape[0] // p
        qkv = self.qkv(xp).reshape(npatch, p, 3, self.heads, c // self.heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self.enable_rpe:
            assert grid is not None, "enable_rpe needs serialized grid coords"
            gp = F.pad(grid, (0, 0, 0, pad)).reshape(npatch, p, 3)
            bias = self.rpe(gp[:, :, None, :] - gp[:, None, :, :])
            qh = q.permute(0, 2, 1, 3) * (c // self.heads) ** -0.5
            logits = torch.einsum("nhkd,nhqd->nhkq", qh, k.permute(0, 2, 1, 3)) + bias
            logits = torch.where(mp.reshape(npatch, 1, 1, p), logits, -1e9)
            out = torch.einsum("nhkq,nqhd->nkhd", torch.softmax(logits, dim=-1), v)
        else:
            out = attend(q, k, v, mask=mp.reshape(npatch, 1, 1, p))
        return self.proj(out.reshape(npatch * p, c)[:n])


class SerialConvCPE(nn.Module):
    """Conditional positional encoding: a depthwise window-3 conv along the
    serialized order, then a projection (the reference's sparse-conv xCPE)."""

    def __init__(self, channels: int):
        super().__init__()
        self.dwconv = nn.Conv1d(channels, channels, 3, padding=1, groups=channels)
        self.proj = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        m = mask[:, None].to(x.dtype)
        h = self.dwconv((x * m).T[None])[0].T
        return x + self.proj(h) * m


class PTv3Block(nn.Module):
    def __init__(self, channels: int, heads: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, rpe_patch: Optional[int] = None):
        super().__init__()
        self.drop_path = drop_path
        self.cpe = SerialConvCPE(channels)
        self.norm1 = nn.LayerNorm(channels, eps=LN_EPS)
        self.attn = PatchAttention(channels, heads, rpe_patch)
        self.norm2 = nn.LayerNorm(channels, eps=LN_EPS)
        self.mlp_in = nn.Linear(channels, int(channels * mlp_ratio))
        self.mlp_out = nn.Linear(int(channels * mlp_ratio), channels)

    def forward(self, x: torch.Tensor, order: torch.Tensor, inverse: torch.Tensor,
                mask: torch.Tensor, patch: int, grid: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = 0.0 if deterministic else self.drop_path
        xs, ms = x[order], mask[order]
        gs = grid[order] if grid is not None else None
        xs = self.cpe(xs, ms)
        xs = xs + _drop_rows(self.attn(self.norm1(xs), ms, patch, gs), rate, generator)
        h = self.mlp_out(F.gelu(self.mlp_in(self.norm2(xs)), approximate="tanh"))
        xs = xs + _drop_rows(h, rate, generator)
        return xs[inverse] * mask[:, None]


def grid_pool_segments(codes: torch.Tensor, mask: torch.Tensor, capacity: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group points by code into at most ``capacity`` segments: (segment id
    a point (N,), segment validity (capacity,), the order (N,) that sorts
    points by code with padding last). Segments past the capacity merge into
    the last row; padding points take the last real point's segment (their
    weight is 0 downstream)."""
    order = argsort_with_mask(codes, mask)
    sc, sm = codes[order], mask[order]
    head = torch.cat([sm.new_ones((1,)), sc[1:] != sc[:-1]]) & sm
    seg_sorted = (torch.cumsum(head.to(torch.int64), 0) - 1).clamp(0, capacity - 1)
    seg = torch.empty_like(seg_sorted).scatter_(0, order, seg_sorted)
    n_seg = torch.where(sm.any(), seg_sorted[-1] + 1, 0)
    seg_valid = torch.arange(capacity, device=codes.device) < n_seg
    return seg, seg_valid, order


def segment_mean(x: torch.Tensor, seg: torch.Tensor, mask: torch.Tensor,
                 capacity: int) -> torch.Tensor:
    """Mean of the masked rows of ``x`` in each of ``capacity`` segments
    (0 for an empty one)."""
    w = mask.to(x.dtype)
    num = x.new_zeros((capacity, x.shape[-1])).index_add_(0, seg, x * w[:, None])
    den = x.new_zeros((capacity,)).index_add_(0, seg, w)
    return num / den.clamp(min=1.0)[:, None]


def _serial_orders(grid: torch.Tensor, mask: torch.Tensor, orders: Sequence[str], bits: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, N) sort orders along each curve (padding last) and their inverses."""
    ords = torch.stack([argsort_with_mask(serialize_code(grid, o, bits), mask) for o in orders])
    arange = torch.arange(grid.shape[0], device=grid.device).expand_as(ords)
    return ords, torch.empty_like(ords).scatter_(1, ords, arange)


class PTv3(nn.Module):
    """Encoder-decoder PT-v3 over one padded cloud.

    ``forward(points (N, 3), feats (N, in_channels), mask (N,))`` -> ((N,
    dec_channels[0]) features, the mask); ``encoder_only`` returns the last
    level's (capacity, enc_channels[-1]) features and its segment mask.

    A level of capacity C attends in patches of ``min(patch_size, C)``;
    level 0 holds the cloud's N rows and each level half the last. With
    ``enable_rpe`` the relative-position tables are sized by those patches,
    so ``capacity`` (N) must be given; otherwise it is not read."""

    def __init__(self, cfg: PTv3Config, encoder_only: bool = False,
                 capacity: Optional[int] = None):
        super().__init__()
        self.cfg, self.encoder_only = cfg, encoder_only
        if cfg.enable_rpe and capacity is None:
            raise ValueError("enable_rpe sizes its tables by the patches: give the capacity")
        caps = [capacity or 1]
        for _ in cfg.enc_depths[1:]:
            caps.append(max(caps[-1] // 2, 1))

        def rpe(level):
            return min(cfg.patch_size, caps[level]) if cfg.enable_rpe else None
        self.embed = nn.Linear(cfg.in_channels, cfg.enc_channels[0])
        self.embed_norm = nn.LayerNorm(cfg.enc_channels[0], eps=LN_EPS)
        enc_dpr, dec_dpr = self._dpr(cfg.enc_depths), self._dpr(cfg.dec_depths)
        width = cfg.enc_channels[0]
        for level, (depth, ch, heads) in enumerate(zip(cfg.enc_depths, cfg.enc_channels,
                                                       cfg.enc_heads)):
            if width != ch:
                self.add_module(f"enc{level}_proj", nn.Linear(width, ch))
            base = sum(cfg.enc_depths[:level])
            for b in range(depth):
                self.add_module(f"enc{level}_block{b}", PTv3Block(
                    ch, heads, cfg.mlp_ratio, enc_dpr[base + b], rpe(level)))
            width = ch
        if encoder_only:
            return
        for level in reversed(range(len(cfg.dec_depths))):
            ch = cfg.dec_channels[level]
            self.add_module(f"dec{level}_up", nn.Linear(width, ch))
            self.add_module(f"dec{level}_skip", nn.Linear(cfg.enc_channels[level], ch))
            base = sum(cfg.dec_depths[:level])
            rates = dec_dpr[base: base + cfg.dec_depths[level]][::-1]
            for b in range(cfg.dec_depths[level]):
                self.add_module(f"dec{level}_block{b}", PTv3Block(
                    ch, cfg.dec_heads[level], cfg.mlp_ratio, rates[b], rpe(level)))
            width = ch

    def _dpr(self, depths: Sequence[int]) -> List[float]:
        """Stochastic-depth rates: linspace(0, drop_path) over the blocks."""
        tot = sum(depths)
        return [self.cfg.drop_path * i / max(tot - 1, 1) for i in range(tot)]

    def _grid(self, points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Level-0 int32 grid coords from the valid points' minimum corner,
        clipped to ``2**bits - 1`` (divided by a tensor: a Python-float
        divisor may become a multiply by its reciprocal, which floors some
        points into the next cell)."""
        cfg = self.cfg
        origin = torch.where(mask[:, None], points, torch.inf).amin(dim=0)
        size = torch.tensor(cfg.grid_size, dtype=points.dtype, device=points.device)
        return torch.floor((points - origin) / size).to(torch.int32).clamp(0, (1 << cfg.bits) - 1)

    def _blocks(self, prefix: str, depth: int, x, grid, mask, deterministic, generator):
        """A level's blocks, each in the order of its curve."""
        cfg = self.cfg
        patch = min(cfg.patch_size, x.shape[0])
        orders, inverses = _serial_orders(grid, mask, cfg.orders, cfg.bits)
        n_orders = len(cfg.orders)
        perm = (torch.randperm(n_orders, generator=generator).tolist()
                if cfg.shuffle_orders and not deterministic and n_orders > 1
                else list(range(n_orders)))
        for b in range(depth):
            sel = perm[b % n_orders]
            x = getattr(self, f"{prefix}_block{b}")(x, orders[sel], inverses[sel], mask, patch,
                                                    grid, deterministic, generator)
        return x

    def forward(self, points: torch.Tensor, feats: torch.Tensor, mask: torch.Tensor,
                deterministic: bool = True, generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        n = points.shape[0]
        grid = self._grid(points, mask)
        x = self.embed_norm(self.embed(feats)) * mask[:, None]

        grids, masks, caps, skips = [grid], [mask], [n], []
        for level, depth in enumerate(cfg.enc_depths):
            g, m, cap = grids[-1], masks[-1], caps[-1]
            if hasattr(self, f"enc{level}_proj"):
                x = getattr(self, f"enc{level}_proj")(x)
            x = self._blocks(f"enc{level}", depth, x, g, m, deterministic, generator)
            if level < len(cfg.enc_depths) - 1:
                parent = g >> 1
                new_cap = max(cap // 2, 1)
                seg, seg_valid, _ = grid_pool_segments(serialize_code(parent, "z", cfg.bits), m,
                                                       new_cap)
                skips.append((x, seg, m))
                x = segment_mean(x, seg, m, new_cap)
                grids.append(segment_mean(parent.to(x.dtype), seg, m, new_cap)
                             .to(torch.int32))
                masks.append(seg_valid)
                caps.append(new_cap)
                x = x * seg_valid[:, None]
        if self.encoder_only:
            return x, masks[-1]

        for level in reversed(range(len(cfg.dec_depths))):
            skip_x, seg, fine_mask = skips[level]
            x = getattr(self, f"dec{level}_up")(x[seg]) + getattr(self, f"dec{level}_skip")(skip_x)
            x = x * fine_mask[:, None]
            x = self._blocks(f"dec{level}", cfg.dec_depths[level], x, grids[level], fine_mask,
                             deterministic, generator)
        return x, masks[0]

    def pooled_levels(self, points: torch.Tensor, mask: torch.Tensor
                      ) -> List[Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]]:
        """The encoder's pooling chain alone, for one cloud: each level's
        (int32 grid, row mask, the segment of each row of the level before;
        None at level 0), as ``forward`` computes them."""
        g, m, cap = self._grid(points, mask), mask, points.shape[0]
        out = [(g, m, None)]
        for _ in range(len(self.cfg.enc_depths) - 1):
            cap = max(cap // 2, 1)
            seg, valid, _ = grid_pool_segments(serialize_code(g >> 1, "z", self.cfg.bits), m,
                                               cap)
            g = segment_mean((g >> 1).float(), seg, m, cap).to(torch.int32)
            m = valid
            out.append((g, m, seg))
        return out


class PTv3Segmentor(nn.Module):
    """PT-v3 backbone, a ``neck`` Dense, GELU and a per-point ``seg_head``
    (pointcept's DefaultSegmentorV2); logits zero on padding."""

    def __init__(self, backbone_cfg: PTv3Config, num_classes: int = 16,
                 backbone_out_channels: int = 64, capacity: Optional[int] = None):
        super().__init__()
        self.backbone = PTv3(backbone_cfg, capacity=capacity)
        self.neck = nn.Linear(backbone_cfg.dec_channels[0], backbone_out_channels)
        self.seg_head = nn.Linear(backbone_out_channels, num_classes)

    def forward(self, points: torch.Tensor, feats: torch.Tensor, mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h, _ = self.backbone(points, feats, mask, deterministic, generator)
        logits = self.seg_head(F.gelu(self.neck(h), approximate="tanh"))
        return logits * mask[:, None]
