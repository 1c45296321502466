"""MinkowskiNet and SPVCNN, the frozen feature nets of FSVD and FPVD.

Counterpart of ``lidar_layout_tpu/eval/sparse_seg_nets.py`` (``TSConv3d``,
``BatchNormEval``, ``BasicConvolutionBlock``, ``BasicDeconvolutionBlock``,
``ResidualBlock``, ``SegNetConfig``, ``_build_pyramid``, ``MinkowskiNet``,
``_voxel_to_point``, ``_point_to_voxel``, ``SPVCNN``), batched over a leading
cloud dimension on the fixed-capacity grids of ``ops/voxel``.

Module names are those of the reference's torchsparse checkpoints
(``stem.{0,3}.kernel``, ``stage{s}.0.net.{0,1}``, ``stage{s}.{1,2}.(net|
downsample)``, ``up{u}.0.net.{0,1}``, ``up{u}.1.{0,1}``, ``classifier.0``,
``point_transforms.{i}.{0,1}``), so their ``model.ckpt`` loads with
``load_state_dict`` (``utils/convert.load_torchsparse_checkpoint``). Conv
kernels keep torchsparse v1.4's layout, (K^3, Cin, Cout) or (Cin, Cout) at
1^3, and its offset orders (``_K3`` z slowest, ``_K2`` x slowest); the
BatchNorms are ``nn.BatchNorm1d`` that always normalise with their running
statistics, as JAX's ``BatchNormEval`` does.

A sparse convolution is a gather of neighbour rows and one matmul of
(B * cap, K * Cin) by (K * Cin, Cout). The neighbour tables are built once a
forward (``_Tables``): the 27-offset table of each level serves every
submanifold convolution there, each level pair's 8-offset tables its
stride-2 convolution and its transposed one, each level's point tables
SPVCNN's voxel <-> point steps. The JAX package looks them up again in every
convolution; the rows are the same.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.voxel import (VoxelGrid, build_grid, gather_rows, gather_table, lookup,
                         neighbor_table, scatter_mean)

# torchsparse v1.4 kernel offset orders (get_kernel_offsets)
_K3 = torch.tensor([[x, y, z] for z in (-1, 0, 1) for y in (-1, 0, 1) for x in (-1, 0, 1)],
                   dtype=torch.int32)                       # odd: z slowest
_K2 = torch.tensor([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                   dtype=torch.int32)                       # even: x slowest

LAYER_NUM = (32, 32, 64, 128, 256, 256, 128, 96, 96)       # the reference's layer_num


@dataclasses.dataclass(frozen=True)
class SegNetConfig:
    """model_params of the reference's eval config."""

    input_dims: int = 4
    cr: float = 1.0
    layer_num: Tuple[int, ...] = LAYER_NUM
    num_class: int = 19
    voxel_size: float = 0.05
    capacity: int = 65536        # finest-level voxel capacity
    bits: int = 10

    @property
    def cs(self) -> Tuple[int, ...]:
        return tuple(int(self.cr * x) for x in self.layer_num)

    def level_capacity(self, level: int) -> int:
        return self.capacity if level == 0 else max(self.capacity >> level, 64)


def build_pyramid(coords: torch.Tensor, mask: torch.Tensor, cfg: SegNetConfig
                  ) -> Tuple[List[VoxelGrid], torch.Tensor]:
    """The 5-level grid pyramid of (B, N, 3) voxel coords: ([grid L0..L4],
    point_to_voxel (B, N) at L0). Each level deduplicates the one below's
    coords >> 1 into ``cfg.level_capacity`` rows."""
    g, p2v = build_grid(coords, mask, cfg.capacity, cfg.bits)
    grids = [g]
    for lvl in range(1, 5):
        g, _ = build_grid(g.coords >> 1, g.mask, cfg.level_capacity(lvl), cfg.bits)
        grids.append(g)
    return grids, p2v


class _Tables:
    """The neighbour tables of one forward, each built at its first use."""

    def __init__(self, grids: List[VoxelGrid], bits: int, pts_base: Optional[torch.Tensor] = None):
        self.grids, self.bits, self.pts_base = grids, bits, pts_base
        self._memo: Dict[Tuple[str, int], tuple] = {}

    def _get(self, key, build):
        if key not in self._memo:
            self._memo[key] = build()
        return self._memo[key]

    def sub(self, lvl: int):
        """27 offsets (``_K3``) at level ``lvl``: (idx, ok) (B, cap, 27)."""
        def build():
            g = self.grids[lvl]
            idx, hit = neighbor_table(g, _K3, self.bits)
            return idx, hit & g.mask[..., None]
        return self._get(("sub", lvl), build)

    def down(self, lvl: int):
        """Level lvl -> lvl + 1 stride-2 taps (``_K2``): (idx, ok) (B, cap_out, 8)
        into level lvl; out[p] = sum_k W[k] x[2p + k]."""
        def build():
            fine, out = self.grids[lvl], self.grids[lvl + 1]
            b, cap = out.mask.shape
            q = out.coords[:, :, None, :] * 2 + _K2.to(out.coords.device)
            idx, hit = lookup(fine, q.reshape(b, cap * 8, 3), self.bits)
            idx, hit = idx.view(b, cap, 8), hit.view(b, cap, 8)
            return idx, hit & out.mask[..., None] & fine.mask.gather(1, idx.view(b, -1)).view(
                b, cap, 8)
        return self._get(("down", lvl), build)

    def up(self, lvl: int):
        """Level lvl + 1 -> lvl transposed taps: (parent idx, ok, kernel
        index), each (B, cap_lvl); out[f] = x[f >> 1] W[offset(f & 1)]."""
        def build():
            fine, coarse = self.grids[lvl], self.grids[lvl + 1]
            pidx, phit = lookup(coarse, fine.coords >> 1, self.bits)
            ok = phit & fine.mask & coarse.mask.gather(1, pidx)
            f = fine.coords & 1
            return pidx, ok, (f[..., 0] * 4 + f[..., 1] * 2 + f[..., 2]).long()
        return self._get(("up", lvl), build)

    def corners(self, lvl: int):
        """Trilinear taps of the base-resolution points at level ``lvl``:
        (idx, weight) (B, N, 8), weight 0 where the corner is not a voxel."""
        def build():
            g = self.grids[lvl]
            pf = self.pts_base / float(1 << lvl)
            base = torch.floor(pf).to(torch.int32)
            frac = pf - base
            idxs, wgts = [], []
            for dx in (0, 1):
                for dy in (0, 1):
                    for dz in (0, 1):
                        corner = base + torch.tensor([dx, dy, dz], dtype=torch.int32,
                                                     device=base.device)
                        idx, hit = lookup(g, corner, self.bits)
                        wgt = ((frac[..., 0] if dx else 1 - frac[..., 0])
                               * (frac[..., 1] if dy else 1 - frac[..., 1])
                               * (frac[..., 2] if dz else 1 - frac[..., 2]))
                        ok = hit & g.mask.gather(1, idx)
                        idxs.append(idx)
                        wgts.append(torch.where(ok, wgt, 0.0))
            return torch.stack(idxs, -1), torch.stack(wgts, -1)
        return self._get(("corners", lvl), build)

    def points(self, lvl: int, pt_mask: torch.Tensor):
        """Each point's voxel at level ``lvl``: (idx, ok) (B, N)."""
        def build():
            coords = self.pts_base.to(torch.int32) >> lvl
            idx, hit = lookup(self.grids[lvl], coords, self.bits)
            return idx, hit & pt_mask
        return self._get(("points", lvl), build)


def voxel_to_point(tables: _Tables, vox_feats: torch.Tensor, lvl: int) -> torch.Tensor:
    """Trilinear devoxelisation (torchsparse ``voxel_to_point``, nearest
    False) of level-``lvl`` feats at the base-resolution points; the eight
    corners summed in JAX's order."""
    idx, wgt = tables.corners(lvl)
    rows = gather_rows(vox_feats, idx)                       # (B, N, 8, C)
    out = wgt[..., 0, None] * rows[..., 0, :]
    for k in range(1, 8):
        out = out + wgt[..., k, None] * rows[..., k, :]
    return out


def point_to_voxel(tables: _Tables, pt_feats: torch.Tensor, pt_mask: torch.Tensor,
                   lvl: int) -> torch.Tensor:
    """Scatter-mean of point feats onto the existing level-``lvl`` grid
    (torchsparse ``point_to_voxel``)."""
    idx, ok = tables.points(lvl, pt_mask)
    g = tables.grids[lvl]
    return scatter_mean(idx, pt_feats, ok.to(pt_feats.dtype), g.mask.shape[1]) * g.mask[..., None]


class BatchNorm(nn.BatchNorm1d):
    """A frozen BatchNorm over the last axis of (..., C): (x - mean) * weight *
    rsqrt(var + eps) + bias from the running statistics, in train mode too,
    as JAX's ``BatchNormEval``. State-dict names are ``nn.BatchNorm1d``'s,
    which torchsparse's ``spnn.BatchNorm`` shares."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ((x - self.running_mean) * self.weight * torch.rsqrt(self.running_var + self.eps)
                + self.bias)


class TSConv3d(nn.Module):
    """torchsparse v1.4 ``Conv3d`` over fixed-capacity grids: ks 3 stride 1
    (submanifold), ks 1, ks 2 stride 2 down, ks 2 stride 2 transposed. The
    parameter ``kernel`` is (K^3, Cin, Cout), or (Cin, Cout) at ks 1."""

    def __init__(self, inc: int, outc: int, ks: int = 3, stride: int = 1,
                 transposed: bool = False):
        super().__init__()
        if (ks, stride) not in ((3, 1), (1, 1), (2, 2)) or (transposed and ks != 2):
            raise NotImplementedError((ks, stride, transposed))
        self.ks, self.stride, self.transposed = ks, stride, transposed
        shape = (inc, outc) if ks == 1 else (ks ** 3, inc, outc)
        self.kernel = nn.Parameter(torch.empty(shape))
        with torch.no_grad():
            self.kernel.normal_(0.0, (ks ** 3 * inc) ** -0.5)

    def forward(self, x: torch.Tensor, table, out_mask: torch.Tensor) -> torch.Tensor:
        """``x`` (B, cap_in, Cin) -> (B, cap_out, Cout), padding rows zeroed;
        ``table`` is the ``_Tables`` entry for this mode (None at ks 1)."""
        b = x.shape[0]
        cout = self.kernel.shape[-1]
        if self.ks == 1:
            out = x @ self.kernel
        elif self.transposed:
            pidx, ok, kidx = table
            xp = torch.where(ok[..., None], gather_rows(x, pidx), 0.0)
            outs = (xp @ self.kernel.permute(1, 0, 2).reshape(x.shape[-1], 8 * cout)).view(
                b, -1, 8, cout)
            out = outs.gather(2, kidx[..., None, None].expand(-1, -1, 1, cout))[:, :, 0]
        else:
            nb = gather_table(x, *table)                        # (B, cap_out, K, Cin)
            out = nb.reshape(b, nb.shape[1], -1) @ self.kernel.reshape(-1, cout)
        return out * out_mask[..., None]


class BasicConvolutionBlock(nn.Module):
    """conv-bn-relu (``net.0``, ``net.1``)."""

    def __init__(self, inc: int, outc: int, ks: int = 3, stride: int = 1):
        super().__init__()
        self.net = nn.ModuleList([TSConv3d(inc, outc, ks, stride), BatchNorm(outc), nn.ReLU()])

    def forward(self, x, table, out_mask):
        return F.relu(self.net[1](self.net[0](x, table, out_mask))) * out_mask[..., None]


class BasicDeconvolutionBlock(nn.Module):
    """transposed conv-bn-relu (``net.0``, ``net.1``)."""

    def __init__(self, inc: int, outc: int):
        super().__init__()
        self.net = nn.ModuleList([TSConv3d(inc, outc, 2, 2, transposed=True), BatchNorm(outc),
                                  nn.ReLU()])

    def forward(self, x, table, out_mask):
        return F.relu(self.net[1](self.net[0](x, table, out_mask))) * out_mask[..., None]


class ResidualBlock(nn.Module):
    """conv-bn-relu-conv-bn (``net.{0,1,3,4}``) plus x, or a 1^3 conv-bn
    shortcut (``downsample.{0,1}``) when the widths differ, then relu."""

    def __init__(self, inc: int, outc: int):
        super().__init__()
        self.net = nn.ModuleList([TSConv3d(inc, outc, 3), BatchNorm(outc), nn.ReLU(),
                                  TSConv3d(outc, outc, 3), BatchNorm(outc)])
        self.downsample = (nn.ModuleList([TSConv3d(inc, outc, 1), BatchNorm(outc)])
                           if inc != outc else None)

    def forward(self, x, table, mask):
        h = F.relu(self.net[1](self.net[0](x, table, mask)))
        h = self.net[4](self.net[3](h, table, mask))
        s = x if self.downsample is None else self.downsample[1](
            self.downsample[0](x, None, mask))
        return F.relu(h + s) * mask[..., None]


class MinkowskiNet(nn.Module):
    """The reference MinkowskiNet: stem, four down stages (a stride-2 block
    and two residual blocks), four up stages (a transposed block, the skip
    concatenated, two residual blocks), classifier."""

    def __init__(self, cfg: SegNetConfig):
        super().__init__()
        self.cfg = cfg
        cs = cfg.cs
        self.stem = nn.ModuleList([TSConv3d(cfg.input_dims, cs[0], 3), BatchNorm(cs[0]), nn.ReLU(),
                                   TSConv3d(cs[0], cs[0], 3), BatchNorm(cs[0]), nn.ReLU()])
        for s in range(1, 5):
            setattr(self, f"stage{s}", nn.ModuleList([
                BasicConvolutionBlock(cs[s - 1], cs[s - 1], ks=2, stride=2),
                ResidualBlock(cs[s - 1], cs[s]), ResidualBlock(cs[s], cs[s])]))
        skip = {1: cs[3], 2: cs[2], 3: cs[1], 4: cs[0]}
        for u in range(1, 5):
            setattr(self, f"up{u}", nn.ModuleList([
                BasicDeconvolutionBlock(cs[3 + u], cs[4 + u]),
                nn.ModuleList([ResidualBlock(cs[4 + u] + skip[u], cs[4 + u]),
                               ResidualBlock(cs[4 + u], cs[4 + u])])]))
        self.classifier = nn.Sequential(nn.Linear(cs[8], cfg.num_class))

    def _stem(self, tables: _Tables, x: torch.Tensor) -> torch.Tensor:
        m = tables.grids[0].mask
        x = F.relu(self.stem[1](self.stem[0](x, tables.sub(0), m)))
        return F.relu(self.stem[4](self.stem[3](x, tables.sub(0), m))) * m[..., None]

    def _stage(self, s: int, tables: _Tables, x: torch.Tensor) -> torch.Tensor:
        down, res0, res1 = getattr(self, f"stage{s}")
        m = tables.grids[s].mask
        x = down(x, tables.down(s - 1), m)
        return res1(res0(x, tables.sub(s), m), tables.sub(s), m)

    def _up(self, u: int, tables: _Tables, y: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        deconv, (res0, res1) = getattr(self, f"up{u}")
        lvl = 4 - u
        m = tables.grids[lvl].mask
        y = torch.cat([deconv(y, tables.up(lvl), m), skip], dim=-1)
        return res1(res0(y, tables.sub(lvl), m), tables.sub(lvl), m)

    def forward(self, coords: torch.Tensor, feats: torch.Tensor, mask: torch.Tensor,
                return_final_logits: bool = True) -> Dict[str, torch.Tensor]:
        """(B, N, 3) int voxel coords, (B, N, input_dims) feats, (B, N) mask ->
        {"logits": (B, capacity, C) per voxel, "coords", "mask"} of level 0;
        the last stage's features, or the classifier's logits."""
        grids, p2v = build_pyramid(coords, mask, self.cfg)
        tables = _Tables(grids, self.cfg.bits)
        x = scatter_mean(p2v, feats, mask.to(feats.dtype), self.cfg.capacity)
        skips = [self._stem(tables, x)]
        for s in range(1, 5):
            skips.append(self._stage(s, tables, skips[-1]))
        y = skips[4]
        for u in range(1, 5):
            y = self._up(u, tables, y, skips[4 - u])
        return {"logits": y if return_final_logits else self.classifier(y),
                "coords": grids[0].coords, "mask": grids[0].mask}


class SPVCNN(MinkowskiNet):
    """The reference SPVCNN: MinkowskiNet's voxel trunk and a point branch of
    three ``point_transforms`` (linear-bn-relu), joined by trilinear
    devoxelisation and scatter-mean voxelisation at levels 0, 4, 2 and 0."""

    def __init__(self, cfg: SegNetConfig):
        super().__init__(cfg)
        cs = cfg.cs
        self.point_transforms = nn.ModuleList([
            nn.Sequential(nn.Linear(ci, co), BatchNorm(co), nn.ReLU())
            for ci, co in ((cs[0], cs[4]), (cs[4], cs[6]), (cs[6], cs[8]))])

    def forward(self, coords: torch.Tensor, feats: torch.Tensor, mask: torch.Tensor,
                return_final_logits: bool = True) -> Dict[str, torch.Tensor]:
        """As MinkowskiNet's, but the logits are per point: (B, N, C), with
        the input coords and mask."""
        grids, p2v = build_pyramid(coords, mask, self.cfg)
        pts_base = coords.to(torch.float32)
        tables = _Tables(grids, self.cfg.bits, pts_base)
        w = mask.to(feats.dtype)[..., None]
        x = scatter_mean(p2v, feats, mask.to(feats.dtype), self.cfg.capacity)
        x0 = self._stem(tables, x)
        z0 = voxel_to_point(tables, x0, 0) * w
        # the trunk starts from the point branch voxelised again; up4 takes
        # the stem's x0 as its skip
        skips = [x0]
        x_cur = point_to_voxel(tables, z0, mask, 0)
        for s in range(1, 5):
            x_cur = self._stage(s, tables, x_cur)
            skips.append(x_cur)
        z1 = (voxel_to_point(tables, x_cur, 4) + self.point_transforms[0](z0)) * w
        y = point_to_voxel(tables, z1, mask, 4)
        for u in (1, 2):
            y = self._up(u, tables, y, skips[4 - u])
        z2 = (voxel_to_point(tables, y, 2) + self.point_transforms[1](z1)) * w
        y = point_to_voxel(tables, z2, mask, 2)
        for u in (3, 4):
            y = self._up(u, tables, y, skips[4 - u])
        z3 = (voxel_to_point(tables, y, 0) + self.point_transforms[2](z2)) * w
        return {"logits": z3 if return_final_logits else self.classifier(z3),
                "coords": coords, "mask": mask}
