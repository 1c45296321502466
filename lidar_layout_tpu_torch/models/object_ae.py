"""Per-object point-cloud autoencoder (G2SD grid-to-shape, ``VQModel_Object``).

Counterpart of ``lidar_layout_tpu/models/object_ae.py``: the ``CdwExtractor``
backbone (kNN local aggregation, two residual shared MLPs, a fused 512-wide
MLP, global max and attention pooling, a 1024-512-1024 codeword) and the
two-stage ``FoldingDecoder`` (a square 2D lattice folded to 3D twice), with
the optional ``VectorQuantizer`` over the codeword that no config turns on.

The port runs a batch of objects at once, (B, N, 3) in and (B, G, 3) out,
where JAX vmaps its one-object modules; every reduction over points (the
kNN, the max pools, the attention softmax) runs over the point axis of each
object alone. The modules keep the flax names (``loc_agg.smlp_1a.Dense_0``,
``att_pool.Dense_0``, ``fc3``, ``decoder.fold2_out``, ...), so
``utils/convert.dense_tree_state_dict`` carries a JAX tree over. Norms are
LayerNorms with flax's eps of 1e-6 (the reference's BatchNorms, as in JAX).
``NbrAgg`` takes column 0 of the kNN as the point itself: with duplicated
points (a crop padded by repetition) it may be a twin of the point, which
has the same coordinates, so the result does not depend on which one wins.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.quantize import VectorQuantizer
from ..ops.chamfer import chamfer_loss
from ..ops.pointops import knn_query

LN_EPS = 1e-6   # flax LayerNorm's


@dataclasses.dataclass(frozen=True)
class ObjectAEConfig:
    num_points: int = 512      # input cloud size (sizes JAX's init only)
    num_grids: int = 1024      # folded output size (grid_size**2)
    num_neighbors: int = 16    # NbrAgg kNN
    cdw_dim: int = 1024        # codeword width
    quantize_latent: bool = False
    n_embed: int = 512
    embed_dim: int = 64


class SMLP(nn.Module):
    """Shared point MLP: a bias-free Dense, LayerNorm, ReLU."""

    def __init__(self, ic: int, oc: int, norm: bool = True, act: str = "relu"):
        super().__init__()
        self.Dense_0 = nn.Linear(ic, oc, bias=False)
        if norm:
            self.LayerNorm_0 = nn.LayerNorm(oc, eps=LN_EPS)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Dense_0(x)
        if hasattr(self, "LayerNorm_0"):
            y = self.LayerNorm_0(y)
        return F.relu(y) if self.act == "relu" else y


class ResSMLP(nn.Module):
    def __init__(self, ic: int, oc: int):
        super().__init__()
        self.smlp_1 = SMLP(ic, ic, act="none")
        self.smlp_2 = SMLP(ic, oc, act="none")
        if ic != oc:
            self.shortcut = SMLP(ic, oc, act="none")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.smlp_2(F.relu(self.smlp_1(x)))
        if hasattr(self, "shortcut"):
            x = self.shortcut(x)
        return F.relu(x + h)


class NbrAgg(nn.Module):
    """kNN local geometry aggregation over (B, N, 3)."""

    def __init__(self, num_neighbors: int = 16, oc: int = 32):
        super().__init__()
        self.k = num_neighbors
        self.smlp_1a = SMLP(7, 16)
        self.smlp_1b = SMLP(16, oc)
        self.smlp_2 = SMLP(3, oc)
        self.smlp_3 = SMLP(2 * oc, oc)

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        b, n, _ = pts.shape
        idx, _ = knn_query(pts, pts, self.k + 1)                       # (B, N, K+1)
        knn_pts = pts[torch.arange(b, device=pts.device)[:, None, None], idx]
        abs_pts = knn_pts[:, :, :1]
        rel = knn_pts[:, :, 1:] - abs_pts                             # (B, N, K, 3)
        dist = torch.sqrt((rel ** 2).sum(dim=-1, keepdim=True) + 1e-8)
        concat = torch.cat([abs_pts.expand(b, n, self.k, 3), rel, dist], dim=-1)
        pooled = self.smlp_1b(self.smlp_1a(concat)).amax(dim=2)
        return self.smlp_3(torch.cat([self.smlp_2(pts), pooled], dim=-1))


class AttPool(nn.Module):
    """Softmax attention pooling over the point axis."""

    def __init__(self, c: int):
        super().__init__()
        self.Dense_0 = nn.Linear(c, c, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x * torch.softmax(self.Dense_0(x), dim=-2)).sum(dim=-2)


class CdwExtractor(nn.Module):
    """(B, N, 3) clouds -> (B, cdw_dim) codewords."""

    def __init__(self, cfg: ObjectAEConfig):
        super().__init__()
        self.loc_agg = NbrAgg(cfg.num_neighbors, 32)
        self.res_smlp_1 = ResSMLP(32, 64)
        self.res_smlp_2 = ResSMLP(128, 128)
        self.fuse = SMLP(32 + 64 + 128 + 128, 512)
        self.att_pool = AttPool(512)
        self.fc1 = SMLP(1024, 512)
        self.fc2 = SMLP(512, 1024)
        self.fc3 = nn.Linear(1024, cfg.cdw_dim, bias=False)

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        f1 = self.loc_agg(pts)
        f2 = self.res_smlp_1(f1)
        f3 = self.res_smlp_2(torch.cat([f2, f2.amax(dim=1, keepdim=True).expand_as(f2)], -1))
        f4 = self.fuse(torch.cat([f1, f2, f3, f3.amax(dim=1, keepdim=True).expand_as(f3)], -1))
        pooled = torch.cat([f4.amax(dim=1), self.att_pool(f4)], dim=-1)
        return self.fc3(self.fc2(self.fc1(pooled)))


def build_lattice(grid_size: int) -> np.ndarray:
    """(G, 2) lattice points in (0, 1), the JAX package's."""
    margin = 1e-4
    p = np.linspace(margin, 1 - margin, grid_size, dtype=np.float32)
    return np.stack(np.meshgrid(p, p, indexing="ij"), -1).reshape(-1, 2)


class FoldingDecoder(nn.Module):
    """(B, cdw_dim) codewords -> (B, G, 3): a 2D lattice folded twice."""

    def __init__(self, cfg: ObjectAEConfig):
        super().__init__()
        grid_size = int(np.sqrt(cfg.num_grids))
        if grid_size * grid_size != cfg.num_grids:
            raise ValueError("num_grids must be a square")
        self.register_buffer("grids", torch.from_numpy(build_lattice(grid_size)),
                             persistent=False)
        for stage, extra in ((1, 2), (2, 3)):
            ic = cfg.cdw_dim + extra
            for i, c in enumerate((256, 128, 64)):
                setattr(self, f"fold{stage}_{i}", SMLP(ic, c))
                ic = c
            setattr(self, f"fold{stage}_out", nn.Linear(64, 3, bias=False))

    def _fold(self, stage: int, h: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            h = getattr(self, f"fold{stage}_{i}")(h)
        return getattr(self, f"fold{stage}_out")(h)

    def forward(self, cdw: torch.Tensor) -> torch.Tensor:
        b, g = cdw.shape[0], self.grids.shape[0]
        cdw_dup = cdw[:, None, :].expand(b, g, cdw.shape[-1])
        rec1 = self._fold(1, torch.cat([cdw_dup, self.grids.expand(b, g, 2)], dim=-1))
        return self._fold(2, torch.cat([cdw_dup, rec1], dim=-1))


class VQModelObject(nn.Module):
    """The G2SD autoencoder: ``forward`` returns (reconstruction (B, G, 3),
    codebook loss (B,), indices)."""

    def __init__(self, cfg: ObjectAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = CdwExtractor(cfg)
        self.decoder = FoldingDecoder(cfg)
        if cfg.quantize_latent:
            self.quantize = VectorQuantizer(cfg.n_embed, cfg.embed_dim)

    def encode(self, points: torch.Tensor) -> torch.Tensor:
        return self.encoder(points)

    def decode(self, cdw: torch.Tensor) -> torch.Tensor:
        return self.decoder(cdw)

    def forward(self, points: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cdw = self.encoder(points)
        b = cdw.shape[0]
        if self.cfg.quantize_latent:
            # each object's tokens as an NCHW column, one object at a time,
            # so that each codebook loss is that object's, as under JAX's vmap
            tokens = cdw.reshape(b, -1, self.cfg.embed_dim).transpose(1, 2)[..., None]
            outs = [self.quantize(tokens[i:i + 1]) for i in range(b)]
            cdw = torch.cat([q for q, _, _ in outs]).squeeze(-1).transpose(1, 2).reshape(b, -1)
            qloss = torch.stack([loss for _, loss, _ in outs])
            ind = torch.cat([i.reshape(1, -1) for _, _, i in outs])
        else:
            qloss = cdw.new_zeros(b)
            ind = torch.zeros((b, 1), dtype=torch.long, device=cdw.device)
        return self.decoder(cdw), qloss, ind


def object_ae_loss(rec: torch.Tensor, target: torch.Tensor, qloss: torch.Tensor,
                   codebook_weight: float = 1.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-object loss (B,) and parts: the chamfer loss plus the weighted
    codebook loss."""
    l_cd = chamfer_loss(rec, target)
    loss = l_cd + codebook_weight * qloss
    return loss, {"rec_loss": l_cd, "quant_loss": qloss, "loss": loss}
