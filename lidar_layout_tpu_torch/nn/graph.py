"""Scene-graph convolution over padded graphs.

Counterpart of ``lidar_layout_tpu/nn/graph.py`` (``build_mlp``,
``GraphTripleConv``, ``GraphTripleConvNet``): a per-triple MLP over
(subject, predicate, object), average pooling back to the nodes, residual
projections, the settings LayoutDiffusion uses (its encoder and U-Net set
``residual``; both pool by average). Graphs are fixed-capacity padded
arrays, as there: a padding triple (``pred_mask`` False) points at node 0
and adds zeros.

The JAX package pools with ``.at[].add``. Here the pooling is one product
with the triples' one-hot incidence matrix, so the sums run in a fixed order
on the card too (``index_add_`` sums float32 by atomics in no fixed order).
Modules keep the flax names (``net1.dense_0``, ``proj_obj``, ``gconv_0``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class MLP(nn.Module):
    """``build_mlp``'s MLP: ``dense_0 .. dense_{k-1}`` over ``dims``, a ReLU
    after every layer, the last included."""

    def __init__(self, dims: Sequence[int]):
        super().__init__()
        self.n = len(dims) - 1
        for i in range(self.n):
            self.add_module(f"dense_{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = F.relu(getattr(self, f"dense_{i}")(x))
        return x


def pool_to_nodes(n: int, edges: torch.Tensor, new_s: torch.Tensor, new_o: torch.Tensor,
                  pred_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Average each triple's subject and object vectors into their nodes,
    over a count clamped at 1: (n, h). One product with the (n, 2T)
    incidence matrix; masked triples count and add nothing."""
    onehot = F.one_hot(torch.cat([edges[:, 0], edges[:, 1]]), n).to(new_s.dtype)   # (2T, n)
    pooled = onehot.t() @ torch.cat([new_s, new_o])
    ones = (pred_mask.to(new_s.dtype) if pred_mask is not None
            else new_s.new_ones(edges.shape[0]))
    counts = onehot.t() @ torch.cat([ones, ones])
    return pooled / torch.clamp(counts, min=1.0)[:, None]


class GraphTripleConv(nn.Module):
    """One scene-graph conv layer: obj_vecs (N, D_obj), pred_vecs (T, D_pred),
    edges (T, 2) [subject, object] node indices, pred_mask (T,) bool. The
    JAX module with ``pooling="avg"`` and ``residual=True``."""

    def __init__(self, input_dim_obj: int, input_dim_pred: int,
                 output_dim: Optional[int] = None, hidden_dim: int = 512):
        super().__init__()
        out_dim = output_dim or input_dim_obj
        self.hidden_dim, self.d_pred = hidden_dim, input_dim_pred
        self.net1 = MLP([2 * input_dim_obj + input_dim_pred, hidden_dim,
                         2 * hidden_dim + input_dim_pred])
        self.net2 = MLP([hidden_dim, hidden_dim, out_dim])
        self.proj_obj = nn.Linear(input_dim_obj, out_dim)
        self.proj_pred = nn.Linear(input_dim_pred, input_dim_pred)

    def forward(self, obj_vecs: torch.Tensor, pred_vecs: torch.Tensor, edges: torch.Tensor,
                pred_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h, dp = self.hidden_dim, self.d_pred
        t_in = torch.cat([obj_vecs[edges[:, 0]], pred_vecs, obj_vecs[edges[:, 1]]], dim=-1)
        new_s, new_p, new_o = self.net1(t_in).split([h, dp, h], dim=-1)
        if pred_mask is not None:
            m = pred_mask[:, None].to(new_s.dtype)
            new_s, new_o = new_s * m, new_o * m
        pooled = pool_to_nodes(obj_vecs.shape[0], edges, new_s, new_o, pred_mask)
        return (self.net2(pooled) + self.proj_obj(obj_vecs),
                new_p + self.proj_pred(pred_vecs))


class GraphTripleConvNet(nn.Module):
    """``num_layers`` GraphTripleConvs ``gconv_i``; only the last maps to
    ``output_dim``."""

    def __init__(self, input_dim_obj: int, input_dim_pred: int, num_layers: int = 5,
                 hidden_dim: int = 512, output_dim: Optional[int] = None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            last = i >= num_layers - 1
            self.add_module(f"gconv_{i}", GraphTripleConv(
                input_dim_obj, input_dim_pred, output_dim if last else None, hidden_dim))

    def forward(self, obj_vecs, pred_vecs, edges, pred_mask=None):
        for i in range(self.num_layers):
            obj_vecs, pred_vecs = getattr(self, f"gconv_{i}")(obj_vecs, pred_vecs, edges,
                                                              pred_mask)
        return obj_vecs, pred_vecs
