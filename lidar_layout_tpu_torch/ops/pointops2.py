"""Edge-list window attention with relative-position tables (pointops2).

Counterpart of ``lidar_layout_tpu/ops/pointops2.py`` (``attention_step1``,
``attention_step2``, ``dot_prod_with_idx``, ``relative_pos_value``,
``attention_step2_with_rel_pos_value``, ``segment_softmax``,
``window_attention``). The JAX package writes the reference's pointops2
CUDA kernels as gathers and masked ``segment_sum``s with no Pallas kernel;
so does this port, in plain PyTorch: gathers, ``index_add_`` for the
scatter-sums and ``scatter_reduce(amax)`` for the per-query maximum, whose
gradients autograd derives.

Edge m attends query ``index0[m]`` to key/value ``index1[m]``; the edge list
has a fixed length M with a (M,) validity mask, and ``index0`` need not be
sorted. ``segment_softmax`` takes each query's maximum with
``scatter_reduce(amax, include_self=False)``, 0 for a query without edges,
and gives masked edges 0.
"""
from __future__ import annotations

from typing import Optional

import torch


def _masked(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x
    return torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - 1)), x, 0.0)


def _segment_sum(values: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    out = values.new_zeros((n,) + tuple(values.shape[1:]))
    return out.index_add(0, index.long(), values)


def attention_step1(q: torch.Tensor, k: torch.Tensor, index0: torch.Tensor,
                    index1: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-edge q.k: (N, h, d) q and k -> (M, h)."""
    return _masked((q[index0.long()] * k[index1.long()]).sum(dim=-1), mask)


def attention_step2(attn: torch.Tensor, v: torch.Tensor, index0: torch.Tensor,
                    index1: torch.Tensor, n_out: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[n] = sum over edges m of query n of attn[m] * v[index1[m]]:
    (M, h), (N, h, d) -> (n_out, h, d)."""
    vals = _masked(attn[..., None] * v[index1.long()], mask)
    return _segment_sum(vals, index0, n_out)


def dot_prod_with_idx(q: torch.Tensor, index: torch.Tensor, table: torch.Tensor,
                      rel_idx: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Position bias: out[m, i] = sum over axes a of <q[index[m], i],
    table[rel_idx[m, a], i, :, a]>; table (L, h, d, 3), rel_idx (M, 3)."""
    qg = q[index.long()]
    out = 0.0
    for a in range(rel_idx.shape[1]):
        out = out + (qg * table[rel_idx[:, a].long(), :, :, a]).sum(dim=-1)
    return _masked(out, mask)


def relative_pos_value(table: torch.Tensor, rel_idx: torch.Tensor) -> torch.Tensor:
    """Sum over axes a of table[rel_idx[:, a], :, :, a]: (M, h, d)."""
    pe = 0.0
    for a in range(rel_idx.shape[1]):
        pe = pe + table[rel_idx[:, a].long(), :, :, a]
    return pe


def attention_step2_with_rel_pos_value(attn: torch.Tensor, v: torch.Tensor,
                                       index0: torch.Tensor, index1: torch.Tensor,
                                       table: torch.Tensor, rel_idx: torch.Tensor, n_out: int,
                                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``attention_step2`` with each edge's value v[index1[m]] plus its
    relative-position value."""
    vals = attn[..., None] * (v[index1.long()] + relative_pos_value(table, rel_idx))
    return _segment_sum(_masked(vals, mask), index0, n_out)


def segment_softmax(scores: torch.Tensor, index0: torch.Tensor, n_seg: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax over the edges that share a query: (M, h) -> (M, h)."""
    idx = index0.long()
    s = scores if mask is None else torch.where(mask[:, None], scores, -torch.inf)
    # the maximum only shifts the exponent (every non-empty segment's sum is
    # at least 1), so no gradient flows through it
    seg_max = scores.new_full((n_seg,) + tuple(scores.shape[1:]), -torch.inf).scatter_reduce(
        0, idx[:, None].expand_as(s), s.detach(), "amax", include_self=False)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    e = _masked(torch.exp(s - seg_max[idx]), mask)
    den = _segment_sum(e, idx, n_seg)
    return e / torch.clamp(den[idx], min=1e-12)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, index0: torch.Tensor,
                     index1: torch.Tensor, n_out: int, table_q: Optional[torch.Tensor] = None,
                     table_v: Optional[torch.Tensor] = None,
                     rel_idx: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """step1 (+ the query position bias), ``segment_softmax``, step2 (+ the
    position values)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    attn = attention_step1(q * scale, k, index0, index1, mask)
    if table_q is not None and rel_idx is not None:
        attn = attn + dot_prod_with_idx(q * scale, index0, table_q, rel_idx, mask)
    attn = segment_softmax(attn, index0, n_out, mask)
    if table_v is not None and rel_idx is not None:
        return attention_step2_with_rel_pos_value(attn, v, index0, index1, table_v, rel_idx,
                                                  n_out, mask)
    return attention_step2(attn, v, index0, index1, n_out, mask)
