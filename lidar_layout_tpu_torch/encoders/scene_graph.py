"""Scene-graph conditioning encoder of LayoutDiffusion.

Counterpart of ``lidar_layout_tpu/encoders/scene_graph.py``: object and
predicate embeddings with the precomputed 512-d text features concatenated in
front, a GraphTripleConv encoder over the original graph, and a manipulation
GCN over the decoder graph. Decoder nodes are aligned to the encoder's by
``enc_to_dec`` (-1 for an added node, which gets a zero latent); added and
changed nodes carry N(0, 1) "change" noise of ``embedding_dim`` channels,
untouched ones zeros. Modules keep the flax names (``obj_embeddings_ec``,
``gconv_net_ec``, ``gconv_net_manipulation``, ...).

The graph is a dict of fixed-capacity arrays (numpy or tensors), the keys of
``data/layout_synthetic.synthetic_graph_batch``; ``graph_tensors`` puts it on
a device.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ..nn.graph import GraphTripleConvNet
from ..parallel.collectives import rank_rows

Graph = Dict[str, Union[np.ndarray, torch.Tensor]]
CLIP_DIM = 512   # the precomputed text features' width


def graph_tensors(graph: Graph, device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """The graph's arrays as tensors on ``device``: integers as int64 (they
    index), booleans as bool, floats as float32; ``n_scenes`` stays an int."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in graph.items():
        if k == "n_scenes":
            out[k] = int(v)
            continue
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
        if t.dtype == torch.bool:
            pass
        elif t.is_floating_point():
            t = t.float()
        else:
            t = t.long()
        out[k] = t.to(device)
    return out


class SceneGraphEncoder(nn.Module):
    """The JAX encoder with ``residual=True`` and 5 graph-conv layers a pass,
    as LayoutDiffusion builds it; ``replace_latent`` as there."""

    def __init__(self, num_objs: int, num_preds: int, embedding_dim: int = 128,
                 use_clip: bool = True, replace_latent: bool = False):
        super().__init__()
        gdim = embedding_dim
        self.embedding_dim, self.use_clip, self.replace_latent = gdim, use_clip, replace_latent
        add = CLIP_DIM if use_clip else 0
        self.out_dim = gdim * 2 + add
        self.obj_embeddings_ec = nn.Embedding(num_objs + 1, gdim * 2)
        self.pred_embeddings_ec = nn.Embedding(num_preds, gdim * 2)
        self.pred_embeddings_man_dc = nn.Embedding(num_preds, gdim * 2)
        self.gconv_net_ec = GraphTripleConvNet(gdim * 2 + add, gdim * 2 + add,
                                               hidden_dim=gdim * 4, output_dim=self.out_dim)
        self.gconv_net_manipulation = GraphTripleConvNet(
            self.out_dim + gdim + gdim * 2 + add, gdim * 2 + add, hidden_dim=gdim * 4,
            output_dim=self.out_dim)

    def forward(self, graph: Graph, generator: Optional[torch.Generator] = None,
                change_noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(latent (M, out_dim), decoder object embeddings (M, out_dim)).

        The change noise is ``change_noise`` (M, embedding_dim) when given,
        else drawn from ``generator`` (on its device), else zeros, as the JAX
        encoder without an rng."""
        dev = self.obj_embeddings_ec.weight.device
        g = graph_tensors(graph, dev)
        # encoder pass over the original graph
        tri = g["enc_triples"]
        edges = tri[:, [0, 2]]
        obj_embed = self.obj_embeddings_ec(g["enc_objs"])
        pred_embed = self.pred_embeddings_ec(tri[:, 1])
        if self.use_clip:
            obj_embed = torch.cat([g["enc_text_feat"], obj_embed], -1)
            pred_embed = torch.cat([g["enc_rel_feat"], pred_embed], -1)
        latent_obj, _ = self.gconv_net_ec(obj_embed, pred_embed, edges, g.get("enc_pred_mask"))

        # align to the decoder graph; zero rows for added nodes
        e2d = g["enc_to_dec"]
        added = e2d < 0
        latent_aligned = torch.where(added[:, None], 0.0, latent_obj[e2d.clamp(min=0)])
        touched = added | g["changed_mask"].to(torch.bool)
        m = latent_aligned.shape[0]
        if change_noise is not None:
            noise = torch.as_tensor(change_noise, dtype=torch.float32).to(dev)
        elif generator is not None:   # under dp: this rank's rows of the global draw
            noise = rank_rows(lambda n: torch.randn((n, self.embedding_dim), generator=generator,
                                                    device=generator.device), m).to(dev)
        else:
            noise = torch.zeros((m, self.embedding_dim), device=dev)
        change_repr = torch.where(touched[:, None], noise, 0.0)

        # manipulation pass over the decoder graph
        dtri = g["dec_triples"]
        obj_embed_d = self.obj_embeddings_ec(g["dec_objs"])
        pred_embed_d = self.pred_embeddings_man_dc(dtri[:, 1])
        if self.use_clip:
            obj_embed_d = torch.cat([g["dec_text_feat"], obj_embed_d], -1)
            pred_embed_d = torch.cat([g["dec_rel_feat"], pred_embed_d], -1)
        man_in = torch.cat([latent_aligned, change_repr, obj_embed_d], -1)
        latent_man, _ = self.gconv_net_manipulation(man_in, pred_embed_d, dtri[:, [0, 2]],
                                                    g.get("dec_pred_mask"))
        if self.replace_latent:
            return latent_man, obj_embed_d
        # untouched nodes keep their original latents
        return torch.where(touched[:, None], latent_man, latent_aligned), obj_embed_d
