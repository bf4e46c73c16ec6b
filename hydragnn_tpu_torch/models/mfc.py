"""MFC (molecular fingerprint) convolution.

Counterpart of ``hydragnn_tpu/models/mfc.py``: Duvenaud-style weights per
degree, ``x_i' = W_root^(d_i) x_i + W_nbr^(d_i) sum_j x_j + b^(d_i)`` with
``d_i`` the in-degree clipped to ``max_degree`` (the config's
``max_neighbours``, 10 when unset). The per-node weights are selected by a
one-hot degree matrix in dense einsums, as the JAX package computes them
(outside any kernel); the neighbour sum is K1's. Parameters ``w_root`` and
``w_nbr`` [max_degree + 1, in, out] and ``bias`` [max_degree + 1, out],
named and laid out as in the flax tree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.segment import segment_count, segment_sum
from .base import register_conv
from .layers import OwnInit, _promote, glorot_uniform_


class MFConv(OwnInit, nn.Module):
    def __init__(self, in_dim: int, output_dim: int, max_degree: int = 10,
                 sorted_agg: bool = False, max_in_degree: int = 0):
        super().__init__()
        self.max_degree = max_degree
        self.sorted_agg = sorted_agg
        self.max_in_degree = max_in_degree
        d = max_degree + 1
        self.w_root = nn.Parameter(torch.empty(d, in_dim, output_dim))
        self.w_nbr = nn.Parameter(torch.empty(d, in_dim, output_dim))
        self.bias = nn.Parameter(torch.zeros(d, output_dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        glorot_uniform_(self.w_root, gen)
        glorot_uniform_(self.w_nbr, gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, inv, equiv, batch):
        agg = segment_sum(inv[batch.senders], batch.receivers, batch.num_nodes,
                          batch.edge_mask, sorted_ids=self.sorted_agg,
                          max_degree=self.max_in_degree)
        deg = segment_count(batch.receivers, batch.num_nodes, batch.edge_mask)
        deg = torch.clamp(deg.to(torch.int32), 0, self.max_degree)
        dt = _promote(inv, agg, self.w_root, self.w_nbr, self.bias)
        onehot = F.one_hot(deg.long(), self.max_degree + 1).to(dt)  # [N, D]
        out = torch.einsum("nd,nf,dfo->no", onehot, inv.to(dt), self.w_root.to(dt))
        out = out + torch.einsum("nd,nf,dfo->no", onehot, agg.to(dt), self.w_nbr.to(dt))
        return out + onehot @ self.bias.to(dt), equiv


@register_conv("MFC", is_edge_model=False)
def make_mfc(cfg, in_dim, out_dim, last_layer):
    max_deg = cfg.max_neighbours if cfg.max_neighbours is not None else 10
    return MFConv(in_dim, out_dim, max_degree=int(max_deg),
                  sorted_agg=cfg.sorted_aggregation, max_in_degree=cfg.max_in_degree)
