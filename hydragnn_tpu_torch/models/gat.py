"""GATv2 convolution.

Counterpart of ``hydragnn_tpu/models/gat.py``: 6 heads, negative slope
0.05; ``e_ij = a . LeakyReLU(W_l x_i + W_r x_j (+ W_e e_ij))``, ``alpha =
softmax_i(e_ij)``, ``out_i = sum_j alpha_ij W_r x_j``. Hidden layers
concatenate the heads (width ``6 * out``, exposed as ``out_width`` so the
next layer and its batch norm take it, as flax infers it); the last layer,
and every layer under GPS, averages them. The head sum runs on the
flattened ``[E, 6 * out]`` messages through K1. Parameter names follow the
flax tree: ``Dense_0`` (W_l), ``Dense_1`` (W_r), ``Dense_2`` (W_e, with
``edge_dim``) and ``att`` [1, heads, out].
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.segment import segment_softmax, segment_sum
from .base import register_conv
from .layers import Dense, OwnInit, glorot_uniform_, leaky_relu


class GATv2Conv(OwnInit, nn.Module):
    def __init__(self, in_dim: int, output_dim: int, heads: int = 6, concat: bool = True,
                 negative_slope: float = 0.05, edge_dim: int = 0, sorted_agg: bool = False,
                 max_in_degree: int = 0):
        super().__init__()
        self.heads, self.channels = heads, output_dim
        self.concat = concat
        self.negative_slope = negative_slope
        self.sorted_agg = sorted_agg
        self.max_in_degree = max_in_degree
        self.out_width = heads * output_dim if concat else output_dim
        self.Dense_0 = Dense(in_dim, heads * output_dim)
        self.Dense_1 = Dense(in_dim, heads * output_dim)
        self.Dense_2 = Dense(edge_dim, heads * output_dim) if edge_dim else None
        self.att = nn.Parameter(torch.empty(1, heads, output_dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        glorot_uniform_(self.att, gen)

    def forward(self, inv, equiv, batch):
        h, c = self.heads, self.channels
        x_l = self.Dense_0(inv).reshape(-1, h, c)  # receiver (query) side
        x_r = self.Dense_1(inv).reshape(-1, h, c)  # sender (value) side
        g = x_l[batch.receivers] + x_r[batch.senders]
        if self.Dense_2 is not None and batch.edge_attr is not None:
            g = g + self.Dense_2(batch.edge_attr).reshape(-1, h, c)
        g = leaky_relu(g, self.negative_slope)
        logits = torch.sum(g * self.att, dim=-1)  # [E, H]
        alpha = segment_softmax(logits, batch.receivers, batch.num_nodes, batch.edge_mask)
        msg = x_r[batch.senders] * alpha[..., None]  # [E, H, C]
        out = segment_sum(msg.reshape(-1, h * c), batch.receivers, batch.num_nodes,
                          batch.edge_mask, sorted_ids=self.sorted_agg,
                          max_degree=self.max_in_degree).reshape(-1, h, c)
        if self.concat:
            return out.reshape(-1, h * c), equiv
        return out.mean(dim=1), equiv


@register_conv("GAT", is_edge_model=True)
def make_gat(cfg, in_dim, out_dim, last_layer):
    return GATv2Conv(in_dim, out_dim, heads=6, concat=not last_layer, negative_slope=0.05,
                     edge_dim=cfg.edge_dim, sorted_agg=cfg.sorted_aggregation,
                     max_in_degree=cfg.max_in_degree)
