"""GIN convolution.

Counterpart of ``hydragnn_tpu/models/gin.py``:
``x_i' = MLP((1 + eps) * x_i + sum_{j in N(i)} x_j)`` with a two-layer MLP
(``Dense_0``, relu, ``Dense_1``) and a learnable scalar ``eps`` that starts
at 100.0. With receiver-sorted edges and an in-degree bound the neighbour
sum takes the sorted-segment kernel (K1 on the card, ops/segment.py).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.segment import segment_sum
from .base import register_conv
from .layers import Dense, _promote


class GINConv(nn.Module):
    """Parameter names follow the flax tree: ``eps``, ``Dense_0``,
    ``Dense_1``."""

    def __init__(self, in_dim: int, output_dim: int, eps_init: float = 100.0,
                 sorted_agg: bool = False, max_in_degree: int = 0):
        super().__init__()
        self.sorted_agg = sorted_agg
        self.max_in_degree = max_in_degree
        self.eps = nn.Parameter(torch.tensor(float(eps_init)))
        self.Dense_0 = Dense(in_dim, output_dim)
        self.Dense_1 = Dense(output_dim, output_dim)

    def forward(self, inv, equiv, batch):
        agg = segment_sum(inv[batch.senders], batch.receivers, batch.num_nodes,
                          batch.edge_mask, sorted_ids=self.sorted_agg,
                          max_degree=self.max_in_degree)
        # the f32 eps promotes a bf16 input, as jnp does
        dt = _promote(inv, self.eps)
        h = (1.0 + self.eps).to(dt) * inv.to(dt) + agg
        return self.Dense_1(torch.relu(self.Dense_0(h))), equiv


@register_conv("GIN", is_edge_model=False)
def make_gin(cfg, in_dim, out_dim, last_layer):
    return GINConv(in_dim, out_dim, sorted_agg=cfg.sorted_aggregation,
                   max_in_degree=cfg.max_in_degree)
