"""GraphSAGE convolution.

Counterpart of ``hydragnn_tpu/models/sage.py``:
``x_i' = W_neigh mean_{j in N(i)} x_j + b + W_root x_i``. The neighbour
mean is K1's sum (sorted ids with an in-degree bound) over the count.
Parameter names follow the flax tree: ``Dense_0`` (the mean, with the
bias), ``Dense_1`` (the root, no bias).
"""

from __future__ import annotations

from torch import nn

from ..ops.segment import segment_mean
from .base import register_conv
from .layers import Dense


class SAGEConv(nn.Module):
    def __init__(self, in_dim: int, output_dim: int, sorted_agg: bool = False,
                 max_in_degree: int = 0):
        super().__init__()
        self.sorted_agg = sorted_agg
        self.max_in_degree = max_in_degree
        self.Dense_0 = Dense(in_dim, output_dim)
        self.Dense_1 = Dense(in_dim, output_dim, bias=False)

    def forward(self, inv, equiv, batch):
        agg = segment_mean(inv[batch.senders], batch.receivers, batch.num_nodes,
                           batch.edge_mask, sorted_ids=self.sorted_agg,
                           max_degree=self.max_in_degree)
        return self.Dense_0(agg) + self.Dense_1(inv), equiv


@register_conv("SAGE", is_edge_model=False)
def make_sage(cfg, in_dim, out_dim, last_layer):
    return SAGEConv(in_dim, out_dim, sorted_agg=cfg.sorted_aggregation,
                    max_in_degree=cfg.max_in_degree)
