"""CGCNN (crystal graph) convolution.

Counterpart of ``hydragnn_tpu/models/cgcnn.py``:
``x_i' = x_i + sum_j sigmoid(z_ij W_f + b_f) * softplus(z_ij W_s + b_s)``,
``z_ij = [x_i, x_j(, e_ij)]``, both projections distributed over the concat
and computed on node-sized operands before the edge gather
(``hoisted_pair_dense``). Dimension-preserving: config completion pins
``hidden_dim`` to the input width unless GPS is on. The edge sum is K1's at
that width. Parameter names follow the flax tree: ``gate_recv``,
``gate_send`` (``gate_edge``), ``core_recv``, ``core_send``
(``core_edge``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.segment import segment_sum
from .base import register_conv
from .layers import Dense, hoisted_pair_dense


class CGConv(nn.Module):
    def __init__(self, in_dim: int, output_dim: int, edge_dim: int = 0,
                 sorted_agg: bool = False, max_in_degree: int = 0):
        super().__init__()
        self.sorted_agg = sorted_agg
        self.max_in_degree = max_in_degree
        self.has_edge = bool(edge_dim)
        for name in ("gate", "core"):
            self.add_module(f"{name}_recv", Dense(in_dim, output_dim))
            self.add_module(f"{name}_send", Dense(in_dim, output_dim, bias=False))
            if edge_dim:
                self.add_module(f"{name}_edge", Dense(edge_dim, output_dim, bias=False))

    def _z(self, name, inv, batch):
        terms = []
        if self.has_edge and batch.edge_attr is not None:
            terms.append((getattr(self, f"{name}_edge"), batch.edge_attr))
        return hoisted_pair_dense(getattr(self, f"{name}_recv"), getattr(self, f"{name}_send"),
                                  inv, batch, terms)

    def forward(self, inv, equiv, batch):
        gate = torch.sigmoid(self._z("gate", inv, batch))
        core = F.softplus(self._z("core", inv, batch))
        agg = segment_sum(gate * core, batch.receivers, batch.num_nodes, batch.edge_mask,
                          sorted_ids=self.sorted_agg, max_degree=self.max_in_degree)
        return inv + agg, equiv


@register_conv("CGCNN", is_edge_model=True)
def make_cgcnn(cfg, in_dim, out_dim, last_layer):
    return CGConv(in_dim, out_dim, edge_dim=cfg.edge_dim, sorted_agg=cfg.sorted_aggregation,
                  max_in_degree=cfg.max_in_degree)
