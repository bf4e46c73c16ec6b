"""E(n)-equivariant graph conv (EGNN).

Counterpart of ``hydragnn_tpu/models/egnn.py``: message MLP over
[h_i, h_j, |x_i - x_j|], sum aggregation, node MLP over [h, agg]; the
equivariant variant also moves the coordinates along normalized edge vectors
gated by a small MLP (tanh-bounded, mean-aggregated). Non-equivariant layers
with sorted aggregation and the fused flag run the edge path as one fused op
(K2); the others aggregate with the sorted-segment sum (K1).

Parameter names follow the flax tree: ``edge_lin_recv``/``edge_lin_send``/
``edge_lin_len``/``edge_lin2``, and in equivariant layers the coordinate
gate ``MLP_0`` + ``Dense_0`` and ``coords_range`` before the node MLP
``MLP_1`` (``MLP_0`` in the others).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.radial import edge_vectors
from ..ops.segment import segment_mean, segment_sum
from .base import register_conv
from .layers import MLP, Dense, fused_pair_dense_sum, hoisted_pair_dense


def coordinate_displacement(gate_mlp, gate_out, unit, gate_feat, batch, tanh: bool = False,
                            sorted_agg: bool = False, max_in_degree: int = 0):
    """Mean-aggregated coordinate displacement along normalized edge
    vectors, gated by ``gate_mlp`` -> ``gate_out`` (final gain 0.001;
    ``tanh`` bounds it). Shared by EGNN and equivariant SchNet."""
    coef = gate_out(gate_mlp(gate_feat))
    if tanh:
        coef = torch.tanh(coef)
    trans = torch.clamp(unit * coef, -100.0, 100.0)
    return segment_mean(trans, batch.receivers, batch.num_nodes, batch.edge_mask,
                        sorted_ids=sorted_agg, max_degree=max_in_degree)


class EGCL(nn.Module):
    def __init__(self, in_dim: int, output_dim: int, hidden_dim: int,
                 edge_dim: int = 0, equivariant: bool = False, tanh: bool = True,
                 sorted_agg: bool = False, max_in_degree: int = 0,
                 fused_edge: bool = False):
        super().__init__()
        self.equivariant = equivariant
        self.tanh = tanh
        self.sorted_agg = sorted_agg
        self.max_in_degree = max_in_degree
        self.fused_edge = fused_edge
        self.edge_lin_recv = Dense(in_dim, hidden_dim)
        self.edge_lin_send = Dense(in_dim, hidden_dim, bias=False)
        self.edge_lin_len = Dense(1, hidden_dim, bias=False)
        self.edge_lin_attr = Dense(edge_dim, hidden_dim, bias=False) if edge_dim else None
        self.edge_lin2 = Dense(hidden_dim, hidden_dim)
        if equivariant:
            self.MLP_0 = MLP(hidden_dim, (hidden_dim,), "relu", final_activation=True)
            self.Dense_0 = Dense(hidden_dim, 1, bias=False,
                                 init=("variance_scaling", 0.001))
            self.coords_range = nn.Parameter(torch.ones(1)) if tanh else None
            self.MLP_1 = MLP(in_dim + hidden_dim, (hidden_dim, output_dim), "relu")
        else:
            self.MLP_0 = MLP(in_dim + hidden_dim, (hidden_dim, output_dim), "relu")

    @property
    def node_mlp(self) -> MLP:
        return self.MLP_1 if self.equivariant else self.MLP_0

    @property
    def uses_fused_edge(self) -> bool:
        return (self.fused_edge and self.sorted_agg and self.max_in_degree > 0
                and not self.equivariant)

    def forward(self, inv, equiv, batch):
        pos = equiv
        # positions from bare coordinates in every layer (PBC shifts are
        # zeroed for positional-update models, as in the JAX package)
        vec, length = edge_vectors(pos, batch.senders, batch.receivers)
        unit = vec / (length + 1.0)
        terms = [(self.edge_lin_len, length)]
        if self.edge_lin_attr is not None and batch.edge_attr is not None:
            terms.append((self.edge_lin_attr, batch.edge_attr))

        if self.uses_fused_edge:
            agg = fused_pair_dense_sum(self, inv, batch, terms,
                                       max_in_degree=self.max_in_degree)
        else:
            pre = hoisted_pair_dense(self.edge_lin_recv, self.edge_lin_send, inv, batch, terms)
            edge_feat = torch.relu(self.edge_lin2(torch.relu(pre)))
            if self.equivariant:
                delta = coordinate_displacement(
                    self.MLP_0, self.Dense_0, unit, edge_feat, batch, tanh=self.tanh,
                    sorted_agg=self.sorted_agg, max_in_degree=self.max_in_degree)
                if self.tanh:
                    delta = delta * self.coords_range * 3.0
                pos = pos + delta
            agg = segment_sum(edge_feat, batch.receivers, batch.num_nodes,
                              batch.edge_mask, sorted_ids=self.sorted_agg,
                              max_degree=self.max_in_degree)
        dt = torch.promote_types(inv.dtype, agg.dtype)
        out = self.node_mlp(torch.cat([inv.to(dt), agg.to(dt)], dim=-1))
        return out, pos


@register_conv("EGNN", is_edge_model=True)
def make_egnn(cfg, in_dim, out_dim, last_layer):
    return EGCL(
        in_dim=in_dim,
        output_dim=out_dim,
        hidden_dim=cfg.hidden_dim,
        edge_dim=cfg.edge_dim,
        equivariant=cfg.equivariance and not last_layer,
        sorted_agg=cfg.sorted_aggregation,
        max_in_degree=cfg.max_in_degree,
        fused_edge=cfg.fused_edge_kernel,
    )
