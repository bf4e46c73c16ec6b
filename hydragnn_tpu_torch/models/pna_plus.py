"""PNAPlus: PNA aggregation with Bessel radial-basis edge conditioning.

Counterpart of ``hydragnn_tpu/models/pna_plus.py``: the PNA pre-message
over [x_i, x_j, rbf_emb (+edge)] in factored form, Hadamard-gated by a
bias-free projection of the enveloped Bessel basis of the edge length, then
PNA's four aggregators and degree scalers. With ``multi_agg`` on a sorted,
degree-bounded batch the receiver projection and the gate ride K3's
``node_recv`` and ``gate`` operands (ops/multi_agg.py): the gated [E, C]
message is never materialized.

Parameter names follow the flax tree: ``Dense_0`` (rbf embedding),
``Dense_1`` (edge features with the embedding, with ``edge_dim``),
``pre_recv``, ``pre_send``, ``pre_edge``, then the next ``Dense``s: the
gate (no bias), the output over [x, scaled], and the last.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.radial import bessel_basis_enveloped, edge_vectors
from .base import register_conv
from .layers import Dense
from .pna import pna_aggregate, pna_pre_message


class PNAPlusConv(nn.Module):
    def __init__(self, in_dim: int, output_dim: int, deg_hist: Tuple[int, ...], radius: float,
                 num_radial: int = 5, envelope_exponent: int = 5, edge_dim: int = 0,
                 sorted_agg: bool = False, max_in_degree: int = 0, multi_agg: bool = False):
        super().__init__()
        self.deg_hist = tuple(deg_hist)
        self.radius = radius
        self.num_radial = num_radial
        self.envelope_exponent = envelope_exponent
        self.has_edge = bool(edge_dim)
        self.sorted_agg = sorted_agg
        self.max_in_degree = max_in_degree
        self.multi_agg = multi_agg
        f = in_dim
        self.Dense_0 = Dense(num_radial, f)
        k = 1
        if edge_dim:
            self.Dense_1 = Dense(edge_dim + f, f)
            k = 2
        self.pre_recv = Dense(f, f)
        self.pre_send = Dense(f, f, bias=False)
        self.pre_edge = Dense(f, f, bias=False)
        self.gate, self.out_0, self.out_1 = (f"Dense_{k + i}" for i in range(3))
        self.add_module(self.gate, Dense(num_radial, f, bias=False))
        self.add_module(self.out_0, Dense(f + 16 * f, output_dim))
        self.add_module(self.out_1, Dense(output_dim, output_dim))

    def forward(self, inv, equiv, batch):
        _, length = edge_vectors(equiv, batch.senders, batch.receivers, batch.edge_shifts)
        rbf = bessel_basis_enveloped(length[:, 0], self.radius, self.num_radial,
                                     self.envelope_exponent)
        e = torch.relu(self.Dense_0(rbf))
        if self.has_edge and batch.edge_attr is not None:
            e = self.Dense_1(torch.cat([batch.edge_attr, e], dim=-1))
        node_recv, edge_in = pna_pre_message(self, inv, batch, [(self.pre_edge, e)])
        gate = getattr(self, self.gate)(rbf)
        scaled = pna_aggregate(edge_in, batch, self.deg_hist, self.sorted_agg,
                               self.max_in_degree, node_recv=node_recv, gate=gate,
                               multi_agg=self.multi_agg)
        out = getattr(self, self.out_0)(torch.cat([inv, scaled], dim=-1))
        return getattr(self, self.out_1)(out), equiv


@register_conv("PNAPlus", is_edge_model=True)
def make_pna_plus(cfg, in_dim, out_dim, last_layer):
    return PNAPlusConv(
        in_dim, out_dim, cfg.pna_deg,
        radius=cfg.radius or 5.0,
        num_radial=cfg.num_radial or 5,
        envelope_exponent=cfg.envelope_exponent or 5,
        edge_dim=cfg.edge_dim,
        sorted_agg=cfg.sorted_aggregation,
        max_in_degree=cfg.max_in_degree,
        multi_agg=cfg.fused_edge_kernel,
    )
