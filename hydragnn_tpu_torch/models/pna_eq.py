"""PNAEq: equivariant PNA (a PaiNN vector channel with PNA scalar
aggregation).

Counterpart of ``hydragnn_tpu/models/pna_eq.py``: the scalar message is the
pre-message over [x_i, x_j, tanh(rbf_emb) (+edge)] in factored form, through
a silu MLP, Hadamard-gated by a projection of the enveloped Bessel basis and
split three ways (vector gate, edge-vector gate, scalar message). The
vector messages are summed on the plain scatter ([E, 3, F]); the scalar
messages take PNA's aggregators and degree scalers, on K3's ``edge_in``-only
route with ``multi_agg`` on a sorted, degree-bounded batch (the message is
post-MLP, so nothing of it can be gathered inside the kernel). A PaiNN
update block follows. The JAX package's ``remat_policy`` (what its backward
keeps in memory) changes no number and has no counterpart here.

Parameter names follow the flax tree: ``x_proj``, ``Dense_0``
(rbf embedding), ``Dense_1`` (edge features, with ``edge_dim``),
``pre_recv``, ``pre_send``, ``pre_rbf``, ``pre_attr``, ``MLP_0``, then the
next ``Dense``s: the rbf gate (no bias), the scalar delta over [x, scaled],
and the update block's U and V, and its ``MLP_1`` (no ``v_proj``, as in
``painn.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.radial import bessel_basis_enveloped, edge_vectors
from ..ops.segment import segment_sum
from .base import register_conv
from .layers import MLP, Dense, hoisted_pair_dense
from .painn import VectorsIn, add_painn_update, painn_update, vector_state
from .pna import pna_aggregate


class PNAEqConv(VectorsIn, nn.Module):
    def __init__(self, in_dim: int, node_size: int, deg_hist: Tuple[int, ...],
                 num_radial: int, radius: float, edge_dim: int = 0, last_layer: bool = False,
                 sorted_agg: bool = False, max_in_degree: int = 0, multi_agg: bool = False):
        super().__init__()
        f = node_size
        self.node_size = node_size
        self.deg_hist = tuple(deg_hist)
        self.num_radial = num_radial
        self.radius = radius
        self.has_edge = bool(edge_dim)
        self.last_layer = last_layer
        self.sorted_agg = sorted_agg
        self.max_in_degree = max_in_degree
        self.multi_agg = multi_agg
        self.x_proj = Dense(in_dim, f) if in_dim != f else None
        self.Dense_0 = Dense(num_radial, f)
        k = 1
        if edge_dim:
            self.Dense_1 = Dense(edge_dim, f)
            self.pre_attr = Dense(f, f, bias=False)
            k = 2
        self.pre_recv = Dense(f, f)
        self.pre_send = Dense(f, f, bias=False)
        self.pre_rbf = Dense(f, f, bias=False)
        self.MLP_0 = MLP(f, (f, f, 3 * f), "silu")
        self.rbf_gate, self.delta = f"Dense_{k}", f"Dense_{k + 1}"
        self.add_module(self.rbf_gate, Dense(num_radial, 3 * f, bias=False))
        self.add_module(self.delta, Dense(f + 16 * f, f))
        add_painn_update(self, f, last_layer, dense_index=k + 2, mlp_index=1)

    def forward(self, inv, equiv, batch):
        n = batch.num_nodes
        x = inv if self.x_proj is None else self.x_proj(inv)
        v = vector_state(equiv, n, self.node_size, self._modules.get("v_proj"))
        vec, length = edge_vectors(batch.pos, batch.senders, batch.receivers, batch.edge_shifts)
        r = length[:, 0]
        unit = vec / length
        rbf = bessel_basis_enveloped(r, self.radius, self.num_radial)

        terms = [(self.pre_rbf, torch.tanh(self.Dense_0(rbf)))]
        if self.has_edge and batch.edge_attr is not None:
            terms.append((self.pre_attr, self.Dense_1(batch.edge_attr)))
        msg = hoisted_pair_dense(self.pre_recv, self.pre_send, x, batch, terms)
        msg = self.MLP_0(torch.tanh(msg)) * getattr(self, self.rbf_gate)(rbf)
        gate_v, gate_edge, msg_s = torch.chunk(msg, 3, dim=-1)

        msg_v = v[batch.senders] * gate_v[:, None, :] + gate_edge[:, None, :] * unit[:, :, None]
        v = v + segment_sum(msg_v, batch.receivers, n, batch.edge_mask)
        scaled = pna_aggregate(msg_s, batch, self.deg_hist, self.sorted_agg,
                               self.max_in_degree, multi_agg=self.multi_agg)
        x = x + getattr(self, self.delta)(torch.cat([x, scaled], dim=-1))
        return painn_update(self, x, v, self.last_layer)


@register_conv("PNAEq", is_edge_model=True)
def make_pna_eq(cfg, in_dim, out_dim, last_layer):
    return PNAEqConv(
        in_dim, out_dim, cfg.pna_deg,
        num_radial=cfg.num_radial or 5,
        radius=cfg.radius or 5.0,
        edge_dim=cfg.edge_dim,
        last_layer=last_layer,
        sorted_agg=cfg.sorted_aggregation,
        max_in_degree=cfg.max_in_degree,
        multi_agg=cfg.fused_edge_kernel,
    )
