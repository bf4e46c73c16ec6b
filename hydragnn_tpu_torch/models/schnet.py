"""SchNet continuous-filter convolution (CFConv).

Counterpart of ``hydragnn_tpu/models/schnet.py``: Gaussian-smeared
distances from the original positions (with the PBC shifts) feed a
softplus filter MLP, enveloped by the cosine cutoff; the messages
``h_j * W(e_ij)`` are summed (K1 at ``num_filters`` wide), projected, and
added to the input (width-preserving layers) or to a learned embedding of
it. With ``equivariance`` every layer but the last moves the coordinates
as EGNN does (``coordinate_displacement`` over the running positions, no
tanh, unsorted mean); the scalar stream keeps reading the original
positions' rbf. Distances are recomputed from positions each call, so the
energy-force objective differentiates straight through.

Parameter names follow the flax tree: ``MLP_0`` (filter), ``Dense_0``
(h, no bias), ``Dense_1`` (output), ``Dense_2`` (the input embedding, no
bias, when the widths differ), then in equivariant layers ``MLP_1`` and
the next ``Dense_k`` (the displacement gate, gain 0.001).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.radial import cosine_cutoff, edge_vectors, gaussian_basis
from ..ops.segment import segment_sum
from .base import register_conv
from .egnn import coordinate_displacement
from .layers import MLP, Dense


class CFConv(nn.Module):
    def __init__(self, in_dim: int, output_dim: int, num_filters: int, num_gaussians: int,
                 radius: float, edge_dim: int = 0, equivariant: bool = False,
                 sorted_agg: bool = False, max_in_degree: int = 0):
        super().__init__()
        self.num_gaussians = num_gaussians
        self.radius = radius
        self.has_edge = bool(edge_dim)
        self.equivariant = equivariant
        self.sorted_agg = sorted_agg
        self.max_in_degree = max_in_degree
        self.MLP_0 = MLP(num_gaussians + edge_dim, (num_filters, num_filters), "softplus")
        self.Dense_0 = Dense(in_dim, num_filters, bias=False)
        self.Dense_1 = Dense(num_filters, output_dim)
        k = 2
        self.embeds = in_dim != output_dim
        if self.embeds:
            self.Dense_2 = Dense(in_dim, output_dim, bias=False)
            k = 3
        if equivariant:
            self.MLP_1 = MLP(num_filters, (num_filters,), "relu", final_activation=True)
            self.gate_name = f"Dense_{k}"
            self.add_module(self.gate_name, Dense(num_filters, 1, bias=False,
                                                  init=("variance_scaling", 0.001)))

    def forward(self, inv, equiv, batch):
        _, length0 = edge_vectors(batch.pos, batch.senders, batch.receivers, batch.edge_shifts)
        r = length0[:, 0]
        rbf = gaussian_basis(r, self.radius, self.num_gaussians)
        filt_in = rbf
        if self.has_edge and batch.edge_attr is not None:
            filt_in = torch.cat([rbf, batch.edge_attr], dim=-1)
        w = self.MLP_0(filt_in) * cosine_cutoff(r, self.radius)[:, None]
        msg = self.Dense_0(inv)[batch.senders] * w
        agg = segment_sum(msg, batch.receivers, batch.num_nodes, batch.edge_mask,
                          sorted_ids=self.sorted_agg, max_degree=self.max_in_degree)
        out = self.Dense_1(agg)
        out = out + (self.Dense_2(inv) if self.embeds else inv)
        if self.equivariant:
            vec, length = edge_vectors(equiv, batch.senders, batch.receivers)
            unit = vec / (length + 1.0)
            equiv = equiv + coordinate_displacement(self.MLP_1, getattr(self, self.gate_name),
                                                    unit, w, batch)
        return out, equiv


@register_conv("SchNet", is_edge_model=True)
def make_schnet(cfg, in_dim, out_dim, last_layer):
    return CFConv(
        in_dim, out_dim,
        num_filters=cfg.num_filters or 126,
        num_gaussians=cfg.num_gaussians or 50,
        radius=cfg.radius or 5.0,
        edge_dim=cfg.edge_dim,
        # the last layer stays invariant, so node outputs are E(3)-invariant
        equivariant=cfg.equivariance and not last_layer,
        sorted_agg=cfg.sorted_aggregation,
        max_in_degree=cfg.max_in_degree,
    )
