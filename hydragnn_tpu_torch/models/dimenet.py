"""DimeNet++ directional message passing.

Counterpart of ``hydragnn_tpu/models/dimenet.py``. Each conv layer is a
node projection, then the embedding block (edge messages from
``[x_i, x_j, rbf(, e)]``), the interaction block (each edge k->j gated by
the spherical basis of its triplets k->j->i and summed over them into edge
j->i), and the output block (edges summed into their receivers: K1 on the
card with sorted aggregation).

The triplets are padded on the host (``GraphBatch.trip_kj/trip_ji/
trip_mask``, from a pad spec with ``n_triplets``); the angles are
recomputed from the positions each call, so the energy-force objective
differentiates straight through them. Padding edges have eps-clamped
lengths: their rbf rows are zeroed at the source and the spherical basis
evaluates them at a safe distance (ops/sbf.py), so no huge intermediate
ever reaches a backward.

Parameter names follow the flax tree, whose ``Dense_<k>`` are numbered in
the order the layers are constructed: the node projection, the rbf and
(with ``edge_dim``) edge embeddings, the message layer, then the
interaction block's and the output block's layers; in a residual
``act(Dense(act(Dense(h))))`` the outer layer is constructed first
(``DimeNetConv.__init__`` creates them in that order).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.radial import bessel_basis_enveloped, edge_vectors
from ..ops.sbf import spherical_basis
from ..ops.segment import segment_sum
from .base import register_conv
from .layers import Dense


class DimeNetConv(nn.Module):
    def __init__(self, in_dim: int, output_dim: int, hidden_dim: int, num_radial: int = 6,
                 num_spherical: int = 7, basis_emb_size: int = 8, int_emb_size: int = 64,
                 out_emb_size: int = 128, num_before_skip: int = 1, num_after_skip: int = 2,
                 envelope_exponent: int = 5, radius: float = 5.0, edge_dim: int = 0,
                 sorted_agg: bool = False, max_in_degree: int = 0):
        super().__init__()
        self.num_radial = num_radial
        self.num_spherical = num_spherical
        self.envelope_exponent = envelope_exponent
        self.radius = radius
        self.has_edge = bool(edge_dim)
        self.sorted_agg = sorted_agg
        self.max_in_degree = max_in_degree
        # role -> layer; each registered as the next Dense_<k> of the flax
        # call order
        self.layers = {}
        h = hidden_dim
        self._dense("lin", in_dim, h)
        self._dense("emb_rbf", num_radial, h)
        if self.has_edge:
            self._dense("emb_edge", edge_dim, h)
        self._dense("emb", (4 if self.has_edge else 3) * h, h)
        self._dense("lin_ji", h, h)
        self._dense("lin_kj", h, h)
        self._dense("rbf1", num_radial, basis_emb_size, bias=False)
        self._dense("rbf2", basis_emb_size, h, bias=False)
        self._dense("down", h, int_emb_size)
        self._dense("sbf1", num_spherical * num_radial, basis_emb_size, bias=False)
        self._dense("sbf2", basis_emb_size, int_emb_size, bias=False)
        self._dense("up", int_emb_size, h)
        self.residuals = (num_before_skip, num_after_skip)
        for i in range(num_before_skip):
            self._dense(f"before{i}_outer", h, h)
            self._dense(f"before{i}_inner", h, h)
        self._dense("skip", h, h)
        for i in range(num_after_skip):
            self._dense(f"after{i}_outer", h, h)
            self._dense(f"after{i}_inner", h, h)
        self._dense("out_rbf", num_radial, h, bias=False)
        self._dense("out_up", h, out_emb_size, bias=False)
        self._dense("out_lin", out_emb_size, out_emb_size)
        self._dense("out", out_emb_size, output_dim, bias=False)

    def _dense(self, role: str, in_dim: int, out_dim: int, bias: bool = True) -> None:
        layer = Dense(in_dim, out_dim, bias=bias)
        self.add_module(f"Dense_{len(self.layers)}", layer)
        self.layers[role] = layer

    def forward(self, inv, equiv, batch):
        if batch.trip_kj is None:
            raise ValueError("DimeNet requires triplet indices: batch with a pad spec "
                             "built with_triplets=True")
        act = F.silu
        vec, length = edge_vectors(batch.pos, batch.senders, batch.receivers,
                                   batch.edge_shifts)
        dist = length[:, 0]
        zero = torch.zeros((), dtype=dist.dtype, device=dist.device)
        rbf = bessel_basis_enveloped(dist, self.radius, self.num_radial, self.envelope_exponent)
        # padding edges' eps-clamped lengths give a ~5e6 envelope spike:
        # zeroed at the source
        rbf = torch.where(batch.edge_mask[:, None], rbf, zero)

        # (the gathers are index_select: its backward is one index_add_)
        # the angle at j between edges j->i and k->i = k->j + j->i (the
        # vectors added separately, for periodic shifts); the smoothed cross
        # norm keeps d(angle)/d(pos) finite at collinear and zero-length
        # (padding) triplets
        pos_ji = vec.index_select(0, batch.trip_ji)
        pos_ki = vec.index_select(0, batch.trip_kj) + pos_ji
        a = torch.sum(pos_ji * pos_ki, dim=-1)
        cross = torch.linalg.cross(pos_ji, pos_ki, dim=-1)
        b = torch.sqrt(torch.sum(cross * cross, dim=-1)
                       + cross.new_full((), 1e-12))
        angle = torch.atan2(b, a)
        sbf = spherical_basis(dist, angle, batch.trip_kj, self.radius, self.num_spherical,
                              self.num_radial, self.envelope_exponent,
                              edge_mask=batch.edge_mask)

        # node projection + embedding block
        L = self.layers
        x = L["lin"](inv)
        parts = [x.index_select(0, batch.receivers), x.index_select(0, batch.senders),
                 act(L["emb_rbf"](rbf))]
        if self.has_edge and batch.edge_attr is not None:
            parts.append(act(L["emb_edge"](batch.edge_attr)))
        m = act(L["emb"](torch.cat(parts, dim=-1)))  # [E, H]

        # interaction block
        x_ji = act(L["lin_ji"](m))
        x_kj = act(L["lin_kj"](m)) * L["rbf2"](L["rbf1"](rbf))
        x_kj = act(L["down"](x_kj))
        t_msg = x_kj.index_select(0, batch.trip_kj) * L["sbf2"](L["sbf1"](sbf))  # [T, int_emb]
        agg = segment_sum(t_msg, batch.trip_ji, batch.num_edges, batch.trip_mask)
        h = x_ji + act(L["up"](agg))
        for i in range(self.residuals[0]):
            h = h + act(L[f"before{i}_outer"](act(L[f"before{i}_inner"](h))))
        h = act(L["skip"](h)) + m
        for i in range(self.residuals[1]):
            h = h + act(L[f"after{i}_outer"](act(L[f"after{i}_inner"](h))))

        # output block: edges -> receivers
        g = L["out_rbf"](rbf) * h
        node = segment_sum(g, batch.receivers, batch.num_nodes, batch.edge_mask,
                           sorted_ids=self.sorted_agg, max_degree=self.max_in_degree)
        node = act(L["out_lin"](L["out_up"](node)))
        return L["out"](node), equiv


@register_conv("DimeNet", is_edge_model=True, needs_triplets=True)
def make_dimenet(cfg, in_dim, out_dim, last_layer):
    # hidden = out_dim when the input is scalar, else in_dim, as the
    # reference's DIMEStack sizes it
    hidden = out_dim if in_dim == 1 else in_dim
    assert hidden > 1, (
        "DimeNet requires more than one hidden dimension between input_dim and output_dim."
    )
    return DimeNetConv(
        in_dim, out_dim, hidden,
        num_radial=cfg.num_radial or 6,
        num_spherical=cfg.num_spherical or 7,
        basis_emb_size=cfg.basis_emb_size or 8,
        int_emb_size=cfg.int_emb_size or 64,
        out_emb_size=cfg.out_emb_size or 128,
        num_before_skip=cfg.num_before_skip if cfg.num_before_skip is not None else 1,
        num_after_skip=cfg.num_after_skip if cfg.num_after_skip is not None else 2,
        envelope_exponent=cfg.envelope_exponent or 5,
        radius=cfg.radius or 5.0,
        edge_dim=cfg.edge_dim,
        sorted_agg=cfg.sorted_aggregation,
        max_in_degree=cfg.max_in_degree,
    )
