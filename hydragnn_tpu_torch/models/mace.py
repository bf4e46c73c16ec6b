"""MACE: higher-order E(3)-equivariant message passing.

Counterpart of ``hydragnn_tpu/models/mace.py``, on dense
uniform-multiplicity irreps ``[N, C, (L+1)^2]`` and host-computed real CG
tensors (ops/o3.py):

- node attributes are one-hot atomic numbers Z in [1, 118], embedded to C
  scalar channels;
- each layer's interaction: an equivariant skip, ``linear_up``, a radial
  MLP over ``[radial basis, scalars_down[sender], scalars_down[receiver]]``
  giving per-path per-channel tensor-product weights, the CG coupling of
  the sender features with the edges' spherical harmonics, the receiver
  sum over ``[E, C * (max_ell+1)^2]`` (K1 on the card with sorted
  aggregation) over ``avg_num_neighbors``, and ``linear``;
- then the symmetric product basis, B_1 = A, B_{k+1} = CG(B_k x A), weighted
  per element and channel at every order, and the ``sizing`` linear;
- the prediction is the sum of a readout per layer and one of the one-hot
  attributes; the last layer's readout is an MLP.

The CG contractions take the JAX package's fused route, its one compute
route here: one product with the block tensor ``combined_cg`` (every
coupling path at once; 0/1 matrices then spread each path's weights over
its output columns and sum each output irrep's paths) and one with
``summed_cg`` per order of the product basis. The JAX package's per-path
``couple`` loop computes the same function on the same parameters. The CG
tensors take the features' dtype, as there.

Parameter names follow the flax tree (``node_embedding``,
``conv<i>/interaction/{skip, linear_up, linear_down, conv_tp_weights,
linear}``, ``conv<i>/product/w<k>_<l>``, ``conv<i>/sizing``, the branch
banks ``readout<idx>_head<i>``); ``EquivariantLinear``'s weights ``w<l>``
keep the flax layout ``[C_in, C_out]``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from ..ops.o3 import combined_cg, irrep_slice, real_sph_harm, sh_dim, summed_cg, tp_paths
from ..ops.radial import _const, edge_vectors, radial_embedding
from ..ops.segment import masked_global_mean_pool, segment_sum
from .base import GraphHeadConfig, ModelConfig, NodeHeadConfig
from .layers import MLP, BankedDense, Dense, OwnInit, _lecun_normal_, _promote

NUM_ELEMENTS = 118


def _sum_by_l(by_l: List[List[torch.Tensor]], like: torch.Tensor, rows: int, c: int):
    """Per-l partial sums (in list order) concatenated into one irreps
    array; an l with no block is zeros."""
    return torch.cat([
        sum(blocks) if blocks else like.new_zeros((rows, c, 2 * l + 1))
        for l, blocks in enumerate(by_l)
    ], dim=-1)


class EquivariantLinear(OwnInit, nn.Module):
    """Per-l channel mixing ``[N, C_in, (L_in+1)^2] -> [N, C_out,
    (L_out+1)^2]``: one ``[C_in, C_out]`` weight per l (shared by its 2l+1
    components, which keeps it equivariant), a bias on l = 0 only, zeros
    for an output l above the input's."""

    def __init__(self, c_in: int, features: int, lmax_in: int, lmax_out: int):
        super().__init__()
        self.features = features
        self.lmax_in = lmax_in
        self.lmax_out = lmax_out
        for l in range(min(lmax_in, lmax_out) + 1):
            self.register_parameter(f"w{l}", nn.Parameter(torch.empty(c_in, features)))
        self.b0 = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, gen: torch.Generator) -> None:
        for l in range(min(self.lmax_in, self.lmax_out) + 1):
            w = getattr(self, f"w{l}")
            _lecun_normal_(w, w.shape[0], gen)
        with torch.no_grad():
            self.b0.zero_()

    def forward(self, x):
        n = x.shape[0]
        dt = _promote(x, self.b0)
        x = x.to(dt)
        outs = []
        for l in range(self.lmax_out + 1):
            if l <= self.lmax_in:
                w = getattr(self, f"w{l}").to(dt)
                block = torch.einsum("ncm,cf->nfm", x[:, :, irrep_slice(l)], w)
                if l == 0:
                    block = block + self.b0.to(dt)[None, :, None]
            else:
                block = x.new_zeros((n, self.features, 2 * l + 1))
            outs.append(block)
        return torch.cat(outs, dim=-1)


class MACEInteraction(nn.Module):
    """The residual interaction block: returns (message aggregate after
    ``linear``, skip)."""

    def __init__(self, c: int, lmax_in: int, max_ell: int, node_max_ell: int,
                 num_radial: int, edge_dim: int, avg_num_neighbors: float,
                 sorted_agg: bool = False, max_in_degree: int = 0, last_layer: bool = False):
        super().__init__()
        self.c = c
        self.max_ell = max_ell
        self.avg_num_neighbors = avg_num_neighbors
        self.sorted_agg = sorted_agg
        self.max_in_degree = max_in_degree
        self.has_edge = bool(edge_dim)
        self.skip = EquivariantLinear(c, c, lmax_in, 0 if last_layer else node_max_ell)
        self.linear_up = EquivariantLinear(c, c, lmax_in, lmax_in)
        self.linear_down = Dense(c, c)
        G, paths, offsets = combined_cg(lmax_in, max_ell, max_ell)
        assert paths == tuple(tp_paths(lmax_in, max_ell, max_ell))
        self.conv_tp_weights = MLP(num_radial + 2 * c + edge_dim, (c, c, c, len(paths) * c),
                                   "silu")
        # 0/1 matrices of the block tensor's columns q: ``spread`` [P, Q]
        # copies path p's weight to its columns, ``slot`` [Q, D] adds each
        # column into its place in the output irreps
        spread = np.zeros((len(paths), G.shape[-1]), np.float32)
        slot = np.zeros((G.shape[-1], sh_dim(max_ell)), np.float32)
        for p, (off, (_, _, l3)) in enumerate(zip(offsets, paths)):
            for j in range(2 * l3 + 1):
                spread[p, off + j] = 1.0
                slot[off + j, l3 * l3 + j] = 1.0
        self.register_buffer("cg", torch.from_numpy(G), persistent=False)
        self.register_buffer("spread", torch.from_numpy(spread), persistent=False)
        self.register_buffer("slot", torch.from_numpy(slot), persistent=False)
        self.linear = EquivariantLinear(c, c, max_ell, max_ell)

    def forward(self, h, sh, radial, batch):
        c, e = self.c, sh.shape[0]
        sc = self.skip(h)
        h_up = self.linear_up(h)
        scalars_down = self.linear_down(h[:, :, 0])
        # the edge gathers as index_select: its backward is one index_add_
        edge_in = [radial, scalars_down.index_select(0, batch.senders),
                   scalars_down.index_select(0, batch.receivers)]
        if self.has_edge and batch.edge_attr is not None:
            edge_in.append(batch.edge_attr)
        tp_w = self.conv_tp_weights(torch.cat(edge_in, dim=-1)).reshape(e, -1, c)
        dt = h.dtype
        # every coupling path in one product: (sh . G) per edge, then the
        # sender features against it; each path's weights on its columns
        coupling = torch.einsum("en,mnq->emq", sh, self.cg.to(dt))
        raw = torch.bmm(h_up.index_select(0, batch.senders), coupling)  # [E, C, Q]
        weighted = raw * torch.matmul(tp_w.transpose(1, 2), self.spread.to(dt))
        msg = torch.matmul(weighted, self.slot.to(dt))  # [E, C, (max_ell+1)^2]
        msg = msg * batch.edge_mask.to(dt)[:, None, None]
        # channels and irreps flattened: the receiver sum is one [E, C * D]
        # segment sum (K1 with sorted aggregation)
        agg = segment_sum(msg.reshape(e, -1), batch.receivers, h.shape[0],
                          sorted_ids=self.sorted_agg, max_degree=self.max_in_degree)
        agg = agg.reshape(h.shape[0], c, sh_dim(self.max_ell))
        agg = agg / _const(self.avg_num_neighbors, agg)
        return self.linear(agg), sc


class SymmetricProduct(OwnInit, nn.Module):
    """The n-body product basis with per-element weights: B_1 = A,
    B_{k+1}[l3] = sum over paths of CG(B_k[l1], A[l2]) (one product with
    ``summed_cg``), the output sum_k W_k(Z) * B_k up to ``lmax_out``."""

    def __init__(self, c: int, lmax_a: int, lmax_out: int, correlation: int, lmax_keep: int):
        super().__init__()
        self.c = c
        self.lmax_out = lmax_out
        self.orders = []  # (lmax of B_k, summed CG from B_{k-1} x A or None)
        lmax_b = lmax_a
        for k in range(1, correlation + 1):
            if k > 1:
                new_lmax = min(lmax_keep, lmax_b + lmax_a)
                G = summed_cg(lmax_b, lmax_a, new_lmax)
                self.register_buffer(f"cg{k}", torch.from_numpy(G.reshape(-1, G.shape[-1])),
                                     persistent=False)
                lmax_b = new_lmax
            self.orders.append(lmax_b)
            for l in range(min(lmax_out, lmax_b) + 1):
                self.register_parameter(f"w{k}_{l}",
                                        nn.Parameter(torch.empty(NUM_ELEMENTS, c)))

    def reset_parameters(self, gen: torch.Generator) -> None:
        for name, p in self.named_parameters():
            with torch.no_grad():
                p.normal_(0.0, 1.0 / math.sqrt(NUM_ELEMENTS), generator=gen)

    def forward(self, a, node_attrs):
        n, c = a.shape[0], self.c
        out_by_l = [[] for _ in range(self.lmax_out + 1)]
        b = a
        for k, lmax_b in enumerate(self.orders, start=1):
            if k > 1:
                outer = (b[:, :, :, None] * a[:, :, None, :]).reshape(n, c, -1)
                b = torch.matmul(outer, getattr(self, f"cg{k}").to(a.dtype))
            for l in range(min(self.lmax_out, lmax_b) + 1):
                wn = node_attrs @ getattr(self, f"w{k}_{l}").to(a.dtype)  # [N, C]
                out_by_l[l].append(wn[:, :, None] * b[:, :, irrep_slice(l)])
        return _sum_by_l(out_by_l, a, n, c)


class MACEConv(nn.Module):
    """One interaction + product layer: node irreps ``[N, C, *] -> [N, C,
    (lmax_out+1)^2]``."""

    def __init__(self, c: int, lmax_in: int, max_ell: int, node_max_ell: int, num_radial: int,
                 edge_dim: int, avg_num_neighbors: float, correlation: int,
                 last_layer: bool = False, sorted_agg: bool = False, max_in_degree: int = 0):
        super().__init__()
        lmax_out = 0 if last_layer else node_max_ell
        self.interaction = MACEInteraction(c, lmax_in, max_ell, node_max_ell, num_radial,
                                           edge_dim, avg_num_neighbors, sorted_agg,
                                           max_in_degree, last_layer)
        self.product = SymmetricProduct(c, max_ell, lmax_out, correlation, lmax_keep=max_ell)
        self.sizing = EquivariantLinear(c, c, lmax_out, lmax_out)

    def forward(self, h, sh, radial, node_attrs, batch):
        agg, sc = self.interaction(h, sh, radial, batch)
        return self.sizing(self.product(agg, node_attrs)) + sc


class MACEModel(nn.Module):
    """The whole MACE model with the port's multihead decoding: ``forward
    (batch)`` returns head name -> ``[G, d]`` or ``[N, d]``, as
    ``HydraModel`` does, so every train, eval and serving path is shared."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.hidden_dim
        self.max_ell = int(cfg.max_ell or 3)
        node_max_ell = int(cfg.node_max_ell or 1)
        correlation = int(cfg.correlation or 2)
        avg = float(cfg.avg_num_neighbors or 1.0)
        self.num_radial = int(cfg.num_radial or 8)
        edge_dim = cfg.edge_dim if cfg.use_edge_attr else 0
        self.node_embedding = Dense(NUM_ELEMENTS, c)
        lmax_in = 0
        for i in range(cfg.num_conv_layers):
            last = i == cfg.num_conv_layers - 1
            self.add_module(f"conv{i}", MACEConv(
                c, lmax_in, self.max_ell, node_max_ell, self.num_radial, edge_dim, avg,
                correlation, last_layer=last, sorted_agg=cfg.sorted_aggregation,
                max_in_degree=cfg.max_in_degree))
            lmax_in = 0 if last else node_max_ell
        # readout 0 decodes the one-hot attributes linearly, readout i + 1
        # conv i's scalars (the last one through an MLP)
        B = cfg.num_branches
        for idx in range(cfg.num_conv_layers + 1):
            in_dim = NUM_ELEMENTS if idx == 0 else c
            nonlinear = idx == cfg.num_conv_layers
            for ihead, (t, d) in enumerate(zip(cfg.output_type, cfg.output_dim)):
                d = d * (2 if cfg.var_output else 1)
                if nonlinear:
                    if t == "graph":
                        gh = cfg.graph_head or GraphHeadConfig()
                        dims = tuple(gh.dim_headlayers) if cfg.graph_head else (c,)
                    else:
                        dims = tuple((cfg.node_head or NodeHeadConfig()).dim_headlayers)
                    head = MLP(in_dim, dims + (d,), cfg.activation, num_branches=B)
                else:
                    head = BankedDense(B, in_dim, d)
                self.add_module(f"readout{idx}_head{ihead}", head)

    def forward(self, batch) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        dt = batch.pos.dtype
        z = torch.clamp(batch.z.long(), 0, NUM_ELEMENTS)
        node_attrs = torch.nn.functional.one_hot(torch.clamp(z - 1, 0, NUM_ELEMENTS - 1),
                                                 NUM_ELEMENTS).to(dt)
        node_attrs = node_attrs * batch.node_mask.to(dt)[:, None]
        vec, length = edge_vectors(batch.pos, batch.senders, batch.receivers, batch.edge_shifts)
        sh = real_sph_harm(vec, self.max_ell)
        radial = radial_embedding(
            length, float(cfg.radius or 5.0), self.num_radial, cfg.radial_type or "bessel",
            int(cfg.envelope_exponent or 5), cfg.distance_transform, z=z,
            senders=batch.senders, receivers=batch.receivers)
        outputs = self._readout(node_attrs, batch, 0)
        h = self.node_embedding(node_attrs)[:, :, None]
        for i in range(cfg.num_conv_layers):
            h = getattr(self, f"conv{i}")(h, sh, radial, node_attrs, batch)
            layer_out = self._readout(h[:, :, 0], batch, i + 1)
            outputs = {k: outputs[k] + v for k, v in layer_out.items()}
        return outputs

    def _readout(self, scalars, batch, idx: int) -> Dict[str, torch.Tensor]:
        """Every head's decode of the node scalars (graph heads pool
        first), each branch decoded densely and selected per row."""
        cfg = self.cfg
        outputs: Dict[str, torch.Tensor] = {}
        pooled = None
        for ihead, (name, t, d) in enumerate(zip(cfg.output_names, cfg.output_type,
                                                 cfg.output_dim)):
            if t == "graph":
                if pooled is None:
                    pooled = masked_global_mean_pool(scalars, batch.node_graph,
                                                     batch.num_graphs, batch.node_mask,
                                                     batch.graphs_contiguous)
                inp, rows = pooled, batch.dataset_id
            else:
                inp, rows = scalars, batch.dataset_id[batch.node_graph]
            stacked = getattr(self, f"readout{idx}_head{ihead}")(inp)  # [B, R, d]
            if cfg.num_branches == 1:
                out = stacked[0]
            else:
                sel = rows.long()[None, :, None].expand(1, -1, stacked.shape[-1])
                out = torch.gather(stacked, 0, sel)[0]
            outputs[name] = out[..., :d]
            if cfg.var_output:
                # this layer's variance: the second half of its readout,
                # squared; forward sums the layers' variances
                outputs[f"{name}__var"] = out[..., d:] ** 2
        return outputs
