"""PaiNN: polarizable atom interaction network.

Counterpart of ``hydragnn_tpu/models/painn.py``. Each conv is a message
block (a sinc radial filter times the cosine cutoff gates a scalar MLP of
the senders; vector messages mix the senders' vectors and the unit edge
vectors) and an update block (``painn_update``). Scalars ride the ``inv``
slot; the per-node vectors [N, 3, F] ride ``equiv``: the first layer gets
the positions [N, 3] there and starts from zero vectors (f32, as the JAX
package makes them). The scalar sum is K1's (2-D); the [E, 3, F] vector sum
stays on the plain scatter, as the JAX routing keeps it.

Parameter names follow the flax tree: ``x_proj`` (scalar width change),
``Dense_0`` (the filter), ``MLP_0`` (the edge-feature filter, with
``edge_dim``), then the scalar MLP, and the update block's ``Dense``s (U,
V) and ``MLP``. Every conv of a stack has the same width, so the vectors
never change width between layers and the JAX package's ``v_proj`` is
never created.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.radial import cosine_cutoff, edge_vectors, sinc_expansion
from ..ops.segment import segment_sum
from .base import register_conv
from .layers import MLP, Dense


def vector_state(equiv, n: int, features: int, v_proj=None):
    """The ``equiv`` slot as [N, 3, F] vectors: zeros (f32) where it holds
    the positions, else the incoming vectors, mixed to the layer's width by
    ``v_proj`` where they arrive at another (a conv node head's chain)."""
    if equiv is None or equiv.dim() == 2:
        device = None if equiv is None else equiv.device
        return torch.zeros((n, 3, features), dtype=torch.float32, device=device)
    if equiv.shape[-1] != features:
        assert v_proj is not None, (tuple(equiv.shape), features)
        return v_proj(equiv)
    return equiv


class VectorsIn:
    """A conv whose incoming vector features may arrive at another width
    than its own: ``vectors_in(width)`` adds the bias-free channel mixing
    ``v_proj`` (the flax module creates it where the widths differ)."""

    def vectors_in(self, width: int) -> None:
        if width != self.node_size:
            self.v_proj = Dense(width, self.node_size, bias=False)


def update_clamp(t):
    """The update block's residual clamp to +-1e6 (the JAX package's
    guard against an overflowing product stream)."""
    return torch.clamp(t, -1e6, 1e6)


def add_painn_update(layer: nn.Module, node_size: int, last_layer: bool, dense_index: int,
                     mlp_index: int) -> None:
    """The update block's parameters on ``layer``, named as flax counts
    them there: ``Dense_<dense_index>`` (U), the next ``Dense`` (V), and
    ``MLP_<mlp_index>``. Shared by PAINN and PNAEq."""
    layer.update_names = (f"Dense_{dense_index}", f"Dense_{dense_index + 1}",
                          f"MLP_{mlp_index}")
    u, v, mlp = layer.update_names
    layer.add_module(u, Dense(node_size, node_size, bias=False))
    layer.add_module(v, Dense(node_size, node_size, bias=False))
    layer.add_module(mlp, MLP(2 * node_size, (node_size, (2 if last_layer else 3) * node_size),
                              "silu"))


def painn_update(layer: nn.Module, x, v, last_layer: bool):
    """The update block: U/V channel mixings, gated scalar and vector
    residuals clamped to +-1e6; the last layer updates the scalars only."""
    u_dense, v_dense, mlp = (getattr(layer, n) for n in layer.update_names)
    uv, vv = u_dense(v), v_dense(v)
    vv_norm = torch.sqrt(torch.sum(vv * vv, dim=1) + 1e-12)
    out = mlp(torch.cat([vv_norm, x], dim=-1))
    inner = torch.sum(uv * vv, dim=1)
    if last_layer:
        a_sv, a_ss = torch.chunk(out, 2, dim=-1)
        return x + update_clamp(a_sv * inner + a_ss), v
    a_vv, a_sv, a_ss = torch.chunk(out, 3, dim=-1)
    return (x + update_clamp(a_sv * inner + a_ss),
            v + update_clamp(a_vv[:, None, :] * uv))


class PainnConv(VectorsIn, nn.Module):
    def __init__(self, in_dim: int, node_size: int, num_radial: int, radius: float,
                 edge_dim: int = 0, last_layer: bool = False, sorted_agg: bool = False,
                 max_in_degree: int = 0):
        super().__init__()
        self.node_size = node_size
        self.num_radial = num_radial
        self.radius = radius
        self.has_edge = bool(edge_dim)
        self.last_layer = last_layer
        self.sorted_agg = sorted_agg
        self.max_in_degree = max_in_degree
        self.x_proj = Dense(in_dim, node_size) if in_dim != node_size else None
        self.Dense_0 = Dense(num_radial, 3 * node_size)
        m = 0
        if edge_dim:
            self.MLP_0 = MLP(edge_dim, (node_size, 3 * node_size), "silu")
            m = 1
        self.scalar_mlp = f"MLP_{m}"
        self.add_module(self.scalar_mlp, MLP(node_size, (node_size, 3 * node_size), "silu"))
        add_painn_update(self, node_size, last_layer, dense_index=1, mlp_index=m + 1)

    def forward(self, inv, equiv, batch):
        n = batch.num_nodes
        x = inv if self.x_proj is None else self.x_proj(inv)
        v = vector_state(equiv, n, self.node_size, self._modules.get("v_proj"))
        vec, length = edge_vectors(batch.pos, batch.senders, batch.receivers, batch.edge_shifts)
        r = length[:, 0]
        unit = vec / length

        filt = self.Dense_0(sinc_expansion(r, self.radius, self.num_radial))
        filt = filt * cosine_cutoff(r, self.radius)[:, None]
        if self.has_edge and batch.edge_attr is not None:
            filt = filt * self.MLP_0(batch.edge_attr)
        scal = getattr(self, self.scalar_mlp)(x)
        gate_v, gate_edge, msg_s = torch.chunk(filt * scal[batch.senders], 3, dim=-1)
        msg_v = v[batch.senders] * gate_v[:, None, :] + gate_edge[:, None, :] * unit[:, :, None]

        x = x + segment_sum(msg_s, batch.receivers, n, batch.edge_mask,
                            sorted_ids=self.sorted_agg, max_degree=self.max_in_degree)
        v = v + segment_sum(msg_v, batch.receivers, n, batch.edge_mask)
        return painn_update(self, x, v, self.last_layer)


@register_conv("PAINN", is_edge_model=True)
def make_painn(cfg, in_dim, out_dim, last_layer):
    return PainnConv(
        in_dim, out_dim,
        num_radial=cfg.num_radial or 20,
        radius=cfg.radius or 5.0,
        edge_dim=cfg.edge_dim,
        last_layer=last_layer,
        sorted_agg=cfg.sorted_aggregation,
        max_in_degree=cfg.max_in_degree,
    )
