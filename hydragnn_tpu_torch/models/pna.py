"""Principal Neighbourhood Aggregation convolution.

Counterpart of ``hydragnn_tpu/models/pna.py``: a one-layer pre-MLP over
[x_i, x_j(, edge)] in factored form (node-sized receiver projection
``pre_recv`` with the bias, edge-aligned sender projection ``pre_send`` plus
``pre_edge`` when ``edge_dim`` is set), aggregated four ways (mean, min,
max, std), scaled by the identity and three degree scalers (amplification,
attenuation, linear), then ``Dense_0`` over [x, scaled] and ``Dense_1``.

With ``multi_agg`` (``use_fused_edge_kernel``) on a sorted, degree-bounded
batch, the four aggregators derive from one multi-moment pass (K3 on the
card, ops/multi_agg.py): the [E, C] messages are never materialized.
Otherwise the dense route gathers the messages and runs the four masked
segment reductions.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from ..ops.segment import (
    multi_moment_agg,
    segment_count,
    segment_max,
    segment_mean,
    segment_min,
    segment_std,
)
from .base import register_conv
from .layers import Dense, pair_message_factored


def _avg_deg_stats(deg_hist: Tuple[int, ...]) -> Tuple[float, float]:
    """(avg_log_deg, avg_lin_deg) from the dataset degree histogram."""
    if not deg_hist:
        return 1.0, 1.0
    total = float(sum(deg_hist)) or 1.0
    avg_log = sum(n * math.log(d + 1) for d, n in enumerate(deg_hist)) / total
    avg_lin = sum(n * d for d, n in enumerate(deg_hist)) / total
    return max(avg_log, 1e-6), max(avg_lin, 1e-6)


def pna_pre_message(layer, inv, batch, edge_terms=()):
    """PNA's pre-MLP (pre_layers=1) in factored form: ``(node_recv [N, C],
    edge_in [E, C])`` from ``layer.pre_recv`` / ``layer.pre_send``."""
    return pair_message_factored(layer.pre_recv, layer.pre_send, inv, batch, edge_terms)


def pna_aggregate(msg, batch, deg_hist, sorted_agg: bool = False, max_in_degree: int = 0,
                  node_recv=None, gate=None, multi_agg: bool = False):
    """[mean, min, max, std] aggregation x [identity, amplification,
    attenuation, linear] degree scalers of the per-edge message
    ``(node_recv[recv] + msg) * gate`` (``node_recv``/``gate`` optional)."""
    n = batch.num_nodes
    if multi_agg and sorted_agg and max_in_degree > 0:
        s, cnt, mn, mx, ssq = multi_moment_agg(
            msg, batch.receivers, n, node_recv=node_recv, gate=gate,
            sorted_ids=True, max_degree=max_in_degree,
        )
        cnt1 = torch.clamp(cnt, min=1.0)[:, None]
        mean = s / cnt1
        var = torch.clamp(ssq / cnt1 - mean**2, min=0.0)
        std = torch.sqrt(var + 1e-5)
        aggs = [a.to(msg.dtype) for a in (mean, mn, mx, std)]
        deg = cnt[:, None]
    else:
        if node_recv is not None:
            msg = node_recv[batch.receivers] + msg
        if gate is not None:
            msg = msg * gate
        aggs = [
            segment_mean(msg, batch.receivers, n, batch.edge_mask,
                         sorted_ids=sorted_agg, max_degree=max_in_degree),
            segment_min(msg, batch.receivers, n, batch.edge_mask),
            segment_max(msg, batch.receivers, n, batch.edge_mask),
            segment_std(msg, batch.receivers, n, batch.edge_mask),
        ]
        deg = segment_count(batch.receivers, n, batch.edge_mask)[:, None]
    # torch.cat promotes mixed dtypes like jnp.concatenate: a bf16 aggregate
    # beside the f32 mean or scalers gives f32
    agg = torch.cat(aggs, dim=-1)
    avg_log, avg_lin = _avg_deg_stats(deg_hist)
    log_deg = torch.log(deg + 1.0)
    return torch.cat(
        [agg, agg * (log_deg / avg_log),
         agg * (avg_log / torch.clamp(log_deg, min=1e-6)),
         agg * (deg / avg_lin)],
        dim=-1,
    )


class PNAConv(nn.Module):
    """Parameter names follow the flax tree: ``pre_recv``, ``pre_send``
    (``pre_edge`` with ``edge_dim``), ``Dense_0``, ``Dense_1``."""

    def __init__(self, in_dim: int, output_dim: int, deg_hist: Tuple[int, ...],
                 edge_dim: int = 0, sorted_agg: bool = False, max_in_degree: int = 0,
                 multi_agg: bool = False):
        super().__init__()
        self.deg_hist = tuple(deg_hist)
        self.sorted_agg = sorted_agg
        self.max_in_degree = max_in_degree
        self.multi_agg = multi_agg
        self.pre_recv = Dense(in_dim, in_dim)
        self.pre_send = Dense(in_dim, in_dim, bias=False)
        self.pre_edge = Dense(edge_dim, in_dim, bias=False) if edge_dim else None
        self.Dense_0 = Dense(in_dim + 16 * in_dim, output_dim)
        self.Dense_1 = Dense(output_dim, output_dim)

    def forward(self, inv, equiv, batch):
        terms = []
        if self.pre_edge is not None and batch.edge_attr is not None:
            terms.append((self.pre_edge, batch.edge_attr))
        node_recv, edge_in = pna_pre_message(self, inv, batch, terms)
        scaled = pna_aggregate(
            edge_in, batch, self.deg_hist, self.sorted_agg, self.max_in_degree,
            node_recv=node_recv, multi_agg=self.multi_agg,
        )
        out = self.Dense_0(torch.cat([inv, scaled], dim=-1))
        return self.Dense_1(out), equiv


@register_conv("PNA", is_edge_model=True)
def make_pna(cfg, in_dim, out_dim, last_layer):
    return PNAConv(in_dim, out_dim, cfg.pna_deg, edge_dim=cfg.edge_dim,
                   sorted_agg=cfg.sorted_aggregation, max_in_degree=cfg.max_in_degree,
                   multi_agg=cfg.fused_edge_kernel)
