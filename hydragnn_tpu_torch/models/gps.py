"""GPS (GraphGPS) global attention layer.

Counterpart of ``hydragnn_tpu/models/gps.py``: ``GPSConv`` wraps a local
MPNN (residual + masked batch norm) beside global multi-head attention
(residual + masked batch norm), sums the two, and adds a two-layer MLP
block with a third norm. Attention is block-diagonal over graphs, three
routes as in the JAX package:

- flash (``use_flash_attention`` with a static node bound and no
  attention-prob dropout): the segment-masked kernel over the flat node
  array (K4 on the card, ops/flash_attention.py);
- gathered dense (a static node bound, no kernel): nodes gathered per graph
  into ``[G, Nmax]`` and dense attention within each graph;
- flat masked (no bound): one ``[H, N, N]``-masked attention.

Both bounded routes poison the output with NaN when a real graph exceeds
``max_nodes_per_graph``.

``global_attn_type: "ring"`` (``RingSelfAttention``) attends over every real
node of a batch that holds ONE spanning graph: inside
``parallel.sp.sp_context`` through ring attention (the block-summary kernel
K4b on the card with ``use_flash_attention``), outside it through the same
math computed densely. A batch with more than one real graph comes out NaN.

``global_attn_type: "performer"`` (``PerformerSelfAttention``) is linear
attention with the relu feature map: per-graph K^T V and K moments by a
plain segment sum over ``node_graph``, O(N d^2), no softmax matrix; no
kernel.

Parameter names follow the flax tree: ``conv``, ``MaskedBatchNorm_{0,1,2}``,
``MultiheadSelfAttention_0`` or ``RingSelfAttention_0`` (``Dense_0`` the
fused QKV projection, ``Dense_1`` the output projection) and the MLP
block's ``Dense_0`` / ``Dense_1``; ``PerformerSelfAttention_0`` holds
``Dense_0``-``Dense_3`` (query, key, value, output).
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_self_attention
from ..ops.remat import at_site
from ..ops.segment import segment_sum
from ..parallel.ring_attention import ring_self_attention
from ..parallel.sp import current_sp
from .layers import Dense, MaskedBatchNorm


def _poison(out, cond):
    """NaN everywhere where the 0-dim bool ``cond`` holds."""
    return torch.where(cond, torch.full((), math.nan, dtype=out.dtype, device=out.device), out)


def _poison_overflow(out, batch, nmax: int):
    """NaN everywhere when a real graph has more than ``nmax`` nodes: the
    bounded routes would silently under-cover it."""
    return _poison(out, ((batch.nodes_per_graph > nmax) & batch.graph_mask).any())


class MultiheadSelfAttention(nn.Module):
    """In-projection QKV and out-projection, attention restricted to
    same-graph pairs of real nodes."""

    def __init__(self, channels: int, heads: int, dropout: float = 0.0,
                 max_nodes_per_graph: int = 0, use_flash_attention: bool = False):
        super().__init__()
        if channels % heads:
            raise ValueError(f"channels {channels} not divisible by heads {heads}")
        self.channels = channels
        self.heads = heads
        self.dropout = dropout
        self.max_nodes_per_graph = max_nodes_per_graph
        self.use_flash_attention = use_flash_attention
        self.Dense_0 = Dense(channels, 3 * channels)
        self.Dense_1 = Dense(channels, channels)

    def forward(self, x, batch):
        H, C = self.heads, self.channels
        d = C // H
        n = x.shape[0]
        q, k, v = self.Dense_0(x).split(C, dim=-1)
        # sqrt(d) rounded to f32, then to the input dtype (jnp.sqrt(d).astype)
        # (filled on the card: a host tensor would be a copy a CUDA graph cannot capture)
        scale = x.new_full((), math.sqrt(d), dtype=torch.float32).to(x.dtype)
        prob_dropout = self.dropout > 0 and self.training
        nmax = self.max_nodes_per_graph
        if self.use_flash_attention and nmax > 0 and not prob_dropout:
            def attend(q_, k_, v_):  # the remat site (ops/remat.py): K4
                return flash_self_attention(q_, k_, v_, batch.node_graph, batch.node_mask,
                                            batch.num_graphs, nmax)

            out = at_site(attend, q.view(n, H, d), k.view(n, H, d),
                          v.view(n, H, d)).reshape(n, C)
            out = _poison_overflow(out, batch, nmax)
        elif nmax > 0:
            G = batch.num_graphs
            counts = batch.nodes_per_graph
            starts = torch.cumsum(counts, 0) - counts
            slot = torch.arange(nmax, device=x.device)
            valid = (slot[None, :] < counts[:, None]) & batch.graph_mask[:, None]
            # flat node id of slot r in graph g; invalid slots hit the last
            # node, which the pad spec guarantees is a padding node
            idx = torch.where(valid, starts[:, None] + slot[None, :], n - 1)
            qg = q[idx].reshape(G, nmax, H, d)
            kg = k[idx].reshape(G, nmax, H, d)
            vg = v[idx].reshape(G, nmax, H, d)
            logits = torch.einsum("gihd,gjhd->ghij", qg, kg) / scale
            logits = torch.where(valid[:, None, None, :], logits, torch.finfo(x.dtype).min)
            probs = torch.softmax(logits, dim=-1)
            if prob_dropout:
                probs = F.dropout(probs, self.dropout)
            og = torch.einsum("ghij,gjhd->gihd", probs, vg).reshape(G * nmax, C)
            out = torch.zeros((n, C), dtype=x.dtype, device=x.device).index_add_(
                0, idx.reshape(-1), og * valid.reshape(-1, 1))
            out = _poison_overflow(out, batch, nmax)
        else:
            qf, kf, vf = q.reshape(n, H, d), k.reshape(n, H, d), v.reshape(n, H, d)
            same = (batch.node_graph[:, None] == batch.node_graph[None, :]) & (
                batch.node_mask[:, None] & batch.node_mask[None, :])
            logits = torch.einsum("ihd,jhd->hij", qf, kf) / scale
            logits = torch.where(same[None], logits, torch.finfo(x.dtype).min)
            probs = torch.softmax(logits, dim=-1)
            # rows with no valid key (padding nodes) are uniform garbage,
            # masked downstream
            if prob_dropout:
                probs = F.dropout(probs, self.dropout)
            out = torch.einsum("hij,jhd->ihd", probs, vf).reshape(n, C)
        return self.Dense_1(out)


class RingSelfAttention(nn.Module):
    """Global attention for ONE graph spanning the batch: exact softmax
    attention over every real node (no per-graph mask). Inside an SP
    context through ``ring_self_attention`` over the context's group (with
    K4b when ``use_flash_attention``); outside one, the dense fallback with
    ``finfo.min`` masking, the same numbers up to summation order."""

    def __init__(self, channels: int, heads: int, use_flash_attention: bool = False):
        super().__init__()
        if channels % heads:
            raise ValueError(f"channels {channels} not divisible by heads {heads}")
        self.channels = channels
        self.heads = heads
        self.use_flash_attention = use_flash_attention
        self.Dense_0 = Dense(channels, 3 * channels)
        self.Dense_1 = Dense(channels, channels)

    def forward(self, x, batch):
        H, C = self.heads, self.channels
        d = C // H
        n = x.shape[0]
        q, k, v = (t.view(n, H, d) for t in self.Dense_0(x).split(C, dim=-1))
        active, group = current_sp()
        if active:
            out = ring_self_attention(q, k, v, batch.node_mask, group=group,
                                      use_flash=self.use_flash_attention)
        else:
            scale = 1.0 / torch.sqrt(q.new_full((), float(d)))
            logits = torch.einsum("ihd,jhd->hij", q, k) * scale
            logits = torch.where(batch.node_mask[None, None, :], logits,
                                 torch.finfo(q.dtype).min)
            out = torch.einsum("hij,jhd->ihd", torch.softmax(logits, dim=-1), v)
        # attention spans every real node: a batch of several real graphs
        # would mix them silently, so it comes out NaN
        out = _poison(out, batch.graph_mask.sum() > 1)
        return self.Dense_1(out.reshape(n, C))


class PerformerSelfAttention(nn.Module):
    """Linear attention per graph with the relu feature map (+1e-6):
    ``out_i = q_i (sum_j k_j v_j^T) / (q_i . sum_j k_j)`` over the real
    nodes j of i's graph."""

    def __init__(self, channels: int, heads: int):
        super().__init__()
        if channels % heads:
            raise ValueError(f"channels {channels} not divisible by heads {heads}")
        self.channels = channels
        self.heads = heads
        for i in range(4):
            self.add_module(f"Dense_{i}", Dense(channels, channels))

    def forward(self, x, batch):
        H, C = self.heads, self.channels
        d = C // H
        eps = x.new_full((), 1e-6)
        q = torch.relu(self.Dense_0(x)).reshape(-1, H, d) + eps
        k = torch.relu(self.Dense_1(x)).reshape(-1, H, d) + eps
        v = self.Dense_2(x).reshape(-1, H, d)
        kv = torch.einsum("nhd,nhe->nhde", k, v)  # [N, H, d, d]
        G = batch.num_graphs
        kv_sum = segment_sum(kv, batch.node_graph, G, batch.node_mask)
        k_sum = segment_sum(k, batch.node_graph, G, batch.node_mask)
        num = torch.einsum("nhd,nhde->nhe", q, kv_sum[batch.node_graph])
        den = torch.einsum("nhd,nhd->nh", q, k_sum[batch.node_graph])
        out = num / torch.clamp(den[..., None], min=1e-6)
        return self.Dense_3(out.reshape(-1, C))


class GPSConv(nn.Module):
    """Local MPNN + global attention + MLP block (the GraphGPS layer)."""

    def __init__(self, channels: int, conv: nn.Module, heads: int = 1,
                 dropout: float = 0.0, attn_type: str = "multihead",
                 max_nodes_per_graph: int = 0, use_flash_attention: bool = False):
        super().__init__()
        self.dropout = dropout
        self.conv = conv
        self.MaskedBatchNorm_0 = MaskedBatchNorm(channels)
        self.attn_name = {"ring": "RingSelfAttention_0",
                          "performer": "PerformerSelfAttention_0"}.get(
                              attn_type, "MultiheadSelfAttention_0")
        if attn_type == "performer":
            self.PerformerSelfAttention_0 = PerformerSelfAttention(channels, heads)
        elif attn_type == "ring":
            self.RingSelfAttention_0 = RingSelfAttention(
                channels, heads, use_flash_attention=use_flash_attention)
        elif attn_type == "multihead":
            # attention-prob dropout is 0 on the flash route on every device:
            # its probabilities never exist to be dropped
            self.MultiheadSelfAttention_0 = MultiheadSelfAttention(
                channels, heads, 0.0 if use_flash_attention else dropout,
                max_nodes_per_graph, use_flash_attention=use_flash_attention,
            )
        else:
            raise ValueError(f"attn_type {attn_type!r} not supported")
        self.MaskedBatchNorm_1 = MaskedBatchNorm(channels)
        self.Dense_0 = Dense(channels, 2 * channels)
        self.Dense_1 = Dense(2 * channels, channels)
        self.MaskedBatchNorm_2 = MaskedBatchNorm(channels)

    def forward(self, inv, equiv, batch):
        drop = lambda t: F.dropout(t, self.dropout, self.training)  # noqa: E731
        h, equiv = self.conv(inv, equiv, batch)
        local = self.MaskedBatchNorm_0(drop(h) + inv, batch.node_mask, self.training)
        h = drop(getattr(self, self.attn_name)(inv, batch)) + inv
        out = local + self.MaskedBatchNorm_1(h, batch.node_mask, self.training)
        out = out + drop(self.Dense_1(drop(torch.relu(self.Dense_0(out)))))
        return self.MaskedBatchNorm_2(out, batch.node_mask, self.training), equiv
