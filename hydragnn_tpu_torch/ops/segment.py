"""Masked segment reductions and the routing to the hand-written kernels.

Counterpart of ``hydragnn_tpu/ops/segment.py``. Routing follows the JAX
package: receiver-sorted ids (``sorted_ids=True``) with a static in-degree
bound go through the sorted-segment kernel (K1, ops/sorted_segment.py),
``fused_edge_message_sum`` through the fused edge kernel (K2,
ops/fused_edge.py) and ``multi_moment_agg`` through the multi-moment kernel
(K3, ops/multi_agg.py). Those wrappers take the kernel for a CUDA tensor
and their plain version for a CPU tensor. Unsorted reductions (pooling,
counts, min/max/std) are plain PyTorch, as they are plain XLA in the JAX
package.
"""

from __future__ import annotations

from typing import Optional

import torch

from .fused_edge import fused_edge_message_sum as _fused_edge_message_sum
from .remat import at_site
from .multi_agg import fused_multi_agg, reference_multi_agg
from .sorted_segment import segment_sum_plain, sorted_segment_sum, sorted_segment_sum_plain


def _mask_messages(messages, mask, fill: float = 0.0):
    if mask is None:
        return messages
    m = mask.reshape(mask.shape + (1,) * (messages.dim() - mask.dim()))
    return torch.where(m, messages, torch.full((), fill, dtype=messages.dtype,
                                               device=messages.device))


def segment_sum(messages, segment_ids, num_segments: int, mask=None,
                sorted_ids: bool = False, max_degree: Optional[int] = None):
    """Scatter-add of edge messages, padding masked to zero first. Sorted
    ids with an in-degree bound and 2-D messages take K1."""
    msg = _mask_messages(messages, mask)
    if sorted_ids and max_degree and msg.dim() == 2:
        return sorted_segment_sum(msg.contiguous(), segment_ids, num_segments)
    if msg.dim() == 1:
        return segment_sum_plain(msg[:, None], segment_ids, num_segments)[:, 0]
    return segment_sum_plain(msg, segment_ids, num_segments)


def fused_edge_message_sum(node_recv, edge_in, weights, bias, segment_ids,
                           num_segments: int, max_degree: int):
    """``segment_sum(relu(relu(node_recv[ids] + edge_in) @ W + b))`` over
    receiver-sorted ids: K2 when an in-degree bound is set, else the dense
    plain statement (the JAX package's routing)."""
    if max_degree:
        return _fused_edge_message_sum(
            node_recv, edge_in, weights, bias, segment_ids, num_segments
        )
    from .fused_edge import reference_edge_message_sum

    return reference_edge_message_sum(
        node_recv, edge_in, weights, bias, segment_ids, num_segments
    )


def multi_moment_agg(edge_in, segment_ids, num_segments: int, node_recv=None,
                     gate=None, mask=None, sorted_ids: bool = False,
                     max_degree: int = 0):
    """The five f32 moments ``(sum, count, min, max, sumsq)`` of
    ``(node_recv[ids] + edge_in) * gate`` (``node_recv``/``gate`` optional)
    that the PNA aggregators derive from. Sorted ids with an in-degree
    bound and 2-D messages take K3, which ignores ``mask``: the sorted
    layout sends every padding edge to the final dummy node, masked
    downstream. Otherwise the dense plain version runs and honours
    ``mask``."""
    if sorted_ids and max_degree and edge_in.dim() == 2:
        # the kernel takes one operand dtype, edge_in's: node_recv and gate
        # are cast to it, as the JAX kernel casts them
        def call(nr, ei, g):  # the remat site (ops/remat.py): casts and K3
            def operand(t):
                return None if t is None else t.to(ei.dtype).contiguous()

            return fused_multi_agg(operand(nr), ei.contiguous(), operand(g), segment_ids,
                                   num_segments)

        return at_site(call, node_recv, edge_in, gate)
    return reference_multi_agg(node_recv, edge_in, gate, segment_ids, num_segments,
                               mask=mask)


def segment_count(segment_ids, num_segments: int, mask=None):
    ones = torch.ones(segment_ids.shape[:1], dtype=torch.float32,
                      device=segment_ids.device)
    if mask is not None:
        ones = torch.where(mask, ones, torch.zeros((), device=ones.device))
    out = torch.zeros(num_segments, dtype=torch.float32, device=ones.device)
    return out.index_add_(0, segment_ids.long(), ones)


def segment_mean(messages, segment_ids, num_segments: int, mask=None,
                 eps: float = 0.0, sorted_ids: bool = False,
                 max_degree: Optional[int] = None):
    s = segment_sum(messages, segment_ids, num_segments, mask,
                    sorted_ids=sorted_ids, max_degree=max_degree)
    n = segment_count(segment_ids, num_segments, mask)
    n = torch.clamp(n, min=1.0) if eps == 0.0 else n + eps
    # f32 counts promote a bf16 sum to f32, as jnp does
    return s / n.reshape(n.shape + (1,) * (s.dim() - 1))


def _segment_extreme(messages, segment_ids, num_segments: int, mask, reduce: str):
    info = torch.finfo(messages.dtype)
    fill = info.min if reduce == "amax" else info.max
    msg = _mask_messages(messages, mask, fill)
    ids = segment_ids.long()
    idx = ids.reshape(ids.shape + (1,) * (msg.dim() - 1)).expand_as(msg)
    out = torch.full((num_segments,) + tuple(msg.shape[1:]), fill, dtype=msg.dtype,
                     device=msg.device).scatter_reduce_(0, idx, msg, reduce)
    # segments with no (real) incoming messages -> 0, like torch_scatter
    empty = out <= fill / 2 if reduce == "amax" else out >= fill / 2
    return torch.where(empty, torch.zeros((), dtype=out.dtype, device=out.device), out)


def segment_max(messages, segment_ids, num_segments: int, mask=None):
    return _segment_extreme(messages, segment_ids, num_segments, mask, "amax")


def segment_min(messages, segment_ids, num_segments: int, mask=None):
    return _segment_extreme(messages, segment_ids, num_segments, mask, "amin")


def segment_std(messages, segment_ids, num_segments: int, mask=None, eps: float = 1e-5):
    """Population std per segment (PNA's 'std' aggregator). The moments
    accumulate in f32 whatever the message dtype, and the E[x^2] - E[x]^2
    variance is clamped at zero before the sqrt: a bf16 near-constant
    segment would otherwise give a small negative variance and a NaN."""
    m = messages.float()
    mean = segment_mean(m, segment_ids, num_segments, mask)
    mean_sq = segment_mean(m * m, segment_ids, num_segments, mask)
    var = torch.clamp(mean_sq - mean**2, min=0.0)
    return torch.sqrt(var + eps).to(messages.dtype)


def segment_softmax(logits, segment_ids, num_segments: int, mask=None):
    """Numerically stable softmax of ``logits`` [E, ...] within each segment
    (GAT's attention): masked entries are filled with the dtype's finfo min
    before the segment max and get weight 0; an empty segment's max is 0;
    the denominator is clamped at 1e-16."""
    neg = torch.finfo(logits.dtype).min
    masked = _mask_messages(logits, mask, neg)
    ids = segment_ids.long()
    idx = ids.reshape(ids.shape + (1,) * (masked.dim() - 1)).expand_as(masked)
    seg_max = torch.full((num_segments,) + tuple(masked.shape[1:]), float("-inf"),
                         dtype=masked.dtype, device=masked.device)
    seg_max = seg_max.scatter_reduce(0, idx, masked, "amax")
    zero = torch.zeros((), dtype=masked.dtype, device=masked.device)
    seg_max = torch.where(seg_max <= neg / 2, zero, seg_max)
    exp = torch.exp(masked - seg_max[ids])
    if mask is not None:
        exp = _mask_messages(exp, mask, 0.0)
    denom = segment_sum_plain(exp, ids, num_segments)
    return exp / torch.clamp(denom[ids], min=1e-16)


def masked_global_mean_pool(x, node_graph, num_graphs: int, node_mask,
                            contiguous: bool = False):
    """Per-graph mean over real nodes, differentiable to any order. Where
    the caller knows ``node_graph`` ascends (``contiguous``: graphs
    contiguous along the node axis, as ``batch_graphs`` lays them out and
    records in ``GraphBatch.graphs_contiguous``), each graph's nodes are
    summed in node order: the same bits on every run, where ``index_add_``
    on the card adds in the order its atomics land. Any other order takes
    ``index_add_``."""
    msg = _mask_messages(x, node_mask)
    if contiguous:
        s = sorted_segment_sum_plain(msg, node_graph, num_graphs)
    else:
        s = segment_sum_plain(msg, node_graph, num_graphs)
    n = torch.clamp(segment_count(node_graph, num_graphs, node_mask), min=1.0)
    # f32 counts promote a bf16 sum to f32, as jnp does
    return s / n.reshape(n.shape + (1,) * (s.dim() - 1))
