"""Per-sample validation gate (numpy only).

Counterpart of ``validate_graph`` and the rejection reasons of
``hydragnn_tpu/data/validate.py``; the serving admission check uses it. The
dataset-level ``SampleValidator`` policies come with a later slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .graph import Graph

R_NONFINITE = "nonfinite_features"  # any non-finite numeric channel
R_BAD_EDGE = "bad_edge_index"  # sender/receiver outside [0, num_nodes)
R_SELF_LOOP = "self_loop_only"  # every edge is a self loop
R_EMPTY = "empty_graph"  # zero nodes
R_BUDGET = "budget_overflow"  # exceeds the pad/pack budget
R_CHANNELS = "channel_mismatch"  # feature channel layout != the served model's

REASON_MESSAGES = {
    R_NONFINITE: "a numeric channel contains NaN/Inf values",
    R_BAD_EDGE: "edge sender/receiver indices fall outside [0, num_nodes)",
    R_SELF_LOOP: "every edge is a self loop (degenerate connectivity)",
    R_EMPTY: "the graph has zero nodes",
    R_BUDGET: "the graph exceeds the pad/pack budget (nodes or edges)",
    R_CHANNELS: (
        "the feature channels present (or their widths) do not match the "
        "layout the model was trained and warmed with"
    ),
}


def describe_reason(reason: str) -> str:
    return REASON_MESSAGES.get(reason, reason)


def validate_graph(g: Graph, max_nodes: Optional[int] = None,
                   max_edges: Optional[int] = None) -> Optional[str]:
    """The rejection reason for ``g``, or None when it is clean (most
    diagnostic defect first)."""
    n = g.num_nodes
    if n == 0:
        return R_EMPTY
    e = g.num_edges
    if e:
        s = np.asarray(g.senders, np.int64)
        r = np.asarray(g.receivers, np.int64)
        if int(s.min()) < 0 or int(r.min()) < 0 or int(s.max()) >= n or int(r.max()) >= n:
            return R_BAD_EDGE
        if bool(np.all(s == r)):
            return R_SELF_LOOP
    for _name, arr in g.float_channels():
        if np.issubdtype(arr.dtype, np.floating) and not bool(np.isfinite(arr).all()):
            return R_NONFINITE
    if max_nodes is not None and n > int(max_nodes):
        return R_BUDGET
    if max_edges is not None and e > int(max_edges):
        return R_BUDGET
    return None
