"""Per-sample validation gate (numpy only).

Counterpart of ``validate_graph``, the rejection reasons and the
``SampleValidator`` of ``hydragnn_tpu/data/validate.py``; the serving
admission check uses ``validate_graph``, ``api.prepare_data`` the
validator (``Dataset.bad_sample_policy``: ``error`` raises
``BadSampleError``, ``warn_skip`` drops and counts the sample, the first
few with a line on stderr). The ``quarantine`` policy (a manifest of the
rejects in the run directory) comes with the robustness slice of the port
and raises ``NotImplementedError``.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

from .graph import Graph

R_NONFINITE = "nonfinite_features"  # any non-finite numeric channel
R_BAD_EDGE = "bad_edge_index"  # sender/receiver outside [0, num_nodes)
R_SELF_LOOP = "self_loop_only"  # every edge is a self loop
R_EMPTY = "empty_graph"  # zero nodes
R_BUDGET = "budget_overflow"  # exceeds the pad/pack budget
R_CHANNELS = "channel_mismatch"  # feature channel layout != the served model's
R_BRANCH = "unknown_branch"  # dataset_id names no branch of the served model

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
    R_BRANCH: "the dataset_id names no decoder branch of the served model",
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


POLICIES = ("error", "warn_skip", "quarantine")


class BadSampleError(ValueError):
    """A sample failed validation under ``bad_sample_policy: error``."""


class CorruptSampleError(ValueError):
    """Stored sample bytes failed to deserialize (bit rot, a torn write,
    wire corruption). Raised by the blob-store datasets (data/ddstore.py)
    with the store's name and the sample's id, so the bad blob is findable."""


class SampleValidator:
    """The run's policy for bad samples and its tally of them. One
    instance spans the run's data plane (the per-split gate and every
    loader); rejections are counted once per (source, index, reason)."""

    # rejects reported one by one before the tally alone
    _VERBOSE_LIMIT = 3

    def __init__(self, policy: str = "warn_skip"):
        if policy not in POLICIES:
            raise ValueError(f"bad_sample_policy {policy!r} must be one of {POLICIES}")
        if policy == "quarantine":
            raise NotImplementedError(
                "Dataset.bad_sample_policy 'quarantine' (the reject manifest) comes with "
                "the robustness slice of the port (a later slice); use 'warn_skip' or "
                "'error'")
        self.policy = policy
        self.checked = 0
        self.counts: Dict[str, int] = {}
        self._seen = set()
        self._reported = 0

    def reject(self, g: Optional[Graph], index: int, reason: str,
               source: str = "dataset", detail: str = "") -> None:
        """Record (or raise, under ``error``) one rejected sample."""
        ds_id = int(getattr(g, "dataset_id", 0) or 0) if g is not None else -1
        if self.policy == "error":
            raise BadSampleError(
                f"sample {index} (dataset_id {ds_id}, source {source!r}) rejected: {reason}"
                + (f" — {detail}" if detail else "")
                + ". Set Dataset.bad_sample_policy to 'warn_skip' to drop bad samples "
                "instead of failing.")
        key = (source, int(index), reason)
        if key in self._seen:
            return
        self._seen.add(key)
        self.counts[reason] = self.counts.get(reason, 0) + 1
        # a typed incident record (obs/events.py) with its reason
        try:
            from ..obs.events import EV_DATA_SKIP
            from ..obs.events import emit as _emit_event

            _emit_event(EV_DATA_SKIP, severity="warn", reason=reason, source=source,
                        index=int(index), quarantined=self.policy == "quarantine")
        except Exception:
            pass
        if self._reported < self._VERBOSE_LIMIT:
            self._reported += 1
            print(f"[hydragnn_tpu_torch.data] skipping bad sample {index} (dataset_id "
                  f"{ds_id}, source {source!r}): {reason}"
                  + (f" — {detail}" if detail else ""), file=sys.stderr)

    def check(self, g: Graph, index: int, source: str = "dataset",
              max_nodes: Optional[int] = None, max_edges: Optional[int] = None
              ) -> Optional[str]:
        """The rejection reason of one sample (recorded per the policy), or
        None to keep it."""
        self.checked += 1
        reason = validate_graph(g, max_nodes=max_nodes, max_edges=max_edges)
        if reason is not None:
            self.reject(g, index, reason, source=source)
        return reason

    def filter(self, graphs: Sequence[Graph], source: str = "dataset",
               max_nodes: Optional[int] = None, max_edges: Optional[int] = None
               ) -> List[Graph]:
        """``graphs`` without the rejected samples, in order (indices in the
        tally are positions in ``graphs``)."""
        return [g for i, g in enumerate(graphs)
                if self.check(g, i, source=source, max_nodes=max_nodes,
                              max_edges=max_edges) is None]

    @property
    def skipped_total(self) -> int:
        return sum(self.counts.values())

    def stats(self) -> Dict:
        return {"checked": self.checked, "skipped": dict(self.counts),
                "skipped_total": self.skipped_total, "policy": self.policy}

    def tally(self) -> str:
        """One line for the epoch log."""
        if not self.counts:
            return "no skipped samples"
        parts = ", ".join(f"{k}={v}" for k, v in sorted(self.counts.items()))
        return f"{self.skipped_total} skipped [{parts}]"
