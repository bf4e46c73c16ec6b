"""Serving policy knobs, resolved from a run config's ``Serving`` section.

Counterpart of ``hydragnn_tpu/serve/config.py`` for the single-server slice:
admission (queue bound, deadlines), micro-batching, load shedding and drain.
Keys of the JAX package's serving surface that this slice does not consume
(hot reload, int8, fleet, router, cache, HTTP) warn and are ignored, like any
unknown key.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """All times in seconds.

    - ``max_queue_requests`` bounds the admission queue (<= 0: unbounded);
      ``default_deadline_s`` is the per-request deadline when the client sets
      none (0 disables deadlines);
    - ``micro_batch_graphs`` caps graphs per device batch; ``batch_window_s``
      is how long the batcher waits to fill a batch after its first request;
    - ``slo_p99_s`` > 0 sheds admissions whose projected queue wait exceeds
      it; ``expected_latency_per_graph_s`` seeds that projection before the
      first measured batch;
    - ``drain_timeout_s`` bounds how long ``close()`` waits for in-flight work.
    """

    max_queue_requests: int = 256
    micro_batch_graphs: int = 32
    batch_window_s: float = 0.005
    default_deadline_s: float = 30.0
    slo_p99_s: float = 0.0
    expected_latency_per_graph_s: float = 0.0
    drain_timeout_s: float = 30.0

    def __post_init__(self):
        if self.micro_batch_graphs < 1:
            raise ValueError(
                f"Serving.micro_batch_graphs must be >= 1, got {self.micro_batch_graphs}"
            )
        for key in ("batch_window_s", "default_deadline_s", "slo_p99_s",
                    "expected_latency_per_graph_s", "drain_timeout_s"):
            if float(getattr(self, key)) < 0:
                raise ValueError(
                    f"Serving.{key} must be >= 0 (seconds; 0 disables), got "
                    f"{getattr(self, key)!r}"
                )

    @staticmethod
    def from_config(config: Dict[str, Any]) -> "ServeConfig":
        """From a full run config; ``micro_batch_graphs`` falls back to
        ``Training.batch_size`` so the served shapes are the trained pad
        buckets."""
        section = dict(config.get("Serving", {}) or {})
        known = {f.name for f in dataclasses.fields(ServeConfig)}
        unknown = sorted(set(section) - known)
        if unknown:
            warnings.warn(
                f"Serving config keys {unknown} are not consumed by this port "
                f"(known keys: {sorted(known)})",
                stacklevel=2,
            )
            for k in unknown:
                section.pop(k)
        if "micro_batch_graphs" not in section:
            bs = config.get("NeuralNetwork", {}).get("Training", {}).get("batch_size")
            if bs:
                section["micro_batch_graphs"] = int(bs)
        return ServeConfig(**section)
