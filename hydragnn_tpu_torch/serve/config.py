"""Serving policy knobs, resolved from a run config's ``Serving`` section.

Counterpart of ``hydragnn_tpu/serve/config.py`` for the single-server slice:
admission (queue bound, deadlines), micro-batching, load shedding, drain,
the device-step watchdog, the ``/metrics`` endpoint and the retrace
sentinel's policy. Keys of the JAX
package's serving surface that this slice does not consume (hot reload,
int8, fleet, router, cache) warn and are ignored, like any unknown key.
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
    - ``drain_timeout_s`` bounds how long ``close()`` waits for in-flight work;
    - ``step_timeout_s`` bounds one device step (0 disables the watchdog): a
      step past it fails its batch's requests with ``WedgedStepError`` and
      the server takes a fresh step runner;
    - ``http_port`` mounts the Prometheus ``/metrics`` + ``/healthz`` /
      ``/readyz`` endpoint (obs/prometheus.py): 0 (the default) binds an
      ephemeral port (``GraphServer.http_port`` reads it back), a positive
      value pins it, a negative one disables it; ``http_host`` is the bind
      interface (loopback by default);
    - ``retrace_policy`` is the retrace sentinel's answer, once every ladder
      level is captured, to a batch of a shape and dtype no level has
      (train/compile_plane.py): ``error`` (the default) fails the batch
      with ``RetraceError``, ``warn`` serves it eagerly with a warning.
    """

    max_queue_requests: int = 256
    micro_batch_graphs: int = 32
    batch_window_s: float = 0.005
    default_deadline_s: float = 30.0
    slo_p99_s: float = 0.0
    expected_latency_per_graph_s: float = 0.0
    drain_timeout_s: float = 30.0
    step_timeout_s: float = 60.0
    http_port: int = 0
    http_host: str = "127.0.0.1"
    retrace_policy: str = "error"

    def __post_init__(self):
        from ..train.compile_plane import RETRACE_POLICIES

        if self.micro_batch_graphs < 1:
            raise ValueError(
                f"Serving.micro_batch_graphs must be >= 1, got {self.micro_batch_graphs}"
            )
        if int(self.http_port) > 65535:
            raise ValueError(
                f"Serving.http_port must be <= 65535 (0 = ephemeral, negative "
                f"disables), got {self.http_port!r}"
            )
        if not isinstance(self.http_host, str) or not self.http_host:
            raise ValueError(
                f"Serving.http_host must be a non-empty bind address, got {self.http_host!r}"
            )
        if self.retrace_policy not in RETRACE_POLICIES:
            raise ValueError(
                f"Serving.retrace_policy {self.retrace_policy!r} must be one "
                f"of {RETRACE_POLICIES}"
            )
        for key in ("batch_window_s", "default_deadline_s", "slo_p99_s",
                    "expected_latency_per_graph_s", "drain_timeout_s", "step_timeout_s"):
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
