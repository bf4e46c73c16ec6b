"""Serving policy knobs, resolved from a run config's ``Serving`` section.

Counterpart of ``hydragnn_tpu/serve/config.py``, with its 32 keys, defaults
and validation: a plain JSON section with complete defaults, validated
eagerly so a typo'd policy fails at load time, not mid-traffic.
``update_config`` validates the section when present; ``config.lint`` knows
every key. Unknown keys warn and are ignored.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Tuple

#: int8 quantization modes (docs/SERVING.md "Quantization"): weight_only
#: keeps activations in the model's own precision and fuses the dequant
#: into the matmul; w8a8 also quantizes activations against static scales
#: calibrated from the numerics observatory's max-abs statistics.
QUANT_MODES = ("weight_only", "w8a8")


@dataclasses.dataclass(frozen=True)
class QuantizationSpec:
    """Resolved ``Serving.quantization`` sub-config (only meaningful with
    ``weights_dtype: int8``): the mode, how many warmed template batches
    feed activation calibration, the accuracy gate's relative max-error
    bound, and extra per-layer exclude substrings (head output layers and
    norm parameters are excluded structurally either way)."""

    mode: str = "weight_only"
    calibration_batches: int = 2
    max_error: float = 0.05
    exclude: Tuple[str, ...] = ()

    _KNOWN = ("mode", "calibration_batches", "max_error", "exclude")

    def __post_init__(self):
        if self.mode not in QUANT_MODES:
            raise ValueError(
                f"Serving.quantization.mode {self.mode!r} must be one of "
                f"{QUANT_MODES}"
            )
        if int(self.calibration_batches) < 1:
            raise ValueError(
                f"Serving.quantization.calibration_batches must be >= 1, "
                f"got {self.calibration_batches!r}"
            )
        if not (float(self.max_error) > 0.0):
            raise ValueError(
                f"Serving.quantization.max_error must be > 0 (relative max "
                f"error the accuracy gate tolerates), got "
                f"{self.max_error!r}"
            )
        if not isinstance(self.exclude, tuple) or not all(
            isinstance(p, str) and p for p in self.exclude
        ):
            raise ValueError(
                f"Serving.quantization.exclude must be a list of non-empty "
                f"layer-path substrings, got {self.exclude!r}"
            )

    @staticmethod
    def resolve(section: Any) -> "QuantizationSpec":
        """Normalize the config's ``Serving.quantization`` value (None =
        all defaults, a dict validates each key, a spec passes through).
        Unknown keys FAIL here (unlike top-level Serving keys, which only
        warn): a typo'd ``max_eror`` silently serving ungated int8 is
        exactly the accident the gate exists to prevent."""
        if section is None:
            return QuantizationSpec()
        if isinstance(section, QuantizationSpec):
            return section
        if not isinstance(section, dict):
            raise ValueError(
                f"Serving.quantization must be an object of "
                f"{list(QuantizationSpec._KNOWN)}, got {section!r}"
            )
        unknown = sorted(set(section) - set(QuantizationSpec._KNOWN))
        if unknown:
            raise ValueError(
                f"Serving.quantization keys {unknown} are unknown (known: "
                f"{list(QuantizationSpec._KNOWN)})"
            )
        kw = dict(section)
        if "calibration_batches" in kw:
            kw["calibration_batches"] = int(kw["calibration_batches"])
        if "max_error" in kw:
            kw["max_error"] = float(kw["max_error"])
        if "exclude" in kw:
            ex = kw["exclude"]
            kw["exclude"] = tuple(
                str(p) for p in (ex if isinstance(ex, (list, tuple)) else [ex])
            )
        return QuantizationSpec(**kw)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Resolved serving policy knobs (all times in seconds).

    - admission: ``max_queue_requests`` bounds the queue (0/negative =
      unbounded), ``default_deadline_s`` is the per-request deadline when the
      client does not set one (0 disables deadlines);
    - batching: ``micro_batch_graphs`` caps graphs per device batch,
      ``batch_window_s`` is how long the batcher waits to fill a batch after
      the first request arrives;
    - overload: ``slo_p99_s`` > 0 sheds admissions whose projected queue
      wait exceeds it; ``expected_latency_per_graph_s`` seeds the wait
      estimator before the first measured batch (0 = no shedding until the
      warm-up measurement lands);
    - fault tolerance: ``step_timeout_s`` bounds one device step (0 disables
      the watchdog), ``retrace_policy`` is the sentinel mode once the warmed
      ladder is armed (``error`` is the serving default: an unknown
      specialization in steady state is a correctness bug, not a warning);
    - lifecycle: ``hot_reload`` watches the run dir's ``latest`` pointer and
      swaps verified checkpoints in between batches (``reload_poll_s``
      cadence); ``drain_timeout_s`` bounds how long ``close()`` waits for
      in-flight work;
    - observability: ``http_port`` mounts the Prometheus ``/metrics`` +
      ``/healthz``/``/readyz`` endpoint (obs/prometheus.py) on the server —
      0 (the default) binds an ephemeral loopback port (read it back from
      ``GraphServer.http_port``), a positive value pins the port, a
      negative value disables the endpoint (embedded/test servers);
      ``http_host`` is the bind interface (default loopback — metrics are
      not public by default; set ``"0.0.0.0"`` for off-host scrapers and
      load-balancer readiness probes).
    """

    max_queue_requests: int = 256
    micro_batch_graphs: int = 32
    batch_window_s: float = 0.005
    default_deadline_s: float = 30.0
    slo_p99_s: float = 0.0
    expected_latency_per_graph_s: float = 0.0
    step_timeout_s: float = 60.0
    retrace_policy: str = "error"
    hot_reload: bool = False
    reload_poll_s: float = 2.0
    drain_timeout_s: float = 30.0
    http_port: int = 0
    http_host: str = "127.0.0.1"
    # reduced-precision serving: "bfloat16" serves a copy of the restored
    # model whose floating parameters are bf16 (batch-norm statistics stay
    # f32) on bf16 inputs: half the weight bytes on the card, bf16 tensor
    # cores. "int8" goes through the quantization plane (serve/quantize.py):
    # per-channel symmetric int8 weights and f32 scales, gated at every
    # install by quantization.max_error. Hot reloads take the same path.
    weights_dtype: str = "float32"
    # int8 sub-config (QuantizationSpec; only consulted when weights_dtype
    # is "int8"): mode weight_only|w8a8, calibration batch count, accuracy
    # gate bound, per-layer exclude substrings. None = spec defaults.
    quantization: Any = None
    # drain ordering (docs/SERVING.md "Drain"): on SIGTERM /readyz flips
    # not-ready immediately, but admissions stay open for drain_grace_s so
    # a load balancer observes the flip and stops routing *before* clients
    # start eating ServerDrainingError. 0 (the default) rejects immediately
    # — the pre-fleet behavior.
    drain_grace_s: float = 0.0
    # fleet supervision (serve/fleet.py; docs/SERVING.md "Fleet"):
    # fleet_replicas > 0 is the ReplicaManager's worker count; crashed
    # replicas restart with exponential backoff (base doubling up to the
    # cap) and a replica dying fleet_flap_max_restarts times inside
    # fleet_flap_window_s is benched (typed replica_benched event), not
    # restarted forever. fleet_ready_floor is the fraction of replicas that
    # must stay ready during a rolling reload.
    fleet_replicas: int = 0
    fleet_restart_backoff_s: float = 0.5
    fleet_restart_backoff_max_s: float = 10.0
    fleet_flap_window_s: float = 60.0
    fleet_flap_max_restarts: int = 5
    fleet_ready_floor: float = 0.5
    # front router (serve/router.py): per-request end-to-end timeout,
    # bounded retries of retryable failures on a different replica
    # (router_backoff_s base, doubling), tail hedging past
    # max(router_hedge_min_s, router_hedge_factor x EMA latency) for
    # interactive traffic, and a per-replica circuit breaker that opens
    # after breaker_failures consecutive typed failures and half-open
    # probes after breaker_cooldown_s.
    router_timeout_s: float = 30.0
    router_retries: int = 2
    router_backoff_s: float = 0.05
    router_hedge_factor: float = 3.0
    router_hedge_min_s: float = 0.05
    breaker_failures: int = 3
    breaker_cooldown_s: float = 5.0
    # content-addressed prediction cache (serve/cache.py): False disables,
    # True uses <run dir>/pred_cache, a string is an explicit directory.
    # Hits are bit-identical to misses by construction (lossless .npz +
    # digest-verified load).
    prediction_cache: Any = False
    # rolling-reload regression guard: after the first replica swaps, the
    # manager probes it with reload_probe_requests requests; an error rate
    # >= reload_error_spike rolls that replica back to the prior checkpoint
    # (typed reload_rollback event) and aborts the rollout.
    reload_error_spike: float = 0.5
    reload_probe_requests: int = 8

    _KNOWN = (
        "max_queue_requests",
        "micro_batch_graphs",
        "batch_window_s",
        "default_deadline_s",
        "slo_p99_s",
        "expected_latency_per_graph_s",
        "step_timeout_s",
        "retrace_policy",
        "hot_reload",
        "reload_poll_s",
        "drain_timeout_s",
        "http_port",
        "http_host",
        "weights_dtype",
        "quantization",
        "drain_grace_s",
        "fleet_replicas",
        "fleet_restart_backoff_s",
        "fleet_restart_backoff_max_s",
        "fleet_flap_window_s",
        "fleet_flap_max_restarts",
        "fleet_ready_floor",
        "router_timeout_s",
        "router_retries",
        "router_backoff_s",
        "router_hedge_factor",
        "router_hedge_min_s",
        "breaker_failures",
        "breaker_cooldown_s",
        "prediction_cache",
        "reload_error_spike",
        "reload_probe_requests",
    )

    WEIGHTS_DTYPES = ("float32", "bfloat16", "int8")

    def __post_init__(self):
        from ..train.compile_plane import RETRACE_POLICIES

        if self.micro_batch_graphs < 1:
            raise ValueError(
                f"Serving.micro_batch_graphs must be >= 1, got "
                f"{self.micro_batch_graphs}"
            )
        if self.retrace_policy not in RETRACE_POLICIES:
            raise ValueError(
                f"Serving.retrace_policy {self.retrace_policy!r} must be one "
                f"of {RETRACE_POLICIES}"
            )
        for key in ("batch_window_s", "default_deadline_s", "slo_p99_s",
                    "expected_latency_per_graph_s", "step_timeout_s",
                    "reload_poll_s", "drain_timeout_s", "drain_grace_s",
                    "fleet_restart_backoff_s", "fleet_restart_backoff_max_s",
                    "fleet_flap_window_s", "router_timeout_s",
                    "router_backoff_s", "router_hedge_min_s",
                    "breaker_cooldown_s"):
            if float(getattr(self, key)) < 0:
                raise ValueError(
                    f"Serving.{key} must be >= 0 (seconds; 0 disables), got "
                    f"{getattr(self, key)!r}"
                )
        for key in ("fleet_replicas", "fleet_flap_max_restarts",
                    "router_retries", "breaker_failures",
                    "reload_probe_requests"):
            if int(getattr(self, key)) < 0:
                raise ValueError(
                    f"Serving.{key} must be >= 0, got {getattr(self, key)!r}"
                )
        if not (0.0 <= float(self.fleet_ready_floor) <= 1.0):
            raise ValueError(
                f"Serving.fleet_ready_floor must be a fraction in [0, 1], "
                f"got {self.fleet_ready_floor!r}"
            )
        if not (0.0 <= float(self.reload_error_spike) <= 1.0):
            raise ValueError(
                f"Serving.reload_error_spike must be a fraction in [0, 1], "
                f"got {self.reload_error_spike!r}"
            )
        if float(self.router_hedge_factor) < 1.0:
            raise ValueError(
                f"Serving.router_hedge_factor must be >= 1 (multiple of the "
                f"EMA latency), got {self.router_hedge_factor!r}"
            )
        if not isinstance(self.prediction_cache, (bool, str)) or (
            isinstance(self.prediction_cache, str)
            and not self.prediction_cache
        ):
            raise ValueError(
                f"Serving.prediction_cache must be False, True, or a "
                f"non-empty cache directory path, got "
                f"{self.prediction_cache!r}"
            )
        if int(self.http_port) > 65535:
            raise ValueError(
                f"Serving.http_port must be <= 65535 (0 = ephemeral, "
                f"negative disables), got {self.http_port!r}"
            )
        if not isinstance(self.http_host, str) or not self.http_host:
            raise ValueError(
                f"Serving.http_host must be a non-empty bind address, got "
                f"{self.http_host!r}"
            )
        if self.weights_dtype not in ServeConfig.WEIGHTS_DTYPES:
            raise ValueError(
                f"Serving.weights_dtype {self.weights_dtype!r} must be one "
                f"of {ServeConfig.WEIGHTS_DTYPES}"
            )
        if self.quantization is not None or self.weights_dtype == "int8":
            # normalize once here so every consumer (server, fleet, bench)
            # reads a validated QuantizationSpec, never a raw dict
            object.__setattr__(
                self, "quantization",
                QuantizationSpec.resolve(self.quantization),
            )

    @staticmethod
    def from_config(config: Dict[str, Any]) -> "ServeConfig":
        """Resolve from a full run config's ``Serving`` section (missing
        section = all defaults; ``micro_batch_graphs`` falls back to
        ``Training.batch_size`` so the served shapes are the trained pad
        buckets). Unknown keys warn — matching config completion's
        ignore-unknown behavior — rather than failing the server."""
        section = dict(config.get("Serving", {}) or {})
        unknown = sorted(set(section) - set(ServeConfig._KNOWN))
        if unknown:
            warnings.warn(
                f"Serving config keys {unknown} are not consumed (known keys: "
                f"{list(ServeConfig._KNOWN)}); check docs/CONFIG.md for the "
                "serving surface",
                stacklevel=2,
            )
            for k in unknown:
                section.pop(k)
        if "micro_batch_graphs" not in section:
            bs = (
                config.get("NeuralNetwork", {})
                .get("Training", {})
                .get("batch_size")
            )
            if bs:
                section["micro_batch_graphs"] = int(bs)
        return ServeConfig(**section)
