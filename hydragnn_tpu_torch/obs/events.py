"""Structured event log: typed, ring-buffered records for every discrete
incident the subsystems detect (docs/OBSERVABILITY.md "Event log"); the
same vocabulary and record shape as ``hydragnn_tpu.obs.events``.

Each incident (a guard skip, a data reject, a checkpoint write, a wedged
serve step) becomes a typed record: timestamp, kind, severity, the active
trace_id (obs/trace.py) when one is open, and the incident's own
attributes, in one process-wide ring buffer the flight recorder
(obs/flightrec.py) dumps verbatim, and in ``events.jsonl`` once a run
attaches its stream.

Publishing is unconditional and cheap (one deque append + one counter inc
under the registry lock), matching the registry's contract; sinks
(flight-recorder dumps, ``snapshot()`` consumers) are opt-in. Emission is
exception-safe by construction: a malformed attribute is coerced to its
``str`` rather than raised, because an incident *reporter* must never
become an incident *source*.
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
from collections import deque
from typing import Any, Dict, List, Optional

from ..utils import ranks as _ranks
from .registry import registry

# -- stable event vocabulary (the kinds subsystems emit today) ---------------
EV_GUARD_SKIP = "guard_skip"              # non-finite steps skipped (epoch tally)
EV_GUARD_ROLLBACK = "guard_rollback"      # rollback policy restored a checkpoint
EV_GUARD_FATAL = "guard_fatal"            # non_finite_policy=error raising
EV_DATA_SKIP = "data_skip"                # validator reject (incl. quarantine)
EV_RETRACE_VIOLATION = "retrace_violation"  # sentinel saw a silent recompile
EV_CACHE_MISS = "compile_cache_miss"      # persistent compile cache miss
EV_LOADER_STALL = "loader_stall"          # LoaderStallError raised
EV_CKPT_WRITE = "checkpoint_write"        # checkpoint committed
EV_SHED = "serve_shed"                    # SLO load shed at admission
EV_QUEUE_FULL = "serve_queue_full"        # admission queue at its bound
EV_DEADLINE = "serve_deadline"            # request expired while queued
EV_WEDGE = "serve_wedge"                  # device-step watchdog fired
EV_DRAIN = "serve_drain"                  # graceful drain initiated
EV_RELOAD_SWAP = "reload_swap"            # hot reload installed a checkpoint
EV_RELOAD_REJECT = "reload_reject"        # hot reload rejected a candidate
EV_FLIGHT_DUMP = "flightrec_dump"         # the recorder itself dumped
EV_MIX_SOURCE_ADD = "mix_source_add"      # mixture source hot-added
EV_MIX_SOURCE_REMOVE = "mix_source_remove"  # mixture source hot-removed
EV_MIX_DEMOTE = "mix_demote"              # source quarantine-demoted (mix/)
EV_MIX_DRIFT = "mix_drift"                # per-branch loss diverged past threshold
EV_NUMERICS_PROVENANCE = "numerics_provenance"  # NaN drill-down located a tensor
EV_FLEET_STRAGGLER = "fleet_straggler"    # fleet watchdog flagged a slow host
EV_FLEET_DESYNC = "fleet_desync"          # step progress skewed past the bound
EV_FLEET_HOST_STALE = "fleet_host_stale"  # host heartbeat missing past timeout
EV_SHARDING_AUDIT = "sharding_audit"      # inspector flagged an over-replicated leaf
EV_TILE_PLAN = "tile_plan"                # kernel tile-plan choice (tune/runtime.py)
EV_ELASTIC_SHRINK = "elastic_shrink"      # fleet re-laid-out onto fewer hosts
EV_ELASTIC_GROW = "elastic_grow"          # fleet re-laid-out back onto more hosts
EV_REPLICA_EXIT = "replica_exit"          # serving replica process died
EV_REPLICA_RESTART = "replica_restart"    # supervisor restarted a replica
EV_REPLICA_BENCHED = "replica_benched"    # flap breaker benched a replica
EV_BREAKER_OPEN = "breaker_open"          # router circuit breaker opened
EV_BREAKER_CLOSE = "breaker_close"        # half-open probe reclosed a breaker
EV_RELOAD_ROLLBACK = "reload_rollback"    # rolling reload rolled back a regression
EV_QUANT_DRIFT = "quant_drift"            # int8 accuracy gate refused a state

EVENT_KINDS = (
    EV_GUARD_SKIP, EV_GUARD_ROLLBACK, EV_GUARD_FATAL, EV_DATA_SKIP,
    EV_RETRACE_VIOLATION, EV_CACHE_MISS, EV_LOADER_STALL, EV_CKPT_WRITE,
    EV_SHED, EV_QUEUE_FULL, EV_DEADLINE, EV_WEDGE, EV_DRAIN,
    EV_RELOAD_SWAP, EV_RELOAD_REJECT, EV_FLIGHT_DUMP,
    EV_MIX_SOURCE_ADD, EV_MIX_SOURCE_REMOVE, EV_MIX_DEMOTE, EV_MIX_DRIFT,
    EV_NUMERICS_PROVENANCE,
    EV_FLEET_STRAGGLER, EV_FLEET_DESYNC, EV_FLEET_HOST_STALE,
    EV_SHARDING_AUDIT, EV_TILE_PLAN,
    EV_ELASTIC_SHRINK, EV_ELASTIC_GROW,
    EV_REPLICA_EXIT, EV_REPLICA_RESTART, EV_REPLICA_BENCHED,
    EV_BREAKER_OPEN, EV_BREAKER_CLOSE, EV_RELOAD_ROLLBACK,
    EV_QUANT_DRIFT,
)

SEVERITIES = ("info", "warn", "error", "fatal")

# per-kind default severities: emitters that do not rank their own
# incident inherit the kind's rank here, so consumers (the run doctor's
# rules, the flight recorder's incident census) can order incidents by
# severity instead of re-deriving rank from kind-name heuristics. An
# emitter passing an explicit severity still wins (a retrace violation
# under policy=error emits "error", not the table's "warn").
DEFAULT_SEVERITY: Dict[str, str] = {
    EV_GUARD_SKIP: "warn",
    EV_GUARD_ROLLBACK: "error",
    EV_GUARD_FATAL: "fatal",
    EV_DATA_SKIP: "warn",
    EV_RETRACE_VIOLATION: "warn",
    EV_CACHE_MISS: "info",
    EV_LOADER_STALL: "error",
    EV_CKPT_WRITE: "info",
    EV_SHED: "warn",
    EV_QUEUE_FULL: "warn",
    EV_DEADLINE: "warn",
    EV_WEDGE: "error",
    EV_DRAIN: "info",
    EV_RELOAD_SWAP: "info",
    EV_RELOAD_REJECT: "warn",
    EV_FLIGHT_DUMP: "info",
    EV_MIX_SOURCE_ADD: "info",
    EV_MIX_SOURCE_REMOVE: "info",
    EV_MIX_DEMOTE: "warn",
    EV_MIX_DRIFT: "warn",
    EV_NUMERICS_PROVENANCE: "warn",
    EV_FLEET_STRAGGLER: "warn",
    EV_FLEET_DESYNC: "error",
    EV_FLEET_HOST_STALE: "warn",
    EV_SHARDING_AUDIT: "warn",
    EV_TILE_PLAN: "info",
    # a shrink is progress lost + degraded capacity; a re-grow is recovery
    EV_ELASTIC_SHRINK: "warn",
    EV_ELASTIC_GROW: "info",
    # one replica death is absorbed by the fleet (warn); a bench means the
    # fleet permanently lost capacity until an operator intervenes (error),
    # and a reload rollback means a bad checkpoint reached serving (error)
    EV_REPLICA_EXIT: "warn",
    EV_REPLICA_RESTART: "warn",
    EV_REPLICA_BENCHED: "error",
    EV_BREAKER_OPEN: "warn",
    EV_BREAKER_CLOSE: "info",
    EV_RELOAD_ROLLBACK: "error",
    # a refused quantized state means a candidate would have served wrong
    # answers — the gate caught it, but the rollout it rode is dead
    EV_QUANT_DRIFT: "error",
}


def severity_rank(severity: str) -> int:
    """Numeric rank of a severity (info=0 .. fatal=3; unknown ranks as
    info) — the shared ordering for doctor rules and dump censuses."""
    try:
        return SEVERITIES.index(severity)
    except ValueError:
        return 0

# default ring capacity: deep enough that a post-mortem sees the whole
# incident cascade (a wedge under load sheds dozens of requests), small
# enough that the resident cost is a few hundred dicts
DEFAULT_CAPACITY = 256


def _json_safe(v: Any) -> Any:
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, dict):
        # structured evidence (elastic before/after layouts, sharding-table
        # summaries) must survive as objects, not reprs — the doctor
        # indexes into them
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        items = sorted(v, key=str) if isinstance(v, (set, frozenset)) else v
        return [_json_safe(x) for x in items]
    return str(v)


class EventLog:
    """Process-wide ring buffer of typed incident records, mirrored into
    the metrics registry (``hydragnn_events_total{kind=...}``)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        # RLock, not Lock: emitters run from signal handlers too (the serve
        # drain hook emits EV_DRAIN from SIGTERM) — a handler interrupting
        # its own thread mid-emit must be able to re-acquire, matching the
        # registry's locking contract
        self._lock = threading.RLock()
        self._ring: "deque[Dict[str, Any]]" = deque(maxlen=max(int(capacity), 1))
        self.emitted = 0
        # persistent JSONL sink (events.jsonl; attach_stream): the on-disk
        # analog of the ring so a *completed* run's incidents are readable
        # post-hoc (the run doctor's primary event source) instead of only
        # surviving inside flight dumps
        self._sink_fh = None
        self._sink_path: Optional[str] = None
        # records emitted while no sink was attached, written out by the
        # next attach_jsonl (bounded by the ring capacity)
        self._unstreamed: List[Dict[str, Any]] = []
        self._counter = registry().counter(
            "hydragnn_events_total",
            "Structured incident events emitted, by kind "
            "(docs/OBSERVABILITY.md event vocabulary)",
            labelnames=("kind",),
        )

    def emit(
        self,
        kind: str,
        severity: Optional[str] = None,
        trace_id: Optional[str] = None,
        **attrs: Any,
    ) -> Dict[str, Any]:
        """Record one incident. ``severity=None`` (the default) resolves
        through the per-kind ``DEFAULT_SEVERITY`` table so every record is
        ranked even when the emitter did not rank it; ``trace_id``
        defaults to the active tracer's current span context, so incidents
        inside a sampled request/step carry their causal anchor for free."""
        if trace_id is None:
            from . import trace as _trace

            trace_id = _trace.current_trace_id()
        if severity is None:
            severity = DEFAULT_SEVERITY.get(str(kind), "info")
        rec: Dict[str, Any] = {
            "ts": round(time.time(), 6),
            "kind": str(kind),
            "severity": severity if severity in SEVERITIES else "info",
        }
        if trace_id:
            rec["trace_id"] = trace_id
        for k, v in attrs.items():
            rec[k] = _json_safe(v)
        with self._lock:
            self._ring.append(rec)
            self.emitted += 1
            if self._sink_fh is not None:
                try:
                    # flushed per record: events are rare incidents (the
                    # hot paths emit none), and a crash must not truncate
                    # the very record that explains it
                    self._sink_fh.write(json.dumps(rec) + "\n")
                    self._sink_fh.flush()
                except (OSError, ValueError) as e:
                    self._sink_fh = None
                    warnings.warn(
                        f"events.jsonl stream failed ({e}); incident "
                        "records are ring-buffered only from here on",
                        RuntimeWarning,
                        stacklevel=2,
                    )
            else:
                # no sink yet: hold for backfill on the next attach — an
                # incident emitted before the run dir exists (e.g. the
                # elastic_shrink record from the resume guard, which runs
                # before the train loop arms events.jsonl) must still
                # reach the doctor's on-disk stream
                self._unstreamed.append(rec)
                del self._unstreamed[: -self._ring.maxlen]
        try:
            self._counter.inc(kind=rec["kind"])
        except Exception:
            pass  # an invalid label value must not fail the reporter
        return rec

    # -- persistent sink -----------------------------------------------------

    def attach_jsonl(self, path: str) -> Optional[str]:
        """Append-mode JSONL sink for every subsequent emit (last attach
        wins — one live run per process, matching the tracer's install
        contract). Returns the path, or None when it could not open (the
        ring keeps working either way)."""
        with self._lock:
            if self._sink_fh is not None:
                try:
                    self._sink_fh.close()
                except OSError:
                    pass
                self._sink_fh = None
            try:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                self._sink_fh = open(path, "a")
                self._sink_path = path
                if self._unstreamed:
                    # backfill incidents that predate the sink (see emit)
                    for rec in self._unstreamed:
                        self._sink_fh.write(json.dumps(rec) + "\n")
                    self._sink_fh.flush()
                    self._unstreamed.clear()
            except OSError as e:
                self._sink_path = None
                warnings.warn(
                    f"events.jsonl sink could not open ({e}); incidents "
                    "stay ring-buffered only",
                    RuntimeWarning,
                    stacklevel=2,
                )
                return None
        return path

    def detach_jsonl(self) -> None:
        with self._lock:
            if self._sink_fh is not None:
                try:
                    self._sink_fh.close()
                except OSError:
                    pass
            self._sink_fh = None
            self._sink_path = None

    @property
    def sink_path(self) -> Optional[str]:
        return self._sink_path

    def snapshot(self) -> List[Dict[str, Any]]:
        """The last N events, oldest first (what the flight recorder dumps)."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        """Drop buffered events (tests; the counter keeps its totals)."""
        with self._lock:
            self._ring.clear()
            self._unstreamed.clear()


_EVENTS = EventLog()


def events() -> EventLog:
    """The process-wide event log every subsystem emits into."""
    return _EVENTS


def emit(kind: str, severity: Optional[str] = None,
         trace_id: Optional[str] = None, **attrs: Any) -> Dict[str, Any]:
    """Module-level shorthand for ``events().emit(...)`` — the one-line
    call subsystems use at their incident sites. ``severity=None``
    inherits the kind's ``DEFAULT_SEVERITY`` rank."""
    return _EVENTS.emit(kind, severity=severity, trace_id=trace_id, **attrs)


def attach_stream(run_dir: str) -> Optional[str]:
    """Arm the persistent ``events.jsonl`` sink for ``run_dir`` (rank-
    suffixed on non-zero ranks: two processes appending one JSONL on a
    shared filesystem interleave mid-line). train/loop.py and
    api.run_server call this when the observability plane is on."""
    host_i = _ranks.rank()
    fname = "events.jsonl" if host_i == 0 else f"events-h{host_i}.jsonl"
    return _EVENTS.attach_jsonl(os.path.join(run_dir, fname))


def detach_stream() -> None:
    """Close the persistent sink (run teardown)."""
    _EVENTS.detach_jsonl()
