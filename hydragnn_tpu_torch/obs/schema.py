"""One source of truth for the observability record shapes
(docs/OBSERVABILITY.md "Streams catalog").

The shapes of the ``metrics.jsonl`` / ``trace.jsonl`` / event records are
pinned here as versioned field specs, the same tables as
``hydragnn_tpu.obs.schema`` (the port's CPU tests hold them equal), so a
consumer of one package's streams reads the other's:

- the port's tests validate every record kind its planes produce here
  and against the JAX validators, so a producer change that breaks a
  consumer fails on the CPU first;
- a reader parses every stream through ``validate_*`` and degrades
  invalid records to warnings instead of crashing on them (a truncated
  flight dump is evidence, not an excuse to die).

A field spec is ``name -> (types, required, allow_none)``. Extra fields
are always allowed (records carry incident-specific attributes by
design); validation only complains about *missing required* fields and
*wrong types* — the failure modes that actually break consumers.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

# the stream schema versions the producers stamp (obs/telemetry.py
# SCHEMA_VERSION, obs/trace.py TRACE_SCHEMA_VERSION import from here so
# the stamp and the validator can never disagree)
METRICS_SCHEMA_VERSION = 1
TRACE_SCHEMA_VERSION = 1
EVENTS_SCHEMA_VERSION = 1

_NUM = (int, float)
_STR = (str,)
_INT = (int,)
_BOOL = (bool,)
_DICT = (dict,)
_LIST = (list,)

FieldSpec = Dict[str, Tuple[tuple, bool, bool]]

# ---------------------------------------------------------------------------
# metrics.jsonl (obs/telemetry.py MetricsStream)
# ---------------------------------------------------------------------------

# every record shares the envelope MetricsStream.write stamps
METRICS_ENVELOPE: FieldSpec = {
    "v": (_INT, True, False),
    "ts": (_NUM, True, False),
    "kind": (_STR, True, False),
    "host": (_INT, True, False),
}

# per-kind bodies (StepTelemetry.flush / on_epoch / run_record /
# compile_record; train/loop.py is the producer of "run"/"compile_report")
METRICS_KINDS: Dict[str, FieldSpec] = {
    "step_window": {
        "step": (_INT, True, False),
        "steps": (_INT, True, False),
        "step_time_ms": (_NUM, True, False),
        "graphs_per_sec": (_NUM, True, False),
        "nodes_per_sec": (_NUM, True, False),
        "edges_per_sec": (_NUM, True, False),
        "padding_waste": (_NUM, True, False),
        "padding_waste_graphs": (_NUM, True, False),
        "padding_waste_edges": (_NUM, True, False),
        "mfu_est": (_NUM, True, True),
        "comm_bytes_per_step": (_NUM, True, True),
        "comm_fraction_est": (_NUM, True, True),
        "buckets": (_DICT, True, False),
    },
    "epoch": {
        "epoch": (_INT, True, False),
        "filler": (_BOOL, True, False),
        # the scalar keys (train/val/test/lr, per-branch mirrors) are
        # recipe-dependent — validated as "extra numeric" by convention
    },
    "numerics": {
        "step": (_INT, True, False),
        # at least one of activations/gradients, each a name -> stats map
        "activations": (_DICT, False, False),
        "gradients": (_DICT, False, False),
    },
    "run": {
        "log_name": (_STR, True, False),
        "epochs": (_INT, True, False),
        "global_step": (_INT, True, False),
        "endpoint_port": (_INT, True, True),
        "compile": (_DICT, True, False),
    },
    # the compile plane's full end-of-run report (train/loop.py writes it
    # through StepTelemetry.compile_record — the doctor's source for HBM /
    # comm / cache / retrace verdicts without scraping stderr)
    "compile_report": {
        "mode": (_STR, True, False),
        "precompiled": (_INT, True, False),
        "specializations": (_INT, True, False),
        "cache_hits": (_INT, True, False),
        "cache_misses": (_INT, True, False),
        "violations": (_INT, True, False),
        "time_to_first_step": (_NUM, True, True),
        "hbm_by_spec": (_DICT, True, False),
        "hbm_peak_bytes": (_INT, True, True),
        "comm_by_spec": (_DICT, True, False),
        "comm_bytes_peak": (_INT, True, True),
        "device_bytes_limit": (_NUM, True, True),
    },
    # serving-fleet aggregate window (serve/fleet.py ReplicaManager writes
    # it to the run dir's metrics.jsonl ~1/s while the fleet is up): the
    # doctor's fleet-wide saturation source — ONE record spans every
    # replica, so queue_saturation/shed_spiral can fire once for the fleet
    # instead of once per replica stream
    "fleet_serve": {
        "replicas": (_INT, True, False),
        "ready": (_INT, True, False),
        "benched": (_INT, True, False),
        "queue_depth_mean": (_NUM, True, False),
        "queue_depth_max": (_NUM, True, False),
        "shed_total": (_NUM, True, False),
        "queue_full_total": (_NUM, True, False),
        "completed_total": (_NUM, True, False),
        "per_replica": (_DICT, True, False),
        # prediction-cache efficacy (serve/cache.py stats; optional so
        # pre-cache fleet streams stay schema-valid): cumulative lookup
        # counters + current entry census — the doctor's
        # cache_ineffective rule reads these
        "cache_enabled": (_BOOL, False, False),
        "cache_hits": (_NUM, False, False),
        "cache_misses": (_NUM, False, False),
        "cache_stores": (_NUM, False, False),
        "cache_entries": (_NUM, False, False),
        "cache_bytes": (_NUM, False, False),
    },
}

# ---------------------------------------------------------------------------
# trace.jsonl (obs/trace.py Span.to_record + the host stamp)
# ---------------------------------------------------------------------------

SPAN_FIELDS: FieldSpec = {
    "v": (_INT, True, False),
    "traceId": (_STR, True, False),
    "spanId": (_STR, True, False),
    "name": (_STR, True, False),
    # OTLP JSON maps 64-bit ints to strings
    "startTimeUnixNano": (_STR, True, False),
    "endTimeUnixNano": (_STR, True, False),
    "host": (_INT, True, False),
    "parentSpanId": (_STR, False, False),
    "attributes": (_LIST, False, False),
    "links": (_LIST, False, False),
    "status": (_DICT, False, False),
}

# ---------------------------------------------------------------------------
# event records (obs/events.py EventLog.emit; the ring, events.jsonl, and
# every flight dump's events.json share this shape)
# ---------------------------------------------------------------------------

EVENT_FIELDS: FieldSpec = {
    "ts": (_NUM, True, False),
    "kind": (_STR, True, False),
    "severity": (_STR, True, False),
    "trace_id": (_STR, False, False),
}


def _check(rec: Any, spec: FieldSpec, label: str) -> List[str]:
    if not isinstance(rec, dict):
        return [f"{label}: record is {type(rec).__name__}, not an object"]
    errors: List[str] = []
    for name, (types, required, allow_none) in spec.items():
        if name not in rec:
            if required:
                errors.append(f"{label}: missing required field {name!r}")
            continue
        v = rec[name]
        if v is None:
            if not allow_none:
                errors.append(f"{label}: field {name!r} is null")
            continue
        # bool is an int subclass — an int-typed field must not accept it
        if isinstance(v, bool) and bool not in types:
            errors.append(f"{label}: field {name!r} is a bool")
            continue
        if not isinstance(v, types):
            errors.append(
                f"{label}: field {name!r} is {type(v).__name__}, wanted "
                f"{'/'.join(t.__name__ for t in types)}"
            )
    return errors


def validate_metrics_record(rec: Any) -> List[str]:
    """Validate one metrics.jsonl record (envelope + per-kind body).
    Returns a list of error strings — empty means valid. Unknown kinds
    validate the envelope only (forward compatibility: a new producer
    kind must not fail every old consumer)."""
    errors = _check(rec, METRICS_ENVELOPE, "metrics")
    if errors or not isinstance(rec, dict):
        return errors
    if int(rec["v"]) > METRICS_SCHEMA_VERSION:
        return [
            f"metrics: record v={rec['v']} is newer than this reader "
            f"(v={METRICS_SCHEMA_VERSION})"
        ]
    kind = rec.get("kind")
    body = METRICS_KINDS.get(kind)
    if body is not None:
        errors = _check(rec, body, f"metrics[{kind}]")
        if kind == "numerics" and not errors:
            if "activations" not in rec and "gradients" not in rec:
                errors.append(
                    "metrics[numerics]: neither 'activations' nor "
                    "'gradients' present"
                )
    return errors


def validate_span_record(rec: Any) -> List[str]:
    """Validate one trace.jsonl span record."""
    errors = _check(rec, SPAN_FIELDS, "span")
    if not errors and int(rec["v"]) > TRACE_SCHEMA_VERSION:
        return [
            f"span: record v={rec['v']} is newer than this reader "
            f"(v={TRACE_SCHEMA_VERSION})"
        ]
    if not errors:
        try:
            if int(rec["endTimeUnixNano"]) < int(rec["startTimeUnixNano"]):
                errors.append("span: endTimeUnixNano before startTimeUnixNano")
        except ValueError:
            errors.append("span: non-integer time bounds")
    return errors


def validate_event_record(rec: Any) -> List[str]:
    """Validate one event record (ring snapshot / events.jsonl /
    flight-dump events.json entry)."""
    errors = _check(rec, EVENT_FIELDS, "event")
    if not errors:
        from .events import SEVERITIES

        if rec["severity"] not in SEVERITIES:
            errors.append(
                f"event: severity {rec['severity']!r} not in {SEVERITIES}"
            )
    return errors


def span_duration_ms(rec: Dict[str, Any]) -> Optional[float]:
    """Duration of a validated span record in milliseconds (the shared
    consumer helper — bench_gate's trace stats and the doctor's span
    decomposition must compute the same number)."""
    try:
        return (
            int(rec["endTimeUnixNano"]) - int(rec["startTimeUnixNano"])
        ) / 1e6
    except (KeyError, ValueError, TypeError):
        return None


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list — the ONE
    implementation behind every trace-percentile consumer (bench_gate's
    stage gate and the doctor's span decomposition/diff); two copies
    drifting (e.g. one growing interpolation) would silently make the
    gate's baseline and the doctor's report disagree on the same data."""
    if not sorted_vals:
        return 0.0
    idx = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
    return sorted_vals[idx]
