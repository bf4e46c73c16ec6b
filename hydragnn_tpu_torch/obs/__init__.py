"""The observability plane of the port (docs/OBSERVABILITY.md), the
counterpart of ``hydragnn_tpu/obs``: the process-wide metrics registry
every subsystem publishes into, the Prometheus scrape and health endpoint,
the per-step train instrumentation with its versioned ``metrics.jsonl``
stream and the card's MFU, the on-demand profiling trigger, request and
step spans (obs/trace.py), the structured event log (obs/events.py), the
numerics probes with NaN provenance (obs/numerics.py), the crash
flight recorder (obs/flightrec.py) and the fleet layer (obs/fleet.py:
cross-host aggregation, the straggler/desync watchdog, trace stitching).
The sharding inspector and the run doctor are not ported yet."""

from .events import (
    DEFAULT_SEVERITY,
    EventLog,
    attach_stream,
    detach_stream,
    events,
    severity_rank,
)
from .events import emit as emit_event
from .fleet import (
    FleetCollector,
    FleetPlane,
    FleetPusher,
    host_identity,
    merge_traces,
    registry_snapshot,
)
from .flightrec import FlightRecorder
from .numerics import NanWatch, probe
from .prometheus import TelemetryHTTPServer, render_text, start_endpoint
from .registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    registry,
)
from .schema import (
    validate_event_record,
    validate_metrics_record,
    validate_span_record,
)
from .telemetry import (
    SCHEMA_VERSION,
    MetricsStream,
    ProfileTrigger,
    StepTelemetry,
    host_memory_bytes,
    mfu_estimate,
    peak_flops,
    publish_build_info,
    resolve_telemetry,
)
from .trace import Span, Tracer

__all__ = [
    "Counter",
    "DEFAULT_SEVERITY",
    "EventLog",
    "FleetCollector",
    "FleetPlane",
    "FleetPusher",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MetricsStream",
    "NanWatch",
    "ProfileTrigger",
    "SCHEMA_VERSION",
    "Span",
    "StepTelemetry",
    "TelemetryHTTPServer",
    "Tracer",
    "attach_stream",
    "detach_stream",
    "emit_event",
    "events",
    "host_identity",
    "host_memory_bytes",
    "merge_traces",
    "mfu_estimate",
    "peak_flops",
    "probe",
    "publish_build_info",
    "registry",
    "registry_snapshot",
    "render_text",
    "resolve_telemetry",
    "severity_rank",
    "start_endpoint",
    "validate_event_record",
    "validate_metrics_record",
    "validate_span_record",
]
