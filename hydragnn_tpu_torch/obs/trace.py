"""Span tracing plane: the causal layer on top of the metrics registry
(docs/OBSERVABILITY.md "Tracing").

Metrics aggregate — they cannot answer *where* one p99 request or one slow
step spent its time. Spans can: every sampled request/step becomes a trace
(trace_id) of timed spans (span_id/parent) written as OTLP-shaped JSONL to
``logs/<run>/trace.jsonl``, one JSON object per line, so any OTLP-literate
tool can consume it without an
exporter dependency.

Design points:

- **head-based sampling** — the keep/drop decision is made once, at the
  trace root (``Telemetry.trace_sample`` per serving request,
  ``Telemetry.trace_interval_steps`` every-Nth training step); unsampled
  work creates no span objects at all, which is what keeps the tracing
  bill inside the telemetry plane's <= 2% overhead budget
  (``chip_smoke.py``'s ``obs_train`` phase measures the A/B on the card).
- **unified with the region timers** — ``utils/tracer.py`` ``start/stop``
  regions that close while a sampled span is open on the same thread are
  emitted as child spans (``note_region``), so the pre-existing
  ``dataload``/``train_step`` instrumentation lands in the same trace tree
  without a second instrumentation pass.
- **cross-thread spans** — serving forms batches on the serve loop thread
  from requests admitted on client threads; ``begin``/``finish`` take
  explicit parent/trace ids (no thread-local requirement) and spans carry
  OTLP links, so co-batched requests share the device-step span as a link.
- **crash-safe** — finished spans ride a ring buffer the flight recorder
  (obs/flightrec.py) dumps on crash, and the JSONL stream is flushed by an
  ``atexit`` hook, so an abnormal exit does not truncate the last window.

The writer follows the ``MetricsStream`` contract: observability never
takes the owner down — a full disk drops the stream with a warning and the
run keeps going.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import random
import threading
import time
import warnings
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..utils import ranks as _ranks
from .registry import registry

# span-record schema version (the trace.jsonl analog of metrics.jsonl "v";
# the shape itself is pinned in obs/schema.py SPAN_FIELDS)
from .schema import TRACE_SCHEMA_VERSION

# OTLP status codes (proto enum values)
STATUS_UNSET = 0
STATUS_OK = 1
STATUS_ERROR = 2


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


def _otlp_value(v: Any) -> Dict[str, Any]:
    """One attribute value in OTLP JSON shape (ints as strings, per the
    OTLP JSON mapping of 64-bit integers)."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


class Span:
    """One timed operation: identity (trace/span/parent ids), wall-clock
    start, monotonic duration, attributes, links, and an OTLP status."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "start_unix", "_t0",
        "duration_s", "attributes", "links", "status_code", "status_message",
    )

    def __init__(
        self,
        name: str,
        trace_id: str,
        parent_id: Optional[str] = None,
        start_unix: Optional[float] = None,
        attributes: Optional[Dict[str, Any]] = None,
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        now = time.time()
        self.start_unix = now if start_unix is None else float(start_unix)
        # a retroactive start (start_unix in the past) anchors the duration
        # clock too, so end() measures from the DECLARED start — a request
        # root begun after admission work still spans admission-to-outcome
        self._t0 = time.perf_counter() - max(now - self.start_unix, 0.0)
        self.duration_s: Optional[float] = None
        self.attributes: Dict[str, Any] = dict(attributes or {})
        self.links: List[Tuple[str, str]] = []
        self.status_code = STATUS_UNSET
        self.status_message = ""

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def add_link(self, trace_id: str, span_id: str) -> None:
        self.links.append((trace_id, span_id))

    def set_status(self, code: int, message: str = "") -> None:
        self.status_code = code
        self.status_message = message

    @property
    def ended(self) -> bool:
        return self.duration_s is not None

    def end(self, duration_s: Optional[float] = None) -> None:
        if self.duration_s is None:
            self.duration_s = (
                time.perf_counter() - self._t0
                if duration_s is None
                else float(duration_s)
            )

    def to_record(self) -> Dict[str, Any]:
        """OTLP-shaped JSON record (the Span proto's JSON mapping, plus a
        top-level schema version)."""
        dur = self.duration_s if self.duration_s is not None else 0.0
        rec: Dict[str, Any] = {
            "v": TRACE_SCHEMA_VERSION,
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "name": self.name,
            "startTimeUnixNano": str(int(self.start_unix * 1e9)),
            "endTimeUnixNano": str(int((self.start_unix + dur) * 1e9)),
        }
        if self.parent_id:
            rec["parentSpanId"] = self.parent_id
        if self.attributes:
            rec["attributes"] = [
                {"key": k, "value": _otlp_value(v)}
                for k, v in self.attributes.items()
            ]
        if self.links:
            rec["links"] = [
                {"traceId": t, "spanId": s} for t, s in self.links
            ]
        if self.status_code != STATUS_UNSET:
            status: Dict[str, Any] = {"code": self.status_code}
            if self.status_message:
                status["message"] = self.status_message
            rec["status"] = status
        return rec


class Tracer:
    """Span factory + sink for one run.

    - ``sample_request()`` / ``sample_step()`` are the head-sampling
      decisions (probability / every-Nth); call once per root.
    - ``span(name)`` is the thread-local context manager (parents nest on
      this thread's stack); ``begin``/``finish`` are the explicit-context
      API for cross-thread spans; ``emit_completed`` records a span
      retroactively from a measured (start, duration) — the region-timer
      and queue-wait shape.
    - finished spans land in the JSONL stream (flushed at most once a
      second + atexit) and a ring buffer for the flight recorder.
    """

    def __init__(
        self,
        run_dir: Optional[str] = None,
        sample: float = 1.0,
        every_n_steps: int = 0,
        ring: int = 512,
        jsonl: bool = True,
        rank0: Optional[bool] = None,
        filename: str = "trace.jsonl",
    ):
        self.sample = float(sample)
        self.every_n_steps = int(every_n_steps)
        self.run_dir = run_dir
        # every span record names its rank so per-rank streams stitch into
        # one run-level view; ``filename`` lets a non-zero rank write its
        # own suffixed stream on a shared filesystem (train/loop.py)
        self.host = _ranks.rank()
        self.path = (
            os.path.join(run_dir, filename)
            if run_dir and jsonl
            else None
        )
        if rank0 is None:
            rank0 = _ranks.is_primary()
        self._fh = None
        if self.path is not None and rank0:
            try:
                os.makedirs(run_dir, exist_ok=True)
                self._fh = open(self.path, "a")
            except OSError as e:
                warnings.warn(
                    f"trace.jsonl stream could not open ({e}); spans are "
                    "ring-buffered only for this run",
                    RuntimeWarning,
                    stacklevel=2,
                )
        self._lock = threading.Lock()
        self._ring: "deque[Dict[str, Any]]" = deque(maxlen=max(int(ring), 1))
        self._tls = threading.local()
        self._steps = 0
        self._flushed_at = 0.0
        self.emitted = 0
        self._c_spans = registry().counter(
            "hydragnn_trace_spans_total",
            "Spans emitted by the tracing plane, by span name",
            labelnames=("name",),
        )
        atexit.register(self._atexit_flush)

    # -- sampling -------------------------------------------------------------

    def sample_request(self) -> bool:
        """Head decision for one serving request (probability
        ``Telemetry.trace_sample``)."""
        return self.sample > 0 and random.random() < self.sample

    def sample_step(self) -> bool:
        """Head decision for one training step: every
        ``Telemetry.trace_interval_steps``-th step is traced (the first
        sampled step is step N, so warm-up noise is skipped)."""
        if self.every_n_steps <= 0:
            return False
        self._steps += 1
        return self._steps % self.every_n_steps == 0

    # -- thread-local context -------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    def current_trace_id(self) -> Optional[str]:
        cur = self.current()
        return cur.trace_id if cur is not None else None

    # -- span lifecycle -------------------------------------------------------

    def begin(
        self,
        name: str,
        parent: Optional[Span] = None,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        attributes: Optional[Dict[str, Any]] = None,
        start_unix: Optional[float] = None,
    ) -> Span:
        """Open a span with an explicit context (cross-thread safe; does
        NOT touch the thread-local stack). With no parent/trace given, a
        new trace root is created. ``start_unix`` backdates the span (the
        sampling decision may only be reachable after the work started)."""
        if parent is not None:
            trace_id = parent.trace_id
            parent_id = parent.span_id
        if trace_id is None:
            trace_id = _new_trace_id()
        return Span(
            name,
            trace_id,
            parent_id=parent_id,
            start_unix=start_unix,
            attributes=attributes,
        )

    def finish(self, span: Span) -> None:
        """End an explicitly begun span and emit it."""
        span.end()
        self._emit(span)

    @contextlib.contextmanager
    def span(self, name: str, parent: Optional[Span] = None, **attributes):
        """Thread-local span: parents under this thread's current span
        (or the explicit ``parent``), marks ERROR status on exception and
        re-raises."""
        sp = self.begin(
            name, parent=parent if parent is not None else self.current(),
            attributes=attributes,
        )
        stack = self._stack()
        stack.append(sp)
        try:
            yield sp
        except BaseException as e:
            sp.set_status(STATUS_ERROR, f"{type(e).__name__}: {e}")
            raise
        finally:
            if stack and stack[-1] is sp:
                stack.pop()
            else:  # out-of-order exit: drop it wherever it sits
                try:
                    stack.remove(sp)
                except ValueError:
                    pass
            self.finish(sp)

    def emit_completed(
        self,
        name: str,
        start_unix: float,
        duration_s: float,
        parent: Optional[Span] = None,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        attributes: Optional[Dict[str, Any]] = None,
        links: Iterable[Tuple[str, str]] = (),
        status: int = STATUS_UNSET,
        status_message: str = "",
    ) -> Span:
        """Record an already-measured operation as a finished span (the
        retroactive shape: queue waits, region timers, host batch build)."""
        if parent is not None:
            trace_id = parent.trace_id
            parent_id = parent.span_id
        sp = Span(
            name,
            trace_id if trace_id is not None else _new_trace_id(),
            parent_id=parent_id,
            start_unix=start_unix,
            attributes=attributes,
        )
        for t, s in links:
            sp.add_link(t, s)
        if status != STATUS_UNSET:
            sp.set_status(status, status_message)
        sp.end(duration_s=duration_s)
        self._emit(sp)
        return sp

    # -- sink -----------------------------------------------------------------

    def _emit(self, span: Span) -> None:
        rec = span.to_record()
        rec["host"] = self.host
        with self._lock:
            self._ring.append(rec)
            self.emitted += 1
            if self._fh is not None:
                try:
                    self._fh.write(json.dumps(rec) + "\n")
                    now = time.monotonic()
                    # flush at most ~1/s (the MetricsStream cadence): the
                    # fsync-free flush is still a syscall on the hot path
                    if now - self._flushed_at >= 1.0:
                        self._fh.flush()
                        self._flushed_at = now
                except (OSError, ValueError) as e:
                    self._fh = None
                    warnings.warn(
                        f"trace.jsonl stream failed ({e}); spans are "
                        "ring-buffered only for the rest of this run",
                        RuntimeWarning,
                        stacklevel=3,
                    )
        self._c_spans.inc(name=span.name)

    def recent(self) -> List[Dict[str, Any]]:
        """The last N finished span records (the flight-recorder window)."""
        with self._lock:
            return list(self._ring)

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.flush()
                except (OSError, ValueError):
                    self._fh = None

    def _atexit_flush(self) -> None:
        # abnormal-exit guarantee: whatever reached the writer is on disk
        # even when the owner never called close() (unhandled exception,
        # sys.exit from a signal handler)
        try:
            self.flush()
        except Exception:
            pass

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
        try:
            atexit.unregister(self._atexit_flush)
        except Exception:
            pass


# ---------------------------------------------------------------------------
# process-active tracer: the hook point for subsystems that cannot be handed
# a Tracer instance (utils/tracer.py regions, checkpoint IO, event trace-id
# attachment)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Tracer] = None
_ACTIVE_LOCK = threading.Lock()


def install(tracer: Tracer) -> Tracer:
    """Make ``tracer`` the process-active tracer (last install wins — one
    live run per process is the deployment model, tests install/uninstall
    around themselves)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = tracer
    return tracer


def uninstall(tracer: Optional[Tracer] = None) -> None:
    """Clear the active tracer (only if it is ``tracer``, when given —
    a nested run tearing down must not clobber its parent's install)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if tracer is None or _ACTIVE is tracer:
            _ACTIVE = None


def active() -> Optional[Tracer]:
    return _ACTIVE


def current_trace_id() -> Optional[str]:
    """Trace id of the active tracer's current thread-local span, or None —
    the hook obs/events.py uses to stamp events with causal context."""
    t = _ACTIVE
    if t is None:
        return None
    try:
        return t.current_trace_id()
    except Exception:
        return None


def note_region(name: str, duration_s: float) -> None:
    """Region-timer unification hook (utils/tracer.py ``stop`` calls this):
    when a sampled span is open on this thread, the closed region becomes a
    retroactive child span of it. No active tracer / no open span = no-op,
    so unsampled steps pay one None check."""
    t = _ACTIVE
    if t is None:
        return
    cur = t.current()
    if cur is None:
        return
    t.emit_completed(
        name, time.time() - duration_s, duration_s, parent=cur
    )


def note_completed(
    name: str,
    duration_s: float,
    attributes: Optional[Dict[str, Any]] = None,
) -> None:
    """Standalone-operation hook (checkpoint IO): emit a finished span via
    the active tracer, parented under the current span when one is open,
    otherwise as its own single-span trace."""
    t = _ACTIVE
    if t is None:
        return
    t.emit_completed(
        name,
        time.time() - duration_s,
        duration_s,
        parent=t.current(),
        attributes=attributes,
    )
