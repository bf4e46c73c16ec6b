"""Crash flight recorder: the black box of a run
(docs/OBSERVABILITY.md "Flight recorder").

On an unhandled exception, ``SIGUSR2``, a fatal guard policy, a NaN
provenance finding or a GraphServer wedge, the recorder dumps the last N
structured events (obs/events.py), the last N finished spans
(obs/trace.py), a full registry snapshot (Prometheus text) and the
device's memory figures (obs/memory.py) atomically into
``logs/<run>/flightrec/<stamp>-<reason>/`` — so a post-mortem has the
incident cascade, its causal trace context, and every counter/gauge at the
moment of death without re-running anything.

Atomicity: each dump is assembled in a hidden temp directory and renamed
into place, so a consumer never sees a half-written dump; a crash *during*
the dump leaves only a ``.tmp-*`` directory behind, never a truncated
final one. Dumps are bounded (``max_dumps`` per recorder) so a crash loop
cannot fill the disk.

Triggering: ``install()`` chains ``sys.excepthook`` (unhandled exceptions
on the main thread), ``threading.excepthook`` (worker threads — the serve
loop and prefetch producers live there), and a ``SIGUSR2`` handler (the
operator's "dump now" button on a live process), and registers the
instance as the process-active recorder so call sites that cannot be
handed an instance (the guard's fatal path) reach it via ``trigger()``.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import traceback
from typing import Any, Dict, Optional

# import from the submodule directly: the package __init__ re-exports the
# ``events()`` accessor under the submodule's own name, so ``from . import
# events`` would resolve to the function after package init
from .events import EV_FLIGHT_DUMP
from .events import emit as _emit_event
from .events import events as _event_log
from .prometheus import render_text
from ..utils import ranks as _ranks


class FlightRecorder:
    """Per-run black box. Construct with the run dir; ``install()`` wires
    the crash hooks; ``dump(reason)`` is the manual trigger."""

    def __init__(
        self,
        run_dir: str,
        tracer=None,
        max_dumps: int = 8,
    ):
        self.out_root = os.path.join(run_dir, "flightrec")
        self.tracer = tracer
        self.max_dumps = int(max_dumps)
        self.dumps = 0
        self._lock = threading.Lock()
        self._prev_excepthook = None
        self._prev_thread_hook = None
        self._prev_sigusr2 = None
        self._installed = False

    # -- dumping --------------------------------------------------------------

    def _spans(self):
        if self.tracer is not None:
            return self.tracer.recent()
        from . import trace as _trace

        t = _trace.active()
        return t.recent() if t is not None else []

    def dump(self, reason: str, exc: Optional[BaseException] = None) -> Optional[str]:
        """Write one dump; returns its directory, or None when the dump
        budget is spent or the write failed (the recorder never raises —
        a black box that crashes the plane defeats its purpose)."""
        with self._lock:
            if self.dumps >= self.max_dumps:
                return None
            self.dumps += 1
            idx = self.dumps
        try:
            safe_reason = "".join(
                c if c.isalnum() or c in "-_" else "_" for c in str(reason)
            )[:64] or "dump"
            stamp = time.strftime("%Y%m%d-%H%M%S")
            # rank-disambiguated directory: ranks dumping onto one shared
            # filesystem in the same second land side by side
            host_i = _ranks.rank()
            final = os.path.join(
                self.out_root, f"{stamp}-{idx:02d}-{safe_reason}-h{host_i}"
            )
            tmp = os.path.join(
                self.out_root,
                f".tmp-{idx:02d}-{safe_reason}-h{host_i}-{os.getpid()}",
            )
            os.makedirs(tmp, exist_ok=True)
            meta: Dict[str, Any] = {
                "reason": str(reason),
                "ts": round(time.time(), 6),
                "pid": os.getpid(),
                "host": host_i,
                "dump_index": idx,
            }
            if exc is not None:
                meta["exception"] = {
                    "type": type(exc).__name__,
                    "message": str(exc),
                    "traceback": "".join(
                        traceback.format_exception(
                            type(exc), exc, exc.__traceback__
                        )
                    ),
                }
            # incident census by severity (the per-kind ranks of
            # obs/events.py DEFAULT_SEVERITY): a post-mortem — and the run
            # doctor's dump ingestion — ranks the window without kind-name
            # heuristics, and the worst rank is grep-able from meta alone
            event_window = _event_log().snapshot()
            census: Dict[str, int] = {}
            for ev in event_window:
                sev = str(ev.get("severity", "info"))
                census[sev] = census.get(sev, 0) + 1
            meta["events_by_severity"] = census
            from .events import SEVERITIES as _SEVS

            meta["worst_severity"] = next(
                (s for s in reversed(_SEVS) if census.get(s)), "info"
            )
            with open(os.path.join(tmp, "meta.json"), "w") as fh:
                json.dump(meta, fh, indent=2)
            with open(os.path.join(tmp, "events.json"), "w") as fh:
                json.dump(event_window, fh, indent=2)
            with open(os.path.join(tmp, "spans.json"), "w") as fh:
                json.dump(self._spans(), fh, indent=2)
            with open(os.path.join(tmp, "metrics.prom"), "w") as fh:
                fh.write(render_text())
            # OOM forensics: the labelled memory table (obs/memory.py) and
            # the live device figures, best-effort (the CPU has none)
            try:
                from . import memory as _memory

                with open(os.path.join(tmp, "memory.json"), "w") as fh:
                    json.dump(
                        {
                            "hbm_by_spec": _memory.snapshot(),
                            "device_memory_peak_bytes":
                                _memory.device_memory_stats(),
                            "device_bytes_limit":
                                _memory.device_bytes_limit(),
                        },
                        fh,
                        indent=2,
                    )
            except Exception:
                pass
            os.rename(tmp, final)
            # the dump is itself an incident record (visible to later dumps
            # and to anyone tailing the event log)
            _emit_event(EV_FLIGHT_DUMP, reason=str(reason), path=final)
            return final
        except Exception:
            return None

    # -- crash hooks ----------------------------------------------------------

    def _on_exception(self, exc_type, exc, tb):
        try:
            if exc is not None and exc.__traceback__ is None:
                exc = exc.with_traceback(tb)
            self.dump("unhandled_exception", exc=exc)
        finally:
            hook = self._prev_excepthook or sys.__excepthook__
            hook(exc_type, exc, tb)

    def _on_thread_exception(self, args):
        try:
            # KeyboardInterrupt/SystemExit in a worker is a shutdown, not a
            # crash; everything else is black-box-worthy
            if not issubclass(args.exc_type, (SystemExit, KeyboardInterrupt)):
                self.dump(
                    f"thread_exception_{args.thread.name if args.thread else 'unknown'}",
                    exc=args.exc_value,
                )
        finally:
            hook = self._prev_thread_hook or threading.__excepthook__
            hook(args)

    def _on_sigusr2(self, signum, frame):
        self.dump("sigusr2")
        prev = self._prev_sigusr2
        if callable(prev):
            prev(signum, frame)

    def install(self, signal_hook: bool = True) -> "FlightRecorder":
        """Wire the crash hooks and register as the process-active
        recorder. Idempotent per instance."""
        if self._installed:
            return self
        self._installed = True
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._on_exception
        self._prev_thread_hook = threading.excepthook
        threading.excepthook = self._on_thread_exception
        if signal_hook:
            try:
                self._prev_sigusr2 = signal.signal(
                    signal.SIGUSR2, self._on_sigusr2
                )
            except ValueError:
                pass  # not the main thread: exception hooks only
        # every snapshot self-describes: the build-info gauge rides the
        # registry snapshot of every dump (and every Prometheus scrape)
        try:
            from .telemetry import publish_build_info

            publish_build_info()
        except Exception:
            pass
        _set_active(self)
        return self

    def uninstall(self) -> None:
        if not self._installed:
            _clear_active(self)
            return
        self._installed = False
        if sys.excepthook == self._on_exception:
            sys.excepthook = self._prev_excepthook or sys.__excepthook__
        if threading.excepthook == self._on_thread_exception:
            threading.excepthook = (
                self._prev_thread_hook or threading.__excepthook__
            )
        if self._prev_sigusr2 is not None:
            try:
                signal.signal(signal.SIGUSR2, self._prev_sigusr2)
            except ValueError:
                pass
            self._prev_sigusr2 = None
        _clear_active(self)


# ---------------------------------------------------------------------------
# process-active recorder: the hook for call sites that cannot be handed an
# instance (guard fatal policy, serve wedge)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FlightRecorder] = None
_ACTIVE_LOCK = threading.Lock()


def _set_active(rec: FlightRecorder) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = rec


def _clear_active(rec: Optional[FlightRecorder]) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        if rec is None or _ACTIVE is rec:
            _ACTIVE = None


def active() -> Optional[FlightRecorder]:
    return _ACTIVE


def trigger(reason: str, exc: Optional[BaseException] = None) -> Optional[str]:
    """Dump via the process-active recorder; no-op (None) when none is
    installed — incident sites call this unconditionally."""
    rec = _ACTIVE
    if rec is None:
        return None
    return rec.dump(reason, exc=exc)
