"""Region tracer facade: the GPTL/Score-P analog.

Counterpart of ``hydragnn_tpu/utils/tracer.py`` (reference:
hydragnn/utils/profiling_and_tracing/tracer.py:35-167). The backend is (a)
an in-process accumulator (count/total/min/max per region) and (b) a
``torch.profiler.record_function`` range per open region, so a region is
named in a Kineto trace (``torch.profiler``, the ``Profile`` section and
the on-demand trigger of obs/telemetry.py). ``sync=True`` waits for the
current CUDA device (``torch.cuda.synchronize``) before the timestamp, the
reference's ``cudasync=True`` (tracer.py:106-127); it runs only when asked,
by the argument or by ``HYDRAGNN_TRACE_LEVEL`` > 0 (the reference's
train-loop spans, train_validate_test.py:477-498). Each closed region
also feeds ``obs.trace.note_region``: inside a sampled span it becomes a
child span.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, Optional

from . import envflags

_enabled = False
_regions: Dict[str, Dict[str, float]] = {}
# span-plane bridge (obs/trace.py), resolved lazily once
_obs_trace = None
# per-name stacks so a re-entrant start(name) nests instead of overwriting
_open: Dict[str, list] = {}
# one global LIFO of (name, record_function): profiler ranges must close in
# strict nesting order
_ann_stack: list = []


def _sync_devices() -> None:
    """Wait for the work queued on the current CUDA device (no-op without
    a GPU)."""
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    except Exception:
        pass


def _trace_level() -> int:
    return envflags.env_int("HYDRAGNN_TRACE_LEVEL", 0)


def initialize() -> None:
    """(reference: tracer.py:35-60 registers GPTL/Score-P if importable)"""
    reset()


def reset() -> None:
    _regions.clear()
    _open.clear()
    while _ann_stack:
        _, ann = _ann_stack.pop()
        try:
            ann.__exit__(None, None, None)
        except Exception:
            pass


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def start(name: str, sync: Optional[bool] = None) -> None:
    """Open a region (reference: tracer.py:106-116)."""
    if not _enabled:
        return
    if sync is None:
        sync = _trace_level() > 0
    if sync:
        _sync_devices()
    try:
        import torch

        ann = torch.profiler.record_function(name)
        ann.__enter__()
        _ann_stack.append((name, ann))
    except Exception:
        pass
    _open.setdefault(name, []).append(time.perf_counter())


def stop(name: str, sync: Optional[bool] = None) -> None:
    """Close a region and accumulate (reference: tracer.py:118-127)."""
    if not _enabled or not _open.get(name):
        return
    if sync is None:
        sync = _trace_level() > 0
    if sync:
        _sync_devices()
    starts = _open[name]
    dt = time.perf_counter() - starts.pop()
    if not starts:
        del _open[name]
    # unwind the profiler ranges in strict LIFO order: an out-of-nesting
    # stop closes the inner (still-open) ranges early
    if any(n == name for n, _ in _ann_stack):
        while _ann_stack:
            top_name, ann = _ann_stack.pop()
            try:
                ann.__exit__(None, None, None)
            except Exception:
                pass
            if top_name == name:
                break
    rec = _regions.setdefault(
        name, {"count": 0.0, "total": 0.0, "min": float("inf"), "max": 0.0}
    )
    rec["count"] += 1
    rec["total"] += dt
    rec["min"] = min(rec["min"], dt)
    rec["max"] = max(rec["max"], dt)
    _note_span(name, dt)


def _note_span(name: str, dt: float) -> None:
    """Forward a closed region to the span plane (a no-op without an
    active tracer and an open span)."""
    global _obs_trace
    if _obs_trace is None:
        try:
            from ..obs import trace as _t

            _obs_trace = _t
        except Exception:
            _obs_trace = False
            return
    if _obs_trace is False:
        return
    try:
        _obs_trace.note_region(name, dt)
    except Exception:
        pass  # tracing must never fail the timed code


@contextlib.contextmanager
def timer(name: str, sync: Optional[bool] = None):
    """(reference: tracer.py:158-167)"""
    start(name, sync)
    try:
        yield
    finally:
        stop(name, sync)


def profile(name: str):
    """Decorator opening a region around the call (reference: tracer.py:145-155)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with timer(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


def get_regions() -> Dict[str, Dict[str, float]]:
    return {k: dict(v) for k, v in _regions.items()}


def print_report(prefix: str = "") -> None:
    """Per-process region dump (the GPTL ``pr_file`` analog,
    reference: examples/multibranch/train.py:507-514)."""
    if not _regions:
        return
    width = max(len(k) for k in _regions)
    print(f"{prefix}{'region'.ljust(width)}  count     total(s)    avg(s)      max(s)")
    for name, r in sorted(_regions.items()):
        avg = r["total"] / max(r["count"], 1)
        print(
            f"{prefix}{name.ljust(width)}  {int(r['count']):<8d}"
            f"  {r['total']:<10.4f}  {avg:<10.4f}  {r['max']:<10.4f}"
        )


def save_report(path: str) -> None:
    import json

    with open(path, "w") as f:
        json.dump(get_regions(), f, indent=2)
