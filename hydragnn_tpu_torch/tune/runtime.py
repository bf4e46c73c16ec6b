"""Process-global tuned-table runtime: what the kernel wrappers ask.

Counterpart of ``hydragnn_tpu/tune/runtime.py``. The kernel wrappers
(``ops/sorted_segment.py``, ``ops/fused_edge.py``, ``ops/multi_agg.py``,
``ops/flash_attention.py``) cannot see the config, so the entry points
*install* the resolved tuned table here (``train_validate_test``,
``run_prediction``, the ``python -m hydragnn_tpu_torch.tune`` CLI), and
every launch asks :func:`tile_plan` for its launch constants:

    tuned-table entry for (kernel + version, device kind, dtype, shapes)
        -> the swept winner
    no entry / no table / autotune off
        -> the defaults, normalized — today's launch

Either way the choice is emitted once per (key, source) as an
``EV_TILE_PLAN`` event and counted in
``hydragnn_tune_lookups_total{kernel,source}``. A launch asks once per
shape: the answer is kept per (kernel, dtype, shapes) until the next
``install``, so a lookup costs a dict read. ``forced`` pins one kernel's
plan for a block (the sweep's candidates).
"""

from __future__ import annotations

import contextlib
import json
import threading
from typing import Any, Dict, Optional, Tuple

from . import plans
from .table import TunedTable, device_kind

MODES = ("off", "cached", "sweep")

_lock = threading.Lock()
_active: Optional[TunedTable] = None
_mode: str = "off"
# (kernel, dtype, shape items, source) already announced — dedups the
# choice event and counter across lookups of the same specialization
_announced: set = set()
# (kernel, dtype, shape items) -> the plan a launch takes, until install()
_plans: Dict[Tuple, Dict[str, int]] = {}
# kernel -> the plan ``forced`` pins
_forced: Dict[str, Dict[str, int]] = {}


def install(table: Optional[TunedTable], mode: str = "cached") -> None:
    """Make ``table`` the process-wide tuned table (None deactivates).
    Last install wins — one live run per process."""
    global _active, _mode
    if mode not in MODES:
        raise ValueError(f"autotune mode {mode!r} must be one of {MODES}")
    with _lock:
        _active = table if mode != "off" else None
        _mode = mode
        _announced.clear()
        _plans.clear()
    if table is not None and mode != "off":
        _entries_gauge().set(float(table.size()))


def deactivate() -> None:
    install(None, "off")


def active() -> Optional[TunedTable]:
    return _active


def mode() -> str:
    return _mode


@contextlib.contextmanager
def forced(kernel: str, plan: Dict[str, int]):
    """Every launch of ``kernel`` in the block takes ``plan`` (normalized
    per call), whatever the table holds: the sweep's candidates."""
    with _lock:
        _forced[kernel] = dict(plan)
    try:
        yield
    finally:
        with _lock:
            _forced.pop(kernel, None)


def _entries_gauge():
    from ..obs.registry import registry

    return registry().gauge(
        "hydragnn_tune_table_entries",
        "Tuned-table entries on disk for the installed table",
    )


def _lookup_counter():
    from ..obs.registry import registry

    return registry().counter(
        "hydragnn_tune_lookups_total",
        "Tile-plan lookups by kernel and winning source "
        "(tuned = table entry, default = the defaults)",
        labelnames=("kernel", "source"),
    )


def tile_plan(kernel: str, shapes: Dict[str, Any], dtype: Any = "float32") -> Dict[str, int]:
    """The launch constants this kernel call should run with.

    ``shapes`` is the kernel's shape signature — every static fact that
    distinguishes tuned entries (pad-spec sizes, channel widths, operand
    census; tune/plans.py ``normalize``) — and doubles as the
    normalization input. ``dtype`` is the operand dtype (its own table
    axis: bf16 plans do not transfer to f32).

    Always returns a normalized plan; never raises on table trouble (a
    corrupt entry warns inside TunedTable and falls through to the
    defaults)."""
    dt = str(dtype).replace("torch.", "")
    pinned = _forced.get(kernel)
    if pinned is not None:
        return plans.normalize(kernel, pinned, {**shapes, "dtype": dt})
    memo_key = (kernel, dt, tuple(sorted(shapes.items())))
    plan = _plans.get(memo_key)
    if plan is not None:
        return plan
    spec = plans.KERNELS[kernel]
    table = _active
    tuned: Optional[Dict[str, int]] = None
    if table is not None:
        tuned = table.lookup(kernel, spec.version, device_kind(), dt, _shape_key(shapes))
    source = "tuned" if tuned else "default"
    plan = plans.normalize(kernel, tuned or spec.defaults, {**shapes, "dtype": dt})
    with _lock:
        _plans[memo_key] = plan
    _announce(kernel, dt, shapes, plan, source)
    return plan


def _shape_key(shapes: Dict[str, Any]) -> Dict[str, Any]:
    """The table-key view of a shape signature: scalars only, canonical
    types (bools stay bools, numbers become ints, anything else strs)."""
    out: Dict[str, Any] = {}
    for k, v in shapes.items():
        if isinstance(v, bool):
            out[k] = v
        elif isinstance(v, (int, float)):
            out[k] = int(v)
        else:
            out[k] = str(v)
    return out


def setup_autotune(config: Dict[str, Any], loader=None,
                   log_name: Optional[str] = None) -> Optional[str]:
    """Resolve and install the run's tuned table per ``Training.autotune``
    — the entry-point hook training and prediction call before the first
    launch, so every kernel's ``tile_plan`` lookup sees it.

    ``off`` deactivates (the defaults, no lookups); ``cached`` installs the
    resolved table read-only (missing entries fall back to the defaults);
    ``sweep`` first fills missing entries for the config's ladder slots
    (budget-capped, ``loader.ladder`` supplies the pad levels) and then
    installs. Returns the active table directory, or None."""
    import warnings

    from .table import resolve_tune_cache

    training = config["NeuralNetwork"]["Training"]
    autotune = str(training.get("autotune", "cached"))
    if autotune == "off":
        deactivate()
        return None
    cache_dir = resolve_tune_cache(training, log_name)
    if not cache_dir:
        deactivate()
        return None
    table = TunedTable(cache_dir)
    if autotune == "sweep":
        from .sweep import config_slots, sweep_slots

        ladder = getattr(loader, "ladder", None)
        slots = config_slots(config, ladder) if ladder is not None else []
        if slots:
            try:
                sweep_slots(slots, table, budget=int(training.get("autotune_budget") or 0))
            except Exception as e:
                warnings.warn(
                    f"autotune sweep failed ({e}); continuing with the existing tuned table",
                    RuntimeWarning,
                    stacklevel=2,
                )
    install(table, autotune)
    return cache_dir


def _announce(kernel: str, dtype: str, shapes: Dict[str, Any],
              plan: Dict[str, int], source: str) -> None:
    sig: Tuple = (kernel, dtype, tuple(sorted(_shape_key(shapes).items())), source)
    with _lock:
        if sig in _announced:
            return
        _announced.add(sig)
    try:
        from ..obs.events import EV_TILE_PLAN, emit

        emit(
            EV_TILE_PLAN,
            kernel=kernel,
            source=source,
            mode=_mode,
            device=device_kind(),
            dtype=dtype,
            plan=json.dumps(plan, sort_keys=True),
            shape=json.dumps(_shape_key(shapes), sort_keys=True),
        )
        _lookup_counter().inc(kernel=kernel, source=source)
    except Exception:
        pass  # the choice reporter must never fail the kernel call
