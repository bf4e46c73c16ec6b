"""Device memory accounting (docs/OBSERVABILITY.md "Memory").

Counterpart of ``hydragnn_tpu/obs/memory.py`` on PyTorch's caching
allocator. ``device_memory_stats`` and ``device_bytes_limit`` read the
card (``torch.cuda.memory_stats`` / ``torch.cuda.mem_get_info``);
``record(label, stats)`` keeps a per-label table of memory figures,
publishes the ``hydragnn_hbm_*`` gauges per label, and the flight
recorder dumps the table with the live figures as the OOM-forensics
section of every black box (obs/flightrec.py).

The JAX module also harvests ``memory_analysis()`` of a compiled XLA
executable; the port compiles no executables, so that part has no
counterpart here. Everything is best-effort: without a GPU the figures
are empty and nothing raises.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

_LOCK = threading.Lock()
_TABLE: Dict[str, Dict[str, float]] = {}

# the gauge-published keys of a recorded entry (those it holds)
_GAUGE_KEYS = ("argument_bytes", "output_bytes", "temp_bytes", "peak_bytes")


def record(label: str, stats: Optional[Dict[str, float]] = None
           ) -> Optional[Dict[str, float]]:
    """Store ``stats`` (byte figures by key; ``peak_bytes`` at least) for
    one label and publish the ``hydragnn_hbm_*`` gauges of the keys it
    holds. With no ``stats``, the device's current peak allocation
    (``torch.cuda.max_memory_allocated``) as ``peak_bytes``; None without
    a GPU."""
    if stats is None:
        try:
            import torch

            if not torch.cuda.is_available():
                return None
            stats = {"peak_bytes": float(torch.cuda.max_memory_allocated())}
        except Exception:
            return None
    with _LOCK:
        _TABLE[label] = dict(stats)
    try:
        from .registry import registry

        reg = registry()
        for key in _GAUGE_KEYS:
            if key in stats:
                reg.gauge(
                    f"hydragnn_hbm_{key}",
                    f"Device memory {key.replace('_', ' ')} per recorded label",
                    labelnames=("spec",),
                ).set(float(stats[key]), spec=label)
    except Exception:
        pass  # the table is the source of truth; gauges are best-effort
    return stats


def snapshot() -> Dict[str, Dict[str, float]]:
    """The per-label table (what the flight recorder dumps)."""
    with _LOCK:
        return {k: dict(v) for k, v in _TABLE.items()}


def reset() -> None:
    """Drop the table (tests)."""
    with _LOCK:
        _TABLE.clear()


def device_memory_stats() -> Dict[str, Any]:
    """Peak bytes allocated per local CUDA device, best-effort (the flight
    recorder's 'what was resident at the moment of death'); empty without
    a GPU."""
    try:
        from ..utils.profile import peak_memory_stats

        return {str(k): float(v) for k, v in peak_memory_stats().items()}
    except Exception:
        return {}


def device_bytes_limit() -> Optional[float]:
    """The current CUDA device's capacity in bytes
    (``torch.cuda.mem_get_info``), or None without a GPU."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        return float(torch.cuda.mem_get_info()[1])
    except Exception:
        return None
