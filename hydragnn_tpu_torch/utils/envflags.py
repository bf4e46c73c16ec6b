"""The parse boundary for the ``HYDRAGNN_*`` environment flags the port reads.

Counterpart of ``hydragnn_tpu/utils/envflags.py`` (the port keeps its own
copy: it imports nothing of the JAX package). The flags read today:
``HYDRAGNN_CKPT_RETRIES`` / ``HYDRAGNN_CKPT_RETRY_BASE`` and
``HYDRAGNN_EPOCH`` (train/checkpoint.py), ``HYDRAGNN_VALTEST``,
``HYDRAGNN_MAX_NUM_BATCH``, ``HYDRAGNN_STEP_GUARD`` and
``HYDRAGNN_DUMP_TESTDATA`` (train/loop.py); ``HYDRAGNN_TELEMETRY``,
``HYDRAGNN_NUMERICS``, ``HYDRAGNN_FLEET`` and ``HYDRAGNN_TRIAL_ID``
(obs/telemetry.py); ``HYDRAGNN_TRACE_LEVEL`` (utils/tracer.py);
``HYDRAGNN_DEVICE_PREFETCH`` (train/loop.py), ``HYDRAGNN_NUM_WORKERS``
(api.py), ``HYDRAGNN_NATIVE_NEIGHBORS`` (data/neighbors.py) and
``HYDRAGNN_DDSTORE_*`` (data/ddstore.py).

- ``env_flag``: tri-state on/off: None unset, else False for ``0``/``off``/
  ``false``/empty (any case) and True otherwise;
- ``env_force``: tri-state force/deny: None unset, True for exactly
  ``1``, False for anything else;
- ``env_int`` / ``env_float``: a number with a default; a malformed value
  warns and falls back instead of crashing the run;
- ``env_str``: the raw string; ``env_set``: whether the flag is present.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

_FALSY = ("0", "off", "false", "")


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    return os.environ.get(name, default)


def env_set(name: str) -> bool:
    return env_str(name) is not None


def env_flag(name: str) -> Optional[bool]:
    v = env_str(name)
    if v is None:
        return None
    return v.strip().lower() not in _FALSY


def env_force(name: str) -> Optional[bool]:
    v = env_str(name)
    if v is None:
        return None
    return v == "1"


def env_int(name: str, default: int) -> int:
    v = env_str(name)
    if v is None:
        return default
    try:
        return int(v)
    except ValueError:
        warnings.warn(f"{name}={v!r} is not an integer; using the default {default!r} instead",
                      RuntimeWarning, stacklevel=2)
        return default


def env_float(name: str, default: float) -> float:
    v = env_str(name)
    if v is None:
        return default
    try:
        return float(v)
    except ValueError:
        warnings.warn(f"{name}={v!r} is not a number; using the default {default!r} instead",
                      RuntimeWarning, stacklevel=2)
        return default
