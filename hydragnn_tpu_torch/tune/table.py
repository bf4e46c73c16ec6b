"""The tuned-table cache: content-addressed, disk-persistent sweep winners.

Counterpart of ``hydragnn_tpu/tune/table.py``. One JSON file per tuned
entry, named by the sha256 of its canonical key — ``(kernel id, kernel
version, device kind, dtype, normalized shape signature)`` — in a
directory that lives next to the compile cache (default
``./logs/<run>/tuned_table``; ``Training.autotune_cache_dir`` redirects,
``HYDRAGNN_TUNE_CACHE`` env always wins, same grammar as the compile
cache's resolution in train/compile_plane.py).

Invalidation is entirely in the key: an edited kernel source changes its
``KERNEL_VERSION`` (the source's sha256, tune/plans.py), another card
reports another ``device_kind``, a dtype or pad-spec change reshapes the
signature — each lands on a different sha256, so stale entries simply
never match (they are inert files, not wrong answers).

Durability: tmp file in the same directory, fsync, ``os.replace``.
Concurrent sweepers racing on one entry both publish a complete file and
the last replace wins — readers never observe a torn entry. A corrupt or
schema-incompatible file degrades to "no entry" with a warning (the
caller falls back to pinned defaults), never an exception: the tuned
table is an accelerant, not a dependency.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import warnings
from typing import Any, Dict, Optional

from ..utils import envflags

# bump when the entry file layout changes incompatibly — old files then
# fail validation and read as "no entry" instead of misparsing
TABLE_SCHEMA_VERSION = 1


_DEVICE_KIND: Optional[str] = None


def device_kind() -> str:
    """The tuned-table device axis: ``torch.cuda.get_device_name()`` ("NVIDIA
    H100 80GB HBM3", ...), or "cpu" without a card. CPU sweeps (the plain
    versions) key under "cpu" and are therefore invisible to a card's run
    by construction — timings never transfer across device kinds. Read
    once per process."""
    global _DEVICE_KIND
    if _DEVICE_KIND is None:
        import torch

        try:
            _DEVICE_KIND = (str(torch.cuda.get_device_name()) if torch.cuda.is_available()
                            else "cpu")
        except Exception:
            _DEVICE_KIND = "unknown"
    return _DEVICE_KIND


def entry_key(
    kernel: str,
    version: Any,
    device: str,
    dtype: str,
    shape: Dict[str, Any],
) -> str:
    """sha256 of the canonical JSON of the key fields — the entry's
    filename stem. ``shape`` is the kernel's normalized shape signature
    (tune/plans.py ``normalize`` inputs: pad-spec sizes, channel widths,
    operand census), canonicalized by sorted keys."""
    payload = json.dumps(
        {
            "schema": TABLE_SCHEMA_VERSION,
            "kernel": str(kernel),
            "version": str(version),
            "device": str(device),
            "dtype": str(dtype),
            "shape": {str(k): shape[k] for k in sorted(shape)},
        },
        sort_keys=True,
        separators=(",", ":"),
    )
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()


def resolve_tune_cache(
    training: Dict[str, Any], log_name: Optional[str] = None
) -> Optional[str]:
    """Resolve the tuned-table directory, mirroring the compile cache's
    grammar (train/compile_plane.py ``setup_compile_cache``):
    ``HYDRAGNN_TUNE_CACHE`` env (``0``/``off``/``none`` disables, ``1``
    forces the config/default resolution back on, a path overrides), then
    ``Training.autotune_cache_dir`` (``false`` disables, a path
    overrides), else ``./logs/<run>/tuned_table`` next to the compile
    cache. Returns the directory, or None when disabled."""
    env = envflags.env_str("HYDRAGNN_TUNE_CACHE")
    cfg = training.get("autotune_cache_dir")
    if env is not None:
        s = env.strip()
        if s.lower() in ("0", "off", "none", "false", ""):
            return None
        if s != "1":
            cfg = s  # an explicit path beats the config
        elif cfg is False or (
            isinstance(cfg, str) and cfg.strip().lower() in ("off", "none")
        ):
            cfg = None  # "1": force-on with the config/default resolution
    if cfg is False or (
        isinstance(cfg, str) and cfg.strip().lower() in ("off", "none")
    ):
        return None
    if isinstance(cfg, str) and cfg:
        return cfg
    return os.path.join("./logs", log_name or "run", "tuned_table")


class TunedTable:
    """Reader/writer over one tuned-table directory, with an in-process
    memo so the routing layer's trace-time lookups are dict reads after
    the first touch of each key."""

    def __init__(self, cache_dir: str):
        self.cache_dir = str(cache_dir)
        self._lock = threading.Lock()
        # memo maps key -> plan dict or None (known miss); store() updates
        # it so a sweep's own process sees its writes without re-reading
        self._memo: Dict[str, Optional[Dict[str, int]]] = {}

    def _path(self, key: str) -> str:
        return os.path.join(self.cache_dir, key + ".json")

    # -- read ---------------------------------------------------------------

    def lookup(
        self,
        kernel: str,
        version: Any,
        device: str,
        dtype: str,
        shape: Dict[str, Any],
    ) -> Optional[Dict[str, int]]:
        """The tuned plan for this key, or None (missing OR unreadable —
        a corrupt entry warns once and reads as absent; the caller's
        pinned-defaults fallback is always available)."""
        key = entry_key(kernel, version, device, dtype, shape)
        with self._lock:
            if key in self._memo:
                plan = self._memo[key]
                return dict(plan) if plan else None
        plan = self._read(key, kernel)
        with self._lock:
            self._memo[key] = dict(plan) if plan else None
        return plan

    def _read(self, key: str, kernel: str) -> Optional[Dict[str, int]]:
        path = self._path(key)
        try:
            with open(path, "r") as fh:
                entry = json.load(fh)
        except FileNotFoundError:
            return None
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            warnings.warn(
                f"tuned-table entry {path} is unreadable ({e}); falling "
                f"back to pinned defaults for kernel {kernel!r} — re-run "
                "`python -m hydragnn_tpu_torch.tune` to repair it",
                RuntimeWarning,
                stacklevel=3,
            )
            return None
        plan = self._validate(entry, key)
        if plan is None:
            warnings.warn(
                f"tuned-table entry {path} failed validation; falling back "
                f"to pinned defaults for kernel {kernel!r} — re-run "
                "`python -m hydragnn_tpu_torch.tune` to repair it",
                RuntimeWarning,
                stacklevel=3,
            )
        return plan

    @staticmethod
    def _validate(entry: Any, key: str) -> Optional[Dict[str, int]]:
        """Schema + self-consistency check: the entry must re-derive its
        own filename key from its recorded key fields (a renamed or
        hand-edited file whose fields drifted reads as absent) and carry
        an all-int plan."""
        if not isinstance(entry, dict):
            return None
        if entry.get("schema") != TABLE_SCHEMA_VERSION:
            return None
        fields = entry.get("key_fields")
        plan = entry.get("plan")
        if not isinstance(fields, dict) or not isinstance(plan, dict):
            return None
        try:
            rederived = entry_key(
                fields["kernel"], fields["version"], fields["device"],
                fields["dtype"], fields["shape"],
            )
        except (KeyError, TypeError):
            return None
        if rederived != key:
            return None
        try:
            return {str(k): int(v) for k, v in plan.items()}
        except (TypeError, ValueError):
            return None

    # -- write --------------------------------------------------------------

    def store(
        self,
        kernel: str,
        version: Any,
        device: str,
        dtype: str,
        shape: Dict[str, Any],
        plan: Dict[str, int],
        measured_us: Optional[float] = None,
        meta: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Publish one tuned entry atomically (tmp + fsync + replace —
        the blessed torn-state-free pattern; concurrent writers both
        publish whole files, last replace wins). Returns the entry path."""
        key = entry_key(kernel, version, device, dtype, shape)
        entry = {
            "schema": TABLE_SCHEMA_VERSION,
            "key_fields": {
                "kernel": str(kernel),
                "version": str(version),
                "device": str(device),
                "dtype": str(dtype),
                "shape": {str(k): shape[k] for k in sorted(shape)},
            },
            "plan": {str(k): int(v) for k, v in plan.items()},
        }
        if measured_us is not None:
            entry["measured_us"] = float(measured_us)
        if meta:
            entry["meta"] = meta
        path = self._path(key)
        os.makedirs(self.cache_dir, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "w") as fh:
                json.dump(entry, fh, sort_keys=True, indent=1)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
        with self._lock:
            self._memo[key] = {str(k): int(v) for k, v in plan.items()}
        return path

    # -- census -------------------------------------------------------------

    def size(self) -> int:
        """Number of entry files on disk (readable or not)."""
        try:
            return sum(
                1 for f in os.listdir(self.cache_dir)
                if f.endswith(".json")
            )
        except OSError:
            return 0

    def has(self, kernel: str, version: Any, device: str, dtype: str,
            shape: Dict[str, Any]) -> bool:
        return self.lookup(kernel, version, device, dtype, shape) is not None
