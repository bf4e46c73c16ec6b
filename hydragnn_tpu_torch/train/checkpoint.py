"""Model and optimizer checkpoints: atomic, verified, fault-tolerant.

Counterpart of ``hydragnn_tpu/train/checkpoint.py`` on one host, with its
protocol and its layout: ``<path>/<log_name>/<log_name>[_epoch<N>].pt``,
each beside a ``.sha256`` sidecar, and a ``latest`` pointer. The payload is
``torch.save`` of ``TrainState.to_payload()``, a dict of CPU tensors and
plain values (the model's and the optimizer's state dicts, the counters,
the learning rate), read back with ``torch.load(..., weights_only=True)``:
a checkpoint written on the card restores on the CPU and the other way
round. The file is not msgpack; the suffix says so.

A process may die at any instruction, and a file system may throw
transient IO errors or rot bytes at rest. The protocol:

- every file (payload, sidecar, pointer) is written tmp file -> fsync ->
  ``os.replace`` -> directory fsync, so a reader sees the old version or
  the new one, never a prefix;
- the ``latest`` pointer is written last and commits the save: a process
  killed inside a save leaves ``latest`` on the previous checkpoint;
- a sha256 sidecar is written with every payload; a restore checks it and
  walks back through older epoch files on a mismatch;
- transient ``OSError``s retry with exponential backoff
  (``HYDRAGNN_CKPT_RETRIES`` attempts, first delay
  ``HYDRAGNN_CKPT_RETRY_BASE`` seconds);
- ``retention`` > 0 prunes the per-epoch chain to its newest files after a
  committed save.

Over several ranks (``parallel/engine.py``) every rank gathers the whole
state (``TrainState.to_payload`` is a collective), rank 0 alone writes the
same file chain, and every rank waits at a barrier until it is written;
every rank restores, each placing its part. Not in this slice: the orbax
backend (per-rank sharded checkpoint files, with the elastic and
robustness slice; an ``orbax/<step>`` pointer is walked past), the mixture
snapshot (it goes with the mixture plane), and the fault-injection kill
points and duration telemetry of the JAX package.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import time
import warnings
from typing import Iterator, List, Optional, Tuple

import torch

from ..utils import envflags
from ..utils.ranks import barrier as _barrier
from ..utils.ranks import is_primary as _primary
from .state import InferenceState, LoaderState, TrainState

SUFFIX = ".pt"
_EPOCH_RE = re.compile(r"_epoch(\d+)\.pt$")
_LOADER_STATE_FILE = "loader_state.json"


def _run_dir(log_name: str, path: str = "./logs") -> str:
    d = os.path.join(path, log_name)
    os.makedirs(d, exist_ok=True)
    return d


def _retry_plan() -> List[float]:
    """Backoff schedule for transient IO errors: attempt i sleeps
    base * 2^i before the next (base 0: no sleeping)."""
    attempts = max(envflags.env_int("HYDRAGNN_CKPT_RETRIES", 4), 1)
    base = envflags.env_float("HYDRAGNN_CKPT_RETRY_BASE", 0.25)
    return [base * (2.0**i) for i in range(attempts)]


def _fsync_replace(path: str, data: bytes) -> None:
    """One atomic publish: tmp file + fsync + os.replace + directory fsync."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
    # fsync the directory so the rename itself survives a power loss
    try:
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # some file systems refuse a directory fsync; the replace stands


def atomic_write(path: str, data: bytes) -> None:
    """``_fsync_replace`` with exponential-backoff retries on transient
    ``OSError``s; the last failure propagates."""
    plan = _retry_plan()
    for i, delay in enumerate(plan):
        try:
            return _fsync_replace(path, data)
        except OSError:
            if i == len(plan) - 1:
                raise
            if delay > 0:
                time.sleep(delay)


def _sha256_path(fname: str) -> str:
    return fname + ".sha256"


def _epoch_from_env() -> Optional[int]:
    """``HYDRAGNN_EPOCH``; a malformed value warns and saves under the
    unsuffixed name rather than fail the save."""
    env = envflags.env_str("HYDRAGNN_EPOCH")
    if env is None:
        return None
    try:
        return int(env)
    except ValueError:
        warnings.warn(
            f"HYDRAGNN_EPOCH={env!r} is not an integer; saving without an "
            "epoch suffix instead of failing the checkpoint",
            stacklevel=3,
        )
        return None


def _prune_retention(d: str, log_name: str, retention: int) -> None:
    """Keep only the newest ``retention`` per-epoch payloads (and their
    sidecars); 0 or less keeps everything. The unsuffixed file is never
    pruned."""
    if retention <= 0:
        return
    epochs = []
    for fn in os.listdir(d):
        m = _EPOCH_RE.search(fn)
        if m and fn.startswith(log_name):
            epochs.append((int(m.group(1)), fn))
    for _, fn in sorted(epochs, reverse=True)[retention:]:
        for victim in (os.path.join(d, fn), _sha256_path(os.path.join(d, fn))):
            try:
                os.unlink(victim)
            except OSError:
                pass  # best effort: a leftover file is harmless


def _observe_duration(op: str, t0: float) -> None:
    """Publish one checkpoint write/restore duration into the registry, the
    span plane and the event log (obs/). Observability only: never allowed
    to fail a save or a restore."""
    dt = time.perf_counter() - t0
    try:
        from ..obs.registry import registry

        registry().histogram(
            "hydragnn_checkpoint_seconds",
            "Checkpoint write/restore wall time",
            labelnames=("op",),
        ).observe(dt, op=op)
    except Exception:
        pass
    try:
        # a span under the active tracer (nested in an open span, else its
        # own trace) and a write event for the flight-recorder window
        from ..obs import trace as _obs_trace
        from ..obs.events import EV_CKPT_WRITE
        from ..obs.events import emit as _emit_event

        _obs_trace.note_completed(f"train/checkpoint_{op}", dt, attributes={"op": op})
        if op == "write":
            _emit_event(EV_CKPT_WRITE, seconds=round(dt, 6))
    except Exception:
        pass


def save_model(state: TrainState, log_name: str, path: str = "./logs",
               epoch: Optional[int] = None, retention: int = 0) -> str:
    """Write ``state``'s checkpoint: payload -> sha256 sidecar -> ``latest``,
    each atomically; the pointer commits the save. The file is
    ``<log_name>_epoch<epoch>.pt`` (``epoch`` None: ``HYDRAGNN_EPOCH``,
    else the unsuffixed name). ``retention`` > 0 prunes older epoch files
    after the commit. Returns the payload's path. Over several ranks every
    rank calls it: each takes part in gathering the payload, rank 0 writes,
    and all return together."""
    if epoch is None:
        epoch = _epoch_from_env()
    suffix = f"_epoch{epoch}" if epoch is not None else ""
    payload = state.to_payload()
    fname = os.path.join(path, log_name, f"{log_name}{suffix}{SUFFIX}")
    if not _primary():
        _barrier()
        return fname
    t0 = time.perf_counter()
    try:
        _write_payload(payload, fname, log_name, path, retention)
    finally:
        _barrier()
    _observe_duration("write", t0)
    return fname


def _write_payload(payload, fname: str, log_name: str, path: str, retention: int) -> None:
    d = _run_dir(log_name, path)
    buf = io.BytesIO()
    torch.save(payload, buf)
    blob = buf.getvalue()
    # a resave of the same name: drop the old sidecar first, so a process
    # killed between the payload replace and the new sidecar leaves a
    # complete payload without a sidecar (restored, with a warning), never
    # a new payload beside the old digest (rejected as corrupt)
    try:
        os.unlink(_sha256_path(fname))
    except FileNotFoundError:
        pass
    atomic_write(fname, blob)
    atomic_write(_sha256_path(fname), hashlib.sha256(blob).hexdigest().encode("ascii"))
    atomic_write(os.path.join(d, "latest"), os.path.basename(fname).encode("utf-8"))
    _prune_retention(d, log_name, retention)


def save_loader_state(state: LoaderState, log_name: str, path: str = "./logs") -> str:
    """Publish the loader-position sidecar (``loader_state.json``) beside
    the checkpoint, atomically. The training loop writes it after the model
    save of a mid-epoch preemption stop, and every other save clears it
    (``clear_loader_state``), so a present sidecar describes the committed
    checkpoint. Rank 0 writes it."""
    fname = os.path.join(path, log_name, _LOADER_STATE_FILE)
    if _primary():
        _run_dir(log_name, path)
        atomic_write(fname, json.dumps(state.to_dict()).encode("utf-8"))
    return fname


def load_loader_state(log_name: str, path: str = "./logs") -> Optional[LoaderState]:
    """The loader-position sidecar of a run, or None when the run stopped
    at an epoch boundary. A malformed sidecar warns and resumes at epoch
    granularity: it must never block the model restore."""
    fname = os.path.join(path, log_name, _LOADER_STATE_FILE)
    if not os.path.exists(fname):
        return None
    try:
        with open(fname, encoding="utf-8") as f:
            return LoaderState.from_dict(json.load(f))
    except (OSError, ValueError, KeyError, TypeError) as e:
        warnings.warn(
            f"loader-state sidecar {fname} is unreadable ({e}); resuming at "
            "epoch granularity instead of mid-epoch",
            stacklevel=2,
        )
        return None


def clear_loader_state(log_name: str, path: str = "./logs") -> None:
    """Remove the loader-position sidecar (a later save makes its cursor
    stale). A missing file is fine. Rank 0 removes it."""
    if not _primary():
        return
    try:
        os.unlink(os.path.join(path, log_name, _LOADER_STATE_FILE))
    except OSError:
        pass


def _verified_read(full: str, tried: List[str]) -> Optional[bytes]:
    """A payload's bytes checked against its sha256 sidecar, or None (the
    reason appended to ``tried``)."""
    base = os.path.basename(full)
    try:
        with open(full, "rb") as f:
            blob = f.read()
    except OSError as e:
        tried.append(f"{base}: unreadable ({e})")
        return None
    side = _sha256_path(full)
    if os.path.exists(side):
        try:
            with open(side) as f:
                want = f.read().strip()
        except OSError as e:
            tried.append(f"{base}: sidecar unreadable ({e})")
            return None
        got = hashlib.sha256(blob).hexdigest()
        if got != want:
            tried.append(
                f"{base}: sha256 mismatch (file {got[:12]}… != sidecar "
                f"{want[:12]}… — torn or bit-rotted; falling back)"
            )
            return None
    else:
        # a save killed between the payload and its digest: the atomic
        # replace means the payload is complete; accept it, and say so
        warnings.warn(f"checkpoint {base} has no sha256 sidecar; restoring unverified",
                      stacklevel=4)
    return blob


def _payload_candidates(d: str, entry: Optional[str]) -> List[str]:
    """Restore order: the ``latest`` entry first, then every other payload
    in the run directory, newest epoch first, the unsuffixed file last."""
    out = []
    if entry and not entry.startswith("orbax/"):
        out.append(entry)
    epochs, plain = [], []
    for fn in os.listdir(d):
        if not fn.endswith(SUFFIX) or fn in out:
            continue
        m = _EPOCH_RE.search(fn)
        (epochs if m else plain).append((int(m.group(1)) if m else -1, fn))
    out.extend(fn for _, fn in sorted(epochs, reverse=True))
    out.extend(fn for _, fn in sorted(plain))
    return out


def has_checkpoint(log_name: str, path: str = "./logs") -> bool:
    """Whether the run directory holds any payload file, verified or not
    (a restore from a directory that does may still find no good copy)."""
    d = os.path.join(path, log_name)
    return os.path.isdir(d) and any(fn.endswith(SUFFIX) for fn in os.listdir(d))


def latest_checkpoint_entry(log_name: str, path: str = "./logs") -> Optional[str]:
    """The content of a run's ``latest`` pointer (e.g. ``run_epoch3.pt``),
    or None when it is missing or unreadable."""
    try:
        with open(os.path.join(path, log_name, "latest")) as f:
            return f.read().strip() or None
    except OSError:
        return None


def _resolve_restore_dir(log_name: str, path: str, tried: List[str]):
    """The run directory (it must exist) and the ``latest`` entry (a
    missing pointer recorded in ``tried``, the default name tried)."""
    d = os.path.join(path, log_name)
    if not os.path.isdir(d):
        raise FileNotFoundError(
            f"no checkpoint for run {log_name!r}: directory {d!r} does not "
            f"exist (searched under path={path!r}). Was the run saved with "
            "a different log name or Training.startfrom?"
        )
    latest = os.path.join(d, "latest")
    entry: Optional[str] = None
    if os.path.exists(latest):
        try:
            with open(latest) as f:
                entry = f.read().strip()
        except OSError as e:
            tried.append(f"latest: unreadable ({e})")
    else:
        entry = f"{log_name}{SUFFIX}"
        tried.append(f"latest: missing (trying the default {SUFFIX} name)")
    if entry and entry.startswith("orbax/"):
        tried.append(f"{entry}: the orbax backend comes with the port's sharded-checkpoint slice")
    return d, entry


def _read_payload(blob: bytes):
    return torch.load(io.BytesIO(blob), map_location="cpu", weights_only=True)


def _verified_payloads(d: str, entry: Optional[str],
                       tried: List[str]) -> Iterator[Tuple[str, dict]]:
    """``(file name, payload)`` of every candidate whose bytes verify and
    load, newest first: the walk-back chain of every restore."""
    for fn in _payload_candidates(d, entry):
        full = os.path.join(d, fn)
        if not os.path.exists(full):
            tried.append(f"{fn}: missing")
            continue
        blob = _verified_read(full, tried)
        if blob is None:
            continue
        try:
            payload = _read_payload(blob)
        except Exception as e:  # noqa: BLE001 — a truncated or foreign file
            tried.append(f"{fn}: deserialization failed ({e})")
            continue
        yield fn, payload


def _raise_no_checkpoint(log_name: str, d: str, tried: List[str]):
    try:
        files = sorted(os.listdir(d))
    except OSError:
        files = ["<unlistable>"]
    raise FileNotFoundError(
        f"no loadable checkpoint for run {log_name!r} in {d!r}.\n"
        f"  files present: {files}\n"
        f"  candidates tried: {tried or ['<none>']}\n"
        "Each candidate above was rejected for the stated reason; a sha256 "
        "mismatch means the file is corrupt — delete it to silence the "
        "fallback, or restore an older epoch by editing 'latest'."
    )


def _restore(template, log_name: str, path: str, tried: List[str]):
    """Load the newest verified candidate into ``template`` (a
    ``TrainState`` or an ``InferenceState``); ``(state, file name)``."""
    t0 = time.perf_counter()
    d, entry = _resolve_restore_dir(log_name, path, tried)
    for fn, payload in _verified_payloads(d, entry, tried):
        try:
            state = template.load_payload(payload)
        except (ValueError, KeyError, RuntimeError) as e:  # structure drift
            tried.append(f"{fn}: does not fit this model ({e})")
            continue
        _observe_duration("restore", t0)
        return state, fn
    _raise_no_checkpoint(log_name, d, tried)


def load_inference_state(template: InferenceState, log_name: str,
                         path: str = "./logs") -> Tuple[InferenceState, str]:
    """Restore only the model tensors (parameters and batch-norm buffers)
    and the step of a run's newest verified checkpoint into ``template``'s
    model, walking back past corrupt files as ``load_existing_model`` does.
    Returns ``(state, the file restored)``: it may be older than ``latest``
    names."""
    return _restore(template, log_name, path, [])


def load_inference_entry(template: InferenceState, log_name: str, entry: str,
                         path: str = "./logs") -> InferenceState:
    """Restore one named, verified payload; no walk-back. Raises
    ``FileNotFoundError`` when it is missing and ``ValueError`` when it
    fails verification or does not load into ``template``."""
    tried: List[str] = []
    full = os.path.join(path, log_name, entry)
    if not os.path.exists(full):
        raise FileNotFoundError(
            f"checkpoint entry {entry!r} of run {log_name!r} does not exist at {full!r}")
    blob = _verified_read(full, tried)
    if blob is None:
        raise ValueError(f"checkpoint entry {entry!r} failed verification: {tried}")
    try:
        return template.load_payload(_read_payload(blob))
    except Exception as e:  # noqa: BLE001 — a truncated file or structure drift
        raise ValueError(
            f"checkpoint entry {entry!r} failed to deserialize: {type(e).__name__}: {e}")


def load_existing_model(template_state: TrainState, log_name: str, path: str = "./logs",
                        loaded_entry: Optional[List[str]] = None) -> TrainState:
    """Restore a run's newest verified checkpoint into ``template_state``
    in place (model, optimizer, counters, learning rate). Every candidate
    is checked against its sha256 sidecar; on corruption the walk falls
    back through older epochs, newest first. Pass a list as
    ``loaded_entry`` to receive the file restored. Total failure raises a
    ``FileNotFoundError`` listing the run directory's files and every
    candidate tried with the reason it was rejected. Over several ranks
    every rank calls it, after a barrier (rank 0's last save is then on
    disk), and places its part of the payload."""
    _barrier()
    state, fn = _restore(template_state, log_name, path, [])
    if loaded_entry is not None:
        loaded_entry.append(fn)
    return state
