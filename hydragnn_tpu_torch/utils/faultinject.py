"""Deterministic fault injection for the fault-tolerance layer.

Counterpart of ``hydragnn_tpu/utils/faultinject.py``: the same
``HYDRAGNN_FAULT_*`` knobs, grammar, ``configure`` / ``reset`` and
``flip_bit``. The port wires the serving call sites (``GraphServer.submit``
and its step, the int8 install, the replica's /predict); the training,
checkpoint and data call sites come with the robustness slice (ROADMAP).

Every recovery path in train/ and checkpoint IO is exercised in CI through
the injection points below instead of being trusted: a NaN landing in the
gradients at a known step, a SIGKILL at a named point inside the checkpoint
writer, a bit flipped in a saved checkpoint, an IOError on the first n write
attempts (the flaky-parallel-FS model). All points are env/config driven and
deterministic — no time-based races, no random faults.

Injection points (env is the primary surface; ``configure`` mirrors it for
in-process tests):

- ``HYDRAGNN_FAULT_NAN_STEP``: poison the gradients with NaN inside the
  train step — ``"5"`` (exactly step 5), ``"5+"`` (every step >= 5),
  ``"3,7"`` (a list). The condition is computed on the step's own device,
  so a captured step needs no host read.
- ``HYDRAGNN_FAULT_NAN_LR_GT``: poison the gradients while the injected
  learning rate is above the threshold — the deterministic model of
  "diverged because the LR is too high", which the rollback policy's LR
  backoff genuinely recovers from. ANDed with NAN_STEP when both are set.
- ``HYDRAGNN_FAULT_KILL_AT``: comma-separated point names; ``maybe_kill``
  SIGKILLs the process when called with a listed name (checkpoint writer
  points: ``ckpt_tmp_written``, ``ckpt_msgpack_replaced``,
  ``ckpt_digest_written`` — see train/checkpoint.py).
- ``HYDRAGNN_FAULT_IO_ERRORS``: ``maybe_ioerror`` raises OSError on the
  first n calls per point name (per process), then succeeds — the transient
  flaky-FS model the checkpoint writer's retry loop must absorb.

Data-plane points (docs/ROBUSTNESS.md "Data plane"):

- ``HYDRAGNN_FAULT_SAMPLE_NAN``: ``poison_samples`` NaNs the first feature
  of the dataset samples at the listed indices (``"3"`` / ``"3,7"``) — the
  dirty-ingest model the sample validator must catch, with per-reason skip
  counts matching the injection plan exactly.
- ``HYDRAGNN_FAULT_CORRUPT_SAMPLE``: ``corrupt_blob`` flips the leading
  byte of the listed sample ids' serialized bytes on fetch, so
  deserialization fails deterministically (DistDataset's corrupt-sample
  error path).
- ``HYDRAGNN_FAULT_SOCKET_DROP``: ``maybe_socket_drop`` raises
  ConnectionError on the listed call numbers per point (``"2"`` = the 2nd
  call) — the transient-connection model RemoteStoreClient's
  reconnect/backoff loop must absorb with zero sample loss.
- ``HYDRAGNN_FAULT_LOADER_STALL`` (``"k"`` or ``"k:secs"``) /
  ``HYDRAGNN_FAULT_LOADER_DIE`` (``"k"``): ``maybe_loader_fault`` makes the
  prefetch producer sleep before batch k, or exit silently without its end
  sentinel — the wedged/dead-worker models the loader watchdog turns into
  an actionable LoaderStallError.

Serve-plane points (docs/SERVING.md "Failure model"):

- ``HYDRAGNN_FAULT_SERVE_REQ_NAN``: ``poison_request`` NaNs the first
  feature of the listed *submission indices* (``"3"`` / ``"3,7"``) right
  after the client hands the graph over — the corrupt-request model the
  admission gate must turn into a typed per-request error while the
  co-batched requests beside it succeed.
- ``HYDRAGNN_FAULT_SERVE_WEDGE`` (``"k"`` or ``"k:secs"``):
  ``maybe_serve_wedge`` sleeps inside the device-step runner before batch
  k's dispatch (default 60s — longer than any sane step watchdog) — the
  wedged-step model the serving watchdog must bound with a typed error and
  a recycled runner instead of hanging the server.
- ``HYDRAGNN_FAULT_SERVE_SLOW_CLIENT`` (``"i"`` or ``"i:secs"``):
  ``maybe_slow_client`` sleeps at the listed submissions' admission call —
  the slow-client model (admission must not be wedged by one caller; other
  threads keep being served).

Serving-fleet points (docs/SERVING.md "Fleet"): all three take a
``replica:...`` spec so ONE env set on the whole fleet arms exactly one
replica (the manager passes its environment through to every worker);
``replica`` is the worker's fleet index (HYDRAGNN_FLEET_HOST_INDEX).

- ``HYDRAGNN_FAULT_REPLICA_KILL`` (``"r:k"``, k in the ``_index_armed``
  grammar): ``maybe_replica_kill`` SIGKILLs replica r before serving its
  k-th /predict request — the dead-replica model: the router's retry must
  absorb the in-flight loss on a different replica and the ReplicaManager
  must restart the worker within its backoff bound.
- ``HYDRAGNN_FAULT_REPLICA_WEDGE`` (``"r:k[:secs]"``, default 30s):
  ``maybe_replica_wedge`` sleeps replica r's armed /predict requests
  before processing — the wedged-replica model that must open the
  router's circuit breaker, then reclose it via the half-open probe once
  the armed window passes.
- ``HYDRAGNN_FAULT_REPLICA_SLOW`` (``"r[:secs]"``, default 0.2s):
  ``maybe_replica_slow`` sleeps EVERY /predict on replica r — the
  slow-replica model the router's tail hedging must beat (duplicate to a
  fast replica past the hedge deadline, first answer wins).
- ``HYDRAGNN_FAULT_QUANT_DRIFT`` (``"<entry_substring>:<factor>"``, factor
  default 4.0; empty substring arms every entry): ``maybe_quant_drift``
  hands the serving quantizer (serve/quantize.py) a scale-distortion
  factor when the checkpoint entry being quantized matches — the
  drifted-candidate model the int8 accuracy gate must refuse with a typed
  ``quant_drift`` event while the prior weights keep serving.

Fleet-plane points (docs/OBSERVABILITY.md "Fleet"):

- ``HYDRAGNN_FAULT_STRAGGLE`` (``"k:secs"``, ``"k+:secs"``, or bare
  ``"k"``/``"k+"`` with a 0.05s default): ``maybe_straggle`` sleeps on the
  HOST side before dispatching the listed training-step indices (``"k+"``
  arms every step >= k) — the slow-host model the fleet watchdog
  (obs/fleet.py) must flag as a typed ``fleet_straggler`` event with a
  coordinated flight dump, exercised by ``run-scripts/fleet_smoke.py``
  with the env set on exactly one simulated host.
- ``HYDRAGNN_FAULT_HOST_KILL`` (``"k"``, ``"k+"``, comma lists; the index
  counts cumulative train steps across ALL epochs of this process, so a
  drill can fire after the epoch-0 checkpoint committed):
  ``maybe_host_fault`` SIGKILLs this process before dispatching the listed
  training-step indices — the dead-host model (hardware loss, OOM-killer):
  no grace, no signal handler, nothing runs after it. The fleet watchdog
  sees the heartbeat go stale and the elastic coordinator
  (train/elastic.py) drives the survivors' re-layout; exercised by
  ``run-scripts/elastic_smoke.py`` with the env set on one simulated host.
- ``HYDRAGNN_FAULT_HOST_PREEMPT`` (same grammar): ``maybe_host_fault``
  SIGTERMs this process at the listed step instead — the scheduler-
  preemption model WITH grace: the run's SIGTERM handler
  (train/preempt.py) performs the coordinated mid-epoch checkpoint before
  exit, so recovery resumes from the exact step rather than the last
  epoch boundary.

``flip_bit`` is the host-side corruption tool for the torn/rotted-checkpoint
tests: flip one bit of a saved file and assert restore falls back to the
previous verified epoch (the serve chaos smoke also uses it to corrupt a
hot-reload candidate).
"""

from __future__ import annotations

import os
import signal
from typing import Dict, Optional

from . import envflags

# per-point counters for maybe_ioerror (per process — checkpoint saves run
# in-process, so a counter here is exactly "the first n attempts")
_io_error_counts: Dict[str, int] = {}
# per-point call counters for maybe_socket_drop ("drop on the nth call")
_socket_call_counts: Dict[str, int] = {}
# configure() overrides; env wins when both are set
_config: Dict[str, str] = {}


def configure(**kwargs: Optional[str]) -> None:
    """In-process mirror of the env surface for tests:
    ``configure(nan_step="5+", io_errors="2", kill_at="ckpt_tmp_written")``.
    Pass ``None`` to clear a key."""
    keymap = {
        "nan_step": "HYDRAGNN_FAULT_NAN_STEP",
        "nan_lr_gt": "HYDRAGNN_FAULT_NAN_LR_GT",
        "kill_at": "HYDRAGNN_FAULT_KILL_AT",
        "io_errors": "HYDRAGNN_FAULT_IO_ERRORS",
        "sample_nan": "HYDRAGNN_FAULT_SAMPLE_NAN",
        "corrupt_sample": "HYDRAGNN_FAULT_CORRUPT_SAMPLE",
        "socket_drop": "HYDRAGNN_FAULT_SOCKET_DROP",
        "loader_stall": "HYDRAGNN_FAULT_LOADER_STALL",
        "loader_die": "HYDRAGNN_FAULT_LOADER_DIE",
        "serve_req_nan": "HYDRAGNN_FAULT_SERVE_REQ_NAN",
        "serve_wedge": "HYDRAGNN_FAULT_SERVE_WEDGE",
        "serve_slow_client": "HYDRAGNN_FAULT_SERVE_SLOW_CLIENT",
        "replica_kill": "HYDRAGNN_FAULT_REPLICA_KILL",
        "replica_wedge": "HYDRAGNN_FAULT_REPLICA_WEDGE",
        "replica_slow": "HYDRAGNN_FAULT_REPLICA_SLOW",
        "straggle": "HYDRAGNN_FAULT_STRAGGLE",
        "host_kill": "HYDRAGNN_FAULT_HOST_KILL",
        "host_preempt": "HYDRAGNN_FAULT_HOST_PREEMPT",
    }
    for k, v in kwargs.items():
        if k not in keymap:
            raise KeyError(f"unknown faultinject key {k!r}; known: {sorted(keymap)}")
        if v is None:
            _config.pop(keymap[k], None)
        else:
            _config[keymap[k]] = str(v)


def reset() -> None:
    """Clear configure() state and the per-point counters."""
    global _host_fault_steps
    _config.clear()
    _io_error_counts.clear()
    _socket_call_counts.clear()
    _host_fault_steps = 0


def _get(key: str) -> Optional[str]:
    env = envflags.env_str(key)
    return env if env is not None else _config.get(key)


def poison_grads(grads, step, lr=None):
    """In the train step: ``grads`` (a tensor, or a dict, list or tuple of
    them) with every floating tensor replaced by NaN where the armed
    condition holds, or ``grads`` itself when nothing is armed (an exact
    no-op).

    ``step`` is the step counter (an int or a device tensor); ``lr`` the
    learning rate, when the optimizer has one. The condition is a device
    boolean: no host read."""
    spec = _get("HYDRAGNN_FAULT_NAN_STEP")
    lr_gt = _get("HYDRAGNN_FAULT_NAN_LR_GT")
    if spec is None and lr_gt is None:
        return grads
    import torch

    cond = None
    if spec is not None:
        s = torch.as_tensor(step)
        if spec.endswith("+"):
            cond = s >= int(spec[:-1])
        else:
            cond = torch.zeros((), dtype=torch.bool, device=s.device)
            for k in spec.split(","):
                cond = cond | (s == int(k))
    if lr_gt is not None and lr is not None:
        c = torch.as_tensor(lr) > float(lr_gt)
        cond = c if cond is None else cond & c.to(cond.device)
    if cond is None:
        return grads

    def poison(g):
        if not torch.is_tensor(g) or not g.is_floating_point():
            return g
        return torch.where(cond.to(g.device), torch.full_like(g, float("nan")), g)

    if isinstance(grads, dict):
        return {k: poison(v) for k, v in grads.items()}
    if isinstance(grads, (list, tuple)):
        return type(grads)(poison(v) for v in grads)
    return poison(grads)


def lr_of(optimizer):
    """The learning rate of a torch optimizer's first parameter group (or
    of anything with ``param_groups``), or None: the lr hook for
    poison_grads' LR-threshold mode."""
    groups = getattr(optimizer, "param_groups", None)
    if groups and "lr" in groups[0]:
        return groups[0]["lr"]
    return None


def maybe_kill(point: str) -> None:
    """SIGKILL this process when ``point`` is armed — the preemption-
    mid-write model. SIGKILL (not SIGTERM): nothing may run after it, which
    is exactly the torn-write scenario the atomic checkpoint protocol must
    survive."""
    spec = _get("HYDRAGNN_FAULT_KILL_AT")
    if spec is None:
        return
    if point in (p.strip() for p in spec.split(",")):
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_ioerror(point: str) -> None:
    """Raise OSError on the first n calls for ``point`` (n from
    HYDRAGNN_FAULT_IO_ERRORS), then succeed — deterministic transient-IO
    model for the checkpoint writer's retry/backoff loop."""
    spec = _get("HYDRAGNN_FAULT_IO_ERRORS")
    if spec is None:
        return
    n = int(spec)
    done = _io_error_counts.get(point, 0)
    if done < n:
        _io_error_counts[point] = done + 1
        raise OSError(
            f"injected transient IO error {done + 1}/{n} at {point!r} "
            "(HYDRAGNN_FAULT_IO_ERRORS)"
        )


def _index_set(spec: Optional[str]) -> set:
    """Parse a comma-separated index list spec (``"3"`` / ``"3,7"``)."""
    if not spec:
        return set()
    return {int(k) for k in spec.split(",") if k.strip()}


def _index_armed(spec: str, index: int) -> bool:
    """Whether ``index`` matches an index spec: comma-separated values
    (``"3"``/``"3,7"``, the _index_set grammar) plus the open-range form
    ``"k+"`` (every index >= k) — ONE grammar for every indexed
    HYDRAGNN_FAULT_* point."""
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if part.endswith("+"):
            if index >= int(part[:-1]):
                return True
        elif index == int(part):
            return True
    return False


def poison_samples(graphs):
    """Dataset-ingest corruption: return ``graphs`` with the first feature of
    every armed index (HYDRAGNN_FAULT_SAMPLE_NAN, ``"3,7"``) replaced by NaN.
    No-op (the same list object) when unarmed. The dirty-data model the
    sample validator must catch — each poisoned sample must show up as
    exactly one ``nonfinite_features`` skip."""
    spec = _get("HYDRAGNN_FAULT_SAMPLE_NAN")
    idxs = _index_set(spec)
    if not idxs:
        return graphs
    import dataclasses

    import numpy as np

    out = list(graphs)
    for i in idxs:
        if 0 <= i < len(out):
            x = np.array(out[i].x, dtype=np.float32, copy=True)
            x.flat[0] = np.nan
            out[i] = dataclasses.replace(out[i], x=x)
    return out


def corrupt_blob(blob: bytes, idx: int) -> bytes:
    """Fetched-bytes corruption: when ``idx`` is armed
    (HYDRAGNN_FAULT_CORRUPT_SAMPLE), flip the leading byte so
    deserialization fails deterministically (a pickle stream never survives
    a mangled protocol opcode). Returns ``blob`` unchanged otherwise."""
    if idx not in _index_set(_get("HYDRAGNN_FAULT_CORRUPT_SAMPLE")):
        return blob
    if not blob:
        return blob
    return bytes([blob[0] ^ 0xFF]) + blob[1:]


def maybe_socket_drop(point: str) -> None:
    """Raise ConnectionError on the armed call numbers for ``point``
    (HYDRAGNN_FAULT_SOCKET_DROP, 1-based: ``"2"`` drops the 2nd call,
    ``"1,3"`` the 1st and 3rd) — the transient-connection model the remote
    store client's reconnect/backoff loop must absorb."""
    spec = _get("HYDRAGNN_FAULT_SOCKET_DROP")
    if spec is None:
        return
    call = _socket_call_counts.get(point, 0) + 1
    _socket_call_counts[point] = call
    if call in _index_set(spec):
        raise ConnectionError(
            f"injected socket drop on call {call} at {point!r} "
            "(HYDRAGNN_FAULT_SOCKET_DROP)"
        )


def maybe_loader_fault(batch_index: int) -> Optional[str]:
    """Prefetch-producer fault hook, called before building batch
    ``batch_index``. Returns ``"die"`` when the producer must exit silently
    without its end sentinel (HYDRAGNN_FAULT_LOADER_DIE = ``"k"``); sleeps
    in place for the armed stall (HYDRAGNN_FAULT_LOADER_STALL = ``"k"`` or
    ``"k:secs"``, default 60s — longer than any sane watchdog timeout) and
    returns None. Both model a wedged/dead loader worker the watchdog must
    turn into an actionable error instead of a silent hang."""
    die = _get("HYDRAGNN_FAULT_LOADER_DIE")
    if die is not None and batch_index in _index_set(die):
        return "die"
    stall = _get("HYDRAGNN_FAULT_LOADER_STALL")
    if stall is not None:
        k, _, secs = stall.partition(":")
        if int(k) == batch_index:
            import time

            time.sleep(float(secs) if secs else 60.0)
    return None


def poison_request(graph, idx: int):
    """Serve-plane ingest corruption: when submission index ``idx`` is armed
    (HYDRAGNN_FAULT_SERVE_REQ_NAN), return ``graph`` with its first feature
    NaN'd; the same graph object otherwise (exact no-op unarmed). The
    corrupt-request model the admission validation gate must catch as a
    typed per-request error."""
    if idx not in _index_set(_get("HYDRAGNN_FAULT_SERVE_REQ_NAN")):
        return graph
    import dataclasses

    import numpy as np

    x = np.array(graph.x, dtype=np.float32, copy=True)
    x.flat[0] = np.nan
    return dataclasses.replace(graph, x=x)


def _indexed_sleep(spec: Optional[str], index: int, default_secs: float) -> None:
    if spec is None:
        return
    k, _, secs = spec.partition(":")
    if _index_armed(k, index):
        import time

        time.sleep(float(secs) if secs else default_secs)


def maybe_serve_wedge(batch_index: int) -> None:
    """Sleep inside the serving step runner before dispatching batch
    ``batch_index`` when armed (HYDRAGNN_FAULT_SERVE_WEDGE = ``"k"`` or
    ``"k:secs"``, default 60s) — the wedged-device-step model the serve
    watchdog must turn into a bounded WedgedStepError + runner recycle."""
    _indexed_sleep(_get("HYDRAGNN_FAULT_SERVE_WEDGE"), batch_index, 60.0)


def maybe_slow_client(request_index: int) -> None:
    """Sleep at submission ``request_index``'s admission call when armed
    (HYDRAGNN_FAULT_SERVE_SLOW_CLIENT = ``"i"`` or ``"i:secs"``, default
    1s) — the slow-client model: one dawdling caller must only delay
    itself, never the serve loop or other submitters."""
    _indexed_sleep(_get("HYDRAGNN_FAULT_SERVE_SLOW_CLIENT"), request_index, 1.0)


def _replica_spec(key: str, replica_index: int) -> Optional[str]:
    """Resolve a ``"r:..."`` replica-scoped spec: returns the ``...`` part
    when the leading replica index matches this worker, else None."""
    spec = _get(key)
    if spec is None:
        return None
    r, sep, rest = spec.partition(":")
    try:
        if int(r) != replica_index:
            return None
    except ValueError:
        return None
    return rest if sep else ""


def maybe_replica_kill(replica_index: int, request_index: int) -> None:
    """SIGKILL this replica before serving request ``request_index`` when
    armed (HYDRAGNN_FAULT_REPLICA_KILL = ``"r:k"``; k defaults to 0, the
    first request) — the dead-replica model: no grace, nothing runs after
    it; the in-flight request is the router's retry problem and the
    restart is the ReplicaManager's."""
    kspec = _replica_spec("HYDRAGNN_FAULT_REPLICA_KILL", replica_index)
    if kspec is None:
        return
    if _index_armed(kspec or "0", request_index):
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_replica_wedge(replica_index: int, request_index: int) -> None:
    """Sleep this replica's armed /predict requests before processing
    (HYDRAGNN_FAULT_REPLICA_WEDGE = ``"r:k[:secs]"``, default 30s — longer
    than any sane router timeout) — the wedged-replica model that must
    open the circuit breaker; requests past the armed window succeed, so
    the half-open probe recloses it."""
    rest = _replica_spec("HYDRAGNN_FAULT_REPLICA_WEDGE", replica_index)
    if rest is None:
        return
    _indexed_sleep(rest or "0", request_index, 30.0)


def maybe_replica_slow(replica_index: int) -> None:
    """Sleep EVERY /predict on this replica when armed
    (HYDRAGNN_FAULT_REPLICA_SLOW = ``"r[:secs]"``, default 0.2s) — the
    slow-replica model the router's tail hedging must beat."""
    rest = _replica_spec("HYDRAGNN_FAULT_REPLICA_SLOW", replica_index)
    if rest is None:
        return
    import time

    time.sleep(float(rest) if rest else 0.2)


def maybe_quant_drift(entry: Optional[str]) -> Optional[float]:
    """Drifted-quantization drill (HYDRAGNN_FAULT_QUANT_DRIFT =
    ``"<entry_substring>:<factor>"``; empty substring arms every entry,
    factor defaults to 4.0): returns the scale-distortion factor when the
    checkpoint entry being quantized matches, else None. The serving
    quantizer multiplies every weight scale by it, so the accuracy gate
    must refuse the candidate (typed quant_drift event) while entries
    outside the match keep quantizing cleanly — the deterministic
    bad-candidate model for the fleet smoke's rolling-reload leg."""
    spec = _get("HYDRAGNN_FAULT_QUANT_DRIFT")
    if spec is None:
        return None
    sub, sep, factor_s = spec.rpartition(":")
    if not sep:
        sub, factor_s = spec, ""
    if sub and (entry is None or sub not in str(entry)):
        return None
    try:
        return float(factor_s) if factor_s else 4.0
    except ValueError:
        return 4.0


def maybe_straggle(step_index: int) -> None:
    """Host-side per-step sleep when armed (HYDRAGNN_FAULT_STRAGGLE =
    ``"k:secs"`` for exactly step k, ``"k+:secs"`` for every step >= k,
    comma lists like the sibling points; seconds default 0.05) — the
    slow-host model of a fleet straggler. Called from the epoch loop
    before each step dispatch; an unarmed call is one dict lookup."""
    _indexed_sleep(_get("HYDRAGNN_FAULT_STRAGGLE"), step_index, 0.05)


_host_fault_steps = 0


def maybe_host_fault(step_index: Optional[int] = None) -> None:
    """Host-loss drill hook, called from the epoch loop before each step
    dispatch (beside ``maybe_straggle``). Unlike the other indexed points,
    the armed index counts CUMULATIVE train steps dispatched by this
    process across epochs — a dead-host drill must fire *after* the
    epoch-0 checkpoint committed, which a per-epoch index cannot express
    (the epoch loop restarts its counter every epoch). When the step is
    armed:

    - HYDRAGNN_FAULT_HOST_KILL → SIGKILL this process (dead-host model:
      nothing runs after it — the fleet watchdog must detect the stale
      heartbeat and the elastic coordinator re-lay-out the survivors);
    - HYDRAGNN_FAULT_HOST_PREEMPT → SIGTERM this process (preemption-with-
      grace model: the run's SIGTERM handler checkpoints mid-epoch first).

    Both use the shared ``_index_armed`` grammar (``"k"``, ``"k+"``, comma
    lists). ``step_index`` overrides the process counter (tests). An
    unarmed call is two dict lookups."""
    global _host_fault_steps
    if step_index is None:
        step_index = _host_fault_steps
    _host_fault_steps += 1
    kill = _get("HYDRAGNN_FAULT_HOST_KILL")
    if kill is not None and _index_armed(kill, step_index):
        os.kill(os.getpid(), signal.SIGKILL)
    preempt = _get("HYDRAGNN_FAULT_HOST_PREEMPT")
    if preempt is not None and _index_armed(preempt, step_index):
        os.kill(os.getpid(), signal.SIGTERM)


def flip_bit(path: str, byte_offset: Optional[int] = None, bit: int = 0) -> int:
    """Flip one bit of the file at ``path`` in place (default: the middle
    byte — inside the payload, past any header). Returns the byte
    offset flipped. The corruption tool for the verified-restore tests."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot bit-flip empty file {path}")
    off = size // 2 if byte_offset is None else byte_offset
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ (1 << bit)]))
    return off
