"""Compile plane: one captured CUDA graph per ladder level, and the retrace
sentinel.

Counterpart of ``hydragnn_tpu/train/compile_plane.py``. On the TPU the JAX
package runs each ladder level's step as one XLA executable: its plane
warms one executable per (train, eval) x pad-bucket specialization and
arms a sentinel against silent retraces. The port's counterpart of "one
executable per specialization" is one captured ``torch.cuda.CUDAGraph``
per ladder level: a step that replays as one graph launch instead of the
host dispatching each of its kernels (the egnn_train step spends most of
its wall time in that dispatch; PERF.md).

**A specialization** is a ``StepGraph`` per (train or eval) x ladder level:
static input buffers in the level's padded shapes
(``GraphLoader.spec_template_batches``), views of one device block laid
out by ``block_layout``, a double-buffered pinned host block, the
captured graph and its static outputs. Each batch is copied into its
level's block in one copy: device to device on the compute stream where
train/loop.py ``device_prefetch`` staged it on the card in the same
layout (the staging producer pauses while a level is captured,
``CAPTURE_LOCK``), else packed into the pinned block and copied over;
then the graph replays; the outputs are
cloned out (the next replay overwrites them). All graphs of a plane share
one memory pool (``torch.cuda.graph_pool_handle``): levels never replay
concurrently, and each graph keeps its own gradients, so no graph's
replay touches memory another reads later. ``blocking`` captures the
largest level first, so the others reuse its freed blocks; a capture
first hands the eager steps' cached blocks back to CUDA
(``torch.cuda.empty_cache``).

``Training.precompile``:

- ``off``: eager, as before the plane; the sentinel counts but never arms.
- ``blocking``: every level captured before step 0. Everything the step
  changes (parameters, buffers, optimizer state and counters, the guard's
  copies, the RNG) is saved in place, one warm-up step per level runs on
  the templates on a side stream (it creates what a step makes lazily:
  the kernels' libraries, K2's shared-memory attribute, the K3 counters),
  every level is captured, and the saved values are copied back into the
  same storages: the trajectory afterwards equals ``off``.
- ``background``: each level is captured right after its first organic
  visit, on the loop's thread: that first step runs eagerly and is the
  warm-up, and capturing records the step without running it, so the
  state is untouched. Unlike the JAX package's background mode there is
  no compile to hide behind epoch 0: a capture costs about one step's host
  time.
- ``analysis``: ``blocking``, plus each level's FLOPs (obs/flops.py) and
  each capture's pool bytes (the counterparts of XLA's ``cost_analysis``
  and ``memory_analysis``).

On the CPU nothing is captured: ``blocking`` warms every level eagerly
(with the same save and restore) and arms the sentinel, ``background``
arms it once every level ran; each step then runs eagerly.

**The persistent cache.** A CUDA graph does not outlive its process, so
there is nothing to persist; unlike the JAX package (whose plane degrades
to ``off`` without a cache directory, since its AOT executables would be
unreachable) the port's plane runs without one. ``setup_compile_cache``
still resolves and reports the directory (without creating it)
(``Training.compile_cache_dir``, ``HYDRAGNN_COMPILE_CACHE``), and the
report's ``cache_hits`` / ``cache_misses`` count the kernel libraries
``ops/_build.py`` found already built or had to build.

**The sentinel** (``_TraceSentinel``, the JAX package's) counts one
*trace* per new batch signature (shape and dtype per leaf) of each step:
a capture, or an eager step of a signature no graph holds. It arms once
every level is captured; afterwards a batch of an unknown signature is a
violation handled by ``retrace_policy``: ``warn`` runs it eagerly with a
``RuntimeWarning`` naming the leaf diff, an ``EV_RETRACE_VIOLATION``
event and ``hydragnn_retrace_violations_total``; ``error`` raises
``RetraceError``.

**Launches.** A kernel wrapper counts ``launches`` only where it runs its
kernel; under capture it counts ``captured`` instead
(``ops/sorted_segment.count_launch``). Each graph records its captured
launches per kernel and case, and each replay adds them to the wrapper's
``replayed`` / ``replayed_by_case``: a replayed step's launches are read
there (the report's ``graphs`` gives each graph's launches and replays).

**The learning rate** is a host float baked into a capture
(``torch.optim`` and ``OptaxRule`` read ``group["lr"]``): a graph records
the rates it was captured with, and a step whose rates differ (the
plateau schedule, the warmup ramp, the guard's rollback backoff)
recaptures its level first.

The distributed step (``parallel/engine.py``) stays eager: its
collectives under capture come with a later slice; the report says so.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import sys
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import envflags

PRECOMPILE_MODES = ("off", "blocking", "background", "analysis")
RETRACE_POLICIES = ("warn", "error")

# why the distributed step runs eagerly (the report's ``graphs_note``)
DISTRIBUTED_NOTE = ("eager: the distributed step (parallel/engine.py) runs its collectives "
                    "outside CUDA graphs; NCCL under capture comes with a later slice")


# held by a capture from its begin to its end, and by the device-staging
# producer (train/loop.py ``device_prefetch``) around each batch's copy to
# the card: no staging copy, and no allocation of its, is issued while a
# CUDA graph is being captured
CAPTURE_LOCK = threading.Lock()

# each tensor of a batch laid out in one block starts on this boundary (a
# multiple of every dtype's size, so each slice can be viewed as its dtype)
BLOCK_ALIGN = 256


def block_layout(batch) -> Tuple[List[Tuple[int, int]], int]:
    """(offset, bytes) of each tensor of the ``GraphBatch`` ``batch`` in
    ``GraphBatch.apply``'s order, and the aligned total: the layout of a
    batch in one block (a ``StepGraph``'s buffers, a staged batch)."""
    spans: List[Tuple[int, int]] = []
    total = 0

    def visit(t):
        nonlocal total
        nbytes = t.numel() * t.element_size()
        spans.append((total, nbytes))
        total += -(-nbytes // BLOCK_ALIGN) * BLOCK_ALIGN
        return t

    batch.apply(visit)
    return spans, max(total, BLOCK_ALIGN)


def pack_block(batch, block: torch.Tensor, spans) -> None:
    """Copy each tensor of ``batch`` into its span of the byte tensor
    ``block`` (``block_layout``'s)."""
    it = iter(spans)

    def pack(t):
        off, nbytes = next(it)
        block[off:off + nbytes].view(t.dtype).view(t.shape).copy_(t)
        return t

    batch.apply(pack)


def block_views(batch, block: torch.Tensor, spans):
    """``batch`` with each tensor replaced by the view of its span of
    ``block``."""
    it = iter(spans)

    def view(t):
        off, nbytes = next(it)
        return block[off:off + nbytes].view(t.dtype).view(t.shape)

    return batch.apply(view)


class RetraceError(RuntimeError):
    """An armed retrace sentinel saw a batch signature outside the known
    specialization set (``Training.retrace_policy: error``,
    ``Serving.retrace_policy: error``). The message carries the leaf diff
    against the nearest known specialization."""


# ---------------------------------------------------------------------------
# the persistent cache directory and the kernel-library counters
# ---------------------------------------------------------------------------

_CACHE_DIR: Optional[str] = None


def cache_dir_active() -> Optional[str]:
    """The compile-cache directory the last ``setup_compile_cache`` set, or
    None."""
    return _CACHE_DIR


def set_cache_dir(path: Optional[str]) -> Optional[str]:
    """Record ``path`` (abspath'd) as the compile-cache directory; None
    disables it. Nothing is created there (nothing is written there)."""
    global _CACHE_DIR
    _CACHE_DIR = None if path is None else os.path.abspath(path)
    return _CACHE_DIR


def setup_compile_cache(training: Dict[str, Any], log_name: Optional[str] = None
                        ) -> Optional[str]:
    """Resolve and record the run's compile-cache directory, with the JAX
    package's grammar: ``HYDRAGNN_COMPILE_CACHE`` (``0``/``off``/``none``
    disables, ``1`` forces the config/default resolution back on, a path
    overrides), then ``Training.compile_cache_dir`` (``false`` disables, a
    path overrides), else ``./logs/<run>/xla_cache``. The disable paths
    also clear a directory an earlier run in this process set. Returns the
    directory, or None. Nothing is written there: a CUDA graph does not
    outlive its process (module docstring)."""
    env = envflags.env_str("HYDRAGNN_COMPILE_CACHE")
    cfg = training.get("compile_cache_dir")
    if env is not None:
        s = env.strip()
        if s.lower() in ("0", "off", "none", "false", ""):
            return set_cache_dir(None)
        if s != "1":
            cfg = s  # an explicit path beats the config
        elif cfg is False or (isinstance(cfg, str) and cfg.strip().lower() in ("off", "none")):
            cfg = None  # "1": force-on with the config/default resolution
    if cfg is False or (isinstance(cfg, str) and cfg.strip().lower() in ("off", "none")):
        return set_cache_dir(None)
    if isinstance(cfg, str) and cfg:
        path = cfg
    else:
        path = os.path.join("./logs", log_name or "run", "xla_cache")
    return set_cache_dir(path)


def compile_metrics() -> Dict[str, float]:
    """Process-wide counters: the kernel libraries found built (hits) or
    built (misses) by ``ops/_build.py``."""
    from ..ops._build import build_counts

    return {"cache_hits": build_counts["hits"], "cache_misses": build_counts["misses"]}


# ---------------------------------------------------------------------------
# retrace sentinel
# ---------------------------------------------------------------------------

# one leaf of a signature: (tree path, shape, dtype, weak_type)
_Leaf = Tuple[str, Tuple[int, ...], str, bool]
_Sig = Tuple[_Leaf, ...]


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _flatten(x, path: str, out: List[_Leaf]) -> None:
    """The leaves of ``x`` with the JAX package's tree paths
    (``jax.tree_util.keystr``: ``.field``, ``[i]``, ``['key']``; dict keys
    sorted; None is no leaf)."""
    if x is None:
        return
    if isinstance(x, torch.Tensor):
        out.append((path, tuple(x.shape), _dtype_name(x.dtype), False))
    elif isinstance(x, np.ndarray):
        out.append((path, tuple(x.shape), str(x.dtype), False))
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _flatten(getattr(x, f.name), f"{path}.{f.name}", out)
    elif isinstance(x, dict):
        for k in sorted(x):
            _flatten(x[k], f"{path}[{k!r}]", out)
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            _flatten(v, f"{path}[{i}]", out)
    else:  # a host scalar leaf (bool, int, float)
        out.append((path, (), type(x).__name__, isinstance(x, (int, float, complex, bool))))


def _signature_of(args) -> _Sig:
    """Signature of a (tree of) step argument(s): per leaf (path, shape,
    dtype, weak_type), the JAX package's leaf tuple. Tensors are never
    weak; a host scalar is. The port's index tensors are int64 where the
    JAX package's are int32."""
    leaves: List[_Leaf] = []
    _flatten(args, "", leaves)
    return tuple(leaves)


def _diff_sigs(got: _Sig, ref: _Sig, limit: int = 8) -> List[str]:
    """Human-readable per-leaf diff of two signatures (by tree path)."""
    ref_by_path = {p: (s, d, w) for p, s, d, w in ref}
    got_paths = {p for p, *_ in got}
    out = []
    for p, s, d, w in got:
        have = ref_by_path.get(p)
        if have is None:
            out.append(f"  {p}: NEW leaf {d}{list(s)}{' weak' if w else ''}")
        elif have != (s, d, w):
            rs, rd, rw = have
            out.append(
                f"  {p}: {rd}{list(rs)}{' weak' if rw else ''} -> "
                f"{d}{list(s)}{' weak' if w else ''}"
            )
    for p, s, d, w in ref:
        if p not in got_paths:
            out.append(f"  {p}: leaf DROPPED ({d}{list(s)})")
    if len(out) > limit:
        out = out[:limit] + [f"  ... {len(out) - limit} more differing leaves"]
    return out


class _TraceSentinel:
    """Process-wide trace counter per step, armable against a known
    specialization set. ``note`` is called once per new signature of a
    step (a capture, or an eager step no graph holds), so its counts are
    the port's retrace census."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sigs: Dict[str, List[_Sig]] = {}
        self._armed = False
        self._policy = "warn"
        self._known: Dict[str, set] = {}
        self._violations: List[str] = []

    def note(self, name: str, args) -> None:
        self.note_signature(name, _signature_of(args))

    def note_signature(self, name: str, sig: _Sig) -> None:
        """``note`` of a signature already taken (``_signature_of``)."""
        with self._lock:
            self._sigs.setdefault(name, []).append(sig)
            if not self._armed:
                return
            known = self._known.get(name, set())
            if sig in known:
                msg = (f"retrace sentinel: {name} re-traced an already-known specialization "
                       "after warm-up (a rebuilt step function?) — one extra capture")
            else:
                msg = self._unknown_sig_message(name, sig, known)
            # numbered: Python's default filter would fold repeats into one
            msg = f"{msg} [violation #{len(self._violations) + 1}]"
            self._violations.append(msg)
            policy = self._policy
            n_violations = len(self._violations)
        try:
            from ..obs.events import EV_RETRACE_VIOLATION
            from ..obs.events import emit as _emit_event
            from ..obs.registry import registry

            _emit_event(EV_RETRACE_VIOLATION, severity="error" if policy == "error" else "warn",
                        step=name, violation=n_violations)
            registry().counter("hydragnn_retrace_violations_total",
                               "Trace-sentinel violations (silent recompiles) this "
                               "process").inc()
        except Exception:
            pass
        if policy == "error":
            raise RetraceError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)

    @staticmethod
    def _unknown_sig_message(name: str, sig: _Sig, known: set) -> str:
        nearest = None
        best = None
        for k in known:
            d = len(_diff_sigs(sig, k, limit=10 ** 6))
            if best is None or d < best:
                best, nearest = d, k
        lines = [
            f"retrace sentinel: {name} traced a specialization outside the warmed ladder "
            "budget after warm-up completed — a silent recompile (here: an eager step no "
            "captured graph holds, on every occurrence)."
        ]
        if nearest is not None:
            lines.append(f"aval diff vs the nearest known specialization "
                         f"({best} differing leaves):")
            lines.extend(_diff_sigs(sig, nearest))
        else:
            lines.append(f"no known specializations recorded for {name!r}")
        return "\n".join(lines)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {k: len(v) for k, v in self._sigs.items()}

    def arm(self, policy: str) -> None:
        """Freeze every signature seen so far as the known set; later
        notes are violations handled per ``policy``."""
        with self._lock:
            self._known = {k: set(v) for k, v in self._sigs.items()}
            self._policy = policy
            self._armed = True

    def disarm(self) -> None:
        with self._lock:
            self._armed = False

    @property
    def armed(self) -> bool:
        return self._armed

    def violations(self) -> List[str]:
        with self._lock:
            return list(self._violations)

    def reset(self) -> None:
        with self._lock:
            self._sigs.clear()
            self._known.clear()
            self._violations.clear()
            self._armed = False
            self._policy = "warn"


_SENTINEL = _TraceSentinel()


def sentinel() -> _TraceSentinel:
    return _SENTINEL


def note_trace(name: str, args) -> None:
    """Record one trace of step ``name``: ``args`` is the step's batch."""
    _SENTINEL.note(name, args)


# ---------------------------------------------------------------------------
# kernel launch counters
# ---------------------------------------------------------------------------


def _kernel_wrappers() -> Dict[str, Any]:
    from ..ops.flash_attention import flash_block_summary, flash_self_attention
    from ..ops.fused_edge import fused_edge_message_sum
    from ..ops.multi_agg import fused_multi_agg
    from ..ops.numerics_stats import numerics_stats
    from ..ops.sorted_segment import sorted_segment_sum

    return {"sorted_segment_sum": sorted_segment_sum,
            "fused_edge_message_sum": fused_edge_message_sum,
            "fused_multi_agg": fused_multi_agg,
            "flash_self_attention": flash_self_attention,
            "flash_block_summary": flash_block_summary,
            "numerics_stats": numerics_stats}


def captured_counts() -> Dict[str, Dict[str, int]]:
    """Launches recorded into graphs so far, per kernel wrapper and case."""
    return {k: dict(f.captured_by_case) for k, f in _kernel_wrappers().items()}


# ---------------------------------------------------------------------------
# captured steps
# ---------------------------------------------------------------------------


def _clone_out(x):
    """The step's outputs with every tensor cloned (the graph's static
    outputs are overwritten by its next replay)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone_out(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_clone_out(v) for v in x)
    if isinstance(x, list):
        return [_clone_out(v) for v in x]
    return x


class StepGraph:
    """One captured step of one (kind, ladder level): static input buffers
    on the card (views of one block), a double-buffered pinned host block,
    the graph and its static outputs. ``run(batch)`` copies ``batch`` in,
    replays, and returns cloned outputs."""

    def __init__(self, label: str, template, device: torch.device):
        self.label = label
        self.device = device
        self._spans, self.nbytes = block_layout(template)
        self._staging = [torch.empty(self.nbytes, dtype=torch.uint8, pin_memory=True)
                         for _ in range(2)]
        self._events: List[Optional[torch.cuda.Event]] = [None, None]
        self._slot = 0
        self.block = torch.empty(self.nbytes, dtype=torch.uint8, device=device)
        pack_block(template, self._staging[0], self._spans)
        self.block.copy_(self._staging[0])
        self.static = block_views(template, self.block, self._spans)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None
        self.keep: List[torch.Tensor] = []
        self.key: Any = None  # what the capture baked in (the learning rates)
        self.capture_s = 0.0
        self.captures = 0
        self.replays = 0
        # wrapper -> case -> launches recorded by the capture
        self.launches: Dict[str, Dict[str, int]] = {}
        self.pool_bytes = 0
        self.kept_bytes = 0

    @torch.no_grad()
    def load(self, batch) -> None:
        """Copy ``batch`` into the static buffers in one copy on the current
        (compute) stream: only that stream writes the buffers the previous
        replay reads. A batch staged on the card by train/loop.py
        ``device_prefetch`` (whose consumer made this stream wait for its
        copy) carries its block in the same layout (``.block``): one copy
        device to device. A host batch is packed into the pinned block the
        copy before last used, once that copy is done."""
        staged = getattr(batch, "block", None)
        if staged is not None:
            if staged.numel() < self.nbytes:
                raise RuntimeError(f"{self.label}: the staged block holds {staged.numel()} "
                                   f"bytes, the captured step's {self.nbytes}")
            self.block.copy_(staged[:self.nbytes], non_blocking=True)
            return
        slot = self._slot
        self._slot ^= 1
        ev = self._events[slot]
        if ev is not None:
            ev.synchronize()
        pack_block(batch, self._staging[slot], self._spans)
        self.block.copy_(self._staging[slot], non_blocking=True)
        ev = self._events[slot] = self._events[slot] or torch.cuda.Event()
        ev.record()

    def capture(self, body: Callable, pool, stream: torch.cuda.Stream, key: Any = None,
                keep: Callable[[], List[torch.Tensor]] = lambda: [],
                collect: bool = True) -> None:
        """Capture ``body(static batch)`` into a fresh graph on ``pool``
        (``collect``: the garbage collected and the cache emptied first; a
        caller capturing several levels in a row does that once). A failure
        raises ``RuntimeError`` naming the level."""
        before = captured_counts()
        dev = self.device
        torch.cuda.synchronize(dev)
        if collect:
            # as torch.cuda.graph does: collect the garbage first (a CUDA
            # graph freed by the collector during a capture would free its
            # pool there, which invalidates the capture), then hand the
            # eager steps' cached blocks back to CUDA, where the graph's
            # pool can take them
            gc.collect()
            torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(dev)
        allocated0 = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream(dev))
        try:
            # the device-staging producer pauses for the capture
            with CAPTURE_LOCK, torch.cuda.stream(stream):
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    out = body(self.static)
                finally:
                    graph.capture_end()
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {self.label} failed: "
                               f"{type(e).__name__}: {e}") from e
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.graph, self.out, self.key = graph, out, key
        self.keep = list(keep())
        self.captures += 1
        after = captured_counts()
        self.launches = {}
        for k, cases in after.items():
            diff = {c: n - before[k].get(c, 0) for c, n in cases.items()
                    if n != before[k].get(c, 0)}
            if diff:
                self.launches[k] = diff
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved0
        self.kept_bytes = torch.cuda.memory_allocated(dev) - allocated0

    def replay(self, clone: bool = True):
        self.graph.replay()
        self.replays += 1
        if self.launches:
            wrappers = _kernel_wrappers()
            for k, cases in self.launches.items():
                w = wrappers[k]
                for c, n in cases.items():
                    w.replayed += n
                    w.replayed_by_case[c] += n
        return _clone_out(self.out) if clone else self.out

    def run(self, batch, clone: bool = True):
        """Copy ``batch`` in and replay; the outputs cloned (``clone``), or
        the static outputs themselves for a caller that reads them before
        the next replay."""
        self.load(batch)
        return self.replay(clone)


def _lr_key(state) -> Tuple[float, ...]:
    return tuple(float(g["lr"]) for g in state.optimizer.param_groups)


def _grads(state) -> List[torch.Tensor]:
    return [p.grad for p in state.model.parameters() if p.grad is not None]


class _Saved:
    """Everything a train step changes, copied out and back in place: the
    state's tensors and counters (``TrainState.state_dict``), the guard's
    flat copies, and the host's and the card's RNG."""

    def __init__(self, state):
        self.state = state
        self.sd = state.state_dict()
        self.guard = ([tuple(t.clone() for t in pair) for pair in state.guard.flat]
                      if state.guard is not None else None)
        self.cpu_rng = torch.get_rng_state()
        self.cuda_rng = torch.cuda.get_rng_state_all() if torch.cuda.is_available() else None

    @torch.no_grad()
    def restore(self) -> None:
        self.state.load_state_dict(self.sd)
        if self.guard is not None:
            for pair, saved in zip(self.state.guard.flat, self.guard):
                for t, s in zip(pair, saved):
                    t.copy_(s)
        torch.set_rng_state(self.cpu_rng)
        if self.cuda_rng is not None:
            torch.cuda.set_rng_state_all(self.cuda_rng)


def serve_warmup(run: Callable, templates, policy: str = "error", label: str = "serve"
                 ) -> Tuple[List[Tuple[str, float]], List[Tuple[str, str]], float]:
    """Serving-side blocking warm-up: ``run(spec, template)`` warms (and on
    the card captures) one template batch per ladder level.

    On full coverage the retrace sentinel is armed at ``policy`` (serving
    default ``error``: an unknown specialization under live traffic is a
    bug). Returns ``(compiled, errors, last_exec_s)``: [(label, seconds)]
    per level, the failures (arming is skipped if any), and the warm
    re-execution time of the last (largest) level — the serving-latency
    seed for the shed estimator."""
    if policy not in RETRACE_POLICIES:
        raise ValueError(f"retrace policy {policy!r} must be one of {RETRACE_POLICIES}")
    compiled: List[Tuple[str, float]] = []
    errors: List[Tuple[str, str]] = []
    last_exec_s = 0.0
    for spec, tmpl in templates:
        name = f"{label}:{spec.n_nodes}n/{spec.n_edges}e"
        t0 = time.perf_counter()
        try:
            run(spec, tmpl)
        except Exception as e:  # noqa: BLE001 — reported to the caller
            errors.append((name, f"{type(e).__name__}: {e}"))
            continue
        compiled.append((name, time.perf_counter() - t0))
    if templates and not errors:
        spec, tmpl = templates[-1]
        t0 = time.perf_counter()
        run(spec, tmpl)
        last_exec_s = time.perf_counter() - t0
        _SENTINEL.arm(policy)
    return compiled, errors, last_exec_s


class GraphSet:
    """The captured graphs of one step, one per batch signature, on one
    shared pool. ``body(static batch)`` is the step on a placed batch."""

    def __init__(self, body: Callable, device: torch.device, pool=None,
                 stream: Optional[torch.cuda.Stream] = None):
        self.body = body
        self.device = device
        self.pool = pool if pool is not None else torch.cuda.graph_pool_handle()
        self.stream = stream if stream is not None else torch.cuda.Stream(device)
        self.graphs: Dict[_Sig, StepGraph] = {}

    def capture(self, sig: _Sig, label: str, template, key: Any = None,
                keep: Callable[[], List[torch.Tensor]] = lambda: [],
                collect: bool = True) -> StepGraph:
        g = self.graphs.get(sig)
        if g is None:
            g = StepGraph(label, template, self.device)
        g.capture(self.body, self.pool, self.stream, key=key, keep=keep, collect=collect)
        self.graphs[sig] = g
        return g


# ---------------------------------------------------------------------------
# the plane
# ---------------------------------------------------------------------------


class CompilePlane:
    """Per-run orchestrator: the ladder's specializations, their graphs (or
    eager warm-ups on the CPU), the sentinel, and the report."""

    def __init__(self, mode: str = "background", retrace_policy: str = "warn",
                 log_name: str = "run", remat_policy: str = "full"):
        if mode not in PRECOMPILE_MODES:
            raise ValueError(f"precompile mode {mode!r} must be one of {PRECOMPILE_MODES}")
        if retrace_policy not in RETRACE_POLICIES:
            raise ValueError(f"retrace_policy {retrace_policy!r} must be one of "
                             f"{RETRACE_POLICIES}")
        self.mode = mode
        self.retrace_policy = retrace_policy
        self.log_name = log_name
        # Training.remat_policy, reported beside the FLOPs it changes
        self.remat_policy = remat_policy
        self.cache_dir: Optional[str] = None
        self.jobs: List[Tuple[str, str, _Sig, Any]] = []  # (kind, label, sig, template)
        self.compiled: List[Tuple[str, float]] = []  # (label, seconds)
        self.errors: List[Tuple[str, str]] = []
        self.flops_by_spec: Dict[str, float] = {}
        self.memory_by_spec: Dict[str, Dict[str, float]] = {}
        self.graphs_note: Optional[str] = None
        self.time_to_first_step: Optional[float] = None
        self._t0: Optional[float] = None
        self._m0: Dict[str, float] = {}
        self._counts0: Dict[str, int] = {}
        self._viol0 = 0
        self._sets: Dict[str, GraphSet] = {}
        self._done: set = set()  # labels warmed (CPU) or captured (card)
        self._seen: Dict[str, set] = {"train_step": set(), "eval_step": set()}
        self._device: Optional[torch.device] = None
        self._final: Optional[Dict[str, Any]] = None  # the report at finish()

    # -- lifecycle ---------------------------------------------------------

    def launch(self, step_fn, eval_fn, state, train_loader, val_loader=None,
               test_loader=None, skip_eval: bool = False, distributed: bool = False):
        """Start the plane for one run; returns ``(step_fn, eval_fn)``
        wrapped per ``self.mode``. ``step_fn`` / ``eval_fn`` are the
        ``make_train_step`` / ``make_eval_step`` functions (their
        ``placed`` attribute is the step on a placed batch);
        ``distributed`` keeps the steps eager (``DISTRIBUTED_NOTE``)."""
        from ..device import module_device
        from ..utils.timers import Timer

        self._t0 = time.perf_counter()
        self._ttfs = Timer("time_to_first_step").start()
        self.cache_dir = cache_dir_active()
        self._m0 = compile_metrics()
        self._counts0 = _SENTINEL.counts()
        self._viol0 = len(_SENTINEL.violations())
        self._state = state
        self._device = module_device(state.model)
        self._step_fn, self._eval_fn = step_fn, eval_fn
        graphable = (self._device.type == "cuda" and not distributed
                     and hasattr(step_fn, "placed") and hasattr(eval_fn, "placed"))
        if distributed:
            self.graphs_note = DISTRIBUTED_NOTE
        elif self._device.type != "cuda":
            self.graphs_note = "eager: no CUDA device (the levels are warmed eagerly)"
        self._graphs = graphable and self.mode != "off"
        self._job_by_sig: Dict[Tuple[str, _Sig], Tuple[str, Any]] = {}
        if self.mode != "off" and not distributed:
            self._collect_jobs(train_loader, None if skip_eval else (val_loader, test_loader))
            if self._graphs:
                pool = torch.cuda.graph_pool_handle()
                stream = torch.cuda.Stream(self._device)
                self._sets["train_step"] = GraphSet(
                    lambda b: step_fn.placed(self._state, b), self._device, pool, stream)
                self._sets["eval_step"] = GraphSet(
                    lambda b: eval_fn.placed(self._state, b), self._device, pool, stream)
            if self.mode in ("blocking", "analysis"):
                with Timer("compile_plane_warmup"):
                    self._warm_all()
                self._maybe_arm()
        if distributed:
            return step_fn, eval_fn
        return self._wrap("train_step", step_fn), self._wrap("eval_step", eval_fn)

    def _collect_jobs(self, train_loader, eval_loaders) -> None:
        def templates(loader):
            fn = getattr(loader, "spec_template_batches", None)
            return fn() if fn is not None else []

        for spec, tmpl in templates(train_loader):
            self.jobs.append(("train_step", f"train:{spec.n_nodes}n/{spec.n_edges}e",
                              _signature_of(tmpl), tmpl))
        seen = set()
        for loader in eval_loaders or ():
            if loader is None:
                continue
            for spec, tmpl in templates(loader):
                if spec in seen:
                    continue  # val/test share the ladder (api.prepare_data)
                seen.add(spec)
                self.jobs.append(("eval_step", f"eval:{spec.n_nodes}n/{spec.n_edges}e",
                                  _signature_of(tmpl), tmpl))
        self._job_by_sig = {(kind, sig): (label, tmpl) for kind, label, sig, tmpl in self.jobs}

    def _warm_all(self) -> None:
        """``blocking``: one warm-up step per level, then every capture,
        with the state saved before and copied back after."""
        saved = _Saved(self._state)
        try:
            if self._graphs:
                side = torch.cuda.Stream(self._device)
                side.wait_stream(torch.cuda.current_stream(self._device))
                with torch.cuda.stream(side):
                    for kind, label, sig, tmpl in self.jobs:
                        self._fn_of(kind)(self._state, tmpl)
                torch.cuda.current_stream(self._device).wait_stream(side)
                # the largest level first: the smaller ones' captures then
                # reuse (split) its freed blocks in the shared pool
                gc.collect()
                torch.cuda.empty_cache()
                for kind, label, sig, tmpl in sorted(
                        self.jobs, key=lambda j: (j[0] != "train_step", -j[3].num_edges,
                                                  -j[3].num_nodes)):
                    self._capture(kind, label, sig, tmpl, collect=False)
            else:
                for kind, label, sig, tmpl in self.jobs:
                    t0 = time.perf_counter()
                    self._fn_of(kind)(self._state, tmpl)
                    self.compiled.append((label, time.perf_counter() - t0))
                    self._done.add(label)
                    self._note(kind, sig)
        except RuntimeError:
            raise
        finally:
            saved.restore()
        if self.mode == "analysis":
            self._analyse()

    def _fn_of(self, kind: str) -> Callable:
        return self._step_fn if kind == "train_step" else self._eval_fn

    def _capture(self, kind: str, label: str, sig: _Sig, tmpl, collect: bool = True
                 ) -> StepGraph:
        gs = self._sets[kind]
        train = kind == "train_step"
        recapture = sig in gs.graphs
        g = gs.capture(sig, label, tmpl, key=_lr_key(self._state) if train else None,
                       keep=(lambda: _grads(self._state)) if train else (lambda: []),
                       collect=collect)
        if not recapture:
            self.compiled.append((label, g.capture_s))
            self.memory_by_spec[label] = {"pool_bytes": g.pool_bytes,
                                          "kept_bytes": g.kept_bytes}
            self._done.add(label)
            self._note(kind, sig)
        return g

    def _analyse(self) -> None:
        """``analysis``: each train level's FLOPs (obs/flops.py, on meta
        tensors)."""
        from ..obs.flops import train_step_flops

        model = self._state.model
        cfg = getattr(self._step_fn, "objective", {}) or {}
        for kind, label, sig, tmpl in self.jobs:
            if kind != "train_step":
                continue
            try:
                self.flops_by_spec[label] = train_step_flops(
                    model, tmpl, bool(cfg.get("compute_grad_energy", False)),
                    bool(cfg.get("mixed_precision", False)))
            except Exception as e:  # noqa: BLE001 — observability only
                self.errors.append((label, f"flops: {type(e).__name__}: {e}"))

    def _note(self, kind: str, sig: _Sig) -> None:
        if sig not in self._seen[kind]:
            _SENTINEL.note_signature(kind, sig)  # a raise leaves it unseen: it raises again
            self._seen[kind].add(sig)

    def _maybe_arm(self) -> None:
        # arm only on full coverage: a level that failed would legitimately
        # trace later
        if (self.jobs and not self.errors
                and all(label in self._done for _, label, _, _ in self.jobs)):
            if not _SENTINEL.armed:
                _SENTINEL.arm(self.retrace_policy)

    # -- the steps ---------------------------------------------------------

    def _wrap(self, kind: str, fn: Callable) -> Callable:
        plane = self
        train = kind == "train_step"

        def step(state, batch):
            plane._state = state
            sig = _signature_of(batch)
            gs = plane._sets.get(kind)
            g = gs.graphs.get(sig) if gs is not None else None
            if g is not None:
                if train and g.key != _lr_key(state):
                    g = gs.capture(sig, g.label, batch, key=_lr_key(state),
                                   keep=lambda: _grads(state))
                out = g.run(batch)
            else:
                job = plane._job_by_sig.get((kind, sig)) if plane.mode != "off" else None
                if job is None or plane.mode == "off":
                    plane._note(kind, sig)  # warns or raises once armed
                t0 = time.perf_counter()
                out = fn(state, batch)
                if job is not None and job[0] not in plane._done:
                    # background: the first visit was the warm-up
                    if plane._graphs:
                        plane._capture(kind, job[0], sig, job[1])
                    else:
                        plane.compiled.append((job[0], time.perf_counter() - t0))
                        plane._done.add(job[0])
                        plane._note(kind, sig)
                    plane._maybe_arm()
            if train and plane.time_to_first_step is None:
                if plane._device is not None and plane._device.type == "cuda":
                    torch.cuda.synchronize(plane._device)
                plane.time_to_first_step = time.perf_counter() - plane._t0
                plane._ttfs.stop()
            return out

        for attr in ("_numerics_meta", "_nan_diagnose", "placed", "objective"):
            if hasattr(fn, attr):
                setattr(step, attr, getattr(fn, attr))
        return step

    # -- accounting --------------------------------------------------------

    def graphs(self) -> Dict[str, StepGraph]:
        """label -> StepGraph, every captured graph of the plane."""
        return {g.label: g for gs in self._sets.values() for g in gs.graphs.values()}

    def train_flops_for(self, key: Tuple[int, int]) -> Optional[float]:
        """FLOPs of the train level padded to ``key`` = (nodes, edges), or
        None where ``analysis`` did not count it."""
        return self.flops_by_spec.get(f"train:{key[0]}n/{key[1]}e")

    def enable_flops_fallback(self) -> None:
        """A no-op in the port: the telemetry's FLOPs come from obs/flops.py
        (a meta-tensor count per level) whatever the mode, where the JAX
        package needs an executable to harvest."""

    def finish(self, verbosity: int = 0) -> Dict[str, Any]:
        """End the run: disarm the sentinel, release the graphs (their
        pools go back now, not whenever the collector reaches them), return
        (and at verbosity > 0 print) the report, which ``report()`` keeps
        giving afterwards."""
        rep = self.report()
        self._final = rep
        for gs in self._sets.values():
            gs.graphs.clear()
        self._sets.clear()
        _SENTINEL.disarm()
        if verbosity > 0:
            print(f"[{self.log_name}] {format_report(rep)}", file=sys.stderr)
        return rep

    def report(self) -> Dict[str, Any]:
        if self._final is not None:
            return self._final
        now = compile_metrics()
        counts = _SENTINEL.counts()
        traces = {k: v - self._counts0.get(k, 0) for k, v in counts.items()
                  if v - self._counts0.get(k, 0)}
        graphs = {label: {"capture_s": round(g.capture_s, 4), "captures": g.captures,
                          "replays": g.replays, "pool_bytes": int(g.pool_bytes),
                          "kept_bytes": int(g.kept_bytes), "launches": dict(g.launches)}
                  for label, g in sorted(self.graphs().items())}
        hbm = {label: int(m["pool_bytes"]) for label, m in sorted(self.memory_by_spec.items())}
        return {
            "mode": self.mode,
            "cache_dir": self.cache_dir,
            "remat_policy": self.remat_policy,
            "specializations": len(self.jobs),
            "precompiled": len(self.compiled),
            "compile_time_s": round(sum(s for _, s in self.compiled), 3),
            "backend_compile_s": 0.0,
            "cache_hits": int(now["cache_hits"] - self._m0.get("cache_hits", 0)),
            "cache_misses": int(now["cache_misses"] - self._m0.get("cache_misses", 0)),
            "time_to_first_step": (round(self.time_to_first_step, 3)
                                   if self.time_to_first_step is not None else None),
            "traces": traces,
            "violations": len(_SENTINEL.violations()) - self._viol0,
            "warmup_errors": list(self.errors),
            "graphs": graphs,
            "graphs_note": self.graphs_note,
            "flops_by_spec": dict(self.flops_by_spec),
            "hbm_by_spec": hbm,
            "hbm_peak_bytes": max(hbm.values()) if hbm else None,
            "comm_by_spec": {},
            "comm_bytes_peak": None,
            "device_bytes_limit": device_bytes_limit(),
        }


def device_bytes_limit() -> Optional[float]:
    """The card's memory capacity (None without one)."""
    try:
        from ..obs.memory import device_bytes_limit as _limit

        return _limit()
    except Exception:
        return None


def format_report(rep: Dict[str, Any]) -> str:
    """One grep-able line."""
    ttfs = rep.get("time_to_first_step")
    hbm = rep.get("hbm_peak_bytes")
    graphs = rep.get("graphs") or {}
    return (
        f"compile plane: mode={rep['mode']} "
        f"remat={rep.get('remat_policy', 'full')} "
        f"precompiled={rep['precompiled']}/{rep['specializations']} "
        f"compile_time_s={rep['compile_time_s']} "
        f"cache_hits={rep['cache_hits']} cache_misses={rep['cache_misses']} "
        f"time_to_first_step={ttfs if ttfs is not None else 'n/a'}s "
        f"traces={sum(rep['traces'].values())} "
        f"violations={rep['violations']} "
        f"graphs={len(graphs)} replays={sum(g['replays'] for g in graphs.values())} "
        f"hbm_peak={hbm if hbm is not None else 'n/a'}"
        + (f" warmup_errors={len(rep['warmup_errors'])}" if rep["warmup_errors"] else "")
    )
