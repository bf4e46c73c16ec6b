"""Micro-batched graph inference server.

Counterpart of ``hydragnn_tpu/serve/server.py`` for the single-server
slice:

- **admission**: a bounded request queue with per-request deadlines; every
  request passes ``data/validate.validate_graph``, a channel-signature
  check and a branch check (its ``dataset_id`` picks its decoder) at the
  door, so a malformed request gets a typed error
  (serve/errors.py) instead of failing the requests batched beside it;
- **micro-batcher**: admitted graphs are packed into the run's
  ``SpecLadder`` pad buckets (``select_for`` picks the smallest level that
  fits, DimeNet's triplets within its budget), so the model only
  sees the shapes warmed at startup;
- **warm-up**: one forward per reachable ladder level before readiness
  flips (this is where the CUDA kernels are built and first launched);
- **overload**: shedding with ``SheddedError`` when the projected queue wait
  exceeds ``Serving.slo_p99_s``; deadlines expire at dequeue;
- **drain/close**: ``drain()`` stops admissions while queued work completes.

Not in this slice: hot reload, int8, the fleet/router/cache, the HTTP
endpoint, tracing, the flight recorder and the device-step watchdog.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data.graph import Graph, SpecLadder, batch_graphs
from ..data.pipeline import spec_template_batches
from ..data.validate import R_BRANCH, R_BUDGET, R_CHANNELS, describe_reason, validate_graph
from ..device import DeviceLike, resolve_device
from ..train.loop import cast_batch_bf16, mp_cast_model
from .config import ServeConfig
from .errors import (
    DeadlineExceededError,
    InvalidRequestError,
    QueueFullError,
    RequestError,
    ServerClosedError,
    ServerDrainingError,
    SheddedError,
)

# serve-loop / waiter wake-up cadence
_TICK_S = 0.02
_JOIN_TIMEOUT_S = 5.0


class PredictionHandle:
    """Client-side handle of one submitted request: ``result()`` blocks for
    the outcome and re-raises the request's typed error; ``error()`` returns
    it as a value. ``batch_index`` is the served batch that answered it."""

    __slots__ = ("request_id", "deadline", "submitted_at", "done_at", "batch_index", "_event",
                 "_result", "_error")

    def __init__(self, request_id: int, deadline: float):
        self.request_id = request_id
        self.deadline = deadline
        # perf_counter stamps: per-request latency without a waiter thread
        self.submitted_at: float = time.perf_counter()
        self.done_at: Optional[float] = None
        self.batch_index: Optional[int] = None
        self._event = threading.Event()
        self._result: Optional[Dict[str, np.ndarray]] = None
        self._error: Optional[RequestError] = None

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def error(self, timeout: Optional[float] = None) -> Optional[RequestError]:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.request_id} has no outcome after {timeout}s")
        return self._error

    def result(self, timeout: Optional[float] = None) -> Dict[str, np.ndarray]:
        err = self.error(timeout)
        if err is not None:
            raise err
        return self._result

    def _resolve(self, result: Dict[str, np.ndarray]) -> None:
        self._result = result
        self.done_at = time.perf_counter()
        self._event.set()

    def _fail(self, err: RequestError) -> None:
        err.request_id = self.request_id
        self._error = err
        self.done_at = time.perf_counter()
        self._event.set()


@dataclasses.dataclass
class _Request:
    graph: Graph
    handle: PredictionHandle


def _strip_targets(g: Graph) -> Graph:
    """Serving inputs carry no supervision: drop the target tables so every
    request batches into the same layout as the warmed templates."""
    if g.graph_targets is None and g.node_targets is None and g.graph_y is None:
        return g
    return dataclasses.replace(g, graph_targets=None, node_targets=None, graph_y=None)


def _channel_signature(g: Graph) -> Tuple[Tuple[str, int], ...]:
    """(field, width) of the channels that shape a batch."""
    sig: List[Tuple[str, int]] = []
    for name in ("x", "pos", "edge_attr", "edge_shifts", "pe", "rel_pe", "z"):
        v = getattr(g, name)
        if v is None:
            continue
        arr = np.asarray(v)
        sig.append((name, int(arr.shape[1]) if arr.ndim > 1 else 1))
    return tuple(sig)


class GraphServer:
    """Micro-batched prediction with a request lifecycle.

    ``model`` is moved to ``device`` (the current CUDA device when None;
    raises when there is none) and served in eval mode; with
    ``mixed_precision`` the server keeps a bfloat16 copy of it and casts the
    input channels, as the JAX package's eval step does. ``sort_edges``
    must match the model's ``sorted_aggregation``. ``checkpoint_label`` names
    the checkpoint file the weights were restored from (``run_server``
    passes the file its walk-back actually restored); ``stats()`` reports
    it as ``current_checkpoint``."""

    def __init__(self, model: torch.nn.Module, ladder: SpecLadder,
                 serve_config: Optional[ServeConfig] = None, *,
                 template_graphs: Sequence[Graph], mixed_precision: bool = False,
                 sort_edges: bool = False, device: DeviceLike = None,
                 log_name: str = "serve", checkpoint_label: Optional[str] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.mixed_precision = bool(mixed_precision)
        self._serve_model = mp_cast_model(self.model) if self.mixed_precision else self.model
        self.cfg = serve_config or ServeConfig()
        self.ladder = ladder
        self.sort_edges = sort_edges
        self.log_name = log_name
        # the checkpoint file the weights came from (None: given in memory)
        self.current_checkpoint = checkpoint_label
        clean = [g for g in map(_strip_targets, template_graphs)
                 if validate_graph(g) is None]
        if not clean:
            raise ValueError(
                "GraphServer needs at least one valid template graph to warm "
                "the pad-bucket ladder"
            )
        self._template_graphs = clean
        self._channel_sig = _channel_signature(clean[0])
        self._num_branches = int(getattr(getattr(model, "cfg", None), "num_branches", 1))
        self._worst = ladder.specs[-1]
        # real-graph slots are bounded by the worst spec (n_graphs counts
        # the dummy slot too)
        self._batch_cap = min(int(self.cfg.micro_batch_graphs), self._worst.n_graphs - 1)
        self._queue: "queue.Queue[_Request]" = queue.Queue(
            maxsize=max(int(self.cfg.max_queue_requests), 0)
        )
        self._holdover: Optional[_Request] = None
        self._form_started = 0.0
        self._submit_seq = itertools.count()
        self._batch_seq = itertools.count()
        self._inflight_graphs = 0
        self._per_graph_s = float(self.cfg.expected_latency_per_graph_s)
        self._ready = threading.Event()
        self._draining = threading.Event()
        self._drained = threading.Event()
        self._stop = threading.Event()
        self._closed = False
        self.failed: Optional[Exception] = None
        self.warmup_compiled: List[Tuple[str, float]] = []
        self._stats_lock = threading.Lock()
        self._stats: Dict[str, int] = {
            "submitted": 0, "admitted": 0, "completed": 0, "rejected": 0,
            "shed": 0, "queue_full": 0, "deadline_expired": 0,
            "failed_batches": 0, "batches": 0,
        }
        # seconds spent per served batch phase, summed: forming the batch
        # (after its first request), host batching, and the model step
        # (device transfer, forward, outputs back on the host)
        self._seconds: Dict[str, float] = {"form": 0.0, "build": 0.0, "step": 0.0}
        self._serve_thread: Optional[threading.Thread] = None

    # -- model step ------------------------------------------------------

    def forward(self, batch) -> Dict[str, np.ndarray]:
        """One served forward on a CPU ``GraphBatch``: per-head outputs as
        f32 host arrays."""
        batch = batch.to(self.device, non_blocking=True)
        if self.mixed_precision:
            batch = cast_batch_bf16(batch)
        with torch.inference_mode():
            out = self._serve_model(batch)
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "GraphServer":
        """Launch warm-up + the serve loop. Admission opens at once:
        requests queue while the ladder warms."""
        if self._closed:
            raise ServerClosedError("server is closed")
        if self._serve_thread is None:
            self._serve_thread = threading.Thread(
                target=self._run, daemon=True, name="serve-loop"
            )
            self._serve_thread.start()
        return self

    def _warmup(self) -> None:
        templates = spec_template_batches(
            self._template_graphs, self.ladder, sort_edges=self.sort_edges
        )
        if not templates:
            raise ValueError(
                "no template graph fits any ladder level: the ladder does not "
                "describe the template dataset"
            )
        exec_s = 0.0
        for spec, batch in templates:
            t0 = time.perf_counter()
            self.forward(batch)
            exec_s = time.perf_counter() - t0
            self.warmup_compiled.append((f"{spec.n_nodes}n/{spec.n_edges}e", exec_s))
        if self._per_graph_s <= 0 and exec_s > 0:
            # one real graph per template batch
            self._per_graph_s = exec_s

    def _run(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        try:
            self._warmup()
        except Exception as e:  # noqa: BLE001 -- the server must fail typed
            self.failed = e
            self._stop.set()
            self._drained.set()
            self._fail_queued(ServerClosedError(f"serve warm-up failed: {e}"))
            return
        self._ready.set()
        self._serve_loop()

    @property
    def ready(self) -> bool:
        return self._ready.is_set()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until warm-up completes (True) or fails/times out (False;
        ``self.failed`` carries the warm-up error)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._ready.is_set():
            if self.failed is not None:
                return False
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(_TICK_S)
        return True

    def initiate_drain(self) -> None:
        """Stop admitting; queued and in-flight requests still complete."""
        self._draining.set()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Initiate and wait for the drain. True when every admitted request
        was answered."""
        self.initiate_drain()
        if timeout is None:
            timeout = self.cfg.drain_timeout_s or None
        return self._drained.wait(timeout)

    def close(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Shut down: optionally drain, stop the serve thread, and fail
        whatever is still queued with a typed error."""
        if self._closed:
            return
        if drain and self._serve_thread is not None and self.failed is None:
            self.drain(timeout)
        self._closed = True
        self._stop.set()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=_JOIN_TIMEOUT_S)
            if self._serve_thread.is_alive():
                warnings.warn("serve loop still alive at close(); leaking the "
                              "daemon thread", RuntimeWarning, stacklevel=2)
        self._fail_queued(ServerClosedError("server closed"))
        self._drained.set()

    def __enter__(self) -> "GraphServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))

    # -- admission -------------------------------------------------------

    def submit(self, graph: Graph, deadline_s: Optional[float] = None) -> PredictionHandle:
        """Admit one request. Admission rejections raise the typed error;
        an admitted request's later failures arrive on the handle."""
        idx = next(self._submit_seq)
        self._bump("submitted")
        if self._closed or self.failed is not None:
            self._bump("rejected")
            raise ServerClosedError(
                "server is closed" if self.failed is None
                else f"server failed at warm-up: {self.failed}",
                request_id=idx,
            )
        if self._draining.is_set():
            self._bump("rejected")
            raise ServerDrainingError(
                "server is draining; request not admitted", request_id=idx
            )
        g = _strip_targets(graph)
        if _channel_signature(g) != self._channel_sig:
            self._bump("rejected")
            raise InvalidRequestError(
                f"request {idx} channel layout {_channel_signature(g)} does not "
                f"match the served model's {self._channel_sig}: "
                f"{describe_reason(R_CHANNELS)}",
                request_id=idx, reason=R_CHANNELS,
            )
        reason = validate_graph(g, max_nodes=self._worst.n_nodes - 1,
                                max_edges=self._worst.n_edges)
        if reason is None and self._worst.n_triplets and g.num_triplets > self._worst.n_triplets:
            reason = R_BUDGET
        # each request's dataset_id picks its decoder branch; one outside
        # the model's branches would index past the banked decoders
        if reason is None and not 0 <= int(g.dataset_id) < self._num_branches:
            reason = R_BRANCH
        if reason is not None:
            self._bump("rejected")
            raise InvalidRequestError(
                f"request {idx} rejected: {reason} ({describe_reason(reason)})",
                request_id=idx, reason=reason,
            )
        if self.cfg.slo_p99_s > 0 and self._per_graph_s > 0:
            backlog = (self._queue.qsize() + self._inflight_graphs
                       + (1 if self._holdover is not None else 0))
            projected = backlog * self._per_graph_s
            if projected > self.cfg.slo_p99_s:
                self._bump("shed")
                raise SheddedError(
                    f"request {idx} shed: projected queue wait {projected:.3f}s "
                    f"exceeds the p99 SLO {self.cfg.slo_p99_s:.3f}s",
                    request_id=idx, projected_wait_s=projected,
                    slo_s=self.cfg.slo_p99_s,
                )
        if deadline_s is None:
            deadline_s = self.cfg.default_deadline_s
        deadline = time.monotonic() + float(deadline_s) if deadline_s else float("inf")
        handle = PredictionHandle(idx, deadline)
        try:
            self._queue.put_nowait(_Request(g, handle))
        except queue.Full:
            self._bump("queue_full")
            raise QueueFullError(
                f"request {idx} rejected: admission queue is at its bound "
                f"({self.cfg.max_queue_requests} requests)",
                request_id=idx,
            ) from None
        self._bump("admitted")
        return handle

    def predict(self, graphs: Sequence[Graph], deadline_s: Optional[float] = None,
                timeout: Optional[float] = None
                ) -> List[Union[Dict[str, np.ndarray], RequestError]]:
        """Blocking convenience: one outcome per graph, a per-head prediction
        dict or the request's typed ``RequestError`` as a value."""
        handles: List[Union[PredictionHandle, RequestError]] = []
        for g in graphs:
            try:
                handles.append(self.submit(g, deadline_s=deadline_s))
            except RequestError as e:
                handles.append(e)
        out: List[Union[Dict[str, np.ndarray], RequestError]] = []
        for h in handles:
            if isinstance(h, RequestError):
                out.append(h)
                continue
            err = h.error(timeout)
            out.append(err if err is not None else h.result(0))
        return out

    # -- serve loop ------------------------------------------------------

    def _take_request(self, timeout: float) -> Optional[_Request]:
        """Next admitted request (the holdover first); deadline-expired
        requests are failed here, never batched."""
        deadline = time.monotonic() + max(timeout, 0.0)
        while not self._stop.is_set():
            if self._holdover is not None:
                req, self._holdover = self._holdover, None
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0 and timeout > 0:
                    return None
                try:
                    req = self._queue.get(
                        timeout=min(max(remaining, 0.0), _TICK_S) if timeout > 0 else _TICK_S
                    )
                except queue.Empty:
                    if timeout > 0:
                        continue
                    return None
            if time.monotonic() > req.handle.deadline:
                self._bump("deadline_expired")
                self._fail_request(req.handle, DeadlineExceededError(
                    "deadline expired while queued"
                ))
                continue
            return req
        return None

    def _collect_batch(self) -> Optional[List[_Request]]:
        """One micro-batch: wait for a first request, then fill until the
        graph cap, the worst-spec pad budget or the batch window closes. A
        request that does not fit leads the next batch."""
        first = self._take_request(timeout=0.0)
        if first is None:
            return None
        self._form_started = time.perf_counter()
        reqs = [first]
        budget_t = self._worst.n_triplets
        n, e = first.graph.num_nodes, first.graph.num_edges
        t = first.graph.num_triplets if budget_t else 0
        window_ends = time.monotonic() + self.cfg.batch_window_s
        while len(reqs) < self._batch_cap:
            remaining = window_ends - time.monotonic()
            if remaining <= 0 and self._queue.qsize() == 0 and self._holdover is None:
                break
            req = self._take_request(timeout=max(remaining, _TICK_S / 10))
            if req is None:
                break
            gn, ge = req.graph.num_nodes, req.graph.num_edges
            gt = req.graph.num_triplets if budget_t else 0
            if (n + gn > self._worst.n_nodes - 1 or e + ge > self._worst.n_edges
                    or t + gt > budget_t):
                self._holdover = req
                break
            reqs.append(req)
            n, e, t = n + gn, e + ge, t + gt
        return reqs

    def _serve_loop(self) -> None:
        while not self._stop.is_set():
            reqs = self._collect_batch()
            if reqs is None:
                if (self._draining.is_set() and self._queue.qsize() == 0
                        and self._holdover is None):
                    break
                continue
            self._inflight_graphs = len(reqs)
            batch_index = next(self._batch_seq)
            graphs = [r.graph for r in reqs]
            t0 = time.perf_counter()
            try:
                spec = self.ladder.select_for(graphs)
                batch = batch_graphs(graphs, spec, sort_edges=self.sort_edges)
                t_built = time.perf_counter()
                outputs = self.forward(batch)
            except Exception as e:  # noqa: BLE001 -- batch-level failure
                self._bump("failed_batches")
                for r in reqs:
                    self._fail_request(r.handle, RequestError(
                        f"batch {batch_index} failed: {type(e).__name__}: {e}"
                    ))
                self._inflight_graphs = 0
                continue
            t_done = time.perf_counter()
            dt = t_done - t0
            with self._stats_lock:
                self._seconds["form"] += t0 - self._form_started
                self._seconds["build"] += t_built - t0
                self._seconds["step"] += t_done - t_built
            self._deliver(reqs, batch, outputs, batch_index)
            self._bump("batches")
            self._bump("completed", len(reqs))
            # EMA service-time estimate drives the shed projection
            per_graph = dt / len(reqs)
            self._per_graph_s = (per_graph if self._per_graph_s <= 0
                                 else 0.8 * self._per_graph_s + 0.2 * per_graph)
            self._inflight_graphs = 0
        self._drained.set()

    def _deliver(self, reqs: List[_Request], batch, outputs: Dict[str, Any],
                 batch_index: int) -> None:
        """Slice the padded outputs back per request: graph heads by graph
        row, node heads by the request's node span."""
        node_offsets = np.cumsum([0] + [r.graph.num_nodes for r in reqs])
        n_graphs, n_nodes = batch.num_graphs, batch.num_nodes
        for i, r in enumerate(reqs):
            result: Dict[str, np.ndarray] = {}
            for name, a in outputs.items():
                if a.ndim and a.shape[0] == n_graphs:
                    result[name] = a[i]
                elif a.ndim and a.shape[0] == n_nodes:
                    result[name] = a[node_offsets[i]: node_offsets[i + 1]]
                else:
                    result[name] = a
            r.handle.batch_index = batch_index
            r.handle._resolve(result)

    # -- bookkeeping -----------------------------------------------------

    def _fail_request(self, handle: PredictionHandle, err: RequestError) -> None:
        handle._fail(err)

    def _fail_queued(self, err: RequestError) -> None:
        if self._holdover is not None:
            self._fail_request(self._holdover.handle, err)
            self._holdover = None
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            self._fail_request(req.handle, err)

    def _bump(self, key: str, by: int = 1) -> None:
        with self._stats_lock:
            self._stats[key] = self._stats.get(key, 0) + by

    def stats(self) -> Dict[str, Any]:
        """Serving counters and the current policy snapshot."""
        with self._stats_lock:
            out: Dict[str, Any] = dict(self._stats)
            out["seconds"] = dict(self._seconds)
        out.update(
            ready=self.ready,
            draining=self.draining,
            closed=self._closed,
            queued=self._queue.qsize(),
            per_graph_latency_s=round(self._per_graph_s, 6),
            ladder_levels=len(self.ladder.specs),
            warmed_specializations=len(self.warmup_compiled),
            device=str(self.device),
            mixed_precision=self.mixed_precision,
            current_checkpoint=self.current_checkpoint,
        )
        return out
