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
- **drain/close**: ``initiate_drain`` (wired to SIGTERM by
  ``start(install_sigterm=True)``) turns ``/readyz`` not-ready at once and
  keeps admitting for ``Serving.drain_grace_s``, so a load balancer stops
  routing before clients meet ``ServerDrainingError``; queued work
  completes;
- **hot reload** (serve/reload.py): a verified candidate is restored into
  a standby copy of the model on the host, prepared into the served form
  off the serve loop, and copied into the served tensors IN PLACE between
  batches: every level's CUDA graph holds the addresses of those tensors,
  so a swap that rebound them would leave the replays on the old weights.
  ``PredictionHandle.checkpoint`` names the weights that answered;
- **reduced-precision weights** (``Serving.weights_dtype``): ``bfloat16``
  serves a copy whose floating parameters are bf16, ``int8`` a quantized
  copy (serve/quantize.py) behind the accuracy gate, at construction and
  at every reload; the f32 master then stays on the host;
- **watchdog**: every device step runs on a replaceable step runner; one
  that blows ``Serving.step_timeout_s`` fails its batch's requests with
  ``WedgedStepError``, emits ``serve_wedge``, dumps the flight recorder,
  and a fresh runner takes the next batch;
- **observability**: the request-lifecycle counters, queue depth,
  readiness and the batch and request latency histograms in the process
  registry, scraped at ``/metrics`` (``Serving.http_port``, with
  ``/healthz`` and ``/readyz``); head-sampled request traces (a
  ``serve/request`` root with ``serve/admit`` and ``serve/queue_wait``, and
  the shared ``serve/step`` with ``serve/batch_form``,
  ``serve/bucket_select``, ``serve/device_step`` and ``serve/respond``);
  the ``serve_*`` events.

Chaos hooks (utils/faultinject.py, exact no-ops unarmed):
``HYDRAGNN_FAULT_SERVE_REQ_NAN``, ``HYDRAGNN_FAULT_SERVE_WEDGE``,
``HYDRAGNN_FAULT_SERVE_SLOW_CLIENT`` and ``HYDRAGNN_FAULT_QUANT_DRIFT``.
The fleet (serve/fleet.py, serve/router.py, serve/replica.py) runs
replicas of this server.
"""

from __future__ import annotations

import copy
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
from ..train.compile_plane import GraphSet, _signature_of, sentinel, serve_warmup
from ..data.pipeline import spec_template_batches
from ..data.validate import R_BRANCH, R_BUDGET, R_CHANNELS, describe_reason, validate_graph
from ..device import DeviceLike, resolve_device
from ..obs.events import (EV_DEADLINE, EV_DRAIN, EV_QUEUE_FULL, EV_SHED, EV_WEDGE)
from ..obs.events import emit as _emit_event
from ..obs.registry import registry as _obs_registry
from ..obs.trace import STATUS_ERROR, STATUS_OK
from ..train.loop import cast_batch_bf16, mp_cast_model
from ..train.state import InferenceState, cast_inference_weights
from ..utils import faultinject
from .config import ServeConfig
from .errors import (
    DeadlineExceededError,
    InvalidRequestError,
    QueueFullError,
    RequestError,
    ServerClosedError,
    ServerDrainingError,
    SheddedError,
    WedgedStepError,
)

# serve-loop / waiter wake-up cadence
_TICK_S = 0.02
_JOIN_TIMEOUT_S = 5.0


def _emit_serve_event(kind, severity=None, trace_id=None, **attrs):
    """A typed incident record (obs/events.py) that never fails the request
    path it describes."""
    try:
        _emit_event(kind, severity=severity, trace_id=trace_id, **attrs)
    except Exception:
        pass


class _StepTimeout(Exception):
    """Internal: the step runner exceeded its watchdog budget."""


class _StepRunner:
    """One daemon worker running device steps, replaceable on a wedge: a step
    that blows ``step_timeout_s`` leaves its thread abandoned (a daemon: it
    cannot block process exit) and a fresh runner takes over, so the serve
    loop never queues behind a hung step."""

    def __init__(self, device, name: str = "serve-step"):
        self._device = device
        self._in: "queue.Queue" = queue.Queue(maxsize=1)
        self._out: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._main, daemon=True, name=name)
        self._thread.start()

    def _main(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while True:
            thunk = self._in.get()
            if thunk is None:
                return
            try:
                self._out.put(("ok", thunk()))
            except BaseException as e:  # surfaced in run()
                self._out.put(("err", e))

    def run(self, thunk, timeout: float):
        self._in.put(thunk)
        try:
            kind, val = self._out.get(timeout=timeout if timeout > 0 else None)
        except queue.Empty:
            raise _StepTimeout() from None
        if kind == "err":
            raise val
        return val

    def stop(self) -> None:
        try:
            self._in.put_nowait(None)
        except queue.Full:
            pass  # wedged mid-step; the daemon thread is simply abandoned


class PredictionHandle:
    """Client-side handle of one submitted request: ``result()`` blocks for
    the outcome and re-raises the request's typed error; ``error()`` returns
    it as a value. ``batch_index`` is the served batch that answered it,
    ``checkpoint`` the checkpoint file whose weights did."""

    __slots__ = ("request_id", "deadline", "submitted_at", "done_at", "batch_index",
                 "checkpoint", "_event", "_result", "_error", "trace")

    def __init__(self, request_id: int, deadline: float):
        self.request_id = request_id
        self.deadline = deadline
        # perf_counter stamps: per-request latency without a waiter thread
        self.submitted_at: float = time.perf_counter()
        self.done_at: Optional[float] = None
        self.batch_index: Optional[int] = None
        self.checkpoint: Optional[str] = None
        self._event = threading.Event()
        self._result: Optional[Dict[str, np.ndarray]] = None
        self._error: Optional[RequestError] = None
        # the open serve/request root span of a sampled request's trace
        self.trace = None

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
    input channels, as the JAX package's eval step does (not for int8
    weights, which define their own precision). ``Serving.weights_dtype``
    picks the served form of the weights (module docstring);
    ``checkpoint_dir`` locates the int8 snapshots beside the run's
    checkpoints. ``sort_edges``
    must match the model's ``sorted_aggregation``. ``checkpoint_label`` names
    the checkpoint file the weights were restored from (``run_server``
    passes the file its walk-back actually restored); ``stats()`` reports
    it as ``current_checkpoint``. ``tracer`` (obs/trace.Tracer) samples
    request traces; the server owns it, the ``flight_recorder``
    (obs/flightrec.FlightRecorder) and, with ``events_stream``, the
    attached ``events.jsonl``, and tears them down at ``close()``."""

    def __init__(self, model: torch.nn.Module, ladder: SpecLadder,
                 serve_config: Optional[ServeConfig] = None, *,
                 template_graphs: Sequence[Graph], mixed_precision: bool = False,
                 sort_edges: bool = False, device: DeviceLike = None,
                 log_name: str = "serve", checkpoint_label: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None, tracer=None, flight_recorder=None,
                 events_stream: bool = False):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = serve_config or ServeConfig()
        self.mixed_precision = bool(mixed_precision)
        # int8 weights define their own precision: casting the inputs (and
        # the f32 scales) to bf16 would shift the values the gate certified
        self._cast_inputs = self.mixed_precision and self.cfg.weights_dtype != "int8"
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
        # the reload plane: the standby restore target (made at first use),
        # the staged swap, the int8 snapshots' directory and gate report
        self._checkpoint_dir = checkpoint_dir
        self._quant_report: Optional[Dict[str, Any]] = None
        self._standby: Optional[InferenceState] = None
        self.reload_lock = threading.Lock()
        self._swap_lock = threading.Lock()
        self._pending_state: Optional[Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor],
                                            Optional[str]]] = None
        self._watcher = None  # serve/reload.CheckpointWatcher
        self._prev_sigterm = None
        # admissions stay open until this monotonic stamp once draining
        # (Serving.drain_grace_s; 0 rejects at once)
        self._drain_admit_deadline = 0.0
        # the served module: the f32 model itself, its bf16 copy (mixed
        # precision or bf16 weights) or its int8 copy; int8 calibrates and
        # gates on the template batches, so after the fields above
        self._serve_model = self._served_module(
            self._cast_weights(InferenceState(self.model), checkpoint_label))
        if self._serve_model is not self.model:
            self._serve_model.eval()
        if self.cfg.weights_dtype != "float32":
            # the served copy holds the weights the card needs; the f32
            # master (reload bookkeeping, ``server.model``) stays on the host
            self.model = self.model.cpu()
        self._served_tensors = dict(self._serve_model.state_dict(keep_vars=True))
        self._master_tensors = (dict(self.model.state_dict(keep_vars=True))
                                if self._serve_model is not self.model else {})
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
        # the levels' CUDA graphs (the card only), the signatures the
        # sentinel has seen, and whether warm-up armed it
        self._graphs: Optional[GraphSet] = None
        self._seen: set = set()
        self._armed = False
        self._stats_lock = threading.Lock()
        self._stats: Dict[str, int] = {
            "submitted": 0, "admitted": 0, "completed": 0, "rejected": 0,
            "shed": 0, "queue_full": 0, "deadline_expired": 0,
            "wedged_batches": 0, "failed_batches": 0, "batches": 0, "reloads": 0,
        }
        # seconds spent per served batch phase, summed: forming the batch
        # (after its first request), host batching, and the model step
        # (device transfer, forward, outputs back on the host)
        self._seconds: Dict[str, float] = {"form": 0.0, "build": 0.0, "step": 0.0}
        self._serve_thread: Optional[threading.Thread] = None
        self._runner: Optional[_StepRunner] = None
        self._tracer = tracer
        self._flight = flight_recorder
        self._events_stream = bool(events_stream)
        self._http = None  # obs/prometheus.TelemetryHTTPServer
        # the registry series behind /metrics: every counter _bump touches,
        # queue depth, readiness, batch and per-request latency. They are
        # PROCESS metrics (one server a process is the deployment model);
        # the series appear at 0 before the first request, and a standby
        # server never clobbers a live one's readiness (set_default).
        reg = _obs_registry()
        self._m_events = reg.counter(
            "hydragnn_serve_events_total",
            "Serving request-lifecycle event counts (GraphServer.stats keys)",
            labelnames=("event",),
        )
        for key in self._stats:
            self._m_events.inc(0, event=key)
        self._m_queue = reg.gauge(
            "hydragnn_serve_queue_depth",
            "Admitted requests waiting in the micro-batcher queue",
        )
        self._m_ready = reg.gauge(
            "hydragnn_serve_ready",
            "1 once the full ladder is warmed and admissions are open",
        )
        self._m_batch_lat = reg.histogram(
            "hydragnn_serve_batch_latency_seconds",
            "Device micro-batch service time (form -> outputs on host)",
        )
        self._m_req_lat = reg.histogram(
            "hydragnn_serve_request_latency_seconds",
            "Per-request latency, admission to delivered outcome (outcome="
            "error covers deadline/wedge/batch failures — without it the "
            "p99 would be survivorship-biased exactly under overload)",
            labelnames=("outcome",),
        )
        self._m_queue.set_default(0)
        self._m_ready.set_default(0)

    # -- model step ------------------------------------------------------

    def _placed_forward(self, batch) -> Dict[str, torch.Tensor]:
        """The served forward on a batch on the server's device (what each
        level's CUDA graph captures)."""
        if self._cast_inputs:
            batch = cast_batch_bf16(batch)
        with torch.inference_mode():
            return self._serve_model(batch)

    def forward(self, batch) -> Dict[str, np.ndarray]:
        """One served forward on a CPU ``GraphBatch``: per-head outputs as
        f32 host arrays. A batch of a level captured at warm-up replays its
        CUDA graph; any other runs eagerly, after the retrace sentinel's
        verdict (``Serving.retrace_policy``: ``error`` raises
        ``RetraceError``, failing the batch)."""
        sig = _signature_of(batch)
        g = self._graphs.graphs.get(sig) if self._graphs is not None else None
        if g is not None:
            out = g.run(batch, clone=False)
        else:
            if sig not in self._seen:
                sentinel().note_signature("serve_predict", sig)  # a raise leaves it unseen
                self._seen.add(sig)
            out = self._placed_forward(batch.to(self.device, non_blocking=True))
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    def _device_step(self, batch) -> Dict[str, np.ndarray]:
        """``forward`` on the step runner's thread, inside its profiler range."""
        with torch.profiler.record_function("serve/device_step"):
            return self.forward(batch)

    # -- lifecycle -------------------------------------------------------

    def start(self, install_sigterm: bool = False) -> "GraphServer":
        """Launch warm-up + the serve loop, and mount the endpoint
        (``Serving.http_port`` >= 0; a failed bind warns). Admission opens at
        once: requests queue while the ladder warms. ``install_sigterm``
        wires SIGTERM to ``initiate_drain`` (from the main thread only)."""
        if self._closed:
            raise ServerClosedError("server is closed")
        if self._serve_thread is None:
            if install_sigterm:
                import signal

                def _on_sigterm(signum, frame):
                    # only flags: the serve loop finishes the admitted work
                    self.initiate_drain()
                    if callable(self._prev_sigterm):
                        self._prev_sigterm(signum, frame)

                try:
                    self._prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
                except ValueError:
                    pass  # not the main thread: the caller wires the drain
            if int(self.cfg.http_port) >= 0:
                from ..obs.prometheus import start_endpoint

                # readiness IS the full-ladder warm-up flip that opens the
                # serve loop; draining or closed falls out of the balancer
                self._http = start_endpoint(
                    int(self.cfg.http_port),
                    ready_fn=lambda: (self._ready.is_set() and self.failed is None
                                      and not self._closed and not self._draining.is_set()),
                    health_fn=lambda: (
                        (True, "serving") if self.failed is None and not self._closed
                        else (False, "closed" if self.failed is None
                              else f"warm-up failed: {self.failed}")),
                    label=f"serve[{self.log_name}]",
                    host=self.cfg.http_host,
                )
            self._runner = _StepRunner(self.device)
            self._serve_thread = threading.Thread(
                target=self._run, daemon=True, name="serve-loop"
            )
            self._serve_thread.start()
        return self

    def attach_watcher(self, watcher) -> None:
        """Register a started ``CheckpointWatcher``: ``close()`` stops it."""
        self._watcher = watcher

    def _warm_level(self, spec, batch) -> None:
        """Warm one ladder level: on the card one eager forward, then its
        CUDA graph captured (a failed capture raises, naming the level);
        a captured level replays."""
        sig = _signature_of(batch)
        if self._graphs is not None and sig not in self._graphs.graphs:
            self._placed_forward(batch.to(self.device))
            self._graphs.capture(sig, f"serve:{spec.n_nodes}n/{spec.n_edges}e", batch)
            sentinel().note_signature("serve_predict", sig)
            self._seen.add(sig)
            return
        self.forward(batch)

    def _warmup(self) -> None:
        """``serve_warmup`` over the ladder (train/compile_plane.py): every
        level warmed (and on the card captured) before readiness, then the
        retrace sentinel armed at ``Serving.retrace_policy``."""
        templates = spec_template_batches(
            self._template_graphs, self.ladder, sort_edges=self.sort_edges
        )
        if not templates:
            raise ValueError(
                "no template graph fits any ladder level: the ladder does not "
                "describe the template dataset"
            )
        if self.device.type == "cuda":
            self._graphs = GraphSet(self._placed_forward, self.device)
        compiled, errors, exec_s = serve_warmup(self._warm_level, templates,
                                                policy=self.cfg.retrace_policy, label="serve")
        self.warmup_compiled = [(label.split(":", 1)[1], t) for label, t in compiled]
        if errors:
            raise RuntimeError(f"serve warm-up failed for {len(errors)} level(s): {errors}")
        if self._stop.is_set():
            # close() raced warm-up: the sentinel serve_warmup just armed
            # must not leak into the rest of the process
            sentinel().disarm()
            return
        self._armed = True
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
        self._m_ready.set(1)
        self._serve_loop()

    @property
    def ready(self) -> bool:
        return self._ready.is_set()

    @property
    def http_port(self) -> Optional[int]:
        """Port of the /metrics, /healthz, /readyz endpoint, or None when
        disabled (``Serving.http_port`` < 0) or the bind failed."""
        return self._http.port if self._http is not None else None

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
        """Stop admitting, after ``Serving.drain_grace_s`` (async-signal
        safe: a float store and flags); queued and in-flight requests still
        complete. The ready gauge and ``/readyz`` report not-ready from here
        on, at once: a load balancer observes the flip within the grace
        window and stops routing before clients meet
        ``ServerDrainingError`` (only the instance that reported ready
        zeroes the shared gauge)."""
        self._drain_admit_deadline = time.monotonic() + float(self.cfg.drain_grace_s)
        self._draining.set()
        if self._ready.is_set():
            self._m_ready.set(0)
        _emit_serve_event(EV_DRAIN, severity="info", queued=self._queue.qsize())

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
        # a staged reload the serve loop will never take drops here
        with self._swap_lock:
            self._pending_state = None
        if self._ready.is_set():
            self._m_ready.set(0)
        if self._http is not None:
            self._http.close()
            self._http = None
        if self._watcher is not None:
            self._watcher.stop()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=_JOIN_TIMEOUT_S)
            if self._serve_thread.is_alive():
                warnings.warn("serve loop still alive at close(); leaking the "
                              "daemon thread", RuntimeWarning, stacklevel=2)
        if self._runner is not None:
            self._runner.stop()
        self._fail_queued(ServerClosedError("server closed"))
        if self._armed:
            sentinel().disarm()
            self._armed = False
        if self._prev_sigterm is not None:
            import signal

            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                pass
            self._prev_sigterm = None
        self._graphs = None  # the levels' graphs and their pool, released now
        self._close_plane()
        self._drained.set()

    def _close_plane(self) -> None:
        """Tear down the tracing plane the server was handed."""
        if self._flight is not None:
            try:
                self._flight.uninstall()
            except Exception:
                pass
        if self._tracer is not None:
            from ..obs import trace as _obs_trace

            try:
                _obs_trace.uninstall(self._tracer)
                self._tracer.close()
            except Exception:
                pass
        if self._events_stream:
            from ..obs.events import detach_stream

            detach_stream()

    def __enter__(self) -> "GraphServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))

    # -- admission -------------------------------------------------------

    def submit(self, graph: Graph, deadline_s: Optional[float] = None) -> PredictionHandle:
        """Admit one request. Admission rejections raise the typed error;
        an admitted request's later failures arrive on the handle."""
        idx = next(self._submit_seq)
        t_admit_wall = time.time()
        self._bump("submitted")
        # chaos hook: a slow client holding the admission door
        faultinject.maybe_slow_client(idx)
        if self._closed or self.failed is not None:
            self._bump("rejected")
            raise ServerClosedError(
                "server is closed" if self.failed is None
                else f"server failed at warm-up: {self.failed}",
                request_id=idx,
            )
        # the grace window: /readyz is already 503, admissions stay open
        if self._draining.is_set() and time.monotonic() >= self._drain_admit_deadline:
            self._bump("rejected")
            raise ServerDrainingError(
                "server is draining (SIGTERM or drain()); request not admitted",
                request_id=idx)
        # chaos hook: a corrupt request by submission index
        g = faultinject.poison_request(_strip_targets(graph), idx)
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
                _emit_serve_event(EV_SHED, request_id=idx, projected_wait_s=round(projected, 6),
                                  slo_s=self.cfg.slo_p99_s)
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
        # the head-sampling decision at the trace root, before the enqueue:
        # the serve loop may dequeue the request at once
        if self._tracer is not None and self._tracer.sample_request():
            # backdated to submit's entry: the root spans admission to outcome
            root = self._tracer.begin("serve/request", start_unix=t_admit_wall)
            root.set_attribute("request_id", idx)
            handle.trace = root
            self._tracer.emit_completed("serve/admit", t_admit_wall,
                                        time.time() - t_admit_wall, parent=root)
        try:
            self._queue.put_nowait(_Request(g, handle))
        except queue.Full:
            self._bump("queue_full")
            _emit_serve_event(
                EV_QUEUE_FULL,
                trace_id=handle.trace.trace_id if handle.trace is not None else None,
                request_id=idx, bound=self.cfg.max_queue_requests)
            self._end_request_trace(handle, error="queue_full")
            raise QueueFullError(
                f"request {idx} rejected: admission queue is at its bound "
                f"({self.cfg.max_queue_requests} requests)",
                request_id=idx,
            ) from None
        self._bump("admitted")
        self._m_queue.set(self._queue.qsize())
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
                _emit_serve_event(
                    EV_DEADLINE,
                    trace_id=req.handle.trace.trace_id if req.handle.trace is not None else None,
                    request_id=req.handle.request_id,
                    waited_s=round(time.perf_counter() - req.handle.submitted_at, 6))
                self._fail_request(req.handle, DeadlineExceededError(
                    "deadline expired while queued"
                ))
                continue
            if req.handle.trace is not None:
                # the queue wait, retroactive at dequeue: admission -> now
                wait = time.perf_counter() - req.handle.submitted_at
                self._tracer.emit_completed("serve/queue_wait", time.time() - wait, wait,
                                            parent=req.handle.trace)
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
            # the hot-reload swap point: after batch forming, before the
            # dispatch; a state staged while the loop waited serves the
            # very next batch
            with self._swap_lock:
                pending, self._pending_state = self._pending_state, None
            if pending is not None:
                self._swap_in(*pending)
            if reqs is None:
                # exit once the grace window has passed too: a request
                # admitted in it must not race a loop that already quit
                if (self._draining.is_set() and self._queue.qsize() == 0
                        and self._holdover is None
                        and time.monotonic() >= self._drain_admit_deadline):
                    break
                continue
            self._inflight_graphs = len(reqs)
            batch_index = next(self._batch_seq)
            graphs = [r.graph for r in reqs]
            step_span = self._begin_step_span(reqs, batch_index)
            # profiler ranges named as the step's spans (torch.profiler traces)
            rf_step = torch.profiler.record_function("serve/step")
            rf_step.__enter__()
            t0 = time.perf_counter()
            try:
                spec = self.ladder.select_for(graphs)
                if step_span is not None:
                    sel_dt = time.perf_counter() - t0
                    self._tracer.emit_completed(
                        "serve/bucket_select", time.time() - sel_dt, sel_dt, parent=step_span,
                        attributes={"level": f"{spec.n_nodes}n/{spec.n_edges}e"})
                batch = batch_graphs(graphs, spec, sort_edges=self.sort_edges)
                t_built = time.perf_counter()

                def step(b=batch, bi=batch_index):
                    faultinject.maybe_serve_wedge(bi)  # chaos hook: a wedged step
                    return self._device_step(b)

                label = self.current_checkpoint
                outputs = self._runner.run(step, self.cfg.step_timeout_s)
                if step_span is not None:
                    dev_dt = time.perf_counter() - t_built
                    self._tracer.emit_completed("serve/device_step", time.time() - dev_dt,
                                                dev_dt, parent=step_span)
            except _StepTimeout:
                self._bump("wedged_batches")
                _emit_serve_event(
                    EV_WEDGE, severity="error",
                    trace_id=step_span.trace_id if step_span is not None else None,
                    batch_index=batch_index, graphs=len(reqs),
                    step_timeout_s=self.cfg.step_timeout_s)
                # the wedged runner's thread is abandoned (a daemon); recycle
                self._runner = _StepRunner(self.device)
                for r in reqs:
                    self._fail_request(r.handle, WedgedStepError(
                        f"device step for batch {batch_index} exceeded step_timeout_s="
                        f"{self.cfg.step_timeout_s}s; the batch was abandoned and the step "
                        "runner recycled"))
                self._finish_step_span(step_span, error="wedged_step")
                # a wedged step is a flight-recorder trigger: the wedge event,
                # the abandoned batch's spans and the registry
                self._flight_dump("serve_wedge")
                self._inflight_graphs = 0
                rf_step.__exit__(None, None, None)
                continue
            except Exception as e:  # noqa: BLE001 -- batch-level failure
                self._bump("failed_batches")
                for r in reqs:
                    self._fail_request(r.handle, RequestError(
                        f"batch {batch_index} failed: {type(e).__name__}: {e}"
                    ))
                self._finish_step_span(step_span, error=f"{type(e).__name__}: {e}")
                self._inflight_graphs = 0
                rf_step.__exit__(None, None, None)
                continue
            t_done = time.perf_counter()
            dt = t_done - t0
            with self._stats_lock:
                self._seconds["form"] += t0 - self._form_started
                self._seconds["build"] += t_built - t0
                self._seconds["step"] += t_done - t_built
            self._m_batch_lat.observe(dt)
            self._m_queue.set(self._queue.qsize())
            # counted before the answers go out: a client that has its answer
            # reads stats() that hold its batch
            self._bump("batches")
            self._bump("completed", len(reqs))
            with torch.profiler.record_function("serve/respond"):
                self._deliver(reqs, batch, outputs, batch_index, label)
            if step_span is not None:
                resp_dt = time.perf_counter() - t_done
                self._tracer.emit_completed("serve/respond", time.time() - resp_dt, resp_dt,
                                            parent=step_span)
            self._finish_step_span(step_span)
            rf_step.__exit__(None, None, None)
            # EMA service-time estimate drives the shed projection
            per_graph = dt / len(reqs)
            self._per_graph_s = (per_graph if self._per_graph_s <= 0
                                 else 0.8 * self._per_graph_s + 0.2 * per_graph)
            self._inflight_graphs = 0
        self._drained.set()

    def _deliver(self, reqs: List[_Request], batch, outputs: Dict[str, Any],
                 batch_index: int, checkpoint: Optional[str] = None) -> None:
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
            r.handle.checkpoint = checkpoint
            r.handle._resolve(result)
            self._m_req_lat.observe(r.handle.done_at - r.handle.submitted_at, outcome="ok")
            self._end_request_trace(r.handle)

    # -- tracing helpers -------------------------------------------------

    def _begin_step_span(self, reqs: List[_Request], batch_index: int):
        """Open the shared device-step span of a batch holding sampled
        requests: it lives in the LEAD sampled request's trace and is
        cross-linked with every other sampled request of the batch (OTLP
        links), with the retroactive serve/batch_form child (the lead's
        dequeue -> now)."""
        if self._tracer is None:
            return None
        sampled = [r.handle.trace for r in reqs if r.handle.trace is not None]
        if not sampled:
            return None
        sp = self._tracer.begin("serve/step", parent=sampled[0])
        sp.set_attribute("batch_index", batch_index)
        sp.set_attribute("graphs", len(reqs))
        for other in sampled[1:]:
            sp.add_link(other.trace_id, other.span_id)
            other.add_link(sp.trace_id, sp.span_id)
        form_dt = time.perf_counter() - self._form_started
        self._tracer.emit_completed("serve/batch_form", time.time() - form_dt, form_dt,
                                    parent=sp)
        return sp

    def _finish_step_span(self, span, error: Optional[str] = None) -> None:
        if span is None:
            return
        try:
            span.set_status(STATUS_ERROR if error is not None else STATUS_OK, error or "")
            self._tracer.finish(span)
        except Exception:
            pass  # tracing must never fail the serve loop

    def _end_request_trace(self, handle: PredictionHandle, error: Optional[str] = None) -> None:
        """Close a sampled request's root span with its outcome; its
        duration IS the request's admission-to-outcome latency."""
        root = handle.trace
        if root is None:
            return
        handle.trace = None
        try:
            root.set_status(STATUS_ERROR if error is not None else STATUS_OK, error or "")
            self._tracer.finish(root)
        except Exception:
            pass

    def _flight_dump(self, reason: str) -> None:
        """Dump the black box: the server's own recorder, else whatever
        recorder is process-active."""
        try:
            if self._flight is not None:
                self._flight.dump(reason)
            else:
                from ..obs import flightrec as _flightrec

                _flightrec.trigger(reason)
        except Exception:
            pass

    # -- bookkeeping -----------------------------------------------------

    def _fail_request(self, handle: PredictionHandle, err: RequestError) -> None:
        """Fail one admitted request AND observe its latency with the error
        outcome: failed requests are the slow tail, so leaving them out
        would make the scraped p99 improve as the server fails harder."""
        handle._fail(err)
        self._m_req_lat.observe(handle.done_at - handle.submitted_at, outcome="error")
        self._end_request_trace(handle, error=getattr(err, "code", type(err).__name__))

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

    # -- weights: the served form, reloads -------------------------------

    def _cast_weights(self, state: InferenceState, entry: Optional[str] = None):
        """Apply ``Serving.weights_dtype`` to an incoming f32 state: the one
        precision gate for the construction and every reload, so a reload
        never reverts the server to f32. ``int8`` goes through the
        quantization plane (calibration and the accuracy gate; ``entry``
        names the checkpoint for the snapshot and the drift drill) and may
        raise ``QuantizationDriftError``."""
        if self.cfg.weights_dtype == "float32":
            return state
        if self.cfg.weights_dtype == "int8":
            return self._quantize_state(state, entry)
        return cast_inference_weights(state, self.cfg.weights_dtype)

    def _served_module(self, state) -> torch.nn.Module:
        """The module the server runs for a cast state: its own model, or
        that model's bf16 copy under mixed precision."""
        return mp_cast_model(state.model) if self._cast_inputs else state.model

    def _quant_batches(self) -> list:
        """The calibration and gate batches: the template graphs packed as
        the micro-batcher packs requests (up to the batch cap, within the
        worst level's budget), each batch at the ladder level it selects
        (the shapes serving runs), capped at
        ``Serving.quantization.calibration_batches``. The JAX server
        calibrates on one graph per level (``spec_template_batches``);
        static activation scales from single graphs saturated the EGNN's
        activations on real traffic (up to 15x past the calibrated range at
        hidden 24), so the port calibrates on full batches, and on their
        real rows only (``_quantize_state``)."""
        batches, cur, n, e = [], [], 0, 0
        worst = self.ladder.specs[-1]
        for g in self._template_graphs:
            if cur and (len(cur) >= self._batch_cap or n + g.num_nodes > worst.n_nodes - 1
                        or e + g.num_edges > worst.n_edges):
                batches.append(cur)
                cur, n, e = [], 0, 0
            if g.num_nodes > worst.n_nodes - 1 or g.num_edges > worst.n_edges:
                continue
            cur.append(g)
            n, e = n + g.num_nodes, e + g.num_edges
        if cur:
            batches.append(cur)
        if not batches:
            raise ValueError(
                "int8 quantization needs at least one template batch to calibrate and "
                "gate on: the ladder does not describe the template dataset")
        cap = max(1, int(self.cfg.quantization.calibration_batches))
        return [batch_graphs(gs, self.ladder.select_for(gs), sort_edges=self.sort_edges)
                for gs in batches[:cap]]

    def _quantize_state(self, state: InferenceState, entry: Optional[str]):
        """The int8 install: the snapshot's fast path (no calibration: the
        artifact banked its gate report), else quantize, calibrate and gate
        on the server's device, then publish the snapshot beside the
        checkpoint for the rest of the fleet."""
        from . import quantize as qz

        spec = self.cfg.quantization
        if isinstance(state, qz.QuantizedInferenceState):
            self._quant_report = {"source": "prequantized", "mode": state.mode}
            return state
        fp = InferenceState(state.model.to(self.device).eval(), state.step)
        if entry and self._checkpoint_dir:
            loaded = qz.load_snapshot(fp.model, self.log_name, entry, spec.mode,
                                      self._checkpoint_dir)
            if loaded is not None:
                qstate, report = loaded
                qstate.model.to(self.device)
                self._quant_report = dict(report, source="snapshot", mode=qstate.mode)
                return qstate
        batches = self._quant_batches()
        # calibrated and gated on the real rows: the padding's rows (the
        # dummy node sums every padding edge) set no scale and no verdict
        qstate = qz.quantize_state(fp.model, fp, batches, spec.mode, spec.exclude)
        factor = faultinject.maybe_quant_drift(entry)
        if factor:
            qstate = qz.apply_scale_drift(qstate, factor)
        report = qz.gate_or_raise(fp, qstate, batches, spec.max_error,
                                  run=self.log_name, entry=entry)
        self._quant_report = dict(report, source="calibrated")
        if entry and self._checkpoint_dir:
            try:
                qz.save_snapshot(qstate, self._quant_report, self.log_name, entry,
                                 self._checkpoint_dir)
            except OSError:
                pass  # the artifact is an accelerator, not a dependency
        return qstate

    @property
    def restore_template(self) -> InferenceState:
        """The standby restore target of reloads: a host copy of the f32
        model, made at first use. A restore writes only here, never into
        the served tensors."""
        if self._standby is None:
            self._standby = InferenceState(copy.deepcopy(self.model).cpu().eval())
        return self._standby

    def _install_state(self, state: InferenceState, label: Optional[str]) -> bool:
        """Stage a restored f32 state (the standby); the serve loop copies
        it into the served tensors at the next batch boundary (in-flight
        batches keep the weights they started with). The cast, the
        quantization and its gate run here, off the serve loop: staging
        never stalls traffic, and a gate refusal (``QuantizationDriftError``)
        propagates with nothing staged. A candidate whose served form does
        not fit the served tensors raises ``ValueError``. Refused (False)
        on a draining, stopping or closed server."""
        if self.cfg.weights_dtype == "int8":
            state = InferenceState(copy.deepcopy(state.model), state.step)
        module = self._served_module(self._cast_weights(state, entry=label))
        values = {n: t.detach().to(self.device, copy=True)
                  for n, t in module.state_dict().items()}
        master_device = next(self.model.parameters()).device
        master = ({n: t.detach().to(master_device, copy=True)
                   for n, t in state.model.state_dict().items()}
                  if self._master_tensors and module is not state.model else {})
        for have, got, what in ((self._served_tensors, values, "served"),
                                (self._master_tensors, master, "master")):
            if got and {n: tuple(t.shape) for n, t in have.items()} != \
                    {n: tuple(t.shape) for n, t in got.items()}:
                raise ValueError(f"reload candidate {label!r} does not fit the {what} "
                                 "tensors (another model or quantized structure)")
        with self._swap_lock:
            if self._closed or self._stop.is_set() or self._draining.is_set():
                return False
            self._pending_state = (values, master, label)
            return True

    def _swap_in(self, values: Dict[str, torch.Tensor], master: Dict[str, torch.Tensor],
                 label: Optional[str]) -> None:
        """Copy a staged state into the served tensors in place, on the
        step runner (the stream the replays run on), then name it."""
        def copy_all():
            with torch.no_grad():
                for tensors, new in ((self._served_tensors, values),
                                     (self._master_tensors, master)):
                    for n, t in new.items():
                        tensors[n].copy_(t)

        self._runner.run(copy_all, self.cfg.step_timeout_s)
        self.current_checkpoint = label
        self._bump("reloads")

    def weight_nbytes(self) -> int:
        """Bytes of the served module's parameters and buffers (on the
        card when the server runs there)."""
        from .quantize import weight_nbytes

        return weight_nbytes(self._serve_model)

    def _bump(self, key: str, by: int = 1) -> None:
        with self._stats_lock:
            self._stats[key] = self._stats.get(key, 0) + by
        self._m_events.inc(by, event=key)

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
            http_port=self.http_port,
            weights_dtype=self.cfg.weights_dtype,
        )
        if self._quant_report is not None:
            out["quantization"] = dict(self._quant_report)
        return out
