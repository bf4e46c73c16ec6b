"""Front router for the serving fleet: failover, retries, hedging, circuit
breakers, priority classes, and the prediction cache (docs/SERVING.md
"Fleet").

Counterpart of ``hydragnn_tpu/serve/router.py``.

The router owns the *request-side* half of the fleet's fault model (the
ReplicaManager in serve/fleet.py owns the process-side half): every replica
is addressed through a ``ReplicaClient`` (HTTP for subprocess workers,
in-process for tests and BENCH cells), and one ``predict`` call survives any
single-replica failure mode:

- **load balancing** — replicas are scored on live queue depth (the
  collector substrate's per-replica gauges via ``depth_fn``, plus the
  router's own in-flight count) and EMA latency; lowest score wins;
- **retries** — a typed retryable failure (``RETRYABLE_CODES``; plus
  router-observed timeouts, safe because graph inference is pure — no
  side effects to double-apply) is re-issued on a *different* replica
  with bounded exponential backoff, up to ``router_retries`` times;
- **hedging** — an interactive request still unanswered past
  ``max(router_hedge_min_s, router_hedge_factor x EMA latency)`` is
  duplicated to a second replica; the first answer wins and the loser is
  abandoned (a blocking HTTP read cannot be cancelled; its late result is
  discarded and counted);
- **circuit breakers** — ``breaker_failures`` consecutive typed failures
  open a per-replica breaker (typed ``breaker_open`` event); after
  ``breaker_cooldown_s`` one half-open probe is admitted, and its success
  recloses the breaker (``breaker_close``);
- **priority classes** — ``"interactive"`` (default) gets the full
  treatment; ``"batch"`` is never hedged and is shed *at the router* when
  the chosen replica's projected wait exceeds the SLO, so background
  traffic yields capacity to interactive traffic first;
- **prediction cache** — an optional content-addressed
  ``PredictionCache``; hits skip the fleet entirely and are bit-identical
  to misses by construction. Keys mix the graph content with the cache's
  *context* (installed checkpoint digest + prediction-affecting serve
  config, maintained by the ReplicaManager), so a hot-reloaded fleet can
  never serve a prior checkpoint's cached prediction as a hit.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..data.graph import Graph
from .cache import PredictionCache, graph_key
from .config import ServeConfig
from .errors import (
    BreakerOpenError,
    DeadlineExceededError,
    NoReplicasError,
    ReplicaUnavailableError,
    RETRYABLE_CODES,
    ServeError,
    SheddedError,
)

# Codes the router re-issues on a different replica. Extends the wire-level
# retryable set with router-observed timeouts: inference is pure, so a
# timed-out attempt (which may still complete uselessly on the wedged
# replica) is safe to re-issue — there is no side effect to double-apply.
_ROUTER_RETRYABLE = frozenset(RETRYABLE_CODES) | {DeadlineExceededError.code}

# Codes that count against a replica's circuit breaker: transport loss,
# lifecycle rejections, wedges, and timeouts are *replica-health* signals.
# invalid_request fails identically everywhere (client bug), and
# shed/queue_full are load signals — breaking on them would amputate
# capacity exactly when it is scarcest.
_BREAKER_COUNTED = frozenset(_ROUTER_RETRYABLE)

_PRIORITIES = ("interactive", "batch")


def _emit_event(kind: str, **attrs: Any) -> None:
    try:
        from ..obs.events import emit

        emit(kind, **attrs)
    except Exception:
        pass


class ReplicaClient:
    """Uniform replica handle: blocking typed-error predict + health
    introspection. ``predict`` either returns the head->array dict or
    raises a ``ServeError`` subclass (never a transport exception — HTTP
    clients map those to ``ReplicaUnavailableError``)."""

    name: str = "replica"

    def predict(self, graph: Graph,
                timeout_s: Optional[float] = None) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def ready(self) -> bool:
        raise NotImplementedError

    def queue_depth(self) -> Optional[float]:
        """Live queue depth when the client can see it cheaply, else None
        (the router falls back to its own in-flight tracking)."""
        return None

    def close(self) -> None:
        pass


class LocalReplicaClient(ReplicaClient):
    """In-process client over a ``GraphServer`` — the test/BENCH transport
    (no sockets, no serialization; latency numbers are the server's own)."""

    def __init__(self, server, name: Optional[str] = None):
        self.server = server
        self.name = name or f"local:{id(server):x}"

    def predict(self, graph: Graph,
                timeout_s: Optional[float] = None) -> Dict[str, np.ndarray]:
        handle = self.server.submit(graph, deadline_s=timeout_s)
        return handle.result(timeout=timeout_s)

    def ready(self) -> bool:
        return bool(self.server.ready and not self.server.draining
                    and self.server.failed is None)

    def queue_depth(self) -> Optional[float]:
        try:
            return float(self.server._queue.qsize())
        except Exception:
            return None


class HTTPReplicaClient(ReplicaClient):
    """HTTP client for a subprocess replica (serve/replica.py): POST
    /predict with the wire codec, GET /readyz for health. Transport
    failures (refused/reset/dead process) map to
    ``ReplicaUnavailableError``; protocol failures re-raise the replica's
    typed error reconstructed from its stable code."""

    def __init__(self, base_url: str, name: Optional[str] = None):
        self.base_url = base_url.rstrip("/")
        self.name = name or self.base_url

    def _post(self, path: str, payload: bytes,
              timeout_s: Optional[float]) -> bytes:
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            self.base_url + path,
            data=payload,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            # the replica answered with a typed error body: not a
            # transport failure — surface the body for decoding
            try:
                return e.read()
            except Exception:
                raise ReplicaUnavailableError(
                    f"replica {self.name}: HTTP {e.code} with unreadable "
                    f"body"
                )
        except Exception as e:
            raise ReplicaUnavailableError(
                f"replica {self.name}: {type(e).__name__}: {e}"
            )

    def predict(self, graph: Graph,
                timeout_s: Optional[float] = None) -> Dict[str, np.ndarray]:
        from . import wire

        payload = wire.encode_graph(graph)
        if timeout_s:
            # server-side deadline: urllib's timeout is socket-inactivity
            # only, and an abandoned request (router timeout, retry, lost
            # hedge) would otherwise run handle.result(timeout=None) and
            # park a replica HTTP thread forever. With deadline_s on the
            # wire the replica bounds the request itself and frees the
            # handler for work someone still wants.
            payload["deadline_s"] = float(timeout_s)
        body = self._post("/predict", wire.dumps(payload), timeout_s)
        obj = wire.loads(body)
        if wire.is_error(obj):
            raise wire.decode_error(obj)
        return wire.decode_prediction(obj)

    def ready(self) -> bool:
        import urllib.request

        try:
            with urllib.request.urlopen(
                self.base_url + "/readyz", timeout=2.0
            ) as resp:
                return resp.status == 200
        except Exception:
            return False


class CircuitBreaker:
    """Per-replica failure gate: ``failures`` consecutive counted failures
    open it; after ``cooldown_s`` exactly one half-open probe is admitted,
    and its outcome closes or re-opens. Thread-safe; time injectable for
    tests via ``now_fn``."""

    def __init__(self, replica: str, failures: int = 3,
                 cooldown_s: float = 5.0,
                 now_fn: Callable[[], float] = time.monotonic):
        self.replica = replica
        self.failures = max(int(failures), 1)
        self.cooldown_s = float(cooldown_s)
        self._now = now_fn
        self._lock = threading.Lock()
        self.state = "closed"
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_out = False
        self.opens = 0
        self.closes = 0

    def allow(self) -> bool:
        """Whether a request may be sent to this replica right now. In
        half-open, admits exactly one probe at a time."""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if self._now() - self._opened_at >= self.cooldown_s:
                    self.state = "half_open"
                    self._probe_out = False
                else:
                    return False
            # half_open: one outstanding probe
            if self._probe_out:
                return False
            self._probe_out = True
            return True

    def record_success(self) -> None:
        with self._lock:
            was = self.state
            self._consecutive = 0
            self._probe_out = False
            if was != "closed":
                self.state = "closed"
                self.closes += 1
        if was != "closed":
            from ..obs.events import EV_BREAKER_CLOSE

            _emit_event(EV_BREAKER_CLOSE, replica=self.replica)

    def record_failure(self, code: str = "") -> None:
        opened = False
        with self._lock:
            if self.state == "half_open":
                # failed probe: straight back to open, fresh cooldown
                self.state = "open"
                self._opened_at = self._now()
                self._probe_out = False
                self.opens += 1
                opened = True
            else:
                self._consecutive += 1
                if self.state == "closed" and (
                    self._consecutive >= self.failures
                ):
                    self.state = "open"
                    self._opened_at = self._now()
                    self.opens += 1
                    opened = True
        if opened:
            from ..obs.events import EV_BREAKER_OPEN

            _emit_event(
                EV_BREAKER_OPEN, replica=self.replica, code=code,
                consecutive=self._consecutive, cooldown_s=self.cooldown_s,
            )


class FleetRouter:
    """Failover front door over a set of ``ReplicaClient``s.

    ``depth_fn(name) -> Optional[float]`` is the collector-substrate hook:
    the ReplicaManager wires it to the aggregated per-replica queue-depth
    gauges so balancing sees queue pressure the router did not itself
    create. ``clients`` may be mutated via ``set_clients`` as the manager
    restarts/benches replicas.
    """

    def __init__(
        self,
        clients: Dict[str, ReplicaClient],
        cfg: Optional[ServeConfig] = None,
        cache: Optional[PredictionCache] = None,
        depth_fn: Optional[Callable[[str], Optional[float]]] = None,
    ):
        self.cfg = cfg or ServeConfig()
        self._lock = threading.Lock()
        self._clients: Dict[str, ReplicaClient] = dict(clients)
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._inflight: Dict[str, int] = {}
        self._lat_ema: Dict[str, float] = {}
        self.cache = cache
        self._depth_fn = depth_fn
        self._stats = {
            "requests": 0,
            "succeeded": 0,
            "failed": 0,
            "retries": 0,
            "hedges": 0,
            "hedge_wins": 0,
            "hedge_wasted": 0,
            "cache_hits": 0,
            "cache_misses": 0,
            "router_shed": 0,
        }
        for name in clients:
            self._ensure_replica(name)

    # -- replica bookkeeping -------------------------------------------------

    def _ensure_replica(self, name: str) -> None:
        with self._lock:
            if name not in self._breakers:
                self._breakers[name] = CircuitBreaker(
                    name,
                    failures=self.cfg.breaker_failures,
                    cooldown_s=self.cfg.breaker_cooldown_s,
                )
            self._inflight.setdefault(name, 0)

    def set_clients(self, clients: Dict[str, ReplicaClient]) -> None:
        """Replace the replica set (manager restart/bench churn). Breakers
        and latency history persist across a same-name replacement — a
        restarted replica starts half-trusted, which is exactly right."""
        with self._lock:
            self._clients = dict(clients)
        for name in clients:
            self._ensure_replica(name)

    def replicas(self) -> List[str]:
        with self._lock:
            return sorted(self._clients)

    def breaker(self, name: str) -> CircuitBreaker:
        self._ensure_replica(name)
        return self._breakers[name]

    def ready_count(self) -> int:
        with self._lock:
            clients = list(self._clients.values())
        return sum(1 for c in clients if _safe_ready(c))

    # -- balancing -----------------------------------------------------------

    def _score(self, name: str, client: ReplicaClient) -> float:
        depth = None
        if self._depth_fn is not None:
            try:
                depth = self._depth_fn(name)
            except Exception:
                depth = None
        if depth is None:
            depth = client.queue_depth()
        with self._lock:
            inflight = self._inflight.get(name, 0)
            lat = self._lat_ema.get(name, 0.0)
        # queued work dominates; the latency term breaks ties toward the
        # historically faster replica (normalized so 10ms of EMA ~ one
        # queued request)
        return float(depth or 0.0) + float(inflight) + lat * 100.0

    def _pick(self, exclude: set) -> Optional[str]:
        """Choose the lowest-scored breaker-admitted replica not in
        ``exclude``. Half-open probe slots are handed out by ``allow()``;
        to avoid consuming a probe slot for a replica we do not pick, probe
        admission is re-checked only for the winner and losers' slots are
        released."""
        with self._lock:
            names = list(self._clients)
        scored: List[tuple] = []
        for n in names:
            if n in exclude:
                continue
            br = self.breaker(n)
            with br._lock:
                state = br.state
                if state == "open" and (
                    br._now() - br._opened_at < br.cooldown_s
                ):
                    continue  # hard-open: not a candidate
                if state == "half_open" and br._probe_out:
                    continue  # someone is already probing it
            with self._lock:
                client = self._clients.get(n)
            if client is None:
                continue
            scored.append((self._score(n, client), n))
        if not scored:
            return None
        scored.sort()
        for _, n in scored:
            if self.breaker(n).allow():
                return n
        return None

    # -- dispatch ------------------------------------------------------------

    def _attempt(self, name: str, graph: Graph, timeout_s: float):
        """One dispatch to one replica: returns ``("ok", result, dt)`` or
        ``("err", exc, dt)`` — never raises. Updates in-flight counts, the
        latency EMA, and the breaker."""
        with self._lock:
            client = self._clients.get(name)
            self._inflight[name] = self._inflight.get(name, 0) + 1
        t0 = time.perf_counter()
        try:
            if client is None:
                raise ReplicaUnavailableError(
                    f"replica {name} left the fleet"
                )
            result = client.predict(graph, timeout_s=timeout_s)
            dt = time.perf_counter() - t0
            with self._lock:
                prev = self._lat_ema.get(name)
                self._lat_ema[name] = (
                    dt if prev is None else 0.8 * prev + 0.2 * dt
                )
            self.breaker(name).record_success()
            return ("ok", result, dt)
        except BaseException as e:  # noqa: BLE001 — typed below
            dt = time.perf_counter() - t0
            code = getattr(e, "code", None)
            if code is None:
                e = ReplicaUnavailableError(
                    f"replica {name}: {type(e).__name__}: {e}"
                )
                code = e.code
            if code in _BREAKER_COUNTED:
                self.breaker(name).record_failure(code=code)
            return ("err", e, dt)
        finally:
            with self._lock:
                self._inflight[name] = max(
                    self._inflight.get(name, 1) - 1, 0
                )

    def _hedge_delay(self, name: str) -> float:
        with self._lock:
            ema = self._lat_ema.get(name, 0.0)
        return max(
            float(self.cfg.router_hedge_min_s),
            float(self.cfg.router_hedge_factor) * ema,
        )

    def _dispatch(self, graph: Graph, primary: str, timeout_s: float,
                  hedge: bool, tried: set):
        """Dispatch to ``primary``; optionally hedge to a second replica
        past the hedge deadline. Returns ``("ok", result, winner)`` or
        ``("err", first_error)``. Replicas used are added to ``tried``."""
        out: "queue.Queue" = queue.Queue()

        def run(name: str) -> None:
            status, payload, dt = self._attempt(name, graph, timeout_s)
            out.put((status, payload, name))

        tried.add(primary)
        threading.Thread(
            target=run, args=(primary,), daemon=True,
            name=f"router-req-{primary}",
        ).start()
        outstanding = 1
        deadline = time.monotonic() + timeout_s
        hedge_at = (
            time.monotonic() + self._hedge_delay(primary) if hedge else None
        )
        first_err: Optional[BaseException] = None
        while outstanding > 0:
            now = time.monotonic()
            if now >= deadline:
                break
            wait_until = deadline
            if hedge_at is not None:
                wait_until = min(wait_until, hedge_at)
            try:
                status, payload, name = out.get(
                    timeout=max(wait_until - now, 0.001)
                )
            except queue.Empty:
                if hedge_at is not None and time.monotonic() >= hedge_at:
                    hedge_at = None
                    mate = self._pick(exclude=tried)
                    if mate is not None:
                        tried.add(mate)
                        self._bump("hedges")
                        threading.Thread(
                            target=run, args=(mate,), daemon=True,
                            name=f"router-hedge-{mate}",
                        ).start()
                        outstanding += 1
                continue
            outstanding -= 1
            if status == "ok":
                if name != primary:
                    self._bump("hedge_wins")
                if outstanding > 0:
                    # the loser's eventual answer is discarded
                    self._bump("hedge_wasted")
                return ("ok", payload, name)
            if first_err is None:
                first_err = payload
        if first_err is None:
            first_err = DeadlineExceededError(
                f"router timeout after {timeout_s:.3f}s on {sorted(tried)}"
            )
        return ("err", first_err)

    # -- public API ----------------------------------------------------------

    def predict(
        self,
        graph: Graph,
        timeout_s: Optional[float] = None,
        priority: str = "interactive",
    ) -> Dict[str, np.ndarray]:
        """Route one prediction through the fleet. Raises a typed
        ``ServeError``; transient single-replica failures are absorbed by
        retries/hedging and never reach the caller."""
        if priority not in _PRIORITIES:
            raise ValueError(
                f"priority {priority!r} must be one of {_PRIORITIES}"
            )
        self._bump("requests")
        timeout_s = float(
            timeout_s if timeout_s is not None else self.cfg.router_timeout_s
        )
        key = None
        gk = None
        if self.cache is not None:
            # key = graph content x cache context (checkpoint digest +
            # serve config); key_for returns None while the context is
            # unknown/mixed (mid-rollout) and the cache sits out entirely
            gk = graph_key(graph)
            key = self.cache.key_for(graph, base=gk)
            if key is not None:
                hit = self.cache.get(graph, key=key)
                if hit is not None:
                    self._bump("cache_hits")
                    self._bump("succeeded")
                    return hit
                self._bump("cache_misses")

        deadline = time.monotonic() + timeout_s
        tried: set = set()
        attempts: List[str] = []
        last_err: Optional[BaseException] = None
        for attempt in range(int(self.cfg.router_retries) + 1):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            name = self._pick(exclude=tried)
            if name is None and tried:
                # every distinct replica was tried: allow a second pass
                # over the fleet rather than failing with capacity idle
                name = self._pick(exclude=set())
            if name is None:
                if not attempts:
                    self._bump("failed")
                    raise BreakerOpenError(
                        "no replica available: all breakers open or fleet "
                        "empty"
                    )
                attempts.append("no_candidate")
                break
            if priority == "batch" and self._batch_shed(name):
                self._bump("router_shed")
                raise SheddedError(
                    f"batch-priority request shed at the router: replica "
                    f"{name} projected wait exceeds the SLO",
                    projected_wait_s=self._projected_wait(name),
                    slo_s=self.cfg.slo_p99_s,
                )
            status, payload, *rest = self._dispatch(
                graph, name, min(remaining, timeout_s),
                hedge=(priority == "interactive"), tried=tried,
            )
            if status == "ok":
                self._bump("succeeded")
                if self.cache is not None and key is not None and (
                    # the context may have moved while the request was in
                    # flight (a reload finished): a prediction keyed under
                    # the old checkpoint must not land under the new one
                    self.cache.key_for(graph, base=gk) == key
                ):
                    self.cache.put(graph, payload, key=key)
                return payload
            last_err = payload
            code = getattr(payload, "code", ServeError.code)
            attempts.append(f"{name}:{code}")
            if code not in _ROUTER_RETRYABLE:
                self._bump("failed")
                raise payload
            if attempt < int(self.cfg.router_retries):
                self._bump("retries")
                backoff = float(self.cfg.router_backoff_s) * (2 ** attempt)
                time.sleep(min(backoff, max(deadline - time.monotonic(), 0)))
        self._bump("failed")
        if isinstance(last_err, ServeError) and not attempts:
            raise last_err
        raise NoReplicasError(
            f"prediction failed after {len(attempts)} attempt(s): "
            f"{attempts} (last: {last_err})",
            attempts=attempts,
        )

    def _projected_wait(self, name: str) -> float:
        with self._lock:
            client = self._clients.get(name)
            inflight = self._inflight.get(name, 0)
            lat = self._lat_ema.get(name, 0.0)
        depth = 0.0
        if client is not None:
            depth = float(client.queue_depth() or 0.0)
        return (depth + inflight) * lat

    def _batch_shed(self, name: str) -> bool:
        """Router-side shedding for batch priority: when an SLO is
        configured and the chosen replica's projected wait already blows
        it, background traffic yields instead of queueing."""
        slo = float(self.cfg.slo_p99_s)
        return slo > 0 and self._projected_wait(name) > slo

    def _bump(self, key: str, by: int = 1) -> None:
        with self._lock:
            self._stats[key] = self._stats.get(key, 0) + by

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = dict(self._stats)
            out["replicas"] = sorted(self._clients)
            out["inflight"] = dict(self._inflight)
            out["latency_ema_s"] = {
                k: round(v, 6) for k, v in self._lat_ema.items()
            }
        out["breakers"] = {
            n: b.state for n, b in list(self._breakers.items())
        }
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        return out

    def close(self) -> None:
        with self._lock:
            clients = list(self._clients.values())
        for c in clients:
            try:
                c.close()
            except Exception:
                pass


def _safe_ready(client: ReplicaClient) -> bool:
    try:
        return bool(client.ready())
    except Exception:
        return False
