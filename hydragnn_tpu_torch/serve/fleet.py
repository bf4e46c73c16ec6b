"""Replica supervisor for the serving fleet (docs/SERVING.md "Fleet").

Counterpart of ``hydragnn_tpu/serve/fleet.py``. Replica ``i`` runs on card
``(i - 1) mod count`` of the cards the manager sees
(``CUDA_VISIBLE_DEVICES``; on a one-card machine every replica shares it,
each in its own CUDA context), or where ``device`` says (``"cpu"`` in the
tests). The replicas build no kernel of their own: the kernels' build
(ops/_build.py) takes a file lock, so the first replica builds what is
missing and the others load it.

``ReplicaManager`` owns the *process-side* half of the fleet's fault model
(the router in serve/router.py owns the request-side half): N
``serve/replica.py`` subprocesses, each a full GraphServer with its own
card (per-replica env overlays reach every replica's environment),
supervised through three signals:

- **process liveness** — a dead worker (``proc.poll()``) is restarted with
  exponential backoff (``fleet_restart_backoff_s`` doubling up to the
  cap); a replica that dies ``fleet_flap_max_restarts`` times inside
  ``fleet_flap_window_s`` is BENCHED with a typed ``replica_benched``
  event and never restarted again — a flapping process is a config or
  hardware problem restarts cannot fix, and restart loops hide it;
- **readiness** — ``/readyz`` per replica (LB-safe by construction: a
  draining or warming replica reports 503);
- **heartbeats** — every replica pushes its registry (queue depth, shed
  counters, per-graph latency) to the manager's FleetCollector ~1/s; a
  replica whose heartbeat goes stale while its process is alive is WEDGED
  and gets SIGKILLed into the normal restart path.

The manager aggregates the fleet view two ways: live gauges
(``hydragnn_fleet_serve_*`` on its own /metrics endpoint, per-replica
queue depth mirrored from the collector) and ~1/s ``fleet_serve`` records
appended to the run dir's metrics.jsonl — the stream the run doctor's
``queue_saturation``/``shed_spiral`` rules consume so fleet-wide
saturation is ONE finding, not N.

Rolling reload (``rolling_reload``): replicas swap one at a time, each
gated on the fleet's ready count staying at or above
``ceil(fleet_ready_floor x N)``. After the FIRST replica swaps, it is
probed with ``reload_probe_requests`` real requests; an error rate >=
``reload_error_spike`` rolls that replica back to its prior checkpoint
(typed ``reload_rollback`` event) and aborts the rollout — a regressed
checkpoint reaches at most one replica.

Host-index convention: the manager is fleet host 0; replicas are hosts
1..N. That gives each process its own ``events-h<i>.jsonl``/
``metrics-h<i>.jsonl`` stream (the doctor merges them) and leaves the
unsuffixed host-0 streams to the manager's aggregate records.
"""

from __future__ import annotations

import json
import math
import os
import signal
import subprocess
import sys
import threading
import time
import warnings
from collections import deque
from typing import Any, Dict, List, Optional

from ..data.graph import Graph
from .cache import PredictionCache
from .config import ServeConfig
from .router import FleetRouter, HTTPReplicaClient

_SUPERVISE_TICK_S = 0.2
_METRICS_PERIOD_S = 1.0
_SPAWN_READY_TIMEOUT_S = 600.0
# floor on how soon after (re)start wedge detection may judge a replica.
# The real gate is per-incarnation: _spawn() forgets the collector's host
# entry, so staleness can only be measured against heartbeats the NEW
# process pushed (warm-up may legitimately push nothing for minutes).
_WEDGE_GRACE_S = 10.0
# how often the manager re-derives the prediction-cache context (installed
# checkpoint digest x serve config) from replica /stats
_CACHE_CTX_REFRESH_S = 5.0
# replicas heartbeat ~1/s, so a 5 s silence is a wedge, not jitter (the
# collector's adaptive threshold still stretches this for slow pushers)
_STALE_AFTER_S = 5.0


def _emit_event(kind: str, **attrs: Any) -> None:
    try:
        from ..obs.events import emit

        emit(kind, **attrs)
    except Exception:
        pass


class _Replica:
    """Supervisor-side record of one worker (not the transport — that is
    the router's HTTPReplicaClient, rebuilt on every restart)."""

    def __init__(self, index: int):
        self.index = index  # fleet host index, 1-based
        self.name = f"replica{index}"
        self.proc: Optional[subprocess.Popen] = None
        self.port: Optional[int] = None
        self.pid: Optional[int] = None
        self.log_fh = None
        self.benched = False
        self.deaths: "deque[float]" = deque()
        self.consecutive_restarts = 0
        self.restart_at: Optional[float] = None
        self.started_at = 0.0
        self.restarts = 0

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class ReplicaManager:
    """Spawn, health-gate, restart/bench, and roll-reload N replica
    workers; expose the fleet through ``router()``.

    ``config`` is a run config dict or a JSON config path (dicts are
    written to ``<run_dir>/serve_fleet_config.json`` for the children).
    ``per_replica_env`` maps a replica index (1-based) to extra env for
    that worker; it wins over the card pinning. ``device`` is written
    into the replicas' config (its top-level ``"device"``): None runs them
    on the cards.
    """

    def __init__(
        self,
        config,
        serve_cfg: Optional[ServeConfig] = None,
        path: str = "./logs",
        log_name: Optional[str] = None,
        per_replica_env: Optional[Dict[int, Dict[str, str]]] = None,
        replicas: Optional[int] = None,
        device=None,
    ):
        from ..config.config import get_log_name_config, load_config

        if isinstance(config, str):
            config_dict = load_config(config)
        else:
            config_dict = json.loads(json.dumps(dict(config)))
        self.cfg = serve_cfg or ServeConfig.from_config(config_dict)
        n = replicas if replicas is not None else self.cfg.fleet_replicas
        self.n = int(n)
        if self.n < 1:
            raise ValueError(
                f"fleet needs at least 1 replica (Serving.fleet_replicas or "
                f"replicas=), got {self.n}"
            )
        self.path = os.path.abspath(path)  # the run dir stays put when the caller moves
        self.log_name = log_name or get_log_name_config(config_dict)
        self.run_dir = os.path.join(self.path, self.log_name)
        os.makedirs(self.run_dir, exist_ok=True)
        # children always run a manager-authored config: every replica must
        # bind an ephemeral port (a pinned http_port would collide N ways),
        # and reloads are manager-orchestrated — hot_reload stays on so the
        # watcher exists for /reload {"poll": true}, but its own poll loop
        # is parked far in the future so it cannot race the rollout stagger
        serving = dict(config_dict.get("Serving") or {})
        serving["http_port"] = 0
        serving["hot_reload"] = True
        serving["reload_poll_s"] = 10.0 ** 9
        config_dict["Serving"] = serving
        if device is not None:
            config_dict["device"] = str(device)
        self._cards = self._visible_cards(config_dict.get("device"))
        self._config_path = os.path.join(
            self.run_dir, "serve_fleet_config.json"
        )
        tmp = f"{self._config_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(config_dict, f)
        os.replace(tmp, self._config_path)
        self.rendezvous_dir = os.path.join(self.run_dir, "fleet_rendezvous")
        os.makedirs(self.rendezvous_dir, exist_ok=True)
        self._per_replica_env = dict(per_replica_env or {})
        # every incarnation runs where the manager was made: its ./logs is
        # where the replicas restore from, restarts included
        self.cwd = os.getcwd()
        self._replicas = {i: _Replica(i) for i in range(1, self.n + 1)}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._router: Optional[FleetRouter] = None
        self._cache: Optional[PredictionCache] = None
        self._metrics_fh = None
        self._last_metrics = 0.0
        self._supervisor: Optional[threading.Thread] = None
        self._ctx_thread: Optional[threading.Thread] = None
        self._reloading = False
        self._closed = False

        # collector + push endpoint: the manager is fleet host 0
        from ..obs.events import attach_stream
        from ..obs.fleet import FleetCollector
        from ..obs.prometheus import TelemetryHTTPServer
        from ..obs.registry import registry

        attach_stream(self.run_dir)
        self.collector = FleetCollector(stale_after_s=_STALE_AFTER_S)
        self._http = TelemetryHTTPServer(
            reg=registry(),
            port=0,
            ready_fn=lambda: self.ready_count() > 0,
            health_fn=lambda: (not self._closed, "fleet manager"),
            post_routes={"/fleet/push": self._handle_push},
        )
        self.push_url = f"{self._http.url}/fleet/push"
        reg = registry()
        self._g_replicas = reg.gauge(
            "hydragnn_fleet_serve_replicas",
            "Serving replicas configured (fleet manager)",
        )
        self._g_ready = reg.gauge(
            "hydragnn_fleet_serve_ready",
            "Serving replicas currently ready (/readyz)",
        )
        self._g_benched = reg.gauge(
            "hydragnn_fleet_serve_benched",
            "Serving replicas benched by the flap breaker",
        )
        self._g_depth = reg.gauge(
            "hydragnn_fleet_serve_queue_depth",
            "Per-replica serve queue depth (heartbeat mirror)",
            labelnames=("replica",),
        )
        self._g_replicas.set(self.n)
        self._g_benched.set(0)

    # -- spawning ------------------------------------------------------------

    @staticmethod
    def _visible_cards(device) -> List[str]:
        """The card ids the replicas are pinned over, in order: the
        manager's ``CUDA_VISIBLE_DEVICES`` or every card it sees; none for
        a replica off the cards."""
        if device is not None and not str(device).startswith("cuda"):
            return []
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        if visible:
            return [c.strip() for c in visible.split(",") if c.strip()]
        try:
            import torch

            return [str(i) for i in range(torch.cuda.device_count())]
        except Exception:  # noqa: BLE001 -- no torch.cuda: nothing to pin
            return []

    def _child_env(self, index: int) -> Dict[str, str]:
        env = dict(os.environ)
        # the replica imports this checkout's package from any working dir
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        if self._cards:
            env["CUDA_VISIBLE_DEVICES"] = self._cards[(index - 1) % len(self._cards)]
        env["HYDRAGNN_FLEET_HOST_INDEX"] = str(index)
        env["HYDRAGNN_FLEET_HOST_COUNT"] = str(self.n + 1)
        env["HYDRAGNN_SERVE_RENDEZVOUS"] = self.rendezvous_dir
        env["HYDRAGNN_SERVE_FLEET_PUSH"] = self.push_url
        env.update(self._per_replica_env.get(index, {}))
        return env

    def _spawn(self, rep: _Replica) -> None:
        # stale rendezvous from a previous life must not be mistaken for
        # the new worker — remove before spawn, then poll for the rewrite
        rv = os.path.join(self.rendezvous_dir, f"replica_{rep.index}.json")
        try:
            os.remove(rv)
        except OSError:
            pass
        # same for the heartbeat state: the dead incarnation's collector
        # entry goes stale within seconds, and the new process does not
        # push until its warm-up completes (up to _SPAWN_READY_TIMEOUT_S)
        # — judged against the old entry, every restart would be SIGKILLed
        # as "wedged" ~10s in and flap-benched after one real crash.
        # Forgetting the entry means staleness is only ever measured
        # against heartbeats this incarnation actually sent.
        self.collector.forget(rep.index)
        if rep.log_fh is None:
            rep.log_fh = open(
                os.path.join(self.run_dir, f"replica_{rep.index}.log"), "ab"
            )
        rep.proc = subprocess.Popen(
            [sys.executable, "-m", "hydragnn_tpu_torch.serve.replica",
             self._config_path],
            env=self._child_env(rep.index),
            stdout=rep.log_fh,
            stderr=subprocess.STDOUT,
            cwd=self.cwd,
        )
        rep.started_at = time.monotonic()
        rep.restart_at = None
        rep.port = None
        rep.pid = rep.proc.pid

    def _read_rendezvous(self, rep: _Replica) -> bool:
        """Pick up the worker's published port once it appears; returns
        True when the client transport is (re)built."""
        rv = os.path.join(self.rendezvous_dir, f"replica_{rep.index}.json")
        try:
            with open(rv) as f:
                info = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False
        if rep.proc is None or int(info.get("pid", -1)) != rep.proc.pid:
            return False  # a previous life's file
        rep.port = int(info["port"])
        self._rebuild_router_clients()
        return True

    def start(self) -> "ReplicaManager":
        for rep in self._replicas.values():
            self._spawn(rep)
        self._supervisor = threading.Thread(
            target=self._supervise, daemon=True, name="fleet-supervisor"
        )
        self._supervisor.start()
        return self

    def wait_ready(self, timeout: Optional[float] = None,
                   min_ready: Optional[int] = None) -> bool:
        """Block until ``min_ready`` (default: all non-benched) replicas
        report /readyz."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                target = min_ready if min_ready is not None else sum(
                    1 for r in self._replicas.values() if not r.benched
                )
            if target <= 0:
                return False
            if self.ready_count() >= target:
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.2)

    # -- fleet views ---------------------------------------------------------

    def clients(self) -> Dict[str, HTTPReplicaClient]:
        with self._lock:
            reps = [
                r for r in self._replicas.values()
                if not r.benched and r.port is not None
            ]
        return {
            r.name: HTTPReplicaClient(
                f"http://127.0.0.1:{r.port}", name=r.name
            )
            for r in reps
        }

    def router(self) -> FleetRouter:
        """The fleet's front door (one per manager; cached). Wires the
        collector's per-replica queue-depth gauges in as the balancing
        signal and the prediction cache when configured. The cache starts
        DISABLED (context None) and only serves once every reachable
        replica agrees on its installed checkpoint — the context (that
        checkpoint's digest x ``weights_dtype``) namespaces every key, so
        a rolling reload can never surface a prior checkpoint's cached
        prediction as a hit."""
        if self._router is None:
            cache = None
            pc = self.cfg.prediction_cache
            if pc:
                cache_dir = (
                    pc if isinstance(pc, str)
                    else os.path.join(self.run_dir, "pred_cache")
                )
                self._cache = cache = PredictionCache(cache_dir, context=None)
                self._refresh_cache_context()
                self._ctx_thread = threading.Thread(
                    target=self._cache_ctx_loop, daemon=True,
                    name="fleet-cache-ctx",
                )
                self._ctx_thread.start()
            self._router = FleetRouter(
                self.clients(), cfg=self.cfg, cache=cache,
                depth_fn=self._depth_of,
            )
        return self._router

    def _cache_context(self) -> Optional[str]:
        """The non-graph component of a prediction-cache key, or ``None``
        (cache disabled) while it cannot be pinned down: the sha256 of the
        checkpoint every reachable replica currently serves (its sidecar
        digest when present, the entry name otherwise) plus the
        prediction-affecting serve config. Replicas disagreeing — a
        rollout in flight, or a restart that restored a newer pointer —
        means NO shared entry is safe, so the cache sits out."""
        with self._lock:
            reps = [
                r for r in self._replicas.values()
                if not r.benched and r.port is not None
            ]
        entries = set()
        for rep in reps:
            try:
                entries.add(str(self._replica_stat(rep, "current_checkpoint")))
            except Exception:  # noqa: BLE001 — unreachable: just excluded
                continue
        if len(entries) != 1:
            return None
        entry = entries.pop()
        ident = entry
        try:
            # the checkpoint plane writes a sha256 sidecar next to every
            # entry (train/checkpoint.py) — key on content, not filename
            with open(os.path.join(self.run_dir, entry + ".sha256")) as f:
                ident = f"{entry}:{f.read().strip()}"
        except OSError:
            pass
        ctx = f"ckpt={ident};weights_dtype={self.cfg.weights_dtype}"
        if self.cfg.weights_dtype == "int8" and self.cfg.quantization:
            # int8 predictions depend on the quantization recipe too — a
            # weight_only fleet and a w8a8 fleet must never share entries
            ctx += f";quant={self.cfg.quantization.mode}"
        return ctx

    def _refresh_cache_context(self) -> None:
        if self._cache is None or self._reloading:
            return
        ctx = self._cache_context()
        if not self._reloading:
            self._cache.set_context(ctx)

    def _cache_ctx_loop(self) -> None:
        # off the supervisor thread: deriving the context blocks on
        # replica /stats HTTP calls, and restarts/wedge checks must not
        # wait behind a dead replica's connect timeout
        while not self._stop.wait(_CACHE_CTX_REFRESH_S):
            try:
                self._refresh_cache_context()
            except Exception:  # noqa: BLE001 — cache is an accelerator
                pass

    def _depth_of(self, name: str) -> Optional[float]:
        try:
            index = int(name.replace("replica", ""))
        except ValueError:
            return None
        series = self.collector.host_series(index)
        return series.get("hydragnn_serve_queue_depth")

    def _rebuild_router_clients(self) -> None:
        if self._router is not None:
            self._router.set_clients(self.clients())

    def ready_count(self) -> int:
        count = 0
        for name, client in self.clients().items():
            try:
                if client.ready():
                    count += 1
            except Exception:
                pass
        return count

    def replica_state(self) -> Dict[int, Dict[str, Any]]:
        with self._lock:
            return {
                r.index: {
                    "alive": r.alive(),
                    "benched": r.benched,
                    "port": r.port,
                    "pid": r.pid,
                    "restarts": r.restarts,
                }
                for r in self._replicas.values()
            }

    # -- supervision ---------------------------------------------------------

    def _handle_push(self, body: bytes):
        payload = json.loads(body.decode("utf-8"))
        return 200, self.collector.absorb(payload)

    def _backoff_s(self, rep: _Replica) -> float:
        base = float(self.cfg.fleet_restart_backoff_s) or 0.05
        return min(
            base * (2 ** rep.consecutive_restarts),
            float(self.cfg.fleet_restart_backoff_max_s),
        )

    def _on_death(self, rep: _Replica, now: float) -> None:
        code = rep.proc.poll() if rep.proc is not None else None
        _emit_event(
            "replica_exit", replica=rep.index, returncode=code,
            restarts=rep.restarts,
        )
        rep.deaths.append(now)
        window = float(self.cfg.fleet_flap_window_s)
        while rep.deaths and now - rep.deaths[0] > window:
            rep.deaths.popleft()
        if len(rep.deaths) >= int(self.cfg.fleet_flap_max_restarts):
            rep.benched = True
            rep.proc = None
            rep.port = None
            _emit_event(
                "replica_benched", replica=rep.index,
                deaths_in_window=len(rep.deaths), window_s=window,
                remediation="inspect replica_<i>.log; the flap breaker "
                "never restarts a benched replica — fix and restart the "
                "fleet",
            )
            self._g_benched.set(
                sum(1 for r in self._replicas.values() if r.benched)
            )
            self._rebuild_router_clients()
            return
        delay = self._backoff_s(rep)
        rep.restart_at = now + delay
        rep.proc = None
        rep.port = None
        self._rebuild_router_clients()

    def _supervise(self) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            with self._lock:
                reps = list(self._replicas.values())
            for rep in reps:
                if rep.benched:
                    continue
                if rep.proc is not None and rep.proc.poll() is not None:
                    self._on_death(rep, now)
                elif rep.proc is None and rep.restart_at is not None:
                    if now >= rep.restart_at:
                        rep.consecutive_restarts += 1
                        rep.restarts += 1
                        _emit_event(
                            "replica_restart", replica=rep.index,
                            restarts=rep.restarts,
                            backoff_s=round(self._backoff_s(rep), 3),
                        )
                        self._spawn(rep)
                elif rep.proc is not None:
                    if rep.port is None:
                        self._read_rendezvous(rep)
                    # a stable stretch clears the backoff escalation
                    if rep.consecutive_restarts and (
                        now - rep.started_at
                        > float(self.cfg.fleet_flap_window_s)
                    ):
                        rep.consecutive_restarts = 0
                    self._check_wedged(rep, now)
            self._publish(now)
            self._stop.wait(_SUPERVISE_TICK_S)

    def _check_wedged(self, rep: _Replica, now: float) -> None:
        """A live process whose heartbeat went stale is wedged (device
        hang, GIL-holding bug): SIGKILL it into the normal death path —
        the restart gets a fresh runner, and repeated wedges hit the flap
        breaker like any other crash loop. Staleness is judged strictly
        per incarnation: ``_spawn`` forgets the collector's host entry,
        so until THIS process heartbeats there is no entry to go stale
        and a slow warm-up can never be mistaken for a wedge."""
        if now - rep.started_at < _WEDGE_GRACE_S:
            return
        # the collector only sweeps staleness inside absorb(); with every
        # replica wedged nobody pushes, so the supervisor drives the sweep
        self.collector.sweep()
        hosts = self.collector.hosts()
        st = hosts.get(rep.index)
        if st is not None and st.get("stale") and rep.alive():
            _emit_event(
                "replica_exit", replica=rep.index, returncode=None,
                cause="wedged (stale heartbeat); killed by supervisor",
            )
            try:
                rep.proc.kill()
            except OSError:
                pass

    # -- aggregation ---------------------------------------------------------

    def _publish(self, now: float) -> None:
        ready = 0
        depth_sum = 0.0
        depth_max = 0.0
        shed_total = 0.0
        queue_full_total = 0.0
        completed_total = 0.0
        per_replica: Dict[str, Dict[str, float]] = {}
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            series = self.collector.host_series(rep.index)
            depth = float(series.get("hydragnn_serve_queue_depth", 0.0))
            shed = float(series.get(
                'hydragnn_serve_events_total{event="shed"}', 0.0
            ))
            qfull = float(series.get(
                'hydragnn_serve_events_total{event="queue_full"}', 0.0
            ))
            completed = float(series.get(
                'hydragnn_serve_events_total{event="completed"}', 0.0
            ))
            rdy = float(series.get("hydragnn_serve_ready", 0.0))
            if not rep.benched and rep.alive() and rdy >= 1.0:
                ready += 1
            depth_sum += depth
            depth_max = max(depth_max, depth)
            shed_total += shed
            queue_full_total += qfull
            completed_total += completed
            self._g_depth.set(depth, replica=str(rep.index))
            per_replica[str(rep.index)] = {
                "queue_depth": depth, "shed": shed,
                "queue_full": qfull, "ready": rdy,
            }
        self._g_ready.set(ready)
        if now - self._last_metrics >= _METRICS_PERIOD_S:
            self._last_metrics = now
            self._write_metrics_record(
                ready, depth_sum, depth_max, shed_total, queue_full_total,
                completed_total, per_replica,
            )

    def _write_metrics_record(self, ready, depth_sum, depth_max, shed,
                              qfull, completed, per_replica) -> None:
        from ..obs.schema import METRICS_SCHEMA_VERSION

        live = max(
            sum(1 for r in self._replicas.values() if not r.benched), 1
        )
        rec = {
            "v": METRICS_SCHEMA_VERSION,
            "ts": round(time.time(), 3),
            "kind": "fleet_serve",
            "host": 0,
            "replicas": self.n,
            "ready": int(ready),
            "benched": sum(
                1 for r in self._replicas.values() if r.benched
            ),
            "queue_depth_mean": round(depth_sum / live, 3),
            "queue_depth_max": depth_max,
            "shed_total": shed,
            "queue_full_total": qfull,
            "completed_total": completed,
            "per_replica": per_replica,
        }
        cache = getattr(self, "_cache", None)
        if cache is not None:
            # prediction-cache efficacy ride-along (optional schema
            # fields): the doctor's cache_ineffective rule reads these
            cs = cache.stats()
            rec["cache_enabled"] = cache.context is not None
            rec["cache_hits"] = cs["hits"]
            rec["cache_misses"] = cs["misses"]
            rec["cache_stores"] = cs["stores"]
            rec["cache_entries"] = cs["entries"]
            rec["cache_bytes"] = cs["bytes"]
        try:
            if self._metrics_fh is None:
                self._metrics_fh = open(
                    os.path.join(self.run_dir, "metrics.jsonl"), "a"
                )
            self._metrics_fh.write(json.dumps(rec) + "\n")
            self._metrics_fh.flush()
        except (OSError, ValueError):
            self._metrics_fh = None

    # -- rolling reload ------------------------------------------------------

    def _replica_stat(self, rep: _Replica, field: str) -> Any:
        client = HTTPReplicaClient(f"http://127.0.0.1:{rep.port}")
        import urllib.request

        req = urllib.request.Request(
            client.base_url + "/stats", data=b"{}",
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(req, timeout=5.0) as resp:
            return json.loads(resp.read().decode("utf-8")).get(field)

    def _post_reload(self, rep: _Replica, body: Dict[str, Any]
                     ) -> Dict[str, Any]:
        import urllib.request

        req = urllib.request.Request(
            f"http://127.0.0.1:{rep.port}/reload",
            data=json.dumps(body).encode("utf-8"),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(req, timeout=30.0) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def rolling_reload(self, probe_graphs: List[Graph],
                       timeout_s: float = 120.0) -> Dict[str, Any]:
        """Stagger checkpoint reloads across the fleet, one replica at a
        time, capacity-floor gated, with first-replica regression probing
        and automatic rollback. Always returns a status dict
        (``{"status": "done"|"rolled_back"|"aborted", ...}``) — a replica
        that becomes unreachable mid-roll is skipped with a warning, never
        surfaced as a raw transport error, and a rollback whose POST fails
        reports ``rollback_ok: False`` + ``rollback_error``. While the
        rollout is in flight the prediction cache is disabled (mixed-fleet
        window); it re-enables under the new checkpoint's context once the
        fleet agrees again."""
        if not probe_graphs:
            raise ValueError(
                "rolling_reload needs probe graphs to verify the first "
                "reloaded replica"
            )
        floor = math.ceil(float(self.cfg.fleet_ready_floor) * self.n)
        deadline = time.monotonic() + float(timeout_s)
        installed = 0
        first_probed = False
        min_ready_seen = self.n
        with self._lock:
            reps = [
                r for r in self._replicas.values()
                if not r.benched and r.port is not None
            ]
        # mid-rollout the fleet serves two checkpoints at once: no shared
        # cache entry is safe, so the cache sits out until the rollout
        # settles and the context is re-derived from the fleet's agreement
        self._reloading = True
        if self._cache is not None:
            self._cache.set_context(None)
        try:
            return self._rolling_reload(
                reps, probe_graphs, floor, deadline, installed,
                first_probed, min_ready_seen,
            )
        finally:
            self._reloading = False
            self._refresh_cache_context()

    def _rolling_reload(self, reps, probe_graphs, floor, deadline,
                        installed, first_probed, min_ready_seen
                        ) -> Dict[str, Any]:
        for rep in reps:
            # capacity gate: proceed only while the REST of the fleet
            # keeps aggregate ready capacity at/above the floor (the
            # reloading replica itself stays ready — swaps are staged
            # between batches — but a concurrently crashed replica must
            # pause the rollout)
            while True:
                ready = self.ready_count()
                min_ready_seen = min(min_ready_seen, ready)
                if ready >= floor:
                    break
                if time.monotonic() >= deadline:
                    return {
                        "status": "aborted",
                        "reason": f"ready count {ready} below floor "
                                  f"{floor}; rollout timed out",
                        "installed": installed,
                        "min_ready_seen": min_ready_seen,
                    }
                time.sleep(0.2)
            try:
                prior = self._replica_stat(rep, "current_checkpoint")
                out = self._post_reload(rep, {"poll": True})
            except Exception as e:  # noqa: BLE001 — replica died mid-roll
                # an unreachable replica is the supervisor's problem (it
                # restarts on the LATEST pointer anyway); the rollout
                # skips it instead of leaking a transport error to the
                # caller in place of the documented status dict
                warnings.warn(
                    f"rolling reload: replica {rep.index} unreachable "
                    f"({type(e).__name__}: {e}); skipping",
                    RuntimeWarning, stacklevel=2,
                )
                continue
            if out.get("status") != "installed":
                # unchanged pointer or rejected candidate: nothing swapped
                continue
            # the serve loop takes the staged swap at the next batch
            # boundary (~one tick); wait for the visible flip
            entry = self._wait_checkpoint_change(rep, prior, deadline)
            installed += 1
            if not first_probed:
                first_probed = True
                verdict = self._probe_first(rep, probe_graphs)
                if verdict["error_rate"] >= float(
                    self.cfg.reload_error_spike
                ):
                    rollback_error = None
                    try:
                        self._post_reload(rep, {"entry": prior})
                    except Exception as e:  # noqa: BLE001 — died mid-roll
                        # the regressed checkpoint may still be installed
                        # on this replica: report it, never swallow it —
                        # the caller (and the doctor) must know the
                        # rollback did not land
                        rollback_error = f"{type(e).__name__}: {e}"
                        warnings.warn(
                            f"rolling reload: rollback POST to replica "
                            f"{rep.index} failed ({rollback_error}); the "
                            f"regressed checkpoint may still be serving "
                            f"there until the supervisor restarts it",
                            RuntimeWarning, stacklevel=2,
                        )
                    _emit_event(
                        "reload_rollback", replica=rep.index,
                        rolled_back_to=prior, regressed=entry,
                        error_rate=verdict["error_rate"],
                        probes=verdict["probes"],
                        rollback_error=rollback_error,
                    )
                    return {
                        "status": "rolled_back",
                        "replica": rep.index,
                        "prior": prior,
                        "regressed": entry,
                        "error_rate": verdict["error_rate"],
                        "installed": installed,
                        "min_ready_seen": min_ready_seen,
                        "rollback_ok": rollback_error is None,
                        "rollback_error": rollback_error,
                    }
        return {
            "status": "done",
            "installed": installed,
            "min_ready_seen": min_ready_seen,
            "floor": floor,
        }

    def _wait_checkpoint_change(self, rep: _Replica, prior: Any,
                                deadline: float) -> Any:
        while time.monotonic() < deadline:
            try:
                cur = self._replica_stat(rep, "current_checkpoint")
            except Exception as e:  # noqa: BLE001 — replica died mid-swap
                # do not stall the whole rollout polling a dead replica:
                # the supervisor restarts it on the latest pointer anyway
                warnings.warn(
                    f"rolling reload: replica {rep.index} unreachable "
                    f"while awaiting its swap ({type(e).__name__}: {e})",
                    RuntimeWarning, stacklevel=2,
                )
                return prior
            if cur != prior:
                return cur
            time.sleep(0.1)
        return prior

    def _probe_first(self, rep: _Replica,
                     probe_graphs: List[Graph]) -> Dict[str, Any]:
        client = HTTPReplicaClient(
            f"http://127.0.0.1:{rep.port}", name=rep.name
        )
        probes = max(int(self.cfg.reload_probe_requests), 1)
        errors = 0
        for k in range(probes):
            g = probe_graphs[k % len(probe_graphs)]
            try:
                client.predict(g, timeout_s=30.0)
            except Exception:  # noqa: BLE001 — any failure counts against
                # the canary (typed serve errors AND transport loss: a
                # replica that died under probing is a regression signal)
                errors += 1
        return {"probes": probes, "errors": errors,
                "error_rate": errors / probes}

    def poll_reload_once(self) -> Dict[int, str]:
        """Deterministic per-replica single poll (tests/smokes): no
        capacity gating, no probing — just ask each replica to take one
        watcher poll and report the outcome."""
        out: Dict[int, str] = {}
        with self._lock:
            reps = [
                r for r in self._replicas.values()
                if not r.benched and r.port is not None
            ]
        for rep in reps:
            try:
                out[rep.index] = self._post_reload(
                    rep, {"poll": True}
                ).get("status", "unreachable")
            except Exception:
                out[rep.index] = "unreachable"
        return out

    # -- teardown ------------------------------------------------------------

    def close(self, timeout_s: float = 30.0) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout=5.0)
        if self._ctx_thread is not None:
            self._ctx_thread.join(timeout=5.0)
        if self._router is not None:
            self._router.close()
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            if rep.alive():
                try:
                    rep.proc.send_signal(signal.SIGTERM)  # graceful drain
                except OSError:
                    pass
        deadline = time.monotonic() + timeout_s
        for rep in reps:
            if rep.proc is None:
                continue
            remaining = max(deadline - time.monotonic(), 0.1)
            try:
                rep.proc.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                rep.proc.kill()
                try:
                    rep.proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    pass
            if rep.log_fh is not None:
                try:
                    rep.log_fh.close()
                except OSError:
                    pass
                rep.log_fh = None
        self._http.close()
        if self._metrics_fh is not None:
            try:
                self._metrics_fh.close()
            except OSError:
                pass
            self._metrics_fh = None
        from ..obs.events import detach_stream

        detach_stream()

    def __enter__(self) -> "ReplicaManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
