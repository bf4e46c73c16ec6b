"""Fleet observability plane: cross-host aggregation, straggler/desync
detection, and per-host trace stitching (docs/OBSERVABILITY.md "Fleet").

Counterpart of ``hydragnn_tpu/obs/fleet.py``, with its payloads, series,
events and decisions. The registry, metrics.jsonl, trace.jsonl and flight
dumps of one process carry no cross-host view; this module is the layer
above them:

- **host identity** (``host_identity``): every metrics.jsonl record, span,
  build-info scrape, and flight dump self-identifies with the process
  index. ``HYDRAGNN_FLEET_HOST_INDEX``/``_COUNT`` override the
  ``torch.distributed`` rank so a fleet of independent processes (the
  serving replicas) carries real host identities.
- **push-based aggregation**: every host's ``StepTelemetry`` flush window
  serializes its registry (``registry_snapshot``) and POSTs it to the
  rank-0 collector over the existing Prometheus/HTTP substrate
  (obs/prometheus.py ``post_routes``) — loopback-compatible, so the
  single-host degenerate case runs the identical path. The collector
  merges per-host snapshots (counters max-merge, gauges last-write — the
  registry's own absorption semantics, applied across pushes) and
  publishes ``hydragnn_fleet_{min,mean,max}{series=...}`` across-host
  aggregates plus per-host step / step-lag / staleness gauges.
- **straggler & desync watchdog**: each push doubles as a heartbeat
  carrying the host's step index, window step time, and (once comm
  accounting lands with the distributed capture; null until then) its
  estimated collective fraction.
  The collector flags a host whose step time skews beyond
  ``fleet_straggler_factor`` x the fleet median (or whose collective
  fraction exceeds ``fleet_collective_budget``) as ``fleet_straggler``,
  and step progress skewed past ``fleet_max_step_lag`` as
  ``fleet_desync``. A detection queues a broadcast command; every host
  applies it exactly once from its next push response — emitting the
  typed event locally and triggering a coordinated flight-recorder dump
  keyed by the same fleet step index (dump directories are
  host-disambiguated, obs/flightrec.py). A host whose heartbeat goes
  missing past ``fleet_stale_after_s`` goes STALE: its series leave the
  fleet aggregates (they must not freeze them) and ``fleet_host_stale``
  is emitted once.
- **trace stitching** (``merge_traces`` / ``python -m
  hydragnn_tpu_torch.obs.fleet``): per-host trace.jsonl streams (spans carry
  their host, obs/trace.py) merge into one time-ordered run-level view.

Everything here follows the plane's contract: observability never takes
the owner down. A dead collector degrades pushes to warn-once retries; a
bind failure degrades the collector to local-only; fleet off means ZERO
extra work (the loop holds no plane object at all) and the step program
is untouched either way — the fleet is host-side only by construction.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
import warnings
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .events import EV_FLEET_DESYNC, EV_FLEET_HOST_STALE, EV_FLEET_STRAGGLER
from .events import emit as emit_event
from .registry import MetricsRegistry, registry
from ..utils import envflags

# push payload schema version (the fleet analog of metrics.jsonl "v")
FLEET_SCHEMA_VERSION = 1

# how many broadcast commands the collector retains for late pushers; a
# host further behind than this missed a window the watchdog already
# re-fires on, so unbounded retention buys nothing
_COMMAND_RING = 16

# minimum seconds between pushes: a fast CPU step loop can flush telemetry
# windows every few milliseconds, and serializing + POSTing the registry at
# that rate is a double-digit step-time tax (the fleet smoke's A/B caught
# exactly this). 1 Hz is plenty for a 30 s staleness timeout and a
# seconds-scale watchdog — the same rate-limit discipline as the memory
# gauges and stream flushes (obs/telemetry.py).
_PUSH_MIN_INTERVAL_S = 1.0


def host_identity() -> Tuple[int, int]:
    """(host_index, host_count) of this process in the fleet.

    ``HYDRAGNN_FLEET_HOST_INDEX``/``HYDRAGNN_FLEET_HOST_COUNT`` override
    (independent processes, such as serving replicas, each believe they
    are rank 0: the env gives them their fleet identity); otherwise the
    joined ``torch.distributed`` group's rank, falling back to the
    scheduler envs (``WORLD_SIZE``/``RANK``, SLURM, OMPI — parallel/mesh.py
    ``local_host_info``); (0, 1) without any of them."""
    env_i = envflags.env_str("HYDRAGNN_FLEET_HOST_INDEX")
    env_c = envflags.env_str("HYDRAGNN_FLEET_HOST_COUNT")
    if env_i is not None or env_c is not None:
        try:
            return int(env_i or 0), max(int(env_c or 1), 1)
        except ValueError:
            # a typo'd identity env must not take the owner down (this
            # runs inside MetricsStream/Tracer construction) — warn and
            # fall through to the runtime/scheduler resolution
            warnings.warn(
                "malformed HYDRAGNN_FLEET_HOST_INDEX/_COUNT "
                f"({env_i!r}/{env_c!r}); falling back to the runtime's "
                "host identity",
                RuntimeWarning,
                stacklevel=2,
            )
    try:
        from ..parallel.mesh import local_host_info

        count, index = local_host_info()
        return index, count
    except Exception:
        return 0, 1


def _valid_collector_addr(addr: str) -> bool:
    """The 'host:port' grammar resolve_telemetry enforces on the config
    key, shared with the env path (obs/telemetry.py validation)."""
    host_part, sep, port_part = addr.rpartition(":")
    return bool(sep) and bool(host_part) and port_part.isdigit()


def series_key(name: str, labels: Iterable[Tuple[str, str]]) -> str:
    """Canonical one-string series identity (``name{k="v",...}``) — the
    label value of the fleet aggregate gauges."""
    labs = list(labels)
    if not labs:
        return name
    return name + "{" + ",".join(f'{k}="{v}"' for k, v in labs) + "}"


def registry_snapshot(
    reg: Optional[MetricsRegistry] = None,
) -> List[Dict[str, Any]]:
    """Serialize the registry's scalar samples for one push: counters and
    gauges verbatim, histograms as their ``_sum``/``_count`` series
    (buckets are excluded — per-host bucket CDFs do not min/mean/max into
    anything meaningful and dominate payload size). The fleet's own
    ``hydragnn_fleet_*`` output gauges are excluded too, or the rank-0
    host would aggregate its aggregates."""
    reg = reg if reg is not None else registry()
    out: List[Dict[str, Any]] = []
    for metric in reg.collect():
        if metric.name.startswith("hydragnn_fleet_"):
            continue
        for suffix, labels, value in metric.samples():
            if suffix == "_bucket":
                continue
            out.append(
                {
                    "n": metric.name + suffix,
                    "k": metric.kind,
                    "l": [list(kv) for kv in labels],
                    "v": float(value),
                }
            )
    return out


class _HostState:
    """Collector-side view of one pushing host."""

    __slots__ = (
        "host", "step", "step_time_s", "comm_fraction", "ts", "mono",
        "counters", "gauges", "stale", "pushes", "delivered_cmd",
        "push_gap_ema",
    )

    def __init__(self, host: int):
        self.host = host
        self.step = 0
        self.step_time_s: Optional[float] = None
        self.comm_fraction: Optional[float] = None
        self.ts = 0.0
        self.mono = 0.0
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.stale = False
        self.pushes = 0
        # highest broadcast-command id already RETURNED to this host:
        # a restarted pusher (fresh ack=0) must not replay the whole
        # command ring — each stale replay would cost a flight dump,
        # and 8 of them exhaust the recorder's per-run budget
        self.delivered_cmd = 0
        # EMA of this host's inter-push gap: the staleness threshold
        # scales with the host's OWN cadence (heartbeats ride telemetry
        # flush windows, so slow-step runs legitimately push slower than
        # any fixed wall-clock bound)
        self.push_gap_ema: Optional[float] = None


class FleetCollector:
    """Rank-0 absorber of per-host registry snapshots + the fleet
    watchdog. ``absorb(payload)`` is the push sink (mounted at
    ``/fleet/push`` by ``FleetPlane``); it merges the snapshot, refreshes
    the ``hydragnn_fleet_*`` aggregates, runs straggler/desync/staleness
    detection, and returns the response dict carrying any broadcast
    commands the pushing host has not applied yet.

    Merge semantics (the registry's own absorption contract, applied
    across pushes): counter series max-merge — a re-pushed or reordered
    snapshot can never move a monotonic total backwards — and gauge
    series last-write-wins. Aggregates are computed over LIVE hosts only:
    a host that disappears goes stale after ``stale_after_s`` and its
    series leave the min/mean/max, they do not freeze it."""

    def __init__(
        self,
        straggler_factor: float = 2.0,
        max_step_lag: int = 200,
        stale_after_s: float = 30.0,
        collective_budget: Optional[float] = None,
        straggler_min_skew_s: float = 0.005,
        reg: Optional[MetricsRegistry] = None,
    ):
        self.straggler_factor = float(straggler_factor)
        self.max_step_lag = int(max_step_lag)
        self.stale_after_s = float(stale_after_s)
        self.collective_budget = (
            float(collective_budget) if collective_budget is not None else None
        )
        self.straggler_min_skew_s = float(straggler_min_skew_s)
        self._lock = threading.Lock()
        self._hosts: Dict[int, _HostState] = {}
        self._commands: "deque[Dict[str, Any]]" = deque(maxlen=_COMMAND_RING)
        self._next_command_id = 1
        # (kind, host, cause) currently firing — a condition must clear
        # before the same detection can queue a second broadcast
        self._active: set = set()
        # aggregate series published last refresh (retired when their
        # contributors all go stale)
        self._published: set = set()
        reg = reg if reg is not None else registry()
        self._g_hosts = reg.gauge(
            "hydragnn_fleet_hosts",
            "Live (non-stale) hosts the fleet collector is aggregating",
        )
        self._g_step = reg.gauge(
            "hydragnn_fleet_host_step",
            "Latest optimizer step each host reported",
            labelnames=("host",),
        )
        self._g_lag = reg.gauge(
            "hydragnn_fleet_step_lag",
            "Steps each host trails the fleet's most advanced host",
            labelnames=("host",),
        )
        self._g_step_time = reg.gauge(
            "hydragnn_fleet_host_step_time_seconds",
            "Mean step time of each host's last telemetry window",
            labelnames=("host",),
        )
        self._g_stale = reg.gauge(
            "hydragnn_fleet_host_stale",
            "1 while a host's heartbeat is older than fleet_stale_after_s",
            labelnames=("host",),
        )
        self._g_min = reg.gauge(
            "hydragnn_fleet_min",
            "Across-host minimum of each scalar registry series",
            labelnames=("series",),
        )
        self._g_mean = reg.gauge(
            "hydragnn_fleet_mean",
            "Across-host mean of each scalar registry series",
            labelnames=("series",),
        )
        self._g_max = reg.gauge(
            "hydragnn_fleet_max",
            "Across-host maximum of each scalar registry series",
            labelnames=("series",),
        )
        self._c_pushes = reg.counter(
            "hydragnn_fleet_pushes_total",
            "Per-host registry snapshots absorbed by the collector",
            labelnames=("host",),
        )

    # -- push sink -----------------------------------------------------------

    def absorb(
        self, payload: Dict[str, Any], now: Optional[float] = None
    ) -> Dict[str, Any]:
        """Merge one host push; returns the response (ok + unapplied
        broadcast commands). ``now`` (monotonic seconds) is injectable for
        the staleness tests."""
        mono = time.monotonic() if now is None else float(now)
        host = int(payload.get("host", 0))
        ack = int(payload.get("ack", 0))
        with self._lock:
            st = self._hosts.setdefault(host, _HostState(host))
            if st.pushes > 0 and not st.stale:
                # a rejoin gap is an OUTAGE, not cadence — folding it into
                # the EMA would stretch the staleness threshold to cover
                # the very silence it is supposed to detect
                gap = max(mono - st.mono, 0.0)
                st.push_gap_ema = (
                    gap if st.push_gap_ema is None
                    else 0.7 * st.push_gap_ema + 0.3 * gap
                )
            st.pushes += 1
            st.mono = mono
            st.ts = float(payload.get("ts", time.time()))
            st.step = int(payload.get("step", st.step))
            # overwrite with the payload VERBATIM — None means "no fresh
            # measurement this window" and must clear the stored sample,
            # or the watchdog keeps evaluating (and never un-firing) a
            # collective-budget/straggler condition against an
            # arbitrarily old reading
            v = payload.get("step_time_s")
            st.step_time_s = float(v) if v is not None else None
            v = payload.get("comm_fraction_est")
            st.comm_fraction = float(v) if v is not None else None
            if st.stale:
                st.stale = False  # a returning host rejoins the aggregates
                self._g_stale.set(0.0, host=str(host))
            for s in payload.get("samples", ()):
                key = series_key(
                    str(s["n"]), [(str(k), str(v)) for k, v in s.get("l", ())]
                )
                val = float(s["v"])
                if s.get("k") == "counter":
                    # max-merge: monotonic totals absorb idempotently
                    st.counters[key] = max(st.counters.get(key, 0.0), val)
                else:
                    st.gauges[key] = val  # last write wins
            self._sweep_locked(mono)
            self._detect_locked(mono)
            self._publish_locked()
            # deliver each command to each host at most once (optimistic:
            # delivery is marked when the response is BUILT — a response
            # lost to a dying process loses its commands, which is the
            # right trade for an observability broadcast; re-delivering
            # on restart would burn the flight-dump budget on replays)
            floor = max(ack, st.delivered_cmd)
            commands = [
                dict(c) for c in self._commands if int(c["id"]) > floor
            ]
            if commands:
                st.delivered_cmd = max(int(c["id"]) for c in commands)
        self._c_pushes.inc(host=str(host))
        return {"ok": True, "v": FLEET_SCHEMA_VERSION, "commands": commands}

    def forget(self, host: int) -> None:
        """Drop one host's state entirely — the serving-fleet supervisor
        calls this when it respawns a replica, so the dead incarnation's
        heartbeat entry (which would go stale within seconds) can never be
        mistaken for the new process. Staleness on the slot resumes only
        after the new incarnation's first push recreates the entry. The
        host's per-host gauges are retired with it; its contributions to
        the min/mean/max aggregates leave at the next publish."""
        host = int(host)
        with self._lock:
            if self._hosts.pop(host, None) is None:
                return
            label = str(host)
            self._g_step.remove(host=label)
            self._g_lag.remove(host=label)
            self._g_step_time.remove(host=label)
            self._g_stale.remove(host=label)
            self._publish_locked()

    def sweep(self, now: Optional[float] = None) -> None:
        """Staleness pass without a push (tests; a timer would also fit
        here — in production every push sweeps, and a fleet with zero
        pushes has nothing to aggregate anyway)."""
        mono = time.monotonic() if now is None else float(now)
        with self._lock:
            self._sweep_locked(mono)
            self._publish_locked()

    # -- internals (all under self._lock) ------------------------------------

    def _live(self) -> List[_HostState]:
        return [h for h in self._hosts.values() if not h.stale]

    def _sweep_locked(self, mono: float) -> None:
        for st in self._hosts.values():
            # the threshold adapts to the host's own push cadence: a run
            # whose flush windows legitimately take 40 s must not flap
            # stale/rejoined on a 30 s wall-clock default — silence is
            # only staleness once it clearly exceeds BOTH the configured
            # bound and ~3 missed heartbeats
            threshold = max(
                self.stale_after_s, 3.0 * (st.push_gap_ema or 0.0)
            )
            if not st.stale and mono - st.mono > threshold:
                st.stale = True
                self._g_stale.set(1.0, host=str(st.host))
                try:
                    emit_event(
                        EV_FLEET_HOST_STALE,
                        severity="warn",
                        host=st.host,
                        last_step=st.step,
                        silent_s=round(mono - st.mono, 3),
                    )
                except Exception:
                    pass

    def _queue_command_locked(
        self, kind: str, offender: int, step: int, cause: str
    ) -> None:
        self._commands.append(
            {
                "id": self._next_command_id,
                "kind": kind,
                "host": offender,
                "step": int(step),
                "cause": cause,
            }
        )
        self._next_command_id += 1

    def _detect_locked(self, mono: float) -> None:
        live = self._live()
        firing: set = set()
        if live:
            fleet_step = max(h.step for h in live)
            # desync: step progress skewed beyond the configured bound
            for h in live:
                if fleet_step - h.step > self.max_step_lag:
                    firing.add((EV_FLEET_DESYNC, h.host, "step_lag"))
            # straggler: window step time beyond factor x the median of
            # the OTHER hosts. The candidate is excluded from its own
            # baseline: a fleet-wide median that averages the straggler
            # in makes a 2-host fleet mathematically undetectable at
            # factor >= 2 (slow > f*(slow+fast)/2 reduces to 0 > fast),
            # and large fleets are unaffected by dropping one sample.
            timed = [h for h in live if h.step_time_s is not None]
            if len(timed) >= 2:
                for h in timed:
                    others = sorted(
                        x.step_time_s for x in timed if x is not h
                    )
                    med = others[len(others) // 2]
                    if len(others) % 2 == 0:
                        med = (med + others[len(others) // 2 - 1]) / 2.0
                    if (
                        h.step_time_s > self.straggler_factor * med
                        and h.step_time_s - med > self.straggler_min_skew_s
                    ):
                        firing.add((EV_FLEET_STRAGGLER, h.host, "step_time"))
            # collective budget: time-inside-collective estimate over bound
            if self.collective_budget is not None:
                for h in live:
                    if (
                        h.comm_fraction is not None
                        and h.comm_fraction > self.collective_budget
                    ):
                        firing.add(
                            (EV_FLEET_STRAGGLER, h.host, "collective_budget")
                        )
            for key in firing - self._active:
                kind, offender, cause = key
                self._queue_command_locked(kind, offender, fleet_step, cause)
        # a cleared condition re-arms its detection
        self._active = firing

    def _publish_locked(self) -> None:
        live = self._live()
        self._g_hosts.set(float(len(live)))
        if not self._hosts:
            return
        fleet_step = max((h.step for h in live), default=0)
        for st in self._hosts.values():
            self._g_step.set(float(st.step), host=str(st.host))
            if not st.stale:
                self._g_lag.set(
                    float(max(fleet_step - st.step, 0)), host=str(st.host)
                )
                if st.step_time_s is not None:
                    self._g_step_time.set(
                        st.step_time_s, host=str(st.host)
                    )
        # across-host aggregates over live hosts only
        series: Dict[str, List[float]] = {}
        for st in live:
            for key, val in st.counters.items():
                series.setdefault(key, []).append(val)
            for key, val in st.gauges.items():
                series.setdefault(key, []).append(val)
        for key, vals in series.items():
            self._g_min.set(min(vals), series=key)
            self._g_mean.set(sum(vals) / len(vals), series=key)
            self._g_max.set(max(vals), series=key)
        # retire aggregates whose every contributor went stale: the
        # registry would otherwise scrape the dead host's last value
        # forever, indistinguishable from a live reading (the module
        # contract: stale series LEAVE the aggregates)
        for key in self._published - set(series):
            self._g_min.remove(series=key)
            self._g_mean.remove(series=key)
            self._g_max.remove(series=key)
        self._published = set(series)

    # -- introspection (tests, the smoke) ------------------------------------

    def hosts(self) -> Dict[int, Dict[str, Any]]:
        with self._lock:
            return {
                h.host: {
                    "step": h.step,
                    "step_time_s": h.step_time_s,
                    "stale": h.stale,
                    "pushes": h.pushes,
                    "series": len(h.counters) + len(h.gauges),
                }
                for h in self._hosts.values()
            }

    def host_series(self, host: int) -> Dict[str, float]:
        """One host's absorbed scalar series (gauges last-write, counters
        max-merged), keyed by canonical ``series_key`` — the serving fleet
        manager's per-replica load/health view (live queue depth, shed
        totals) without re-scraping each replica's /metrics. Empty dict
        for a host that never pushed."""
        with self._lock:
            st = self._hosts.get(int(host))
            if st is None:
                return {}
            out = dict(st.counters)
            out.update(st.gauges)
            return out

    def pending_commands(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(c) for c in self._commands]


class FleetPusher:
    """Per-host push client: serializes the local registry each telemetry
    flush window, POSTs it to the collector on a background thread (the
    step path never blocks on the network — a slower-than-window push
    drops the stale window and sends the latest), and applies broadcast
    commands from the response exactly once each: emit the typed fleet
    event locally and trigger a coordinated flight dump keyed by the
    command's fleet step."""

    def __init__(
        self,
        url: str,
        host: int,
        host_count: int,
        reg: Optional[MetricsRegistry] = None,
        timeout_s: float = 2.0,
        min_interval_s: float = _PUSH_MIN_INTERVAL_S,
    ):
        self.url = url
        self.host = int(host)
        self.host_count = int(host_count)
        self.timeout_s = float(timeout_s)
        self.min_interval_s = float(min_interval_s)
        self._last_accept = 0.0
        self._reg = reg
        self._ack = 0
        self.pushed = 0
        self.failures = 0
        self._warned = False
        self._lock = threading.Lock()
        self._pending: Optional[Dict[str, Any]] = None
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, daemon=True, name="fleet-push"
        )
        self._thread.start()

    def _payload(
        self,
        step: int,
        step_time_s: Optional[float],
        comm_fraction_est: Optional[float],
    ) -> Dict[str, Any]:
        return {
            "v": FLEET_SCHEMA_VERSION,
            "host": self.host,
            "host_count": self.host_count,
            "ts": round(time.time(), 3),
            "step": int(step),
            "step_time_s": step_time_s,
            "comm_fraction_est": comm_fraction_est,
            "ack": self._ack,
            "samples": registry_snapshot(self._reg),
        }

    def on_window(
        self,
        step: int,
        step_time_s: Optional[float] = None,
        comm_fraction_est: Optional[float] = None,
    ) -> None:
        """Queue this window's push (latest-wins when the worker is mid-
        push), rate-limited to ``min_interval_s`` — sub-second telemetry
        windows must not turn into a per-window serialize+POST tax. An
        accepted window's snapshot is serialized here — cheap dict walks
        — so the payload reflects the flush that triggered it."""
        now = time.monotonic()
        if now - self._last_accept < self.min_interval_s:
            return
        self._last_accept = now
        payload = self._payload(step, step_time_s, comm_fraction_est)
        with self._lock:
            self._pending = payload
        self._wake.set()

    def push_now(
        self,
        step: int,
        step_time_s: Optional[float] = None,
        comm_fraction_est: Optional[float] = None,
    ) -> bool:
        """Synchronous push (tests + the close() flush)."""
        return self._post(self._payload(step, step_time_s, comm_fraction_est))

    def _worker(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=0.5)
            if self._stop.is_set():
                return
            self._wake.clear()
            with self._lock:
                payload, self._pending = self._pending, None
            if payload is not None:
                self._post(payload)

    def _post(self, payload: Dict[str, Any]) -> bool:
        try:
            req = urllib.request.Request(
                self.url,
                data=json.dumps(payload).encode("utf-8"),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                body = json.loads(resp.read().decode("utf-8"))
        except (OSError, urllib.error.URLError, ValueError) as e:
            self.failures += 1
            if not self._warned:
                self._warned = True
                warnings.warn(
                    f"fleet push to {self.url} failed ({e}); will keep "
                    "retrying each window (warn-once)",
                    RuntimeWarning,
                    stacklevel=2,
                )
            return False
        self.pushed += 1
        self._apply_commands(body.get("commands") or ())
        return True

    def _apply_commands(self, commands: Sequence[Dict[str, Any]]) -> None:
        for cmd in commands:
            try:
                cid = int(cmd.get("id", 0))
            except (TypeError, ValueError):
                continue
            if cid <= self._ack:
                continue  # applied already (or a replay)
            self._ack = cid
            kind = str(cmd.get("kind", EV_FLEET_DESYNC))
            if kind not in (EV_FLEET_STRAGGLER, EV_FLEET_DESYNC):
                kind = EV_FLEET_DESYNC
            step = cmd.get("step")
            try:
                emit_event(
                    kind,
                    severity="warn",
                    host=self.host,
                    offender=cmd.get("host"),
                    step=step,
                    cause=cmd.get("cause"),
                )
            except Exception:
                pass
            # coordinated flight dump: every host dumps under the SAME
            # fleet step key; directories are host-disambiguated
            # (obs/flightrec.py), so shared-filesystem dumps line up
            # side by side instead of colliding
            try:
                from . import flightrec

                flightrec.trigger(f"{kind}_step{step}")
            except Exception:
                pass

    def close(self, flush_step: Optional[int] = None) -> None:
        """Stop the worker; ``flush_step`` sends one final synchronous
        push so the collector sees the host's terminal step (and this
        host applies any last broadcast)."""
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=2.0)
        if flush_step is not None:
            self.push_now(flush_step)


class FleetPlane:
    """Per-run wiring of the fleet plane (owned by ``StepTelemetry``).

    Host 0 mounts the collector's push sink on its own HTTP endpoint
    (``fleet_collector_host``:``fleet_collector_port``, or the port from
    the shared ``fleet_collector``/``HYDRAGNN_FLEET_COLLECTOR`` address);
    every host — including host 0, over loopback — runs a pusher against
    the resolved collector address. The symmetric push path is the point:
    the single-host degenerate case and the N-host fleet run identical
    code."""

    @staticmethod
    def from_settings(
        settings: Dict[str, Any], run_dir: Optional[str] = None
    ) -> Optional["FleetPlane"]:
        if not settings.get("fleet"):
            return None
        return FleetPlane(settings, run_dir=run_dir)

    def __init__(self, settings: Dict[str, Any], run_dir: Optional[str] = None):
        self.run_dir = run_dir
        self.host, self.host_count = host_identity()
        addr = envflags.env_str("HYDRAGNN_FLEET_COLLECTOR") or settings.get(
            "fleet_collector"
        )
        if addr is not None and not _valid_collector_addr(str(addr)):
            # the env path bypasses resolve_telemetry's host:port check —
            # apply the same grammar here, degrading loudly instead of
            # binding an unrelated port and pushing at port 80
            warnings.warn(
                f"fleet collector address {addr!r} is not 'host:port'; "
                "ignoring it (set HYDRAGNN_FLEET_COLLECTOR or "
                "Telemetry.fleet_collector to rank 0's host:port)",
                RuntimeWarning,
                stacklevel=2,
            )
            addr = None
        self.collector: Optional[FleetCollector] = None
        self.endpoint = None
        self.pusher: Optional[FleetPusher] = None
        if self.host == 0:
            self.collector = FleetCollector(
                straggler_factor=float(
                    settings.get("fleet_straggler_factor", 2.0)
                ),
                max_step_lag=int(settings.get("fleet_max_step_lag", 200)),
                stale_after_s=float(settings.get("fleet_stale_after_s", 30.0)),
                collective_budget=settings.get("fleet_collective_budget"),
            )
            port = int(settings.get("fleet_collector_port") or 0)
            bind_host = str(settings.get("fleet_collector_host", "127.0.0.1"))
            if addr:
                try:
                    port = int(str(addr).rsplit(":", 1)[1])
                except (IndexError, ValueError):
                    pass
                if bind_host == "127.0.0.1":
                    # an explicit collector address means off-host pushers
                    # exist — a loopback bind would refuse every one of
                    # them (and rank 0's own push aimed at the external
                    # address). Operators who really want loopback set
                    # fleet_collector to a 127.0.0.1:... address.
                    host_part = str(addr).rsplit(":", 1)[0]
                    bind_host = (
                        "127.0.0.1"
                        if host_part in ("127.0.0.1", "localhost")
                        else "0.0.0.0"
                    )
            from .prometheus import TelemetryHTTPServer

            try:
                self.endpoint = TelemetryHTTPServer(
                    host=bind_host,
                    port=port,
                    post_routes={"/fleet/push": self._on_push},
                )
            except (OSError, OverflowError) as e:
                warnings.warn(
                    f"fleet collector could not bind port {port} ({e}); "
                    "cross-host aggregation is unavailable for this run",
                    RuntimeWarning,
                    stacklevel=2,
                )
            if addr is None and self.endpoint is not None:
                addr = f"127.0.0.1:{self.endpoint.port}"
        if addr:
            self.pusher = FleetPusher(
                f"http://{addr}/fleet/push", self.host, self.host_count
            )
        elif self.host != 0:
            warnings.warn(
                "fleet plane is on but no collector address is configured "
                "for this non-zero host (set Telemetry.fleet_collector or "
                "HYDRAGNN_FLEET_COLLECTOR to rank 0's host:port); this "
                "host stays invisible to the fleet view",
                RuntimeWarning,
                stacklevel=2,
            )

    def _on_push(self, body: bytes) -> Tuple[int, Dict[str, Any]]:
        try:
            payload = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            return 400, {"ok": False, "error": f"bad payload: {e}"}
        if self.collector is None:  # pragma: no cover - defensive
            return 503, {"ok": False, "error": "no collector"}
        return 200, self.collector.absorb(payload)

    @property
    def collector_url(self) -> Optional[str]:
        return self.endpoint.url if self.endpoint is not None else None

    def on_window(
        self,
        step: int,
        step_time_s: Optional[float] = None,
        comm_fraction_est: Optional[float] = None,
    ) -> None:
        if self.pusher is not None:
            self.pusher.on_window(step, step_time_s, comm_fraction_est)

    def close(self, final_step: Optional[int] = None) -> None:
        if self.pusher is not None:
            try:
                self.pusher.close(flush_step=final_step)
            except Exception:
                pass
            self.pusher = None
        if self.endpoint is not None:
            try:
                self.endpoint.close()
            except Exception:
                pass
            self.endpoint = None


# ---------------------------------------------------------------------------
# trace stitching: per-host trace.jsonl streams -> one run-level view
# ---------------------------------------------------------------------------


def merge_traces(
    paths: Sequence[str], out_path: str
) -> Dict[str, Any]:
    """Stitch per-host trace.jsonl streams (spans carry their ``host``,
    obs/trace.py) into one time-ordered run-level stream. Unparseable
    lines are counted and skipped (a crash can truncate a host's last
    line); span records missing a host keep their absence — stitching
    never invents identity. Returns ``{spans, hosts, files, skipped}``."""
    records: List[Dict[str, Any]] = []
    skipped = 0
    hosts: set = set()
    for path in paths:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    skipped += 1
                    continue
                if "host" in rec:
                    hosts.add(rec["host"])
                records.append(rec)
    records.sort(key=lambda r: int(r.get("startTimeUnixNano", 0)))
    with open(out_path, "w") as fh:
        for rec in records:
            fh.write(json.dumps(rec) + "\n")
    return {
        "spans": len(records),
        "hosts": sorted(hosts),
        "files": len(paths),
        "skipped": skipped,
    }


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m hydragnn_tpu_torch.obs.fleet merged.jsonl trace*.jsonl`` —
    the run-level trace stitch."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print(
            "usage: python -m hydragnn_tpu_torch.obs.fleet OUT.jsonl "
            "TRACE.jsonl [TRACE.jsonl ...]"
        )
        return 2
    out, inputs = argv[0], argv[1:]
    try:
        summary = merge_traces(inputs, out)
    except OSError as e:
        print(f"hydragnn_tpu_torch.obs.fleet: {e}")
        return 2
    print(
        f"merged {summary['spans']} spans from {summary['files']} stream(s) "
        f"(hosts: {summary['hosts'] or ['unknown']}, "
        f"{summary['skipped']} unparseable line(s) skipped) -> {out}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
