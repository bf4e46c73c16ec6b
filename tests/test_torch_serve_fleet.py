"""The port's serving-fleet request plane on the CPU: the scenarios of the
JAX package's tests/test_serve_fleet.py on the port's router (balancing,
retries on another replica, hedging, circuit breakers, batch-priority
shedding) over stub replica clients, the prediction cache (bit identity,
corrupt entries, atomic writes, the context), the wire codec, the
error-code table, the fleet keys of ``ServeConfig``, the replica fault
specs, the rolling reload and wedge detection; then the port held against
the JAX package (wire bytes, ``graph_key`` digests, ``ServeConfig`` fields,
defaults and refusals, the error tables) and a two-replica fleet of CPU
processes losing one replica with no failed request."""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest

import hydragnn_tpu.serve as j_serve
from hydragnn_tpu.data import deterministic_graph_dataset as j_dataset
from hydragnn_tpu.serve import wire as j_wire
from hydragnn_tpu.serve.cache import graph_key as j_graph_key
from hydragnn_tpu_torch.data import deterministic_graph_dataset
from hydragnn_tpu_torch.serve import (
    BreakerOpenError,
    CircuitBreaker,
    ERROR_CODES,
    FleetRouter,
    InvalidRequestError,
    NoReplicasError,
    PredictionCache,
    ReplicaClient,
    ReplicaUnavailableError,
    RETRYABLE_CODES,
    ServeConfig,
    ServeError,
    SheddedError,
    error_from_code,
    graph_key,
)
from hydragnn_tpu_torch.serve import wire
from hydragnn_tpu_torch.utils import faultinject


@pytest.fixture(autouse=True)
def _clean_faults():
    faultinject.reset()
    yield
    faultinject.reset()


@pytest.fixture(scope="module")
def graphs():
    return deterministic_graph_dataset(4, seed=11)


def _result(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "graph_s": rng.standard_normal((1, 1)).astype(np.float32),
        "node_e": rng.standard_normal((5, 1)).astype(np.float64),
    }


class StubReplica(ReplicaClient):
    """Scriptable in-memory replica: ``fail_with`` raises per call until
    exhausted, then predictions succeed; ``delay_s`` models a slow
    replica."""

    def __init__(self, name, result=None, fail_with=(), delay_s=0.0,
                 depth=0.0):
        self.name = name
        self._result = result if result is not None else _result()
        self._failures = list(fail_with)
        self.delay_s = delay_s
        self.depth = depth
        self.calls = 0
        self._lock = threading.Lock()

    def predict(self, graph, timeout_s=None):
        with self._lock:
            self.calls += 1
            exc = self._failures.pop(0) if self._failures else None
        if self.delay_s:
            time.sleep(self.delay_s)
        if exc is not None:
            raise exc
        return dict(self._result)

    def ready(self):
        return True

    def queue_depth(self):
        return self.depth


def _cfg(**kw):
    kw.setdefault("router_backoff_s", 0.001)
    kw.setdefault("router_timeout_s", 5.0)
    return ServeConfig(**kw)


# ---------------------------------------------------------------------------
# router: balancing / retries / hedging / priorities
# ---------------------------------------------------------------------------


def pytest_router_balances_on_queue_depth(graphs):
    a = StubReplica("a", depth=5.0)
    b = StubReplica("b", depth=0.0)
    r = FleetRouter({"a": a, "b": b}, cfg=_cfg())
    for _ in range(4):
        r.predict(graphs[0])
    # every request should land on the idle replica
    assert b.calls == 4 and a.calls == 0


def pytest_router_depth_fn_overrides_client_depth(graphs):
    a = StubReplica("a", depth=0.0)
    b = StubReplica("b", depth=0.0)
    # the collector-substrate hook says a is drowning even though the
    # client-side depth does not
    r = FleetRouter({"a": a, "b": b}, cfg=_cfg(),
                    depth_fn=lambda n: 50.0 if n == "a" else 0.0)
    r.predict(graphs[0])
    assert b.calls == 1 and a.calls == 0


def pytest_router_retries_on_a_different_replica(graphs):
    a = StubReplica("a", fail_with=[ReplicaUnavailableError("conn reset")],
                    depth=0.0)
    b = StubReplica("b", depth=1.0)  # scored worse: a gets picked first
    r = FleetRouter({"a": a, "b": b}, cfg=_cfg(router_retries=2))
    out = r.predict(graphs[0])
    assert set(out) == {"graph_s", "node_e"}
    assert a.calls == 1 and b.calls == 1
    st = r.stats()
    assert st["retries"] >= 1 and st["succeeded"] == 1


def pytest_router_does_not_retry_invalid_request(graphs):
    a = StubReplica("a", fail_with=[InvalidRequestError("bad graph")])
    b = StubReplica("b", depth=1.0)
    r = FleetRouter({"a": a, "b": b}, cfg=_cfg(router_retries=3))
    with pytest.raises(InvalidRequestError):
        r.predict(graphs[0])
    # a client bug fails identically everywhere: exactly one attempt
    assert a.calls + b.calls == 1


def pytest_router_exhausted_retries_raise_no_replicas(graphs):
    a = StubReplica("a", fail_with=[ReplicaUnavailableError("down")] * 10)
    r = FleetRouter({"a": a}, cfg=_cfg(router_retries=2,
                                       breaker_failures=50))
    with pytest.raises(NoReplicasError) as ei:
        r.predict(graphs[0])
    assert len(ei.value.attempts) == 3  # initial + 2 retries
    assert all("replica_unavailable" in att for att in ei.value.attempts)


def pytest_router_hedges_slow_replica(graphs):
    a = StubReplica("a", delay_s=0.5, depth=0.0)
    b = StubReplica("b", depth=1.0)
    r = FleetRouter({"a": a, "b": b},
                    cfg=_cfg(router_hedge_min_s=0.03,
                             router_hedge_factor=1.0))
    t0 = time.perf_counter()
    out = r.predict(graphs[0], priority="interactive")
    dt = time.perf_counter() - t0
    assert set(out) == {"graph_s", "node_e"}
    assert dt < 0.4  # the hedge answered; we did not wait out the 0.5s
    st = r.stats()
    assert st["hedges"] == 1 and st["hedge_wins"] == 1


def pytest_router_batch_priority_is_shed_not_hedged(graphs):
    slow = StubReplica("a", depth=30.0)
    r = FleetRouter({"a": slow}, cfg=_cfg(slo_p99_s=0.01))
    # seed the latency EMA so projected wait = depth * ema blows the SLO
    r._lat_ema["a"] = 0.1
    with pytest.raises(SheddedError):
        r.predict(graphs[0], priority="batch")
    assert slow.calls == 0  # shed at the router, never dispatched
    assert r.stats()["router_shed"] == 1
    # interactive traffic still goes through
    out = r.predict(graphs[0], priority="interactive")
    assert set(out) == {"graph_s", "node_e"}


def pytest_router_rejects_unknown_priority(graphs):
    r = FleetRouter({"a": StubReplica("a")}, cfg=_cfg())
    with pytest.raises(ValueError):
        r.predict(graphs[0], priority="best_effort")


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------


def pytest_breaker_open_halfopen_close_lifecycle():
    clock = [0.0]
    br = CircuitBreaker("a", failures=3, cooldown_s=5.0,
                        now_fn=lambda: clock[0])
    for _ in range(2):
        br.record_failure("replica_unavailable")
    assert br.state == "closed" and br.allow()
    br.record_failure("replica_unavailable")
    assert br.state == "open" and not br.allow()
    clock[0] = 4.9
    assert not br.allow()
    clock[0] = 5.1
    assert br.allow()  # the single half-open probe
    assert br.state == "half_open"
    assert not br.allow()  # second concurrent probe is refused
    br.record_success()
    assert br.state == "closed" and br.closes == 1
    assert br.allow()


def pytest_breaker_failed_probe_reopens():
    clock = [0.0]
    br = CircuitBreaker("a", failures=1, cooldown_s=2.0,
                        now_fn=lambda: clock[0])
    br.record_failure("wedged_step")
    assert br.state == "open"
    clock[0] = 2.5
    assert br.allow()
    br.record_failure("wedged_step")
    assert br.state == "open" and br.opens == 2
    clock[0] = 3.0
    assert not br.allow()  # fresh cooldown from the failed probe


def pytest_router_breaker_opens_and_recloses(graphs):
    a = StubReplica("a", fail_with=[ReplicaUnavailableError("down")] * 2,
                    depth=0.0)
    b = StubReplica("b", depth=1.0)
    r = FleetRouter({"a": a, "b": b},
                    cfg=_cfg(breaker_failures=2, breaker_cooldown_s=0.05,
                             router_retries=2))
    r.predict(graphs[0])  # a fails, retry lands on b
    r.predict(graphs[0])  # a fails again -> breaker opens, b serves
    assert r.breaker("a").state == "open"
    calls_b = b.calls
    r.predict(graphs[0])  # hard-open: a is not even a candidate
    assert a.calls == 2 and b.calls == calls_b + 1
    time.sleep(0.06)
    r.predict(graphs[0])  # half-open probe succeeds (failures exhausted)
    assert r.breaker("a").state in ("closed", "half_open")
    # drive to certainty: a serves again
    r.predict(graphs[0])
    assert r.breaker("a").state == "closed"


def pytest_router_all_breakers_open_raises_typed(graphs):
    a = StubReplica("a", fail_with=[ReplicaUnavailableError("down")] * 10)
    r = FleetRouter({"a": a},
                    cfg=_cfg(breaker_failures=1, breaker_cooldown_s=60.0,
                             router_retries=1))
    with pytest.raises((NoReplicasError, ReplicaUnavailableError,
                        BreakerOpenError)):
        r.predict(graphs[0])
    with pytest.raises(BreakerOpenError):
        r.predict(graphs[0])  # breaker now hard-open, no candidates at all


def pytest_router_set_clients_preserves_breaker_state(graphs):
    a = StubReplica("a", fail_with=[ReplicaUnavailableError("down")] * 10)
    r = FleetRouter({"a": a}, cfg=_cfg(breaker_failures=1,
                                       breaker_cooldown_s=60.0,
                                       router_retries=0))
    with pytest.raises((NoReplicasError, ReplicaUnavailableError)):
        r.predict(graphs[0])
    assert r.breaker("a").state == "open"
    # the manager restarts replica "a": same name, fresh client — the
    # breaker (and its cooldown) survives, so the restart is half-trusted
    r.set_clients({"a": StubReplica("a")})
    assert r.breaker("a").state == "open"
    assert r.replicas() == ["a"]


# ---------------------------------------------------------------------------
# prediction cache
# ---------------------------------------------------------------------------


def pytest_cache_hit_is_bit_identical(tmp_path, graphs):
    cache = PredictionCache(str(tmp_path / "pc"))
    result = _result(seed=3)
    assert cache.get(graphs[0]) is None
    cache.put(graphs[0], result)
    hit = cache.get(graphs[0])
    assert hit is not None
    assert set(hit) == set(result)
    for k in result:
        assert hit[k].dtype == result[k].dtype
        assert hit[k].shape == result[k].shape
        # bit identity, not closeness
        assert hit[k].tobytes() == result[k].tobytes()
    st = cache.stats()
    assert st["hits"] == 1 and st["misses"] == 1 and st["stores"] == 1


def pytest_cache_key_tracks_graph_content(graphs):
    k0, k1 = graph_key(graphs[0]), graph_key(graphs[1])
    assert k0 != k1
    assert k0 == graph_key(graphs[0])  # deterministic
    import dataclasses

    bumped = dataclasses.replace(graphs[0], x=graphs[0].x + 1.0)
    assert graph_key(bumped) != k0


def pytest_cache_corrupt_entry_is_a_miss(tmp_path, graphs):
    cache = PredictionCache(str(tmp_path / "pc"))
    cache.put(graphs[0], _result())
    key = graph_key(graphs[0])
    path = cache._path(key)
    with open(path, "r+b") as fh:  # tear the zip container
        fh.seek(0)
        fh.write(b"\xff\xff\xff\xff")
    assert cache.get(graphs[0]) is None  # unreadable -> miss, not a raise
    assert cache.stats()["misses"] >= 1

    # a VALID npz whose stored digest disagrees with its arrays (the
    # corruption the zip CRC cannot catch) is dropped and evicted
    cache.put(graphs[1], _result(seed=1))
    path2 = cache._path(graph_key(graphs[1]))
    np.savez(path2.replace(".npz", ""),
             graph_s=np.zeros((1, 1), np.float32),
             __digest__=np.asarray("0" * 64))
    assert cache.get(graphs[1]) is None
    assert not os.path.exists(path2)  # digest-mismatch entries are evicted
    assert cache.stats()["corrupt"] >= 1


def pytest_cache_write_is_atomic(tmp_path, graphs):
    cache = PredictionCache(str(tmp_path / "pc"))
    cache.put(graphs[0], _result())
    shard_root = str(tmp_path / "pc")
    leftovers = [
        f for _, _, files in os.walk(shard_root) for f in files
        if ".tmp." in f
    ]
    assert leftovers == []  # tmp+rename leaves no partials behind


def pytest_router_cache_hits_skip_the_fleet(graphs):
    a = StubReplica("a")

    class MemCache(PredictionCache):
        pass

    import tempfile

    with tempfile.TemporaryDirectory() as d:
        r = FleetRouter({"a": a}, cfg=_cfg(), cache=MemCache(d))
        out1 = r.predict(graphs[0])
        out2 = r.predict(graphs[0])
        assert a.calls == 1  # second answer came from the cache
        for k in out1:
            assert out1[k].tobytes() == out2[k].tobytes()
        st = r.stats()
        assert st["cache_hits"] == 1 and st["cache_misses"] == 1


def pytest_cache_context_namespaces_keys(tmp_path, graphs):
    # the non-graph key component: a reloaded checkpoint must never serve
    # the old checkpoint's cached prediction as a hit
    cache = PredictionCache(str(tmp_path / "pc"), context="ckpt-a")
    res = _result(seed=5)
    cache.put(graphs[0], res)
    assert cache.get(graphs[0]) is not None
    cache.set_context("ckpt-b")
    assert cache.get(graphs[0]) is None  # same graph, new weights: miss
    cache.set_context("ckpt-a")
    assert cache.get(graphs[0]) is not None  # rollback re-hits old entries
    # context None disables the cache outright (mid-rollout mixed fleet)
    cache.set_context(None)
    assert cache.key_for(graphs[0]) is None
    assert cache.get(graphs[0]) is None
    assert cache.put(graphs[0], res) is None
    # the default "" context keys on graph content alone (bench/standalone)
    plain = PredictionCache(str(tmp_path / "pc2"))
    assert plain.key_for(graphs[0]) == graph_key(graphs[0])


def pytest_router_cache_sits_out_without_context(graphs):
    import tempfile

    a = StubReplica("a")
    with tempfile.TemporaryDirectory() as d:
        cache = PredictionCache(d, context=None)
        r = FleetRouter({"a": a}, cfg=_cfg(), cache=cache)
        r.predict(graphs[0])
        r.predict(graphs[0])
        assert a.calls == 2  # disabled cache: every request hits the fleet
        assert r.stats()["cache_hits"] == 0
        cache.set_context("ckpt-a")
        r.predict(graphs[0])  # miss + store under the new context
        r.predict(graphs[0])  # hit
        assert a.calls == 3
        assert r.stats()["cache_hits"] == 1


class _FakeProc:
    def __init__(self):
        self.killed = 0

    def poll(self):
        return None

    def kill(self):
        self.killed += 1


def pytest_wedge_detection_waits_for_new_incarnation_heartbeat():
    # after a respawn, the dead incarnation's stale
    # collector entry must not judge the new process — a replica whose
    # warm-up outlives the grace window was SIGKILLed repeatedly and
    # flap-benched after a single real crash
    from hydragnn_tpu_torch.obs.fleet import FleetCollector
    from hydragnn_tpu_torch.serve.fleet import ReplicaManager, _Replica

    col = FleetCollector(stale_after_s=2.0)
    now = time.monotonic()
    # the OLD incarnation heartbeated long ago (entry is stale by now)
    col.absorb({"host": 1, "samples": []}, now=now - 60.0)
    m = ReplicaManager.__new__(ReplicaManager)
    m.collector = col
    rep = _Replica(1)
    rep.proc = _FakeProc()
    rep.started_at = now - 30.0  # well past the fixed grace window
    # _spawn forgets the old entry: with no heartbeat from THIS process
    # there is nothing to go stale, so warm-up is never "wedged"
    col.forget(1)
    assert 1 not in col.hosts()
    ReplicaManager._check_wedged(m, rep, now)
    assert rep.proc.killed == 0
    # once the new incarnation heartbeats and THEN goes silent, the wedge
    # path fires as designed
    col.absorb({"host": 1, "samples": []}, now=now - 10.0)
    ReplicaManager._check_wedged(m, rep, now)
    assert rep.proc.killed == 1


def _fake_manager(n, ready=None):
    from hydragnn_tpu_torch.serve.fleet import ReplicaManager, _Replica

    m = ReplicaManager.__new__(ReplicaManager)
    m.cfg = _cfg(fleet_ready_floor=0.0)
    m.n = n
    m._lock = threading.Lock()
    m._cache = None
    m._reloading = False
    m._replicas = {}
    for i in range(1, n + 1):
        rep = _Replica(i)
        rep.port = 10000 + i
        m._replicas[i] = rep
    m.ready_count = lambda: ready if ready is not None else n
    return m


def pytest_rolling_reload_skips_unreachable_replica(graphs):
    # a replica crashing between the rollout snapshot
    # and its stat/reload calls must yield the documented skip, not a raw
    # urllib/OSError out of rolling_reload
    m = _fake_manager(2)
    posted = []

    def stat(rep, field):
        if rep.index == 1:
            raise OSError("connection refused")
        return "ckpt-old"

    m._replica_stat = stat
    m._post_reload = lambda rep, body: (
        posted.append((rep.index, dict(body))) or {"status": "installed"}
    )
    m._wait_checkpoint_change = lambda rep, prior, deadline: "ckpt-new"
    m._probe_first = lambda rep, pg: {
        "probes": 4, "errors": 0, "error_rate": 0.0,
    }
    with pytest.warns(RuntimeWarning, match="unreachable"):
        res = m.rolling_reload(list(graphs[:2]), timeout_s=5.0)
    assert res["status"] == "done"
    assert res["installed"] == 1
    assert [idx for idx, _ in posted] == [2]  # replica 1 skipped entirely


def pytest_rolling_reload_reports_failed_rollback(graphs):
    # a rollback POST to a replica that died under
    # probing must be reported in the status dict, not silently lost
    m = _fake_manager(1)
    m._replica_stat = lambda rep, field: "ckpt-old"

    def post(rep, body):
        if "entry" in body:
            raise OSError("replica died")
        return {"status": "installed"}

    m._post_reload = post
    m._wait_checkpoint_change = lambda rep, prior, deadline: "ckpt-new"
    m._probe_first = lambda rep, pg: {
        "probes": 4, "errors": 4, "error_rate": 1.0,
    }
    with pytest.warns(RuntimeWarning, match="rollback POST"):
        res = m.rolling_reload(list(graphs[:1]), timeout_s=5.0)
    assert res["status"] == "rolled_back"
    assert res["rollback_ok"] is False
    assert "OSError" in res["rollback_error"]
    assert res["prior"] == "ckpt-old" and res["regressed"] == "ckpt-new"


def pytest_http_client_sends_deadline_on_the_wire(graphs):
    # without deadline_s in the /predict body the
    # replica runs handle.result(timeout=None) and parks an HTTP thread
    # forever on requests the router already timed out or hedged away
    from hydragnn_tpu_torch.serve import HTTPReplicaClient

    c = HTTPReplicaClient("http://127.0.0.1:9", name="a")
    seen = {}

    def fake_post(path, payload, timeout_s):
        seen["obj"] = json.loads(payload.decode("utf-8"))
        return wire.dumps(wire.encode_prediction(_result()))

    c._post = fake_post
    out = c.predict(graphs[0], timeout_s=2.5)
    assert set(out) == {"graph_s", "node_e"}
    assert seen["obj"]["deadline_s"] == 2.5
    # the payload stays a valid wire graph with the deadline attached
    wire.decode_graph(seen["obj"])
    c.predict(graphs[0])  # no client timeout: server default applies
    assert "deadline_s" not in seen["obj"]


# ---------------------------------------------------------------------------
# wire codec
# ---------------------------------------------------------------------------


def pytest_wire_graph_round_trip_exact(graphs):
    g = graphs[0]
    back = wire.decode_graph(wire.loads(wire.dumps(wire.encode_graph(g))))
    for name in ("x", "pos", "senders", "receivers", "z"):
        a, b = np.asarray(getattr(g, name)), np.asarray(getattr(back, name))
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert graph_key(back) == graph_key(g)


def pytest_wire_prediction_round_trip_exact():
    pred = {"graph_s": np.arange(6, dtype=np.float64).reshape(2, 3) / 7.0,
            "node_e": np.float32([[1e-20], [3.0]])}
    back = wire.decode_prediction(
        wire.loads(wire.dumps(wire.encode_prediction(pred)))
    )
    for k, a in pred.items():
        assert back[k].dtype == a.dtype
        assert back[k].tobytes() == a.tobytes()


def pytest_wire_malformed_and_truncated_reject():
    with pytest.raises(InvalidRequestError):
        wire.loads(b"not json")
    with pytest.raises(InvalidRequestError):
        wire.decode_graph({"v": 1})  # missing required fields
    arr = wire.encode_array(np.arange(8, dtype=np.float32))
    arr["b64"] = arr["b64"][: len(arr["b64"]) // 2]
    with pytest.raises(InvalidRequestError):
        wire.decode_array(arr)


def pytest_wire_error_round_trip_typed():
    err = wire.decode_error(wire.encode_error(
        ReplicaUnavailableError("conn refused")
    ))
    assert isinstance(err, ReplicaUnavailableError)
    assert "conn refused" in str(err)
    unknown = wire.decode_error(
        {"v": 1, "error": {"code": "code_from_the_future", "message": "x"}}
    )
    assert isinstance(unknown, ServeError)


# ---------------------------------------------------------------------------
# error-code table / config / fault specs
# ---------------------------------------------------------------------------


def pytest_error_code_table_is_stable():
    # append-only contract: these codes are on the wire — renaming or
    # removing any of them breaks deployed routers
    for code in ("serve_error", "request_error", "invalid_request",
                 "queue_full", "shed", "deadline_exceeded", "draining",
                 "closed", "wedged_step", "replica_unavailable",
                 "breaker_open", "no_replicas"):
        assert code in ERROR_CODES, code
        assert ERROR_CODES[code].code == code
    assert "shed" not in RETRYABLE_CODES  # backpressure is not a fault
    assert "invalid_request" not in RETRYABLE_CODES
    assert "replica_unavailable" in RETRYABLE_CODES
    e = error_from_code("queue_full", "full")
    assert type(e).__name__ == "QueueFullError"


@pytest.mark.parametrize("bad", [
    {"fleet_ready_floor": 1.5},
    {"reload_error_spike": -0.1},
    {"router_hedge_factor": 0.5},
    {"router_retries": -1},
    {"fleet_restart_backoff_s": -1.0},
    {"prediction_cache": ""},
    {"prediction_cache": 3},
])
def pytest_serve_config_rejects_bad_fleet_keys(bad):
    with pytest.raises((ValueError, TypeError)):
        ServeConfig(**bad)


def pytest_serve_config_fleet_defaults_validate():
    cfg = ServeConfig(fleet_replicas=4, prediction_cache=True,
                      router_hedge_factor=2.0)
    assert cfg.fleet_replicas == 4 and cfg.prediction_cache is True


def pytest_replica_fault_specs_scope_by_replica(monkeypatch):
    # one env on the whole fleet arms exactly one replica
    monkeypatch.setenv("HYDRAGNN_FAULT_REPLICA_SLOW", "2:0.001")
    faultinject.configure()
    t0 = time.perf_counter()
    faultinject.maybe_replica_slow(1)  # not replica 2: no-op
    assert time.perf_counter() - t0 < 0.05
    faultinject.maybe_replica_slow(2)  # armed replica sleeps
    monkeypatch.setenv("HYDRAGNN_FAULT_REPLICA_WEDGE", "1:0:0.001")
    faultinject.configure()
    faultinject.maybe_replica_wedge(2, 0)  # other replica: no-op
    t0 = time.perf_counter()
    faultinject.maybe_replica_wedge(1, 0)  # replica 1, request 0 wedges
    assert time.perf_counter() - t0 >= 0.0005
    # KILL spec parsing only (actually dying would kill pytest)
    monkeypatch.setenv("HYDRAGNN_FAULT_REPLICA_KILL", "3:5")
    faultinject.configure()
    faultinject.maybe_replica_kill(1, 5)  # not replica 3: survives
    faultinject.maybe_replica_kill(3, 4)  # request 4 != 5: survives




# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------


def _pred(seed=0):
    rng = np.random.default_rng(seed)
    return {"energy": rng.standard_normal((1,)).astype(np.float32),
            "forces": rng.standard_normal((7, 3)).astype(np.float32),
            "aux": np.arange(5, dtype=np.int64)}


def pytest_wire_bytes_equal_jax():
    """The same graphs, predictions and errors encode to the same bytes,
    and each package decodes the other's."""
    tg, jg = deterministic_graph_dataset(3, seed=5), j_dataset(3, seed=5)
    for t, j in zip(tg, jg):
        tb, jb = wire.dumps(wire.encode_graph(t)), j_wire.dumps(j_wire.encode_graph(j))
        assert tb == jb
        back = wire.decode_graph(wire.loads(jb))
        assert graph_key(back) == graph_key(t)
    pred = _pred(1)
    assert wire.dumps(wire.encode_prediction(pred)) == \
        j_wire.dumps(j_wire.encode_prediction(pred))
    for cls in (ReplicaUnavailableError, InvalidRequestError, ServeError):
        e = cls("boom")
        assert wire.dumps(wire.encode_error(e)) == \
            j_wire.dumps(j_wire.encode_error(getattr(j_serve, cls.__name__)("boom")))
    assert wire.WIRE_V == j_wire.WIRE_V


def pytest_graph_key_digests_equal_jax():
    tg, jg = deterministic_graph_dataset(4, seed=9), j_dataset(4, seed=9)
    for t, j in zip(tg, jg):
        assert graph_key(t) == j_graph_key(j)
        bumped_t = dataclasses.replace(t, dataset_id=3)
        bumped_j = dataclasses.replace(j, dataset_id=3)
        assert graph_key(bumped_t) == j_graph_key(bumped_j) != graph_key(t)
    # the same context mixes in the same way
    tc = PredictionCache.__new__(PredictionCache)
    jc = j_serve.PredictionCache.__new__(j_serve.PredictionCache)
    for c in (tc, jc):
        c._lock, c._context = threading.Lock(), "ckpt=a.pt:ff;weights_dtype=int8"
    assert tc.key_for(tg[0]) == jc.key_for(jg[0])


def pytest_serve_config_fields_equal_jax():
    """The 32 keys with the JAX defaults, in the same order."""
    t = [(f.name, f.default) for f in dataclasses.fields(ServeConfig)]
    j = [(f.name, f.default) for f in dataclasses.fields(j_serve.ServeConfig)]
    assert t == j and len(t) == 32
    assert ServeConfig._KNOWN == j_serve.ServeConfig._KNOWN
    assert ServeConfig.WEIGHTS_DTYPES == j_serve.ServeConfig.WEIGHTS_DTYPES
    tq = ServeConfig(weights_dtype="int8").quantization
    jq = j_serve.ServeConfig(weights_dtype="int8").quantization
    assert dataclasses.asdict(tq) == dataclasses.asdict(jq)


@pytest.mark.parametrize("bad", [
    {"fleet_ready_floor": 1.5}, {"reload_error_spike": 2.0}, {"router_hedge_factor": 0.5},
    {"router_retries": -1}, {"breaker_failures": -2}, {"reload_probe_requests": -1},
    {"drain_grace_s": -1.0}, {"reload_poll_s": -0.5}, {"weights_dtype": "float16"},
    {"prediction_cache": ""}, {"prediction_cache": 3}, {"http_port": 70000},
    {"weights_dtype": "int8", "quantization": {"mode": "int4"}},
    {"weights_dtype": "int8", "quantization": {"max_eror": 0.1}},
    {"weights_dtype": "int8", "quantization": {"max_error": 0.0}},
    {"weights_dtype": "int8", "quantization": {"calibration_batches": 0}},
    {"quantization": {"exclude": [""]}},
])
def pytest_serve_config_refuses_what_jax_refuses(bad):
    def outcome(cls):
        try:
            cls(**bad)
        except (ValueError, TypeError) as e:
            return type(e).__name__, str(e)
        return None

    got, want = outcome(ServeConfig), outcome(j_serve.ServeConfig)
    assert want is not None and got == want


def pytest_serve_config_from_config_matches_jax():
    section = {"Serving": {"hot_reload": True, "weights_dtype": "int8",
                           "quantization": {"mode": "w8a8", "exclude": "heads"},
                           "fleet_replicas": 2, "prediction_cache": True,
                           "drain_grace_s": 1.5},
               "NeuralNetwork": {"Training": {"batch_size": 7}}}
    t, j = ServeConfig.from_config(section), j_serve.ServeConfig.from_config(section)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.micro_batch_graphs == 7 and t.quantization.exclude == ("heads",)


def pytest_error_tables_equal_jax():
    assert sorted(ERROR_CODES) == sorted(j_serve.ERROR_CODES)
    assert {c: k.__name__ for c, k in ERROR_CODES.items()} == \
        {c: k.__name__ for c, k in j_serve.ERROR_CODES.items()}
    assert RETRYABLE_CODES == j_serve.RETRYABLE_CODES
    for code in list(ERROR_CODES) + ["code_from_the_future"]:
        assert type(error_from_code(code, "m")).__name__ == \
            type(j_serve.error_from_code(code, "m")).__name__


# ---------------------------------------------------------------------------
# a two-replica fleet of CPU processes
# ---------------------------------------------------------------------------


def _fleet_config():
    return {
        "Verbosity": {"level": 0},
        "Dataset": {
            "name": "fleet_test", "format": "synthetic",
            "synthetic": {"number_configurations": 40},
            "node_features": {"name": ["x", "x2", "x3"], "dim": [1, 1, 1]},
            "graph_features": {"name": ["s"], "dim": [1]},
        },
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "GIN", "radius": 2.0, "max_neighbours": 100, "hidden_dim": 8,
                "num_conv_layers": 2, "task_weights": [1.0],
                "output_heads": {"graph": {"num_sharedlayers": 1, "dim_sharedlayers": 8,
                                           "num_headlayers": 2, "dim_headlayers": [8, 8]}},
            },
            "Variables_of_interest": {
                "input_node_features": [0], "output_names": ["s"], "output_index": [0],
                "type": ["graph"], "denormalize_output": False,
            },
            "Training": {"num_epoch": 1, "batch_size": 8,
                         "Optimizer": {"type": "AdamW", "learning_rate": 0.01}},
        },
        "Serving": {"batch_window_s": 0.002, "fleet_restart_backoff_s": 0.1,
                    "router_backoff_s": 0.01, "prediction_cache": True},
    }


def pytest_two_replica_cpu_fleet_survives_a_replica_kill(tmp_path, monkeypatch):
    """Replica 1 is SIGKILLed at its first request: every request still
    answers (the router retries it on replica 2), the supervisor restarts
    replica 1 and it comes back ready; the answers equal an in-process
    server's bit for bit, and a second pass hits the cache."""
    import torch

    from hydragnn_tpu_torch.api import prepare_data, run_server, run_server_fleet

    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the replicas' count: the same sums, bit for bit
    env = {"OMP_NUM_THREADS": "1", "HYDRAGNN_NUM_WORKERS": "0"}
    cfg = _fleet_config()
    fleet = run_server_fleet(cfg, replicas=2, device="cpu", wait_ready_s=240,
                             per_replica_env={1: {**env, "HYDRAGNN_FAULT_REPLICA_KILL": "1:0"},
                                              2: env})
    local = None
    try:
        _, (_, _, test_loader), _ = prepare_data(json.loads(json.dumps(cfg)))
        requests = list(test_loader.graphs[:6])
        router = fleet.router()
        fleet._refresh_cache_context()
        got = [router.predict(g, timeout_s=60.0) for g in requests]
        st = router.stats()
        assert st["failed"] == 0 and st["succeeded"] == len(requests)
        assert st["retries"] >= 1, st
        assert fleet.wait_ready(timeout=180.0), fleet.replica_state()
        assert fleet.replica_state()[1]["restarts"] >= 1
        local = run_server(cfg, device="cpu")
        assert local.wait_ready(60)
        want = local.predict(requests)
        for a, b in zip(got, want):
            assert set(a) == set(b)
            for k in a:
                assert a[k].tobytes() == b[k].tobytes(), k
        hits = router.stats()["cache_hits"]
        again = [router.predict(g, timeout_s=60.0) for g in requests]
        assert router.stats()["cache_hits"] - hits == len(requests)
        for a, b in zip(again, got):
            assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    finally:
        torch.set_num_threads(threads)
        if local is not None:
            local.close()
        fleet.close()
