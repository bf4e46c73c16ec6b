"""The port's fleet observability plane (hydragnn_tpu_torch/obs/fleet.py)
against the JAX package's on the CPU: the same pushes (and sweeps and
forgets) give the same responses, commands, host views, published series
and events in both collectors (counter max-merge, gauge last-write, stale
hosts leaving the aggregates, the straggler / desync / collective-budget
watchdog, the cadence-scaled staleness, restart-safe delivery); the
pushers apply a command once; the loopback plane round-trips; the
telemetry window pushes its heartbeat; ``merge_traces`` and the CLI stitch
the same streams."""

import json
import math
import os

import pytest

import hydragnn_tpu.obs.fleet as j_fleet
from hydragnn_tpu.obs.events import events as j_log
from hydragnn_tpu.obs.registry import MetricsRegistry as JRegistry
from hydragnn_tpu_torch.obs import fleet as t_fleet
from hydragnn_tpu_torch.obs.events import EV_FLEET_STRAGGLER
from hydragnn_tpu_torch.obs.events import events as t_log
from hydragnn_tpu_torch.obs.registry import MetricsRegistry as TRegistry
from hydragnn_tpu_torch.obs.registry import registry as t_registry
from hydragnn_tpu_torch.obs.telemetry import resolve_telemetry


def _push(host, step, step_time_s=None, samples=(), ack=0, comm=None):
    return {"v": 1, "host": host, "step": step, "step_time_s": step_time_s,
            "comm_fraction_est": comm, "ack": ack, "samples": list(samples)}


def _sample(name, kind, value, labels=()):
    return {"n": name, "k": kind, "l": [list(kv) for kv in labels], "v": value}


def _g(name, value, **labels):
    return _sample(name, "gauge", value, tuple(labels.items()))


def _c(name, value, **labels):
    return _sample(name, "counter", value, tuple(labels.items()))


# each scenario: collector kwargs, then ("push", payload, now) /
# ("sweep", now) / ("forget", host) operations
SCENARIOS = {
    "merge": ({"stale_after_s": 100.0}, [
        ("push", _push(0, 10, samples=[_c("c_total", 5.0), _g("g", 1.0)]), 0.0),
        ("push", _push(1, 9, samples=[_c("c_total", 3.0), _g("g", 3.0)]), 1.0),
        ("push", _push(1, 11, samples=[_c("c_total", 2.0)]), 2.0),
        ("push", _push(1, 12, samples=[_g("g", 0.5), _g("lab", 4.0, kind="a")]), 3.0),
    ]),
    "stale_and_rejoin": ({"stale_after_s": 10.0}, [
        ("push", _push(0, 5, samples=[_g("g", 1.0)]), 0.0),
        ("push", _push(1, 5, samples=[_g("g", 9.0)]), 0.0),
        ("push", _push(0, 8, samples=[_g("g", 2.0)]), 20.0),
        ("push", _push(1, 9, samples=[_g("g", 9.0), _g("only_h1", 5.0)]), 21.0),
        ("push", _push(0, 10, samples=[_g("g", 1.0)]), 40.0),
    ]),
    "straggler_desync": ({"straggler_factor": 1.5, "max_step_lag": 5,
                          "stale_after_s": 100.0}, [
        ("push", _push(0, 10, step_time_s=0.01), 0.0),
        ("push", _push(1, 10, step_time_s=0.1), 0.1),
        ("push", _push(1, 11, step_time_s=0.1), 0.2),
        ("push", _push(1, 12, step_time_s=0.01), 0.3),
        ("push", _push(1, 13, step_time_s=0.1), 0.4),
        ("push", _push(0, 30, step_time_s=0.01), 0.5),
        ("push", _push(0, 31, step_time_s=0.01, ack=3), 0.6),
        ("push", _push(0, 32, step_time_s=0.01, ack=0), 0.7),
    ]),
    "two_hosts_default_factor": ({"stale_after_s": 100.0}, [
        ("push", _push(0, 10, step_time_s=0.02), 0.0),
        ("push", _push(1, 10, step_time_s=0.2), 0.1),
        ("push", _push(2, 10, step_time_s=0.021), 0.2),
    ]),
    "cadence": ({"stale_after_s": 30.0}, [
        *[op for i, t in enumerate((0.0, 40.0, 80.0, 120.0))
          for op in (("push", _push(1, i, step_time_s=4.0), t),
                     ("push", _push(0, i, step_time_s=4.0), t + 1.0))],
        ("sweep", 220.0),
        ("sweep", 450.0),
    ]),
    "collective_budget": ({"collective_budget": 0.3, "stale_after_s": 100.0}, [
        ("push", _push(0, 5, step_time_s=0.01, comm=0.1), 0.0),
        ("push", _push(1, 5, step_time_s=0.01, comm=0.6), 0.1),
        ("push", _push(1, 6, step_time_s=0.01, comm=None), 0.2),
        ("push", _push(1, 7, step_time_s=0.01, comm=0.7), 0.3),
    ]),
    "forget_on_respawn": ({"stale_after_s": 2.0}, [
        ("push", _push(1, 3, samples=[_g("hydragnn_serve_queue_depth", 4.0)]), 0.0),
        ("push", _push(2, 3, samples=[_g("hydragnn_serve_queue_depth", 1.0)]), 0.5),
        ("forget", 1),
        ("sweep", 10.0),
        ("push", _push(1, 0, samples=[_g("hydragnn_serve_queue_depth", 0.0)]), 11.0),
    ]),
}


def _published(reg):
    """Every sample of the collector's own registry, as plain values."""
    out = {}
    for metric in reg.collect():
        for suffix, labels, value in metric.samples():
            v = float(value)
            out[(metric.name + suffix, tuple(labels))] = "nan" if math.isnan(v) else v
    return out


def _run(fleet, registry_cls, log, kw, ops):
    log.clear()
    reg = registry_cls()
    col = fleet.FleetCollector(reg=reg, **kw)
    trail = []
    for op in ops:
        if op[0] == "push":
            trail.append(col.absorb(json.loads(json.dumps(op[1])), now=op[2]))
        elif op[0] == "sweep":
            col.sweep(now=op[1])
        else:
            col.forget(op[1])
        trail.append((col.hosts(), {h: col.host_series(h) for h in col.hosts()},
                      col.pending_commands()))
    evs = [(e["kind"], e.get("host"), e.get("last_step")) for e in log.snapshot()]
    return trail, _published(reg), evs


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def pytest_collector_decisions_and_series_match_jax(name):
    kw, ops = SCENARIOS[name]
    t = _run(t_fleet, TRegistry, t_log(), kw, ops)
    j = _run(j_fleet, JRegistry, j_log(), kw, ops)
    assert t[0] == j[0]  # responses, host views, per-host series, commands
    assert t[1] == j[1]  # the published hydragnn_fleet_* series
    assert t[2] == j[2]  # the fleet_host_stale events


def pytest_registry_snapshot_matches_jax():
    regs = (TRegistry(), JRegistry())
    for reg in regs:
        reg.counter("hydragnn_serve_events_total", "e", labelnames=("event",)).inc(
            3, event="completed")
        reg.gauge("hydragnn_serve_queue_depth", "q").set(2.0)
        h = reg.histogram("hydragnn_serve_batch_latency_seconds", "l")
        h.observe(0.01)
        h.observe(0.2)
        reg.gauge("hydragnn_fleet_hosts", "own output, excluded").set(5.0)
    t, j = (m.registry_snapshot(r) for m, r in zip((t_fleet, j_fleet), regs))
    assert t == j and not any(s["n"].startswith("hydragnn_fleet_") for s in t)
    assert t_fleet.series_key("a", [("k", "v"), ("h", "1")]) == \
        j_fleet.series_key("a", [("k", "v"), ("h", "1")]) == 'a{k="v",h="1"}'


def pytest_host_identity_env_and_malformed(monkeypatch):
    monkeypatch.setenv("HYDRAGNN_FLEET_HOST_INDEX", "3")
    monkeypatch.setenv("HYDRAGNN_FLEET_HOST_COUNT", "8")
    assert t_fleet.host_identity() == j_fleet.host_identity() == (3, 8)
    monkeypatch.setenv("HYDRAGNN_FLEET_HOST_INDEX", "$SLURM_PROCID")
    with pytest.warns(RuntimeWarning, match="malformed"):
        assert t_fleet.host_identity() == (0, 1)
    for k in ("HYDRAGNN_FLEET_HOST_INDEX", "HYDRAGNN_FLEET_HOST_COUNT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert t_fleet.host_identity() == (2, 4)


def pytest_pusher_applies_commands_once_with_event_and_dump(tmp_path):
    from hydragnn_tpu_torch.obs.flightrec import FlightRecorder

    t_log().clear()
    rec = FlightRecorder(str(tmp_path)).install(signal_hook=False)
    try:
        pusher = t_fleet.FleetPusher("http://127.0.0.1:9/unused", 1, 2)
        try:
            cmd = {"id": 1, "kind": EV_FLEET_STRAGGLER, "host": 1,
                   "step": 40, "cause": "step_time"}
            pusher._apply_commands([cmd])
            pusher._apply_commands([cmd])  # a replay is a no-op
        finally:
            pusher.close()
        evs = [e for e in t_log().snapshot() if e["kind"] == EV_FLEET_STRAGGLER]
        assert len(evs) == 1 and evs[0]["step"] == 40
        dumps = os.listdir(os.path.join(str(tmp_path), "flightrec"))
        assert any("fleet_straggler_step40" in d for d in dumps), dumps
    finally:
        rec.uninstall()


def pytest_fleet_plane_loopback_round_trip(monkeypatch):
    monkeypatch.delenv("HYDRAGNN_FLEET_COLLECTOR", raising=False)
    settings = resolve_telemetry({"Telemetry": {"enabled": True, "fleet": True}})
    plane = t_fleet.FleetPlane.from_settings(settings)
    assert plane is not None and plane.collector is not None and plane.pusher is not None
    try:
        t_registry().gauge("fleet_rt_gauge").set(42.0)
        assert plane.pusher.push_now(7, step_time_s=0.01)
        assert plane.collector.hosts()[0]["step"] == 7
        assert t_registry().get("hydragnn_fleet_max").value(series="fleet_rt_gauge") == 42.0
    finally:
        plane.close()
    assert t_fleet.FleetPlane.from_settings(resolve_telemetry({})) is None


def pytest_fleet_plane_rejects_malformed_env_collector(monkeypatch):
    monkeypatch.setenv("HYDRAGNN_FLEET_COLLECTOR", "rank0host")
    settings = resolve_telemetry({"Telemetry": {"fleet": True}})
    with pytest.warns(RuntimeWarning, match="not 'host:port'"):
        plane = t_fleet.FleetPlane.from_settings(settings)
    try:
        assert plane.endpoint is not None and "127.0.0.1" in plane.pusher.url
    finally:
        plane.close()


def pytest_step_telemetry_window_pushes_heartbeat(tmp_path, monkeypatch):
    """With ``Telemetry.fleet`` the window flush is the heartbeat: the
    collector (rank 0's, loopback) sees the step and the window's step
    time; close sends the final step."""
    import torch

    from hydragnn_tpu_torch.obs.telemetry import StepTelemetry

    monkeypatch.delenv("HYDRAGNN_FLEET_COLLECTOR", raising=False)
    tel = StepTelemetry.from_config(
        {"Telemetry": {"enabled": True, "fleet": True, "interval_steps": 2, "jsonl": False}},
        "fleetrun", log_path=str(tmp_path), device=torch.device("cpu"))
    assert tel.fleet is not None and tel.fleet.collector is not None
    collector = tel.fleet.collector
    tel.fleet.pusher.min_interval_s = 0.0
    from hydragnn_tpu_torch.data import GraphLoader, oc20_shaped_dataset

    batch = next(iter(GraphLoader(oc20_shaped_dataset(4, mean_atoms=10, min_atoms=5,
                                                      max_atoms=20), 2)))
    for _ in range(4):
        tel.step_begin()
        tel.on_step(batch, 0.01, 2)
    tel.close()
    hosts = collector.hosts()
    assert hosts[0]["step"] == 4 and hosts[0]["pushes"] >= 1


def _trace_files(tmp_path):
    paths = []
    for host, spans in ((0, [(30, "b"), (10, "a")]), (1, [(20, "c")])):
        p = tmp_path / f"trace-h{host}.jsonl"
        lines = [json.dumps({"name": n, "startTimeUnixNano": t, "host": host})
                 for t, n in spans]
        p.write_text("\n".join(lines) + ("\n{truncated" if host else "") + "\n")
        paths.append(str(p))
    nohost = tmp_path / "trace.jsonl"
    nohost.write_text(json.dumps({"name": "d", "startTimeUnixNano": 5}) + "\n")
    return paths + [str(nohost)]


def pytest_merge_traces_matches_jax(tmp_path, capsys):
    paths = _trace_files(tmp_path)
    t = t_fleet.merge_traces(paths, str(tmp_path / "t.jsonl"))
    j = j_fleet.merge_traces(paths, str(tmp_path / "j.jsonl"))
    assert t == j == {"spans": 4, "hosts": [0, 1], "files": 3, "skipped": 1}
    assert (tmp_path / "t.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()
    names = [json.loads(x)["name"] for x in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert names == ["d", "a", "c", "b"]
    assert t_fleet.main([str(tmp_path / "cli.jsonl"), *paths]) == 0
    assert "merged 4 spans from 3 stream(s)" in capsys.readouterr().out
    assert t_fleet.main(["only.jsonl"]) == 2
