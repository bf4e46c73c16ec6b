"""The port's observability modules against the JAX package's, on the CPU.

The pure-Python pieces are copies and are held equal: the same publishes
render byte-equal Prometheus text, the schema tables and event vocabulary
are the same, ``resolve_telemetry`` gives the same settings or raises the
same exception type for every section below. The rest is the port's own
contract: the endpoint on an ephemeral loopback port, the span plane, the
flight recorder, the region timers, the writer and the profile trigger,
and that the new modules import nothing of JAX or of the JAX package.
"""

import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest

from importlib import import_module

# by module path: each package's obs/__init__ re-exports functions under
# the names of the ``events`` and ``registry`` modules
j_events = import_module("hydragnn_tpu.obs.events")
j_prom = import_module("hydragnn_tpu.obs.prometheus")
j_registry = import_module("hydragnn_tpu.obs.registry")
j_schema = import_module("hydragnn_tpu.obs.schema")
j_telemetry = import_module("hydragnn_tpu.obs.telemetry")
t_events = import_module("hydragnn_tpu_torch.obs.events")
t_flightrec = import_module("hydragnn_tpu_torch.obs.flightrec")
t_prom = import_module("hydragnn_tpu_torch.obs.prometheus")
t_registry = import_module("hydragnn_tpu_torch.obs.registry")
t_schema = import_module("hydragnn_tpu_torch.obs.schema")
t_telemetry = import_module("hydragnn_tpu_torch.obs.telemetry")
t_trace = import_module("hydragnn_tpu_torch.obs.trace")

REPO = Path(__file__).resolve().parents[1]
NEW_MODULES = (
    "obs/__init__.py", "obs/events.py", "obs/flightrec.py", "obs/flops.py", "obs/memory.py",
    "obs/numerics.py", "obs/prometheus.py", "obs/registry.py", "obs/schema.py",
    "obs/telemetry.py", "obs/trace.py", "utils/printing.py", "utils/profile.py",
    "utils/timers.py", "utils/tracer.py", "utils/writer.py",
)


def _publish(mod):
    """The same publishes into a fresh registry of ``mod``."""
    reg = mod.MetricsRegistry()
    c = reg.counter("hydragnn_demo_total", "A demo counter", labelnames=("kind",))
    c.inc(3, kind="a")
    c.inc(kind="b\"quoted\\")
    c.set_total(7, kind="a")
    g = reg.gauge("hydragnn_demo_gauge", "A demo gauge")
    g.set(0.125)
    g.set_default(9.0)
    h = reg.histogram("hydragnn_demo_seconds", "A demo histogram", labelnames=("op",))
    for v in (0.0004, 0.003, 0.2, 1.5, 40.0):
        h.observe(v, op="write")
    h2 = reg.histogram("hydragnn_demo_custom", "Custom buckets", buckets=(0.5, 1.0))
    h2.observe(0.7)
    return reg


def pytest_render_text_is_byte_equal():
    j = j_prom.render_text(_publish(j_registry))
    t = t_prom.render_text(_publish(t_registry))
    assert t == j and "hydragnn_demo_seconds_bucket" in t


def pytest_registry_defaults_and_schema_tables_are_the_jax_ones():
    assert t_registry.DEFAULT_BUCKETS == j_registry.DEFAULT_BUCKETS
    for name in ("METRICS_SCHEMA_VERSION", "TRACE_SCHEMA_VERSION", "EVENTS_SCHEMA_VERSION",
                 "METRICS_ENVELOPE", "METRICS_KINDS", "SPAN_FIELDS", "EVENT_FIELDS"):
        assert getattr(t_schema, name) == getattr(j_schema, name), name
    assert t_events.EVENT_KINDS == j_events.EVENT_KINDS
    assert t_events.DEFAULT_SEVERITY == j_events.DEFAULT_SEVERITY
    assert t_events.SEVERITIES == j_events.SEVERITIES
    assert t_telemetry.TELEMETRY_DEFAULTS == j_telemetry.TELEMETRY_DEFAULTS


SECTIONS = [
    None,
    {},
    {"enabled": True},
    {"enabled": True, "interval_steps": 5, "trace": True, "trace_interval_steps": 1,
     "numerics": True, "http_port": 0},
    {"trace_sample": 1.0, "profile_steps": 3, "http_host": "0.0.0.0", "mfu": False},
    {"fleet_collector": "node0:9100", "fleet_collective_budget": 0.5},
    {"unknown_key": 1, "enabled": True},
    {"interval_steps": 0},
    {"profile_steps": 0},
    {"http_port": 70000},
    {"http_host": ""},
    {"trace_sample": 1.5},
    {"trace_interval_steps": 0},
    {"numerics": "yes"},
    {"fleet": "yes"},
    {"fleet_straggler_factor": 1.0},
    {"fleet_max_step_lag": 0},
    {"fleet_stale_after_s": 0},
    {"fleet_collective_budget": 0.0},
    {"fleet_sharding_audit_bytes": -1},
    {"fleet_collector": "nocolon"},
]


def _resolve(mod, section):
    try:
        return mod.resolve_telemetry({"Telemetry": section} if section is not None else {})
    except Exception as e:  # noqa: BLE001 -- compared by type
        return type(e)


@pytest.mark.parametrize("section", SECTIONS, ids=[str(i) for i in range(len(SECTIONS))])
@pytest.mark.parametrize("env", [{}, {"HYDRAGNN_TELEMETRY": "1", "HYDRAGNN_NUMERICS": "0"}],
                         ids=["noenv", "env"])
def pytest_resolve_telemetry_matches_jax(section, env, monkeypatch):
    for k in ("HYDRAGNN_TELEMETRY", "HYDRAGNN_NUMERICS", "HYDRAGNN_FLEET"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert _resolve(t_telemetry, section) == _resolve(j_telemetry, section)


def pytest_fleet_raises_not_implemented(monkeypatch):
    """The fleet plane is ported (obs/fleet.py): ``fleet: true`` and
    ``HYDRAGNN_FLEET=1`` resolve as the JAX package resolves them, and no
    longer raise."""
    monkeypatch.delenv("HYDRAGNN_FLEET", raising=False)
    section = {"Telemetry": {"fleet": True}}
    assert t_telemetry.resolve_telemetry(section) == j_telemetry.resolve_telemetry(section)
    assert t_telemetry.resolve_telemetry(section)["fleet"] is True
    monkeypatch.setenv("HYDRAGNN_FLEET", "1")
    assert t_telemetry.resolve_telemetry({})["fleet"] is True
    assert t_telemetry.resolve_telemetry({}) == j_telemetry.resolve_telemetry({})


def pytest_peak_is_the_cards_own():
    """The H100 SXM5's dense bf16 peak; no guessed peak elsewhere."""
    assert t_telemetry.peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert t_telemetry.peak_flops("TPU v5 lite") is None
    assert t_telemetry.peak_flops("cpu") is None
    assert t_telemetry.mfu_estimate(989.4e12, 2.0, "NVIDIA H100 80GB HBM3") == 0.5
    assert t_telemetry.mfu_estimate(1e9, 1.0, "cpu") is None


def pytest_new_modules_import_nothing_of_jax():
    """Neither the source nor a fresh interpreter importing every new module
    touches ``jax``, ``flax``, ``optax`` or ``hydragnn_tpu``."""
    for rel in NEW_MODULES:
        src = (REPO / "hydragnn_tpu_torch" / rel).read_text()
        for line in src.splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                root = words[1].split(".")[0]
                assert root not in ("jax", "jaxlib", "flax", "optax", "hydragnn_tpu"), (rel, line)
    mods = ", ".join("hydragnn_tpu_torch." + r[:-3].replace("/", ".").replace(".__init__", "")
                     for r in NEW_MODULES)
    code = (f"import sys, importlib\nfor m in '{mods}'.split(', '): importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'hydragnn_tpu')]\nprint(bad)\n"
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def pytest_endpoint_serves_metrics_health_and_readiness():
    reg = _publish(t_registry)
    state = {"ready": False, "healthy": True}
    srv = t_prom.start_endpoint(0, ready_fn=lambda: state["ready"],
                                health_fn=lambda: (state["healthy"], "detail"), reg=reg)
    try:
        assert srv is not None and srv.port > 0
        code, body = _get(srv.url + "/metrics")
        assert code == 200 and body == t_prom.render_text(reg)
        assert _get(srv.url + "/healthz")[0] == 200
        assert _get(srv.url + "/readyz")[0] == 503
        state.update(ready=True, healthy=False)
        assert _get(srv.url + "/readyz")[0] == 200
        assert _get(srv.url + "/healthz")[0] == 503
    finally:
        srv.close()


def pytest_tracer_spans_regions_and_records(tmp_path):
    """Every-Nth step sampling, the thread-local span stack, a closed
    region as a child span, ``note_completed`` as its own trace; every
    record validates against both packages' schema."""
    from hydragnn_tpu_torch.utils import tracer as tr

    tracer = t_trace.install(t_trace.Tracer(str(tmp_path), every_n_steps=2))
    try:
        assert [tracer.sample_step() for _ in range(4)] == [False, True, False, True]
        tr.enable()
        with tracer.span("train/guard_verdict", epoch=0):
            tr.start("validate")
            tr.stop("validate")
        t_trace.note_completed("train/checkpoint_write", 0.01, {"op": "write"})
        root = tracer.begin("serve/request")
        tracer.emit_completed("serve/admit", 0.0, 0.001, parent=root)
        tracer.finish(root)
    finally:
        t_trace.uninstall(tracer)
        tracer.close()
    recs = [json.loads(l) for l in (tmp_path / "trace.jsonl").read_text().splitlines()]
    by_name = {r["name"]: r for r in recs}
    assert set(by_name) == {"validate", "train/guard_verdict", "train/checkpoint_write",
                            "serve/request", "serve/admit"}
    assert by_name["validate"]["parentSpanId"] == by_name["train/guard_verdict"]["spanId"]
    assert by_name["serve/admit"]["parentSpanId"] == by_name["serve/request"]["spanId"]
    assert "parentSpanId" not in by_name["train/checkpoint_write"]
    for r in recs:
        assert t_schema.validate_span_record(r) == [] == j_schema.validate_span_record(r)


def pytest_flight_recorder_dumps_events_spans_metrics(tmp_path):
    rec = t_flightrec.FlightRecorder(str(tmp_path)).install()
    try:
        t_events.emit(t_events.EV_GUARD_SKIP, epoch=0, total=1)
        path = t_flightrec.trigger("unit_test")
    finally:
        rec.uninstall()
    assert path is not None and t_flightrec.trigger("after") is None
    files = sorted(os.listdir(path))
    assert files == ["events.json", "memory.json", "meta.json", "metrics.prom", "spans.json"]
    meta = json.loads(Path(path, "meta.json").read_text())
    assert meta["reason"] == "unit_test" and meta["worst_severity"] in ("warn", "info")
    for e in json.loads(Path(path, "events.json").read_text()):
        assert t_schema.validate_event_record(e) == [] == j_schema.validate_event_record(e)
    assert "hydragnn_events_total" in Path(path, "metrics.prom").read_text()


def pytest_events_stream_backfills_and_validates(tmp_path):
    log = t_events.EventLog(capacity=8)
    log.emit(t_events.EV_DATA_SKIP, reason="nonfinite_features", index=3)
    assert log.attach_jsonl(str(tmp_path / "events.jsonl"))
    log.emit(t_events.EV_CKPT_WRITE, seconds=0.5, extra={"a": {1, 2}})
    log.detach_jsonl()
    recs = [json.loads(l) for l in (tmp_path / "events.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in recs] == ["data_skip", "checkpoint_write"]
    assert recs[0]["severity"] == "warn" and recs[1]["extra"] == {"a": [1, 2]}
    for r in recs:
        assert j_schema.validate_event_record(r) == []


def pytest_timers_regions_writer_and_log(tmp_path, capsys):
    from hydragnn_tpu_torch.utils import tracer as tr
    from hydragnn_tpu_torch.utils.printing import print_distributed, print_master, setup_log
    from hydragnn_tpu_torch.utils.timers import Timer, print_timers
    from hydragnn_tpu_torch.utils.writer import MetricsWriter

    Timer.reset()
    with Timer("load_data"):
        pass
    Timer("load_data").start().stop()
    print_timers(1)
    out = capsys.readouterr().out
    assert "load_data" in out and Timer.totals().keys() == {"load_data"}
    tr.reset()
    tr.enable()
    with tr.timer("dataload"):
        pass
    assert tr.get_regions()["dataload"]["count"] == 1
    w = MetricsWriter("run", path=str(tmp_path))
    w.add_scalars({"loss/train": 0.5, "lr": 1e-3}, 2)
    w.close()
    rows = [json.loads(l) for l in (tmp_path / "run" / "scalars.jsonl").read_text().splitlines()]
    assert rows == [{"tag": "loss/train", "value": 0.5, "step": 2},
                    {"tag": "lr", "value": 1e-3, "step": 2}]
    log = setup_log("run", path=str(tmp_path))
    log.info("hello")
    for h in list(log.handlers):
        h.close()
        log.removeHandler(h)
    assert "hello" in (tmp_path / "run" / "run.log").read_text()
    print_master("shown", verbosity=2)
    print_distributed(0, "hidden")
    assert capsys.readouterr().out.count("shown") == 1


def pytest_profile_trigger_captures_steps(tmp_path):
    """A touch file arms a ``torch.profiler`` capture at the next poll; it
    stops after ``steps`` steps and its trace names the regions."""
    import torch

    from hydragnn_tpu_torch.utils import tracer as tr

    trig = t_telemetry.ProfileTrigger(str(tmp_path), steps=2, install_signal=False)
    (tmp_path / "profile_trigger").touch()
    trig.poll(5)
    assert trig.active and not (tmp_path / "profile_trigger").exists()
    tr.enable()
    for step in (6, 7):
        with tr.timer("train_step"):
            torch.ones(4) @ torch.ones(4)
        trig.step(step)
    assert not trig.active and trig.captures == 1
    trace = Path(trig.paths[0]).read_text()
    assert "train_step" in trace
    trig.close()


def pytest_memory_and_build_info_without_a_gpu():
    from hydragnn_tpu_torch.obs import memory

    assert memory.device_memory_stats() == {} and memory.device_bytes_limit() is None
    memory.record("spec", {"peak_bytes": 1024.0})
    assert memory.snapshot()["spec"] == {"peak_bytes": 1024.0}
    memory.reset()
    t_telemetry.publish_build_info()
    text = t_prom.render_text()
    assert "hydragnn_build_info" in text and 'backend="cpu"' in text
    assert t_telemetry.host_memory_bytes() > 0


def pytest_profile_section_captures_its_epoch(tmp_path, monkeypatch):
    """``NeuralNetwork.Profile`` in ``run_training``: the target epoch's
    ``torch.profiler`` trace under ``logs/<run>/profile``, naming the step's
    ranges; the legacy top-level ``Profile`` is read too."""
    import chip_smoke
    from hydragnn_tpu_torch.api import run_training
    from hydragnn_tpu_torch.data import oc20_shaped_dataset, split_dataset

    monkeypatch.chdir(tmp_path)
    splits = split_dataset(oc20_shaped_dataset(16, mean_atoms=12, min_atoms=8, max_atoms=16),
                           0.75, seed=0)
    for where in ("NeuralNetwork", "top"):
        cfg = chip_smoke.train_config(batch_size=4, hidden=8, head=8)
        cfg["NeuralNetwork"]["Training"]["num_epoch"] = 2
        section = {"enable": 1, "target_epoch": 1}
        if where == "top":
            cfg["Profile"] = section
            cfg["NeuralNetwork"]["Architecture"]["hidden_dim"] = 12  # another run dir
        else:
            cfg["NeuralNetwork"]["Profile"] = section
        run_training(cfg, datasets=splits, device="cpu")
    traces = sorted(tmp_path.glob("logs/*/profile/trace.json"))
    assert len(traces) == 2
    for trace in traces:
        names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
        assert {"train/step", "train/device_dispatch", "dataload"} <= names
