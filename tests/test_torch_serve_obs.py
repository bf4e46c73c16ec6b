"""The port's serving observability against the JAX package's, on the CPU.

Both packages' ``run_server`` serve the same config (an EGNN of hidden 16,
3 pad levels) with ``Telemetry.trace`` on and ``trace_sample`` 1.0, and
answer the same 12 requests. What must agree: the span-name tree (each
``(span, parent)`` pair of ``trace.jsonl``, and one ``serve/request``
root with its ``serve/admit`` and ``serve/queue_wait`` children per
request), and the ``hydragnn_serve_*`` series names the ``/metrics``
endpoint (``Serving.http_port`` 0: an ephemeral loopback port) renders.
The port's endpoint answers ``/healthz`` and ``/readyz`` (503 before
warm-up or after the drain); its request histogram counts every request;
its watchdog fails a wedged step's requests with ``WedgedStepError``,
emits ``serve_wedge`` and dumps the flight recorder, and the next request
is answered by a fresh step runner.
"""

import copy
import json
import os
import re
import time
import urllib.request
from collections import Counter
from importlib import import_module

import pytest
import torch

from hydragnn_tpu.api import run_server as j_run_server
from hydragnn_tpu_torch.api import run_server
from hydragnn_tpu_torch.data import oc20_shaped_dataset, split_dataset
from hydragnn_tpu_torch.serve import WedgedStepError

t_events = import_module("hydragnn_tpu_torch.obs.events")
t_registry = import_module("hydragnn_tpu_torch.obs.registry")
t_schema = import_module("hydragnn_tpu_torch.obs.schema")
j_registry = import_module("hydragnn_tpu.obs.registry")
j_schema = import_module("hydragnn_tpu.obs.schema")

torch.set_num_threads(2)

N_REQUESTS = 12


def _config(**serving):
    return {
        "Verbosity": {"level": 0},
        "Dataset": {"node_features": {"dim": [1, 3, 3]}, "graph_features": {"dim": [1]}},
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "EGNN", "equivariance": True, "radius": 5.0,
                "max_neighbours": 10, "hidden_dim": 16, "num_conv_layers": 2,
                "use_sorted_aggregation": True, "task_weights": [1.0, 1.0],
                "output_heads": {
                    "graph": {"num_sharedlayers": 1, "dim_sharedlayers": 8,
                              "num_headlayers": 2, "dim_headlayers": [8, 8]},
                    "node": {"num_headlayers": 2, "dim_headlayers": [8, 8], "type": "mlp"}}},
            "Variables_of_interest": {
                "input_node_features": [0, 1], "output_names": ["energy", "forces"],
                "output_index": [0, 2], "type": ["graph", "node"]},
            "Training": {"batch_size": 4, "pack_batches": True, "num_pad_buckets": 3},
        },
        "Serving": {"batch_window_s": 0.01, "http_port": 0, **serving},
        "Telemetry": {"trace": True, "trace_sample": 1.0},
    }


def _graphs():
    return oc20_shaped_dataset(16, mean_atoms=20, min_atoms=10, max_atoms=40,
                               max_neighbours=10)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _serve(start, workdir, graphs):
    """Serve ``N_REQUESTS`` requests through ``start(config, splits)``;
    ``(spans, /metrics text, server)`` with the server closed."""
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        server = start(_config(), split_dataset(graphs, 0.75, seed=0))
        try:
            assert server.wait_ready(120)
            assert _get(f"http://127.0.0.1:{server.http_port}/readyz")[0] == 200
            out = server.predict([graphs[i % len(graphs)] for i in range(N_REQUESTS)],
                                 timeout=60)
            assert all(isinstance(o, dict) for o in out)
            _, metrics = _get(f"http://127.0.0.1:{server.http_port}/metrics")
        finally:
            server.close()
        (log_name,) = os.listdir("logs")
        with open(os.path.join("logs", log_name, "trace.jsonl")) as fh:
            spans = [json.loads(line) for line in fh]
    finally:
        os.chdir(cwd)
    return spans, metrics, server


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    graphs = _graphs()
    # each package's servers publish into a registry of their own here: the
    # process registries also hold what earlier test files of this process
    # registered (the JAX serving cache's series, say)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_registry, "_REGISTRY", j_registry.MetricsRegistry())
        mp.setattr(t_registry, "_REGISTRY", t_registry.MetricsRegistry())
        with pytest.warns(UserWarning, match="no checkpoint"):
            jax_side = _serve(lambda c, s: j_run_server(c, s), tmp_path_factory.mktemp("jax"),
                              graphs)
        with pytest.warns(UserWarning, match="no checkpoint"):
            port_side = _serve(lambda c, s: run_server(c, datasets=s, device="cpu"),
                               tmp_path_factory.mktemp("port"), graphs)
    return {"jax": jax_side, "port": port_side}


def _tree(spans):
    names = {s["spanId"]: s["name"] for s in spans}
    return {(s["name"], names.get(s.get("parentSpanId"))) for s in spans}


def pytest_span_tree_matches_jax(served):
    jspans, tspans = served["jax"][0], served["port"][0]
    assert _tree(tspans) == _tree(jspans)
    for spans in (jspans, tspans):
        roots = [s for s in spans if s["name"] == "serve/request"]
        assert len(roots) == N_REQUESTS and all(s.get("status", {}).get("code") == 1
                                                for s in roots)
        kids = Counter((s["name"], s["parentSpanId"]) for s in spans if "parentSpanId" in s)
        for r in roots:
            assert kids[("serve/admit", r["spanId"])] == 1
            assert kids[("serve/queue_wait", r["spanId"])] == 1
    steps = [s for s in tspans if s["name"] == "serve/step"]
    for st in steps:
        kids = sorted(s["name"] for s in tspans if s.get("parentSpanId") == st["spanId"])
        assert kids == ["serve/batch_form", "serve/bucket_select", "serve/device_step",
                        "serve/respond"]
    for s in tspans:
        assert t_schema.validate_span_record(s) == [] == j_schema.validate_span_record(s)


def _series(text):
    return {m.group(1) for m in re.finditer(r"^(hydragnn_serve_\w+?)(?:_bucket|_sum|_count)?[{ ]",
                                            text, re.M)}


def pytest_metrics_series_match_jax_and_count_requests(served):
    jmetrics, tmetrics, server = served["jax"][1], served["port"][1], served["port"][2]
    assert _series(tmetrics) == _series(jmetrics) and _series(tmetrics)
    count = re.search(r'^hydragnn_serve_request_latency_seconds_count\{outcome="ok"\} (\S+)',
                      tmetrics, re.M)
    assert count and float(count.group(1)) >= N_REQUESTS
    assert server.http_port is None  # closed with the server


def pytest_health_readiness_and_the_watchdog(tmp_path, monkeypatch):
    """``/healthz`` and ``/readyz`` through the lifecycle, and a step that
    sleeps past ``step_timeout_s``: its request fails with
    ``WedgedStepError``, ``serve_wedge`` is emitted, the flight recorder
    dumps, and the next request is answered."""
    monkeypatch.chdir(tmp_path)
    graphs = _graphs()
    cfg = _config(step_timeout_s=0.5)
    cfg["Telemetry"] = {"enabled": True}
    with pytest.warns(UserWarning, match="no checkpoint"):
        server = run_server(cfg, datasets=split_dataset(graphs, 0.75, seed=0), device="cpu")
    base = f"http://127.0.0.1:{server.http_port}"
    try:
        assert server.wait_ready(120)
        assert _get(base + "/healthz")[0] == 200 and _get(base + "/readyz")[0] == 200
        forward = server.forward
        slept = []

        def wedged(batch):
            if not slept:
                slept.append(1)
                time.sleep(2.0)
            return forward(batch)

        n0 = len(t_events.events().snapshot())
        server.forward = wedged
        err = server.submit(graphs[0]).error(timeout=30)
        assert isinstance(err, WedgedStepError)
        wedge = [e for e in t_events.events().snapshot()[n0:] if e["kind"] == "serve_wedge"]
        assert len(wedge) == 1 and wedge[0]["step_timeout_s"] == 0.5
        out = server.predict([graphs[1]], timeout=30)
        assert isinstance(out[0], dict) and server.stats()["wedged_batches"] == 1
        server.initiate_drain()
        assert _get(base + "/readyz")[0] == 503
    finally:
        server.close()
    (log_name,) = os.listdir("logs")
    dumps = os.listdir(os.path.join("logs", log_name, "flightrec"))
    assert any(d.endswith("serve_wedge-h0") for d in dumps)
    events = os.path.join("logs", log_name, "events.jsonl")
    kinds = [json.loads(line)["kind"] for line in open(events)]
    assert "serve_wedge" in kinds and "flightrec_dump" in kinds
