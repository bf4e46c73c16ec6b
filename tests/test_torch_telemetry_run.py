"""A ``Telemetry``-on ``run_training`` in the port against the JAX
package's, on the CPU.

Both run the same config (a 2-layer EGNN of hidden 24, batch 4, AdamW,
best-validation checkpoints, 2 epochs) on the same splits, the port from
the JAX run's own initial weights (``bridge.load_jax_variables``), with
``Telemetry`` on: windows of 2 steps, every step traced, numerics on.
What must agree:

- the ``metrics.jsonl`` record kinds and each kind's keys (the JAX run's
  ``compile_report`` record is the compile plane's, not ported);
- every window's census exactly: its step, steps, per-level buckets and
  the padding waste of each axis;
- the epoch losses and the ``scalars.jsonl`` values within
  ``test_torch_train.py``'s loss tolerance (1e-5 relative); the numerics
  records' tensor names, and their statistics within 1e-3 relative. One
  step's statistics agree to 1e-5 (test_torch_numerics.py); over the run,
  AdamW moves each weight whose gradient is rounding noise by about lr
  either way, in both packages (test_torch_train.py), and the windows'
  gradient statistics drift with it: 2.7e-4 at most here, one group's
  rms in the last window, every other entry within 1e-5;
- the span-name tree of ``trace.jsonl`` and the event kinds of
  ``events.jsonl``;
- ``print_model``'s parameter count;

and every record the port writes passes the JAX package's validators.
"""

import copy
import json
import os
from collections import Counter
from importlib import import_module

import numpy as np
import pytest
import torch

import jax

from hydragnn_tpu.api import prepare_data as j_prepare
from hydragnn_tpu.api import run_training as j_run_training
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.models import init_model as j_init
from hydragnn_tpu.utils.printing import print_model as j_print_model
from hydragnn_tpu_torch.api import run_training
from hydragnn_tpu_torch.data import oc20_shaped_dataset, split_dataset
from hydragnn_tpu_torch.utils.printing import print_model

j_events = import_module("hydragnn_tpu.obs.events")
j_schema = import_module("hydragnn_tpu.obs.schema")
t_events = import_module("hydragnn_tpu_torch.obs.events")

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
STATS_RTOL = 1e-3
VALIDATORS = {"metrics.jsonl": j_schema.validate_metrics_record,
              "trace.jsonl": j_schema.validate_span_record,
              "events.jsonl": j_schema.validate_event_record}


def _config():
    return {
        "Verbosity": {"level": 0},
        "Dataset": {"node_features": {"dim": [1, 3, 3]}, "graph_features": {"dim": [1]}},
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "EGNN", "equivariance": True, "radius": 5.0,
                "max_neighbours": 10, "hidden_dim": 24, "num_conv_layers": 2,
                "use_sorted_aggregation": True, "task_weights": [1.0, 100.0],
                "output_heads": {
                    "graph": {"num_sharedlayers": 2, "dim_sharedlayers": 8,
                              "num_headlayers": 2, "dim_headlayers": [12, 12]},
                    "node": {"num_headlayers": 2, "dim_headlayers": [12, 12],
                             "type": "mlp"}}},
            "Variables_of_interest": {
                "input_node_features": [0, 1], "output_names": ["energy", "forces"],
                "output_index": [0, 2], "type": ["graph", "node"]},
            "Training": {"batch_size": 4, "loss_function_type": "mae", "pack_batches": True,
                         "num_epoch": 2, "precompile": "off", "Checkpoint": True,
                         "Optimizer": {"type": "AdamW", "learning_rate": 1e-3}},
        },
        "Telemetry": {"enabled": True, "interval_steps": 2, "trace": True,
                      "trace_interval_steps": 1, "numerics": True, "profile_trigger": False},
    }


def _read(run_dir, name):
    path = os.path.join(run_dir, name)
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return [json.loads(line) for line in fh]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' runs, once for the file: ``{side: (run dir, history,
    parameter count)}``."""
    graphs = oc20_shaped_dataset(28, mean_atoms=20, min_atoms=10, max_atoms=40,
                                 max_neighbours=10)
    splits = split_dataset(graphs, 0.75, seed=0)
    raw = _config()
    jc, (jtl, _, _), _ = j_prepare(copy.deepcopy(raw), splits)
    jm = j_create(jc)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(
        j_init(jm, next(iter(jtl)), seed=0)))
    out = {}
    cwd = os.getcwd()
    try:
        for side in ("jax", "port"):
            d = tmp_path_factory.mktemp(side)
            os.chdir(d)
            # events.jsonl backfills the ring's earlier records: start empty
            for log in (j_events.events(), t_events.events()):
                log.clear()
            if side == "jax":
                _, _, hist, cfg, _, _ = j_run_training(copy.deepcopy(raw), splits)
                count = j_print_model(variables, verbosity=0)
            else:
                model, _, hist = run_training(copy.deepcopy(raw), datasets=splits,
                                              variables=variables, device="cpu")
                count = print_model(model, verbosity=0)
            (log_name,) = os.listdir(d / "logs")
            out[side] = (str(d / "logs" / log_name), hist, count)
    finally:
        os.chdir(cwd)
    return out


def pytest_records_validate_against_the_jax_schema(runs):
    run_dir = runs["port"][0]
    for name, validate in VALIDATORS.items():
        recs = _read(run_dir, name)
        assert recs, name
        for rec in recs:
            assert validate(rec) == [], (name, rec)


def pytest_record_kinds_and_keys_match(runs):
    def shape(run_dir):
        kinds = {}
        for rec in _read(run_dir, "metrics.jsonl"):
            kinds.setdefault(rec["kind"], set()).update(rec)
            if rec["kind"] == "run":
                kinds["run.compile"] = set(rec["compile"])
        return kinds

    want, got = shape(runs["jax"][0]), shape(runs["port"][0])
    want.pop("compile_report")  # the compile plane's record, not ported
    assert got == want


def pytest_window_census_is_exact(runs):
    keys = ("step", "steps", "buckets", "padding_waste", "padding_waste_graphs",
            "padding_waste_edges")

    def windows(run_dir):
        return [{k: r[k] for k in keys} for r in _read(run_dir, "metrics.jsonl")
                if r["kind"] == "step_window"]

    want = windows(runs["jax"][0])
    assert len(want) >= 4 and windows(runs["port"][0]) == want


def pytest_losses_scalars_and_numerics_agree(runs):
    (jdir, jhist, _), (tdir, thist, _) = runs["jax"], runs["port"]
    for k in ("train", "val", "test"):
        np.testing.assert_allclose(thist[k], jhist[k], rtol=LOSS_RTOL)

    def scalars(run_dir):
        # the JAX run's MFU mirror rides its TPU peak table; the port names
        # no peak for the CPU
        return {(r["tag"], r["step"]): r["value"] for r in _read(run_dir, "scalars.jsonl")
                if not r["tag"].startswith("telemetry/")}

    want, got = scalars(jdir), scalars(tdir)
    assert set(got) == set(want)
    for key, v in want.items():
        if not key[0].startswith("compile/"):  # the port compiles nothing
            assert got[key] == pytest.approx(v, rel=LOSS_RTOL, abs=1e-12), key

    def numerics(run_dir):
        return [r for r in _read(run_dir, "metrics.jsonl") if r["kind"] == "numerics"]

    jn, tn = numerics(jdir), numerics(tdir)
    assert len(jn) == len(tn) > 0
    for jr, tr in zip(jn, tn):
        assert jr["step"] == tr["step"]
        for section in ("activations", "gradients"):
            assert list(tr[section]) == list(jr[section])
            for name, st in jr[section].items():
                for stat in ("max_abs", "rms"):
                    assert tr[section][name][stat] == pytest.approx(
                        st[stat], rel=STATS_RTOL), (section, name, stat)
                assert tr[section][name]["nonfinite"] == st["nonfinite"]


def pytest_span_tree_events_and_parameter_count(runs):
    def tree(run_dir):
        spans = _read(run_dir, "trace.jsonl")
        names = {s["spanId"]: s["name"] for s in spans}
        return Counter((s["name"], names.get(s.get("parentSpanId"))) for s in spans)

    (jdir, _, jcount), (tdir, _, tcount) = runs["jax"], runs["port"]
    assert tree(tdir) == tree(jdir)
    assert ([e["kind"] for e in _read(tdir, "events.jsonl")]
            == [e["kind"] for e in _read(jdir, "events.jsonl")])
    assert "checkpoint_write" in [e["kind"] for e in _read(tdir, "events.jsonl")]
    assert tcount == jcount > 0
