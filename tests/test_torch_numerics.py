"""The port's numerics observatory against the JAX package's, on the CPU.

One train step of a 2-layer EGNN (hidden 24, batch 4, f32) in both
packages, on the same bridged weights and batch, with numerics on:

- every probe's raw moments (max |x|, sum of squares, element count,
  non-finite count, bf16 underflow) within 1e-5 relative, the same names
  in the same order; the same for every gradient group;
- a NaN planted in a batch after batching (``x[0, 0]``) is attributed to
  the same first tensor, ``embedding``, by both drill-downs;
- through the port's epoch loop the guard skips that step, the NaN watch
  emits ``numerics_provenance`` naming ``embedding`` and the flight
  recorder writes one dump with its files; the epoch's verdict under
  ``non_finite_policy: error`` emits ``guard_skip`` with that provenance
  and ``guard_fatal``, and dumps before it raises.

Also the port's own contract: a tap outside a collection touches nothing,
the watch's diagnostic budget, numerics on a distributed step raising,
and the FLOP count of obs/flops.py (on ``meta`` tensors) equal to the
same count on the CPU route.
"""

import copy
import json
import os
from importlib import import_module

import numpy as np
import pytest
import torch

import jax

from hydragnn_tpu.api import prepare_data as j_prepare
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.models import init_model as j_init
from hydragnn_tpu.train import TrainState as JState
from hydragnn_tpu.train import make_optimizer as j_make_optimizer
from hydragnn_tpu.train import make_train_step as j_make_train_step
from hydragnn_tpu_torch.api import prepare_data as t_prepare
from hydragnn_tpu_torch.bridge import load_jax_variables
from hydragnn_tpu_torch.data import oc20_shaped_dataset, split_dataset
from hydragnn_tpu_torch.models import create_model as t_create
from hydragnn_tpu_torch.obs import flops as t_flops
from hydragnn_tpu_torch.obs import numerics as t_numerics
from hydragnn_tpu_torch.train import TrainState, make_optimizer, make_train_step
from hydragnn_tpu_torch.train.loop import train_epoch, train_validate_test

t_events = import_module("hydragnn_tpu_torch.obs.events")
t_flightrec = import_module("hydragnn_tpu_torch.obs.flightrec")

torch.set_num_threads(2)

RTOL = 1e-5


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
                         "num_epoch": 1, "precompile": "off",
                         "Optimizer": {"type": "AdamW", "learning_rate": 1e-3}},
        },
    }


class _Case:
    def __init__(self):
        graphs = oc20_shaped_dataset(20, mean_atoms=20, min_atoms=10, max_atoms=40,
                                     max_neighbours=10)
        self.splits = split_dataset(graphs, 0.8, seed=0)
        self.raw = _config()
        self.jc, (jtl, _, _), _ = j_prepare(copy.deepcopy(self.raw), self.splits)
        self.tc, (ttl, _, _), _ = t_prepare(copy.deepcopy(self.raw), self.splits)
        self.jbatch, self.tbatch = next(iter(jtl)), next(iter(ttl))
        self.tloader = ttl
        self.jm = j_create(self.jc)
        self.v = jax.tree_util.tree_map(np.asarray, jax.device_get(
            j_init(self.jm, self.jbatch, seed=3)))
        self.tx = j_make_optimizer(self.jc["NeuralNetwork"]["Training"]["Optimizer"])
        self.jstep = j_make_train_step(self.jm, self.tx, numerics=True)

    def torch_state(self):
        model = t_create(self.tc, device="cpu")
        load_jax_variables(model, self.v)
        opt = make_optimizer(model, self.tc["NeuralNetwork"]["Training"]["Optimizer"])
        return TrainState.create(model, opt)

    def jax_state(self):
        return JState.create(jax.tree_util.tree_map(jax.numpy.asarray, self.v), self.tx)


@pytest.fixture(scope="module")
def case():
    return _Case()


def _poisoned(batch, x):
    bad = np.array(np.asarray(x), copy=True)
    bad[0, 0] = np.nan
    return bad


def pytest_probe_and_gradient_moments_match_jax(case):
    _, jtot, _, jnum = case.jstep(case.jax_state(), case.jbatch, jax.random.PRNGKey(0))
    ts = case.torch_state()
    step = make_train_step(ts.model, numerics=True)
    _, ttot, _, tnum = step(ts, case.tbatch)
    jmeta, tmeta = case.jstep._numerics_meta, step._numerics_meta
    assert tuple(tmeta["act_names"]) == tuple(jmeta["act_names"])
    assert tmeta["act_names"][:3] == ("embedding", "bn:feature_layers_0", "conv0")
    assert tuple(tmeta["grad_names"]) == tuple(jmeta["grad_names"])
    assert bool(tnum["ok"]) and bool(jnum["ok"])
    for key in ("act", "grad"):
        want = np.asarray(jnum[key], np.float64)
        got = tnum[key].double().numpy()
        assert got.shape == want.shape and got.shape[1] == len(t_numerics.STAT_FIELDS)
        np.testing.assert_array_equal(got[:, 2:], want[:, 2:])  # counts
        np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=RTOL)
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=RTOL)


def pytest_nan_drill_down_names_the_embedding_like_jax(case):
    jbad = case.jbatch.replace(x=_poisoned(case.jbatch, case.jbatch.x))
    tbad = case.tbatch.replace(x=torch.from_numpy(_poisoned(case.tbatch, case.tbatch.x)))
    jfind = case.jstep._nan_diagnose(case.jax_state(), jbad, jax.random.PRNGKey(0), 0)
    ts = case.torch_state()
    step = make_train_step(ts.model, numerics=True)
    before = [b.clone() for b in ts.model.buffers()]
    tfind = step._nan_diagnose(ts, tbad, 0)
    assert all(torch.equal(a, b) for a, b in zip(ts.model.buffers(), before))
    assert all(p.grad is None for p in ts.model.parameters())
    for f in (jfind, tfind):
        assert f["kind"] == "activation" and f["layer"] == "embedding"
        assert f["stats"]["nonfinite"] >= 1
    assert tfind["stats"]["nonfinite"] == jfind["stats"]["nonfinite"]


def pytest_poisoned_batch_through_the_epoch_loop(case, tmp_path):
    """The guard skips the poisoned step, the watch names ``embedding`` in
    a ``numerics_provenance`` event, and one flight dump holds its files."""
    ts = case.torch_state()
    step = make_train_step(ts.model, numerics=True)
    tb = case.tbatch
    bad = tb.replace(x=torch.from_numpy(_poisoned(tb, tb.x)))
    watch = t_numerics.NanWatch(diagnose=step._nan_diagnose, lag=1)
    rec = t_flightrec.FlightRecorder(str(tmp_path)).install()
    n0 = len(t_events.events().snapshot())
    try:
        ts, _, _, _ = train_epoch([tb, bad, tb, tb], step, ts, nan_watch=watch)
    finally:
        rec.uninstall()
    assert (int(ts.step), int(ts.skipped_steps)) == (4, 1)
    (skip,) = watch.take()
    assert (skip["layer"], skip["kind"], skip["batch"]) == ("embedding", "activation", 1)
    prov = [e for e in t_events.events().snapshot()[n0:]
            if e["kind"] == "numerics_provenance"]
    assert len(prov) == 1 and prov[0]["layer"] == "embedding"
    (dump,) = [d for d in os.listdir(tmp_path / "flightrec") if not d.startswith(".tmp")]
    files = set(os.listdir(tmp_path / "flightrec" / dump))
    assert {"meta.json", "events.json", "spans.json", "metrics.prom",
            "memory.json"} <= files
    meta = json.loads((tmp_path / "flightrec" / dump / "meta.json").read_text())
    assert meta["reason"] == "numerics_provenance"
    # the epoch's verdict under non_finite_policy "error": guard_skip with
    # the watch's provenance, guard_fatal, and a fatal_guard dump first
    from hydragnn_tpu_torch.train.guard import NonFinitePolicy

    rec = t_flightrec.FlightRecorder(str(tmp_path / "fatal")).install()
    n1 = len(t_events.events().snapshot())
    try:
        with pytest.raises(RuntimeError, match="non_finite_policy is 'error'"):
            NonFinitePolicy(policy="error").after_epoch(ts, 0, provenance=[skip])
    finally:
        rec.uninstall()
    new = t_events.events().snapshot()[n1:]
    kinds = [e["kind"] for e in new]
    assert kinds[:2] == ["guard_skip", "guard_fatal"] and "flightrec_dump" in kinds
    assert new[0]["layers"] == "embedding" and new[0]["batches"] == "1"
    assert any(d.endswith("fatal_guard-h0") for d in os.listdir(tmp_path / "fatal" / "flightrec"))


def pytest_watch_diagnostic_budget():
    calls = {"n": 0}

    def counting(state, batch, step):
        calls["n"] += 1
        return None

    watch = t_numerics.NanWatch(diagnose=counting, lag=1, max_diagnoses=3)
    bad = torch.zeros((), dtype=torch.bool)
    before = len([e for e in t_events.events().snapshot()
                  if e["kind"] == "numerics_provenance"])
    for i in range(10):
        watch.on_step(None, object(), i, i, {"ok": bad})
    watch.end_epoch(None)
    assert calls["n"] == 3 and watch.suppressed == 7
    skips = watch.take()
    assert len(skips) == 10 and skips[-1]["layer"] == "<diagnostic_budget_spent>"
    after = [e for e in t_events.events().snapshot()
             if e["kind"] == "numerics_provenance"][before:]
    assert len(after) == 4 and after[-1]["layer"] == "<diagnostic_budget_spent>"


def pytest_taps_off_touch_nothing(case):
    """Without a collection a tap never looks at its tensor, and the step
    keeps its three outputs."""

    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"tap touched {name}")

    t_numerics.probe("anything", Untouchable(), Untouchable())
    assert not t_numerics.collection_active()
    ts = case.torch_state()
    assert len(make_train_step(ts.model)(ts, case.tbatch)) == 3


def pytest_numerics_on_a_distributed_step_raises(case):
    ts = case.torch_state()
    cfg = copy.deepcopy(case.tc)
    cfg["Telemetry"] = {"numerics": True}
    with pytest.raises(NotImplementedError, match="distributed capture slice"):
        train_validate_test(ts.model, ts, case.tloader, case.tloader, case.tloader, cfg,
                            step_fn=make_train_step(ts.model))


def pytest_flop_count_on_meta_equals_the_cpu_route(case):
    """The count on ``meta`` copies (what the MFU uses, any route) equals
    ``FlopCounterMode`` over the same step on the CPU; it is cached per
    level."""
    from torch.utils.flop_counter import FlopCounterMode

    from hydragnn_tpu_torch.train.loss import compute_loss

    model = case.torch_state().model
    model.train()
    with FlopCounterMode(display=False) as counter:
        tot, _, _ = compute_loss(model, case.tbatch, model.cfg, False)
        tot.float().backward()
    flops_for = t_flops.train_flops_for(model)
    key = (int(case.tbatch.node_mask.numel()), int(case.tbatch.edge_mask.numel()))
    got = flops_for(key, case.tbatch)
    assert got == counter.get_total_flops() > 0
    assert flops_for(key, None) == got  # from the cache, no batch needed
