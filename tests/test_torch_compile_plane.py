"""The port's compile plane (hydragnn_tpu_torch/train/compile_plane.py) and
the compile and memory plane's config keys, on the CPU.

The CPU cannot capture a CUDA graph (the card tests in
tests/test_torch_cuda.py and chip_smoke.py's ``graphs_*`` phases do), so
here:

- config completion: the nine keys' defaults and rejected values equal the
  JAX package's (tests/test_compile_plane.py, tests/test_tune.py);
- the retrace sentinel: the same batch sequences (the ladder, a dtype flip,
  a shape outside the ladder) fed to both packages give the same known-set
  counts, the same decision (silent, warn, raise) and the same diff lines.
  The port's index tensors are int64 where the JAX package's are int32, so
  the port's lines are compared with ``int64`` read as ``int32``;
- the plane: ``blocking`` and ``background`` warm each level eagerly and
  arm the sentinel; a ``blocking`` run equals an ``off`` run bit for bit;
  the report's specializations equal the JAX plane's for the same config
  and ladder; ``train_validate_test`` writes the ``compile`` field; the
  plane does not degrade to ``off`` without a cache directory (the JAX
  package's does);
- serving: warm-up arms the sentinel at ``Serving.retrace_policy``.
"""

import json
import os
import types
import warnings

import pytest
import torch

import jax
import jax.numpy as jnp

from hydragnn_tpu.api import prepare_data as j_prepare
from hydragnn_tpu.config import update_config as j_update_config
from hydragnn_tpu.data.graph import PadSpec as JPadSpec
from hydragnn_tpu.data.graph import batch_graphs as j_batch_graphs
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.models import init_model as j_init
from hydragnn_tpu.serve.config import ServeConfig as JServeConfig
from hydragnn_tpu.train import TrainState as JState
from hydragnn_tpu.train import compile_plane as j_cp
from hydragnn_tpu.train import make_optimizer as j_make_optimizer
from hydragnn_tpu.train import make_train_step as j_make_train_step
from hydragnn_tpu.train.loop import make_eval_step as j_make_eval_step
from hydragnn_tpu_torch.api import prepare_data as t_prepare
from hydragnn_tpu_torch.config import update_config as t_update_config
from hydragnn_tpu_torch.data import (PadSpec, batch_graphs, oc20_shaped_dataset,
                                     split_dataset)
from hydragnn_tpu_torch.models import create_model as t_create
from hydragnn_tpu_torch.serve import ServeConfig
from hydragnn_tpu_torch.train import TrainState, make_optimizer, train_validate_test
from hydragnn_tpu_torch.train import compile_plane as cp
from hydragnn_tpu_torch.train.loop import make_eval_step, make_train_step

torch.set_num_threads(2)

PLANE_KEYS = ("conv_checkpointing", "remat_policy", "compile_cache_dir", "precompile",
              "retrace_policy", "autotune", "autotune_budget", "autotune_cache_dir")


@pytest.fixture(autouse=True)
def _plane_isolation():
    cp.sentinel().reset()
    j_cp.sentinel().reset()
    yield
    cp.sentinel().reset()
    j_cp.sentinel().reset()
    cp.set_cache_dir(None)


def _config(num_buckets=3, pack=False, **training):
    return {
        "Verbosity": {"level": 0},
        "Dataset": {"node_features": {"dim": [1, 3, 3]}, "graph_features": {"dim": [1]}},
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "EGNN", "equivariance": True, "radius": 5.0,
                "max_neighbours": 10, "hidden_dim": 16, "num_conv_layers": 2,
                "use_sorted_aggregation": True, "task_weights": [1.0, 10.0],
                "output_heads": {
                    "graph": {"num_sharedlayers": 1, "dim_sharedlayers": 8,
                              "num_headlayers": 2, "dim_headlayers": [8, 8]},
                    "node": {"num_headlayers": 2, "dim_headlayers": [8, 8], "type": "mlp"}}},
            "Variables_of_interest": {
                "input_node_features": [0, 1], "output_names": ["energy", "forces"],
                "output_index": [0, 2], "type": ["graph", "node"]},
            "Training": {"batch_size": 4, "loss_function_type": "mae", "pack_batches": pack,
                         "num_pad_buckets": num_buckets, "num_epoch": 2,
                         "Optimizer": {"type": "AdamW", "learning_rate": 1e-3}, **training},
        },
    }


@pytest.fixture(scope="module")
def splits():
    graphs = oc20_shaped_dataset(36, mean_atoms=16, min_atoms=6, max_atoms=32,
                                 max_neighbours=10)
    return split_dataset(graphs, 0.7, seed=0)


# -- config completion ------------------------------------------------------------

def pytest_config_completion_defaults_match_jax(splits):
    j = j_update_config(_config(), *splits)["NeuralNetwork"]["Training"]
    t = t_update_config(_config(), *splits)["NeuralNetwork"]["Training"]
    assert {k: t[k] for k in PLANE_KEYS} == {k: j[k] for k in PLANE_KEYS}
    assert {k: t[k] for k in PLANE_KEYS} == {
        "conv_checkpointing": False, "remat_policy": "full", "compile_cache_dir": None,
        "precompile": "background", "retrace_policy": "warn", "autotune": "cached",
        "autotune_budget": 32, "autotune_cache_dir": None}
    assert ServeConfig().retrace_policy == JServeConfig().retrace_policy == "error"


@pytest.mark.parametrize("key,val", [
    ("precompile", "sometimes"), ("retrace_policy", "ignore"), ("remat_policy", "everything"),
    ("autotune", "aggressive"), ("autotune_budget", -1),
])
def pytest_config_completion_rejects_bad_values_as_jax(splits, key, val):
    for update in (j_update_config, t_update_config):
        with pytest.raises(ValueError, match=key):
            update(_config(**{key: val}), *splits)


def pytest_serving_retrace_policy_rejects_bad_values_as_jax(splits):
    for cls in (JServeConfig, ServeConfig):
        with pytest.raises(ValueError, match="retrace_policy"):
            cls(retrace_policy="ignore")
    cfg = _config()
    cfg["Serving"] = {"retrace_policy": "ignore"}
    with pytest.raises(ValueError, match="retrace_policy"):
        t_update_config(cfg, *splits)


def pytest_setup_compile_cache_resolution(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("HYDRAGNN_COMPILE_CACHE", raising=False)
    got = cp.setup_compile_cache({}, "runA")
    assert got == os.path.abspath(os.path.join("logs", "runA", "xla_cache"))
    # resolved and reported, not created: a CUDA graph outlives no process
    assert not os.path.exists(got) and cp.cache_dir_active() == got
    assert cp.setup_compile_cache({"compile_cache_dir": str(tmp_path / "cc")},
                                  "runA") == str(tmp_path / "cc")
    assert cp.setup_compile_cache({"compile_cache_dir": False}, "runA") is None
    monkeypatch.setenv("HYDRAGNN_COMPILE_CACHE", str(tmp_path / "env_cc"))
    assert cp.setup_compile_cache({"compile_cache_dir": False}, "runA") == str(
        tmp_path / "env_cc")
    monkeypatch.setenv("HYDRAGNN_COMPILE_CACHE", "off")
    assert cp.setup_compile_cache({"compile_cache_dir": str(tmp_path / "cc")}, "runA") is None
    assert cp.cache_dir_active() is None
    monkeypatch.setenv("HYDRAGNN_COMPILE_CACHE", "1")
    assert cp.setup_compile_cache({"compile_cache_dir": False}, "runA") == os.path.abspath(
        os.path.join("logs", "runA", "xla_cache"))
    monkeypatch.delenv("HYDRAGNN_COMPILE_CACHE")
    assert cp.setup_compile_cache({"compile_cache_dir": False}, "runA") is None


# -- the sentinel against the JAX package's -----------------------------------------

def _ladder_batches(splits):
    """The ladder's template batches in both packages, a dtype flip of the
    first, and a batch padded outside the ladder."""
    cfg, (tl, _, _), _ = t_prepare(_config(), splits)
    port = [b for _, b in tl.spec_template_batches()]
    jax_b = [j_batch_graphs([g], JPadSpec(s.n_nodes, s.n_edges, s.n_graphs),
                            sort_edges=True)
             for (s, _), g in zip(tl.spec_template_batches(),
                                  [_fitting(tl, s) for s, _ in tl.spec_template_batches()])]
    spec = tl.ladder.specs[-1]
    g = splits[0][0]
    # more nodes than the top level, its edges and graphs: the top level is
    # the one nearest specialization
    off = PadSpec(spec.n_nodes + 8, spec.n_edges, spec.n_graphs)
    seq = {
        "ladder": (port, jax_b),
        "dtype_flip": ([port[0].replace(x=port[0].x.to(torch.bfloat16))],
                       [jax_b[0].replace(x=jax_b[0].x.astype(jnp.bfloat16))]),
        "new_shape": ([batch_graphs([g], off, sort_edges=True)],
                      [j_batch_graphs([g], JPadSpec(off.n_nodes, off.n_edges, off.n_graphs),
                                      sort_edges=True)]),
    }
    return seq


def _fitting(loader, spec):
    from hydragnn_tpu_torch.data.pipeline import selectable_levels

    for li, g in selectable_levels(loader.graphs, loader.ladder):
        if loader.ladder.specs[li] == spec:
            return g
    raise AssertionError(spec)


def _port_plane():
    """A plane in mode off over a trivial step: its wrap notes each new
    batch signature (the port's trace)."""
    plane = cp.CompilePlane(mode="off")
    state = types.SimpleNamespace(model=torch.nn.Linear(1, 1))
    step, _ = plane.launch(lambda s, b: b.x.float().sum(), lambda s, b: None, state, None)
    return plane, lambda b: step(state, b)


def _jax_step():
    return jax.jit(lambda b: (j_cp.note_trace("train_step", b), b.x.astype(jnp.float32).sum())[1])


def _decide(run, batch):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        try:
            run(batch)
        except (cp.RetraceError, j_cp.RetraceError) as e:
            return "raise", str(e)
    msgs = [str(x.message) for x in w if "retrace sentinel" in str(x.message)]
    return ("warn", msgs[0]) if msgs else ("silent", "")


def _diff_lines(msg: str, port: bool):
    lines = [ln for ln in msg.splitlines() if ln.startswith("  ") or "differing leaves" in ln]
    return [ln.replace("int64", "int32") for ln in lines] if port else lines


@pytest.mark.parametrize("policy", ["warn", "error"])
@pytest.mark.parametrize("which", ["ladder", "dtype_flip", "new_shape"])
def pytest_sentinel_matches_jax(splits, which, policy):
    seq = _ladder_batches(splits)
    _, port_step = _port_plane()
    jax_step = _jax_step()
    for b in seq["ladder"][0]:
        assert _decide(port_step, b)[0] == "silent"
    for b in seq["ladder"][1]:
        assert _decide(jax_step, b)[0] == "silent"
    assert cp.sentinel().counts() == j_cp.sentinel().counts() == {
        "train_step": len(seq["ladder"][0])}
    cp.sentinel().arm(policy)
    j_cp.sentinel().arm(policy)
    (pb,), (jb,) = ([seq[which][0][0]], [seq[which][1][0]])
    pdec, pmsg = _decide(port_step, pb)
    jdec, jmsg = _decide(jax_step, jb)
    want = "silent" if which == "ladder" else ("raise" if policy == "error" else "warn")
    assert pdec == jdec == want
    assert _diff_lines(pmsg, True) == _diff_lines(jmsg, False)
    if want != "silent":
        assert len(cp.sentinel().violations()) == len(j_cp.sentinel().violations()) == 1


# -- the plane on the CPU ---------------------------------------------------------

def _setup(splits, **training):
    cfg, loaders, _ = t_prepare(_config(**training), splits)
    model = t_create(cfg, device="cpu", seed=1)
    opt = make_optimizer(model, cfg["NeuralNetwork"]["Training"]["Optimizer"])
    return cfg, model, TrainState.create(model, opt), loaders


def _snapshot(state):
    return [t.clone() for t in state.held] + [state.step.clone(),
                                              state.skipped_steps.clone()]


@pytest.mark.parametrize("mode", ["blocking", "background"])
def pytest_plane_warms_every_level_and_arms(splits, mode):
    cfg, model, state, (tl, vl, tel) = _setup(splits)
    n_train = len(tl.spec_template_batches())
    plane = cp.CompilePlane(mode=mode, retrace_policy="error")
    step, ev = plane.launch(make_train_step(model), make_eval_step(model), state, tl, vl, tel)
    n_eval = len(plane.jobs) - n_train
    assert n_train > 1 and n_eval >= 1
    if mode == "blocking":
        assert cp.sentinel().armed
    else:
        assert not cp.sentinel().armed
        for kind, label, sig, tmpl in plane.jobs:  # the first visit of each level
            (step if kind == "train_step" else ev)(state, tmpl)
        assert cp.sentinel().armed
    assert cp.sentinel().counts() == {"train_step": n_train, "eval_step": n_eval}
    rep = plane.finish()
    assert rep["precompiled"] == rep["specializations"] == n_train + n_eval
    assert rep["graphs"] == {} and "no CUDA device" in rep["graphs_note"]
    assert rep["violations"] == 0 and not cp.sentinel().armed


def pytest_plane_does_not_degrade_without_a_cache_dir(splits):
    """The JAX plane runs ``off`` without a persistent cache (its warm-up
    could not be reached); the port's has nothing to persist and runs."""
    cp.set_cache_dir(None)
    cfg, model, state, (tl, vl, tel) = _setup(splits)
    plane = cp.CompilePlane(mode="background", retrace_policy="error")
    plane.launch(make_train_step(model), make_eval_step(model), state, tl, vl, tel)
    rep = plane.finish()
    assert rep["mode"] == "background" and rep["cache_dir"] is None
    assert rep["specializations"] > 0


def pytest_blocking_run_equals_off_bit_for_bit(splits):
    snaps, hists = {}, {}
    for mode in ("off", "blocking"):
        cfg, model, state, loaders = _setup(splits, precompile=mode)
        rng0 = torch.get_rng_state()
        state, hists[mode] = train_validate_test(model, state, *loaders, cfg)
        snaps[mode] = _snapshot(state)
        assert torch.equal(torch.get_rng_state(), rng0)
    assert len(snaps["off"]) == len(snaps["blocking"])
    for a, b in zip(snaps["off"], snaps["blocking"]):
        assert torch.equal(a, b)
    assert hists["off"] == hists["blocking"]


def pytest_specializations_equal_the_jax_planes(splits):
    cfg, model, state, (tl, vl, tel) = _setup(splits)
    plane = cp.CompilePlane(mode="blocking")
    plane.launch(make_train_step(model), make_eval_step(model), state, tl, vl, tel)
    rep = plane.finish()
    jc, (jtl, jvl, jtel), _ = j_prepare(_config(), splits)
    jm = j_create(jc)
    tx = j_make_optimizer(jc["NeuralNetwork"]["Training"]["Optimizer"])
    jstate = JState.create(j_init(jm, next(iter(jtl)), seed=0), tx)
    jplane = j_cp.CompilePlane(mode="blocking")
    jplane._collect_jobs(j_make_train_step(jm, tx), j_make_eval_step(jm), jstate, jtl, jvl, jtel,
                         jax.random.PRNGKey(0))
    assert rep["specializations"] == len(jplane.jobs)
    assert [label for _, label, _, _ in plane.jobs] == [label for label, _ in jplane.jobs]


def pytest_train_validate_test_writes_the_compile_field(splits, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cfg, model, state, loaders = _setup(splits, precompile="blocking", retrace_policy="error")
    cfg["Telemetry"] = {"enabled": True, "interval_steps": 2}
    train_validate_test(model, state, *loaders, cfg, log_name="plane", verbosity=1)
    err = capsys.readouterr().err
    assert "compile plane: mode=blocking" in err and "violations=0" in err
    runs = [json.loads(line) for line in open(tmp_path / "logs" / "plane" / "metrics.jsonl")
            if '"kind": "run"' in line]
    (run,) = runs
    n = len(loaders[0].spec_template_batches())
    assert set(run["compile"]) == {"precompiled", "specializations", "cache_hits",
                                   "cache_misses", "violations", "time_to_first_step"}
    assert run["compile"]["specializations"] == run["compile"]["precompiled"] > n
    assert run["compile"]["violations"] == 0 and run["compile"]["time_to_first_step"] > 0
    assert not cp.sentinel().armed  # finish() disarmed


@pytest.mark.parametrize("policy", ["warn", "error"])
def pytest_off_ladder_batch_after_arming(splits, policy):
    from hydragnn_tpu_torch.obs.events import EV_RETRACE_VIOLATION, events
    from hydragnn_tpu_torch.obs.registry import registry

    cfg, model, state, (tl, vl, tel) = _setup(splits)
    plane = cp.CompilePlane(mode="blocking", retrace_policy=policy)
    step, _ = plane.launch(make_train_step(model), make_eval_step(model), state, tl, vl, tel)
    spec = tl.ladder.specs[-1]
    off = batch_graphs([splits[0][0]], PadSpec(spec.n_nodes + 8, spec.n_edges + 128,
                                               spec.n_graphs), sort_edges=True)
    events().clear()
    counter = registry().counter("hydragnn_retrace_violations_total")
    before = counter.value()
    if policy == "error":
        with pytest.raises(cp.RetraceError, match="outside the warmed ladder"):
            step(state, off)
    else:
        with pytest.warns(RuntimeWarning, match="retrace sentinel") as rec:
            _, tot, _ = step(state, off)
        assert len([w for w in rec if "retrace sentinel" in str(w.message)]) == 1
        assert torch.isfinite(tot)
    assert len([e for e in events().snapshot() if e["kind"] == EV_RETRACE_VIOLATION]) == 1
    assert counter.value() == before + 1
    assert plane.finish()["violations"] == 1


def pytest_kernel_wrappers_count_captures_apart():
    counts = cp.captured_counts()
    assert set(counts) == {"sorted_segment_sum", "fused_edge_message_sum", "fused_multi_agg",
                           "flash_self_attention", "flash_block_summary", "numerics_stats"}
    assert all(v == {} for v in counts.values())


# -- serving ------------------------------------------------------------------------

def pytest_server_warmup_arms_the_sentinel_at_error(splits):
    from hydragnn_tpu_torch.api import run_server

    cfg = _config()
    cfg["Serving"] = {"batch_window_s": 0.01}
    with pytest.warns(UserWarning, match="no checkpoint"):
        server = run_server(cfg, datasets=splits, device="cpu")
    try:
        assert server.wait_ready(60)
        assert cp.sentinel().armed
        n = len(server.warmup_compiled)
        assert n == len(server.ladder.specs) and cp.sentinel().counts() == {
            "serve_predict": n}
        spec = server.ladder.specs[-1]
        off = batch_graphs([splits[2][0]], PadSpec(spec.n_nodes + 8, spec.n_edges + 128,
                                                   spec.n_graphs), sort_edges=True)
        off = off.replace(graph_targets={}, node_targets={})
        with pytest.raises(cp.RetraceError):
            server.forward(off)
        out = server.predict(splits[2][:2])
        assert len(out) == 2
    finally:
        server.close()
    assert not cp.sentinel().armed
