"""The port's kernel autotuning plane (hydragnn_tpu_torch/tune) on the CPU.

Mirrors the JAX package's tests/test_tune.py on the port's own plans (the
CUDA kernels' launch constants, tune/plans.py):

- invalidation lives entirely in the content-addressed key (kernel version,
  device kind, dtype, shape);
- a corrupt, hand-edited or schema-drifted entry degrades to the defaults
  with a warning naming the repair CLI, never an exception;
- concurrent writers race safely through the atomic publish;
- the defaults are today's launch constants, so a missing entry reproduces
  today's launches; each wrapper hands its plan to its C entry point;
- the sweep publishes winners and its second run is a 100% cache hit; on
  the CPU the wrappers run their plain versions, so it exercises the
  bookkeeping, not the timings.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

from hydragnn_tpu_torch.ops import _build
from hydragnn_tpu_torch.tune import plans, runtime
from hydragnn_tpu_torch.tune.runtime import deactivate, install, setup_autotune, tile_plan
from hydragnn_tpu_torch.tune.sweep import config_slots, sweep_kernel
from hydragnn_tpu_torch.tune.table import (
    TABLE_SCHEMA_VERSION,
    TunedTable,
    device_kind,
    entry_key,
    resolve_tune_cache,
)

SHAPE = {"edges": 64, "channels": 8, "num_segments": 16}
V = "0123456789abcdef"
PLAN = {"narrow_edges": 256, "max_rows": 64, "wide_iters": 2}


@pytest.fixture(autouse=True)
def _no_table_leak():
    deactivate()
    yield
    deactivate()


# -- content-addressed keys ---------------------------------------------------

def pytest_entry_key_changes_on_every_axis():
    base = entry_key("segment_sum", V, "NVIDIA H100 80GB HBM3", "float32", SHAPE)
    assert base == entry_key("segment_sum", V, "NVIDIA H100 80GB HBM3", "float32", dict(SHAPE))
    bumped = {
        "version": entry_key("segment_sum", "fedcba9876543210", "NVIDIA H100 80GB HBM3",
                             "float32", SHAPE),
        "device": entry_key("segment_sum", V, "NVIDIA A100", "float32", SHAPE),
        "dtype": entry_key("segment_sum", V, "NVIDIA H100 80GB HBM3", "bfloat16", SHAPE),
        "shape": entry_key("segment_sum", V, "NVIDIA H100 80GB HBM3", "float32",
                           {**SHAPE, "edges": 128}),
        "kernel": entry_key("multi_agg", V, "NVIDIA H100 80GB HBM3", "float32", SHAPE),
    }
    assert len({base, *bumped.values()}) == 6, bumped


def pytest_store_then_lookup_roundtrips_through_disk(tmp_path):
    t = TunedTable(str(tmp_path))
    path = t.store("segment_sum", V, "cpu", "float32", SHAPE, PLAN, measured_us=12.5,
                   meta={"candidates": 3})
    assert os.path.isfile(path) and not any(".tmp" in f for f in os.listdir(tmp_path))
    assert TunedTable(str(tmp_path)).lookup("segment_sum", V, "cpu", "float32", SHAPE) == PLAN
    assert t.size() == 1


def pytest_stale_entries_never_match(tmp_path):
    t = TunedTable(str(tmp_path))
    t.store("segment_sum", V, "cpu", "float32", SHAPE, PLAN)
    assert t.lookup("segment_sum", "fedcba9876543210", "cpu", "float32", SHAPE) is None
    assert t.lookup("segment_sum", V, "NVIDIA H100 80GB HBM3", "float32", SHAPE) is None
    assert t.lookup("segment_sum", V, "cpu", "bfloat16", SHAPE) is None
    assert t.lookup("segment_sum", V, "cpu", "float32", {**SHAPE, "channels": 16}) is None
    assert t.lookup("segment_sum", V, "cpu", "float32", SHAPE) == PLAN


def pytest_kernel_version_is_the_source_digest(tmp_path, monkeypatch):
    """An edited kernel source changes its KERNEL_VERSION: its old tuned
    entries never match again."""
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(plans, "_VERSIONS", {})
    before = {k: plans.kernel_version(k) for k in plans.KERNELS}
    assert len(set(before.values())) == len(before)
    (src / "multi_agg.cu").write_text((src / "multi_agg.cu").read_text() + "\n// edited\n")
    monkeypatch.setattr(plans, "_VERSIONS", {})
    after = {k: plans.kernel_version(k) for k in plans.KERNELS}
    assert after["multi_agg"] != before["multi_agg"]
    assert {k: v for k, v in after.items() if k != "multi_agg"} == {
        k: v for k, v in before.items() if k != "multi_agg"}


# -- degradation: corrupt entries read as absent, never raise -------------------

def pytest_corrupt_json_degrades_to_defaults_with_warning(tmp_path):
    t = TunedTable(str(tmp_path))
    key = entry_key("segment_sum", V, "cpu", "float32", SHAPE)
    (tmp_path / f"{key}.json").write_text("{ torn mid-write")
    with pytest.warns(RuntimeWarning, match="python -m hydragnn_tpu_torch.tune"):
        assert t.lookup("segment_sum", V, "cpu", "float32", SHAPE) is None
    assert t.lookup("segment_sum", V, "cpu", "float32", SHAPE) is None  # memoized miss


def pytest_hand_edited_entry_fails_self_validation(tmp_path):
    path = TunedTable(str(tmp_path)).store("segment_sum", V, "cpu", "float32", SHAPE, PLAN)
    entry = json.loads(open(path).read())
    entry["key_fields"]["dtype"] = "bfloat16"
    with open(path, "w") as fh:
        json.dump(entry, fh)
    with pytest.warns(RuntimeWarning, match="failed validation"):
        assert TunedTable(str(tmp_path)).lookup("segment_sum", V, "cpu", "float32",
                                                SHAPE) is None


def pytest_schema_version_mismatch_reads_as_absent(tmp_path):
    path = TunedTable(str(tmp_path)).store("segment_sum", V, "cpu", "float32", SHAPE, PLAN)
    entry = json.loads(open(path).read())
    entry["schema"] = TABLE_SCHEMA_VERSION + 1
    with open(path, "w") as fh:
        json.dump(entry, fh)
    with pytest.warns(RuntimeWarning):
        assert TunedTable(str(tmp_path)).lookup("segment_sum", V, "cpu", "float32",
                                                SHAPE) is None


def pytest_concurrent_writers_race_safely(tmp_path):
    written = [{"narrow_edges": 256, "max_rows": 32 * (i + 1), "wide_iters": 4}
               for i in range(8)]
    errs = []

    def _write(plan):
        try:
            TunedTable(str(tmp_path)).store("segment_sum", V, "cpu", "float32", SHAPE, plan)
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errs.append(e)

    threads = [threading.Thread(target=_write, args=(p,), daemon=True) for p in written]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not errs
    assert TunedTable(str(tmp_path)).lookup("segment_sum", V, "cpu", "float32",
                                            SHAPE) in written
    assert not any(".tmp" in f for f in os.listdir(tmp_path))


def pytest_resolve_tune_cache_grammar(monkeypatch):
    monkeypatch.delenv("HYDRAGNN_TUNE_CACHE", raising=False)
    assert resolve_tune_cache({}, "runA") == os.path.join("./logs", "runA", "tuned_table")
    assert resolve_tune_cache({"autotune_cache_dir": "/x/table"}) == "/x/table"
    assert resolve_tune_cache({"autotune_cache_dir": False}) is None
    assert resolve_tune_cache({"autotune_cache_dir": "off"}) is None
    monkeypatch.setenv("HYDRAGNN_TUNE_CACHE", "0")
    assert resolve_tune_cache({"autotune_cache_dir": "/x/table"}) is None
    monkeypatch.setenv("HYDRAGNN_TUNE_CACHE", "/env/table")
    assert resolve_tune_cache({"autotune_cache_dir": "/x/table"}) == "/env/table"
    monkeypatch.setenv("HYDRAGNN_TUNE_CACHE", "1")
    assert resolve_tune_cache({"autotune_cache_dir": False}, "runB") == \
        os.path.join("./logs", "runB", "tuned_table")


# -- the defaults are today's launches ----------------------------------------

def _old_k1_rows(c):  # csrc/sorted_segment_sum.cu before the plan: kMaxRows, kWideIters
    tx = 2
    while tx < 32 and 2 * tx < c:
        tx *= 2
    return min(128, (256 // tx) * 4)


@pytest.mark.parametrize("c,dtype", [(3, "float32"), (4, "float32"), (8, "bfloat16"),
                                     (16, "float32"), (126, "float32"), (866, "bfloat16")])
def pytest_segment_default_plan_is_todays_launch(c, dtype):
    plan = tile_plan("segment_sum", {"edges": 36096, "channels": c, "num_segments": 2320},
                     dtype)
    itemsize = 4 if dtype == "float32" else 2
    if c * itemsize <= 16:  # the narrow launch: 256 edges a block
        assert plan["narrow_edges"] == 256
    else:
        tx = 2
        while tx < 32 and 2 * tx < c:
            tx *= 2
        rows = min(plan["max_rows"], (256 // tx) * plan["wide_iters"])
        assert rows == _old_k1_rows(c)


@pytest.mark.parametrize("e,n", [(36096, 2320), (384, 200), (18432, 1024), (1, 1), (64, 3)])
def pytest_fused_edge_default_plan_is_todays_rule(e, n):
    mean_degree = max(e, 1) / max(n, 1)
    old = int(min(max(round(512 / mean_degree), 1), 32))  # ops/fused_edge.py before the plan
    assert tile_plan("fused_edge", {"edges": e, "ci": 866, "co": 866,
                                    "num_segments": n}, "bfloat16") == {"rows_per_block": old}


@pytest.mark.parametrize("d,dtype,bk", [(4, "float32", 64), (32, "float32", 64),
                                        (32, "bfloat16", 64), (64, "float32", 32),
                                        (128, "bfloat16", 32), (128, "float32", 16)])
def pytest_flash_default_plan_is_the_instance_block(d, dtype, bk):
    shapes = {"nodes": 64, "keys": 64, "heads": 8, "head_dim": d, "summary": False}
    assert tile_plan("flash_attention", shapes, dtype) == {"block_k": bk}
    # d = 32 also has the instance of half the keys; other widths only their own
    half = plans.normalize("flash_attention", {"block_k": bk // 2}, {**shapes, "dtype": dtype})
    assert half == {"block_k": bk // 2 if d == 32 else bk}


def pytest_multi_agg_default_plan_and_normalization():
    shapes = {"edges": 18432, "channels": 256, "num_segments": 1024, "has_recv": True,
              "has_gate": False}
    assert tile_plan("multi_agg", shapes, "float32") == {"chunk_edges": 256, "col_threads": 32}
    assert plans.normalize("multi_agg", {"chunk_edges": 1000, "col_threads": 12}, shapes) == \
        {"chunk_edges": 512, "col_threads": 8}


def pytest_candidates_are_deduplicated_launches():
    """Plans that make the same launch are one candidate: a narrow K1 slot
    sweeps only its three block sizes, the defaults first."""
    narrow = plans.candidates("segment_sum", {"channels": 3, "dtype": "float32"})
    assert [p["narrow_edges"] for p in narrow] == [256, 128, 512]
    wide = plans.candidates("segment_sum", {"channels": 866, "dtype": "bfloat16"})
    rows = [p["max_rows"] for p in wide]
    assert len(rows) == len(set(rows)) and rows[0] == 32
    assert len(plans.candidates("segment_sum", {"channels": 866, "dtype": "bfloat16"},
                                budget=2)) == 2


# -- the wrappers hand their plan to the C entry points ------------------------

class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.fixture
def fake_launch(monkeypatch):
    """Every wrapper's ``_launch`` on CPU tensors with a recording library:
    the arguments its C entry point would get."""
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name, sig=None: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    from hydragnn_tpu_torch.ops import (flash_attention, fused_edge, multi_agg,
                                        sorted_segment)
    for m in (flash_attention, fused_edge, multi_agg, sorted_segment):
        monkeypatch.setattr(m, "_check_current_device", lambda device: None)
    monkeypatch.setattr(multi_agg, "_zeroed_counters",
                        lambda dev, n: torch.zeros(max(n, 1), dtype=torch.int32))
    return lib


def _ids(e, n):
    return torch.as_tensor(np.minimum(np.arange(e) * n // e, n - 1))


@pytest.mark.parametrize("tuned", [False, True])
def pytest_wrappers_pass_their_plan_to_the_kernel(fake_launch, tmp_path, tuned):
    from hydragnn_tpu_torch.ops import flash_attention, fused_edge, multi_agg, sorted_segment

    e, n, c = 256, 40, 16
    shapes = {
        "segment_sum": {"edges": e, "channels": c, "num_segments": n},
        "fused_edge": {"edges": e, "ci": c, "co": c, "num_segments": n},
        "multi_agg": {"edges": e, "channels": c, "num_segments": n, "has_recv": True,
                      "has_gate": False},
        "flash_attention": {"nodes": n, "keys": n, "heads": 2, "head_dim": 32,
                            "summary": False, "graphs": 4},
    }
    want = {k: plans.default_plan(k, {**s, "dtype": "float32"}) for k, s in shapes.items()}
    if tuned:
        t = TunedTable(str(tmp_path))
        tuned_plans = {"segment_sum": {"narrow_edges": 256, "max_rows": 64, "wide_iters": 2},
                       "fused_edge": {"rows_per_block": 3},
                       "multi_agg": {"chunk_edges": 512, "col_threads": 8},
                       "flash_attention": {"block_k": 32}}
        for k, p in tuned_plans.items():
            t.store(k, plans.kernel_version(k), device_kind(), "float32",
                    runtime._shape_key(shapes[k]), p)
        install(t, "cached")
        want = {k: plans.normalize(k, p, {**shapes[k], "dtype": "float32"})
                for k, p in tuned_plans.items()}
    x = torch.ones(e, c)
    sorted_segment._launch(x, _ids(e, n), n)
    fused_edge._launch(torch.ones(n, c), x, torch.ones(c, c), torch.ones(c), _ids(e, n), n)
    multi_agg._launch(torch.ones(n, c), x, None, _ids(e, n), n)
    q = torch.ones(n, 2, 32)
    flash_attention._launch_attention(q, q, q, _ids(n, 4), torch.ones(n, dtype=torch.bool), 4)
    calls = dict(fake_launch.calls)
    seg = calls["hg_sorted_segment_sum"]
    assert seg[-4:-1] == tuple(want["segment_sum"][k]
                               for k in ("narrow_edges", "max_rows", "wide_iters"))
    assert calls["hg_fused_edge_message_sum"][-3] == want["fused_edge"]["rows_per_block"]
    assert calls["hg_multi_agg"][-3:-1] == (want["multi_agg"]["chunk_edges"],
                                            want["multi_agg"]["col_threads"])
    assert calls["hg_flash_attention"][-2] == want["flash_attention"]["block_k"]


# -- runtime: tile_plan routing, normalization, events -------------------------

def pytest_tile_plan_consults_installed_table_and_normalizes(tmp_path):
    t = TunedTable(str(tmp_path))
    wide = {"edges": 4096, "channels": 866, "num_segments": 512}
    # an over-asking plan comes back as the launch the kernel makes: 8 row
    # threads (TX = 32) x 8 iterations = 64 rows, not 500
    t.store("segment_sum", plans.kernel_version("segment_sum"), device_kind(), "float32",
            wide, {"narrow_edges": 512, "max_rows": 500, "wide_iters": 8})
    install(t, "cached")
    assert tile_plan("segment_sum", wide, "float32") == {
        "narrow_edges": 256, "max_rows": 64, "wide_iters": 8}
    deactivate()
    assert tile_plan("segment_sum", wide, "float32")["max_rows"] == 32


def pytest_tile_plan_emits_choice_event_once_per_key(tmp_path):
    from hydragnn_tpu_torch.obs.events import events

    events().clear()
    install(TunedTable(str(tmp_path)), "cached")
    for _ in range(3):
        tile_plan("segment_sum", SHAPE, "float32")
    evs = [e for e in events().snapshot() if e["kind"] == "tile_plan"]
    assert len(evs) == 1, evs
    ev = evs[0]
    assert ev["source"] == "default" and ev["mode"] == "cached"
    assert ev["kernel"] == "segment_sum" and ev["device"] == device_kind() == "cpu"
    assert json.loads(ev["plan"])["max_rows"] == 128
    assert json.loads(ev["shape"])["edges"] == 64


def pytest_forced_plan_overrides_the_table(tmp_path):
    wide = {"edges": 4096, "channels": 866, "num_segments": 512}
    with runtime.forced("segment_sum", {"max_rows": 16, "wide_iters": 2}):
        assert tile_plan("segment_sum", wide, "float32")["max_rows"] == 16
    assert tile_plan("segment_sum", wide, "float32")["max_rows"] == 32


# -- sweep ----------------------------------------------------------------------

@pytest.mark.parametrize("kernel,shapes", [
    ("segment_sum", SHAPE),
    ("fused_edge", {"edges": 64, "ci": 8, "co": 8, "num_segments": 16}),
    ("multi_agg", {"edges": 64, "channels": 8, "num_segments": 16, "has_recv": True,
                   "has_gate": False}),
    ("flash_attention", {"nodes": 32, "keys": 32, "heads": 2, "head_dim": 32,
                         "summary": False, "graphs": 4}),
])
def pytest_sweep_kernel_publishes_winner_then_hits_cache(tmp_path, kernel, shapes):
    res = sweep_kernel(kernel, shapes, "float32", TunedTable(str(tmp_path)), budget=2, trials=1)
    assert res["cached"] is False and res["candidates"] >= 1
    assert set(res["plan"]) == set(plans.KERNELS[kernel].params)
    res2 = sweep_kernel(kernel, shapes, "float32", TunedTable(str(tmp_path)), budget=2,
                        trials=1)
    assert res2["cached"] is True and res2["plan"] == res["plan"]


@pytest.mark.parametrize("offset,dropped", [(1e-3, 2), (1e-6, 0)])
def pytest_sweep_publishes_only_plans_that_agree_with_the_defaults(tmp_path, monkeypatch,
                                                                   offset, dropped):
    """Every non-default K1 plan here times faster and computes the
    default's output times (1 + ``offset``): beyond the f32 agreement
    tolerance it is dropped with a warning and the defaults win; within it
    a faster plan wins."""
    from hydragnn_tpu_torch.tune import sweep

    kernel, shapes = "segment_sum", {**SHAPE, "dtype": "float32"}
    default = plans.default_plan(kernel, shapes)

    def is_default():
        return plans.normalize(kernel, runtime._forced[kernel], shapes) == default

    monkeypatch.setattr(sweep, "build_call", lambda *a, **k: lambda: (
        torch.ones(4), torch.full((3,), 2.0) * (1.0 if is_default() else 1.0 + offset)))
    monkeypatch.setattr(sweep, "measure", lambda call, **k: 1.0 if is_default() else 0.5)
    if dropped:
        with pytest.warns(RuntimeWarning, match="part from the default"):
            res = sweep_kernel(kernel, SHAPE, "float32", TunedTable(str(tmp_path)), budget=3,
                               trials=1)
        assert res["plan"] == default
    else:
        res = sweep_kernel(kernel, SHAPE, "float32", TunedTable(str(tmp_path)), budget=3,
                           trials=1)
        assert res["plan"] != default
    assert res["dropped"] == dropped and res["candidates"] == 3 - dropped


def pytest_agreement_fails_on_nan_and_shape():
    from hydragnn_tpu_torch.tune.sweep import agrees

    x = torch.arange(4.0)
    assert agrees((x, x), (x, x.clone()), "float32")
    assert not agrees(torch.full((4,), float("nan")), x, "float32")
    assert not agrees(x[:3], x, "float32")
    assert agrees(x.to(torch.bfloat16), x + 0.05, "bfloat16")


# -- config plumbing -------------------------------------------------------------

def _ladder(*levels):
    return types.SimpleNamespace(specs=[
        types.SimpleNamespace(n_nodes=n, n_edges=e, n_graphs=3, n_triplets=0)
        for n, e in levels])


def _full_config(tmp_path, mpnn="EGNN", **arch):
    return {"NeuralNetwork": {
        "Architecture": {"hidden_dim": 16, "max_in_degree": 8, "max_nodes_per_graph": 12,
                         "global_attn_heads": 2, "mpnn_type": mpnn, "equivariance": True,
                         "use_sorted_aggregation": True, "use_fused_edge_kernel": True,
                         "use_flash_attention": True, **arch},
        "Training": {"autotune": "cached", "autotune_budget": 2,
                     "autotune_cache_dir": str(tmp_path / "table")}}}


def pytest_config_slots_cover_every_kernel(tmp_path):
    egnn = config_slots(_full_config(tmp_path), _ladder((32, 64), (64, 128)))
    kernels = [k for k, _, _ in egnn]
    # K1 at the hidden width and at the coordinate update's 3, K2, K4
    assert kernels.count("segment_sum") == 4 and kernels.count("fused_edge") == 2
    assert kernels.count("flash_attention") == 2 and "multi_agg" not in kernels
    assert {s["channels"] for k, s, _ in egnn if k == "segment_sum"} == {16, 3}
    pna = config_slots(_full_config(tmp_path, "PNA", equivariance=False,
                                    use_fused_edge_kernel=False), _ladder((32, 64)))
    assert sorted(k for k, _, _ in pna) == ["flash_attention", "multi_agg", "segment_sum"]
    assert all(d == "float32" for _, _, d in egnn + pna)


def pytest_setup_autotune_modes(tmp_path, monkeypatch):
    monkeypatch.delenv("HYDRAGNN_TUNE_CACHE", raising=False)
    cfg = _full_config(tmp_path)
    assert setup_autotune(cfg, None, "runT") == str(tmp_path / "table")
    assert runtime.active() is not None and runtime.mode() == "cached"
    cfg["NeuralNetwork"]["Training"]["autotune"] = "off"
    assert setup_autotune(cfg, None, "runT") is None
    assert runtime.active() is None and runtime.mode() == "off"


def pytest_setup_autotune_sweep_fills_table(tmp_path, monkeypatch):
    monkeypatch.delenv("HYDRAGNN_TUNE_CACHE", raising=False)
    cfg = _full_config(tmp_path, equivariance=False, use_fused_edge_kernel=False,
                       use_flash_attention=False)
    cfg["NeuralNetwork"]["Training"]["autotune"] = "sweep"
    setup_autotune(cfg, types.SimpleNamespace(ladder=_ladder((16, 32))), "runS")
    table = runtime.active()
    assert table is not None and runtime.mode() == "sweep"
    assert table.size() == 1  # one kernel x one ladder level
    assert tile_plan("segment_sum", {"edges": 32, "channels": 16, "num_segments": 16},
                     "float32") == table.lookup(
        "segment_sum", plans.kernel_version("segment_sum"), "cpu", "float32",
        {"edges": 32, "channels": 16, "num_segments": 16})


def pytest_cli_sweeps_a_config_ladder_then_hits_every_lookup(tmp_path, monkeypatch):
    """``python -m hydragnn_tpu_torch.tune`` over a config's whole ladder;
    the second run sweeps nothing."""
    from hydragnn_tpu_torch.tune.__main__ import main

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("HYDRAGNN_TUNE_CACHE", raising=False)
    cfg = {
        "Verbosity": {"level": 0},
        "Dataset": {"name": "unit_test", "format": "unit_test", "compositional_stratified_splitting": False,
                    "rotational_invariance": False, "number_configurations": 40,
                    "node_features": {"name": ["x", "x2", "x3"], "dim": [1, 1, 1],
                                      "column_index": [0, 6, 7]},
                    "graph_features": {"name": ["sum_x_x2_x3"], "dim": [1], "column_index": [0]}},
        "NeuralNetwork": {
            "Architecture": {"mpnn_type": "GIN", "hidden_dim": 8, "num_conv_layers": 2,
                             "use_sorted_aggregation": True, "radius": 2.0,
                             "max_neighbours": 100, "task_weights": [1.0],
                             "output_heads": {"graph": {"num_sharedlayers": 1,
                                                        "dim_sharedlayers": 4,
                                                        "num_headlayers": 1,
                                                        "dim_headlayers": [4]}}},
            "Variables_of_interest": {"input_node_features": [0], "output_names": ["s"],
                                      "output_index": [0], "type": ["graph"]},
            "Training": {"batch_size": 8, "num_pad_buckets": 2, "num_epoch": 1,
                         "perc_train": 0.7, "Optimizer": {"learning_rate": 0.01}}},
    }
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    argv = [str(path), "--budget", "2", "--trials", "1", "--cache-dir", str(tmp_path / "table")]
    # the module entry itself, in a process of its own
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, "-m", "hydragnn_tpu_torch.tune", *argv],
                          capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    entries = len(list((tmp_path / "table").glob("*.json")))
    last = proc.stdout.strip().splitlines()[-1]
    assert entries >= 1 and last == f"tune: {entries} entries ({0} cache hit(s), {entries} swept)"
    second = main(argv)
    assert second["hits"] == second["entries"] == entries and second["swept"] == 0
