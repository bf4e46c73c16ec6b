"""The port's int8 plane against the JAX package's on the CPU.

- ``ops/quant.py``: ``quantize_per_channel`` (2-D and branch-banked),
  ``dequantize``, ``quantize_activations`` (saturation included),
  ``int8_matmul`` (int32 accumulation, padded operands) and
  ``normalize_tiles`` bit for bit against ``hydragnn_tpu.ops.quant``; the
  ``int8_dot`` plan keyed under dtype ``int8`` as in the JAX plane.
- ``serve/quantize.py`` on the EGNN (hidden 24, 2 layers, K2 in the last
  layer) with bridged weights: the same layers quantized, the weight scales
  bit for bit, in w8a8 the same calibrated scopes with their activation
  scales to f32 rounding (``ACT_SCALE_RTOL``: the probed activations differ
  by summation order across the packages); the quantized predictions on
  real rows within ``PRED_RTOL`` of each head's largest value, and the
  gate's errors equal to within ``GATE_ATOL``. The JAX package calibrates
  and gates on every row, the padding's too; the port on real rows only,
  so these comparisons run the port on every row (``every_row``).
- The port's own calibration and gate at the served batch shapes (the
  server's ``_quant_batches``) against a plain masked max-abs reference.
- The snapshot round trip, its refusals (another mode, a torn file) and
  the server's install paths: calibrated then the snapshot's fast path, a
  drifted install refused with the typed error.
"""

import contextlib
import copy
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from hydragnn_tpu.config import update_config as j_update
from hydragnn_tpu.data import GraphLoader as JLoader
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.models import init_model as j_init
from hydragnn_tpu.ops import quant as j_quant
from hydragnn_tpu.serve import quantize as j_qz
from hydragnn_tpu.train.state import InferenceState as JState
from hydragnn_tpu.tune import plans as j_plans
from hydragnn_tpu_torch.bridge import load_jax_variables
from hydragnn_tpu_torch.config import update_config as t_update
from hydragnn_tpu_torch.data import GraphLoader as TLoader
from hydragnn_tpu_torch.data import oc20_shaped_dataset, split_dataset
from hydragnn_tpu_torch.models import create_model as t_create
from hydragnn_tpu_torch.ops import quant as t_quant
from hydragnn_tpu_torch.serve import GraphServer, ServeConfig
from hydragnn_tpu_torch.serve import quantize as t_qz
from hydragnn_tpu_torch.train.state import InferenceState, cast_inference_weights
from hydragnn_tpu_torch.tune import plans as t_plans
from hydragnn_tpu_torch.utils import faultinject

torch.set_num_threads(2)

PRED_RTOL = {"weight_only": 1e-4, "w8a8": 2e-3}
# the gate's relative errors (1e-2 to 5e-2 here) agree to the f32 forwards'
# own agreement: both dequantize the same weights, but each sums in its
# own order (1e-6 of the largest output; readings 1.04e-6 weight-only,
# 1.7e-7 w8a8, whose activation roundings did not flip)
GATE_ATOL = {"weight_only": 3e-6, "w8a8": 3e-6}
ACT_SCALE_RTOL = 1e-6


@contextlib.contextmanager
def every_row():
    """The port's calibration and gate on every row, as the JAX package's
    run: no row mask for any layer input or output."""
    with mock.patch.object(t_qz, "_real_rows", lambda batch, x: None):
        yield


@pytest.fixture(autouse=True)
def _clean_faults():
    faultinject.reset()
    yield
    faultinject.reset()


# ---------------------------------------------------------------------------
# ops/quant.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 6), (3, 24, 10), (2, 3, 5, 7)])
def pytest_quantize_per_channel_and_dequantize_bit_for_bit(shape):
    rng = np.random.default_rng(sum(shape))
    w = rng.normal(size=shape).astype(np.float32)
    w[..., 1] *= 100.0  # a wide channel
    w[..., -1] = 0.0  # an all-zero channel
    jq, js = j_quant.quantize_per_channel(w)
    tq, ts = t_quant.quantize_per_channel(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(t_quant.dequantize(tq, ts).numpy(),
                                  np.asarray(j_quant.dequantize(jq, js)))
    assert float(ts.reshape(-1, shape[-1])[0, -1]) == 1.0  # the zero guard


def pytest_quantize_activations_bit_for_bit():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(size=200).astype(np.float32) * 3,
                        np.array([0.0, 0.5, -0.5, 1.5, 1000.0, -1000.0], np.float32)])
    for scale in (np.float32(1.0 / 127.0), np.float32(0.0173)):
        want = np.asarray(j_quant.quantize_activations(x, scale))
        got = t_quant.quantize_activations(torch.from_numpy(x), torch.tensor(scale)).numpy()
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,k,n", [(2, 512, 3), (5, 13, 7), (40, 866, 24), (1, 8, 8)])
def pytest_int8_matmul_bit_for_bit(m, k, n):
    rng = np.random.default_rng(m * k + n)
    x = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    w = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    if k == 512:
        x[:] = 127
        w[:] = 127  # 127 * 127 * 512 overflows int16 250x: int32 accumulation
    want = np.asarray(j_quant.int8_matmul(jnp.asarray(x), jnp.asarray(w)))
    got = t_quant.int8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the padded weight _int_mm takes gives the same sums (extra columns 0)
    padded = t_quant.int8_matmul(torch.from_numpy(x), t_quant.pad_weight(torch.from_numpy(w)))
    np.testing.assert_array_equal(padded[:, :n].numpy(), want)
    assert not padded[:, n:].any()


@pytest.mark.parametrize("args", [(0, 0, 0, 128, 128, 128), (40, 866, 866, 256, 256, 512),
                                  (3, 5, 7, 1, 2, 3), (1000, 24, 8, 64, 512, 128)])
def pytest_normalize_tiles_and_plan_match_jax(args):
    assert t_quant.normalize_tiles(*args) == j_quant.normalize_tiles(*args)
    shapes = {"rows": args[0], "cols": args[1], "k": args[2]}
    plan = dict(zip(("block_m", "block_n", "block_k"), args[3:]))
    assert t_plans.normalize("int8_dot", plan, shapes) == j_plans.normalize("int8_dot", plan, shapes)
    assert t_plans.KERNELS["int8_dot"].defaults == j_plans.KERNELS["int8_dot"].defaults
    assert t_plans.KERNELS["int8_dot"].grid == j_plans.KERNELS["int8_dot"].grid
    assert t_plans.kernel_version("int8_dot") == str(t_quant.KERNEL_VERSION) == \
        str(j_quant.KERNEL_VERSION)


def pytest_int8_matmul_announces_its_plan_under_int8(monkeypatch):
    from hydragnn_tpu_torch.tune import runtime

    seen = []
    monkeypatch.setattr(runtime, "tile_plan", lambda kernel, shapes, dtype: seen.append(
        (kernel, dict(shapes), dtype)) or {})
    t_quant.int8_matmul(torch.ones(4, 8, dtype=torch.int8), torch.ones(8, 16, dtype=torch.int8))
    assert seen == [("int8_dot", {"rows": 4, "cols": 16, "k": 8}, "int8")]


# ---------------------------------------------------------------------------
# the quantized EGNN on bridged weights
# ---------------------------------------------------------------------------


def _config(hidden=24):
    heads = {"graph": {"num_sharedlayers": 2, "dim_sharedlayers": 8, "num_headlayers": 2,
                       "dim_headlayers": [12, 12]},
             "node": {"num_headlayers": 2, "dim_headlayers": [12, 12], "type": "mlp"}}
    return {
        "Dataset": {"node_features": {"dim": [1, 3, 3]}, "graph_features": {"dim": [1]}},
        "NeuralNetwork": {
            "Architecture": {"mpnn_type": "EGNN", "equivariance": True, "radius": 5.0,
                             "max_neighbours": 10, "hidden_dim": hidden, "num_conv_layers": 2,
                             "use_sorted_aggregation": True, "task_weights": [1.0, 1.0],
                             "output_heads": heads},
            "Variables_of_interest": {
                "input_node_features": [0, 1], "output_names": ["energy", "forces"],
                "output_index": [0, 2], "type": ["graph", "node"]},
            "Training": {"batch_size": 4, "loss_function_type": "mae"},
        },
    }


@pytest.fixture(scope="module")
def world():
    os.environ["HYDRAGNN_PALLAS_SEGMENT"] = "1"
    try:
        graphs = oc20_shaped_dataset(16, mean_atoms=20, min_atoms=10, max_atoms=40,
                                     max_neighbours=10)
        tr, va, te = split_dataset(graphs, 0.75, seed=0)
        cfg = _config()
        jc = j_update(copy.deepcopy(cfg), tr, va, te)
        tc = t_update(copy.deepcopy(cfg), tr, va, te)
        jb = list(JLoader(tr, 4, sort_edges=True))[:2]
        tb = list(TLoader(tr, 4, sort_edges=True))[:2]
        jm = j_create(jc)
        v = jax.tree_util.tree_map(np.asarray, jax.device_get(j_init(jm, jb[0], seed=3)))
        tm = t_create(tc, device="cpu").eval()
        load_jax_variables(tm, v)
        quantized = {}
        for mode in ("weight_only", "w8a8"):
            js = JState.create(v)
            jq = j_qz.quantize_state(jm, js, jb, mode)
            ts = InferenceState(tm)
            with every_row():
                tq = t_qz.quantize_state(tm, ts, tb, mode)
            quantized[mode] = (js, jq, ts, tq)
        yield jm, v, jb, tm, tb, tc, quantized
    finally:
        os.environ.pop("HYDRAGNN_PALLAS_SEGMENT", None)


@pytest.mark.parametrize("mode", ["weight_only", "w8a8"])
def pytest_quantized_layers_and_scales_match_jax(world, mode):
    js, jq, ts, tq = world[-1][mode]
    assert sorted(tq.scales) == sorted(jq.scales) and tq.scales
    for path, s in jq.scales.items():
        np.testing.assert_array_equal(tq.scales[path].numpy(), np.asarray(s), err_msg=path)
    assert tq.mode == jq.mode == mode
    assert tq.w8a8 == jq.w8a8
    # each head's output layer stays f32
    assert "heads_NN_0/Dense_1/kernel" in tq.scales
    assert not {"heads_NN_0/Dense_2/kernel", "heads_NN_1/MLP_0/Dense_2/kernel"} & set(tq.scales)
    jflat = {"/".join(k): np.asarray(a) for k, a in flatten_dict(jq.quant).items()} \
        if jq.quant else {}
    assert sorted(tq.quant) == sorted({k.rsplit("/", 1)[0] for k in jflat})
    for scope, q in tq.quant.items():
        np.testing.assert_array_equal(q["kernel_scale"].numpy(), jflat[f"{scope}/kernel_scale"])
        a, b = float(q["act_scale"]), float(jflat[f"{scope}/act_scale"])
        assert abs(a - b) <= ACT_SCALE_RTOL * b, scope
    if mode == "w8a8":
        assert tq.w8a8, "no calibrated scope"
        assert not any(s.startswith("graph_convs_1/edge_lin2") for s in tq.w8a8)
    assert tq.weight_nbytes() < t_qz.weight_nbytes(ts.model)


@pytest.mark.parametrize("mode", ["weight_only", "w8a8"])
def pytest_quantized_predictions_and_gate_match_jax(world, mode):
    jm, _, jb, _, tb, _, quantized = world
    js, jq, ts, tq = quantized[mode]
    for j_batch, t_batch in zip(jb, tb):
        jout = jax.device_get(j_qz.apply_quantized(jm, jq, j_batch))
        tout = t_qz.apply_quantized(tq, t_batch)
        for name, a in jout.items():
            a = np.asarray(a)
            t = tout[name].float().numpy()
            mask = (t_batch.graph_mask if a.shape[0] == t_batch.num_graphs
                    else t_batch.node_mask).numpy()
            scale = float(np.abs(a[mask]).max())
            assert float(np.abs(a[mask] - t[mask]).max()) <= PRED_RTOL[mode] * scale, name
    jr = j_qz.accuracy_report(jm, js, jq, jb)
    with every_row():
        tr = t_qz.accuracy_report(ts, tq, tb)
    assert abs(tr["max_error"] - jr["max_error"]) <= GATE_ATOL[mode]
    assert sorted(tr["per_head"]) == sorted(jr["per_head"])
    for k, e in jr["per_head"].items():
        assert abs(tr["per_head"][k] - e) <= GATE_ATOL[mode], k
    assert tr["batches"] == jr["batches"] == len(tb)


def pytest_gate_refuses_drifted_candidate_like_jax(world):
    jm, _, jb, _, tb, _, quantized = world
    js, jq, ts, tq = quantized["weight_only"]
    outcomes = []
    for run in ((lambda: j_qz.gate_or_raise(jm, js, j_qz.apply_scale_drift(jq, 8.0), jb, 0.05)),
                (lambda: t_qz.gate_or_raise(ts, t_qz.apply_scale_drift(tq, 8.0), tb, 0.05))):
        with pytest.raises(Exception) as exc, every_row():
            run()
        outcomes.append(exc.value)
    j_err, t_err = outcomes
    assert type(t_err).__name__ == type(j_err).__name__ == "QuantizationDriftError"
    assert t_err.code == j_err.code == "quant_drift"
    assert abs(t_err.max_error - j_err.max_error) <= 1e-5 * j_err.max_error
    assert t_err.limit == j_err.limit == 0.05 and sorted(t_err.per_head) == sorted(j_err.per_head)
    # the drift drill distorts a copy: the original still passes
    assert t_qz.gate_or_raise(ts, tq, tb, 0.05)["max_error"] <= 0.05


def pytest_cast_int8_dispatches_to_the_quantizer(world):
    ts = world[-1]["weight_only"][2]
    q = cast_inference_weights(ts, "int8")
    assert isinstance(q, t_qz.QuantizedInferenceState) and q.mode == "weight_only"
    assert sorted(q.scales) == sorted(world[-1]["weight_only"][3].scales)


@pytest.mark.parametrize("mode", ["weight_only", "w8a8"])
def pytest_snapshot_round_trip_and_corrupt_fallback(world, tmp_path, mode):
    _, _, _, tm, tb, _, quantized = world
    _, _, ts, tq = quantized[mode]
    report = t_qz.gate_or_raise(ts, tq, tb, 0.05 if mode == "weight_only" else 1.0,
                                run="snap", entry="e1")
    full = t_qz.save_snapshot(tq, dict(report, source="calibrated"), "snap", "e1", str(tmp_path))
    assert os.path.exists(full) and os.path.exists(full + ".sha256")
    loaded = t_qz.load_snapshot(tm, "snap", "e1", mode, str(tmp_path))
    assert loaded is not None
    q2, banked = loaded
    assert (q2.mode, q2.w8a8) == (tq.mode, tq.w8a8)
    assert banked["max_error"] == report["max_error"]
    a, b = tq.model.state_dict(), q2.model.state_dict()
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    for p in tq.scales:
        assert torch.equal(tq.scales[p], q2.scales[p])
    for batch in tb:
        x, y = t_qz.apply_quantized(tq, batch), t_qz.apply_quantized(q2, batch)
        assert all(torch.equal(x[k], y[k]) for k in x)
    other = "w8a8" if mode == "weight_only" else "weight_only"
    assert t_qz.load_snapshot(tm, "snap", "e1", other, str(tmp_path)) is None
    assert t_qz.load_snapshot(tm, "snap", "e2", mode, str(tmp_path)) is None
    with open(full, "r+b") as f:
        f.write(b"\x00" * 64)
    assert t_qz.load_snapshot(tm, "snap", mode="weight_only" if mode == "weight_only" else mode,
                              entry="e1", path=str(tmp_path)) is None


def _server(world, tmp_path, mode="weight_only", label="e1.pt", max_error=0.05):
    _, _, _, tm, _, tc, _ = world
    graphs = oc20_shaped_dataset(16, mean_atoms=20, min_atoms=10, max_atoms=40, max_neighbours=10)
    from hydragnn_tpu_torch.data.graph import SpecLadder

    ladder = SpecLadder.for_dataset(graphs, 4, num_buckets=2)
    return GraphServer(
        copy.deepcopy(tm), ladder,
        ServeConfig(micro_batch_graphs=4, batch_window_s=0.002, http_port=-1,
                    weights_dtype="int8",
                    quantization={"mode": mode, "calibration_batches": 2,
                                  "max_error": max_error}),
        template_graphs=graphs, sort_edges=True, device="cpu", log_name="quant_srv",
        checkpoint_label=label, checkpoint_dir=str(tmp_path)), graphs


def pytest_server_int8_calibrates_then_takes_the_snapshot(world, tmp_path):
    """The first int8 server quantizes, calibrates and gates, and publishes
    the snapshot; the next one (a replica) loads it without calibrating,
    and both serve the same answers; the f32 master stays on the host."""
    first, graphs = _server(world, tmp_path)
    assert first.stats()["quantization"]["source"] == "calibrated"
    assert os.path.exists(t_qz.snapshot_path("quant_srv", "e1.pt", "weight_only", str(tmp_path)))
    second, _ = _server(world, tmp_path)
    assert second.stats()["quantization"]["source"] == "snapshot"
    assert second.stats()["weights_dtype"] == "int8"
    assert second.weight_nbytes() < t_qz.weight_nbytes(first.model)
    answers = []
    for s in (first, second):  # one at a time: the retrace sentinel is process-wide
        s.start()
        try:
            assert s.wait_ready(60), s.failed
            answers.append(s.predict(graphs[:6]))
        finally:
            s.close()
    for x, y in zip(*answers):
        assert all(np.array_equal(x[k], y[k]) for k in x)


def pytest_server_refuses_a_drifted_install(world, tmp_path, monkeypatch):
    monkeypatch.setenv("HYDRAGNN_FAULT_QUANT_DRIFT", "bad:8")
    with pytest.raises(t_qz.QuantizationDriftError) as exc:
        _server(world, tmp_path, label="bad_epoch3.pt")
    assert exc.value.max_error > exc.value.limit == 0.05
    # an entry outside the drill's match quantizes cleanly
    server, _ = _server(world, tmp_path, label="good.pt")
    assert server.stats()["quantization"]["max_error"] <= 0.05


def _rows(batch, x):
    """The real rows of a layer input or output, by its leading extent."""
    for extent, mask in ((batch.num_nodes, batch.node_mask), (batch.num_edges, batch.edge_mask),
                         (batch.num_graphs, batch.graph_mask)):
        if x.shape[0] == extent:
            return mask
    raise AssertionError(f"rows {x.shape[0]} name no nodes, edges or graphs")


def pytest_server_calibration_on_real_rows_ignores_the_padding(world):
    """The port calibrates and gates on real rows: each activation scale is
    the max |x| of the layer's real node, edge or graph rows over 127, not
    the padding's (the sorted layout's dummy node sums every padding edge);
    on every row (the JAX package's) no scale is smaller and no gate
    reading lower."""
    _, _, _, tm, tb, _, quantized = world
    ts = quantized["w8a8"][2]
    seen = {}

    def hook(name):
        def pre(module, args):
            seen.setdefault(name, []).append(args[0].detach())
        return pre

    handles = [m.register_forward_pre_hook(hook(n)) for n, m in tm.named_modules()
               if n in ("graph_convs.0.edge_lin_recv", "graph_convs.1.MLP_0.Dense_0")]
    try:
        scales, _ = t_qz.calibrate_activations(tm, tb)
    finally:
        for h in handles:
            h.remove()
    for name, scope in (("graph_convs.0.edge_lin_recv", "graph_convs_0/edge_lin_recv"),
                        ("graph_convs.1.MLP_0.Dense_0", "graph_convs_1/MLP_0/Dense_0")):
        peak = max(float(x[_rows(b, x)].abs().max()) for x, b in zip(seen[name], tb))
        assert scales[scope] == peak / t_qz.INT8_MAX, scope
    with every_row():
        everywhere, _ = t_qz.calibrate_activations(tm, tb)
    assert sorted(scales) == sorted(everywhere)
    assert all(scales[s] <= everywhere[s] for s in scales)
    q = t_qz.quantize_state(tm, ts, tb, "w8a8")
    real = t_qz.accuracy_report(ts, q, tb)
    with every_row():
        assert real["max_error"] <= t_qz.accuracy_report(ts, q, tb)["max_error"]


def pytest_served_calibration_and_gate_match_a_masked_reference(world, tmp_path):
    """The w8a8 server's install at its served batch shapes (the template
    graphs packed as requests are, each batch at its ladder level): every
    calibrated layer's activation scale is the plain max |x| over that
    layer's real input rows over 127, and the gate's reading is the plain
    relative max error of the quantized outputs over the real graph and
    node rows."""
    server, _ = _server(world, tmp_path, mode="w8a8", max_error=1.0)
    try:
        batches = server._quant_batches()
        assert len(batches) == 2 and {b.num_nodes for b in batches} <= \
            {s.n_nodes for s in server.ladder.specs}
        fp = server.model.eval()
        peaks, handles = {}, []
        for scope, m in t_qz._calibration_modules(fp).items():
            def pre(module, args, scope=scope):
                x = args[0].detach()
                rows = x[_rows(batch, x)]
                peaks[scope] = max(peaks.get(scope, 0.0), float(rows.abs().max()))
            handles.append(m.register_forward_pre_hook(pre))
        outs = []
        try:
            with torch.inference_mode():
                for batch in batches:
                    outs.append((batch, fp(batch)))
        finally:
            for h in handles:
                h.remove()
        served = {n: m for n, m in server._serve_model.named_modules()
                  if isinstance(m, t_qz.QuantizedDense) and m.act_scale is not None}
        assert served
        by_scope = {s: n for s, n in ((t_qz.flax_path(f"{n}.weight")[0].rsplit("/", 1)[0], n)
                                      for n in served)}
        assert set(by_scope) <= set(peaks)
        for scope, name in by_scope.items():
            assert float(served[name].act_scale) == np.float32(peaks[scope] / t_qz.INT8_MAX), \
                scope
        err = {}
        with torch.inference_mode():
            for batch, ref in outs:
                got = server._serve_model(batch)
                for k, r in ref.items():
                    rows = _rows(batch, r)
                    a, b = got[k][rows].float(), r[rows].float()
                    err[k] = max(err.get(k, 0.0),
                                 float((a - b).abs().max()) / (float(b.abs().max()) + 1e-8))
        report = server.stats()["quantization"]
        assert report["source"] == "calibrated"
        for k, e in err.items():
            assert abs(report["per_head"][k] - e) <= 1e-8, k
        assert abs(report["max_error"] - max(err.values())) <= 1e-8
    finally:
        server.close()
