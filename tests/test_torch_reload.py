"""Hot reload, the drain's grace window and reduced-precision weights of the
port's server on the CPU, held against the JAX package.

- The ``CheckpointWatcher``'s verdicts over one scenario of pointer moves
  (a new entry, an unchanged pointer, a bit-flipped candidate, a pointer
  to a missing file, a good entry again) equal the JAX watcher's, with the
  same reload events.
- On a live ``GraphServer`` (EGNN, small): a staged swap is taken between
  batches, in place (the served tensors keep their storage: the CUDA
  graphs of the card hold their addresses), and every answer equals the
  forward with the weights its handle names, bit for bit; a corrupt
  candidate and a walk-back to an older file are rejected while the
  current weights keep serving; an int8 candidate refused by the accuracy
  gate keeps the old weights too.
- ``drain_grace_s``: ``/readyz`` turns 503 at once while admissions stay
  open for the grace window, then they close.
- ``cast_inference_weights(state, "bfloat16")`` equals the JAX package's on
  bridged weights (bf16 parameters bit for bit, f32 statistics), and a
  bf16-weight server answers as the cast model does.
"""

import copy
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from hydragnn_tpu.config import update_config as j_update
from hydragnn_tpu.data import GraphLoader as JLoader
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.models import init_model as j_init
from hydragnn_tpu.obs.events import events as j_log
from hydragnn_tpu.serve.reload import CheckpointWatcher as JWatcher
from hydragnn_tpu.train import TrainState as JTrain
from hydragnn_tpu.train import checkpoint as jck
from hydragnn_tpu.train import make_optimizer as j_make_optimizer
from hydragnn_tpu.train.state import InferenceState as JInference
from hydragnn_tpu.train.state import cast_inference_weights as j_cast
from hydragnn_tpu_torch.api import run_server
from hydragnn_tpu_torch.bridge import load_jax_variables, torch_arrays
from hydragnn_tpu_torch.config import update_config as t_update
from hydragnn_tpu_torch.data import GraphLoader as TLoader
from hydragnn_tpu_torch.data import batch_graphs, oc20_shaped_dataset, split_dataset
from hydragnn_tpu_torch.models import create_model as t_create
from hydragnn_tpu_torch.obs.events import events as t_log
from hydragnn_tpu_torch.serve import ServerDrainingError
from hydragnn_tpu_torch.serve.reload import CheckpointWatcher
from hydragnn_tpu_torch.train import InferenceState, TrainState, make_optimizer
from hydragnn_tpu_torch.train import checkpoint as tck
from hydragnn_tpu_torch.train.state import cast_inference_weights
from hydragnn_tpu_torch.utils import faultinject

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the watcher's verdicts against the JAX watcher
# ---------------------------------------------------------------------------


class _W(torch.nn.Module):
    def __init__(self, v: float):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((4,), float(v)))


class _StubServer:
    """The server surface a watcher drives: the restore template, the
    install (recording what it staged) and the current checkpoint."""

    def __init__(self, side):
        import threading

        self.side = side
        self.reload_lock = threading.Lock()
        self.current_checkpoint = None
        self.installed = []
        self.restore_template = (
            JInference.create({"params": {"w": np.zeros((4,), np.float32)}})
            if side == "jax" else InferenceState(_W(0.0)))

    def _install_state(self, state, label):
        w = state.params["w"] if self.side == "jax" else state.model.w.detach()
        self.installed.append((label.rsplit(".", 1)[0], float(np.asarray(w)[0])))
        self.current_checkpoint = label
        return True


def _save(side, root, v, epoch):
    if side == "jax":
        st = JTrain.create({"params": {"w": np.full((4,), v, np.float32)}},
                           j_make_optimizer({"type": "SGD", "learning_rate": 1e-2}))
        return jck.save_model(st, "run", path=root, epoch=epoch)
    m = _W(v)
    st = TrainState.create(m, make_optimizer(m, {"type": "SGD", "learning_rate": 1e-2}))
    return tck.save_model(st, "run", path=root, epoch=epoch)


def _scenario(side, root):
    log = j_log() if side == "jax" else t_log()
    log.clear()
    server = _StubServer(side)
    cls = JWatcher if side == "jax" else CheckpointWatcher
    first = _save(side, root, 1.0, 0)
    watcher = cls(server, "run", path=root, initial_entry=os.path.basename(first))
    verdicts = [watcher.poll_once()]  # the pointer names the initial entry
    _save(side, root, 2.0, 1)
    verdicts += [watcher.poll_once(), watcher.poll_once()]
    bad = _save(side, root, 3.0, 2)
    faultinject.flip_bit(bad)  # the walk-back chain lands on epoch 1: rejected
    verdicts.append(watcher.poll_once())
    with open(os.path.join(root, "run", "latest"), "w") as f:
        f.write(os.path.basename(bad).replace("_epoch2", "_epoch7"))  # a missing file
    verdicts.append(watcher.poll_once())
    _save(side, root, 4.0, 3)
    verdicts.append(watcher.poll_once())
    kinds = [(e["kind"], e["candidate"].rsplit(".", 1)[0]) for e in log.snapshot()
             if e["kind"].startswith("reload_")]
    return verdicts, server.installed, (watcher.installed, watcher.rejected), kinds


def pytest_watcher_verdicts_match_jax(tmp_path):
    with pytest.warns(RuntimeWarning, match="hot reload: candidate"):
        got = _scenario("torch", str(tmp_path / "t"))
    with pytest.warns(RuntimeWarning, match="hot reload: candidate"):
        want = _scenario("jax", str(tmp_path / "j"))
    assert got == want
    assert got[0] == [None, "installed", None, "rejected", "rejected", "installed"]
    assert got[1] == [("run_epoch1", 2.0), ("run_epoch3", 4.0)]


# ---------------------------------------------------------------------------
# a live server
# ---------------------------------------------------------------------------


def _config(serving=None, hidden=16):
    return {
        "Dataset": {"node_features": {"dim": [1, 3, 3]}, "graph_features": {"dim": [1]}},
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "EGNN", "equivariance": True, "radius": 5.0,
                "max_neighbours": 10, "hidden_dim": hidden, "num_conv_layers": 2,
                "use_sorted_aggregation": True, "task_weights": [1.0, 1.0],
                "output_heads": {
                    "graph": {"num_sharedlayers": 1, "dim_sharedlayers": 8,
                              "num_headlayers": 2, "dim_headlayers": [8, 8]},
                    "node": {"num_headlayers": 2, "dim_headlayers": [8, 8], "type": "mlp"},
                },
            },
            "Variables_of_interest": {
                "input_node_features": [0, 1], "output_names": ["energy", "forces"],
                "output_index": [0, 2], "type": ["graph", "node"],
            },
            "Training": {"batch_size": 4, "pack_batches": True, "num_pad_buckets": 2,
                         "Optimizer": {"type": "AdamW", "learning_rate": 1e-3}},
        },
        "Serving": {"batch_window_s": 0.002, "http_port": -1, "reload_poll_s": 3600.0,
                    **(serving or {})},
    }


def _graphs():
    return oc20_shaped_dataset(16, mean_atoms=20, min_atoms=10, max_atoms=40, max_neighbours=10)


def _publish(cfg, splits, seed, epoch):
    """A checkpoint of the run's model with weights from ``seed``: the next
    entry the pointer names."""
    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.config.config import get_log_name_config

    done, _, _ = prepare_data(copy.deepcopy(cfg), splits)
    model = t_create(done, device="cpu", seed=seed)
    st = TrainState.create(model, make_optimizer(model, {"type": "AdamW", "learning_rate": 1e-3}))
    path = tck.save_model(st, get_log_name_config(done), epoch=epoch)
    return os.path.basename(path), model


def _answers_of(model, server, graphs):
    """Each graph alone through ``model`` at the server's pad level."""
    out = []
    with torch.no_grad():
        for g in graphs:
            b = batch_graphs([g], server.ladder.select_for([g]), sort_edges=True)
            o = model.eval()(b)
            out.append({"energy": o["energy"][0].numpy(),
                        "forces": o["forces"][:g.num_nodes].numpy()})
    return out


def _served(server, graphs):
    """Each graph submitted alone (a batch each); (answers, handles)."""
    handles = []
    for g in graphs:
        h = server.submit(g)
        h.result(timeout=60)
        handles.append(h)
    return [h.result() for h in handles], handles


def _same(a, b):
    return all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in ("energy", "forces"))


def pytest_swap_between_batches_in_place_and_rejections(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    graphs = _graphs()
    splits = split_dataset(graphs, 0.75, seed=0)
    cfg = _config({"hot_reload": True})
    e0, m0 = _publish(cfg, splits, seed=1, epoch=0)
    server = run_server(copy.deepcopy(cfg), datasets=splits, device="cpu")
    try:
        assert server.wait_ready(60), server.failed
        watcher = server._watcher
        assert isinstance(watcher, CheckpointWatcher)
        req = graphs[:3]
        got, hs = _served(server, req)
        assert _same(got, _answers_of(m0, server, req)) and {h.checkpoint for h in hs} == {e0}
        storage = {n: t.data_ptr() for n, t in server._served_tensors.items()}
        e1, m1 = _publish(cfg, splits, seed=2, epoch=1)
        assert watcher.poll_once() == "installed"
        # staged: nothing swapped until the next batch is formed
        assert server.stats()["reloads"] == 0 and server.current_checkpoint == e0
        got, hs = _served(server, req)
        assert _same(got, _answers_of(m1, server, req)) and {h.checkpoint for h in hs} == {e1}
        st = server.stats()
        assert st["reloads"] == 1 and st["current_checkpoint"] == e1
        assert {n: t.data_ptr() for n, t in server._served_tensors.items()} == storage
        # a bit-flipped candidate: the walk-back restores epoch 1, rejected
        e2, _ = _publish(cfg, splits, seed=3, epoch=2)
        faultinject.flip_bit(os.path.join("logs", server.log_name, e2))
        with pytest.warns(RuntimeWarning, match="failed verification"):
            assert watcher.poll_once() == "rejected"
        # a pointer to a file that is not there: an older file, rejected
        with open(os.path.join("logs", server.log_name, "latest"), "w") as f:
            f.write(e2.replace("_epoch2", "_epoch9"))
        with pytest.warns(RuntimeWarning, match="failed verification"):
            assert watcher.poll_once() == "rejected"
        got, hs = _served(server, req)
        assert _same(got, _answers_of(m1, server, req)) and {h.checkpoint for h in hs} == {e1}
        assert (watcher.installed, watcher.rejected) == (1, 2)
        assert server.stats()["failed_batches"] == 0
    finally:
        server.close()
    # a draining server refuses a stage
    assert server._install_state(InferenceState(m1), "late.pt") is False


def _readyz(port):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz", timeout=5) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def pytest_drain_grace_keeps_admitting_while_readyz_is_503(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    graphs = _graphs()
    cfg = _config({"drain_grace_s": 0.6, "http_port": 0})
    with pytest.warns(UserWarning, match="no checkpoint"):
        server = run_server(cfg, datasets=split_dataset(graphs, 0.75, seed=0), device="cpu")
    try:
        assert server.wait_ready(60) and _readyz(server.http_port) == 200
        t0 = time.monotonic()
        server.initiate_drain()
        assert _readyz(server.http_port) == 503
        h = server.submit(graphs[0])  # inside the grace window: admitted
        assert time.monotonic() - t0 < 0.6
        assert h.result(timeout=30)["forces"].shape == (graphs[0].num_nodes, 3)
        time.sleep(max(0.0, 0.65 - (time.monotonic() - t0)))
        with pytest.raises(ServerDrainingError):
            server.submit(graphs[1])
        assert server._drained.wait(10)
    finally:
        server.close()


def pytest_int8_reload_refused_by_the_gate_keeps_the_old_weights(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    graphs = _graphs()
    splits = split_dataset(graphs, 0.75, seed=0)
    cfg = _config({"hot_reload": True, "weights_dtype": "int8",
                   "quantization": {"mode": "weight_only", "max_error": 0.2}})
    e0, _ = _publish(cfg, splits, seed=1, epoch=0)
    server = run_server(copy.deepcopy(cfg), datasets=splits, device="cpu")
    try:
        assert server.wait_ready(60), server.failed
        before, _ = _served(server, graphs[:2])
        _publish(cfg, splits, seed=2, epoch=1)
        monkeypatch.setenv("HYDRAGNN_FAULT_QUANT_DRIFT", "_epoch1:8")
        with pytest.warns(RuntimeWarning, match="refused at install"):
            assert server._watcher.poll_once() == "rejected"
        after, hs = _served(server, graphs[:2])
        assert _same(before, after) and {h.checkpoint for h in hs} == {e0}
        assert server.stats()["reloads"] == 0
        # the next good candidate installs through the same gate
        monkeypatch.delenv("HYDRAGNN_FAULT_QUANT_DRIFT")
        e2, _ = _publish(cfg, splits, seed=3, epoch=2)
        assert server._watcher.poll_once() == "installed"
        _, hs = _served(server, graphs[:2])
        assert {h.checkpoint for h in hs} == {e2}
        assert server.stats()["quantization"]["source"] == "calibrated"
    finally:
        server.close()


# ---------------------------------------------------------------------------
# bf16 weights
# ---------------------------------------------------------------------------


def pytest_cast_inference_weights_bf16_matches_jax(monkeypatch):
    monkeypatch.setenv("HYDRAGNN_PALLAS_SEGMENT", "1")
    graphs = _graphs()
    tr, va, te = split_dataset(graphs, 0.75, seed=0)
    cfg = _config(hidden=24)
    jc = j_update(copy.deepcopy(cfg), tr, va, te)
    tc = t_update(copy.deepcopy(cfg), tr, va, te)
    jb = next(iter(JLoader(tr, 4, sort_edges=True)))
    tb = next(iter(TLoader(tr, 4, sort_edges=True)))
    jm = j_create(jc)
    v = jax.tree_util.tree_map(np.asarray, jax.device_get(j_init(jm, jb, seed=5)))
    tm = t_create(tc, device="cpu").eval()
    load_jax_variables(tm, v)
    jcast = j_cast(JInference.create(v), "bfloat16")
    tcast = cast_inference_weights(InferenceState(tm, 3), "bfloat16")
    assert tcast.step == 3 and tcast.model is not tm
    params = dict(tcast.model.named_parameters())
    for name, arr, where in torch_arrays(tcast.model, jax.device_get(jcast.params)):
        assert params[name].dtype == torch.bfloat16, where
        np.testing.assert_array_equal(params[name].detach().float().numpy(),
                                      np.asarray(arr).astype(np.float32), err_msg=where)
    assert all(p.dtype == torch.float32 for p in tm.parameters())  # the original untouched
    assert all(b.dtype != torch.bfloat16 for b in tcast.model.buffers())
    # f32 inputs on bf16-valued weights: both promote to f32
    jout = jax.device_get(jm.apply(jcast.variables(), jb, train=False))
    with torch.no_grad():
        tout = tcast.model(tb)
    for name, a in jout.items():
        a, t = np.asarray(a), tout[name].float().numpy()
        assert tout[name].dtype == torch.float32
        mask = (tb.graph_mask if a.shape[0] == tb.num_graphs else tb.node_mask).numpy()
        assert float(np.abs(a[mask] - t[mask]).max()) <= 1e-4 * float(np.abs(a[mask]).max())


def pytest_bf16_server_answers_as_the_cast_model(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    graphs = _graphs()
    splits = split_dataset(graphs, 0.75, seed=0)
    cfg = _config({"weights_dtype": "bfloat16"})
    _, m0 = _publish(cfg, splits, seed=1, epoch=0)
    server = run_server(copy.deepcopy(cfg), datasets=splits, device="cpu")
    try:
        assert server.wait_ready(60), server.failed
        st = server.stats()
        assert st["weights_dtype"] == "bfloat16"
        assert server.weight_nbytes() < 0.6 * sum(
            t.numel() * t.element_size() for t in m0.state_dict().values())
        got, _ = _served(server, graphs[:3])
        want = _answers_of(cast_inference_weights(InferenceState(m0), "bfloat16").model,
                           server, graphs[:3])
        assert _same(got, want)
    finally:
        server.close()
