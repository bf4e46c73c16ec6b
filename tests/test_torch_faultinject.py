"""The port's fault-injection knobs (hydragnn_tpu_torch/utils/faultinject.py)
against the JAX package's on the CPU: for every ``HYDRAGNN_FAULT_*`` knob
and a set of specs, the same calls make the same decisions in both
modules (which step poisons, which point kills, which call raises or
sleeps and for how long, which sample or request is corrupted, which
replica is armed), with ``os.kill`` and ``time.sleep`` recorded instead of
acted on; ``configure`` mirrors the environment, ``reset`` clears the
counters, and ``flip_bit`` flips the same bit."""

import os
import time

import numpy as np
import pytest
import torch

import hydragnn_tpu.utils.faultinject as j_fi
import hydragnn_tpu_torch.utils.faultinject as t_fi
from hydragnn_tpu.data import deterministic_graph_dataset as j_graphs
from hydragnn_tpu_torch.data import deterministic_graph_dataset as t_graphs

MODULES = {"jax": j_fi, "torch": t_fi}


@pytest.fixture(autouse=True)
def _recorded(monkeypatch):
    """``os.kill`` and ``time.sleep`` recorded, both modules reset."""
    calls = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: calls.append(("kill", int(sig))))
    monkeypatch.setattr(time, "sleep", lambda s: calls.append(("sleep", float(s))))
    for m in MODULES.values():
        m.reset()
    yield calls
    for m in MODULES.values():
        m.reset()


def _trace(calls, fn):
    """``fn()``'s result, or the exception's type and message, plus the
    kills and sleeps it recorded."""
    start = len(calls)
    try:
        out = ("ok", fn())
    except Exception as e:  # noqa: BLE001 -- the outcome is the datum
        out = ("raise", type(e).__name__, str(e))
    return out, calls[start:]


def _both(monkeypatch, calls, env, drive):
    """``drive(module)`` under ``env`` in each module, from a reset."""
    got = {}
    for name, m in MODULES.items():
        for k in list(os.environ):
            if k.startswith("HYDRAGNN_FAULT_"):
                monkeypatch.delenv(k)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        m.reset()
        got[name] = drive(m, calls)
    return got["torch"], got["jax"]


# knob -> (specs, driver over the module's hook)
def _indexed(hook, n=12):
    def drive(m, calls):
        return [_trace(calls, lambda i=i: getattr(m, hook)(i)) for i in range(n)]
    return drive


def _replica(hook, two_args):
    def drive(m, calls):
        out = []
        for r in range(4):
            for k in (range(8) if two_args else (None,)):
                args = (r, k) if two_args else (r,)
                out.append(_trace(calls, lambda a=args: getattr(m, hook)(*a)))
        return out
    return drive


def _kill_points(m, calls):
    return [_trace(calls, lambda p=p: m.maybe_kill(p))
            for p in ("ckpt_tmp_written", "ckpt_msgpack_replaced", "ckpt_digest_written", "x")]


def _io_errors(m, calls):
    return [_trace(calls, lambda p=p: m.maybe_ioerror(p)) for p in ("a", "a", "b", "a", "a", "b")]


def _socket(m, calls):
    return [_trace(calls, lambda p=p: m.maybe_socket_drop(p)) for p in ("s", "s", "t", "s", "t")]


def _loader(m, calls):
    return [_trace(calls, lambda i=i: m.maybe_loader_fault(i)) for i in range(6)]


def _host(m, calls):
    return [_trace(calls, lambda: m.maybe_host_fault()) for _ in range(6)] + \
        [_trace(calls, lambda: m.maybe_host_fault(1))]


def _drift(m, calls):
    return [_trace(calls, lambda e=e: m.maybe_quant_drift(e))
            for e in (None, "run_epoch1.pt", "run_epoch2.pt", "other.pt")]


def _corrupt(m, calls):
    return [_trace(calls, lambda i=i: m.corrupt_blob(b"\x80\x04abc", i)) for i in range(5)]


KNOBS = {
    "kill_at": ("HYDRAGNN_FAULT_KILL_AT", ["ckpt_tmp_written", "ckpt_digest_written,x", ""],
                _kill_points),
    "io_errors": ("HYDRAGNN_FAULT_IO_ERRORS", ["0", "1", "3"], _io_errors),
    "socket_drop": ("HYDRAGNN_FAULT_SOCKET_DROP", ["2", "1,3", ""], _socket),
    "loader_stall": ("HYDRAGNN_FAULT_LOADER_STALL", ["2", "3:0.5"], _loader),
    "loader_die": ("HYDRAGNN_FAULT_LOADER_DIE", ["1", "0,4"], _loader),
    "serve_wedge": ("HYDRAGNN_FAULT_SERVE_WEDGE", ["2", "3:1.5", "4+:0.25", "1,5"],
                    _indexed("maybe_serve_wedge")),
    "serve_slow_client": ("HYDRAGNN_FAULT_SERVE_SLOW_CLIENT", ["0", "2:0.3", "6+"],
                          _indexed("maybe_slow_client")),
    "replica_kill": ("HYDRAGNN_FAULT_REPLICA_KILL", ["1", "2:3", "1:2+", "3:1,4", "x:1"],
                     _replica("maybe_replica_kill", True)),
    "replica_wedge": ("HYDRAGNN_FAULT_REPLICA_WEDGE", ["1", "2:3", "1:0:0.5", "0:2+:2"],
                      _replica("maybe_replica_wedge", True)),
    "replica_slow": ("HYDRAGNN_FAULT_REPLICA_SLOW", ["1", "2:0.05", "z"],
                     _replica("maybe_replica_slow", False)),
    "quant_drift": ("HYDRAGNN_FAULT_QUANT_DRIFT", ["", ":8", "epoch2:2.5", "epoch1", "run:x"],
                    _drift),
    "straggle": ("HYDRAGNN_FAULT_STRAGGLE", ["3", "2+:0.2", "1,4:0.1"], _indexed("maybe_straggle")),
    "host_kill": ("HYDRAGNN_FAULT_HOST_KILL", ["2", "3+", "0,5"], _host),
    "host_preempt": ("HYDRAGNN_FAULT_HOST_PREEMPT", ["1", "4+"], _host),
    "corrupt_sample": ("HYDRAGNN_FAULT_CORRUPT_SAMPLE", ["1", "0,3"], _corrupt),
}


@pytest.mark.parametrize("spec", [(k, s) for k, (_, specs, _) in KNOBS.items() for s in specs],
                         ids=lambda ks: f"{ks[0]}={ks[1]}")
def pytest_knob_decisions_match_jax(spec, monkeypatch, _recorded):
    knob, value = spec
    env, _, drive = KNOBS[knob]
    got, want = _both(monkeypatch, _recorded, {env: value}, drive)
    assert got == want
    # and configure() mirrors the environment in the port; like the JAX
    # package's, it has no key for the quantization drill (env only)
    monkeypatch.delenv(env)
    t_fi.reset()
    if knob == "quant_drift":
        for m in MODULES.values():
            with pytest.raises(KeyError, match="unknown faultinject key"):
                m.configure(quant_drift=value)
        return
    t_fi.configure(**{knob: value})
    assert drive(t_fi, _recorded) == got


@pytest.mark.parametrize("env", [
    {"HYDRAGNN_FAULT_NAN_STEP": "5"}, {"HYDRAGNN_FAULT_NAN_STEP": "5+"},
    {"HYDRAGNN_FAULT_NAN_STEP": "3,7"}, {"HYDRAGNN_FAULT_NAN_LR_GT": "0.01"},
    {"HYDRAGNN_FAULT_NAN_STEP": "2+", "HYDRAGNN_FAULT_NAN_LR_GT": "0.01"}, {},
])
def pytest_poison_grads_matches_jax(env, monkeypatch, _recorded):
    """Which steps (and learning rates) poison every floating gradient."""
    import jax.numpy as jnp

    def drive(m, calls):
        out = []
        for step in range(9):
            for lr in (0.001, 0.1):
                if m is j_fi:
                    g = {"w": jnp.ones((2, 2)), "i": jnp.ones(2, jnp.int32)}
                    p = m.poison_grads(g, jnp.asarray(step), jnp.asarray(lr))
                else:
                    g = {"w": torch.ones(2, 2), "i": torch.ones(2, dtype=torch.int32)}
                    p = m.poison_grads(g, torch.tensor(step), torch.tensor(lr))
                out.append((bool(np.isnan(np.asarray(p["w"])).all()),
                            bool(np.isnan(np.asarray(p["w"])).any()),
                            np.asarray(p["i"]).tolist()))
        return out

    got, want = _both(monkeypatch, _recorded, env, drive)
    assert got == want
    if not env:
        g = [torch.ones(1)]
        assert t_fi.poison_grads(g, 0) is g  # unarmed: the same object
    opt = torch.optim.SGD([torch.nn.Parameter(torch.ones(1))], lr=0.05)
    assert t_fi.lr_of(opt) == 0.05 and t_fi.lr_of(object()) is None


@pytest.mark.parametrize("spec", ["1", "0,2", "9", ""])
def pytest_sample_and_request_poisoning_match_jax(spec, monkeypatch, _recorded):
    tg, jg = t_graphs(4, seed=2), j_graphs(4, seed=2)

    def nan_rows(graphs):
        return [bool(np.isnan(np.asarray(g.x)).any()) for g in graphs]

    for env in ("HYDRAGNN_FAULT_SAMPLE_NAN", "HYDRAGNN_FAULT_SERVE_REQ_NAN"):
        def drive(m, calls, env=env):
            graphs = jg if m is j_fi else tg
            if env.endswith("SAMPLE_NAN"):
                out = m.poison_samples(graphs)
                return nan_rows(out), out is graphs
            out = [m.poison_request(g, i) for i, g in enumerate(graphs)]
            return nan_rows(out), [a is b for a, b in zip(out, graphs)]

        got, want = _both(monkeypatch, _recorded, {env: spec}, drive)
        assert got == want
    assert not any(nan_rows(tg))  # the inputs themselves are untouched


def pytest_configure_and_reset_match_jax(monkeypatch, _recorded):
    with pytest.raises(KeyError, match="unknown faultinject key"):
        t_fi.configure(no_such_knob="1")
    for m in MODULES.values():
        m.configure(io_errors="1")
        assert _trace(_recorded, lambda: m.maybe_ioerror("p"))[0][0] == "raise"
        m.reset()
        assert _trace(_recorded, lambda: m.maybe_ioerror("p"))[0] == ("ok", None)
        m.configure(io_errors=None)
    # the environment wins over configure()
    monkeypatch.setenv("HYDRAGNN_FAULT_SERVE_WEDGE", "1:0.5")
    t_fi.configure(serve_wedge="2:9")
    assert _trace(_recorded, lambda: t_fi.maybe_serve_wedge(1))[1] == [("sleep", 0.5)]


def pytest_flip_bit_matches_jax(tmp_path):
    blobs = []
    for m in MODULES.values():
        p = tmp_path / f"f_{m.__name__.split('.')[0]}"
        p.write_bytes(bytes(range(64)))
        offs = (m.flip_bit(str(p)), m.flip_bit(str(p), byte_offset=3, bit=7))
        blobs.append((offs, p.read_bytes()))
    assert blobs[0] == blobs[1]
    empty = tmp_path / "empty"
    empty.write_bytes(b"")
    with pytest.raises(ValueError, match="empty"):
        t_fi.flip_bit(str(empty))
