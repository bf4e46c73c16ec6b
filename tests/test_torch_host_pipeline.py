"""The host pipeline of the port against the JAX package's, on the CPU.

- Config completion of the three host-pipeline ``Training`` keys
  (``loader_stall_timeout``, ``double_buffer``, ``elastic``): the same
  completed values and the same ``ValueError``s as the JAX package.
- ``GraphLoader``'s prefetch producer: the same batches, bit for bit and in
  order, with prefetch 0 and 2 (shuffled, packed, weighted draws, rank
  shares), equal to the JAX loader's for the same seed; its stall
  watchdog: a wedged producer and a dead one raise ``LoaderStallError``
  (counted in ``hydragnn_loader_stalls_total``, with a ``loader_stall``
  event), a producer's exception reaches the consumer, an abandoned epoch
  reaps the producer or warns that it leaked.
- ``device_prefetch`` on the CPU (the same thread and queue as on the
  card, without streams): order, errors, early close; ``double_buffer``
  mapped to a depth as the JAX package maps it, ``HYDRAGNN_DEVICE_PREFETCH``
  winning; a small ``run_training`` gives the same losses and state bit
  for bit with staging and prefetch on and off.
"""

import copy
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from hydragnn_tpu.config.config import update_config as j_update_config
from hydragnn_tpu.data.pipeline import GraphLoader as JGraphLoader
from hydragnn_tpu_torch.api import run_training
from hydragnn_tpu_torch.config.config import update_config as t_update_config
from hydragnn_tpu_torch.data import oc20_shaped_dataset, split_dataset
from hydragnn_tpu_torch.data import pipeline
from hydragnn_tpu_torch.data.graph import SpecLadder
from hydragnn_tpu_torch.data.pipeline import GraphLoader, LoaderStallError
from hydragnn_tpu_torch.obs.events import EV_LOADER_STALL, events
from hydragnn_tpu_torch.obs.registry import registry
from hydragnn_tpu_torch.train import loop
from test_torch_compile_plane import _config
from test_torch_data import _assert_batch_equal

torch.set_num_threads(2)

PIPELINE_KEYS = ("loader_stall_timeout", "double_buffer", "elastic")


@pytest.fixture(scope="module")
def splits():
    graphs = oc20_shaped_dataset(36, mean_atoms=16, min_atoms=6, max_atoms=32,
                                 max_neighbours=10)
    return split_dataset(graphs, 0.7, seed=0)


@pytest.fixture(scope="module")
def graphs():
    return oc20_shaped_dataset(60, mean_atoms=14, min_atoms=6, max_atoms=30, max_neighbours=8)


# -- config completion --------------------------------------------------------------


def pytest_config_completion_pipeline_keys_match_jax(splits):
    j = j_update_config(_config(), *splits)["NeuralNetwork"]["Training"]
    t = t_update_config(_config(), *splits)["NeuralNetwork"]["Training"]
    assert {k: t[k] for k in PIPELINE_KEYS} == {k: j[k] for k in PIPELINE_KEYS} == {
        "loader_stall_timeout": 600.0, "double_buffer": True,
        "elastic": {"enabled": False, "min_hosts": 1, "grace_s": 30.0}}
    # every Training key the JAX package completes, the port completes too
    assert set(j) - set(t) == set()
    given = {"loader_stall_timeout": 0, "double_buffer": 3,
             "elastic": {"min_hosts": 2, "grace_s": 5.0}}
    j = j_update_config(_config(**copy.deepcopy(given)), *splits)["NeuralNetwork"]["Training"]
    t = t_update_config(_config(**copy.deepcopy(given)), *splits)["NeuralNetwork"]["Training"]
    assert {k: t[k] for k in PIPELINE_KEYS} == {k: j[k] for k in PIPELINE_KEYS}


@pytest.mark.parametrize("key,val,match", [
    ("loader_stall_timeout", -1, "loader_stall_timeout"),
    ("double_buffer", "x", "double_buffer"),
    ("double_buffer", -2, "double_buffer"),
    ("elastic", [1], "elastic"),
    ("elastic", {"min_hosts": 0}, "min_hosts"),
    ("elastic", {"grace_s": -1.0}, "grace_s"),
])
def pytest_config_completion_rejects_bad_pipeline_values_as_jax(splits, key, val, match):
    for update in (j_update_config, t_update_config):
        with pytest.raises(ValueError, match=match):
            update(_config(**{key: copy.deepcopy(val)}), *splits)


def pytest_elastic_enabled_is_not_ported_yet(splits):
    j_update_config(_config(elastic={"enabled": True}), *splits)
    with pytest.raises(NotImplementedError, match="elastic"):
        t_update_config(_config(elastic={"enabled": True}), *splits)


# -- the loader's prefetch producer ---------------------------------------------------


def _same(a, b) -> bool:
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, dict):
            if x.keys() != y.keys() or not all(torch.equal(x[k], y[k]) for k in x):
                return False
        elif isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or not torch.equal(x, y):
                return False
        elif x != y:
            return False
    return True


LOADER_CASES = {
    "shuffled": dict(num_buckets=3),
    "packed": dict(pack=True),
    "sorted, bucketed": dict(num_buckets=3, sort_edges=True, size_bucketing=True),
    "weighted draws": dict(num_buckets=2, oversampling=True, num_samples=50,
                           sample_weights=np.linspace(1.0, 3.0, 60)),
    "rank 1 of 3, packed": dict(pack=True, host_count=3, host_index=1),
    "rank 0 of 2, full batches": dict(num_buckets=2, host_count=2, host_index=0,
                                      drop_last=True),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def pytest_prefetch_keeps_the_batches_and_their_order(graphs, case):
    """Prefetch 0 and 2 give the same batches bit for bit, epoch by epoch,
    and each equals the JAX loader's with the same settings."""
    kw = LOADER_CASES[case]
    for epoch in (0, 1):
        got = {}
        for prefetch in (0, 2):
            loader = GraphLoader(graphs, 6, seed=5, prefetch=prefetch, **kw)
            loader.set_epoch(epoch)
            got[prefetch] = list(loader)
        assert len(got[0]) == len(got[2]) > 1
        assert all(_same(a, b) for a, b in zip(got[0], got[2]))
        jloader = JGraphLoader(graphs, 6, seed=5, prefetch=2, **kw)
        jloader.set_epoch(epoch)
        jb = list(jloader)
        assert len(jb) == len(got[2])
        for a, b in zip(jb, got[2]):
            _assert_batch_equal(a, b)


def pytest_prefetch_resumes_mid_epoch_as_without(graphs):
    loaders = []
    for prefetch in (0, 2):
        loader = GraphLoader(graphs, 6, seed=1, num_buckets=2, prefetch=prefetch)
        loader.resume(1, 3)
        loader.set_epoch(5)
        loaders.append(list(loader))
    assert len(loaders[0]) == len(loaders[1]) > 0
    assert all(_same(a, b) for a, b in zip(*loaders))


class _Fetch:
    """A dataset whose ``__getitem__`` blocks ``seconds`` once at index
    ``at``, or raises there."""

    def __init__(self, graphs, at, seconds=0.0, fail=False):
        self.graphs, self.at, self.seconds, self.fail = graphs, at, seconds, fail
        self.release = threading.Event()
        self.hit = False

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, i):
        if i == self.at and not self.hit:
            self.hit = True
            if self.fail:
                raise OSError(f"fetch of sample {i} failed")
            self.release.wait(self.seconds)
        return self.graphs[i]


def _loader(ds, graphs, source, **kw):
    return GraphLoader(ds, 6, spec=SpecLadder.for_dataset(graphs, 6), shuffle=False,
                       prefetch=2, source=source, **kw)


def _stalls(source):
    return registry().get("hydragnn_loader_stalls_total").value(source=source)


def pytest_watchdog_raises_on_a_wedged_producer(graphs):
    """A fetch that blocks past ``stall_timeout`` raises LoaderStallError
    naming the batch; the stall is counted once and emitted as an event;
    the producer, released, is reaped by the teardown join."""
    ds = _Fetch(graphs, at=20, seconds=5.0)
    loader = _loader(ds, graphs, "wedge_test", stall_timeout=0.3)
    events().clear()
    got = []
    t0 = time.perf_counter()
    with pytest.raises(LoaderStallError, match="produced nothing") as err:
        for b in loader:
            got.append(b)
            if len(got) == 3:
                # release the producer once the consumer is waiting on it
                threading.Timer(0.6, ds.release.set).start()
    assert time.perf_counter() - t0 < 3.0
    assert len(got) == 3 and "batch 3 of epoch 0" in str(err.value)
    assert _stalls("wedge_test") == 1
    ev = [e for e in events().snapshot() if e["kind"] == EV_LOADER_STALL]
    assert len(ev) == 1 and ev[0]["cause"] == "producer_wedged" and ev[0]["batch_index"] == 3
    loader._producer_thread.join(5.0)
    assert not loader._producer_thread.is_alive()


class _Dropping:
    """A queue module whose Queue loses every item after the first
    ``keep``: the producer finishes without its sentinel arriving, as a
    producer that died outside Python does."""

    Empty, Full = pipeline.queue.Empty, pipeline.queue.Full

    def __init__(self, keep):
        module = self

        class Queue(pipeline.queue.Queue):
            def put(self, item, block=True, timeout=None):
                module.puts += 1
                if module.puts <= keep:
                    super().put(item, block, timeout)

        self.Queue, self.puts = Queue, 0


def pytest_watchdog_raises_on_a_dead_producer(graphs, monkeypatch):
    monkeypatch.setattr(pipeline, "queue", _Dropping(keep=2))
    loader = _loader(graphs, graphs, "dead_test", stall_timeout=0)
    events().clear()
    got = []
    with pytest.raises(LoaderStallError, match="exited without an end-of-epoch sentinel"):
        for b in loader:
            got.append(b)
    assert len(got) == 2 and _stalls("dead_test") == 1
    assert [e["cause"] for e in events().snapshot()
            if e["kind"] == EV_LOADER_STALL] == ["producer_died"]


def pytest_producer_exception_reaches_the_consumer(graphs):
    loader = _loader(_Fetch(graphs, at=14, fail=True), graphs, "error_test")
    with pytest.raises(OSError, match="sample 14"):
        list(loader)
    loader._producer_thread.join(5.0)
    assert not loader._producer_thread.is_alive() and _stalls("error_test") == 0


def pytest_abandoned_epoch_reaps_or_warns(graphs, monkeypatch):
    loader = _loader(graphs, graphs, "break_test")
    for _ in loader:
        break
    assert not loader._producer_thread.is_alive()
    # a producer blocked in a fetch past the join's bound is left with a warning
    monkeypatch.setattr(pipeline, "_PRODUCER_JOIN_TIMEOUT_S", 0.2)
    ds = _Fetch(graphs, at=6, seconds=5.0)
    loader = _loader(ds, graphs, "leak_test", stall_timeout=0)
    with pytest.warns(RuntimeWarning, match="leaking the daemon thread"):
        it = iter(loader)
        next(it)
        time.sleep(0.2)
        it.close()
    ds.release.set()
    loader._producer_thread.join(5.0)
    assert not loader._producer_thread.is_alive()


def pytest_prefetch_depth_gauge_is_published(graphs):
    list(_loader(graphs, graphs, "gauge_test"))
    depth = registry().get("hydragnn_loader_prefetch_depth").value(source="gauge_test")
    assert 0.0 <= depth <= 2.0


# -- device staging on the CPU --------------------------------------------------------


def _staging_threads():
    return [t for t in threading.enumerate() if t.name == "device-prefetch" and t.is_alive()]


def pytest_device_prefetch_order_errors_and_close(graphs):
    hosts = list(GraphLoader(graphs, 6, num_buckets=2))
    got = list(loop.device_prefetch(iter(hosts), depth=2, device="cpu"))
    assert len(got) == len(hosts)
    assert all(_same(a, b) and a.host is b for a, b in zip(got, hosts))

    def failing():
        yield hosts[0]
        raise OSError("the loader failed")

    with pytest.raises(OSError, match="the loader failed"):
        list(loop.device_prefetch(failing(), depth=2, device="cpu"))
    gen = loop.device_prefetch(iter(hosts), depth=1, device="cpu")
    next(gen)
    gen.close()
    time.sleep(0.05)
    assert not _staging_threads()


@pytest.mark.parametrize("double_buffer,env,depth", [
    (True, None, 2), (False, None, 0), (3, None, 3), (0, None, 0),
    (True, "0", 0), (False, "4", 4), (3, "1", 1),
])
def pytest_double_buffer_maps_to_a_depth_as_jax(double_buffer, env, depth, monkeypatch):
    """``Training.double_buffer`` to the staging depth (true 2, false 0, an
    int itself), ``HYDRAGNN_DEVICE_PREFETCH`` winning, published in
    ``hydragnn_device_prefetch_depth``; the distributed step stages
    nothing."""
    if env is None:
        monkeypatch.delenv("HYDRAGNN_DEVICE_PREFETCH", raising=False)
    else:
        monkeypatch.setenv("HYDRAGNN_DEVICE_PREFETCH", env)
    want = loop.prefetch_depth_of({"double_buffer": double_buffer})
    # the JAX loop's mapping (hydragnn_tpu/train/loop.py train_validate_test)
    assert want == (0 if not double_buffer else (2 if double_buffer is True
                                                 else int(double_buffer)))
    source = iter([])
    it = loop._maybe_device_prefetch(source, want, "cpu")
    gauge = registry().get("hydragnn_device_prefetch_depth")
    assert gauge.value() == depth
    assert (it is source) == (depth == 0)
    assert loop._maybe_device_prefetch(source, want, "cpu", distributed=True) is source
    assert gauge.value() == 0


def _run_config(double_buffer):
    config = _config(double_buffer=double_buffer, num_epoch=2)
    config["NeuralNetwork"]["Training"]["EarlyStopping"] = False
    return config


def pytest_run_training_equal_with_staging_on_and_off(splits, tmp_path, monkeypatch):
    """``run_training`` on the CPU with ``double_buffer`` true and the
    loader's prefetch at 2, against both off: the same history and every
    state tensor bit for bit; the gauge follows the key."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("HYDRAGNN_DEVICE_PREFETCH", raising=False)
    runs = {}
    for db, workers in ((True, "2"), (False, "0")):
        monkeypatch.setenv("HYDRAGNN_NUM_WORKERS", workers)
        _, state, hist = run_training(copy.deepcopy(_run_config(db)), datasets=splits,
                                      device="cpu")
        runs[db] = (hist, [t.detach().clone() for t in state.held])
        assert registry().get("hydragnn_device_prefetch_depth").value() == (2 if db else 0)
    assert runs[True][0] == runs[False][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1], runs[False][1]))
    assert np.isfinite(runs[True][0]["train"]).all()


def pytest_run_training_wires_the_stall_timeout_and_prefetch(splits, tmp_path, monkeypatch):
    """``api.prepare_data`` gives every loader ``Training.loader_stall_timeout``
    and the train loader ``HYDRAGNN_NUM_WORKERS`` (default 2) batches of
    prefetch, as the JAX package does."""
    from hydragnn_tpu_torch.api import prepare_data

    monkeypatch.delenv("HYDRAGNN_NUM_WORKERS", raising=False)
    _, loaders, _ = prepare_data(_config(loader_stall_timeout=7.5), splits)
    assert [l.stall_timeout for l in loaders] == [7.5, 7.5, 7.5]
    assert [l.prefetch for l in loaders] == [2, 0, 0]
    monkeypatch.setenv("HYDRAGNN_NUM_WORKERS", "0")
    assert prepare_data(_config(), splits)[1][0].prefetch == 0
