"""The port's native C++ (``hydragnn_tpu_torch/native``, built with ``g++`` at
first use) against the JAX package's, on the CPU.

- The cell-list neighbor builder: the same edges in the same order as the
  JAX package's native route on the same positions; the KD-tree route
  (``HYDRAGNN_NATIVE_NEIGHBORS=0``) the JAX package's KD-tree edges; the
  two routes the same edge set; ``_NATIVE_MIN_N`` switches routes; a
  failed build raises with the compiler's output.
- The shared-memory sample store: a blob round trip, a full store and an
  out-of-range id, ``DistDataset`` attached from another process, a remote
  get through the TCP plane from another process, ``MultiHostDistDataset``
  across two "hosts" on this one, a corrupt blob raising
  ``CorruptSampleError``, and a ``DistDataset`` feeding ``GraphLoader``
  with prefetch: the list-backed loader's batches bit for bit. Every
  store's POSIX name carries this process's id (the tests run in several
  processes) and is unlinked at the end.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from hydragnn_tpu.data import neighbors as j_neighbors
from hydragnn_tpu_torch.data import (
    CorruptSampleError,
    DDStore,
    DistDataset,
    GraphLoader,
    MultiHostDistDataset,
    RemoteStoreClient,
    deterministic_graph_dataset,
    oc20_shaped_dataset,
)
from hydragnn_tpu_torch.data import neighbors as t_neighbors
from hydragnn_tpu_torch.native import build as t_build
from test_torch_data import _assert_graphs_equal

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _name(tag: str) -> str:
    return f"/pt_dds_{os.getpid()}_{tag}"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- the cell-list neighbor builder -------------------------------------------------


@pytest.mark.parametrize("n,radius,seed", [(300, 1.5, 0), (5000, 2.0, 1), (4096, 0.9, 2)])
def pytest_native_neighbors_match_the_jax_native_route(n, radius, seed, monkeypatch):
    pos = np.random.default_rng(seed).uniform(0.0, (n / 0.3) ** (1 / 3), (n, 3))
    monkeypatch.setenv("HYDRAGNN_NATIVE_NEIGHBORS", "1")
    ts, tr = t_neighbors.radius_graph(pos, radius)
    js, jr = j_neighbors.radius_graph(pos, radius)
    assert ts.dtype == js.dtype == np.int32 and ts.size > 0
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tr, jr)
    # the KD-tree route: the JAX package's KD-tree edges, and the same set
    monkeypatch.setenv("HYDRAGNN_NATIVE_NEIGHBORS", "0")
    ks, kr = t_neighbors.radius_graph(pos, radius)
    jks, jkr = j_neighbors.radius_graph(pos, radius)
    np.testing.assert_array_equal(ks, jks)
    np.testing.assert_array_equal(kr, jkr)
    assert set(zip(ks.tolist(), kr.tolist())) == set(zip(ts.tolist(), tr.tolist()))


def pytest_native_route_taken_from_the_threshold(monkeypatch):
    monkeypatch.delenv("HYDRAGNN_NATIVE_NEIGHBORS", raising=False)
    calls = []
    real = t_neighbors._radius_graph_native
    monkeypatch.setattr(t_neighbors, "_radius_graph_native",
                        lambda pos, r: calls.append(len(pos)) or real(pos, r))
    rng = np.random.default_rng(3)
    for n in (t_neighbors._NATIVE_MIN_N - 1, t_neighbors._NATIVE_MIN_N):
        s, r = t_neighbors.radius_graph(rng.uniform(0, 25, (n, 3)), 1.0, max_neighbours=6)
        assert np.bincount(r, minlength=n).max() <= 6
    assert calls == [t_neighbors._NATIVE_MIN_N]


def pytest_failed_native_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int main( {\n")
    monkeypatch.setattr(t_build, "HERE", tmp_path)
    monkeypatch.setattr(t_build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build the native 'broken'"):
        t_build.build_library("broken")
    with pytest.raises(RuntimeError, match="no native source"):
        t_build.build_library("missing")


def pytest_native_library_keyed_by_the_source(tmp_path, monkeypatch):
    src = tmp_path / "tiny.cpp"
    src.write_text('extern "C" int tiny() { return 1; }\n')
    monkeypatch.setattr(t_build, "HERE", tmp_path)
    monkeypatch.setattr(t_build, "BUILD_DIR", tmp_path / "out")
    first = t_build.build_library("tiny")
    assert t_build.build_library("tiny") == first
    src.write_text('extern "C" int tiny() { return 2; }\n')
    second = t_build.build_library("tiny")
    assert second != first and os.path.exists(first) and os.path.exists(second)
    import ctypes

    assert ctypes.CDLL(second).tiny() == 2


# -- the sample store -----------------------------------------------------------------


def pytest_ddstore_blob_roundtrip():
    store = DDStore(_name("blob"), capacity_bytes=1 << 20, max_items=64, overwrite=True)
    try:
        store.put(3, b"hello")
        store.put(7, b"world-longer-blob")
        assert store.get(3) == b"hello" and store.get(7) == b"world-longer-blob"
        assert len(store) == 2 and store.used_bytes == 5 + 17
        with pytest.raises(KeyError):
            store.get(99)
        with pytest.raises(KeyError, match="already stored"):
            store.put(3, b"again")
        store.epoch_begin()
        store.epoch_end()
    finally:
        store.close()


def pytest_ddstore_full_and_out_of_range():
    store = DDStore(_name("full"), capacity_bytes=64, max_items=4, overwrite=True)
    try:
        with pytest.raises(MemoryError):
            store.put(0, b"x" * 128)
        with pytest.raises(IndexError):
            store.put(4, b"x")
        with pytest.raises(FileExistsError):
            DDStore(_name("full"), capacity_bytes=64, max_items=4)
    finally:
        store.close()


_ATTACH = r"""
import sys
sys.path.insert(0, {repo!r})
from hydragnn_tpu_torch.data import DistDataset
ds = DistDataset(name={name!r}, populate=False, attach_timeout_s=30)
g = ds[2]
print("CHILD-OK", len(ds), g.num_nodes, int(g.senders.sum()), flush=True)
ds.close(unlink=False)
"""


def pytest_distdataset_attached_from_another_process():
    graphs = deterministic_graph_dataset(6, seed=9)
    name = _name("xproc")
    ds = DistDataset(graphs, name=name, capacity_bytes=1 << 22, overwrite=True)
    try:
        assert len(ds) == 6
        _assert_graphs_equal([graphs[2]], [ds[2]])
        out = subprocess.run([sys.executable, "-c", _ATTACH.format(repo=REPO, name=name)],
                             capture_output=True, text=True, timeout=120)
        want = f"CHILD-OK 6 {graphs[2].num_nodes} {int(graphs[2].senders.sum())}"
        assert want in out.stdout, (out.stdout, out.stderr)
    finally:
        ds.close(unlink=True)


_REMOTE = r"""
import sys
sys.path.insert(0, {repo!r})
from hydragnn_tpu_torch.data import RemoteStoreClient
c = RemoteStoreClient("127.0.0.1", {port}, retry_base=0.0, timeout_s=10.0)
a, b = c.get(100), c.get(101)
try:
    c.get(105)
    missing = "no"
except KeyError:
    missing = "yes"
print("CHILD-OK", a.decode(), len(b), missing, flush=True)
c.close()
"""


def pytest_remote_get_from_another_process():
    """A store serving its slots (wire ids offset by 100) answers another
    process's gets and its missing id; a client whose server went away
    retries on fresh connections, then raises naming the store."""
    port = _free_port()
    store = DDStore(_name("serve"), max_items=8, overwrite=True)
    try:
        store.put(0, b"alpha")
        store.put(1, b"beta" * 1000)
        store.serve(port, id_offset=100)
        out = subprocess.run([sys.executable, "-c", _REMOTE.format(repo=REPO, port=port)],
                             capture_output=True, text=True, timeout=120)
        assert "CHILD-OK alpha 4000 yes" in out.stdout, (out.stdout, out.stderr)
        with pytest.raises(RuntimeError, match="already serving"):
            store.serve(port)
        client = RemoteStoreClient("127.0.0.1", port, retries=2, retry_base=0.0, timeout_s=2.0)
        assert client.get(100) == b"alpha"
    finally:
        store.close()
    with pytest.raises(ConnectionError, match="unreachable fetching global_id 100 after 2"):
        client.get(100)
    client.close()


def pytest_remote_client_refused_connection():
    with pytest.raises(ConnectionError, match="cannot connect"):
        RemoteStoreClient("127.0.0.1", _free_port(), retries=1, retry_base=0.0, timeout_s=1.0)


def pytest_multihost_distdataset_over_two_hosts_on_one():
    graphs = deterministic_graph_dataset(9, seed=4)
    ports = [_free_port(), _free_port()]
    hosts = [("127.0.0.1", p) for p in ports]
    block = 5  # ceil(9 / 2)
    a = MultiHostDistDataset(graphs[:block], 9, hosts, 0, name=_name("mh0"), overwrite=True)
    b = MultiHostDistDataset(graphs[block:], 9, hosts, 1, name=_name("mh1"), overwrite=True)
    try:
        for ds in (a, b):
            assert len(ds) == 9
            _assert_graphs_equal(graphs, [ds[i] for i in range(9)])
            _assert_graphs_equal([graphs[-1]], [ds[-1]])
            with pytest.raises(IndexError):
                ds[9]
        with pytest.raises(ValueError, match="owns global ids"):
            MultiHostDistDataset(graphs[:3], 9, hosts, 0, name=_name("mh2"), overwrite=True)
    finally:
        a.close()
        b.close()


def pytest_corrupt_blob_raises_corrupt_sample_error():
    graphs = deterministic_graph_dataset(3, seed=2)
    name = _name("corrupt")
    ds = DistDataset(graphs, name=name, capacity_bytes=1 << 22, max_items=16,
                     overwrite=True)
    try:
        ds.store.put(5, b"\x00not a pickle")
        with pytest.raises(CorruptSampleError, match=f"sample 5 from shared-memory store"):
            ds.get(5)
    finally:
        ds.close(unlink=True)


@pytest.mark.parametrize("prefetch", [0, 2])
def pytest_distdataset_feeds_the_loader_like_a_list(prefetch):
    graphs = oc20_shaped_dataset(30, mean_atoms=14, min_atoms=6, max_atoms=30, max_neighbours=8)
    ds = DistDataset(graphs, name=_name(f"loader{prefetch}"), capacity_bytes=1 << 24,
                     overwrite=True)
    try:
        for kw in (dict(num_buckets=2, sort_edges=True), dict(pack=True)):
            want = list(GraphLoader(graphs, 4, seed=3, **kw))
            got = list(GraphLoader(ds, 4, seed=3, prefetch=prefetch, **kw))
            assert len(got) == len(want) > 1
            for a, b in zip(want, got):
                for f in ("x", "pos", "senders", "receivers", "node_mask", "edge_mask",
                          "graph_mask", "node_graph"):
                    assert torch.equal(getattr(a, f), getattr(b, f)), f
    finally:
        ds.close(unlink=True)
