"""The port's on-disk datasets against the JAX package's, on the CPU: the
per-sample pickle store and the sharded columnar format, each written by
one package and read by the other, in both directions. The graphs must be
equal field by field, bit for bit (dtypes too): pickle with and without
``use_subdir``, columnar in each of its three read modes over two shards
with string columns and attributes, whose files are byte-identical."""

import dataclasses
import filecmp
import io
import os
import pickle

import numpy as np
import pytest
import torch

from hydragnn_tpu.data import columnar as jcol
from hydragnn_tpu.data import datasets as jds
from hydragnn_tpu_torch.data import columnar as tcol
from hydragnn_tpu_torch.data import datasets as tds
from hydragnn_tpu_torch.data import graph as tgraph
from hydragnn_tpu_torch.data import oc20_shaped_dataset
from test_torch_data import _assert_graphs_equal

torch.set_num_threads(2)


def _graphs(n=7, seed=5):
    """OC20-shaped graphs with every optional field a columnar shard can
    carry (edge attributes, shifts, PE, cell, graph and node targets), the
    dataset ids of two branches, drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for i, g in enumerate(oc20_shaped_dataset(n, mean_atoms=12, min_atoms=6, max_atoms=20,
                                              max_neighbours=6, seed=seed)):
        e, v = g.num_edges, g.num_nodes
        out.append(dataclasses.replace(
            g,
            edge_attr=rng.normal(size=(e, 2)).astype(np.float32),
            edge_shifts=rng.normal(size=(e, 3)).astype(np.float32),
            pe=rng.normal(size=(v, 3)).astype(np.float32),
            rel_pe=rng.normal(size=(e, 3)).astype(np.float32),
            z=rng.integers(1, 80, size=v).astype(np.int32),
            graph_y=rng.normal(size=2).astype(np.float32),
            cell=rng.normal(size=(3, 3)).astype(np.float32),
            dataset_id=i % 2,
        ))
    return out


@pytest.mark.parametrize("use_subdir", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def pytest_pickle_datasets_read_across_packages(tmp_path, writer, use_subdir):
    """A pickle dataset written by either package reads back in both, the
    same graphs bit for bit, with the header's min-max table."""
    graphs = _graphs()
    mm = {"x_min": [0.0], "x_max": [1.0]}
    write = jds.SimplePickleWriter if writer == "jax" else tds.SimplePickleWriter
    write(graphs, str(tmp_path), "set", minmax=mm, use_subdir=use_subdir)
    if use_subdir:
        assert os.path.isfile(tmp_path / "0" / "set-3.pkl")
    jset = jds.SimplePickleDataset(str(tmp_path), "set")
    tset = tds.SimplePickleDataset(str(tmp_path), "set")
    assert len(jset) == len(tset) == len(graphs)
    assert tset.minmax == jset.minmax == mm and tset.use_subdir == use_subdir
    got = list(tset)
    assert all(type(g) is tgraph.Graph for g in got)
    _assert_graphs_equal(graphs, got)
    _assert_graphs_equal(graphs, list(jset))


def pytest_pickle_reader_maps_the_jax_class_and_refuses_other_globals(tmp_path):
    """A sample pickled by the JAX package names its Graph class; the port's
    reader takes it as the port's Graph without importing anything, and
    refuses a pickle that names any other global."""
    g = _graphs(1)[0]
    from hydragnn_tpu.data.graph import Graph as JGraph

    blob = pickle.dumps(JGraph(**{f.name: getattr(g, f.name) for f in dataclasses.fields(g)}))
    assert b"hydragnn_tpu.data.graph" in blob
    back = tds.load_graph(io.BytesIO(blob))
    assert type(back) is tgraph.Graph
    _assert_graphs_equal([g], [back])
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        tds.load_graph(io.BytesIO(pickle.dumps(os.getcwd)))
    # the dataset-name table tags a sample of a known branch
    tds.SimplePickleWriter([dataclasses.replace(g, dataset_id=0)], str(tmp_path), "mptrj")
    assert tds.SimplePickleDataset(str(tmp_path), "mptrj")[0].dataset_id == \
        jds.SimplePickleDataset(str(tmp_path), "mptrj")[0].dataset_id == 2


def _write_columnar(mod, path, graphs, strings):
    """Two shards, each with a string column and attributes (``save``
    called twice: it is idempotent)."""
    halves = (graphs[:4], graphs[4:])
    for k, part in enumerate(halves):
        w = mod.ColumnarWriter(str(path), shard_index=k)
        w.add(part).add_string("smiles", strings[k * 4:k * 4 + len(part)])
        w.add_global("minmax", np.asarray([0.5, 2.0], np.float32))
        w.add_global("label", f"shard{k}")
        assert w.save() == w.save()  # idempotent


@pytest.mark.parametrize("mode", ["mmap", "preload", "shmem"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def pytest_columnar_datasets_read_across_packages(tmp_path, writer, mode):
    """A two-shard columnar dataset written by either package reads back in
    both, in each mode: the same graphs bit for bit, the same strings and
    attributes; the port's and the JAX package's shards are the same bytes."""
    graphs = _graphs()
    strings = [f"C{i}O{'=' * i}N ü" for i in range(len(graphs))]
    _write_columnar(jcol if writer == "jax" else tcol, tmp_path / "a", graphs, strings)
    _write_columnar(tcol if writer == "jax" else jcol, tmp_path / "b", graphs, strings)
    for shard in ("shard00000", "shard00001"):
        names = sorted(os.listdir(tmp_path / "a" / shard))
        assert names == sorted(os.listdir(tmp_path / "b" / shard))
        _, mismatch, errors = filecmp.cmpfiles(tmp_path / "a" / shard, tmp_path / "b" / shard,
                                               names, shallow=False)
        assert not mismatch and not errors
    jset = jcol.ColumnarDataset(str(tmp_path / "a"), mode=mode)
    tset = tcol.ColumnarDataset(str(tmp_path / "a"), mode=mode)
    try:
        assert len(tset) == len(jset) == len(graphs)
        got = list(tset)
        _assert_graphs_equal(graphs, got)
        _assert_graphs_equal(list(jset), got)
        _assert_graphs_equal([tset[-1]], [graphs[-1]])
        assert tset.string_columns() == jset.string_columns() == ["smiles"]
        assert [tset.get_string("smiles", i) for i in range(len(graphs))] == strings
        assert tset.attrs == jset.attrs == {"minmax": [0.5, 2.0], "label": "shard1"}
        with pytest.raises(KeyError, match="no string column"):
            tset.get_string("names", 0)
        with pytest.raises(IndexError):
            tset.get(len(graphs))
    finally:
        tset.close(unlink=True)
        jset.close(unlink=True)


def pytest_columnar_writer_refuses_inconsistent_samples(tmp_path):
    g = _graphs(2)
    w = tcol.ColumnarWriter(str(tmp_path))
    w.add(g[0])
    with pytest.raises(ValueError, match="inconsistent fields"):
        w.add(dataclasses.replace(g[1], cell=None))
    w.add_string("s", ["a", "b"])
    with pytest.raises(ValueError, match="string column"):
        w.save()
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no shards"):
        tcol.ColumnarDataset(str(tmp_path / "empty"))
    with pytest.raises(ValueError, match="mode"):
        tcol.ColumnarDataset(str(tmp_path), mode="disk")
