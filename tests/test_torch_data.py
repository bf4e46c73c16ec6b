"""The port's host data plane against the JAX package: the same seed and
settings must give byte-identical arrays (generators, radius graphs, padded
batches, pad specs, packed and laddered loaders, splits, normalization) and
the same completed config."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import hydragnn_tpu.config as jcfg
import hydragnn_tpu.data as jdata
from hydragnn_tpu.data import graph as jgraph
from hydragnn_tpu.data import pipeline as jpipe
import hydragnn_tpu_torch.config as tcfg
import hydragnn_tpu_torch.data as tdata
from hydragnn_tpu_torch.data import graph as tgraph
from hydragnn_tpu_torch.data import pipeline as tpipe

torch.set_num_threads(2)

_SMALL_OC20 = dict(mean_atoms=20, min_atoms=10, max_atoms=40, max_neighbours=10)


def _assert_graphs_equal(a_list, b_list):
    assert len(a_list) == len(b_list)
    for a, b in zip(a_list, b_list):
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, dict) or isinstance(vb, dict):
                assert (va or {}).keys() == (vb or {}).keys()
                for k in va or {}:
                    np.testing.assert_array_equal(va[k], vb[k])
                    assert np.asarray(va[k]).dtype == np.asarray(vb[k]).dtype
            elif va is None or vb is None:
                assert va is None and vb is None, f.name
            elif isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb)
                assert va.dtype == vb.dtype, f.name
            else:
                assert va == vb, f.name


def _assert_batch_equal(jb, tb):
    """A JAX GraphBatch and a port GraphBatch hold the same arrays (index
    fields widen to int64 in the port)."""
    for f in ("x", "pos", "node_graph", "node_mask", "senders", "receivers",
              "edge_mask", "graph_mask", "dataset_id", "z"):
        a, b = getattr(jb, f), getattr(tb, f)
        if a is None:
            assert b is None
            continue
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for table in ("graph_targets", "node_targets"):
        ja, ta = getattr(jb, table), getattr(tb, table)
        assert ja.keys() == ta.keys()
        for k in ja:
            np.testing.assert_array_equal(np.asarray(ja[k]), ta[k].numpy())


def pytest_oc20_shaped_dataset_identical():
    _assert_graphs_equal(jdata.oc20_shaped_dataset(12, **_SMALL_OC20),
                         tdata.oc20_shaped_dataset(12, **_SMALL_OC20))


def pytest_oc20_shaped_dataset_identical_at_default_shape():
    _assert_graphs_equal(jdata.oc20_shaped_dataset(3), tdata.oc20_shaped_dataset(3))


def pytest_deterministic_graph_dataset_identical():
    _assert_graphs_equal(jdata.deterministic_graph_dataset(10),
                         tdata.deterministic_graph_dataset(10))
    _assert_graphs_equal(jdata.deterministic_graph_dataset(4, linear_only=True),
                         tdata.deterministic_graph_dataset(4, linear_only=True))


@pytest.mark.parametrize("max_neighbours,loop", [(None, False), (5, False), (8, True)])
def pytest_radius_graph_identical(max_neighbours, loop):
    pos = np.random.default_rng(1).uniform(0, 6, size=(60, 3))
    from hydragnn_tpu.data.neighbors import radius_graph as jr
    from hydragnn_tpu_torch.data.neighbors import radius_graph as tr

    for a, b in zip(jr(pos, 2.5, max_neighbours, loop), tr(pos, 2.5, max_neighbours, loop)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("sort_edges", [False, True])
def pytest_batch_graphs_np_identical(sort_edges):
    graphs = tdata.oc20_shaped_dataset(6, **_SMALL_OC20)
    spec_args = dict(n_nodes=256, n_edges=2048, n_graphs=7)
    a = jgraph.batch_graphs_np(graphs, jgraph.PadSpec(**spec_args), sort_edges=sort_edges)
    b = tgraph.batch_graphs_np(graphs, tgraph.PadSpec(**spec_args), sort_edges=sort_edges)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype, k
    if sort_edges:
        assert np.all(np.diff(b["receivers"]) >= 0)
        assert b["receivers"][-1] == spec_args["n_nodes"] - 1


def pytest_pad_specs_and_ladders_identical():
    graphs = tdata.oc20_shaped_dataset(40, **_SMALL_OC20)
    assert (dataclasses.astuple(jpipe._pack_spec(graphs, 8))
            == dataclasses.astuple(tpipe._pack_spec(graphs, 8)))
    jl = jgraph.SpecLadder.for_dataset(graphs, 8, num_buckets=4)
    tl = tgraph.SpecLadder.for_dataset(graphs, 8, num_buckets=4)
    assert [dataclasses.astuple(s) for s in jl.specs] == [dataclasses.astuple(s) for s in tl.specs]
    sel = graphs[:5]
    assert dataclasses.astuple(jl.select_for(sel)) == dataclasses.astuple(tl.select_for(sel))


@pytest.mark.parametrize("pack,num_buckets", [(True, 1), (False, 3)])
def pytest_graph_loader_batches_identical(pack, num_buckets):
    graphs = tdata.oc20_shaped_dataset(30, **_SMALL_OC20)
    kw = dict(seed=3, sort_edges=True, pack=pack, num_buckets=num_buckets, shuffle=True)
    jl = jdata.GraphLoader(graphs, 6, **kw)
    tl = tdata.GraphLoader(graphs, 6, **kw)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jbs, tbs = list(jl), list(tl)
        assert len(jbs) == len(tbs) == len(tl) > 1
        for jb, tb in zip(jbs, tbs):
            _assert_batch_equal(jb, tb)
    jt = jl.spec_template_batches()
    tt = tl.spec_template_batches()
    assert [dataclasses.astuple(s) for s, _ in jt] == [dataclasses.astuple(s) for s, _ in tt]
    for (_, jb), (_, tb) in zip(jt, tt):
        _assert_batch_equal(jb, tb)


def pytest_loader_rejects_graphs_over_the_degree_bound():
    graphs = tdata.oc20_shaped_dataset(4, **_SMALL_OC20)
    with pytest.raises(ValueError, match="max_in_degree"):
        tdata.GraphLoader(graphs, 2, sort_edges=True, max_in_degree=1)


def pytest_split_minmax_and_variables_identical():
    raw = jdata.deterministic_graph_dataset(20)
    voi_args = dict(input_node_features=[0], output_names=["y", "n"],
                    output_types=["graph", "node"], output_index=[0, 1],
                    node_feature_dims=[1, 1, 1], graph_feature_dims=[1])
    jmm = jpipe.MinMax.fit(raw)
    tmm = tpipe.MinMax.fit(raw)
    jready = [jpipe.extract_variables(g, jpipe.VariablesOfInterest(**voi_args))
              for g in jmm.apply(raw)]
    tready = [tpipe.extract_variables(g, tpipe.VariablesOfInterest(**voi_args))
              for g in tmm.apply(raw)]
    _assert_graphs_equal(jready, tready)
    for a, b in zip(jpipe.split_dataset(jready, 0.6, seed=4),
                    tpipe.split_dataset(tready, 0.6, seed=4)):
        _assert_graphs_equal(a, b)


def _egnn_config():
    return {
        "Dataset": {"node_features": {"dim": [1, 3, 3]}, "graph_features": {"dim": [1]}},
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "EGNN", "equivariance": True, "radius": 5.0,
                "max_neighbours": 10, "hidden_dim": 16, "num_conv_layers": 3,
                "use_sorted_aggregation": True, "task_weights": [1.0, 1.0],
                "output_heads": {
                    "graph": {"num_sharedlayers": 2, "dim_sharedlayers": 8,
                              "num_headlayers": 2, "dim_headlayers": [12, 12]},
                    "node": {"num_headlayers": 2, "dim_headlayers": [12, 12],
                             "type": "mlp"},
                },
            },
            "Variables_of_interest": {
                "input_node_features": [0, 1], "output_names": ["energy", "forces"],
                "output_index": [0, 2], "type": ["graph", "node"],
            },
            "Training": {"batch_size": 4},
        },
    }


_DERIVED = ("output_dim", "output_type", "input_dim", "num_nodes", "max_in_degree",
            "use_sorted_aggregation", "use_fused_edge_kernel", "graph_size_variable",
            "max_nodes_per_graph")


def pytest_update_config_derives_the_same_keys():
    graphs = tdata.oc20_shaped_dataset(12, **_SMALL_OC20)
    splits = tpipe.split_dataset(graphs, 0.75, seed=0)
    for explicit_fused in (None, False):
        c = _egnn_config()
        if explicit_fused is not None:
            c["NeuralNetwork"]["Architecture"]["use_fused_edge_kernel"] = explicit_fused
        ja = jcfg.update_config(copy.deepcopy(c), *splits)["NeuralNetwork"]
        ta = tcfg.update_config(copy.deepcopy(c), *splits)["NeuralNetwork"]
        for k in _DERIVED:
            assert ja["Architecture"][k] == ta["Architecture"][k], k
        assert ja["Training"]["num_pad_buckets"] == ta["Training"]["num_pad_buckets"]
    assert jcfg.get_log_name_config(jcfg.update_config(_egnn_config(), *splits)) == \
        tcfg.get_log_name_config(tcfg.update_config(_egnn_config(), *splits))


def pytest_update_config_refuses_stale_bounds_and_fused_without_sorted():
    graphs = tdata.oc20_shaped_dataset(8, **_SMALL_OC20)
    splits = tpipe.split_dataset(graphs, 0.75, seed=0)
    stale = _egnn_config()
    stale["NeuralNetwork"]["Architecture"]["max_in_degree"] = 2
    with pytest.raises(ValueError, match="below the dataset's actual"):
        tcfg.update_config(stale, *splits)
    bad = _egnn_config()
    bad["NeuralNetwork"]["Architecture"].update(use_sorted_aggregation=False,
                                                use_fused_edge_kernel=True)
    with pytest.raises(ValueError, match="use_sorted_aggregation"):
        tcfg.update_config(bad, *splits)
