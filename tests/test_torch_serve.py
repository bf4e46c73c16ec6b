"""The port's serving slice on the CPU: ``GraphServer`` answers equal a
direct forward of the same graphs, ``run_server``/``run_prediction`` drive
the config path end to end, and admission errors are typed."""

import copy

import numpy as np
import pytest
import torch

from hydragnn_tpu_torch.api import prepare_data, run_prediction, run_server, run_training
from hydragnn_tpu_torch.data import (
    GraphLoader,
    PadSpec,
    batch_graphs,
    oc20_shaped_dataset,
    split_dataset,
)
from hydragnn_tpu_torch.data.graph import _round_up
from hydragnn_tpu_torch.models import create_model
from hydragnn_tpu_torch.serve import (
    ERROR_CODES,
    GraphServer,
    InvalidRequestError,
    ServeConfig,
    ServerClosedError,
    ServerDrainingError,
)

torch.set_num_threads(2)


def _config(pack=True, mixed_precision=False):
    return {
        "Dataset": {"node_features": {"dim": [1, 3, 3]}, "graph_features": {"dim": [1]}},
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "EGNN", "equivariance": True, "radius": 5.0,
                "max_neighbours": 10, "hidden_dim": 16, "num_conv_layers": 3,
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
            "Training": {"batch_size": 4, "pack_batches": pack,
                         "mixed_precision": mixed_precision, "num_pad_buckets": 3},
            "Serving": {"batch_window_s": 0.01},
        },
    }


def _graphs(n=20):
    return oc20_shaped_dataset(n, mean_atoms=20, min_atoms=10, max_atoms=40, max_neighbours=10)


def _direct(model, graphs):
    """One forward over all ``graphs`` at once, sliced per graph."""
    spec = PadSpec(n_nodes=_round_up(sum(g.num_nodes for g in graphs) + 1, 8),
                   n_edges=_round_up(sum(g.num_edges for g in graphs), 128),
                   n_graphs=len(graphs) + 1)
    with torch.no_grad():
        out = model(batch_graphs(graphs, spec, sort_edges=True))
    res, off = [], 0
    for i, g in enumerate(graphs):
        res.append({"energy": out["energy"][i].numpy(),
                    "forces": out["forces"][off:off + g.num_nodes].numpy()})
        off += g.num_nodes
    return res


@pytest.mark.parametrize("pack", [True, False])
def pytest_graph_server_answers_equal_a_direct_forward(pack):
    graphs = _graphs()
    config, (_, _, test_loader), _ = prepare_data(_config(pack), split_dataset(graphs, 0.5))
    model = create_model(config, device="cpu", seed=1)
    server = GraphServer(model, test_loader.ladder, ServeConfig.from_config(config),
                         template_graphs=test_loader.graphs, sort_edges=True, device="cpu")
    with server:
        assert server.wait_ready(timeout=120)
        requests = graphs[:8]
        results = server.predict(requests, timeout=120)
        stats = server.stats()
    assert stats["completed"] == 8 and stats["batches"] >= 2  # batch_size 4
    for got, want in zip(results, _direct(model, requests)):
        assert isinstance(got, dict), got
        for k in ("energy", "forces"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)


def pytest_handles_name_the_batch_that_answered_them():
    """``PredictionHandle.batch_index``: the served batches in order, each
    holding requests in submission order; rebuilding a batch from its
    requests at ``ladder.select_for`` gives the served answers exactly."""
    graphs = _graphs()
    config, (_, _, test_loader), _ = prepare_data(_config(False), split_dataset(graphs, 0.5))
    model = create_model(config, device="cpu", seed=1)
    server = GraphServer(model, test_loader.ladder, ServeConfig.from_config(config),
                         template_graphs=test_loader.graphs, sort_edges=True, device="cpu")
    with server:
        assert server.wait_ready(timeout=120)
        handles = [server.submit(g) for g in graphs[:8]]
        results = [h.result(timeout=120) for h in handles]
        batches = server.stats()["batches"]
    index = [h.batch_index for h in handles]
    assert index == sorted(index) and set(index) == set(range(batches))
    for b in range(batches):
        group = [g for g, i in zip(graphs, index) if i == b]
        assert 1 <= len(group) <= 4
        with torch.no_grad():
            out = model(batch_graphs(group, server.ladder.select_for(group), sort_edges=True))
        got = [r for r, i in zip(results, index) if i == b]
        off = 0
        for j, g in enumerate(group):
            np.testing.assert_array_equal(got[j]["energy"], out["energy"][j].numpy())
            np.testing.assert_array_equal(got[j]["forces"],
                                          out["forces"][off:off + g.num_nodes].numpy())
            off += g.num_nodes


def pytest_run_server_and_run_prediction_on_cpu(tmp_path, monkeypatch):
    """Both entry points restore the run's checkpoint from ``./logs`` (here
    written by one epoch of ``run_training``) and answer from it."""
    monkeypatch.chdir(tmp_path)
    graphs = _graphs()
    splits = split_dataset(graphs, 0.5)
    run_training(_config(), datasets=splits, device="cpu", seed=2)
    server = run_server(_config(mixed_precision=True), datasets=splits, device="cpu", seed=2)
    try:
        assert server.wait_ready(timeout=120)
        assert server.mixed_precision and server.stats()["warmed_specializations"] == 1
        assert server.stats()["current_checkpoint"].endswith("_epoch0.pt")
        handles = [server.submit(g) for g in graphs[:6]]
        for g, h in zip(graphs[:6], handles):
            r = h.result(timeout=120)
            assert r["energy"].shape == (1,) and r["forces"].shape == (g.num_nodes, 3)
            assert all(np.isfinite(v).all() for v in r.values())
            assert h.done_at >= h.submitted_at
    finally:
        server.close()
    assert server.stats()["closed"]
    tot, tasks, preds, trues = run_prediction(_config(), datasets=splits, device="cpu")
    assert np.isfinite(tot) and preds["forces"].shape == trues["forces"].shape


def pytest_admission_errors_are_typed():
    graphs = _graphs(12)
    config, (_, _, test_loader), _ = prepare_data(_config(), split_dataset(graphs, 0.5))
    model = create_model(config, device="cpu")
    server = GraphServer(model, test_loader.ladder, template_graphs=test_loader.graphs,
                         sort_edges=True, device="cpu").start()
    try:
        assert server.wait_ready(timeout=120)
        bad = copy.deepcopy(graphs[0])
        bad.pos[0, 0] = np.nan
        narrow = copy.deepcopy(graphs[1])
        narrow.x = narrow.x[:, :2]
        good, nan_err, chan_err = server.predict([graphs[2], bad, narrow], timeout=120)
        assert isinstance(good, dict)
        assert isinstance(nan_err, InvalidRequestError) and nan_err.reason == "nonfinite_features"
        assert isinstance(chan_err, InvalidRequestError) and chan_err.reason == "channel_mismatch"
        assert nan_err.request_id == 1 and ERROR_CODES[nan_err.code] is InvalidRequestError
        server.initiate_drain()
        with pytest.raises(ServerDrainingError):
            server.submit(graphs[3])
    finally:
        server.close()
    with pytest.raises(ServerClosedError):
        server.submit(graphs[3])


def pytest_serve_config_resolution():
    # every key of the JAX package's surface is consumed now; an unknown
    # (typo'd) key warns and is ignored
    with pytest.warns(UserWarning, match="not consumed"):
        cfg = ServeConfig.from_config({"Serving": {"hot_reload": True, "http_port": 0,
                                                   "step_timeout_s": 5.0, "hot_relaod": 1},
                                       "NeuralNetwork": {"Training": {"batch_size": 7}}})
    assert cfg.micro_batch_graphs == 7
    assert (cfg.http_port, cfg.step_timeout_s, cfg.hot_reload) == (0, 5.0, True)
    with pytest.raises(ValueError):
        ServeConfig(micro_batch_graphs=0)
    with pytest.raises(ValueError):
        ServeConfig(batch_window_s=-1.0)


def pytest_prepare_data_loads_the_config_or_takes_datasets():
    """With no datasets ``prepare_data`` loads the Dataset section's data
    (the synthetic format here) and returns its min-max table, the JAX
    package's; with explicit datasets it takes them as they are (no min-max
    table)."""
    from hydragnn_tpu.api import prepare_data as j_prepare

    c = _config()
    c["Dataset"] = {"format": "synthetic", "synthetic": {"number_configurations": 24},
                    "node_features": {"dim": [1, 1, 1]}, "graph_features": {"dim": [1]}}
    c["NeuralNetwork"]["Variables_of_interest"].update(input_node_features=[0],
                                                        output_index=[0, 1])
    config, loaders, mm = prepare_data(copy.deepcopy(c))
    _, jloaders, jmm = j_prepare(copy.deepcopy(c))
    assert [len(l.graphs) for l in loaders] == [len(l.graphs) for l in jloaders]
    assert sum(len(l.graphs) for l in loaders) == 24
    for f in ("x_min", "x_max", "y_min", "y_max"):
        np.testing.assert_array_equal(getattr(mm, f), getattr(jmm, f))
    assert config["NeuralNetwork"]["Architecture"]["input_dim"] == 1
    config, loaders, mm = prepare_data(_config(), split_dataset(_graphs(12), 0.5))
    assert mm is None and all(isinstance(l, GraphLoader) for l in loaders)
    assert all(l.sort_edges for l in loaders) and loaders[0].pack
