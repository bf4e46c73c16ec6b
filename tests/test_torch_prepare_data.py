"""``prepare_data``, ``run_training`` and ``run_prediction`` from the config
alone (no explicit datasets), the port against the JAX package on the CPU.

Each format of ``Dataset.format`` (``synthetic``, ``unit_test``,
``lennard_jones``, ``pickle``, ``columnar`` in its three modes, ``LSMS``
with and without stratified splitting, ``XYZ``, ``CFG`` with periodic
edges), on the committed example configs where the repo has one
(examples/synthetic, examples/LennardJones, examples/open_catalyst_2020,
examples/lsms), narrowed, with the data written first by the JAX
package's writers (numpy, from a seed): the completed config equals the JAX
package's on every key the port completes, the min-max table is equal, and
the three loaders give the same batches, array by array, exactly.

``run_training(config)`` on examples/synthetic (with SGD for its AdamW,
see ``synthetic_run``) from the JAX weights follows the JAX package's
``train_validate_test`` for 2 epochs (each epoch's train, val and test
loss to ``LOSS_RTOL``, as tests/test_torch_train.py) and writes its
completed config to the run directory; ``run_server(config)`` answers
as ``run_prediction(config)`` does, and ``run_prediction(config)`` under
``denormalize_output`` returns the JAX package's denormalized predictions
to ``LOSS_RTOL`` of the largest.
"""

import copy
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import chip_smoke
from hydragnn_tpu.api import prepare_data as j_prepare
from hydragnn_tpu.api import run_prediction as j_run_prediction
from hydragnn_tpu.data import ColumnarWriter as JColumnarWriter
from hydragnn_tpu.data import deterministic_graph_dataset as j_deterministic
from hydragnn_tpu.data import oc20_shaped_dataset as j_oc20
from hydragnn_tpu.data.datasets import SimplePickleWriter as JPickleWriter
from hydragnn_tpu.data.lsms import convert_total_energy_to_formation_gibbs as j_gibbs
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.train import TrainState as JState
from hydragnn_tpu.train import make_optimizer as j_make_optimizer
from hydragnn_tpu.train import make_train_step as j_make_train_step
from hydragnn_tpu.train.loop import make_eval_step as j_make_eval_step
from hydragnn_tpu.train.loop import train_validate_test as j_tvt
from hydragnn_tpu.train.state import InferenceState as JInference
from hydragnn_tpu_torch.api import prepare_data as t_prepare
from hydragnn_tpu_torch.api import run_prediction, run_server, run_training
from test_torch_data import _assert_batch_equal
from test_torch_raw import _write_cfg, _write_xyz
from test_torch_train import LOSS_RTOL, _jax_variables

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _example(name):
    return json.loads((REPO / "examples" / name).read_text())


def _narrow(config, hidden=8, layers=2, batch=8, heads=8):
    arch = config["NeuralNetwork"]["Architecture"]
    arch.update(hidden_dim=hidden, num_conv_layers=layers)
    for head in arch["output_heads"].values():
        head["dim_headlayers"] = [heads] * head["num_headlayers"]
        if "dim_sharedlayers" in head:
            head["dim_sharedlayers"] = heads
    config["NeuralNetwork"]["Training"].update(batch_size=batch, num_epoch=2)
    config["Verbosity"] = {"level": 0}
    return config


def _pna_raw_config(fmt, path, node_dims, graph_dims, periodic=False):
    """A narrow PNA config over raw files: node input column 0, a graph head
    on graph feature 0 and a node head on node feature 1."""
    return {
        "Verbosity": {"level": 0},
        "Dataset": {"name": "raw", "format": fmt, "path": {"total": str(path)},
                    "node_features": {"dim": node_dims}, "graph_features": {"dim": graph_dims}},
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "PNA", "radius": 3.5, "max_neighbours": 8, "hidden_dim": 8,
                "num_conv_layers": 2, "periodic_boundary_conditions": periodic,
                "task_weights": [1.0, 1.0],
                "output_heads": {"graph": {"num_sharedlayers": 1, "dim_sharedlayers": 4,
                                           "num_headlayers": 1, "dim_headlayers": [4]},
                                 "node": {"num_headlayers": 1, "dim_headlayers": [4],
                                          "type": "mlp"}}},
            "Variables_of_interest": {"input_node_features": [0],
                                      "output_names": ["g", "n"], "output_index": [0, 1],
                                      "type": ["graph", "node"]},
            "Training": {"batch_size": 4, "num_epoch": 2},
        },
    }


def _case(name, tmp):
    """One case's config, its data written under ``tmp`` by the JAX
    package's writers, so the port reads what the other package wrote."""
    if name in ("synthetic", "unit_test"):
        config = _narrow(_example("synthetic/synthetic.json"))
        config["Dataset"].update(format=name, synthetic={"number_configurations": 40})
        return config
    if name == "synthetic-gps":  # GPS's PE, through a cache in ``tmp``
        config = _narrow(_example("synthetic/synthetic.json"))
        config["Dataset"].update(synthetic={"number_configurations": 24},
                                 lappe_cache=str(tmp / "pe"))
        config["NeuralNetwork"]["Architecture"].update(
            global_attn_engine="GPS", global_attn_type="multihead", global_attn_heads=2,
            pe_dim=3)
        return config
    if name == "lennard_jones":
        config = _narrow(_example("LennardJones/LJ.json"))
        config["Dataset"]["lennard_jones"] = {"number_configurations": 12}
        return config
    if name == "pickle":
        config = _narrow(_example("synthetic/synthetic.json"))
        config["Dataset"].update(format="pickle", name="synth", path={"total": str(tmp)})
        JPickleWriter(j_deterministic(30, seed=5), str(tmp), "synth", use_subdir=True)
        return config
    if name.startswith("columnar"):
        config = _narrow(_example("open_catalyst_2020/open_catalyst_2020.json"), batch=4)
        config["Dataset"].update(path={"total": str(tmp)}, mode=name.split("-")[1])
        JColumnarWriter(str(tmp), 0).add(j_oc20(10, mean_atoms=12, min_atoms=6,
                                                 max_atoms=20, seed=3)).save()
        JColumnarWriter(str(tmp), 1).add(j_oc20(8, mean_atoms=12, min_atoms=6,
                                                max_atoms=20, seed=4)).save()
        return config
    if name.startswith("LSMS"):
        config = _narrow(_example("lsms/lsms.json"), batch=4)
        chip_smoke.write_lsms_raw(tmp / "FePt", 24, seed=6)
        config["Dataset"]["path"]["total"] = j_gibbs(str(tmp / "FePt"), [26.0, 78.0]).output_dir
        config["Dataset"]["compositional_stratified_splitting"] = name == "LSMS-stratified"
        return config
    if name == "XYZ":
        _write_xyz(tmp / "xyz", 14, seed=7)
        return _pna_raw_config("XYZ", tmp / "xyz", [1, 1, 1], [2])
    _write_cfg(tmp / "cfg", 12, seed=8)
    return _pna_raw_config("CFG", tmp / "cfg", [1, 1, 1], [1], periodic=True)


CASES = ["synthetic", "unit_test", "synthetic-gps", "lennard_jones", "pickle", "columnar-mmap",
         "columnar-preload", "columnar-shmem", "LSMS", "LSMS-stratified", "XYZ", "CFG"]


# Training keys the port writes into the completed config where the JAX
# package leaves them out and its consumers read them with these defaults
PORT_DEFAULTS = {"config.NeuralNetwork.Training.mixed_precision": False,
                 "config.NeuralNetwork.Training.warmup_epochs": 0,
                 "config.NeuralNetwork.Training.continue": False,
                 "config.NeuralNetwork.Training.startfrom": None}


def _same_keys(t, j, where="config"):
    """Every key of the port's completed config equals the JAX package's
    (or, where the JAX package leaves it out, its default there)."""
    if isinstance(t, dict):
        assert isinstance(j, dict), where
        for k, v in t.items():
            if k in j:
                _same_keys(v, j[k], f"{where}.{k}")
            else:
                assert PORT_DEFAULTS.get(f"{where}.{k}", "absent") == v, f"{where}.{k}"
    else:
        assert t == j, (where, t, j)


@pytest.mark.parametrize("name", CASES)
def pytest_prepare_data_from_the_config_matches_jax(tmp_path, name):
    config = _case(name, tmp_path)
    jc, jl, jmm = j_prepare(copy.deepcopy(config))
    tc, tl, tmm = t_prepare(copy.deepcopy(config))
    _same_keys(tc, jc)
    ef = config["NeuralNetwork"]["Training"].get("compute_grad_energy", False)
    assert (tmm is None) == (jmm is None) == ef
    if tmm is not None:
        for f in ("x_min", "x_max", "y_min", "y_max"):
            np.testing.assert_array_equal(getattr(tmm, f), getattr(jmm, f), err_msg=f)
        # the JAX table's node-head scale is the x scale, as the port takes it
        np.testing.assert_array_equal(jmm.node_y_min, tmm.x_min)
        np.testing.assert_array_equal(jmm.node_y_max, tmm.x_max)
    for split, (a, b) in enumerate(zip(jl, tl)):
        for epoch in (0, 1) if split == 0 else (0,):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            ja, tb = list(a), list(b)
            assert len(ja) == len(tb) > 0
            for x, y in zip(ja, tb):
                _assert_batch_equal(x, y)
    if name == "CFG":
        assert all(b.edge_shifts is not None for b in tl[0])
    if name == "synthetic-gps":  # one cache entry per topology, both packages
        assert all(b.pe is not None and b.rel_pe is not None for b in tl[0])
        assert 0 < len(list((tmp_path / "pe").glob("*/*.npy"))) <= 24
    if name.startswith("LSMS"):  # the charge density corrected to a net charge
        assert float(np.abs(tmm.x_max[1])) < 1.0


def pytest_bad_raw_file_follows_the_sample_policy(tmp_path):
    """A garbled LSMS file: skipped with a warning under ``warn_skip``,
    raised on under ``error``, in the port as in the JAX package."""
    config = _case("LSMS", tmp_path)
    bad = sorted(Path(config["Dataset"]["path"]["total"]).iterdir())[3]
    bad.write_text("-1.0 0.0\n26.0 0.0 1.0\n")
    with pytest.warns(UserWarning, match="skipping unparseable"):
        tc, tl, _ = t_prepare(copy.deepcopy(config))
    with pytest.warns(UserWarning, match="skipping unparseable"):
        jc, jl, _ = j_prepare(copy.deepcopy(config))
    assert sum(len(l.graphs) for l in tl) == sum(len(l.graphs) for l in jl) == 23
    config["Dataset"]["bad_sample_policy"] = "error"
    with pytest.raises(IndexError):
        t_prepare(copy.deepcopy(config))


def pytest_mixture_and_quarantine_still_raise():
    config = _case("synthetic", None)
    with pytest.raises(NotImplementedError, match="later slice"):
        t_prepare(dict(copy.deepcopy(config), Mixture={"temperature": 1.0}))
    config["Dataset"]["bad_sample_policy"] = "quarantine"
    with pytest.raises(NotImplementedError, match="later slice"):
        t_prepare(config)


@pytest.fixture(scope="module")
def synthetic_run(tmp_path_factory):
    """examples/synthetic narrowed, trained 2 epochs by the JAX package's
    ``train_validate_test`` from seeded weights: (config, the JAX weights,
    the JAX history, the JAX run's final variables)."""
    config = _case("synthetic", None)
    # SGD for the example's AdamW: the conv biases feed a batch norm, which
    # cancels their gradient, and AdamW turns its rounding noise into steps
    # of about the learning rate that move the running means (the eval
    # losses then part by 1e-4 between any two summation orders)
    config["NeuralNetwork"]["Training"].update(EarlyStopping=False,
                                               Optimizer={"type": "SGD", "learning_rate": 0.01})
    jc, (jtl, jvl, jtel), _ = j_prepare(copy.deepcopy(config))
    jm = j_create(jc)
    v = _jax_variables(jm, next(iter(jtl)))
    tx = j_make_optimizer(jc["NeuralNetwork"]["Training"]["Optimizer"])
    js, jhist = j_tvt(jm, JState.create(jax.tree_util.tree_map(np.asarray, v), tx), tx,
                      jtl, jvl, jtel, jc, step_fn=j_make_train_step(jm, tx, guard=True),
                      eval_fn=j_make_eval_step(jm))
    final = jax.tree_util.tree_map(np.asarray, jax.device_get(js.variables()))
    return config, v, jhist, final


def pytest_run_training_from_the_config_matches_jax(synthetic_run, tmp_path, monkeypatch):
    """``run_training`` from the JSON's path, no datasets, from the JAX
    weights: the JAX history; the completed config in the run directory;
    ``run_server`` from the same path answers the test split as
    ``run_prediction`` does (to ``LOSS_RTOL`` of the largest: the server
    batches the graphs its own way)."""
    monkeypatch.chdir(tmp_path)
    config, v, jhist, _ = synthetic_run
    path = tmp_path / "synthetic.json"
    path.write_text(json.dumps(config))
    _, state, hist = run_training(str(path), variables=v, device="cpu")
    for k in ("train", "val", "test"):
        np.testing.assert_allclose(hist[k], jhist[k], rtol=LOSS_RTOL)
    assert hist["lr"] == pytest.approx(jhist["lr"])
    tc, (tl, _, _), _ = t_prepare(copy.deepcopy(config))
    written = list((tmp_path / "logs").glob("*/config.json"))
    assert len(written) == 1 and json.loads(written[0].read_text()) == json.loads(json.dumps(tc))
    assert written[0].parent.name.startswith("PNA-r-2.0-ncl-2-hd-8-ne-2")
    # the server from the same JSON restores the run's checkpoint and
    # answers the test split as run_prediction does (in the model's
    # normalized units: the server does not denormalize)
    raw = copy.deepcopy(config)
    raw["NeuralNetwork"]["Variables_of_interest"]["denormalize_output"] = False
    _, _, preds, _ = run_prediction(raw, device="cpu")
    with run_server(str(path), device="cpu") as server:
        assert server.wait_ready(60) and server.stats()["current_checkpoint"]
        answers = server.predict(t_prepare(copy.deepcopy(config))[1][2].graphs)
    got = np.concatenate([a["sum_x_x2_x3"].reshape(-1) for a in answers])
    np.testing.assert_allclose(got, preds["sum_x_x2_x3"].reshape(-1), rtol=0,
                               atol=LOSS_RTOL * float(np.abs(preds["sum_x_x2_x3"]).max()))


def pytest_run_prediction_denormalizes_as_jax(synthetic_run, tmp_path, monkeypatch):
    """``run_prediction(config)`` under ``denormalize_output`` with the JAX
    run's final weights: the JAX package's denormalized predictions and
    targets (the test split's graph energies in the data's units), to
    ``LOSS_RTOL`` of the largest; the same without it, normalized."""
    monkeypatch.chdir(tmp_path)
    config, _, _, final = synthetic_run
    assert config["NeuralNetwork"]["Variables_of_interest"]["denormalize_output"]
    jvars = jax.tree_util.tree_map(jax.numpy.asarray, final)
    outs = {}
    for denorm in (True, False):
        c = copy.deepcopy(config)
        c["NeuralNetwork"]["Variables_of_interest"]["denormalize_output"] = denorm
        jtot, _, jpreds, jtrues = j_run_prediction(copy.deepcopy(c),
                                                   model_state=JInference.create(jvars))
        ttot, _, tpreds, ttrues = run_prediction(copy.deepcopy(c), variables=final,
                                                 device="cpu")
        np.testing.assert_allclose(ttot, jtot, rtol=LOSS_RTOL)
        for want, got in ((jpreds, tpreds), (jtrues, ttrues)):
            assert want.keys() == got.keys() == {"sum_x_x2_x3"}
            w, g = np.asarray(want["sum_x_x2_x3"]), got["sum_x_x2_x3"]
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=LOSS_RTOL * float(np.abs(w).max()))
        outs[denorm] = ttrues["sum_x_x2_x3"]
    # denormalized targets are the raw sums (> 1), normalized ones in [0, 1]
    assert float(outs[True].max()) > 1.0 >= float(outs[False].max())
    shutil.rmtree(tmp_path / "logs", ignore_errors=True)
