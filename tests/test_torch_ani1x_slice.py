"""The slice as a whole on the ANI-1x recipe (examples/ani1_x/ani1x_forces.json,
narrowed to hidden 8 and 2 conv layers), the port against the JAX package
on the CPU: the data made by each package's ``ani1x_shaped_dataset`` (the
same bytes) and written by the JAX package's ``ColumnarWriter``; both
packages' ``prepare_data`` from the JSON alone give the same completed
config and the same batches; one train step from the JAX weights
(``bridge.load_jax_variables``) gives the same loss to ``LOSS_RTOL``, with
the port's loader prefetching and the step fed by ``device_prefetch``
(the CPU route of the device staging); the JAX side runs its Pallas
segment route in interpret mode."""

import copy
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hydragnn_tpu.api import prepare_data as j_prepare
from hydragnn_tpu.data import ColumnarWriter as JColumnarWriter
from hydragnn_tpu.data import ani1x_shaped_dataset as j_ani1x
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.train import TrainState as JState
from hydragnn_tpu.train import make_optimizer as j_make_optimizer
from hydragnn_tpu.train import make_train_step as j_make_train_step
from hydragnn_tpu_torch.api import prepare_data as t_prepare
from hydragnn_tpu_torch.bridge import load_jax_variables
from hydragnn_tpu_torch.data import ani1x_shaped_dataset as t_ani1x
from hydragnn_tpu_torch.models import create_model as t_create
from hydragnn_tpu_torch.train import TrainState, make_optimizer, make_train_step
from hydragnn_tpu_torch.train.loop import device_prefetch
from test_torch_data import _assert_batch_equal, _assert_graphs_equal
from test_torch_prepare_data import _narrow, _same_keys
from test_torch_train import LOSS_RTOL, _jax_variables

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
ANI1X_GRAPHS = 40


@pytest.fixture
def ani1x_config(tmp_path, monkeypatch):
    monkeypatch.setenv("HYDRAGNN_PALLAS_SEGMENT", "1")
    config = _narrow(json.loads((REPO / "examples/ani1_x/ani1x_forces.json").read_text()))
    arch = config["NeuralNetwork"]["Architecture"]
    graphs = j_ani1x(number_configurations=ANI1X_GRAPHS, radius=arch["radius"],
                     max_neighbours=arch["max_neighbours"])
    _assert_graphs_equal(graphs, t_ani1x(number_configurations=ANI1X_GRAPHS,
                                         radius=arch["radius"],
                                         max_neighbours=arch["max_neighbours"]))
    path = tmp_path / "ani1x_columnar"
    JColumnarWriter(str(path)).add(graphs).save()
    config["Dataset"]["path"]["total"] = str(path)
    arch["use_sorted_aggregation"] = True
    return config


def pytest_ani1x_slice_matches_jax(ani1x_config, monkeypatch):
    monkeypatch.setenv("HYDRAGNN_NUM_WORKERS", "2")
    jc, (jtl, _, _), _ = j_prepare(copy.deepcopy(ani1x_config))
    tc, (ttl, _, _), _ = t_prepare(copy.deepcopy(ani1x_config))
    _same_keys(tc, jc)
    arch = tc["NeuralNetwork"]["Architecture"]
    assert (arch["mpnn_type"], arch["hidden_dim"], arch["num_conv_layers"]) == ("EGNN", 8, 2)
    assert arch["use_fused_edge_kernel"] and ttl.prefetch == 2
    jb, tb = list(jtl), list(ttl)
    assert len(jb) == len(tb) > 1
    for a, b in zip(jb, tb):
        _assert_batch_equal(a, b)
    jm = j_create(jc)
    v = _jax_variables(jm, jb[0])
    tx = j_make_optimizer(jc["NeuralNetwork"]["Training"]["Optimizer"])
    js = JState.create(jax.tree_util.tree_map(jax.numpy.asarray, v), tx)
    _, jloss, _ = j_make_train_step(jm, tx, guard=True)(js, jb[0], jax.random.PRNGKey(0))
    tm = t_create(tc, device="cpu")
    load_jax_variables(tm, v)
    ts = TrainState.create(tm, make_optimizer(tm, tc["NeuralNetwork"]["Training"]["Optimizer"]))
    staged = next(device_prefetch(iter(tb), depth=2, device="cpu"))
    _, tloss, _ = make_train_step(tm)(ts, staged)
    assert np.isfinite(float(jloss))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
