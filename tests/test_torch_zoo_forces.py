"""Energy-force objectives of the port's zoo against the JAX package, on the
CPU; the rotation equivariance of forces; GPS over SchNet.

- SchNet (also with ``equivariance: true``) and PAINN with
  ``compute_grad_energy`` (one node head of nodal energy, the atomic number
  as the only input, MAE): the loss and its parts, the forces ``-dE/dpos``
  and every parameter's gradient of one step (a double backward through
  K1's Function), against the JAX package's step with its Pallas route in
  interpret mode; SchNet's coordinate update (the first layer's updated
  positions) against the JAX layer's;
- the rotation equivariance of forces (tests/test_forces.py:88) for SchNet
  and PAINN on Lennard-Jones configurations, and the same energies and
  forces as the JAX package's ``predict_energy_forces``;
- GPS global attention over SchNet at the architecture of
  examples/zinc/zinc.json (multihead, PE 6, radius 7, 5 neighbours, 10
  Gaussians, 8 filters, 2 layers, graph head [50, 25] over a shared 2 x 5),
  narrowed to hidden 16 and 4 heads: outputs and one step's gradients.

Tolerances (f32, the same algorithm in another summation order): losses
1e-5 relative; forces and energies 1e-4 of the largest; gradients 1e-4 of
each parameter's largest, floored at 1e-3 of the largest anywhere (as
tests/test_torch_train.py); updated positions 1e-5 of the largest
displacement; rotated forces as tests/test_forces.py holds them (energies
1e-4, forces rtol 1e-3 and atol 1e-4). GPS over SchNet's gradients: 5e-4
on the same terms (``GPS_GRAD_RTOL``): the attention's query projection
and the node embeddings carry f32 rounding of 6e-5 of their largest
gradient (the port's f32 step against its own f64 step), so two f32
evaluations part by up to a few times that (2e-4 measured).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydragnn_tpu.config import update_config as j_update
from hydragnn_tpu.data import GraphLoader as JLoader
from hydragnn_tpu.data.graph import PadSpec as JPadSpec
from hydragnn_tpu.data.graph import batch_graphs as j_batch_graphs
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.train.loss import compute_loss as j_compute_loss
from hydragnn_tpu.train.loss import predict_energy_forces as j_predict_energy_forces
from hydragnn_tpu_torch.config import update_config as t_update
from hydragnn_tpu_torch.data import GraphLoader as TLoader
from hydragnn_tpu_torch.data import (
    add_dataset_pe,
    lennard_jones_dataset,
    oc20_shaped_dataset,
    split_dataset,
)
from hydragnn_tpu_torch.data.graph import PadSpec, batch_graphs
from hydragnn_tpu_torch.train import compute_loss, predict_energy_forces
from test_torch_egnn import _assert_close_real_rows
from test_torch_train import _assert_close, _flat
from test_torch_zoo import _jax_init, torch_model
from test_torch_zoo_grads import grads_of

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
FORCE_RTOL = 1e-4
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-3
POS_RTOL = 1e-5
GPS_GRAD_RTOL = 5e-4


def _ef_config(model, equivariance=False, hidden=16, layers=2, radius=5.0, neighbours=10):
    arch = {"mpnn_type": model, "radius": radius, "max_neighbours": neighbours,
            "hidden_dim": hidden, "num_conv_layers": layers, "equivariance": equivariance,
            "use_sorted_aggregation": True, "task_weights": [1.0],
            "output_heads": {"node": {"num_headlayers": 2, "dim_headlayers": [12, 12],
                                      "type": "mlp"}}}
    if model == "SchNet":
        arch.update(num_gaussians=12, num_filters=10)
    if model == "PAINN":
        arch["num_radial"] = 6
    return {
        "Dataset": {"node_features": {"dim": [1]}},
        "NeuralNetwork": {
            "Architecture": arch,
            "Variables_of_interest": {"input_node_features": [0],
                                      "output_names": ["graph_energy"], "output_index": [0],
                                      "output_dim": [1], "type": ["node"]},
            "Training": {"batch_size": 4, "loss_function_type": "mae",
                         "compute_grad_energy": True},
        },
    }


def _ef_splits():
    graphs = oc20_shaped_dataset(16, mean_atoms=20, min_atoms=10, max_atoms=40,
                                 max_neighbours=10)
    graphs = [dataclasses.replace(g, x=g.x[:, :1]) for g in graphs]  # the atomic number
    return split_dataset(graphs, 0.75, seed=0)


def _both(cfg, splits, batch_size=4):
    tr, va, te = splits
    jc = j_update(copy.deepcopy(cfg), tr, va, te)
    tc = t_update(copy.deepcopy(cfg), tr, va, te)
    jb = next(iter(JLoader(tr, batch_size, sort_edges=True)))
    tb = next(iter(TLoader(tr, batch_size, sort_edges=True)))
    jm = j_create(jc)
    v = _jax_init(jm, jb)
    return jm, v, jb, torch_model(v, tc), tb


@pytest.fixture
def pallas_route(monkeypatch):
    monkeypatch.setenv("HYDRAGNN_PALLAS_SEGMENT", "1")


@pytest.mark.parametrize("model,equivariance", [("SchNet", False), ("SchNet", True),
                                                ("PAINN", False)])
def pytest_energy_force_step_matches_jax(model, equivariance, pallas_route):
    """One ``compute_grad_energy`` step: the loss and its parts, the forces
    and every parameter's gradient."""
    jm, v, jb, tm, tb = _both(_ef_config(model, equivariance), _ef_splits())
    jv = jax.tree_util.tree_map(jnp.asarray, v)

    def loss_fn(params):
        tot, tasks, _, preds = j_compute_loss(jm, {"params": params,
                                                   "batch_stats": jv["batch_stats"]},
                                              jb, jm.cfg, True, jax.random.PRNGKey(0), True)
        return tot, (tasks, preds)

    (jtot, (jtasks, jpreds)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jv["params"])
    tm.train()
    tot, tasks, preds = compute_loss(tm, tb, tm.cfg, True)
    tot.backward()
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=LOSS_RTOL)
    for k in ("graph_energy", "forces"):
        np.testing.assert_allclose(float(tasks[k].detach()), float(jtasks[k]), rtol=LOSS_RTOL)
    jf = np.asarray(jpreds["forces"])
    assert np.isfinite(preds["forces"].detach().numpy()).all()
    assert float(np.abs(preds["forces"].detach().numpy() - jf).max()) <= \
        FORCE_RTOL * float(np.abs(jf).max())
    _assert_close(_flat(jgrads), grads_of(tm), GRAD_RTOL, f"{model} ef grad", floor=GRAD_FLOOR)


def pytest_schnet_coordinate_update_matches_jax(pallas_route):
    """``equivariance: true``: the first SchNet layer moves the positions
    along its gated, mean-aggregated unit edge vectors; the moved positions
    against the JAX layer's (the last layer stays invariant)."""
    jm, v, jb, tm, tb = _both(_ef_config("SchNet", True), _ef_splits())
    assert tm.graph_convs[0].equivariant and not tm.graph_convs[1].equivariant
    _, inter = jm.apply(v, jb, train=False, mutable=["intermediates"],
                        capture_intermediates=lambda mdl, method: method == "__call__"
                        and mdl.name == "graph_convs_0")
    want = np.asarray(inter["intermediates"]["graph_convs_0"]["__call__"][0][1])
    seen = []
    hook = tm.graph_convs[0].register_forward_hook(lambda m, i, o: seen.append(o[1]))
    with torch.no_grad():
        tm(tb)
    hook.remove()
    rows = tb.node_mask.numpy()
    pos = tb.pos.numpy()[rows]
    got = seen[0].numpy()[rows]
    moved = float(np.abs(want[rows] - pos).max())
    assert moved > 0
    assert float(np.abs(got - want[rows]).max()) <= POS_RTOL * moved


def _lj_config(model):
    cfg = _ef_config(model, radius=2.5, neighbours=32)
    cfg["NeuralNetwork"]["Architecture"]["use_sorted_aggregation"] = False
    return cfg


@pytest.mark.parametrize("model", ["SchNet", "PAINN"])
def pytest_forces_rotation_equivariant_and_match_jax(model):
    """Forces from an invariant energy rotate with the configuration, and
    the energies and forces are the JAX package's
    ``predict_energy_forces``'s."""
    graphs = lennard_jones_dataset(8, seed=3)
    jm, v, jb, tm, _ = _both(_lj_config(model), (graphs, graphs, graphs))
    size = dict(n_nodes=sum(g.num_nodes for g in graphs[:4]) + 8,
                n_edges=sum(g.num_edges for g in graphs[:4]) + 8, n_graphs=5)
    batch = batch_graphs(graphs[:4], PadSpec(**size))
    tm.eval()
    e0, f0 = predict_energy_forces(tm, batch, tm.cfg)
    jbatch = j_batch_graphs(graphs[:4], JPadSpec(**size))
    je, jf = j_predict_energy_forces(
        lambda b: (jm.apply(v, b, train=False), None), jbatch, jm.cfg)
    for got, want in ((e0, je), (f0, jf)):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert float(np.abs(got.numpy() - want).max()) <= FORCE_RTOL * float(np.abs(want).max())
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    rotated = batch.replace(pos=torch.from_numpy((batch.pos.numpy() @ q.T).astype(np.float32)))
    e1, f1 = predict_energy_forces(tm, rotated, tm.cfg)
    np.testing.assert_allclose(e0.numpy(), e1.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f0.numpy() @ q.T, f1.numpy(), rtol=1e-3, atol=1e-4)


def _zinc_gps_config(hidden=16, heads=4):
    """examples/zinc/zinc.json's Architecture, narrowed (hidden 64 -> 16,
    8 heads -> 4), on OC20-shaped graphs with one graph target."""
    arch = {"global_attn_engine": "GPS", "global_attn_type": "multihead",
            "global_attn_heads": heads, "pe_dim": 6, "mpnn_type": "SchNet", "radius": 7.0,
            "max_neighbours": 5, "hidden_dim": hidden, "num_conv_layers": 2,
            "num_gaussians": 10, "num_filters": 8, "dropout": 0.0,
            "use_sorted_aggregation": True, "task_weights": [1.0],
            "output_heads": {"graph": {"num_sharedlayers": 2, "dim_sharedlayers": 5,
                                       "num_headlayers": 2, "dim_headlayers": [50, 25]}}}
    return {
        "Dataset": {"node_features": {"dim": [1, 3, 3]}, "graph_features": {"dim": [1]}},
        "NeuralNetwork": {
            "Architecture": arch,
            "Variables_of_interest": {"input_node_features": [0, 1], "output_names": ["energy"],
                                      "output_index": [0], "type": ["graph"]},
            "Training": {"batch_size": 4, "loss_function_type": "mse"},
        },
    }


def pytest_gps_over_schnet_matches_jax(pallas_route):
    """GPS over SchNet: the graph outputs in eval mode, and one training
    step's loss and gradients (batch statistics, no dropout)."""
    graphs = add_dataset_pe(oc20_shaped_dataset(16, mean_atoms=20, min_atoms=10,
                                                max_atoms=40, max_neighbours=5), 6)
    jm, v, jb, tm, tb = _both(_zinc_gps_config(), split_dataset(graphs, 0.75, seed=0))
    assert tm.cfg.use_global_attn and tm.graph_convs[0].conv.__class__.__name__ == "CFConv"
    with torch.no_grad():
        _assert_close_real_rows(jm.apply(v, jb, train=False), tm(tb), tb)
    jv = jax.tree_util.tree_map(jnp.asarray, v)

    def loss_fn(params):
        tot, _, _, _ = j_compute_loss(jm, {"params": params, "batch_stats": jv["batch_stats"]},
                                      jb, jm.cfg, True, jax.random.PRNGKey(0), False)
        return tot

    jtot, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jv["params"])
    tm.train()
    tot, _, _ = compute_loss(tm, tb, tm.cfg, False)
    tot.backward()
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=LOSS_RTOL)
    _assert_close(_flat(jgrads), grads_of(tm), GPS_GRAD_RTOL, "gps schnet grad",
                  floor=GRAD_FLOOR)
