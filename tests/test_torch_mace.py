"""MACE's port (``MACEModel``) against the JAX package, on the CPU: 2 conv
layers at hidden 8, max_ell and node_max_ell 2, on OC20-shaped graphs,
built in JAX, its variables bridged into the port, on the same
receiver-sorted batch. The JAX side runs under both of its CG routes
(``HYDRAGNN_MACE_DENSE_CG=0``: the per-path ``couple`` loop; ``=1``: the
fused block-CG contraction, the port's one route) and with its Pallas
route in interpret mode (``HYDRAGNN_PALLAS_SEGMENT=1``: the receiver sum
over [E, C * 9] is K1).

Tolerances (f32: the same function, the sums in another order):

- forwards at correlation 1, 2 and 3, one head and two: real rows to 1e-4
  of each head's largest value (tests/test_torch_egnn.py);
- rotation and translation invariance of the port's outputs, as
  tests/test_mace.py holds the JAX package's (5e-4 absolute; a random
  rotation, a shift of 7.5);
- bf16 ``mixed_precision``: the dtype of every head as the JAX package's,
  and the first layer's node features within ``BF16_SHARE`` of the
  distance bf16 itself puts between the JAX package's bf16 and f32
  features (tests/test_torch_zoo.py);
- one training step and one energy-force step (forces by a double backward
  through K1's Function): the loss and each task's to 1e-5, the forces to
  1e-4 of the largest, every gradient to 1e-4 of its largest (floored at
  1e-3 of the largest anywhere: tests/test_torch_train.py).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydragnn_tpu.config import update_config as j_update
from hydragnn_tpu.data import GraphLoader as JLoader
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.train.loss import compute_loss as j_compute_loss
from hydragnn_tpu.train.loop import mp_cast_eval as j_mp_cast_eval
from hydragnn_tpu_torch.bridge import load_jax_variables
from hydragnn_tpu_torch.config import update_config as t_update
from hydragnn_tpu_torch.data import GraphLoader as TLoader
from hydragnn_tpu_torch.models import create_model as t_create
from hydragnn_tpu_torch.models.mace import MACEModel
from hydragnn_tpu_torch.train import compute_loss, mp_cast_eval
from test_torch_egnn import _assert_close_real_rows
from test_torch_train import _assert_close, _flat
from test_torch_zoo import BF16_SHARE, _config, _relative_l2, _splits
from test_torch_zoo_forces import _ef_config, _ef_splits
from test_torch_zoo_grads import grads_of

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
FORCE_RTOL = 1e-4
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-3
INVARIANCE_ATOL = 5e-4
MACE_ARCH = dict(num_radial=6, max_ell=2, node_max_ell=2, radial_type="bessel",
                 envelope_exponent=5)


@pytest.fixture(params=["0", "1"], ids=["loop_cg", "dense_cg"])
def jax_routes(request, monkeypatch):
    """The JAX package's K1 in interpret mode, under each of its CG routes."""
    monkeypatch.setenv("HYDRAGNN_PALLAS_SEGMENT", "1")
    monkeypatch.setenv("HYDRAGNN_MACE_DENSE_CG", request.param)


def _mace_config(correlation=3, heads="graph+node", hidden=8):
    cfg = _config("MACE", hidden=hidden)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch.update(MACE_ARCH, correlation=correlation)
    if heads == "graph":
        arch["output_heads"] = {"graph": arch["output_heads"]["graph"]}
        arch["task_weights"] = [1.0]
        var = cfg["NeuralNetwork"]["Variables_of_interest"]
        var.update(output_names=["energy"], output_index=[0], type=["graph"])
    return cfg


def _init(jm, jb, seed=3):
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r, b: jm.init(r, b, train=False))({"params": jax.random.PRNGKey(seed)}, jb))


_PAIRS = {}


def mace_pair(correlation=3, heads="graph+node", ef=False):
    """(JAX model, its variables, JAX batch, port model on the bridged
    variables, torch batch), built once per configuration."""
    key = (correlation, heads, ef)
    if key not in _PAIRS:
        if ef:
            cfg = _ef_config("MACE")
            cfg["NeuralNetwork"]["Architecture"].update(MACE_ARCH, correlation=correlation,
                                                        hidden_dim=8)
            tr, va, te = _ef_splits()
        else:
            cfg = _mace_config(correlation, heads)
            tr, va, te = _splits()
        jc = j_update(copy.deepcopy(cfg), tr, va, te)
        tc = t_update(copy.deepcopy(cfg), tr, va, te)
        jb = next(iter(JLoader(tr, 4, sort_edges=True)))
        tb = next(iter(TLoader(tr, 4, sort_edges=True)))
        jm = j_create(jc)
        v = _init(jm, jb)
        tm = t_create(tc, device="cpu")
        load_jax_variables(tm, v)
        _PAIRS[key] = (jm, v, jb, tm, tb)
    return _PAIRS[key]


def pytest_mace_config_completion_matches_jax():
    """``avg_num_neighbors`` (the training split's average in-degree) for
    MACE, None for another conv; the MACE keys None where unset."""
    tr, va, te = _splits()
    keys = ("avg_num_neighbors", "max_ell", "node_max_ell", "correlation", "radial_type",
            "distance_transform", "num_radial", "num_spherical", "max_in_degree")
    for cfg in (_mace_config(), _config("SAGE")):
        jc = j_update(copy.deepcopy(cfg), tr, va, te)["NeuralNetwork"]["Architecture"]
        tc = t_update(copy.deepcopy(cfg), tr, va, te)["NeuralNetwork"]["Architecture"]
        assert {k: tc[k] for k in keys} == {k: jc[k] for k in keys}
    assert tc["avg_num_neighbors"] is None and jc["max_ell"] is None


def pytest_create_model_checks_mace_as_jax_does():
    tr, va, te = _splits()
    for bad, match in ((dict(max_ell=0), "max_ell"), (dict(node_max_ell=0), "node_max_ell"),
                       (dict(global_attn_engine="GPS", global_attn_type="multihead",
                             global_attn_heads=2, pe_dim=4), "GPS")):
        cfg = _mace_config()
        cfg["NeuralNetwork"]["Architecture"].update(bad)
        with pytest.raises(AssertionError, match=match):
            t_create(t_update(cfg, tr, va, te), device="cpu")
    assert isinstance(t_create(t_update(_mace_config(), tr, va, te), device="cpu"), MACEModel)


@pytest.mark.parametrize("heads", ["graph", "graph+node"])
@pytest.mark.parametrize("correlation", [1, 2, 3])
def pytest_mace_matches_jax_on_bridged_weights(correlation, heads, jax_routes):
    jm, v, jb, tm, tb = mace_pair(correlation, heads)
    with torch.no_grad():
        tout = tm(tb)
    jout = jm.apply(v, jb, train=False)
    assert sorted(tout) == sorted(jout)
    _assert_close_real_rows(jout, tout, tb)


def _rotated(batch, seed=0):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return batch.replace(pos=batch.pos @ torch.from_numpy(q.astype(np.float32)).T)


@pytest.mark.parametrize("correlation", [1, 2, 3])
def pytest_mace_rotation_and_translation_invariance(correlation):
    """The port's energies and node outputs (invariant heads) under a
    random rotation and under a translation of every position."""
    _, _, _, tm, tb = mace_pair(correlation)
    rows = {"energy": tb.graph_mask.numpy(), "forces": tb.node_mask.numpy()}
    with torch.no_grad():
        base = tm(tb)
        moved = {"rotated": tm(_rotated(tb)), "shifted": tm(tb.replace(pos=tb.pos + 7.5))}
    for name, out in moved.items():
        for k, m in rows.items():
            np.testing.assert_allclose(out[k].numpy()[m], base[k].numpy()[m], rtol=0,
                                       atol=INVARIANCE_ATOL, err_msg=f"{name} {k}")


def _conv0(mdl, method):
    return method == "__call__" and mdl.name == "conv0"


def pytest_mace_mixed_precision_matches_jax(jax_routes):
    """Both packages' ``mp_cast_eval``: every head's dtype, and the first
    layer's node features within ``BF16_SHARE`` of bf16's own distance."""
    jm, v, jb, tm, tb = mace_pair()
    jv, jbb = j_mp_cast_eval(jax.tree_util.tree_map(jnp.asarray, v), jb, False)
    jout, inter = jm.apply(jv, jbb, train=False, mutable=["intermediates"],
                           capture_intermediates=_conv0)
    _, inter32 = jm.apply(v, jb, train=False, mutable=["intermediates"],
                          capture_intermediates=_conv0)
    want = np.asarray(inter["intermediates"]["conv0"]["__call__"][0].astype(jnp.float32))
    want32 = np.asarray(inter32["intermediates"]["conv0"]["__call__"][0])
    bf_model, bf_batch = mp_cast_eval(tm, tb)
    seen = []
    hook = bf_model.conv0.register_forward_hook(lambda m, i, o: seen.append(o))
    with torch.no_grad():
        tout = bf_model(bf_batch)
    hook.remove()
    assert seen[0].dtype == torch.bfloat16
    for name, a in jout.items():
        assert str(tout[name].dtype)[6:] == str(a.dtype), name
    rows = tb.node_mask.numpy()
    budget = _relative_l2(want[rows], want32[rows])
    assert budget > 0
    assert _relative_l2(seen[0].float().numpy()[rows], want[rows]) <= BF16_SHARE * budget


def _jax_step(jm, v, jb, grad_energy):
    jv = jax.tree_util.tree_map(jnp.asarray, v)

    def loss_fn(params):
        tot, tasks, _, preds = j_compute_loss(jm, {"params": params}, jb, jm.cfg, True,
                                              jax.random.PRNGKey(0), grad_energy)
        return tot, (tasks, preds)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jv["params"])


def pytest_mace_step0_gradients_match_jax(jax_routes):
    jm, v, jb, tm, tb = mace_pair()
    (jtot, (jtasks, _)), jgrads = _jax_step(jm, v, jb, False)
    tm = copy.deepcopy(tm).train()
    tot, tasks, _ = compute_loss(tm, tb, tm.cfg, False)
    tot.backward()
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=LOSS_RTOL)
    for k in jtasks:
        np.testing.assert_allclose(float(tasks[k].detach()), float(jtasks[k]), rtol=LOSS_RTOL)
    _assert_close(_flat(jgrads), grads_of(tm), GRAD_RTOL, "MACE grad", floor=GRAD_FLOOR)


def pytest_mace_energy_force_step_matches_jax(jax_routes):
    """``compute_grad_energy``: the loss and its parts, the forces and every
    gradient (a double backward through the CG products and K1)."""
    jm, v, jb, tm, tb = mace_pair(ef=True)
    (jtot, (jtasks, jpreds)), jgrads = _jax_step(jm, v, jb, True)
    tm = copy.deepcopy(tm).train()
    tot, tasks, preds = compute_loss(tm, tb, tm.cfg, True)
    tot.backward()
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=LOSS_RTOL)
    for k in ("graph_energy", "forces"):
        np.testing.assert_allclose(float(tasks[k].detach()), float(jtasks[k]), rtol=LOSS_RTOL)
    jf, tf = np.asarray(jpreds["forces"]), preds["forces"].detach().numpy()
    assert np.isfinite(tf).all() and float(np.abs(jf).max()) > 0
    assert float(np.abs(tf - jf).max()) <= FORCE_RTOL * float(np.abs(jf).max())
    _assert_close(_flat(jgrads), grads_of(tm), GRAD_RTOL, "MACE ef grad", floor=GRAD_FLOOR)


def pytest_mace_bridge_names_every_flax_leaf():
    """Every leaf of the flax tree lands on a tensor of the port's model
    (``load_jax_variables`` is strict), the readout banks included."""
    _, v, _, tm, _ = mace_pair()
    names = set(tm.state_dict())
    assert set(_flat(v["params"])) == names and "batch_stats" not in v
    assert {"conv0.interaction.conv_tp_weights.Dense_3.weight", "conv1.product.w3_0",
            "conv0.sizing.w2", "readout0_head0.weight", "readout2_head1.Dense_2.weight",
            "node_embedding.weight"} <= names
