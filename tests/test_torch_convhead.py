"""The conv node head of the port against the JAX package's, on the CPU.

For each of the eleven convs of the JAX package's conv-head training test
(SAGE, GIN, GAT, MFC, PNA, PNAPlus and PNA's bf16 step here; EGNN, PNAEq,
PAINN, EGNN's bf16 step and the bridge in tests/test_torch_convhead_eq.py;
SchNet and DimeNet in tests/test_torch_convhead_basis.py, so that each
file stays near a minute on the CPU): a
2-layer ``HydraModel`` (hidden 16) with 2 branches, a graph head and a
node head of ``"type": "conv"`` ([8] + the output conv, one chain of the
model's own conv per branch, each with its own batch-norm statistics),
built in JAX; its variables (non-trivial batch-norm statistics, the conv
heads' ``[B]`` leaves split per branch by ``bridge.py``) are loaded into
the port, and both run the same receiver-sorted batch, whose graphs belong
to both branches. The JAX side runs its Pallas routes in interpret mode
(``HYDRAGNN_PALLAS_SEGMENT=1``).

Tolerances (f32, the same algorithm in another summation order): the
forward's real rows to 1e-4 of each head's largest value (as
tests/test_torch_zoo.py); the loss and each task's to 1e-5, every
parameter's gradient to 1e-4 of its largest, floored at 1e-3 of the
largest gradient anywhere (as tests/test_torch_train.py); a bf16
``mixed_precision`` step's loss to 1e-3.
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
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.train.loop import mp_cast
from hydragnn_tpu.train.loss import compute_loss as j_compute_loss
from hydragnn_tpu_torch.bridge import load_jax_variables, torch_arrays
from hydragnn_tpu_torch.config import update_config as t_update
from hydragnn_tpu_torch.data import GraphLoader as TLoader
from hydragnn_tpu_torch.models import create_model as t_create
from hydragnn_tpu_torch.models.base import BranchBank, NodeConvHead
from hydragnn_tpu_torch.train import TrainState, compute_loss, make_optimizer, make_train_step
from test_torch_dimenet import BLOCKS
from test_torch_egnn import _assert_close_real_rows
from test_torch_train import _assert_close
from test_torch_zoo import _config, _jax_init, _splits
from test_torch_zoo_grads import grads_of

torch.set_num_threads(2)

CONV_HEAD_MODELS = ("SAGE", "GIN", "GAT", "MFC", "PNA", "PNAPlus", "SchNet", "DimeNet",
                    "EGNN", "PNAEq", "PAINN")
LOSS_RTOL = 1e-5
BF16_LOSS_RTOL = 1e-3
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-3
BRANCHES = 2


def convhead_config(model, branches=BRANCHES):
    cfg = _config(model)
    arch = cfg["NeuralNetwork"]["Architecture"]
    if model == "DimeNet":
        arch.update(BLOCKS)
    arch["equivariance"] = model in ("SchNet", "PAINN", "PNAEq", "EGNN")
    heads = arch["output_heads"]
    node = dict(heads["node"], type="conv", num_headlayers=1, dim_headlayers=[8])
    arch["output_heads"] = {
        "graph": [{"type": f"branch-{b}", "architecture": heads["graph"]}
                  for b in range(branches)],
        "node": [{"type": f"branch-{b}", "architecture": node} for b in range(branches)],
    }
    return cfg


def branch_splits(branches=BRANCHES):
    """tests/test_torch_zoo.py's splits, graph i in branch i % branches."""
    return tuple([dataclasses.replace(g, dataset_id=i % branches) for i, g in enumerate(s)]
                 for s in _splits())


_PAIRS = {}


def convhead_pair(model):
    """(JAX model, its variables, JAX batch, completed torch config, torch
    batch), built once per conv in a process."""
    if model not in _PAIRS:
        tr, va, te = branch_splits()
        cfg = convhead_config(model)
        jc = j_update(copy.deepcopy(cfg), tr, va, te)
        tc = t_update(copy.deepcopy(cfg), tr, va, te)
        kw = dict(sort_edges=True, with_triplets=model == "DimeNet")
        jb = next(iter(JLoader(tr, 4, **kw)))
        tb = next(iter(TLoader(tr, 4, **kw)))
        assert set(np.asarray(jb.dataset_id)[np.asarray(jb.graph_mask)]) == {0, 1}
        jm = j_create(jc)
        _PAIRS[model] = (jm, _jax_init(jm, jb), jb, tc, tb)
    return _PAIRS[model]


def flat(model, tree):
    """A JAX params-shaped tree as {torch name: array in torch layout}, the
    conv heads' ``[B]`` leaves split per branch."""
    return {n: np.asarray(a, np.float32) for n, a, _ in torch_arrays(model, tree)}


def jax_eval(jm, v, jb):
    """The JAX eval forward, jitted: the eager flax forward of these models
    takes 10-20 s on the CPU."""
    return jax.jit(lambda variables, batch: jm.apply(variables, batch, train=False))(v, jb)


def torch_model(v, tc):
    tm = t_create(tc, device="cpu")
    load_jax_variables(tm, v)
    return tm


@pytest.fixture
def pallas_route(monkeypatch):
    monkeypatch.setenv("HYDRAGNN_PALLAS_SEGMENT", "1")


def _jax_loss(jm, v, jb, mixed_precision=False):
    jv = jax.tree_util.tree_map(jnp.asarray, v)

    def loss_fn(params):
        batch = jb
        if mixed_precision:
            params, batch = mp_cast(params, jb, False)
        tot, tasks, _, _ = j_compute_loss(jm, {"params": params,
                                               "batch_stats": jv["batch_stats"]},
                                          batch, jm.cfg, True, jax.random.PRNGKey(0), False)
        return tot.astype(jnp.float32), tasks

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jv["params"])


def check_conv_node_head(model):
    """The eval forward (each graph decoded by its branch's conv chain),
    then one training step's loss, per-task losses and every parameter's
    gradient, f32."""
    jm, v, jb, tc, tb = convhead_pair(model)
    tm = torch_model(v, tc)
    head = tm.heads_NN[1]
    assert isinstance(head, BranchBank) and len(head.branches) == BRANCHES
    assert all(isinstance(b, NodeConvHead) and len(b.names) == 2 for b in head.branches)
    with torch.no_grad():
        tout = tm(tb)
    _assert_close_real_rows(jax_eval(jm, v, jb), tout, tb)

    (jtot, jtasks), jgrads = _jax_loss(jm, v, jb)
    tm.train()
    tot, tasks, _ = compute_loss(tm, tb, tm.cfg, False)
    tot.backward()
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=LOSS_RTOL)
    for k in jtasks:
        np.testing.assert_allclose(float(tasks[k].detach()), float(jtasks[k]), rtol=LOSS_RTOL)
    _assert_close(flat(tm, jgrads), grads_of(tm), GRAD_RTOL, f"{model} grad", floor=GRAD_FLOOR)
    # each branch's chain has gradients of its own
    for b in head.branches:
        assert any(float(p.grad.abs().max()) > 0 for p in b.parameters())


def check_mixed_precision_loss(model):
    """One bf16 ``mixed_precision`` train step: its loss against the JAX
    step's loss function with its ``mp_cast``, and every gradient on the
    f32 masters finite."""
    jm, v, jb, tc, tb = convhead_pair(model)
    (jtot, _), _ = _jax_loss(jm, v, jb, mixed_precision=True)
    tm = torch_model(v, tc)
    ts = TrainState.create(tm, make_optimizer(tm, {"type": "AdamW", "learning_rate": 1e-3}))
    ts, tot, _ = make_train_step(tm, mixed_precision=True)(ts, tb)
    np.testing.assert_allclose(float(tot), float(jtot), rtol=BF16_LOSS_RTOL)
    assert all(p.grad.dtype == torch.float32 and bool(torch.isfinite(p.grad).all())
               for p in tm.parameters())
    assert int(ts.skipped_steps) == 0


@pytest.mark.parametrize("model", CONV_HEAD_MODELS[:6])
def pytest_conv_node_head_matches_jax(model, pallas_route):
    check_conv_node_head(model)


@pytest.mark.parametrize("model", ["PNA"])
def pytest_conv_node_head_mixed_precision_loss_matches_jax(model, pallas_route):
    check_mixed_precision_loss(model)
