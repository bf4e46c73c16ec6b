"""The port's remat policies (hydragnn_tpu_torch/ops/remat.py) on the CPU.

A 2-layer equivariant EGNN (hidden 16, batch 4, packed, sorted aggregation
and the fused edge op: K1 and K2's CPU routes) takes one train step's loss
and gradients under each ``Training.remat_policy`` with and without
``conv_checkpointing``:

- against the port's unwrapped step: the loss and every gradient bit for
  bit (a wrap recomputes the same operations on the same inputs), and the
  batch-norm running statistics too (a recompute leaves them alone);
- against the JAX package's loss with the same wrap (its plain route):
  the loss within 1e-5 of the largest, the gradients within 1e-4 of each
  parameter's largest (floored at 1e-3 of the largest anywhere), as
  tests/test_torch_train.py holds the unwrapped step.
"""


import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from hydragnn_tpu.api import prepare_data as j_prepare
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.models import init_model as j_init
from hydragnn_tpu.ops.remat import loss_remat as j_loss_remat
from hydragnn_tpu.train.loss import compute_loss as j_compute_loss
from hydragnn_tpu_torch.api import prepare_data as t_prepare
from hydragnn_tpu_torch.bridge import _leaves, load_jax_variables, torch_name
from hydragnn_tpu_torch.data import oc20_shaped_dataset, split_dataset
from hydragnn_tpu_torch.models import create_model as t_create
from hydragnn_tpu_torch.ops import remat
from hydragnn_tpu_torch.train.loop import train_loss

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-3
POLICIES = ("none", "dots", "names", "full")


def _config(ckpt=False, policy="full"):
    return {
        "Verbosity": {"level": 0},
        "Dataset": {"node_features": {"dim": [1, 3, 3]}, "graph_features": {"dim": [1]}},
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "EGNN", "equivariance": True, "radius": 5.0,
                "max_neighbours": 10, "hidden_dim": 16, "num_conv_layers": 2,
                "use_sorted_aggregation": True, "use_fused_edge_kernel": True,
                "task_weights": [1.0, 10.0],
                "output_heads": {
                    "graph": {"num_sharedlayers": 1, "dim_sharedlayers": 8,
                              "num_headlayers": 2, "dim_headlayers": [8, 8]},
                    "node": {"num_headlayers": 2, "dim_headlayers": [8, 8], "type": "mlp"}}},
            "Variables_of_interest": {
                "input_node_features": [0, 1], "output_names": ["energy", "forces"],
                "output_index": [0, 2], "type": ["graph", "node"]},
            "Training": {"batch_size": 4, "loss_function_type": "mae", "pack_batches": True,
                         "num_epoch": 1, "conv_checkpointing": ckpt, "remat_policy": policy,
                         "Optimizer": {"type": "AdamW", "learning_rate": 1e-3}},
        },
    }


@pytest.fixture(scope="module")
def case():
    graphs = oc20_shaped_dataset(24, mean_atoms=16, min_atoms=10, max_atoms=30,
                                 max_neighbours=10)
    splits = split_dataset(graphs, 0.75, seed=0)
    jc, (jtl, _, _), _ = j_prepare(_config(), splits)
    tc, (ttl, _, _), _ = t_prepare(_config(), splits)
    jbatch, tbatch = next(iter(jtl)), next(iter(ttl))
    jm = j_create(jc)
    v = jax.tree_util.tree_map(np.asarray, jax.device_get(j_init(jm, jbatch, seed=3)))
    return {"splits": splits, "v": v, "jbatch": jbatch, "tbatch": tbatch}


def _port_step(case, ckpt, policy):
    tc, _, _ = t_prepare(_config(ckpt, policy), case["splits"])
    model = t_create(tc, device="cpu")
    load_jax_variables(model, case["v"])
    model.train()
    saved = [0]

    def pack(t):
        saved[0] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tot, tasks, _ = train_loss(model, case["tbatch"], model.cfg)
    tot.float().backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    stats = {n: b.detach().clone() for n, b in model.named_buffers()}
    return tot.detach(), grads, stats, saved[0]


@pytest.fixture(scope="module")
def unwrapped(case):
    return _port_step(case, False, "full")


def _jax_loss_and_grads(case, ckpt, policy):
    jc, _, _ = j_prepare(_config(ckpt, policy), case["splits"])
    jm = j_create(jc)
    cfg = jm.cfg
    assert cfg.conv_checkpointing == ckpt and cfg.remat_policy == policy

    def loss_fn(params, stats, batch):
        tot, tasks, _, _ = j_compute_loss(jm, {"params": params, "batch_stats": stats}, batch,
                                          cfg, True, jax.random.PRNGKey(0), False)
        return tot.astype(jnp.float32)

    if ckpt:
        loss_fn = j_loss_remat(loss_fn, policy)
    v = jax.tree_util.tree_map(jnp.asarray, case["v"])
    tot, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"], v["batch_stats"],
                                                      case["jbatch"])
    out = {}
    for path, leaf in _leaves(grads):
        name, transpose = torch_name(path)
        a = np.asarray(leaf, np.float32)
        out[name] = np.swapaxes(a, -1, -2) if transpose else a
    return float(tot), out


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("ckpt", [False, True])
def pytest_remat_changes_no_value(case, unwrapped, ckpt, policy):
    tot, grads, stats, _ = _port_step(case, ckpt, policy)
    base_tot, base_grads, base_stats, _ = unwrapped
    assert torch.equal(tot, base_tot)
    assert grads.keys() == base_grads.keys()
    for k in grads:
        assert torch.equal(grads[k], base_grads[k]), k
    for k in stats:
        assert torch.equal(stats[k], base_stats[k]), k


@pytest.mark.parametrize("policy", POLICIES)
def pytest_checkpointed_loss_matches_jax(case, policy):
    tot, grads, _, _ = _port_step(case, True, policy)
    j_tot, j_grads = _jax_loss_and_grads(case, True, policy)
    assert abs(float(tot) - j_tot) <= LOSS_RTOL * abs(j_tot)
    top = max(float(np.abs(g).max()) for g in j_grads.values())
    for name, want in j_grads.items():
        got = grads[name].numpy()
        scale = max(float(np.abs(want).max()), GRAD_FLOOR * top, 1e-30)
        assert float(np.abs(got - want).max()) <= GRAD_RTOL * scale, name


def pytest_conv_checkpointing_takes_effect(case, unwrapped):
    """The flag is no longer ignored: the checkpointed step saves fewer
    tensors for its backward and gets the same gradients."""
    _, grads, _, saved = _port_step(case, True, "full")
    assert saved < unwrapped[3] // 2, (saved, unwrapped[3])
    assert all(torch.equal(grads[k], unwrapped[1][k]) for k in grads)


class _KernelCalls(TorchDispatchMode):
    """Counts the K1 operator calls that run (a selective checkpoint's
    recompute hands a saved output back before this outer mode sees it)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.hydragnn.segment_sum.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy,calls", [("full", 2), ("dots", 2), ("names", 1)])
def pytest_names_keeps_the_kernel_outputs(case, policy, calls):
    """Under conv_checkpointing the recompute runs K1's operator again,
    except under ``names``, a selective policy that saves its outputs (the
    pooling's plain segment sum, no kernel, is recomputed under each)."""
    with _KernelCalls() as plain_step:
        _port_step(case, False, policy)
    assert plain_step.n > 0
    with _KernelCalls() as wrapped_step:
        _port_step(case, True, policy)
    assert wrapped_step.n == calls * plain_step.n


def pytest_names_saves_only_the_kernel_operators():
    """The ``names`` policy's save set is the five kernels' operators."""
    saved = remat._saved_ops("names")
    assert [op.name() for op in saved] == [f"hydragnn::{n}" for n in remat.KERNEL_OUTPUT_NAMES]


def pytest_kernel_remat_wraps(case):
    def fn(x):
        return x * 2

    assert remat.kernel_remat(fn, "none") is fn
    assert remat.kernel_remat(fn, "full") is fn
    for policy in ("dots", "names"):
        assert remat.kernel_remat(fn, policy).remat_policy == policy
    assert remat.loss_remat(fn, "none").remat_policy == "full"
    with pytest.raises(ValueError, match="remat_policy"):
        remat.kernel_remat(fn, "everything")


def pytest_flops_count_the_recompute(case):
    """obs/flops.py counts the step under its remat wrap: the whole-loss
    recompute adds its forward's products."""
    from hydragnn_tpu_torch.obs.flops import train_step_flops

    counts = {}
    for ckpt in (False, True):
        tc, _, _ = t_prepare(_config(ckpt, "full"), case["splits"])
        model = t_create(tc, device="cpu")
        counts[ckpt] = train_step_flops(model, case["tbatch"])
    assert counts[True] > counts[False]
