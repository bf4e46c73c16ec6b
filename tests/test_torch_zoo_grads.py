"""One training step of each conv of the port's zoo against the JAX
package's, on the CPU: the models, weights and batches of
tests/test_torch_zoo.py (2 conv layers, hidden 16, graph and node heads),
the JAX side with its Pallas routes in interpret mode
(``HYDRAGNN_PALLAS_SEGMENT=1``), so K1's and K3's ``custom_jvp`` rules
carry its gradients where the port's Functions carry them.

Tolerances (f32, the same algorithm in another summation order): the loss
(MAE over both heads, batch statistics) and each task's to 1e-5; every
parameter's gradient to 1e-4 of its largest, floored at 1e-3 of the
largest gradient anywhere (as tests/test_torch_train.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydragnn_tpu.train.loss import compute_loss as j_compute_loss
from hydragnn_tpu_torch.train import compute_loss
from test_torch_train import _assert_close, _flat
from test_torch_zoo import ZOO, pair, torch_model

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-3


def grads_of(model):
    """Every parameter's gradient, 0 where the loss does not reach it (an
    equivariant SchNet layer's coordinate gate feeds no head): the JAX
    package's zeros there."""
    return {n: np.zeros(tuple(p.shape), np.float32) if p.grad is None
            else p.grad.float().numpy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("model", ZOO)
def pytest_conv_step0_gradients_match_jax(model, monkeypatch):
    """The loss and every parameter's gradient of one training step, f32,
    through K1 (and K3 for PNAPlus and PNAEq) and their gradients."""
    monkeypatch.setenv("HYDRAGNN_PALLAS_SEGMENT", "1")
    jm, v, jb, tc, tb = pair(model)
    jv = jax.tree_util.tree_map(jnp.asarray, v)

    def loss_fn(params):
        tot, tasks, _, _ = j_compute_loss(jm, {"params": params,
                                               "batch_stats": jv["batch_stats"]},
                                          jb, jm.cfg, True, jax.random.PRNGKey(0), False)
        return tot, tasks

    (jtot, jtasks), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jv["params"])
    tm = torch_model(v, tc)
    tm.train()
    tot, tasks, _ = compute_loss(tm, tb, tm.cfg, False)
    tot.backward()
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=LOSS_RTOL)
    for k in jtasks:
        np.testing.assert_allclose(float(tasks[k].detach()), float(jtasks[k]), rtol=LOSS_RTOL)
    _assert_close(_flat(jgrads), grads_of(tm), GRAD_RTOL, f"{model} grad", floor=GRAD_FLOOR)
