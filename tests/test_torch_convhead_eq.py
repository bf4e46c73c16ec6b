"""The conv node head of the port against the JAX package's, on the CPU:
EGNN, PNAEq and PAINN (whose head chains carry vector features from width
to width), EGNN's bf16 step, and the bridge's split of the banked leaves.
The models, batches and tolerances are tests/test_torch_convhead.py's.
"""

import numpy as np
import pytest
import torch

from test_torch_convhead import (
    CONV_HEAD_MODELS,
    check_conv_node_head,
    check_mixed_precision_loss,
    convhead_pair,
    torch_model,
)

torch.set_num_threads(2)


@pytest.fixture
def pallas_route(monkeypatch):
    monkeypatch.setenv("HYDRAGNN_PALLAS_SEGMENT", "1")


@pytest.mark.parametrize("model", CONV_HEAD_MODELS[8:])
def pytest_conv_node_head_matches_jax(model, pallas_route):
    check_conv_node_head(model)


@pytest.mark.parametrize("model", ["EGNN"])
def pytest_conv_node_head_mixed_precision_loss_matches_jax(model, pallas_route):
    check_mixed_precision_loss(model)


def pytest_conv_head_bridge_splits_branches(pallas_route):
    """Each branch's chain takes its slice of the JAX ``[B]`` leaves, its
    batch-norm statistics too."""
    _, v, _, tc, _ = convhead_pair("EGNN")
    tm = torch_model(v, tc)
    jhead = v["params"]["heads_NN_1"]
    for b, chain in enumerate(tm.heads_NN[1].branches):
        np.testing.assert_array_equal(
            chain.EGCL_0.edge_lin_recv.weight.detach().numpy(),
            np.asarray(jhead["EGCL_0"]["edge_lin_recv"]["kernel"])[b].T)
        np.testing.assert_array_equal(
            chain.MaskedBatchNorm_1.mean.numpy(),
            np.asarray(v["batch_stats"]["heads_NN_1"]["MaskedBatchNorm_1"]["mean"])[b])
