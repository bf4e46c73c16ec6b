"""The conv node head of the port against the JAX package's, on the CPU:
SchNet and DimeNet, the convs over radial (and spherical) bases. The
models, batches and tolerances are tests/test_torch_convhead.py's.
"""

import pytest
import torch

from test_torch_convhead import CONV_HEAD_MODELS, check_conv_node_head

torch.set_num_threads(2)


@pytest.fixture
def pallas_route(monkeypatch):
    monkeypatch.setenv("HYDRAGNN_PALLAS_SEGMENT", "1")


@pytest.mark.parametrize("model", CONV_HEAD_MODELS[6:8])
def pytest_conv_node_head_matches_jax(model, pallas_route):
    check_conv_node_head(model)
