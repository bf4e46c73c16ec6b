"""The hand-written CUDA kernels against their plain PyTorch versions, on a
GPU. Every test carries the ``gpu`` marker and skips where no CUDA device is
present; this file imports torch only (no JAX), so it runs on a GPU machine
without the JAX package's dependencies:

    python -m pytest tests/test_torch_cuda.py -m gpu -q

Tolerances: f32 sums in another order than index_add_/cuBLAS (1e-4); bf16
rounds once after f32 accumulation in both versions, but K2's plain version
rounds the product before adding the bias, so a message may differ by an ulp
or two of bf16 (2e-2 of the largest output).
"""

import pytest
import torch

from hydragnn_tpu_torch.ops import fused_edge as t_fused
from hydragnn_tpu_torch.ops import sorted_segment as t_sorted


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 3, 33, 866])
def pytest_k1_kernel_matches_plain_on_card(cuda, dtype, c):
    """Including empty rows, a trailing empty run, long rows walked by the
    whole block (three in one block) and a long last row."""
    gen = torch.Generator(device=cuda).manual_seed(c)
    n = 300
    deg = torch.randint(0, 20, (n,), generator=gen, device=cuda)
    deg[50:60] = 0
    deg[-20:-1] = 0
    deg[100:103] = torch.tensor([65, 200, 64], device=cuda)
    deg[-1] = 1500
    ids = torch.repeat_interleave(torch.arange(n, device=cuda), deg)
    msg = torch.randn(ids.shape[0], c, generator=gen, device=cuda).to(dtype)
    before = t_sorted.sorted_segment_sum.launches
    got = t_sorted.sorted_segment_sum(msg, ids, n)
    want = t_sorted.sorted_segment_sum_plain(msg, ids, n)
    torch.cuda.synchronize()
    assert t_sorted.sorted_segment_sum.launches == before + 1
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci,co", [(7, 5), (64, 64), (130, 70), (866, 866)])
def pytest_k2_kernel_matches_plain_on_card(cuda, dtype, ci, co):
    gen = torch.Generator(device=cuda).manual_seed(ci)
    n = 200
    deg = torch.randint(0, 30, (n,), generator=gen, device=cuda)
    deg[10:20] = 0
    deg[-1] = 700
    ids = torch.repeat_interleave(torch.arange(n, device=cuda), deg)
    e = ids.shape[0]
    ops = [torch.randn(n, ci, generator=gen, device=cuda),
           torch.randn(e, ci, generator=gen, device=cuda),
           torch.randn(ci, co, generator=gen, device=cuda) / ci**0.5,
           torch.randn(co, generator=gen, device=cuda)]
    ops = [o.to(dtype) for o in ops]
    got = t_fused.fused_edge_message_sum(*ops, ids, n)
    want = t_fused.reference_edge_message_sum(*ops, ids, n)
    torch.cuda.synchronize()
    assert float(got[10:20].abs().sum()) == 0.0  # empty rows stay exactly zero
    scale = float(want.float().abs().max())
    tol = (1e-4 if dtype == torch.float32 else 2e-2) * max(scale, 1.0)
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.gpu
def pytest_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    ids = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        t_sorted.sorted_segment_sum(torch.ones(4, 3, dtype=torch.float16, device=cuda), ids, 2)
    with pytest.raises(ValueError):
        t_sorted.sorted_segment_sum(torch.ones(3, 4, device=cuda).t(), ids, 2)
    with pytest.raises(ValueError):
        t_sorted.sorted_segment_sum(torch.ones(4, 3, device=cuda), ids.cpu(), 2)
    ops = [torch.ones(2, 3, device=cuda), torch.ones(4, 3, device=cuda),
           torch.ones(3, 5, device=cuda), torch.ones(5, dtype=torch.bfloat16, device=cuda)]
    with pytest.raises(TypeError):
        t_fused.fused_edge_message_sum(*ops, ids, 2)


@pytest.mark.gpu
def pytest_egnn_kernels_match_the_plain_route_on_card(cuda):
    """A small equivariant EGNN on the card: the sorted route (K1 in every
    layer, K2 in the last) against the same weights on the unsorted plain
    route, f32, real rows to 1e-4 of each head's largest value."""
    import copy

    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.data import GraphLoader, oc20_shaped_dataset, split_dataset
    from hydragnn_tpu_torch.models import create_model

    graphs = oc20_shaped_dataset(16, mean_atoms=20, min_atoms=10, max_atoms=40)
    splits = split_dataset(graphs, 0.75)
    arch = {"mpnn_type": "EGNN", "equivariance": True, "radius": 5.0,
            "max_neighbours": 20, "hidden_dim": 64, "num_conv_layers": 3,
            "use_sorted_aggregation": True, "task_weights": [1.0, 1.0],
            "output_heads": {
                "graph": {"num_sharedlayers": 1, "dim_sharedlayers": 16,
                          "num_headlayers": 1, "dim_headlayers": [16]},
                "node": {"num_headlayers": 1, "dim_headlayers": [16], "type": "mlp"}}}
    cfg = {"Dataset": {"node_features": {"dim": [1, 3, 3]}, "graph_features": {"dim": [1]}},
           "NeuralNetwork": {"Architecture": arch, "Training": {"batch_size": 8},
                             "Variables_of_interest": {
                                 "input_node_features": [0, 1],
                                 "output_names": ["energy", "forces"],
                                 "output_index": [0, 2], "type": ["graph", "node"]}}}
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg["NeuralNetwork"]["Architecture"]["use_sorted_aggregation"] = False
    model = create_model(update_config(cfg, *splits), device=cuda)
    plain = create_model(update_config(plain_cfg, *splits), device=cuda)
    plain.load_state_dict(model.state_dict())
    batch = next(iter(GraphLoader(splits[0], 8, sort_edges=True))).to(cuda)
    k1, k2 = t_sorted.sorted_segment_sum.launches, t_fused.fused_edge_message_sum.launches
    with torch.no_grad():
        got, want = model(batch), plain(batch)
    torch.cuda.synchronize()
    assert t_sorted.sorted_segment_sum.launches - k1 == 4  # 2 equivariant layers x 2
    assert t_fused.fused_edge_message_sum.launches - k2 == 1
    for k in want:
        m = batch.graph_mask if want[k].shape[0] == batch.num_graphs else batch.node_mask
        scale = float(want[k][m].abs().max())
        assert float((got[k][m] - want[k][m]).abs().max()) <= 1e-4 * scale, k
