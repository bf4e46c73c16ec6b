"""The hand-written CUDA kernels against their plain PyTorch versions, on a
GPU. Every test carries the ``gpu`` marker and skips where no CUDA device is
present; this file imports torch only (no JAX), so it runs on a GPU machine
without the JAX package's dependencies:

    python -m pytest tests/test_torch_cuda.py -m gpu -q

Tolerances: f32 sums in another order than index_add_/cuBLAS (1e-4); bf16
rounds once after f32 accumulation in both versions, but K2's plain version
rounds the product before adding the bias, so a message may differ by an ulp
or two of bf16 (2e-2 of the largest output). K3 forms each message exactly
as its plain version does, so count, min and max agree exactly and sum and
sumsq to f32 summation order (1e-5 of the largest value). K4 sums in
another order (f32: 1e-5 of max |v|); in bf16 it rounds p to bf16 against a
running maximum where the plain version uses the row's final maximum, an
ulp of bf16 on each p, and rounds the output (2e-2 of max |v|). K4b's
m, l and acc, each against its own largest value: f32 1e-5 (summation order,
exp2 of log2-scaled scores against exp); bf16 2e-2 (m, l and acc = o * l
rounded to bf16, p rounded against a running maximum). Merging K4b blocks
rescales them by exp of differences of f32 maxima: 1e-5 of max |v|. N1
reads the same values as its plain version: max |x| and the counts agree
exactly, the sums of squares to f32 summation order (1e-5 relative).
"""

import contextlib
import copy
import itertools
import time

import pytest
import torch

from hydragnn_tpu_torch.ops import flash_attention as t_flash
from hydragnn_tpu_torch.ops import fused_edge as t_fused
from hydragnn_tpu_torch.ops import multi_agg as t_multi
from hydragnn_tpu_torch.ops import numerics_stats as t_nstats
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,recv,gate", [(256, True, False), (33, True, True), (5, False, False),
                                          (3, False, True)])
def pytest_k3_kernel_matches_plain_on_card(cuda, dtype, c, recv, gate):
    """Empty rows (a run and the last-but-one), three long rows side by side
    on the chunked two-pass route (and one just under its threshold) and a
    long dummy last row."""
    gen = torch.Generator(device=cuda).manual_seed(c)
    n = 400
    deg = torch.randint(0, 30, (n,), generator=gen, device=cuda)
    deg[10:25] = 0
    deg[200:203] = torch.tensor([65, 300, 64], device=cuda)
    deg[-2] = 0
    deg[-1] = 900
    ids = torch.repeat_interleave(torch.arange(n, device=cuda), deg)
    e = ids.shape[0]
    ops = [torch.randn(n, c, generator=gen, device=cuda).to(dtype) if recv else None,
           torch.randn(e, c, generator=gen, device=cuda).to(dtype),
           torch.randn(e, c, generator=gen, device=cuda).to(dtype) if gate else None]
    before = t_multi.fused_multi_agg.launches
    got = t_multi.fused_multi_agg(*ops, ids, n)
    want = t_multi.reference_multi_agg(*ops, ids, n)
    torch.cuda.synchronize()
    assert t_multi.fused_multi_agg.launches == before + 1
    names = ("sum", "count", "min", "max", "sumsq")
    for name, a, b in zip(names, got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        if name in ("count", "min", "max"):
            assert torch.equal(a, b), name
        else:
            tol = 1e-5 * max(float(b.abs().max()), 1.0)
            assert float((a - b).abs().max()) <= tol, name
    assert float(got[2][10:25].abs().sum() + got[3][10:25].abs().sum()) == 0.0


def _attention_case(cuda, dtype, h, d, sizes, n_pad, seed):
    """q/k/v [N, H, d] over graphs of the given sizes, then n_pad padding
    nodes in the dummy graph."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    sizes = torch.tensor(sizes, device=cuda)
    g = sizes.shape[0]
    node_graph = torch.cat([torch.repeat_interleave(torch.arange(g, device=cuda), sizes),
                            torch.full((n_pad,), g, device=cuda)])
    n = node_graph.shape[0]
    node_mask = torch.arange(n, device=cuda) < int(sizes.sum())
    qkv = [torch.randn(n, h, d, generator=gen, device=cuda).to(dtype) for _ in range(3)]
    return qkv, node_graph, node_mask, g + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,d", [(8, 32), (2, 8), (1, 128)])
def pytest_k4_kernel_matches_plain_on_card(cuda, dtype, h, d):
    """A single-node graph, graphs across q tiles, a graph of 225 nodes (the
    serving bound) and padding rows, which come out 0."""
    sizes = [1, 40, 225, 3, 70, 1, 128, 17]
    qkv, node_graph, node_mask, g = _attention_case(cuda, dtype, h, d, sizes, 37, d)
    before = t_flash.flash_self_attention.launches
    got = t_flash.flash_self_attention(*qkv, node_graph, node_mask, g, max(sizes))
    want = t_flash.reference_masked_attention(*qkv, node_graph, node_mask)
    gathered = t_flash.reference_gathered_attention(*qkv, node_graph, node_mask, g, max(sizes))
    torch.cuda.synchronize()
    assert t_flash.flash_self_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape and got.is_contiguous()
    assert float(got[~node_mask].float().abs().sum()) == 0.0
    scale = float(qkv[2].float().abs().max())
    tol = (1e-5 if dtype == torch.float32 else 2e-2) * scale
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert float((got.float() - gathered.float()).abs().max()) <= tol


@pytest.mark.gpu
def pytest_k4_kernel_takes_row_strided_views_of_a_fused_projection(cuda):
    qkv, node_graph, node_mask, g = _attention_case(cuda, torch.float32, 4, 16, [30, 50], 5, 1)
    fused = torch.cat([t.reshape(t.shape[0], -1) for t in qkv], dim=1)  # [N, 3 * H * d]
    views = [t.view(-1, 4, 16) for t in fused.split(64, dim=1)]
    assert views[0].stride(0) == 192
    got = t_flash.flash_self_attention(*views, node_graph, node_mask, g, 50)
    want = t_flash.flash_self_attention(*[t.contiguous() for t in qkv], node_graph, node_mask,
                                        g, 50)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="head dim"):
        t_flash.flash_self_attention(*[t[..., :12] for t in qkv], node_graph, node_mask, g, 50)


@pytest.mark.gpu
def pytest_gps_pna_kernels_match_the_plain_route_on_card(cuda):
    """A small GPS-PNA on the card: K3 and K4 in every layer against the same
    weights on the plain route (unsorted, dense attention), f32, real rows
    to 1e-4 of each head's largest value."""
    import copy

    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.data import (GraphLoader, add_dataset_pe, oc20_shaped_dataset,
                                         split_dataset)
    from hydragnn_tpu_torch.models import create_model

    graphs = add_dataset_pe(oc20_shaped_dataset(16, mean_atoms=20, min_atoms=10, max_atoms=40), 4)
    splits = split_dataset(graphs, 0.75)
    arch = {"mpnn_type": "PNA", "radius": 5.0, "max_neighbours": 20, "hidden_dim": 64,
            "num_conv_layers": 2, "global_attn_engine": "GPS", "global_attn_type": "multihead",
            "global_attn_heads": 4, "pe_dim": 4, "dropout": 0.0,
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
    plain_cfg["NeuralNetwork"]["Architecture"].update(use_sorted_aggregation=False,
                                                      use_flash_attention=False)
    model = create_model(update_config(cfg, *splits), device=cuda)
    plain = create_model(update_config(plain_cfg, *splits), device=cuda)
    plain.load_state_dict(model.state_dict())
    batch = next(iter(GraphLoader(splits[0], 8, sort_edges=True))).to(cuda)
    k3, k4 = t_multi.fused_multi_agg.launches, t_flash.flash_self_attention.launches
    with torch.no_grad():
        got, want = model(batch), plain(batch)
    torch.cuda.synchronize()
    assert t_multi.fused_multi_agg.launches - k3 == 2
    assert t_flash.flash_self_attention.launches - k4 == 2
    for k in want:
        m = batch.graph_mask if want[k].shape[0] == batch.num_graphs else batch.node_mask
        scale = float(want[k][m].abs().max())
        assert float((got[k][m] - want[k][m]).abs().max()) <= 1e-4 * scale, k


def _block_case(cuda, dtype, n_q, n_k, h, d, seed, p_mask=0.2):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(n_q, h, d, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(n_k, h, d, generator=gen, device=cuda).to(dtype) for _ in range(2))
    key_mask = torch.rand(n_k, generator=gen, device=cuda) > p_mask
    return q, k, v, key_mask


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_q,n_k,h,d", [(300, 300, 8, 32), (70, 513, 2, 8), (513, 70, 1, 128),
                                         (33, 5, 4, 16)])
def pytest_k4b_kernel_matches_plain_on_card(cuda, dtype, n_q, n_k, h, d):
    """Square and n_q != n_k blocks, key blocks shorter and longer than a
    shared-memory tile, a fifth of the keys masked."""
    q, k, v, key_mask = _block_case(cuda, dtype, n_q, n_k, h, d, seed=n_q + n_k)
    before = t_flash.flash_block_summary.launches
    got = t_flash.flash_block_summary(q, k, v, key_mask)
    want = t_flash.reference_block_summary(q, k, v, key_mask)
    torch.cuda.synchronize()
    assert t_flash.flash_block_summary.launches == before + 1
    rtol = 1e-5 if dtype == torch.float32 else 2e-2
    for name, a, b in zip(("m", "l", "acc"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= rtol * scale, name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def pytest_k4b_fully_masked_block_on_card(cuda, dtype):
    """A block of padding keys only: (-1e30, 0, 0) in the operand dtype, the
    merge-neutral partial, as the plain version gives."""
    q, k, v, _ = _block_case(cuda, dtype, 40, 100, 2, 16, seed=3)
    none = torch.zeros(100, dtype=torch.bool, device=cuda)
    m, l, acc = t_flash.flash_block_summary(q, k, v, none)
    want = t_flash.reference_block_summary(q, k, v, none)
    torch.cuda.synchronize()
    assert float(m.float().max()) <= -1e29
    assert float(l.abs().max()) == 0.0 and float(acc.abs().max()) == 0.0
    for a, b in zip((m, l, acc), want):
        assert torch.equal(a, b)


@pytest.mark.gpu
def pytest_k4b_blocks_merge_to_one_call_on_card(cuda):
    """Four key blocks through K4b merged by the ring's ``_block_attend``
    against one K4b call over all keys, and against ring attention on the
    dense route (f32)."""
    from hydragnn_tpu_torch.parallel import ring_self_attention
    from hydragnn_tpu_torch.parallel.ring_attention import _block_attend

    n, h, d = 1030, 8, 32
    q, k, v, key_mask = _block_case(cuda, torch.float32, n, n, h, d, seed=11)
    key_mask[-300:] = False  # the last block is mostly padding
    m, l, acc = t_flash.flash_block_summary(q, k, v, key_mask)
    whole = acc / l[..., None]
    mm = torch.full((n, h), torch.finfo(torch.float32).min, device=cuda)
    denom, accm = torch.zeros(n, h, device=cuda), torch.zeros_like(q)
    before = t_flash.flash_block_summary.launches
    for kb, vb, mb in zip(k.chunk(4), v.chunk(4), key_mask.chunk(4)):
        mm, denom, accm = _block_attend(q, kb, vb, mb, mm, denom, accm, d**-0.5, use_flash=True)
    merged = accm / denom[..., None]
    dense = ring_self_attention(q, k, v, key_mask, use_flash=False)
    torch.cuda.synchronize()
    assert t_flash.flash_block_summary.launches == before + 4
    tol = 1e-5 * float(v.abs().max())
    assert float((merged - whole).abs().max()) <= tol
    assert float((merged - dense).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 8])
def pytest_k1_narrow_rows_match_plain_on_card(cuda, dtype, c):
    """The narrow-row layout (a group of lanes per row up to 16 bytes a
    row): ids that start above 0, empty runs inside and at the end, long
    rows walked by the whole block (three in one block) and a long last
    real row."""
    gen = torch.Generator(device=cuda).manual_seed(100 + c)
    n = 300
    deg = torch.randint(0, 20, (n,), generator=gen, device=cuda)
    deg[:7] = 0
    deg[50:60] = 0
    deg[100:103] = torch.tensor([65, 200, 64], device=cuda)
    deg[-40] = 900
    deg[-39:] = 0
    ids = torch.repeat_interleave(torch.arange(n, device=cuda), deg)
    msg = torch.randn(ids.shape[0], c, generator=gen, device=cuda).to(dtype)
    got = t_sorted.sorted_segment_sum(msg, ids, n)
    want = t_sorted.sorted_segment_sum_plain(msg, ids, n)
    torch.cuda.synchronize()
    assert float(got[:7].float().abs().sum() + got[-39:].float().abs().sum()) == 0.0
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [3, 866])
def pytest_k1_is_deterministic_and_one_launch_on_card(cuda, c):
    """Two calls give bitwise-equal sums (no atomics, fixed order), and each
    call is one device kernel: no row-pointer kernel before it."""
    gen = torch.Generator(device=cuda).manual_seed(c)
    deg = torch.randint(0, 30, (2000,), generator=gen, device=cuda)
    deg[-1] = 700
    ids = torch.repeat_interleave(torch.arange(2000, device=cuda), deg)
    msg = torch.randn(ids.shape[0], c, generator=gen, device=cuda)
    first = t_sorted.sorted_segment_sum(msg, ids, 2000)
    torch.cuda.synchronize()
    before = t_sorted.sorted_segment_sum.launches
    kernels, second = _recorded_kernels(lambda: t_sorted.sorted_segment_sum(msg, ids, 2000))
    assert t_sorted.sorted_segment_sum.launches == before + 2
    assert sum(ev.count for ev in kernels) == 1, [ev.key for ev in kernels]
    assert torch.equal(first, second)


def _recorded_kernels(fn):
    """The device kernels of one call of ``fn`` under torch.profiler, after
    one call profiled to warm the profiler up and not recorded (a cold
    profile can drop a call's kernels), and the recorded call's result."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        out = fn()
        torch.cuda.synchronize()
    return [ev for ev in prof.key_averages() if str(ev.device_type).endswith("CUDA")], out


def _check_summary(got, want, dtype):
    rtol = 1e-5 if dtype == torch.float32 else 2e-2
    for name, a, b in zip(("m", "l", "acc"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= rtol * scale, name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", t_flash.HEAD_DIMS)
def pytest_flash_kernels_every_head_dim_on_card(cuda, dtype, d):
    """K4 and K4b at every head dim the wrapper takes (d below the MMA depth
    zero-padded, d = 64 and 128 on shorter key tiles)."""
    sizes = [1, 40, 130, 3, 70]
    qkv, node_graph, node_mask, g = _attention_case(cuda, dtype, 2, d, sizes, 11, d + 1)
    got = t_flash.flash_self_attention(*qkv, node_graph, node_mask, g, max(sizes))
    want = t_flash.reference_masked_attention(*qkv, node_graph, node_mask)
    q, k, v, key_mask = _block_case(cuda, dtype, 150, 170, 2, d, seed=d)
    got_b = t_flash.flash_block_summary(q, k, v, key_mask)
    want_b = t_flash.reference_block_summary(q, k, v, key_mask)
    torch.cuda.synchronize()
    assert float(got[~node_mask].float().abs().sum()) == 0.0
    tol = (1e-5 if dtype == torch.float32 else 2e-2) * float(qkv[2].float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol
    _check_summary(got_b, want_b, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_q,n_k", [(1, 65), (15, 17), (17, 15), (63, 65), (65, 63), (65, 1),
                                     (8194, 63), (63, 8194), (8194, 8194)])
def pytest_k4b_query_and_key_counts_on_card(cuda, dtype, n_q, n_k):
    """Query and key counts on both sides of the 16-row and 64-key tiles,
    up to the gin_ring block of 8,194."""
    q, k, v, key_mask = _block_case(cuda, dtype, n_q, n_k, 2, 32, seed=n_q * 7 + n_k)
    got = t_flash.flash_block_summary(q, k, v, key_mask)
    want = t_flash.reference_block_summary(q, k, v, key_mask)
    torch.cuda.synchronize()
    _check_summary(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 128])
def pytest_k4b_all_masked_tile_between_valid_ones_on_card(cuda, dtype, d):
    """Keys 64-191 masked: whole key tiles skipped between tiles that
    attend, and a partly masked tile at each edge of the run."""
    q, k, v, key_mask = _block_case(cuda, dtype, 100, 300, 2, d, seed=5, p_mask=0.0)
    key_mask[64:192] = False
    key_mask[40:50] = False
    got = t_flash.flash_block_summary(q, k, v, key_mask)
    want = t_flash.reference_block_summary(q, k, v, key_mask)
    torch.cuda.synchronize()
    _check_summary(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 2, 4])
def pytest_flash_kernels_take_misaligned_row_strided_views_on_card(cuda, dtype, offset):
    """q, k, v as views of one fused projection that starts `offset`
    elements into its rows, so the rows are not 16-byte aligned (bf16 at
    offset 1: 2-byte aligned): the same result as contiguous copies."""
    h, d, n = 2, 32, 150
    qkv, node_graph, node_mask, g = _attention_case(cuda, dtype, h, d, [60, 80], 10, offset)
    fused = torch.zeros(n, offset + 3 * h * d + 3, dtype=dtype, device=cuda)
    fused[:, offset:offset + 3 * h * d] = torch.cat([t.reshape(n, -1) for t in qkv], dim=1)
    views = [fused[:, offset + i * h * d:offset + (i + 1) * h * d].view(n, h, d)
             for i in range(3)]
    size = fused.element_size()
    assert any(t.data_ptr() % 16 or t.stride(0) * size % 16 for t in views)
    got = t_flash.flash_self_attention(*views, node_graph, node_mask, g, 80)
    want = t_flash.flash_self_attention(*qkv, node_graph, node_mask, g, 80)
    got_b = t_flash.flash_block_summary(*views, node_mask)
    want_b = t_flash.flash_block_summary(*qkv, node_mask)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for a, b in zip(got_b, want_b):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci,co", [(33, 129), (258, 130), (17, 300), (866, 866)])
def pytest_k2_ragged_widths_and_rows_across_edge_tiles_on_card(cuda, dtype, ci, co):
    """Widths off the 128-column tile and the k slice (odd bf16 rows take the
    element-wise loads); a row of 300 edges across three 128-edge tiles with
    empty rows on both sides, and a dummy last row of 700."""
    gen = torch.Generator(device=cuda).manual_seed(ci + co)
    n = 120
    deg = torch.randint(0, 30, (n,), generator=gen, device=cuda)
    deg[40:45] = 0
    deg[45] = 300
    deg[46:50] = 0
    deg[-1] = 700
    ids = torch.repeat_interleave(torch.arange(n, device=cuda), deg)
    e = ids.shape[0]
    ops = [torch.randn(n, ci, generator=gen, device=cuda),
           torch.randn(e, ci, generator=gen, device=cuda),
           torch.randn(ci, co, generator=gen, device=cuda) / ci**0.5,
           torch.randn(co, generator=gen, device=cuda)]
    ops = [o.to(dtype) for o in ops]
    before = t_fused.fused_edge_message_sum.launches
    got = t_fused.fused_edge_message_sum(*ops, ids, n)
    want = t_fused.reference_edge_message_sum(*ops, ids, n)
    torch.cuda.synchronize()
    assert t_fused.fused_edge_message_sum.launches == before + 1
    assert got.dtype == dtype and got.shape == (n, co)
    assert float(got[40:45].float().abs().sum() + got[46:50].float().abs().sum()) == 0.0
    scale = float(want.float().abs().max())
    atol, rtol = (1e-3, 1e-4) if dtype == torch.float32 else (5e-2, 2e-2)
    assert float((got.float() - want.float()).abs().max()) <= atol + rtol * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def pytest_k2_and_k3_give_the_same_bits_twice_on_card(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(7)
    n, c = 500, 256
    deg = torch.randint(0, 30, (n,), generator=gen, device=cuda)
    deg[-1] = 3000
    ids = torch.repeat_interleave(torch.arange(n, device=cuda), deg)
    e = ids.shape[0]
    nr = torch.randn(n, c, generator=gen, device=cuda).to(dtype)
    ei = torch.randn(e, c, generator=gen, device=cuda).to(dtype)
    w = (torch.randn(c, c, generator=gen, device=cuda) / c**0.5).to(dtype)
    b = torch.randn(c, generator=gen, device=cuda).to(dtype)
    k2 = [t_fused.fused_edge_message_sum(nr, ei, w, b, ids, n) for _ in range(2)]
    k3 = [t_multi.fused_multi_agg(nr, ei, None, ids, n) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(k2[0], k2[1])
    for a, b_ in zip(*k3):
        assert torch.equal(a, b_)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def pytest_k3_is_one_launch_on_card(cuda, dtype):
    """One device kernel per call, with a split dummy row: no row-pointer
    kernel, no separate long-row pass, no memset."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    deg = torch.randint(0, 30, (1000,), generator=gen, device=cuda)
    deg[-1] = 2000
    ids = torch.repeat_interleave(torch.arange(1000, device=cuda), deg)
    nr = torch.randn(1000, 256, generator=gen, device=cuda).to(dtype)
    ei = torch.randn(ids.shape[0], 256, generator=gen, device=cuda).to(dtype)
    first = t_multi.fused_multi_agg(nr, ei, None, ids, 1000)
    torch.cuda.synchronize()
    before = t_multi.fused_multi_agg.launches
    kernels, second = _recorded_kernels(lambda: t_multi.fused_multi_agg(nr, ei, None, ids, 1000))
    assert t_multi.fused_multi_agg.launches == before + 2
    assert sum(ev.count for ev in kernels) == 1, [ev.key for ev in kernels]
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("long_deg", [255, 256, 257, 511, 512, 513, 1500])
@pytest.mark.parametrize("offset", [0, 100])
def pytest_k3_long_rows_around_the_chunk_size_on_card(cuda, dtype, long_deg, offset):
    """Rows at and just above the 256-edge chunk, starting on a chunk
    boundary or off it: one in the middle, two side by side, and the dummy
    last row; the moments exact in count, min and max."""
    gen = torch.Generator(device=cuda).manual_seed(long_deg + offset)
    n = 60
    deg = torch.randint(0, 10, (n,), generator=gen, device=cuda)
    deg[0] = offset
    deg[20] = long_deg
    deg[30] = long_deg
    deg[31] = long_deg
    deg[-1] = long_deg
    ids = torch.repeat_interleave(torch.arange(n, device=cuda), deg)
    e = ids.shape[0]
    nr = torch.randn(n, 256, generator=gen, device=cuda).to(dtype)
    ei = torch.randn(e, 256, generator=gen, device=cuda).to(dtype)
    for _ in range(2):  # the arrival counters are back at 0 for the second call
        got = t_multi.fused_multi_agg(nr, ei, None, ids, n)
        want = t_multi.reference_multi_agg(nr, ei, None, ids, n)
        torch.cuda.synchronize()
        for name, a, b in zip(("sum", "count", "min", "max", "sumsq"), got, want):
            if name in ("count", "min", "max"):
                assert torch.equal(a, b), name
            else:
                assert float((a - b).abs().max()) <= 3e-5 * max(float(b.abs().max()), 1.0), name


@pytest.mark.gpu
def pytest_k1_plain_version_gives_the_same_bits_twice_on_card(cuda):
    """The fixed-order plain route (segment_reduce over the row lengths),
    unlike index_add_'s atomics, adds in the same order on every call."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    deg = torch.randint(0, 30, (3000,), generator=gen, device=cuda)
    deg[-1] = 5000
    ids = torch.repeat_interleave(torch.arange(3000, device=cuda), deg)
    msg = torch.randn(ids.shape[0], 256, generator=gen, device=cuda)
    a = t_sorted.sorted_segment_sum_plain(msg, ids, 3000)
    b = t_sorted.sorted_segment_sum_plain(msg, ids, 3000)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    # index_add_ sums in another order: the 5,000-edge row differs by f32
    # rounding, 1e-5 of the largest sum
    other = t_sorted.segment_sum_plain(msg, ids, 3000)
    assert float((a - other).abs().max()) <= 1e-5 * float(other.abs().max())


def _ascending_ids(cuda, n, mean_degree, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    deg = torch.randint(0, 2 * mean_degree + 1, (n,), generator=gen, device=cuda)
    return torch.repeat_interleave(torch.arange(n, device=cuda), deg), gen


# gradients of the kernels' Functions against their plain versions' or an
# independent route's autograd (they see the forwards' rounding through
# tanh'; in bf16 K4 rounds p to bf16 where the independent route keeps f32):
# f32 1e-4, bf16 3e-2 of the largest value of each gradient
_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _assert_grads_close(got, want, dtype):
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        scale = max(float(b.float().abs().max()), 1e-12)
        assert float((a.float() - b.float()).abs().max()) <= _GRAD_TOL[dtype] * scale, i


def _first_and_second(fn, inputs, w, v):
    """d/dinputs of L = sum(w tanh(fn(inputs))), then d/dinputs of
    <dL/dinputs[0], v> (a double backward, as the energy-force loss takes)."""
    out = fn(*inputs)
    g = torch.autograd.grad(torch.sum(w * torch.tanh(out.float())), inputs, create_graph=True)
    gg = torch.autograd.grad(torch.sum(g[0].float() * v), inputs, allow_unused=True)
    return [t.detach() for t in g], [torch.zeros_like(x) if t is None else t for t, x in zip(gg, inputs)]


@pytest.mark.gpu
@pytest.mark.parametrize("plain", ["sorted_segment_sum_plain", "segment_sum_plain"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c", [(300, 33), (2272, 866), (2272, 3)])
def pytest_k1_function_gradients_match_plain_on_card(cuda, dtype, n, c, plain):
    """K1's Function, first and second order, at a small and at the EGNN
    path's shapes (about 16 edges per row), against the fixed-order plain
    version (the same Function, another forward) and against
    ``index_add_`` through ordinary autograd (none of K1's code): one
    forward launch, none in either backward."""
    ids, gen = _ascending_ids(cuda, n, 16, c)
    msg = torch.randn(ids.shape[0], c, generator=gen, device=cuda).to(dtype)
    w = torch.randn(n, c, generator=gen, device=cuda)
    v = torch.randn(ids.shape[0], c, generator=gen, device=cuda)
    before = t_sorted.sorted_segment_sum.launches
    got = _first_and_second(lambda m: t_sorted.sorted_segment_sum(m, ids, n),
                            [msg.clone().requires_grad_(True)], w, v)
    torch.cuda.synchronize()
    assert t_sorted.sorted_segment_sum.launches == before + 1
    want = _first_and_second(lambda m: getattr(t_sorted, plain)(m, ids, n),
                             [msg.clone().requires_grad_(True)], w, v)
    for a, b in zip(got, want):
        _assert_grads_close(a, b, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,ci,co", [(300, 64, 64), (2272, 866, 866)])
def pytest_k2_function_gradients_match_plain_on_card(cuda, dtype, n, ci, co):
    """K2's Function (backward: the recompute through the dense plain
    version), first and second order, for all four float inputs, against
    the plain version's own autograd; one forward launch, none in either
    backward."""
    ids, gen = _ascending_ids(cuda, n, 16, ci)
    e = ids.shape[0]
    inputs = [torch.randn(n, ci, generator=gen, device=cuda),
              torch.randn(e, ci, generator=gen, device=cuda),
              torch.randn(ci, co, generator=gen, device=cuda) / ci**0.5,
              0.1 * torch.randn(co, generator=gen, device=cuda)]
    inputs = [t.to(dtype) for t in inputs]
    w = torch.randn(n, co, generator=gen, device=cuda)
    v = torch.randn(n, ci, generator=gen, device=cuda)
    before = t_fused.fused_edge_message_sum.launches
    got = _first_and_second(lambda *a: t_fused.fused_edge_message_sum(*a, ids, n),
                            [t.clone().requires_grad_(True) for t in inputs], w, v)
    torch.cuda.synchronize()
    assert t_fused.fused_edge_message_sum.launches == before + 1
    want = _first_and_second(lambda *a: t_fused.reference_edge_message_sum(*a, ids, n),
                             [t.clone().requires_grad_(True) for t in inputs], w, v)
    for a, b in zip(got, want):
        _assert_grads_close(a, b, dtype)


def _function_against(fn, independent, inputs, wrapper, dtype, seed):
    """First- and second-order gradients of ``fn`` (a kernel's Function)
    against ``independent`` (ordinary autograd, none of the kernel's code)
    through chip_smoke's ``first_and_second``: one forward launch, none in
    either backward; each gradient within ``_GRAD_TOL``."""
    from chip_smoke import first_and_second

    want_1, want_2, scales = first_and_second(independent, inputs, seed)
    before = wrapper.launches
    got_1, got_2, _ = first_and_second(fn, inputs, seed, scales)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    for got, want in ((got_1, want_1), (got_2, want_2)):
        _assert_grads_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,deg,c,gate", [(64, 4, 32, True), (1100, 16, 256, False)])
def pytest_k3_function_gradients_match_autograd_on_card(cuda, dtype, n, deg, c, gate):
    """K3's Function (its backward the recompute through
    ``reference_multi_agg``) at a small shape with a gate and at the GPS-PNA
    path's (C = 256, about 16 edges per row), against
    ``reference_multi_agg``'s own autograd; under no_grad the wrapper runs
    without it."""
    ids, gen = _ascending_ids(cuda, n, deg, c)
    e = ids.shape[0]
    inputs = [torch.randn(r, c, generator=gen, device=cuda).to(dtype)
              for r in ((n, e, e) if gate else (n, e))]

    def call(fn):
        return lambda nr, ei, g=None: fn(nr, ei, g, ids, n)

    _function_against(call(t_multi.fused_multi_agg), call(t_multi.reference_multi_agg), inputs,
                      t_multi.fused_multi_agg, dtype, c)
    with torch.no_grad():
        out = t_multi.fused_multi_agg(*inputs[:2], None, ids, n)
    assert not any(o.requires_grad for o in out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sizes,h,d", [([1, 40, 3, 17], 2, 16), ("path", 8, 32)])
def pytest_k4_function_gradients_match_autograd_on_card(cuda, dtype, sizes, h, d):
    """K4's Function (its backward the recompute through
    ``reference_gathered_attention``) with padding rows, at a small shape
    and at the GPS-PNA path's (16 graphs of 20 to 130 nodes, 8 heads of
    32), against softmax attention written with ordinary autograd."""
    from chip_smoke import dense_attention

    if sizes == "path":
        gen = torch.Generator().manual_seed(16)
        sizes = torch.randint(20, 131, (16,), generator=gen).tolist()
    qkv, node_graph, node_mask, g = _attention_case(cuda, dtype, h, d, sizes, 9, len(sizes))
    valid = ((node_graph[:, None] == node_graph[None, :]) & node_mask[:, None]
             & node_mask[None, :])
    nmax = max(sizes)
    _function_against(
        lambda q, k, v: t_flash.flash_self_attention(q, k, v, node_graph, node_mask, g, nmax),
        lambda q, k, v: dense_attention(q, k, v, valid), qkv, t_flash.flash_self_attention,
        dtype, d)


@pytest.mark.gpu
@pytest.mark.parametrize("n_q,n_k,h,d,p_mask", [(150, 170, 2, 16, 0.2), (40, 60, 2, 16, 1.0),
                                                (8194, 8194, 8, 32, 0.0)])
def pytest_k4b_function_gradients_match_autograd_on_card(cuda, n_q, n_k, h, d, p_mask):
    """K4b's Function (its backward the recompute through
    ``reference_block_summary`` in blocks of query rows), f32 as on the SP
    path: some keys masked, every key masked (fully masked rows: zero
    gradients), and the gin_ring path's 8,194 x 8,194 block (several row
    blocks), against the block summary written with ordinary autograd."""
    from chip_smoke import dense_block_summary

    q, k, v, key_mask = _block_case(cuda, torch.float32, n_q, n_k, h, d, seed=n_q, p_mask=p_mask)
    if n_k == 8194:
        key_mask[-2:] = False  # the spanning batch's two padding nodes
    _function_against(
        lambda q_, k_, v_: t_flash.flash_block_summary(q_, k_, v_, key_mask),
        lambda q_, k_, v_: dense_block_summary(q_, k_, v_, key_mask), [q, k, v],
        t_flash.flash_block_summary, torch.float32, d)
    with torch.inference_mode():
        assert not any(o.requires_grad for o in t_flash.flash_block_summary(q, k, v, key_mask))


@pytest.mark.gpu
def pytest_pool_routes_agree_on_card(cuda):
    """The graph mean pool's fixed-order route (contiguous graphs) and its
    index_add_ route agree on ascending ids (f32 sums in another order,
    1e-6 of the largest mean), and an unsorted layout pools as on the CPU."""
    from hydragnn_tpu_torch.ops.segment import masked_global_mean_pool

    gen = torch.Generator(device=cuda).manual_seed(4)
    node_graph = torch.repeat_interleave(torch.arange(33, device=cuda),
                                         torch.randint(10, 120, (33,), generator=gen,
                                                       device=cuda))
    n = node_graph.shape[0]
    x = torch.randn(n, 866, generator=gen, device=cuda)
    mask = torch.rand(n, generator=gen, device=cuda) < 0.95
    a = masked_global_mean_pool(x, node_graph, 33, mask, contiguous=True)
    b = masked_global_mean_pool(x, node_graph, 33, mask, contiguous=False)
    torch.cuda.synchronize()
    assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    perm = torch.randperm(n, generator=gen, device=cuda)
    c = masked_global_mean_pool(x[perm], node_graph[perm], 33, mask[perm])
    d = masked_global_mean_pool(x[perm].cpu(), node_graph[perm].cpu(), 33, mask[perm].cpu())
    assert float((c.cpu() - d).abs().max()) <= 1e-6 * float(d.abs().max())
    assert float((c - b).abs().max()) <= 1e-6 * float(b.abs().max())


@pytest.mark.gpu
def pytest_checkpoint_moves_between_card_and_cpu(cuda, tmp_path):
    """A checkpoint of a state trained on the card (AdamW capturable, its
    step counts on the card) restores bit for bit into a state on the CPU,
    and one saved on the CPU restores into a state on the card: the
    payload holds CPU tensors and a restore copies them in place."""
    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.data import oc20_shaped_dataset, split_dataset
    from hydragnn_tpu_torch.models import create_model
    from hydragnn_tpu_torch.train import TrainState, make_optimizer, make_train_step
    from hydragnn_tpu_torch.train import checkpoint as ck

    import chip_smoke

    graphs = oc20_shaped_dataset(16, mean_atoms=20, min_atoms=10, max_atoms=40)
    config, (loader, _, _), _ = prepare_data(chip_smoke.train_config(batch_size=4, hidden=32,
                                                                     head=16),
                                             split_dataset(graphs, 0.75))

    def state_on(device, seed):
        m = create_model(config, device=device, seed=seed)
        return TrainState.create(m, make_optimizer(m, {"type": "AdamW", "learning_rate": 1e-3}))

    def tensors(state):
        out = dict(state.model.state_dict())
        for i, st in state.optimizer.state_dict()["state"].items():
            out.update({f"opt.{i}.{k}": v for k, v in st.items()})
        return {k: v.cpu() for k, v in out.items()}, (int(state.step), state.learning_rate)

    card = state_on(cuda, 1)
    step = make_train_step(card.model, mixed_precision=True)
    for b in list(loader)[:2]:
        step(card, b)
    ck.save_model(card, "card", path=str(tmp_path))
    host = state_on("cpu", 2)
    ck.load_existing_model(host, "card", path=str(tmp_path))
    (want, wm), (got, gm) = tensors(card), tensors(host)
    assert wm == gm and set(want) == set(got)
    assert all(torch.equal(want[k], got[k]) for k in want)
    ck.save_model(host, "host", path=str(tmp_path))
    back = state_on(cuda, 3)
    ck.load_existing_model(back, "host", path=str(tmp_path))
    got, gm = tensors(back)
    assert gm == wm and all(torch.equal(want[k], got[k]) for k in want)
    assert all(t.device.type == "cuda" for t in back.held)


# ---------------------------------------------------------------------------
# the message-passing zoo's shapes: K1 at C = 4 (SAGE's and MFC's first
# layer, CGCNN at the OC20 input width), 126 (SchNet's filters on MD17),
# 128 (DimeNet's output block), 1,536 (GAT's six concatenated heads of 256)
# and 2,304 (MACE's 256 channels x 9 irrep components); K3 with edge_in
# alone (PNAEq) and with node_recv and a gate (PNAPlus) at C = 256


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c", [(2272, 4), (700, 126), (1100, 128), (400, 1536),
                                 (1100, 2304)])
def pytest_k1_zoo_widths_match_plain_on_card(cuda, dtype, n, c):
    """K1's forward against its fixed-order plain version, and its
    Function's first- and second-order gradients against ``index_add_``
    through ordinary autograd, at about 16 edges per row; one forward
    launch, none in either backward."""
    ids, gen = _ascending_ids(cuda, n, 16, c)
    msg = torch.randn(ids.shape[0], c, generator=gen, device=cuda).to(dtype)
    got = t_sorted.sorted_segment_sum(msg, ids, n)
    want = t_sorted.sorted_segment_sum_plain(msg, ids, n)
    torch.cuda.synchronize()
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=atol)
    _function_against(lambda m: t_sorted.sorted_segment_sum(m, ids, n),
                      lambda m: t_sorted.segment_sum_plain(m, ids, n), [msg],
                      t_sorted.sorted_segment_sum, dtype, c)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["edge_in only", "node_recv and gate"])
def pytest_k3_zoo_variants_match_plain_on_card(cuda, dtype, variant):
    """K3 at the zoo's shapes (C = 256, 16 OC20-shaped graphs' worth of
    rows at about 16 edges each, a long dummy last row): the moments
    against ``reference_multi_agg`` (count, min and max exactly), then the
    Function's first- and second-order gradients against its autograd; the
    launch counted under the variant's case."""
    n, c = 1100, 256
    ids, gen = _ascending_ids(cuda, n, 16, 7)
    ids = torch.cat([ids, torch.full((3000,), n - 1, dtype=ids.dtype, device=cuda)])
    e = ids.shape[0]
    full = variant != "edge_in only"
    inputs = [torch.randn(r, c, generator=gen, device=cuda).to(dtype)
              for r in ((n, e, e) if full else (e,))]

    def call(fn):
        if full:
            return lambda nr, ei, g: fn(nr, ei, g, ids, n)
        return lambda ei: fn(None, ei, None, ids, n)

    case = f"{str(dtype)[6:]}/C{c}/" + ("gate" if full else "edge_in only")
    before = t_multi.fused_multi_agg.launches_by_case[case]
    got = call(t_multi.fused_multi_agg)(*inputs)
    want = call(t_multi.reference_multi_agg)(*inputs)
    torch.cuda.synchronize()
    assert t_multi.fused_multi_agg.launches_by_case[case] == before + 1
    for name, a, b in zip(("sum", "count", "min", "max", "sumsq"), got, want):
        if name in ("count", "min", "max"):
            assert torch.equal(a, b), name
        else:
            assert float((a - b).abs().max()) <= 1e-5 * max(float(b.abs().max()), 1.0), name
    _function_against(call(t_multi.fused_multi_agg), call(t_multi.reference_multi_agg), inputs,
                      t_multi.fused_multi_agg, dtype, 11)


# launches of one forward of each zoo conv's model (2 conv layers) through
# the kernels, f32: kernel -> count
ZOO_LAUNCHES = {
    "SAGE": {"K1": 2}, "MFC": {"K1": 2}, "CGCNN": {"K1": 2}, "GAT": {"K1": 2},
    "SchNet": {"K1": 2}, "PAINN": {"K1": 2}, "PNAPlus": {"K3": 2}, "PNAEq": {"K3": 2},
    "DimeNet": {"K1": 2}, "MACE": {"K1": 2},
}
# the blocks of DimeNet and MACE at this width (the bench cells' sizes)
ZOO_ARCH = {"DimeNet": dict(num_radial=6, num_spherical=7, basis_emb_size=8, int_emb_size=16,
                            out_emb_size=32),
            "MACE": dict(num_radial=8, max_ell=2, node_max_ell=2, correlation=3)}


def _zoo_config(model, layers, node_type="mlp", branches=1, loss="mae", gps=False):
    """``(config, splits)`` of a zoo conv's model (hidden 64) on the sorted
    route over 16 OC20-shaped graphs (see ``_zoo_models``); ``gps``: GPS
    global attention (2 heads) over it, the graphs with Laplacian PE."""
    import dataclasses

    from hydragnn_tpu_torch.data import add_dataset_pe, oc20_shaped_dataset, split_dataset

    graphs = [dataclasses.replace(g, dataset_id=i % branches) for i, g in enumerate(
        oc20_shaped_dataset(16, mean_atoms=20, min_atoms=10, max_atoms=40))]
    if gps:
        graphs = add_dataset_pe(graphs, 4)
    splits = split_dataset(graphs, 0.75)
    heads = {"graph": {"num_sharedlayers": 1, "dim_sharedlayers": 16,
                       "num_headlayers": 1, "dim_headlayers": [16]},
             "node": {"num_headlayers": 1, "dim_headlayers": [16], "type": node_type}}
    if branches > 1:
        heads = {k: [{"type": f"branch-{b}", "architecture": h} for b in range(branches)]
                 for k, h in heads.items()}
    arch = {"mpnn_type": model, "radius": 5.0, "max_neighbours": 20, "hidden_dim": 64,
            "num_conv_layers": layers, "use_sorted_aggregation": True,
            "task_weights": [1.0, 1.0], "output_heads": heads,
            **ZOO_ARCH.get(model, {})}
    if model == "EGNN":
        arch["equivariance"] = True
    if gps:
        arch.update(global_attn_engine="GPS", global_attn_type="multihead",
                    global_attn_heads=2, pe_dim=4, dropout=0.0)
    if branches > 1:
        arch.update(branch_loss_weights=[1.0 + b for b in range(branches)],
                    branch_loss_metrics=True)
    cfg = {"Dataset": {"node_features": {"dim": [1, 3, 3]}, "graph_features": {"dim": [1]}},
           "NeuralNetwork": {"Architecture": arch,
                             "Training": {"batch_size": 8, "loss_function_type": loss},
                             "Variables_of_interest": {
                                 "input_node_features": [0, 1],
                                 "output_names": ["energy", "forces"],
                                 "output_index": [0, 2], "type": ["graph", "node"]}}}
    return cfg, splits


def _zoo_models(device, model, layers, node_type="mlp", branches=1, loss="mae"):
    """A zoo conv's model (hidden 64, f32) on the sorted route, the same
    weights on the unsorted plain route (no kernel), and one batch of 8
    OC20-shaped graphs (DimeNet's with its triplets). ``node_type``,
    ``branches`` and ``loss`` give it another node head, that many decoder
    branches (graph i in branch i % branches, per-branch loss weights and
    scalars) and another loss."""
    import copy

    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.data import GraphLoader
    from hydragnn_tpu_torch.models import create_model

    cfg, splits = _zoo_config(model, layers, node_type, branches, loss)
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg["NeuralNetwork"]["Architecture"].update(use_sorted_aggregation=False,
                                                      use_fused_edge_kernel=False)
    kernels = create_model(update_config(cfg, *splits), device=device)
    plain = create_model(update_config(plain_cfg, *splits), device=device)
    plain.load_state_dict(kernels.state_dict())
    batch = next(iter(GraphLoader(splits[0], 8, sort_edges=True,
                                  with_triplets=model == "DimeNet"))).to(device)
    return kernels, plain, batch


@pytest.mark.gpu
@pytest.mark.parametrize("model", list(ZOO_LAUNCHES))
def pytest_zoo_conv_kernels_match_the_plain_route_on_card(cuda, model):
    """Each conv of the zoo, DimeNet and MACE too (2 conv layers, hidden 64,
    f32), through the kernels against the same weights on the unsorted
    plain route (no kernel): real rows to 1e-4 of each head's largest value (GAT's and
    PNAEq's to 1e-3: their softmax and degree scalers carry a summation
    order's rounding further), and the launches per forward."""
    model_k, plain, batch = _zoo_models(cuda, model, 2)
    wrappers = {"K1": t_sorted.sorted_segment_sum, "K3": t_multi.fused_multi_agg}
    before = {k: w.launches for k, w in wrappers.items()}
    with torch.no_grad():
        got = model_k(batch)
        mid = {k: w.launches for k, w in wrappers.items()}
        want = plain(batch)
    torch.cuda.synchronize()
    launched = {k: mid[k] - before[k] for k in wrappers}
    assert launched == {k: ZOO_LAUNCHES[model].get(k, 0) for k in wrappers}, launched
    assert all(w.launches == mid[k] for k, w in wrappers.items())  # the plain route: none
    rtol = 1e-3 if model in ("GAT", "PNAEq") else 1e-4
    for k in want:
        m = batch.graph_mask if want[k].shape[0] == batch.num_graphs else batch.node_mask
        scale = float(want[k][m].abs().max())
        assert torch.isfinite(got[k][m]).all()
        assert float((got[k][m] - want[k][m]).abs().max()) <= rtol * scale, k


def _zoo_step_gradient_gap(device, model, layers=1, clamps=None, prepare=None, **kw):
    """One training step's gradients (batch statistics) of a zoo model of
    ``layers`` conv layers (``_zoo_models``'s ``kw``) through the kernels
    against the plain route's: ``(largest gap, its parameter, clamp
    decisions)``, each parameter's gap its largest difference over 1e-3 of
    its largest gradient, floored at 1e-3 of the largest anywhere (so 1 is
    the limit). With ``clamps`` (a ``monkeypatch``) the PaiNN update
    block's +-1e6 clamp saturates on the kernel route exactly the elements
    it saturated on the plain route; the decisions count how many elements
    each of those clamp calls saturated. ``prepare(m)`` changes both
    models' weights alike first."""
    import hydragnn_tpu_torch.models.painn as painn
    from hydragnn_tpu_torch.train import compute_loss

    kernels, plain, batch = _zoo_models(device, model, layers, **kw)
    if prepare is not None:
        prepare(kernels)
        plain.load_state_dict(kernels.state_dict())
    decisions = []

    def record(t):
        decisions.append(t.abs() > 1e6)
        return torch.clamp(t, -1e6, 1e6)

    def replay(t, calls=iter(decisions)):
        return torch.where(next(calls), torch.clamp(t, -1e6, 1e6).detach(), t)

    grads = {}
    for route, m, clamp in (("plain", plain, record), ("kernels", kernels, replay)):
        if clamps is not None:
            clamps.setattr(painn, "update_clamp", clamp)
        m.train()
        tot, _, _ = compute_loss(m, batch, m.cfg, False)
        tot.backward()
        grads[route] = {n: p.grad for n, p in m.named_parameters()}
    got, want = grads["kernels"], grads["plain"]
    top = max(float(g.abs().max()) for g in want.values() if g is not None)
    gaps = {}
    for n, w in want.items():
        if w is None:
            assert got[n] is None, n
            continue
        scale = max(float(w.abs().max()), 1e-3 * top)
        gaps[n] = float((got[n] - w).abs().max()) / (1e-3 * scale)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst, [int(d.sum()) for d in decisions]


def _assert_zoo_step_gradients_match(device, model, layers=1, clamps=None, **kw):
    """``_zoo_step_gradient_gap`` within its limit: every parameter's
    gradient to 1e-3 of its largest, floored at 1e-3 of the largest
    anywhere. Returns the clamp decisions."""
    gap, worst, decisions = _zoo_step_gradient_gap(device, model, layers, clamps, **kw)
    assert gap <= 1.0, (worst, gap)
    return decisions


@pytest.mark.gpu
@pytest.mark.parametrize("model", list(ZOO_LAUNCHES))
def pytest_zoo_conv_gradients_match_the_plain_route_on_card(cuda, model):
    """One conv layer of each zoo conv (hidden 64, f32): one training step's
    gradients through K1's or K3's Function against the plain route's."""
    _assert_zoo_step_gradients_match(cuda, model)


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["PAINN", "PNAEq"])
def pytest_zoo_vector_update_gradients_match_the_plain_route_on_card(cuda, model, monkeypatch):
    """Three conv layers of PAINN and PNAEq (hidden 64, f32), so that two
    run the update block's vector form: one training step's gradients
    through K1's or K3's Function against the plain route's, the kernel
    route held to the plain route's clamp decisions (deeper stacks
    saturate the +-1e6 clamp at random init, where one rounding can flip
    an element). The first layer's two clamps saturate nothing, so the
    vector update's gradient reaches K1 or K3 unclamped. Both routes run
    PyTorch's deterministic algorithms: the plain route's ``index_add_``
    sums and both routes' gathers' backwards otherwise add with atomics in
    an order that changes from run to run, and the rounding they leave free
    moved one parameter's gap past its limit in about one run of four."""
    with deterministic_algorithms():
        saturated = _assert_zoo_step_gradients_match(cuda, model, layers=3,
                                                     clamps=monkeypatch)
    assert len(saturated) == 5 and saturated[:2] == [0, 0], saturated


@contextlib.contextmanager
def deterministic_algorithms():
    """Within the block, PyTorch's deterministic algorithms (warning where
    an op has none)."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["EGNN", "SAGE", "PNA"])
def pytest_conv_node_head_gradients_match_the_plain_route_on_card(cuda, model):
    """Conv node heads (2 branches, each a chain of the model's own conv:
    EGNN's through K1 and, in its last conv, K2; SAGE's through K1; PNA's
    through K3) after 2 conv layers, f32, both routes under deterministic
    algorithms: one training step's gradients through the kernels against
    the plain route's, to 1e-3 as the zoo's. PNA's case reads about 21x
    the limit in graph_convs.1.pre_send.weight under PyTorch's default
    algorithms, as far as the same step in f64 lies from either
    deterministic route (``pytest_pna_conv_head_routes_against_f64_on_card``
    prints the readings)."""
    with deterministic_algorithms():
        _assert_zoo_step_gradients_match(cuda, model, layers=2, node_type="conv", branches=2)


def _pna_conv_head_readings(device):
    """The PNA conv-head case of the test above, each reading its largest
    per-parameter gap (1 the limit) and that parameter: the kernel route
    against the plain route under deterministic algorithms and with
    PyTorch's default (atomic) algorithms, and each route against the same
    step in f64 (the kernel route's statement, every sum and moment in
    f64)."""
    from chip_smoke import f64_sums
    from hydragnn_tpu_torch.train import compute_loss

    kernels, plain, batch = _zoo_models(device, "PNA", 2, node_type="conv", branches=2)

    def grads(m, b, *contexts):
        m = copy.deepcopy(m).train()
        with contextlib.ExitStack() as stack:
            for c in contexts:
                stack.enter_context(c)
            tot, _, _ = compute_loss(m, b, m.cfg, False)
            tot.backward()
        return {n: p.grad for n, p in m.named_parameters()}

    def gap(got, want):
        top = max(float(w.abs().max()) for w in want.values())
        gaps = {n: float((got[n].to(w.dtype) - w).abs().max())
                / (1e-3 * max(float(w.abs().max()), 1e-3 * top)) for n, w in want.items()}
        worst = max(gaps, key=gaps.get)
        return gaps[worst], worst

    with deterministic_algorithms():
        gk, gp = grads(kernels, batch), grads(plain, batch)
    b64 = batch.replace(**{f: getattr(batch, f).double() for f in ("x", "pos", "edge_attr")
                           if getattr(batch, f) is not None})
    g64 = grads(copy.deepcopy(kernels).double(), b64, f64_sums())
    gka, gpa = grads(kernels, batch), grads(plain, batch)
    return {"deterministic": gap(gk, gp), "atomics": gap(gka, gpa),
            "kernels vs f64": gap(gk, g64), "plain vs f64": gap(gp, g64),
            "kernels with atomics vs f64": gap(gka, g64),
            "plain with atomics vs f64": gap(gpa, g64)}


@pytest.mark.gpu
def pytest_pna_conv_head_routes_against_f64_on_card(cuda):
    """Why the PNA case runs deterministic algorithms (the readings are
    printed under ``-s``): PyTorch's default algorithms move one
    parameter's gradient by about 21x the limit, as far as the step in f64
    lies from either deterministic route. Held: the deterministic routes
    agree to the limit, and the kernel route lies no further from the f64
    step than the plain route, beyond the limit."""
    r = _pna_conv_head_readings(cuda)
    print("PNA conv head, largest gap over the 1e-3 limit (its parameter): "
          + "; ".join(f"{k} {v[0]:.6g} ({v[1]})" for k, v in r.items()))
    assert r["deterministic"][0] <= 1.0, r
    assert r["kernels vs f64"][0] <= r["plain vs f64"][0] + 1.0, r


@pytest.mark.gpu
@pytest.mark.parametrize("loss", ["mae", "GaussianNLLLoss"])
def pytest_gfm_step_gradients_match_the_plain_route_on_card(cuda, loss):
    """The GFM recipe's model at hidden 64: EGNN, 3 branches with
    per-branch loss weights and scalars, mlp heads (variance heads under
    GaussianNLLLoss, started near 4), f32, both routes under deterministic
    algorithms: one training step's gradients through K1 and K2 against the
    plain route's, to 1e-3 as the zoo's. The variances start near 4
    (``chip_smoke.unit_variance``), away from the NLL's 1e-6 clamp, where a
    random init leaves some and a rounding is amplified a millionfold."""
    from chip_smoke import unit_variance

    with deterministic_algorithms():
        _assert_zoo_step_gradients_match(
            cuda, "EGNN", layers=3, branches=3, loss=loss,
            prepare=unit_variance if loss == "GaussianNLLLoss" else None)


@pytest.mark.gpu
def pytest_run_training_from_a_columnar_config_on_card(cuda, tmp_path, monkeypatch):
    """``run_training`` from the OC20 example's JSON alone (narrowed: EGNN
    hidden 32) over a small columnar directory, one epoch on the card with
    no device given: the kernels on by config completion, K2 four times in
    each train step and eval batch (every EGNN layer, equivariance off), the
    state on the card, every loss finite, the completed config written to
    the run directory. Under the default ``precompile: background`` most
    launches are CUDA-graph replays (``replayed_by_case``)."""
    import json
    import math
    from pathlib import Path

    from hydragnn_tpu_torch.api import prepare_data, run_training
    from hydragnn_tpu_torch.data import ColumnarWriter, oc20_shaped_dataset

    monkeypatch.chdir(tmp_path)
    config = json.loads((Path(__file__).resolve().parents[1] / "examples" / "open_catalyst_2020"
                         / "open_catalyst_2020.json").read_text())
    config["NeuralNetwork"]["Architecture"]["hidden_dim"] = 32
    config["NeuralNetwork"]["Training"].update(num_epoch=1, batch_size=4)
    config["Dataset"]["path"]["total"] = str(tmp_path / "oc20")
    ColumnarWriter(str(tmp_path / "oc20")).add(
        oc20_shaped_dataset(24, mean_atoms=20, min_atoms=10, max_atoms=40)).save()
    done, loaders, mm = prepare_data(copy.deepcopy(config))
    arch = done["NeuralNetwork"]["Architecture"]
    assert mm is None and arch["use_sorted_aggregation"] and arch["use_fused_edge_kernel"]
    k2 = t_fused.fused_edge_message_sum

    def k2_launches():  # run by the wrapper, and by replays of the levels' CUDA graphs
        return k2.launches_by_case["float32/32x32"] + k2.replayed_by_case["float32/32x32"]

    before = k2_launches()
    _, state, hist = run_training(copy.deepcopy(config))
    torch.cuda.synchronize()
    launched = k2_launches() - before
    assert launched == 4 * (int(state.step) + len(loaders[1]) + len(loaders[2]))
    assert state.step.device.type == "cuda" and int(state.step) == len(loaders[0])
    assert all(math.isfinite(v) for k in ("train", "val", "test") for v in hist[k])
    assert list((tmp_path / "logs").glob("*/config.json"))


def _numerics_step(model, batch, swap=()):
    """One numerics train step (f32, AdamW, guard on) of a copy of
    ``model`` on ``batch``: (its statistics bundle, names, K1/K2 launches
    by case); ``swap`` names the kernels taken by their plain versions."""
    from chip_smoke import plain_versions

    from hydragnn_tpu_torch.train import TrainState, make_optimizer, make_train_step

    m = copy.deepcopy(model)
    state = TrainState.create(m, make_optimizer(m, {"type": "AdamW", "learning_rate": 1e-3}))
    wrappers = {"K1": t_sorted.sorted_segment_sum, "K2": t_fused.fused_edge_message_sum}
    before = {k: dict(w.launches_by_case) for k, w in wrappers.items()}
    step = make_train_step(m, numerics=True)
    with plain_versions(swap):
        out = step(state, batch)
    torch.cuda.synchronize()
    launched = {k: {c: n - before[k].get(c, 0) for c, n in w.launches_by_case.items()
                    if n != before[k].get(c, 0)} for k, w in wrappers.items()}
    return out[3], step._numerics_meta, launched, len(out)


def _numerics_inputs(device, bad_leaf: bool = False):
    """Taps (bf16 and f32, [N, C] and [N, 4, C], under two masks and none)
    whose padding rows hold NaN and inf, a NaN in one real row, bf16
    subnormals, and 60 gradient leaves in 7 groups (more segments than one
    launch takes, leaves longer than a tile); ``bad_leaf`` plants an inf in
    a leaf."""
    gen = torch.Generator(device=device).manual_seed(0)
    node = torch.rand(517, generator=gen, device=device) < 0.8
    graph = torch.rand(33, generator=gen, device=device) < 0.5

    def tap(shape, dtype):
        x = torch.randn(shape, generator=gen, device=device) * 3
        return x.to(dtype)

    taps = [tap((517, 96), torch.bfloat16), tap((517, 4, 24), torch.bfloat16),
            tap((517, 96), torch.float32), tap((33, 7), torch.float32), tap((9, 5), torch.bfloat16)]
    masks = [node, node, node, graph, None]
    taps[0][~node] = float("nan")
    taps[2][~node] = float("inf")
    taps[1][node.nonzero()[3, 0], 2, 5] = float("nan")
    taps[0][node.nonzero()[0, 0], :4] = torch.tensor([1e-39, -2e-40, 0.0, 5e-39])
    sizes = torch.randint(1, 9000, (60,), generator=gen, device=device).tolist()
    leaves = [torch.randn(n, generator=gen, device=device) for n in sizes]
    if bad_leaf:
        leaves[41][7] = float("inf")
    groups = (9, 1, 20, 5, 10, 8, 7)
    return taps, masks, leaves, groups


@pytest.mark.gpu
@pytest.mark.parametrize("bad_leaf", [False, True])
def pytest_numerics_stats_kernel_matches_its_plain_version_on_card(cuda, bad_leaf):
    """N1 against its plain version on awkward inputs: max |x| (NaN where a
    real element is NaN) and the counts exactly, the sums of squares to
    1e-5 relative, the same ok flag (false with an inf gradient); one
    launch counted; the same bits twice; a CUDA graph's replay equal to the
    eager call bit for bit."""
    taps, masks, leaves, groups = _numerics_inputs(cuda, bad_leaf)
    tot = torch.tensor(1.5, device=cuda)
    before = t_nstats.numerics_stats.launches
    got, ok = t_nstats.numerics_stats(taps, masks, leaves, groups, tot)
    want, ok_p = t_nstats.numerics_stats_plain(taps, masks, leaves, groups, tot)
    torch.cuda.synchronize()
    assert t_nstats.numerics_stats.launches == before + 1
    assert got.shape == want.shape == (len(taps) + len(groups), 5)
    assert bool(ok) == bool(ok_p) == (not bad_leaf)
    assert torch.equal(got[:, 2:], want[:, 2:])
    assert float(got[0, 4]) == 3.0 and float(got[1, 3]) == 1.0 and bool(got[1, 0].isnan())
    fin = want[:, 3] == 0
    assert int((~fin).sum()) == 1 + bad_leaf
    assert torch.equal(got[fin, 0], want[fin, 0])
    torch.testing.assert_close(got[fin, 1], want[fin, 1], rtol=1e-5, atol=0)
    assert not got[~fin, 1].isfinite().any()
    again, _ = t_nstats.numerics_stats(taps, masks, leaves, groups, tot)
    assert torch.equal(again.nan_to_num(), got.nan_to_num())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static, static_ok = t_nstats.numerics_stats(taps, masks, leaves, groups, tot)
    static.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static.nan_to_num(), got.nan_to_num()) and bool(static_ok) == bool(ok)


@pytest.mark.gpu
def pytest_numerics_probes_through_k1_k2_match_the_plain_versions_on_card(cuda):
    """The EGNN of the zoo tests (3 layers, hidden 64, f32: K1 and K2 on its
    path) under deterministic algorithms: every probe's and gradient
    group's raw moments through the kernels against the same step through
    their plain versions (max |x| and the sum of squares to 1e-4
    relative, the counts exactly), the ok flag set; and the numerics step
    launches K1 and K2 exactly as the step without numerics does."""
    from hydragnn_tpu_torch.train import TrainState, make_optimizer, make_train_step

    model, _, batch = _zoo_models(cuda, "EGNN", 3)
    with deterministic_algorithms():
        got, meta, launched, _ = _numerics_step(model, batch)
        want, _, none, _ = _numerics_step(model, batch, swap=("K1", "K2"))
    assert launched["K1"] and launched["K2"] and none == {"K1": {}, "K2": {}}
    assert meta["act_names"][0] == "embedding" and bool(got["ok"])
    for key in ("act", "grad"):
        g, w = got[key].double().cpu(), want[key].double().cpu()
        assert torch.equal(g[:, 2:], w[:, 2:]), key
        torch.testing.assert_close(g[:, :2], w[:, :2], rtol=1e-4, atol=0)
    m = copy.deepcopy(model)
    state = TrainState.create(m, make_optimizer(m, {"type": "AdamW", "learning_rate": 1e-3}))
    before = {"K1": dict(t_sorted.sorted_segment_sum.launches_by_case),
              "K2": dict(t_fused.fused_edge_message_sum.launches_by_case)}
    assert len(make_train_step(m)(state, batch)) == 3
    torch.cuda.synchronize()
    off = {"K1": {c: n - before["K1"].get(c, 0)
                  for c, n in t_sorted.sorted_segment_sum.launches_by_case.items()
                  if n != before["K1"].get(c, 0)},
           "K2": {c: n - before["K2"].get(c, 0)
                  for c, n in t_fused.fused_edge_message_sum.launches_by_case.items()
                  if n != before["K2"].get(c, 0)}}
    assert off == launched


@pytest.mark.gpu
@pytest.mark.parametrize("mixed_precision", [False, True])
def pytest_flop_count_per_level_equal_on_kernel_and_plain_routes_on_card(cuda,
                                                                         mixed_precision):
    """The MFU's FLOP count of a train step (obs/flops.py, on ``meta``
    copies) for the kernel route's model equals ``FlopCounterMode`` over
    the same step on the card through the kernels' plain versions, at the
    batch's level, in f32 and under mixed precision; counting launches no
    kernel."""
    from torch.utils.flop_counter import FlopCounterMode

    from chip_smoke import plain_versions
    from hydragnn_tpu_torch.obs.flops import train_flops_for
    from hydragnn_tpu_torch.train.loop import _apply_fn, cast_batch_bf16
    from hydragnn_tpu_torch.train.loss import compute_loss

    model, _, batch = _zoo_models(cuda, "EGNN", 3)
    b = batch.to("cpu")
    launches = (t_sorted.sorted_segment_sum.launches, t_fused.fused_edge_message_sum.launches)
    key = (int(b.node_mask.numel()), int(b.edge_mask.numel()))
    counted = train_flops_for(model, mixed_precision=mixed_precision)(key, b)
    assert (t_sorted.sorted_segment_sum.launches,
            t_fused.fused_edge_message_sum.launches) == launches
    m = copy.deepcopy(model).train()
    db = batch
    if mixed_precision:
        db = cast_batch_bf16(db)
    with plain_versions(("K1", "K2")), FlopCounterMode(display=False) as counter:
        tot, _, _ = compute_loss(_apply_fn(m, mixed_precision, False), db, m.cfg, False)
        tot.float().backward()
    assert counted == counter.get_total_flops() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("numerics", [False, True])
@pytest.mark.parametrize("mixed_precision", [False, True])
def pytest_egnn_train_step_makes_no_synchronizing_call_on_card(cuda, mixed_precision, numerics):
    """A train step of the egnn_train cell (``chip_smoke.train_config`` at
    hidden 24: K1 and K2 on its path, the graph head's fixed-order mean
    pool, the decoders' leaky relu), with and without the numerics bundle,
    on a batch already on the card, makes no call PyTorch flags as
    synchronizing: the host never waits for the card inside a step, so the
    loop's own host work (telemetry, the next batch) overlaps the card's."""
    import chip_smoke as cs
    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.data.synthetic import oc20_shaped_dataset
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train.loop import make_train_step

    splits = split_dataset(oc20_shaped_dataset(24, mean_atoms=20, min_atoms=10, max_atoms=40),
                           0.9, seed=0)
    config, (loader, _, _), _ = prepare_data(
        copy.deepcopy(cs.train_config(batch_size=4, hidden=24, head=16)), splits)
    loader.set_epoch(0)
    batches = [b.to(cuda) for b in list(loader)[:2]]
    state = cs._train_copy(create_model(config, device=cuda, seed=0), cuda)
    step = make_train_step(state.model, mixed_precision=mixed_precision, numerics=numerics)
    step(state, batches[0])  # the cached layouts, the kernels' first load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step(state, batches[1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(out) == (4 if numerics else 3) and bool(torch.isfinite(out[1]))



# -- the compile plane (train/compile_plane.py): CUDA graphs of the kernels and the step


def _capture_case(kernel, cuda):
    """``(wrapper, zero-argument call)`` of ``kernel``'s wrapper on small
    operands on the card."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    n, e, c = 40, 300, 16
    ids = torch.sort(torch.randint(0, n, (e,), generator=gen, device=cuda)).values
    x = torch.randn(e, c, generator=gen, device=cuda)
    if kernel == "K1":
        return t_sorted.sorted_segment_sum, lambda: t_sorted.sorted_segment_sum(x, ids, n)
    if kernel == "K2":
        ops = (torch.randn(n, c, generator=gen, device=cuda), x,
               torch.randn(c, c, generator=gen, device=cuda) / 4,
               torch.randn(c, generator=gen, device=cuda))
        return (t_fused.fused_edge_message_sum,
                lambda: t_fused.fused_edge_message_sum(*ops, ids, n))
    if kernel == "K3":
        nr = torch.randn(n, c, generator=gen, device=cuda)
        return t_multi.fused_multi_agg, lambda: t_multi.fused_multi_agg(nr, x, None, ids, n)
    q, k, v = (torch.randn(64, 2, 32, generator=gen, device=cuda) for _ in range(3))
    if kernel == "K4":
        graph = torch.arange(64, device=cuda) // 16
        mask = torch.ones(64, dtype=torch.bool, device=cuda)
        return (t_flash.flash_self_attention,
                lambda: t_flash.flash_self_attention(q, k, v, graph, mask, 4, 16))
    key_mask = torch.arange(64, device=cuda) % 5 != 0
    return (t_flash.flash_block_summary,
            lambda: t_flash.flash_block_summary(q, k, v, key_mask))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K4b"])
def pytest_kernel_captured_and_replayed_equals_eager_on_card(cuda, kernel):
    """Each kernel's wrapper captured in a CUDA graph and replayed (its
    outputs zeroed first, so the replay writes them): bit for bit the eager
    call's outputs; the capture counts one launch recorded and none run, so
    the ``ctypes`` launch went onto the capturing stream."""
    wrapper, call = _capture_case(kernel, cuda)
    eager = call()
    eager = eager if isinstance(eager, tuple) else (eager,)
    torch.cuda.synchronize()
    launches, captured = wrapper.launches, wrapper.captured
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = call()
    static = static if isinstance(static, tuple) else (static,)
    assert (wrapper.launches, wrapper.captured) == (launches, captured + 1)
    for t in static:
        t.zero_()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(static, eager))


def _graph_cell(cuda, copies: int = 2):
    """The egnn_train cell at hidden 24 on a 3-level ladder: the train
    loader and ``copies`` states from one init."""
    import chip_smoke as cs
    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.data.synthetic import oc20_shaped_dataset
    from hydragnn_tpu_torch.models.create import create_model

    splits = split_dataset(oc20_shaped_dataset(48, mean_atoms=20, min_atoms=8, max_atoms=40),
                           0.9, seed=0)
    config = cs.train_config(batch_size=4, hidden=24, head=16)
    config["NeuralNetwork"]["Training"].update(pack_batches=False, num_pad_buckets=3)
    config, (loader, _, _), _ = prepare_data(config, splits)
    loader.set_epoch(0)
    model = create_model(config, device=cuda, seed=0)
    return loader, [cs._train_copy(model, cuda) for _ in range(copies)]


def _tensors(state):
    return [t.detach().clone() for t in state.held] + [state.step.clone()]


def _graphed(state, loader, policy="warn"):
    from hydragnn_tpu_torch.train import compile_plane as cp
    from hydragnn_tpu_torch.train.loop import make_eval_step, make_train_step

    plane = cp.CompilePlane(mode="blocking", retrace_policy=policy)
    step, _ = plane.launch(make_train_step(state.model, mixed_precision=True),
                           make_eval_step(state.model, mixed_precision=True), state, loader,
                           skip_eval=True)
    return plane, step


@pytest.mark.gpu
def pytest_graphed_train_step_equals_eager_on_card(cuda):
    """The egnn_train cell's step (bf16, K1 and K2) at hidden 24 over an
    epoch of a 3-level ladder, eagerly and through a blocking compile
    plane's CUDA graphs from the same init, under deterministic
    algorithms: every loss, parameter, moment, buffer and the step counter
    bit for bit; every step a replay, no kernel run eagerly."""
    from hydragnn_tpu_torch.train.loop import make_train_step

    loader, (a, b) = _graph_cell(cuda)
    batches = list(loader)
    eager = make_train_step(a.model, mixed_precision=True)
    plane, graphed = _graphed(b, loader, "error")
    try:
        assert len(plane.graphs()) == len(loader.spec_template_batches()) > 1
        with deterministic_algorithms():
            la = [eager(a, x)[1] for x in batches]
            before = t_sorted.sorted_segment_sum.launches
            lb = [graphed(b, x)[1] for x in batches]
        torch.cuda.synchronize()
        assert t_sorted.sorted_segment_sum.launches == before
        assert sum(g.replays for g in plane.graphs().values()) == len(batches)
        assert torch.equal(torch.stack(la), torch.stack(lb))
        assert all(torch.equal(x, y) for x, y in zip(_tensors(a), _tensors(b)))
    finally:
        plane.finish()


@pytest.mark.gpu
def pytest_lr_change_takes_effect_under_replay_on_card(cuda):
    """A learning rate is baked into a captured step: after
    ``with_learning_rate`` (the plateau schedule, the guard's backoff) the
    level is captured again, and the replayed trajectory equals the eager
    one under the same change bit for bit (deterministic algorithms), and
    parts from a run that kept the old rate."""
    from hydragnn_tpu_torch.train.loop import make_train_step

    loader, (a, b, c) = _graph_cell(cuda, copies=3)
    batches = list(loader)[:4]
    eager = make_train_step(a.model, mixed_precision=True)
    kept = make_train_step(c.model, mixed_precision=True)
    plane, graphed = _graphed(b, loader)
    try:
        with deterministic_algorithms():
            for i, x in enumerate(batches):
                if i == 2:
                    a.with_learning_rate(1e-2)
                    b.with_learning_rate(1e-2)
                eager(a, x)
                graphed(b, x)
                kept(c, x)
        torch.cuda.synchronize()
        assert sum(g.captures for g in plane.graphs().values()) > len(plane.graphs())
        assert all(torch.equal(x, y) for x, y in zip(_tensors(a), _tensors(b)))
        assert not all(torch.equal(x, y) for x, y in zip(_tensors(c), _tensors(b)))
    finally:
        plane.finish()


@pytest.mark.gpu
def pytest_k3_counters_outgrown_under_a_captured_graph_on_card(cuda):
    """K3's arrival counters grow with the largest call; a graph captured at
    a smaller one keeps the buffer it recorded alive: capture a small call,
    run a larger one eagerly (the counters grow), then replay the small
    one: its moments equal the plain version's (count, min and max exactly)
    and every counter reads 0 after it."""
    def case(n, seed):
        ids, gen = _ascending_ids(cuda, n, 8, seed)
        # a long dummy last row: the split rows that count their arrivals
        ids = torch.cat([ids, torch.full((2000,), n - 1, dtype=ids.dtype, device=cuda)])
        x = torch.randn(ids.shape[0], 32, generator=gen, device=cuda)
        return (torch.randn(n, 32, generator=gen, device=cuda), x, None, ids, n)

    small = case(50, 1)
    t_multi.fused_multi_agg(*small)  # sizes the counters for the small call
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = t_multi.fused_multi_agg(*small)
    held = t_multi._counters[cuda]
    large = case(held.numel() + 1, 2)  # more rows than the buffer has counters
    t_multi.fused_multi_agg(*large)
    torch.cuda.synchronize()
    assert t_multi._counters[cuda] is not held  # grown, the captured one kept
    for t in static:
        t.zero_()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    want = t_multi.reference_multi_agg(*small)
    for name, a, b in zip(("sum", "count", "min", "max", "sumsq"), static, want):
        if name in ("count", "min", "max"):
            assert torch.equal(a, b), name
        else:
            assert float((a - b).abs().max()) <= 1e-5 * max(float(b.abs().max()), 1.0), name
    assert int(held.abs().sum()) == 0
    assert int(t_multi._counters[cuda].abs().sum()) == 0


# every launch plan a tuned table may pick beside today's (tune/plans.py),
# forced: (kernel, channels or head dim, plan)
NON_DEFAULT_PLANS = [
    ("K1", 3, {"narrow_edges": 128}), ("K1", 4, {"narrow_edges": 512}),
    ("K1", 33, {"max_rows": 256, "wide_iters": 8}),
    ("K1", 126, {"max_rows": 512, "wide_iters": 64}),
    ("K1", 866, {"max_rows": 32, "wide_iters": 2}),
    ("K2", 64, {"rows_per_block": 1}), ("K2", 130, {"rows_per_block": 32}),
    ("K2", 866, {"rows_per_block": 7}),
    ("K3", 50, {"chunk_edges": 512, "col_threads": 16}),
    ("K3", 50, {"chunk_edges": 256, "col_threads": 1}),
    ("K3", 3, {"chunk_edges": 512, "col_threads": 2}),
    ("K3", 128, {"chunk_edges": 512, "col_threads": 8}),
    ("K3", 256, {"chunk_edges": 512, "col_threads": 32}),
    ("K4", 32, {"block_k": 32}), ("K4b", 32, {"block_k": 32}),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel,width,plan", NON_DEFAULT_PLANS)
def pytest_non_default_plans_match_plain_on_card(cuda, kernel, width, plan, dtype):
    """Each kernel under a forced plan that is not its default launch, on
    the operands of its default-plan test above (empty rows, long rows, a
    long dummy last row), against its plain version at that test's
    tolerance; one launch."""
    from hydragnn_tpu_torch.tune import plans, runtime

    gen = torch.Generator(device=cuda).manual_seed(width)
    dt = str(dtype)[6:]
    if kernel in ("K1", "K2", "K3"):
        n = 400
        deg = torch.randint(0, 30, (n,), generator=gen, device=cuda)
        deg[10:25] = 0
        deg[200:203] = torch.tensor([65, 1300, 64], device=cuda)
        deg[-1] = 2500
        ids = torch.repeat_interleave(torch.arange(n, device=cuda), deg)
        e = ids.shape[0]

        def rand(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device=cuda) * scale).to(dtype)
    if kernel == "K1":
        kid, shapes = plans.SEGMENT, {"channels": width}
        wrapper, msg = t_sorted.sorted_segment_sum, rand(e, width)
        call = lambda: t_sorted.sorted_segment_sum(msg, ids, n)  # noqa: E731
        want = t_sorted.sorted_segment_sum_plain(msg, ids, n)
    elif kernel == "K2":
        kid, shapes = plans.FUSED_EDGE, {"edges": e, "num_segments": n}
        ops = [rand(n, width), rand(e, width), rand(width, width, scale=width ** -0.5),
               rand(width)]
        wrapper = t_fused.fused_edge_message_sum
        call = lambda: t_fused.fused_edge_message_sum(*ops, ids, n)  # noqa: E731
        want = t_fused.reference_edge_message_sum(*ops, ids, n)
    elif kernel == "K3":
        kid, shapes = plans.MULTI_AGG, {}
        ops = [rand(n, width), rand(e, width), rand(e, width)]
        wrapper = t_multi.fused_multi_agg
        call = lambda: t_multi.fused_multi_agg(*ops, ids, n)  # noqa: E731
        want = t_multi.reference_multi_agg(*ops, ids, n)
    elif kernel == "K4":
        kid, shapes = plans.FLASH, {"head_dim": width}
        sizes = [1, 40, 225, 3, 70, 1, 128, 17]
        qkv, node_graph, node_mask, g = _attention_case(cuda, dtype, 8, width, sizes, 37, 5)
        wrapper = t_flash.flash_self_attention
        call = lambda: t_flash.flash_self_attention(  # noqa: E731
            *qkv, node_graph, node_mask, g, max(sizes))
        want = t_flash.reference_masked_attention(*qkv, node_graph, node_mask)
    else:
        kid, shapes = plans.FLASH, {"head_dim": width}
        q, k, v, key_mask = _block_case(cuda, dtype, 300, 170, 8, width, seed=9)
        wrapper = t_flash.flash_block_summary
        call = lambda: t_flash.flash_block_summary(q, k, v, key_mask)  # noqa: E731
        want = t_flash.reference_block_summary(q, k, v, key_mask)
    shapes["dtype"] = dt
    assert plans.normalize(kid, plan, shapes) != plans.default_plan(kid, shapes)
    before = wrapper.launches
    with runtime.forced(kid, plan):
        got = call()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    f32 = dtype == torch.float32
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.float(), b.float()
        scale = float(b.abs().max())
        if kernel == "K1":
            torch.testing.assert_close(a, b, rtol=1e-2, atol=1e-4 if f32 else 2e-2)
        elif kernel == "K2":
            assert float((a - b).abs().max()) <= (1e-4 if f32 else 2e-2) * max(scale, 1.0)
        elif kernel == "K3" and i in (1, 2, 3):  # count, min, max
            assert torch.equal(a, b), i
        elif kernel == "K3":
            assert float((a - b).abs().max()) <= 1e-5 * max(scale, 1.0), i
        elif kernel == "K4":
            tol = (1e-5 if f32 else 2e-2) * float(qkv[2].float().abs().max())
            assert float((a - b).abs().max()) <= tol
        else:
            assert float((a - b).abs().max()) <= (1e-5 if f32 else 2e-2) * scale, i


# every model family the port ships: each zoo conv, EGNN, PNA, GIN, and GPS
# global attention over PNA
CAPTURE_FAMILIES = ["EGNN", "PNA", "GIN", "GPS"] + list(ZOO_LAUNCHES)


def _family_capture_check(device, model):
    """A blocking compile plane over ``model``'s family (2 conv layers,
    hidden 64, f32, a 2-level ladder): every train and eval level is
    captured (on the card); from the same state, each train batch through
    the plane gives the eager step's loss and gradients, and each eval
    batch its outputs. Returns the plane's graphs' replays."""
    import chip_smoke as cs
    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train import compile_plane as cp
    from hydragnn_tpu_torch.train.loop import make_eval_step, make_train_step

    gps = model == "GPS"
    cfg, splits = _zoo_config("PNA" if gps else model, 2, gps=gps)
    cfg["NeuralNetwork"]["Training"].update(num_pad_buckets=2, pack_batches=False)
    config, (train, val, _), _ = prepare_data(cfg, splits)
    train.set_epoch(0)
    net = create_model(config, device=device, seed=0)
    a, b = (cs._train_copy(net, device) for _ in range(2))
    eager_step, eager_eval = make_train_step(a.model), make_eval_step(a.model)
    plane = cp.CompilePlane(mode="blocking", retrace_policy="error")
    step, evaluate = plane.launch(make_train_step(b.model), make_eval_step(b.model), b, train,
                                  val)
    try:
        batches = 0
        with deterministic_algorithms():
            for x in train:
                b.load_state_dict(a.state_dict())
                _, la, _ = eager_step(a, x)
                _, lb, _ = step(b, x)
                assert abs(float(la) - float(lb)) <= 1e-5 * abs(float(la)), (model, la, lb)
                grads = [(p.grad, q.grad) for p, q in zip(a.model.parameters(),
                                                          b.model.parameters())]
                top = max(float(ga.abs().max()) for ga, _ in grads)
                for ga, gb in grads:
                    scale = max(float(ga.abs().max()), 1e-3 * top)
                    assert float((ga - gb).abs().max()) <= 1e-4 * scale, model
                batches += 1
            for x in val:
                b.load_state_dict(a.state_dict())
                want, got = eager_eval(a, x)[2], evaluate(b, x)[2]
                for k in want:
                    scale = max(float(want[k].abs().max()), 1e-30)
                    assert float((want[k] - got[k]).abs().max()) <= 1e-5 * scale, (model, k)
                batches += 1
        if device.type == "cuda":
            kinds = {label.split(":")[0] for label in plane.graphs()}
            assert kinds == {"train", "eval"}, (model, kinds)
            assert sum(g.replays for g in plane.graphs().values()) == batches, model
        return batches
    finally:
        plane.finish()


@pytest.mark.gpu
@pytest.mark.parametrize("model", CAPTURE_FAMILIES)
def pytest_every_family_steps_through_captured_graphs_on_card(cuda, model):
    """``precompile: blocking`` (and so ``background``, the default, whose
    captures are the same) captures a train and an eval level of every
    model family, and each replay computes what the eager step does:
    losses to 1e-5, gradients to 1e-4 of each one's largest value (floored
    at 1e-3 of the largest anywhere), eval outputs to 1e-5, deterministic
    algorithms on."""
    assert _family_capture_check(cuda, model) > 0


# -- the host data plane: device staging (train/loop.py device_prefetch)


def _same_batch(a, b) -> bool:
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, dict):
            if x.keys() != y.keys() or not all(torch.equal(x[k], y[k].to(x[k].device))
                                               for k in x):
                return False
        elif isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y.to(x.device)):
                return False
        elif x != y:
            return False
    return True


def _staging_alive() -> bool:
    import threading

    return any(t.name == "device-prefetch" and t.is_alive() for t in threading.enumerate())


@pytest.mark.gpu
def pytest_device_prefetch_stages_batches_on_a_side_stream_on_card(cuda):
    """``device_prefetch`` on the card: every batch of an epoch (more than
    the ring's slots, so each slot is reused) arrives on the card equal to
    its host batch bit for bit, in order, with the host batch kept as
    ``.host`` and its device block as ``.block``, while the compute stream
    is kept busy between batches (the copies run on the side stream, the
    consumer's stream waits on each one's event, and a slot is written
    again only after the step that read it); an early close stops the
    producer, and a producer's exception reaches the consumer."""
    from hydragnn_tpu_torch.train.loop import device_prefetch, staging_bytes

    loader, _ = _graph_cell(cuda, copies=0)
    hosts = list(loader)
    slot = staging_bytes(loader)
    assert slot >= max(sum(t.numel() * t.element_size() for t in _leaves(b)) for b in hosts)
    busy = torch.randn(2048, 2048, device=cuda)
    seen = []
    for b in device_prefetch(iter(hosts), depth=2, device=cuda, slot_bytes=slot):
        busy = torch.tanh(busy @ busy * 1e-3)  # compute-stream work between the batches
        assert b.x.is_cuda and b.block.is_cuda and b.host is not None
        # a staged batch is valid until the next one is asked for: read it
        # on the compute stream now, behind the work queued before it
        seen.append((b.host, b.apply(lambda t: t.clone())))
    torch.cuda.synchronize()
    assert len(seen) == len(hosts) > 4
    assert all(_same_batch(g, h) and host is h for (host, g), h in zip(seen, hosts))
    gen = device_prefetch(iter(hosts), depth=2, device=cuda, slot_bytes=slot)
    next(gen)
    gen.close()
    assert not _staging_alive()

    def failing():
        yield hosts[0]
        raise OSError("the loader failed")

    with pytest.raises(OSError, match="the loader failed"):
        list(device_prefetch(failing(), depth=2, device=cuda, slot_bytes=slot))
    assert not _staging_alive()


def _leaves(batch):
    out = []
    batch.apply(lambda t: out.append(t) or t)
    return out


@pytest.mark.gpu
def pytest_capture_while_staging_equals_capture_paused_on_card(cuda):
    """Levels captured (a blocking compile plane) while the staging
    producer runs (its host batches built during the captures; its copies
    wait for ``CAPTURE_LOCK``) step an epoch of staged batches exactly as
    levels captured with no producer alive: every loss and state tensor
    bit for bit from one init (deterministic algorithms, bf16, K1 and K2)."""
    from hydragnn_tpu_torch.train.loop import device_prefetch, staging_bytes

    loader, (a, b) = _graph_cell(cuda)
    hosts = list(loader)
    built = []

    def slow():
        for h in hosts:
            time.sleep(0.01)
            built.append(time.perf_counter())
            yield h

    staged = device_prefetch(slow(), depth=len(hosts), device=cuda,
                             slot_bytes=staging_bytes(loader))
    first = next(staged)
    t0 = time.perf_counter()
    plane_a, step_a = _graphed(a, loader, "error")
    t1 = time.perf_counter()
    try:
        assert any(t0 <= t <= t1 for t in built), "the producer was not running during capture"
        with deterministic_algorithms():
            la = [step_a(a, x)[1] for x in itertools.chain([first], staged)]
        torch.cuda.synchronize()
        assert sum(g.replays for g in plane_a.graphs().values()) == len(hosts)
    finally:
        plane_a.finish()  # the sentinel is the process's: one armed plane at a time
    plane_b, step_b = _graphed(b, loader, "error")
    try:
        with deterministic_algorithms():
            lb = [step_b(b, x)[1] for x in device_prefetch(iter(hosts), depth=2, device=cuda,
                                                           slot_bytes=staging_bytes(loader))]
        torch.cuda.synchronize()
    finally:
        plane_b.finish()
    assert torch.equal(torch.stack(la), torch.stack(lb))
    assert all(torch.equal(x, y) for x, y in zip(_tensors(a), _tensors(b)))


@pytest.mark.gpu
def pytest_step_graph_load_from_a_device_batch_equals_the_pinned_route_on_card(cuda):
    """``StepGraph.load`` of a batch already on the card (staged by
    ``device_prefetch``: its block in one device-to-device copy on the
    compute stream) against the same batch from the host (through the
    pinned block): the replayed train steps of two states from one init
    give the same losses and state bit for bit, and each eval level's
    replayed outputs are equal."""
    from hydragnn_tpu_torch.train import compile_plane as cp
    from hydragnn_tpu_torch.train.loop import (
        device_prefetch,
        make_eval_step,
        make_train_step,
        staging_bytes,
    )

    loader, (a, b) = _graph_cell(cuda)
    hosts = list(loader)

    def staged():
        return device_prefetch(iter(hosts), depth=2, device=cuda,
                               slot_bytes=staging_bytes(loader))

    runs = []
    for st, place in ((a, lambda: hosts), (b, staged)):
        plane = cp.CompilePlane(mode="blocking", retrace_policy="error")
        step, ev = plane.launch(make_train_step(st.model, mixed_precision=True),
                                make_eval_step(st.model, mixed_precision=True), st, loader,
                                val_loader=loader)
        try:
            with deterministic_algorithms():
                outs = [ev(st, x) for x in place()]
                losses = [step(st, x)[1] for x in place()]
            torch.cuda.synchronize()
            # each batch one eval replay and one train replay
            assert sum(g.replays for g in plane.graphs().values()) == 2 * len(hosts)
        finally:
            plane.finish()  # the sentinel is the process's: one armed plane at a time
        runs.append((outs, losses))
    for x, y in zip(runs[0][0], runs[1][0]):
        assert torch.equal(x[0], y[0])
        assert all(torch.equal(x[2][k], y[2][k]) for k in x[2])
    assert torch.equal(torch.stack(runs[0][1]), torch.stack(runs[1][1]))
    assert all(torch.equal(x, y) for x, y in zip(_tensors(a), _tensors(b)))


# -- the serving plane: the int8 product and the in-place reload


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 16, 17, 40, 2272])
@pytest.mark.parametrize("k,n", [(866, 866), (866, 889), (889, 889), (4, 866), (866, 1)])
def pytest_int_mm_matches_plain_at_padded_egnn_shapes(cuda, rows, k, n):
    """``int8_matmul`` on the card (``torch._int_mm`` on operands zero-padded
    to its rules) against the widened int32 product on the CPU, bit for bit,
    at the EGNN's widths (866 hidden, 889 in the heads) with the weight
    padded once (``pad_weight``) as the quantized layers hold it."""
    from hydragnn_tpu_torch.ops import quant

    gen = torch.Generator().manual_seed(rows * 7 + k + n)
    x = torch.randint(-127, 128, (rows, k), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    want = quant.int8_matmul(x, w)
    calls = quant.int_mm_calls
    got = quant.int8_matmul(x.to(cuda), quant.pad_weight(w).to(cuda))
    unpadded = quant.int8_matmul(x.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert quant.int_mm_calls - calls == 2
    assert got.dtype == torch.int32 and torch.equal(got[:, :n].cpu(), want)
    assert not got[:, n:].any()
    assert torch.equal(unpadded.cpu(), want)


def _serve_cell(cuda, weights_dtype="float32", mixed_precision=True):
    """A small EGNN (K1 in every layer, K2 in the last) behind a started
    GraphServer on the card, its levels captured, and a second set of
    weights for the same model."""
    import chip_smoke as cs
    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.data.synthetic import oc20_shaped_dataset
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.serve import GraphServer, ServeConfig

    graphs = oc20_shaped_dataset(32, mean_atoms=20, min_atoms=10, max_atoms=40)
    cfg = cs.serving_config(batch_size=4, hidden=64, head=32)
    cfg["NeuralNetwork"]["Training"]["mixed_precision"] = mixed_precision
    config, (_, _, test_loader), _ = prepare_data(cfg, split_dataset(graphs, 0.5, seed=0))
    first = create_model(config, device=cuda, seed=1)
    second = create_model(config, device=cuda, seed=2)
    server = GraphServer(
        first, test_loader.ladder,
        ServeConfig(micro_batch_graphs=4, batch_window_s=0.002, http_port=-1,
                    weights_dtype=weights_dtype,
                    quantization={"mode": "w8a8", "max_error": 1.0}
                    if weights_dtype == "int8" else None),
        template_graphs=test_loader.graphs, mixed_precision=mixed_precision, sort_edges=True,
        device=cuda, checkpoint_label="first").start()
    assert server.wait_ready(120), server.failed
    return server, graphs, second


@pytest.mark.gpu
@pytest.mark.parametrize("weights_dtype", ["float32", "bfloat16", "int8"])
def pytest_replay_after_an_in_place_swap_equals_the_eager_forward(cuda, weights_dtype):
    """A swap writes the new weights into the captured tensors in place:
    the first replay after it equals, bit for bit, the eager forward of the
    served module with the new weights (a rebinding swap would leave the
    replays on the old ones), and no served tensor moved."""
    from hydragnn_tpu_torch.data.graph import batch_graphs
    from hydragnn_tpu_torch.train.loop import cast_batch_bf16
    from hydragnn_tpu_torch.train.state import InferenceState

    server, _, second = _serve_cell(cuda, weights_dtype, weights_dtype == "float32")
    try:
        req = server._template_graphs[0]  # its level was captured at warm-up
        ptrs = {n: t.data_ptr() for n, t in server._served_tensors.items()}
        replays = sum(x.replays for x in server._graphs.graphs.values())
        before = server.submit(req).result(timeout=60)
        assert server._install_state(InferenceState(second.cpu()), "second")
        h = server.submit(req)
        got = h.result(timeout=60)
        assert h.checkpoint == "second" and server.stats()["reloads"] == 1
        assert sum(x.replays for x in server._graphs.graphs.values()) == replays + 2
        assert {n: t.data_ptr() for n, t in server._served_tensors.items()} == ptrs
        batch = batch_graphs([req], server.ladder.select_for([req]),
                             sort_edges=True).to(cuda)
        with torch.inference_mode():
            eager = server._serve_model(cast_batch_bf16(batch) if server._cast_inputs else batch)
        n = req.num_nodes
        assert torch.equal(torch.from_numpy(got["energy"]), eager["energy"][0].float().cpu())
        assert torch.equal(torch.from_numpy(got["forces"]), eager["forces"][:n].float().cpu())
        assert not all(torch.equal(torch.from_numpy(before[k]), torch.from_numpy(got[k]))
                       for k in got)
    finally:
        server.close()
