"""The port's kernel modules against the JAX package's Pallas kernels.

K1 (hydragnn_tpu_torch/ops/sorted_segment.py) and K2
(hydragnn_tpu_torch/ops/fused_edge.py): on the CPU their wrappers run the
plain PyTorch versions, held here against the JAX kernels in interpret mode
and the JAX dense references, in f32 with atol 1e-5 (the same function
summed in another order). K3 and K4 are held against the JAX package in
tests/test_torch_pna.py and tests/test_torch_gps.py; here their wrappers'
CPU routing. The CUDA kernels themselves run only on a GPU:
tests/test_torch_cuda.py holds them against these plain versions there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hydragnn_tpu.ops.pallas_fused_edge import fused_edge_message_sum as jax_fused
from hydragnn_tpu.ops.pallas_fused_edge import reference_edge_message_sum as jax_fused_ref
from hydragnn_tpu.ops.pallas_segment import sorted_segment_sum as jax_sorted_sum
from hydragnn_tpu.ops.segment import segment_mean as jax_segment_mean
from hydragnn_tpu_torch.ops import flash_attention as t_flash
from hydragnn_tpu_torch.ops import fused_edge as t_fused
from hydragnn_tpu_torch.ops import multi_agg as t_multi
from hydragnn_tpu_torch.ops import segment as t_segment
from hydragnn_tpu_torch.ops import sorted_segment as t_sorted

torch.set_num_threads(2)

ATOL = 1e-5


def _sorted_ids(rng, e, n, max_degree):
    """Ascending receiver ids with every in-degree <= max_degree."""
    deg = np.zeros(n, np.int64)
    out = []
    while len(out) < e:
        i = int(rng.integers(0, n))
        if deg[i] < max_degree:
            deg[i] += 1
            out.append(i)
    return np.sort(np.asarray(out, np.int32))


@pytest.mark.parametrize("c", [3, 40])
def pytest_sorted_segment_sum_plain_matches_jax_kernel(c):
    rng = np.random.default_rng(c)
    e, n, max_degree = 300, 50, 16
    ids = _sorted_ids(rng, e, n, max_degree)
    msg = rng.normal(size=(e, c)).astype(np.float32)
    want = np.asarray(jax_sorted_sum(jnp.asarray(msg), jnp.asarray(ids), n, max_degree,
                                     interpret=True))
    got = t_sorted.sorted_segment_sum(torch.from_numpy(msg), torch.from_numpy(ids), n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("c", [3, 40])
def pytest_fixed_order_plain_route_matches_jax_kernel_and_index_add(c):
    """K1's plain version (``segment_reduce`` over the row lengths, each row
    in edge order) against the JAX kernel in interpret mode, and against
    ``index_add_`` (``segment_sum_plain``, the route for unsorted ids), with
    empty rows before, between and after the edges."""
    rng = np.random.default_rng(200 + c)
    e, n, max_degree = 300, 60, 16
    ids = _sorted_ids(rng, e, n - 10, max_degree) + 3
    msg = rng.normal(size=(e, c)).astype(np.float32)
    want = np.asarray(jax_sorted_sum(jnp.asarray(msg), jnp.asarray(ids), n, max_degree,
                                     interpret=True))
    t_msg, t_ids = torch.from_numpy(msg), torch.from_numpy(ids)
    got = t_sorted.sorted_segment_sum_plain(t_msg, t_ids, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), t_sorted.segment_sum_plain(t_msg, t_ids, n).numpy(),
                               rtol=0, atol=ATOL)
    assert float(got[:3].abs().sum() + got[-7:].abs().sum()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def pytest_fixed_order_plain_route_sums_a_long_dummy_row_like_jax(dtype):
    """A dummy last row of 900 edges (over any in-degree bound): the plain
    route is exact for it, as the JAX dense segment sum is."""
    import jax

    rng = np.random.default_rng(11)
    ids = np.concatenate([_sorted_ids(rng, 200, 39, 12), np.full(900, 39, np.int32)])
    msg = torch.from_numpy(rng.normal(size=(ids.shape[0], 5)).astype(np.float32)).to(dtype)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(msg.float().numpy()), jnp.asarray(ids), 40))
    got = t_sorted.sorted_segment_sum_plain(msg, torch.from_numpy(ids), 40)
    assert got.dtype == dtype
    # f32: summation order; bf16: the f32 sum rounded once to bf16
    rtol = 1e-6 if dtype == torch.float32 else 2.0**-8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=1e-4)


@pytest.mark.parametrize("c", [3, 40])
def pytest_segment_mean_matches_jax_pallas_route(monkeypatch, c):
    """The routed masked mean (ops/segment.py) against the JAX routing with
    the Pallas route forced (interpret mode), padding edges masked."""
    monkeypatch.setenv("HYDRAGNN_PALLAS_SEGMENT", "1")
    rng = np.random.default_rng(100 + c)
    e, n, max_degree = 256, 40, 12
    ids = _sorted_ids(rng, e, n, max_degree)
    msg = rng.normal(size=(e, c)).astype(np.float32)
    mask = rng.random(e) > 0.2
    want = np.asarray(jax_segment_mean(jnp.asarray(msg), jnp.asarray(ids), n,
                                       jnp.asarray(mask), sorted_ids=True,
                                       max_degree=max_degree))
    got = t_segment.segment_mean(torch.from_numpy(msg), torch.from_numpy(ids), n,
                                 torch.from_numpy(mask), sorted_ids=True,
                                 max_degree=max_degree)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def _fused_operands(rng, e, n, ci, co):
    nr = rng.normal(size=(n, ci)).astype(np.float32)
    ei = rng.normal(size=(e, ci)).astype(np.float32)
    w = (rng.normal(size=(ci, co)) / np.sqrt(ci)).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    return nr, ei, w, b


@pytest.mark.parametrize("e,n,ci,co,max_degree", [(200, 40, 24, 20, 12), (37, 64, 3, 5, 4)])
def pytest_fused_edge_plain_matches_jax_kernel(e, n, ci, co, max_degree):
    rng = np.random.default_rng(e + ci)
    ids = _sorted_ids(rng, e, n, max_degree)
    ops = _fused_operands(rng, e, n, ci, co)
    j = [jnp.asarray(a) for a in ops]
    want_kernel = np.asarray(jax_fused(*j, jnp.asarray(ids), n, max_degree, interpret=True))
    want_ref = np.asarray(jax_fused_ref(*j, jnp.asarray(ids), n))
    got = t_fused.fused_edge_message_sum(*[torch.from_numpy(a) for a in ops],
                                         torch.from_numpy(ids), n)
    np.testing.assert_allclose(got.numpy(), want_kernel, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=0, atol=ATOL)


def pytest_cpu_wrappers_take_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(_sorted_ids(rng, 64, 10, 10))
    msg = torch.from_numpy(rng.normal(size=(64, 7)).astype(np.float32))
    k1, k2 = t_sorted.sorted_segment_sum.launches, t_fused.fused_edge_message_sum.launches
    torch.testing.assert_close(t_sorted.sorted_segment_sum(msg, ids, 10),
                               t_sorted.sorted_segment_sum_plain(msg, ids, 10))
    ops = [torch.from_numpy(a) for a in _fused_operands(rng, 64, 10, 7, 6)]
    torch.testing.assert_close(t_fused.fused_edge_message_sum(*ops, ids, 10),
                               t_fused.reference_edge_message_sum(*ops, ids, 10))
    assert t_sorted.sorted_segment_sum.launches == k1
    assert t_fused.fused_edge_message_sum.launches == k2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def pytest_k3_k4_cpu_wrappers_take_the_plain_versions_and_count_nothing(dtype):
    rng = np.random.default_rng(6)
    ids = torch.from_numpy(_sorted_ids(rng, 64, 10, 10))
    ops = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
           for s in ((10, 7), (64, 7), (64, 7))]
    k3, k4 = t_multi.fused_multi_agg.launches, t_flash.flash_self_attention.launches
    for got, want in zip(t_multi.fused_multi_agg(*ops, ids, 10),
                         t_multi.reference_multi_agg(*ops, ids, 10)):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    node_graph = torch.tensor([0] * 4 + [1] * 5 + [2] * 3)
    node_mask = torch.arange(12) < 9
    qkv = [torch.from_numpy(rng.normal(size=(12, 2, 4)).astype(np.float32)).to(dtype)
           for _ in range(3)]
    out = t_flash.flash_self_attention(*qkv, node_graph, node_mask, 3, 6)
    assert out.dtype == dtype and out.shape == (12, 2, 4)
    torch.testing.assert_close(out, t_flash.reference_masked_attention(*qkv, node_graph, node_mask),
                               rtol=0, atol=0)
    assert float(out[9:].abs().max()) == 0.0
    assert t_multi.fused_multi_agg.launches == k3
    assert t_flash.flash_self_attention.launches == k4


def pytest_plain_attention_rounds_p_like_the_kernel():
    """bf16 operands: the plain versions round the probabilities to bf16
    before ``p @ v`` (the kernel's rounding point) and normalize by the
    unrounded sum. Logits (0, -0.1): p = (1, 0.9047) rounds to (1, 0.90625),
    so the output 0.90625 / 1.9047 rounds to 0.4765625 in bf16, where the
    unrounded p would give 0.474609375."""
    node_graph = torch.zeros(2, dtype=torch.int64)
    node_mask = torch.ones(2, dtype=torch.bool)
    q = torch.ones(2, 1, 1, dtype=torch.bfloat16)
    k = torch.tensor([0.0, -0.1], dtype=torch.bfloat16).reshape(2, 1, 1)
    v = torch.tensor([0.0, 1.0], dtype=torch.bfloat16).reshape(2, 1, 1)
    for out in (t_flash.reference_masked_attention(q, k, v, node_graph, node_mask),
                t_flash.reference_gathered_attention(q, k, v, node_graph, node_mask, 1, 2)):
        assert float(out[0, 0, 0]) == 0.4765625


def pytest_plain_versions_keep_the_operand_dtype_and_sum_in_f32():
    """bf16 messages: the sum is taken in f32 and rounded once."""
    ids = torch.zeros(300, dtype=torch.int64)
    msg = torch.full((300, 2), 1.0, dtype=torch.bfloat16)
    out = t_sorted.sorted_segment_sum_plain(msg, ids, 2)
    assert out.dtype == torch.bfloat16
    assert float(out[0, 0]) == 300.0  # a bf16 running sum would stall at 256
    assert float(out[1].abs().sum()) == 0.0


def pytest_routing_masks_before_k1_and_not_before_k2():
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(_sorted_ids(rng, 30, 6, 8))
    msg = torch.ones(30, 4)
    mask = torch.arange(30) < 20
    out = t_segment.segment_sum(msg, ids, 6, mask, sorted_ids=True, max_degree=8)
    assert float(out.sum()) == 20 * 4
    ops = [torch.from_numpy(a) for a in _fused_operands(rng, 30, 6, 4, 3)]
    torch.testing.assert_close(
        t_segment.fused_edge_message_sum(*ops, ids, 6, max_degree=8),
        t_fused.reference_edge_message_sum(*ops, ids, 6),
    )


def pytest_fused_edge_rows_per_block_follow_the_mean_degree():
    assert t_fused.rows_per_block(1_000_000, 10_000) == 5  # 512 edges / degree 100
    assert t_fused.rows_per_block(34_000, 2_160) == 32  # capped
    assert t_fused.rows_per_block(10, 10_000) == 32
    assert t_fused.rows_per_block(10_000, 1) == 1


def pytest_build_keys_libraries_by_source_and_flags():
    from hydragnn_tpu_torch.ops import _build

    paths = [_build.library_path(k) for k in
             ("sorted_segment_sum", "fused_edge", "multi_agg", "flash_attention")]
    p1 = paths[0]
    assert all(p.parent == _build.BUILD_DIR and p.suffix == ".so" for p in paths)
    assert len(set(paths)) == 4 and p1 == _build.library_path("sorted_segment_sum")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    with pytest.raises(RuntimeError, match="no kernel source"):
        _build.library_path("no_such_kernel")
