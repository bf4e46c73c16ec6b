"""The port's SP evaluation path against the JAX package: K4b's plain
version (``ops/flash_attention.flash_block_summary`` on CPU tensors) against
the JAX block-summary kernel in interpret mode and its reference, ring
attention over a ring of one rank and over two gloo ranks, GIN on bridged
weights, the periodic radius graph and the BCC supercell, and the GIN
GPS-ring model through ``make_sp_eval_step`` against the JAX package's SP
forward on its 8-device CPU mesh.

Tolerances: f32 attention is the same function summed in another order:
2e-5 (the JAX package's own kernel-vs-reference and ring-vs-dense
tolerance). In bf16 both compute f32 scores and round p to bf16 before
``p . v``; the JAX kernel also rounds ``o`` and ``l`` before ``o * l``, as the
port does, so m, l and acc agree to a bf16 ulp or two: 1e-2 of each output's
largest value. Models: rtol 2e-4 and atol 2e-5, the JAX package's
ring-vs-dense model tolerance; GIN without attention: 1e-4 of each head's
largest real value (the EGNN and PNA parity tolerance).
"""

import copy
import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

from hydragnn_tpu.config import update_config as j_update
from hydragnn_tpu.data.graph import PadSpec as JPadSpec
from hydragnn_tpu.data.graph import batch_graphs as j_batch_graphs
from hydragnn_tpu.data.neighbors import radius_graph_pbc as j_radius_graph_pbc
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.ops.pallas_flash_attention import flash_block_summary as j_block_summary
from hydragnn_tpu.ops.pallas_flash_attention import (
    reference_block_summary as j_reference_block_summary,
)
from hydragnn_tpu.parallel.ring_attention import sharded_global_attention
from hydragnn_tpu.parallel.sp import make_sp_eval_step as j_make_sp_eval_step
from hydragnn_tpu.parallel.sp import make_sp_mesh, shard_sp_batch as j_shard_sp_batch
from hydragnn_tpu.parallel.sp import sp_context as j_sp_context
from hydragnn_tpu.train import TrainState, make_optimizer
from hydragnn_tpu_torch.bridge import load_jax_variables
from hydragnn_tpu_torch.config import update_config as t_update
from hydragnn_tpu_torch.data import (
    MinMax,
    PadSpec,
    VariablesOfInterest,
    add_dataset_pe,
    batch_graphs,
    bcc_supercell,
    deterministic_graph_dataset,
    extract_variables,
    radius_graph_pbc,
    split_dataset,
)
from hydragnn_tpu_torch.models import create_model as t_create
from hydragnn_tpu_torch.ops import flash_attention as t_flash
from hydragnn_tpu_torch.parallel import ring_self_attention, shard_sp_batch, sp_context
from hydragnn_tpu_torch.data.neighbors import _radius_graph_pbc_once
from hydragnn_tpu_torch.parallel.ring_attention import _block_attend
from hydragnn_tpu_torch.parallel.sp import make_sp_eval_step
from test_torch_egnn import _assert_close_real_rows, _jax_variables

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
F32_TOL = 2e-5
BF16_RTOL = 1e-2
MODEL_RTOL, MODEL_ATOL = 2e-4, 2e-5


def _qkv(n_q, n_k, h, d, seed, p_mask=0.3):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n_q, h, d)).astype(np.float32)
    k = rng.normal(size=(n_k, h, d)).astype(np.float32)
    v = rng.normal(size=(n_k, h, d)).astype(np.float32)
    return q, k, v, rng.random(n_k) > p_mask


def _dense_reference(q, k, v, key_mask):
    logits = np.einsum("qhd,khd->qhk", q, k) / np.sqrt(q.shape[-1])
    logits = np.where(key_mask[None, None, :], logits, -np.inf)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return np.einsum("qhk,khd->qhd", p / p.sum(-1, keepdims=True), v)


# ---------------------------------------------------------------------------
# K4b: the block summary
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_q,n_k,h,d", [
    (24, 40, 2, 16),     # the JAX package's own case: n_q != n_k
    (40, 24, 1, 8),      # more queries than keys
    (130, 130, 4, 32),   # n_q == n_k over more than one 128-key tile
])
def pytest_block_summary_plain_matches_jax_f32(n_q, n_k, h, d):
    q, k, v, km = _qkv(n_q, n_k, h, d, seed=n_q + n_k)
    want_kernel = j_block_summary(*map(jnp.asarray, (q, k, v, km)), 128, 128, True)
    want_ref = j_reference_block_summary(*map(jnp.asarray, (q, k, v, km)))
    got = t_flash.flash_block_summary(*map(torch.from_numpy, (q, k, v, km)))
    for g, wk, wr, name in zip(got, want_kernel, want_ref, ("m", "l", "acc")):
        assert g.dtype == torch.float32 and tuple(g.shape) == wk.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(wk), rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(wr), rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=name)


def pytest_block_summary_plain_matches_jax_bf16():
    q, k, v, km = _qkv(48, 100, 2, 16, seed=5)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = j_block_summary(jq, jk, jv, jnp.asarray(km), 128, 128, True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = t_flash.flash_block_summary(tq, tk, tv, torch.from_numpy(km))
    for g, w, name in zip(got, want, ("m", "l", "acc")):
        assert g.dtype == torch.bfloat16, name
        w = np.asarray(w, np.float32)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=BF16_RTOL * scale,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def pytest_block_summary_fully_masked_block(dtype):
    """A block of padding keys only gives (<= -1e29, 0, 0) in both packages:
    the merge-neutral element."""
    q, k, v, _ = _qkv(24, 40, 2, 16, seed=21)
    none = np.zeros(40, bool)
    m, l, acc = t_flash.flash_block_summary(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)), torch.from_numpy(none))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jm, jl, jacc = j_block_summary(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                                   jnp.asarray(none), 128, 128, True)
    for got, want in ((m, jm), (l, jl), (acc, jacc)):
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert float(m.float().max()) <= -1e29
    assert float(l.abs().max()) == 0.0 and float(acc.abs().max()) == 0.0


def pytest_cpu_block_summary_counts_nothing():
    q, k, v, km = _qkv(8, 8, 1, 4, seed=0)
    before = t_flash.flash_block_summary.launches
    t_flash.flash_block_summary(*map(torch.from_numpy, (q, k, v, km)))
    assert t_flash.flash_block_summary.launches == before


def pytest_block_summaries_merge_to_one_call():
    """Four key blocks merged through ``_block_attend`` equal one block of
    all the keys, on the flash and the dense route alike."""
    q, k, v, km = (torch.from_numpy(a) for a in _qkv(30, 64, 2, 8, seed=3))
    scale = 1.0 / torch.sqrt(torch.tensor(8.0))
    outs = []
    for flash in (True, False):
        for blocks in (1, 4):
            m = torch.full((30, 2), torch.finfo(torch.float32).min)
            denom, acc = torch.zeros(30, 2), torch.zeros(30, 2, 8)
            for kb, vb, mb in zip(k.chunk(blocks), v.chunk(blocks), km.chunk(blocks)):
                m, denom, acc = _block_attend(q, kb, vb, mb, m, denom, acc, scale, flash)
            outs.append((acc / denom[..., None]).numpy())
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=F32_TOL, atol=F32_TOL)


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,dh,masked_shard", [(1, 8, False), (4, 16, False), (1, 8, True)])
def pytest_ring_one_rank_matches_jax_and_dense(monkeypatch, h, dh, masked_shard):
    """``group=None`` (one block) against the JAX ring with its flash block
    over the 8-device mesh and against the dense numpy reference; with
    ``masked_shard`` the last device's keys are all padding."""
    monkeypatch.setenv("HYDRAGNN_PALLAS_FLASH", "1")
    n = 8 * 16
    q, k, v, mask = _qkv(n, n, h, dh, seed=23 + h, p_mask=0.2)
    if masked_shard:
        mask[:] = True
        mask[-16:] = False
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()), ("data",))
    want = np.asarray(sharded_global_attention(mesh, use_flash=True)(
        *map(jnp.asarray, (q, k, v, mask))))
    dense = _dense_reference(q, k, v, mask)
    for flash in (True, False):
        got = ring_self_attention(*map(torch.from_numpy, (q, k, v, mask)), use_flash=flash)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(got.numpy(), dense, rtol=F32_TOL, atol=F32_TOL)


def _ring_rank(rank, world, init_method, arrays, out_dir):
    """One rank of the gloo ring: its shard of q/k/v/mask through
    ``ring_self_attention`` over the world group, both routes."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    try:
        q, k, v, mask = (torch.from_numpy(a).chunk(world)[rank].contiguous() for a in arrays)
        for flash in (False, True):
            out = ring_self_attention(q, k, v, mask, group=dist.group.WORLD, use_flash=flash)
            np.save(Path(out_dir) / f"out{rank}_{int(flash)}.npy", out.numpy())
        try:
            shard_sp_batch(None, dist.group.WORLD, device="cpu")
        except NotImplementedError:
            (Path(out_dir) / f"refused{rank}").touch()
    finally:
        dist.destroy_process_group()


def pytest_ring_two_gloo_ranks_rotate_to_the_dense_answer(tmp_path):
    """Two processes, one K/V rotation: each rank's local queries attend to
    both ranks' keys (the second rank's last 8 keys are padding), and
    ``shard_sp_batch`` refuses the 2-rank group."""
    world, n, h, dh = 2, 2 * 24, 2, 8
    q, k, v, mask = _qkv(n, n, h, dh, seed=31, p_mask=0.2)
    mask[-8:] = False
    ctx = mp.start_processes(
        _ring_rank, args=(world, f"file://{tmp_path / 'store'}", (q, k, v, mask), str(tmp_path)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the ring ranks did not finish within 120 s")
    want = _dense_reference(q, k, v, mask)
    for flash in (0, 1):
        got = np.concatenate([np.load(tmp_path / f"out{r}_{flash}.npy") for r in range(world)])
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    assert all((tmp_path / f"refused{r}").exists() for r in range(world))


# ---------------------------------------------------------------------------
# data: the periodic radius graph and the BCC supercell
# ---------------------------------------------------------------------------


def _assert_same_arrays(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case,radius,isolated", [
    ("supercell", 1.1, [0, 0, 0]),
    ("retry", 0.55, [22, 1, 0]),             # the third build covers every node
    ("artificial_edges", 0.45, [29, 17, 1]),  # one node is left for the fallback
])
def pytest_radius_graph_pbc_matches_jax(case, radius, isolated):
    """Byte-identical edges and shifts: an ordinary periodic graph, one
    whose first builds leave nodes without an in-edge (the radius grows by
    1.25x per retry), and one with a node still isolated after the last
    retry (an artificial in-edge from ``(i + 1) % n``, zero shift)."""
    rng = np.random.default_rng(4)
    cell = np.eye(3) * 3.0
    pos = rng.uniform(0.0, 3.0, (40, 3))
    k = 12 if case == "supercell" else 6
    once = [_radius_graph_pbc_once(pos, cell, radius * 1.25**a, k, (True,) * 3)
            for a in range(3)]
    assert [40 - np.unique(r).size for _, r, _ in once] == isolated
    got = radius_graph_pbc(pos, cell, radius, max_neighbours=k)
    _assert_same_arrays(got, j_radius_graph_pbc(pos, cell, radius, max_neighbours=k))
    assert np.unique(got[1]).size == 40
    last = next((o for o, n_iso in zip(once, isolated) if n_iso == 0), once[-1])
    e = last[0].size
    _assert_same_arrays([a[:e] for a in got], last)
    lonely = np.setdiff1d(np.arange(40), last[1])
    np.testing.assert_array_equal(got[1][e:], lonely)
    np.testing.assert_array_equal(got[0][e:], (lonely + 1) % 40)
    assert not got[2][e:].any()


def _mesoscale():
    spec = importlib.util.spec_from_file_location(
        "mesoscale_example", REPO / "examples" / "mesoscale" / "mesoscale.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cells,seed", [(2, 7), (3, 11)])
def pytest_bcc_supercell_matches_mesoscale_example(cells, seed):
    want = _mesoscale().build_supercell(cells, jitter=0.03, seed=seed)
    got = bcc_supercell(cells, jitter=0.03, seed=seed)
    fields = ("x", "pos", "senders", "receivers", "edge_shifts", "graph_y")
    _assert_same_arrays([getattr(got, f) for f in fields], [getattr(want, f) for f in fields])
    assert got.num_nodes == 2 * cells**3


# ---------------------------------------------------------------------------
# GIN, then the slice as a whole
# ---------------------------------------------------------------------------


def _gin_config(gps: bool):
    arch = {"mpnn_type": "GIN", "hidden_dim": 16, "num_conv_layers": 2,
            "output_heads": {"graph": {"num_sharedlayers": 1, "dim_sharedlayers": 8,
                                       "num_headlayers": 2, "dim_headlayers": [8, 8]}},
            "task_weights": [1.0]}
    if gps:
        arch.update(global_attn_engine="GPS", global_attn_type="ring", global_attn_heads=4,
                    pe_dim=4, dropout=0.0)
    return {
        "NeuralNetwork": {
            "Architecture": arch,
            "Variables_of_interest": {"input_node_features": [0], "output_names": ["total"],
                                      "output_index": [0], "type": ["graph"]},
            "Training": {"batch_size": 1, "num_epoch": 1},
        },
        "Dataset": {"node_features": {"dim": [1, 1, 1]}, "graph_features": {"dim": [1]}},
    }


@pytest.mark.parametrize("sorted_agg", [True, False])
def pytest_gin_matches_jax_on_bridged_weights(monkeypatch, sorted_agg):
    """A GIN stack (no attention) on a batch of 4 BCC graphs: the port's
    sorted route (K1's plain version) against the JAX package's Pallas route
    in interpret mode, and both unsorted routes."""
    monkeypatch.setenv("HYDRAGNN_PALLAS_SEGMENT", "1")
    raw = deterministic_graph_dataset(12, seed=5)
    raw = MinMax.fit(raw).apply(raw)
    voi = VariablesOfInterest([0], ["total"], ["graph"], [0], [1, 1, 1], [1])
    tr, va, te = split_dataset([extract_variables(g, voi) for g in raw], 0.5)
    cfg = _gin_config(gps=False)
    cfg["NeuralNetwork"]["Architecture"]["use_sorted_aggregation"] = sorted_agg
    jc, tc = j_update(copy.deepcopy(cfg), tr, va, te), t_update(copy.deepcopy(cfg), tr, va, te)
    assert tc["NeuralNetwork"]["Architecture"]["max_in_degree"] == (
        jc["NeuralNetwork"]["Architecture"]["max_in_degree"])
    spec = JPadSpec(n_nodes=sum(g.num_nodes for g in tr[:4]) + 8,
                    n_edges=sum(g.num_edges for g in tr[:4]) + 128, n_graphs=5)
    jb = j_batch_graphs(tr[:4], spec, sort_edges=sorted_agg)
    tb = batch_graphs(tr[:4], PadSpec(spec.n_nodes, spec.n_edges, 5), sort_edges=sorted_agg)
    jm = j_create(jc)
    v = _jax_variables(jm, jb)
    assert v["params"]["graph_convs_0"]["eps"].shape == ()
    tm = t_create(tc, device="cpu")
    load_jax_variables(tm, v)
    assert all(c.sorted_agg is sorted_agg and c.eps.item() == 100.0 for c in tm.graph_convs)
    with torch.no_grad():
        tout = tm(tb)
    _assert_close_real_rows(jm.apply(v, jb, train=False), tout, tb)


def _supercells(n_graphs=6, cells=3):
    """The slice's data pipeline at a small size: BCC supercells, MinMax,
    the variables of interest and Laplacian PE of 4."""
    graphs = [bcc_supercell(cells, jitter=0.03, seed=7 + i) for i in range(n_graphs)]
    graphs = MinMax.fit(graphs).apply(graphs)
    voi = VariablesOfInterest([0], ["total"], ["graph"], [0], [1, 1, 1], [1])
    return add_dataset_pe([extract_variables(g, voi) for g in graphs], 4)


def _ring_both(monkeypatch, graphs_per_batch=1):
    """Both packages' GIN GPS-ring model on bridged weights and one batch
    padded as the mesoscale example pads it for the 8-device mesh."""
    monkeypatch.setenv("HYDRAGNN_PALLAS_FLASH", "1")
    ready = _supercells()
    tr, va, te = ready[:4], ready[4:5], ready[5:]
    cfg = _gin_config(gps=True)
    cfg["NeuralNetwork"]["Architecture"]["use_flash_attention"] = True
    jc = j_update(copy.deepcopy(cfg), tr, va, te)
    tcfg = copy.deepcopy(cfg)
    tcfg["NeuralNetwork"]["Architecture"]["use_sorted_aggregation"] = True
    tc = t_update(tcfg, tr, va, te)
    gs = tr[:graphs_per_batch]
    n, e = sum(g.num_nodes for g in gs), sum(g.num_edges for g in gs)
    spec = JPadSpec(n_nodes=(n // 8 + 2) * 8, n_edges=(e // 8 + 2) * 8,
                    n_graphs=graphs_per_batch + 1)
    jb = j_batch_graphs(gs, spec)
    tb = batch_graphs(gs, PadSpec(spec.n_nodes, spec.n_edges, spec.n_graphs), sort_edges=True)
    jm = j_create(jc)
    v = _jax_variables(jm, jb)
    tm = t_create(tc, device="cpu")
    load_jax_variables(tm, v)
    convs = list(tm.graph_convs)
    assert all(c.RingSelfAttention_0.use_flash_attention and c.conv.sorted_agg for c in convs)
    return jc, jm, v, jb, tm, tb


def _close(got, want):
    for name in want:
        np.testing.assert_allclose(got[name].float().numpy(), np.asarray(want[name]),
                                   rtol=MODEL_RTOL, atol=MODEL_ATOL, err_msg=name)


def pytest_gin_ring_sp_eval_matches_jax(monkeypatch):
    """The slice as a whole: the port's ``make_sp_eval_step`` (a ring of one
    rank, K4b's and K1's plain versions) against the JAX package's SP eval
    step over its 8-device mesh (the flash block summary in interpret mode
    in every ring step): outputs, total and per-task losses."""
    jc, jm, v, jb, tm, tb = _ring_both(monkeypatch)
    mesh = make_sp_mesh()
    assert mesh.size == 8
    state = TrainState.create(v, make_optimizer({"type": "AdamW", "learning_rate": 1e-3}))
    jtot, jtasks, jout = j_make_sp_eval_step(jm, mesh)(state, j_shard_sp_batch(jb, mesh))
    tot, tasks, tout = make_sp_eval_step(tm, device="cpu")(tb)
    _close(tout, jout)
    np.testing.assert_allclose(float(tot), float(jtot), rtol=MODEL_RTOL, atol=MODEL_ATOL)
    assert set(tasks) == set(jtasks) == {"total"}
    np.testing.assert_allclose(float(tasks["total"]), float(jtasks["total"]),
                               rtol=MODEL_RTOL, atol=MODEL_ATOL)
    assert np.isfinite(tout["total"][0].item())


def pytest_gin_ring_dense_fallbacks_match(monkeypatch):
    """Outside an SP context both packages take the dense fallback; they
    agree with each other and with the port's ring route."""
    jc, jm, v, jb, tm, tb = _ring_both(monkeypatch)
    jdense = jm.apply(v, jb, train=False)
    with torch.no_grad():
        tdense = tm(tb)
    _close(tdense, jdense)
    _, _, tring = make_sp_eval_step(tm, device="cpu")(tb)
    _close(tring, jdense)


def pytest_gin_ring_two_graph_batch_is_nan(monkeypatch):
    """Ring attention spans every real node, so a batch of two real graphs
    comes out NaN in both packages, on the SP route and the dense one."""
    jc, jm, v, jb, tm, tb = _ring_both(monkeypatch, graphs_per_batch=2)
    mesh = make_sp_mesh()
    with j_sp_context(mesh):
        jring = jax.jit(lambda v_, b_: jm.apply(v_, b_, train=False))(
            v, j_shard_sp_batch(jb, mesh))
    jdense = jm.apply(v, jb, train=False)
    _, _, tring = make_sp_eval_step(tm, device="cpu")(tb)
    with torch.no_grad():
        tdense = tm(tb)
    real = tb.graph_mask.numpy()
    assert real.sum() == 2
    for out in (jring, jdense):
        assert np.isnan(np.asarray(out["total"])[real]).all()
    for out in (tring, tdense):
        assert torch.isnan(out["total"][tb.graph_mask]).all()


def pytest_sp_context_routes_ring_attention(monkeypatch):
    """``sp_context`` is what selects the ring route: the same module gives
    the dense fallback outside it, and the context restores on exit."""
    from hydragnn_tpu_torch.parallel import current_sp

    jc, jm, v, jb, tm, tb = _ring_both(monkeypatch)
    att = tm.graph_convs[0].RingSelfAttention_0
    x = torch.randn(tb.num_nodes, 16, generator=torch.Generator().manual_seed(0))
    calls = []
    monkeypatch.setattr("hydragnn_tpu_torch.models.gps.ring_self_attention",
                        lambda *a, **kw: calls.append(kw) or ring_self_attention(*a, **kw))
    assert current_sp() == (False, None)
    with torch.no_grad():
        dense = att(x, tb)
        with sp_context():
            assert current_sp() == (True, None)
            ring = att(x, tb)
    assert current_sp() == (False, None)
    assert calls == [{"group": None, "use_flash": True}]
    torch.testing.assert_close(ring, dense, rtol=MODEL_RTOL, atol=MODEL_ATOL)
