"""Training GPS in the port against the JAX package, on the CPU.

The multi-moment (K3), flash-attention (K4) and block-summary (K4b)
kernels carry gradients through ``torch.autograd.Function``s whose
backwards recompute through a plain version, as the JAX kernels'
``custom_jvp`` tangent rules do. Here each Function runs with its launch
replaced by its plain version (the kernels run only on the card), and its
first and second derivatives are held against ``jax.grad`` of the JAX
kernel in interpret mode. Then the ring's rotation over two gloo ranks, a
GPS-PNA train step through the Functions and through the plain CPU route
against the JAX ``make_train_step`` (with its kernels in interpret mode),
and ``make_sp_train_step`` against the JAX one on its 8-device CPU mesh.

Tolerances (f32; the same function in another summation order):

- the Functions' derivatives: ``atol + rtol * max |want|`` of each
  gradient with rtol 1e-5, atol 1e-6; the same in bf16 where every value
  is exact (ties split over two or four edges, dyadic inputs, a linear
  loss);
- ring attention's gradients over two ranks against dense attention's
  autograd: 2e-5, the ring's forward tolerance (tests/test_torch_ring.py);
- the GPS-PNA step: test_torch_train.py's (loss 1e-5, gradients 1e-4 of
  each parameter's largest with its floor, the first step's batch-norm
  statistics 1e-5,
  parameters after three AdamW steps 1e-5 absolute (``GPS_TRAJ_ATOL``)
  outside rounding-noise gradients); the bf16 loss 1e-3;
- ``make_sp_train_step``: the JAX package's ring-vs-dense model tolerance
  (rtol 2e-4, atol 2e-5) on the losses and parameters of three steps and
  the first step's running statistics.
"""

import copy
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

from hydragnn_tpu.config import update_config as j_update
from hydragnn_tpu.data import GraphLoader as JLoader
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.ops.pallas_flash_attention import flash_block_summary as j_block_summary
from hydragnn_tpu.ops.pallas_flash_attention import flash_self_attention as j_flash
from hydragnn_tpu.ops.pallas_multi_agg import fused_multi_agg as j_multi_agg
from hydragnn_tpu.parallel.sp import make_sp_mesh, shard_sp_batch as j_shard_sp_batch
from hydragnn_tpu.parallel.sp import make_sp_train_step as j_make_sp_train_step
from hydragnn_tpu.train import TrainState as JState
from hydragnn_tpu.train import make_optimizer as j_make_optimizer
from hydragnn_tpu.train import make_train_step as j_make_train_step
from hydragnn_tpu.train.loop import mp_cast, mp_restore_stats
from hydragnn_tpu.train.loss import compute_loss as j_compute_loss
from hydragnn_tpu_torch.bridge import load_jax_variables
from hydragnn_tpu_torch.config import update_config as t_update
from hydragnn_tpu_torch.data import GraphLoader as TLoader
from hydragnn_tpu_torch.data import (
    MinMax,
    PadSpec,
    VariablesOfInterest,
    add_dataset_pe,
    batch_graphs,
    deterministic_graph_dataset,
    extract_variables,
)
from hydragnn_tpu_torch.models import create_model as t_create
from hydragnn_tpu_torch.ops import flash_attention as t_flash
from hydragnn_tpu_torch.ops import multi_agg as t_multi
from hydragnn_tpu_torch.parallel import make_sp_train_step, ring_self_attention
from hydragnn_tpu_torch.train import TrainState, compute_loss, make_optimizer, make_train_step
from test_ring_attention import _gps_ring_setup
from test_torch_pna import _pna_config, _splits
from test_torch_train import (
    BF16_LOSS_RTOL,
    GRAD_FLOOR,
    GRAD_RTOL,
    LOSS_RTOL,
    NOISE,
    STATS_RTOL,
    _assert_close,
    _flat,
    _jax_snapshot,
    _jax_variables,
    _torch_grads,
    _torch_snapshot,
    _torch_stats,
)

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
RING_TOL = 2e-5
# parameters after three AdamW steps (lr 1e-3): Adam scales each element's
# step by its own gradient's size, so an element whose gradient changes
# sign between steps moves with that gradient's relative difference, here
# up to 4e-4 for elements at 3e-4 of the largest gradient (2.6e-6 measured)
GPS_TRAJ_ATOL = 1e-5
SP_RTOL, SP_ATOL = 2e-4, 2e-5


def _close(got, want, what):
    """Each gradient within ``ATOL + RTOL`` of its largest value."""
    for i, (a, b) in enumerate(zip(got, want)):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        assert a.shape == b.shape, (what, i)
        assert np.isfinite(a).all(), (what, i)
        err = float(np.abs(a - b).max(initial=0.0))
        assert err <= ATOL + RTOL * float(np.abs(b).max(initial=0.0)), (what, i, err)


def _jax_first_and_second(loss, inputs, vs):
    """``jax.grad`` of ``loss`` at ``inputs``, then the gradient of
    ``sum_i <grad_i, vs[i]>``: first and second order."""
    argnums = tuple(range(len(inputs)))
    grad = jax.grad(loss, argnums=argnums)
    second = jax.grad(lambda *a: sum(jnp.sum(g * v) for g, v in zip(grad(*a), vs)),
                      argnums=argnums)
    return [np.asarray(g) for g in grad(*inputs)], [np.asarray(g) for g in second(*inputs)]


def _torch_first_and_second(loss, inputs, vs, dtype=torch.float32):
    leaves = [torch.from_numpy(np.array(a)).to(dtype).requires_grad_(True) for a in inputs]
    g = torch.autograd.grad(loss(*leaves), leaves, create_graph=True)
    gg = torch.autograd.grad(sum(torch.sum(a * torch.from_numpy(v).to(a.dtype))
                                 for a, v in zip(g, vs)), leaves)
    return [t.detach().float().numpy() for t in g], [t.float().numpy() for t in gg]


# ---------------------------------------------------------------------------
# K3: the multi-moment aggregation's Function
# ---------------------------------------------------------------------------


def _k3_case(recv, gate, seed, scale=0.5):
    """Ascending ids over 7 rows with an empty row (1); in rows 0 and 4 two
    edges carry the same message (a tie for min and max in every channel),
    in row 6 three do."""
    rng = np.random.default_rng(seed)
    n, c = 7, 5
    ids = np.repeat(np.arange(n), [3, 0, 4, 1, 5, 2, 6]).astype(np.int64)
    e = ids.size
    nr = (scale * rng.normal(size=(n, c))).astype(np.float32)
    ei = (scale * rng.normal(size=(e, c))).astype(np.float32)
    gt = rng.normal(size=(e, c)).astype(np.float32)
    for a, b in ((0, 1), (8, 10), (16, 17), (16, 19)):
        ei[b], gt[b] = ei[a], gt[a]
    inputs = [x for x, on in ((nr, recv), (ei, True), (gt, gate)) if on]
    return ids, n, nr if recv else None, gt if gate else None, inputs, rng


@pytest.mark.parametrize("recv,gate", [(True, False), (True, True), (False, False),
                                       (False, True)])
def pytest_k3_function_derivatives_match_jax(monkeypatch, recv, gate):
    """``_FusedMultiAgg`` with and without ``node_recv`` and ``gate``,
    ties in min and max, an empty row: the first and second derivatives of
    ``sum(w * tanh(moment))`` over sum, min, max and sumsq against
    ``jax.grad`` through the JAX kernel's tangent rule."""
    monkeypatch.setattr(t_multi, "_launch", t_multi.reference_multi_agg)
    ids, n, nr, gt, inputs, rng = _k3_case(recv, gate, seed=int(recv) + 2 * int(gate))
    ws = [rng.normal(size=(n, 5)).astype(np.float32) for _ in range(4)]
    vs = [rng.normal(size=a.shape).astype(np.float32) for a in inputs]

    def split(args):
        args = list(args)
        return (args.pop(0) if recv else None), args.pop(0), (args.pop(0) if gate else None)

    def j_loss(*args):
        s, _, mn, mx, ssq = j_multi_agg(*split(args), jnp.asarray(ids, jnp.int32), n, 8,
                                        interpret=True)
        return sum(jnp.sum(w * jnp.tanh(o)) for w, o in zip(ws, (s, mn, mx, ssq)))

    def t_loss(*args):
        s, cnt, mn, mx, ssq = t_multi._FusedMultiAgg.apply(*split(args), torch.from_numpy(ids), n)
        assert not cnt.requires_grad and cnt.tolist() == [3, 0, 4, 1, 5, 2, 6]
        return sum(torch.sum(torch.from_numpy(w) * torch.tanh(o))
                   for w, o in zip(ws, (s, mn, mx, ssq)))

    want = _jax_first_and_second(j_loss, inputs, vs)
    got = _torch_first_and_second(t_loss, inputs, vs)
    for order, a, b in zip(("first", "second"), got, want):
        _close(a, b, order)


def pytest_k3_function_splits_bf16_ties_as_jax(monkeypatch):
    """bf16 messages where four edges of a row tie for its min and two for
    its max, every value exact in bf16 (dyadic inputs, a linear loss with
    power-of-two weights): the gradients equal JAX's, a quarter and a half
    of the row's weight on each tied edge, and the empty row's min and max
    pass none."""
    monkeypatch.setattr(t_multi, "_launch", t_multi.reference_multi_agg)
    ids = np.array([0, 0, 0, 0, 0, 0, 2, 2], np.int64)
    nr = np.array([[0.5, -1.0], [2.0, 0.25], [1.0, 1.0]], np.float32)
    ei = np.array([[-0.5, 0.5], [-0.5, 0.5], [-0.5, 0.5], [-0.5, 0.5], [1.5, 2.0],
                   [1.5, 2.0], [0.25, -0.75], [0.5, 0.125]], np.float32)
    w = [np.array([[2.0, -1.0], [4.0, 8.0], [0.5, 1.0]], np.float32) * f for f in (1, 2, 4, 0.5)]

    def j_loss(a, b):
        s, _, mn, mx, ssq = j_multi_agg(a, b, None, jnp.asarray(ids, jnp.int32), 3, 8,
                                        interpret=True)
        return sum(jnp.sum(wi * o) for wi, o in zip(w, (s, mn, mx, ssq)))

    def t_loss(a, b):
        s, _, mn, mx, ssq = t_multi._FusedMultiAgg.apply(a, b, None, torch.from_numpy(ids), 3)
        return sum(torch.sum(torch.from_numpy(wi) * o) for wi, o in zip(w, (s, mn, mx, ssq)))

    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (nr, ei)]
    want = [np.asarray(g, np.float32) for g in jax.grad(j_loss, argnums=(0, 1))(*jb)]
    got, _ = _torch_first_and_second(t_loss, [nr, ei], [nr, ei], torch.bfloat16)
    _close(got, want, "bf16 ties")
    # channel 0 of row 0: edges 0-3 tie for its min (weight 4, a quarter
    # each), edges 4-5 for its max (weight 8, a half each)
    msg = nr[ids] + ei
    d_min = np.where(msg[:6, 0] == msg[:6, 0].min(), w[1][0, 0] / 4, 0.0)
    d_max = np.where(msg[:6, 0] == msg[:6, 0].max(), w[2][0, 0] / 2, 0.0)
    expect = w[0][0, 0] + d_min + d_max + 2 * msg[:6, 0] * w[3][0, 0]
    np.testing.assert_array_equal(got[1][:6, 0], expect)
    assert got[0][1].tolist() == [0.0, 0.0]  # row 1 has no edge


# ---------------------------------------------------------------------------
# K4 and K4b: the attention Functions
# ---------------------------------------------------------------------------


def _masked_launch(q, k, v, node_graph, node_mask, num_graphs):
    return t_flash.reference_masked_attention(q, k, v, node_graph, node_mask)


@pytest.mark.parametrize("sizes,nmax,h,d", [
    ([5, 9, 3], 9, 2, 8),      # the bound is the largest graph
    ([1, 12, 4, 7], 16, 1, 4),  # a single-node graph, slots left over
])
def pytest_k4_function_derivatives_match_jax(monkeypatch, sizes, nmax, h, d):
    """``_FlashSelfAttention`` over graphs with padding rows after them: the
    derivatives of ``sum(w * tanh(out))`` in q, k and v against
    ``jax.grad`` of the JAX kernel (its tangent rule the gathered
    reference); the padding rows' q, k and v get zero gradients."""
    monkeypatch.setattr(t_flash, "_launch_attention", _masked_launch)
    n_pad = 4
    g = len(sizes) + 1
    node_graph = np.concatenate([np.full(s, i) for i, s in enumerate(sizes)]
                                + [np.full(n_pad, g - 1)]).astype(np.int64)
    node_mask = np.arange(node_graph.size) < sum(sizes)
    rng = np.random.default_rng(sum(sizes))
    n = node_graph.size
    inputs = [rng.normal(size=(n, h, d)).astype(np.float32) for _ in range(3)]
    w = rng.normal(size=(n, h, d)).astype(np.float32)
    vs = [rng.normal(size=(n, h, d)).astype(np.float32) for _ in range(3)]
    jg, jm = jnp.asarray(node_graph), jnp.asarray(node_mask)
    tg, tm = torch.from_numpy(node_graph), torch.from_numpy(node_mask)

    def j_loss(q, k, v):
        return jnp.sum(w * jnp.tanh(j_flash(q, k, v, jg, jm, g, nmax, interpret=True)))

    def t_loss(q, k, v):
        out = t_flash._FlashSelfAttention.apply(q, k, v, tg, tm, g, nmax)
        return torch.sum(torch.from_numpy(w) * torch.tanh(out))

    want = _jax_first_and_second(j_loss, inputs, vs)
    got = _torch_first_and_second(t_loss, inputs, vs)
    for order, a, b in zip(("first", "second"), got, want):
        _close(a, b, order)
        assert all(np.abs(x[~node_mask]).max() == 0.0 for x in a)


@pytest.mark.parametrize("masked,rows", [("some", None), ("some", 3), ("all", None), ("all", 3)])
def pytest_k4b_function_derivatives_match_jax(monkeypatch, masked, rows):
    """``_FlashBlockSummary`` (n_q != n_k), with some keys masked or every
    key masked (every row fully masked: ``(-1e30, 0, 0)``), its recompute
    in one block of query rows or in blocks of 3: the derivatives of
    ``sum(w * tanh(output))`` over m, l and acc against ``jax.grad`` of the
    JAX kernel; fully masked rows give finite zero gradients."""
    monkeypatch.setattr(t_flash, "_launch_summary", t_flash.reference_block_summary)
    nq, nk, h, d = 10, 14, 2, 8
    if rows is not None:
        monkeypatch.setattr(t_flash, "_RECOMPUTE_BYTES", 4 * h * nk * rows)
    rng = np.random.default_rng(7 + (rows or 0))
    q = rng.normal(size=(nq, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(nk, h, d)).astype(np.float32) for _ in range(2))
    key_mask = rng.random(nk) > 0.3 if masked == "some" else np.zeros(nk, bool)
    ws = [rng.normal(size=s).astype(np.float32) for s in ((nq, h), (nq, h), (nq, h, d))]
    vs = [rng.normal(size=a.shape).astype(np.float32) for a in (q, k, v)]
    # m is a score maximum: scaled so that tanh does not saturate on it
    scales = (0.1, 1.0, 1.0)

    def j_loss(q_, k_, v_):
        outs = j_block_summary(q_, k_, v_, jnp.asarray(key_mask), 128, 128, True)
        return sum(jnp.sum(w * jnp.tanh(c * o)) for w, c, o in zip(ws, scales, outs))

    def t_loss(q_, k_, v_):
        outs = t_flash._FlashBlockSummary.apply(q_, k_, v_, torch.from_numpy(key_mask))
        return sum(torch.sum(torch.from_numpy(w) * torch.tanh(c * o))
                   for w, c, o in zip(ws, scales, outs))

    want = _jax_first_and_second(j_loss, [q, k, v], vs)
    got = _torch_first_and_second(t_loss, [q, k, v], vs)
    for order, a, b in zip(("first", "second"), got, want):
        _close(a, b, order)
        if masked == "all":
            assert all(np.isfinite(x).all() and np.abs(x).max() == 0.0 for x in a)


# ---------------------------------------------------------------------------
# the ring's rotation over two gloo ranks
# ---------------------------------------------------------------------------


def _ring_grad_rank(rank, world, init_method, arrays, out_dir):
    """One rank of the gloo ring: its shard of q/k/v/mask through
    ``ring_self_attention`` over the world group (both routes), then the
    gradients of ``sum(w * out)`` in its shard's q, k and v."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    try:
        q, k, v, mask, w = (torch.from_numpy(a).chunk(world)[rank].contiguous() for a in arrays)
        for flash in (False, True):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = ring_self_attention(*leaves, mask, group=dist.group.WORLD, use_flash=flash)
            grads = torch.autograd.grad(torch.sum(w * out), leaves)
            np.save(Path(out_dir) / f"grads{rank}_{int(flash)}.npy",
                    np.stack([t.numpy() for t in grads]))
    finally:
        dist.destroy_process_group()


def pytest_ring_gradients_over_two_gloo_ranks_match_dense(tmp_path):
    """Each rank's q, k and v gradients of ``sum(w * out)`` through
    ``ring_self_attention`` over two gloo processes (the second rank's
    last 6 keys padding) equal dense attention's autograd over the whole
    sequence, on the einsum and the block-summary route: a key block's
    gradient holds the other rank's queries' terms, sent back round the
    ring."""
    world, n, h, d = 2, 2 * 20, 2, 8
    rng = np.random.default_rng(41)
    q, k, v, w = (rng.normal(size=(n, h, d)).astype(np.float32) for _ in range(4))
    mask = rng.random(n) > 0.2
    mask[-6:] = False
    ctx = mp.start_processes(
        _ring_grad_rank,
        args=(world, f"file://{tmp_path / 'store'}", (q, k, v, mask, w), str(tmp_path)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the ring ranks did not finish within 120 s")
    leaves = [torch.from_numpy(a).double().requires_grad_(True) for a in (q, k, v)]
    logits = torch.einsum("qhd,khd->qhk", leaves[0], leaves[1]) / np.sqrt(d)
    logits = torch.where(torch.from_numpy(mask)[None, None, :], logits, -np.inf)
    dense = torch.einsum("qhk,khd->qhd", torch.softmax(logits, dim=-1), leaves[2])
    want = torch.autograd.grad(torch.sum(torch.from_numpy(w).double() * dense), leaves)
    for flash in (0, 1):
        got = np.concatenate([np.load(tmp_path / f"grads{r}_{flash}.npy") for r in range(world)],
                             axis=1)
        for name, a, b in zip("qkv", got, want):
            np.testing.assert_allclose(a, b.numpy(), rtol=RING_TOL, atol=RING_TOL,
                                       err_msg=f"{name} flash={flash}")


# ---------------------------------------------------------------------------
# GPS-PNA: one train step, three AdamW steps, bf16
# ---------------------------------------------------------------------------


def _through_functions(monkeypatch):
    """The model's call sites of K3, K4 and K4b take the kernels'
    Functions on CPU tensors, each launch replaced by its plain version."""
    import hydragnn_tpu_torch.models.gps as gps
    import hydragnn_tpu_torch.ops.segment as segment
    import hydragnn_tpu_torch.parallel.ring_attention as ring

    monkeypatch.setattr(t_multi, "_launch", t_multi.reference_multi_agg)
    monkeypatch.setattr(t_flash, "_launch_attention", _masked_launch)
    monkeypatch.setattr(t_flash, "_launch_summary", t_flash.reference_block_summary)
    monkeypatch.setattr(segment, "fused_multi_agg", t_multi._FusedMultiAgg.apply)
    monkeypatch.setattr(gps, "flash_self_attention", t_flash._FlashSelfAttention.apply)
    monkeypatch.setattr(ring, "flash_block_summary", t_flash._FlashBlockSummary.apply)


def _gps_train_config():
    cfg = _pna_config(gps=True, fused=True)
    cfg["NeuralNetwork"]["Architecture"]["use_flash_attention"] = True
    cfg["NeuralNetwork"]["Training"]["Optimizer"] = {"type": "AdamW", "learning_rate": 1e-3}
    return cfg


class _GpsCase:
    """GPS-PNA (hidden 16, 2 conv layers, 2 heads, PE 4, flash and
    multi-moment routes on) on both sides with bridged variables, the
    train batches of epoch 0 of each package, and the JAX loss function
    under ``value_and_grad`` (jitted once per dtype)."""

    def __init__(self):
        self.splits = _splits(pe=True)
        tr, va, te = self.splits
        self.raw = _gps_train_config()
        self.jc = j_update(copy.deepcopy(self.raw), tr, va, te)
        self.tc = t_update(copy.deepcopy(self.raw), tr, va, te)
        self.jbatches = list(JLoader(tr, 4, sort_edges=True))
        self.tbatches = list(TLoader(tr, 4, sort_edges=True))
        self.jm = j_create(self.jc)
        self.v = _jax_variables(self.jm, self.jbatches[0])
        self._vg = {}

    def torch_model(self):
        m = t_create(self.tc, device="cpu")
        load_jax_variables(m, self.v)
        assert all(c.MultiheadSelfAttention_0.use_flash_attention and c.conv.multi_agg
                   for c in m.graph_convs)
        return m

    def jax_variables(self):
        return jax.tree_util.tree_map(jnp.asarray, self.v)

    def value_and_grad(self, mixed_precision=False):
        if mixed_precision not in self._vg:
            jm, cfg = self.jm, self.jm.cfg

            def loss_fn(params, stats, batch):
                if mixed_precision:
                    params, batch = mp_cast(params, batch, False)
                tot, tasks, mutated, _ = j_compute_loss(
                    jm, {"params": params, "batch_stats": stats}, batch, cfg, True,
                    jax.random.PRNGKey(0), False)
                if mixed_precision:
                    mutated = mp_restore_stats(mutated)
                return tot.astype(jnp.float32), (tasks, mutated)

            self._vg[mixed_precision] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        return self._vg[mixed_precision]


@pytest.fixture(scope="module")
def gps_case():
    """The JAX side runs its Pallas kernels in interpret mode, so K3's and
    K4's custom_jvp rules are what it differentiates."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("HYDRAGNN_PALLAS_SEGMENT", "1")
        m.setenv("HYDRAGNN_PALLAS_FLASH", "1")
        yield _GpsCase()


@pytest.fixture(params=["plain versions", "kernels' Functions"])
def gps_route(request, monkeypatch):
    if request.param == "kernels' Functions":
        _through_functions(monkeypatch)
    return request.param


def pytest_gps_pna_step0_gradients_match_jax(gps_case, gps_route):
    """The first train step's loss, per-task losses, every parameter's
    gradient and the updated running statistics, f32, through the
    Functions (with plain launches) and through the CPU route."""
    c = gps_case
    jv = c.jax_variables()
    (jtot, (jtasks, jmut)), jgrads = c.value_and_grad()(jv["params"], jv["batch_stats"],
                                                         c.jbatches[0])
    tm = c.torch_model()
    tm.train()
    tot, tasks, _ = compute_loss(tm, c.tbatches[0], tm.cfg, False)
    tot.backward()
    unused = [n for n, p in tm.named_parameters() if p.grad is None]
    for n, p in tm.named_parameters():  # zero, as make_train_step and optax give
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=LOSS_RTOL)
    for k in jtasks:
        np.testing.assert_allclose(float(tasks[k].detach()), float(jtasks[k]), rtol=LOSS_RTOL)
    _assert_close(_flat(jgrads), _torch_grads(tm), GRAD_RTOL, "grad", floor=GRAD_FLOOR)
    _assert_close(_flat(jmut["batch_stats"]), _torch_stats(tm), STATS_RTOL, "stats")
    for conv in tm.graph_convs:
        for part in (conv.conv, conv.MultiheadSelfAttention_0):
            assert all(float(p.grad.abs().max()) > 0 for p in part.parameters())
    assert unused == ["rel_pos_emb.weight"]  # no relative PE without edge features


def pytest_gps_pna_three_adamw_steps_match_jax(gps_case, gps_route):
    """Three guarded f32 AdamW steps of ``make_train_step`` against the JAX
    package's: the losses of every step, the first step's batch-norm
    statistics, then the parameters (rounding-noise gradients excepted, as
    test_torch_train.py states) and the step counters."""
    c = gps_case
    tx = j_make_optimizer(c.jc["NeuralNetwork"]["Training"]["Optimizer"])
    js = JState.create(c.jax_variables(), tx)
    jstep = j_make_train_step(c.jm, tx, guard=True)
    tm = c.torch_model()
    ts = TrainState.create(tm, make_optimizer(tm, c.tc["NeuralNetwork"]["Training"]["Optimizer"]))
    tstep = make_train_step(tm)
    for i, (jb, tb) in enumerate(zip(c.jbatches[:3], c.tbatches[:3])):
        js, jtot, _ = jstep(js, jb, jax.random.PRNGKey(0))
        ts, ttot, _ = tstep(ts, tb)
        np.testing.assert_allclose(float(ttot), float(jtot), rtol=LOSS_RTOL)
        if i == 0:
            # the first step's running statistics (later forwards carry the
            # rounding-noise biases below into the running means of the
            # batch norms they feed)
            _assert_close(_jax_snapshot(js)[1], _torch_snapshot(ts)[1], STATS_RTOL, "stats")
    jp, _, jcount = _jax_snapshot(js)
    tp, _, tcount = _torch_snapshot(ts)
    jv = c.jax_variables()
    _, g0 = c.value_and_grad()(jv["params"], jv["batch_stats"], c.jbatches[0])
    g0 = _flat(g0)
    top = max(float(np.abs(g).max()) for g in g0.values())
    for k, want in jp.items():
        err = np.abs(tp[k] - want)
        noise = np.abs(g0[k]) < NOISE * top
        assert float(np.where(noise, 0.0, err).max()) <= GPS_TRAJ_ATOL, (k, float(err.max()))
        assert float(err.max()) <= 2 * 1e-3 * 3, k
    assert tcount == jcount == (3, 0, 0)


def pytest_gps_pna_mixed_precision_step_matches_jax(gps_case, gps_route):
    """One bf16 ``mixed_precision`` train step: the loss against the JAX
    loss function under its ``mp_cast``, f32 gradients on the f32 masters,
    every one finite."""
    c = gps_case
    jv = c.jax_variables()
    (jtot, _), _ = c.value_and_grad(True)(jv["params"], jv["batch_stats"], c.jbatches[0])
    tm = c.torch_model()
    ts = TrainState.create(tm, make_optimizer(tm, {"type": "AdamW", "learning_rate": 1e-3}))
    ts, tot, _ = make_train_step(tm, mixed_precision=True)(ts, c.tbatches[0])
    np.testing.assert_allclose(float(tot), float(jtot), rtol=BF16_LOSS_RTOL)
    assert all(p.grad.dtype == torch.float32 and bool(torch.isfinite(p.grad).all())
               for p in tm.parameters())
    assert int(ts.skipped_steps) == 0


# ---------------------------------------------------------------------------
# make_sp_train_step: one spanning graph, a ring of one rank
# ---------------------------------------------------------------------------


def _port_ring_batch(jconfig, jbatch):
    """The JAX setup's graphs built by the port's pipeline, its config
    completed by the port with the sorted and block-summary kernels' routes
    on, and its one spanning graph padded as the JAX batch is."""
    raw = deterministic_graph_dataset(6, unit_cell_x_range=(3, 4), unit_cell_y_range=(3, 4),
                                      seed=3)
    raw = MinMax.fit(raw).apply(raw)
    voi = VariablesOfInterest([0], ["sum_x_x2_x3"], ["graph"], [0], [1, 1, 1], [1])
    ready = add_dataset_pe([extract_variables(g, voi) for g in raw], 1)
    cfg = copy.deepcopy(jconfig)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch.update(use_sorted_aggregation=True, use_flash_attention=True)
    cfg = t_update(cfg, ready[:4], ready[4:5], ready[5:])
    spec = PadSpec(jbatch.x.shape[0], jbatch.senders.shape[0], 2)
    return cfg, batch_graphs([ready[0]], spec, sort_edges=True)


@pytest.mark.parametrize("route", ["plain versions", "kernels' Functions"])
def pytest_sp_train_step_matches_jax(monkeypatch, route):
    """The port's ``make_sp_train_step`` on a ring of one rank (K1's and
    K4b's Functions or plain versions) against the JAX package's over its
    8-device CPU mesh, on the JAX ring test's spanning graph and weights:
    the losses of three AdamW steps (lr 5e-3), then every parameter and
    running statistic."""
    if route == "kernels' Functions":
        _through_functions(monkeypatch)
    config, _, variables, jbatch, _ = _gps_ring_setup()
    # no dropout, so that both packages' train-mode forwards are one function
    config["NeuralNetwork"]["Architecture"]["dropout"] = 0.0
    jm = j_create(config)
    tx = j_make_optimizer({"type": "AdamW", "learning_rate": 5e-3})
    js = JState.create(variables, tx)
    mesh = make_sp_mesh()
    jstep = j_make_sp_train_step(jm, tx, mesh)
    sb = j_shard_sp_batch(jbatch, mesh)
    tcfg, tb = _port_ring_batch(config, jbatch)
    tm = t_create(tcfg, device="cpu")
    load_jax_variables(tm, jax.device_get(variables))
    assert all(c.RingSelfAttention_0.use_flash_attention and c.conv.sorted_agg
               for c in tm.graph_convs)
    ts = TrainState.create(tm, make_optimizer(tm, {"type": "AdamW", "learning_rate": 5e-3}),
                           guard=False)
    tstep = make_sp_train_step(tm, ts)
    lr = 5e-3
    for i in range(3):
        js, jtot, _ = jstep(js, sb, jax.random.PRNGKey(i))
        ts, ttot, _ = tstep(tb)
        np.testing.assert_allclose(float(ttot), float(jtot), rtol=SP_RTOL, atol=SP_ATOL)
        if i == 0:
            g0 = {n: p.grad.numpy().copy() for n, p in tm.named_parameters()}
            # the first step's running statistics: its forward ran on the
            # bridged weights (later ones carry the noise below into the
            # running means of the batch norms those biases feed)
            jst, tst = _jax_snapshot(js)[1], _torch_snapshot(ts)[1]
            assert set(jst) == set(tst)
            for k, want in jst.items():
                np.testing.assert_allclose(tst[k], want, rtol=SP_RTOL, atol=SP_ATOL, err_msg=k)
    jp, tp = _jax_snapshot(js)[0], _torch_snapshot(ts)[0]
    assert set(jp) == set(tp)
    # a parameter whose step-0 gradient is rounding noise (the bias of a
    # dense layer that feeds a batch norm: zero in exact arithmetic) moves
    # by about lr per step either way in both packages: only a bound holds
    top = max(float(np.abs(g).max()) for g in g0.values())
    for k, want in jp.items():
        noise = np.abs(g0[k]) < NOISE * top
        err = np.abs(tp[k] - want)
        assert float(np.where(noise, 0.0, err - SP_RTOL * np.abs(want)).max()) <= SP_ATOL, k
        assert float(err.max()) <= 2 * lr * 3, k
    assert int(ts.step) == 3
