"""The port's GPS pieces against the JAX package: K4's plain versions
(hydragnn_tpu_torch/ops/flash_attention.py) against the JAX flash kernel in
interpret mode and its dense references, the Laplacian positional
encodings, and the GPS-PNA ``HydraModel`` on bridged weights, in f32 and
under both packages' mixed-precision eval cast; GIN under GPS performer
attention (served answers and one step's gradients) on bridged weights.

Tolerances: attention in f32 is the same function summed in another order
(2e-5, the JAX package's own kernel-vs-dense tolerance). In bf16 the JAX
kernel rounds its probabilities to bf16 against a running maximum where the
port's plain version uses the row's final one, and both round the output:
2e-2 of max |v|. Models in f32: real rows to 1e-4 of each head's largest
value.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydragnn_tpu.config import update_config as j_update
from hydragnn_tpu.data import GraphLoader as JLoader
from hydragnn_tpu.data.lappe import laplacian_pe as j_laplacian_pe
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.ops.pallas_flash_attention import flash_self_attention as j_flash
from hydragnn_tpu.ops.pallas_flash_attention import (
    reference_gathered_attention as j_gathered,
)
from hydragnn_tpu.ops.pallas_flash_attention import reference_masked_attention as j_masked
from hydragnn_tpu.train.loop import mp_cast_eval as j_mp_cast_eval
from hydragnn_tpu_torch.bridge import load_jax_variables
from hydragnn_tpu_torch.config import update_config as t_update
from hydragnn_tpu_torch.data import GraphLoader as TLoader
from hydragnn_tpu_torch.data import add_graph_pe, laplacian_pe, oc20_shaped_dataset
from hydragnn_tpu_torch.models import create_model as t_create
from hydragnn_tpu_torch.ops import flash_attention as t_flash
from hydragnn_tpu_torch.train import mp_cast_eval
from test_torch_egnn import _assert_close_real_rows, _jax_variables
from test_torch_pna import _pna_config, _splits

torch.set_num_threads(2)


def _flat_layout(sizes, n_pad):
    """Graphs contiguous along the node axis, then ``n_pad`` padding nodes
    in the final (dummy) graph: the batcher's layout."""
    g = len(sizes) + 1
    node_graph = np.concatenate([np.full(s, i) for i, s in enumerate(sizes)]
                                + [np.full(n_pad, g - 1)]).astype(np.int64)
    node_mask = np.arange(node_graph.shape[0]) < sum(sizes)
    return node_graph, node_mask, g


def _attention_inputs(sizes, n_pad, h, d, seed):
    node_graph, node_mask, g = _flat_layout(sizes, n_pad)
    rng = np.random.default_rng(seed)
    qkv = [rng.normal(size=(node_graph.shape[0], h, d)).astype(np.float32) for _ in range(3)]
    return qkv, node_graph, node_mask, g


@pytest.mark.parametrize("sizes,h,d", [
    ([1, 1, 1], 1, 8),                 # single-node graphs
    ([17, 29, 5, 31, 2], 2, 16),       # ragged, wider than one q block
    ([40, 1, 12, 40], 4, 8),           # two graphs at the bound, one single node
])
def pytest_attention_plain_matches_jax_kernel(sizes, h, d):
    qkv, node_graph, node_mask, g = _attention_inputs(sizes, 6, h, d, sum(sizes))
    nmax = max(sizes)
    j = [jnp.asarray(a) for a in qkv]
    jg, jm = jnp.asarray(node_graph), jnp.asarray(node_mask)
    want_kernel = np.asarray(j_flash(*j, jg, jm, g, nmax, interpret=True))
    t = [torch.from_numpy(a) for a in qkv]
    tg, tm = torch.from_numpy(node_graph), torch.from_numpy(node_mask)
    got = t_flash.flash_self_attention(*t, tg, tm, g, nmax).numpy()
    np.testing.assert_allclose(got, want_kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(j_masked(*j, jg, jm)), rtol=2e-5, atol=2e-5)
    gathered = t_flash.reference_gathered_attention(*t, tg, tm, g, nmax).numpy()
    np.testing.assert_allclose(gathered, np.asarray(j_gathered(*j, jg, jm, g, nmax)),
                               rtol=2e-5, atol=2e-5)
    assert np.abs(got[~node_mask]).max() == 0.0  # padding rows are 0


def pytest_attention_plain_bf16_matches_jax_kernel():
    qkv, node_graph, node_mask, g = _attention_inputs([9, 4, 14, 21], 5, 4, 8, 5)
    j = [jnp.asarray(a).astype(jnp.bfloat16) for a in qkv]
    want = np.asarray(j_flash(*j, jnp.asarray(node_graph), jnp.asarray(node_mask), g, 21,
                              interpret=True), np.float32)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in qkv]
    got = t_flash.flash_self_attention(*t, torch.from_numpy(node_graph),
                                       torch.from_numpy(node_mask), g, 21)
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(qkv[2]).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2e-2 * scale)


def pytest_cpu_attention_wrapper_counts_nothing():
    qkv, node_graph, node_mask, g = _attention_inputs([3, 5], 2, 2, 4, 0)
    before = t_flash.flash_self_attention.launches
    t_flash.flash_self_attention(*[torch.from_numpy(a) for a in qkv],
                                 torch.from_numpy(node_graph), torch.from_numpy(node_mask), g, 5)
    assert t_flash.flash_self_attention.launches == before


def pytest_laplacian_pe_matches_jax():
    """Ordinary graphs, a graph with fewer modes than ``k`` (zero-padded),
    and an edgeless one."""
    graphs = oc20_shaped_dataset(4, mean_atoms=20, min_atoms=10, max_atoms=40)
    cases = [(g.num_nodes, g.senders, g.receivers, 4) for g in graphs]
    cases += [(3, np.array([0, 1]), np.array([1, 2]), 4), (2, np.zeros(0, int), np.zeros(0, int), 3)]
    for n, s, r, k in cases:
        got = laplacian_pe(n, s, r, k)
        assert got.shape == (n, k) and got.dtype == np.float32
        np.testing.assert_array_equal(got, j_laplacian_pe(n, s, r, k))
    g = add_graph_pe(graphs[0], 4)
    np.testing.assert_array_equal(g.rel_pe, np.abs(g.pe[g.senders] - g.pe[g.receivers]))


def _gps_both(flash, fused=None, conv_scale=1.0):
    tr, va, te = _splits(pe=True)
    cfg = _pna_config(gps=True, fused=fused)
    jc = j_update(copy.deepcopy(cfg), tr, va, te)
    tcfg = copy.deepcopy(cfg)
    tcfg["NeuralNetwork"]["Architecture"]["use_flash_attention"] = flash
    tc = t_update(tcfg, tr, va, te)
    jb = next(iter(JLoader(tr, 4, sort_edges=True)))
    tb = next(iter(TLoader(tr, 4, sort_edges=True)))
    jm = j_create(jc)
    v = _jax_variables(jm, jb)
    v["params"] = {k: jax.tree_util.tree_map(lambda a: a * np.float32(conv_scale), t)
                   if k.startswith("graph_convs_") else t for k, t in v["params"].items()}
    tm = t_create(tc, device="cpu")
    load_jax_variables(tm, v)
    return jm, v, jb, tm, tb


@pytest.mark.parametrize("flash,fused", [(True, True), (False, True), (False, False)])
def pytest_gps_pna_matches_jax_on_bridged_weights(flash, fused):
    """The whole GPS-PNA forward, both heads, f32: the port through K4's and
    K3's plain versions (flash, fused) or the gathered attention and dense
    aggregators, the JAX package through its gathered route."""
    jm, v, jb, tm, tb = _gps_both(flash, fused)
    convs = list(tm.graph_convs)
    assert all(c.MultiheadSelfAttention_0.use_flash_attention is flash for c in convs)
    assert all(c.conv.multi_agg is fused for c in convs)
    with torch.no_grad():
        tout = tm(tb)
    _assert_close_real_rows(jm.apply(v, jb, train=False), tout, tb)


def pytest_gps_nmax_overflow_poisons_both_routes():
    """A real graph over ``max_nodes_per_graph`` turns the attention output
    NaN on the flash and the gathered route, as in the JAX package."""
    jm, v, jb, tm, tb = _gps_both(flash=True)
    for flash in (True, False):
        att = tm.graph_convs[0].MultiheadSelfAttention_0
        att.use_flash_attention = flash
        att.max_nodes_per_graph = int(tb.nodes_per_graph.max()) - 1
        with torch.no_grad():
            out = att(torch.randn(tb.num_nodes, 16), tb)
        assert torch.isnan(out).all(), flash
        att.max_nodes_per_graph = int(tb.nodes_per_graph.max())
        with torch.no_grad():
            assert torch.isfinite(att(torch.randn(tb.num_nodes, 16), tb)).all()


def _jax_dtypes(inter):
    def first(tree, name):
        return str(tree[name]["__call__"][0].dtype)

    convs = inter["intermediates"]
    return [(first(convs[f"graph_convs_{i}"]["conv"], "pre_send"),
             first(convs[f"graph_convs_{i}"], "MultiheadSelfAttention_0"))
            for i in range(len(convs))]


# bf16 against bf16, with the conv stack's weights halved: at their drawn
# scale the activations of this random model grow layer by layer and the
# attention logits reach the tens to hundreds, where a bf16 logit's rounding
# flips near-ties and the two packages' bf16 answers scatter by 2e-2 to 5e-2.
# Halved, both packages round at the same points and differ only in how
# their softmax rounds in bf16: measured 1.7e-3 to 4.0e-3 of each head's
# largest real value, while the same model in f32 lies 3.4e-2 to 1.7e-1
# away. The tolerance sits between, so a layer run in the wrong dtype fails.
BF16_RTOL = 1e-2


@pytest.mark.parametrize("flash", [True, False])
def pytest_gps_pna_mixed_precision_eval_matches_jax(flash):
    """Both packages' ``mp_cast_eval`` on the same bridged weights: K3's and
    K4's operands (the PNA sender projection and the attention output) are
    bf16 in conv layer 0 and f32 after it, because the PNA degree scalers'
    f32 counts promote the conv output; the outputs agree within
    ``BF16_RTOL``."""
    jm, v, jb, tm, tb = _gps_both(flash, conv_scale=0.5)
    jv, jbb = j_mp_cast_eval(jax.tree_util.tree_map(jnp.asarray, v), jb, False)
    jout, inter = jm.apply(
        jv, jbb, train=False, mutable=["intermediates"],
        capture_intermediates=lambda mdl, method: method == "__call__"
        and mdl.name in ("pre_send", "MultiheadSelfAttention_0"),
    )
    bf_model, bf_batch = mp_cast_eval(tm, tb)
    seen = [[None, None] for _ in bf_model.graph_convs]
    hooks = []
    for i, c in enumerate(bf_model.graph_convs):
        for j, mod in enumerate((c.conv.pre_send, c.MultiheadSelfAttention_0)):
            hooks.append(mod.register_forward_hook(
                lambda m, a, o, i=i, j=j: seen[i].__setitem__(j, str(o.dtype)[6:])))
    with torch.no_grad():
        tout = bf_model(bf_batch)
    for h in hooks:
        h.remove()
    jdt = _jax_dtypes(inter)
    assert [tuple(s) for s in seen] == jdt
    assert jdt == [("bfloat16", "bfloat16"), ("float32", "float32")]
    f32 = jm.apply(v, jb, train=False)
    for name, a in jout.items():
        a = np.asarray(a).astype(np.float32)
        t = tout[name]
        assert str(t.dtype)[6:] == str(jout[name].dtype), name
        t = t.float().numpy()
        mask = (tb.graph_mask if a.shape[0] == tb.num_graphs else tb.node_mask).numpy()
        scale = max(float(np.abs(a[mask]).max()), 1e-6)
        assert float(np.abs(a[mask] - t[mask]).max()) <= BF16_RTOL * scale, name
        # and the tolerance does tell bf16 from f32
        assert float(np.abs(a[mask] - np.asarray(f32[name])[mask]).max()) > BF16_RTOL * scale, name


def pytest_run_server_serves_gps_pna_on_cpu(tmp_path, monkeypatch):
    """The slice as a whole at a tiny width: ``api.run_server`` on the
    chip smoke's GPS-PNA configuration (flash and multi-moment routes on,
    mixed precision) answers every request, each equal to a direct
    forward of the server's own bf16 model on the same graphs. The run has
    no checkpoint under ``./logs``, so the server warns and serves the
    seeded initialization."""
    monkeypatch.chdir(tmp_path)
    import chip_smoke
    from hydragnn_tpu_torch.api import run_server
    from hydragnn_tpu_torch.data import add_dataset_pe, split_dataset
    from hydragnn_tpu_torch.train.loop import cast_batch_bf16
    from test_torch_serve import _direct

    graphs = add_dataset_pe(oc20_shaped_dataset(20, mean_atoms=20, min_atoms=10, max_atoms=40,
                                                max_neighbours=10), 4)
    config = chip_smoke.gps_pna_config(batch_size=4, hidden=16, head=8, heads=2, layers=2)
    arch = config["NeuralNetwork"]["Architecture"]
    arch.update(use_flash_attention=True)
    with pytest.warns(UserWarning, match="no checkpoint on disk"):
        server = run_server(config, datasets=split_dataset(graphs, 0.5), device="cpu", seed=3)
    try:
        assert server.wait_ready(timeout=120)
        convs = server.model.graph_convs
        assert all(c.MultiheadSelfAttention_0.use_flash_attention and c.conv.multi_agg
                   for c in convs)
        results = server.predict(graphs[:6], timeout=120)
    finally:
        server.close()

    class _Bf16Inputs(torch.nn.Module):  # the server's cast of the inputs
        def __init__(self, model):
            super().__init__()
            self.model = model

        def forward(self, batch):
            return {k: v.float() for k, v in self.model(cast_batch_bf16(batch)).items()}

    for g, got, want in zip(graphs[:6], results, _direct(_Bf16Inputs(server._serve_model),
                                                          graphs[:6])):
        assert got["energy"].shape == (1,) and got["forces"].shape == (g.num_nodes, 3)
        assert all(np.isfinite(v).all() for v in got.values())
        for k in ("energy", "forces"):
            scale = max(float(np.abs(want[k]).max()), 1.0)
            # the same function; the batches differ, so a matmul may block
            # its sums differently (measured under 1e-7)
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# GPS performer attention (linear attention, the relu feature map)


def _performer_config():
    cfg = _pna_config(gps=True)
    cfg["NeuralNetwork"]["Architecture"].update(mpnn_type="GIN", global_attn_type="performer")
    return cfg


def _performer_both():
    """GIN under GPS performer attention (hidden 16, 2 heads, PE 4, 2
    layers) built in JAX and bridged into the port, on one batch."""
    tr, va, te = _splits(pe=True)
    cfg = _performer_config()
    jc = j_update(copy.deepcopy(cfg), tr, va, te)
    tc = t_update(copy.deepcopy(cfg), tr, va, te)
    jb = next(iter(JLoader(tr, 4, sort_edges=True)))
    tb = next(iter(TLoader(tr, 4, sort_edges=True)))
    jm = j_create(jc)
    v = _jax_variables(jm, jb)
    tm = t_create(tc, device="cpu")
    load_jax_variables(tm, v)
    return jm, v, jb, tm, tb, (tr, va, te)


def pytest_performer_served_answers_match_jax(tmp_path, monkeypatch):
    """``api.run_server`` on the bridged JAX weights (f32) answers each
    request as the JAX model does on the same graphs, real rows to 1e-4 of
    each head's largest value; the JAX side takes K1 in interpret mode."""
    monkeypatch.setenv("HYDRAGNN_PALLAS_SEGMENT", "1")
    monkeypatch.chdir(tmp_path)
    from hydragnn_tpu.data.graph import PadSpec as JPadSpec
    from hydragnn_tpu.data.graph import _round_up
    from hydragnn_tpu.data.graph import batch_graphs as j_batch_graphs
    from hydragnn_tpu_torch.api import run_server

    jm, v, _, tm, _, splits = _performer_both()
    assert type(tm.graph_convs[0].PerformerSelfAttention_0).__name__ == "PerformerSelfAttention"
    requests = splits[0][:6]
    server = run_server(_performer_config(), datasets=splits, variables=v, device="cpu")
    try:
        assert server.wait_ready(timeout=120)
        results = server.predict(requests, timeout=120)
    finally:
        server.close()
    n = sum(g.num_nodes for g in requests)
    spec = JPadSpec(n_nodes=_round_up(n + 1, 8),
                    n_edges=_round_up(sum(g.num_edges for g in requests), 128),
                    n_graphs=len(requests) + 1)
    jout = jm.apply(v, j_batch_graphs(requests, spec, sort_edges=True), train=False)
    want = {"energy": np.asarray(jout["energy"])[:len(requests)],
            "forces": np.asarray(jout["forces"])[:n]}
    got = {"energy": np.stack([r["energy"] for r in results]),
           "forces": np.concatenate([r["forces"] for r in results])}
    for k in ("energy", "forces"):
        assert np.isfinite(got[k]).all()
        scale = float(np.abs(want[k]).max())
        assert float(np.abs(got[k] - want[k]).max()) <= 1e-4 * scale, k


def pytest_performer_step0_gradients_match_jax(monkeypatch):
    """One training step (MAE over both heads, batch statistics, f32): the
    loss and each task's to 1e-5, every gradient to 1e-4 of its largest
    (floored at 1e-3 of the largest anywhere: tests/test_torch_train.py)."""
    monkeypatch.setenv("HYDRAGNN_PALLAS_SEGMENT", "1")
    from hydragnn_tpu.train.loss import compute_loss as j_compute_loss
    from hydragnn_tpu_torch.train import compute_loss
    from test_torch_train import _assert_close, _flat
    from test_torch_zoo_grads import grads_of

    jm, v, jb, tm, tb, _ = _performer_both()
    jv = jax.tree_util.tree_map(jnp.asarray, v)

    def loss_fn(params):
        tot, tasks, _, _ = j_compute_loss(jm, {"params": params,
                                               "batch_stats": jv["batch_stats"]},
                                          jb, jm.cfg, True, jax.random.PRNGKey(0), False)
        return tot, tasks

    (jtot, jtasks), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jv["params"])
    tm.train()
    tot, tasks, _ = compute_loss(tm, tb, tm.cfg, False)
    tot.backward()
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=1e-5)
    for k in jtasks:
        np.testing.assert_allclose(float(tasks[k].detach()), float(jtasks[k]), rtol=1e-5)
    _assert_close(_flat(jgrads), grads_of(tm), 1e-4, "performer grad", floor=1e-3)
