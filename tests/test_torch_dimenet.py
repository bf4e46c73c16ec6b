"""DimeNet's port against the JAX package, on the CPU: the spherical basis,
the triplet channel of the data plane, and ``DimeNetConv`` in a 2-layer
``HydraModel`` (hidden 16, small blocks, graph and node heads) on bridged
weights, the JAX side with its Pallas route in interpret mode
(``HYDRAGNN_PALLAS_SEGMENT=1``: the output block's receiver sum is K1).

Tolerances:

- ``spherical_basis``: 1e-5 of the largest value in f32; from bf16
  distances and angles (the radial part is f32 in both packages, the
  Legendre part bf16, where XLA may keep f32 across the recurrence's steps,
  its excess-precision default, and the port rounds each) 1e-4 of the
  largest (``SBF_BF16_RTOL``: a few bf16 ulps of one angular factor);
  padding rows exactly 0,
  and the first and second derivatives by the distances finite everywhere
  (0 on the padding rows);
- the triplet arrays, ``n_triplets`` and the pad specs: bit for bit, host
  numpy in both packages, packed and unpacked;
- forwards: real rows to 1e-4 of each head's largest value
  (tests/test_torch_egnn.py); bf16 ``mixed_precision``: every conv
  layer's and head's dtype as the JAX package's, and the first conv
  layer's outputs within ``BF16_SHARE`` of the distance bf16 itself puts
  between the JAX package's bf16 and f32 outputs (tests/test_torch_zoo.py);
- one training step, and one energy-force step (forces by a double
  backward through K1's Function): the loss and each task's to 1e-5, the
  forces to 1e-4 of the largest, every gradient to 1e-4 of its largest
  (floored at 1e-3 of the largest anywhere: tests/test_torch_train.py);
- the port of tests/test_mixed_precision.py's DimeNet regression: a bf16
  train step on a batch with padding triplets has finite gradients
  everywhere.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydragnn_tpu.config import update_config as j_update
from hydragnn_tpu.data import GraphLoader as JLoader
from hydragnn_tpu.data import graph as j_graph
from hydragnn_tpu.data import pipeline as j_pipeline
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.ops import sbf as j_sbf
from hydragnn_tpu.train.loss import compute_loss as j_compute_loss
from hydragnn_tpu.train.loop import mp_cast_eval as j_mp_cast_eval
from hydragnn_tpu_torch.config import update_config as t_update
from hydragnn_tpu_torch.data import GraphLoader as TLoader
from hydragnn_tpu_torch.data import graph as t_graph
from hydragnn_tpu_torch.data import pipeline as t_pipeline
from hydragnn_tpu_torch.data import (
    MinMax,
    VariablesOfInterest,
    deterministic_graph_dataset,
    extract_variables,
    split_dataset,
)
from hydragnn_tpu_torch.ops import sbf as t_sbf
from hydragnn_tpu_torch.train import TrainState, compute_loss, make_optimizer, make_train_step
from hydragnn_tpu_torch.train import mp_cast_eval
from hydragnn_tpu_torch.models import create_model as t_create
from test_torch_egnn import _assert_close_real_rows
from test_torch_train import _assert_close, _flat
from test_torch_zoo import (
    BF16_SHARE,
    _capture,
    _config,
    _conv_outputs,
    _jax_init,
    _relative_l2,
    _splits,
    torch_model,
)
from test_torch_zoo_forces import _ef_config, _ef_splits
from test_torch_zoo_grads import grads_of

torch.set_num_threads(2)

SBF_RTOL = 1e-5
SBF_BF16_RTOL = 1e-4
LOSS_RTOL = 1e-5
FORCE_RTOL = 1e-4
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-3

BLOCKS = dict(num_radial=4, num_spherical=3, basis_emb_size=4, int_emb_size=8,
              out_emb_size=12, envelope_exponent=5)


@pytest.fixture
def pallas_route(monkeypatch):
    monkeypatch.setenv("HYDRAGNN_PALLAS_SEGMENT", "1")


# ---------------------------------------------------------------------------
# the spherical basis


def _sbf_inputs():
    """Edge lengths over [0.8, 5.5] (atoms lie no closer; far below, the
    upward recurrence of the high orders keeps no accuracy in either
    package: an ulp of sin or cos grows by (2l+1)/x a level) with three
    padding edges (eps-clamped 1e-6), angles over [0, pi], and triplets
    gathering every edge, the padding ones too."""
    rng = np.random.default_rng(0)
    dist = rng.uniform(0.8, 5.5, 40).astype(np.float32)
    dist[-3:] = 1e-6
    mask = np.ones(40, bool)
    mask[-3:] = False
    angle = rng.uniform(0.0, np.pi, 90).astype(np.float32)
    angle[:2] = [0.0, np.pi]
    idx = np.concatenate([np.arange(40), rng.integers(0, 40, 50)])
    return dist, angle, idx, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def pytest_spherical_basis_matches_jax(dtype):
    dist, angle, idx, mask = _sbf_inputs()
    args = (5.0, 7, 6, 5)
    jd = getattr(jnp, dtype)
    want = j_sbf.spherical_basis(jnp.asarray(dist).astype(jd), jnp.asarray(angle).astype(jd),
                                 jnp.asarray(idx), *args, edge_mask=jnp.asarray(mask))
    td = getattr(torch, dtype)
    got = t_sbf.spherical_basis(torch.from_numpy(dist).to(td), torch.from_numpy(angle).to(td),
                                torch.from_numpy(idx), *args, edge_mask=torch.from_numpy(mask))
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    want, got = np.asarray(want), got.numpy()
    assert got.shape == (90, 42)
    rtol = SBF_RTOL if dtype == "float32" else SBF_BF16_RTOL
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()))
    assert float(np.abs(got[~mask[idx]]).max()) == 0.0


def pytest_spherical_basis_padding_rows_have_finite_derivatives():
    """First and second derivatives by the distances are finite, and 0 on
    the padding edges. Without ``edge_mask`` the padding rows' recurrence
    runs at 1e-6, and the same derivatives are not finite: the mask is what
    keeps them so."""
    dist, angle, idx, mask = _sbf_inputs()
    w = torch.from_numpy(np.random.default_rng(1).normal(size=(90, 42)).astype(np.float32))

    def derivatives(edge_mask):
        d = torch.from_numpy(dist).requires_grad_(True)
        out = t_sbf.spherical_basis(d, torch.from_numpy(angle), torch.from_numpy(idx),
                                    5.0, 7, 6, 5, edge_mask=edge_mask)
        out = torch.where(torch.from_numpy(mask[idx])[:, None], out, torch.zeros(()))
        (g,) = torch.autograd.grad((out * w).sum(), d, create_graph=True)
        (g2,) = torch.autograd.grad(g.sum(), d)
        return g.detach().numpy(), g2.numpy()

    g, g2 = derivatives(torch.from_numpy(mask))
    assert np.isfinite(g).all() and np.isfinite(g2).all()
    assert float(np.abs(g[~mask]).max()) == 0.0 and float(np.abs(g2[~mask]).max()) == 0.0
    assert float(np.abs(g[mask]).max()) > 0.0
    g, g2 = derivatives(None)
    assert not (np.isfinite(g).all() and np.isfinite(g2).all())


# ---------------------------------------------------------------------------
# the triplet channel of the data plane


def _graphs():
    tr, va, te = _splits()
    return tr + va + te


def pytest_triplet_counts_and_pad_specs_match_jax():
    graphs = _graphs()
    assert [t_graph._triplet_count(g) for g in graphs] == \
        [j_graph._triplet_count(g) for g in graphs]
    want = j_graph.PadSpec.for_dataset(graphs, 4, with_triplets=True)
    assert dataclasses.asdict(t_graph.PadSpec.for_dataset(graphs, 4, with_triplets=True)) == \
        dataclasses.asdict(want)
    assert want.n_triplets > 0
    jl = j_graph.SpecLadder.for_dataset(graphs, 4, num_buckets=4, with_triplets=True)
    tl = t_graph.SpecLadder.for_dataset(graphs, 4, num_buckets=4, with_triplets=True)
    assert [dataclasses.asdict(s) for s in tl.specs] == [dataclasses.asdict(s) for s in jl.specs]
    assert dataclasses.asdict(t_pipeline._pack_spec(graphs, 4, with_triplets=True)) == \
        dataclasses.asdict(j_pipeline._pack_spec(graphs, 4, with_triplets=True))


@pytest.mark.parametrize("pack", [False, True])
def pytest_triplet_arrays_are_byte_identical(pack):
    """Every batch of an epoch, packed and unpacked, receiver-sorted: the
    host arrays of the two packages are the same bytes, and the port's
    batch carries them."""
    graphs = _graphs()
    kw = dict(shuffle=True, seed=3, sort_edges=True, with_triplets=True, pack=pack)
    jbatches = list(JLoader(graphs, 4, num_buckets=3, **kw))
    tloader = TLoader(graphs, 4, num_buckets=3, **kw)
    tbatches = list(tloader)
    assert len(tbatches) == len(jbatches) > 1
    for jb, tb in zip(jbatches, tbatches):
        for f in ("trip_kj", "trip_ji", "trip_mask", "senders", "receivers", "edge_mask"):
            assert np.array_equal(np.asarray(getattr(jb, f)), getattr(tb, f).numpy()), f
        assert tb.trip_kj.dtype == torch.int64 and not bool(tb.trip_mask.all())
    spec = tloader.spec if pack else tloader.ladder.specs[-1]
    group = [graphs[i] for i in tloader._groups()[0]]
    got = t_graph.batch_graphs_np(group, spec, sort_edges=True)
    want = j_graph.batch_graphs_np(group, j_graph.PadSpec(**dataclasses.asdict(spec)),
                                   sort_edges=True)
    assert sorted(got) == sorted(want)
    for k in ("trip_kj", "trip_ji", "trip_mask"):
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


def pytest_prepare_data_budgets_triplets_for_dimenet_only():
    """``api.prepare_data`` builds the ladder the JAX package's builds, with
    the triplet channel for DimeNet and without it for another conv."""
    from hydragnn_tpu_torch.api import prepare_data

    splits = _splits()
    for model, with_t in (("DimeNet", True), ("SAGE", False)):
        cfg = _dimenet_config() if model == "DimeNet" else _config(model)
        done, loaders, _ = prepare_data(cfg, splits)
        want = j_graph.SpecLadder.for_dataset(
            splits[0] + splits[1] + splits[2], 4,
            num_buckets=done["NeuralNetwork"]["Training"]["num_pad_buckets"],
            with_triplets=with_t)
        assert [dataclasses.asdict(s) for s in loaders[0].ladder.specs] == \
            [dataclasses.asdict(s) for s in want.specs]
        assert bool(loaders[0].spec.n_triplets) == with_t


# ---------------------------------------------------------------------------
# DimeNetConv on bridged weights


def _dimenet_config(layers=2):
    cfg = _config("DimeNet", layers=layers)
    cfg["NeuralNetwork"]["Architecture"].update(BLOCKS)
    return cfg


_PAIR = {}


def dimenet_pair():
    """(JAX model, its variables, JAX batch, completed torch config, torch
    batch) with the triplet channel, built once."""
    if not _PAIR:
        tr, va, te = _splits()
        cfg = _dimenet_config()
        jc = j_update(copy.deepcopy(cfg), tr, va, te)
        tc = t_update(copy.deepcopy(cfg), tr, va, te)
        jb = next(iter(JLoader(tr, 4, sort_edges=True, with_triplets=True)))
        tb = next(iter(TLoader(tr, 4, sort_edges=True, with_triplets=True)))
        jm = j_create(jc)
        _PAIR["pair"] = (jm, _jax_init(jm, jb), jb, tc, tb)
    return _PAIR["pair"]


def pytest_dimenet_config_completion_matches_jax():
    tr, va, te = _splits()
    keys = ("num_radial", "num_spherical", "basis_emb_size", "int_emb_size", "out_emb_size",
            "num_before_skip", "num_after_skip", "envelope_exponent", "radial_type",
            "distance_transform", "correlation", "max_ell", "node_max_ell",
            "avg_num_neighbors", "max_in_degree")
    jc = j_update(_dimenet_config(), tr, va, te)["NeuralNetwork"]["Architecture"]
    tc = t_update(_dimenet_config(), tr, va, te)["NeuralNetwork"]["Architecture"]
    assert {k: tc[k] for k in keys} == {k: jc[k] for k in keys}


def pytest_dimenet_matches_jax_on_bridged_weights(pallas_route):
    jm, v, jb, tc, tb = dimenet_pair()
    tm = torch_model(v, tc)
    assert [type(c).__name__ for c in tm.graph_convs] == ["DimeNetConv"] * 2
    with torch.no_grad():
        tout = tm(tb)
    _assert_close_real_rows(jm.apply(v, jb, train=False), tout, tb)


def pytest_dimenet_mixed_precision_matches_jax(pallas_route):
    """Both packages' ``mp_cast_eval``: the dtypes out of every conv layer
    (f32: the spherical basis promotes the interaction) and every head; the
    first layer's outputs within ``BF16_SHARE`` of bf16's own distance."""
    jm, v, jb, tc, tb = dimenet_pair()
    jv, jbb = j_mp_cast_eval(jax.tree_util.tree_map(jnp.asarray, v), jb, False)
    jout, inter = jm.apply(jv, jbb, train=False, mutable=["intermediates"],
                           capture_intermediates=_capture)
    _, inter32 = jm.apply(v, jb, train=False, mutable=["intermediates"],
                          capture_intermediates=_capture)
    jconv, jconv32 = _conv_outputs(inter, 2), _conv_outputs(inter32, 2)
    bf_model, bf_batch = mp_cast_eval(torch_model(v, tc), tb)
    seen = []
    hooks = [c.register_forward_hook(lambda m, i, o: seen.append(o))
             for c in bf_model.graph_convs]
    with torch.no_grad():
        tout = bf_model(bf_batch)
    for h in hooks:
        h.remove()
    assert ([tuple(str(t.dtype)[6:] for t in o) for o in seen]
            == [tuple(str(t.dtype) for t in o) for o in jconv])
    assert str(seen[0][0].dtype) == "torch.float32"
    for name, a in jout.items():
        assert str(tout[name].dtype)[6:] == str(a.dtype), name
    rows = tb.node_mask.numpy()
    got = seen[0][0].float().numpy()[rows]
    want = np.asarray(jconv[0][0].astype(jnp.float32))[rows]
    budget = _relative_l2(want, np.asarray(jconv32[0][0])[rows])
    assert _relative_l2(got, want) <= BF16_SHARE * budget


def pytest_dimenet_step0_gradients_match_jax(pallas_route):
    jm, v, jb, tc, tb = dimenet_pair()
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
    _assert_close(_flat(jgrads), grads_of(tm), GRAD_RTOL, "DimeNet grad", floor=GRAD_FLOOR)


def pytest_dimenet_energy_force_step_matches_jax(pallas_route):
    """``compute_grad_energy``: the loss and its parts, the forces and every
    gradient, through the angles of the triplets."""
    cfg = _ef_config("DimeNet")
    cfg["NeuralNetwork"]["Architecture"].update(BLOCKS)
    tr, va, te = _ef_splits()
    jc = j_update(copy.deepcopy(cfg), tr, va, te)
    tc = t_update(copy.deepcopy(cfg), tr, va, te)
    jb = next(iter(JLoader(tr, 4, sort_edges=True, with_triplets=True)))
    tb = next(iter(TLoader(tr, 4, sort_edges=True, with_triplets=True)))
    jm = j_create(jc)
    v = _jax_init(jm, jb)
    jv = jax.tree_util.tree_map(jnp.asarray, v)

    def loss_fn(params):
        tot, tasks, _, preds = j_compute_loss(jm, {"params": params,
                                                   "batch_stats": jv["batch_stats"]},
                                              jb, jm.cfg, True, jax.random.PRNGKey(0), True)
        return tot, (tasks, preds)

    (jtot, (jtasks, jpreds)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jv["params"])
    tm = torch_model(v, tc)
    tm.train()
    tot, tasks, preds = compute_loss(tm, tb, tm.cfg, True)
    tot.backward()
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=LOSS_RTOL)
    for k in ("graph_energy", "forces"):
        np.testing.assert_allclose(float(tasks[k].detach()), float(jtasks[k]), rtol=LOSS_RTOL)
    jf, tf = np.asarray(jpreds["forces"]), preds["forces"].detach().numpy()
    assert np.isfinite(tf).all() and float(np.abs(jf).max()) > 0
    assert float(np.abs(tf - jf).max()) <= FORCE_RTOL * float(np.abs(jf).max())
    _assert_close(_flat(jgrads), grads_of(tm), GRAD_RTOL, "DimeNet ef grad", floor=GRAD_FLOOR)


def pytest_dimenet_bf16_grads_finite_with_padding_triplets():
    """tests/test_mixed_precision.py's DimeNet regression in the port: one
    conv layer (hidden 16, 6 radial and 7 spherical functions), a bf16
    mixed-precision train step on a batch whose padding edges (eps-clamped
    lengths) are gathered by padding triplets: every gradient finite, the
    step taken."""
    raw = deterministic_graph_dataset(32, seed=97)
    raw = MinMax.fit(raw).apply(raw)
    voi = VariablesOfInterest([0], ["t"], ["graph"], [0], [1, 1, 1], [1])
    tr, va, te = split_dataset([extract_variables(g, voi) for g in raw], 0.8, seed=0)
    cfg = {
        "Dataset": {"node_features": {"dim": [1, 1, 1]}, "graph_features": {"dim": [1]}},
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "DimeNet", "hidden_dim": 16, "num_conv_layers": 1,
                "num_radial": 6, "num_spherical": 7, "task_weights": [1.0],
                "output_heads": {"graph": {"num_sharedlayers": 1, "dim_sharedlayers": 16,
                                           "num_headlayers": 2, "dim_headlayers": [16, 16]}},
            },
            "Variables_of_interest": {"input_node_features": [0], "output_names": ["t"],
                                      "output_index": [0], "type": ["graph"]},
            "Training": {"batch_size": 16, "mixed_precision": True},
        },
    }
    tc = t_update(cfg, tr, va, te)
    batch = next(iter(TLoader(tr, 16, with_triplets=True)))
    assert not bool(batch.trip_mask.all()) and not bool(batch.edge_mask.all())
    model = t_create(tc, device="cpu")
    state = TrainState.create(model, make_optimizer(model, {"type": "AdamW",
                                                            "learning_rate": 1e-3}))
    _, loss, _ = make_train_step(model, mixed_precision=True)(state, batch)
    assert np.isfinite(float(loss))
    for n, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), n
    assert int(state.skipped_steps) == 0 and int(state.step) == 1


def pytest_dimenet_served_answers_match_jax(tmp_path, monkeypatch):
    """The slice as a whole at a tiny width: ``api.run_server`` on the
    bridged JAX weights (f32) builds each batch with its triplets and
    answers every request as the JAX model does on the same graphs (real
    rows to 1e-4 of each head's largest value); a graph with more triplets
    than the ladder's top level holds is refused at admission."""
    monkeypatch.chdir(tmp_path)
    from hydragnn_tpu_torch.api import run_server
    from hydragnn_tpu_torch.serve import InvalidRequestError

    jm, v, _, _, _ = dimenet_pair()
    splits = _splits()
    requests = splits[0][:6]
    server = run_server(_dimenet_config(), datasets=splits, variables=v, device="cpu")
    try:
        assert server.wait_ready(timeout=120)
        results = server.predict(requests, timeout=120)
        # a complete graph within the top level's nodes and edges, over its
        # triplets: k (k - 1) edges, k (k - 1) (k - 2) triplets
        worst = server.ladder.specs[-1]
        k = next(k for k in range(3, 100) if k * (k - 1) * (k - 2) > worst.n_triplets)
        assert k < worst.n_nodes and k * (k - 1) <= worst.n_edges
        s, r = (a.ravel().astype(np.int32) for a in np.meshgrid(np.arange(k), np.arange(k)))
        keep = s != r
        pos = np.random.default_rng(0).normal(size=(k, 3)).astype(np.float32)
        clique = t_graph.Graph(x=np.ones((k, 4), np.float32), pos=pos, senders=s[keep],
                               receivers=r[keep], z=np.full(k, 6, np.int32))
        with pytest.raises(InvalidRequestError) as err:
            server.submit(clique)
        assert err.value.reason == "budget_overflow"
    finally:
        server.close()
    n = sum(g.num_nodes for g in requests)
    spec = j_graph.PadSpec(n_nodes=j_graph._round_up(n + 1, 8),
                           n_edges=j_graph._round_up(sum(g.num_edges for g in requests), 128),
                           n_graphs=len(requests) + 1,
                           n_triplets=j_graph._round_up(
                               sum(j_graph._triplet_count(g) for g in requests), 128))
    jout = jm.apply(v, j_graph.batch_graphs(requests, spec, sort_edges=True), train=False)
    want = {"energy": np.asarray(jout["energy"])[:len(requests)],
            "forces": np.asarray(jout["forces"])[:n]}
    got = {"energy": np.stack([r["energy"] for r in results]),
           "forces": np.concatenate([r["forces"] for r in results])}
    for k in ("energy", "forces"):
        assert np.isfinite(got[k]).all()
        assert float(np.abs(got[k] - want[k]).max()) <= 1e-4 * float(np.abs(want[k]).max()), k
