"""The multibranch GFM surface of the port against the JAX package's, on
the CPU: per-node MLP heads, variance heads (``GaussianNLLLoss``), the
branch selection and the per-branch loss weights and scalars, and the
``HYDRAGNN_STEP_GUARD`` / ``HYDRAGNN_DUMP_TESTDATA`` knobs.

Each model is a 2-layer ``HydraModel`` at hidden 16 (tests/test_torch_zoo.py's
configuration), built in JAX with its variables (non-trivial batch-norm
statistics) bridged into the port, on the same receiver-sorted batch whose
graphs belong to 2 or 3 branches. The JAX side runs its Pallas routes in
interpret mode (``HYDRAGNN_PALLAS_SEGMENT=1``).

Tolerances (f32, the same algorithm in another summation order): forwards
on real rows to 1e-4 of each head's largest value; losses (each task's and
each ``branch<i>`` scalar) to 1e-5; gradients to 1e-4 of each parameter's
largest, floored at 1e-3 of the largest anywhere; the dumped test
predictions to 1e-5 of the largest.
"""

import copy
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydragnn_tpu.config import update_config as j_update
from hydragnn_tpu.data import GraphLoader as JLoader
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.train import TrainState as JState
from hydragnn_tpu.train import make_optimizer as j_make_optimizer
from hydragnn_tpu.train import make_train_step as j_make_train_step
from hydragnn_tpu.train.loop import test_model as j_test_model
from hydragnn_tpu.train.loss import compute_loss as j_compute_loss
from hydragnn_tpu.train.loss import gaussian_nll as j_gaussian_nll
from hydragnn_tpu.train.loss import multitask_loss as j_multitask_loss
from hydragnn_tpu_torch.config import update_config as t_update
from hydragnn_tpu_torch.data import GraphLoader as TLoader
from hydragnn_tpu_torch.models.base import node_position_in_graph
from hydragnn_tpu_torch.train import TrainState, compute_loss, make_optimizer, make_train_step
from hydragnn_tpu_torch.train.loop import test_model
from hydragnn_tpu_torch.train.loss import gaussian_nll, multitask_loss
from test_torch_convhead import flat, jax_eval, torch_model
from test_torch_egnn import _assert_close_real_rows
from test_torch_mace import MACE_ARCH
from test_torch_mace import _init as mace_init
from test_torch_train import _assert_close
from test_torch_zoo import _config, _jax_init, _splits
from test_torch_zoo_grads import grads_of

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-3
DUMP_RTOL = 1e-5


@pytest.fixture
def pallas_route(monkeypatch):
    monkeypatch.setenv("HYDRAGNN_PALLAS_SEGMENT", "1")


def multibranch(cfg, branches, node_type="mlp"):
    """``cfg``'s heads as ``branches`` branch entries, the node head of
    ``node_type``."""
    arch = cfg["NeuralNetwork"]["Architecture"]
    heads = arch["output_heads"]
    node = dict(heads["node"], type=node_type)
    arch["output_heads"] = {
        "graph": [{"type": f"branch-{b}", "architecture": heads["graph"]}
                  for b in range(branches)],
        "node": [{"type": f"branch-{b}", "architecture": node} for b in range(branches)]}
    return cfg


def in_branches(splits, branches):
    return tuple([dataclasses.replace(g, dataset_id=i % branches) for i, g in enumerate(s)]
                 for s in splits)


_PAIRS = {}


def gfm_pair(key, cfg, splits, pack=False, init=_jax_init):
    """(JAX model, variables, JAX batch, completed torch config, torch
    batch) of ``cfg`` on the first train batch of ``splits``, once per
    ``key``."""
    if key not in _PAIRS:
        tr, va, te = splits
        jc = j_update(copy.deepcopy(cfg), tr, va, te)
        tc = t_update(copy.deepcopy(cfg), tr, va, te)
        jb = next(iter(JLoader(tr, 4, sort_edges=True, pack=pack)))
        tb = next(iter(TLoader(tr, 4, sort_edges=True, pack=pack)))
        jm = j_create(jc)
        _PAIRS[key] = (jm, init(jm, jb), jb, tc, tb)
    return _PAIRS[key]


def _jax_value_and_grad(jm, v, jb):
    jv = jax.tree_util.tree_map(jnp.asarray, v)

    def loss_fn(params):
        tot, tasks, _, out = j_compute_loss(jm, {"params": params,
                                                 "batch_stats": jv.get("batch_stats", {})},
                                            jb, jm.cfg, True, jax.random.PRNGKey(0), False)
        return tot, (tasks, out)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jv["params"])


def _step_matches(jm, v, jb, tc, tb, what):
    """One training step's loss, task losses and gradients against JAX;
    returns the port's task losses."""
    (jtot, (jtasks, _)), jgrads = _jax_value_and_grad(jm, v, jb)
    tm = torch_model(v, tc)
    tm.train()
    tot, tasks, _ = compute_loss(tm, tb, tm.cfg, False)
    tot.backward()
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=LOSS_RTOL)
    assert sorted(tasks) == sorted(jtasks)
    for k in jtasks:
        np.testing.assert_allclose(float(tasks[k].detach()), float(jtasks[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    _assert_close(flat(tm, jgrads), grads_of(tm), GRAD_RTOL, what, floor=GRAD_FLOOR)
    return tasks


# ---------------------------------------------------------------------------
# mlp_per_node


def _per_node_pair():
    """GIN with 2 branches and an ``mlp_per_node`` node head over the
    OC20-shaped graphs (sizes vary, so the head's width is the output's and
    a node at position p takes MLP p % num_nodes, as the JAX package's
    mlp_per_node training test runs it)."""
    cfg = multibranch(_config("GIN"), 2, node_type="mlp_per_node")
    return gfm_pair("per_node", cfg, in_branches(_splits(), 2), pack=True)


def pytest_mlp_per_node_matches_jax(pallas_route):
    """The forward (one MLP per node position, each branch its own bank)
    and one step's gradients."""
    jm, v, jb, tc, tb = _per_node_pair()
    tm = torch_model(v, tc)
    layer = tm.heads_NN[1].VmapMLP_0.Dense_0
    assert tuple(layer.weight.shape[:2]) == (2, tc["NeuralNetwork"]["Architecture"]["num_nodes"])
    with torch.no_grad():
        tout = tm(tb)
    _assert_close_real_rows(jax_eval(jm, v, jb), tout, tb)
    _step_matches(jm, v, jb, tc, tb, "mlp_per_node grad")


def pytest_node_position_in_graph_on_ragged_packed_batches():
    """Each real node's position in its own graph, on packed batches of
    graphs of different sizes: against the JAX package's
    ``_node_position_in_graph``."""
    from hydragnn_tpu.models.base import _node_position_in_graph

    tr = _splits()[0]
    for jb, tb in zip(JLoader(tr, 4, pack=True), TLoader(tr, 4, pack=True)):
        sizes = [g for g in np.bincount(tb.node_graph.numpy()[tb.node_mask.numpy()])]
        assert len(set(sizes)) > 1
        want = np.asarray(_node_position_in_graph(jb))
        got = node_position_in_graph(tb).numpy()
        m = tb.node_mask.numpy()
        np.testing.assert_array_equal(got[m], want[m])
        np.testing.assert_array_equal(got[m], np.concatenate([np.arange(s) for s in sizes]))


def pytest_fixed_size_mlp_per_node_fails_in_the_loss_as_in_jax():
    """On fixed-size graphs config completion widens an ``mlp_per_node``
    node head to ``dim * num_nodes`` (the reference's flattened per-node
    output), and the loss cannot shape the ``[N, dim]`` targets to it: the
    JAX package raises there, and the port does too."""
    g0 = _splits()[0][0]
    splits = ([g0] * 6, [g0] * 2, [g0] * 2)
    cfg = multibranch(_config("GIN"), 1, node_type="mlp_per_node")
    jc = j_update(copy.deepcopy(cfg), *splits)
    tc = t_update(copy.deepcopy(cfg), *splits)
    assert jc["NeuralNetwork"]["Architecture"]["output_dim"] == \
        tc["NeuralNetwork"]["Architecture"]["output_dim"] == [1, 3 * g0.num_nodes]
    jm = j_create(jc)
    jb = next(iter(JLoader(splits[0], 4)))
    v = _jax_init(jm, jb)
    with pytest.raises(TypeError, match="reshape"):
        j_compute_loss(jm, v, jb, jm.cfg, False, None, False)
    tm = torch_model(v, tc)
    with pytest.raises(RuntimeError, match="shape"):
        compute_loss(tm, next(iter(TLoader(splits[0], 4))), tm.cfg, False)


# ---------------------------------------------------------------------------
# variance heads


def _nll_config(model="EGNN", branches=2):
    cfg = multibranch(_config(model), branches)
    cfg["NeuralNetwork"]["Architecture"]["equivariance"] = model == "EGNN"
    cfg["NeuralNetwork"]["Training"]["loss_function_type"] = "GaussianNLLLoss"
    return cfg


def _unit_variance(v, path, d):
    """The last layer's variance half given a bias of 2 and a tenth of its
    weights: the variances start near 4, away from the 1e-6 clamp of the
    NLL, where a random init leaves some of them and any rounding of the
    prediction is amplified a millionfold."""
    leaf = v["params"]
    for k in path:
        leaf = leaf[k]
    leaf["bias"] = np.array(leaf["bias"])
    leaf["bias"][..., d:] = 2.0
    leaf["kernel"] = np.array(leaf["kernel"])
    leaf["kernel"][..., d:] *= 0.1


def pytest_variance_heads_match_jax(pallas_route):
    """``GaussianNLLLoss``: every head twice as wide, its ``__var`` output
    the second half squared; the Gaussian NLL loss and one step's
    gradients."""
    jm, v, jb, tc, tb = gfm_pair("nll", _nll_config(), in_branches(_splits(), 2))
    _unit_variance(v, ("heads_NN_0", "Dense_2"), 1)
    _unit_variance(v, ("heads_NN_1", "MLP_0", "Dense_2"), 3)
    tm = torch_model(v, tc)
    assert tm.cfg.var_output
    with torch.no_grad():
        tout = tm(tb)
    jout = jax_eval(jm, v, jb)
    assert sorted(tout) == sorted(jout) == ["energy", "energy__var", "forces", "forces__var"]
    _assert_close_real_rows(jout, tout, tb)
    _step_matches(jm, v, jb, tc, tb, "nll grad")


def pytest_mace_variance_heads_match_jax(pallas_route):
    """MACE under ``GaussianNLLLoss``: each layer's readout twice as wide,
    the layers' variances summed; the forward and the loss."""
    cfg = _config("MACE", hidden=8)
    cfg["NeuralNetwork"]["Architecture"].update(MACE_ARCH, correlation=2)
    cfg["NeuralNetwork"]["Training"]["loss_function_type"] = "GaussianNLLLoss"
    jm, v, jb, tc, tb = gfm_pair("mace_nll", cfg, _splits(), init=mace_init)
    for head, d in (("head0", 1), ("head1", 3)):
        _unit_variance(v, (f"readout0_{head}",), d)
    tm = torch_model(v, tc)
    with torch.no_grad():
        tout = tm(tb)
    jout = jax_eval(jm, v, jb)
    assert sorted(tout) == sorted(jout)
    _assert_close_real_rows(jout, tout, tb)
    _step_matches(jm, v, jb, tc, tb, "mace nll grad")


def pytest_gaussian_nll_matches_jax():
    """``gaussian_nll`` on random predictions, variances (some below the
    1e-6 clamp) and masks, with and without row weights."""
    rng = np.random.default_rng(0)
    pred, target = (rng.normal(size=(9, 3)).astype(np.float32) for _ in range(2))
    var = np.abs(rng.normal(size=(9, 3))).astype(np.float32)
    var[0, 0], var[1, 2] = 0.0, 1e-9
    mask = rng.uniform(size=9) > 0.3
    w = rng.uniform(0.5, 2.0, 9).astype(np.float32)
    for rw in (None, w):
        want = j_gaussian_nll(pred, var, target, mask, row_weights=rw)
        got = gaussian_nll(*(torch.from_numpy(a) for a in (pred, var, target, mask)),
                           row_weights=None if rw is None else torch.from_numpy(rw))
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# branches


def _weighted_pair():
    cfg = multibranch(_config("EGNN"), 3)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch.update(equivariance=True, branch_loss_weights=[1.0, 2.0, 0.5],
                branch_loss_metrics=True)
    return gfm_pair("weighted", cfg, in_branches(_splits(), 3), pack=True)


def pytest_branch_selection_with_padding_graphs(pallas_route):
    """Each real graph (and each of its nodes) decodes with its
    ``dataset_id``'s branch: the multibranch model's outputs equal, row for
    row, those of the branch's decoder run alone; the packed batch's
    padding graphs (``dataset_id`` 0) change nothing."""
    jm, v, jb, tc, tb = _weighted_pair()
    assert int((~tb.graph_mask).sum()) > 0
    tm = torch_model(v, tc).eval()
    with torch.no_grad():
        out = tm(tb)
        for b in range(3):
            alone = tm(tb.replace(dataset_id=torch.full_like(tb.dataset_id, b)))
            rows_g = tb.graph_mask & (tb.dataset_id == b)
            rows_n = tb.node_mask & (tb.dataset_id[tb.node_graph] == b)
            assert bool(rows_g.any())
            torch.testing.assert_close(out["energy"][rows_g], alone["energy"][rows_g],
                                       rtol=0, atol=0)
            torch.testing.assert_close(out["forces"][rows_n], alone["forces"][rows_n],
                                       rtol=0, atol=0)
    _assert_close_real_rows(jax_eval(jm, v, jb), out, tb)


def pytest_weighted_multibranch_loss_and_branch_scalars_match_jax(pallas_route):
    """``branch_loss_weights`` [1, 2, 0.5] and ``branch_loss_metrics``: the
    weighted loss, the ``branch<i>`` scalars and one step's gradients
    against the JAX package; and ``multitask_loss`` on the same outputs
    alone, with the weights changed and with variance heads."""
    jm, v, jb, tc, tb = _weighted_pair()
    tasks = _step_matches(jm, v, jb, tc, tb, "weighted grad")
    assert [k for k in tasks if k.startswith("branch")] == ["branch0", "branch1", "branch2"]
    rng = np.random.default_rng(1)
    outs = {"energy": rng.normal(size=(tb.num_graphs, 1)).astype(np.float32),
            "forces": rng.normal(size=(tb.num_nodes, 3)).astype(np.float32)}
    tm = torch_model(v, tc)
    for weights, var in (((1.0, 2.0, 0.5), False), ((3.0, 1.0, 1.0), False),
                         ((1.0, 2.0, 0.5), True)):
        jcfg = dataclasses.replace(jm.cfg, branch_loss_weights=weights, var_output=var)
        tcfg = dataclasses.replace(tm.cfg, branch_loss_weights=weights, var_output=var)
        o = dict(outs)
        if var:
            o.update({f"{k}__var": np.abs(a) + 0.1 for k, a in outs.items()})
        jtot, jtasks = j_multitask_loss({k: jnp.asarray(a) for k, a in o.items()}, jb, jcfg)
        ttot, ttasks = multitask_loss({k: torch.from_numpy(a) for k, a in o.items()}, tb, tcfg)
        np.testing.assert_allclose(float(ttot), float(jtot), rtol=LOSS_RTOL)
        assert sorted(ttasks) == sorted(jtasks)
        for k in jtasks:
            np.testing.assert_allclose(float(ttasks[k]), float(jtasks[k]), rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# HYDRAGNN_STEP_GUARD and HYDRAGNN_DUMP_TESTDATA


@pytest.mark.parametrize("guard_env", [None, "0"])
def pytest_step_guard_env_matches_jax_on_a_nan_batch(guard_env, pallas_route, monkeypatch):
    """A step on a batch with a NaN input feature: by default both packages
    skip it (the parameters unchanged, one skip counted);
    ``HYDRAGNN_STEP_GUARD=0`` turns the guard off in both, and the NaN
    reaches the parameters."""
    if guard_env is not None:
        monkeypatch.setenv("HYDRAGNN_STEP_GUARD", guard_env)
    jm, v, jb, tc, tb = _weighted_pair()
    x = np.asarray(jb.x).copy()
    x[0, 0] = np.nan
    opt = {"type": "AdamW", "learning_rate": 1e-3}
    tx = j_make_optimizer(opt)
    js = JState.create(jax.tree_util.tree_map(jnp.asarray, v), tx)
    js, _, _ = j_make_train_step(jm, tx)(js, jb.replace(x=jnp.asarray(x)), jax.random.PRNGKey(0))
    tm = torch_model(v, tc)
    ts = TrainState.create(tm, make_optimizer(tm, opt))
    ts, _, _ = make_train_step(tm)(ts, tb.replace(x=torch.from_numpy(x)))
    j_finite = all(bool(np.isfinite(np.asarray(a)).all())
                   for a in jax.tree_util.tree_leaves(js.params))
    t_finite = all(bool(torch.isfinite(p).all()) for p in tm.parameters())
    assert j_finite == t_finite == (guard_env is None)
    assert int(ts.skipped_steps) == int(js.skipped_steps) == (1 if guard_env is None else 0)
    assert int(ts.step) == int(js.step) == 1


def pytest_dump_testdata_pickle_matches_jax(pallas_route, tmp_path, monkeypatch):
    """``HYDRAGNN_DUMP_TESTDATA=<dir>``: ``test_model`` pickles the test
    split's predictions and targets per head, as the JAX package does."""
    jm, v, jb, tc, tb = _weighted_pair()
    tr = in_branches(_splits(), 3)[0]
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    monkeypatch.setenv("HYDRAGNN_DUMP_TESTDATA", str(jdir))
    js = JState.create(jax.tree_util.tree_map(jnp.asarray, v),
                       j_make_optimizer({"type": "AdamW", "learning_rate": 1e-3}))
    j_test_model(jm, js, JLoader(tr, 4, sort_edges=True, pack=True))
    monkeypatch.setenv("HYDRAGNN_DUMP_TESTDATA", str(tdir))
    test_model(torch_model(v, tc), TLoader(tr, 4, sort_edges=True, pack=True))
    files = sorted(os.listdir(jdir))
    assert files == sorted(os.listdir(tdir)) == ["testdata_rank0.pkl"]
    with open(jdir / files[0], "rb") as f:
        want = pickle.load(f)
    with open(tdir / files[0], "rb") as f:
        got = pickle.load(f)
    assert sorted(got) == sorted(want) == ["preds", "trues"]
    for part in ("preds", "trues"):
        assert sorted(got[part]) == sorted(want[part]) == ["energy", "forces"]
        for k, w in want[part].items():
            w = np.asarray(w)
            assert got[part][k].shape == w.shape
            np.testing.assert_allclose(got[part][k], w, rtol=0,
                                       atol=DUMP_RTOL * float(np.abs(w).max()))
    monkeypatch.setenv("HYDRAGNN_DUMP_TESTDATA", "0")
    test_model(torch_model(v, tc), TLoader(tr, 4, sort_edges=True, pack=True))
    assert not (tmp_path / "logs").exists()


# ---------------------------------------------------------------------------
# serving every branch


def pytest_server_answers_each_branch_with_its_decoder(tmp_path, monkeypatch):
    """``run_server`` on a 3-branch model with variance heads: each
    request's ``dataset_id`` picks its decoder (the answers equal the
    model's on a batch of that graph alone, ``__var`` outputs included), and
    a ``dataset_id`` that names no branch is rejected at the door."""
    import hydragnn_tpu_torch.api as api
    from hydragnn_tpu_torch.data.graph import batch_graphs
    from hydragnn_tpu_torch.serve import InvalidRequestError
    from test_torch_serve import _config as serve_config
    from test_torch_serve import _graphs

    monkeypatch.chdir(tmp_path)
    cfg = multibranch(serve_config(), 3)
    cfg["NeuralNetwork"]["Training"]["loss_function_type"] = "GaussianNLLLoss"
    graphs = [dataclasses.replace(g, dataset_id=i % 3) for i, g in enumerate(_graphs(12))]
    splits = (graphs[:8], graphs[8:10], graphs[10:])
    with pytest.warns(UserWarning, match="no checkpoint"):
        server = api.run_server(cfg, datasets=splits, device="cpu")
    try:
        assert server.wait_ready(timeout=120)
        bad = dataclasses.replace(graphs[0], dataset_id=3)
        answers = server.predict(graphs[:6] + [bad], timeout=120)
        assert isinstance(answers[-1], InvalidRequestError)
        assert answers[-1].reason == "unknown_branch"
        model = server.model.eval()
        for g, got in zip(graphs[:6], answers[:6]):
            spec = server.ladder.select_for([g])
            with torch.no_grad():
                want = model(batch_graphs([g], spec, sort_edges=server.sort_edges))
            assert sorted(got) == ["energy", "energy__var", "forces", "forces__var"]
            for k, v in got.items():
                w = want[k].numpy()[: v.shape[0]] if k.startswith("forces") else want[k].numpy()[0]
                np.testing.assert_allclose(v, w, rtol=1e-5, atol=1e-6, err_msg=k)
    finally:
        server.close()
