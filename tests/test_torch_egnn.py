"""The port's EGNN ``HydraModel`` against the JAX package's on bridged weights.

A 3-layer equivariant EGNN (hidden 24) with a graph head and a node head is
built in JAX, its variables (with non-trivial batch-norm statistics) are
exported to numpy and loaded into the port through ``bridge``; both run the
same receiver-sorted batch, the JAX side with its Pallas route forced
(interpret mode). Real rows must agree to rtol 1e-4 of each head's largest
value (f32, same algorithm, other summation order), for the fused (K2 in the
last layer) and the unfused spelling alike.
"""

import copy

import numpy as np
import pytest
import torch

import jax

from hydragnn_tpu.config import update_config as j_update
from hydragnn_tpu.data import GraphLoader as JLoader
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.models import init_model as j_init
from hydragnn_tpu.train.loop import mp_cast_eval as j_mp_cast_eval
from hydragnn_tpu_torch.bridge import load_jax_variables, torch_name
from hydragnn_tpu_torch.config import update_config as t_update
from hydragnn_tpu_torch.data import GraphLoader as TLoader
from hydragnn_tpu_torch.data import oc20_shaped_dataset, split_dataset
from hydragnn_tpu_torch.models import create_model as t_create
from hydragnn_tpu_torch.train import mp_cast_eval, test_model

torch.set_num_threads(2)

RTOL = 1e-4


def _config(fused=None, branches=1, hidden=24):
    graph_head = {"num_sharedlayers": 2, "dim_sharedlayers": 8,
                  "num_headlayers": 2, "dim_headlayers": [12, 12]}
    node_head = {"num_headlayers": 2, "dim_headlayers": [12, 12], "type": "mlp"}
    heads = {"graph": graph_head, "node": node_head}
    if branches > 1:
        heads = {k: [{"type": f"branch-{b}", "architecture": dict(v)}
                     for b in range(branches)] for k, v in heads.items()}
    arch = {"mpnn_type": "EGNN", "equivariance": True, "radius": 5.0,
            "max_neighbours": 10, "hidden_dim": hidden, "num_conv_layers": 3,
            "use_sorted_aggregation": True, "task_weights": [1.0, 1.0],
            "output_heads": heads}
    if fused is not None:
        arch["use_fused_edge_kernel"] = fused
    return {
        "Dataset": {"node_features": {"dim": [1, 3, 3]}, "graph_features": {"dim": [1]}},
        "NeuralNetwork": {
            "Architecture": arch,
            "Variables_of_interest": {
                "input_node_features": [0, 1], "output_names": ["energy", "forces"],
                "output_index": [0, 2], "type": ["graph", "node"],
            },
            "Training": {"batch_size": 4, "loss_function_type": "mae"},
        },
    }


def _splits(dataset_ids=False):
    graphs = oc20_shaped_dataset(16, mean_atoms=20, min_atoms=10, max_atoms=40,
                                 max_neighbours=10)
    if dataset_ids:
        for i, g in enumerate(graphs):
            g.dataset_id = i % 2
    return split_dataset(graphs, 0.75, seed=0)


def _jax_variables(model, batch, seed=3):
    v = jax.tree_util.tree_map(np.asarray, jax.device_get(j_init(model, batch, seed=seed)))
    rng = np.random.default_rng(seed)

    def randomize(tree):  # every batch norm's running statistics, nested or not
        if "mean" not in tree:
            for sub in tree.values():
                randomize(sub)
            return
        tree["mean"] = (0.1 * rng.normal(size=tree["mean"].shape)).astype(np.float32)
        tree["var"] = rng.uniform(0.5, 2.0, size=tree["var"].shape).astype(np.float32)

    randomize(v["batch_stats"])
    return v


def _both(monkeypatch, fused=None, branches=1):
    monkeypatch.setenv("HYDRAGNN_PALLAS_SEGMENT", "1")
    tr, va, te = _splits(dataset_ids=branches > 1)
    cfg = _config(fused, branches)
    jc = j_update(copy.deepcopy(cfg), tr, va, te)
    tc = t_update(copy.deepcopy(cfg), tr, va, te)
    jb = next(iter(JLoader(tr, 4, sort_edges=True)))
    tb = next(iter(TLoader(tr, 4, sort_edges=True)))
    jm = j_create(jc)
    v = _jax_variables(jm, jb)
    tm = t_create(tc, device="cpu")
    load_jax_variables(tm, v)
    return jm, v, jb, tm, tb, tc


def _assert_close_real_rows(jout, tout, batch):
    for name, a in jout.items():
        a = np.asarray(a)
        t = tout[name].detach().float().numpy()
        assert a.shape == t.shape, name
        mask = (batch.graph_mask if a.shape[0] == batch.num_graphs else batch.node_mask).numpy()
        scale = max(float(np.abs(a[mask]).max()), 1e-6)
        assert float(np.abs(a[mask] - t[mask]).max()) <= RTOL * scale, name


@pytest.mark.parametrize("fused", [True, False])
def pytest_egnn_matches_jax_on_bridged_weights(monkeypatch, fused):
    jm, v, jb, tm, tb, tc = _both(monkeypatch, fused)
    assert tc["NeuralNetwork"]["Architecture"]["use_fused_edge_kernel"] is fused
    assert tm.graph_convs[-1].uses_fused_edge is fused
    assert not any(c.uses_fused_edge for c in tm.graph_convs[:-1])
    with torch.no_grad():
        tout = tm(tb)
    _assert_close_real_rows(jm.apply(v, jb, train=False), tout, tb)


def pytest_egnn_branch_banks_match_jax(monkeypatch):
    """Two decoder branches: the [B] parameter axis is kept and every graph
    decodes with its dataset_id's branch."""
    jm, v, jb, tm, tb, _ = _both(monkeypatch, branches=2)
    assert tm.graph_shared.Dense_0.weight.shape[0] == 2
    assert set(tb.dataset_id[tb.graph_mask].tolist()) == {0, 1}
    with torch.no_grad():
        tout = tm(tb)
    _assert_close_real_rows(jm.apply(v, jb, train=False), tout, tb)


def pytest_fused_and_unfused_share_one_state_dict():
    tr, va, te = _splits()
    names = []
    for fused in (True, False):
        c = t_update(_config(fused), tr, va, te)
        names.append(sorted(t_create(c, device="cpu").state_dict()))
    assert names[0] == names[1]


def pytest_bridge_is_strict(monkeypatch):
    jm, v, jb, tm, tb, tc = _both(monkeypatch, True)
    missing = copy.deepcopy(v)
    del missing["params"]["graph_convs_0"]["edge_lin_len"]
    with pytest.raises(ValueError, match="not filled"):
        load_jax_variables(tm, missing)
    extra = copy.deepcopy(v)
    extra["params"]["graph_convs_0"]["edge_lin_extra"] = {"kernel": np.zeros((1, 24), np.float32)}
    with pytest.raises(ValueError, match="no counterpart"):
        load_jax_variables(tm, extra)
    wrong = copy.deepcopy(v)
    wrong["params"]["graph_convs_1"]["edge_lin2"]["bias"] = np.zeros((5,), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(tm, wrong)
    assert torch_name(("heads_NN_1", "MLP_0", "Dense_2", "kernel")) == ("heads_NN.1.MLP_0.Dense_2.weight", True)


def pytest_decoder_init_is_mirrored_and_seeded():
    tr, va, te = _splits()
    c = t_update(_config(), tr, va, te)
    m1 = t_create(c, device="cpu", seed=7)
    m2 = t_create(c, device="cpu", seed=7)
    m3 = t_create(c, device="cpu", seed=8)
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    assert not torch.equal(m1.graph_convs[0].edge_lin2.weight, m3.graph_convs[0].edge_lin2.weight)
    w = m1.heads_NN[0].Dense_0.weight[0]  # activated decoder layer: (w, -w) unit pairs
    half = (w.shape[0] + 1) // 2
    torch.testing.assert_close(w[half:], -w[: w.shape[0] - half])
    last = m1.heads_NN[1].MLP_0.Dense_2.weight[0]  # output layer: plain lecun normal
    assert last.shape[0] == 3 and not torch.allclose(last[2], -last[0])


def pytest_mixed_precision_eval_runs_bf16_first_then_f32():
    """bf16 parameters and inputs: the f32 coordinate mean promotes the
    positions, so later layers run in f32 (the JAX package's promotion);
    outputs are finite f32. (bf16 numerics are compared on the card.)"""
    tr, va, te = _splits()
    c = t_update(_config(True), tr, va, te)
    model = t_create(c, device="cpu")
    batch = next(iter(TLoader(tr, 4, sort_edges=True)))
    bf_model, bf_batch = mp_cast_eval(model, batch)
    assert bf_batch.x.dtype == torch.bfloat16 and bf_batch.pos.dtype == torch.bfloat16
    assert bf_model.feature_layers[0].mean.dtype == torch.bfloat16
    assert model.graph_convs[0].edge_lin2.weight.dtype == torch.float32  # the original stays
    seen = []
    hooks = [conv.register_forward_hook(lambda m, i, o: seen.append(o[1].dtype))
             for conv in bf_model.graph_convs]
    with torch.no_grad():
        out = bf_model(bf_batch)
    for h in hooks:
        h.remove()
    assert seen == [torch.float32, torch.float32, torch.float32]
    for v in out.values():
        assert v.dtype == torch.float32 and torch.isfinite(v).all()


def _jax_conv_dtypes(inter):
    convs = inter["intermediates"]
    return [tuple(str(t.dtype) for t in convs[f"graph_convs_{i}"]["__call__"][0])
            for i in range(len(convs))]


# bf16 against bf16: both packages round at the same points (bf16 parameters,
# running statistics and inputs; Dense outputs in the promoted dtype) and only
# conv layer 0 runs in bf16, so they agree to about 1e-6 of each head's
# largest real value here; the same model in f32 lies 5e-3 to 1e-2 away. The
# tolerance sits between the two, so a layer run in the wrong dtype fails.
BF16_RTOL = 1e-3


@pytest.mark.parametrize("fused", [True, False])
def pytest_mixed_precision_eval_matches_jax(monkeypatch, fused):
    """Both packages' ``mp_cast_eval`` on the same bridged weights: the same
    dtypes out of every conv layer (the f32 coordinate mean of layer 0
    promotes the positions, so later layers run in f32) and the same outputs
    within ``BF16_RTOL`` on real rows."""
    jm, v, jb, tm, tb, tc = _both(monkeypatch, fused)
    # the JAX cast only touches jax arrays, as its trainer's variables are
    jv, jbb = j_mp_cast_eval(jax.tree_util.tree_map(jax.numpy.asarray, v), jb, False)
    jout, inter = jm.apply(
        jv, jbb, train=False, mutable=["intermediates"],
        capture_intermediates=lambda mdl, method: method == "__call__"
        and (mdl.name or "").startswith("graph_convs_"),
    )
    bf_model, bf_batch = mp_cast_eval(tm, tb)
    seen = []
    hooks = [conv.register_forward_hook(
        lambda m, i, o: seen.append(tuple(str(t.dtype)[6:] for t in o)))
        for conv in bf_model.graph_convs]
    with torch.no_grad():
        tout = bf_model(bf_batch)
    for h in hooks:
        h.remove()
    jdt = _jax_conv_dtypes(inter)
    assert seen == jdt
    assert jdt[0] == ("bfloat16", "float32") and jdt[1:] == [("float32", "float32")] * 2
    for name, a in jout.items():
        a = np.asarray(a).astype(np.float32)
        t = tout[name]
        assert str(t.dtype)[6:] == str(jout[name].dtype), name
        t = t.float().numpy()
        mask = (tb.graph_mask if a.shape[0] == tb.num_graphs else tb.node_mask).numpy()
        scale = max(float(np.abs(a[mask]).max()), 1e-6)
        assert float(np.abs(a[mask] - t[mask]).max()) <= BF16_RTOL * scale, name


def pytest_test_model_reports_real_rows_and_loss():
    tr, va, te = _splits()
    c = t_update(_config(), tr, va, te)
    model = t_create(c, device="cpu")
    loader = TLoader(te, 4, shuffle=False, sort_edges=True)
    tot, tasks, preds, trues = test_model(model, loader)
    n_nodes = sum(g.num_nodes for g in te)
    assert preds["energy"].shape == (len(te), 1) and preds["forces"].shape == (n_nodes, 3)
    assert trues["forces"].shape == (n_nodes, 3)
    assert np.isfinite(tot) and set(tasks) == {"energy", "forces"}
    np.testing.assert_allclose(tasks["energy"], np.abs(preds["energy"] - trues["energy"]).mean(),
                               rtol=1e-5)
