"""The port's message-passing zoo against the JAX package, on the CPU.

SAGE, MFC, CGCNN, GAT, SchNet, PAINN, PNAPlus and PNAEq, each in a 2-layer
``HydraModel`` (hidden 16, graph and node heads) built in JAX, its
variables (with non-trivial batch-norm statistics) bridged into the port,
on the same receiver-sorted batch of OC20-shaped graphs. The JAX side runs
its Pallas routes in interpret mode (``HYDRAGNN_PALLAS_SEGMENT=1``), so K1
and K3 are held through their kernels and their ``custom_jvp`` rules. Also
the radial bases, ``segment_softmax``, the MD17 and Lennard-Jones
generators, and config completion.

Tolerances (f32: the same algorithm in another summation order):

- radial bases: 1e-5 of the largest value in f32 (XLA's f32 exp lies up
  to 1e-5 relative from PyTorch's at the Gaussian basis's arguments, the
  other bases within 1e-6); in bf16 the same bits, but for values below
  the smallest normal, which XLA flushes to 0;
- ``segment_softmax``: 1e-6 in f32; in bf16 2^-7 absolute (two bf16
  ulps of a weight near 1), as the port sums its denominators in f32
  where the JAX scatter-add sums in bf16;
- forwards: real rows to 1e-4 of each head's largest value;
- one training step (tests/test_torch_zoo_grads.py): the loss and each
  task's to 1e-5, every parameter's gradient to 1e-4 of its largest
  (floored at 1e-3 of the largest gradient anywhere, as
  tests/test_torch_train.py);
- bf16 ``mixed_precision`` (each package's ``mp_cast_eval``): the dtype
  out of every conv layer and every head exactly as the JAX package's;
  the first conv layer's outputs, real rows, within ``BF16_SHARE`` of the
  distance bf16 itself puts between the JAX package's bf16 and f32
  outputs of that layer (relative L2). Both packages round at the same
  points, but the JAX package's silu, sigmoid and softplus round their
  inner steps in bf16 (one ulp apart from PyTorch's on some elements),
  its scatter-add sums in bf16, and a random-weight conv amplifies such
  ulps by cancellation; past the first layer, through the batch norms,
  by as much again. A conv computing another function lies O(1) away.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydragnn_tpu.config import update_config as j_update
from hydragnn_tpu.data import GraphLoader as JLoader
from hydragnn_tpu.data import synthetic as j_synthetic
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.ops import radial as j_radial
from hydragnn_tpu.ops import segment as j_segment
from hydragnn_tpu.train.loop import mp_cast_eval as j_mp_cast_eval
from hydragnn_tpu_torch.bridge import load_jax_variables
from hydragnn_tpu_torch.config import update_config as t_update
from hydragnn_tpu_torch.data import GraphLoader as TLoader
from hydragnn_tpu_torch.data import oc20_shaped_dataset, split_dataset
from hydragnn_tpu_torch.data import synthetic as t_synthetic
from hydragnn_tpu_torch.models import create_model as t_create
from hydragnn_tpu_torch.ops import radial as t_radial
from hydragnn_tpu_torch.ops import segment as t_segment
from hydragnn_tpu_torch.train import mp_cast_eval
from test_torch_egnn import _assert_close_real_rows
from test_torch_kernels import _sorted_ids

torch.set_num_threads(2)

ZOO = ("SAGE", "MFC", "CGCNN", "GAT", "SchNet", "PAINN", "PNAPlus", "PNAEq")
BASIS_RTOL = 1e-5
SOFTMAX_RTOL = 1e-6
TINY = 2.0**-126  # the smallest normal f32 and bf16 value
SOFTMAX_BF16_ATOL = 2.0**-7
BF16_SHARE = 2.0


# ---------------------------------------------------------------------------
# radial bases and segment_softmax


def _radii(dtype):
    """Distances over [0, 6] around a cutoff of 5, with the clamped length
    of a padding self-edge (1e-6) and an exact 0."""
    r = np.concatenate([[0.0, 1e-6], np.linspace(0.05, 6.0, 97)]).astype(np.float32)
    return jnp.asarray(r).astype(dtype), torch.from_numpy(r).to(
        torch.float32 if dtype == jnp.float32 else torch.bfloat16)


BASES = {
    "gaussian_basis": lambda m, r: m.gaussian_basis(r, 5.0, 50),
    "sinc_expansion": lambda m, r: m.sinc_expansion(r, 5.0, 20),
    "bessel_basis": lambda m, r: m.bessel_basis(r, 5.0, 8),
    "cosine_cutoff": lambda m, r: m.cosine_cutoff(r, 5.0),
    "dimenet_envelope": lambda m, r: m.dimenet_envelope(r / 5.0, 5),
    "bessel_basis_enveloped": lambda m, r: m.bessel_basis_enveloped(r, 5.0, 5, 5),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(BASES))
def pytest_radial_basis_matches_jax(name, dtype):
    jr, tr = _radii(getattr(jnp, dtype))
    want = np.asarray(BASES[name](j_radial, jr).astype(jnp.float32))
    got = BASES[name](t_radial, tr)
    assert str(got.dtype)[6:] == dtype and np.isfinite(got.float().numpy()).all()
    got = got.float().numpy()
    assert got.shape == want.shape
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=0, atol=TINY)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=BASIS_RTOL * float(np.abs(want).max()))


def pytest_edge_vectors_clamp_a_padding_self_edge():
    """A padding self-edge (sender == receiver) has vec 0 and length
    sqrt(1e-12) = 1e-6 in both packages, and its length's gradient is 0."""
    pos = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    s, r = np.array([0, 3, 4], np.int32), np.array([1, 3, 4], np.int32)
    jv, jl = j_radial.edge_vectors(jnp.asarray(pos), jnp.asarray(s), jnp.asarray(r))
    tp = torch.from_numpy(pos).requires_grad_(True)
    tv, tl = t_radial.edge_vectors(tp, torch.from_numpy(s).long(), torch.from_numpy(r).long())
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=1e-6)
    assert float(tl[1, 0].detach()) == pytest.approx(1e-6)
    assert float(tv[1].detach().abs().sum()) == 0.0
    (g,) = torch.autograd.grad(tl[1:].sum(), tp)
    assert float(g.abs().sum()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def pytest_segment_softmax_matches_jax(dtype):
    """[E, H] logits over ascending ids with empty segments, masked edges,
    and a segment whose every edge is masked (all weights 0, no NaN); in
    f32 also the gradient of a weighted sum of the weights."""
    rng = np.random.default_rng(5)
    e, n, h = 120, 30, 3
    ids = _sorted_ids(rng, e, n, 9)
    logits = (4.0 * rng.normal(size=(e, h))).astype(np.float32)
    mask = rng.random(e) > 0.2
    mask[ids == ids[0]] = False  # an all-padding segment
    w = rng.normal(size=(e, h)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    def jfn(x):
        return j_segment.segment_softmax(x, jnp.asarray(ids), n, jnp.asarray(mask))

    want = np.asarray(jfn(jnp.asarray(logits).astype(jd)).astype(jnp.float32))
    tl = torch.from_numpy(logits).to(td).requires_grad_(dtype == "float32")
    got = t_segment.segment_softmax(tl, torch.from_numpy(ids), n, torch.from_numpy(mask))
    assert got.dtype == td
    g = got.detach().float().numpy()
    assert np.isfinite(g).all() and float(np.abs(g[ids == ids[0]]).max()) == 0.0
    sums = np.zeros((n, h))
    np.add.at(sums, ids[mask], g[mask])
    real = np.isin(np.arange(n), ids[mask])
    np.testing.assert_allclose(sums[real], 1.0, atol=1e-5 if dtype == "float32" else 3e-2)
    atol = SOFTMAX_RTOL if dtype == "float32" else SOFTMAX_BF16_ATOL
    np.testing.assert_allclose(g, want, rtol=0, atol=atol)
    if dtype == "float32":
        jg = jax.grad(lambda x: jnp.sum(jfn(x) * w))(jnp.asarray(logits))
        (tg,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), tl)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                                   atol=SOFTMAX_RTOL * float(np.abs(np.asarray(jg)).max()))


# ---------------------------------------------------------------------------
# the MD17 and Lennard-Jones generators


@pytest.mark.parametrize("name,kw", [
    ("md17_shaped_dataset", dict(number_configurations=24)),
    ("lennard_jones_dataset", dict(number_configurations=12, supercell=(3, 2, 2))),
])
def pytest_energy_force_datasets_are_byte_identical(name, kw):
    want = getattr(j_synthetic, name)(**kw)
    got = getattr(t_synthetic, name)(**kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in ("x", "pos", "senders", "receivers", "z"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
        for t in ("graph_targets", "node_targets"):
            assert getattr(a, t).keys() == getattr(b, t).keys()
            for k, v in getattr(b, t).items():
                assert getattr(a, t)[k].tobytes() == v.tobytes(), (t, k)


# ---------------------------------------------------------------------------
# config completion and the model factory


def _config(model, hidden=16, layers=2, gps=False):
    heads = {"graph": {"num_sharedlayers": 1, "dim_sharedlayers": 8,
                       "num_headlayers": 2, "dim_headlayers": [8, 8]},
             "node": {"num_headlayers": 2, "dim_headlayers": [8, 8], "type": "mlp"}}
    arch = {"mpnn_type": model, "radius": 5.0, "max_neighbours": 10, "hidden_dim": hidden,
            "num_conv_layers": layers, "use_sorted_aggregation": True,
            "equivariance": model in ("SchNet", "PAINN", "PNAEq"),
            "task_weights": [1.0, 1.0], "output_heads": heads}
    if model == "SchNet":
        arch.update(num_gaussians=12, num_filters=10)
    if model in ("PAINN", "PNAPlus", "PNAEq"):
        arch["num_radial"] = 6
    if gps:
        arch.update(global_attn_engine="GPS", global_attn_type="multihead",
                    global_attn_heads=2, pe_dim=4, dropout=0.0)
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


_SPLITS = []


def _splits():
    if not _SPLITS:
        graphs = oc20_shaped_dataset(16, mean_atoms=20, min_atoms=10, max_atoms=40,
                                     max_neighbours=10)
        _SPLITS.append(split_dataset(graphs, 0.75, seed=0))
    return _SPLITS[0]


ARCH_KEYS = ("hidden_dim", "input_dim", "edge_dim", "pna_deg", "max_neighbours", "radius",
             "num_gaussians", "num_filters", "num_radial", "envelope_exponent",
             "equivariance", "max_in_degree", "use_sorted_aggregation",
             "use_fused_edge_kernel")


@pytest.mark.parametrize("model", ZOO)
def pytest_update_config_matches_jax(model):
    """The Architecture keys the convs read, completed as the JAX package
    completes them: CGCNN's hidden width pinned to the input width (and
    its edge_dim 0), the PNA family's degree histogram and neighbour cap,
    the radial keys None where unset."""
    tr, va, te = _splits()
    cfg = _config(model)
    jc = j_update(copy.deepcopy(cfg), tr, va, te)["NeuralNetwork"]["Architecture"]
    tc = t_update(copy.deepcopy(cfg), tr, va, te)["NeuralNetwork"]["Architecture"]
    assert {k: tc[k] for k in ARCH_KEYS} == {k: jc[k] for k in ARCH_KEYS}
    if model == "CGCNN":
        assert tc["hidden_dim"] == tc["input_dim"] == 4 and tc["edge_dim"] == 0
        gps = t_update(_config(model, gps=True), tr, va, te)["NeuralNetwork"]["Architecture"]
        assert gps["hidden_dim"] == 16  # GPS keeps the configured width
    if model in ("PNAPlus", "PNAEq"):
        assert tc["pna_deg"] and tc["max_neighbours"] == len(tc["pna_deg"]) - 1
    else:
        assert tc["pna_deg"] is None


def pytest_create_model_raises_only_for_dimenet_and_mace():
    """Named when the port still raised for DimeNet and MACE: now
    ``create_model`` builds every conv of the JAX package's registry into a
    ``HydraModel`` with each layer of that conv, and MACE into its own
    ``MACEModel``, as the JAX package's ``available_models`` lists them."""
    from hydragnn_tpu.models.create import available_models
    from hydragnn_tpu_torch.models import HydraModel
    from hydragnn_tpu_torch.models.mace import MACEModel

    tr, va, te = _splits()
    extra = {"DimeNet": dict(num_radial=4, num_spherical=3),
             "MACE": dict(num_radial=6, max_ell=2, node_max_ell=1, correlation=2)}
    built = {}
    for model in available_models():
        cfg = _config(model)
        cfg["NeuralNetwork"]["Architecture"].update(extra.get(model, {}))
        m = t_create(t_update(cfg, tr, va, te), device="cpu")
        built[model] = type(m)
        if model != "MACE":
            assert {type(c).__module__.rsplit(".", 1)[-1] for c in m.graph_convs} == \
                {type(m.graph_convs[0]).__module__.rsplit(".", 1)[-1]}
    assert set(ZOO) | {"DimeNet", "EGNN", "GIN", "PNA", "MACE"} <= set(built)
    assert built.pop("MACE") is MACEModel
    assert set(built.values()) == {HydraModel}


def pytest_gat_layer_widths_follow_its_heads():
    """GAT's hidden layers concatenate 6 heads: the next conv and the batch
    norm take 6 x hidden, the last layer averages; under GPS every layer
    averages."""
    tr, va, te = _splits()
    m = t_create(t_update(_config("GAT", layers=3), tr, va, te), device="cpu")
    assert [c.out_width for c in m.graph_convs] == [96, 96, 16]
    assert [bn.scale.shape[0] for bn in m.feature_layers] == [96, 96, 16]
    assert m.graph_convs[1].Dense_0.weight.shape == (96, 96)
    g = t_create(t_update(_config("GAT", layers=2, gps=True), tr, va, te), device="cpu")
    assert [bn.scale.shape[0] for bn in g.feature_layers] == [16, 16]


# ---------------------------------------------------------------------------
# each conv on bridged weights


_PAIRS = {}


def _jax_init(jm, jb, seed=3):
    """``init_model``'s variables (the same rngs), under ``jax.jit``, with
    randomized batch-norm statistics as ``test_torch_egnn._jax_variables``
    draws them."""
    rngs = {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)}
    v = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r, b: jm.init(r, b, train=False))(rngs, jb))
    rng = np.random.default_rng(seed)

    def randomize(tree):
        if "mean" not in tree:
            for sub in tree.values():
                randomize(sub)
            return
        tree["mean"] = (0.1 * rng.normal(size=tree["mean"].shape)).astype(np.float32)
        tree["var"] = rng.uniform(0.5, 2.0, size=tree["var"].shape).astype(np.float32)

    randomize(v["batch_stats"])
    return v


def pair(model, layers=2, **kw):
    """(JAX model, its variables, JAX batch, completed torch config, torch
    batch), built once per configuration in a process."""
    key = (model, layers, tuple(sorted(kw.items())))
    if key not in _PAIRS:
        tr, va, te = _splits()
        cfg = _config(model, layers=layers, **kw)
        jc = j_update(copy.deepcopy(cfg), tr, va, te)
        tc = t_update(copy.deepcopy(cfg), tr, va, te)
        jb = next(iter(JLoader(tr, 4, sort_edges=True)))
        tb = next(iter(TLoader(tr, 4, sort_edges=True)))
        jm = j_create(jc)
        _PAIRS[key] = (jm, _jax_init(jm, jb), jb, tc, tb)
    return _PAIRS[key]


def torch_model(v, tc):
    tm = t_create(tc, device="cpu")
    load_jax_variables(tm, v)
    return tm


@pytest.fixture
def pallas_route(monkeypatch):
    monkeypatch.setenv("HYDRAGNN_PALLAS_SEGMENT", "1")


@pytest.mark.parametrize("model", ZOO)
def pytest_conv_matches_jax_on_bridged_weights(model, pallas_route):
    jm, v, jb, tc, tb = pair(model)
    tm = torch_model(v, tc)
    with torch.no_grad():
        tout = tm(tb)
    _assert_close_real_rows(jm.apply(v, jb, train=False), tout, tb)


def _relative_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _conv_outputs(tree, n):
    """The JAX conv layers' ``(inv, equiv)`` outputs from captured
    intermediates."""
    return [tree["intermediates"][f"graph_convs_{i}"]["__call__"][0] for i in range(n)]


def _capture(mdl, method):
    return method == "__call__" and (mdl.name or "").startswith("graph_convs_")


@pytest.mark.parametrize("model", ZOO)
def pytest_conv_mixed_precision_matches_jax(model, pallas_route):
    """Both packages' ``mp_cast_eval`` on the same bridged weights: the same
    dtypes out of every conv layer and every head; the first conv layer's
    outputs (scalar, and vector or positions) on real rows within
    ``BF16_SHARE`` of the distance between the JAX package's bf16 and f32
    outputs of that layer."""
    jm, v, jb, tc, tb = pair(model)
    n = tc["NeuralNetwork"]["Architecture"]["num_conv_layers"]
    jv, jbb = j_mp_cast_eval(jax.tree_util.tree_map(jnp.asarray, v), jb, False)
    jout, inter = jm.apply(jv, jbb, train=False, mutable=["intermediates"],
                           capture_intermediates=_capture)
    _, inter32 = jm.apply(v, jb, train=False, mutable=["intermediates"],
                          capture_intermediates=_capture)
    jconv, jconv32 = _conv_outputs(inter, n), _conv_outputs(inter32, n)
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
    for name, a in jout.items():
        assert str(tout[name].dtype)[6:] == str(a.dtype), name
    rows = tb.node_mask.numpy()
    for k, (got, want, want32) in enumerate(zip(seen[0], jconv[0], jconv32[0])):
        want = np.asarray(want.astype(jnp.float32))[rows]
        budget = _relative_l2(want, np.asarray(want32)[rows])
        err = _relative_l2(got.float().numpy()[rows], want)
        assert err <= BF16_SHARE * budget, (k, err, budget)
