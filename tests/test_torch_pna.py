"""The port's PNA pieces against the JAX package: K3's plain version
(hydragnn_tpu_torch/ops/multi_agg.py) against the JAX kernel in interpret mode
and its dense reference, the dense min/max/std aggregators, config
completion for PNA and GPS, and the PNA ``HydraModel`` on bridged weights.

Tolerances: the moments are the same function summed in another order, so
f32 sums agree to 3e-5 (the JAX package's own kernel-vs-dense tolerance) and
count, min and max exactly; in bf16 both packages form each message in bf16
and widen it, so count, min and max still agree exactly. Models: real rows
to 1e-4 of each head's largest value (f32, other summation order).
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hydragnn_tpu.config import update_config as j_update
from hydragnn_tpu.config.config import degree_histogram as j_degree_histogram
from hydragnn_tpu.data import GraphLoader as JLoader
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.ops import segment as j_segment
from hydragnn_tpu.ops.pallas_multi_agg import fused_multi_agg as j_fused_multi_agg
from hydragnn_tpu.ops.pallas_multi_agg import reference_multi_agg as j_reference_multi_agg
from hydragnn_tpu_torch.bridge import load_jax_variables
from hydragnn_tpu_torch.config import update_config as t_update
from hydragnn_tpu_torch.config.config import degree_histogram
from hydragnn_tpu_torch.data import GraphLoader as TLoader
from hydragnn_tpu_torch.data import oc20_shaped_dataset, split_dataset
from hydragnn_tpu_torch.models import create_model as t_create
from hydragnn_tpu_torch.ops import multi_agg as t_multi
from hydragnn_tpu_torch.ops import segment as t_segment
from test_torch_egnn import _assert_close_real_rows, _jax_variables
from test_torch_kernels import _sorted_ids

torch.set_num_threads(2)

MOMENTS = ("sum", "count", "min", "max", "sumsq")
EXACT = ("count", "min", "max")


def _operands(rng, e, n, c, use_recv, use_gate):
    nr = rng.normal(size=(n, c)).astype(np.float32) if use_recv else None
    ei = rng.normal(size=(e, c)).astype(np.float32)
    g = rng.normal(size=(e, c)).astype(np.float32) if use_gate else None
    return nr, ei, g


def _jax(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a).astype(dtype)


def _torch(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _assert_moments(got, want, tol=3e-5):
    for g, w, name in zip(got, want, MOMENTS):
        g, w = g.numpy(), np.asarray(w, np.float32)
        assert g.dtype == np.float32 and g.shape == w.shape, name
        if name in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("e,n,c,max_degree,use_recv,use_gate", [
    (300, 50, 7, 16, True, False),    # PNA: receiver projection + edge operand
    (400, 64, 32, 20, True, True),    # with a gate (PNAPlus's shape)
    (37, 120, 3, 4, False, False),    # the message alone, many empty rows
    (1, 1, 1, 1, True, False),        # one segment, one edge
])
def pytest_multi_agg_plain_matches_jax_kernel(e, n, c, max_degree, use_recv, use_gate):
    rng = np.random.default_rng(e + n)
    ids = _sorted_ids(rng, e, n, max_degree)
    ops = _operands(rng, e, n, c, use_recv, use_gate)
    j = [_jax(a) for a in ops]
    want_kernel = j_fused_multi_agg(*j, jnp.asarray(ids), n, max_degree, interpret=True)
    want_ref = j_reference_multi_agg(*j, jnp.asarray(ids), n)
    got = t_multi.fused_multi_agg(*[_torch(a) for a in ops], torch.from_numpy(ids), n)
    _assert_moments(got, want_kernel)
    _assert_moments(got, want_ref)


@pytest.mark.parametrize("use_gate", [False, True])
def pytest_multi_agg_bf16_forms_messages_like_jax(use_gate):
    """bf16 operands: the message is rounded to bf16 before any moment in
    both packages, so count, min and max agree exactly; every moment is f32."""
    rng = np.random.default_rng(11)
    ids = _sorted_ids(rng, 400, 64, 16)
    ops = _operands(rng, 400, 64, 32, True, use_gate)
    j = [_jax(a, jnp.bfloat16) for a in ops]
    want = j_reference_multi_agg(*j, jnp.asarray(ids), 64)
    got = t_multi.fused_multi_agg(*[_torch(a, torch.bfloat16) for a in ops],
                                  torch.from_numpy(ids), 64)
    _assert_moments(got, want)
    # the JAX kernel's own bf16 rounding points differ from its reference
    # (its test holds it to 4e-2 of it); the port follows the reference
    kernel = j_fused_multi_agg(*j, jnp.asarray(ids), 64, 16, interpret=True)
    for g, k, name in zip(got, kernel, MOMENTS):
        np.testing.assert_allclose(g.numpy(), np.asarray(k), rtol=4e-2, atol=4e-2, err_msg=name)


def pytest_multi_agg_empty_and_trailing_segments_are_zero():
    rng = np.random.default_rng(2)
    ids = np.array([2, 2, 5], np.int32)
    nr, ei, _ = _operands(rng, 3, 64, 4, True, False)
    got = t_multi.fused_multi_agg(_torch(nr), _torch(ei), None, torch.from_numpy(ids), 64)
    _assert_moments(got, j_fused_multi_agg(_jax(nr), _jax(ei), None, jnp.asarray(ids), 64, 8,
                                           interpret=True))
    keep = np.ones(64, bool)
    keep[[2, 5]] = False
    for o, name in zip(got, MOMENTS):
        assert float(o[torch.from_numpy(keep)].abs().max()) == 0.0, name


def pytest_multi_moment_agg_routes_and_masks_like_jax():
    """Sorted ids with a degree bound take K3's wrapper, which ignores the
    mask (padding edges land on the dummy row); otherwise the dense plain
    version runs and honours it, as the JAX routing does."""
    rng = np.random.default_rng(4)
    e, n, c = 200, 30, 6
    ids = _sorted_ids(rng, e, n, 12)
    nr, ei, _ = _operands(rng, e, n, c, True, False)
    mask = rng.random(e) > 0.3
    before = t_multi.fused_multi_agg.launches
    routed = t_segment.multi_moment_agg(_torch(ei), torch.from_numpy(ids), n,
                                        node_recv=_torch(nr), mask=torch.from_numpy(mask),
                                        sorted_ids=True, max_degree=12)
    assert t_multi.fused_multi_agg.launches == before  # a CPU tensor: the plain version
    _assert_moments(routed, j_reference_multi_agg(_jax(nr), _jax(ei), None, jnp.asarray(ids), n))
    dense = t_segment.multi_moment_agg(_torch(ei), torch.from_numpy(ids), n,
                                       node_recv=_torch(nr), mask=torch.from_numpy(mask))
    _assert_moments(dense, j_segment.multi_moment_agg(
        _jax(ei), jnp.asarray(ids), n, node_recv=_jax(nr), mask=jnp.asarray(mask)))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("name", ["segment_min", "segment_max", "segment_std"])
def pytest_dense_aggregators_match_jax(name, dtype):
    """Masked, with empty segments (0 in min/max), f32 and bf16; std takes
    its moments in f32 and clamps the variance before the sqrt."""
    rng = np.random.default_rng(7)
    e, n, c = 150, 40, 5
    ids = _sorted_ids(rng, e, n, 8)
    msg = rng.normal(size=(e, c)).astype(np.float32)
    msg[:10] = 3.0  # a constant segment: a cancelling variance
    mask = rng.random(e) > 0.2
    jd, td = (jnp.float32, torch.float32) if dtype is np.float32 else (jnp.bfloat16, torch.bfloat16)
    want = getattr(j_segment, name)(jnp.asarray(msg).astype(jd), jnp.asarray(ids), n,
                                    jnp.asarray(mask))
    got = getattr(t_segment, name)(torch.from_numpy(msg).to(td), torch.from_numpy(ids), n,
                                   torch.from_numpy(mask))
    assert str(got.dtype)[6:] == str(want.dtype)
    tol = 1e-6 if dtype is np.float32 else 8e-3  # std in bf16: one rounding of an f32 value
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _pna_config(gps=False, fused=None, hidden=16, layers=2):
    heads = {"graph": {"num_sharedlayers": 1, "dim_sharedlayers": 8,
                       "num_headlayers": 2, "dim_headlayers": [8, 8]},
             "node": {"num_headlayers": 2, "dim_headlayers": [8, 8], "type": "mlp"}}
    arch = {"mpnn_type": "PNA", "radius": 5.0, "max_neighbours": 10, "hidden_dim": hidden,
            "num_conv_layers": layers, "use_sorted_aggregation": True,
            "task_weights": [1.0, 1.0], "output_heads": heads}
    if gps:
        arch.update(global_attn_engine="GPS", global_attn_type="multihead",
                    global_attn_heads=2, pe_dim=4, dropout=0.0)
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


def _splits(pe=False):
    graphs = oc20_shaped_dataset(16, mean_atoms=20, min_atoms=10, max_atoms=40,
                                 max_neighbours=10)
    if pe:
        from hydragnn_tpu_torch.data import add_dataset_pe

        graphs = add_dataset_pe(graphs, 4)
    return split_dataset(graphs, 0.75, seed=0)


def pytest_degree_histogram_matches_jax():
    tr, _, _ = _splits()
    assert degree_histogram(tr) == j_degree_histogram(tr)


@pytest.mark.parametrize("gps", [False, True])
def pytest_update_config_pna_and_gps_fields_match_jax(gps):
    tr, va, te = _splits(pe=gps)
    cfg = _pna_config(gps=gps)
    jc = j_update(copy.deepcopy(cfg), tr, va, te)["NeuralNetwork"]["Architecture"]
    tc = t_update(copy.deepcopy(cfg), tr, va, te)["NeuralNetwork"]["Architecture"]
    keys = ("pna_deg", "max_neighbours", "global_attn_engine", "global_attn_type",
            "global_attn_heads", "pe_dim", "max_nodes_per_graph", "use_flash_attention",
            "use_fused_edge_kernel", "max_in_degree", "input_dim")
    assert {k: tc[k] for k in keys} == {k: jc[k] for k in keys}
    assert tc["max_neighbours"] == len(tc["pna_deg"]) - 1 != 10  # overwritten from the data
    if not gps:
        assert tc["global_attn_engine"] is None and tc["use_flash_attention"] is False


@pytest.mark.parametrize("fused", [True, False])
def pytest_pna_matches_jax_on_bridged_weights(monkeypatch, fused):
    """PNA without attention: the multi-moment route (fused) and the dense
    route, the JAX side with its Pallas routes forced (interpret mode)."""
    monkeypatch.setenv("HYDRAGNN_PALLAS_SEGMENT", "1")
    tr, va, te = _splits()
    cfg = _pna_config(fused=fused)
    jc = j_update(copy.deepcopy(cfg), tr, va, te)
    tc = t_update(copy.deepcopy(cfg), tr, va, te)
    jb = next(iter(JLoader(tr, 4, sort_edges=True)))
    tb = next(iter(TLoader(tr, 4, sort_edges=True)))
    jm = j_create(jc)
    v = _jax_variables(jm, jb)
    tm = t_create(tc, device="cpu")
    load_jax_variables(tm, v)
    assert all(c.multi_agg is fused for c in tm.graph_convs)
    with torch.no_grad():
        tout = tm(tb)
    _assert_close_real_rows(jm.apply(v, jb, train=False), tout, tb)
