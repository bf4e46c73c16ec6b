"""The port's load-time transforms and Laplacian-PE cache against the JAX
package's, on the CPU.

- Each transform (rotational normalization with its shifts, cell and
  forces; edge lengths; the global-max normalization; spherical
  coordinates; the estimated normals and point-pair features) and the whole
  chain over three splits that share one edge-length max: the same graphs
  as the JAX package's, bit for bit (both are the same numpy arithmetic).
- The completed config's edge width, and a model built from it that takes
  the JAX weights and gives the JAX forward within 1e-4 of each head's
  largest value (tests/test_torch_egnn.py's ``RTOL``, the forces tolerance
  of tests/test_torch_train.py).
- ``prepare_data`` on explicit datasets with transforms: the same batches
  as the JAX package's, edge attributes included.
- The PE cache: a hit equals a fresh computation bit for bit, an entry
  either package wrote is read by the other (the same sha256 key and
  ``.npy`` layout), a corrupt entry is computed again, and the environment
  override resolves as in the JAX package.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax

from hydragnn_tpu.api import prepare_data as j_prepare
from hydragnn_tpu.config import update_config as j_update
from hydragnn_tpu.data import GraphLoader as JLoader
from hydragnn_tpu.data import lappe as jlappe
from hydragnn_tpu.data import transforms as jtr
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu_torch.api import prepare_data as t_prepare
from hydragnn_tpu_torch.bridge import load_jax_variables
from hydragnn_tpu_torch.config import update_config as t_update
from hydragnn_tpu_torch.data import GraphLoader as TLoader
from hydragnn_tpu_torch.data import lappe as tlappe
from hydragnn_tpu_torch.data import oc20_shaped_dataset, split_dataset
from hydragnn_tpu_torch.data import transforms as ttr
from hydragnn_tpu_torch.models import create_model as t_create
from test_torch_data import _assert_batch_equal, _assert_graphs_equal
from test_torch_egnn import _assert_close_real_rows
from test_torch_zoo import _config as zoo_config
from test_torch_zoo import _jax_init

torch.set_num_threads(2)

ALL = {"rotational_invariance": True, "edge_features": ["lengths"],
       "Descriptors": {"SphericalCoordinates": True, "PointPairFeatures": True}}
CHAINS = [{"rotational_invariance": True}, {"edge_features": ["lengths"]},
          {"Descriptors": {"SphericalCoordinates": True}},
          {"Descriptors": {"PointPairFeatures": True}}, ALL]


def _graphs(n=9, periodic=False):
    """OC20-shaped graphs (edges, forces), with a cubic cell and periodic
    shifts drawn from a seed when ``periodic``."""
    graphs = oc20_shaped_dataset(n, mean_atoms=14, min_atoms=8, max_atoms=24, max_neighbours=8,
                                 seed=7)
    if not periodic:
        return graphs
    rng = np.random.default_rng(8)
    return [dataclasses.replace(
        g, cell=(9.0 * np.eye(3)).astype(np.float32),
        edge_shifts=(9.0 * rng.integers(-1, 2, size=(g.num_edges, 3))).astype(np.float32))
        for g in graphs]


@pytest.mark.parametrize("periodic", [False, True])
def pytest_each_transform_matches_jax(periodic):
    graphs = _graphs(periodic=periodic)
    for g in graphs:
        np.testing.assert_array_equal(ttr.principal_rotation(g.pos), jtr.principal_rotation(g.pos))
        np.testing.assert_array_equal(
            ttr.estimate_normals(g.pos, g.senders, g.receivers, g.edge_shifts),
            jtr.estimate_normals(g.pos, g.senders, g.receivers, g.edge_shifts))
    for name in ("normalize_rotation", "add_edge_lengths", "add_spherical_descriptors",
                 "add_point_pair_features"):
        _assert_graphs_equal([getattr(jtr, name)(g) for g in graphs],
                             [getattr(ttr, name)(g) for g in graphs])
    with_len = [ttr.add_edge_lengths(g) for g in graphs]
    assert ttr.global_max_edge_attr(with_len) == jtr.global_max_edge_attr(with_len)
    _assert_graphs_equal(jtr.normalize_edge_attr(with_len), ttr.normalize_edge_attr(with_len))
    _assert_graphs_equal(jtr.normalize_edge_attr(with_len, 2.5),
                         ttr.normalize_edge_attr(with_len, 2.5))
    # the rotation turns the forces and keeps the edge displacements' lengths
    g, r = graphs[0], ttr.normalize_rotation(graphs[0])
    _, before = ttr._graph_edge_geometry(g)
    _, after = ttr._graph_edge_geometry(r)
    np.testing.assert_allclose(after, before, rtol=1e-5)
    assert not np.array_equal(r.node_targets["forces"], g.node_targets["forces"])


@pytest.mark.parametrize("ds", CHAINS)
def pytest_transform_chain_over_three_splits_matches_jax(ds):
    """The chain over three splits (one edge-length max over all of them):
    JAX's graphs; the widths the config declares."""
    splits = split_dataset(_graphs(12, periodic=True), 0.5, seed=1)
    got = ttr.apply_dataset_transforms(ds, *splits)
    want = jtr.apply_dataset_transforms(ds, *splits)
    assert [len(s) for s in got] == [len(s) for s in splits]
    for a, b in zip(want, got):
        _assert_graphs_equal(a, b)
    assert ttr.descriptor_edge_dim(ds) == jtr.descriptor_edge_dim(ds)
    assert ttr.wants_transforms(ds) == jtr.wants_transforms(ds) is True
    width = ttr.descriptor_edge_dim(ds)
    assert all((g.edge_attr is None) if width == 0 else g.edge_attr.shape[1] == width
               for s in got for g in s)
    if ds.get("edge_features"):  # one global max: the largest length is 1
        assert max(float(g.edge_attr[:, 0].max()) for s in got for g in s) == 1.0


def pytest_stored_edge_columns_must_match_the_declaration():
    graphs = _graphs(3)
    for mod in (jtr, ttr):
        with pytest.raises(ValueError, match="stored column"):
            mod.apply_post_edge_transforms(graphs, {"edge_features": ["lengths", "bond"]})
    stored = [dataclasses.replace(g, edge_attr=np.ones((g.num_edges, 1), np.float32))
              for g in graphs]
    ds = {"edge_features": ["bond", "lengths"]}
    _assert_graphs_equal(jtr.apply_post_edge_transforms(stored, ds),
                         ttr.apply_post_edge_transforms(stored, ds))


@pytest.mark.parametrize("model", ["PNA", "EGNN"])
def pytest_model_from_a_transform_config_takes_jax_weights(model):
    """A config with every transform: the completed edge width (1 length + 3
    spherical + 4 PPF columns) equals JAX's, and the model built from it
    takes the JAX weights and gives the JAX forward within 1e-4 of each
    head's largest value on real rows."""
    splits = ttr.apply_dataset_transforms(
        ALL, *split_dataset(_graphs(16), 0.75, seed=0))
    cfg = zoo_config(model)
    cfg["Dataset"].update(copy.deepcopy(ALL))
    jc = j_update(copy.deepcopy(cfg), *splits)
    tc = t_update(copy.deepcopy(cfg), *splits)
    assert tc["NeuralNetwork"]["Architecture"]["edge_dim"] == \
        jc["NeuralNetwork"]["Architecture"]["edge_dim"] == 8
    jb = next(iter(JLoader(splits[0], 4, sort_edges=True)))
    tb = next(iter(TLoader(splits[0], 4, sort_edges=True)))
    jm = j_create(jc)
    v = _jax_init(jm, jb)
    tm = t_create(tc, device="cpu")
    load_jax_variables(tm, v)
    with torch.no_grad():
        tout = tm(tb.to("cpu"))
    _assert_close_real_rows(jax.device_get(jm.apply(v, jb, train=False)), tout, tb)


@pytest.mark.parametrize("ds", [{"rotational_invariance": True}, ALL])
def pytest_prepare_data_applies_transforms_to_explicit_datasets(ds):
    """``prepare_data`` on explicit datasets with load-time transforms: the
    same completed edge width and the same batches as the JAX package's."""
    splits = split_dataset(_graphs(12), 0.5, seed=2)
    cfg = zoo_config("PNA")
    cfg["Dataset"].update(copy.deepcopy(ds))
    jc, jl, _ = j_prepare(copy.deepcopy(cfg), splits)
    tc, tl, _ = t_prepare(copy.deepcopy(cfg), splits)
    assert tc["NeuralNetwork"]["Architecture"]["edge_dim"] == \
        jc["NeuralNetwork"]["Architecture"]["edge_dim"]
    for a, b in zip(jl, tl):
        ja, tb = list(a), list(b)
        assert len(ja) == len(tb) > 0
        for x, y in zip(ja, tb):
            _assert_batch_equal(x, y)
            if x.edge_attr is None:
                assert y.edge_attr is None
            else:
                np.testing.assert_array_equal(np.asarray(x.edge_attr), y.edge_attr.numpy())


def pytest_lappe_cache_hit_equals_fresh_across_packages(tmp_path):
    """A cache hit equals a fresh computation bit for bit; both packages key
    a topology alike, so an entry one wrote is the other's hit; a corrupt
    or wrong-shape entry is computed again."""
    g = _graphs(1)[0]
    n, s, r = g.num_nodes, g.senders, g.receivers
    key = tlappe._topology_key(n, s, r, 4)
    assert key == jlappe._topology_key(n, s, r, 4)
    fresh = tlappe.laplacian_pe(n, s, r, 4)
    path = tmp_path / "j" / key[:2] / f"{key}.npy"
    jlappe.laplacian_pe(n, s, r, 4, cache_dir=str(tmp_path / "j"))
    assert path.is_file()
    np.save(path, np.full_like(fresh, 7.0))  # a planted entry proves the hit
    np.testing.assert_array_equal(tlappe.laplacian_pe(n, s, r, 4, cache_dir=str(tmp_path / "j")),
                                  np.full_like(fresh, 7.0))
    got = tlappe.laplacian_pe(n, s, r, 4, cache_dir=str(tmp_path / "t"))
    hit = tlappe.laplacian_pe(n, s, r, 4, cache_dir=str(tmp_path / "t"))
    jhit = jlappe.laplacian_pe(n, s, r, 4, cache_dir=str(tmp_path / "t"))
    for a in (got, hit, jhit):
        np.testing.assert_array_equal(a, fresh)
        assert a.dtype == np.float32
    tpath = tmp_path / "t" / key[:2] / f"{key}.npy"
    tpath.write_bytes(b"not an array")
    np.testing.assert_array_equal(tlappe.laplacian_pe(n, s, r, 4, cache_dir=str(tmp_path / "t")),
                                  fresh)
    np.testing.assert_array_equal(np.load(tpath), fresh)  # written again
    _assert_graphs_equal(jlappe.add_dataset_pe([g], 4, cache=str(tmp_path / "d")),
                         tlappe.add_dataset_pe([g], 4, cache=str(tmp_path / "d")))


@pytest.mark.parametrize("env", [None, "0", "off", "1", "/tmp/elsewhere"])
def pytest_lappe_cache_dir_resolves_as_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("HYDRAGNN_LAPPE_CACHE", raising=False)
    else:
        monkeypatch.setenv("HYDRAGNN_LAPPE_CACHE", env)
    for cache in (True, False, None, "cache/here"):
        assert tlappe.resolve_cache_dir(cache) == jlappe.resolve_cache_dir(cache)
