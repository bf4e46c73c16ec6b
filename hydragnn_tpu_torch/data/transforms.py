"""Load-time geometric transforms: rotational normalization, edge lengths
normalized by one global max, spherical coordinates and point-pair
features.

Counterpart of ``hydragnn_tpu/data/transforms.py``, host-side numpy run
once per sample, in the JAX package's order:

  1. ``normalize_rotation``        (``Dataset.rotational_invariance``)
  2. radius graph                  (data/neighbors.py)
  3. ``add_edge_lengths``          (``Dataset.edge_features: ["lengths"]``)
  4. ``normalize_edge_attr``       (divided by the max over every split)
  5. ``add_spherical_descriptors`` / ``add_point_pair_features``
                                   (``Dataset.Descriptors``)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .graph import Graph
from .neighbors import edge_vectors_and_lengths

# ---------------------------------------------------------------------------
# rotational normalization
# ---------------------------------------------------------------------------


def principal_rotation(pos: np.ndarray) -> np.ndarray:
    """Rotation onto the principal axes of a point set: the eigenvectors
    (ascending eigenvalues) of the centered scatter matrix, each sign fixed
    by a fixed pseudo-random odd functional of the projected coordinates
    (the largest ``|projection|`` where that cancels). A degenerate spectrum
    keeps an arbitrary basis of its subspace."""
    pos = np.asarray(pos, np.float64)
    centered = pos - pos.mean(axis=0, keepdims=True)
    _, vecs = np.linalg.eigh(centered.T @ centered)  # columns, ascending
    proj = centered @ vecs
    # a rotation of the input flips each projected column at most globally,
    # so any odd functional fixes the sign; a pseudo-random weighting stays
    # clear of the exact ties that symmetric lattices give an argmax
    weights = np.cos(1.0 + np.arange(proj.shape[0], dtype=np.float64))
    for c in range(proj.shape[1]):
        col = proj[:, c]
        s = float(weights @ col)
        if abs(s) <= 1e-9 * (np.linalg.norm(col) + 1e-30):
            s = float(col[int(np.argmax(np.abs(col)))])
        if s < 0:
            vecs[:, c] = -vecs[:, c]
    return vecs


# node targets that are cartesian vectors and turn with the geometry
_VECTOR_NODE_TARGETS = ("forces",)


def normalize_rotation(graph: Graph) -> Graph:
    """One graph in its canonical frame: positions, periodic shifts, the
    cell and vector node targets (forces) turn by the same matrix, so edge
    displacements and ``F = -dE/dpos`` hold before or after edges exist."""
    rot = principal_rotation(graph.pos)
    rep = {"pos": (np.asarray(graph.pos, np.float64) @ rot).astype(np.float32)}
    if graph.edge_shifts is not None:
        rep["edge_shifts"] = (np.asarray(graph.edge_shifts, np.float64) @ rot).astype(np.float32)
    if graph.cell is not None:
        rep["cell"] = (np.asarray(graph.cell, np.float64) @ rot).astype(np.float32)
    if graph.node_targets:
        nt = dict(graph.node_targets)
        for key in _VECTOR_NODE_TARGETS:
            if key in nt and nt[key].shape[-1] == 3:
                nt[key] = (np.asarray(nt[key], np.float64) @ rot).astype(np.float32)
        rep["node_targets"] = nt
    return dataclasses.replace(graph, **rep)


# ---------------------------------------------------------------------------
# edge lengths and the global-max normalization
# ---------------------------------------------------------------------------


def _cat_edge_attr(graph: Graph, cols: np.ndarray) -> Graph:
    cols = np.asarray(cols, np.float32)
    attr = cols if graph.edge_attr is None else np.concatenate(
        [np.asarray(graph.edge_attr, np.float32), cols], axis=1)
    return dataclasses.replace(graph, edge_attr=attr)


def _graph_edge_geometry(graph: Graph):
    """(vec, length) of a graph's edges, shift-aware."""
    return edge_vectors_and_lengths(graph.pos, graph.senders, graph.receivers,
                                    graph.edge_shifts)


def add_edge_lengths(graph: Graph, vec_length=None) -> Graph:
    """The edge length appended as an edge-attribute column (periodic
    shifts honored)."""
    _, length = vec_length if vec_length is not None else _graph_edge_geometry(graph)
    return _cat_edge_attr(graph, length[:, None])


def global_max_edge_attr(graphs: Sequence[Graph]) -> float:
    """The largest ``edge_attr`` entry over ``graphs`` (one host: the JAX
    package also reduces it over its processes)."""
    local = float("-inf")
    for g in graphs:
        if g.edge_attr is not None and g.edge_attr.size:
            local = max(local, float(np.max(g.edge_attr)))
    return local


def normalize_edge_attr(graphs: Sequence[Graph],
                        max_value: Optional[float] = None) -> List[Graph]:
    """Every graph's whole ``edge_attr`` divided by the global max entry."""
    if max_value is None:
        max_value = global_max_edge_attr(graphs)
    if not np.isfinite(max_value) or max_value == 0.0:
        return list(graphs)
    return [dataclasses.replace(g, edge_attr=np.asarray(g.edge_attr, np.float32) / max_value)
            if g.edge_attr is not None else g for g in graphs]


# ---------------------------------------------------------------------------
# spherical coordinates
# ---------------------------------------------------------------------------


def add_spherical_descriptors(graph: Graph, rho_max: Optional[float] = None,
                              vec_length=None) -> Graph:
    """Per-edge ``[rho, theta, phi]`` appended: rho the length over the
    graph's largest (or ``rho_max``), theta the azimuth over 2 pi in
    [0, 1], phi the inclination over pi; sender -> receiver, shift-aware."""
    vec, length = vec_length if vec_length is not None else _graph_edge_geometry(graph)
    rho = length.copy()
    scale = rho_max if rho_max is not None else (np.max(rho) if rho.size else 1.0)
    if scale > 0:
        rho = rho / scale
    theta = np.arctan2(vec[:, 1], vec[:, 0])
    theta = (theta + (theta < 0) * (2.0 * np.pi)) / (2.0 * np.pi)
    with np.errstate(invalid="ignore", divide="ignore"):
        phi = np.arccos(np.clip(vec[:, 2] / np.maximum(length, 1e-12), -1.0, 1.0))
    return _cat_edge_attr(graph, np.stack([rho, theta, phi / np.pi], axis=1))


# ---------------------------------------------------------------------------
# point-pair features
# ---------------------------------------------------------------------------


def estimate_normals(pos: np.ndarray, senders: np.ndarray, receivers: np.ndarray,
                     edge_shifts: Optional[np.ndarray] = None,
                     vec: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-node unit normals from local-neighborhood PCA: the
    smallest-variance direction of the (shift-aware) displacements to the
    node's in-neighbors, with a deterministic, rotation-stable sign; a
    node with fewer than 2 in-edges gets the z unit vector."""
    n = pos.shape[0]
    normals = np.zeros((n, 3), np.float64)
    normals[:, 2] = 1.0
    if senders.size == 0:
        return normals.astype(np.float32)
    pos = np.asarray(pos, np.float64)
    if vec is None:
        vec, _ = edge_vectors_and_lengths(pos, senders, receivers, edge_shifts)
    # displacements node -> neighbor image, grouped by (receiver, sender)
    disp_all = -np.asarray(vec, np.float64)
    order = np.lexsort((senders, receivers))
    r_sorted = receivers[order]
    disp_sorted = disp_all[order]
    starts = np.searchsorted(r_sorted, np.arange(n), side="left")
    ends = np.searchsorted(r_sorted, np.arange(n), side="right")
    for i in range(n):
        disp = disp_sorted[starts[i]:ends[i]]
        if disp.shape[0] < 2:
            continue
        _, vecs = np.linalg.eigh(disp.T @ disp)
        nrm = vecs[:, 0]  # the smallest-variance direction
        # the sign: an odd functional of the displacements projected on the
        # normal (neighbors in node order, so it flips with the normal under
        # any rotation), the next weighting where one cancels
        proj = disp @ nrm
        scale = np.linalg.norm(proj) + 1e-30
        s = 0.0
        if np.linalg.norm(proj) > 1e-6 * np.linalg.norm(disp):
            for k in (1.0, 2.0, 3.0):
                cand = float(np.cos(k * (1.0 + np.arange(proj.size))) @ proj)
                if abs(cand) > 1e-6 * scale:
                    s = cand
                    break
        if s == 0.0:
            # a coplanar neighborhood: det(d_a, d_b, n) is odd in n and
            # invariant under proper rotations
            for a in range(disp.shape[0] - 1):
                cand = float(np.dot(np.cross(disp[a], disp[a + 1]), nrm))
                if abs(cand) > 1e-9 * (np.linalg.norm(disp[a]) * np.linalg.norm(disp[a + 1])
                                       + 1e-30):
                    s = cand
                    break
            else:
                s = 1.0
        if s > 0:
            nrm = -nrm
        normals[i] = nrm
    return normals.astype(np.float32)


def _angle(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.arctan2(np.linalg.norm(np.cross(a, b), axis=1), np.sum(a * b, axis=1))


def add_point_pair_features(graph: Graph, normals: Optional[np.ndarray] = None,
                            vec_length=None) -> Graph:
    """PPF columns ``[|d|, ang(n1, d), ang(n2, d), ang(n1, n2)]`` appended,
    the normals estimated (``estimate_normals``) where none are given."""
    vec, length = vec_length if vec_length is not None else _graph_edge_geometry(graph)
    if normals is None:
        normals = estimate_normals(graph.pos, graph.senders, graph.receivers,
                                   graph.edge_shifts, vec=vec)
    n1 = np.asarray(normals, np.float64)[graph.senders]
    n2 = np.asarray(normals, np.float64)[graph.receivers]
    cols = np.stack([length, _angle(n1, vec), _angle(n2, vec), _angle(n1, n2)], axis=1)
    return _cat_edge_attr(graph, cols)


# ---------------------------------------------------------------------------
# the config's chain
# ---------------------------------------------------------------------------


def descriptor_edge_dim(dataset_cfg: dict) -> int:
    """Edge-attribute columns the model sees: one per ``edge_features``
    entry ("lengths" computed here, any other name a column the dataset
    stores), +3 for SphericalCoordinates, +4 for PointPairFeatures."""
    dim = len(dataset_cfg.get("edge_features") or [])
    desc = dataset_cfg.get("Descriptors", {})
    if desc.get("SphericalCoordinates"):
        dim += 3
    if desc.get("PointPairFeatures"):
        dim += 4
    return dim


def wants_transforms(dataset_cfg: dict) -> bool:
    """Whether the Dataset section asks for a load-time transform
    (``rotational_invariance``, ``edge_features``, ``Descriptors``)."""
    return bool(dataset_cfg.get("rotational_invariance") or dataset_cfg.get("edge_features")
                or dataset_cfg.get("Descriptors"))


def apply_dataset_transforms(dataset_cfg: dict, *splits: Sequence[Graph]) -> List[List[Graph]]:
    """The whole chain over one or more splits, which share one edge-length
    max (taken over them all)."""
    sizes = [len(s) for s in splits]
    combined: List[Graph] = [g for s in splits for g in s]
    combined = apply_post_edge_transforms(apply_pre_edge_transforms(combined, dataset_cfg),
                                          dataset_cfg)
    out, off = [], 0
    for sz in sizes:
        out.append(combined[off:off + sz])
        off += sz
    return out


def apply_pre_edge_transforms(graphs: Sequence[Graph], dataset_cfg: dict) -> List[Graph]:
    """The transforms that come before the radius graph."""
    if dataset_cfg.get("rotational_invariance"):
        graphs = [normalize_rotation(g) for g in graphs]
    return list(graphs)


def apply_post_edge_transforms(graphs: Sequence[Graph], dataset_cfg: dict) -> List[Graph]:
    """The edge descriptors, once edges exist: ``edge_features`` (its
    "lengths" computed, the whole edge_attr then divided by the global max)
    and the ``Descriptors`` columns. Raises where a graph's stored columns
    disagree with the other names of ``edge_features``."""
    graphs = list(graphs)
    feats = dataset_cfg.get("edge_features") or []
    desc = dataset_cfg.get("Descriptors", {})
    if not (feats or desc.get("SphericalCoordinates") or desc.get("PointPairFeatures")):
        return graphs
    stored = [f for f in feats if f != "lengths"]
    for g in graphs:
        have = 0 if g.edge_attr is None else int(g.edge_attr.shape[1])
        if have != len(stored):
            raise ValueError(
                f"Dataset.edge_features declares {len(stored)} stored column(s) {stored} but "
                f"a graph carries edge_attr with {have} column(s); only 'lengths' is "
                "computed at load time")
    # the geometry serves every descriptor: positions and edges stay put
    geos = [_graph_edge_geometry(g) for g in graphs]
    if feats:
        if "lengths" in feats:
            graphs = [add_edge_lengths(g, vl) for g, vl in zip(graphs, geos)]
        graphs = normalize_edge_attr(graphs)
    if desc.get("SphericalCoordinates"):
        graphs = [add_spherical_descriptors(g, vec_length=vl) for g, vl in zip(graphs, geos)]
    if desc.get("PointPairFeatures"):
        graphs = [add_point_pair_features(g, vec_length=vl) for g, vl in zip(graphs, geos)]
    return graphs
