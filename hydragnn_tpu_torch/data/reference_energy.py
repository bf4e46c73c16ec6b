"""Per-element reference-energy regression.

Counterpart of ``hydragnn_tpu/data/reference_energy.py``: a least-squares
fit of ``E_total ~ sum_z n_z * e_z`` (atom counts times per-element
reference energies), and the residual energies after subtracting it, a
better conditioned regression target.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import Graph


def _energy_of(g: Graph) -> Tuple[float, str]:
    """(energy value, field it came from) — the ONE extraction rule shared
    by fit and subtract so both support exactly the same Graph shapes."""
    if g.graph_targets and "energy" in g.graph_targets:
        return float(g.graph_targets["energy"][0]), "graph_targets"
    if g.graph_y is not None and len(np.asarray(g.graph_y)):
        return float(np.asarray(g.graph_y)[0]), "graph_y"
    raise ValueError(
        "graph has no energy target: expected graph_targets['energy'] or a "
        "non-empty graph_y"
    )


def _composition_matrix(graphs: Sequence[Graph], species: np.ndarray):
    a = np.zeros((len(graphs), species.shape[0]), np.float64)
    index = {int(z): i for i, z in enumerate(species)}
    for row, g in enumerate(graphs):
        zs, counts = np.unique(np.asarray(g.z), return_counts=True)
        for z, c in zip(zs, counts):
            a[row, index[int(z)]] = c
    return a


def _fit_one(graphs, energies, per_atom) -> Dict[int, float]:
    if energies is None:
        energies = np.asarray([_energy_of(g)[0] for g in graphs], np.float64)
    else:
        energies = np.asarray(energies, np.float64)
    if per_atom:
        energies = energies * np.asarray([g.num_nodes for g in graphs])
    species = np.unique(np.concatenate([np.asarray(g.z) for g in graphs]))
    a = _composition_matrix(graphs, species)
    coef, *_ = np.linalg.lstsq(a, energies, rcond=None)
    return {int(z): float(e) for z, e in zip(species, coef)}


def fit_reference_energies(
    graphs: Sequence[Graph],
    energies: Optional[np.ndarray] = None,
    per_atom: bool = False,
    by_dataset: bool = False,
):
    """Least-squares per-element reference energies ``{Z: e_Z}``.

    ``energies`` defaults to each graph's energy target (the same
    extraction rule ``subtract_reference_energies`` uses). ``per_atom=True``
    treats the energies as per-atom values (multiplied back to totals
    before fitting — the energy_per_atom_linear_regression variant).

    ``by_dataset=True`` fits ONE TABLE PER ``dataset_id`` and returns
    ``{dataset_id: {Z: e_Z}}``: reference offsets differ between datasets
    computed with different DFT settings, so a shared element across
    families has no single e_Z (the reference fits per dataset for the
    same reason, examples/multidataset/energy_linear_regression.py).
    Fit on the TRAIN split only to keep held-out metrics honest.
    """
    if not graphs:
        return {}
    if not by_dataset:
        return _fit_one(graphs, energies, per_atom)
    if energies is not None:
        raise ValueError("by_dataset=True derives energies from the graphs")
    tables: Dict[int, Dict[int, float]] = {}
    ids = sorted({g.dataset_id for g in graphs})
    for ds_id in ids:
        group = [g for g in graphs if g.dataset_id == ds_id]
        tables[ds_id] = _fit_one(group, None, per_atom)
    return tables


def subtract_reference_energies(
    graphs: Sequence[Graph],
    table,
    per_atom: bool = False,
) -> List[Graph]:
    """Replace each graph's energy target with the residual after removing
    ``sum_z n_z e_z`` (elements missing from the table contribute 0).

    ``table`` is either a flat ``{Z: e_Z}`` or the ``by_dataset`` form
    ``{dataset_id: {Z: e_Z}}`` (a graph whose dataset_id has no table is
    passed through unchanged). The residual is written back to the field
    the energy came from; ``per_atom=True`` divides the offset by the atom
    count, matching per-atom targets."""
    nested = bool(table) and isinstance(next(iter(table.values())), dict)
    out = []
    for g in graphs:
        t = table.get(g.dataset_id) if nested else table
        if not t:
            out.append(g)
            continue
        e, field = _energy_of(g)
        zs, counts = np.unique(np.asarray(g.z), return_counts=True)
        offset = float(
            sum(t.get(int(z), 0.0) * int(c) for z, c in zip(zs, counts))
        )
        resid = e - (offset / g.num_nodes if per_atom else offset)
        if field == "graph_targets":
            tgt = dict(g.graph_targets)
            tgt["energy"] = np.asarray([resid], np.float32)
            out.append(dataclasses.replace(g, graph_targets=tgt))
        else:
            gy = np.asarray(g.graph_y, np.float32).copy()
            gy[0] = resid
            out.append(dataclasses.replace(g, graph_y=gy))
    return out
