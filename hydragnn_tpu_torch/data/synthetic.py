"""Deterministic synthetic datasets (numpy only).

Counterpart of ``hydragnn_tpu/data/synthetic.py`` for the generators the
port's slices use; for the same seed both packages return the same arrays.

- ``deterministic_graph_dataset``: BCC configurations with closed-form
  targets (the CI fixture);
- ``oc20_shaped_dataset``: OC20-S2EF-shaped slabs (lognormal sizes with mean
  ~73 atoms clipped to [20, 225], FCC packing, capped ~20-degree radius
  graphs, Lennard-Jones energy and force targets) — the serving main path;
- ``bcc_supercell``: one periodic BCC supercell (the mesoscale example's
  spanning graph) — the SP evaluation path;
- ``md17_shaped_dataset``: thermal perturbations of one 21-atom
  (aspirin-composition) molecule with Lennard-Jones energy and force
  targets — the MD17 energy-force recipe (examples/md17);
- ``lennard_jones_dataset``: perturbed cubic lattices with exact
  Lennard-Jones energies and forces (examples/LennardJones);
- ``qm9_shaped_dataset`` and ``mptrj_shaped_dataset``: QM9-shaped
  molecules and MPTrj-shaped periodic crystals (examples/qm9,
  examples/mptrj), with the shared geometry helpers ``grow_molecule`` and
  ``supercell_frac`` that data/shaped.py builds on.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .graph import Graph
from .neighbors import radius_graph, radius_graph_pbc


def knn_average(pos: np.ndarray, values: np.ndarray, k: int) -> np.ndarray:
    """Average of the k nearest samples (incl. self)."""
    from scipy.spatial import cKDTree

    _, idx = cKDTree(pos).query(pos, k=k)
    if k == 1:
        idx = idx[:, None]
    return values[idx].mean(axis=1)


def bcc_positions(uc_x: int, uc_y: int, uc_z: int) -> np.ndarray:
    """Body-centered-cubic positions: corner + center atom per unit cell."""
    corners = np.array(
        [(x, y, z) for x in range(uc_x) for y in range(uc_y) for z in range(uc_z)],
        np.float64,
    )
    pos = np.empty((2 * corners.shape[0], 3), np.float64)
    pos[0::2] = corners
    pos[1::2] = corners + 0.5
    return pos


def deterministic_graph_dataset(
    number_configurations: int = 500,
    unit_cell_x_range: Sequence[int] = (1, 3),
    unit_cell_y_range: Sequence[int] = (1, 3),
    unit_cell_z_range: Sequence[int] = (1, 2),
    number_types: int = 3,
    types: Optional[Sequence[int]] = None,
    number_neighbors: int = 2,
    linear_only: bool = False,
    radius: float = 2.0,
    max_neighbours: int = 100,
    seed: int = 97,
) -> List[Graph]:
    """BCC configurations with node table ``[type, out2, out3]`` and graph
    target ``sum(out1) + sum(out2) + sum(out3)`` (``linear_only``: node
    table ``[type]``, target ``sum(type)``)."""
    if types is None:
        types = list(range(number_types))
    rng = np.random.default_rng(seed)
    graphs: List[Graph] = []
    for _ in range(number_configurations):
        uc = (
            rng.integers(unit_cell_x_range[0], unit_cell_x_range[1]),
            rng.integers(unit_cell_y_range[0], unit_cell_y_range[1]),
            rng.integers(unit_cell_z_range[0], unit_cell_z_range[1]),
        )
        graphs.append(
            _configuration(rng, uc, types, number_neighbors, linear_only, radius, max_neighbours)
        )
    return graphs


def _configuration(rng, uc, types, number_neighbors, linear_only, radius, max_neighbours):
    """One BCC configuration of ``uc`` unit cells with its closed-form
    targets (``deterministic_graph_dataset``'s sample)."""
    pos = bcc_positions(*uc)
    n = pos.shape[0]
    node_type = rng.integers(min(types), max(types) + 1, (n, 1)).astype(np.float64)
    out1 = node_type.copy() if linear_only else knn_average(pos, node_type, number_neighbors)
    out2 = out1**2 + node_type
    out3 = out1**3
    if linear_only:
        total = out1.sum(keepdims=False)
        x_table = node_type.astype(np.float32)
    else:
        total = out1.sum() + out2.sum() + out3.sum()
        # columns as ci.json selects them: [type, out2, out3]
        x_table = np.concatenate([node_type, out2, out3], axis=1).astype(np.float32)
    senders, receivers = radius_graph(pos, radius, max_neighbours)
    return Graph(
        x=x_table,
        pos=pos.astype(np.float32),
        senders=senders,
        receivers=receivers,
        graph_y=np.asarray([float(total)], np.float32),
        z=node_type[:, 0].astype(np.int32),
    )


def grow_molecule(rng, n: int, lo: float = 1.0, hi: float = 1.9,
                  step: float = 1.5, max_tries: int = 8000) -> np.ndarray:
    """Bonded-molecule geometry by rejection sampling at covalent distances:
    each new atom anchors off a random placed atom and must land within
    [lo, hi] of its nearest neighbour (the molecular generators' geometry:
    qm9 here; ani1x, qm7x, transition1x, omol25 and uv in data/shaped.py)."""
    pos = np.zeros((n, 3))
    placed, tries = 1, 0
    while placed < n and tries < max_tries:
        tries += 1
        anchor = pos[int(rng.integers(placed))]
        cand = anchor + rng.normal(0.0, 1.0, 3) * step
        d = np.linalg.norm(pos[:placed] - cand, axis=1)
        if d.min() > lo and d.min() < hi:
            pos[placed] = cand
            placed += 1
    return pos[:placed]


def supercell_frac(basis: np.ndarray, reps: int) -> np.ndarray:
    """Fractional coordinates of a ``reps^3`` supercell of ``basis`` (one
    row per atom, x-major cell order): the periodic generators' lattice
    (mptrj here; alexandria, omat24 and eam in data/shaped.py)."""
    cells = np.array([(x, y, z) for x in range(reps) for y in range(reps) for z in range(reps)],
                     np.float64)
    return (cells[:, None, :] + basis[None, :, :]).reshape(-1, 3) / reps


def _symmetrize_edges(senders: np.ndarray, receivers: np.ndarray):
    """Every pair in both directions (Newton's third law for the LJ
    targets), in sorted pair order."""
    pairs = set(zip(senders.tolist(), receivers.tolist()))
    pairs |= {(i, j) for (j, i) in pairs}
    s, r = zip(*sorted(pairs))
    return np.asarray(s, np.int32), np.asarray(r, np.int32)


def _lj_targets(pos, senders, receivers, epsilon: float, sigma: float, shifts=None):
    """Lennard-Jones total energy and per-atom forces over the edge list:
    half the pair energy per directed edge, forces the exact gradient;
    ``shifts`` makes the displacements periodic."""
    diff = pos[receivers] - pos[senders]
    if shifts is not None:
        diff = diff - shifts
    r = np.linalg.norm(diff, axis=1)
    s6 = (sigma / r) ** 6
    s12 = s6**2
    energy = float(np.sum(0.5 * 4.0 * epsilon * (s12 - s6)))
    coef = 0.5 * 24.0 * epsilon * (2.0 * s12 - s6) / r**2
    forces = np.zeros_like(pos)
    np.add.at(forces, receivers, coef[:, None] * diff)
    np.add.at(forces, senders, -coef[:, None] * diff)
    return energy, forces


def oc20_shaped_dataset(
    number_configurations: int = 64,
    mean_atoms: float = 73.0,
    min_atoms: int = 20,
    max_atoms: int = 225,
    radius: float = 5.0,
    max_neighbours: int = 20,
    lattice_constant: float = 3.8,
    jitter: float = 0.12,
    seed: int = 42,
) -> List[Graph]:
    """OC20-S2EF-shaped workload: node table ``[Z, x, y, z]``, graph target
    ``energy`` (per atom), node target ``forces``."""
    rng = np.random.default_rng(seed)
    mu = np.log(mean_atoms) - 0.35**2 / 2.0
    zs = np.array([1, 6, 8, 13, 26, 29, 46, 78])  # adsorbate + catalyst metals
    a = lattice_constant
    basis = np.array(
        [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]], np.float64
    )
    sigma = a / np.sqrt(2.0) / 2.0 ** (1.0 / 6.0)  # LJ minimum at the nn distance
    graphs: List[Graph] = []
    for _ in range(number_configurations):
        n = int(np.clip(rng.lognormal(mu, 0.35), min_atoms, max_atoms))
        side = int(np.ceil((n / 4.0) ** (1.0 / 3.0))) + 1
        cells = np.array(
            [(x, y, z) for z in range(side) for y in range(side) for x in range(side)],
            np.float64,
        )
        pos = (cells[:, None, :] + basis[None, :, :]).reshape(-1, 3) * a
        pos = pos[:n] + rng.uniform(-jitter, jitter, (n, 3))
        senders, receivers = radius_graph(pos, radius, max_neighbours)
        senders, receivers = _symmetrize_edges(senders, receivers)
        energy, forces = _lj_targets(pos, senders, receivers, 1.0, sigma)
        z = rng.choice(zs, size=n).astype(np.int32)
        x = np.concatenate([z[:, None].astype(np.float32), pos.astype(np.float32)], axis=1)
        graphs.append(Graph(
            x=x,
            pos=pos.astype(np.float32),
            senders=senders,
            receivers=receivers,
            graph_targets={"energy": np.asarray([energy / n], np.float32)},
            node_targets={"forces": forces.astype(np.float32)},
            z=z,
        ))
    return graphs


def bcc_supercell(cells: int, jitter: float, seed: int) -> Graph:
    """BCC supercell of ``cells``^3 unit cells (``2 * cells**3`` atoms) with
    thermal jitter, under periodic boundary conditions (radius 1.1 lattice
    constants, 12 neighbours): node table ``[x, x^2, x^3]`` and the graph
    target ``sum`` of that table. The same graph as the mesoscale example's
    ``build_supercell`` (examples/mesoscale/mesoscale.py) for the same
    arguments: one graph spanning a whole SP batch."""
    rng = np.random.default_rng(seed)
    a = 1.0
    base = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]) * a
    pos = []
    for i in range(cells):
        for j in range(cells):
            for k in range(cells):
                pos.append(base + np.array([i, j, k], float) * a)
    pos = np.concatenate(pos) + rng.normal(0.0, jitter, (2 * cells**3, 3))
    cell = np.eye(3) * (a * cells)
    senders, receivers, shifts = radius_graph_pbc(pos, cell, radius=1.1 * a, max_neighbours=12)
    x = rng.uniform(0.2, 1.0, (pos.shape[0], 1)).astype(np.float32)
    feats = np.concatenate([x, x**2, x**3], axis=1).astype(np.float32)
    target = np.asarray([feats.sum()], np.float32)
    return Graph(
        x=feats,
        pos=pos.astype(np.float32),
        senders=senders.astype(np.int32),
        receivers=receivers.astype(np.int32),
        edge_shifts=shifts.astype(np.float32),
        graph_y=target,
    )


def md17_shaped_dataset(
    number_configurations: int = 256,
    jitter: float = 0.12,
    radius: float = 5.0,
    max_neighbours: int = 32,
    seed: int = 7,
) -> List[Graph]:
    """MD17-(aspirin)-shaped workload: one fixed 21-atom molecule (C9 H8 O4)
    whose configurations are thermal perturbations of a common template,
    with Lennard-Jones energy (centred on the dataset mean) and force
    targets. Draws whose largest per-atom force component exceeds 5 are
    rejected (a thermal ensemble rarely visits the repulsive wall), so the
    force distribution stays near equilibrium; a jitter so large that
    almost every draw is rejected raises."""
    rng = np.random.default_rng(seed)
    z = np.array([6] * 9 + [1] * 8 + [8] * 4, np.int32)
    n = z.shape[0]
    # the template: min-distance rejection sampling inside a molecule-size ball
    template = np.zeros((n, 3))
    placed = 1
    while placed < n:
        cand = rng.uniform(-3.2, 3.2, 3)
        if np.linalg.norm(cand) > 3.4:
            continue
        if np.min(np.linalg.norm(template[:placed] - cand, axis=1)) > 1.25:
            template[placed] = cand
            placed += 1
    graphs: List[Graph] = []
    force_cap = 5.0
    attempts = 0
    max_attempts = 100 * number_configurations
    while len(graphs) < number_configurations:
        attempts += 1
        if attempts > max_attempts:
            raise ValueError(
                f"md17_shaped_dataset: acceptance rate {len(graphs)}/{attempts} too low "
                f"for jitter={jitter} (force cap {force_cap}); reduce jitter"
            )
        pos = template + rng.normal(0.0, jitter, (n, 3))
        senders, receivers = radius_graph(pos, radius, max_neighbours)
        senders, receivers = _symmetrize_edges(senders, receivers)
        energy, forces = _lj_targets(pos, senders, receivers, 0.2, 1.1)
        if float(np.abs(forces).max()) > force_cap:
            continue
        graphs.append(Graph(
            x=z[:, None].astype(np.float32),
            pos=pos.astype(np.float32),
            senders=senders,
            receivers=receivers,
            graph_targets={"energy": np.asarray([energy], np.float32)},
            node_targets={"forces": forces.astype(np.float32)},
            z=z.copy(),
        ))
    # reference-energy centring (forces are invariant to it)
    e_mean = float(np.mean([g.graph_targets["energy"][0] for g in graphs]))
    for g in graphs:
        g.graph_targets["energy"] = (g.graph_targets["energy"] - e_mean).astype(np.float32)
    return graphs


def qm9_shaped_dataset(
    number_configurations: int = 1000,
    radius: float = 7.0,
    max_neighbours: int = 5,
    seed: int = 0,
) -> List[Graph]:
    """QM9-shaped molecules (3-29 atoms of H/C/N/O/F, ~18 on average, the
    real benchmark's statistics): node table ``[Z]``, graph table
    ``[LJ energy per atom]`` (examples/qm9's data contract)."""
    rng = np.random.default_rng(seed)
    graphs: List[Graph] = []
    heavy_choices = np.array([6, 7, 8, 9])  # C N O F
    heavy_probs = np.array([0.72, 0.12, 0.13, 0.03])
    for _ in range(number_configurations):
        n_heavy = int(rng.integers(1, 10))  # QM9: up to 9 heavy atoms
        # at least 2 hydrogens on a lone heavy atom: every graph has edges
        n_h = int(np.clip(rng.poisson(1.3 * n_heavy), 2 if n_heavy < 2 else 0, 20))
        z = np.concatenate([rng.choice(heavy_choices, size=n_heavy, p=heavy_probs),
                            np.ones(n_h, np.int64)]).astype(np.int32)
        n = z.shape[0]
        pos = grow_molecule(rng, n)
        z = z[: pos.shape[0]]
        n = pos.shape[0]
        senders, receivers = radius_graph(pos, radius, max_neighbours)
        senders, receivers = _symmetrize_edges(senders, receivers)
        energy, _ = _lj_targets(pos, senders, receivers, 0.15, 1.2)
        graphs.append(Graph(
            x=z[:, None].astype(np.float32),
            pos=pos.astype(np.float32),
            senders=senders,
            receivers=receivers,
            graph_y=np.asarray([energy / n], np.float32),
            z=z.copy(),
        ))
    return graphs


def mptrj_shaped_dataset(
    number_configurations: int = 128,
    radius: float = 5.0,
    max_neighbours: int = 20,
    seed: int = 23,
) -> List[Graph]:
    """MPTrj-shaped periodic crystals (examples/mptrj): SC/BCC/FCC
    supercells of a random binary composition, rattled, with periodic
    radius-graph edges and their shifts, LJ energy per atom (graph) and
    forces (node) on the periodic displacements."""
    rng = np.random.default_rng(seed)
    bases = {
        "sc": np.zeros((1, 3)),
        "bcc": np.array([[0, 0, 0], [0.5, 0.5, 0.5]], np.float64),
        "fcc": np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]], np.float64),
    }
    element_pool = np.array([3, 8, 13, 14, 22, 26, 28, 29])  # Li O Al Si Ti Fe Ni Cu
    graphs: List[Graph] = []
    for _ in range(number_configurations):
        kind = ("sc", "bcc", "fcc")[int(rng.integers(3))]
        basis = bases[kind]
        a = float(rng.uniform(3.4, 4.4))
        reps = int(rng.integers(2, 4))
        frac = supercell_frac(basis, reps)
        cell = np.diag([a * reps] * 3)
        pos = frac @ cell + rng.normal(0.0, 0.08, (frac.shape[0], 3))
        n = pos.shape[0]
        zs = rng.choice(element_pool, size=2, replace=False)
        z = np.where(rng.random(n) < rng.uniform(0.2, 0.8), zs[0], zs[1]).astype(np.int32)
        senders, receivers, shifts = radius_graph_pbc(pos, cell, radius, max_neighbours)
        sigma = a / np.sqrt(2.0) / 2.0 ** (1.0 / 6.0)
        energy, forces = _lj_targets(pos, senders, receivers, 0.5, sigma, shifts=shifts)
        graphs.append(Graph(
            x=z[:, None].astype(np.float32),
            pos=pos.astype(np.float32),
            senders=senders,
            receivers=receivers,
            edge_shifts=shifts.astype(np.float32),
            cell=cell.astype(np.float32),
            graph_targets={"energy": np.asarray([energy / n], np.float32)},
            node_targets={"forces": forces.astype(np.float32)},
            z=z.copy(),
        ))
    return graphs


def lennard_jones_dataset(
    number_configurations: int = 200,
    supercell: Sequence[int] = (2, 2, 2),
    spacing: float = 1.2,
    jitter: float = 0.08,
    radius: float = 2.5,
    max_neighbours: int = 32,
    epsilon: float = 1.0,
    sigma: float = 1.0,
    seed: int = 17,
    center_energies: bool = True,
) -> List[Graph]:
    """Perturbed cubic-lattice configurations with exact Lennard-Jones
    energies (graph target ``energy``) and analytic forces (node target
    ``forces``) for energy-force training. ``center_energies`` subtracts
    the dataset-mean per-atom energy times each graph's atom count."""
    rng = np.random.default_rng(seed)
    graphs: List[Graph] = []
    for _ in range(number_configurations):
        base = np.array(
            [(x, y, z) for x in range(supercell[0]) for y in range(supercell[1])
             for z in range(supercell[2])],
            np.float64,
        )
        pos = base * spacing + rng.uniform(-jitter, jitter, base.shape)
        senders, receivers = radius_graph(pos, radius, max_neighbours)
        senders, receivers = _symmetrize_edges(senders, receivers)
        energy, forces = _lj_targets(pos, senders, receivers, epsilon, sigma)
        graphs.append(Graph(
            x=np.ones((pos.shape[0], 1), np.float32),
            pos=pos.astype(np.float32),
            senders=senders,
            receivers=receivers,
            graph_targets={"energy": np.asarray([energy], np.float32)},
            node_targets={"forces": forces.astype(np.float32)},
            z=np.ones((pos.shape[0],), np.int32),
        ))
    if center_energies:
        e_per_atom = float(np.mean([g.graph_targets["energy"][0] / g.num_nodes for g in graphs]))
        for g in graphs:
            g.graph_targets["energy"] = (
                g.graph_targets["energy"] - e_per_atom * g.num_nodes
            ).astype(np.float32)
    return graphs
