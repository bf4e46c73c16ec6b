"""Shaped dataset generators for the remaining example families.

Counterpart of ``hydragnn_tpu/data/shaped.py``: for the same seed both
packages return the same arrays, byte for byte. The example families'
datasets (ANI-1x, QM7-X, Transition1x, Alexandria, OMat24, OMol25, ODAC23,
ZINC, DFTB UV spectra, NiNb EAM) are multi-GB downloads; each gets a
shaped generator here: a synthetic dataset with the real one's size,
composition and degree statistics and physically consistent closed-form
targets, so the example drivers (examples/ani1_x, examples/qm7x,
examples/transition1x, examples/alexandria, examples/open_materials_2024,
examples/open_molecules_2025, examples/open_direct_air_capture_2023,
examples/eam, examples/dftb_uv_spectrum, examples/zinc) exercise the
training path the real data would.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .graph import Graph
from .neighbors import radius_graph, radius_graph_pbc
from .synthetic import (
    _lj_targets,
    _symmetrize_edges,
    grow_molecule as _grow_molecule,
    supercell_frac,
)

# electronegativity table (Pauling) for the charge-like closed-form targets
_EN = {1: 2.20, 6: 2.55, 7: 3.04, 8: 3.44, 9: 3.98, 16: 2.58, 17: 3.16,
       3: 0.98, 11: 0.93, 13: 1.61, 14: 1.90, 15: 2.19, 19: 0.82, 20: 1.00,
       22: 1.54, 25: 1.55, 26: 1.83, 28: 1.91, 29: 1.90, 30: 1.65,
       34: 2.55, 35: 2.96, 41: 1.60, 53: 2.66}


def _en_of(z: np.ndarray) -> np.ndarray:
    return np.asarray([_EN.get(int(v), 1.8) for v in z], np.float64)


def _molecule_forces_family(
    number_configurations: int,
    heavy_choices: Sequence[int],
    heavy_probs: Sequence[float],
    n_heavy_range: Sequence[int],
    h_rate: float,
    radius: float,
    max_neighbours: int,
    seed: int,
    epsilon: float = 0.2,
    sigma: float = 1.2,
    per_atom_energy: bool = False,
) -> List[Graph]:
    """Shared builder for the molecular energy+force families: variable-size
    organic molecules, LJ energy (graph) + forces (node), node feature table
    ``[Z, fx, fy, fz]`` so force targets are selectable as table columns
    (the reference's packed-y convention) *and* ride ``node_targets`` for the
    ``compute_grad_energy`` path."""
    rng = np.random.default_rng(seed)
    heavy_choices = np.asarray(heavy_choices)
    heavy_probs = np.asarray(heavy_probs, np.float64)
    heavy_probs = heavy_probs / heavy_probs.sum()
    graphs: List[Graph] = []
    for _ in range(number_configurations):
        n_heavy = int(rng.integers(n_heavy_range[0], n_heavy_range[1] + 1))
        n_h = int(np.clip(rng.poisson(h_rate * n_heavy),
                          2 if n_heavy < 2 else 0, 3 * n_heavy + 2))
        z = np.concatenate([
            rng.choice(heavy_choices, size=n_heavy, p=heavy_probs),
            np.ones(n_h, np.int64),
        ]).astype(np.int32)
        pos = _grow_molecule(rng, z.shape[0])
        z = z[: pos.shape[0]]
        n = pos.shape[0]
        senders, receivers = radius_graph(pos, radius, max_neighbours)
        senders, receivers = _symmetrize_edges(senders, receivers)
        energy, forces = _lj_targets(pos, senders, receivers, epsilon, sigma)
        if per_atom_energy:
            energy = energy / n
        x = np.concatenate(
            [z[:, None].astype(np.float32), forces.astype(np.float32)], axis=1
        )
        graphs.append(Graph(
            x=x,
            pos=pos.astype(np.float32),
            senders=senders,
            receivers=receivers,
            graph_y=np.asarray([energy], np.float32),
            graph_targets={"energy": np.asarray([energy], np.float32)},
            node_targets={"forces": forces.astype(np.float32)},
            z=z.copy(),
        ))
    # reference-energy centering (standard atomization-energy shift)
    e_mean = float(np.mean([g.graph_y[0] for g in graphs]))
    for g in graphs:
        g.graph_y = (g.graph_y - e_mean).astype(np.float32)
        g.graph_targets["energy"] = g.graph_y.copy()
    return graphs


def ani1x_shaped_dataset(number_configurations: int = 256, radius: float = 5.0,
                         max_neighbours: int = 32, seed: int = 11) -> List[Graph]:
    """ANI-1x-*shaped*: C/H/N/O molecules, 2-~30 atoms (the ANI-1x organic
    range), energy + force targets (reference: examples/ani1_x/train.py,
    ani1x_energy.json / ani1x_forces.json)."""
    return _molecule_forces_family(
        number_configurations, [6, 7, 8], [0.7, 0.15, 0.15], (1, 8), 1.4,
        radius, max_neighbours, seed,
    )


def transition1x_shaped_dataset(number_configurations: int = 256,
                                radius: float = 5.0, max_neighbours: int = 32,
                                seed: int = 29) -> List[Graph]:
    """Transition1x-*shaped*: reaction-path configurations — pairs of
    perturbed endpoint geometries of one molecule linearly interpolated with
    an activation-barrier energy bump at the midpoint, the structure of the
    real NEB-sampled dataset (reference: examples/transition1x/train.py,
    transition1x_energy.json; energy-only graph target)."""
    rng = np.random.default_rng(seed)
    graphs: List[Graph] = []
    n_paths = max(1, number_configurations // 8)
    # distribute the remainder so exactly number_configurations come back
    per_path_counts = np.full(n_paths, number_configurations // n_paths)
    per_path_counts[: number_configurations - int(per_path_counts.sum())] += 1
    for per_path in per_path_counts:
        n_heavy = int(rng.integers(2, 8))
        n_h = int(np.clip(rng.poisson(1.3 * n_heavy), 0, 16))
        z = np.concatenate([
            rng.choice([6, 7, 8], size=n_heavy, p=[0.7, 0.15, 0.15]),
            np.ones(n_h, np.int64),
        ]).astype(np.int32)
        reactant = _grow_molecule(rng, z.shape[0])
        z = z[: reactant.shape[0]]
        product = reactant + rng.normal(0.0, 0.35, reactant.shape)
        barrier = float(rng.uniform(0.5, 2.0))
        for _ in range(int(per_path)):
            lam = float(rng.uniform(0.0, 1.0))
            pos = (1 - lam) * reactant + lam * product
            pos = pos + rng.normal(0.0, 0.03, pos.shape)
            senders, receivers = radius_graph(pos, radius, max_neighbours)
            senders, receivers = _symmetrize_edges(senders, receivers)
            energy, _ = _lj_targets(pos, senders, receivers, 0.2, 1.2)
            energy += 4.0 * barrier * lam * (1.0 - lam)  # NEB-like bump
            graphs.append(Graph(
                x=z[:, None].astype(np.float32),
                pos=pos.astype(np.float32),
                senders=senders,
                receivers=receivers,
                graph_y=np.asarray([energy], np.float32),
                z=z.copy(),
            ))
    e_mean = float(np.mean([g.graph_y[0] for g in graphs]))
    for g in graphs:
        g.graph_y = (g.graph_y - e_mean).astype(np.float32)
    return graphs


def qm7x_shaped_dataset(number_configurations: int = 256, radius: float = 5.0,
                        max_neighbours: int = 32, seed: int = 13) -> List[Graph]:
    """QM7-X-*shaped*: up-to-7-heavy-atom molecules (C/N/O/S/Cl + H) with the
    reference's five-target multitask surface (examples/qm7x/qm7x.json):
    graph HLGAP + node forces/hCHG/hVDIP/hRAT. Closed forms, all learnable
    from geometry+species: HLGAP = softened inverse of the per-atom LJ
    energy; hCHG = electronegativity imbalance vs bonded neighbours;
    hVDIP = local asymmetry (norm of the mean neighbour unit vector);
    hRAT = degree / max_neighbours. Node feature table:
    ``[Z, fx, fy, fz, hCHG, hVDIP, hRAT]``, graph table ``[HLGAP]``."""
    rng = np.random.default_rng(seed)
    graphs: List[Graph] = []
    for _ in range(number_configurations):
        n_heavy = int(rng.integers(1, 8))  # QM7-X: max 7 heavy atoms
        n_h = int(np.clip(rng.poisson(1.5 * n_heavy), 2 if n_heavy < 2 else 0, 18))
        z = np.concatenate([
            rng.choice([6, 7, 8, 16, 17], size=n_heavy,
                       p=[0.62, 0.14, 0.14, 0.06, 0.04]),
            np.ones(n_h, np.int64),
        ]).astype(np.int32)
        pos = _grow_molecule(rng, z.shape[0])
        z = z[: pos.shape[0]]
        n = pos.shape[0]
        senders, receivers = radius_graph(pos, radius, max_neighbours)
        senders, receivers = _symmetrize_edges(senders, receivers)
        energy, forces = _lj_targets(pos, senders, receivers, 0.2, 1.2)
        en = _en_of(z)
        deg = np.bincount(receivers, minlength=n).astype(np.float64)
        safe_deg = np.maximum(deg, 1.0)
        # neighbour-mean electronegativity -> charge-like imbalance
        en_sum = np.zeros(n)
        np.add.at(en_sum, receivers, en[senders])
        hchg = (en - en_sum / safe_deg) * 0.3
        # local asymmetry: norm of the mean bond unit vector
        diff = pos[senders] - pos[receivers]
        unit = diff / np.maximum(np.linalg.norm(diff, axis=1, keepdims=True), 1e-9)
        acc = np.zeros((n, 3))
        np.add.at(acc, receivers, unit)
        hvdip = np.linalg.norm(acc / safe_deg[:, None], axis=1)
        hrat = deg / max_neighbours
        hlgap = 2.0 / (1.0 + np.exp(energy / n))  # smooth, bounded, geometric
        x = np.concatenate([
            z[:, None].astype(np.float32),
            forces.astype(np.float32),
            hchg[:, None].astype(np.float32),
            hvdip[:, None].astype(np.float32),
            hrat[:, None].astype(np.float32),
        ], axis=1)
        graphs.append(Graph(
            x=x,
            pos=pos.astype(np.float32),
            senders=senders,
            receivers=receivers,
            graph_y=np.asarray([hlgap], np.float32),
            z=z.copy(),
        ))
    return graphs


def omol25_shaped_dataset(number_configurations: int = 128, radius: float = 5.0,
                          max_neighbours: int = 32, seed: int = 31) -> List[Graph]:
    """OMol25-*shaped*: larger organic/organometallic molecules (mean ~40
    atoms, elements incl. S/P/halogens/a few metals), energy + forces
    (reference: examples/open_molecules_2025/train.py)."""
    return _molecule_forces_family(
        number_configurations,
        [6, 7, 8, 15, 16, 17, 30, 26], [0.55, 0.12, 0.12, 0.05, 0.07, 0.04, 0.02, 0.03],
        (6, 24), 1.2, radius, max_neighbours, seed,
    )


def periodic_crystal_shaped_dataset(
    number_configurations: int = 128,
    element_pool: Sequence[int] = (3, 8, 13, 14, 22, 26, 28, 29),
    n_species: int = 2,
    reps_range: Sequence[int] = (2, 3),  # inclusive
    lattice_range: Sequence[float] = (3.4, 4.4),
    rattle: float = 0.08,
    radius: float = 5.0,
    max_neighbours: int = 20,
    seed: int = 23,
) -> List[Graph]:
    """Perturbed periodic crystals: random SC/BCC/FCC supercells, random
    ``n_species``-ary composition from ``element_pool``, PBC radius graphs
    with shift vectors, LJ energy-per-atom (graph) + forces (node) on the
    periodic displacements. The generalized form of the MPTrj generator
    covering the Alexandria and OMat24 families (reference:
    examples/alexandria/train.py, examples/open_materials_2024/omat24.py).
    Node feature table ``[Z, fx, fy, fz]``."""
    rng = np.random.default_rng(seed)
    bases = {
        "sc": np.zeros((1, 3)),
        "bcc": np.array([[0, 0, 0], [0.5, 0.5, 0.5]], np.float64),
        "fcc": np.array(
            [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]], np.float64
        ),
    }
    element_pool = np.asarray(element_pool)
    graphs: List[Graph] = []
    for _ in range(number_configurations):
        kind = ("sc", "bcc", "fcc")[int(rng.integers(3))]
        basis = bases[kind]
        a = float(rng.uniform(*lattice_range))
        # inclusive range, like n_heavy_range in _molecule_forces_family
        reps = int(rng.integers(reps_range[0], reps_range[1] + 1))
        frac = supercell_frac(basis, reps)
        cell = np.diag([a * reps] * 3)
        pos = frac @ cell + rng.normal(0.0, rattle, (frac.shape[0], 3))
        n = pos.shape[0]
        k = int(np.clip(n_species, 1, element_pool.shape[0]))
        zs = rng.choice(element_pool, size=k, replace=False)
        z = zs[rng.integers(0, k, n)].astype(np.int32)
        senders, receivers, shifts = radius_graph_pbc(pos, cell, radius, max_neighbours)
        sigma = a / np.sqrt(2.0) / 2.0 ** (1.0 / 6.0)
        energy, forces = _lj_targets(pos, senders, receivers, 0.5, sigma, shifts=shifts)
        x = np.concatenate(
            [z[:, None].astype(np.float32), forces.astype(np.float32)], axis=1
        )
        graphs.append(Graph(
            x=x,
            pos=pos.astype(np.float32),
            senders=senders,
            receivers=receivers,
            edge_shifts=shifts.astype(np.float32),
            cell=cell.astype(np.float32),
            graph_y=np.asarray([energy / n], np.float32),
            graph_targets={"energy": np.asarray([energy / n], np.float32)},
            node_targets={"forces": forces.astype(np.float32)},
            z=z.copy(),
        ))
    return graphs


def alexandria_shaped_dataset(number_configurations: int = 128, **kw) -> List[Graph]:
    """Alexandria-*shaped*: ternary oxide-like periodic crystals
    (reference: examples/alexandria/train.py + find_json_files.py)."""
    kw.setdefault("element_pool", (8, 3, 13, 14, 20, 22, 26, 30))
    kw.setdefault("n_species", 3)
    kw.setdefault("seed", 37)
    return periodic_crystal_shaped_dataset(number_configurations, **kw)


def omat24_shaped_dataset(number_configurations: int = 128, **kw) -> List[Graph]:
    """OMat24-*shaped*: rattled inorganic crystals at larger perturbation
    (the real OMat24 samples far-from-equilibrium configurations;
    reference: examples/open_materials_2024/omat24.py)."""
    kw.setdefault("element_pool", (8, 13, 14, 22, 25, 26, 28, 29, 41))
    kw.setdefault("n_species", 2)
    kw.setdefault("rattle", 0.16)
    kw.setdefault("seed", 41)
    return periodic_crystal_shaped_dataset(number_configurations, **kw)


def odac23_shaped_dataset(number_configurations: int = 96, radius: float = 5.0,
                          max_neighbours: int = 20, seed: int = 43) -> List[Graph]:
    """ODAC23-*shaped*: sparse MOF-like frameworks with a CO2 adsorbate —
    an open metal-organic lattice (larger lattice constant than a metal
    slab) plus one CO2 molecule placed in a pore; energy+forces
    (reference: examples/open_direct_air_capture_2023/train.py)."""
    rng = np.random.default_rng(seed)
    graphs: List[Graph] = []
    for _ in range(number_configurations):
        reps = int(rng.integers(2, 4))
        a = float(rng.uniform(5.2, 6.2))  # open-framework spacing
        # framework: metal node at corner + organic linker atoms on edges
        linker_basis = np.array(
            [[0, 0, 0], [0.5, 0, 0], [0, 0.5, 0], [0, 0, 0.5]], np.float64
        )
        frame_frac = supercell_frac(linker_basis, reps)
        cell = np.diag([a * reps] * 3)
        pos = frame_frac @ cell + rng.normal(0.0, 0.06, (frame_frac.shape[0], 3))
        n_frame = pos.shape[0]
        # atoms are cell-major (4 basis sites per cell): site 0 is the
        # metal node, sites 1-3 the organic linkers
        z = rng.choice([6, 8], size=n_frame).astype(np.int32)
        z[0::4] = rng.choice([29, 30, 26])  # metal nodes
        # CO2 adsorbate in a pore center
        center = np.array([0.25, 0.25, 0.25]) @ cell + rng.normal(0, 0.4, 3)
        axis = rng.normal(0, 1, 3)
        axis /= np.linalg.norm(axis)
        co2 = np.stack([center - 1.16 * axis, center, center + 1.16 * axis])
        pos = np.concatenate([pos, co2])
        z = np.concatenate([z, np.array([8, 6, 8], np.int32)])
        senders, receivers, shifts = radius_graph_pbc(pos, cell, radius, max_neighbours)
        energy, forces = _lj_targets(pos, senders, receivers, 0.3, 2.6, shifts=shifts)
        x = np.concatenate(
            [z[:, None].astype(np.float32), forces.astype(np.float32)], axis=1
        )
        graphs.append(Graph(
            x=x,
            pos=pos.astype(np.float32),
            senders=senders,
            receivers=receivers,
            edge_shifts=shifts.astype(np.float32),
            cell=cell.astype(np.float32),
            graph_y=np.asarray([energy / pos.shape[0]], np.float32),
            graph_targets={"energy": np.asarray([energy / pos.shape[0]], np.float32)},
            node_targets={"forces": forces.astype(np.float32)},
            z=z.copy(),
        ))
    return graphs


def eam_bulk_dataset(number_configurations: int = 128, radius: float = 3.6,
                     max_neighbours: int = 32, seed: int = 47) -> List[Graph]:
    """NiNb-EAM-*shaped*: binary Ni/Nb BCC bulk supercells with
    Finnis-Sinclair embedded-atom energies — per-atom energy (node),
    total energy (graph), analytic forces (node)
    (reference: examples/eam/eam.py + NiNb_EAM_*.json configs; the real
    data comes from LAMMPS EAM tables). Node feature table
    ``[Z, atomic_energy, fx, fy, fz]``, graph table ``[total_energy]``."""
    rng = np.random.default_rng(seed)
    basis = np.array([[0, 0, 0], [0.5, 0.5, 0.5]], np.float64)
    graphs: List[Graph] = []
    for _ in range(number_configurations):
        reps = int(rng.integers(2, 4))
        a = float(rng.uniform(3.1, 3.4))  # Ni/Nb BCC lattice range
        frac = supercell_frac(basis, reps)
        cell = np.diag([a * reps] * 3)
        pos = frac @ cell + rng.normal(0.0, 0.05, (frac.shape[0], 3))
        n = pos.shape[0]
        frac_nb = float(rng.uniform(0.1, 0.5))
        z = np.where(rng.random(n) < frac_nb, 41, 28).astype(np.int32)
        senders, receivers, shifts = radius_graph_pbc(pos, cell, radius, max_neighbours)
        atomic_energy, forces = _fs_eam_targets_pbc(
            pos, senders, receivers, z, radius, shifts
        )
        x = np.concatenate([
            z[:, None].astype(np.float32),
            atomic_energy[:, None].astype(np.float32),
            forces.astype(np.float32),
        ], axis=1)
        graphs.append(Graph(
            x=x,
            pos=pos.astype(np.float32),
            senders=senders,
            receivers=receivers,
            edge_shifts=shifts.astype(np.float32),
            cell=cell.astype(np.float32),
            graph_y=np.asarray([atomic_energy.sum()], np.float32),
            z=z.copy(),
        ))
    return graphs


def _fs_eam_targets_pbc(pos, senders, receivers, z, cutoff, shifts):
    """PBC-aware Finnis-Sinclair per-atom energies and analytic forces."""
    A = np.where(z == 28, 1.2, 1.6)
    B = 0.25
    diff = pos[receivers] - pos[senders]
    if shifts is not None:
        diff = diff - shifts
    r = np.linalg.norm(diff, axis=1)
    w = np.maximum(cutoff - r, 0.0)
    n = pos.shape[0]
    rho = np.zeros(n)
    np.add.at(rho, receivers, w**2)
    rho = np.maximum(rho, 1e-12)
    atomic_energy = -A * np.sqrt(rho)
    np.add.at(atomic_energy, receivers, 0.5 * B * w**2)
    demb = -A / (2.0 * np.sqrt(rho))
    # edge j->i: rho_i gains w^2 -> d rho_i/dx_i = 2 w * (-1) * diff/r.
    # The twin edge i->j handles rho_j, so each edge only carries its
    # receiver's embedding derivative. Pair: 0.5 B w^2 per direction; its
    # gradient per edge w.r.t. x_i is B w * (-1) * diff/r * 0.5 * 2.
    dEdr = demb[receivers] * 2.0 * w * (-1.0) - B * w
    dEdr = dEdr * (w > 0)
    unit = diff / np.maximum(r, 1e-12)[:, None]
    grad_edge = dEdr[:, None] * unit
    forces = np.zeros_like(pos)
    np.add.at(forces, receivers, -grad_edge)
    np.add.at(forces, senders, grad_edge)
    return atomic_energy, forces


def uv_spectrum_shaped_dataset(
    number_configurations: int = 256,
    num_bins: int = 37,
    smooth: bool = True,
    radius: float = 7.0,
    max_neighbours: int = 10,
    seed: int = 53,
) -> List[Graph]:
    """DFTB-UV-spectrum-*shaped*: small organic molecules whose graph target
    is a ``num_bins``-dim spectrum — Gaussian-broadened (smooth) or binned
    (discrete) intensity over a fixed energy grid, with excitation energies
    derived from the molecular geometry's pair-distance spectrum so the
    target is learnable (reference: examples/dftb_uv_spectrum/
    train_smooth_uv_spectrum.py and train_discrete_uv_spectrum.py; the real
    smooth target is a 37,500-point grid — configurable here, default kept
    small for CI)."""
    rng = np.random.default_rng(seed)
    grid = np.linspace(0.0, 1.0, num_bins)
    graphs: List[Graph] = []
    for _ in range(number_configurations):
        n_heavy = int(rng.integers(2, 9))
        n_h = int(np.clip(rng.poisson(1.3 * n_heavy), 0, 16))
        z = np.concatenate([
            rng.choice([6, 7, 8], size=n_heavy, p=[0.7, 0.15, 0.15]),
            np.ones(n_h, np.int64),
        ]).astype(np.int32)
        pos = _grow_molecule(rng, z.shape[0])
        z = z[: pos.shape[0]]
        senders, receivers = radius_graph(pos, radius, max_neighbours)
        senders, receivers = _symmetrize_edges(senders, receivers)
        # "excitations": normalized inverse pair distances along edges
        d = np.linalg.norm(pos[senders] - pos[receivers], axis=1)
        exc = 1.0 / (1.0 + d)  # in (0, 1)
        inten = _en_of(z)[senders] * 0.2
        spectrum = np.zeros(num_bins)
        if smooth:
            width = 0.04
            spectrum = np.sum(
                inten[:, None]
                * np.exp(-0.5 * ((grid[None, :] - exc[:, None]) / width) ** 2),
                axis=0,
            )
        else:
            idx = np.clip((exc * num_bins).astype(int), 0, num_bins - 1)
            np.add.at(spectrum, idx, inten)
        spectrum = spectrum / max(len(d), 1)
        graphs.append(Graph(
            x=z[:, None].astype(np.float32),
            pos=pos.astype(np.float32),
            senders=senders,
            receivers=receivers,
            graph_y=spectrum.astype(np.float32),
            z=z.copy(),
        ))
    return graphs


def zinc_shaped_dataset(number_configurations: int = 512, radius: float = 7.0,
                        max_neighbours: int = 5, seed: int = 59) -> List[Graph]:
    """ZINC-*shaped*: drug-like organic molecules (9-37 atoms, the ZINC-
    subset range) with a penalized-logP-like closed-form graph target
    (hydrophobicity sum minus a size penalty plus a geometry term), node
    feature = atom-type index like the real ZINC's 28-type vocabulary
    (reference: examples/zinc/zinc.py; free-energy graph target)."""
    rng = np.random.default_rng(seed)
    # type vocabulary: common ZINC heavy atoms + H; index is the feature
    vocab = np.array([1, 6, 7, 8, 9, 15, 16, 17, 35, 53])
    logp_w = np.array([0.1, 0.5, -0.3, -0.4, 0.2, 0.1, 0.4, 0.7, 0.9, 1.1])
    graphs: List[Graph] = []
    for _ in range(number_configurations):
        n_heavy = int(rng.integers(8, 28))
        n_h = int(np.clip(rng.poisson(1.1 * n_heavy), 0, 24))
        type_idx = np.concatenate([
            rng.choice(len(vocab) - 1, size=n_heavy,
                       p=[0.55, 0.14, 0.14, 0.04, 0.02, 0.05, 0.04, 0.01, 0.01]) + 1,
            np.zeros(n_h, np.int64),  # type 0 = H
        ])
        z = vocab[type_idx].astype(np.int32)
        pos = _grow_molecule(rng, z.shape[0])
        type_idx = type_idx[: pos.shape[0]]
        z = z[: pos.shape[0]]
        senders, receivers = radius_graph(pos, radius, max_neighbours)
        senders, receivers = _symmetrize_edges(senders, receivers)
        d = np.linalg.norm(pos[senders] - pos[receivers], axis=1)
        target = (
            float(np.sum(logp_w[type_idx]))
            - 0.05 * pos.shape[0]
            + 0.1 * float(np.mean(d))
        )
        graphs.append(Graph(
            x=type_idx[:, None].astype(np.float32),
            pos=pos.astype(np.float32),
            senders=senders,
            receivers=receivers,
            graph_y=np.asarray([target], np.float32),
            z=z.copy(),
        ))
    return graphs
