"""Atomic descriptors and molecule-to-graph helpers
(reference: hydragnn/utils/descriptors_and_embeddings/atomicdescriptors.py
builds feature tables from mendeleev/pymatgen; smiles_utils.py:1-127 turns
SMILES strings into graphs via rdkit).

Counterpart of ``hydragnn_tpu/data/descriptors.py``: the same tables, and
the route the JAX package takes where rdkit is absent.

Neither mendeleev nor pymatgen is a dependency, so the periodic-table
quantities used by the reference descriptors are embedded directly
(standard CODATA/Pauling values, Z <= 118, zero where undefined).
SMILES support degrades gracefully when rdkit is absent.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..ops.radial import COVALENT_RADII
from .graph import Graph
from .raw import ATOMIC_SYMBOLS, SYMBOL_TO_Z

# Pauling electronegativity per Z (0 where undefined / noble without value)
ELECTRONEGATIVITY = np.zeros(119, np.float32)
ELECTRONEGATIVITY[1:104] = [
    2.20, 0.0, 0.98, 1.57, 2.04, 2.55, 3.04, 3.44, 3.98, 0.0,
    0.93, 1.31, 1.61, 1.90, 2.19, 2.58, 3.16, 0.0, 0.82, 1.00,
    1.36, 1.54, 1.63, 1.66, 1.55, 1.83, 1.88, 1.91, 1.90, 1.65,
    1.81, 2.01, 2.18, 2.55, 2.96, 3.00, 0.82, 0.95, 1.22, 1.33,
    1.60, 2.16, 1.90, 2.20, 2.28, 2.20, 1.93, 1.69, 1.78, 1.96,
    2.05, 2.10, 2.66, 2.60, 0.79, 0.89,
    # 57-71 lanthanides
    1.10, 1.12, 1.13, 1.14, 1.13, 1.17, 1.20, 1.20, 1.10, 1.22,
    1.23, 1.24, 1.25, 1.10, 1.27,
    # 72-86 Hf..Rn
    1.30, 1.50, 2.36, 1.90, 2.20, 2.20, 2.28, 2.54, 2.00, 1.62,
    2.33, 2.02, 2.00, 2.20, 2.20,
    # 87-103 Fr..Lr
    0.70, 0.90, 1.10, 1.30, 1.50, 1.38, 1.36, 1.28, 1.13, 1.28,
    1.30, 1.30, 1.30, 1.30, 1.30, 1.30, 1.30,
]

# standard atomic weights (u), Z <= 94, zero beyond
ATOMIC_MASS = np.zeros(119, np.float32)
ATOMIC_MASS[1:95] = [
    1.008, 4.003, 6.94, 9.012, 10.81, 12.011, 14.007, 15.999, 18.998, 20.180,
    22.990, 24.305, 26.982, 28.085, 30.974, 32.06, 35.45, 39.948, 39.098,
    40.078, 44.956, 47.867, 50.942, 51.996, 54.938, 55.845, 58.933, 58.693,
    63.546, 65.38, 69.723, 72.630, 74.922, 78.971, 79.904, 83.798, 85.468,
    87.62, 88.906, 91.224, 92.906, 95.95, 97.0, 101.07, 102.906, 106.42,
    107.868, 112.414, 114.818, 118.710, 121.760, 127.60, 126.904, 131.293,
    132.905, 137.327, 138.905, 140.116, 140.908, 144.242, 145.0, 150.36,
    151.964, 157.25, 158.925, 162.500, 164.930, 167.259, 168.934, 173.045,
    174.967, 178.486, 180.948, 183.84, 186.207, 190.23, 192.217, 195.084,
    196.967, 200.592, 204.38, 207.2, 208.980, 209.0, 210.0, 222.0, 223.0,
    226.0, 227.0, 232.038, 231.036, 238.029, 237.0, 244.0,
]

_PERIOD_STARTS = np.array([1, 3, 11, 19, 37, 55, 87, 119])


def period_of(z: np.ndarray) -> np.ndarray:
    return np.searchsorted(_PERIOD_STARTS, np.asarray(z), side="right")


def group_of(z: np.ndarray) -> np.ndarray:
    """IUPAC group 1-18 (lanthanides/actinides mapped to group 3)."""
    z = np.asarray(z)
    out = np.zeros_like(z)
    for i, zi in np.ndenumerate(z):
        zi = int(zi)
        if zi in (1,):
            g = 1
        elif zi == 2:
            g = 18
        elif zi <= 18:
            off = zi - (3 if zi <= 10 else 11)
            g = off + 1 if off < 2 else off + 11
        elif zi <= 54:
            off = (zi - 19) % 18
            g = off + 1
        else:
            base = 55 if zi <= 86 else 87
            off = zi - base
            if off < 2:
                g = off + 1
            elif off < 17:
                g = 3  # f-block
            else:
                g = off - 13
        out[i] = min(max(g, 1), 18)
    return out


def atomic_descriptors(z, one_hot_period_group: bool = True) -> np.ndarray:
    """Per-atom descriptor rows for atomic numbers ``z``
    (reference: atomicdescriptors.get_atom_features — normalized scalar
    properties plus one-hot period/group encodings)."""
    z = np.clip(np.asarray(z, np.int64), 0, 118)
    cov = np.zeros(119, np.float32)
    cov[: len(COVALENT_RADII)] = COVALENT_RADII[:119]
    scalars = np.stack(
        [
            z / 118.0,
            ATOMIC_MASS[z] / ATOMIC_MASS.max(),
            ELECTRONEGATIVITY[z] / 4.0,
            cov[z] / max(cov.max(), 1e-6),
        ],
        axis=-1,
    ).astype(np.float32)
    if not one_hot_period_group:
        return scalars
    period = np.eye(8, dtype=np.float32)[np.clip(period_of(z) - 1, 0, 7)]
    group = np.eye(18, dtype=np.float32)[np.clip(group_of(z) - 1, 0, 17)]
    return np.concatenate([scalars, period, group], axis=-1)


def smiles_to_graph(smiles: str, radius: float = 10.0) -> Graph:
    """SMILES -> Graph through the in-tree SMILES reader (data/smiles.py):
    the JAX package's route where rdkit is absent, with its warning (rdkit
    is not a dependency of the port)."""
    import warnings

    from .smiles import smiles_to_graph as _native

    warnings.warn(
        "rdkit unavailable: smiles_to_graph is using the in-tree SMILES "
        "reader, whose node-feature table ([Z, degree, charge, aromatic, "
        "n_H, sp, sp2, sp3] + bond-order edge_attr) differs from the rdkit path's "
        "atomic_descriptors table — datasets/checkpoints built with one "
        "path are not feature-compatible with the other",
        stacklevel=2,
    )
    return _native(smiles)
