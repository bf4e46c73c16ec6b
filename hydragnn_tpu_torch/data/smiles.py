"""Dependency-free SMILES reader: string -> molecular ``Graph``.

Counterpart of ``hydragnn_tpu/data/smiles.py``: for the same strings and
seed both packages return the same arrays.

The reference turns SMILES into PyG graphs with rdkit
(hydragnn/utils/descriptors_and_embeddings/smiles_utils.py:1-127:
``generate_graphdata_from_smilestr`` one-hot-encodes atom type, degree and
H-count into the node feature table; bonds become bidirectional edges).
rdkit is not a dependency, so this module implements the needed subset of
the SMILES grammar directly — enough for the drug-like strings of the
ZINC / CSCE / OGB example datasets:

- organic-subset atoms (B C N O P S F Cl Br I), aromatic lowercase forms
- bracket atoms ``[...]`` with isotope / charge / explicit H (parsed,
  stereo ``@`` ignored)
- bonds ``- = # :``, ring-closure digits + ``%nn``, branches ``( )``
- implicit hydrogens by standard valence, made explicit as H nodes so the
  graph matches rdkit's ``AddHs`` convention used by the reference

A light 3D embedding (bonded-distance rejection sampling) gives each
molecule coordinates so geometric models (SchNet etc.) run on the result.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from .graph import Graph

_ORGANIC = ["Cl", "Br", "B", "C", "N", "O", "P", "S", "F", "I"]
_AROMATIC = {"b": "B", "c": "C", "n": "N", "o": "O", "p": "P", "s": "S"}
_Z = {"H": 1, "B": 5, "C": 6, "N": 7, "O": 8, "F": 9, "P": 15, "S": 16,
      "Cl": 17, "Br": 35, "I": 53, "Si": 14, "Se": 34, "As": 33}
# default valence for implicit-H counting (organic subset)
_VALENCE = {"B": 3, "C": 4, "N": 3, "O": 2, "P": 3, "S": 2, "F": 1,
            "Cl": 1, "Br": 1, "I": 1, "H": 1}

_BRACKET = re.compile(
    r"\[(?P<iso>\d+)?(?P<sym>[A-Z][a-z]?|[bcnops])(?P<chiral>@{0,2})"
    r"(?P<h>H\d*)?(?P<chg>[+-]+\d*|\+\d+|-\d+)?(?::\d+)?\]"
)

# covalent radii (Angstrom) for the 3D embedding's bond lengths
_RCOV = {1: 0.31, 5: 0.84, 6: 0.76, 7: 0.71, 8: 0.66, 9: 0.57, 14: 1.11,
         15: 1.07, 16: 1.05, 17: 1.02, 33: 1.19, 34: 1.20, 35: 1.20, 53: 1.39}


class SmilesError(ValueError):
    pass


def parse_smiles(s: str):
    """Parse a SMILES string.

    Returns ``(symbols, aromatic, charges, explicit_h, bonds)`` where bonds
    is a list of ``(i, j, order)`` (order 1.5 = aromatic).
    """
    symbols: List[str] = []
    aromatic: List[bool] = []
    charges: List[int] = []
    explicit_h: List[Optional[int]] = []  # None = implicit by valence
    bonds: List[Tuple[int, int, float]] = []
    prev: Optional[int] = None
    stack: List[Optional[int]] = []
    rings: Dict[str, Tuple[int, Optional[float]]] = {}
    pending_bond: Optional[float] = None
    i = 0
    n = len(s)

    def add_atom(sym: str, arom: bool, chg: int = 0, h: Optional[int] = None) -> int:
        symbols.append(sym)
        aromatic.append(arom)
        charges.append(chg)
        explicit_h.append(h)
        return len(symbols) - 1

    def bond_to(idx: int):
        nonlocal pending_bond, prev
        if prev is not None:
            order = pending_bond
            if order is None:
                order = 1.5 if (aromatic[prev] and aromatic[idx]) else 1.0
            bonds.append((prev, idx, order))
        pending_bond = None
        prev = idx

    while i < n:
        ch = s[i]
        if ch == "(":
            stack.append(prev)
            i += 1
        elif ch == ")":
            if not stack:
                raise SmilesError(f"unbalanced ')' in {s!r}")
            prev = stack.pop()
            i += 1
        elif ch in "-=#:":
            pending_bond = {"-": 1.0, "=": 2.0, "#": 3.0, ":": 1.5}[ch]
            i += 1
        elif ch in "/\\":
            i += 1  # cis/trans stereo: topology-irrelevant, skip
        elif ch == ".":
            prev = None  # disconnected component
            pending_bond = None
            i += 1
        elif ch.isdigit() or ch == "%":
            if ch == "%":
                label = s[i + 1:i + 3]
                i += 3
            else:
                label = ch
                i += 1
            if prev is None:
                raise SmilesError(f"ring closure before any atom in {s!r}")
            if label in rings:
                j, open_order = rings.pop(label)
                order = pending_bond or open_order
                if order is None:
                    order = 1.5 if (aromatic[prev] and aromatic[j]) else 1.0
                bonds.append((j, prev, order))
                pending_bond = None
            else:
                rings[label] = (prev, pending_bond)
                pending_bond = None
        elif ch == "[":
            m = _BRACKET.match(s, i)
            if not m:
                raise SmilesError(f"bad bracket atom at {i} in {s!r}")
            sym = m.group("sym")
            arom = sym in _AROMATIC
            if arom:
                sym = _AROMATIC[sym]
            h = m.group("h")
            hcount = 0 if h is None else (1 if h == "H" else int(h[1:]))
            chg_s = m.group("chg") or ""
            if chg_s in ("+", "-"):
                chg = 1 if chg_s == "+" else -1
            elif chg_s in ("++", "--"):
                chg = 2 if chg_s == "++" else -2
            elif chg_s:
                chg = int(chg_s[1:]) * (1 if chg_s[0] == "+" else -1)
            else:
                chg = 0
            idx = add_atom(sym, arom, chg, hcount)
            bond_to(idx)
            i = m.end()
        else:
            matched = None
            for sym in _ORGANIC:
                if s.startswith(sym, i):
                    matched = sym
                    break
            if matched:
                idx = add_atom(matched, False)
                bond_to(idx)
                i += len(matched)
            elif ch in _AROMATIC:
                idx = add_atom(_AROMATIC[ch], True)
                bond_to(idx)
                i += 1
            else:
                raise SmilesError(f"unexpected {ch!r} at {i} in {s!r}")
    if stack:
        raise SmilesError(f"unbalanced '(' in {s!r}")
    if rings:
        raise SmilesError(f"unclosed ring bond(s) {sorted(rings)} in {s!r}")
    return symbols, aromatic, charges, explicit_h, bonds


def _implicit_h(sym: str, arom: bool, charge: int, bond_order_sum: float) -> int:
    val = _VALENCE.get(sym)
    if val is None:
        return 0
    if sym == "N" and charge > 0:
        val = 4
    elif sym == "O" and charge > 0:
        val = 3
    elif charge < 0:
        val = max(val + charge, 0)
    used = int(round(bond_order_sum)) if not arom else int(np.ceil(bond_order_sum))
    return max(val - used, 0)


def _embed_3d(z: np.ndarray, bonds: List[Tuple[int, int, float]],
              seed: int = 0) -> np.ndarray:
    """Place atoms so bonded pairs sit near the sum of covalent radii:
    breadth-first placement with short steric relaxation. Not a
    conformer generator — just enough geometry for radius-based models."""
    rng = np.random.default_rng(seed)
    n = z.shape[0]
    pos = np.zeros((n, 3))
    adj: List[List[Tuple[int, float]]] = [[] for _ in range(n)]
    for a, b, _ in bonds:
        d = _RCOV.get(int(z[a]), 0.8) + _RCOV.get(int(z[b]), 0.8)
        adj[a].append((b, d))
        adj[b].append((a, d))
    placed = np.zeros(n, bool)
    for root in range(n):
        if placed[root]:
            continue
        pos[root] = rng.normal(0, 4.0, 3)
        placed[root] = True
        queue = [root]
        while queue:
            cur = queue.pop()
            for nb, d in adj[cur]:
                if placed[nb]:
                    continue
                direction = rng.normal(0, 1, 3)
                direction /= np.linalg.norm(direction)
                pos[nb] = pos[cur] + direction * d
                placed[nb] = True
                queue.append(nb)
    # relaxation: push non-bonded close pairs apart while springs keep
    # bonded pairs at their covalent distance
    bonded = {(min(a, b), max(a, b)) for a, b, _ in bonds}
    bond_idx = np.asarray([[a, b] for a, b, _ in bonds], np.int64).reshape(-1, 2)
    bond_len = np.asarray(
        [_RCOV.get(int(z[a]), 0.8) + _RCOV.get(int(z[b]), 0.8) for a, b, _ in bonds]
    )
    for _ in range(80):
        diff = pos[:, None, :] - pos[None, :, :]
        dist = np.linalg.norm(diff, axis=-1) + np.eye(n)
        push = np.maximum(1.4 - dist, 0.0)
        for (a, b) in bonded:
            push[a, b] = push[b, a] = 0.0
        force = (push[:, :, None] * diff / dist[:, :, None]).sum(axis=1)
        if bond_idx.size:
            bvec = pos[bond_idx[:, 0]] - pos[bond_idx[:, 1]]
            bdist = np.maximum(np.linalg.norm(bvec, axis=1), 1e-9)
            stretch = (bdist - bond_len) / bdist  # >0 too long, <0 too short
            pull = stretch[:, None] * bvec
            np.add.at(force, bond_idx[:, 0], -pull)
            np.add.at(force, bond_idx[:, 1], pull)
        if np.abs(force).max() < 1e-3:
            break
        pos += 0.3 * force
    return pos


# width of the node-feature table smiles_to_graph emits:
# [Z, degree, charge, aromatic, n_H, sp, sp2, sp3]
N_NODE_FEATURE_COLS = 8


def columnar_schema_current(path: str) -> bool:
    """True iff the columnar dataset at ``path`` was written with the
    CURRENT SMILES feature table (x width ``N_NODE_FEATURE_COLS``).

    For example drivers that cache `build_dataset` output: a dataset from
    an older table (e.g. the 5-column pre-hybridization layout) must be
    rebuilt or the config's ``input_node_features`` indexes columns the
    arrays don't have. Raises (rather than reporting stale) when the
    metadata cannot be read — a transient read failure must not trigger a
    delete-and-rebuild of real data.
    """
    import json as _json

    meta_path = os.path.join(path, "shard00000", "meta.json")
    with open(meta_path) as f:  # OSError propagates: do NOT rebuild blindly
        meta = _json.load(f)
    try:
        return meta["fields"]["x"]["suffix"] == [N_NODE_FEATURE_COLS]
    except KeyError:
        return False  # a meta without an x field IS a schema mismatch


def _hybridization(z: int, aromatic: bool, charge: int,
                   sigma: int, order_sum: float) -> Tuple[int, int, int]:
    """(sp, sp2, sp3) one-hot, rdkit-free.

    The reference one-hot encodes HybridizationType SP/SP2/SP3 per atom
    (smiles_utils.py:58-70). Without rdkit the same labels follow from
    bond structure: pi = total bond order minus sigma bonds (aromatic
    bonds contribute 0.5 each); >=2 pi -> SP, 1 pi or aromatic -> SP2,
    otherwise the VSEPR steric number (sigma bonds + lone pairs, lone
    pairs from the valence-electron count) picks 4 -> SP3, 3 -> SP2,
    2 -> SP. Hydrogen and bare ions are unhybridized (all zeros), like
    rdkit's HybridizationType.S.
    """
    if z == 1 or sigma == 0:
        return 0, 0, 0
    pi = int(round(order_sum - sigma))
    if aromatic:
        return 0, 1, 0
    if pi >= 2:
        return 1, 0, 0
    if pi == 1:
        return 0, 1, 0
    ve = {5: 3, 6: 4, 7: 5, 8: 6, 9: 7, 15: 5, 16: 6, 17: 7, 35: 7, 53: 7}
    lone = max(0, (ve.get(z, 4) - charge - int(round(order_sum)))) // 2
    steric = sigma + lone
    if steric >= 4:
        return 0, 0, 1
    if steric == 3:
        return 0, 1, 0
    return 1, 0, 0


def smiles_to_graph(
    s: str,
    add_hydrogens: bool = True,
    embed_3d: bool = True,
    graph_y: Optional[np.ndarray] = None,
    seed: int = 0,
) -> Graph:
    """SMILES -> ``Graph`` with the reference's feature-table convention
    (smiles_utils.py: one-hot atom type + degree + H-count columns,
    IsAromatic + HSP/HSP2/HSP3 hybridization one-hots, smiles_utils.py:19-70).

    Node feature table columns: ``[Z, degree, charge, aromatic, n_H,
    sp, sp2, sp3]`` (hybridization appended last so pre-round-4 column
    indices remain valid); bonds become bidirectional edges with
    ``edge_attr = [bond_order]``.
    """
    symbols, aromatic, charges, explicit_h, bonds = parse_smiles(s)
    order_sum = np.zeros(len(symbols))
    for a, b, o in bonds:
        order_sum[a] += o
        order_sum[b] += o
    n_h = [
        h if h is not None else _implicit_h(sym, ar, chg, osum)
        for sym, ar, chg, h, osum in zip(
            symbols, aromatic, charges, explicit_h, order_sum
        )
    ]
    unknown = sorted({sym for sym in symbols if sym not in _Z})
    if unknown:
        raise SmilesError(
            f"unsupported element(s) {unknown} in {s!r} (supported: "
            f"{sorted(_Z)})"
        )
    z = [_Z[sym] for sym in symbols]
    deg = np.zeros(len(symbols))
    for a, b, _ in bonds:
        deg[a] += 1
        deg[b] += 1
    if add_hydrogens:
        heavy_n = len(symbols)
        for i in range(heavy_n):
            for _ in range(int(n_h[i])):
                z.append(1)
                charges.append(0)
                aromatic.append(False)
                bonds.append((i, len(z) - 1, 1.0))
                deg[i] += 1
        deg = np.concatenate([deg[:heavy_n], np.ones(len(z) - heavy_n)])
        n_h = list(n_h) + [0] * (len(z) - heavy_n)
    z_arr = np.asarray(z, np.int32)
    # hybridization from the full bond structure (sigma = bonded neighbors
    # incl. hydrogens = deg; order_sum recomputed over the final bond list)
    full_order = np.zeros(len(z))
    for a, b, o in bonds:
        full_order[a] += o
        full_order[b] += o
    imp_h = np.zeros(len(z)) if add_hydrogens else np.asarray(n_h, float)
    hyb = np.asarray(
        [
            _hybridization(
                int(z_arr[i]), bool(aromatic[i]), int(charges[i]),
                int(deg[i] + imp_h[i]), float(full_order[i] + imp_h[i]),
            )
            for i in range(len(z))
        ],
        np.float32,
    )
    x = np.stack([
        z_arr.astype(np.float32),
        deg.astype(np.float32),
        np.asarray(charges, np.float32),
        np.asarray(aromatic, np.float32),
        np.asarray(n_h, np.float32),
    ], axis=1)
    x = np.concatenate([x, hyb], axis=1)
    senders, receivers, orders = [], [], []
    for a, b, o in bonds:
        senders += [a, b]
        receivers += [b, a]
        orders += [o, o]
    pos = (
        _embed_3d(z_arr, bonds, seed=seed)
        if embed_3d
        else np.zeros((len(z), 3))
    )
    return Graph(
        x=x,
        pos=pos.astype(np.float32),
        senders=np.asarray(senders, np.int32),
        receivers=np.asarray(receivers, np.int32),
        edge_attr=np.asarray(orders, np.float32)[:, None],
        graph_y=None if graph_y is None else np.asarray(graph_y, np.float32),
        z=z_arr,
    )


# drug-like fragments used by the shaped SMILES datasets (valid SMILES,
# composable by string concatenation at the chain level)
_FRAGMENTS = [
    "CC", "CCC", "C(C)C", "CO", "CN", "C=O", "CCl", "CF", "CS",
    "c1ccccc1", "c1ccncc1", "c1ccoc1", "c1ccsc1", "C1CCCCC1", "C1CCNCC1",
    "C(=O)O", "C(=O)N", "C#N", "OC", "N(C)C",
]


def random_drug_smiles(rng: np.random.Generator, n_frag: int = 3) -> str:
    """A random valid drug-like SMILES string by fragment chaining."""
    return "".join(
        _FRAGMENTS[int(rng.integers(len(_FRAGMENTS)))]
        for _ in range(max(1, n_frag))
    )


def smiles_table_dataset(
    number_configurations: int = 256,
    target_fn=None,
    seed: int = 61,
) -> List[Graph]:
    """CSCE/OGB-*shaped*: random drug-like SMILES parsed through the real
    SMILES path, graph target = ``target_fn(graph)`` (default: a
    closed-form electronic-gap-like function of composition and bond
    orders, learnable from the feature table). Reference:
    examples/csce/train_gap.py and examples/ogb/train_gap.py, which read
    SMILES CSVs and train a gap regression."""
    rng = np.random.default_rng(seed)
    if target_fn is None:
        from .shaped import _en_of

        def target_fn(g: Graph) -> float:
            arom_frac = float(g.x[:, 3].mean())
            return float(
                _en_of(g.z).mean() + 0.8 * arom_frac - 0.01 * g.num_nodes
            )
    graphs: List[Graph] = []
    while len(graphs) < number_configurations:
        s = random_drug_smiles(rng, int(rng.integers(2, 5)))
        try:
            g = smiles_to_graph(s, seed=int(rng.integers(2**31)))
        except SmilesError:
            continue
        g.graph_y = np.asarray([target_fn(g)], np.float32)
        graphs.append(g)
    return graphs
