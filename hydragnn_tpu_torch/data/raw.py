"""Raw simulation-output loaders: LSMS, XYZ and AtomEye extended CFG.

Counterpart of ``hydragnn_tpu/data/raw.py``: the same parsers and the same
``Graph`` records. The loaders return edge-less graphs; ``finalize_graphs``
attaches radius-graph edges (open or periodic) with ``data/neighbors.py``.
The port builds open-boundary edges with the scipy KD-tree at every size,
where the JAX package hands graphs of 4,096 nodes and more to its C++ cell
list: the edge sets agree, their order may not there.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import List, Optional, Sequence

import numpy as np

from .graph import Graph
from .neighbors import radius_graph, radius_graph_pbc

ATOMIC_SYMBOLS = (
    "H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe Co "
    "Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In Sn Sb "
    "Te I Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf Ta W Re "
    "Os Ir Pt Au Hg Tl Pb Bi Po At Rn Fr Ra Ac Th Pa U Np Pu Am Cm Bk Cf Es "
    "Fm Md No Lr Rf Db Sg Bh Hs Mt Ds Rg Cn Nh Fl Mc Lv Ts Og"
).split()
SYMBOL_TO_Z = {s: i + 1 for i, s in enumerate(ATOMIC_SYMBOLS)}


def _empty_edges():
    return np.zeros((0,), np.int32), np.zeros((0,), np.int32)


def load_lsms_file(
    path: str,
    node_feature_dims: Sequence[int] = (1, 1),
    node_feature_cols: Sequence[int] = (0, 5),
    graph_feature_dims: Sequence[int] = (1,),
    graph_feature_cols: Sequence[int] = (0,),
    charge_density_correction: bool = False,
) -> Graph:
    """One LSMS text sample: line 0 holds the graph features, then one line
    per atom ``[feat0, feat1, x, y, z, feat5, ...]``; the selected columns
    make the node features. ``charge_density_correction`` subtracts the
    proton count (the first selected column) from the second, for columns
    ``[protons, charge density]``. ``z`` is the first selected column when
    that is column 0 (the protons), else unset."""
    with open(path, encoding="utf-8") as f:
        lines = f.readlines()
    head = lines[0].split()
    g_feature = [float(head[col + i]) for dim, col in zip(graph_feature_dims, graph_feature_cols)
                 for i in range(dim)]
    pos, feats = [], []
    for line in lines[1:]:
        if not line.strip():
            continue
        tok = line.split()
        pos.append([float(tok[2]), float(tok[3]), float(tok[4])])
        feats.append([float(tok[col + i])
                      for dim, col in zip(node_feature_dims, node_feature_cols)
                      for i in range(dim)])
    x = np.asarray(feats, np.float32)
    if charge_density_correction:
        if x.shape[1] < 2:
            raise ValueError("charge_density_correction needs [protons, charge] columns")
        x[:, 1] = x[:, 1] - x[:, 0]  # charge density -> net charge
    senders, receivers = _empty_edges()
    return Graph(
        x=x,
        pos=np.asarray(pos, np.float32),
        senders=senders,
        receivers=receivers,
        graph_y=np.asarray(g_feature, np.float32),
        z=x[:, 0].astype(np.int32) if node_feature_cols[0] == 0 else None,
    )


def load_xyz_file(path: str) -> Graph:
    """(ext)XYZ: the atom count, a comment (the graph features where it is
    all numbers), then ``Symbol x y z [extra...]`` rows; the node features
    are ``[Z, extra...]``."""
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    n = int(lines[0].split()[0])
    # an extxyz metadata line (Lattice=..., Properties=...) holds no targets
    try:
        graph_y = [float(tok) for tok in lines[1].split()]
    except ValueError:
        graph_y = []
    zs, pos, extras = [], [], []
    for line in lines[2:2 + n]:
        tok = line.split()
        z = SYMBOL_TO_Z.get(tok[0])
        zs.append(int(float(tok[0])) if z is None else z)
        pos.append([float(tok[1]), float(tok[2]), float(tok[3])])
        extras.append([float(t) for t in tok[4:]])
    x = np.asarray(zs, np.float32)[:, None]
    if extras and extras[0]:
        x = np.concatenate([x, np.asarray(extras, np.float32)], axis=1)
    senders, receivers = _empty_edges()
    return Graph(
        x=x,
        pos=np.asarray(pos, np.float32),
        senders=senders,
        receivers=receivers,
        graph_y=np.asarray(graph_y, np.float32) if graph_y else None,
        z=np.asarray(zs, np.int32),
    )


def load_cfg_file(path: str) -> Graph:
    """AtomEye extended CFG: ``Number of particles``, the ``H0(i,j)`` cell,
    ``entry_count``, optional ``auxiliary[k]`` names, then per species a
    mass line, a symbol line and one scaled-coordinate row per atom. The
    node features are ``[Z, mass, aux...]``; a sibling ``<name>.bulk``
    file's first number is the graph feature."""
    h0 = np.zeros((3, 3))
    n = None
    aux_count = 0
    rows: List[List[float]] = []
    masses: List[float] = []
    zs: List[int] = []
    cur_mass = None
    cur_z = None
    with open(path, encoding="utf-8") as f:
        for raw_line in f:
            line = raw_line.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("Number of particles"):
                n = int(line.split("=")[1])
            elif line.startswith("H0("):
                i, j = int(line[3]) - 1, int(line[5]) - 1
                h0[i, j] = float(line.split("=")[1].split()[0])
            elif line.startswith("entry_count"):
                aux_count = int(line.split("=")[1]) - 3
            elif line.startswith((".NO_VELOCITY", "A =", "R =", "auxiliary")):
                continue
            else:
                tok = line.split()
                if len(tok) == 1 and tok[0] in SYMBOL_TO_Z:
                    cur_z = SYMBOL_TO_Z[tok[0]]
                elif len(tok) == 1:
                    cur_mass = float(tok[0])
                elif len(tok) >= 3:
                    if cur_z is None:
                        raise ValueError(f"species symbol missing in CFG {path}")
                    rows.append([float(t) for t in tok[:3 + aux_count]])
                    masses.append(cur_mass if cur_mass is not None else 0.0)
                    zs.append(cur_z)
    if n is None or len(rows) != n:
        raise ValueError(f"CFG parse failed for {path}")
    scaled = np.asarray(rows, np.float64)
    pos = scaled[:, :3] @ h0  # scaled -> cartesian
    x = np.concatenate([np.asarray(zs, np.float32)[:, None],
                        np.asarray(masses, np.float32)[:, None],
                        scaled[:, 3:].astype(np.float32)], axis=1)
    graph_y = None
    bulk = os.path.splitext(path)[0] + ".bulk"
    if os.path.exists(bulk):
        with open(bulk, encoding="utf-8") as f:
            graph_y = np.asarray([float(f.readline().split()[0])], np.float32)
    senders, receivers = _empty_edges()
    return Graph(
        x=x,
        pos=pos.astype(np.float32),
        senders=senders,
        receivers=receivers,
        graph_y=graph_y,
        z=np.asarray(zs, np.int32),
        cell=h0.astype(np.float32),
    )


_LOADERS = {"LSMS": load_lsms_file, "XYZ": load_xyz_file, "CFG": load_cfg_file}
# LSMS files carry no conventional extension: every regular file is one
_EXTS = {"XYZ": (".xyz", ".extxyz"), "CFG": (".cfg",)}


def raw_sample_files(path: str) -> List[str]:
    """Sorted raw-sample file names under ``path``: regular files, not the
    ``.bulk`` sidecars."""
    return sorted(name for name in os.listdir(path)
                  if os.path.isfile(os.path.join(path, name)) and not name.endswith(".bulk"))


def load_raw_dataset(path: str, fmt: str, on_error: str = "raise",
                     **loader_kwargs) -> List[Graph]:
    """Every raw file under ``path`` through the format's parser.
    ``on_error="skip"`` drops a file the parser cannot read (warning with
    its name, then a tally); ``"raise"`` stops at it. Raises when some
    samples have graph targets and others none."""
    if on_error not in ("raise", "skip"):
        raise ValueError(f"on_error must be 'raise' or 'skip', got {on_error!r}")
    fmt = fmt.upper()
    loader = _LOADERS[fmt]
    graphs, skipped = [], []
    for name in raw_sample_files(path):
        if fmt in _EXTS and not name.lower().endswith(_EXTS[fmt]):
            continue
        try:
            graphs.append(loader(os.path.join(path, name), **loader_kwargs))
        except Exception as e:  # noqa: BLE001 — a parser failure on one file
            if on_error == "raise":
                raise
            skipped.append(name)
            if len(skipped) <= 3:
                warnings.warn(f"skipping unparseable {fmt} file {name!r}: "
                              f"{type(e).__name__}: {e}", stacklevel=2)
    if skipped:
        warnings.warn(f"{len(skipped)} of the {fmt} files under {path!r} failed to parse "
                      f"and were skipped (first: {skipped[:5]})", stacklevel=2)
    with_y = [g.graph_y is not None for g in graphs]
    if any(with_y) and not all(with_y):
        missing = [i for i, w in enumerate(with_y) if not w][:5]
        raise ValueError(
            f"{sum(not w for w in with_y)} of {len(graphs)} raw samples have no graph "
            f"targets (first sample indices {missing}); provide targets for every file "
            "or none")
    return graphs


def finalize_graphs(graphs: Sequence[Graph], radius: float,
                    max_neighbours: Optional[int] = None,
                    periodic: bool = False) -> List[Graph]:
    """Attach radius-graph edges (open, or periodic with the graph's cell)
    to edge-less raw graphs."""
    out = []
    for g in graphs:
        if periodic:
            if g.cell is None:
                raise ValueError("a periodic radius graph needs the sample's cell")
            senders, receivers, shifts = radius_graph_pbc(g.pos, g.cell, radius,
                                                          max_neighbours or 1000)
            out.append(dataclasses.replace(g, senders=senders, receivers=receivers,
                                           edge_shifts=shifts))
        else:
            senders, receivers = radius_graph(g.pos, radius, max_neighbours or 1000)
            out.append(dataclasses.replace(g, senders=senders, receivers=receivers))
    return out
