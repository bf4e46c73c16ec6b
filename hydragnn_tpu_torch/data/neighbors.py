"""Host-side radius-graph construction (open and periodic boundaries).

Counterpart of ``hydragnn_tpu/data/neighbors.py``. Open-boundary systems of
``_NATIVE_MIN_N`` (4,096) nodes and more go to the C++ cell list
(native/neighbors.cpp, the port's copy of the JAX package's source, built
with ``g++`` at first use); smaller ones to scipy's KD-tree.
``HYDRAGNN_NATIVE_NEIGHBORS`` forces the cell list on (``1``) or off
(``0``). A cell list that cannot be built raises: the KD-tree takes over
only where the caller turned the route off. The periodic path is scipy in
both packages. Each route gives the same edges in the same order as the
JAX package's same route (the cell list: receiver-major, senders
ascending; the KD-tree: its pair order), so the two packages build
byte-identical datasets; the two routes give the same edge set.

Edge direction: an edge (sender j -> receiver i) carries a message from j
aggregated at i; both directions are emitted.
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

from ..utils import envflags

# node count from which the cell list takes over from the KD-tree (the JAX
# package's threshold; the cell list scales linearly in N)
_NATIVE_MIN_N = 4096
_native = None


def _native_lib():
    """The cell-list library (native/neighbors.cpp), built at first use;
    a failed build raises ``RuntimeError`` with the compiler's output."""
    global _native
    if _native is None:
        import ctypes

        from ..native.build import build_library

        lib = ctypes.CDLL(build_library("neighbors"))
        lib.rg_open.restype = ctypes.c_long
        lib.rg_open.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_double,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
        ]
        _native = lib
    return _native


def _radius_graph_native(pos: np.ndarray, radius: float) -> Tuple[np.ndarray, np.ndarray]:
    """Every directed edge within ``radius`` from the cell list,
    receiver-major with ascending senders."""
    import ctypes

    lib = _native_lib()
    pos = np.ascontiguousarray(pos, np.float64)
    n = pos.shape[0]
    cap = max(64 * n, 1024)
    while True:
        senders = np.empty(cap, np.int32)
        receivers = np.empty(cap, np.int32)
        m = lib.rg_open(pos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, float(radius),
                        senders.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                        receivers.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        if m >= 0:
            return senders[:m].copy(), receivers[:m].copy()
        cap = -m  # the exact size needed


def _use_native(n: int) -> bool:
    pref = envflags.env_str("HYDRAGNN_NATIVE_NEIGHBORS")
    return pref == "1" or (pref != "0" and n >= _NATIVE_MIN_N)


def radius_graph(
    pos: np.ndarray,
    radius: float,
    max_neighbours: Optional[int] = None,
    loop: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """All directed edges (j -> i) with ||pos_j - pos_i|| <= radius;
    ``max_neighbours`` keeps the nearest k incoming edges per receiver.
    Returns (senders, receivers) int32 arrays. Systems of ``_NATIVE_MIN_N``
    nodes and more go through the cell list (``_use_native``)."""
    pos = np.asarray(pos, np.float64)
    if _use_native(pos.shape[0]):
        senders, receivers = _radius_graph_native(pos, radius)
    else:
        pairs = cKDTree(pos).query_pairs(r=radius, output_type="ndarray")  # i<j
        if pairs.size == 0:
            senders = np.zeros((0,), np.int32)
            receivers = np.zeros((0,), np.int32)
        else:
            senders = np.concatenate([pairs[:, 0], pairs[:, 1]]).astype(np.int32)
            receivers = np.concatenate([pairs[:, 1], pairs[:, 0]]).astype(np.int32)
    if loop:
        idx = np.arange(pos.shape[0], dtype=np.int32)
        senders = np.concatenate([senders, idx])
        receivers = np.concatenate([receivers, idx])
    if max_neighbours is not None:
        senders, receivers, _ = _cap_neighbours(pos, senders, receivers, None, max_neighbours)
    return senders, receivers


def radius_graph_pbc(
    pos: np.ndarray,
    cell: np.ndarray,
    radius: float,
    max_neighbours: Optional[int] = None,
    pbc: Tuple[bool, bool, bool] = (True, True, True),
    max_attempts: int = 3,
    radius_multiplier: float = 1.25,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Radius graph under periodic boundary conditions: each edge carries
    the cartesian shift of its sender's image, so ``pos[s] + shift -
    pos[r]`` is the displacement. A node left with no in-edge expands the
    radius by ``radius_multiplier`` and retries, up to ``max_attempts``
    builds; a node still isolated after the last gets one artificial in-edge
    from ``(i + 1) % n`` with a zero shift. Returns (senders, receivers,
    edge_shifts [e, 3] float32)."""
    n = np.asarray(pos).shape[0]
    r = float(radius)
    for attempt in range(max_attempts):
        senders, receivers, shifts = _radius_graph_pbc_once(pos, cell, r, max_neighbours, pbc)
        if np.unique(receivers).size == n:
            return senders, receivers, shifts
        if attempt < max_attempts - 1:
            r *= radius_multiplier
    missing = np.setdiff1d(np.arange(n), np.unique(receivers))
    add_s = np.array([(m + 1) % n if n > 1 else 0 for m in missing], np.int32)
    senders = np.concatenate([senders, add_s])
    receivers = np.concatenate([receivers, missing.astype(np.int32)])
    shifts = np.concatenate([shifts, np.zeros((missing.size, 3), shifts.dtype)], axis=0)
    return senders, receivers, shifts


def _radius_graph_pbc_once(pos, cell, radius: float, max_neighbours: Optional[int], pbc):
    """One periodic build at a fixed radius: for every image shift that can
    reach within ``radius`` (in order), receivers ascending, each
    receiver's senders in the KD-tree's order; no self loop in the home
    cell."""
    pos = np.asarray(pos, np.float64)
    cell = np.asarray(cell, np.float64).reshape(3, 3)
    n = pos.shape[0]
    # repeats of each lattice vector needed to cover the radius
    heights = 1.0 / np.linalg.norm(np.linalg.inv(cell), axis=0)
    reps = [int(np.ceil(radius / h)) if p else 0 for h, p in zip(heights, pbc)]
    shifts_frac = np.array(
        [(a, b, c)
         for a in range(-reps[0], reps[0] + 1)
         for b in range(-reps[1], reps[1] + 1)
         for c in range(-reps[2], reps[2] + 1)],
        np.float64,
    )
    shifts_cart = shifts_frac @ cell
    tree = cKDTree(pos)
    senders_l, receivers_l, shift_l = [], [], []
    for sf, sc in zip(shifts_frac, shifts_cart):
        pairs = tree.query_ball_tree(cKDTree(pos + sc), r=radius)  # receiver -> senders
        counts = np.fromiter(map(len, pairs), np.int64, n)
        receivers = np.repeat(np.arange(n), counts)
        senders = np.fromiter(itertools.chain.from_iterable(pairs), np.int64, int(counts.sum()))
        if not sf.any():
            keep = senders != receivers
            senders, receivers = senders[keep], receivers[keep]
        senders_l.append(senders)
        receivers_l.append(receivers)
        shift_l.append(np.broadcast_to(sc, (senders.size, 3)))
    senders = np.concatenate(senders_l).astype(np.int32)
    receivers = np.concatenate(receivers_l).astype(np.int32)
    shifts = np.concatenate(shift_l).astype(np.float64)
    if max_neighbours is not None:
        senders, receivers, shifts = _cap_neighbours(pos, senders, receivers, shifts,
                                                     max_neighbours)
    return senders, receivers, shifts.astype(np.float32)


def _cap_neighbours(pos, senders, receivers, shifts, k):
    """Keep only the k nearest incoming edges per receiver node (with
    ``shifts``, the periodic displacement's length); the sender index breaks
    distance ties so the kept set is deterministic."""
    if senders.size == 0:
        return senders, receivers, shifts
    disp = pos[senders] - pos[receivers]
    if shifts is not None:
        disp = disp + shifts
    d = np.linalg.norm(disp, axis=1)
    order = np.lexsort((senders, d, receivers))
    recv_sorted = receivers[order]
    # rank of each sorted edge within its receiver's run
    starts = np.flatnonzero(np.r_[True, recv_sorted[1:] != recv_sorted[:-1]])
    run_len = np.diff(np.r_[starts, order.size])
    rank = np.arange(order.size) - np.repeat(starts, run_len)
    keep = np.zeros(senders.shape[0], bool)
    keep[order[rank < k]] = True
    if shifts is None:
        return senders[keep], receivers[keep], None
    return senders[keep], receivers[keep], shifts[keep]


def edge_vectors_and_lengths(
    pos: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    shifts: Optional[np.ndarray] = None,
    eps: float = 1e-12,
) -> Tuple[np.ndarray, np.ndarray]:
    """Displacement sender -> receiver (less the sender image's shift) and
    its length ``sqrt(|vec|^2 + eps)``, in numpy."""
    vec = pos[receivers] - pos[senders]
    if shifts is not None:
        vec = vec - shifts
    length = np.sqrt(np.sum(vec * vec, axis=1) + eps)
    return vec, length
