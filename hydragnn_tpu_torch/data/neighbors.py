"""Host-side radius-graph construction (open and periodic boundaries).

Counterpart of ``hydragnn_tpu/data/neighbors.py``, scipy KD-tree path only:
the JAX package hands open-boundary graphs of 4096 nodes and more to a C++
cell list, and the OC20-shaped graphs this port serves stay far below that
(at most 225 atoms). The periodic path is scipy in both packages. Same
edge sets in the same order as the JAX package's scipy paths, so the two
packages build byte-identical datasets.

Edge direction: an edge (sender j -> receiver i) carries a message from j
aggregated at i; both directions are emitted.
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree


def radius_graph(
    pos: np.ndarray,
    radius: float,
    max_neighbours: Optional[int] = None,
    loop: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """All directed edges (j -> i) with ||pos_j - pos_i|| <= radius;
    ``max_neighbours`` keeps the nearest k incoming edges per receiver.
    Returns (senders, receivers) int32 arrays."""
    pos = np.asarray(pos, np.float64)
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
