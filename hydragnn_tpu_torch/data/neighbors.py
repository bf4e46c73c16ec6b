"""Host-side radius-graph construction (open boundary conditions).

Counterpart of ``hydragnn_tpu/data/neighbors.py``, scipy KD-tree path only:
the JAX package hands graphs of 4096 nodes and more to a C++ cell list,
and the OC20-shaped graphs this port serves stay far below that (at most
225 atoms). Same edge set and the same order as the JAX package's scipy
path, so the two packages build byte-identical datasets.

Edge direction: an edge (sender j -> receiver i) carries a message from j
aggregated at i; both directions are emitted.
"""

from __future__ import annotations

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
        senders, receivers = _cap_neighbours(pos, senders, receivers, max_neighbours)
    return senders, receivers


def _cap_neighbours(pos, senders, receivers, k):
    """Keep only the k nearest incoming edges per receiver node; the sender
    index breaks distance ties so the kept set is deterministic."""
    if senders.size == 0:
        return senders, receivers
    d = np.linalg.norm(pos[senders] - pos[receivers], axis=1)
    order = np.lexsort((senders, d, receivers))
    recv_sorted = receivers[order]
    # rank of each sorted edge within its receiver's run
    starts = np.flatnonzero(np.r_[True, recv_sorted[1:] != recv_sorted[:-1]])
    run_len = np.diff(np.r_[starts, order.size])
    rank = np.arange(order.size) - np.repeat(starts, run_len)
    keep = np.zeros(senders.shape[0], bool)
    keep[order[rank < k]] = True
    return senders[keep], receivers[keep]
