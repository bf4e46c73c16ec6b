"""Laplacian positional encodings for GPS.

Counterpart of ``hydragnn_tpu/data/lappe.py``: host-side numpy, per graph
the eigenvectors of the symmetric normalized Laplacian
``L = I - D^-1/2 A D^-1/2`` for the ``k`` smallest non-trivial eigenvalues
(the constant mode skipped, missing modes of tiny graphs zero-padded, each
vector's sign fixed so its first non-zero entry is positive), plus the
relative edge encoding ``rel_pe = |pe_src - pe_dst|``.

The JAX package's optional disk cache of eigenvectors is not carried over:
every call computes. The results are the same.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .graph import Graph


def laplacian_pe(n: int, senders: np.ndarray, receivers: np.ndarray, k: int) -> np.ndarray:
    """[n, k] float32 eigenvectors for the k smallest non-trivial eigenvalues."""
    A = np.zeros((n, n), np.float64)
    A[receivers, senders] = 1.0
    A = np.maximum(A, A.T)  # symmetrize
    deg = A.sum(1)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    L = np.eye(n) - (dinv[:, None] * A * dinv[None, :])
    w, v = np.linalg.eigh(L)
    order = np.argsort(w)
    pe = v[:, order[1 : k + 1]]  # skip the trivial lowest mode
    if pe.shape[1] < k:  # tiny graphs: zero-pad the missing modes
        pe = np.concatenate([pe, np.zeros((n, k - pe.shape[1]))], axis=1)
    # deterministic sign: the first non-zero entry of each vector positive
    for c in range(pe.shape[1]):
        col = pe[:, c]
        nz = np.flatnonzero(np.abs(col) > 1e-8)
        if nz.size and col[nz[0]] < 0:
            pe[:, c] = -col
    return pe.astype(np.float32)


def add_graph_pe(graph: Graph, pe_dim: int) -> Graph:
    """Attach ``pe`` [n, pe_dim] and ``rel_pe`` [e, pe_dim] to a graph."""
    pe = laplacian_pe(graph.num_nodes, graph.senders, graph.receivers, pe_dim)
    rel_pe = np.abs(pe[graph.senders] - pe[graph.receivers])
    return dataclasses.replace(graph, pe=pe, rel_pe=rel_pe)


def add_dataset_pe(graphs: List[Graph], pe_dim: int) -> List[Graph]:
    return [add_graph_pe(g, pe_dim) for g in graphs]
