"""Laplacian positional encodings for GPS.

Counterpart of ``hydragnn_tpu/data/lappe.py``: host-side numpy, per graph
the eigenvectors of the symmetric normalized Laplacian
``L = I - D^-1/2 A D^-1/2`` for the ``k`` smallest non-trivial eigenvalues
(the constant mode skipped, missing modes of tiny graphs zero-padded, each
vector's sign fixed so its first non-zero entry is positive), plus the
relative edge encoding ``rel_pe = |pe_src - pe_dst|``.

Disk cache: the dense ``eigh`` is O(N^3) per graph and depends only on the
topology and ``k``, so each result is kept under a sha256 of
``(n, k, senders, receivers)`` as ``<dir>/<key[:2]>/<key>.npy``, the JAX
package's key and layout (either package reads the other's entries).
``Dataset.lappe_cache``: true (the default ``./logs/lappe_cache``), false
(off), or a directory; ``HYDRAGNN_LAPPE_CACHE`` overrides it (``0``/``off``
disables, ``1`` keeps the config's choice but turns it on, anything else
is the directory). Writes are atomic (a temporary file, then
``os.replace``); a corrupt or wrong-shape entry is computed again.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import List, Optional

import numpy as np

from ..utils import envflags
from .graph import Graph

_CACHE_ENV = "HYDRAGNN_LAPPE_CACHE"
_DEFAULT_CACHE_DIR = os.path.join("logs", "lappe_cache")


def resolve_cache_dir(cache=True) -> Optional[str]:
    """The cache directory of ``Dataset.lappe_cache`` (``cache``: True for
    the default directory, False/None for off, or a path) under the
    environment's override."""
    env = envflags.env_str(_CACHE_ENV)
    if env is not None:
        s = env.strip()
        if s.lower() in ("0", "off", "false", "none", ""):
            return None
        if s != "1":
            return s
        if cache is False or cache is None:
            cache = True  # "1" forces the cache on; a configured directory still wins
    if cache is False or cache is None:
        return None
    if isinstance(cache, str):
        return cache
    return _DEFAULT_CACHE_DIR


def _topology_key(n: int, senders: np.ndarray, receivers: np.ndarray, k: int) -> str:
    h = hashlib.sha256()
    h.update(np.int64(n).tobytes())
    h.update(np.int64(k).tobytes())
    h.update(np.ascontiguousarray(np.asarray(senders, np.int64)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(receivers, np.int64)).tobytes())
    return h.hexdigest()


def _cache_load(path: str, n: int, k: int) -> Optional[np.ndarray]:
    try:
        pe = np.load(path)
    except Exception:  # a missing or corrupt entry: compute again
        return None
    if pe.shape != (n, k) or not np.all(np.isfinite(pe)):
        return None
    return pe.astype(np.float32)


def _cache_store(path: str, pe: np.ndarray) -> None:
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.save(f, pe)
        os.replace(tmp, path)
    except OSError:
        pass  # the cache is best effort: the computed result still returns


def laplacian_pe(n: int, senders: np.ndarray, receivers: np.ndarray, k: int,
                 cache_dir: Optional[str] = None) -> np.ndarray:
    """[n, k] float32 eigenvectors for the k smallest non-trivial
    eigenvalues, read from and written to ``cache_dir`` where given."""
    path = None
    if cache_dir:
        key = _topology_key(n, senders, receivers, k)
        path = os.path.join(cache_dir, key[:2], key + ".npy")
        hit = _cache_load(path, n, k)
        if hit is not None:
            return hit
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
    pe = pe.astype(np.float32)
    if path is not None:
        _cache_store(path, pe)
    return pe


def add_graph_pe(graph: Graph, pe_dim: int, cache_dir: Optional[str] = None) -> Graph:
    """Attach ``pe`` [n, pe_dim] and ``rel_pe`` [e, pe_dim] to a graph."""
    pe = laplacian_pe(graph.num_nodes, graph.senders, graph.receivers, pe_dim,
                      cache_dir=cache_dir)
    rel_pe = np.abs(pe[graph.senders] - pe[graph.receivers])
    return dataclasses.replace(graph, pe=pe, rel_pe=rel_pe)


def add_dataset_pe(graphs: List[Graph], pe_dim: int, cache=True) -> List[Graph]:
    """``add_graph_pe`` over a dataset, through the cache that ``cache``
    (``Dataset.lappe_cache``) and the environment name."""
    cache_dir = resolve_cache_dir(cache)
    return [add_graph_pe(g, pe_dim, cache_dir=cache_dir) for g in graphs]
