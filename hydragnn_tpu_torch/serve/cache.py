"""Content-addressed prediction cache (docs/SERVING.md "Fleet").

Counterpart of ``hydragnn_tpu/serve/cache.py``: the same keys (``graph_key``
digests are byte-identical) and entry layout.

Same storage discipline as the LapPE eigenvector cache (data/lappe.py), the
repo's proven on-disk memoization scheme, applied to inference results:

- the key is a sha256 over the graph's *input content* — every inference
  input array's name, dtype, shape, and raw bytes, plus ``dataset_id`` —
  mixed with the cache ``context``: everything BESIDES the graph that
  determines a prediction (the installed checkpoint's digest and the
  prediction-affecting serve config, e.g. ``weights_dtype``). Two
  bit-identical graphs share an entry, any single-bit input difference
  misses, and a hot-reloaded checkpoint changes the context so entries
  computed by the old weights can never be served as hits for the new
  ones. A context of ``None`` disables the cache entirely (``key_for``
  returns None) — the fleet manager parks it there while replicas
  disagree mid-rollout;
- entries are ``.npz`` files sharded by the first two hex digits
  (``cache_dir/ab/abcdef....npz``) to keep directory fan-out flat;
- stores are atomic: write to ``<path>.tmp.<pid>`` then ``os.replace`` —
  concurrent replicas racing on the same key both win, torn writes are
  impossible, and a reader never sees a partial file;
- loads are digest-verified: the entry records a sha256 over the stored
  prediction arrays, recomputed at load; any mismatch (corrupt file,
  truncation that survived the zip CRC) is treated as a miss and the
  prediction recomputed — a broken cache can cost latency, never
  correctness.

Bit-identity of hits is by construction, not best-effort: ``.npz`` is a
lossless container, so the arrays handed back on a hit are byte-for-byte
the arrays that were stored on the miss. tests/test_serve_fleet.py asserts
it with ``np.array_equal`` on exact dtypes.
"""

from __future__ import annotations

import hashlib
import io
import os
import threading
import zipfile
from typing import Dict, Optional

import numpy as np

from ..data.graph import Graph

# Graph fields that are inference *inputs* — targets deliberately excluded
# (they do not influence the prediction, and keying on them would split
# entries for identical inputs). Mirrors Graph.float_channels plus the
# integer topology/identity fields.
_KEY_FIELDS = (
    "x", "pos", "senders", "receivers", "edge_attr", "edge_shifts",
    "pe", "rel_pe", "z", "graph_y", "cell",
)


def graph_key(graph: Graph) -> str:
    """sha256 hex key over the graph's inference-input content."""
    h = hashlib.sha256()
    for name in _KEY_FIELDS:
        v = getattr(graph, name, None)
        if v is None:
            continue
        a = np.ascontiguousarray(np.asarray(v))
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    h.update(f"dataset_id={int(graph.dataset_id)}".encode())
    return h.hexdigest()


def _result_digest(result: Dict[str, np.ndarray]) -> str:
    """sha256 over the prediction arrays, order-independent."""
    h = hashlib.sha256()
    for name in sorted(result):
        a = np.ascontiguousarray(np.asarray(result[name]))
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


class PredictionCache:
    """Sharded on-disk prediction cache; safe for concurrent processes.

    ``get`` returns the cached head->array dict on a verified hit and
    ``None`` on any miss (absent, unreadable, digest mismatch); ``put``
    stores atomically and never raises on I/O failure — the cache is an
    accelerator, not a dependency. ``stats()`` exposes hit/miss/store/
    corrupt counters plus the on-disk entry/byte census for the fleet
    gauges and bench cells; the same numbers land in the process registry
    as ``hydragnn_serve_cache_{hits,misses,entries,bytes}``, so /metrics
    scrapes see cache efficacy live.

    ``context`` namespaces every key with the non-graph prediction inputs
    (checkpoint digest + serve config). The default ``""`` keys on graph
    content alone (standalone/bench use where the weights never change);
    ``None`` disables the cache until ``set_context`` supplies an
    identity — the fleet manager's mid-rollout state, where replicas
    serve different checkpoints and no shared entry is safe.
    """

    def __init__(self, cache_dir: str, context: Optional[str] = ""):
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._context = context
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.corrupt = 0
        # entry census, seeded from disk so a restarted fleet reports the
        # cache it inherited, then maintained incrementally by put/removal
        self.entries, self.bytes = self._scan()
        # telemetry plane: counters absorb the lookup tallies (set_total —
        # idempotent, so N replicas sharing one process never double
        # count), gauges carry the census; /metrics and the fleet's
        # metrics.jsonl window both render from these
        from ..obs.registry import registry as _obs_registry

        _reg = _obs_registry()
        self._m_hits = _reg.counter(
            "hydragnn_serve_cache_hits",
            "Prediction-cache lookups answered from a verified entry",
        )
        self._m_misses = _reg.counter(
            "hydragnn_serve_cache_misses",
            "Prediction-cache lookups that fell through to the model "
            "(absent, unreadable, or digest-mismatched entry)",
        )
        self._m_entries = _reg.gauge(
            "hydragnn_serve_cache_entries",
            "Prediction-cache entries currently on disk",
        )
        self._m_bytes = _reg.gauge(
            "hydragnn_serve_cache_bytes",
            "Prediction-cache bytes currently on disk",
        )
        self._publish()

    def _scan(self) -> "tuple[int, int]":
        """Count the .npz entries (and their bytes) already in the shard
        dirs — in-flight ``.tmp.<pid>`` files excluded."""
        entries = 0
        size = 0
        try:
            with os.scandir(self.cache_dir) as shards:
                shard_names = [d.name for d in shards if d.is_dir()]
            for shard in shard_names:
                with os.scandir(os.path.join(self.cache_dir, shard)) as it:
                    for f in it:
                        if f.name.endswith(".npz") and f.is_file():
                            entries += 1
                            size += f.stat().st_size
        except OSError:
            pass
        return entries, size

    def _publish(self) -> None:
        """Mirror the counters/census into the process registry. Callers
        hold ``self._lock``-free state reads only — counter absorption is
        max-merge and gauges are last-writer, so racing publishes are
        harmless."""
        self._m_hits.set_total(self.hits)
        self._m_misses.set_total(self.misses)
        self._m_entries.set(max(0, self.entries))
        self._m_bytes.set(max(0, self.bytes))

    @property
    def context(self) -> Optional[str]:
        with self._lock:
            return self._context

    def set_context(self, context: Optional[str]) -> None:
        """Swap the non-graph key component (checkpoint digest + config).
        Existing entries stay on disk under their old context — they are
        simply unreachable until the same context returns (a rollback
        re-hits them), so no eviction pass is needed for correctness."""
        with self._lock:
            self._context = context

    def key_for(self, graph: Graph, base: Optional[str] = None
                ) -> Optional[str]:
        """The effective cache key for ``graph`` under the current
        context, or ``None`` while the cache is disabled (context None).
        ``base`` short-circuits the graph hash when the caller already
        computed ``graph_key(graph)``."""
        with self._lock:
            ctx = self._context
        if ctx is None:
            return None
        base = base if base is not None else graph_key(graph)
        if not ctx:
            return base
        return hashlib.sha256(f"{base}|ctx={ctx}".encode()).hexdigest()

    def _path(self, key: str) -> str:
        return os.path.join(self.cache_dir, key[:2], key + ".npz")

    def get(self, graph: Graph, key: Optional[str] = None
            ) -> Optional[Dict[str, np.ndarray]]:
        key = key if key is not None else self.key_for(graph)
        if key is None:
            return None
        path = self._path(key)
        try:
            with np.load(path, allow_pickle=False) as z:
                stored_digest = str(z["__digest__"])
                result = {
                    n: np.asarray(z[n]) for n in z.files if n != "__digest__"
                }
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            with self._lock:
                self.misses += 1
            # an unreadable file that EXISTS will never become readable:
            # evict it (and its census share) instead of re-missing on it
            # forever; an absent file (the cold-miss case) raises on
            # getsize and stays a plain miss
            try:
                size = os.path.getsize(path)
                os.remove(path)
                with self._lock:
                    self.corrupt += 1
                    self.entries -= 1
                    self.bytes -= size
            except OSError:
                pass
            self._publish()
            return None
        if _result_digest(result) != stored_digest:
            # Corrupt entry that survived the zip CRC: drop it and recompute.
            with self._lock:
                self.corrupt += 1
                self.misses += 1
            try:
                size = os.path.getsize(path)
                os.remove(path)
                with self._lock:
                    self.entries -= 1
                    self.bytes -= size
            except OSError:
                pass
            self._publish()
            return None
        with self._lock:
            self.hits += 1
        self._publish()
        return result

    def put(self, graph: Graph, result: Dict[str, np.ndarray],
            key: Optional[str] = None) -> Optional[str]:
        key = key if key is not None else self.key_for(graph)
        if key is None:
            return None
        path = self._path(key)
        arrays = {n: np.asarray(v) for n, v in result.items()}
        payload = dict(arrays)
        payload["__digest__"] = np.asarray(_result_digest(arrays))
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            buf = io.BytesIO()
            np.savez(buf, **payload)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(buf.getvalue())
            # census delta: a replace of an existing entry (two replicas
            # racing the same key) swaps bytes, not entries
            try:
                prior = os.path.getsize(path)
                fresh = False
            except OSError:
                prior = 0
                fresh = True
            os.replace(tmp, path)
        except OSError:
            return None
        with self._lock:
            self.stores += 1
            self.entries += 1 if fresh else 0
            self.bytes += len(buf.getvalue()) - prior
        self._publish()
        return key

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "stores": self.stores,
                "corrupt": self.corrupt,
                "entries": max(0, self.entries),
                "bytes": max(0, self.bytes),
            }
