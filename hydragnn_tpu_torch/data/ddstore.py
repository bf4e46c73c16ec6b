"""In-memory sample store over the native C++ shared-memory arena
(native/ddstore.cpp): the pyddstore / ``DistDataset`` analog.

Counterpart of ``hydragnn_tpu/data/ddstore.py`` over the port's own copy of
the C++ (built with ``g++`` at first use, native/build.py). ``DDStore`` is
the raw blob store (ctypes over the arena); ``DistDataset`` serves any
dataset out of it: the creating process serializes every sample once into
the host's arena and every loader process on the host fetches by index
(a ``DistDataset`` feeds ``GraphLoader`` like any sequence of graphs).

``MultiHostDistDataset`` is for datasets larger than one host's memory
under global shuffling: each host pins only ``1/num_hosts`` of the samples
and fetches the rest from the owning host over the store's length-prefixed
TCP plane (``RemoteStoreClient``: socket timeouts, reconnects with
exponential backoff and jitter, ``HYDRAGNN_DDSTORE_TIMEOUT`` /
``HYDRAGNN_DDSTORE_RETRIES`` / ``HYDRAGNN_DDSTORE_RETRY_BASE``). A sample
whose bytes fail to deserialize raises ``CorruptSampleError`` naming the
sample and its store. Samples are read back through the port's restricted
unpickler (data/datasets.py ``load_graph``), which also reads a store the
JAX package populated. Not ported: the fault-injection hooks.
"""

from __future__ import annotations

import ctypes
import io
import os
import pickle
import random
import time
from typing import Optional, Sequence

from ..utils import envflags
from .datasets import AbstractBaseDataset, load_graph
from .graph import Graph

_LIB = None


def _load_lib():
    """The native library, built and loaded once, every symbol typed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    from ..native.build import build_library

    lib = ctypes.CDLL(build_library("ddstore"))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    sig = {
        "dds_unlink": (ctypes.c_int, [ctypes.c_char_p]),
        "dds_open": (vp, [ctypes.c_char_p, i64, i64, ctypes.c_int]),
        "dds_put": (ctypes.c_int, [vp, i64, vp, i64]),
        "dds_get_size": (i64, [vp, i64]),
        "dds_get": (i64, [vp, i64, vp, i64]),
        "dds_count": (i64, [vp]),
        "dds_max_items": (i64, [vp]),
        "dds_used_bytes": (i64, [vp]),
        "dds_epoch": (i64, [vp]),
        "dds_epoch_begin": (None, [vp]),
        "dds_epoch_end": (None, [vp]),
        "dds_close": (None, [vp, ctypes.c_int]),
        "dds_serve_start": (vp, [vp, ctypes.c_int, i64]),
        "dds_serve_stop": (None, [vp]),
        "dds_connect_t": (vp, [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]),
        "dds_set_timeout": (None, [vp, ctypes.c_int]),
        "dds_fetch": (i64, [vp, i64]),
        "dds_fetch_read": (i64, [vp, vp, i64]),
        "dds_disconnect": (None, [vp]),
    }
    for fn, (restype, argtypes) in sig.items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    _LIB = lib
    return lib


class DDStore:
    """ctypes facade over the native shared-memory blob store. ``name`` is
    the POSIX shared-memory segment's (``shm_open``): unique per store on a
    host; ``close()`` unlinks it where this process created it."""

    def __init__(self, name: str, capacity_bytes: int = 1 << 28, max_items: int = 1 << 20,
                 create: bool = True, overwrite: bool = False):
        lib = _load_lib()
        self._lib = lib
        self.name = name
        self._server = None
        if create and overwrite:
            lib.dds_unlink(name.encode())
        self._h = lib.dds_open(name.encode(), capacity_bytes, max_items, 1 if create else 0)
        if not self._h:
            if create:
                raise FileExistsError(
                    f"shared-memory store {name!r} already exists; pick a distinct name or "
                    "pass overwrite=True to replace a stale segment from a crashed run")
            raise OSError(f"cannot attach shared-memory store {name!r}")
        self._owner = create
        self.max_items = int(lib.dds_max_items(self._h))

    def put(self, idx: int, blob: bytes) -> None:
        rc = self._lib.dds_put(self._h, idx, blob, len(blob))
        if rc == -1:
            raise MemoryError("DDStore payload arena full")
        if rc == -2:
            raise IndexError(f"id {idx} outside slot table [0, {self.max_items})")
        if rc == -3:
            raise KeyError(f"id {idx} already stored")

    def get(self, idx: int) -> bytes:
        size = self._lib.dds_get_size(self._h, idx)
        if size < 0:
            raise KeyError(idx)
        buf = ctypes.create_string_buffer(size)
        got = self._lib.dds_get(self._h, idx, buf, size)
        if got != size:
            raise OSError(f"store {self.name!r}: read {got} of {size} bytes of id {idx}")
        return buf.raw

    def __len__(self) -> int:
        return int(self._lib.dds_count(self._h))

    @property
    def used_bytes(self) -> int:
        return int(self._lib.dds_used_bytes(self._h))

    def epoch_begin(self) -> None:
        self._lib.dds_epoch_begin(self._h)

    def epoch_end(self) -> None:
        self._lib.dds_epoch_end(self._h)

    def serve(self, port: int, id_offset: int = 0) -> None:
        """Serve the published slots on ``port``; wire ids are global
        (local slot = id - ``id_offset``). The accept loop runs on a C++
        thread, outside the interpreter lock."""
        if self._server:
            raise RuntimeError("already serving")
        srv = self._lib.dds_serve_start(self._h, port, id_offset)
        if not srv:
            raise OSError(f"cannot listen on port {port}")
        self._server = srv

    def stop_serving(self) -> None:
        if self._server:
            self._lib.dds_serve_stop(self._server)
            self._server = None

    def close(self, unlink: Optional[bool] = None) -> None:
        """Detach; ``unlink`` (default: whether this process created it)
        removes the segment."""
        self.stop_serving()
        if self._h:
            self._lib.dds_close(self._h, 1 if (self._owner if unlink is None else unlink) else 0)
            self._h = None

    def __del__(self):  # pragma: no cover - interpreter teardown
        try:
            self.close(unlink=False)
        except Exception:  # noqa: BLE001
            pass


class RemoteStoreClient:
    """A persistent TCP connection fetching blobs from a serving ``DDStore``
    on another host. The socket carries send and receive timeouts
    (``HYDRAGNN_DDSTORE_TIMEOUT`` seconds), and ``get`` absorbs transient
    connection failures with a reconnect, exponential backoff and jitter,
    up to ``HYDRAGNN_DDSTORE_RETRIES`` attempts (base delay
    ``HYDRAGNN_DDSTORE_RETRY_BASE`` seconds). The final error names the
    host, port, id and attempts. Not thread-safe; fork-safe (a forked
    worker opens its own connection)."""

    def __init__(self, host: str, port: int, timeout_s: Optional[float] = None,
                 retries: Optional[int] = None, retry_base: Optional[float] = None):
        self._lib = _load_lib()
        self.host, self.port = host, port
        self.timeout_s = (envflags.env_float("HYDRAGNN_DDSTORE_TIMEOUT", 30.0)
                          if timeout_s is None else float(timeout_s))
        self.retries = max(envflags.env_int("HYDRAGNN_DDSTORE_RETRIES", 4)
                           if retries is None else int(retries), 1)
        self.retry_base = (envflags.env_float("HYDRAGNN_DDSTORE_RETRY_BASE", 0.25)
                           if retry_base is None else float(retry_base))
        self._c = None
        self._connect()

    def _connect(self) -> None:
        self._drop()
        self._c = self._lib.dds_connect_t(self.host.encode(), self.port,
                                          int(self.timeout_s * 1000))
        if not self._c:
            self._c = None
            raise ConnectionError(f"cannot connect to {self.host}:{self.port}")
        # only a successful connect records the pid: a failed reconnect
        # leaves get() connecting again, never fetching on a null handle
        self._pid = os.getpid()

    def _drop(self) -> None:
        c, self._c = getattr(self, "_c", None), None
        if c:
            self._lib.dds_disconnect(c)

    def _fetch_once(self, global_id: int) -> bytes:
        if self._c is None or os.getpid() != self._pid:
            self._connect()
        n = self._lib.dds_fetch(self._c, global_id)
        if n == -2:
            raise ConnectionError(f"connection to {self.host}:{self.port} lost (or timed out "
                                  f"after {self.timeout_s}s) fetching id {global_id}")
        if n < 0:
            raise KeyError(global_id)
        buf = ctypes.create_string_buffer(int(n))
        got = self._lib.dds_fetch_read(self._c, buf, n)
        if got != n:
            raise ConnectionError(f"short read from {self.host}:{self.port}: {got} of {n} "
                                  f"bytes of id {global_id}")
        return buf.raw

    def get(self, global_id: int) -> bytes:
        """One blob. ``KeyError`` (the server holds no such id) is final;
        a connection failure is retried on a fresh connection."""
        last: Optional[ConnectionError] = None
        for attempt in range(self.retries):
            try:
                return self._fetch_once(global_id)
            except ConnectionError as e:
                last = e
                self._drop()  # the stream is dead or out of step either way
                if attempt + 1 < self.retries and self.retry_base > 0:
                    delay = self.retry_base * (2.0**attempt)
                    time.sleep(delay * (1.0 + 0.25 * random.random()))
        raise ConnectionError(
            f"remote store {self.host}:{self.port} unreachable fetching global_id {global_id} "
            f"after {self.retries} attempts (HYDRAGNN_DDSTORE_RETRIES; socket timeout "
            f"{self.timeout_s}s via HYDRAGNN_DDSTORE_TIMEOUT): {last}") from last

    def close(self) -> None:
        self._drop()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


def _pack_graph(g: Graph) -> bytes:
    out = io.BytesIO()
    pickle.dump(g, out, protocol=pickle.HIGHEST_PROTOCOL)
    return out.getvalue()


def _unpack_graph(blob: bytes, idx: int, where: str) -> Graph:
    """A fetched sample; any failure to deserialize raises
    ``CorruptSampleError`` naming the sample and its store."""
    from .validate import CorruptSampleError

    try:
        return load_graph(io.BytesIO(blob))
    except Exception as e:  # noqa: BLE001 — any decode failure is corruption
        raise CorruptSampleError(
            f"sample {idx} from {where} failed to deserialize ({type(e).__name__}: {e}); the "
            "stored bytes are corrupt — repopulate the store, or let the sample validator "
            "quarantine it") from e


class DistDataset(AbstractBaseDataset):
    """Serve any dataset out of the shared arena. The creating process
    (``populate=True``, the default with a ``dataset``) serializes every
    sample once, then publishes a manifest in the last slot; attachers
    (``populate=False``) wait for that manifest, so none ever sees a
    partly populated store."""

    def __init__(self, dataset: Optional[Sequence[Graph]] = None, name: str = "hydragnn_dds",
                 capacity_bytes: int = 1 << 28, max_items: int = 1 << 20,
                 populate: Optional[bool] = None, overwrite: bool = False,
                 attach_timeout_s: float = 300.0):
        populate = dataset is not None if populate is None else populate
        if populate:
            self.store = DDStore(name, capacity_bytes=capacity_bytes, max_items=max_items,
                                 create=True, overwrite=overwrite)
        else:
            # a creator starting at the same time may not have opened it yet
            deadline = time.monotonic() + attach_timeout_s
            while True:
                try:
                    self.store = DDStore(name, capacity_bytes=capacity_bytes,
                                         max_items=max_items, create=False)
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)
        manifest_id = self.store.max_items - 1
        if populate:
            if dataset is None:
                raise ValueError("populate=True needs a dataset")
            n = len(dataset)
            if n > manifest_id:
                raise ValueError(
                    f"dataset has {n} samples but the store holds at most {manifest_id} (the "
                    "last slot is the manifest); raise max_items")
            for i, g in enumerate(dataset):
                self.store.put(i, _pack_graph(g))
            self.store.put(manifest_id, pickle.dumps({"len": n}))
            self._len = n
        else:
            deadline = time.monotonic() + attach_timeout_s
            while True:
                try:
                    manifest = pickle.loads(self.store.get(manifest_id))
                    break
                except KeyError:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"store {name!r} was never marked fully populated") from None
                    time.sleep(0.05)
            self._len = int(manifest["len"])

    def get(self, idx: int) -> Graph:
        return _unpack_graph(self.store.get(idx), idx,
                             f"shared-memory store {self.store.name!r}")

    def __len__(self) -> int:
        return self._len

    def epoch_begin(self) -> None:
        self.store.epoch_begin()

    def epoch_end(self) -> None:
        self.store.epoch_end()

    def close(self, unlink: Optional[bool] = None) -> None:
        self.store.close(unlink)


class MultiHostDistDataset(AbstractBaseDataset):
    """A dataset bigger than one host: each host pins a contiguous block of
    the samples in its arena and serves it over TCP; a read outside the
    local block fetches from the owning host. ``hosts`` lists every host's
    fetch endpoint in rank order (``[(address, port), ...]``); ``my_rank``
    owns the global ids ``[block * my_rank, ...)`` and populates them from
    ``shard``."""

    def __init__(self, shard: Sequence[Graph], total_len: int, hosts: Sequence, my_rank: int,
                 name: str = "hydragnn_mhdds", capacity_bytes: int = 1 << 28,
                 overwrite: bool = False):
        n_hosts = len(hosts)
        block = (total_len + n_hosts - 1) // n_hosts
        # a ceil block can leave trailing ranks an empty range
        lo = min(my_rank * block, total_len)
        hi = min(lo + block, total_len)
        if len(shard) != hi - lo:
            raise ValueError(f"rank {my_rank} owns global ids [{lo}, {hi}) = {hi - lo} "
                             f"samples, got a shard of {len(shard)}")
        self._total = total_len
        self._block = block
        self._lo = lo
        self._hosts = list(hosts)
        self._rank = my_rank
        self.store = DDStore(name, capacity_bytes=capacity_bytes, max_items=max(len(shard), 1),
                             create=True, overwrite=overwrite)
        for i, g in enumerate(shard):
            self.store.put(i, _pack_graph(g))
        self.store.serve(int(self._hosts[my_rank][1]), id_offset=lo)
        self._clients = {}

    def _client(self, owner: int) -> RemoteStoreClient:
        c = self._clients.get(owner)
        if c is None:
            host, port = self._hosts[owner]
            c = self._clients[owner] = RemoteStoreClient(host, int(port))
        return c

    def get(self, idx: int) -> Graph:
        if idx < 0:
            idx += self._total
        if not 0 <= idx < self._total:
            raise IndexError(idx)
        owner = idx // self._block
        if owner == self._rank:
            return _unpack_graph(self.store.get(idx - self._lo), idx,
                                 f"shared-memory store {self.store.name!r}")
        where = "host {}:{}".format(*self._hosts[owner])
        try:
            return _unpack_graph(self._client(owner).get(idx), idx, where)
        except ConnectionError:
            # the client retried already; rebuild the connection once more,
            # so a transient reset does not poison the cache for good
            c = self._clients.pop(owner, None)
            if c is not None:
                c.close()
            return _unpack_graph(self._client(owner).get(idx), idx, where)

    def __len__(self) -> int:
        return self._total

    def epoch_begin(self) -> None:
        self.store.epoch_begin()

    def epoch_end(self) -> None:
        self.store.epoch_end()

    def close(self, unlink: Optional[bool] = None) -> None:
        for c in self._clients.values():
            c.close()
        self._clients = {}
        self.store.close(unlink)
