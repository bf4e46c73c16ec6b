"""Sharded columnar graph dataset.

Counterpart of ``hydragnn_tpu/data/columnar.py``, with the same on-disk
format, so each package reads what the other wrote:

- one directory per dataset, one ``shard<k>/`` per writer process; every
  field is a flat binary file (``<field>.bin``, C order, the samples
  concatenated along axis 0) plus an int64 per-sample counts table
  (``<field>.counts.npy``); ``meta.json`` records the dtypes, trailing
  shapes and attributes; ``/`` in a field name is ``__`` on disk;
- per-sample strings are UTF-8 uint8 columns under ``strings/<name>``;
- read modes: ``mmap`` (lazy ``np.memmap`` slices), ``preload``
  (everything in RAM) and ``shmem`` (one copy per host in POSIX shared
  memory, named after the file, attached by every loader process).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from .datasets import AbstractBaseDataset
from .graph import Graph

_OPTIONAL_FIELDS = ("edge_attr", "edge_shifts", "pe", "rel_pe", "z", "graph_y", "cell")


def _graph_fields(g: Graph) -> Dict[str, np.ndarray]:
    out = {
        "x": np.asarray(g.x),
        "pos": np.asarray(g.pos),
        "senders": np.asarray(g.senders),
        "receivers": np.asarray(g.receivers),
        "dataset_id": np.asarray([g.dataset_id], np.int64),
    }
    for f in _OPTIONAL_FIELDS:
        v = getattr(g, f)
        if v is not None:
            out[f] = np.asarray(v)
    for name, v in (g.graph_targets or {}).items():
        out[f"graph_targets/{name}"] = np.atleast_1d(np.asarray(v))
    for name, v in (g.node_targets or {}).items():
        out[f"node_targets/{name}"] = np.asarray(v)
    return out


class ColumnarWriter:
    """Accumulate graphs and write one shard of a columnar dataset; each
    writer process owns its shard directory (``shard_index``)."""

    def __init__(self, path: str, shard_index: int = 0):
        self.path = path
        self.shard_dir = os.path.join(path, f"shard{shard_index:05d}")
        self._fields: Dict[str, List[np.ndarray]] = {}
        self._strings: Dict[str, List[str]] = {}
        self._attrs: Dict[str, Any] = {}
        self._n = 0

    def add(self, graphs) -> "ColumnarWriter":
        if isinstance(graphs, Graph):
            graphs = [graphs]
        for g in graphs:
            fields = _graph_fields(g)
            if self._fields and set(fields) != set(self._fields):
                raise ValueError(
                    f"inconsistent fields: {sorted(set(fields) ^ set(self._fields))}")
            for k, v in fields.items():
                self._fields.setdefault(k, []).append(v)
            self._n += 1
        return self

    def add_global(self, name: str, value: Any) -> None:
        """A dataset attribute (``meta.json`` ``attrs``)."""
        self._attrs[name] = value

    def add_string(self, name: str, values) -> "ColumnarWriter":
        """Per-sample strings, one per added graph."""
        if isinstance(values, str):
            values = [values]
        self._strings.setdefault(name, []).extend(str(v) for v in values)
        return self

    def save(self) -> str:
        os.makedirs(self.shard_dir, exist_ok=True)
        meta: Dict[str, Any] = {"num_samples": self._n, "fields": {}, "attrs": {}}
        # string columns merge into a local map, so save() stays idempotent
        merged: Dict[str, list] = dict(self._fields)
        for name, vals in self._strings.items():
            if len(vals) != self._n:
                raise ValueError(
                    f"string column {name!r} has {len(vals)} values for {self._n} samples")
            key = f"strings/{name}"
            if key in merged:
                raise ValueError(f"duplicate column {key!r}")
            merged[key] = [np.frombuffer(v.encode("utf-8"), np.uint8) for v in vals]
        for k, arrs in merged.items():
            suffix = list(arrs[0].shape[1:])
            dtype = np.dtype(arrs[0].dtype)
            if any(list(a.shape[1:]) != suffix or a.dtype != dtype for a in arrs):
                raise ValueError(f"field {k!r} has inconsistent trailing shape/dtype")
            counts = np.asarray([a.shape[0] for a in arrs], np.int64)
            flat = (np.concatenate(arrs, axis=0) if counts.sum() > 0
                    else np.zeros((0, *suffix), dtype))
            safe = k.replace("/", "__")
            flat.tofile(os.path.join(self.shard_dir, f"{safe}.bin"))
            np.save(os.path.join(self.shard_dir, f"{safe}.counts.npy"), counts)
            meta["fields"][k] = {"dtype": dtype.str, "suffix": suffix}
        for name, v in self._attrs.items():
            meta["attrs"][name] = v.tolist() if isinstance(v, (np.ndarray, np.generic)) else v
        with open(os.path.join(self.shard_dir, "meta.json"), "w") as f:
            json.dump(meta, f)
        return self.shard_dir


class ColumnarDataset(AbstractBaseDataset):
    """A (multi-shard) columnar dataset read as ``Graph`` samples, in shard
    order. ``mode``: ``mmap``, ``preload`` or ``shmem``."""

    def __init__(self, path: str, mode: str = "mmap"):
        if mode not in ("mmap", "preload", "shmem"):
            raise ValueError(f"mode must be 'mmap', 'preload' or 'shmem', got {mode!r}")
        self.path = path
        self.mode = mode
        self._shm_names: List[str] = []
        shards = sorted(d for d in os.listdir(path) if d.startswith("shard"))
        if not shards:
            raise FileNotFoundError(f"no shards under {path}")
        self._shards = []
        self.attrs: Dict[str, Any] = {}
        total = 0
        for s in shards:
            sdir = os.path.join(path, s)
            with open(os.path.join(sdir, "meta.json")) as f:
                meta = json.load(f)
            self.attrs.update(meta.get("attrs", {}))
            fields = {}
            for k, fmeta in meta["fields"].items():
                safe = k.replace("/", "__")
                counts = np.load(os.path.join(sdir, f"{safe}.counts.npy"))
                offsets = np.concatenate([[0], np.cumsum(counts)])
                arr = self._open_array(os.path.join(sdir, f"{safe}.bin"),
                                       np.dtype(fmeta["dtype"]), tuple(fmeta["suffix"]))
                fields[k] = (arr, counts, offsets)
            self._shards.append((total, meta["num_samples"], fields))
            total += meta["num_samples"]
        self._total = total

    def _open_array(self, path: str, dtype: np.dtype, suffix: tuple) -> np.ndarray:
        width = int(np.prod(suffix)) if suffix else 1
        n = os.path.getsize(path) // (dtype.itemsize * max(width, 1))
        shape = (n, *suffix)
        if n == 0:  # a shard can have zero rows for a field
            return np.zeros(shape, dtype)
        if self.mode == "mmap":
            return np.memmap(path, dtype=dtype, mode="r", shape=shape)
        if self.mode == "preload":
            return np.fromfile(path, dtype=dtype).reshape(shape)
        arr, name = _shared_memory_array(path, dtype, shape)
        self._shm_names.append(name)
        return arr

    def close(self, unlink: bool = False) -> None:
        """Release the shared-memory segments of this dataset: the creating
        process unlinks its segments, an attacher only detaches unless
        ``unlink``. Arrays returned by ``get`` before must not be used
        after."""
        import gc

        # the field arrays are views into the segments' buffers: drop them
        # first, or closing a segment raises BufferError
        self._shards = []
        gc.collect()
        for name in self._shm_names:
            entry = _SHM_CACHE.pop(name, None)
            if entry is None:
                continue
            shm, created = entry
            if created or unlink:
                try:
                    shm.unlink()
                except FileNotFoundError:
                    pass
            try:
                shm.close()
            except BufferError:
                pass  # views the caller holds keep the mapping until collected
        self._shm_names = []

    def __len__(self) -> int:
        return self._total

    def _locate(self, idx: int):
        if idx < 0:
            idx += self._total
        for start, n, fields in self._shards:
            if start <= idx < start + n:
                return fields, idx - start
        raise IndexError(idx)

    def get(self, idx: int) -> Graph:
        return self._build(*self._locate(idx))

    def string_columns(self) -> List[str]:
        """Names of the per-sample string columns."""
        return sorted({k.split("/", 1)[1] for _, _, fields in self._shards for k in fields
                       if k.startswith("strings/")})

    def get_string(self, name: str, idx: int) -> str:
        """Sample ``idx``'s string of column ``name``."""
        fields, i = self._locate(idx)
        key = f"strings/{name}"
        if key not in fields:
            raise KeyError(f"no string column {name!r}; have {self.string_columns()}")
        arr, _, offsets = fields[key]
        return bytes(np.array(arr[offsets[i]:offsets[i + 1]])).decode("utf-8")

    def _build(self, fields, i: int) -> Graph:
        def take(k):
            arr, _, offsets = fields[k]
            return np.array(arr[offsets[i]:offsets[i + 1]])

        graph_targets, node_targets = {}, {}
        opt: Dict[str, Optional[np.ndarray]] = {f: None for f in _OPTIONAL_FIELDS}
        for k in fields:
            if k.startswith("graph_targets/"):
                graph_targets[k.split("/", 1)[1]] = take(k)
            elif k.startswith("node_targets/"):
                node_targets[k.split("/", 1)[1]] = take(k)
            elif k in opt:
                opt[k] = take(k)
        z = opt.pop("z")
        return Graph(
            x=take("x"),
            pos=take("pos"),
            senders=take("senders").astype(np.int32),
            receivers=take("receivers").astype(np.int32),
            dataset_id=int(take("dataset_id")[0]),
            graph_targets=graph_targets or None,
            node_targets=node_targets or None,
            z=None if z is None else z.astype(np.int32),
            **opt,
        )


# segment name -> (SharedMemory, created by this process)
_SHM_CACHE: Dict[str, Any] = {}


def _shared_memory_array(path: str, dtype: np.dtype, shape: tuple):
    """The file's array in POSIX shared memory, one copy per host.

    The segment's name is a digest of the absolute path, size and mtime
    (a regenerated file gets a fresh segment). The creator copies the data
    and then sets a trailing sentinel byte; an attacher waits for it, so a
    partly copied buffer is never read."""
    import hashlib
    import time
    from multiprocessing import shared_memory

    st = os.stat(path)
    key = f"{os.path.abspath(path)}:{st.st_size}:{st.st_mtime_ns}"
    name = "hgnn_" + hashlib.sha1(key.encode()).hexdigest()[:24]
    nbytes = max(int(np.prod(shape)) * dtype.itemsize, 1)
    if name in _SHM_CACHE:
        shm, _ = _SHM_CACHE[name]
    else:
        created = False
        try:
            shm = shared_memory.SharedMemory(name=name, create=True, size=nbytes + 1)
            created = True
            data = np.fromfile(path, dtype=dtype).reshape(shape)
            np.frombuffer(shm.buf, dtype=dtype, count=data.size)[:] = data.ravel()
            shm.buf[nbytes] = 1  # the readiness sentinel, set last
        except FileExistsError:
            shm = shared_memory.SharedMemory(name=name, create=False)
            # the resource tracker would unlink an attached segment when
            # this process exits (Python < 3.13): only the creator owns it
            try:
                from multiprocessing import resource_tracker

                resource_tracker.unregister(shm._name, "shared_memory")
            except Exception:
                pass
            deadline = time.monotonic() + 300.0
            while shm.buf[nbytes] != 1:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"shared segment {name!r} never became ready (its creator likely "
                        f"stopped mid-copy); remove /dev/shm/{name} and retry")
                time.sleep(0.05)
        _SHM_CACHE[name] = (shm, created)
    arr = np.frombuffer(shm.buf, dtype=dtype, count=int(np.prod(shape))).reshape(shape)
    return arr, name
