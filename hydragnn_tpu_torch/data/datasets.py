"""On-disk dataset classes: the abstract base, the per-sample pickle store
and its writer.

Counterpart of ``hydragnn_tpu/data/datasets.py``, with the same on-disk
layout: ``<label>-meta.json`` (``ntotal``, ``use_subdir``, ``minmax``,
``hosts``) beside one ``<label>-<idx>.pkl`` per sample, under
``<idx // 1000>/`` with ``use_subdir``. Each package reads what the other
wrote. A pickle written by the JAX package names its ``Graph`` class
(``hydragnn_tpu.data.graph.Graph``); ``SimplePickleDataset`` reads through
an unpickler that maps that name to this package's ``Graph`` (the same 14
fields), allows numpy's own globals, and refuses every other global, so a
read never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from abc import ABC, abstractmethod
from typing import Any, Dict, Iterator, List, Optional

from .graph import Graph

# Known multi-dataset ids for GFM training
DATASET_NAME_IDS = {
    "ani1x": 0,
    "qm7x": 1,
    "mptrj": 2,
    "alexandria": 3,
    "transition1x": 4,
    "omat24": 5,
}

# the class names a pickled sample may carry: the JAX package's and ours
_GRAPH_NAMES = {("hydragnn_tpu.data.graph", "Graph"), ("hydragnn_tpu_torch.data.graph", "Graph")}


class _GraphUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in _GRAPH_NAMES:
            return Graph
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing to load global {module}.{name} from a sample")


def load_graph(f) -> Graph:
    """One pickled sample from an open binary file."""
    return _GraphUnpickler(f).load()


class AbstractBaseDataset(ABC):
    """Random access to ``Graph`` samples: ``get`` and ``__len__``."""

    @abstractmethod
    def get(self, idx: int) -> Graph:
        ...

    @abstractmethod
    def __len__(self) -> int:
        ...

    def __getitem__(self, idx: int) -> Graph:
        g = self.get(idx)
        name = getattr(self, "dataset_name", None)
        if name in DATASET_NAME_IDS and g.dataset_id == 0:
            g.dataset_id = DATASET_NAME_IDS[name]
        return g

    def __iter__(self) -> Iterator[Graph]:
        for i in range(len(self)):
            yield self[i]


class SimplePickleDataset(AbstractBaseDataset):
    """Per-sample ``.pkl`` files and a json meta header."""

    def __init__(self, basedir: str, label: str):
        self.basedir = basedir
        self.label = label
        self.dataset_name = label
        with open(os.path.join(basedir, f"{label}-meta.json")) as f:
            self.meta: Dict[str, Any] = json.load(f)
        self.ntotal = int(self.meta["ntotal"])
        self.use_subdir = bool(self.meta.get("use_subdir", False))

    def _fname(self, idx: int) -> str:
        base = self.basedir
        if self.use_subdir:
            base = os.path.join(base, str(idx // 1000))
        return os.path.join(base, f"{self.label}-{idx}.pkl")

    def get(self, idx: int) -> Graph:
        with open(self._fname(idx), "rb") as f:
            return load_graph(f)

    def __len__(self) -> int:
        return self.ntotal

    @property
    def minmax(self) -> Optional[Dict[str, Any]]:
        return self.meta.get("minmax")


class SimplePickleWriter:
    """Write ``graphs`` as one pickle per sample plus the meta header; a
    host of ``host_count`` writes its own index range from ``offset``."""

    def __init__(
        self,
        graphs: List[Graph],
        basedir: str,
        label: str,
        minmax: Optional[Dict[str, Any]] = None,
        use_subdir: bool = False,
        host_count: int = 1,
        host_index: int = 0,
        nglobal: Optional[int] = None,
        offset: Optional[int] = None,
    ):
        os.makedirs(basedir, exist_ok=True)
        ntotal = nglobal if nglobal is not None else len(graphs)
        start = offset if offset is not None else 0
        if host_index == 0:
            meta = {"ntotal": ntotal, "use_subdir": use_subdir, "minmax": minmax,
                    "hosts": host_count}
            with open(os.path.join(basedir, f"{label}-meta.json"), "w") as f:
                json.dump(meta, f)
        for i, g in enumerate(graphs):
            idx = start + i
            base = basedir
            if use_subdir:
                base = os.path.join(basedir, str(idx // 1000))
                os.makedirs(base, exist_ok=True)
            with open(os.path.join(base, f"{label}-{idx}.pkl"), "wb") as f:
                # a fresh copy: the fields only, no cached properties
                pickle.dump(dataclasses.replace(g), f)
