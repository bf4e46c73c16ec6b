"""Training-metric writer: ``scalars.jsonl`` always, TensorBoard when it
imports.

Counterpart of ``hydragnn_tpu/utils/writer.py`` (reference: the rank-0
``SummaryWriter``, hydragnn/utils/model/model.py:109-115; per-epoch scalars
train_validate_test.py:198-205). Every scalar goes to
``<path>/<log name>/scalars.jsonl`` (machine-readable, no dependency) and to
a ``torch.utils.tensorboard.SummaryWriter`` when that imports. Rank 0 only.

TensorBoard writes its event files with its own TensorFlow stub whenever
the ``tensorboard.compat.notf`` marker module exists (the switch of its
TensorFlow-free install). The writer sets that marker when TensorFlow is
not already imported, so mirroring scalars never pulls TensorFlow (tens
of seconds and a large resident set) into a training process.
"""

from __future__ import annotations

import json
import os
import sys
import types
from typing import Dict

from .ranks import is_primary


class MetricsWriter:
    def __init__(self, log_name: str, path: str = "./logs"):
        self.run_dir = os.path.join(path, log_name)
        self._jsonl = None
        self._tb = None
        if not is_primary():
            return
        os.makedirs(self.run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.run_dir, "scalars.jsonl"), "a")
        try:
            if "tensorflow" not in sys.modules:
                sys.modules.setdefault("tensorboard.compat.notf",
                                       types.ModuleType("tensorboard.compat.notf"))
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=self.run_dir)
        except Exception:
            self._tb = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._jsonl is None:
            return
        self._jsonl.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n"
        )
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def add_scalars(self, scalars: Dict[str, float], step: int) -> None:
        for tag, v in scalars.items():
            self.add_scalar(tag, v, step)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
