"""Coarse phase timers with a reduction across ranks.

Counterpart of ``hydragnn_tpu/utils/timers.py`` (reference:
hydragnn/utils/profiling_and_tracing/time_utils.py:22-138). ``Timer``
accumulates wall time per named phase in class-level state; ``print_timers``
reduces the per-rank totals to min/avg/max over the ranks of a joined
``torch.distributed`` group (every rank must call it then) and prints the
table on rank 0. Outside a group the reduction is the identity.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from . import ranks


class Timer:
    _totals: Dict[str, float] = {}
    _counts: Dict[str, int] = {}

    def __init__(self, name: str):
        self.name = name
        self._start = None

    def start(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def stop(self) -> float:
        assert self._start is not None, f"Timer {self.name} not started"
        dt = time.perf_counter() - self._start
        Timer._totals[self.name] = Timer._totals.get(self.name, 0.0) + dt
        Timer._counts[self.name] = Timer._counts.get(self.name, 0) + 1
        self._start = None
        return dt

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    @classmethod
    def reset(cls) -> None:
        cls._totals.clear()
        cls._counts.clear()

    @classmethod
    def totals(cls) -> Dict[str, float]:
        return dict(cls._totals)


def _reduce_across_ranks(values: np.ndarray) -> Dict[str, np.ndarray]:
    """min/avg/max over the ranks of the joined group; the identity for one."""
    if ranks.world_size() == 1:
        return {"min": values, "avg": values, "max": values}
    import torch
    import torch.distributed as dist

    # a CPU tensor needs gloo; under NCCL the collective runs on the rank's GPU
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.as_tensor(values, dtype=torch.float64, device=device)
    lo, hi, tot = t.clone(), t.clone(), t.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(tot, op=dist.ReduceOp.SUM)
    return {"min": lo.cpu().numpy(), "avg": tot.cpu().numpy() / ranks.world_size(),
            "max": hi.cpu().numpy()}


def print_timers(verbosity: int = 1) -> None:
    """(reference: time_utils.py:95-138; the table on rank 0 only, after the
    reduction every rank joins)"""
    if verbosity <= 0 or not Timer._totals:
        return
    names = sorted(Timer._totals)
    vals = np.asarray([Timer._totals[n] for n in names])
    red = _reduce_across_ranks(vals)
    if not ranks.is_primary():
        return
    width = max(len(n) for n in names)
    print(f"{'timer'.ljust(width)}  count  min(s)      avg(s)      max(s)")
    for i, n in enumerate(names):
        print(
            f"{n.ljust(width)}  {Timer._counts[n]:<5d}"
            f"  {red['min'][i]:<10.4f}  {red['avg'][i]:<10.4f}  {red['max'][i]:<10.4f}"
        )
