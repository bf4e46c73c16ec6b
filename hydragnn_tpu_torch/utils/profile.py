"""Device profiler: the ``NeuralNetwork.Profile`` section on
``torch.profiler`` (reference: hydragnn/utils/profiling_and_tracing/
profile.py:9-70).

Counterpart of ``hydragnn_tpu/utils/profile.py``. ``{"enable": 1,
"target_epoch": N}`` captures that epoch, CPU and CUDA activities, into a
Chrome/Perfetto trace under ``log_dir`` (``logs/<run>/profile`` from the
training loop); a null context otherwise. ``peak_memory_stats`` and
``print_peak_memory`` read ``torch.cuda.max_memory_allocated``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional


def profiler_activities():
    """The activities a capture records: the CPU, and CUDA where a GPU is
    present."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def export_trace(prof, out_dir: str, name: str = "trace.json") -> str:
    """Write ``prof``'s Chrome/Perfetto trace to ``out_dir/name``."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    prof.export_chrome_trace(path)
    return path


def _synchronize() -> None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Profiler:
    def __init__(self, config: Optional[Dict[str, Any]] = None, log_dir: str = "./logs/profile"):
        config = config or {}
        self.enabled = bool(config.get("enable", 0))
        self.target_epoch = int(config.get("target_epoch", 0))
        self.log_dir = config.get("log_dir", log_dir)
        self._prof = None

    def setup(self, config: Optional[Dict[str, Any]]) -> "Profiler":
        """(reference: profile.py:30-44 reads the Profile config section)"""
        if config:
            self.enabled = bool(config.get("enable", 0))
            self.target_epoch = int(config.get("target_epoch", self.target_epoch))
            self.log_dir = config.get("log_dir", self.log_dir)
        return self

    @property
    def active(self) -> bool:
        return self._prof is not None

    def epoch_begin(self, epoch: int) -> None:
        if self.enabled and epoch == self.target_epoch and self._prof is None:
            import torch

            self._prof = torch.profiler.profile(activities=profiler_activities())
            self._prof.__enter__()

    def epoch_end(self, epoch: int) -> None:
        if self._prof is not None and epoch == self.target_epoch:
            self._finish()

    def _finish(self) -> None:
        prof, self._prof = self._prof, None
        _synchronize()
        prof.__exit__(None, None, None)
        export_trace(prof, self.log_dir)

    def close(self) -> None:
        if self._prof is not None:
            self._finish()


def peak_memory_stats() -> Dict[str, float]:
    """Peak bytes allocated per local CUDA device (reference prints
    torch.cuda.max_memory_allocated, distributed.py:354-361); empty
    without a GPU."""
    import torch

    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": float(torch.cuda.max_memory_allocated(i))
            for i in range(torch.cuda.device_count())
            if torch.cuda.is_initialized()}


def print_peak_memory(verbosity: int = 1, prefix: str = "") -> None:
    if verbosity <= 0:
        return
    for dev, peak in peak_memory_stats().items():
        print(f"{prefix}{dev}: peak memory {peak / 2**20:.1f} MiB")
