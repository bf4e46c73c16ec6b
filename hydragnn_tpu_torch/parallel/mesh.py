"""Process groups: the ``torch.distributed`` counterpart of the device mesh.

Counterpart of ``hydragnn_tpu/parallel/mesh.py``. One process drives one
GPU; ``setup_distributed`` joins the ranks of a launch into the default
process group (NCCL on the card, gloo when the caller asks for the CPU),
``Grid`` is the data x model layout of the ranks (the ``make_mesh2d``
analog), and ``gather_across_hosts`` concatenates per-rank arrays of
different lengths.

Rank ``g`` sits at model index ``g // data_size`` and data index
``g % data_size``: the model-major row order of the reference's
``batch_axes``, so global row ``g`` serves branch ``g // (rows /
branches)`` as ``BranchRoutedLoader`` deals it.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils import envflags
from ..utils.ranks import joined, local_rank_from_env, world_from_env

DATA_AXIS = "data"
MODEL_AXIS = "model"

DEFAULT_PORT = 12355


def local_host_info() -> Tuple[int, int]:
    """(world size, rank): the live process group when joined, the
    scheduler's environment otherwise."""
    if joined():
        return dist.get_world_size(), dist.get_rank()
    return world_from_env() or (1, 0)


def world_size(group=None) -> int:
    return dist.get_world_size(group) if joined() else 1


def coordinator_address() -> Optional[str]:
    """``host:port`` of the rendezvous: ``HYDRAGNN_COORDINATOR``, else
    torchrun's ``MASTER_ADDR`` (and ``MASTER_PORT``, default 12355). Under
    torchrun (``launch --nprocs``) its own store comes first."""
    coord = envflags.env_str("HYDRAGNN_COORDINATOR")
    if coord and not os.environ.get("TORCHELASTIC_RUN_ID"):
        return coord
    addr = os.environ.get("MASTER_ADDR")
    if addr:
        return f"{addr}:{os.environ.get('MASTER_PORT') or DEFAULT_PORT}"
    return coord


def init_group(world: int, rank: int, init_method: str, device=None,
               backend: Optional[str] = None, timeout_s: Optional[float] = None) -> None:
    """Join the default process group: NCCL on the card, gloo for
    ``device="cpu"`` (``backend`` overrides: gloo also carries CUDA
    tensors, which lets ranks that share one card talk). On the card the
    rank first takes its host-local GPU (``torch.cuda.set_device``, before
    anything touches CUDA), so a rank that resolves the current device
    gets its own card. A rendezvous that fails raises; it waits at most
    ``timeout_s`` (``HYDRAGNN_DIST_TIMEOUT``, default 1800 s), as does
    every collective after it."""
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hydragnn_tpu_torch runs on a CUDA GPU and none is available; "
                "pass device='cpu' to train over gloo on the CPU explicitly")
        torch.cuda.set_device(local_rank_from_env() % torch.cuda.device_count())
    backend = backend or ("gloo" if on_cpu else "nccl")
    timeout = datetime.timedelta(seconds=timeout_s or envflags.env_float(
        "HYDRAGNN_DIST_TIMEOUT", 1800.0))
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=init_method, world_size=int(world),
                            rank=int(rank), timeout=timeout, **kw)


def setup_distributed(device=None) -> Tuple[int, int]:
    """Join the ranks of a launch (``launch.py``, torchrun, SLURM, OpenMPI)
    into the default process group; returns (world size, rank). The world
    and rank come from ``WORLD_SIZE`` / ``RANK``, else the scheduler's
    task variables (``utils.ranks.world_from_env``). A process already in
    a group joins nothing, and so does a single process that no launcher
    started; a launch of one rank (``WORLD_SIZE=1`` with a rendezvous, as
    ``launch --nprocs 1`` gives) joins a group of one and so runs the same
    distributed step as N ranks. The rendezvous address is
    ``coordinator_address()``; a world of more than one rank without one,
    or a rendezvous that fails, raises: N ranks never fall back to N
    independent replicas (they would train on a fraction of the data each
    and write over each other's checkpoints)."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    count, index = world_from_env() or (1, 0)
    coord = coordinator_address()
    if count < 1 or (count == 1 and not (coord and os.environ.get("WORLD_SIZE"))):
        return 1, 0
    if not coord:
        raise RuntimeError(
            f"a launch of {count} ranks (this is rank {index}) names no rendezvous: set "
            "HYDRAGNN_COORDINATOR=host:port or MASTER_ADDR/MASTER_PORT, or start it "
            "through `python -m hydragnn_tpu_torch.launch`")
    init_group(count, index, f"tcp://{coord}", device)
    return count, index


class Grid:
    """The data x model layout of a process group's ranks (the
    ``make_mesh2d`` analog): ``model_size`` model indices of
    ``data_size = world / model_size`` ranks each, model-major.
    ``data_group`` holds the ranks of this rank's model index (its data
    group: the routed decoders reduce over it); ``group`` is the whole
    world. Every rank builds every subgroup, in the same order, as
    ``torch.distributed.new_group`` requires."""

    def __init__(self, model_size: int = 1, group=None):
        self.group = group
        self.world = world_size(group)
        self.rank = dist.get_rank(group) if dist.is_initialized() else 0
        self.model_size = int(model_size)
        if self.world % self.model_size:
            raise ValueError(f"{self.world} ranks are not divisible by the model axis "
                             f"{self.model_size}")
        self.data_size = self.world // self.model_size
        self.model_index = self.rank // self.data_size
        self.data_index = self.rank % self.data_size
        self.data_group = group
        if self.model_size > 1 and self.data_size > 1:
            for m in range(self.model_size):
                ranks = list(range(m * self.data_size, (m + 1) * self.data_size))
                g = dist.new_group(ranks)
                if m == self.model_index:
                    self.data_group = g
        elif self.model_size > 1:
            self.data_group = None  # one rank per data group: reductions are local

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data_size, MODEL_AXIS: self.model_size}


def _all_gather_object(obj, group=None) -> List:
    out: List = [None] * world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def gather_across_hosts(values: Dict[str, np.ndarray], group=None) -> Dict[str, np.ndarray]:
    """Concatenate per-rank arrays across the group: a dict of
    ``[n_rank, ...]`` arrays becomes one of ``[n_total, ...]`` in rank order.
    Ranks may hold different counts: each pads to the largest, and the
    padding is cut off after the gather. The identity outside a group."""
    if world_size(group) == 1:
        return values
    out = {}
    for k in sorted(values):
        v = np.asarray(values[k])
        counts = _all_gather_object(int(v.shape[0]), group)
        top = max(counts)
        pad = np.zeros((top - v.shape[0],) + v.shape[1:], v.dtype)
        rows = _all_gather_object(np.concatenate([v, pad]), group)
        out[k] = np.concatenate([r[:c] for r, c in zip(rows, counts)])
    return out
