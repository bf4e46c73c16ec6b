"""This process's place in a joined ``torch.distributed`` group.

One home for the questions every layer asks (the loop, checkpoints, the
guard's messages, the entry points): how many ranks, which one this is,
whether it is the one that logs and writes. Outside a group the process
is rank 0 of 1.

Before a group is joined, the environment says where the process sits.
One process drives one GPU, so the per-process contract that the
launcher and torchrun export (``WORLD_SIZE`` / ``RANK`` /
``LOCAL_RANK``) comes first; a scheduler's task variables (SLURM, then
OpenMPI) count only where it is unset. The order matters: a launcher
started inside an allocation of one task (``salloc -n 1``, or ``srun
--ntasks-per-node=1 torchrun ...``) hands its ranks the allocation's
``SLURM_NTASKS`` too, which counts tasks, not ranks.
"""

from __future__ import annotations

import os
import socket
from typing import Mapping, Optional, Tuple

import torch.distributed as dist

# (world size, rank) variable pairs and the local-rank variables, in the
# order they are read
WORLD_ENVS = (("WORLD_SIZE", "RANK"),
              ("SLURM_NTASKS", "SLURM_PROCID"),
              ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK"))
LOCAL_RANK_ENVS = ("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK")
# a scheduler's per-task variables, which a local fan-out must not hand on
SCHEDULER_TASK_ENVS = tuple(k for pair in WORLD_ENVS[1:] for k in pair) + LOCAL_RANK_ENVS[1:]


def world_from_env(env: Mapping[str, str] = os.environ) -> Optional[Tuple[int, int]]:
    """(world size, rank) from the environment, or None when no variable
    names a world."""
    for size_key, rank_key in WORLD_ENVS:
        if env.get(size_key):
            return int(env[size_key]), int(env.get(rank_key) or 0)
    return None


def local_rank_from_env(env: Mapping[str, str] = os.environ) -> int:
    """This process's index among the ranks of its host (0 when unset)."""
    return next((int(env[k]) for k in LOCAL_RANK_ENVS if env.get(k)), 0)


def free_port() -> int:
    """A TCP port on the loopback that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if joined() else 1


def rank() -> int:
    return dist.get_rank() if joined() else 0


def is_primary() -> bool:
    """Rank 0, or a process outside any group: the one that logs and writes."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (a no-op for one)."""
    if world_size() > 1:
        dist.barrier()
