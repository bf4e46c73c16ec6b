"""``python -m hydragnn_tpu_torch.launch`` — start the ranks of a run.

Counterpart of ``hydragnn_tpu/launch.py`` (and its native launcher), in
Python. Two modes:

- fan-out, ``--nprocs N``: start N ranks on this host through
  ``torch.distributed.run`` (``torchrun --standalone``: a loopback
  rendezvous, and a rank that exits with an error takes the others down,
  which would otherwise wait in a collective for it). The scheduler's
  per-task variables are not handed on: inside an allocation of one task
  they would count one rank where there are N. The launcher exits with
  the first failing rank's code;
- scheduler mode (no ``--nprocs``): one launcher per task, the world size
  and rank from ``WORLD_SIZE`` / ``RANK``, SLURM (``SLURM_NTASKS`` /
  ``SLURM_PROCID`` / ``SLURM_LOCALID``) or OpenMPI
  (``OMPI_COMM_WORLD_*``), in the order of ``utils.ranks.WORLD_ENVS``; the
  rendezvous from ``--coordinator``, ``HYDRAGNN_COORDINATOR``, the first
  host of ``SLURM_JOB_NODELIST`` (port ``HYDRAGNN_MASTER_PORT``, default
  12355) or ``MASTER_ADDR`` / ``MASTER_PORT``; the command then replaces
  the launcher.

Either way each rank's command sees ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``: the contract
``parallel.setup_distributed`` reads (torchrun's, so ``torchrun`` can
start the same command)::

    python -m hydragnn_tpu_torch.launch --nprocs 2 -- python train.py config.json
    srun python -m hydragnn_tpu_torch.launch -- python train.py config.json
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional

from .utils.ranks import SCHEDULER_TASK_ENVS, local_rank_from_env, world_from_env

DEFAULT_PORT = 12355


def first_host(nodelist: str) -> str:
    """The first host of a SLURM node list: ``frontier[0007-0010,0012]`` ->
    ``frontier0007``, ``nid001,nid002`` -> ``nid001``."""
    lb, comma = nodelist.find("["), nodelist.find(",")
    if lb < 0 or (0 <= comma < lb):
        return nodelist if comma < 0 else nodelist[:comma]
    rb = nodelist.find("]", lb)
    body = nodelist[lb + 1:rb if rb >= 0 else None]
    first = body
    for sep in (",", "-"):
        first = first.split(sep)[0]
    return nodelist[:lb] + first


def fan_out(nprocs: int, cmd: List[str]) -> int:
    """Run ``cmd`` as ``nprocs`` local ranks; returns the first failing
    rank's exit code (0 when all succeed)."""
    from torch.distributed.elastic.multiprocessing.errors import ChildFailedError
    from torch.distributed.run import parse_args, run

    for key in SCHEDULER_TASK_ENVS + ("HYDRAGNN_COORDINATOR",):
        os.environ.pop(key, None)
    try:
        run(parse_args(["--standalone", f"--nproc-per-node={nprocs}", "--no-python", *cmd]))
    except ChildFailedError as e:
        rank, failure = e.get_first_failure()
        rc = failure.exitcode if failure.exitcode >= 0 else 128 - failure.exitcode
        print(f"hydragnn_tpu_torch.launch: rank {rank} exited rc={rc}; the group was taken "
              "down", file=sys.stderr, flush=True)
        return rc or 1
    return 0


def _contract(env: Dict[str, str], world: int, rank: int, local: int, coord: str) -> None:
    host, _, port = coord.rpartition(":")
    env.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(local),
               MASTER_ADDR=host, MASTER_PORT=port, HYDRAGNN_COORDINATOR=coord)


def scheduler_mode(cmd: List[str], coordinator: Optional[str] = None) -> None:
    """Export the rank contract from the scheduler's variables and run
    ``cmd`` in place of the launcher."""
    env = os.environ
    got = world_from_env(env)
    if got is None:
        print("hydragnn_tpu_torch.launch: no scheduler world variables "
              "(WORLD_SIZE/SLURM_NTASKS/OMPI_COMM_WORLD_SIZE); running one process",
              file=sys.stderr)
        got = (1, 0)
    world, rank = got
    local = local_rank_from_env(env)
    coord = coordinator or env.get("HYDRAGNN_COORDINATOR")
    if not coord and env.get("SLURM_JOB_NODELIST"):
        coord = (f"{first_host(env['SLURM_JOB_NODELIST'])}:"
                 f"{env.get('HYDRAGNN_MASTER_PORT') or DEFAULT_PORT}")
    if not coord and env.get("MASTER_ADDR"):
        coord = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT') or DEFAULT_PORT}"
    if coord:
        _contract(env, world, rank, local, coord)
    else:
        env.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(local))
    os.execvp(cmd[0], cmd)


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if "--" in args:
        split = args.index("--")
        args, cmd = args[:split], args[split + 1:]
    else:
        cmd = []
    ap = argparse.ArgumentParser(prog="python -m hydragnn_tpu_torch.launch",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--nprocs", type=int, default=0,
                    help="start this many local ranks (default: scheduler mode)")
    ap.add_argument("--coordinator", default=None, help="rendezvous host:port (scheduler mode)")
    opts = ap.parse_args(args)
    if not cmd:
        ap.error("give the command after --")
    if opts.nprocs:
        return fan_out(opts.nprocs, cmd)
    scheduler_mode(cmd, opts.coordinator)
    return 0


if __name__ == "__main__":
    sys.exit(main())
