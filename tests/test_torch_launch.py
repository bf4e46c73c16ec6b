"""``python -m hydragnn_tpu_torch.launch`` and ``setup_distributed``, on the
CPU over gloo, mirroring tests/test_multihost.py's launcher tests: the
fan-out joins its ranks into one group (inside a one-task SLURM
allocation too), a launch of one rank joins a group of one, a crashing
rank takes the group down, scheduler mode maps SLURM's variables to the
rank contract, the rank contract wins over a scheduler's task variables,
and a rendezvous that cannot happen raises instead of training alone."""

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _env(**kw):
    env = {k: v for k, v in os.environ.items()
           if k not in ("HYDRAGNN_COORDINATOR", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                        "MASTER_ADDR", "MASTER_PORT", "SLURM_NTASKS", "SLURM_PROCID",
                        "SLURM_LOCALID", "SLURM_JOB_NODELIST", "OMPI_COMM_WORLD_SIZE",
                        "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK",
                        "TORCHELASTIC_RUN_ID")}
    env["PYTHONPATH"] = str(REPO)
    env.update(kw)
    return env


def _launch(args, timeout, **env):
    return subprocess.run([sys.executable, "-m", "hydragnn_tpu_torch.launch", *args],
                          capture_output=True, text=True, timeout=timeout, env=_env(**env),
                          cwd=str(REPO))


_JOIN_CHILD = """
    import os
    import torch
    import torch.distributed as dist
    from hydragnn_tpu_torch.parallel import setup_distributed
    world, rank = setup_distributed(device="cpu")
    assert dist.is_initialized()
    assert (world, rank) == (int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]))
    assert rank == int(os.environ["LOCAL_RANK"])
    t = torch.tensor([rank + 1.0])
    dist.all_reduce(t)
    os.write(1, f"LAUNCH_OK {world} {rank} {int(t)}\\n".encode())
    dist.destroy_process_group()
"""


def _fan_out(tmp_path, nprocs, **env):
    child = tmp_path / "child.py"
    child.write_text(textwrap.dedent(_JOIN_CHILD))
    out = _launch(["--nprocs", str(nprocs), "--", sys.executable, str(child)], timeout=120,
                  **env)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    return out.stdout


def pytest_fanout_joins_one_group(tmp_path):
    """``--nprocs 2``: both ranks get the contract (world, rank, local
    rank, a loopback rendezvous), join one gloo group through
    ``setup_distributed`` and sum over it."""
    stdout = _fan_out(tmp_path, 2)
    assert "LAUNCH_OK 2 0 3" in stdout and "LAUNCH_OK 2 1 3" in stdout


def pytest_fanout_inside_a_one_task_allocation(tmp_path):
    """``--nprocs 2`` started in a shell of one SLURM (and OpenMPI) task:
    the task's ``SLURM_NTASKS=1`` / ``SLURM_PROCID=0`` must not make each
    rank a world of one, which would train two independent replicas."""
    stdout = _fan_out(tmp_path, 2, SLURM_NTASKS="1", SLURM_PROCID="0", SLURM_LOCALID="0",
                      OMPI_COMM_WORLD_SIZE="1", OMPI_COMM_WORLD_RANK="0",
                      OMPI_COMM_WORLD_LOCAL_RANK="0", HYDRAGNN_COORDINATOR="127.0.0.1:1")
    assert "LAUNCH_OK 2 0 3" in stdout and "LAUNCH_OK 2 1 3" in stdout


def pytest_a_launch_of_one_rank_joins_a_group_of_one(tmp_path):
    """``--nprocs 1`` joins a group of one, so one rank runs the same
    distributed step as N; a process no launcher started joins none."""
    from hydragnn_tpu_torch.parallel import setup_distributed

    assert "LAUNCH_OK 1 0 1" in _fan_out(tmp_path, 1)
    assert setup_distributed(device="cpu") == (1, 0)


def pytest_the_rank_contract_comes_before_the_scheduler(monkeypatch):
    """``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` (the launcher's and
    torchrun's, one per process) win over SLURM's and OpenMPI's task
    variables, which count only where the contract is unset."""
    from hydragnn_tpu_torch.parallel.mesh import local_host_info
    from hydragnn_tpu_torch.utils.ranks import local_rank_from_env as local_rank

    for k, v in dict(SLURM_NTASKS="1", SLURM_PROCID="0", SLURM_LOCALID="0",
                     OMPI_COMM_WORLD_SIZE="2", OMPI_COMM_WORLD_RANK="1",
                     OMPI_COMM_WORLD_LOCAL_RANK="1", WORLD_SIZE="4", RANK="2",
                     LOCAL_RANK="3").items():
        monkeypatch.setenv(k, v)
    assert (local_host_info(), local_rank()) == ((4, 2), 3)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k)
    assert (local_host_info(), local_rank()) == ((1, 0), 0)
    for k in ("SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID"):
        monkeypatch.delenv(k)
    assert (local_host_info(), local_rank()) == ((2, 1), 1)


def pytest_a_crashing_rank_takes_the_group_down(tmp_path):
    """Rank 1 exits with 7 while rank 0 hangs (as in a collective): the
    launcher terminates rank 0 at once and exits with rank 1's code."""
    child = tmp_path / "crashy.py"
    child.write_text(textwrap.dedent("""
        import os, sys, time
        if os.environ["RANK"] == "1":
            sys.exit(7)
        time.sleep(600)
    """))
    t0 = time.monotonic()
    out = _launch(["--nprocs", "2", "--", sys.executable, str(child)], timeout=60)
    assert out.returncode == 7, (out.returncode, out.stderr[-2000:])
    assert time.monotonic() - t0 < 30
    assert "rank 1 exited rc=7" in out.stderr


def pytest_scheduler_mode_maps_slurm_to_the_contract(tmp_path):
    """One launcher per task: the world and rank from SLURM, the local rank
    from ``SLURM_LOCALID``, the rendezvous on the first host of the node
    list (bracket ranges expanded) at ``HYDRAGNN_MASTER_PORT``."""
    child = tmp_path / "probe.py"
    child.write_text("import os\nprint('ENV', *(os.environ.get(k) for k in ("
                     "'WORLD_SIZE', 'RANK', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT', "
                     "'HYDRAGNN_COORDINATOR')))\n")
    out = _launch(["--", sys.executable, str(child)], timeout=60, SLURM_NTASKS="4",
                  SLURM_PROCID="3", SLURM_LOCALID="1",
                  SLURM_JOB_NODELIST="frontier[0007-0010],frontier0044",
                  HYDRAGNN_MASTER_PORT="23456")
    assert out.returncode == 0, (out.stdout, out.stderr)
    assert "ENV 4 3 1 frontier0007 23456 frontier0007:23456" in out.stdout


@pytest.mark.parametrize("nodelist,first", [
    ("frontier[0007-0010,0012]", "frontier0007"), ("nid001,nid002", "nid001"),
    ("gpu-a", "gpu-a"), ("n[3,5-6]", "n3")])
def pytest_first_host_of_a_slurm_node_list(nodelist, first):
    from hydragnn_tpu_torch.launch import first_host

    assert first_host(nodelist) == first


def pytest_a_rendezvous_that_cannot_happen_raises(monkeypatch):
    """A world of 2 without an address, and one whose peer never comes,
    raise: the process never trains alone."""
    import torch.distributed as dist

    from hydragnn_tpu_torch.parallel import setup_distributed
    from hydragnn_tpu_torch.utils.ranks import free_port

    for k in ("HYDRAGNN_COORDINATOR", "MASTER_ADDR", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="names no rendezvous"):
        setup_distributed(device="cpu")
    monkeypatch.setenv("HYDRAGNN_COORDINATOR", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("HYDRAGNN_DIST_TIMEOUT", "3")
    with pytest.raises(Exception):
        setup_distributed(device="cpu")
    assert not dist.is_initialized()


def pytest_run_training_through_the_launcher(tmp_path):
    """``run_training`` under ``launch --nprocs 2`` with ``zero_stage`` 1:
    both ranks train the same losses and rank 0 writes the run. Each rank
    leaves its losses in a file beside the run directories (two ranks'
    output on one pipe can interleave mid-line)."""
    script = tmp_path / "train.py"
    script.write_text(textwrap.dedent(f"""
        import json, os, sys
        sys.path.insert(0, {str(REPO / 'tests')!r})
        import torch
        torch.set_num_threads(1)
        import torch_dist_workers as W
        from hydragnn_tpu_torch.api import run_training
        from hydragnn_tpu_torch.data import split_dataset
        cfg = W.raw_config()
        cfg["NeuralNetwork"]["Training"]["Optimizer"]["zero_stage"] = 1
        cfg["Parallel"] = {{"min_size": 64}}
        rank = os.environ["RANK"]
        os.makedirs(rank, exist_ok=True)
        os.chdir(rank)
        _, state, hist = run_training(cfg, datasets=split_dataset(W.graphs(24), 0.75, seed=0),
                                      device="cpu")
        assert len(state.placement.shards) > 0
        with open(os.path.join("..", f"hist{{rank}}.json"), "w") as f:
            json.dump(hist["train"] + hist["val"], f)
    """))
    out = subprocess.run([sys.executable, "-m", "hydragnn_tpu_torch.launch", "--nprocs", "2",
                          "--", sys.executable, str(script)], capture_output=True, text=True,
                         timeout=240, env=_env(), cwd=str(tmp_path))
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    hist = [json.loads((tmp_path / f"hist{r}.json").read_text()) for r in (0, 1)]
    assert hist[0] == hist[1]
    assert os.listdir(tmp_path / "0" / "logs") and not os.listdir(tmp_path / "1")
