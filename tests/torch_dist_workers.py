"""Rank functions of the distributed tests (tests/test_torch_dist.py).

Each spawned rank imports this module (torch and the port only, no JAX),
joins a gloo group through a file store, runs the port's distributed step
on the batches the test hands it, and leaves its results in files the
test reads. Also holds the configurations and batches both sides build.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

LR = 1e-3
MIN_SIZE = 64  # the ZeRO presets' threshold here: most leaves of the narrow models shard
STEPS = 3


def raw_config(model: str = "EGNN", branches: int = 2, hidden: int = 16):
    """A narrow two-branch model (graph heads per branch, one node head)."""
    gh = {"num_sharedlayers": 1, "dim_sharedlayers": 8, "num_headlayers": 2,
          "dim_headlayers": [8, 8]}
    arch = {"mpnn_type": model, "radius": 5.0, "max_neighbours": 10, "hidden_dim": hidden,
            "num_conv_layers": 2, "use_sorted_aggregation": True,
            "equivariance": model == "EGNN", "task_weights": [1.0, 10.0],
            "output_heads": {
                "graph": [{"type": f"branch-{b}", "architecture": dict(gh)}
                          for b in range(branches)],
                "node": {"num_headlayers": 2, "dim_headlayers": [8, 8], "type": "mlp"}}}
    return {
        "Verbosity": {"level": 0},
        "Dataset": {"node_features": {"dim": [1, 3, 3]}, "graph_features": {"dim": [1]}},
        "NeuralNetwork": {
            "Architecture": arch,
            "Variables_of_interest": {"input_node_features": [0, 1],
                                      "output_names": ["energy", "forces"],
                                      "output_index": [0, 2], "type": ["graph", "node"]},
            "Training": {"batch_size": 4, "loss_function_type": "mae", "num_epoch": 1,
                         "Optimizer": {"type": "AdamW", "learning_rate": LR}},
        },
    }


def graphs(n: int = 48, branches: int = 2, seed: int = 42):
    """OC20-shaped graphs, dealt round-robin into ``branches`` dataset ids."""
    from hydragnn_tpu_torch.data import oc20_shaped_dataset

    gs = oc20_shaped_dataset(n, mean_atoms=20, min_atoms=10, max_atoms=40, max_neighbours=10,
                             seed=seed)
    return [dataclasses.replace(g, dataset_id=i % branches) for i, g in enumerate(gs)]


def join(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    from hydragnn_tpu_torch.parallel import init_group

    init_group(world, rank, f"file://{store}", device="cpu", timeout_s=120)


def placed_state(config, variables, table, grid, optimizer=None):
    """The port's state of the bridged JAX ``variables``, placed."""
    from hydragnn_tpu_torch.bridge import load_jax_variables
    from hydragnn_tpu_torch.models import create_model
    from hydragnn_tpu_torch.parallel import place_state
    from hydragnn_tpu_torch.train import TrainState, make_optimizer

    model = create_model(config, device="cpu")
    load_jax_variables(model, variables)
    opt_cfg = optimizer or config["NeuralNetwork"]["Training"]["Optimizer"]
    return place_state(TrainState.create(model, make_optimizer(model, opt_cfg)), table, grid)


def _bytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def held_bytes(state):
    """(optimizer-state bytes of the sharded leaves held here, of the whole
    leaves; parameter bytes of the stage-3 leaves held here, of the whole
    leaves)."""
    pl, opt = state.placement, state.optimizer
    held = whole = p_held = p_whole = 0
    for s in pl.shards:
        for piece in s.pieces:
            held += _bytes(v for v in opt.state[piece].values() if torch.is_tensor(v) and v.dim())
        per_elem = sum(v.element_size() for v in opt.state[s.pieces[0]].values()
                       if torch.is_tensor(v) and v.dim())
        whole += s.n * per_elem
        if s.store_sharded:
            p_held += _bytes([s.local]) + _bytes(p.data for p in s.params)
            p_whole += s.n * s.local.element_size()
    return held, whole, p_held, p_whole


def run_case(case, rank, world, out: Path):
    """One parity case: ``STEPS`` steps on this rank's batches; rank 0
    saves the whole model's state dict, every rank its byte counts."""
    from hydragnn_tpu_torch.data.graph import batch_graphs
    from hydragnn_tpu_torch.parallel import Grid, Objective, make_mesh_train_step
    from hydragnn_tpu_torch.parallel import rules as R

    table = R.preset(case["preset"], min_size=MIN_SIZE, num_branches=2)
    grid = Grid(table.model_size if table.routed else 1)
    state = placed_state(case["config"], case["variables"], table, grid)
    step = make_mesh_train_step(Objective(), table, grid)
    losses = []
    for rows in case["steps"]:
        batch = batch_graphs(rows[rank], case["spec"], sort_edges=True)
        state, tot, _ = step(state, batch)
        losses.append(float(tot))
    payload = state.to_payload()
    np.save(out / f"{case['name']}_bytes{rank}.npy", np.asarray(held_bytes(state)))
    if rank == 0:
        torch.save({"model": payload["model"], "losses": losses,
                    "skipped": int(state.skipped_steps)}, out / f"{case['name']}.pt")


def run_guard(case, rank, world, out: Path):
    """A NaN in one rank's batch at step 1: both ranks skip the step."""
    from hydragnn_tpu_torch.data.graph import batch_graphs
    from hydragnn_tpu_torch.parallel import Grid, Objective, make_mesh_train_step
    from hydragnn_tpu_torch.parallel import rules as R

    table = R.preset("zero2", min_size=MIN_SIZE)
    grid = Grid()
    state = placed_state(case["config"], case["variables"], table, grid)
    step = make_mesh_train_step(Objective(guard=True), table, grid)
    before = None
    for i, rows in enumerate(case["steps"]):
        batch = batch_graphs(rows[rank], case["spec"], sort_edges=True)
        if i == 1:
            before = {k: v.clone() for k, v in state.to_payload()["model"].items()}
            if rank == 1:
                batch.x[0, 0] = float("nan")
        state, _, _ = step(state, batch)
        if i == 1:
            after = state.to_payload()["model"]
            same = all(torch.equal(before[k], after[k]) for k in before)
    np.save(out / f"guard{rank}.npy", np.asarray([int(state.skipped_steps), int(same),
                                                 int(state.step)]))


OPTIMIZERS = ("AdamW", "Adam", "SGD", "Adagrad", "RMSprop", "Adamax", "Adadelta", "LAMB",
              "FusedLAMB")


def run_optimizers(case, rank, world, out: Path):
    """Each of the nine optimizers, 2 steps under dp and under zero3 (every
    admitted leaf's moments and parameters in slices, LAMB's norms summed
    over them): rank 0 saves each pair's whole-model parameters."""
    from hydragnn_tpu_torch.data.graph import batch_graphs
    from hydragnn_tpu_torch.parallel import Grid, Objective, make_mesh_train_step
    from hydragnn_tpu_torch.parallel import rules as R

    got = {}
    for kind in OPTIMIZERS:
        for preset in ("dp", "zero3"):
            table = R.preset(preset, min_size=MIN_SIZE)
            state = placed_state(case["config"], case["variables"], table, Grid(),
                                 optimizer={"type": kind, "learning_rate": LR})
            step = make_mesh_train_step(Objective(), table)
            for rows in case["steps"][:2]:
                state, _, _ = step(state, batch_graphs(rows[rank], case["spec"],
                                                       sort_edges=True))
            got[(kind, preset)] = state.to_payload()["model"]
    if rank == 0:
        torch.save(got, out / "optimizers.pt")


def run_resume(case, rank, world, out: Path):
    """Across topologies: 2 ranks under zero1 train 2 steps from the
    bridged weights and checkpoint (rank 0 writes); then a 1-rank dp
    checkpoint (written by the test) resumes at 2 ranks under zero1 for 2
    steps. Both ranks take the same batch each step."""
    from hydragnn_tpu_torch.data.graph import batch_graphs
    from hydragnn_tpu_torch.parallel import Grid, Objective, make_mesh_train_step
    from hydragnn_tpu_torch.parallel import rules as R
    from hydragnn_tpu_torch.train.checkpoint import load_existing_model, save_model

    table = R.preset("zero1", min_size=MIN_SIZE)
    grid = Grid()
    step = make_mesh_train_step(Objective(), table, grid)
    logs = str(out / "logs")
    state = placed_state(case["config"], case["variables"], table, grid)
    for b in case["batches"][:2]:
        state, _, _ = step(state, batch_graphs(b, case["spec"], sort_edges=True))
    save_model(state, "zero1_at_2", path=logs)
    files = sorted(os.listdir(Path(logs) / "zero1_at_2"))
    np.save(out / f"resume_files{rank}.npy", np.asarray(files))
    state = placed_state(case["config"], case["variables"], table, grid)
    load_existing_model(state, "dp_at_1", path=logs)
    for b in case["batches"][2:4]:
        state, _, _ = step(state, batch_graphs(b, case["spec"], sort_edges=True))
    payload = state.to_payload()
    if rank == 0:
        torch.save(payload, out / "resumed_at_2.pt")


def run_config(case, rank, world, out: Path):
    """``run_training`` from a config at 2 ranks, each rank in its own
    working directory: rank 0 writes the run directory, rank 1 nothing."""
    from hydragnn_tpu_torch.api import run_training

    work = out / f"run{rank}"
    work.mkdir(exist_ok=True)
    os.chdir(work)
    _, state, hist = run_training(copy.deepcopy(case["config"]), datasets=case["splits"],
                                  device="cpu")
    placed = {s.leaf.path: s.store_sharded for s in state.placement.shards}
    np.save(out / f"run_hist{rank}.npy", np.asarray(hist["train"] + hist["val"]))
    np.save(out / f"run_placed{rank}.npy", np.asarray([len(placed), sum(placed.values())]))


def ranks_main(rank, world, store, cases, out):
    """Every case of the file in one gloo group, in order."""
    out = Path(out)
    join(rank, world, store)
    try:
        t0 = time.perf_counter()
        for case in cases:
            {"case": run_case, "guard": run_guard, "resume": run_resume,
             "config": run_config, "optimizers": run_optimizers}[case["kind"]](
                case, rank, world, out)
            dist.barrier()
        np.save(out / f"seconds{rank}.npy", np.asarray([time.perf_counter() - t0]))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args, timeout: float):
    """``fn(rank, *args)`` on ``world`` spawned processes; a rank still
    running after ``timeout`` seconds is killed and the spawn fails."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the ranks did not finish within {timeout} s")
