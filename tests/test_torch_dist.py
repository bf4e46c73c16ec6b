"""The port's multi-GPU slice against the JAX package, on the CPU over gloo.

The reference for every parity case is the JAX package's one mesh step
(``parallel/engine.py`` ``make_mesh_train_step``) on a mesh of 2 CPU
devices, its stacked rows the two ranks' batches: one JAX device is one
torch rank. The port runs as 2 spawned gloo ranks (``torch_dist_workers``),
every case in one group, its steps placed by the same rule table. Weights
come from the JAX initialization through ``bridge.load_jax_variables``,
with non-trivial batch-norm statistics.

Tolerances (f32; the same arithmetic summed in another order):

- parameters after 3 AdamW steps (lr 1e-3): ``PARAM_RTOL`` of the largest
  parameter, except elements whose step-0 gradient is rounding noise
  (below 1e-6 of the largest gradient), which Adam moves by about lr
  either way in both packages: there only a bound holds, 2 lr per step;
- batch-norm running statistics: ``STATS_RTOL`` of the largest;
- the loaders: the same graphs and batch counts exactly.
"""

import contextlib
import copy
import dataclasses
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_workers as W
from hydragnn_tpu.config import update_config as j_update
from hydragnn_tpu.data import GraphLoader as JLoader
from hydragnn_tpu.data.graph import PadSpec as JSpec
from hydragnn_tpu.data.graph import batch_graphs as j_batch
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.parallel import Objective as JObjective
from hydragnn_tpu.parallel import make_mesh2d, make_mesh_train_step, place_state
from hydragnn_tpu.parallel import rules as JR
from hydragnn_tpu.parallel.routing import BranchRoutedLoader as JRouted
from hydragnn_tpu.train import TrainState as JState
from hydragnn_tpu.train import make_optimizer as j_make_optimizer
from hydragnn_tpu.train.loss import compute_loss as j_compute_loss
from hydragnn_tpu_torch.bridge import _leaves, torch_name
from hydragnn_tpu_torch.config import update_config as t_update
from hydragnn_tpu_torch.data import split_dataset
from hydragnn_tpu_torch.data.graph import PadSpec as TSpec
from hydragnn_tpu_torch.data.pipeline import GraphLoader as TLoader
from hydragnn_tpu_torch.parallel.routing import BranchRoutedLoader as TRouted

torch.set_num_threads(2)

PARAM_RTOL = 1e-5
STATS_RTOL = 1e-5
NOISE = 1e-6
WORLD = 2
MODELS = ("EGNN", "GIN")
PRESETS = ("dp", "zero1", "zero2", "zero3", "branch")


def _flat(tree):
    """A JAX collection as {torch name: array in torch layout}."""
    out = {}
    for path, leaf in _leaves(tree):
        name, transpose = torch_name(path)
        a = np.asarray(leaf, np.float32)
        out[name] = np.swapaxes(a, -1, -2) if transpose else a
    return out


def _jax_variables(jm, batch, seed=3):
    v = jax.tree_util.tree_map(np.asarray, jax.jit(lambda r, b: jm.init(r, b, train=False))(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)}, batch))
    rng = np.random.default_rng(seed)

    def randomize(tree):
        if "mean" not in tree:
            for sub in tree.values():
                randomize(sub)
            return
        tree["mean"] = (0.1 * rng.normal(size=tree["mean"].shape)).astype(np.float32)
        tree["var"] = rng.uniform(0.5, 2.0, size=tree["var"].shape).astype(np.float32)
        tree["count"] = np.asarray(50.0, np.float32)

    randomize(v["batch_stats"])
    return v


def _spec(rows):
    n = max(sum(g.num_nodes for g in r) for r in rows)
    e = max(sum(g.num_edges for g in r) for r in rows)
    g = max(len(r) for r in rows)
    return (int(np.ceil((n + 1) / 8) * 8), int(np.ceil(e / 128) * 128), g + 1)


class _Model:
    """One model on both sides: the completed configs, the JAX model and
    its variables, the graphs."""

    def __init__(self, model):
        self.graphs = W.graphs(48)
        self.splits = split_dataset(self.graphs, 0.75, seed=0)
        raw = W.raw_config(model.split("-")[0])
        if model.endswith("-weighted"):
            # per-branch loss weights, under SGD: Adam's per-element scaling
            # would hide a branch's gradient weight (a constant factor
            # cancels in m / sqrt(v))
            raw["NeuralNetwork"]["Architecture"]["branch_loss_weights"] = [1.0, 2.0]
            raw["NeuralNetwork"]["Training"]["Optimizer"] = {"type": "SGD",
                                                             "learning_rate": W.LR}
        self.jc = j_update(copy.deepcopy(raw), *self.splits)
        self.tc = t_update(copy.deepcopy(raw), *self.splits)
        self.jm = j_create(self.jc)
        self.train = self.splits[0]
        first = self.train[:4]
        self.v = _jax_variables(self.jm, j_batch(first, JSpec(*_spec([first])), sort_edges=True))

    def rows(self, preset, uneven=False):
        """Per step, the two ranks' graph lists."""
        if preset == "branch":
            by = [[g for g in self.train if g.dataset_id == b] for b in range(WORLD)]
            return [[by[r][4 * s:4 * s + 4] for r in range(WORLD)] for s in range(W.STEPS)]
        steps = []
        for s in range(W.STEPS):
            chunk = self.train[8 * s:8 * s + 8]
            steps.append([chunk, self.train[24 + 3 * s:24 + 3 * s + 3]] if uneven
                         else [chunk[:4], chunk[4:]])
        return steps


_MODELS = {}


def _model(name):
    if name not in _MODELS:
        _MODELS[name] = _Model(name)
    return _MODELS[name]


def _jax_run(m: _Model, preset, steps, spec):
    """The JAX mesh step on 2 CPU devices, row r = rank r's batch:
    (params, batch_stats) after the steps, in torch layout."""
    table = JR.preset(preset, min_size=W.MIN_SIZE, num_branches=WORLD)
    mesh = make_mesh2d(jax.devices()[:WORLD], model_size=table.model_size if table.routed else 1)
    tx = j_make_optimizer(m.jc["NeuralNetwork"]["Training"]["Optimizer"])
    state = place_state(JState.create(jax.tree_util.tree_map(jnp.asarray, m.v), tx), table, mesh)
    step = make_mesh_train_step(JObjective(model=m.jm, tx=tx), table, mesh)
    for rows in steps:
        batches = [j_batch(r, JSpec(*spec), sort_edges=True) for r in rows]
        stacked = jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                                         *batches)
        state, _, _ = step(state, stacked, jax.random.PRNGKey(0))
    s = jax.device_get(state)
    return _flat(s.params), _flat(s.batch_stats)


def _jax_loss_and_grad(m: _Model, rows, spec, r):
    """Rank r's step-0 train loss and gradients at the initial weights
    (jitted: eager flax forwards take seconds)."""
    b = j_batch(rows[r], JSpec(*spec), sort_edges=True)

    def loss(p, stats, batch):
        return j_compute_loss(m.jm, {"params": p, "batch_stats": stats}, batch,
                              m.jm.cfg, True, jax.random.PRNGKey(0), False)[0]

    value, grads = jax.jit(jax.value_and_grad(loss))(
        jax.tree_util.tree_map(jnp.asarray, m.v["params"]), m.v["batch_stats"], b)
    return float(value), _flat(grads)


def _jax_grad0(m: _Model, rows, spec):
    """The size of the step-0 gradients of both ranks' batches, summed (the
    noise mask)."""
    g = [_jax_loss_and_grad(m, rows, spec, r)[1] for r in range(WORLD)]
    return {k: np.abs(g[0][k]) + np.abs(g[1][k]) for k in g[0]}


def _cases():
    """(name, model, preset, uneven) of every parity case."""
    out = [(f"{m}-{p}", m, p, False) for m in MODELS for p in PRESETS]
    return out + [("EGNN-dp-uneven", "EGNN", "dp", True),
                  ("EGNN-weighted-branch", "EGNN-weighted", "branch", False)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every multi-rank case in one spawn of 2 gloo ranks; returns the
    output directory and the cases' inputs."""
    out = tmp_path_factory.mktemp("dist")
    cases, inputs = [], {}
    for name, model, preset, uneven in _cases():
        m = _model(model)
        steps = m.rows(preset, uneven)
        spec = _spec([r for rows in steps for r in rows])
        inputs[name] = (m, preset, steps, spec)
        cases.append({"kind": "case", "name": name, "preset": preset, "config": m.tc,
                      "variables": m.v, "steps": steps, "spec": TSpec(*spec)})
    egnn = _model("EGNN")
    steps = egnn.rows("dp")
    cases.append({"kind": "guard", "config": egnn.tc, "variables": egnn.v, "steps": steps,
                  "spec": TSpec(*_spec([r for rows in steps for r in rows]))})
    cases.append(dict(cases[-1], kind="optimizers"))
    resume = _resume_inputs(egnn, out)
    cases.append(dict({k: v for k, v in resume.items() if k != "uninterrupted"}, kind="resume"))
    cases.append({"kind": "config", "config": _zero3_config(), "splits": _zero3_splits()})
    t0 = time.perf_counter()
    W.spawn(W.ranks_main, WORLD, (WORLD, str(out / "store"), cases, str(out)), timeout=240)
    print(f"2 gloo ranks: {time.perf_counter() - t0:.1f} s")
    return out, inputs, resume


# ---------------------------------------------------------------------------
# parity against the JAX mesh step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [c[0] for c in _cases()])
def pytest_presets_match_the_jax_mesh_step(ranks, name):
    """Parameters and batch-norm statistics after 3 AdamW steps over 2
    ranks, per preset (ZeRO-1/2/3 over the leaves of at least 64 elements
    whose leading axis 2 divides; branch: each rank one branch), against
    the JAX mesh step on 2 CPU devices fed the same rows. The uneven case
    gives rank 0 eight real graphs and rank 1 three: the gradients, loss
    and statistics are the real-graph-weighted means, as the reference's.
    The weighted branch case trains branch loss weights [1, 2] under SGD:
    each rank's decoder gradients scaled by its branch's weight."""
    out, inputs, _ = ranks
    m, preset, steps, spec = inputs[name]
    got = torch.load(out / f"{name}.pt")
    assert got["skipped"] == 0 and all(np.isfinite(got["losses"]))
    jp, js = _jax_run(m, preset, steps, spec)
    sd = {k: v.float().numpy() for k, v in got["model"].items()}
    assert set(sd) == set(jp) | set(js)
    g0 = _jax_grad0(m, steps[0], spec)
    gtop = max(float(g.max()) for g in g0.values())
    top = max(float(np.abs(w).max()) for w in jp.values())
    for k, want in jp.items():
        err = np.abs(sd[k] - want)
        noise = g0[k] < NOISE * gtop
        assert float(np.where(noise, 0.0, err).max()) <= PARAM_RTOL * top, (k, float(err.max()))
        assert float(err.max()) <= 2 * W.LR * W.STEPS, k
    stop = max(float(np.abs(w).max()) for w in js.values())
    for k, want in js.items():
        assert float(np.abs(sd[k] - want).max()) <= STATS_RTOL * stop, k


def pytest_uneven_shard_weights_by_real_graphs(ranks):
    """Step 0 of the uneven case: the world's loss is the real-graph
    weighted mean of the ranks' losses, (8 l0 + 3 l1) / 11, not DDP's plain
    mean (l0 + l1) / 2, which lies far outside the tolerance; the gradients
    and statistics take the same weights (the parity case above)."""
    out, inputs, _ = ranks
    m, _, steps, spec = inputs["EGNN-dp-uneven"]
    got = torch.load(out / "EGNN-dp-uneven.pt")["losses"][0]
    l0, l1 = (_jax_loss_and_grad(m, steps[0], spec, r)[0] for r in range(WORLD))
    weighted, plain = (8 * l0 + 3 * l1) / 11, (l0 + l1) / 2
    assert abs(got - weighted) <= 1e-6 * abs(weighted)
    assert abs(got - plain) > 1e-3 * abs(plain)


@pytest.mark.parametrize("preset", ["zero1", "zero3"])
def pytest_each_rank_holds_half_of_the_sharded_state(ranks, preset):
    """Under zero1 each rank holds half of the optimizer state of every leaf
    the table shards (the rest replicated); under zero3 half of those
    parameters too, between steps."""
    out, _, _ = ranks
    for model in MODELS:
        b = [np.load(out / f"{model}-{preset}_bytes{r}.npy") for r in range(WORLD)]
        for held, whole, p_held, p_whole in b:
            assert whole > 0 and held * WORLD == whole
            if preset == "zero3":
                assert p_whole > 0 and p_held * WORLD == p_whole
            else:
                assert p_whole == p_held == 0


def pytest_nan_on_one_rank_skips_the_step_on_both(ranks):
    """A NaN in rank 1's batch at step 1 (zero2: the decision is made on the
    reduce-scattered gradients): both ranks skip it, their state unchanged
    by the step, and count one skip."""
    out, _, _ = ranks
    for r in range(WORLD):
        skipped, unchanged, step = np.load(out / f"guard{r}.npy")
        assert (skipped, unchanged, step) == (1, 1, W.STEPS)


@pytest.mark.parametrize("kind", W.OPTIMIZERS)
def pytest_each_optimizer_keeps_its_numbers_under_zero3(ranks, kind):
    """2 steps over 2 ranks under zero3 (moments and parameters of every
    admitted leaf held as slices) against dp (whole leaves): the eight
    element-wise rules bit for bit, LAMB and FusedLAMB (their trust ratio's
    norms summed over the slices, in another order) to 1e-6 of the largest
    parameter."""
    out, _, _ = ranks
    got = torch.load(out / "optimizers.pt")
    dp, z3 = got[(kind, "dp")], got[(kind, "zero3")]
    top = max(float(v.abs().max()) for v in dp.values())
    for k, v in dp.items():
        if "LAMB" in kind:
            err = float((z3[k].double() - v.double()).abs().max())
            assert err <= 1e-6 * top, (k, err)
        else:
            assert torch.equal(z3[k], v), k


# ---------------------------------------------------------------------------
# checkpoints across world sizes
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _one_thread():
    """One intra-op thread, as the ranks run: the same sums in the same
    order, so one process and two give the same bits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _plain_state(m, variables):
    from hydragnn_tpu_torch.bridge import load_jax_variables
    from hydragnn_tpu_torch.models import create_model
    from hydragnn_tpu_torch.train import TrainState, make_optimizer

    model = create_model(m.tc, device="cpu")
    load_jax_variables(model, variables)
    return TrainState.create(model, make_optimizer(
        model, m.tc["NeuralNetwork"]["Training"]["Optimizer"]))


def _resume_inputs(m, out: Path):
    """Four batches (both ranks take the same one each step, so 2 ranks
    compute exactly what 1 rank does), the uninterrupted 1-rank run's
    final state, and a 1-rank dp checkpoint after 2 steps."""
    from hydragnn_tpu_torch.data.graph import batch_graphs
    from hydragnn_tpu_torch.train import make_train_step
    from hydragnn_tpu_torch.train.checkpoint import save_model

    batches = [m.train[4 * i:4 * i + 4] for i in range(4)]
    spec = TSpec(*_spec(batches))
    state = _plain_state(m, m.v)
    step = make_train_step(state.model)
    with _one_thread():
        for i, b in enumerate(batches):
            state, _, _ = step(state, batch_graphs(b, spec, sort_edges=True))
            if i == 1:
                save_model(state, "dp_at_1", path=str(out / "logs"))
    return {"config": m.tc, "variables": m.v, "batches": batches, "spec": spec,
            "uninterrupted": state.to_payload()}


def _assert_payloads_equal(got, want):
    """Bit for bit: both ranks take the same batch, so each step's weighted
    mean halves and adds two equal values, which is exact."""
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for i, st in want["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(got["optimizer"]["state"][i][k]),
                               torch.as_tensor(v)), (i, k)
    assert (got["step"], got["skipped_steps"]) == (want["step"], want["skipped_steps"])


def pytest_checkpoint_from_two_ranks_zero1_resumes_at_one_rank_dp(ranks):
    """A checkpoint written at 2 ranks under zero1 (rank 0 alone writes the
    whole model: payload, digest, pointer) restores into one process's
    plain state, and 2 more steps there equal the uninterrupted run."""
    from hydragnn_tpu_torch.data.graph import batch_graphs
    from hydragnn_tpu_torch.train import make_train_step
    from hydragnn_tpu_torch.train.checkpoint import load_existing_model

    out, _, resume = ranks
    files = [list(np.load(out / f"resume_files{r}.npy")) for r in range(WORLD)]
    assert files[0] == files[1] == ["latest", "zero1_at_2.pt", "zero1_at_2.pt.sha256"]
    m = _model("EGNN")
    state = _plain_state(m, m.v)
    load_existing_model(state, "zero1_at_2", path=str(out / "logs"))
    step = make_train_step(state.model)
    with _one_thread():
        for b in resume["batches"][2:]:
            state, _, _ = step(state, batch_graphs(b, resume["spec"], sort_edges=True))
    _assert_payloads_equal(state.to_payload(), resume["uninterrupted"])


def pytest_checkpoint_from_one_rank_dp_resumes_at_two_ranks_zero1(ranks):
    """The reverse: a 1-rank dp checkpoint placed on 2 ranks under zero1
    (each rank its half of the moments) trains on, equal to the
    uninterrupted run."""
    out, _, resume = ranks
    _assert_payloads_equal(torch.load(out / "resumed_at_2.pt"), resume["uninterrupted"])


# ---------------------------------------------------------------------------
# run_training from a config
# ---------------------------------------------------------------------------


def _zero3_config():
    """examples/multidataset_zero/gfm_zero3.json's model and Training
    block (EGNN 64 x 3, three branches, ZeRO stage 3), on this file's
    graphs and targets, 2 epochs of batch 4."""
    import json

    repo = Path(__file__).resolve().parents[1]
    c = json.loads((repo / "examples/multidataset_zero/gfm_zero3.json").read_text())
    raw = W.raw_config()
    c["Dataset"], c["Verbosity"] = raw["Dataset"], {"level": 0}
    c["NeuralNetwork"]["Variables_of_interest"] = raw["NeuralNetwork"]["Variables_of_interest"]
    c["NeuralNetwork"]["Training"].update(batch_size=4, num_epoch=2)
    c["NeuralNetwork"]["Architecture"]["use_sorted_aggregation"] = True
    c["Parallel"] = {"min_size": W.MIN_SIZE}
    return c


def _zero3_splits():
    return split_dataset(W.graphs(40, branches=3), 0.8, seed=0)


def pytest_run_training_from_a_zero3_config_at_two_ranks(ranks):
    """``run_training`` of the gfm_zero3-shaped config at 2 ranks: the table
    resolved from ``Optimizer.zero_stage`` 3 places parameters as slices,
    both ranks see the same epoch losses, and rank 0 alone wrote the run
    directory: the config with ``Parallel.resolved_rules`` and the
    checkpoint chain."""
    import json

    from hydragnn_tpu_torch.config import get_log_name_config

    out, _, _ = ranks
    hist = [np.load(out / f"run_hist{r}.npy") for r in range(WORLD)]
    np.testing.assert_array_equal(hist[0], hist[1])
    assert np.isfinite(hist[0]).all()
    placed = [np.load(out / f"run_placed{r}.npy") for r in range(WORLD)]
    assert placed[0][0] > 0 and placed[0][1] == placed[0][0] and (placed[0] == placed[1]).all()
    name = get_log_name_config(_zero3_config())
    run = out / "run0" / "logs" / name
    cfg = json.loads((run / "config.json").read_text())
    assert cfg["Parallel"]["resolved_rules"]["name"] == "zero3"
    assert cfg["NeuralNetwork"]["Training"]["Optimizer"]["zero_stage"] == 3
    assert {"latest", f"{name}_epoch1.pt"} <= set(os.listdir(run))
    assert os.listdir(out / "run1") == []


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------


def pytest_zero2_with_branch_parallel_raises():
    """ZeRO stage 2 or more together with ``Training.branch_parallel``
    raises while the data is prepared, with the reference's words."""
    from hydragnn_tpu_torch.api import prepare_data

    c = W.raw_config()
    c["NeuralNetwork"]["Training"].update(branch_parallel=True)
    c["NeuralNetwork"]["Training"]["Optimizer"]["zero_stage"] = 2
    with pytest.raises(ValueError, match="not supported together with"):
        prepare_data(c, _model("EGNN").splits)


def pytest_branch_parallel_at_one_rank_raises(tmp_path, monkeypatch):
    """The routed table needs at least 2 ranks: a run of one process
    raises before it trains."""
    from hydragnn_tpu_torch.api import run_training

    monkeypatch.chdir(tmp_path)
    c = W.raw_config()
    c["NeuralNetwork"]["Training"]["branch_parallel"] = True
    with pytest.raises(ValueError, match=">=2 ranks"):
        run_training(c, datasets=_model("EGNN").splits, device="cpu")


@pytest.fixture
def world_of_one(tmp_path):
    import torch.distributed as dist

    from hydragnn_tpu_torch.parallel import init_group

    init_group(1, 0, f"file://{tmp_path / 'store'}", device="cpu", timeout_s=60)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("preset", ["dp", "zero1", "zero2", "zero3"])
def pytest_world_of_one_equals_make_train_step_bit_for_bit(world_of_one, preset):
    """In a process group of one rank every reduction is the identity, so
    the placed step gives ``make_train_step``'s parameters, statistics and
    moments bit for bit, for each preset (the chip smoke's
    ``dist_gfm_train`` holds the same at full width over NCCL)."""
    from hydragnn_tpu_torch.data.graph import batch_graphs
    from hydragnn_tpu_torch.parallel import Grid, Objective, make_mesh_train_step
    from hydragnn_tpu_torch.parallel import place_state as t_place
    from hydragnn_tpu_torch.parallel import rules as R
    from hydragnn_tpu_torch.train import make_train_step

    m = _model("EGNN")
    batches = [m.train[4 * i:4 * i + 4] for i in range(3)]
    spec = TSpec(*_spec(batches))
    plain = _plain_state(m, m.v)
    placed = t_place(_plain_state(m, m.v), R.preset(preset, min_size=W.MIN_SIZE), Grid())
    assert placed.placement.shards or preset == "dp"
    pstep = make_train_step(plain.model)
    dstep = make_mesh_train_step(Objective(), R.preset(preset, min_size=W.MIN_SIZE))
    for b in batches:
        tb = batch_graphs(b, spec, sort_edges=True)
        plain, lp, _ = pstep(plain, tb)
        placed, ld, _ = dstep(placed, tb)
        assert float(lp) == float(ld)
    want, got = plain.to_payload(), placed.to_payload()
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for i, st in want["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(got["optimizer"]["state"][i][k]),
                               torch.as_tensor(v)), (i, k)


# ---------------------------------------------------------------------------
# the loaders
# ---------------------------------------------------------------------------


def _key(p):
    return np.asarray(p, np.float32).round(4).tobytes()


def _positions(gs):
    return {_key(g.pos[0]): i for i, g in enumerate(gs)}


def _ids(batch, pos):
    """The real graphs of a batch, by their first atom's position."""
    nodes = np.asarray(batch.node_graph)[np.asarray(batch.node_mask)]
    p = np.asarray(batch.pos)[np.asarray(batch.node_mask)]
    return [pos[_key(p[np.argmax(nodes == g)])]
            for g in range(int(np.asarray(batch.graph_mask).sum()))]


LOADER_CASES = {
    "plain": {},
    "pack": {"pack": True},
    "oversampling": {"oversampling": True, "num_samples": 30},
    "balanced": {"oversampling": True, "sample_weights": "branch"},
    "size_bucketing": {"size_bucketing": True},
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
@pytest.mark.parametrize("drop_last", [True, False])
def pytest_graph_loader_rank_shares_match_jax(case, drop_last):
    """``GraphLoader(host_count=2, host_index=r)`` gives each rank the JAX
    loader's graphs in its order and its batch count, for two epochs,
    packed (the agreed count: every rank simulates every rank's packing)
    and plain, with draws with replacement and balanced branch weights."""
    from hydragnn_tpu.data import branch_sample_weights as j_weights

    gs = W.graphs(45)
    pos = _positions(gs)
    kw = dict(LOADER_CASES[case])
    if kw.get("sample_weights") == "branch":
        kw["sample_weights"] = j_weights(gs, {0: 1.0, 1: 1.0})
    counts = set()
    for r in range(2):
        jl = JLoader(gs, 4, host_count=2, host_index=r, drop_last=drop_last, seed=5, **kw)
        tl = TLoader(gs, 4, host_count=2, host_index=r, drop_last=drop_last, seed=5, **kw)
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            tl.set_epoch(epoch)
            assert len(jl) == len(tl)
            want, got = [_ids(b, pos) for b in jl], [_ids(b, pos) for b in tl]
            assert got == want and len(got) == len(tl)
            counts.add((epoch, len(got)))
    assert len(counts) <= 2  # both ranks step equally often in each epoch


@pytest.mark.parametrize("sizes", [(24, 24), (30, 12)])
def pytest_branch_routed_loader_rows_match_jax(sizes):
    """``BranchRoutedLoader`` over 2 ranks (one branch each): rank r's
    batches are the JAX loader's row r, an exhausted branch's rows
    all-padding, over two epochs, with uneven branch sizes oversampled."""
    gs = W.graphs(sum(sizes))
    gs = ([dataclasses.replace(g, dataset_id=0) for g in gs[:sizes[0]]]
          + [dataclasses.replace(g, dataset_id=1) for g in gs[sizes[0]:]])
    pos = _positions(gs)
    for over in (True, False):
        # one JAX host of 2 rows: 8 graphs a step, 4 a row
        jl = JRouted(gs, 8, branch_count=2, num_shards=2, seed=0, oversampling=over)
        tls = [TRouted(gs, 4, branch_count=2, host_count=2, host_index=r, oversampling=over,
                       spec=jl.spec) for r in range(2)]
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            want = [[_ids(jax.tree_util.tree_map(lambda x, i=i: np.asarray(x)[i], b), pos)
                     for i in range(2)] for b in jl]
            for r, tl in enumerate(tls):
                tl.set_epoch(epoch)
                assert len(tl) == len(jl)
                assert [_ids(b, pos) for b in tl] == [w[r] for w in want]
