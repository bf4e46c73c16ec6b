"""The port's training slice against the JAX package's, on the CPU.

A 3-layer equivariant EGNN (hidden 24, batch 4, packed, sorted aggregation,
MAE loss, task weights [1, 100]) is built in JAX; its variables (with
non-trivial batch-norm statistics) are bridged into the port, and both
train on the same batches. The JAX side runs its Pallas route in interpret
mode (``HYDRAGNN_PALLAS_SEGMENT=1``), so K1 and K2 are held through their
``custom_jvp`` rules. JAX compiles are shared across the file (module
fixtures), so it stays well inside its time.

Tolerances (all f32 unless named; the same algorithm in another summation
order, relative to the largest value of each compared quantity):

- losses: 1e-5;
- step-0 gradients: 1e-4 of each parameter's largest gradient (floored at
  1e-3 of the largest gradient anywhere: parameters whose gradients sit at
  the rounding level of the rest compare against that);
- the running batch-norm statistics: 1e-5;
- AdamW trajectories (5 steps, lr 1e-3): parameters to 1e-6 absolute,
  except where the step-0 gradient is rounding noise (below 1e-6 of the
  largest gradient: e.g. the bias of a dense layer feeding a batch norm,
  whose gradient is zero in exact arithmetic). Adam divides such noise by
  its own size and moves the weight by about lr either way, in both
  packages, so there only a bound holds: at most 2 lr per step apart;
- bf16 ``mixed_precision`` (bf16 parameters and inputs; conv layer 0 in
  bf16, the rest promoted to f32 by the reference's own promotion): the
  loss to 1e-3 and the running statistics to two bf16 ulps (2^-7) of the
  largest (the batch mean and variance are taken in bf16, rounded at each
  step of their formula); the gradients as a whole
  (relative L2 distance of all of them) at most half as far from the JAX
  bf16 gradients as those are from the JAX f32 ones. Elementwise bf16
  gradients are no gate: rounding in the forward flips ReLUs and MAE signs,
  which moves single gradients by tens of percent in any two bf16
  evaluations (here the JAX bf16 gradients lie 0.29 from the f32 ones, the
  port's 0.11 from the JAX bf16 ones);
- energy-force (forces through a double backward): forces 1e-4 of the
  largest, loss 1e-5, gradients 1e-4 as above;
- the optimizers against optax: 1e-6 absolute over 3 steps.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from hydragnn_tpu.api import prepare_data as j_prepare
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.models import init_model as j_init
from hydragnn_tpu.models.layers import MaskedBatchNorm as JBatchNorm
from hydragnn_tpu.ops.pallas_segment import sorted_segment_sum as j_sorted_sum
from hydragnn_tpu.ops.segment import masked_global_mean_pool as j_pool
from hydragnn_tpu.train import TrainState as JState
from hydragnn_tpu.train import make_optimizer as j_make_optimizer
from hydragnn_tpu.train import make_train_step as j_make_train_step
from hydragnn_tpu.train.loop import make_eval_step as j_make_eval_step
from hydragnn_tpu.train.loop import mp_cast, mp_restore_stats
from hydragnn_tpu.train.loop import train_validate_test as j_tvt
from hydragnn_tpu.train.loss import compute_loss as j_compute_loss
from hydragnn_tpu.train.loss import predict_energy_forces as j_predict_energy_forces
from hydragnn_tpu.train.optimizer import ReduceLROnPlateau as JPlateau
from hydragnn_tpu_torch.api import prepare_data as t_prepare
from hydragnn_tpu_torch.api import run_training
from hydragnn_tpu_torch.bridge import _leaves, load_jax_variables, torch_name
from hydragnn_tpu_torch.data import oc20_shaped_dataset, split_dataset
from hydragnn_tpu_torch.models import create_model as t_create
from hydragnn_tpu_torch.models.layers import MaskedBatchNorm
from hydragnn_tpu_torch.ops.segment import masked_global_mean_pool
from hydragnn_tpu_torch.ops.sorted_segment import sorted_segment_sum
from hydragnn_tpu_torch.train import (
    BestCheckpoint,
    ReduceLROnPlateau,
    TrainState,
    compute_loss,
    make_optimizer,
    make_train_step,
    optimizer_step,
    predict_energy_forces,
    train_validate_test,
)
from hydragnn_tpu_torch.train.optimizer import state_tensors

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-3
STATS_RTOL = 1e-5
TRAJ_ATOL = 1e-6
NOISE = 1e-6
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_SHARE = 0.5
BF16_STATS_RTOL = 2.0**-7
FORCE_RTOL = 1e-4
OPT_ATOL = 1e-6


def _config(fused=True, mixed_precision=False, energy_force=False, num_epoch=2):
    arch = {"mpnn_type": "EGNN", "equivariance": True, "radius": 5.0,
            "max_neighbours": 10, "hidden_dim": 24, "num_conv_layers": 3,
            "use_sorted_aggregation": True, "use_fused_edge_kernel": fused,
            "task_weights": [1.0, 100.0],
            "output_heads": {
                "graph": {"num_sharedlayers": 2, "dim_sharedlayers": 8,
                          "num_headlayers": 2, "dim_headlayers": [12, 12]},
                "node": {"num_headlayers": 2, "dim_headlayers": [12, 12], "type": "mlp"}}}
    var = {"input_node_features": [0, 1], "output_names": ["energy", "forces"],
           "output_index": [0, 2], "type": ["graph", "node"]}
    if energy_force:  # one node head of nodal energy, as the OC20 example
        arch["task_weights"] = [1.0]
        arch["output_heads"] = {"node": arch["output_heads"]["node"]}
        var = {"input_node_features": [0], "output_names": ["graph_energy"],
               "output_index": [0], "output_dim": [1], "type": ["node"]}
    return {
        "Verbosity": {"level": 0},
        "Dataset": {"node_features": {"dim": [1, 3, 3]}, "graph_features": {"dim": [1]}},
        "NeuralNetwork": {
            "Architecture": arch,
            "Variables_of_interest": var,
            "Training": {"batch_size": 4, "loss_function_type": "mae", "pack_batches": True,
                         "num_epoch": num_epoch, "mixed_precision": mixed_precision,
                         "compute_grad_energy": energy_force, "precompile": "off",
                         "Optimizer": {"type": "AdamW", "learning_rate": 1e-3}},
        },
    }


def _splits(energy_force=False):
    graphs = oc20_shaped_dataset(28, mean_atoms=20, min_atoms=10, max_atoms=40,
                                 max_neighbours=10)
    if energy_force:  # the atomic number alone as the node input
        graphs = [dataclasses.replace(g, x=g.x[:, :1]) for g in graphs]
    return split_dataset(graphs, 0.75, seed=0)


def _jax_variables(model, batch, seed=3):
    v = jax.tree_util.tree_map(np.asarray, jax.device_get(j_init(model, batch, seed=seed)))
    rng = np.random.default_rng(seed)

    def randomize(tree):  # every batch norm's running statistics
        if "mean" not in tree:
            for sub in tree.values():
                randomize(sub)
            return
        tree["mean"] = (0.1 * rng.normal(size=tree["mean"].shape)).astype(np.float32)
        tree["var"] = rng.uniform(0.5, 2.0, size=tree["var"].shape).astype(np.float32)
        tree["count"] = np.asarray(50.0, np.float32)

    randomize(v["batch_stats"])
    return v


class _Case:
    """One configuration on both sides: the JAX model and its bridged
    variables, the JAX and torch train batches of epoch 0 (one packed
    shape, so one compile per JAX function), and the port's loaders."""

    def __init__(self, fused=True, mixed_precision=False, energy_force=False):
        self.splits = _splits(energy_force)
        self.raw = _config(fused, mixed_precision, energy_force)
        self.jc, (jtl, self.jvl, self.jtel), _ = j_prepare(copy.deepcopy(self.raw), self.splits)
        self.tc, (ttl, _, _), _ = t_prepare(copy.deepcopy(self.raw), self.splits)
        self.jloaders = (jtl, self.jvl, self.jtel)
        self.jbatches, self.tbatches = list(jtl), list(ttl)
        self.jm = j_create(self.jc)
        self.v = _jax_variables(self.jm, self.jbatches[0])
        self.mp, self.ef = mixed_precision, energy_force

    def torch_model(self):
        m = t_create(self.tc, device="cpu")
        load_jax_variables(m, self.v)
        return m

    def jax_variables(self):
        return jax.tree_util.tree_map(jnp.asarray, self.v)

    def jax_value_and_grad(self):
        """The JAX train step's loss function (make_train_step's loss_fn,
        with its mixed-precision cast) under value_and_grad, jitted once per
        case."""
        if not hasattr(self, "_vg"):
            jm, cfg, mp, ef = self.jm, self.jm.cfg, self.mp, self.ef

            def loss_fn(params, stats, batch):
                if mp:
                    params, batch = mp_cast(params, batch, ef)
                tot, tasks, mutated, preds = j_compute_loss(
                    jm, {"params": params, "batch_stats": stats}, batch, cfg, True,
                    jax.random.PRNGKey(0), ef)
                if mp:
                    mutated = mp_restore_stats(mutated)
                return tot.astype(jnp.float32), (tasks, mutated, preds)

            self._vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        return self._vg


@pytest.fixture(scope="module")
def pallas_route():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYDRAGNN_PALLAS_SEGMENT", "1")
        yield


@pytest.fixture(scope="module")
def cases(pallas_route):
    built = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in built:
            built[key] = _Case(**kw)
        return built[key]

    return get


@pytest.fixture(scope="module")
def jax_step(cases):
    """The JAX package's guarded f32 AdamW train step and eval step on the
    fused case, compiled once for the file."""
    c = cases(fused=True)
    tx = j_make_optimizer(c.jc["NeuralNetwork"]["Training"]["Optimizer"])
    return c, tx, j_make_train_step(c.jm, tx, guard=True), j_make_eval_step(c.jm)


def _flat(tree):
    """A JAX params / batch_stats tree as {torch name: array in torch layout}."""
    out = {}
    for path, leaf in _leaves(tree):
        name, transpose = torch_name(path)
        a = np.asarray(leaf, np.float32)
        out[name] = np.swapaxes(a, -1, -2) if transpose else a
    return out


def _assert_close(want: dict, got: dict, rtol: float, what: str, floor: float = 0.0,
                  atol: float = 0.0):
    assert set(want) == set(got), what
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), floor * top, 1e-30)
        err = float(np.abs(np.asarray(got[k], np.float32) - w).max())
        assert err <= atol + rtol * scale, (what, k, err, scale)


def _torch_grads(model):
    return {n: p.grad.float().numpy() for n, p in model.named_parameters()}


def _torch_stats(model):
    return {n: b.float().numpy() for n, b in model.named_buffers()}


@pytest.mark.parametrize("fused", [True, False])
def pytest_step0_gradients_match_jax(cases, fused):
    """The first step's loss, per-task losses, every parameter's gradient
    and the updated running statistics, f32, through K1 (and K2 in the last
    conv layer when fused)."""
    c = cases(fused=fused)
    jv = c.jax_variables()
    (jtot, (jtasks, jmut, _)), jgrads = c.jax_value_and_grad()(
        jv["params"], jv["batch_stats"], c.jbatches[0])
    tm = c.torch_model()
    assert tm.graph_convs[-1].uses_fused_edge is fused
    tm.train()
    tot, tasks, _ = compute_loss(tm, c.tbatches[0], tm.cfg, False)
    tot.backward()
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=LOSS_RTOL)
    for k in jtasks:
        np.testing.assert_allclose(float(tasks[k].detach()), float(jtasks[k]), rtol=LOSS_RTOL)
    _assert_close(_flat(jgrads), _torch_grads(tm), GRAD_RTOL, "grad", floor=GRAD_FLOOR)
    _assert_close(_flat(jmut["batch_stats"]), _torch_stats(tm), STATS_RTOL, "stats")
    assert all(float(p.grad.abs().max()) > 0 for p in tm.graph_convs.parameters())


def _jax_snapshot(state):
    s = jax.device_get(state)
    return _flat(s.params), _flat(s.batch_stats), (int(s.step), int(s.skipped_steps),
                                                   int(s.consecutive_skips))


def _torch_snapshot(state):
    m = state.model
    return ({n: p.detach().numpy().copy() for n, p in m.named_parameters()},
            {n: b.numpy().copy() for n, b in m.named_buffers()},
            (int(state.step), int(state.skipped_steps), int(state.consecutive_skips)))


def _assert_trajectory_close(c, jparams, tparams, steps):
    """Parameters after ``steps`` AdamW steps: to ``TRAJ_ATOL``, except
    elements whose step-0 gradient is rounding noise (see the module
    docstring), which may lie up to 2 lr per step apart."""
    jv = c.jax_variables()
    (_, _), g0 = c.jax_value_and_grad()(jv["params"], jv["batch_stats"], c.jbatches[0])
    g0 = _flat(g0)
    top = max(float(np.abs(g).max()) for g in g0.values())
    lr = c.tc["NeuralNetwork"]["Training"]["Optimizer"]["learning_rate"]
    for k, want in jparams.items():
        err = np.abs(np.asarray(tparams[k], np.float32) - want)
        noise = np.abs(g0[k]) < NOISE * top
        assert float(np.where(noise, 0.0, err).max()) <= TRAJ_ATOL, (k, float(err.max()))
        assert float(err.max()) <= 2 * lr * steps, k


def _fresh_states(c, tx):
    js = JState.create(c.jax_variables(), tx)
    tm = c.torch_model()
    ts = TrainState.create(tm, make_optimizer(tm, c.tc["NeuralNetwork"]["Training"]["Optimizer"]))
    return js, ts


def pytest_adamw_five_steps_match_jax(jax_step):
    """Five guarded f32 AdamW steps of ``make_train_step`` on five batches:
    the losses of every step, then the parameters, batch-norm statistics
    and step counters."""
    c, tx, jstep, _ = jax_step
    js, ts = _fresh_states(c, tx)
    tstep = make_train_step(ts.model)
    assert len(c.jbatches) >= 5
    for jb, tb in zip(c.jbatches[:5], c.tbatches[:5]):
        js, jtot, _ = jstep(js, jb, jax.random.PRNGKey(0))
        ts, ttot, _ = tstep(ts, tb)
        np.testing.assert_allclose(float(ttot), float(jtot), rtol=LOSS_RTOL)
    jp, jst, jcount = _jax_snapshot(js)
    tp, tst, tcount = _torch_snapshot(ts)
    _assert_trajectory_close(c, jp, tp, 5)
    _assert_close(jst, tst, STATS_RTOL, "stats")
    assert tcount == jcount == (5, 0, 0)


def pytest_guard_skips_a_nan_batch_like_jax(jax_step):
    """A good step, a NaN batch, a good step: the NaN step leaves the
    parameters, the optimizer state and the batch-norm buffers exactly as
    they were and advances the counters as the JAX guard does."""
    c, tx, jstep, _ = jax_step
    js, ts = _fresh_states(c, tx)
    tstep = make_train_step(ts.model)
    jb, tb = c.jbatches[0], c.tbatches[0]
    jbad = jb.replace(x=np.full_like(np.asarray(jb.x), np.nan))
    tbad = tb.replace(x=torch.full_like(tb.x, float("nan")))
    counts = []
    for j_batch, t_batch in ((jb, tb), (jbad, tbad), (jb, tb)):
        before = [t.clone() for t in (list(ts.model.parameters()) + list(ts.model.buffers())
                                      + list(state_tensors(ts.optimizer)))]
        js, jtot, _ = jstep(js, j_batch, jax.random.PRNGKey(0))
        ts, ttot, _ = tstep(ts, t_batch)
        counts.append((_jax_snapshot(js)[2], _torch_snapshot(ts)[2]))
        if t_batch is tbad:
            assert not np.isfinite(float(ttot)) and not np.isfinite(float(jtot))
            after = (list(ts.model.parameters()) + list(ts.model.buffers())
                     + list(state_tensors(ts.optimizer)))
            assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert [j for j, _ in counts] == [t for _, t in counts] == [(1, 0, 0), (2, 1, 1), (3, 1, 0)]
    _assert_trajectory_close(c, _jax_snapshot(js)[0], _torch_snapshot(ts)[0], 2)


def pytest_guard_commits_exactly_the_unguarded_update(cases):
    """On finite steps the guarded step writes the very bits of the
    unguarded one."""
    c = cases(fused=True)
    runs = []
    for guard in (True, False):
        tm = c.torch_model()
        ts = TrainState.create(tm, make_optimizer(tm, {"type": "AdamW", "learning_rate": 1e-3}),
                               guard=guard)
        assert (ts.guard is not None) is guard
        step = make_train_step(tm)
        for tb in c.tbatches[:2]:
            ts, _, _ = step(ts, tb)
        runs.append(list(tm.state_dict().values()) + list(state_tensors(ts.optimizer)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def pytest_mixed_precision_step_matches_jax(cases):
    """One bf16 ``mixed_precision`` step: the loss, the f32 gradients on the
    f32 masters and the running statistics (kept f32) against the JAX
    step's loss function with its ``mp_cast``; the gradients as a whole
    against the distance bf16 itself puts between the JAX package's bf16
    and f32 gradients."""
    c = cases(fused=True, mixed_precision=True)
    jv = c.jax_variables()
    (jtot, (_, jmut, _)), jgrads = c.jax_value_and_grad()(
        jv["params"], jv["batch_stats"], c.jbatches[0])
    (_, _), jgrads32 = cases(fused=True).jax_value_and_grad()(
        jv["params"], jv["batch_stats"], c.jbatches[0])
    tm = c.torch_model()
    ts = TrainState.create(tm, make_optimizer(tm, {"type": "AdamW", "learning_rate": 1e-3}))
    ts, tot, _ = make_train_step(tm, mixed_precision=True)(ts, c.tbatches[0])
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in tm.parameters())
    assert all(b.dtype == torch.float32 for b in tm.buffers())
    np.testing.assert_allclose(float(tot), float(jtot), rtol=BF16_LOSS_RTOL)
    want, want32, got = _flat(jgrads), _flat(jgrads32), _torch_grads(tm)

    def dist(a, b):
        return np.sqrt(sum(((a[k] - b[k]) ** 2).sum() for k in b)) / np.sqrt(
            sum((b[k] ** 2).sum() for k in b))

    assert dist(got, want) <= BF16_GRAD_SHARE * dist(want, want32)
    _assert_close(_flat(jmut["batch_stats"]), _torch_stats(tm), BF16_STATS_RTOL, "bf16 stats")


@pytest.mark.parametrize("fused", [True, False])
def pytest_energy_force_step_matches_jax(cases, fused):
    """``compute_grad_energy``: one node head of nodal energy, forces
    ``-dE/dpos`` through a double backward of K1 (and K2): the forces, the
    loss and its per-task parts, every parameter's gradient; then one
    train step of the port runs and stays finite."""
    c = cases(fused=fused, energy_force=True)
    jv = c.jax_variables()
    (jtot, (jtasks, _, jpreds)), jgrads = c.jax_value_and_grad()(
        jv["params"], jv["batch_stats"], c.jbatches[0])
    tm = c.torch_model()
    tm.train()
    tb = c.tbatches[0]
    tot, tasks, preds = compute_loss(tm, tb, tm.cfg, True)
    tot.backward()
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=LOSS_RTOL)
    for k in ("graph_energy", "forces"):
        np.testing.assert_allclose(float(tasks[k].detach()), float(jtasks[k]), rtol=LOSS_RTOL)
    jf = np.asarray(jpreds["forces"])
    assert float(np.abs(preds["forces"].detach().numpy() - jf).max()) <= \
        FORCE_RTOL * float(np.abs(jf).max())
    _assert_close(_flat(jgrads), _torch_grads(tm), GRAD_RTOL, "ef grad", floor=GRAD_FLOOR)
    ts = TrainState.create(tm, make_optimizer(tm, {"type": "AdamW", "learning_rate": 1e-3}))
    ts, tot, _ = make_train_step(tm, compute_grad_energy=True)(ts, tb)
    assert np.isfinite(float(tot)) and int(ts.skipped_steps) == 0


def pytest_predict_energy_forces_matches_jax(cases):
    """Inference-side energies and forces (eval mode, running statistics)
    of the bridged weights against the JAX package's
    ``predict_energy_forces``: 1e-4 of the largest of each."""
    c = cases(fused=True, energy_force=True)
    jv = c.jax_variables()
    jf = jax.jit(lambda v, b: j_predict_energy_forces(
        lambda bb: (c.jm.apply(v, bb, train=False), None), b, c.jm.cfg))
    je, jforces = jf(jv, c.jbatches[1])
    tm = c.torch_model().eval()
    te, tforces = predict_energy_forces(tm, c.tbatches[1], tm.cfg)
    for got, want in ((te, je), (tforces, jforces)):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert float(np.abs(got.numpy() - want).max()) <= FORCE_RTOL * float(np.abs(want).max())


@pytest.mark.parametrize("early_stopping", [False, True])
def pytest_run_training_history_matches_jax(jax_step, tmp_path, monkeypatch, early_stopping):
    """``run_training(device="cpu")`` from the bridged weights against the
    JAX package's ``train_validate_test``: the train, val and test losses
    and the learning rate of every epoch over 2 epochs, without and with
    early stopping at patience 0 (then both return the state of their best
    validation epoch: its step count tells which)."""
    monkeypatch.chdir(tmp_path)
    c, tx, jstep, jeval = jax_step
    raw = copy.deepcopy(c.raw)
    jc = copy.deepcopy(c.jc)
    if early_stopping:
        for cfg in (raw, jc):
            cfg["NeuralNetwork"]["Training"].update(EarlyStopping=True, patience=0)
    js = JState.create(c.jax_variables(), tx)
    jtl, jvl, jtel = c.jloaders
    js, jhist = j_tvt(c.jm, js, tx, jtl, jvl, jtel, jc, step_fn=jstep, eval_fn=jeval)
    _, ts, hist = run_training(raw, datasets=c.splits, variables=c.v, device="cpu")
    assert len(hist["train"]) == len(jhist["train"])
    for k in ("train", "val", "test"):
        np.testing.assert_allclose(hist[k], jhist[k], rtol=LOSS_RTOL)
    assert hist["lr"] == pytest.approx(jhist["lr"])
    # the returned state: the last epoch's, or the best validation epoch's
    epochs = int(np.argmin(hist["val"])) + 1 if early_stopping else len(hist["val"])
    _, (loader, _, _), _ = t_prepare(copy.deepcopy(raw), c.splits)
    steps = 0
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        steps += len(list(loader))
    assert int(ts.step) == int(js.step) == steps


def pytest_run_training_without_a_device_raises(cases, monkeypatch):
    """No device named and no GPU: ``run_training`` raises, as every entry
    point does, rather than train on the CPU."""
    c = cases(fused=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_training(copy.deepcopy(c.raw), datasets=c.splits)


def pytest_best_checkpoint_saves_each_new_best():
    """``BestCheckpoint`` calls ``save_fn`` on each new best validation
    loss, and only then."""
    saved = []
    ckpt = BestCheckpoint(lambda state, epoch: saved.append((state, epoch)))
    calls = [ckpt("s", v, e) for e, v in enumerate([3.0, 2.0, 2.0, 2.5, 1.0])]
    assert calls == [True, True, False, False, True]
    assert saved == [("s", 0), ("s", 1), ("s", 4)]


def pytest_train_validate_test_returns_the_best_checkpointed_state(cases):
    """``train_validate_test`` with a ``save_fn`` and ``Training.Checkpoint``
    set: it is called on every new best validation epoch, and the state
    returned is the one it saw at the last of them (its tensors, counters
    and learning rate), not the last epoch's; the guard still restores a
    NaN step of the returned state."""
    c = cases(fused=True)
    raw = copy.deepcopy(c.raw)
    raw["NeuralNetwork"]["Training"].update(num_epoch=3, Checkpoint=True)
    config, (tl, vl, tel), _ = t_prepare(raw, c.splits)
    tm = c.torch_model()
    ts = TrainState.create(tm, make_optimizer(tm, config["NeuralNetwork"]["Training"]["Optimizer"]))
    saved = []
    ts, hist = train_validate_test(tm, ts, tl, vl, tel, config,
                                   save_fn=lambda s, epoch: saved.append((epoch, s.state_dict())))
    best = [e for e, v in enumerate(hist["val"]) if v < min(hist["val"][:e], default=np.inf)]
    assert [e for e, _ in saved] == best
    want = saved[-1][1]
    got = ts.state_dict()
    assert got["lr"] == want["lr"]
    assert all(torch.equal(a, b) for a, b in zip(got["tensors"], want["tensors"]))
    before = [t.clone() for t in ts.held]
    tb = c.tbatches[0]
    ts, tot, _ = make_train_step(tm)(ts, tb.replace(x=torch.full_like(tb.x, float("nan"))))
    assert not np.isfinite(float(tot)) and int(ts.skipped_steps) == 1
    assert all(torch.equal(a, b) for a, b in zip(ts.held, before))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def pytest_masked_batchnorm_ema_over_a_ragged_batch(dtype):
    """Train mode: the masked batch statistics over 5 real rows of 9, the
    count-weighted EMA of the running ones from a count of 20, and buffers
    that stay f32 for bf16 activations (as ``mp_restore_stats`` keeps
    them)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(9, 6)).astype(np.float32) * 3 + 1
    mask = np.zeros(9, bool)
    mask[[0, 2, 3, 5, 8]] = True
    stats = {"mean": rng.normal(size=6).astype(np.float32),
             "var": rng.uniform(0.5, 2, 6).astype(np.float32), "count": np.float32(20.0)}
    params = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
              "bias": rng.normal(size=6).astype(np.float32)}
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), params)
    jy, jmut = JBatchNorm().apply({"params": jparams, "batch_stats": stats},
                                  jnp.asarray(x, jdt), jnp.asarray(mask), train=True,
                                  mutable=["batch_stats"])
    bn = MaskedBatchNorm(6)
    with torch.no_grad():
        for k, v in {**params, **stats}.items():
            getattr(bn, k).copy_(torch.as_tensor(v))
    ty = torch.func.functional_call(
        bn, {k: torch.as_tensor(v).to(dtype) for k, v in params.items()},
        (torch.from_numpy(x).to(dtype), torch.from_numpy(mask)), {"train": True})
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    m = mask[:, None]
    np.testing.assert_allclose(ty.float().numpy() * m, np.asarray(jy, np.float32) * m,
                               atol=tol * 3, rtol=tol)
    for k in ("mean", "var", "count"):
        assert getattr(bn, k).dtype == torch.float32
        np.testing.assert_allclose(getattr(bn, k).numpy(), np.asarray(jmut["batch_stats"][k]),
                                   rtol=tol, atol=tol)
    assert float(bn.count) == pytest.approx(0.9 * 20 + 0.1 * 5)


class _Leaf(torch.nn.Module):
    def __init__(self, **tensors):
        super().__init__()
        for k, v in tensors.items():
            setattr(self, k, torch.nn.Parameter(torch.from_numpy(v.copy())))


class _Tiny(torch.nn.Module):
    """A conv stack, a batch norm and a head, named as the port's models
    name them (``graph_convs.0.weight``, ...)."""

    def __init__(self, tree):
        super().__init__()
        for top in ("graph_convs", "feature_layers", "heads_NN"):
            leaf = tree[f"{top}_0"]
            setattr(self, top, torch.nn.ModuleList([_Leaf(**{
                ("weight" if k == "kernel" else k): (v.T if k == "kernel" else v)
                for k, v in leaf.items()})]))


NEW_OPTIMIZERS = ("Adagrad", "RMSprop", "Adamax", "Adadelta", "LAMB", "FusedLAMB")


def _tiny_tree(rng):
    return {"graph_convs_0": {"kernel": rng.normal(size=(3, 4)).astype(np.float32)},
            "feature_layers_0": {"scale": rng.uniform(0.5, 1.5, 4).astype(np.float32),
                                 "bias": rng.normal(size=4).astype(np.float32)},
            "heads_NN_0": {"kernel": rng.normal(size=(4, 2)).astype(np.float32),
                           "bias": rng.normal(size=2).astype(np.float32)}}


@pytest.mark.parametrize("opt_config,freeze", [
    ({"type": "AdamW", "learning_rate": 1e-2}, False),
    ({"type": "Adam", "learning_rate": 1e-2}, False),
    ({"type": "SGD", "learning_rate": 1e-1}, False),
    ({"type": "AdamW", "learning_rate": 1e-2, "clip_grad_norm": 0.5}, False),
    ({"type": "AdamW", "learning_rate": 1e-2}, True),
    *[({"type": k, "learning_rate": 1e-2}, False) for k in NEW_OPTIMIZERS],
    ({"type": "RMSprop", "learning_rate": 1e-2, "clip_grad_norm": 0.5}, False),
    ({"type": "LAMB", "learning_rate": 1e-2}, True),
])
def pytest_optimizer_steps_match_optax(opt_config, freeze):
    """Three steps of each of the nine optimizers from the JAX package's
    ``make_optimizer`` (optax) and the port's, on the same gradients: the
    optax defaults (AdamW's weight decay 1e-4 on every parameter; Adagrad's
    accumulator from 0.1, RMSprop's decay 0.9 with eps in the root,
    Adamax's eps outside the infinity norm, Adadelta's rho 0.9, LAMB's
    per-tensor trust ratio), the global-norm clip (here it engages on every
    step) and the frozen conv stack."""
    rng = np.random.default_rng(1)
    tree = _tiny_tree(rng)
    tx = j_make_optimizer(opt_config, freeze_conv=freeze)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jopt = tx.init(jparams)
    model = _Tiny(tree)
    opt = make_optimizer(model, opt_config, freeze_conv=freeze)
    names = [n for n, _ in model.named_parameters()]
    for _ in range(3):
        g = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
        updates, jopt = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        flat_g = _flat(g)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(flat_g[n].copy())
        with torch.no_grad():
            optimizer_step(opt, [p.grad for p in model.parameters()])
    want = _flat(jax.device_get(jparams))
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert sorted(want) == sorted(names)
    _assert_close(want, got, 0.0, opt_config["type"], atol=OPT_ATOL)
    if freeze:
        assert np.array_equal(got["graph_convs.0.weight"], tree["graph_convs_0"]["kernel"].T)


@pytest.mark.parametrize("kind", NEW_OPTIMIZERS)
def pytest_optimizer_state_survives_checkpoint_and_guard(kind):
    """Each new optimizer's state exists from construction and lies in the
    guard's copies: a non-finite step leaves the parameters and the state
    exactly as they were; ``TrainState.to_payload`` / ``load_payload``
    carry the state bit for bit into a fresh state, and the next step of
    both states is the same."""
    from hydragnn_tpu_torch.train.guard import guarded_update, step_ok

    rng = np.random.default_rng(2)
    tree = _tiny_tree(rng)
    model = _Tiny(tree)
    opt_config = {"type": kind, "learning_rate": 1e-2}
    state = TrainState.create(model, make_optimizer(model, opt_config))
    held = set(map(id, state.held))
    assert all(id(t) in held for t in state_tensors(state.optimizer))
    assert len(list(state_tensors(state.optimizer))) >= len(list(model.parameters()))

    def step(s, grads):
        for p, g in zip(s.model.parameters(), grads):
            p.grad = torch.from_numpy(g.copy())
        gl = [p.grad for p in s.model.parameters()]
        s.guard.save()
        with torch.no_grad():
            guarded_update(s, step_ok(torch.tensor(1.0), gl), lambda: optimizer_step(s.optimizer, gl))

    def grads():
        return [rng.normal(size=tuple(p.shape)).astype(np.float32) for p in model.parameters()]

    for _ in range(2):
        step(state, grads())
    before = [t.clone() for t in state.held]
    bad = grads()
    bad[0][0, 0] = np.nan
    step(state, bad)
    assert int(state.skipped_steps) == 1
    assert all(torch.equal(a, b) for a, b in zip(before, state.held))
    payload = state.to_payload()
    fresh_model = _Tiny(_tiny_tree(np.random.default_rng(9)))
    fresh = TrainState.create(fresh_model, make_optimizer(fresh_model, opt_config))
    fresh.load_payload(payload)
    assert all(torch.equal(a, b) for a, b in zip(state.held, fresh.held))
    g = grads()
    step(state, g)
    step(fresh, g)
    assert all(torch.equal(a, b) for a, b in zip(state.held, fresh.held))


def pytest_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(torch.nn.Linear(2, 2), {"type": "Lion"})


def pytest_reduce_lr_on_plateau_sequences():
    """The port's copy steps through the same learning rates as the JAX
    package's over a long run of validation losses (improvements, plateaus
    past the patience, the min_lr floor)."""
    rng = np.random.default_rng(2)
    losses = list(np.concatenate([np.linspace(1, 0.5, 5), np.full(20, 0.6),
                                  rng.uniform(0.4, 0.7, 40)]))
    for kw in ({}, {"factor": 0.1, "patience": 2, "min_lr": 1e-4}):
        j, t = JPlateau(**kw), ReduceLROnPlateau(**kw)
        jl = tl = 1e-2
        seq = []
        for v in losses:
            jl, tl = j.step(v, jl), t.step(v, tl)
            seq.append((jl, tl))
        assert [a for a, _ in seq] == [b for _, b in seq]
        assert len({a for a, _ in seq}) > 2


def _ascending_case(seed=0, n=7, c=5):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 4, n)
    ids = np.repeat(np.arange(n), deg).astype(np.int32)
    msg = rng.normal(size=(ids.shape[0], c)).astype(np.float32)
    w, v = (rng.normal(size=s).astype(np.float32) for s in ((n, c), msg.shape))
    return ids, msg, w, v


def pytest_sorted_segment_sum_double_backward_matches_jax(pallas_route):
    """Fault 1: d/dmsg of <dL/dmsg, v> for L = sum(w tanh(S(msg))), S the
    sorted-segment sum, through the port's CPU route against ``jax.grad``
    of ``jax.grad`` through the JAX kernel (interpret mode)."""
    ids, msg, w, v = _ascending_case()
    n = w.shape[0]

    def j_loss(m):
        return jnp.sum(w * jnp.tanh(j_sorted_sum(m, jnp.asarray(ids), n, max_degree=8,
                                                 interpret=True)))

    want_g = jax.grad(j_loss)(msg)
    want_gg = jax.grad(lambda m: jnp.sum(jax.grad(j_loss)(m) * v))(msg)
    m = torch.from_numpy(msg).requires_grad_(True)
    loss = torch.sum(torch.from_numpy(w) * torch.tanh(sorted_segment_sum(m, torch.from_numpy(ids).long(), n)))
    (g,) = torch.autograd.grad(loss, m, create_graph=True)
    (gg,) = torch.autograd.grad(torch.sum(g * torch.from_numpy(v)), m)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gg.numpy(), np.asarray(want_gg), rtol=1e-5, atol=1e-6)


def pytest_sorted_segment_sum_drops_out_of_range_ids():
    """Edges whose id lies outside [0, num_segments) add nothing and get a
    zero gradient, at first and second order."""
    ids = torch.tensor([-1, 0, 0, 2, 3, 3])
    msg = torch.arange(12.0).reshape(6, 2).requires_grad_(True)
    out = sorted_segment_sum(msg, ids, 3)
    assert out.tolist() == [[6.0, 8.0], [0.0, 0.0], [6.0, 7.0]]
    (g,) = torch.autograd.grad((out**2).sum(), msg, create_graph=True)
    assert g[0].tolist() == [0.0, 0.0] and g[4:].abs().sum() == 0
    (gg,) = torch.autograd.grad(g.sum(), msg)
    assert gg[0].tolist() == [0.0, 0.0] and gg[4:].abs().sum() == 0


@pytest.mark.parametrize("contiguous", [True, False])
def pytest_pool_energy_force_double_backward_matches_jax(contiguous):
    """Fault 1: an energy through the graph mean pool, its forces by a
    first backward with ``create_graph``, and the gradient of a loss on the
    forces, against ``jax.grad`` of ``jax.grad`` through the JAX pool; the
    fixed-order route (contiguous graphs) and ``index_add_`` alike."""
    rng = np.random.default_rng(3)
    node_graph = np.array([0, 0, 0, 1, 1, 2, 2, 2, 3], np.int32)
    mask = np.array([1, 1, 1, 1, 1, 1, 1, 0, 0], bool)
    pos = rng.normal(size=(9, 3)).astype(np.float32)
    a = rng.normal(size=(3, 4)).astype(np.float32)
    cvec = rng.normal(size=4).astype(np.float32)

    def j_energy(p, a_):
        return jnp.sum(j_pool(jnp.tanh(p @ a_), node_graph, 4, mask) * cvec)

    def j_force_loss(a_):
        return jnp.sum(jax.grad(j_energy)(pos, a_) ** 2)

    want = jax.grad(j_force_loss)(a)
    tp = torch.from_numpy(pos).requires_grad_(True)
    ta = torch.from_numpy(a).requires_grad_(True)
    pooled = masked_global_mean_pool(torch.tanh(tp @ ta), torch.from_numpy(node_graph).long(),
                                     4, torch.from_numpy(mask), contiguous)
    (de_dpos,) = torch.autograd.grad(torch.sum(pooled * torch.from_numpy(cvec)), tp,
                                     create_graph=True)
    (got,) = torch.autograd.grad(torch.sum(de_dpos**2), ta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def pytest_unsorted_pool_gives_the_jax_answer():
    """Graph ids in any order: ``node_graph = [1, 0, 1, 0]`` with x = 1..4
    pools to [3, 2], as the JAX package's pool does; a batch the host did
    not build (``graphs_contiguous`` false) takes this route."""
    x = torch.arange(1.0, 5.0)[:, None]
    ng = torch.tensor([1, 0, 1, 0])
    mask = torch.ones(4, dtype=torch.bool)
    want = np.asarray(j_pool(x.numpy(), ng.numpy(), 2, mask.numpy()))
    got = masked_global_mean_pool(x, ng, 2, mask)
    assert got[:, 0].tolist() == [3.0, 2.0] == want[:, 0].tolist()
    batch = _splits()[0][:2]
    from hydragnn_tpu_torch.data import PadSpec, batch_graphs

    b = batch_graphs(batch, PadSpec(100, 1000, 3))
    assert b.graphs_contiguous and b.replace(x=b.x).graphs_contiguous
    assert b.to("cpu").graphs_contiguous


@pytest.mark.parametrize("bias_grad", [True, False])
def pytest_fused_edge_function_backward_matches_autograd(monkeypatch, bias_grad):
    """K2's Function, with its launch replaced by the plain version (the
    kernel runs only on the card): first- and second-order gradients of its
    float inputs equal the plain version's own autograd, also when one
    input needs none."""
    from hydragnn_tpu_torch.ops import fused_edge as fe

    monkeypatch.setattr(fe, "_launch", fe.reference_edge_message_sum)
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(np.repeat(np.arange(6), rng.integers(0, 4, 6)))
    n, e = 6, ids.shape[0]
    base = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((n, 5), (e, 5), (5, 4), (4,))]
    w = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(n, 5)).astype(np.float32))

    def grads(fn):
        inputs = [t.clone().requires_grad_(bias_grad or i < 3) for i, t in enumerate(base)]
        wanted = [t for t in inputs if t.requires_grad]
        g = torch.autograd.grad(torch.sum(w * torch.tanh(fn(*inputs, ids, n))), wanted,
                                create_graph=True)
        gg = torch.autograd.grad(torch.sum(g[0] * v), wanted)
        return [t.detach() for t in g + gg]

    got = grads(fe._FusedEdgeMessageSum.apply)
    want = grads(fe.reference_edge_message_sum)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
