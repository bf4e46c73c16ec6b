"""The port's recovery plane against the JAX package's, on the CPU.

The EGNN of tests/test_torch_train.py (hidden 24, 3 layers, packed batch 4,
MAE, task weights [1, 100], AdamW lr 1e-3, the step guard on) starts from
the same variables on both sides (bridged into the port) and trains on the
same batches; the JAX package runs its XLA route (its Pallas kernels'
plain reference) through one train step and one eval step compiled for
the file. Each package checkpoints into a directory of its own.

- ``Training.continue`` / ``startfrom`` (tests/test_config_wiring.py:115):
  the step counts, and the resumed run's history against the JAX
  package's resume of its own checkpoint;
- the mid-epoch SIGTERM stop (tests/test_data_plane.py:310, :454, :572):
  the same cursor and ``LoaderState`` record, the resumed run replays the
  same graphs in the same order as the JAX loader armed with it and as the
  uninterrupted run, and the resumed steps' losses equal the uninterrupted
  run's bit for bit (two uninterrupted runs on the CPU agree bit for bit,
  so the resumed one must too);
- ``Training.non_finite_policy`` (tests/test_faults.py:326-400) with
  poisoned batches (NaN features) at the same steps: the same learning
  rate sequence (across the ``warmup_epochs`` ramp too), the same number
  of rollbacks, restored weights equal to the checkpoint's bit for bit,
  the bound and the no-checkpoint error;
- ``HYDRAGNN_VALTEST=0`` and ``HYDRAGNN_MAX_NUM_BATCH``;
- ``run_prediction`` and ``run_server`` restored from disk against the
  same weights given in memory, and the walk-back past a corrupt file;
- the SIGTERM handler restored and the flag reset
  (tests/test_preemption.py:99).

Tolerances: losses 1e-5 relative (f32, the same algorithm in another
summation order, as tests/test_torch_train.py), the learning rates 1e-6
relative (the JAX package keeps them in f32), predictions 1e-5 of each
head's largest value; the port against itself (disk against memory,
resumed against uninterrupted) exactly.
"""

import copy
import hashlib
import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydragnn_tpu.api import prepare_data as j_prepare
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.train import TrainState as JState
from hydragnn_tpu.train import checkpoint as jck
from hydragnn_tpu.train import make_optimizer as j_make_optimizer
from hydragnn_tpu.train import make_train_step as j_make_train_step
from hydragnn_tpu.train.loop import make_eval_step as j_make_eval_step
from hydragnn_tpu.train.loop import test_model as j_test_model
from hydragnn_tpu.train.loop import train_validate_test as j_tvt
from hydragnn_tpu.train.state import LoaderState as JLoaderState
from hydragnn_tpu.utils import preemption as jpre
import hydragnn_tpu_torch.api as tapi
import hydragnn_tpu_torch.train.loop as tloop
from hydragnn_tpu_torch.api import prepare_data as t_prepare
from hydragnn_tpu_torch.api import run_prediction, run_server, run_training
from hydragnn_tpu_torch.bridge import load_jax_variables
from hydragnn_tpu_torch.config import get_log_name_config
from hydragnn_tpu_torch.data import GraphLoader
from hydragnn_tpu_torch.models import create_model as t_create
from hydragnn_tpu_torch.train import TrainState, make_optimizer, train_validate_test
from hydragnn_tpu_torch.train import checkpoint as tck
from hydragnn_tpu_torch.train.state import LoaderState
from hydragnn_tpu_torch.utils import preemption as tpre
from test_torch_train import _config, _jax_variables, _splits

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
LR_RTOL = 1e-6
PRED_RTOL = 1e-5


class _Case:
    """The JAX model, its variables, one jitted train and eval step, and
    the train split's packed batch count per epoch."""

    def __init__(self):
        self.splits = _splits()
        self.raw = _config()
        jc, (jtl, _, _), _ = j_prepare(copy.deepcopy(self.raw), self.splits)
        self.jm = j_create(jc)
        self.v = _jax_variables(self.jm, next(iter(jtl)))
        self.tx = j_make_optimizer(jc["NeuralNetwork"]["Training"]["Optimizer"])
        self.jstep = j_make_train_step(self.jm, self.tx, guard=True)
        self.jeval = j_make_eval_step(self.jm)
        _, (ttl, _, _), _ = t_prepare(copy.deepcopy(self.raw), self.splits)
        self.per_epoch = []
        for e in range(6):
            ttl.set_epoch(e)
            self.per_epoch.append(len(ttl))

    def config(self, **training):
        raw = copy.deepcopy(self.raw)
        raw["NeuralNetwork"]["Training"].update(training)
        return raw

    def steps_of(self, *epochs):
        """The global step indices of ``epochs``' batches (no resume, no
        cap)."""
        starts = np.cumsum([0] + self.per_epoch)
        return {i for e in epochs for i in range(starts[e], starts[e + 1])}


@pytest.fixture(scope="module")
def case():
    return _Case()


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # ./logs of every run lands here
    yield
    tpre.reset()
    jpre.reset()


def _ids(batch) -> str:
    """A fingerprint of a batch's real node features (the same graphs
    batched by either package give the same bytes)."""
    x = np.asarray(batch.x, np.float32)[np.asarray(batch.node_mask, bool)]
    return hashlib.sha1(x.tobytes()).hexdigest()[:16]


def _jax_run(case, d, log_name="run", poison=(), kill_after=None, restore=True, skipped=0,
             **training):
    """``train_validate_test`` of the JAX package from the case's
    variables; ``poison`` holds the global step indices whose batch gets
    NaN features, ``kill_after`` the step count after which this process
    gets SIGTERM, ``skipped`` the skip total the state starts with (a
    resumed run's). Returns (state, history, the batches stepped, the
    rollbacks, the restored states' params)."""
    jc, (tl, vl, tel), _ = j_prepare(case.config(**training), case.splits)
    seen, restored = [], []

    def step(s, b, r):
        n = len(seen)
        seen.append(_ids(b))
        if n in poison:
            b = b.replace(x=jnp.full_like(b.x, jnp.nan))
        out = case.jstep(s, b, r)
        if kill_after is not None and n + 1 == kill_after:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    def restore_fn(t):
        st = jck.load_existing_model(t, log_name, path=d)
        restored.append(jax.tree_util.tree_map(np.asarray, st.params))
        return st

    js = JState.create(jax.tree_util.tree_map(jnp.asarray, case.v), case.tx)
    if skipped:
        js = js.replace(skipped_steps=skipped)
    js, hist = j_tvt(
        case.jm, js, case.tx, tl, vl, tel, jc, log_name=log_name, step_fn=step,
        eval_fn=case.jeval, save_fn=lambda s, e=None: jck.save_model(s, log_name, path=d, epoch=e),
        restore_fn=restore_fn if restore else None,
        loader_state_fn=lambda r: jck.save_loader_state(JLoaderState.from_dict(r), log_name,
                                                        path=d))
    return js, hist, seen, restored


def _torch_run(case, d, log_name="run", poison=(), restore=True, skipped=0, **training):
    """The port's ``train_validate_test`` on the same terms (no kill: the
    port's SIGTERM runs go through ``run_training``). Returns (state,
    history, the batches stepped, and per rollback the file restored and
    the state's model tensors right after)."""
    tc, (tl, vl, tel), _ = t_prepare(case.config(**training), case.splits)
    model = t_create(tc, device="cpu")
    load_jax_variables(model, case.v)
    state = TrainState.create(model, make_optimizer(model, tc["NeuralNetwork"]["Training"]
                                                    ["Optimizer"]))
    state.skipped_steps.fill_(skipped)
    seen, restored = [], []

    def restore_fn(t):
        names = []
        st = tck.load_existing_model(t, log_name, path=d, loaded_entry=names)
        restored.append((os.path.join(d, log_name, names[0]), _state_tensors(st)))
        return st

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tloop, "make_train_step", _poisoning(tloop.make_train_step, seen, poison))
        state, hist = train_validate_test(
            model, state, tl, vl, tel, tc, log_name=log_name,
            save_fn=lambda s, e=None: tck.save_model(s, log_name, path=d, epoch=e),
            restore_fn=restore_fn if restore else None)
    return state, hist, seen, restored


def _poisoning(make, seen, poison=(), losses=None):
    """``make_train_step`` whose steps record their batch (and loss), and
    get NaN features at the global step indices in ``poison``."""
    def make_step(model, *a, **kw):
        inner = make(model, *a, **kw)

        def step(s, b):
            n = len(seen)
            seen.append(_ids(b))
            if n in poison:
                b = b.replace(x=torch.full_like(b.x, float("nan")))
            out = inner(s, b)
            if losses is not None:
                losses.append(out[1].clone())
            return out

        return step

    return make_step


def _same_history(th, jh):
    assert len(th["train"]) == len(jh["train"]), (th, jh)
    for k in ("train", "val", "test"):
        np.testing.assert_allclose(th[k], jh[k], rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(th["lr"], jh["lr"], rtol=LR_RTOL, err_msg="lr")


def _stem(fname: str) -> str:
    """A checkpoint file's name without the payload extension (the JAX
    package writes ``.msgpack``, the port ``.pt``)."""
    return fname.replace(".msgpack", "").replace(".pt", "")


def _state_tensors(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


# ---------------------------------------------------------------------------
# continue / startfrom


def pytest_continue_and_startfrom_resume_like_jax(case, tmp_path):
    """Two epochs, then ``continue`` with ``startfrom`` naming that run
    (``num_epoch`` is part of the log name) for one more: 3 epochs of steps
    in all, and the resumed epoch's history equal to the JAX package's
    resume of its own checkpoint; a fresh run without the flag restores
    nothing."""
    spe = case.per_epoch
    _, s1, h1 = run_training(case.config(num_epoch=2), datasets=case.splits,
                             variables=case.v, device="cpu")
    assert int(s1.step) == spe[0] + spe[1]
    first = get_log_name_config(t_prepare(case.config(num_epoch=2), case.splits)[0])
    assert tck.latest_checkpoint_entry(first) == f"{first}_epoch1.pt"
    _, s2, h2 = run_training(case.config(num_epoch=1, **{"continue": 1, "startfrom": first}),
                             datasets=case.splits, variables=case.v, device="cpu")
    assert int(s2.step) == spe[0] + spe[1] + spe[0]
    _, s3, _ = run_training(case.config(num_epoch=1), datasets=case.splits, variables=case.v,
                            device="cpu")
    assert int(s3.step) == spe[0]

    # the JAX package: two epochs, its end-of-run save, restore, one epoch
    d = str(tmp_path / "jax")
    js, jh1, _, _ = _jax_run(case, d, num_epoch=2)
    jck.save_model(js, "first", path=d, epoch=1)
    jc, (tl, vl, tel), _ = j_prepare(case.config(num_epoch=1), case.splits)
    resumed = jck.load_existing_model(
        JState.create(jax.tree_util.tree_map(jnp.asarray, case.v), case.tx), "first", path=d)
    js2, jh2 = j_tvt(case.jm, resumed, case.tx, tl, vl, tel, jc, step_fn=case.jstep,
                     eval_fn=case.jeval)
    _same_history(h1, jh1)
    _same_history(h2, jh2)
    assert int(js2.step) == int(s2.step)


# ---------------------------------------------------------------------------
# the mid-epoch SIGTERM stop and resume


def _killing_loader(log, kill_at=None, make=None):
    """A port ``GraphLoader`` whose shuffled (train) instances record what
    they yield as ((epoch, batch index), graph ids), and ``make``
    (``make_train_step``) wrapped so that this process gets SIGTERM as the
    step of batch ``kill_at`` = (epoch, index) starts: device staging
    draws batches ahead of their steps, so the signal is keyed on the
    step, through the hand-out order. Returns (the loader class, the
    wrapped ``make``)."""
    handed, stepped = [], []

    class Loader(GraphLoader):
        def __iter__(self):
            groups = self._groups()[self.start_batch:]
            for k, (grp, batch) in enumerate(zip(groups, super().__iter__())):
                if self.shuffle:
                    pos = (self.epoch, self.start_batch + k)
                    handed.append(pos)
                    log.append((pos, tuple(int(i) for i in grp)))
                yield batch

    def make_step(model, *a, **kw):
        inner = make(model, *a, **kw)

        def step(s, b):
            if handed[len(stepped)] == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            stepped.append(1)
            return inner(s, b)

        return step

    return Loader, make_step


def pytest_sigterm_mid_epoch_resume_like_jax(case, tmp_path, monkeypatch):
    """SIGTERM as the step of batch 1 of epoch 1 starts: that step
    completes, the run saves its state and a loader sidecar with the same
    record as the JAX package's (killed after the same step) and stops with
    a history row per epoch begun; ``continue`` replays exactly the rest of
    epoch 1, the graphs and their order as the JAX loader armed with that
    record hands them out and as the uninterrupted run saw them, and each
    replayed step's loss equals the uninterrupted run's."""
    kill = (1, 1)
    cfg = case.config(num_epoch=2)
    log_name = get_log_name_config(t_prepare(copy.deepcopy(cfg), case.splits)[0])
    full = {}
    for run in ("uninterrupted", "uninterrupted again"):  # the spread of two runs
        log, losses = [], []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tapi, "GraphLoader", _killing_loader(log)[0])
            mp.setattr(tloop, "make_train_step",
                       _poisoning(tloop.make_train_step, [], losses=losses))
            run_training(copy.deepcopy(cfg), datasets=case.splits, variables=case.v,
                         device="cpu")
        full[run] = (log, torch.stack(losses))
    assert full["uninterrupted"][0] == full["uninterrupted again"][0]
    spread = float((full["uninterrupted"][1] - full["uninterrupted again"][1]).abs().max())
    assert spread == 0.0  # two runs agree bit for bit on the CPU: the resumed one must too

    killed_log = []
    with pytest.MonkeyPatch.context() as mp:
        loader, make = _killing_loader(killed_log, kill, tloop.make_train_step)
        mp.setattr(tapi, "GraphLoader", loader)
        mp.setattr(tloop, "make_train_step", make)
        _, _, hist = run_training(copy.deepcopy(cfg), datasets=case.splits, variables=case.v,
                                  device="cpu")
    # the batches handed out are the uninterrupted run's in its order, the
    # killed step's included; device staging (depth 2) draws at most its
    # queue and the batch in hand beyond it
    steps = case.per_epoch[0] + kill[1] + 1
    assert steps <= len(killed_log) <= steps + 3
    assert killed_log == full["uninterrupted"][0][:len(killed_log)]
    assert tpre.global_stop_noted() and len(hist["train"]) == 2
    assert hist["val"][1] == hist["val"][0] and hist["test"][1] == hist["test"][0]
    ls = tck.load_loader_state(log_name)
    assert ls is not None and (ls.epoch, ls.next_batch) == (1, 2)
    files = os.listdir(os.path.join("logs", log_name))
    # beside the checkpoint's files, run_training's metric writer
    # (utils/writer.py): scalars.jsonl and, where TensorBoard imports, its events
    assert "scalars.jsonl" in files
    assert sorted(f for f in files if f != "scalars.jsonl"
                  and not f.startswith("events.out.tfevents.")) == sorted(
        [f"{log_name}_epoch1.pt", f"{log_name}_epoch1.pt.sha256", "latest", "loader_state.json",
         "config.json"])

    # the JAX package killed after the same step
    d = str(tmp_path / "jax")
    _, jhist, _, _ = _jax_run(case, d, kill_after=case.per_epoch[0] + kill[1] + 1, num_epoch=2)
    jls = jck.load_loader_state("run", path=d)
    assert ls.to_dict() == jls.to_dict() == LoaderState(1, 2, 0, case.per_epoch[1]).to_dict()
    _same_history(hist, jhist)

    # resume: the rest of epoch 1 first, then a normal epoch
    resumed_log, losses = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "GraphLoader", _killing_loader(resumed_log)[0])
        mp.setattr(tloop, "make_train_step", _poisoning(tloop.make_train_step, [], losses=losses))
        _, state, hist2 = run_training(case.config(num_epoch=2, **{"continue": True}),
                                       datasets=case.splits, variables=case.v, device="cpu")
    assert tck.load_loader_state(log_name) is None  # the end-of-run save cleared it
    n_tail = case.per_epoch[1] - ls.next_batch
    tail = resumed_log[:n_tail]
    want = [e for e in full["uninterrupted"][0] if e[0][0] == 1 and e[0][1] >= ls.next_batch]
    assert tail == want and [p for p, _ in tail] == [(1, i) for i in range(2, case.per_epoch[1])]
    jl = j_prepare(copy.deepcopy(cfg), case.splits)[1][0]
    jl.resume(jls.epoch, jls.next_batch)
    jl.set_epoch(0)
    jgroups, _ = jl._pack_state()
    assert [g for _, g in tail] == [tuple(int(i) for i in g) for g in jgroups[jl.start_batch:]]
    # the replayed steps' losses, bit for bit, then a whole epoch 1
    start = case.per_epoch[0] + ls.next_batch
    assert torch.equal(torch.stack(losses[:n_tail]), full["uninterrupted"][1][start:start + n_tail])
    assert [p for p, _ in resumed_log[n_tail:]] == [(1, i) for i in range(case.per_epoch[1])]
    assert len(hist2["train"]) == 2 and int(state.step) == start + n_tail + case.per_epoch[1]


# ---------------------------------------------------------------------------
# the non-finite policy and the warmup ramp


POLICY_CASES = {
    # name: (training keys, poisoned epochs)
    "warn_skip": (dict(num_epoch=3), ()),
    "warmup ramp": (dict(num_epoch=4, warmup_epochs=3), ()),
    "rollback across the warmup ramp": (
        dict(num_epoch=4, warmup_epochs=3, Checkpoint=True, non_finite_policy="rollback",
             non_finite_rollback_after=2), (1,)),
    "rollback twice, compounded": (
        dict(num_epoch=4, Checkpoint=True, non_finite_policy="rollback",
             non_finite_rollback_after=2), (1, 2)),
    "rollback bound": (
        dict(num_epoch=4, Checkpoint=True, non_finite_policy="rollback",
             non_finite_rollback_after=1, non_finite_max_rollbacks=1), (1, 2)),
    "rollback without a checkpoint": (
        dict(num_epoch=2, non_finite_policy="rollback", non_finite_rollback_after=1), (0,)),
    "error": (dict(num_epoch=2, non_finite_policy="error"), (1,)),
}


@pytest.mark.parametrize("name", list(POLICY_CASES))
def pytest_non_finite_policy_matches_jax(name, case, tmp_path, monkeypatch):
    """The same poisoned steps on both sides: the same history and learning
    rates (each rollback restores the last checkpoint and sets the LR to
    its LR times lr_backoff**rollbacks, and scales the ramp's base), the
    same rollbacks, restored weights equal to the checkpoint file's bit for
    bit, and the same error where the policy raises."""
    training, epochs = POLICY_CASES[name]
    poison = case.steps_of(*epochs)
    if name == "warn_skip":
        poison = {case.per_epoch[0] + 1}  # one bad step
    restore = name != "rollback without a checkpoint"
    out = {}
    for side in ("jax", "torch"):
        d = str(tmp_path / side)
        try:
            if side == "jax":
                st, hist, _, restored = _jax_run(case, d, poison=poison, restore=restore,
                                                 **training)
                skipped = int(np.asarray(st.skipped_steps))
            else:
                st, hist, _, restored = _torch_run(case, d, poison=poison,
                                                   restore=restore, **training)
                skipped = int(st.skipped_steps)
            out[side] = (hist, len(restored), skipped, restored)
        except RuntimeError as e:
            out[side] = e
    if name in ("rollback bound", "rollback without a checkpoint", "error"):
        phrase = {"rollback bound": "non_finite_max_rollbacks=1",
                  "rollback without a checkpoint": "no checkpoint restore path",
                  "error": "non_finite_policy is 'error'"}[name]
        for side in ("jax", "torch"):
            assert isinstance(out[side], RuntimeError) and phrase in str(out[side]), out[side]
        return
    (th, tn, tskip, trest), (jh, jn, jskip, _) = out["torch"], out["jax"]
    _same_history(th, jh)
    assert tn == jn == {"rollback across the warmup ramp": 1,
                        "rollback twice, compounded": 2}.get(name, 0)
    assert tskip == jskip
    base = case.raw["NeuralNetwork"]["Training"]["Optimizer"]["learning_rate"]
    if name == "warmup ramp":
        assert th["lr"][:3] == pytest.approx([base / 3, 2 * base / 3, base])
    if name == "rollback across the warmup ramp":
        # epoch 1 restores epoch 0's checkpoint (LR base/3) and halves it;
        # the ramp's next line starts from the halved base
        assert th["lr"][:3] == pytest.approx([base / 3, base / 6, base / 2])
    if name == "rollback twice, compounded":
        assert th["lr"][1:3] == pytest.approx([base / 2, base / 4])
    for fname, got in trest:  # every restore: the checkpoint's weights, bit for bit
        assert fname.endswith("run_epoch0.pt")
        want = torch.load(fname, weights_only=True)["model"]
        assert set(got) == set(want) and all(torch.equal(got[k], v) for k, v in want.items())


@pytest.mark.parametrize("policy", ["warn_skip", "error"])
def pytest_resumed_skip_tally_matches_jax(policy, case, tmp_path, capsys):
    """A run resumed from a state with 2 earlier skips and no bad step of
    its own: both packages count the tally from 0 in every run, so both
    report the 2 at the first epoch boundary (the same line on stderr)
    under ``warn_skip`` and raise the same error under ``error``."""
    out = {}
    for side, run in (("jax", _jax_run), ("torch", _torch_run)):
        try:
            st, hist, _, _ = run(case, str(tmp_path / side), skipped=2, num_epoch=1,
                                 non_finite_policy=policy)
            result = (int(np.asarray(st.skipped_steps)), hist)
        except RuntimeError as e:
            result = str(e)
        said = [ln for ln in capsys.readouterr().err.splitlines() if "non-finite step(s)" in ln]
        out[side] = (result, said)
    (tres, tsaid), (jres, jsaid) = out["torch"], out["jax"]
    want = "[run] epoch 0: 2 non-finite step(s) skipped by the train-step guard (total 2"
    if policy == "error":
        assert isinstance(tres, str) and tres == jres and tres.startswith(want)
        assert "non_finite_policy is 'error'" in tres
    else:
        assert tres[0] == jres[0] == 2
        _same_history(tres[1], jres[1])
        assert len(tsaid) == len(jsaid) == 1 and tsaid == jsaid and tsaid[0].startswith(want)


@pytest.mark.parametrize("return_best", [False, True])
def pytest_checkpoint_warmup_and_return_best_match_jax(case, tmp_path, return_best):
    """``checkpoint_warmup: 1`` saves no best-validation checkpoint of
    epoch 0, and ``return_best`` picks the final or the best state. Every
    step of the last epoch is poisoned (skipped), so its validation loss
    repeats epoch 2's and is no new best: the best state is epoch 2's, the
    final one 4 epochs of steps. The same files saved (extension aside),
    the same ``latest`` entry, the same history and the same step of the
    returned state as the JAX package's."""
    training = dict(num_epoch=4, Checkpoint=True, checkpoint_warmup=1,
                    return_best=return_best)
    out = {}
    for side, run in (("jax", _jax_run), ("torch", _torch_run)):
        d = str(tmp_path / side)
        st, hist, _, _ = run(case, d, poison=case.steps_of(3), **training)
        files = sorted(_stem(f) for f in os.listdir(os.path.join(d, "run")))
        latest = _stem(jck.latest_checkpoint_entry("run", path=d))
        out[side] = (int(np.asarray(st.step)), files, latest, hist)
    (tstep, tfiles, tlatest, th), (jstep, jfiles, jlatest, jh) = out["torch"], out["jax"]
    _same_history(th, jh)
    assert th["val"][3] == th["val"][2]
    assert tfiles == jfiles == ["latest", "run_epoch1", "run_epoch1.sha256",
                                "run_epoch2", "run_epoch2.sha256"]
    assert tlatest == jlatest == "run_epoch2"
    assert tstep == jstep == sum(case.per_epoch[:3 if return_best else 4])


def pytest_valtest_off_and_max_num_batch_like_jax(case, tmp_path, monkeypatch):
    """``HYDRAGNN_VALTEST=0``: the train loss stands in for val and test;
    ``HYDRAGNN_MAX_NUM_BATCH=2``: two steps per epoch. The same history as
    the JAX package's."""
    monkeypatch.setenv("HYDRAGNN_VALTEST", "0")
    monkeypatch.setenv("HYDRAGNN_MAX_NUM_BATCH", "2")
    js, jh, jseen, _ = _jax_run(case, str(tmp_path / "jax"), num_epoch=2)
    ts, th, tseen, _ = _torch_run(case, str(tmp_path / "torch"), num_epoch=2)
    _same_history(th, jh)
    assert th["val"] == th["train"] == th["test"]
    assert int(ts.step) == int(js.step) == 4 and tseen == jseen


# ---------------------------------------------------------------------------
# prediction and serving restored from disk


def _server_answers(server, graphs):
    try:
        assert server.wait_ready(timeout=120)
        out = server.predict(graphs, timeout=120)
        return out, server.stats()["current_checkpoint"]
    finally:
        server.close()


def pytest_prediction_and_serving_restored_from_disk(case, monkeypatch):
    """Two checkpoints of the run (epoch 0: the case's weights, epoch 1:
    another draw): ``run_prediction`` and ``run_server`` restore epoch 1
    and answer as the same weights given in memory (``variables``) do, bit
    for bit, and as the JAX package's ``test_model`` does within 1e-5;
    after a byte of epoch 1 flips, both walk back to epoch 0 and the
    server reports that file; with every file corrupt both raise; with no
    checkpoint at all, prediction raises and the server warns."""
    cfg = case.config()
    tc, _, _ = t_prepare(copy.deepcopy(cfg), case.splits)
    log_name = get_log_name_config(tc)
    other = copy.deepcopy(case.v)
    other["params"] = jax.tree_util.tree_map(lambda a: (a * 1.25).astype(a.dtype),
                                             other["params"])
    for epoch, v in ((0, case.v), (1, other)):
        m = t_create(tc, device="cpu")
        load_jax_variables(m, v)
        tck.save_model(TrainState.create(m, make_optimizer(m, {"type": "AdamW"})), log_name,
                       epoch=epoch)
    graphs = case.splits[2][:6]

    def predict(**kw):
        return run_prediction(copy.deepcopy(cfg), datasets=case.splits, device="cpu", **kw)

    def serve(**kw):
        return _server_answers(run_server(copy.deepcopy(cfg), datasets=case.splits,
                                          device="cpu", **kw), graphs)

    def same(a, b):
        return all(np.array_equal(a[k], b[k]) for k in a)

    disk, mem = predict(), predict(variables=other)
    assert disk[0] == mem[0] and all(same(a, b) for a, b in zip(disk[2:], mem[2:]))
    jc, (_, _, jtel), _ = j_prepare(copy.deepcopy(cfg), case.splits)
    jtot, _, jpreds, _ = j_test_model(case.jm, JState.create(
        jax.tree_util.tree_map(jnp.asarray, other), case.tx), jtel)
    assert disk[0] == pytest.approx(jtot, rel=LOSS_RTOL)
    for k, want in jpreds.items():
        assert float(np.abs(disk[2][k] - want).max()) <= PRED_RTOL * float(np.abs(want).max())
    answers, label = serve()
    assert label == f"{log_name}_epoch1.pt"
    assert all(same(a, b) for a, b in zip(answers, serve(variables=other)[0]))

    def flip(epoch):
        with open(os.path.join("logs", log_name, f"{log_name}_epoch{epoch}.pt"), "r+b") as f:
            f.seek(1000)
            b = f.read(1)
            f.seek(1000)
            f.write(bytes([b[0] ^ 0xFF]))

    flip(1)
    answers, label = serve()
    assert label == f"{log_name}_epoch0.pt"
    in_memory, mem_label = serve(variables=case.v)
    assert mem_label is None and all(same(a, b) for a, b in zip(answers, in_memory))
    disk = predict()
    assert all(same(a, b) for a, b in zip(disk[2:], predict(variables=case.v)[2:]))

    flip(0)  # checkpoints on disk, none verified: both raise, the server too
    for restore in (predict, serve):
        with pytest.raises(FileNotFoundError, match="no loadable checkpoint"):
            restore()

    os.rename("logs", "old_logs")
    with pytest.raises(FileNotFoundError, match="does not exist"):
        predict()
    with pytest.warns(UserWarning, match="no checkpoint on disk"):
        _, label = serve()
    assert label is None


# ---------------------------------------------------------------------------
# the SIGTERM handler


@pytest.mark.parametrize("pre", [jpre, tpre], ids=["jax", "torch"])
def pytest_handler_restored_and_flag_reset(pre):
    """After training the SIGTERM disposition is restored, and a fresh
    install clears a stale flag (it would stop the next run at its first
    step); the stop noted by the loop is what gates the end-of-run save."""
    prev = signal.getsignal(signal.SIGTERM)
    pre.install()
    assert signal.getsignal(signal.SIGTERM) is not prev
    os.kill(os.getpid(), signal.SIGTERM)
    assert pre.preempted()
    pre.uninstall()
    assert signal.getsignal(signal.SIGTERM) == prev
    pre.install()
    assert not pre.preempted()
    pre.uninstall()
    pre.reset()
    pre._flag.set()
    assert not pre.global_stop_noted()
    pre.note_global_stop()
    assert pre.global_stop_noted()
    pre.reset()
    assert not pre.preempted() and not pre.global_stop_noted()
