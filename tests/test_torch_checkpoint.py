"""The port's checkpoint protocol against the JAX package's, on the CPU.

Every scenario of ``tests/test_checkpoint.py`` runs through
``hydragnn_tpu.train.checkpoint`` and ``hydragnn_tpu_torch.train.checkpoint``
side by side, each in its own directory, on a one-parameter state whose
value names the save it came from (``w`` = 1.0, 2.0, ...). For each, the
value restored, the files left on disk (``.msgpack`` and ``.pt`` read as
one extension), the exception type and the warnings must be equal. A
process killed inside a save is simulated in-process: ``os.replace`` raises
at its N-th call of the save (1: the payload's, 2: the sidecar's, 3: the
``latest`` pointer's), so the files stand as a kill at that point leaves
them (the tmp file of the write in flight removed, as both packages'
writers do on an exception).

Then the port's own contract: a ``TrainState`` round trip (parameters,
batch-norm buffers, AdamW moments and step counts, the three counters and
the learning rate) is bit-exact, restores in place so the guard's copies
stay valid, and continues training with the same bits; the payload holds
only CPU tensors; a payload of another model is walked past.
"""

import copy
import os
import warnings

import numpy as np
import pytest
import torch

from hydragnn_tpu.train import TrainState as JState
from hydragnn_tpu.train import make_optimizer as j_make_optimizer
from hydragnn_tpu.train import checkpoint as jck
from hydragnn_tpu.train.state import InferenceState as JInference
from hydragnn_tpu.train.state import LoaderState as JLoaderState
from hydragnn_tpu_torch.api import prepare_data
from hydragnn_tpu_torch.data import oc20_shaped_dataset, split_dataset
from hydragnn_tpu_torch.models import create_model
from hydragnn_tpu_torch.train import InferenceState, LoaderState, TrainState
from hydragnn_tpu_torch.train import checkpoint as tck
from hydragnn_tpu_torch.train import make_optimizer, make_train_step

torch.set_num_threads(2)


class _Killed(BaseException):
    """A process death inside a save (not an ``OSError``: no retry)."""


class _W(torch.nn.Module):
    def __init__(self, v: float):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((4,), float(v)))


class _Side:
    """One package's checkpoint module and a state of one parameter ``w``
    of 4 values, all ``v``, under SGD (as tests/test_checkpoint.py)."""

    def __init__(self, name: str, root: str):
        self.name, self.root = name, root
        self.mod = jck if name == "jax" else tck
        self.ext = ".msgpack" if name == "jax" else ".pt"

    def state(self, v: float):
        if self.name == "jax":
            return JState.create({"params": {"w": np.full((4,), v, np.float32)}},
                                 j_make_optimizer({"type": "SGD", "learning_rate": 1e-2}))
        m = _W(v)
        return TrainState.create(m, make_optimizer(m, {"type": "SGD", "learning_rate": 1e-2}))

    def save(self, v: float, **kw) -> str:
        return self.mod.save_model(self.state(v), "run", path=self.root, **kw)

    def restore(self, run: str = "run") -> float:
        st = self.mod.load_existing_model(self.state(0.0), run, path=self.root)
        w = st.params["w"] if self.name == "jax" else st.model.w.detach()
        return float(np.asarray(w)[0])

    def restore_inference(self):
        """(value, file restored) through the optimizer-free restore."""
        if self.name == "jax":
            st, fn = jck.load_inference_state(
                JInference.create({"params": {"w": np.zeros((4,), np.float32)}}), "run",
                path=self.root)
            return float(np.asarray(st.params["w"])[0]), fn.replace(self.ext, ".pt")
        st, fn = tck.load_inference_state(InferenceState(_W(0.0)), "run", path=self.root)
        return float(st.model.w[0]), fn

    def files(self, run: str = "run"):
        d = os.path.join(self.root, run)
        if not os.path.isdir(d):
            return None
        return sorted(f.replace(self.ext, ".pt") for f in os.listdir(d))

    def path(self, name: str) -> str:
        return os.path.join(self.root, "run", name.replace(".pt", self.ext))


def _flip_byte(path: str) -> None:
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def _replace_raising(monkeypatch, at=None, errors=0):
    """``os.replace`` that raises ``_Killed`` at its ``at``-th call, or
    ``OSError`` at its first ``errors`` calls."""
    real, calls = os.replace, [0]

    def fake(src, dst):
        calls[0] += 1
        if calls[0] == at:
            raise _Killed(f"killed at replace {at}")
        if calls[0] <= errors:
            raise OSError(f"transient IO error {calls[0]}")
        return real(src, dst)

    monkeypatch.setattr(os, "replace", fake)


def _kill(at):
    def run(side, mp):
        side.save(1.0, epoch=0)
        _replace_raising(mp, at=at)
        if at is None:
            side.save(2.0, epoch=1)
        else:
            with pytest.raises(_Killed):
                side.save(2.0, epoch=1)
        mp.undo()
        return side.restore()
    return run


def _same_name_resave(side, mp):
    side.save(1.0)
    _replace_raising(mp, at=2)  # killed between the payload and its sidecar
    with pytest.raises(_Killed):
        side.save(2.0)
    mp.undo()
    return side.restore()


def _bit_flip(side, mp):
    side.save(1.0, epoch=0)
    _flip_byte(side.save(2.0, epoch=1))
    return side.restore(), side.restore_inference()


def _bit_flip_of_three(side, mp):
    side.save(1.0, epoch=0)
    side.save(2.0, epoch=1)
    _flip_byte(side.save(3.0, epoch=2))
    return side.restore(), side.restore_inference()


def _latest_missing(side, mp):
    side.save(1.0, epoch=0)
    os.unlink(side.save(2.0, epoch=1))
    return side.restore()


def _no_sidecar(side, mp):
    os.unlink(side.save(3.0, epoch=0) + ".sha256")
    return side.restore()


def _transient_errors(side, mp):
    mp.setenv("HYDRAGNN_CKPT_RETRY_BASE", "0")
    _replace_raising(mp, errors=2)
    side.save(4.0, epoch=0)
    mp.undo()
    return side.restore()


def _errors_beyond_retries(side, mp):
    mp.setenv("HYDRAGNN_CKPT_RETRY_BASE", "0")
    mp.setenv("HYDRAGNN_CKPT_RETRIES", "3")
    _replace_raising(mp, errors=50)
    side.save(5.0, epoch=0)


def _retention(side, mp):
    for e, v in enumerate([1.0, 2.0, 3.0, 4.0]):
        side.save(v, epoch=e, retention=2)
    return side.restore()


def _missing_dir(side, mp):
    return side.restore("no_such_run")


def _empty_dir(side, mp):
    os.makedirs(os.path.join(side.root, "empty"))
    return side.restore("empty")


def _all_corrupt(side, mp):
    for fn in (side.save(1.0, epoch=0), side.save(2.0, epoch=1)):
        _flip_byte(fn)
    return side.restore()


def _malformed_epoch_env(side, mp):
    mp.setenv("HYDRAGNN_EPOCH", "not-an-int")
    fname = side.save(6.0)
    return os.path.basename(fname).replace(side.ext, ".pt"), side.restore()


SCENARIOS = {
    "kill after the tmp write": _kill(1),
    "kill after the payload replace": _kill(2),
    "kill after the digest write": _kill(3),
    "no kill": _kill(None),
    "same-name resave killed before its sidecar": _same_name_resave,
    "bit flip": _bit_flip,
    "bit flip of the newest of three": _bit_flip_of_three,
    "latest names a missing file": _latest_missing,
    "payload without a sidecar": _no_sidecar,
    "transient OSErrors retry": _transient_errors,
    "OSErrors beyond the retries": _errors_beyond_retries,
    "retention 2": _retention,
    "missing run directory": _missing_dir,
    "empty run directory": _empty_dir,
    "every copy corrupt": _all_corrupt,
    "malformed HYDRAGNN_EPOCH": _malformed_epoch_env,
}


def _outcome(side, scenario, monkeypatch):
    """(result or exception type, files left, warning kinds, error text)."""
    with monkeypatch.context() as mp, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            result, err = SCENARIOS[scenario](side, mp), ""
        except Exception as e:  # noqa: BLE001 — the type is compared
            result, err = type(e), str(e)
    kinds = sorted({k for w in caught for k in ("no sha256 sidecar", "HYDRAGNN_EPOCH")
                    if k in str(w.message)})
    return result, side.files(), kinds, err


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def pytest_protocol_matches_jax(scenario, tmp_path, monkeypatch):
    """The same restore, the same files (extension aside), the same
    exception type and warnings as the JAX package's protocol."""
    jax_out = _outcome(_Side("jax", str(tmp_path / "jax")), scenario, monkeypatch)
    port_out = _outcome(_Side("torch", str(tmp_path / "torch")), scenario, monkeypatch)
    assert port_out[:3] == jax_out[:3], (scenario, jax_out, port_out)
    # the actionable error names the same things
    for needle in ("does not exist", "files present", "candidates tried", "sha256 mismatch"):
        assert (needle in jax_out[3]) == (needle in port_out[3]), (needle, jax_out[3],
                                                                   port_out[3])


@pytest.mark.parametrize("scenario,want", [
    ("kill after the tmp write", 1.0), ("kill after the payload replace", 1.0),
    ("kill after the digest write", 1.0), ("no kill", 2.0),
    ("same-name resave killed before its sidecar", 2.0),
    ("bit flip", (1.0, (1.0, "run_epoch0.pt"))),
    ("bit flip of the newest of three", (2.0, (2.0, "run_epoch1.pt"))),
    ("latest names a missing file", 1.0),
    ("payload without a sidecar", 3.0), ("transient OSErrors retry", 4.0),
    ("OSErrors beyond the retries", OSError), ("retention 2", 4.0),
    ("missing run directory", FileNotFoundError), ("empty run directory", FileNotFoundError),
    ("every copy corrupt", FileNotFoundError), ("malformed HYDRAGNN_EPOCH", ("run.pt", 6.0)),
])
def pytest_port_restores_what_the_protocol_promises(scenario, want, tmp_path, monkeypatch):
    """What each scenario restores (the values of tests/test_checkpoint.py):
    a save killed anywhere restores the previous epoch, a completed one its
    own, a corrupt or missing file the one before it."""
    assert _outcome(_Side("torch", str(tmp_path)), scenario, monkeypatch)[0] == want


def pytest_loader_state_sidecar_matches_jax(tmp_path):
    """``save_loader_state`` writes the same record as the JAX package,
    each reads the other's, ``clear_loader_state`` removes it, and a
    malformed sidecar warns and reads as None in both."""
    rec = {"epoch": 1, "next_batch": 3, "seed": 0, "num_batches": 7}
    jck.save_loader_state(JLoaderState.from_dict(rec), "run", path=str(tmp_path / "j"))
    tck.save_loader_state(LoaderState.from_dict(rec), "run", path=str(tmp_path / "t"))
    for a, b in (("j", "t"), ("t", "j")):
        with open(tmp_path / a / "run" / "loader_state.json") as f:
            text = f.read()
        with open(tmp_path / b / "run" / "loader_state.json") as f:
            assert f.read() == text
    assert tck.load_loader_state("run", path=str(tmp_path / "j")).to_dict() == rec
    assert jck.load_loader_state("run", path=str(tmp_path / "t")).to_dict() == rec
    for mod, d in ((jck, "j"), (tck, "t")):
        with open(tmp_path / d / "run" / "loader_state.json", "w") as f:
            f.write("{not json")
        with pytest.warns(UserWarning, match="unreadable"):
            assert mod.load_loader_state("run", path=str(tmp_path / d)) is None
        mod.clear_loader_state("run", path=str(tmp_path / d))
        assert mod.load_loader_state("run", path=str(tmp_path / d)) is None
        mod.clear_loader_state("run", path=str(tmp_path / d))  # a missing file is fine


def pytest_inference_entry_and_latest_match_jax(tmp_path):
    """``latest_checkpoint_entry`` and ``load_inference_entry`` (one named
    file, no walk-back): the same entry, value and exception types as the
    JAX package's."""
    outs = []
    for name in ("jax", "torch"):
        side = _Side(name, str(tmp_path / name))
        side.save(1.0, epoch=0)
        side.save(2.0, epoch=1)
        entry = side.mod.latest_checkpoint_entry("run", path=side.root)
        if name == "jax":
            tmpl = JInference.create({"params": {"w": np.zeros((4,), np.float32)}})
            get = lambda st: float(np.asarray(st.params["w"])[0])  # noqa: E731
        else:
            tmpl = InferenceState(_W(0.0))
            get = lambda st: float(st.model.w[0])  # noqa: E731
        got = get(side.mod.load_inference_entry(tmpl, "run", entry.replace(".pt", side.ext)
                                                if name == "jax" else entry, path=side.root))
        errs = []
        with pytest.raises(FileNotFoundError):
            side.mod.load_inference_entry(tmpl, "run", "absent" + side.ext, path=side.root)
        _flip_byte(side.path("run_epoch0.pt"))
        with pytest.raises(ValueError) as e:
            side.mod.load_inference_entry(tmpl, "run", "run_epoch0" + side.ext, path=side.root)
        errs.append("failed verification" in str(e.value))
        outs.append((entry.replace(side.ext, ".pt"), got, errs))
        assert side.mod.latest_checkpoint_entry("absent", path=side.root) is None
    assert outs[0] == outs[1] == ("run_epoch1.pt", 2.0, [True])


# ---------------------------------------------------------------------------
# the TrainState payload


def _egnn_state(seed: int, hidden: int = 16):
    import chip_smoke

    graphs = oc20_shaped_dataset(24, mean_atoms=12, min_atoms=6, max_atoms=20,
                                 max_neighbours=8)
    config, (train_loader, _, _), _ = prepare_data(
        chip_smoke.train_config(batch_size=4, hidden=hidden, head=8),
        split_dataset(graphs, 0.75, seed=0))
    model = create_model(config, device="cpu", seed=seed)
    state = TrainState.create(model, make_optimizer(
        model, config["NeuralNetwork"]["Training"]["Optimizer"]))
    return state, list(train_loader)


def _tensors(state):
    """Every tensor a checkpoint must carry, by name, plus the scalars."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"optimizer.{i}.{k}": v for k, v in st.items()})
    return out, (int(state.step), int(state.skipped_steps), int(state.consecutive_skips),
                 state.learning_rate)


def pytest_train_state_round_trip_is_bit_exact(tmp_path):
    """Parameters, batch-norm buffers, AdamW moments and step counts, the
    counters and the learning rate restore bit for bit into a fresh model
    and optimizer (another seed), in place: ``held`` keeps its tensors, so
    the guard's copies stay valid (a NaN step of the restored state puts
    back exactly the restored values), and training continues with the
    same bits as the state that was saved."""
    state, batches = _egnn_state(seed=1)
    step = make_train_step(state.model, mixed_precision=True)
    for b in batches[:-1]:
        step(state, b)
    nan = batches[0].replace(x=torch.full_like(batches[0].x, float("nan")))
    step(state, nan)  # a skipped step: the counters are nonzero
    state.with_learning_rate(3.7e-4)
    tck.save_model(state, "run", path=str(tmp_path), epoch=0)

    fresh, _ = _egnn_state(seed=2)
    held = list(fresh.held)
    want, want_scalars = _tensors(state)
    got, _ = _tensors(fresh)
    assert set(got) == set(want)
    assert not all(torch.equal(got[k], want[k]) for k in want)
    tck.load_existing_model(fresh, "run", path=str(tmp_path))
    got, got_scalars = _tensors(fresh)
    assert got_scalars == want_scalars == (len(batches), 1, 1, 3.7e-4)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert all(a is b for a, b in zip(fresh.held, held))
    fresh_step = make_train_step(fresh.model, mixed_precision=True)
    fresh_step(fresh, nan)
    assert int(fresh.skipped_steps) == 2 and int(fresh.consecutive_skips) == 2
    assert all(torch.equal(got[k], v) for k, v in _tensors(fresh)[0].items()
               if not k.endswith(".step"))
    # the same next step from the saved state and from the restored one
    _, la, _ = step(state, batches[-1])
    _, lb, _ = fresh_step(fresh, batches[-1])
    assert torch.equal(la, lb)
    for a, b in zip(state.held, fresh.held):
        assert torch.equal(a, b)


def pytest_payload_holds_cpu_tensors_and_loads_anywhere(tmp_path):
    """The payload is ``torch.save`` of plain values and CPU tensors, each
    its own storage: ``torch.load(weights_only=True)`` reads it on a host
    without the card, and a ``map_location`` moves it whole. (The round
    trip between the card and the CPU runs in tests/test_torch_cuda.py.)"""
    state, _ = _egnn_state(seed=1)
    fname = tck.save_model(state, "run", path=str(tmp_path))
    payload = torch.load(fname, weights_only=True)
    assert payload["format"] == "hydragnn_tpu_torch.TrainState/1"

    def leaves(tree):
        if torch.is_tensor(tree):
            yield tree
        elif isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                yield from leaves(v)

    ts = list(leaves(payload))
    assert ts and all(t.device.type == "cpu" for t in ts)
    assert all(t.untyped_storage().nbytes() == t.numel() * t.element_size() for t in ts)
    moved = torch.load(fname, weights_only=True, map_location=lambda s, loc: s)
    assert all(torch.equal(a, b) for a, b in zip(ts, leaves(moved)))
    assert os.path.getsize(fname) >= sum(t.numel() * t.element_size() for t in ts)


def pytest_payload_of_another_model_is_walked_past(tmp_path):
    """A newer payload of another model (a config change between runs) does
    not load into this one: the restore says why and walks back to the
    older payload that fits, leaving the template untouched until then."""
    small, _ = _egnn_state(seed=1, hidden=16)
    tck.save_model(small, "run", path=str(tmp_path), epoch=0)
    tck.save_model(_egnn_state(seed=3, hidden=24)[0], "run", path=str(tmp_path), epoch=1)
    fresh, _ = _egnn_state(seed=2, hidden=16)
    loaded = []
    tck.load_existing_model(fresh, "run", path=str(tmp_path), loaded_entry=loaded)
    assert loaded == ["run_epoch0.pt"]
    assert all(torch.equal(a, b) for a, b in zip(fresh.held, small.held))
    other = copy.deepcopy(fresh)
    os.unlink(tmp_path / "run" / "run_epoch0.pt")
    before = [t.clone() for t in other.held]
    with pytest.raises(FileNotFoundError, match="does not fit this model"):
        tck.load_existing_model(other, "run", path=str(tmp_path))
    assert all(torch.equal(a, b) for a, b in zip(other.held, before))
