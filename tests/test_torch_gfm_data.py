"""The port's ``prepare_data`` against the JAX package's on explicit
datasets, on the CPU: the data keys that shape the train loader
(``oversampling``, ``num_samples``, ``balance_branch_sampling``,
``size_bucketed_batching``), the sample validator's policies
(``Dataset.bad_sample_policy``), and a narrow multibranch GFM recipe
trained end to end through ``run_training``.

The loaders must give the same batches: the same graphs in the same order
and the same padded arrays (exact, as both build them in numpy from the
same draws). The GFM run: 3 branches drawn balanced from uneven data,
branch loss weights, conv node heads, 2 epochs from the bridged JAX
weights; its history (train, val and test losses, learning rates) to
1e-5, as tests/test_torch_train.py holds ``run_training``'s history.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hydragnn_tpu.api import prepare_data as j_prepare
from hydragnn_tpu.data.validate import BadSampleError as JBadSample
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.train import TrainState as JState
from hydragnn_tpu.train import make_optimizer as j_make_optimizer
from hydragnn_tpu.train.loop import train_validate_test as j_tvt
from hydragnn_tpu_torch.api import prepare_data as t_prepare
from hydragnn_tpu_torch.api import run_training
from hydragnn_tpu_torch.data.validate import BadSampleError
from test_torch_gfm import multibranch
from test_torch_train import _config, _splits
from test_torch_zoo import _jax_init

torch.set_num_threads(2)

LOSS_RTOL = 1e-5


def _epoch(loader, epoch=0):
    loader.set_epoch(epoch)
    return list(loader)


def _same_batches(jbatches, tbatches):
    """The same batches: graph counts, node counts, and every padded array
    the model reads, exactly."""
    assert len(jbatches) == len(tbatches)
    for jb, tb in zip(jbatches, tbatches):
        for f in ("x", "pos", "graph_mask", "node_mask", "node_graph", "dataset_id",
                  "senders", "receivers"):
            np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                                          err_msg=f)


def _counts(batches):
    return len(batches), sum(int(b.graph_mask.sum()) for b in batches)


def _both(training=None, dataset=None, splits=None, config=None):
    raw = copy.deepcopy(config or _config())
    raw["NeuralNetwork"]["Training"].update(training or {})
    raw.setdefault("Dataset", {}).update(dataset or {})
    splits = splits or _splits()
    jc, jl, _ = j_prepare(copy.deepcopy(raw), splits)
    tc, tl, _ = t_prepare(copy.deepcopy(raw), splits)
    return jc, jl, tc, tl


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("training,counts", [
    ({}, (6, 21)),
    ({"oversampling": True, "num_samples": 40}, (10, 40)),
    ({"num_samples": 8}, (2, 8)),
    ({"oversampling": True}, (6, 21)),
])
def pytest_train_loader_draws_match_jax(training, counts, pack):
    """Epochs 0 and 1 of the train loader: the same batches as the JAX
    package's (21 train graphs, batch 4), packed or not; unpacked, the
    (batches, graphs) of the JAX column of the ROADMAP's table."""
    _, jl, _, tl = _both(dict(training, pack_batches=pack))
    for epoch in (0, 1):
        jb, tb = _epoch(jl[0], epoch), _epoch(tl[0], epoch)
        _same_batches(jb, tb)
        assert _counts(tb) == _counts(jb) and _counts(tb)[1] == counts[1]
        if not pack:
            assert _counts(tb) == counts
    _same_batches(_epoch(jl[1]), _epoch(tl[1]))


def _uneven(splits, shares=(0.6, 0.3, 0.1)):
    """The splits' graphs given dataset ids 0-2 in the proportions
    ``shares`` (train split)."""
    out = []
    for s in splits:
        n = len(s)
        cut = np.cumsum([int(round(f * n)) for f in shares[:-1]])
        ids = np.searchsorted(cut, np.arange(n), side="right")
        out.append([dataclasses.replace(g, dataset_id=int(i)) for g, i in zip(s, ids)])
    return tuple(out)


def pytest_balance_branch_sampling_matches_jax():
    """``balance_branch_sampling``: weighted draws with replacement, each
    branch a third of the draws whatever its share of the data: the same
    batches as the JAX package's, and over 20 epochs each branch's share of
    the draws near a third while its share of the data is 0.6 / 0.3 / 0.1."""
    splits = _uneven(_splits())
    cfg = multibranch(_config(), 3)
    _, jl, _, tl = _both({"balance_branch_sampling": True}, splits=splits, config=cfg)
    _same_batches(_epoch(jl[0]), _epoch(tl[0]))
    draws = np.concatenate([
        b.dataset_id.numpy()[b.graph_mask.numpy()] for e in range(20) for b in _epoch(tl[0], e)])
    share = np.bincount(draws, minlength=3) / draws.size
    data = np.bincount([g.dataset_id for g in splits[0]], minlength=3) / len(splits[0])
    assert data[0] > 0.5 and data[2] < 0.15
    assert np.all(np.abs(share - 1 / 3) < 0.08), share


def pytest_size_bucketed_batching_matches_jax():
    """``size_bucketed_batching`` (unpacked, 3 pad buckets): the same
    ladder, built by simulating the bucketed composition, and the same
    batches, of graphs of like size."""
    jc, jl, tc, tl = _both({"size_bucketed_batching": True, "pack_batches": False,
                            "num_pad_buckets": 3, "batch_size": 3})
    assert [dataclasses.asdict(s) for s in tl[0].ladder.specs] == \
        [dataclasses.asdict(s) for s in jl[0].ladder.specs]
    for epoch in (0, 1):
        _same_batches(_epoch(jl[0], epoch), _epoch(tl[0], epoch))
    _same_batches(_epoch(jl[2]), _epoch(tl[2]))
    spread = [np.ptp(np.bincount(b.node_graph.numpy()[b.node_mask.numpy()]))
              for b in _epoch(tl[0])[:-1]]
    assert np.median(spread) <= 4


def _with_nan(splits):
    tr = list(splits[0])
    x = tr[3].x.copy()
    x[0, 0] = np.nan
    tr[3] = dataclasses.replace(tr[3], x=x)
    return (tr, *splits[1:])


@pytest.mark.parametrize("pack", [True, False])
def pytest_bad_sample_policy_warn_skip_matches_jax(capfd, pack):
    """The default ``warn_skip``: a train graph with a NaN feature is
    dropped, counted and named on stderr by both packages, and the loaders
    give the same batches (of 20 graphs; unpacked, 5 batches)."""
    splits = _with_nan(_splits())
    _, jl, _, tl = _both({"pack_batches": pack}, splits=splits)
    err = capfd.readouterr().err
    assert "skipping bad sample 3 (dataset_id 0, source 'train'): nonfinite_features" in err
    assert "[hydragnn_tpu_torch.data]" in err
    assert tl[0].validator.stats()["skipped"] == jl[0].validator.stats()["skipped"] == \
        {"nonfinite_features": 1}
    _same_batches(_epoch(jl[0]), _epoch(tl[0]))
    assert _counts(_epoch(tl[0]))[1] == 20
    if not pack:
        assert _counts(_epoch(tl[0])) == (5, 20)


def pytest_bad_sample_policy_error_raises_as_jax():
    splits = _with_nan(_splits())
    raw = _config()
    raw["Dataset"]["bad_sample_policy"] = "error"
    with pytest.raises(JBadSample, match="sample 3 .*nonfinite_features"):
        j_prepare(copy.deepcopy(raw), splits)
    with pytest.raises(BadSampleError, match="sample 3 .*nonfinite_features"):
        t_prepare(copy.deepcopy(raw), splits)


def _gfm_config():
    """A narrow multibranch GFM recipe: the EGNN of tests/test_torch_train.py
    with 3 branches, conv node heads, balanced branch sampling, branch loss
    weights and the per-branch scalars, trained by SGD: each conv of a head
    chain ends in a dense layer that feeds a batch norm, whose bias has a
    gradient of pure rounding noise, and Adam would move it by about its
    learning rate either way in each package (tests/test_torch_train.py
    holds AdamW's steps apart from that)."""
    cfg = multibranch(_config(num_epoch=2), 3, node_type="conv")
    cfg["NeuralNetwork"]["Training"]["Optimizer"] = {"type": "SGD", "learning_rate": 1e-2}
    arch = cfg["NeuralNetwork"]["Architecture"]
    for head in arch["output_heads"]["node"]:
        head["architecture"].update(num_headlayers=1, dim_headlayers=[12])
    arch.update(branch_loss_weights=[1.0, 2.0, 0.5], branch_loss_metrics=True)
    cfg["NeuralNetwork"]["Training"]["balance_branch_sampling"] = True
    return cfg


def pytest_gfm_run_training_history_matches_jax(tmp_path, monkeypatch):
    """``run_training(device="cpu")`` of the narrow GFM recipe from the
    bridged weights against the JAX package's ``train_validate_test`` on
    its own loaders: the train, val and test losses and the learning rate
    of both epochs; each epoch's per-branch train losses reported."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HYDRAGNN_PALLAS_SEGMENT", "1")
    splits = _uneven(_splits())
    raw = _gfm_config()
    jc, (jtl, jvl, jtel), _ = j_prepare(copy.deepcopy(raw), splits)
    jm = j_create(jc)
    v = _jax_init(jm, next(iter(jtl)))
    tx = j_make_optimizer(jc["NeuralNetwork"]["Training"]["Optimizer"])
    js = JState.create(jax.tree_util.tree_map(jnp.asarray, v), tx)
    js, jhist = j_tvt(jm, js, tx, jtl, jvl, jtel, jc)
    _, ts, hist = run_training(copy.deepcopy(raw), datasets=splits, variables=v, device="cpu")
    assert len(hist["train"]) == len(jhist["train"]) == 2
    for k in ("train", "val", "test"):
        np.testing.assert_allclose(hist[k], jhist[k], rtol=LOSS_RTOL, err_msg=k)
    assert hist["lr"] == pytest.approx(jhist["lr"])
    assert int(ts.step) == int(js.step)
    for tasks in hist["train_tasks"]:
        assert sorted(k for k in tasks if k.startswith("branch")) == \
            ["branch0", "branch1", "branch2"]
        assert all(np.isfinite(list(tasks.values())))
