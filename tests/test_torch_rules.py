"""The port's rule tables (``parallel/rules.py``) against the JAX package's.

Pure placement decisions, no process group: ``resolve`` on the configs of
tests/test_sharding_rules.py (presets, legacy keys, conflicts, the
recorded round trip) gives the JAX package's ``to_config()``; the leaves
each table shards on the port's models (``bridge.flax_leaves``: flax paths
and shapes) are exactly those the JAX package's ``spec_tree`` shards on
the same models; and what the port cannot place raises, naming the rule.
"""

import copy

import numpy as np
import pytest

import jax

import torch_dist_workers as W
from hydragnn_tpu.api import resolve_parallel as j_resolve_parallel
from hydragnn_tpu.config import update_config as j_update
from hydragnn_tpu.data.graph import PadSpec as JSpec
from hydragnn_tpu.data.graph import batch_graphs as j_batch
from hydragnn_tpu.models import create_model as j_create
from hydragnn_tpu.parallel import rules as JR
from hydragnn_tpu_torch.api import resolve_parallel as t_resolve_parallel
from hydragnn_tpu_torch.bridge import flax_leaves
from hydragnn_tpu_torch.config import update_config as t_update
from hydragnn_tpu_torch.data import split_dataset
from hydragnn_tpu_torch.models import create_model as t_create
from hydragnn_tpu_torch.parallel import rules as TR

_ROUTED = {"rules": [{"pattern": "heads_NN", "spec": ["model"], "leading_eq": 2},
                     {"pattern": ".*", "spec": []}],
           "model_size": 2, "routed": True}
_BRANCH_HEADS = {"graph": [{"type": f"branch-{b}", "architecture": {
    "num_sharedlayers": 1, "dim_sharedlayers": 8, "num_headlayers": 2,
    "dim_headlayers": [8, 8]}} for b in range(2)]}

RESOLVE_CASES = {
    "empty": {},
    "zero_stage_1": {"NeuralNetwork": {"Training": {"Optimizer": {"zero_stage": 1}}}},
    "zero_stage_2": {"NeuralNetwork": {"Training": {"Optimizer": {"zero_stage": 2}}}},
    "zero_stage_5": {"NeuralNetwork": {"Training": {"Optimizer": {"zero_stage": 5}}}},
    "use_zero_redundancy": {"NeuralNetwork": {"Training": {
        "Optimizer": {"use_zero_redundancy": True}}}},
    "preset_zero3_min_size": {"Parallel": {"rules": "zero3", "min_size": 64}},
    "preset_dp": {"Parallel": {"rules": "dp"}},
    "inline_routed": {"Parallel": copy.deepcopy(_ROUTED)},
    "inline_zero": {"Parallel": {"rules": [
        {"pattern": "graph_convs", "spec": ["data"], "scope": ["opt_state", "grads"],
         "min_size": 32, "reason": "encoder moments"},
        {"pattern": ".*", "spec": []}], "name": "mine"}},
    "branch_parallel": {"NeuralNetwork": {"Architecture": {"output_heads": _BRANCH_HEADS},
                                          "Training": {"branch_parallel": True}}},
    "preset_mp": {"Parallel": {"rules": "mp"},
                  "NeuralNetwork": {"Architecture": {"output_heads": _BRANCH_HEADS}}},
    "preset_branch_with_flag": {"Parallel": {"rules": "branch"}, "NeuralNetwork": {
        "Architecture": {"output_heads": _BRANCH_HEADS}, "Training": {"branch_parallel": True}}},
}


@pytest.mark.parametrize("case", list(RESOLVE_CASES))
def pytest_resolve_matches_jax(case):
    """The same table, by ``to_config()``, from presets, inline tables and
    the legacy keys; ``resolve_parallel`` records it and brings the legacy
    keys in line as the JAX package's does, idempotently; the recorded
    block rebuilds the same table."""
    cfg = RESOLVE_CASES[case]
    want = JR.resolve(copy.deepcopy(cfg)).to_config()
    assert TR.resolve(copy.deepcopy(cfg)).to_config() == want
    jc, tc = copy.deepcopy(cfg), copy.deepcopy(cfg)
    j_resolve_parallel(jc)
    t_resolve_parallel(tc)
    t_resolve_parallel(tc)
    assert tc == jc
    assert TR.table_from_recorded(tc["Parallel"]["resolved_rules"]).to_config() == want


CONFLICTS = {
    "zero2_with_branch_parallel": ({"NeuralNetwork": {"Training": {
        "branch_parallel": True, "Optimizer": {"zero_stage": 2}}}}, "branch_parallel"),
    "unrouted_table_with_branch_parallel": ({"Parallel": {"rules": "dp"}, "NeuralNetwork": {
        "Training": {"branch_parallel": True}}}, "branch_parallel"),
    "zero1_table_with_stage_2": ({"Parallel": {"rules": "zero1"}, "NeuralNetwork": {
        "Training": {"Optimizer": {"zero_stage": 2}}}}, "grads"),
    "branch_of_one_branch": ({"Parallel": {"rules": "branch"}}, "num_branches"),
    "unknown_preset": ({"Parallel": {"rules": "fsdp"}}, "unknown Parallel.rules preset"),
    "unknown_rule_key": ({"Parallel": {"rules": [{"pattern": ".*", "sepc": ["data"]}]}},
                         "unknown keys"),
    "missing_pattern": ({"Parallel": {"rules": [{"spec": ["data"]}]}}, "missing 'pattern'"),
    "bad_regex": ({"Parallel": {"rules": [{"pattern": "(unclosed"}]}}, "bad regex"),
    "unknown_axis": ({"Parallel": {"rules": [{"pattern": ".*", "spec": ["tensor"]}]}},
                     "unknown axis"),
    "grads_over_model": ({"Parallel": {"rules": [
        {"pattern": ".*", "spec": ["model"], "scope": ["grads"]}]}}, "model axis"),
}


@pytest.mark.parametrize("case", list(CONFLICTS))
def pytest_conflicts_raise_as_in_jax(case):
    cfg, words = CONFLICTS[case]
    with pytest.raises(JR.RuleError, match=words):
        JR.resolve(copy.deepcopy(cfg))
    with pytest.raises(TR.RuleError, match=words):
        TR.resolve(copy.deepcopy(cfg))


@pytest.mark.parametrize("name", TR.PRESET_NAMES)
def pytest_presets_match_jax(name):
    kw = dict(min_size=256, num_branches=3)
    assert TR.preset(name, **kw).to_config() == JR.preset(name, **kw).to_config()


def pytest_admission_predicates_match_jax():
    """``min_size``, leading-axis divisibility and ``leading_eq`` on shapes,
    as the JAX predicates decide them on arrays (tests/test_sharding_rules.py
    ``pytest_admission_predicates``)."""
    shapes = {"big": (8, 64), "small": (8, 4), "odd": (6, 64), "bank2": (2, 16),
              "bank3": (3, 16), "scalar": ()}
    rules = (dict(pattern=r"bank", axes=(JR.MODEL,), leading_eq=2),
             dict(pattern=r".*", axes=(JR.DATA,), min_size=100),
             dict(pattern=r".*", axes=()))
    jt = JR.validate_table(JR.RuleTable("t", tuple(JR.Rule(**r) for r in rules)))
    tt = TR.validate_table(TR.RuleTable("t", tuple(TR.Rule(**r) for r in rules)))
    sizes = {"data": 4, "model": 2}
    for path, shape in shapes.items():
        leaf = np.zeros(shape, np.float32) if shape else np.float32(1.0)
        _, jaxes = JR.match_rule(jt, path, leaf, "params", sizes)
        _, taxes = TR.match_rule(tt, path, shape, "params", sizes)
        assert taxes == jaxes, path


def pytest_unknown_parallel_key_raises():
    """A key of the Parallel section the port does not read raises; it is
    not ignored."""
    with pytest.raises(TR.RuleError, match="not read by the port"):
        TR.resolve({"Parallel": {"rules": "zero1", "offload": True}})


# ---------------------------------------------------------------------------
# the leaves each table shards, on the same models
# ---------------------------------------------------------------------------

MODELS = {"EGNN": {}, "GIN": {}, "EGNN-conv-heads": {"node": {
    "type": "conv", "num_headlayers": 1, "dim_headlayers": [8]}}}


def _pair(name):
    cfg = W.raw_config(name.split("-")[0])
    cfg["NeuralNetwork"]["Architecture"]["output_heads"].update(MODELS[name])
    splits = split_dataset(W.graphs(16), 0.75, seed=0)
    jc = j_update(copy.deepcopy(cfg), *splits)
    tc = t_update(copy.deepcopy(cfg), *splits)
    first = splits[0][:2]
    n = sum(g.num_nodes for g in first) + 8
    e = sum(g.num_edges for g in first)
    jm = j_create(jc)
    b = j_batch(first, JSpec(n, e, 3), sort_edges=True)
    v = jax.jit(lambda r, bb: jm.init(r, bb, train=False))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, b)
    return v, t_create(tc, device="cpu")


@pytest.mark.parametrize("model", list(MODELS))
def pytest_sharded_leaves_match_jax_spec_tree(model):
    """Over a data axis of 2 and a model axis of 2: the port's flax leaves
    (paths and shapes, a conv head's per-branch modules merged into their
    ``[B, ...]`` leaf) are the JAX variables' leaves, and for every preset
    and scope each leaf gets the JAX package's spec."""
    v, tm = _pair(model)
    amap = {JR.DATA: "data", JR.MODEL: "model"}
    sizes = {JR.DATA: 2, JR.MODEL: 2}
    for coll in ("params", "batch_stats"):
        flat = jax.tree_util.tree_flatten_with_path(v[coll])[0]
        jshapes = {JR.path_str(p): tuple(np.shape(x)) for p, x in flat}
        leaves = flax_leaves(tm, coll)
        assert {l.path: l.shape for l in leaves} == jshapes
        for name in TR.PRESET_NAMES:
            jt = JR.preset(name, min_size=64, num_branches=2)
            tt = TR.preset(name, min_size=64, num_branches=2)
            scopes = ("params", "opt_state", "grads") if coll == "params" else ("batch_stats",)
            for scope in scopes:
                specs, _ = JR.spec_tree(v[coll], jt, scope, amap, sizes)
                want = {JR.path_str(p): tuple(s) for p, s in
                        jax.tree_util.tree_flatten_with_path(
                            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
                got = {l.path: tuple(TR.match_rule(tt, l.path, l.shape, scope, sizes)[1])
                       for l in leaves}
                assert got == want, (name, scope)
                if name == "zero3" and scope == "params":
                    assert any(want.values())


UNPLACEABLE = {
    "batch_stats_over_data": ({"rules": [{"pattern": ".*", "spec": ["data"],
                                          "scope": ["batch_stats"]}]}, "batch statistics"),
    "second_axis": ({"rules": [{"pattern": ".*", "spec": [None, "data"],
                                "scope": ["opt_state"]}]}, "leading axes"),
    "routed_with_data": ({"rules": [{"pattern": "heads_NN", "spec": ["model"], "leading_eq": 2},
                                    {"pattern": ".*", "spec": ["data"], "scope": ["opt_state"]}],
                          "model_size": 2, "routed": True}, "data-axis"),
    "model_axis_unrouted": ({"rules": [{"pattern": "heads_NN", "spec": ["model"]}],
                             "model_size": 2}, "model axis"),
}


@pytest.mark.parametrize("case", list(UNPLACEABLE))
def pytest_a_rule_the_port_cannot_place_raises_naming_it(case):
    """A rule that is neither a leading-axis data shard of params,
    opt_state or grads nor a routed decoder bank over ``model`` raises
    ``NotImplementedError`` with the rule in the message."""
    from hydragnn_tpu_torch.parallel.engine import _check_table

    section, words = UNPLACEABLE[case]
    table = TR.resolve({"Parallel": section})
    with pytest.raises(NotImplementedError, match=words) as err:
        _check_table(table)
    assert str(table.rules[-1].to_config()["pattern"]) in str(err.value) or "rule[" in str(
        err.value)
