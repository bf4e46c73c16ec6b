"""Declarative placement: ordered regex -> sharding rule tables.

Counterpart of ``hydragnn_tpu/parallel/rules.py``, pure Python. A rule
table names the placement of every state leaf: ordered regexes matched
against the leaf's '/'-joined flax path (``bridge.flax_leaves`` gives the
port's tensors those paths), first match wins, with the predicates the
ZeRO and branch placements need:

- ``min_size``: ZeRO thresholds (a rule passes over smaller leaves);
- leading-axis divisibility: a rule that shards the leading axis over a
  group passes over leaves whose leading extent it does not divide;
- ``leading_eq``: decoder banks match only at their ``[num_branches]``
  leading extent;
- ``scope``: the state it covers (``params`` / ``opt_state`` /
  ``batch_stats`` between steps, ``grads`` inside the step).

Axes are logical: ``data`` (the ranks of one data group) and ``model``
(the branch groups of the routed presets). The presets ``dp``, ``zero1``,
``zero2``, ``zero3``, ``branch`` and ``mp`` are built here; ``resolve``
reads ``Parallel.rules`` or the legacy ``Training`` keys. Predicates take a
leaf's shape in the flax layout (``Rule.admits``), so a table admits the
same leaves in both packages.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

DATA = "data"
MODEL = "model"
_AXIS_TOKENS = (DATA, MODEL)

SCOPES = ("params", "opt_state", "batch_stats", "grads")
PLACED_SCOPES = ("params", "opt_state", "batch_stats")

# the decoder banks' top-level module names (models/base.py: graph_shared,
# heads_NN; MACE's per-layer readouts)
DECODER_PATTERN = r"(^|/)(graph_shared|heads_NN|readout)"

DEFAULT_MIN_SIZE = 1024

# the keys of the Parallel section (anything else raises)
SECTION_KEYS = ("rules", "min_size", "model_size", "routed", "name", "resolved_rules")


@dataclasses.dataclass(frozen=True)
class Rule:
    """One ordered entry: regex over the '/'-joined path -> logical axes,
    gated by size and shape predicates. ``axes=()`` is an explicit
    replicated placement."""

    pattern: str
    axes: Tuple[Optional[str], ...] = ()
    scope: Tuple[str, ...] = ("params",)
    min_size: int = 0
    leading_eq: Optional[int] = None
    reason: str = ""

    def compiled(self) -> "re.Pattern[str]":
        return re.compile(self.pattern)

    def admits(self, shape: Sequence[int], axis_sizes: Dict[str, int]) -> bool:
        """Shape predicate (the regex already matched) on a leaf of
        ``shape``: scalars never shard, ``min_size`` passes over small
        leaves, and a rule sharding the leading axis needs it divisible
        (or of exactly ``leading_eq``)."""
        shape = tuple(int(s) for s in shape)
        ndim = len(shape)
        size = 1
        for s in shape:
            size *= s
        if self.axes and not ndim:
            return False
        if self.min_size and size < self.min_size:
            return False
        if self.leading_eq is not None and (not ndim or shape[0] != self.leading_eq):
            return False
        if self.axes and self.axes[0] is not None:
            n = axis_sizes.get(self.axes[0], 1)
            if not ndim or shape[0] % max(n, 1) != 0:
                return False
        return True

    def to_config(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"pattern": self.pattern, "spec": list(self.axes),
                               "scope": list(self.scope)}
        if self.min_size:
            out["min_size"] = int(self.min_size)
        if self.leading_eq is not None:
            out["leading_eq"] = int(self.leading_eq)
        if self.reason:
            out["reason"] = self.reason
        return out


@dataclasses.dataclass(frozen=True)
class RuleTable:
    """An ordered rule list plus the semantics it requires: ``model_size``
    the model-axis extent (1: pure data parallelism), ``routed`` the
    branch-routed step (decoder gradients reduced over the data group
    only)."""

    name: str
    rules: Tuple[Rule, ...] = ()
    model_size: int = 1
    routed: bool = False

    def rules_for(self, scope: str) -> Tuple[Rule, ...]:
        return tuple(r for r in self.rules if scope in r.scope)

    def shards(self, scope: str) -> bool:
        """Whether any rule can place a non-replicated spec in ``scope``."""
        return any(r.axes for r in self.rules_for(scope))

    def to_config(self) -> Dict[str, Any]:
        """JSON form, recorded as ``Parallel.resolved_rules``."""
        return {"name": self.name, "model_size": int(self.model_size),
                "routed": bool(self.routed), "rules": [r.to_config() for r in self.rules]}


class RuleError(ValueError):
    """An invalid rule table, raised when the table is resolved."""


def match_rule(table: RuleTable, path: str, shape: Sequence[int], scope: str,
               axis_sizes: Dict[str, int]) -> Tuple[Optional[Rule], Tuple[Optional[str], ...]]:
    """First-match-wins lookup: ``(rule, logical axes)``. Scalars are
    replicated without consulting the table; ``(None, ())`` means no rule
    matched (the leaf is replicated)."""
    if not len(shape):
        return None, ()
    for rule in table.rules_for(scope):
        if rule.compiled().search(path) and rule.admits(shape, axis_sizes):
            return rule, rule.axes
    return None, ()


def validate_table(table: RuleTable) -> RuleTable:
    """Raise ``RuleError`` on the first structural problem: a bad regex,
    an unknown axis or scope, an impossible predicate."""
    if not isinstance(table.name, str) or not table.name:
        raise RuleError("rule table needs a non-empty name")
    if int(table.model_size) < 1:
        raise RuleError(f"rule table {table.name!r}: model_size {table.model_size} < 1")
    for i, rule in enumerate(table.rules):
        where = f"rule table {table.name!r} rule[{i}] ({rule.pattern!r})"
        try:
            re.compile(rule.pattern)
        except re.error as e:
            raise RuleError(f"{where}: bad regex: {e}") from None
        for a in rule.axes:
            if a is not None and a not in _AXIS_TOKENS:
                raise RuleError(f"{where}: unknown axis {a!r} (use "
                                f"{'/'.join(_AXIS_TOKENS)} or null)")
        if not rule.scope:
            raise RuleError(f"{where}: empty scope")
        for s in rule.scope:
            if s not in SCOPES:
                raise RuleError(f"{where}: unknown scope {s!r} (use {'/'.join(SCOPES)})")
        if rule.min_size < 0:
            raise RuleError(f"{where}: min_size {rule.min_size} < 0")
        if rule.leading_eq is not None and rule.leading_eq < 1:
            raise RuleError(f"{where}: leading_eq {rule.leading_eq} < 1")
        if "grads" in rule.scope and any(a == MODEL for a in rule.axes):
            raise RuleError(f"{where}: 'grads' scope cannot shard over the model axis "
                            "(the grads scope is the ZeRO-2 data-axis site)")
    if table.routed and table.model_size < 2:
        raise RuleError(f"rule table {table.name!r}: routed (branch/mp) tables need "
                        f"model_size >= 2 (have {table.model_size})")
    if table.routed and not any(any(a == MODEL for a in r.axes) for r in table.rules):
        raise RuleError(f"rule table {table.name!r}: routed tables must shard at least one "
                        "rule over the model axis (the decoder banks)")
    return table


def _replicated_default() -> Rule:
    return Rule(pattern=r".*", axes=(), scope=PLACED_SCOPES,
                reason="explicit replicated default")


def _zero_rules(stage: int, min_size: int) -> Tuple[Rule, ...]:
    out: List[Rule] = [Rule(pattern=r".*", axes=(DATA,), scope=("opt_state",),
                            min_size=min_size,
                            reason="ZeRO-1: optimizer moments sharded over data")]
    if stage >= 2:
        out.append(Rule(pattern=r".*", axes=(DATA,), scope=("grads",), min_size=min_size,
                        reason="ZeRO-2: gradient reduce-scatter over data"))
    if stage >= 3:
        out.append(Rule(pattern=r".*", axes=(DATA,), scope=("params",), min_size=min_size,
                        reason="ZeRO-3: params stored sharded between steps"))
    out.append(_replicated_default())
    return tuple(out)


def _branch_rules(num_branches: int) -> Tuple[Rule, ...]:
    return (
        Rule(pattern=DECODER_PATTERN, axes=(MODEL,), scope=PLACED_SCOPES,
             leading_eq=num_branches,
             reason=("decoder banks [num_branches, ...] sharded over the model "
                     "axis (MultiTaskModelMP task parallelism)")),
        _replicated_default(),
    )


PRESET_NAMES = ("dp", "zero1", "zero2", "zero3", "branch", "mp")


def preset(name: str, min_size: int = DEFAULT_MIN_SIZE,
           num_branches: Optional[int] = None) -> RuleTable:
    """A shipped preset table. ``branch`` and ``mp`` are the same placement
    (``mp`` the reference-facing name); both need ``num_branches``."""
    if name == "dp":
        return validate_table(RuleTable("dp", (_replicated_default(),)))
    if name in ("zero1", "zero2", "zero3"):
        return validate_table(RuleTable(name, _zero_rules(int(name[-1]), int(min_size))))
    if name in ("branch", "mp"):
        if not num_branches or num_branches < 2:
            raise RuleError(f"preset {name!r} needs num_branches >= 2 (have {num_branches}) "
                            "— a single-branch model has no decoder bank to shard")
        return validate_table(RuleTable(name, _branch_rules(int(num_branches)),
                                        model_size=int(num_branches), routed=True))
    raise RuleError(f"unknown Parallel.rules preset {name!r}; shipped presets: "
                    f"{', '.join(PRESET_NAMES)} (or an inline rule list)")


def table_from_config(spec: Any, section: Dict[str, Any]) -> RuleTable:
    """Inline table: ``Parallel.rules`` as a list of rule dicts
    (``{pattern, spec, scope, min_size, leading_eq, reason}``), with
    ``Parallel.model_size`` / ``Parallel.routed`` alongside."""
    if not isinstance(spec, (list, tuple)):
        raise RuleError(f"Parallel.rules must be a preset name or a rule list, got "
                        f"{type(spec).__name__}")
    rules: List[Rule] = []
    for i, entry in enumerate(spec):
        if not isinstance(entry, dict):
            raise RuleError(f"Parallel.rules[{i}] must be an object, got "
                            f"{type(entry).__name__}")
        unknown = set(entry) - {"pattern", "spec", "scope", "min_size", "leading_eq", "reason"}
        if unknown:
            raise RuleError(f"Parallel.rules[{i}]: unknown keys {sorted(unknown)}")
        if "pattern" not in entry:
            raise RuleError(f"Parallel.rules[{i}]: missing 'pattern'")
        axes = entry.get("spec", [])
        if isinstance(axes, str):
            axes = [axes]
        scope = entry.get("scope", ["params"])
        if isinstance(scope, str):
            scope = [scope]
        rules.append(Rule(
            pattern=str(entry["pattern"]),
            axes=tuple(a if a is not None else None for a in axes),
            scope=tuple(str(s) for s in scope),
            min_size=int(entry.get("min_size", 0)),
            leading_eq=(int(entry["leading_eq"]) if entry.get("leading_eq") is not None
                        else None),
            reason=str(entry.get("reason", "")),
        ))
    return validate_table(RuleTable(
        name=str(section.get("name", "inline")), rules=tuple(rules),
        model_size=int(section.get("model_size", 1)),
        routed=bool(section.get("routed", False)),
    ))


def resolve(config: Dict[str, Any]) -> RuleTable:
    """The one resolution path: an explicit ``Parallel.rules`` (a preset
    name or an inline list) wins; otherwise the table comes from the
    legacy ``Training`` keys (``Optimizer.zero_stage`` /
    ``use_zero_redundancy`` / ``branch_parallel``). Conflicts between an
    explicit table and contradicting legacy keys raise, and so does a key
    of the ``Parallel`` section the port does not read."""
    training = config.get("NeuralNetwork", {}).get("Training", {})
    section = config.get("Parallel") or {}
    unknown = sorted(set(section) - set(SECTION_KEYS))
    if unknown:
        raise RuleError(f"Parallel section keys {unknown} are not read by the port (it reads "
                        f"{', '.join(SECTION_KEYS)}); remove them")
    min_size = int(section.get("min_size", DEFAULT_MIN_SIZE))
    num_branches = num_branches_of(config)
    opt = training.get("Optimizer", {})
    zero_stage = int(opt.get("zero_stage", 1 if opt.get("use_zero_redundancy") else 0))
    branch_parallel = bool(training.get("branch_parallel", False))
    spec = section.get("rules")
    if spec is None:
        if branch_parallel and zero_stage >= 2:
            raise RuleError(
                "Optimizer.zero_stage >= 2 is not supported together with "
                "Training.branch_parallel (the branch table shards decoder "
                "banks, not gradients/moments); drop one of the two, or "
                "write an explicit Parallel.rules table")
        if branch_parallel:
            return preset("branch", num_branches=num_branches)
        if zero_stage >= 1:
            return preset(f"zero{min(zero_stage, 3)}", min_size=min_size)
        return preset("dp")
    if isinstance(spec, str):
        table = preset(spec, min_size=min_size, num_branches=num_branches)
    else:
        table = table_from_config(spec, section)
    if branch_parallel and not table.routed:
        raise RuleError(f"Parallel.rules={table.name!r} is not a routed (branch/mp) table "
                        "but Training.branch_parallel is set; drop branch_parallel or pick "
                        "the 'branch'/'mp' preset")
    if zero_stage >= 2 and not table.shards("grads"):
        raise RuleError(f"Parallel.rules={table.name!r} has no 'grads'-scope rule but "
                        f"Optimizer.zero_stage={zero_stage} asks for gradient sharding; "
                        "align the two (the zero2/zero3 presets carry it)")
    return table


def table_from_recorded(recorded: Dict[str, Any]) -> RuleTable:
    """Rebuild a table from a recorded ``Parallel.resolved_rules`` block."""
    return table_from_config(recorded.get("rules", []), {
        "name": recorded.get("name", "recorded"),
        "model_size": recorded.get("model_size", 1),
        "routed": recorded.get("routed", False),
    })


def num_branches_of(config: Dict[str, Any]) -> int:
    """The branch count as the model factory derives it: the length of
    list-form graph heads, else 1."""
    heads = config.get("NeuralNetwork", {}).get("Architecture", {}).get("output_heads") or {}
    graph = heads.get("graph")
    return len(graph) if isinstance(graph, list) else 1
