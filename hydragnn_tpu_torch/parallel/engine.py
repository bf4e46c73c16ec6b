"""The one distributed train and eval step, placed by a rule table.

Counterpart of ``hydragnn_tpu/parallel/engine.py``. A rule table
(``parallel/rules.py``) places every leaf of the state on the ranks of a
``mesh.Grid`` (``place_state``), and ``make_mesh_train_step`` /
``make_mesh_eval_step`` build the steps every caller uses: dp, ZeRO-1/2/3
and the branch-parallel decoders are presets of one table, not code paths.

Unrouted tables (dp, zero1/2/3): each rank computes its loss on its own
batch; its gradients are scaled by ``n / n_tot`` (``n`` its real graphs,
``n_tot`` the world's) and summed over the ranks, which is the reference's
``n · world / n_tot`` then mean. The loss, the task losses and the
batch-norm running statistics take the same weights: ranks holding
different counts (a remainder, an empty shard) neither dilute the
gradients nor overwrite the statistics. ZeRO follows the table's scopes
leaf by leaf, over the leaves a rule admits (the rest stay replicated):

- ``opt_state`` (stage 1): the optimizer runs over this rank's 1/world of
  the leaf's elements (a contiguous slice, or whole branches of a bank
  module), so its moments are that slice; the updated slices are gathered
  back into the full parameter after each step;
- ``grads`` (stage 2): the leaf's gradient is reduce-scattered, each rank
  receiving only its slice's sum;
- ``params`` (stage 3): the parameter itself is stored as the slice
  between steps and gathered at use, before the forward.

The mechanism is the port's own slicing over the flax leaves of
``bridge.flax_leaves``, so the leaves sharded are the ones the JAX
package's ``spec_tree`` shards, every one of the nine optimizers keeps its
numbers (they update element by element; LAMB's trust ratio sums its
norms over the slices), and a rank holds 1/world of each admitted leaf.

Routed tables (branch / mp): each rank builds the model with its model
index's ``num_branches / model_size`` branches (the decoder banks the
table shards over ``model``), branch loss weights stripped from its
config. Encoder gradients are averaged over every rank with the weights
above; a decoder bank's gradients over the ranks of its data group only,
branch by branch (``n / n_branch``, times the branch's loss weight).
Batches come from ``routing.BranchRoutedLoader``; a rank whose branch is
exhausted steps on a batch with no real graph, at zero weight.

The non-finite guard decides on the reduced loss and gradients, so every
rank skips, or keeps, the same steps. ``TrainState.to_payload`` of a
placed state gathers every leaf to its full tensor (every rank calls it;
rank 0 writes), so a checkpoint has the single-process payload format and
resumes under any world size and preset.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..bridge import FlaxLeaf, flax_leaves
from ..data.graph import GraphBatch
from ..device import module_device
from ..train.guard import StepCopies, guarded_update
from ..train.loop import _apply_fn, cast_batch_bf16, guard_enabled, train_loss
from ..train.loss import compute_loss
from ..train.optimizer import OptaxRule, _init_state, state_tensors
from . import rules as R
from .mesh import Grid


@dataclasses.dataclass
class Objective:
    """What a step optimizes, independent of placement."""

    compute_grad_energy: bool = False
    mixed_precision: bool = False
    guard: Optional[bool] = None


def _check_table(table: R.RuleTable, grid: Optional[Grid] = None) -> None:
    """Refuse what the port cannot place, naming the rule: a data-axis
    rule must shard the leading axis of ``params``, ``opt_state`` or
    ``grads`` in an unrouted table, and a model-axis rule must shard a
    decoder bank's leading axis in a routed one."""
    R.validate_table(table)
    for i, rule in enumerate(table.rules):
        if not rule.axes:
            continue
        where = f"Parallel rule[{i}] {rule.to_config()} of table {table.name!r}"
        if any(a is not None for a in rule.axes[1:]) or rule.axes[0] is None:
            raise NotImplementedError(f"{where}: the port shards leading axes only")
        axis = rule.axes[0]
        if axis == R.DATA:
            if table.routed:
                raise NotImplementedError(f"{where}: a routed table with data-axis sharding "
                                          "is not placed by the port")
            if "batch_stats" in rule.scope:
                raise NotImplementedError(f"{where}: batch statistics are not sharded by "
                                          "the port")
        elif axis == R.MODEL and not table.routed and table.model_size > 1:
            raise NotImplementedError(f"{where}: a model axis outside a routed table")
    if table.routed and grid is not None and grid.model_size != table.model_size:
        raise ValueError(f"table {table.name!r} needs a model axis of {table.model_size}, "
                         f"the grid has {grid.model_size}")


def _axis_of(table, leaf: FlaxLeaf, scope: str, sizes) -> Optional[str]:
    _, axes = R.match_rule(table, leaf.path, leaf.shape, scope, sizes)
    return axes[0] if axes else None


# ---------------------------------------------------------------------------
# collectives (every call names its group; None is the default group)
# ---------------------------------------------------------------------------


def _all_reduce_flat(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum ``tensors`` over ``group`` in one flat bucket, in place."""
    tensors = [t for t in tensors if t.numel()]
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def _reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group=None) -> None:
    """``out`` = this rank's chunk of ``inp`` summed over ``group``
    (``reduce_scatter_single`` where this PyTorch has it)."""
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, inp, group=group)


def _all_gather_into(out: torch.Tensor, chunk: torch.Tensor, group=None) -> None:
    dist.all_gather(list(out.chunk(dist.get_world_size(group))), chunk.contiguous(),
                    group=group)


# ---------------------------------------------------------------------------
# the placed leaves
# ---------------------------------------------------------------------------


class ShardLeaf:
    """One leaf sharded over the data group: ``n`` elements (its torch
    tensors concatenated), of which this rank owns ``[r c, (r + 1) c)``.
    ``pieces`` are what the optimizer updates: the slice itself, or the
    whole branches of a bank module that fall in it. ``grads_sharded`` and
    ``store_sharded`` say whether the gradient is reduce-scattered (stage
    2) and whether the parameter is stored as the slice (stage 3). Below
    stage 3 ``buffer`` holds the whole leaf (a bank module's branches
    become views of it, so its elements are contiguous) and ``local`` is a
    view of this rank's slice of it."""

    def __init__(self, leaf: FlaxLeaf, params: List[torch.nn.Parameter], world: int, rank: int,
                 grads: bool, store_sharded: bool):
        self.leaf, self.params = leaf, params
        self.world, self.rank = world, rank
        self.shape = tuple(params[0].shape)
        self.each = params[0].numel()
        self.n = self.each * len(params)
        self.c = self.n // world
        self.grads_sharded = grads
        self.store_sharded = store_sharded
        self.bank = len(params) > 1
        with torch.no_grad():
            buffer = (torch.stack([p.data for p in params]).view(-1) if self.bank
                      else params[0].data.view(-1))
        self._bind(buffer)
        chunk = buffer[rank * self.c:(rank + 1) * self.c]
        self.buffer = None if store_sharded else buffer
        self.local = chunk.clone() if store_sharded else chunk
        if store_sharded:
            self.release()
        if self.bank:
            per = len(params) // world
            self.pieces = [self.local[j * self.each:(j + 1) * self.each].view(self.shape)
                           for j in range(per)]
        else:
            self.pieces = [self.local]
        # a piece that is part of one tensor: LAMB sums its norms over ranks
        self.partial = not self.bank and world > 1
        self.chunk_grad: Optional[torch.Tensor] = None

    def _bind(self, buffer: torch.Tensor) -> None:
        """Point the torch parameters into ``buffer``."""
        if self.bank:
            full = buffer.view((len(self.params),) + self.shape)
            for b, p in enumerate(self.params):
                p.data = full[b]
        else:
            self.params[0].data = buffer.view(self.shape)

    def gather(self, group) -> None:
        """Stage 3: the whole parameter from every rank's slice."""
        full = torch.empty(self.n, dtype=self.local.dtype, device=self.local.device)
        _all_gather_into(full, self.local, group)
        self._bind(full)

    def gather_updated(self, group) -> None:
        """Stages 1-2: every rank's updated slice back into the buffer."""
        _all_gather_into(self.buffer, self.local.clone(), group)

    def release(self) -> None:
        empty = torch.empty(0, dtype=self.local.dtype, device=self.local.device)
        for p in self.params:
            p.data = empty
            p.grad = None

    def grad_stream(self) -> torch.Tensor:
        """The leaf's gradient as one flat tensor (a view where it can be)."""
        if self.bank:
            return torch.cat([p.grad.reshape(-1) for p in self.params])
        return self.params[0].grad.view(-1)

    def param_grads(self, stream: torch.Tensor) -> List[torch.Tensor]:
        """Views of ``stream`` (the whole leaf) per torch parameter."""
        return list(stream.view((len(self.params),) + self.shape))


class Placement:
    """Where every tensor of a ``TrainState`` lives under ``table`` on
    ``grid``, and how the whole model's state (the single-process
    checkpoint payload) is gathered from it and scattered back.
    ``local_to_global`` maps this rank's tensor names to the whole model's;
    ``decoder`` holds the routed decoder tensors: local name -> (the whole
    model's names per model index for a bank module's branch, else the one
    name; the torch axis of the branches, None for a bank module's branch;
    the offset of this rank's first branch)."""

    def __init__(self, table: R.RuleTable, grid: Grid, model: torch.nn.Module,
                 opt_names: List[str]):
        self.table, self.grid, self.routed = table, grid, table.routed
        self.group = grid.group
        self.global_sd = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
        self.global_opt_names = list(opt_names)
        self.branch_weights = getattr(model.cfg, "branch_loss_weights", None)
        self.b_local = (model.cfg.num_branches // grid.model_size) if self.routed else 1
        self.shards: List[ShardLeaf] = []
        self.replicated: List[torch.nn.Parameter] = []
        self.local_to_global: Dict[str, str] = {}
        self.decoder: Dict[str, Tuple[Tuple[str, ...], Optional[int], int]] = {}
        self.stat_buffers: List[Tuple[str, torch.Tensor]] = []

    # -- step-time movements -------------------------------------------------

    def gather_params(self) -> None:
        for s in self.shards:
            if s.store_sharded:
                s.gather(self.group)

    def release_params(self) -> None:
        for s in self.shards:
            if s.store_sharded:
                s.release()

    # -- the whole model's state ---------------------------------------------

    def _local_from(self, lname: str, get):
        """This rank's value of local tensor ``lname`` from the whole
        model's (``get(global name)``)."""
        dec = self.decoder.get(lname)
        if dec is None:
            return get(self.local_to_global.get(lname, lname))
        gnames, axis, off = dec
        if axis is None:
            return get(gnames[self.grid.model_index])
        v = get(gnames[0])
        return v.narrow(axis, off, self.b_local) if torch.is_tensor(v) and v.dim() else v

    def _stream(self, s: ShardLeaf, chunk: torch.Tensor) -> torch.Tensor:
        full = torch.empty(s.n, dtype=chunk.dtype, device=chunk.device)
        _all_gather_into(full, chunk, self.group)
        return full

    def _whole(self, named: Dict[str, Any]) -> Dict[str, Any]:
        """Local name -> value becomes global name -> value: a routed
        decoder tensor gathered from the first rank of every model index."""
        out: Dict[str, Any] = {}
        for lname, v in named.items():
            dec = self.decoder.get(lname) if self.routed else None
            if dec is None:
                out[self.local_to_global.get(lname, lname)] = v
                continue
            gnames, axis, _ = dec
            if torch.is_tensor(v) and v.dim():
                parts = [torch.empty_like(v) for _ in range(self.grid.world)]
                dist.all_gather(parts, v.contiguous(), group=self.group)
                parts = parts[::self.grid.data_size]
            else:
                parts = [v] * self.grid.model_size
            if axis is None:
                out.update(zip(gnames, parts))
            else:
                out[gnames[0]] = torch.cat(parts, dim=axis) if torch.is_tensor(v) and v.dim() \
                    else v
        return out

    def whole_state(self, state) -> Tuple[Dict[str, torch.Tensor], Dict[str, Dict[str, Any]]]:
        """(state dict, optimizer state by parameter name) of the whole
        model, by its names: a collective every rank calls."""
        model, opt = state.model, state.optimizer
        sd: Dict[str, Any] = dict(model.state_dict())
        moments: Dict[str, Dict[str, Any]] = {}
        for s in self.shards:
            full = self._stream(s, s.local) if s.store_sharded else s.buffer
            for b, n in enumerate(s.leaf.names):
                sd[n] = full[b * s.each:(b + 1) * s.each].view(s.shape)
            for k, v0 in opt.state[s.pieces[0]].items():
                if torch.is_tensor(v0) and v0.dim():
                    full = self._stream(s, torch.cat([opt.state[p][k].reshape(-1)
                                                      for p in s.pieces]))
                    for b, n in enumerate(s.leaf.names):
                        moments.setdefault(n, {})[k] = full[b * s.each:(b + 1) * s.each].view(
                            s.shape)
                else:
                    for n in s.leaf.names:
                        moments.setdefault(n, {})[k] = v0
        name_of = {id(p): n for n, p in model.named_parameters()}
        for p in self.replicated:
            moments[name_of[id(p)]] = dict(opt.state[p])
        sd = self._whole(sd)
        if self.routed:
            keys = sorted({k for mm in moments.values() for k in mm})
            per_key = {k: self._whole({n: mm[k] for n, mm in moments.items() if k in mm})
                       for k in keys}
            moments = {}
            for k, vals in per_key.items():
                for g, v in vals.items():
                    moments.setdefault(g, {})[k] = v
        return {k: sd[k] for k, _ in self.global_sd}, moments

    def to_payload(self, state) -> Dict[str, Any]:
        """The single-process checkpoint payload of the whole model."""
        from ..train.state import PAYLOAD_FORMAT, _to_cpu

        sd, moments = self.whole_state(state)
        hyper = {k: v for k, v in state.optimizer.param_groups[0].items() if k != "params"}
        names = self.global_opt_names
        opt_sd = {"state": {i: moments[n] for i, n in enumerate(names) if n in moments},
                  "param_groups": [dict(hyper, params=list(range(len(names))))]}
        return {"format": PAYLOAD_FORMAT, "model": _to_cpu(sd), "optimizer": _to_cpu(opt_sd),
                "step": int(state.step), "skipped_steps": int(state.skipped_steps),
                "consecutive_skips": int(state.consecutive_skips), "lr": state.learning_rate}

    @torch.no_grad()
    def load_payload(self, state, payload: Dict[str, Any]) -> None:
        """Place a single-process payload: every rank takes its part."""
        from ..train.state import PAYLOAD_FORMAT

        if not isinstance(payload, dict) or payload.get("format") != PAYLOAD_FORMAT:
            raise ValueError(f"not a {PAYLOAD_FORMAT} checkpoint payload")
        have = dict(self.global_sd)
        want = {k: tuple(v.shape) for k, v in payload["model"].items()}
        if have != want:
            diff = sorted(k for k in set(have) | set(want) if have.get(k) != want.get(k))
            raise ValueError(f"the checkpoint's model differs from this one in {diff[:8]}")
        saved = payload["optimizer"]
        if len(saved["param_groups"][0]["params"]) != len(self.global_opt_names):
            raise ValueError("the checkpoint's optimizer has another parameter layout")
        moments = {self.global_opt_names[int(i)]: st for i, st in saved["state"].items()}
        model, opt = state.model, state.optimizer
        full = payload["model"]
        in_shard = {n for s in self.shards for n in s.leaf.names}
        for lname, t in model.state_dict(keep_vars=True).items():
            if lname not in in_shard:
                t.data.copy_(self._local_from(lname, full.__getitem__))
        for s in self.shards:
            if s.store_sharded:
                stream = torch.cat([full[n].reshape(-1) for n in s.leaf.names])
                s.local.copy_(stream[s.rank * s.c:(s.rank + 1) * s.c])
            else:
                for p, n in zip(s.params, s.leaf.names):
                    p.data.copy_(full[n])
            for k, v0 in opt.state[s.pieces[0]].items():
                if torch.is_tensor(v0) and v0.dim():
                    stream = torch.cat([moments[n][k].reshape(-1) for n in s.leaf.names])
                    chunk = stream[s.rank * s.c:(s.rank + 1) * s.c]
                    off = 0
                    for p in s.pieces:
                        opt.state[p][k].copy_(chunk[off:off + p.numel()].view_as(p))
                        off += p.numel()
                else:
                    for p in s.pieces:
                        _set_state(opt.state[p], k, moments[s.leaf.names[0]][k])
        name_of = {id(p): n for n, p in model.named_parameters()}
        for p in self.replicated:
            lname = name_of[id(p)]
            for k in list(opt.state[p]):
                _set_state(opt.state[p], k, self._local_from(lname, lambda g: moments[g][k]))
        for t, k in zip((state.step, state.skipped_steps, state.consecutive_skips),
                        ("step", "skipped_steps", "consecutive_skips")):
            t.fill_(int(payload[k]))
        state.with_learning_rate(payload["lr"])


def _set_state(st: Dict[str, Any], k: str, v) -> None:
    if torch.is_tensor(st[k]):
        st[k].copy_(v)
    else:
        st[k] = v


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def _rebuild_optimizer(opt: torch.optim.Optimizer, params: List[torch.Tensor]):
    """An optimizer of ``opt``'s kind and hyperparameters over ``params``,
    its state made as ``make_optimizer`` makes it (the caller fills it)."""
    group = opt.param_groups[0]
    if isinstance(opt, OptaxRule):
        new = OptaxRule(params, opt.kind, lr=group["lr"])
    else:
        takes = inspect.signature(type(opt).__init__).parameters
        new = type(opt)(params, **{k: v for k, v in group.items()
                                   if k != "params" and k in takes})
        _init_state(new)
    new.clip_grad_norm = opt.clip_grad_norm
    return new


def place_state(state, table: R.RuleTable, grid: Grid):
    """Place a single-process ``TrainState`` (the whole model and its
    optimizer, perhaps restored from a checkpoint) by ``table`` on
    ``grid``; returns the placed state, whose ``placement`` says where
    everything went. Every rank calls it on the same state. The optimizer's
    moments are placed, not made anew. A routed table builds this rank's
    model (its branches of every decoder bank) from the whole one, which
    the caller drops."""
    from ..train.state import TrainState

    _check_table(table, grid)
    model, opt = state.model, state.optimizer
    if len(opt.param_groups) != 1:
        raise NotImplementedError("the placed optimizer takes one parameter group")
    if table.routed:
        nb = model.cfg.num_branches
        if nb < 2 or grid.world < 2:
            raise ValueError(
                "Training.branch_parallel requires a multibranch model "
                f"(num_branches={nb}) and >=2 ranks (have {grid.world})")
        if nb % grid.model_size:
            raise ValueError(f"num_branches {nb} not divisible by the model axis "
                             f"{grid.model_size}")
    name_of = {id(p): n for n, p in model.named_parameters()}
    opt_names = [name_of[id(p)] for p in opt.param_groups[0]["params"]]
    in_opt = set(opt_names)
    pl = Placement(table, grid, model, opt_names)
    if table.routed:
        local, local_state = _place_routed(pl, model, opt, in_opt)
        params = [p for n, p in local.named_parameters() if pl.local_to_global[n] in in_opt]
        new_opt = _rebuild_optimizer(opt, params)
        lname = {id(p): n for n, p in local.named_parameters()}
        for p in params:
            for k, v in local_state[lname[id(p)]].items():
                _set_state(new_opt.state[p], k, v)
        pl.replicated = params
        model = local
    else:
        new_opt = _place_zero(pl, model, opt, in_opt, opt_names)
    new_opt.norm_group = {id(s.pieces[0]): pl.group for s in pl.shards if s.partial}
    persistent = set(model.state_dict())
    pl.stat_buffers = [(n, b) for n, b in model.named_buffers()
                       if n in persistent and b.is_floating_point()]
    dev = module_device(model) or torch.device("cpu")
    counters = [t.detach().clone().to(dev)
                for t in (state.step, state.skipped_steps, state.consecutive_skips)]
    held = _held(model, new_opt, pl)
    return TrainState(model, new_opt, *counters, held,
                      StepCopies(held) if state.guard is not None else None, placement=pl)


def _place_zero(pl: Placement, model, opt, in_opt, opt_names):
    """Unrouted: the leaves the table shards over ``data`` become
    ``ShardLeaf``s; the optimizer runs over their pieces and the other
    parameters, its moments sliced from ``opt``'s."""
    grid, table = pl.grid, pl.table
    by_name = dict(model.named_parameters())
    shard_of: Dict[str, ShardLeaf] = {}
    for leaf in flax_leaves(model, "params"):
        if not all(n in in_opt for n in leaf.names):
            continue  # a frozen leaf stays replicated
        on = {s: _axis_of(table, leaf, s, grid.axis_sizes) == R.DATA
              for s in ("opt_state", "grads", "params")}
        if not any(on.values()):
            continue
        if not on["opt_state"]:
            raise NotImplementedError(
                f"leaf {leaf.path!r}: table {table.name!r} shards its gradients or "
                "parameters but not its optimizer state; the port shards them together")
        s = ShardLeaf(leaf, [by_name[n] for n in leaf.names], grid.world, grid.rank,
                      grads=on["grads"], store_sharded=on["params"])
        pl.shards.append(s)
        shard_of.update((n, s) for n in leaf.names)
    params: List[torch.Tensor] = []
    seen = set()
    for n in opt_names:
        s = shard_of.get(n)
        if s is None:
            params.append(by_name[n])
            pl.replicated.append(by_name[n])
        elif id(s) not in seen:
            seen.add(id(s))
            params.extend(s.pieces)
    new_opt = _rebuild_optimizer(opt, params)
    for p in pl.replicated:
        for k, v in opt.state[p].items():
            _set_state(new_opt.state[p], k, v)
    with torch.no_grad():
        for s in pl.shards:
            for k, v0 in opt.state[s.params[0]].items():
                if torch.is_tensor(v0) and v0.dim():
                    stream = torch.cat([opt.state[p][k].reshape(-1) for p in s.params])
                    chunk = stream[s.rank * s.c:(s.rank + 1) * s.c]
                    off = 0
                    for piece in s.pieces:
                        new_opt.state[piece][k].copy_(chunk[off:off + piece.numel()]
                                                      .view_as(piece))
                        off += piece.numel()
                else:
                    for piece in s.pieces:
                        _set_state(new_opt.state[piece], k, v0)
    return new_opt


def _place_routed(pl: Placement, model, opt, in_opt):
    """Routed: this rank's model with ``num_branches / model_size``
    branches and no branch loss weights (they scale the decoder
    gradients instead), its encoder copied from ``model`` and each decoder
    leaf (a rule of the table shards it over ``model``) cut to this rank's
    branches. Returns the model and its parameters' optimizer state, cut
    the same way."""
    grid, table = pl.grid, pl.table
    cfg = model.cfg
    m, bl = grid.model_index, pl.b_local
    local = type(model)(dataclasses.replace(cfg, num_branches=bl, branch_loss_weights=None,
                                            branch_loss_metrics=False))
    local = local.to(module_device(model)).train(model.training)
    for coll in ("params", "batch_stats"):
        whole = {leaf.path: leaf for leaf in flax_leaves(model, coll)}
        for lleaf in flax_leaves(local, coll):
            gleaf = whole[lleaf.path]
            if _axis_of(table, gleaf, coll, grid.axis_sizes) != R.MODEL:
                if gleaf.shape != lleaf.shape:
                    raise ValueError(f"leaf {gleaf.path!r} {gleaf.shape} carries the branch "
                                     f"axis but no rule of table {table.name!r} places it "
                                     "over 'model'")
                pl.local_to_global.update(zip(lleaf.names, gleaf.names))
            elif len(gleaf.names) > 1:  # a bank module: whole branches
                for j, ln in enumerate(lleaf.names):
                    gnames = tuple(gleaf.names[k * bl + j] for k in range(grid.model_size))
                    pl.decoder[ln] = (gnames, None, m * bl + j)
                    pl.local_to_global[ln] = gnames[m]
            else:
                pl.decoder[lleaf.names[0]] = (gleaf.names, gleaf.lead_axis, m * bl)
                pl.local_to_global[lleaf.names[0]] = gleaf.names[0]
    whole_sd = model.state_dict()
    with torch.no_grad():
        for ln, t in local.state_dict(keep_vars=True).items():
            t.data.copy_(pl._local_from(ln, whole_sd.__getitem__))
    whole_params = dict(model.named_parameters())
    state = {}
    for ln, _ in local.named_parameters():
        if pl.local_to_global[ln] in in_opt:
            keys = opt.state[whole_params[pl.local_to_global[ln]]]
            state[ln] = {k: pl._local_from(ln, lambda g, k=k: opt.state[whole_params[g]][k])
                         for k in keys}
    return local, state


def _held(model, opt, pl: Placement) -> List[torch.Tensor]:
    """What a step may change: the parameters (a stage-3 leaf's slice in
    place of its parameters), the optimizer state, the float buffers."""
    stored = {id(p) for s in pl.shards if s.store_sharded for p in s.params}
    return ([p.detach() for p in model.parameters() if id(p) not in stored]
            + [s.local for s in pl.shards if s.store_sharded] + list(state_tensors(opt))
            + [b for b in model.buffers() if b.is_floating_point()])


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


class _Step:
    """What the train and eval steps share: the world's counts, the
    routed dataset ids, the mixed-precision cast."""

    def __init__(self, objective: Objective, table: R.RuleTable, grid: Optional[Grid] = None):
        _check_table(table, grid)
        self.objective, self.table = objective, table
        self.routed = table.routed
        # the world's real graphs in the last batch: the weight of its loss
        # in an epoch mean (train/loop.py), the same on every rank
        self.last_count: Optional[torch.Tensor] = None

    def _prepare(self, state, batch: GraphBatch):
        """(model, the batch on its device, the counts summed over the
        world: [real graphs, then real graphs per branch], this rank's
        real graphs)."""
        pl: Placement = state.placement
        grid = pl.grid
        model = state.model
        dev = module_device(model)
        mask = batch.graph_mask
        n_local = float(mask.sum())
        row = [n_local]
        if self.routed:
            masses = [0.0] * (pl.b_local * grid.model_size)
            off = grid.model_index * pl.b_local
            for d in batch.dataset_id[mask].tolist():
                masses[off + min(max(int(d) - off, 0), pl.b_local - 1)] += 1.0
            row += masses
        counts = torch.tensor(row, dtype=torch.float32).to(dev)
        dist.all_reduce(counts, group=grid.group)
        batch = batch.to(dev, non_blocking=True)
        if self.routed:
            off = grid.model_index * pl.b_local
            batch = batch.replace(
                dataset_id=torch.clamp(batch.dataset_id - off, 0, pl.b_local - 1))
        if self.objective.mixed_precision:
            batch = cast_batch_bf16(batch, keep_pos=self.objective.compute_grad_energy)
        self.last_count = counts[0]
        return model, batch, counts, n_local


def make_mesh_train_step(objective: Objective, table: R.RuleTable, grid: Optional[Grid] = None):
    """``step(state, batch) -> (state, loss, per-task losses)`` over a
    ``place_state`` state: every rank calls it on its own batch, in
    lockstep. The losses are the world's weighted means; ``step.last_count``
    is the world's real-graph count of the last batch."""
    return _TrainStep(objective, table, grid)


class _TrainStep(_Step):
    def __init__(self, objective, table, grid=None):
        super().__init__(objective, table, grid)
        # read when the step is built, as make_train_step reads it
        self.guarded = guard_enabled() if objective.guard is None else bool(objective.guard)

    def __call__(self, state, batch: GraphBatch):
        pl: Placement = state.placement
        model, batch, counts, n_local = self._prepare(state, batch)
        share = n_local / torch.clamp(counts[0], min=1.0)
        pl.gather_params()
        guarded = self.guarded and state.guard is not None
        model.train()
        if guarded:
            state.guard.save()
        params = list(model.parameters())
        for p in params:
            p.grad = None
        apply = _apply_fn(model, self.objective.mixed_precision, cast_buffers=False)
        tot, tasks, _ = train_loss(apply, batch, model.cfg, self.objective.compute_grad_energy)
        tot = tot.float()
        tot.backward()
        with torch.no_grad():
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            names = sorted(tasks)
            losses = torch.stack([tot.detach()] + [tasks[k].detach().float() for k in names])
            tot, tasks = self._reduce_and_update(state, pl, model, params, losses, counts,
                                                 n_local, share, guarded)
            tasks = dict(zip(names, tasks))
        pl.release_params()
        return state, tot, tasks

    def _reduce_and_update(self, state, pl: Placement, model, params, losses, counts, n_local,
                           share, guarded):
        grid, opt = pl.grid, state.optimizer
        stored = {id(p) for s in pl.shards for p in s.params}
        world_t, dec_t = [], []  # reduced over the world / over the data group
        for n, p in model.named_parameters():
            if id(p) not in stored:
                (dec_t if n in pl.decoder else world_t).append((n, p.grad))
        for n, b in pl.stat_buffers:
            (dec_t if n in pl.decoder else world_t).append((n, b))
        for _, t in world_t:
            t.mul_(share)
        losses.mul_(share)
        streams = [s.grad_stream().mul_(share) for s in pl.shards]
        _all_reduce_flat([t for _, t in world_t] + [losses]
                         + [st for s, st in zip(pl.shards, streams) if not s.grads_sharded],
                         grid.group)
        if dec_t:
            m, bl = grid.model_index, pl.b_local
            scale = n_local / torch.clamp(counts[1 + m * bl:1 + (m + 1) * bl], min=1.0)
            if pl.branch_weights:
                scale = scale * torch.tensor(pl.branch_weights[m * bl:(m + 1) * bl],
                                             dtype=scale.dtype, device=scale.device)
            for n, t in dec_t:
                t.mul_(_per_branch(pl, n, t, scale))
            if grid.data_group is not None:
                _all_reduce_flat([t for _, t in dec_t], grid.data_group)
        reduced = {id(p): p.grad for p in params if id(p) not in stored}
        piece_grads = []
        for s, st in zip(pl.shards, streams):
            if s.grads_sharded:
                chunk = torch.empty(s.c, dtype=st.dtype, device=st.device)
                _reduce_scatter(chunk, st, grid.group)
            else:
                chunk = st[s.rank * s.c:(s.rank + 1) * s.c]
            if not s.grads_sharded or grid.world == 1:
                reduced.update(zip((id(p) for p in s.params),
                                   s.param_grads(st if not s.grads_sharded else chunk)))
            s.chunk_grad = chunk
            off = 0
            for piece in s.pieces:
                piece.grad = chunk[off:off + piece.numel()].view_as(piece)
                off += piece.numel()
                piece_grads.append(piece.grad)
        norm = self._global_norm(pl, model, params, reduced)
        tot = losses[0]
        ok = torch.isfinite(tot) & torch.isfinite(norm)
        opt_grads = [p.grad for p in pl.replicated] + piece_grads

        def update():
            if opt.clip_grad_norm > 0.0:
                clip = opt.clip_grad_norm
                torch._foreach_mul_(opt_grads, torch.where(norm < clip, torch.ones_like(norm),
                                                           clip / norm))
            opt.step()
            for s in pl.shards:
                if not s.store_sharded:
                    s.gather_updated(grid.group)

        if guarded:
            guarded_update(state, ok, update)
        else:
            update()
            state.step.add_(1)
        for s in pl.shards:
            s.chunk_grad = None
            for piece in s.pieces:
                piece.grad = None
        return tot, list(losses[1:])

    def _global_norm(self, pl: Placement, model, params, reduced) -> torch.Tensor:
        """The reduced gradients' global norm, as ``optimizer.global_norm``
        takes it (per parameter, in the model's order) where every rank
        holds every gradient; otherwise the squared norms of the parts a
        rank holds alone (its reduce-scattered slices, its model index's
        decoder branches) summed over the world."""
        grid = pl.grid
        split = [s for s in pl.shards if s.grads_sharded] if grid.world > 1 else []
        if not split and not pl.decoder:
            norms = torch._foreach_norm([reduced[id(p)].float() for p in params])
            return torch.linalg.vector_norm(torch.stack(norms))
        pname = {id(p): n for n, p in model.named_parameters()}
        common = [reduced[id(p)].float() for p in params
                  if id(p) in reduced and pname[id(p)] not in pl.decoder]
        own = [s.chunk_grad.float() for s in split]
        if grid.data_index == 0:  # a decoder's gradients, once per model index
            own += [reduced[id(p)].float() for p in params if pname[id(p)] in pl.decoder]
        sq = lambda ts: (torch.stack(torch._foreach_norm(ts)) ** 2).sum()  # noqa: E731
        part = sq(own) if own else torch.zeros((), device=common[0].device)
        dist.all_reduce(part, group=grid.group)
        return torch.sqrt(sq(common) + part)


def _per_branch(pl: Placement, name: str, t: torch.Tensor, scale: torch.Tensor):
    """``scale`` (one entry per local branch) shaped to multiply ``t``."""
    _, axis, off = pl.decoder[name]
    if axis is None:  # a bank module's branch
        return scale[off - pl.grid.model_index * pl.b_local]
    shape = [1] * t.dim()
    shape[axis] = scale.numel()
    return scale.view(shape)


def make_mesh_eval_step(objective: Objective, table: R.RuleTable, grid: Optional[Grid] = None):
    """``eval_step(state, batch) -> (loss, per-task losses, outputs)`` over
    a placed ``state``, in eval mode: the losses are the world's weighted
    means, the outputs this rank's own."""
    return _EvalStep(objective, table, grid)


class _EvalStep(_Step):
    def __call__(self, state, batch: GraphBatch):
        pl: Placement = state.placement
        model, batch, counts, n_local = self._prepare(state, batch)
        pl.gather_params()
        model.eval()
        apply = _apply_fn(model, self.objective.mixed_precision, cast_buffers=True)
        with torch.no_grad():
            tot, tasks, outputs = compute_loss(apply, batch, model.cfg,
                                               self.objective.compute_grad_energy,
                                               create_graph=False)
            names = sorted(tasks)
            vec = torch.stack([tot.float()] + [tasks[k].float() for k in names])
            vec.mul_(n_local / torch.clamp(counts[0], min=1.0))
            dist.all_reduce(vec, group=pl.grid.group)
        pl.release_params()
        return (vec[0], dict(zip(names, vec[1:])), {k: v.detach() for k, v in outputs.items()})
