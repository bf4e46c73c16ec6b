"""Numerics observatory: per-layer activation and per-parameter-group
gradient statistics taken inside the train step, and the NaN provenance
drill-down (docs/OBSERVABILITY.md "Numerics").

Counterpart of ``hydragnn_tpu/obs/numerics.py``. The step guard
(train/guard.py) says only *that* a loss or gradient went non-finite;
three pieces say where:

1. **Probe taps** (``probe(name, x, mask)``): one-line call sites in
   ``models/base.py`` (``embedding``, ``conv{i}``, ``pooled``,
   ``head:{name}``) and ``models/layers.py`` (``bn:{path}``), the JAX
   package's names in its order. A tap does nothing, and launches
   nothing, unless a collection (``collecting``) is active on the thread.
   A collection holds each tapped tensor (detached) and its mask, and
   ``ProbeRecord.stack`` reduces them all at once, from the tensors as
   they are, accumulating in f32 (``probe_stats``: padding rows zeroed
   by ``where``, so their garbage never counts; every statistic one
   reduction over fixed-size chunks of all taps, then each tap's chunk
   partials combined by index: a few dozen launches a step and no read
   back to the host). Stats are RAW moments (``STAT_FIELDS``: max |x|, sum of squares,
   element count, non-finite count, bf16-underflow count; the last for
   bf16 tensors only) so they merge over a window (max/sum); the host
   finalizes rms and fractions at flush time.

2. **Step ride-along**: ``make_train_step(numerics=True)`` returns the
   probe stack, the gradient-group stack (``grad_group_stats``) and the
   guard's ok flag as a fourth output, all device tensors: nothing syncs
   the host. The telemetry layer reads them at a later flush
   (obs/telemetry.py).

3. **NaN provenance** (``NanWatch``): the loop feeds every step's ok flag
   (and its batch) into a small ring; an entry is read once it is ``lag``
   steps old, when reading it cannot stall the step pipeline. A failed
   step re-runs its HELD batch through ``make_nan_diagnostic`` (every
   probe on, every gradient group) on the CURRENT weights (the failing
   step's were updated or skipped since), names the FIRST non-finite
   tensor in forward order (activations, then gradient groups), emits a
   ``numerics_provenance`` event and triggers one flight-recorder dump per
   run. Data- and LR-driven divergence reproduce; a one-off flip does not
   (the event then says ``layer: <unreproduced>``).
"""

from __future__ import annotations

import math
import threading
import warnings
from collections import OrderedDict, deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# raw stat vector layout, per probed tensor / gradient group:
#   [max_abs, sum_sq, count, nonfinite, bf16_underflow]
# max-abs merges by MAX, the rest by SUM; finalize_stats turns the raw
# moments into {max_abs, rms, nonfinite, bf16_underflow} on the host.
STAT_FIELDS = ("max_abs", "sum_sq", "count", "nonfinite", "bf16_underflow")
STAT_WIDTH = len(STAT_FIELDS)

# smallest positive NORMAL bfloat16/float32 magnitude (bf16 shares f32's
# exponent): a nonzero bf16 value below it is subnormal
BF16_TINY = 1.1754944e-38


# ---------------------------------------------------------------------------
# the reductions
# ---------------------------------------------------------------------------

# segments are laid out in chunks of this many elements: each statistic is
# one reduction over every chunk at once (a launch over the whole card),
# then each segment's chunk partials are combined by index
_CHUNK = 1 << 16
# the layouts (each with its persistent buffer) kept, newest last
_LAYOUTS: "OrderedDict[Tuple, Any]" = OrderedDict()
_MAX_LAYOUTS = 16


def _cached(key, make):
    """A layout or constant made once per signature (a host-to-device copy
    would sync the stream), the least recently used dropped past
    ``_MAX_LAYOUTS``."""
    got = _LAYOUTS.get(key)
    if got is None:
        with torch.inference_mode(False):
            got = make()
        _LAYOUTS[key] = got
        while len(_LAYOUTS) > _MAX_LAYOUTS:
            _LAYOUTS.popitem(last=False)
    else:
        _LAYOUTS.move_to_end(key)
    return got


class _Chunks:
    """A persistent f32 buffer of ``_CHUNK``-element chunks for segments of
    fixed shapes, each segment (a tensor, or a list of tensors taken
    together) on chunks of its own, the bf16 ones first: the views each
    step writes into, made once; the chunks' tails zeroed once (padding is
    finite and counts for nothing); each chunk's segment on the device."""

    def __init__(self, device, shapes: Tuple, bf16: Tuple[bool, ...]):
        order = [i for i, b in enumerate(bf16) if b] + [i for i, b in enumerate(bf16) if not b]
        sizes = [sum(math.prod(s) for s in shapes[i]) for i in range(len(shapes))]
        chunks = {i: max(1, -(-sizes[i] // _CHUNK)) for i in order}
        self.nchunks = sum(chunks.values())
        self.n16 = sum(chunks[i] for i in order if bf16[i])
        self.buf = torch.zeros((self.nchunks, _CHUNK), dtype=torch.float32, device=device)
        flat = self.buf.view(-1)
        self.views: List[List[torch.Tensor]] = [[] for _ in shapes]
        owner, at = [], 0
        for i in order:
            off = at * _CHUNK
            for shape in shapes[i]:
                n = math.prod(shape)
                self.views[i].append(flat[off:off + n].view(shape))
                off += n
            owner += [i] * chunks[i]
            at += chunks[i]
        self.owner = torch.tensor(owner, dtype=torch.int64, device=device)
        self.flat_views = [v for views in self.views for v in views]
        self.nseg = len(shapes)
        self.zero = torch.zeros((), dtype=torch.float32, device=device)
        # a 1-D zero: it takes part in type promotion, so ``where`` of a bf16
        # tap writes f32 into its view in one launch
        self.zero1 = torch.zeros(1, dtype=torch.float32, device=device)

    def _nonfinite_chunks(self) -> torch.Tensor:
        """[chunks] f32 non-finite counts: ``x - x`` is 0 exactly where ``x``
        is finite (NaN elsewhere), and its 0-"norm" counts the rest (two
        passes; ``isfinite`` is five)."""
        return torch.linalg.vector_norm(self.buf - self.buf, ord=0, dim=1)

    def reduce(self, sumsq: bool = True) -> torch.Tensor:
        """[S, 4] f32 (max |x|, sum of squares (0 unless ``sumsq``),
        non-finite count, bf16 underflow count) of each segment: one
        reduction a statistic over every chunk, then the chunks' partials
        combined by index. max |x| comes from the min and the max (no |x|
        buffer); the underflow count from the bf16 segments' chunks alone
        (an f32 copy of a bf16 subnormal is as small); NaN propagates
        through each."""
        lo, hi = torch.aminmax(self.buf, dim=1)
        nonfin = self._nonfinite_chunks()
        if sumsq:
            norm = torch.linalg.vector_norm(self.buf, dim=1)
            parts = [norm * norm, nonfin]
        else:
            parts = [torch.zeros_like(nonfin), nonfin]
        if self.n16:
            ax = self.buf[:self.n16].abs()
            under = self.buf.new_zeros(self.nchunks)
            # the nonzero |x| below the smallest normal, counted as a 0-"norm"
            under[:self.n16] = torch.linalg.vector_norm(
                torch.where(ax < BF16_TINY, ax, self.zero), ord=0, dim=1)
            parts.append(under)
        else:
            parts.append(torch.zeros_like(nonfin))
        raw = self.buf.new_zeros((self.nseg, 4))
        raw[:, 0].scatter_reduce_(0, self.owner, torch.maximum(hi, -lo), "amax")
        raw[:, 1:].index_add_(0, self.owner, torch.stack(parts, dim=1))
        return raw


def _counts(device, sizes: Tuple[int, ...], masks: Sequence[Any]) -> torch.Tensor:
    """[P] f32 real element counts: a masked tensor's real rows times its
    row width (one sum per distinct mask), an unmasked one's size."""
    distinct: List[Any] = []
    pattern = []
    for m in masks:
        if m is None:
            pattern.append(-1)
            continue
        k = next((k for k, d in enumerate(distinct) if d is m), None)
        if k is None:
            distinct.append(m)
            k = len(distinct) - 1
        pattern.append(k)
    key = ("counts", str(device), sizes, tuple(pattern), tuple(tuple(m.shape) for m in distinct))
    n = len(distinct)
    index, widths, one = _cached(key, lambda: (
        torch.tensor([n if k < 0 else k for k in pattern], dtype=torch.int64, device=device),
        torch.tensor([float(size) if k < 0 else float(size // max(distinct[k].numel(), 1))
                      for size, k in zip(sizes, pattern)], dtype=torch.float32, device=device),
        torch.ones(1, dtype=torch.float32, device=device)))
    if not distinct:
        return widths
    sums = torch.cat([torch.stack([m.sum() for m in distinct]).float(), one])
    return sums[index] * widths


def probe_stats(tensors: Sequence[torch.Tensor], masks: Sequence[Any]) -> torch.Tensor:
    """[P, 5] f32 raw moments of the tapped ``tensors``, each with its row
    mask or None (padding rows count as zero: ``where`` drops their
    garbage, NaN included), accumulated in f32: each is written into its
    view of a persistent chunk buffer (one ``where`` a tap, which also
    casts a bf16 one) and ``_Chunks.reduce`` takes them all at once. A few
    dozen launches a step, no host read back."""
    device = tensors[0].device
    shapes = tuple((tuple(x.shape),) for x in tensors)
    bf16 = tuple(x.dtype == torch.bfloat16 for x in tensors)
    ch = _cached((str(device), shapes, bf16), lambda: _Chunks(device, shapes, bf16))
    for x, m, (view,) in zip(tensors, masks, ch.views):
        if m is None:
            view.copy_(x)
            continue
        torch.where(m.reshape(tuple(m.shape) + (1,) * (x.dim() - m.dim())), x, ch.zero1,
                    out=view)
    raw = ch.reduce()
    counts = _counts(device, tuple(x.numel() for x in tensors), masks)
    return torch.stack([raw[:, 0], raw[:, 1], counts, raw[:, 2], raw[:, 3]], dim=1)


class HostCopy:
    """A device tensor's value on its way to the host: a non-blocking copy
    into pinned memory and a CUDA event recorded after it. ``get()`` waits
    for that event alone, never for the work queued after it, so a value
    read steps later drains no pipeline (``.item()`` or ``.cpu()`` wait for
    everything the stream holds). A CPU tensor is kept as it is."""

    __slots__ = ("value", "event")

    def __init__(self, t: torch.Tensor):
        self.value, self.event = t, None
        if t.is_cuda:
            self.value = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.value.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()

    def get(self) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        return self.value


# ---------------------------------------------------------------------------
# probe taps + collection context
# ---------------------------------------------------------------------------


class ProbeRecord:
    """One step's ordered probe collection. ``add`` holds a tapped tensor
    and its mask (detached; the forward holds most of them for the
    backward anyway); ``stack`` reduces them all at once to [P, 5] in
    FORWARD order, the order the NaN drill-down walks."""

    def __init__(self):
        self.entries: List[Tuple[str, torch.Tensor, Any]] = []
        self._seen: Dict[str, int] = {}

    def add(self, name: str, x: torch.Tensor, mask=None) -> None:
        # repeated module calls keep distinct rows (suffix #k)
        seen = self._seen.get(name, 0)
        self._seen[name] = seen + 1
        if seen:
            name = f"{name}#{seen}"
        self.entries.append((name, x.detach(), mask))

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, *_ in self.entries)

    def stack(self):
        """(names, [P, 5] f32 device tensor); P == 0 yields an empty stack.
        Drops the held tensors."""
        if not self.entries:
            return (), torch.zeros((0, STAT_WIDTH))
        out = probe_stats([x for _, x, _ in self.entries], [m for _, _, m in self.entries])
        names = self.names
        self.entries, self._seen = [], {}
        return names, out


class _TapStack(threading.local):
    def __init__(self):
        self.stack: List[ProbeRecord] = []


_TAPS = _TapStack()


@contextmanager
def collecting(record: ProbeRecord):
    """Activate probe collection on this thread for the duration of a
    forward (thread-local: the serving threads never see it)."""
    _TAPS.stack.append(record)
    try:
        yield record
    finally:
        _TAPS.stack.pop()


def collection_active() -> bool:
    """Whether a collection is open on this thread: call sites with
    non-trivial name construction guard on it."""
    return bool(_TAPS.stack)


def probe(name: str, x, mask=None) -> None:
    """Tap a named intermediate. A no-op (one thread-local list check)
    unless a ``collecting`` context is active. ``mask`` restricts the
    statistics to real rows: padding rows carry garbage by contract, and
    counting their NaNs would fire false provenance."""
    if not _TAPS.stack:
        return
    _TAPS.stack[-1].add(name, x, mask)


def run_probed(enabled: bool, meta: Dict[str, Any], thunk: Callable):
    """Run ``thunk`` (the loss computation) under probe collection when
    ``enabled``, recording the forward-ordered tap names into the train
    step's ``meta`` cell. Returns ``(thunk result, acts stack | None)``."""
    if not enabled:
        return thunk(), None
    rec = ProbeRecord()
    with collecting(rec):
        out = thunk()
    names, acts = rec.stack()
    meta["act_names"] = names
    return out, acts


# ---------------------------------------------------------------------------
# gradient groups
# ---------------------------------------------------------------------------


def param_groups(model) -> Tuple:
    """(group names, each parameter's group index, the parameters in group
    order, each group's shapes in that order) of ``model``: one group per
    top-level module of its flax parameter tree (``graph_convs_0``,
    ``feature_layers_0``, ``heads_NN_0``, ...), in sorted order, as the JAX
    package's ``grad_group_stats`` groups a flax params dict. Made once per
    train step function."""
    from ..bridge import flax_path

    banks = [n for n, m in model.named_modules() if getattr(m, "branch_bank", False)]
    tops, shapes = [], []
    for name, p in model.named_parameters():
        bank = next((b for b in banks if name.startswith(b + ".branches.")), None)
        if bank is not None:
            name = bank + "." + name[len(bank) + len(".branches."):].split(".", 1)[1]
        tops.append(flax_path(name)[0].split("/", 1)[0])
        shapes.append(tuple(p.shape))
    names = tuple(sorted(set(tops)))
    index = [names.index(t) for t in tops]
    order = sorted(range(len(index)), key=lambda k: index[k])
    group_shapes = tuple(tuple(shapes[k] for k in order if index[k] == i)
                         for i in range(len(names)))
    return names, index, order, group_shapes


def grad_group_stats(model, grads: Sequence[torch.Tensor], groups=None,
                     leaf_norms: Optional[Sequence[torch.Tensor]] = None):
    """(names, [G, 5]) over the top-level parameter groups of ``model``
    (``grads`` in ``model.parameters()`` order, every one a float tensor
    outside autograd; ``groups`` a cached ``param_groups(model)``;
    ``leaf_norms`` the [L] stack of each gradient's 2-norm where the caller
    has it, as the step's ok flag does). Sorted-name order. The gradients are copied once into a
    persistent chunk buffer (one multi-tensor launch); max |x| and the
    non-finite counts come from the buffer (``_Chunks.reduce``), the sums
    of squares from the 2-norms."""
    names, index, order, shapes = groups if groups is not None else param_groups(model)
    device = grads[0].device
    ch, leaf_group, counts = _cached(("grads", str(device), shapes, tuple(index)), lambda: (
        _Chunks(device, shapes, (False,) * len(names)),
        torch.tensor(index, dtype=torch.int64, device=device),
        torch.tensor([float(sum(math.prod(s) for s in group)) for group in shapes],
                     dtype=torch.float32, device=device)))
    torch._foreach_copy_(ch.flat_views, [grads[k] for k in order])
    if leaf_norms is None:
        leaf_norms = torch.stack(torch._foreach_norm(grads))
    sq = leaf_norms.float() ** 2
    raw = ch.reduce(sumsq=False)
    group_sq = torch.zeros_like(raw[:, 0]).index_add_(0, leaf_group, sq)
    return tuple(names), torch.stack([raw[:, 0], group_sq, counts, raw[:, 2], raw[:, 3]], dim=1)


def finalize_stats(raw) -> Dict[str, float]:
    """Host-side finalization of one raw [5] vector."""
    maxabs, sumsq, cnt, nonfin, under = (float(v) for v in np.asarray(raw))
    denom = max(cnt, 1.0)
    rms = float(np.sqrt(max(sumsq, 0.0) / denom)) if np.isfinite(sumsq) else sumsq
    return {
        "max_abs": maxabs,
        "rms": rms,
        "nonfinite": nonfin,
        "bf16_underflow": under / denom,
    }


def _is_bad(row) -> bool:
    r = np.asarray(row)
    return bool(r[3] > 0 or not np.isfinite(r[0]) or not np.isfinite(r[1]))


def _host(t):
    if t is None:
        return np.zeros((0, STAT_WIDTH))
    if isinstance(t, torch.Tensor):
        return t.detach().double().cpu().numpy()
    return np.asarray(t)


def locate_first_nonfinite(act_names, acts, grad_names, gstats) -> Optional[Dict[str, Any]]:
    """First non-finite tensor in forward order: activations (probe order),
    then gradient groups. Returns {layer, kind, stats} or None."""
    acts = _host(acts)
    for p in range(acts.shape[0]):
        if _is_bad(acts[p]):
            name = act_names[p] if act_names and p < len(act_names) else f"probe{p}"
            return {"layer": name, "kind": "activation",
                    "stats": finalize_stats(acts[p])}
    gstats = _host(gstats)
    for g in range(gstats.shape[0]):
        if _is_bad(gstats[g]):
            name = grad_names[g] if grad_names and g < len(grad_names) else f"group{g}"
            return {"layer": name, "kind": "gradient",
                    "stats": finalize_stats(gstats[g])}
    return None


# ---------------------------------------------------------------------------
# NaN provenance: diagnostic step + deferred watch
# ---------------------------------------------------------------------------


def make_nan_diagnostic(model, compute_grad_energy: bool = False,
                        mixed_precision: bool = False) -> Callable:
    """The drill-down ``diagnose(state, batch, step) -> finding | None`` for
    one model and objective: the train-mode loss of ``batch`` on the
    model's current weights with every probe on, its gradients (through
    ``torch.autograd.grad``: the parameters' ``.grad`` stay as they are)
    and every group's statistics. The batch-norm buffers the forward
    updates are put back, so the diagnosis leaves the model as it was."""
    from ..device import module_device
    from ..train.loop import _apply_fn, cast_batch_bf16
    from ..train.loss import compute_loss

    apply = _apply_fn(model, mixed_precision, cast_buffers=False)
    groups: List[Any] = []

    def diagnose(state, batch, step: int) -> Optional[Dict[str, Any]]:
        if not groups:
            groups.append(param_groups(model))
        batch = batch.to(module_device(model))
        if mixed_precision:
            batch = cast_batch_bf16(batch, keep_pos=compute_grad_energy)
        buffers = [b.clone() for b in model.buffers()]
        model.train()
        try:
            rec = ProbeRecord()
            with torch.enable_grad(), collecting(rec):
                tot, _, _ = compute_loss(apply, batch, model.cfg, compute_grad_energy)
            act_names, acts = rec.stack()
            params = list(model.parameters())
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(
                torch.autograd.grad(tot.float(), params, allow_unused=True), params)]
            grad_names, gstats = grad_group_stats(model, grads, groups[0])
        finally:
            with torch.no_grad():
                for b, saved in zip(model.buffers(), buffers):
                    b.copy_(saved)
        finding = locate_first_nonfinite(act_names, acts, grad_names, gstats)
        if finding is not None:
            finding["loss"] = float(tot.detach())
        return finding

    return diagnose


class NanWatch:
    """Deferred per-step non-finite watch and its provenance drill-down.

    The loop feeds every step (``on_step``); each ok flag starts its way
    to the host at once (``HostCopy``) and is read ``lag`` steps later,
    when the copy has long landed: no read waits for the steps after it. A failed entry is drilled down
    through the diagnostic, emitted as a ``numerics_provenance`` event
    (layer, statistics, batch index, pad level) and, once per run, dumped
    by the flight recorder. ``take()`` hands the accumulated skip
    provenance to the epoch-boundary guard policy, so ``guard_skip``
    events carry it too.

    Bounded: after ``max_diagnoses`` drill-downs the watch stops
    re-running the diagnostic and stops emitting per-skip events (a
    diverged run fails every remaining step), while the skip bookkeeping
    goes on. The ring holds ``lag`` batches (host batches in the port);
    once the budget is spent it holds none."""

    def __init__(self, diagnose: Optional[Callable] = None, lag: int = 4,
                 log_name: str = "run", max_diagnoses: int = 16):
        self.diagnose = diagnose
        self.lag = max(int(lag), 1)
        self.log_name = log_name
        self.max_diagnoses = max(int(max_diagnoses), 1)
        self._ring: deque = deque()
        self.skips: List[Dict[str, Any]] = []
        self.located = 0
        self.suppressed = 0
        self._attempts = 0
        self._dumped = False

    def on_step(self, state, batch, step: int, batch_index: int, numerics,
                level: Optional[str] = None,
                sources: Optional[Sequence[int]] = None) -> None:
        if numerics is None:
            return
        if self._attempts >= self.max_diagnoses:
            batch = None  # budget spent: never hold another batch
        ok = numerics.get("ok")
        self._ring.append((None if ok is None else HostCopy(ok), batch, step, batch_index,
                           level, sources))
        while len(self._ring) > self.lag:
            self._check(state, self._ring.popleft())

    def end_epoch(self, state) -> None:
        """Drain the ring at the epoch boundary (the loop reads the
        epoch's losses there anyway)."""
        while self._ring:
            self._check(state, self._ring.popleft())

    def take(self) -> List[Dict[str, Any]]:
        out, self.skips = self.skips, []
        return out

    def _check(self, state, entry) -> None:
        ok, batch, step, batch_index, level, sources = entry
        try:
            if ok is None or bool(ok.get()):
                return
        except Exception:
            return  # an unreadable flag is not an incident
        prov: Dict[str, Any] = {"batch": int(batch_index), "step": int(step)}
        if level:
            prov["level"] = level
        if sources:
            prov["sources"] = [int(s) for s in sources]
        if self._attempts >= self.max_diagnoses:
            # budget spent (sustained divergence): the bookkeeping only,
            # announced once
            self.suppressed += 1
            prov["layer"] = "<diagnostic_budget_spent>"
            prov["kind"] = "unknown"
            self.skips.append(prov)
            if self.suppressed == 1:
                try:
                    from .events import EV_NUMERICS_PROVENANCE
                    from .events import emit as _emit

                    _emit(
                        EV_NUMERICS_PROVENANCE,
                        severity="warn",
                        layer="<diagnostic_budget_spent>",
                        tensor_kind="unknown",
                        max_diagnoses=self.max_diagnoses,
                        note="sustained divergence: further skips are "
                             "tallied without per-skip drill-down",
                    )
                except Exception:
                    pass
            return
        self._attempts += 1
        finding = None
        if self.diagnose is not None and batch is not None:
            try:
                finding = self.diagnose(state, batch, step)
            except Exception as e:  # diagnosis must never take training down
                warnings.warn(
                    f"NaN provenance diagnostic failed "
                    f"({type(e).__name__}: {e}); the guard skip is still "
                    "recorded without layer attribution",
                    RuntimeWarning,
                    stacklevel=2,
                )
        if finding is not None:
            self.located += 1
            prov.update(
                {
                    "layer": finding["layer"],
                    "kind": finding["kind"],
                    # non-finite stats are the signal; strings keep the
                    # event ring strict JSON
                    **{
                        f"stat_{k}": (float(v) if np.isfinite(v) else str(v))
                        for k, v in finding["stats"].items()
                    },
                }
            )
        else:
            prov["layer"] = "<unreproduced>"
            prov["kind"] = "unknown"
        self.skips.append(prov)
        try:
            from .events import EV_NUMERICS_PROVENANCE
            from .events import emit as _emit

            attrs = dict(prov)
            # "kind" is the event's own discriminator: the tensor kind
            # travels as tensor_kind
            attrs["tensor_kind"] = attrs.pop("kind", "unknown")
            if "sources" in attrs:
                attrs["sources"] = ",".join(str(s) for s in attrs["sources"])
            _emit(EV_NUMERICS_PROVENANCE, severity="warn", **attrs)
        except Exception:
            pass
        if not self._dumped:
            # ONE flight-record dump per run
            self._dumped = True
            try:
                from . import flightrec as _flightrec

                _flightrec.trigger("numerics_provenance")
            except Exception:
                pass
