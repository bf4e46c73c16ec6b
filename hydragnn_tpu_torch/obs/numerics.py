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
   A collection holds each tapped tensor and its mask in forward order.
   Stats are RAW moments (``STAT_FIELDS``: max |x|, sum of
   squares, element count, non-finite count, bf16-underflow count; the
   last for bf16 tensors only) so they merge over a window (max/sum); the
   host finalizes rms and fractions at flush time.

2. **Step ride-along** (``StepStats``): ``make_train_step(numerics=True)``
   holds the taps until the backward ends, then ops/numerics_stats.py
   reduces them and the gradients of every top-level parameter group (the
   JAX package's ``grad_group_stats``) at once: on the card one kernel
   reads each tensor once and a second folds the tiles (N1), two launches
   a step. The probe stack, the gradient-group stack and the guard's ok
   flag (from the groups' sums of squares) are the step's fourth output,
   all device tensors: nothing syncs the host. The telemetry layer reads
   them at a later flush (obs/telemetry.py).

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

import threading
import warnings
from collections import deque
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


# ---------------------------------------------------------------------------
# the reductions
# ---------------------------------------------------------------------------


class StepStats:
    """One step's numerics: the taps of ``record`` (the forward's, in
    forward order) and, at ``finish``, the gradients of the ``groups``
    (``param_groups``), reduced at once by ops/numerics_stats.py (the
    kernel on the card). Drops the record's tensors."""

    def __init__(self, record: "ProbeRecord", groups):
        gnames, _, self.order, gshapes = groups
        entries, record.entries, record._seen = record.entries, [], {}
        self.names = tuple(n for n, _, _ in entries)
        self.group_names = tuple(gnames)
        self.taps = [x for _, x, _ in entries]
        self.masks = [m for _, _, m in entries]
        self.group_sizes = tuple(len(s) for s in gshapes)

    def finish(self, grads: Sequence[torch.Tensor], tot: Optional[torch.Tensor] = None):
        """(probe stack [P, 5], gradient-group stack [G, 5], the ok flag
        from ``tot`` or None), device tensors; ``grads`` in
        ``model.parameters()`` order."""
        from ..ops import numerics_stats as ops

        with torch.no_grad():
            out, ok = ops.numerics_stats(self.taps, self.masks,
                                          [grads[k] for k in self.order],
                                          self.group_sizes, tot)
        self.taps = self.masks = None
        n = len(self.names)
        return out[:n], out[n:], ok


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
    and its mask (the forward holds most of them for the backward anyway)
    in FORWARD order, the order the NaN drill-down walks, until
    ``StepStats`` takes them."""

    def __init__(self):
        self.entries: List[Tuple[str, torch.Tensor, Any]] = []
        self._seen: Dict[str, int] = {}

    def add(self, name: str, x: torch.Tensor, mask=None) -> None:
        # repeated module calls keep distinct rows (suffix #k)
        seen = self._seen.get(name, 0)
        self._seen[name] = seen + 1
        if seen:
            name = f"{name}#{seen}"
        self.entries.append((name, x, mask))


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


# ---------------------------------------------------------------------------
# gradient groups
# ---------------------------------------------------------------------------


def param_groups(model) -> Tuple:
    """(group names, each parameter's group index, the parameters in group
    order, each group's shapes in that order) of ``model``: one group per
    top-level module of its flax parameter tree (``graph_convs_0``,
    ``feature_layers_0``, ``heads_NN_0``, ...), in sorted order, as the JAX
    package's ``grad_group_stats`` groups a flax params dict (``StepStats``
    reduces them). Made once per train step function."""
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
            stats = StepStats(rec, groups[0])
            params = list(model.parameters())
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(
                torch.autograd.grad(tot.float(), params, allow_unused=True), params)]
            acts, gstats, _ = stats.finish(grads)
        finally:
            with torch.no_grad():
                for b, saved in zip(model.buffers(), buffers):
                    b.copy_(saved)
        finding = locate_first_nonfinite(stats.names, acts, stats.group_names, gstats)
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
