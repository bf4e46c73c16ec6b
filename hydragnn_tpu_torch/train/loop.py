"""Training and evaluation loops, and the mixed-precision casts.

Counterpart of ``hydragnn_tpu/train/loop.py``: ``make_train_step``,
``make_eval_step``, ``train_epoch``, ``evaluate``, ``EarlyStopping``,
``BestCheckpoint``, ``train_validate_test`` and ``test_model``, with the
JAX package's recovery plane (the non-finite policy, the warmup ramp, the
SIGTERM stop mid-epoch and at the epoch boundary, mid-epoch resume, ``HYDRAGNN_VALTEST`` / ``HYDRAGNN_MAX_NUM_BATCH``,
``HYDRAGNN_STEP_GUARD`` and ``HYDRAGNN_DUMP_TESTDATA``) and its
observability plane (the per-step telemetry, step spans and region timers,
the numerics step with its NaN watch, the flight recorder, the event
stream and the ``Profile`` section) and its compile and memory plane (the
remat wraps of ``train_loss``; the tuned table and the compile plane,
CUDA graphs per ladder level and the retrace sentinel, launched by
``train_validate_test``), without its fault-injection hooks.

Under ``mixed_precision`` a train step runs the model on bf16 copies of
its parameters made inside the differentiated function
(``torch.func.functional_call``), so the gradients land on the f32
masters; the batch-norm buffers stay f32 and take the EMA in f32, as
``mp_cast`` and ``mp_restore_stats`` do. The eval cast also rounds the
running statistics, as ``mp_cast_eval`` does.

The losses of a step stay on the device; ``train_epoch`` and ``evaluate``
read them once, at the end of the epoch.
"""

from __future__ import annotations

import copy
import os
import pickle
import sys
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.graph import GraphBatch
from ..device import module_device
from ..ops.remat import loss_remat, site_policy
from ..utils import envflags, preemption
from ..utils.ranks import is_primary, rank, world_size
from .guard import NonFinitePolicy, guarded_update, step_ok
from .loss import compute_loss
from .optimizer import ReduceLROnPlateau, optimizer_step
from .state import TrainState

# float batch fields cast to bfloat16 under mixed precision (targets and
# masks stay f32/bool)
_MP_INPUT_FIELDS = ("x", "pos", "edge_attr", "edge_shifts", "pe", "rel_pe")


def cast_batch_bf16(batch: GraphBatch, keep_pos: bool = False) -> GraphBatch:
    """The model-input channels of ``batch`` in bfloat16 (``keep_pos``
    keeps f32 positions for the autograd-force objective)."""
    upd = {}
    for f in _MP_INPUT_FIELDS:
        if keep_pos and f == "pos":
            continue
        v = getattr(batch, f)
        if v is not None and v.is_floating_point():
            upd[f] = v.to(torch.bfloat16)
    return batch.replace(**upd)


def mp_cast_model(model: torch.nn.Module) -> torch.nn.Module:
    """A bfloat16 copy of ``model``: parameters AND batch-norm running
    statistics, as eval normalizes with the running statistics."""
    return copy.deepcopy(model).to(torch.bfloat16)


def mp_cast_eval(model: torch.nn.Module, batch: GraphBatch,
                 compute_grad_energy: bool = False):
    """Eval-side mixed-precision cast: ``(bf16 model copy, bf16 inputs)``."""
    return mp_cast_model(model), cast_batch_bf16(batch, keep_pos=compute_grad_energy)


def _apply_fn(model, mixed_precision: bool, cast_buffers: bool) -> Callable:
    """``batch -> outputs`` of ``model``; under mixed precision on bf16
    casts of its parameters (and, for eval, of its float buffers) made
    inside the call, so autograd carries the gradients to the f32
    masters."""
    if not mixed_precision:
        return model

    def apply(batch):
        cast = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
        if cast_buffers:
            cast.update({n: b.to(torch.bfloat16) for n, b in model.named_buffers()
                         if b.is_floating_point()})
        return torch.func.functional_call(model, cast, (batch,))

    return apply


def train_loss(apply, batch: GraphBatch, cfg, compute_grad_energy: bool = False):
    """``compute_loss`` of a train step: its kernel call sites under
    ``cfg.remat_policy`` (``remat.site_policy``), and under
    ``cfg.conv_checkpointing`` the whole loss checkpointed with that
    policy's save rule (``remat.loss_remat``), as the JAX package's
    ``make_train_step`` wraps its ``loss_fn``. No wrap changes a value."""
    policy = getattr(cfg, "remat_policy", "full")

    def loss():
        with site_policy(policy):
            return compute_loss(apply, batch, cfg, compute_grad_energy)

    if getattr(cfg, "conv_checkpointing", False):
        return loss_remat(loss, policy)()
    return loss()


def guard_enabled() -> bool:
    """``HYDRAGNN_STEP_GUARD``: on unless set to anything but ``1``, as the
    JAX package reads it."""
    return envflags.env_force("HYDRAGNN_STEP_GUARD") is not False


def make_train_step(model, compute_grad_energy: bool = False,
                    mixed_precision: bool = False, numerics: bool = False):
    """``train_step(state, batch) -> (state, loss, per-task losses)``: one
    optimizer step of ``state`` (updated in place) on ``batch``, the losses
    as device tensors. ``compute_grad_energy`` trains the energy-force
    objective. Where the guard is on (``guard_enabled()``, read here) and
    ``state.guard`` is set (``TrainState.create``'s default) a step whose
    loss or global gradient norm is not finite is skipped on the device
    (train/guard.py). The update is ``optimizer_step`` (the optimizer's
    clip, then its step).

    ``numerics`` (``Telemetry.numerics``): the step returns a fourth
    output, ``{"ok", "act", "grad"}`` (the guard's ok flag, the probe
    stack and the gradient-group stack of obs/numerics.py, on the device),
    and the function carries ``_numerics_meta`` (the tensor name tables,
    written by its first step) and ``_nan_diagnose`` (the provenance
    drill-down). Off, nothing of it runs.

    ``train_step.placed(state, batch)`` is the step on a batch already on
    the model's device (what the compile plane captures), and
    ``train_step.objective`` its objective flags."""
    apply = _apply_fn(model, mixed_precision, cast_buffers=False)
    guarded = guard_enabled()
    meta = {"act_names": None, "grad_names": None} if numerics else None

    def placed(state: TrainState, batch: GraphBatch):
        if mixed_precision:
            batch = cast_batch_bf16(batch, keep_pos=compute_grad_energy)
        return step_on(state, model, batch, apply, compute_grad_energy, guard=guarded,
                       numerics=meta)

    def train_step(state: TrainState, batch: GraphBatch):
        return placed(state, batch.to(module_device(model), non_blocking=True))

    train_step.placed = placed
    train_step.objective = {"compute_grad_energy": bool(compute_grad_energy),
                            "mixed_precision": bool(mixed_precision)}

    if numerics:
        from ..obs.numerics import make_nan_diagnostic

        train_step._numerics_meta = meta
        train_step._nan_diagnose = make_nan_diagnostic(model, compute_grad_energy,
                                                       mixed_precision)
    return train_step


def step_on(state: TrainState, model, batch: GraphBatch, apply: Optional[Callable] = None,
            compute_grad_energy: bool = False, guard: bool = True,
            numerics: Optional[Dict[str, Any]] = None):
    """One optimizer step of ``state`` on ``batch`` (placed and cast): the
    train-mode forward of ``apply`` (``model`` when None) and its loss, the
    backward into ``model``'s parameters, then the update, skipped on the
    device for a non-finite step where ``guard`` is set and the state has
    the guard's copies. Returns ``(state, loss, per-task losses)``; with a
    ``numerics`` name table (``make_train_step``'s), the probe and
    gradient-group statistics and the ok flag as a fourth output, the
    names written into the table."""
    params = list(model.parameters())
    opt = state.optimizer
    guarded = guard and state.guard is not None
    model.train()
    if guarded:
        # what the step may change, as it was before the forward (the
        # forward updates the batch-norm buffers)
        state.guard.save()
    for p in params:
        p.grad = None
    if numerics is None:
        tot, tasks, _ = train_loss(apply or model, batch, model.cfg, compute_grad_energy)
    else:
        from ..obs.numerics import ProbeRecord, StepStats, collecting, param_groups

        if "groups" not in numerics:
            numerics["groups"] = param_groups(model)
        rec = ProbeRecord()
        with collecting(rec):
            tot, tasks, _ = train_loss(apply or model, batch, model.cfg, compute_grad_energy)
        stats = StepStats(rec, numerics["groups"])
        numerics["act_names"], numerics["grad_names"] = stats.names, stats.group_names
    tot = tot.float()
    tot.backward()
    numer = None
    with torch.no_grad():
        for p in params:  # an unused parameter gets a zero gradient, as in optax
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        ok = None
        if numerics is not None:
            # with step_ok's verdict, from the groups' sums of squares (the
            # global norm is finite exactly where their sum is)
            acts, gstats, ok = stats.finish(grads, tot)
            numer = {"ok": ok, "act": acts, "grad": gstats}
        if guarded:
            guarded_update(state, ok if ok is not None else step_ok(tot, grads),
                           lambda: optimizer_step(opt, grads))
        else:
            optimizer_step(opt, grads)
            state.step.add_(1)
    out = (state, tot.detach(), {k: v.detach() for k, v in tasks.items()})
    return out if numer is None else out + (numer,)


def make_eval_step(model, compute_grad_energy: bool = False,
                   mixed_precision: bool = False):
    """``eval_step(state, batch) -> (loss, per-task losses, outputs)`` with
    the model in eval mode (running statistics), on the bf16 eval cast
    under ``mixed_precision``. ``state`` may be None. ``eval_step.placed``
    is the step on a batch already on the model's device."""
    cfg = model.cfg
    apply = _apply_fn(model, mixed_precision, cast_buffers=True)

    def placed(state, batch: GraphBatch):
        if mixed_precision:
            batch = cast_batch_bf16(batch, keep_pos=compute_grad_energy)
        model.eval()
        with torch.no_grad():  # the energy-force loss turns grad on for dE/dpos
            tot, tasks, outputs = compute_loss(apply, batch, cfg, compute_grad_energy,
                                               create_graph=False)
        return (tot.detach(), {k: v.detach() for k, v in tasks.items()},
                {k: v.detach() for k, v in outputs.items()})

    def eval_step(state, batch: GraphBatch):
        return placed(state, batch.to(module_device(model), non_blocking=True))

    eval_step.placed = placed
    return eval_step


def _weighted_avg(entries: List[Tuple[float, Dict[str, float], int]]):
    total_n = sum(n for _, _, n in entries) or 1
    tot = sum(l * n for l, _, n in entries) / total_n
    task_names = entries[0][1].keys() if entries else []
    tasks = {k: sum(t[k] * n for _, t, n in entries) / total_n for k in task_names}
    return tot, tasks


def _read_entries(entries):
    """The epoch's device losses (and device counts) read back in one
    transfer."""
    if not entries:
        return []
    names = list(entries[0][1])
    flat = torch.stack([torch.stack([t.float()] + [d[k].float() for k in names]
                                    + [torch.as_tensor(n, dtype=torch.float32, device=t.device)])
                        for t, d, n in entries]).cpu().tolist()
    return [(row[0], dict(zip(names, row[1:-1])), row[-1]) for row in flat]


def _count(fn, batch) -> Any:
    """The weight of a step's loss in an epoch mean: the real graphs of the
    batch, or the world's (``last_count`` of a distributed step, the same
    on every rank, so every rank's epoch means agree)."""
    n = getattr(fn, "last_count", None)
    return n if n is not None else int(batch.graph_mask.sum())


# loader -> staging_bytes: its templates are built once per loader, not at
# every epoch's start, where the first step waits for them
_SLOT_BYTES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def staging_bytes(loader) -> int:
    """Bytes of the largest batch ``loader`` can emit: its ladder's levels'
    template batches laid out in one block (0 without templates), computed
    once per loader. The rings of ``device_prefetch`` are sized by it, not
    per batch."""
    from .compile_plane import block_layout

    fn = getattr(loader, "spec_template_batches", None)
    if fn is None:
        return 0
    try:
        return _SLOT_BYTES[loader]
    except KeyError:
        n = _SLOT_BYTES[loader] = max((block_layout(t)[1] for _, t in fn()), default=0)
        return n


class _CardRing:
    """``device_prefetch``'s buffers on a CUDA device: ``slots`` pinned host
    blocks and as many device blocks of ``nbytes`` each, used in turn, and
    the side stream that copies one to the other. Batch ``j`` goes to slot
    ``j % slots``: its pinned block is packed once that block's last copy
    is done (``copied``), and its device block is written once the step
    that read it last is (``released``, recorded on the compute stream by
    the consumer before it takes the next batch). A batch larger than the
    slot (a loader without templates) grows the slot."""

    def __init__(self, device: torch.device, slots: int, nbytes: int, compute):
        self.device = device
        self.side = torch.cuda.Stream(device)
        self.compute = compute
        nbytes = max(int(nbytes), 1)
        self.pinned = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                       for _ in range(slots)]
        self.blocks = [self._device_block(nbytes) for _ in range(slots)]
        self.copied: List[Optional[torch.cuda.Event]] = [None] * slots
        self.released: List[Optional[torch.cuda.Event]] = [None] * slots
        self.staged = 0

    def _device_block(self, nbytes: int) -> torch.Tensor:
        block = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
        # freed with the ring: reused only once the compute stream is past it
        block.record_stream(self.compute)
        return block

    def stage(self, host: GraphBatch, lock):
        """``host`` packed into the next pinned block and copied to its
        device block in one transfer on the side stream, issued under
        ``lock``: ``(host, the device batch (views of the block), the
        copy's event, the slot)``."""
        from .compile_plane import block_layout, block_views, pack_block

        k = self.staged % len(self.blocks)
        if self.staged >= len(self.blocks) and self.released[k] is None:
            raise RuntimeError("device staging: slot reused before its batch was consumed")
        self.staged += 1
        spans, total = block_layout(host)
        if self.copied[k] is not None:
            self.copied[k].synchronize()
        if self.pinned[k].numel() < total:
            self.pinned[k] = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        pack_block(host, self.pinned[k], spans)
        with lock, torch.cuda.stream(self.side):
            if self.released[k] is not None:
                self.side.wait_event(self.released[k])
            if self.blocks[k].numel() < total:
                if self.released[k] is not None:
                    self.released[k].synchronize()
                self.blocks[k] = self._device_block(total)
            block = self.blocks[k][:total]
            block.copy_(self.pinned[k][:total], non_blocking=True)
            ev = self.copied[k] = torch.cuda.Event()
            ev.record(self.side)
        batch = block_views(host, block, spans)
        batch.block = block
        return host, batch, ev, k


def device_prefetch(iterator, depth: int = 2, device=None, slot_bytes: int = 0):
    """Double-buffered device staging: a producer thread (data/pipeline.py
    ``Producer``) moves upcoming batches to ``device`` ahead of the step
    that uses them, up to ``depth`` batches ahead, so the host-to-device
    copy leaves the dispatching thread. Each yielded batch keeps its host
    batch as ``.host`` (the loop reads its real-graph count there, never
    from the card).

    On a CUDA device each batch is packed into a ring of ``depth + 2``
    pinned host blocks of ``slot_bytes`` (``staging_bytes`` of the loader:
    its largest level) and copied in one ``non_blocking`` transfer, on a
    side stream, into the device block of the same slot; an event marks
    the copy. The yielded batch is views of that block, which it carries
    as ``.block`` (``StepGraph.load`` copies it in whole). The consumer
    makes the current (compute) stream wait on the copy's event, and
    before it takes the next batch records on that stream that the batch
    is consumed: the slot is written again only after that point. A
    yielded batch is therefore valid until the next one is asked for. The
    producer's copies hold ``compile_plane.CAPTURE_LOCK``: none is issued
    while a CUDA graph is being captured. On the CPU the same thread and
    queue run without streams. An exception in the producer reaches the
    consumer; an abandoned iteration stops it."""
    from ..data.pipeline import Producer
    from .compile_plane import CAPTURE_LOCK

    device = torch.device(device) if device is not None else torch.device("cpu")
    ring = None
    if device.type == "cuda":
        ring = _CardRing(device, max(int(depth), 1) + 2, slot_bytes,
                         torch.cuda.current_stream(device))

    def staged():
        if ring is None:
            for host in iterator:
                yield host, host.to(device), None, None
            return
        torch.cuda.set_device(device)
        for host in iterator:
            yield ring.stage(host, CAPTURE_LOCK)

    p = Producer(staged, depth, "device-prefetch")
    last = None
    try:
        while True:
            if last is not None:
                # the step of the batch yielded last is enqueued: its slot
                # may be written once the compute stream is past here
                ev = torch.cuda.Event()
                ev.record(ring.compute)
                ring.released[last] = ev
            item = p.get()
            if item is Producer.END:
                return
            host, batch, ev, last = item
            if ev is not None:
                ring.compute.wait_event(ev)
            batch.host = host
            yield batch
    finally:
        p.close(2.0)
        if ring is not None:
            # a copy staged but never consumed is ordered before the
            # compute stream's later use of the ring's memory
            ring.compute.wait_stream(ring.side)


def _maybe_device_prefetch(iterator, depth: Optional[int] = None, device=None, loader=None,
                           distributed: bool = False):
    """``device_prefetch`` where it applies: ``depth`` from
    ``Training.double_buffer`` (true = 2, false = off, an int = that
    depth), ``HYDRAGNN_DEVICE_PREFETCH`` always winning (0 disables), None
    meaning no config reached here (the env, else 2), as in the JAX
    package. Only a single-process run stages: the distributed step places
    its batches itself (``distributed``). Sets the gauge
    ``hydragnn_device_prefetch_depth`` (0 while staging inline). The rings
    are sized from ``loader``'s ladder."""
    if envflags.env_set("HYDRAGNN_DEVICE_PREFETCH"):
        depth = envflags.env_int("HYDRAGNN_DEVICE_PREFETCH", 2)
    elif depth is None:
        depth = 2
    active = depth > 0 and not distributed and world_size() == 1
    try:
        from ..obs.registry import registry

        registry().gauge(
            "hydragnn_device_prefetch_depth",
            "Double-buffered device staging queue depth (0 = staging inline)",
        ).set(float(depth if active else 0))
    except Exception:  # noqa: BLE001 — observability only
        pass
    if not active:
        return iterator
    device = torch.device(device) if device is not None else torch.device("cpu")
    slot = staging_bytes(loader) if device.type == "cuda" and loader is not None else 0
    return device_prefetch(iterator, depth=depth, device=device, slot_bytes=slot)


def _host(batch):
    """The host batch behind ``batch`` (``device_prefetch`` keeps it)."""
    return getattr(batch, "host", batch)


def prefetch_depth_of(training: Dict[str, Any]) -> int:
    """``Training.double_buffer`` as a staging depth: true = 2, false = 0,
    an int = that depth."""
    db = training.get("double_buffer", True)
    return 0 if not db else (2 if db is True else int(db))


def train_epoch(loader, step_fn, state: TrainState, telemetry=None, tracer=None,
                nan_watch=None, guard_log=None, prefetch_depth: Optional[int] = None,
                distributed: bool = False):
    """One training epoch: ``(state, mean loss, mean per-task losses,
    cursor)``, the means over real graphs. A guarded-and-skipped step's
    non-finite loss is left out of the means unless every step was
    non-finite. ``cursor`` is None when the epoch ran to its end, or the
    next batch's index in the epoch when SIGTERM arrived (checked after
    every step): the loop then checkpoints it for a mid-epoch resume. A
    loader armed with ``resume()`` skips its first batches itself, and its
    ``start_batch`` offsets the cursor. ``HYDRAGNN_MAX_NUM_BATCH`` > 0
    caps the batches of the epoch.

    The observability hooks, each None by default and then one check a
    step: ``telemetry`` (obs/telemetry.StepTelemetry) gets every step
    (``step_begin`` before the dispatch, ``on_step`` after it); ``tracer``
    (obs/trace.Tracer) emits a ``train/step`` span with its
    ``train/host_batch_build`` and ``train/device_dispatch`` children for
    every sampled step; ``nan_watch`` (obs/numerics.NanWatch) gets every
    step's ok flag and batch (a step of ``make_train_step(numerics=True)``);
    ``guard_log`` (a dict) is filled with the epoch's ``nonfinite`` census
    (batch index and pad level of every step whose loss came back
    non-finite), the provenance of the ``guard_skip`` event. The
    ``dataload`` and ``train_step`` regions (utils/tracer.py) time the
    batch's host build and the step's dispatch.

    ``prefetch_depth`` stages the batches on the model's device ahead of
    the steps (``_maybe_device_prefetch``; ``distributed`` leaves them to
    the distributed step)."""
    from ..utils import tracer as tr

    offset = int(getattr(loader, "start_batch", 0) or 0)
    max_batches = envflags.env_int("HYDRAGNN_MAX_NUM_BATCH", 0)
    # the SIGTERM stop is one process's decision: over several ranks it
    # would leave the others in a collective (checked at world 1 only)
    single = world_size() == 1
    entries = []
    cursor = None
    step_meta = [] if (guard_log is not None or nan_watch is not None) else None
    # the watch keys a step by the state's counter: one host read an epoch
    step0 = int(state.step) if nan_watch is not None else 0
    it = _maybe_device_prefetch(iter(loader), prefetch_depth, module_device(state.model),
                                loader, distributed)
    i = -1
    while True:
        # profiler ranges named as the step's spans, so a torch.profiler
        # trace (the Profile section, the on-demand trigger) shows them
        with torch.profiler.record_function("train/step"):
            t_build = time.perf_counter()
            with torch.profiler.record_function("train/host_batch_build"):
                tr.start("dataload")
                try:
                    batch = next(it)
                except StopIteration:
                    batch = None
                tr.stop("dataload")
            if batch is None:
                break
            build_dt = time.perf_counter() - t_build
            i += 1
            sp = None
            if tracer is not None and tracer.sample_step():
                sp = tracer.begin("train/step")
                sp.set_attribute("batch_index", offset + i)
                tracer.emit_completed("train/host_batch_build", time.time() - build_dt,
                                      build_dt, parent=sp)
            with torch.profiler.record_function("train/device_dispatch"):
                tr.start("train_step")
                if telemetry is not None:
                    telemetry.step_begin()
                t_step = time.perf_counter()
                out = step_fn(state, batch)
                state, tot, tasks = out[0], out[1], out[2]
                numer = out[3] if len(out) > 3 else None
                # the host batch's graph_mask: reading it never waits on the device
                host = _host(batch)
                n = int(host.graph_mask.sum())
                tr.stop("train_step")
            last = getattr(step_fn, "last_count", None)
            entries.append((tot, tasks, n if last is None else last))
            if step_meta is not None:
                idx = offset + i
                level = f"{int(batch.node_mask.shape[-1])}n/{int(batch.edge_mask.shape[-1])}e"
                step_meta.append((idx, level))
                if nan_watch is not None:
                    nan_watch.on_step(state, host, step0 + len(entries) - 1, idx, numer,
                                      level=level)
            if sp is not None:
                dispatch_dt = time.perf_counter() - t_step
                tracer.emit_completed("train/device_dispatch", time.time() - dispatch_dt,
                                      dispatch_dt, parent=sp, attributes={"real_graphs": n})
                sp.set_attribute("real_graphs", n)
                tracer.finish(sp)
            if telemetry is not None:
                telemetry.on_step(host, time.perf_counter() - t_step, real_graphs=n,
                                  numerics=numer)
            if single and preemption.preempted():
                cursor = offset + i + 1
                break
            if max_batches > 0 and i + 1 >= max_batches:
                break
    if nan_watch is not None:
        # drain the watch at the boundary the loop syncs on anyway
        nan_watch.end_epoch(state)
    entries = _read_entries(entries)
    if guard_log is not None and step_meta is not None:
        guard_log["nonfinite"] = [{"batch": m[0], "level": m[1]}
                                  for e, m in zip(entries, step_meta) if not np.isfinite(e[0])]
    finite = [e for e in entries if np.isfinite(e[0])]
    if finite and len(finite) < len(entries):
        entries = finite
    tot, tasks = _weighted_avg(entries)
    return state, tot, tasks, cursor


def evaluate(loader, eval_fn, state: Optional[TrainState] = None,
             prefetch_depth: Optional[int] = None, distributed: bool = False):
    """The mean loss and per-task losses over ``loader``, its batches
    staged as ``train_epoch`` stages them (on the state's model's device;
    on the CPU without a state)."""
    device = module_device(state.model) if state is not None else None
    entries = []
    for batch in _maybe_device_prefetch(iter(loader), prefetch_depth, device, loader,
                                        distributed):
        tot, tasks, _ = eval_fn(state, batch)
        entries.append((tot, tasks, _count(eval_fn, _host(batch))))
    return _weighted_avg(_read_entries(entries))


class EarlyStopping:
    def __init__(self, patience: int = 10, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = float("inf")
        self.count = 0

    def __call__(self, val_loss: float) -> bool:
        if val_loss < self.best - self.min_delta:
            self.best = val_loss
            self.count = 0
            return False
        self.count += 1
        return self.count > self.patience


class BestCheckpoint:
    """Best-validation checkpointing: ``save_fn(state, epoch)`` on each new
    best validation loss from epoch ``warmup`` on."""

    def __init__(self, save_fn: Callable[..., None], warmup: int = 0):
        self.save_fn = save_fn
        self.warmup = warmup
        self.best = float("inf")

    def __call__(self, state: TrainState, val_loss: float, epoch: int) -> bool:
        if epoch < self.warmup or val_loss >= self.best:
            return False
        self.best = val_loss
        self.save_fn(state, epoch)
        return True


def train_validate_test(model, state: TrainState, train_loader, val_loader, test_loader,
                        config: Dict[str, Any], log_name: str = "run", verbosity: int = 0,
                        save_fn: Optional[Callable[..., None]] = None,
                        restore_fn: Optional[Callable[[TrainState], TrainState]] = None,
                        loader_state_fn: Optional[Callable[[Dict[str, int]], None]] = None,
                        step_fn: Optional[Callable] = None, eval_fn: Optional[Callable] = None,
                        writer=None, log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
                        ) -> Tuple[TrainState, Dict[str, List[float]]]:
    """The epoch loop: the ``warmup_epochs`` LR ramp, train, the
    non-finite policy (``NonFinitePolicy``: a rollback restores through
    ``restore_fn(state)``), validate and test (skipped under
    ``HYDRAGNN_VALTEST=0``: the train loss stands in), the plateau
    scheduler on the validation loss after the ramp, best-validation
    checkpointing (``save_fn(state, epoch)``, when ``Training.Checkpoint``
    is set), optional early stopping, and the SIGTERM stop: after a step it
    saves the state and, through ``loader_state_fn``, the loader's cursor
    (``train_loader.state_dict(cursor)``), with a history row that carries
    the last measured val/test losses; at an epoch boundary it saves the
    state. Returns the final state (the best one when early stopping or
    checkpointing is on, unless ``Training.return_best`` says otherwise)
    and the loss history ``{"train", "val", "test", "lr"}``, with the
    epochs' mean per-task train losses (the ``branch<i>`` totals of a
    multibranch model included) under ``"train_tasks"``. ``step_fn`` and
    ``eval_fn`` replace ``make_train_step`` / ``make_eval_step`` (the
    distributed steps of ``parallel/engine.py``); over several ranks only
    rank 0 prints, and the SIGTERM stop is not checked.

    The observability plane, as the JAX loop wires it: the top-level
    ``Telemetry`` section (``resolve_telemetry``) turns on the per-step
    layer (``StepTelemetry``: ``metrics.jsonl``, the MFU of obs/flops.py,
    the ``/metrics`` endpoint, the profile trigger), the step spans of
    ``trace.jsonl``, the numerics step and its NaN watch, the flight
    recorder and ``events.jsonl``, all under ``./logs/<log_name>/``;
    ``NeuralNetwork.Profile`` (or the legacy top-level ``Profile``)
    captures one epoch with ``torch.profiler``. ``writer``
    (utils/writer.MetricsWriter) receives the epoch's health counters
    and the telemetry mirror, ``log_fn(epoch, {train, val, test, lr})``
    every epoch's losses (the SIGTERM stop's carried row too). Numerics on
    a distributed step (``step_fn`` given) raises ``NotImplementedError``."""
    from ..obs.telemetry import StepTelemetry, resolve_telemetry
    from ..utils import tracer as tr
    from ..utils.profile import Profiler

    training = config["NeuralNetwork"]["Training"]
    do_valtest = envflags.env_flag("HYDRAGNN_VALTEST") is not False
    compute_grad_energy = bool(training.get("compute_grad_energy", False))
    mixed_precision = bool(training.get("mixed_precision", False))
    # resolved before the step is built: Telemetry.numerics changes it
    obs_settings = resolve_telemetry(config)
    if obs_settings["numerics"] and (world_size() > 1 or step_fn is not None):
        raise NotImplementedError(
            "Telemetry.numerics on the distributed step (parallel/engine.py) is not "
            "in hydragnn_tpu_torch yet: it comes with the distributed capture slice. Train "
            "on one process, or set Telemetry.numerics to false (and unset "
            "HYDRAGNN_NUMERICS).")
    distributed = step_fn is not None or world_size() > 1
    step_fn = step_fn or make_train_step(model, compute_grad_energy, mixed_precision,
                                         numerics=obs_settings["numerics"])
    eval_fn = eval_fn or make_eval_step(model, compute_grad_energy, mixed_precision)
    numerics_meta = getattr(step_fn, "_numerics_meta", None)
    verbosity = verbosity if is_primary() else 0
    single = world_size() == 1
    scheduler = ReduceLROnPlateau()
    stopper = (EarlyStopping(patience=training.get("patience", 10))
               if training.get("EarlyStopping", False) else None)
    checkpointer = (BestCheckpoint(save_fn, warmup=int(training.get("checkpoint_warmup", 0)))
                    if training.get("Checkpoint", False) and save_fn is not None else None)
    nf_policy = NonFinitePolicy(
        policy=training.get("non_finite_policy", "warn_skip"),
        rollback_after=int(training.get("non_finite_rollback_after", 3)),
        lr_backoff=float(training.get("non_finite_lr_backoff", 0.5)),
        max_rollbacks=int(training.get("non_finite_max_rollbacks", 3)),
        restore_fn=restore_fn, log_name=log_name,
    )
    profiler = Profiler(
        # the documented home first; the legacy top-level section still works
        config["NeuralNetwork"].get("Profile") or config.get("Profile"),
        log_dir=f"./logs/{log_name}/profile",
    )
    return_best = bool(training.get("return_best", stopper is not None
                                    or checkpointer is not None)) and do_valtest
    # Training.warmup_epochs: a linear LR ramp over the first epochs, ending
    # at the base LR; the plateau scheduler engages after it
    warmup_epochs = int(training.get("warmup_epochs", 0))
    base_lr = state.learning_rate
    hist: Dict[str, List[Any]] = {"train": [], "val": [], "test": [], "lr": [],
                                  "train_tasks": []}
    validator = getattr(train_loader, "validator", None)
    reported_skips = 0
    best_val, best_state = float("inf"), None
    run_dir = os.path.join("./logs", log_name)
    preemption.install()
    tr.enable()
    telemetry = (StepTelemetry(obs_settings, log_name, writer=writer,
                               device=module_device(model))
                 if obs_settings["enabled"] else None)
    if telemetry is not None:
        if numerics_meta is not None:
            telemetry.attach_numerics(numerics_meta)
        if telemetry.want_mfu:
            from ..obs.flops import train_flops_for

            telemetry.attach_flops(train_flops_for(model, compute_grad_energy,
                                                   mixed_precision))
    elif numerics_meta is not None:
        import warnings

        warnings.warn(
            "Telemetry.numerics is on but Telemetry.enabled is off: the "
            "hydragnn_numerics_* gauges and metrics.jsonl 'numerics' records are "
            "published by the enabled per-step layer and will not appear; NaN "
            "provenance events and flight-recorder dumps still fire. Set "
            "Telemetry.enabled: true for the full observatory.",
            RuntimeWarning, stacklevel=2)
    nan_watch = None
    if numerics_meta is not None:
        from ..obs.numerics import NanWatch

        nan_watch = NanWatch(diagnose=step_fn._nan_diagnose, log_name=log_name)
    tracer = None
    if obs_settings["trace"]:
        from ..obs import trace as obs_trace

        tracer = obs_trace.install(obs_trace.Tracer(
            run_dir, sample=float(obs_settings["trace_sample"]),
            every_n_steps=int(obs_settings["trace_interval_steps"])))
    plane_on = obs_settings["enabled"] or obs_settings["trace"] or obs_settings["numerics"]
    flight = None
    if obs_settings["flight_recorder"] and plane_on:
        from ..obs.flightrec import FlightRecorder

        flight = FlightRecorder(run_dir, tracer=tracer).install()
    events_armed = False
    if plane_on:
        from ..obs.events import attach_stream

        events_armed = attach_stream(run_dir) is not None
    # guard-skip EVENT accounting for the telemetry counter: positive deltas
    # of the state's counter (a rollback restore lowers it), from the
    # incoming state's total (a resumed run's earlier skips are not ours)
    guard_seen = int(state.skipped_steps) if writer is not None or telemetry is not None else 0
    guard_events = 0
    # the kernels' tuned table, installed before the first launch (tune/),
    # then the compile plane: a CUDA graph per ladder level and the retrace
    # sentinel (train/compile_plane.py)
    from ..tune.runtime import setup_autotune
    from .compile_plane import CompilePlane, compile_metrics

    setup_autotune(config, train_loader, log_name)
    plane = CompilePlane(mode=str(training.get("precompile", "background")),
                         retrace_policy=str(training.get("retrace_policy", "warn")),
                         log_name=log_name,
                         remat_policy=str(training.get("remat_policy", "full")))
    plane_rep = None
    # Training.double_buffer: the batches staged on the card ahead of the
    # steps (HYDRAGNN_DEVICE_PREFETCH wins), in a single-process run only
    staging = dict(prefetch_depth=prefetch_depth_of(training), distributed=distributed)
    try:
        step_fn, eval_fn = plane.launch(step_fn, eval_fn, state, train_loader, val_loader,
                                        test_loader, skip_eval=not do_valtest,
                                        distributed=distributed)
        for epoch in range(int(training["num_epoch"])):
            if warmup_epochs and epoch < warmup_epochs:
                state = state.with_learning_rate(base_lr * (epoch + 1) / warmup_epochs)
            profiler.epoch_begin(epoch)
            train_loader.set_epoch(epoch)
            guard_log: Dict[str, Any] = {}
            with tr.timer("train"):
                state, tr_loss, tr_tasks, cursor = train_epoch(
                    train_loader, step_fn, state, telemetry=telemetry, tracer=tracer,
                    nan_watch=nan_watch, guard_log=guard_log, **staging)
            hist["train"].append(tr_loss)
            hist["train_tasks"].append(tr_tasks)
            if (validator is not None and validator.skipped_total != reported_skips
                    and is_primary()):
                # the data plane's skips, said at the epoch boundary
                reported_skips = validator.skipped_total
                print(f"[{log_name}] epoch {epoch}: data-plane skips: {validator.tally()}",
                      file=sys.stderr)
            if writer is not None or telemetry is not None:
                # the run's health counters into the metric sinks
                skipped_total = int(state.skipped_steps)
                guard_events += max(skipped_total - guard_seen, 0)
                guard_seen = skipped_total
                rep_now = plane.report()
                if writer is not None:
                    writer.add_scalars({
                        "guard/skipped_steps": skipped_total,
                        "data/skipped_samples": (validator.skipped_total
                                                 if validator is not None else 0),
                        "compile/retrace_violations": rep_now["violations"],
                        "compile/cache_hits": rep_now["cache_hits"],
                        "compile/cache_misses": rep_now["cache_misses"],
                    }, epoch)
                if telemetry is not None:
                    telemetry.absorb_counters(
                        guard_skipped=guard_events,
                        data_skipped=dict(validator.counts) if validator is not None else None,
                        retrace_violations=rep_now["violations"],
                        compile_metrics=compile_metrics())
            if cursor is not None:
                # SIGTERM between steps: save the state and the loader's
                # cursor now (the grace window is ticking: no val/test, no
                # policy) and stop. The history row carries the last
                # measured val/test losses (the train loss in epoch 0)
                last_val = hist["val"][-1] if hist["val"] else tr_loss
                last_test = hist["test"][-1] if hist["test"] else tr_loss
                hist["val"].append(last_val)
                hist["test"].append(last_test)
                hist["lr"].append(state.learning_rate)
                filler_row = {"train": tr_loss, "val": last_val, "test": last_test,
                              "lr": state.learning_rate}
                if log_fn is not None:
                    log_fn(epoch, filler_row)
                if writer is not None:
                    # this epoch's val/test are carried, not measured
                    writer.add_scalar("loss/filler", 1.0, epoch)
                if telemetry is not None:
                    telemetry.on_epoch(epoch, filler_row, filler=True)
                preemption.note_global_stop()
                if save_fn is not None:
                    save_fn(state, epoch)
                    if loader_state_fn is not None:
                        loader_state_fn(train_loader.state_dict(cursor))
                if verbosity > 0:
                    print(f"[{log_name}] SIGTERM: checkpointed mid-epoch {epoch} at batch "
                          f"{cursor}, stopping")
                break
            # the policy before val/test, so a rollback epoch evaluates the
            # restored state; the skips' provenance from the NaN watch when
            # numerics is on, else the epoch's non-finite loss census
            provenance = nan_watch.take() if nan_watch is not None else guard_log.get("nonfinite")
            rollbacks_before = nf_policy.rollbacks_done
            if tracer is not None:
                # the guard's events attach to this span's trace
                with tracer.span("train/guard_verdict", epoch=epoch):
                    state = nf_policy.after_epoch(state, epoch, provenance=provenance)
            else:
                state = nf_policy.after_epoch(state, epoch, provenance=provenance)
            if nf_policy.rollbacks_done > rollbacks_before:
                # the ramp recomputes the LR from base_lr: scale it too, or
                # the next ramp epoch would erase the backoff
                base_lr *= nf_policy.lr_backoff ** (nf_policy.rollbacks_done - rollbacks_before)
            if do_valtest:
                with tr.timer("validate"):
                    va_loss, _ = evaluate(val_loader, eval_fn, state, **staging)
                with tr.timer("test"):
                    te_loss, _ = evaluate(test_loader, eval_fn, state, **staging)
            else:
                va_loss = te_loss = tr_loss
            hist["val"].append(va_loss)
            hist["test"].append(te_loss)
            profiler.epoch_end(epoch)
            if epoch >= warmup_epochs:
                state = state.with_learning_rate(scheduler.step(va_loss, state.learning_rate))
            hist["lr"].append(state.learning_rate)
            row = {"train": tr_loss, "val": va_loss, "test": te_loss,
                   "lr": state.learning_rate}
            if log_fn is not None:
                log_fn(epoch, row)
            if telemetry is not None:
                telemetry.on_epoch(epoch, row)
            if verbosity > 0:
                branches = "".join(f" {k} {v:.5f}" for k, v in tr_tasks.items()
                                   if k.startswith("branch"))
                print(f"[{log_name}] epoch {epoch}: train {tr_loss:.5f} val {va_loss:.5f} "
                      f"test {te_loss:.5f} lr {state.learning_rate:.2e}{branches}")
            if return_best and va_loss < best_val:
                best_val, best_state = va_loss, state.state_dict()
            if checkpointer is not None:
                checkpointer(state, va_loss, epoch)
            if stopper is not None and stopper(va_loss):
                break
            if single and preemption.preempted():
                # SIGTERM during val/test: checkpoint at the epoch boundary
                preemption.note_global_stop()
                if save_fn is not None:
                    save_fn(state, epoch)
                if verbosity > 0:
                    print(f"[{log_name}] SIGTERM: checkpointed at epoch {epoch}, stopping")
                break
    except BaseException as e:
        # the black box while it is still armed (an interrupt is a shutdown)
        if flight is not None and not isinstance(e, KeyboardInterrupt):
            try:
                flight.dump("train_exception", exc=e)
            except Exception:  # noqa: BLE001 -- never mask the real error
                pass
        raise
    finally:
        plane_rep = plane.finish(verbosity)
        profiler.close()
        preemption.uninstall()
        _close_plane(telemetry, state, guard_seen, guard_events, validator, log_name, hist,
                     flight, tracer, events_armed, plane_rep)
    if best_state is not None:
        state.load_state_dict(best_state)
    return state, hist


# the ``run`` record's ``compile`` field: the JAX package's keys of the
# compile plane's report
_COMPILE_KEYS = ("precompiled", "specializations", "cache_hits", "cache_misses", "violations",
                 "time_to_first_step")


def _close_plane(telemetry, state, guard_seen, guard_events, validator, log_name, hist,
                 flight, tracer, events_armed, plane_rep) -> None:
    """The observability plane's teardown: the run's last counters and the
    ``run`` record (its ``compile`` field from ``plane_rep``, the compile
    plane's report), then the sinks; never raises past the run's result."""
    import warnings

    from .compile_plane import compile_metrics

    if telemetry is not None:
        try:
            try:
                guard_events += max(int(state.skipped_steps) - guard_seen, 0)
            except Exception:  # noqa: BLE001 -- a state lost to an error
                pass
            telemetry.absorb_counters(
                guard_skipped=guard_events,
                data_skipped=dict(validator.counts) if validator is not None else None,
                retrace_violations=plane_rep["violations"],
                compile_metrics=compile_metrics())
            telemetry.run_record({
                "log_name": log_name,
                "epochs": len(hist["train"]),
                "global_step": telemetry.global_step,
                "endpoint_port": telemetry.endpoint_port,
                "compile": {k: plane_rep[k] for k in _COMPILE_KEYS},
            })
        except Exception as e:  # noqa: BLE001
            warnings.warn(f"telemetry teardown failed ({type(e).__name__}: {e}); the run "
                          "result is unaffected", RuntimeWarning, stacklevel=2)
        finally:
            try:
                telemetry.close()
            except Exception:  # noqa: BLE001 -- the same contract
                pass
    # the recorder stays armed while the telemetry teardown could raise;
    # the tracer's close flushes the span tail
    if flight is not None:
        try:
            flight.uninstall()
        except Exception:  # noqa: BLE001
            pass
    if tracer is not None:
        from ..obs import trace as obs_trace

        try:
            obs_trace.uninstall(tracer)
            tracer.close()
        except Exception:  # noqa: BLE001
            pass
    if events_armed:
        from ..obs.events import detach_stream

        try:
            detach_stream()
        except Exception:  # noqa: BLE001
            pass


def test_model(model, loader, mixed_precision: bool = False,
               compute_grad_energy: bool = False
               ) -> Tuple[float, Dict[str, float], Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Full-dataset evaluation: (loss, per-task losses, predictions,
    targets), the last two flattened over real rows per head (under
    ``compute_grad_energy`` the graph energies and the forces)."""
    cfg = model.cfg
    eval_fn = make_eval_step(model, compute_grad_energy, mixed_precision)
    if compute_grad_energy:
        names_types = [(cfg.output_names[0], "graph"), ("forces", "node")]
    else:
        names_types = list(zip(cfg.output_names, cfg.output_type))
    entries = []
    preds: Dict[str, List[np.ndarray]] = {n: [] for n, _ in names_types}
    trues: Dict[str, List[np.ndarray]] = {n: [] for n, _ in names_types}
    for batch in loader:
        tot, tasks, outputs = eval_fn(None, batch)
        entries.append((float(tot), {k: float(v) for k, v in tasks.items()},
                        int(batch.graph_mask.sum())))
        for name, t in names_types:
            if t == "graph":
                mask = batch.graph_mask
                target = batch.graph_targets["energy" if compute_grad_energy else name]
            else:
                mask, target = batch.node_mask, batch.node_targets[name]
            pred = outputs[name].float().cpu().reshape(target.shape)
            preds[name].append(pred[mask].numpy())
            trues[name].append(target[mask].numpy())
    tot, tasks = _weighted_avg(entries)
    preds_flat = {k: np.concatenate(v) for k, v in preds.items()}
    trues_flat = {k: np.concatenate(v) for k, v in trues.items()}
    # HYDRAGNN_DUMP_TESTDATA: "0"/"false" off, "1"/"true" the default
    # directory logs/testdata, anything else the directory
    dump = envflags.env_str("HYDRAGNN_DUMP_TESTDATA", "")
    if dump and dump.lower() not in ("0", "false"):
        path = dump if dump.lower() not in ("1", "true") else os.path.join("logs", "testdata")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, f"testdata_rank{rank()}.pkl"), "wb") as f:
            pickle.dump({"preds": preds_flat, "trues": trues_flat}, f)
    return tot, tasks, preds_flat, trues_flat
