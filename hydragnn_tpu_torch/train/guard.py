"""Non-finite step guard: a bad optimizer step is skipped on the device.

Counterpart of the in-graph half of ``hydragnn_tpu/train/guard.py``. A
long bf16 run now and then produces a non-finite loss or gradient; one such
update writes NaN into the parameters. ``step_ok`` decides on the device
whether the loss and the global gradient norm are finite, and
``guarded_update`` runs the update as usual and then restores, where the
step was bad, the parameters, the optimizer state (the step count
included) and the batch-norm buffers it held before: no host sync, and a
good step keeps exactly the values the unguarded update wrote. The copies
live in ``StepCopies``, flat buffers made once, so saving and restoring
take a few multi-tensor launches and one ``torch.where`` per dtype. The
skip counters advance on the device; the training loop reads them once
per epoch, where ``NonFinitePolicy`` (the epoch-boundary half,
``Training.non_finite_policy``) raises, warns or rolls back to the last
verified checkpoint, and emits the ``guard_skip``, ``guard_fatal`` and
``guard_rollback`` events (obs/events.py); a fatal verdict dumps the
flight recorder before it raises.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..utils.ranks import is_primary
from .optimizer import global_norm, state_tensors


def held_tensors(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    """Every tensor an optimizer step may change: the parameters, the
    optimizer's state (made eagerly by ``make_optimizer``) and the model's
    float buffers (the batch-norm statistics, updated by the forward)."""
    return ([p.detach() for p in model.parameters()] + list(state_tensors(optimizer))
            + [b for b in model.buffers() if b.is_floating_point()])


class StepCopies:
    """Flat copies of ``held``, one pair of buffers per (device, dtype):
    ``before`` the step's values from before its forward, ``after`` room
    for the values the update wrote."""

    def __init__(self, held: List[torch.Tensor]):
        self.held = held
        groups: Dict[Tuple[torch.device, torch.dtype], List[int]] = {}
        for i, t in enumerate(held):
            groups.setdefault((t.device, t.dtype), []).append(i)
        self.flat: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self.before: List[torch.Tensor] = [None] * len(held)
        self.after: List[torch.Tensor] = [None] * len(held)
        for (device, dtype), idx in groups.items():
            sizes = [held[i].numel() for i in idx]
            pair = tuple(torch.empty(sum(sizes), dtype=dtype, device=device) for _ in range(2))
            self.flat.append(pair)
            for views, flat in zip((self.before, self.after), pair):
                for i, v in zip(idx, flat.split(sizes)):
                    views[i] = v.view_as(held[i])

    @torch.no_grad()
    def save(self) -> None:
        torch._foreach_copy_(self.before, self.held)

    @torch.no_grad()
    def restore_unless(self, ok: torch.Tensor) -> None:
        """``held`` keeps what the update wrote where ``ok``, else takes
        back ``before``."""
        torch._foreach_copy_(self.after, self.held)
        for before, after in self.flat:
            torch.where(ok, after, before, out=after)
        torch._foreach_copy_(self.held, self.after)


def step_ok(tot, grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The loss and the global gradient norm are finite (one reduction
    over every gradient: a NaN or inf anywhere poisons the norm)."""
    return torch.isfinite(tot) & torch.isfinite(global_norm(grads))


def guarded_update(state, ok, do_update: Callable[[], None]) -> None:
    """Run ``do_update()`` (the optimizer step, in place), then put back
    the values ``state.guard`` saved before the step's forward where ``ok``
    is false, and advance the state's counters."""
    do_update()
    state.guard.restore_unless(ok)
    bad = (~ok).to(state.skipped_steps.dtype)
    state.step.add_(1)
    state.skipped_steps.add_(bad)
    state.consecutive_skips.add_(bad).mul_(bad)


def _say(msg: str) -> None:
    """To stderr, once per run: on rank 0 of a distributed one."""
    if is_primary():
        print(msg, file=sys.stderr)


class NonFinitePolicy:
    """The epoch-boundary half of ``Training.non_finite_policy``.

    The training loop calls ``after_epoch(state, epoch)`` once per epoch.
    It reads the state's skip counters (one host read; the loop waits for
    the epoch's losses there anyway) and, when the epoch skipped steps:
    ``error`` raises; ``warn_skip`` prints the tally to stderr; ``rollback``
    prints it and, once ``rollback_after`` consecutive steps were skipped,
    restores the last verified checkpoint through ``restore_fn(state)`` and
    sets the learning rate to the restored one times
    ``lr_backoff ** rollbacks_done`` (compounded: sustained divergence
    keeps restoring the same checkpoint). Past ``max_rollbacks``, or with
    no ``restore_fn``, a rollback raises. The tally counts from 0 in every
    run, as the JAX package's does: a run resumed from a state with
    earlier skips reports them at its first epoch boundary (and raises
    under ``error``). ``policy`` is one of the values config completion
    admits. Over several ranks the counters agree (the step's guard decides
    on reduced values), so every rank takes the same branch; ``restore_fn``
    is then called on every rank, and only rank 0 prints."""

    def __init__(self, policy: str = "warn_skip", rollback_after: int = 3,
                 lr_backoff: float = 0.5, max_rollbacks: int = 3,
                 restore_fn: Optional[Callable] = None, log_name: str = "run"):
        self.policy = policy
        self.rollback_after = int(rollback_after)
        self.lr_backoff = float(lr_backoff)
        self.max_rollbacks = int(max_rollbacks)
        self.restore_fn = restore_fn
        self.log_name = log_name
        self._prev_skipped = 0
        self.rollbacks_done = 0

    def after_epoch(self, state, epoch: int, provenance=None):
        """Apply the policy; returns the (possibly restored) state.
        ``provenance`` (optional) is the epoch's per-skip attribution, dicts
        with ``batch`` / ``level`` / ``sources`` / ``layer`` (the NaN
        watch's findings, or the epoch's non-finite loss census), carried
        by the ``guard_skip`` event."""
        from ..obs.events import EV_GUARD_FATAL, EV_GUARD_ROLLBACK, EV_GUARD_SKIP
        from ..obs.events import emit as _emit_event

        skipped = int(state.skipped_steps)
        consec = int(state.consecutive_skips)
        new_skips = skipped - self._prev_skipped
        self._prev_skipped = skipped
        if new_skips <= 0:
            return state
        msg = (f"[{self.log_name}] epoch {epoch}: {new_skips} non-finite step(s) skipped by "
               f"the train-step guard (total {skipped}, {consec} consecutive at epoch end)")
        extra = {}
        if provenance:
            levels = sorted({str(p["level"]) for p in provenance if p.get("level")})
            sources = sorted({int(s) for p in provenance for s in (p.get("sources") or [])})
            batches = [int(p["batch"]) for p in provenance if p.get("batch") is not None]
            layers = sorted({str(p["layer"]) for p in provenance if p.get("layer")})
            if levels:
                extra["levels"] = ",".join(levels)
            if sources:
                extra["sources"] = ",".join(str(s) for s in sources)
            if batches:  # bounded: a diverged epoch skips every step
                extra["batches"] = ",".join(str(b) for b in batches[:16])
            if layers:
                extra["layers"] = ",".join(layers[:8])
        _emit_event(EV_GUARD_SKIP, severity="warn", epoch=epoch, new_skips=new_skips,
                    total=skipped, consecutive=consec, policy=self.policy, **extra)
        if self.policy == "error":
            err = RuntimeError(
                msg + "; Training.non_finite_policy is 'error'. Inspect the "
                "data/LR, or set 'warn_skip'/'rollback' to ride through."
            )
            # the black box before raising: this epoch's events and the registry
            _emit_event(EV_GUARD_FATAL, severity="fatal", epoch=epoch, total=skipped)
            from ..obs import flightrec as _flightrec

            _flightrec.trigger("fatal_guard", exc=err)
            raise err
        _say(msg)
        if self.policy != "rollback" or consec < self.rollback_after:
            return state
        # K consecutive bad steps: the trajectory is lost, not one cosmic ray
        self.rollbacks_done += 1
        if self.rollbacks_done > self.max_rollbacks:
            raise RuntimeError(
                f"[{self.log_name}] non_finite_policy=rollback exceeded "
                f"Training.non_finite_max_rollbacks={self.max_rollbacks}: "
                "the run keeps diverging after restore+LR-backoff. Lower "
                "the learning rate or inspect the data."
            )
        if self.restore_fn is None:
            raise RuntimeError(
                f"[{self.log_name}] non_finite_policy=rollback triggered "
                f"({consec} consecutive skips) but no checkpoint restore "
                "path is wired. Enable Training.Checkpoint so a verified "
                "checkpoint exists to roll back to."
            )
        state = self.restore_fn(state)
        _emit_event(EV_GUARD_ROLLBACK, severity="error", epoch=epoch,
                    rollback=self.rollbacks_done, max_rollbacks=self.max_rollbacks)
        lr = float(state.learning_rate) * self.lr_backoff**self.rollbacks_done
        state = state.with_learning_rate(lr)
        # the restored checkpoint carries its own (older) counters
        self._prev_skipped = int(state.skipped_steps)
        _say(f"[{self.log_name}] rollback {self.rollbacks_done}/{self.max_rollbacks}: "
             f"restored last verified checkpoint, learning rate backed off to {lr:.3e}")
        return state
