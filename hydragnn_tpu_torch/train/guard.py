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
per epoch.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

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
