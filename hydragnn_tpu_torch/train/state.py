"""Training state: the model, its optimizer, the step counters and the
guard's copies.

Counterpart of ``hydragnn_tpu/train/state.py`` ``TrainState``. The
parameters and batch-norm buffers live in the model, the moments in the
optimizer; ``held`` lists every tensor a step may change. ``step`` and the
guard's ``skipped_steps`` (total) and ``consecutive_skips`` (reset by any
good step) are int64 tensors on the model's device, advanced there by the
train step. ``guard`` holds the non-finite step guard's copies of
``held`` (train/guard.py), made once here; None turns the guard off.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..device import module_device
from .guard import StepCopies, held_tensors


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: torch.Tensor
    skipped_steps: torch.Tensor
    consecutive_skips: torch.Tensor
    held: List[torch.Tensor]
    guard: Optional[StepCopies]

    @staticmethod
    def create(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               guard: bool = True) -> "TrainState":
        """The state of a fresh run; ``guard`` (on by default) makes the
        non-finite step guard's copies, so every train step is guarded."""
        dev = module_device(model)
        zero = lambda: torch.zeros((), dtype=torch.int64, device=dev)  # noqa: E731
        held = held_tensors(model, optimizer)
        return TrainState(model, optimizer, zero(), zero(), zero(), held,
                          StepCopies(held) if guard else None)

    @property
    def learning_rate(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    def with_learning_rate(self, lr: float) -> "TrainState":
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)
        return self

    def _counters(self) -> List[torch.Tensor]:
        return [self.step, self.skipped_steps, self.consecutive_skips]

    def state_dict(self):
        """A copy of everything a step changes (``held``, the counters) and
        the learning rate, for ``load_state_dict``."""
        return {"tensors": [t.clone() for t in self.held + self._counters()],
                "lr": self.learning_rate}

    @torch.no_grad()
    def load_state_dict(self, sd) -> None:
        """Copy ``sd`` back in place (the guard's copies stay valid)."""
        torch._foreach_copy_(self.held + self._counters(), sd["tensors"])
        self.with_learning_rate(sd["lr"])
