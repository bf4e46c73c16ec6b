"""FLOPs of one train step per ladder level, the numerator of the MFU
estimate (obs/telemetry.py).

The JAX package reads an XLA executable's ``cost_analysis()`` per ladder
level; the port has no compiled executable. Here one train step's
forward and backward run once per level on ``meta`` tensors (shapes only:
no memory, no launch, no device time) under
``torch.utils.flop_counter.FlopCounterMode``, and the count is cached per
(model configuration, objective, level). On ``meta`` every kernel wrapper
takes its plain version, so the count is the same whichever route the
model runs on the card.

The convention: ``FlopCounterMode`` counts matrix products (``mm``,
``addmm``, ``bmm``, convolutions, attention), at 2 FLOPs a multiply-add,
and nothing elementwise; XLA's count also holds the elementwise work, so
the port's ``mfu_est`` is not the JAX package's number on other hardware.
The optimizer update is not counted. The step's remat wraps are
(``train_loss``: ``Training.conv_checkpointing`` under
``Training.remat_policy``, whose recompute adds its products), as the
JAX package's count holds its remat's: the cache key carries the model
configuration, the policy included, and the compile plane's report names
the policy beside the count.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Tuple

import torch

_CACHE: Dict[Tuple, float] = {}


def _signature(model, compute_grad_energy: bool, mixed_precision: bool, key) -> Tuple:
    return (type(model).__name__, repr(getattr(model, "cfg", None)),
            sum(p.numel() for p in model.parameters()), bool(compute_grad_energy),
            bool(mixed_precision), tuple(key))


def train_step_flops(model, batch, compute_grad_energy: bool = False,
                     mixed_precision: bool = False) -> float:
    """The matrix-product FLOPs of one train step (forward and backward,
    the optimizer excluded) of ``model`` on ``batch``'s shapes, counted on
    ``meta`` copies of both."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..train.loop import _apply_fn, cast_batch_bf16, train_loss

    with torch.inference_mode(False):
        meta = copy.deepcopy(model).to("meta")
        b = batch.to("meta")
        if mixed_precision:
            b = cast_batch_bf16(b, keep_pos=compute_grad_energy)
        apply = _apply_fn(meta, mixed_precision, cast_buffers=False)
        meta.train()
        with FlopCounterMode(display=False) as counter, torch.enable_grad():
            tot, _, _ = train_loss(apply, b, meta.cfg, compute_grad_energy)
            tot.float().backward()
    return float(counter.get_total_flops())


def train_flops_for(model, compute_grad_energy: bool = False,
                    mixed_precision: bool = False):
    """``flops_for(level key, host batch) -> FLOPs`` for
    ``StepTelemetry.attach_flops``, cached per level across runs of one
    process."""

    def flops_for(key, batch) -> Optional[float]:
        sig = _signature(model, compute_grad_energy, mixed_precision, key)
        if sig not in _CACHE:
            _CACHE[sig] = train_step_flops(model, batch, compute_grad_energy,
                                           mixed_precision)
        return _CACHE[sig]

    return flops_for


def cached() -> Dict[Tuple, Any]:
    """The cached counts (tests)."""
    return dict(_CACHE)
