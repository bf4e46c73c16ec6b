"""Sequence (node) parallel training and evaluation: one spanning graph per
batch.

Counterpart of ``hydragnn_tpu/parallel/sp.py`` (``sp_context``,
``current_sp``, ``shard_sp_batch``, ``make_sp_train_step``,
``make_sp_eval_step``). Inside an SP
context, GPS global attention with ``global_attn_type: "ring"`` computes
exact softmax attention over every real node of the batch through
``parallel/ring_attention.py``; outside one, the same module falls back to
dense masked attention, the same math, so one set of weights serves both.

This port runs the ring on one rank (``group=None``: one block, the whole
graph on one card, attention memory O(N * C) through the block-summary
kernel instead of the dense route's O(H * N^2)). The JAX package's GSPMD
partition of convs, norms and pools across ranks is not ported:
``shard_sp_batch`` raises for a group of more than one rank.
``ring_self_attention`` itself rotates K/V blocks over any group.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Tuple

import torch
import torch.distributed as dist

from ..device import DeviceLike, module_device, resolve_device
from ..train.loop import step_on
from ..train.loss import multitask_loss

_ctx = threading.local()


def current_sp() -> Tuple[bool, object]:
    """(active, group) of the SP context: whether one is active, and its
    process group (None: a ring of one rank). Read by the ring-attention
    module at call time."""
    return getattr(_ctx, "active", False), getattr(_ctx, "group", None)


@contextlib.contextmanager
def sp_context(group=None):
    prev = current_sp()
    _ctx.active, _ctx.group = True, group
    try:
        yield
    finally:
        _ctx.active, _ctx.group = prev


def shard_sp_batch(batch, group=None, device: DeviceLike = None):
    """Place a spanning-graph batch for SP evaluation on ``device`` (the
    current CUDA device when None). A ring of one rank holds the whole
    batch; a group of more than one rank raises ``NotImplementedError``."""
    ranks = 1 if group is None else dist.get_world_size(group)
    if ranks > 1:
        raise NotImplementedError(
            f"SP over {ranks} ranks comes with the port's SP-across-ranks slice (a later "
            "slice, after the multi-GPU one): "
            "the partition of convs, norms and pools across ranks is not ported; "
            "the port runs the ring on one rank (group=None)"
        )
    return batch.to(resolve_device(device))


def make_sp_train_step(model, state, group=None, compute_grad_energy: bool = False):
    """``step(batch) -> (state, loss, per-task losses)`` for one spanning
    graph per batch: the batch placed by ``shard_sp_batch`` on the model's
    device, the train-mode forward and its loss inside ``sp_context(group)``
    (ring attention over the group), the backward, and one step of
    ``state``'s optimizer; the batch-norm statistics are the train-mode
    forward's. As in the JAX package, no step guard (``state``'s guard
    copies, if any, are not used: ``TrainState.create(..., guard=False)``
    makes none). ``state`` is updated in place."""
    dev = module_device(model)

    def step(batch):
        batch = shard_sp_batch(batch, group, dev)
        with sp_context(group):
            return step_on(state, model, batch, compute_grad_energy=compute_grad_energy,
                           guard=False)

    return step


def make_sp_eval_step(model, group=None, device: DeviceLike = None):
    """``evalf(batch) -> (total loss, per-task losses, outputs)`` for one
    spanning graph per batch: the model on ``device`` (the current CUDA
    device when None), the batch placed by ``shard_sp_batch``, the forward
    inside ``sp_context(group)`` under ``torch.inference_mode``."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    cfg = model.cfg

    def evalf(batch):
        batch = shard_sp_batch(batch, group, dev)
        with torch.inference_mode(), sp_context(group):
            outputs = model(batch)
            tot, tasks = multitask_loss(outputs, batch, cfg)
        return tot, tasks, outputs

    return evalf
