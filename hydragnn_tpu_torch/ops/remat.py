"""Rematerialization policies (``Training.remat_policy``).

Counterpart of ``hydragnn_tpu/ops/remat.py`` on ``torch.utils.checkpoint``
(non-reentrant). ``Training.remat_policy`` names one save rule for every
remat wrap:

- ``full`` (default): recompute everything inside the wrap in the backward;
- ``dots``: a selective-checkpoint policy
  (``torch.utils.checkpoint.create_selective_checkpoint_contexts``) that
  saves the outputs of ``mm`` / ``addmm`` / ``bmm`` and recomputes the rest;
- ``names``: save only the kernels' outputs (``KERNEL_OUTPUT_NAMES``) and
  recompute the rest: a selective-checkpoint policy that saves the outputs
  of the kernels' operators. Each wrapper reaches its kernel through a
  ``torch.library`` operator (``hydragnn::<name>``) inside its
  ``autograd.Function``, so the dispatcher, and the policy, see the launch
  (its ``ctypes`` call alone they would not); a recompute gets the saved
  output back and launches nothing. On the CPU the same operators run the
  plain versions, so the policy behaves the same there;
- ``none``: the kernel call sites are left unwrapped; the whole-loss
  ``conv_checkpointing`` wrap takes ``full`` (the flag asks for a
  checkpoint).

The kernel call sites (``at_site``: K2 in ``models/layers.py``, K3 in
``ops/segment.py``, K4 in ``models/gps.py``) take the policy of the train
step they run in (``site_policy``, entered by ``train/loop.py step_on``
from the model's ``remat_policy``). They differ from the JAX package's
in one way. Each port kernel's ``Function`` saves only its inputs and
recomputes its plain reference in the backward (``recompute_backward``):
it already is the JAX package's ``full`` wrap of that site, whose
checkpoint keeps the operands and recomputes the tangent rule's [E, C]
residuals. So at a kernel site ``full`` leaves the call as it is (a
checkpoint around it would only launch the kernel again in the backward,
for an output the Function's backward never reads), and so does ``none``:
the port has no route that keeps the tangent rule's residuals, which is
what the JAX package's unwrapped call stores. ``dots`` and ``names`` wrap
the site (its operand casts and the kernel) with their save rules:
``dots`` finds no product outside the Function and recomputes the casts
and the kernel; ``names`` keeps the kernel's output and recomputes only
the casts. No policy changes a value: the recompute runs the same
operations on the same inputs (with atomics in the forward, such as
``index_add_``, only to within their run-to-run spread;
``torch.use_deterministic_algorithms(True)`` makes them exact).

In a recompute the batch norms leave their running statistics alone
(``recomputing()``): the forward already moved them once.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable

import torch

REMAT_POLICIES = ("none", "dots", "names", "full")

# the kernels' outputs, the save set of the ``names`` policy: the operator
# ``hydragnn::<name>`` of each kernel entry point (K1, K2, K3, K4, K4b)
KERNEL_OUTPUT_NAMES = (
    "segment_sum",          # K1 ops/sorted_segment.py
    "fused_edge_sum",       # K2 ops/fused_edge.py
    "multi_agg_moments",    # K3 ops/multi_agg.py
    "flash_attention_out",  # K4 ops/flash_attention.py
    "flash_block_summary",  # K4b ops/flash_attention.py
)

_local = threading.local()


def _check(policy: str) -> None:
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r} must be one of {REMAT_POLICIES}")


def recomputing() -> bool:
    """Whether the current forward is (inside) a checkpoint's recompute."""
    return getattr(_local, "recompute", 0) > 0


@contextlib.contextmanager
def _recompute_pass(inner):
    """A checkpoint's recompute: ``inner`` (its selective policy's context)
    entered, ``recomputing()`` true."""
    _local.recompute = getattr(_local, "recompute", 0) + 1
    try:
        with inner:
            yield
    finally:
        _local.recompute -= 1


def _saved_ops(policy: str) -> tuple:
    """The operators whose outputs ``policy`` (``dots`` or ``names``) saves."""
    if policy == "dots":
        aten = torch.ops.aten
        return aten.mm.default, aten.addmm.default, aten.bmm.default
    from . import flash_attention, fused_edge, multi_agg, sorted_segment  # noqa: F401

    return tuple(getattr(torch.ops.hydragnn, name).default for name in KERNEL_OUTPUT_NAMES)


def _context_fn(policy: str) -> Callable:
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    saved = _saved_ops(policy) if policy in ("dots", "names") else None

    def save_rule(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    def context_fn():
        if saved is None:
            return contextlib.nullcontext(), _recompute_pass(contextlib.nullcontext())
        fwd, rec = create_selective_checkpoint_contexts(save_rule)
        return fwd, _recompute_pass(rec)

    return context_fn


def _checkpointed(fn: Callable, policy: str) -> Callable:
    from torch.utils.checkpoint import checkpoint

    context_fn = _context_fn(policy)

    def wrapped(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn, **kwargs)

    wrapped.remat_policy = policy
    return wrapped


@contextlib.contextmanager
def site_policy(policy: str):
    """The policy of the kernel call sites in the block (``step_on`` runs
    the train step's forward under ``Training.remat_policy``); outside
    one, ``full``."""
    _check(policy)
    prev = getattr(_local, "site", "full")
    _local.site = policy
    try:
        yield
    finally:
        _local.site = prev


def at_site(fn: Callable, *args):
    """``fn(*args)`` at a kernel call site, wrapped per the policy of the
    enclosing ``site_policy`` (``kernel_remat``)."""
    return kernel_remat(fn, getattr(_local, "site", "full"))(*args)


def kernel_remat(fn: Callable, policy: str = "full") -> Callable:
    """Remat wrap for a kernel call site: ``fn`` as it is under ``none``
    and ``full`` (its kernel's Function already recomputes in the backward,
    see the module docstring), checkpointed with the save rule of ``dots``
    or ``names``."""
    _check(policy)
    if policy in ("none", "full"):
        return fn
    return _checkpointed(fn, policy)


def loss_remat(fn: Callable, policy: str = "full") -> Callable:
    """Remat wrap for the whole loss under ``conv_checkpointing``:
    checkpointed with the policy's save rule (``none`` and ``full``:
    recompute everything)."""
    _check(policy)
    return _checkpointed(fn, "full" if policy == "none" else policy)
