"""Optimizer selection with optax's defaults, global-norm clipping, the
frozen conv stack and the plateau schedule.

Counterpart of ``hydragnn_tpu/train/optimizer.py``. Each ``Optimizer.type``
maps to its ``torch.optim`` class with the defaults of the optax
transform the JAX package builds, not torch's: AdamW's weight decay is
optax's 1e-4 (torch's default is 1e-2), decoupled and applied to every
parameter; Adam and AdamW take eps 1e-8 and betas (0.9, 0.999); SGD has no
momentum. On the card the step count stays on the device (``capturable``),
so an update never waits on the host. The other optax types of the JAX
package come with a later slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Sequence

import torch

# top-level modules whose parameters Architecture.freeze_conv_layers keeps
# fixed (the JAX package's freeze_conv_mask prefixes)
_FROZEN_PREFIXES = ("graph_convs", "feature_layers", "conv", "radial_embedding",
                    "node_embedding")

# Optimizer.type -> (torch.optim class, optax's defaults in torch's names)
_OPT_TABLE = {
    "AdamW": (torch.optim.AdamW, dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)),
    "Adam": (torch.optim.Adam, dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)),
    "SGD": (torch.optim.SGD, dict(momentum=0.0, weight_decay=0.0)),
}
_LATER_SLICES = ("Adadelta", "Adagrad", "Adamax", "RMSprop", "FusedLAMB", "LAMB")


def frozen(name: str) -> bool:
    """Whether the parameter ``name`` (a torch state-dict name) belongs to
    the conv stack that ``freeze_conv`` keeps fixed."""
    return any(name.split(".", 1)[0].startswith(p) for p in _FROZEN_PREFIXES)


def make_optimizer(model: torch.nn.Module, opt_config: Dict[str, Any],
                   freeze_conv: bool = False) -> torch.optim.Optimizer:
    """The ``Optimizer`` section's optimizer over ``model``'s parameters
    (without the conv stack's under ``freeze_conv``: the optax mask zeroes
    their updates, so they never move), its state created now, as optax's
    ``init`` does. Its ``clip_grad_norm`` attribute (the section's
    ``clip_grad_norm``, 0: off) is applied by the train step before the
    update."""
    kind = opt_config.get("type", "AdamW")
    if kind in _LATER_SLICES:
        raise NotImplementedError(
            f"Optimizer.type {kind!r} comes with a later slice of the port; "
            f"this slice carries {sorted(_OPT_TABLE)}"
        )
    if kind not in _OPT_TABLE:
        raise ValueError(f"unknown optimizer {kind!r}; known: {sorted(_OPT_TABLE)}")
    cls, defaults = _OPT_TABLE[kind]
    params = [p for n, p in model.named_parameters() if not (freeze_conv and frozen(n))]
    on_card = bool(params) and params[0].device.type == "cuda"
    kw = dict(defaults, lr=float(opt_config.get("learning_rate", 1e-3)))
    if cls is not torch.optim.SGD:
        kw["capturable"] = on_card
    opt = cls(params, foreach=on_card, **kw)
    _init_state(opt)
    opt.clip_grad_norm = float(opt_config.get("clip_grad_norm", 0.0) or 0.0)
    return opt


def _init_state(opt: torch.optim.Optimizer) -> None:
    """Create Adam's moments and step count before the first step, where
    ``torch.optim`` would make them lazily (the train step's guard keeps a
    copy of the state it may have to restore). SGD without momentum keeps
    no state."""
    if not isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
        return
    for group in opt.param_groups:
        for p in group["params"]:
            step_device = p.device if group["capturable"] else "cpu"
            opt.state[p] = {
                "step": torch.zeros((), dtype=torch.float32, device=step_device),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
            }


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32, on the device
    (optax.global_norm)."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_grad_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm, in place: every gradient scaled by
    ``max_norm / norm`` when the global norm reaches ``max_norm``, left as
    it is otherwise; no host sync."""
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


def optimizer_step(opt: torch.optim.Optimizer, grads: List[torch.Tensor]) -> None:
    """The update of one step from the gradients already on the parameters
    (``grads``): the optimizer's global-norm clip, if set, then its step
    (optax's chain order)."""
    if opt.clip_grad_norm > 0.0:
        clip_grad_norm(grads, opt.clip_grad_norm)
    opt.step()


def state_tensors(opt: torch.optim.Optimizer) -> Iterable[torch.Tensor]:
    """Every tensor of the optimizer's state (moments and step counts)."""
    for st in opt.state.values():
        for v in st.values():
            if torch.is_tensor(v):
                yield v


@dataclasses.dataclass
class ReduceLROnPlateau:
    """Host-side plateau scheduler with torch semantics (mode min, factor
    0.5, patience 5, min_lr 1e-5), stepped on the validation loss once per
    epoch."""

    factor: float = 0.5
    patience: int = 5
    min_lr: float = 1e-5
    best: float = float("inf")
    bad_epochs: int = 0

    def step(self, val_loss: float, current_lr: float) -> float:
        if val_loss < self.best:
            self.best = val_loss
            self.bad_epochs = 0
            return current_lr
        self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.bad_epochs = 0
            return max(current_lr * self.factor, self.min_lr)
        return current_lr
