"""Optimizer selection with optax's defaults, global-norm clipping, the
frozen conv stack and the plateau schedule.

Counterpart of ``hydragnn_tpu/train/optimizer.py``: the nine
``Optimizer.type``s of the JAX package, each with the semantics and
defaults of the optax transform the JAX package builds, not torch's.

- AdamW, Adam and SGD are their ``torch.optim`` classes: AdamW's weight
  decay is optax's 1e-4 (torch's default is 1e-2), decoupled and applied
  to every parameter; Adam and AdamW take eps 1e-8 and betas
  (0.9, 0.999); SGD has no momentum. On the card the step count stays on
  the device (``capturable``), so an update never waits on the host.
- Adagrad, RMSprop, Adamax, Adadelta, LAMB and FusedLAMB (LAMB, as the JAX
  package maps it) are ``OptaxRule``, written here, because torch's
  classes differ from optax: torch's Adagrad starts its accumulator at 0
  and adds eps outside the root (optax: 0.1, and ``rsqrt(acc + 1e-7)``);
  torch's RMSprop decays by 0.99 and adds eps outside the root (optax:
  0.9, ``rsqrt(nu + 1e-8)``); torch has no LAMB. Adamax and Adadelta
  follow optax's formulas too (torch's agree on them, bar Adadelta's
  default learning rate, which the config always sets).
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
# Optimizer.type -> OptaxRule kind
_RULES = {"Adagrad": "adagrad", "RMSprop": "rmsprop", "Adamax": "adamax",
          "Adadelta": "adadelta", "LAMB": "lamb", "FusedLAMB": "lamb"}


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
    if kind not in _OPT_TABLE and kind not in _RULES:
        raise ValueError(f"unknown optimizer {kind!r}; known: "
                         f"{sorted(list(_OPT_TABLE) + list(_RULES))}")
    params = [p for n, p in model.named_parameters() if not (freeze_conv and frozen(n))]
    lr = float(opt_config.get("learning_rate", 1e-3))
    if kind in _RULES:
        opt = OptaxRule(params, _RULES[kind], lr=lr)
    else:
        cls, defaults = _OPT_TABLE[kind]
        on_card = bool(params) and params[0].device.type == "cuda"
        kw = dict(defaults, lr=lr)
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


class OptaxRule(torch.optim.Optimizer):
    """The optax transforms torch has no match for, with optax's defaults;
    every state tensor made at construction (optax's ``init``), on the
    parameters' device, the step count included (so no update waits on the
    host, and the guard's copies cover it). ``kind``:

    - ``adagrad``: ``acc += g^2`` from 0.1; ``u = g rsqrt(acc + 1e-7)``
      where ``acc > 0``;
    - ``rmsprop``: ``nu = 0.9 nu + 0.1 g^2`` from 0; ``u = g rsqrt(nu +
      1e-8)``;
    - ``adamax``: ``mu = 0.9 mu + 0.1 g``, ``nu = max(|g| + 1e-8, 0.999
      nu)``; ``u = mu / (1 - 0.9^t) / nu``;
    - ``adadelta``: ``e_g = 0.9 e_g + 0.1 g^2``; ``u = sqrt(e_x + 1e-6) /
      sqrt(e_g + 1e-6) g``; ``e_x = 0.9 e_x + 0.1 u^2``;
    - ``lamb``: Adam's direction (b1 0.9, b2 0.999, eps 1e-6, bias
      corrected), then each tensor's trust ratio ``|p| / |u|`` (1 where
      either norm is 0), weight decay 0;

    and then ``p -= lr u``. A placed state's optimizer may hold only a
    slice of a tensor (ZeRO, parallel/engine.py): ``norm_group`` maps such
    a slice to the process group whose slices make the tensor, over which
    LAMB sums its squared norms."""

    _STATE = {"adagrad": ("sum_of_squares",), "rmsprop": ("nu",),
              "adamax": ("step", "mu", "nu"), "adadelta": ("e_g", "e_x"),
              "lamb": ("step", "mu", "nu")}

    def __init__(self, params, kind: str, lr: float):
        if kind not in self._STATE:
            raise ValueError(f"unknown rule {kind!r}")
        super().__init__(params, dict(lr=lr))
        self.kind = kind
        self.norm_group: Dict[int, Any] = {}
        for group in self.param_groups:
            for p in group["params"]:
                st = {}
                for k in self._STATE[kind]:
                    if k == "step":
                        st[k] = torch.zeros((), dtype=torch.float32, device=p.device)
                    elif k == "sum_of_squares":
                        st[k] = torch.full_like(p, 0.1, memory_format=torch.preserve_format)
                    else:
                        st[k] = torch.zeros_like(p, memory_format=torch.preserve_format)
                self.state[p] = st

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.sub_(self._direction(p, p.grad, self.state[p]) * group["lr"])

    def _direction(self, p, g, st):
        """The update direction ``u`` of ``p`` (its state advanced in
        place)."""
        kind = self.kind
        if kind == "adagrad":
            acc = st["sum_of_squares"].add_(g * g)
            return torch.where(acc > 0, torch.rsqrt(acc + 1e-7), torch.zeros_like(acc)) * g
        if kind == "rmsprop":
            nu = st["nu"].mul_(0.9).add_(g * g * 0.1)
            return torch.rsqrt(nu + 1e-8) * g
        if kind == "adadelta":
            e_g = st["e_g"].mul_(0.9).add_(g * g * 0.1)
            u = torch.sqrt(st["e_x"] + 1e-6) / torch.sqrt(e_g + 1e-6) * g
            st["e_x"].mul_(0.9).add_(u * u * 0.1)
            return u
        t = st["step"].add_(1)
        mu = st["mu"].mul_(0.9).add_(0.1 * g)
        mu_hat = mu / (1 - torch.pow(0.9, t))
        if kind == "adamax":
            nu = torch.maximum(g.abs() + 1e-8, 0.999 * st["nu"])
            st["nu"].copy_(nu)
            return mu_hat / nu
        nu = st["nu"].mul_(0.999).add_(g * g * 0.001)
        u = mu_hat / (torch.sqrt(nu / (1 - torch.pow(0.999, t))) + 1e-6)
        p_norm, u_norm = self._norms(p, u)
        ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                            p_norm / u_norm)
        return u * ratio

    def _norms(self, p, u):
        group = self.norm_group.get(id(p), False)
        if group is False:
            return torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
        return _norms_of(p, u, group)


def _norms_of(p, u, group):
    """The norms of ``p`` and ``u``, squared sums added over ``group`` when
    ``p`` is one slice of a tensor."""
    import torch.distributed as dist

    sq = torch.stack([p.float().pow(2).sum(), u.float().pow(2).sum()])
    dist.all_reduce(sq, group=group)
    return sq[0].sqrt(), sq[1].sqrt()


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
