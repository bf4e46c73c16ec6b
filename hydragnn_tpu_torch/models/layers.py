"""Shared building blocks: dense layers, MLP, masked batch norm, activations,
and the factored EGNN edge layer in its unfused and fused spellings.

Counterpart of ``hydragnn_tpu/models/layers.py``. Parameter names follow the
flax tree (``Dense_<i>`` inside an MLP, ``scale``/``bias`` and the
``mean``/``var``/``count`` statistics of a batch norm) so ``bridge.py`` maps
a JAX checkpoint one to one; a torch ``weight`` is the flax ``kernel``
transposed to ``[out, in]``.

Dtypes follow flax: a dense layer computes in the common dtype of its input
and its parameters, so an f32 input against bf16 parameters runs in f32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..obs.numerics import collection_active, probe
from ..ops.remat import at_site, recomputing
from ..ops.segment import fused_edge_message_sum

# init kinds: ("lecun",) flax's lecun_normal; ("mirror",) its mirrored (w, -w)
# column pairs; ("variance_scaling", scale) fan_avg uniform
Init = Tuple


def _promote(*ts):
    dt = ts[0].dtype
    for t in ts[1:]:
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    return dt


def dense(x, weight, bias=None):
    """``x @ weight.T + bias`` in the common dtype of the three (flax Dense
    promotion). ``weight`` is ``[out, in]``."""
    dt = _promote(x, weight, bias)
    return F.linear(x.to(dt), weight.to(dt), None if bias is None else bias.to(dt))


def _lecun_normal_(w, fan_in: int, gen: torch.Generator):
    # flax lecun_normal: truncated normal on [-2, 2] scaled to variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        w.mul_(std)


def init_dense_weight_(w, init: Init, gen: torch.Generator) -> None:
    """Fill a ``[out, in]`` (or banked ``[B, out, in]``, ``[B, P, out, in]``)
    weight in place."""
    if w.dim() > 2:
        for b in range(w.shape[0]):
            init_dense_weight_(w[b], init, gen)
        return
    fan_out, fan_in = w.shape
    kind = init[0]
    if kind == "lecun":
        _lecun_normal_(w, fan_in, gen)
    elif kind == "mirror":
        # mirrored_lecun_normal (hydragnn_tpu/models/layers.py): output units
        # in (w, -w) pairs, so for any input with w.x != 0 one unit of each
        # pair is active and no seed can draw a fully ReLU-dead layer
        half = (fan_out + 1) // 2
        base = torch.empty(half, fan_in)
        _lecun_normal_(base, fan_in, gen)
        with torch.no_grad():
            w.copy_(torch.cat([base, -base[: fan_out - half]], dim=0))
    elif kind == "variance_scaling":
        limit = math.sqrt(3.0 * init[1] / ((fan_in + fan_out) / 2.0))
        with torch.no_grad():
            w.uniform_(-limit, limit, generator=gen)
    else:
        raise ValueError(f"unknown init {init!r}")


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` [out, in], optional ``bias`` [out]
    (zeros at init)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 init: Init = ("lecun",)):
        super().__init__()
        self.init = init
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        init_dense_weight_(self.weight, self.init, gen)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        return dense(x, self.weight, self.bias)


class BankedDense(nn.Module):
    """A dense layer lifted over the branch axis: ``weight`` [B, out, in],
    ``bias`` [B, out], each branch initialized on its own (the flax
    ``nn.vmap`` branch bank of models/base.py). A 2-D input ``[R, in]`` is
    broadcast to every branch; a 3-D ``[B, R, in]`` input is mapped branch
    by branch. Returns ``[B, R, out]``.

    ``num_branches`` ``(B, P)`` adds a second bank axis (``weight``
    [B, P, out, in]: ``mlp_per_node``'s one layer per node position): then
    ``rows`` [R] picks the bank entry of each input row."""

    def __init__(self, num_branches, in_dim: int, out_dim: int,
                 init: Init = ("lecun",)):
        super().__init__()
        self.init = init
        bank = tuple(num_branches) if isinstance(num_branches, (tuple, list)) else (num_branches,)
        self.weight = nn.Parameter(torch.empty(*bank, out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(*bank, out_dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        init_dense_weight_(self.weight, self.init, gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x, rows=None):
        dt = _promote(x, self.weight, self.bias)
        w, b = self.weight.to(dt), self.bias.to(dt)
        if rows is not None:  # [B, R, out, in]: each row's own layer
            w, b = w[:, rows], b[:, rows]
            eq = "ri,broi->bro" if x.dim() == 2 else "bri,broi->bro"
            return torch.einsum(eq, x.to(dt), w) + b
        eq = "ri,boi->bro" if x.dim() == 2 else "bri,boi->bro"
        return torch.einsum(eq, x.to(dt), w) + b[:, None, :]


def leaky_relu(v, negative_slope: float = 0.01):
    """flax's ``leaky_relu``: ``where(v >= 0, v, slope * v)``, whose
    gradient at 0 is 1 (PyTorch's ``F.leaky_relu`` takes the slope there).
    A ReLU layer's zero outputs (a dead unit, a zero bias) meet it at
    exactly 0."""
    # the slope in v's dtype, filled on v's device (``torch.tensor`` there
    # would copy it from the host and sync the stream)
    return torch.where(v >= 0, v, v.new_full((), negative_slope) * v)


ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda v: F.gelu(v, approximate="tanh"),  # flax nn.gelu default
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "elu": F.elu,
    "leaky_relu": leaky_relu,
    "softplus": F.softplus,
    "identity": lambda v: v,
}


def get_activation(name: str) -> Callable:
    try:
        return ACTIVATIONS[name.lower()]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}; known: {sorted(ACTIVATIONS)}")


class MLP(nn.Module):
    """Dense stack with the activation between layers and none after the
    last (unless ``final_activation``). ``mirror_init`` draws every
    activated layer with the mirrored init; ``recovery_slope`` > 0 turns a
    relu activation into leaky relu with that slope (the decoder settings).
    ``num_branches`` makes every layer a ``BankedDense`` (``rows`` then
    picks each row's entry of a two-axis bank)."""

    def __init__(self, in_dim: int, features: Sequence[int], activation: str = "relu",
                 final_activation: bool = False, mirror_init: bool = False,
                 recovery_slope: float = 0.0, num_branches: Optional[int] = None):
        super().__init__()
        self.features = tuple(features)
        self.final_activation = final_activation
        act = get_activation(activation)
        if recovery_slope and activation.lower() == "relu":
            act = lambda v, s=recovery_slope: leaky_relu(v, s)
        self.act = act
        d = in_dim
        for i, f in enumerate(self.features):
            last = i == len(self.features) - 1
            init = ("mirror",) if mirror_init and (not last or final_activation) else ("lecun",)
            layer = (Dense(d, f, init=init) if num_branches is None
                     else BankedDense(num_branches, d, f, init=init))
            self.add_module(f"Dense_{i}", layer)
            d = f

    def forward(self, x, rows=None):
        n = len(self.features)
        for i in range(n):
            layer = getattr(self, f"Dense_{i}")
            x = layer(x) if rows is None else layer(x, rows)
            if i < n - 1 or self.final_activation:
                x = self.act(x)
        return x


class MaskedBatchNorm(nn.Module):
    """Batch norm over real nodes. Training normalizes with the batch's
    masked statistics and updates the running ones (buffers ``mean``,
    ``var``, ``count``, as in the flax ``batch_stats`` collection) by the
    JAX module's count-weighted EMA; eval normalizes with the running
    statistics."""

    momentum = 0.9
    # the flax module path its numerics tap is named by (``name_probes``)
    probe_path = "batchnorm"

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.register_buffer("count", torch.zeros(()))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x, mask=None, train: bool = False):
        if train:
            # the statistics over the rows of ``mask``, in the activations'
            # dtype, as the JAX module computes them
            m = mask[:, None].to(x.dtype)
            n = torch.clamp(m.sum(), min=1.0)
            mean = (x * m).sum(dim=0) / n
            var = (((x - mean) ** 2) * m).sum(dim=0) / n
            self._update_running(n, mean, var)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) / torch.sqrt(var + self.epsilon)
        y = y * self.scale + self.bias
        # numerics tap (obs/numerics.py): the normalized output, one layer
        # before the activation tap sees a collapsing variance
        if collection_active():
            probe(f"bn:{self.probe_path}", y, mask)
        return y

    @torch.no_grad()
    def _update_running(self, n, mean, var) -> None:
        """Count-weighted EMA: a batch with few real rows moves the running
        statistics proportionally less (for constant batch sizes the torch
        BatchNorm1d update). The buffers keep their own dtype (f32 under
        mixed precision, whatever the activations'). A remat recompute
        (ops/remat.py) leaves them alone: its forward moved them once."""
        if recomputing():
            return
        count = self.count.float()
        # (1 - momentum) * n in n's dtype, then widened, as jnp promotes it
        c_new = self.momentum * count + ((1 - self.momentum) * n).float()
        w_old = self.momentum * count / torch.clamp(c_new, min=1e-8)
        w_new = 1.0 - w_old
        self.mean.copy_(w_old * self.mean.float() + w_new * mean.float())
        self.var.copy_(w_old * self.var.float() + w_new * var.float())
        self.count.copy_(c_new)


def name_probes(model: nn.Module) -> None:
    """Name every batch norm's numerics tap by its module's flax path
    (``feature_layers_0``, as the JAX package names ``bn:{path}``)."""
    from ..bridge import flax_path

    for name, m in model.named_modules():
        if isinstance(m, MaskedBatchNorm):
            m.probe_path = flax_path(f"{name}.scale")[0].rsplit("/", 1)[0]


def pair_message_factored(recv, send, inv, batch, terms=()):
    """The factored first edge-MLP layer: a node-sized receiver projection
    ``recv(inv)`` [N, C] (carrying the one bias) and one edge-aligned
    operand: the bias-free sender projection ``send(inv)`` gathered by
    ``senders`` plus a bias-free projection of every ``(module, [E, d])``
    entry of ``terms``. Returns ``(node_recv, edge_in)``."""
    node_recv = recv(inv)
    edge_in = send(inv)[batch.senders]
    for module, arr in terms:
        edge_in = edge_in + module(arr)
    return node_recv, edge_in


def hoisted_pair_dense(recv, send, inv, batch, terms=()):
    """``Dense(concat[x_i, x_j, e...])`` computed on node-sized operands
    before the edge gather: ``node_recv[receivers] + edge_in``, with the
    receiver projection ``recv`` (carrying the bias) and the bias-free
    sender projection ``send``."""
    node_recv, edge_in = pair_message_factored(recv, send, inv, batch, terms)
    return node_recv[batch.receivers] + edge_in


def fused_pair_dense_sum(layer, inv, batch, terms=(), max_in_degree: int = 0):
    """The whole edge path ``hoisted_pair_dense -> relu -> edge_lin2 -> relu
    -> segment_sum`` as one op (K2 on the card), with the same parameters as
    the unfused spelling: ``edge_lin2`` is an ordinary ``Dense`` whose
    weight the fused op reads transposed."""
    node_recv, edge_in = pair_message_factored(layer.edge_lin_recv, layer.edge_lin_send,
                                               inv, batch, terms)
    lin2 = layer.edge_lin2
    dt = _promote(node_recv, edge_in, lin2.weight, lin2.bias)

    def call(nr, ei, w, b):  # the remat site (ops/remat.py): casts and K2
        return fused_edge_message_sum(
            nr.to(dt).contiguous(), ei.to(dt).contiguous(), w.to(dt).t().contiguous(),
            b.to(dt).contiguous(), batch.receivers, batch.num_nodes, max_in_degree,
        )

    return at_site(call, node_recv, edge_in, lin2.weight, lin2.bias)


def glorot_uniform_(w, gen: torch.Generator) -> None:
    """flax's ``glorot_uniform`` in place on a parameter laid out as in the
    flax tree: the last two axes are (fan in, fan out), any leading axes
    multiply both fans (a bank of ``w.shape[0]`` matrices counts as one
    receptive field of that size)."""
    receptive = w.numel() // (w.shape[-2] * w.shape[-1])
    fan_in, fan_out = w.shape[-2] * receptive, w.shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-limit, limit, generator=gen)


class OwnInit:
    """Marks a module holding parameters of its own beside its layers (a
    weight bank, an attention vector): its ``reset_parameters(gen)``
    initializes those, and its layers are initialized as layers."""


def reset_parameters(module: nn.Module, gen: torch.Generator) -> None:
    """Initialize every layer of ``module`` from ``gen``, in registration
    order (deterministic for a given seed)."""
    for m in module.modules():
        if isinstance(m, (Dense, BankedDense, MaskedBatchNorm, OwnInit)):
            m.reset_parameters(gen)
