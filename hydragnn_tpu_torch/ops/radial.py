"""Edge geometry, radial bases and cutoff envelopes.

Counterpart of ``hydragnn_tpu/ops/radial.py`` for what the port's convs
call: ``edge_vectors``; the Gaussian (SchNet), sinc (PAINN) and enveloped
Bessel (PNAPlus, PNAEq) bases; the cosine cutoff and the DimeNet envelope.

Each basis computes in the dtype of its distances and rounds where the JAX
functions round: a Python constant takes that dtype before it meets a
tensor (``_const``, as a weakly typed constant does in JAX, where PyTorch
would otherwise apply it in higher precision), an integer power is the
JAX package's chain of squarings (``_ipow``), and the Gaussian centres are
``jnp.linspace``'s. In f32 this changes nothing; in bf16 it gives the JAX
package's bits.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def edge_vectors(pos, senders, receivers, edge_shifts: Optional[torch.Tensor] = None,
                 eps: float = 1e-12) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-edge displacement r_j - r_i (+ PBC shift) and its length [E, 1].

    Lengths are clamped away from 0 so padding self-edges (sender ==
    receiver) stay finite; mask downstream with ``edge_mask``."""
    vec = pos[senders] - pos[receivers]
    if edge_shifts is not None:
        vec = vec + edge_shifts
    d2 = torch.sum(vec * vec, dim=-1, keepdim=True)
    length = torch.sqrt(torch.clamp(d2, min=eps))
    return vec, length


def _const(value: float, like):
    """``value`` as a 0-d tensor of ``like``'s dtype and device."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _ipow(x, y: int):
    """``x ** y`` for an integer ``y`` >= 1 by repeated squaring, rounding
    after each product as the JAX package's ``integer_pow`` does."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def _harmonics(r, num_basis: int, scale: float):
    """``n * scale`` for n = 1..num_basis, in ``r``'s dtype."""
    n = torch.arange(1, num_basis + 1, dtype=r.dtype, device=r.device)
    return n * _const(scale, n)


def bessel_basis(r, r_max: float, num_basis: int):
    """Spherical-Bessel radial basis sqrt(2/c) sin(n pi r / c) / r."""
    n = _harmonics(r, num_basis, math.pi / r_max)
    r = r.reshape(-1, 1)
    return _const(math.sqrt(2.0 / r_max), r) * torch.sin(n * r) / torch.clamp(r, min=1e-9)


def _linspace(start: float, stop: float, num: int, like):
    """``jnp.linspace(start, stop, num, dtype=like.dtype)``: the interior
    points as ``start * (1 - t) + stop * t`` with ``t = i / (num - 1)``
    taken in f32 and cast, the endpoint exact."""
    if num < 2:
        return torch.full((num,), start, dtype=like.dtype, device=like.device)
    t = (torch.arange(num - 1, dtype=torch.float32, device=like.device) / (num - 1)).to(like.dtype)
    one, lo, hi = (_const(v, like) for v in (1.0, start, stop))
    return torch.cat([lo * (one - t) + hi * t, hi[None]])


def gaussian_basis(r, r_max: float, num_basis: int, start: float = 0.0):
    """Gaussian-smeared distances, ``num_basis`` centres over [start, r_max]."""
    centers = _linspace(start, r_max, num_basis, r)
    width = (r_max - start) / max(num_basis - 1, 1)
    coeff = _const(-0.5 / (width * width), r)
    diff = r.reshape(-1, 1) - centers
    return torch.exp(coeff * diff * diff)


def sinc_expansion(r, r_max: float, num_basis: int):
    """sin(n pi r / r_max) / r (PAINN's radial filter input)."""
    n = _harmonics(r, num_basis, math.pi / r_max)
    r = r.reshape(-1, 1)
    return torch.sin(n * r) / torch.clamp(r, min=1e-9)


def cosine_cutoff(r, r_max: float):
    """0.5 (cos(pi r / r_max) + 1) for r < r_max, else 0."""
    inside = _const(0.5, r) * (torch.cos(_const(math.pi, r) * r / _const(r_max, r)) + 1.0)
    return torch.where(r < r_max, inside, torch.zeros((), dtype=r.dtype, device=r.device))


def dimenet_envelope(r_scaled, exponent: int = 5):
    """DimeNet envelope u(d) = 1/d + a d^(p-1) + b d^p + c d^(p+1), smooth
    to zero at d = 1; ``r_scaled`` is d = r / cutoff."""
    p = exponent + 1
    x = r_scaled
    a, b, c = (_const(v, x) for v in (-(p + 1) * (p + 2) / 2.0, p * (p + 2.0),
                                      -p * (p + 1) / 2.0))
    val = (_const(1.0, x) / torch.clamp(x, min=1e-9) + a * _ipow(x, p - 1) + b * _ipow(x, p)
           + c * _ipow(x, p + 1))
    return val * (x < 1.0)


def bessel_basis_enveloped(r, r_max: float, num_basis: int, envelope_exponent: int = 5):
    """DimeNet-style enveloped Bessel rbf env(d) sin(n pi d), d = r / r_max."""
    d = (r / _const(r_max, r)).reshape(-1, 1)
    n = _harmonics(r, num_basis, math.pi)
    return dimenet_envelope(d, envelope_exponent) * torch.sin(n * d)
