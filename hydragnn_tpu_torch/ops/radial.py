"""Edge geometry, radial bases and cutoff envelopes.

Counterpart of ``hydragnn_tpu/ops/radial.py``: ``edge_vectors``; the
Gaussian (SchNet), sinc (PAINN), Bessel and Chebyshev (MACE) and enveloped
Bessel (PNAPlus, PNAEq, DimeNet) bases; the cosine, polynomial (MACE) and
DimeNet cutoff envelopes; MACE's Agnesi and Soft distance transforms over
the covalent radii; and ``radial_embedding``, MACE's basis x cutoff row.

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

import numpy as np
import torch

# Covalent radii in Angstrom indexed by atomic number 0..96 (element 0 is a
# placeholder): Cordero et al. 2008, the table ase.data.covalent_radii holds
COVALENT_RADII = np.array(
    [
        0.2, 0.31, 0.28, 1.28, 0.96, 0.84, 0.76, 0.71, 0.66, 0.57, 0.58,
        1.66, 1.41, 1.21, 1.11, 1.07, 1.05, 1.02, 1.06, 2.03, 1.76,
        1.70, 1.60, 1.53, 1.39, 1.39, 1.32, 1.26, 1.24, 1.32, 1.22,
        1.22, 1.20, 1.19, 1.20, 1.20, 1.16, 2.20, 1.95, 1.90, 1.75,
        1.64, 1.54, 1.47, 1.46, 1.42, 1.39, 1.45, 1.44, 1.42, 1.39,
        1.39, 1.38, 1.39, 1.40, 2.44, 2.15, 2.07, 2.04, 2.03, 2.01,
        1.99, 1.98, 1.98, 1.96, 1.94, 1.92, 1.92, 1.89, 1.90, 1.87,
        1.87, 1.75, 1.70, 1.62, 1.51, 1.44, 1.41, 1.36, 1.36, 1.32,
        1.45, 1.46, 1.48, 1.40, 1.50, 1.50, 2.60, 2.21, 2.15, 2.06,
        2.00, 1.96, 1.90, 1.87, 1.80, 1.69, 1.68,
    ],
    dtype=np.float32,
)


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
    """``value`` as a 0-d tensor of ``like``'s dtype and device (filled
    there: a copy from the host could not be captured in a CUDA graph)."""
    return like.new_full((), value)


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


def chebyshev_basis(r, num_basis: int):
    """Chebyshev polynomials T_1..T_num_basis of the (pre-scaled) input,
    expected in [-1, 1]."""
    x = r.reshape(-1, 1)
    two = _const(2.0, x)
    t_prev, t_cur = torch.ones_like(x), x
    cols = [t_cur]
    for _ in range(num_basis - 1):
        t_prev, t_cur = t_cur, two * x * t_cur - t_prev
        cols.append(t_cur)
    return torch.cat(cols, dim=-1)


def polynomial_cutoff(r, r_max: float, p: int = 6):
    """MACE's smooth polynomial envelope (eq. 8 of the MACE paper)."""
    x = r / _const(r_max, r)
    c1, c2, c3 = (_const(v, x) for v in ((p + 1.0) * (p + 2.0) / 2.0, p * (p + 2.0),
                                         p * (p + 1.0) / 2.0))
    env = (_const(1.0, x) - c1 * _ipow(x, p) + c2 * _ipow(x, p + 1) - c3 * _ipow(x, p + 2))
    return env * (r < r_max)


def _pair_r0(z, senders, receivers, scale: float):
    radii = torch.from_numpy(COVALENT_RADII).to(z.device)
    r = radii[torch.clamp(z.long(), 0, radii.shape[0] - 1)]
    return _const(scale, r) * (r[senders] + r[receivers]).reshape(-1, 1)


def agnesi_transform(r, z, senders, receivers, q: float = 0.9183, p: float = 4.5791,
                     a: float = 1.0805):
    """Agnesi distance transform (ACEpotentials.jl) with r0 the mean
    covalent radius of the pair. The radii are f32, so the result is f32."""
    x = r.reshape(-1, 1) / _pair_r0(z, senders, receivers, 0.5)
    one = _const(1.0, x)
    return one / (one + _const(a, x) * x ** q / (one + x ** (q - p)))


def soft_transform(r, z, senders, receivers, a: float = 0.2, b: float = 3.0):
    """Soft distance transform with r0 a quarter of the pair's covalent
    radii; f32, as ``agnesi_transform``."""
    x = r.reshape(-1, 1) / _pair_r0(z, senders, receivers, 0.25)
    half = _const(0.5, x)
    return r.reshape(-1, 1) + half * torch.tanh(-x - _const(a, x) * x ** b) + half


def radial_embedding(lengths, r_max: float, num_basis: int = 8, radial_type: str = "bessel",
                     envelope_exponent: int = 6, distance_transform: Optional[str] = None,
                     z=None, senders=None, receivers=None):
    """MACE's radial feature row of each edge: the basis (``bessel``,
    ``gaussian`` or ``chebyshev``) of the distance, optionally Agnesi- or
    Soft-transformed first, times the polynomial cutoff of the raw
    distance. The JAX package's ``RadialEmbedding`` holds no parameters."""
    r = lengths.reshape(-1)
    cutoff = polynomial_cutoff(r, r_max, envelope_exponent)[:, None]
    if distance_transform in ("Agnesi", "agnesi"):
        r = agnesi_transform(r, z, senders, receivers).reshape(-1)
    elif distance_transform in ("Soft", "soft"):
        r = soft_transform(r, z, senders, receivers).reshape(-1)
    if radial_type == "bessel":
        feats = bessel_basis(r, r_max, num_basis)
    elif radial_type == "gaussian":
        feats = gaussian_basis(r, r_max, num_basis)
    elif radial_type == "chebyshev":
        x = _const(2.0, r) * r / _const(r_max, r) - _const(1.0, r)
        feats = chebyshev_basis(x, num_basis)
    else:
        raise ValueError(f"unknown radial_type {radial_type!r}")
    return feats * cutoff
