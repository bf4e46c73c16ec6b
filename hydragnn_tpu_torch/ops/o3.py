"""O(3) representation algebra for MACE's higher-order messages.

Counterpart of ``hydragnn_tpu/ops/o3.py``: component-normalized real
spherical harmonics (closed forms up to l = 3, the associated-Legendre
recurrence beyond), and the Clebsch-Gordan machinery as host numpy in
float64 (Racah's formula in the complex basis, turned real and normalized
to unit Frobenius norm), so the tensors are the JAX package's bit for bit.
``combined_cg`` and ``summed_cg`` lay every coupling path of a tensor
product out in one block tensor, which MACE contracts in one product.

Conventions: real harmonics with mean square 1 over the unit sphere,
components m = -l..l; features of uniform channel multiplicity stored as
``[N, C, (L+1)^2]``, irrep l in slice ``l^2:(l+1)^2`` of the last axis.

The device functions compute in the dtype of their input: a Python constant
takes that dtype before it meets a tensor, as a weakly typed constant does
in JAX (``radial._const``), so bf16 rounds where the JAX package rounds.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import torch

from .radial import _const

# ---------------------------------------------------------------------------
# real spherical harmonics


def sh_dim(lmax: int) -> int:
    return (lmax + 1) ** 2


def irrep_slice(l: int) -> slice:
    """Slice of irrep ``l`` inside a stacked [..., (L+1)^2] axis."""
    return slice(l * l, (l + 1) * (l + 1))


def _double_fact(n: int) -> float:
    out = 1.0
    while n > 1:
        out *= n
        n -= 2
    return out


def _fact(n: float) -> float:
    return math.gamma(n + 1.0)


def _real_sph_harm_general(u, lmax: int):
    """Real harmonics of unit vectors at any ``lmax``, as polynomials in
    (x, y, z): ``c_m = Re[(x+iy)^m]`` and ``s_m = Im[(x+iy)^m]`` carry the
    azimuth, and the reduced Legendre ``Q_l^m = P_l^m / sin^m`` follows
    ``(l-m) Q_l^m = (2l-1) z Q_{l-1}^m - (l+m-1) Q_{l-2}^m`` from
    ``Q_m^m = (2m-1)!!`` (no pole, smooth gradients everywhere)."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    cs = [(torch.ones_like(x), torch.zeros_like(x))]
    for _ in range(1, lmax + 1):
        cp, sp = cs[-1]
        cs.append((cp * x - sp * y, cp * y + sp * x))
    q: Dict[Tuple[int, int], torch.Tensor] = {}
    for m in range(lmax + 1):
        q[(m, m)] = torch.full_like(z, _double_fact(2 * m - 1))
        if m + 1 <= lmax:
            q[(m + 1, m)] = _const(2 * m + 1, z) * z * q[(m, m)]
        for l in range(m + 2, lmax + 1):
            q[(l, m)] = (_const(2 * l - 1, z) * z * q[(l - 1, m)]
                         - _const(l + m - 1, z) * q[(l - 2, m)]) / _const(l - m, z)
    out = []
    for l in range(lmax + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            norm = math.sqrt((2 * l + 1) * _fact(l - am) / _fact(l + am))
            if m != 0:
                norm *= math.sqrt(2.0)
            base = _const(norm, z) * q[(l, am)]
            if m < 0:
                out.append(base * cs[am][1])
            elif m == 0:
                out.append(base)
            else:
                out.append(base * cs[am][0])
    return torch.stack(out, dim=-1)


def real_sph_harm(vec, lmax: int, eps: float = 1e-12):
    """Component-normalized real spherical harmonics of (normalized)
    3-vectors: ``[..., 3] -> [..., (lmax+1)^2]``. Hand-expanded closed
    forms up to l = 3, the Legendre recurrence beyond (the same polynomials,
    not the same bits)."""
    n = torch.sqrt(torch.sum(vec * vec, dim=-1, keepdim=True) + _const(eps, vec))
    u = vec / n
    if lmax > 3:
        return _real_sph_harm_general(u, lmax)
    x, y, z = u[..., 0], u[..., 1], u[..., 2]

    def c(v):
        return _const(v, x)

    out = [torch.ones_like(x)]
    if lmax >= 1:
        c1 = c(math.sqrt(3.0))
        out += [c1 * y, c1 * z, c1 * x]
    if lmax >= 2:
        c2a, c2b, c2c = c(math.sqrt(15.0)), c(math.sqrt(5.0) / 2.0), c(math.sqrt(15.0) / 2.0)
        out += [
            c2a * x * y,
            c2a * y * z,
            c2b * (c(3.0) * z * z - c(1.0)),
            c2a * x * z,
            c2c * (x * x - y * y),
        ]
    if lmax >= 3:
        c3a, c3b = c(math.sqrt(35.0 / 8.0)), c(math.sqrt(105.0))
        c3c, c3d = c(math.sqrt(21.0 / 8.0)), c(math.sqrt(7.0) / 2.0)
        c3e = c(math.sqrt(105.0) / 2.0)
        three, five = c(3.0), c(5.0)
        out += [
            c3a * y * (three * x * x - y * y),
            c3b * x * y * z,
            c3c * y * (five * z * z - c(1.0)),
            c3d * z * (five * z * z - three),
            c3c * x * (five * z * z - c(1.0)),
            c3e * z * (x * x - y * y),
            c3a * x * (x * x - three * y * y),
        ]
    return torch.stack(out, dim=-1)


# ---------------------------------------------------------------------------
# Clebsch-Gordan coefficients (complex, Racah formula) -> real basis, host
# numpy


def _cg_complex_element(j1, m1, j2, m2, j3, m3) -> float:
    """<j1 m1 j2 m2 | j3 m3> by Racah's closed form (Condon-Shortley)."""
    if m3 != m1 + m2:
        return 0.0
    if not (abs(j1 - j2) <= j3 <= j1 + j2):
        return 0.0
    pref = math.sqrt(
        (2 * j3 + 1)
        * _fact(j3 + j1 - j2)
        * _fact(j3 - j1 + j2)
        * _fact(j1 + j2 - j3)
        / _fact(j1 + j2 + j3 + 1)
    )
    pref *= math.sqrt(
        _fact(j3 + m3)
        * _fact(j3 - m3)
        * _fact(j1 - m1)
        * _fact(j1 + m1)
        * _fact(j2 - m2)
        * _fact(j2 + m2)
    )
    s = 0.0
    kmin = max(0, int(j2 - j3 - m1), int(j1 - j3 + m2))
    kmax = min(int(j1 + j2 - j3), int(j1 - m1), int(j2 + m2))
    for k in range(kmin, kmax + 1):
        s += (-1.0) ** k / (
            _fact(k)
            * _fact(j1 + j2 - j3 - k)
            * _fact(j1 - m1 - k)
            * _fact(j2 + m2 - k)
            * _fact(j3 - j2 + m1 + k)
            * _fact(j3 - j1 - m2 + k)
        )
    return pref * s


@lru_cache(maxsize=None)
def _cg_complex(l1: int, l2: int, l3: int) -> np.ndarray:
    out = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    for i1, m1 in enumerate(range(-l1, l1 + 1)):
        for i2, m2 in enumerate(range(-l2, l2 + 1)):
            for i3, m3 in enumerate(range(-l3, l3 + 1)):
                out[i1, i2, i3] = _cg_complex_element(l1, m1, l2, m2, l3, m3)
    return out


@lru_cache(maxsize=None)
def _real_to_complex(l: int) -> np.ndarray:
    """U with Y_real = U @ Y_complex for the real convention above (rows:
    real m = -l..l; columns: complex m = -l..l)."""
    U = np.zeros((2 * l + 1, 2 * l + 1), complex)
    for m in range(-l, l + 1):
        r = m + l
        if m == 0:
            U[r, l] = 1.0
        elif m > 0:
            U[r, l + m] = (-1.0) ** m / math.sqrt(2.0)
            U[r, l - m] = 1.0 / math.sqrt(2.0)
        else:
            a = -m
            U[r, l + a] = -1j * (-1.0) ** a / math.sqrt(2.0)
            U[r, l - a] = 1j / math.sqrt(2.0)
    return U


@lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis Clebsch-Gordan tensor [2l1+1, 2l2+1, 2l3+1] (float64),
    normalized to unit Frobenius norm (the learned path weights carry the
    scale)."""
    C = _cg_complex(l1, l2, l3)
    M = np.einsum("am,bn,co,mno->abc", _real_to_complex(l1), _real_to_complex(l2),
                  np.conj(_real_to_complex(l3)), C)
    re, im = np.real(M), np.imag(M)
    if np.linalg.norm(im) > 1e-9 * max(np.linalg.norm(re), 1e-30):
        assert np.linalg.norm(re) < 1e-9 * np.linalg.norm(im), (
            f"real CG ({l1},{l2},{l3}) is neither purely real nor imaginary"
        )
        out = im
    else:
        out = re
    norm = np.linalg.norm(out)
    if norm < 1e-12:
        return np.zeros_like(out)
    return (out / norm).astype(np.float64)


def tp_paths(lmax_in1: int, lmax_in2: int, lmax_out: int) -> List[Tuple[int, int, int]]:
    """Every coupling path (l1, l2, l3), |l1-l2| <= l3 <= l1+l2, with a
    nonvanishing real CG tensor."""
    paths = []
    for l1 in range(lmax_in1 + 1):
        for l2 in range(lmax_in2 + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, lmax_out) + 1):
                if np.linalg.norm(real_cg(l1, l2, l3)) > 1e-8:
                    paths.append((l1, l2, l3))
    return paths


def couple(a, b, l1: int, l2: int, l3: int):
    """Channelwise CG coupling: ``a[..., 2l1+1] x b[..., 2l2+1] ->
    [..., 2l3+1]``, the CG tensor in ``a``'s dtype."""
    cg = torch.as_tensor(real_cg(l1, l2, l3), dtype=a.dtype, device=a.device)
    return torch.einsum("...a,...b,abc->...c", a, b, cg)


@lru_cache(maxsize=None)
def combined_cg(lmax1: int, lmax2: int, lmax_out: int
                ) -> Tuple[np.ndarray, Tuple[Tuple[int, int, int], ...], Tuple[int, ...]]:
    """The block CG tensor ``G[d1, d2, Q]`` of a fused tensor product, one
    (2 l3 + 1)-wide output block per path of ``tp_paths(lmax1, lmax2,
    lmax_out)`` (zeros elsewhere), with the paths and each block's offset:
    one contraction with G computes every ``couple`` of the path loop."""
    paths = tp_paths(lmax1, lmax2, lmax_out)
    q_tot = sum(2 * l3 + 1 for _, _, l3 in paths)
    G = np.zeros((sh_dim(lmax1), sh_dim(lmax2), q_tot), np.float32)
    offsets = []
    q = 0
    for l1, l2, l3 in paths:
        G[irrep_slice(l1), irrep_slice(l2), q:q + 2 * l3 + 1] = real_cg(l1, l2, l3)
        offsets.append(q)
        q += 2 * l3 + 1
    return G, tuple(paths), tuple(offsets)


@lru_cache(maxsize=None)
def summed_cg(lmax1: int, lmax2: int, lmax_out: int) -> np.ndarray:
    """``G[d1, d2, d_out]`` with every coupling path accumulated into its
    ``irrep_slice(l3)`` block: ``einsum('...m,...n,mnk->...k', a, b, G)`` is
    the whole couple-and-add chain of an unweighted path sum."""
    G = np.zeros((sh_dim(lmax1), sh_dim(lmax2), sh_dim(lmax_out)), np.float32)
    for l1, l2, l3 in tp_paths(lmax1, lmax2, lmax_out):
        G[irrep_slice(l1), irrep_slice(l2), irrep_slice(l3)] += real_cg(l1, l2, l3)
    return G
