"""DimeNet's spherical basis: spherical Bessel x Legendre angular functions.

Counterpart of ``hydragnn_tpu/ops/sbf.py``. The zeros of the spherical
Bessel functions j_l and the radial normalizers are found once on the host
by a float64 numpy bisection (the JAX package's constants bit for bit); on
the device j_l comes from the upward recurrence and Y_l0 from the Legendre
recurrence, elementwise torch ops.

Dtypes follow the JAX package: the zeros and normalizers are f32 tensors
(not weakly typed there), so the radial part computes in f32 whatever the
distances' dtype, and the basis comes out f32; the Legendre part computes
in the angles' dtype.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .radial import _const, dimenet_envelope


def _sph_jl_np(l: int, x: np.ndarray) -> np.ndarray:
    """Spherical Bessel j_l on the host (float64) for zero-finding."""
    x = np.asarray(x, np.float64)
    small = np.abs(x) < 1e-8
    xs = np.where(small, 1.0, x)
    j0 = np.sin(xs) / xs
    if l == 0:
        return np.where(small, 1.0, j0)
    j1 = np.sin(xs) / xs**2 - np.cos(xs) / xs
    jm, jc = j0, j1
    for n in range(1, l):
        jm, jc = jc, (2 * n + 1) / xs * jc - jm
    return np.where(small, 0.0, jc)


@functools.lru_cache(maxsize=None)
def spherical_bessel_zeros(num_spherical: int, num_radial: int) -> Tuple[Tuple[float, ...], ...]:
    """First ``num_radial`` positive zeros of j_l for l = 0..num_spherical-1:
    n pi for j_0, and each later order's zeros bisected between its
    predecessor's, which they interlace."""
    zeros = [tuple(np.pi * np.arange(1, num_radial + num_spherical + 1))]
    for l in range(1, num_spherical):
        prev = zeros[-1]
        row = []
        for i in range(len(prev) - 1):
            lo, hi = prev[i], prev[i + 1]
            flo = _sph_jl_np(l, np.array(lo))
            for _ in range(80):
                mid = 0.5 * (lo + hi)
                fmid = _sph_jl_np(l, np.array(mid))
                if np.sign(fmid) == np.sign(flo):
                    lo, flo = mid, fmid
                else:
                    hi = mid
            row.append(0.5 * (lo + hi))
        zeros.append(tuple(row))
    return tuple(tuple(z[:num_radial]) for z in zeros)


@functools.lru_cache(maxsize=None)
def _sbf_normalizers(num_spherical: int, num_radial: int) -> Tuple[Tuple[float, ...], ...]:
    """N_ln = sqrt(2) / |j_{l+1}(z_ln)|: each radial mode of unit norm on
    the unit interval (DimeNet eq. 10, the cutoff factored out)."""
    zeros = spherical_bessel_zeros(num_spherical, num_radial)
    out = []
    for l in range(num_spherical):
        zs = np.array(zeros[l])
        out.append(tuple(np.sqrt(2.0) / np.abs(_sph_jl_np(l + 1, zs))))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _constants(num_spherical: int, num_radial: int, device: torch.device):
    """(zeros, normalizers) as f32 [L, N] tensors on ``device``, made once
    (outside inference mode, so a later call under autograd can use them)."""
    with torch.inference_mode(False):
        return tuple(torch.tensor(t(num_spherical, num_radial), dtype=torch.float32,
                                  device=device)
                     for t in (spherical_bessel_zeros, _sbf_normalizers))


def _sph_jl_diagonal(x):
    """``j_l(x[:, l, :])`` for every l of ``x`` [E, L, N], stacked as
    [E, L, N]: the upward recurrence over all of ``x`` (the JAX package's
    values), order l read off at row l."""
    xs = torch.clamp(torch.abs(x), min=1e-8)
    sin, cos = torch.sin(xs), torch.cos(xs)
    jm = sin / xs
    rows = [jm[:, 0]]
    L = x.shape[1]
    if L > 1:
        jc = sin / (xs * xs) - cos / xs
        rows.append(jc[:, 1])
        for n in range(1, L - 1):
            jm, jc = jc, _const(2 * n + 1, xs) / xs * jc - jm
            rows.append(jc[:, n + 1])
    return torch.stack(rows, dim=1)


def legendre_cos(l_max: int, angle):
    """P_0..P_{l_max}(cos angle) stacked on the last axis (Bonnet)."""
    c = torch.cos(angle)
    cols = [torch.ones_like(c)]
    if l_max >= 1:
        cols.append(c)
        pm, pc = cols[0], c
        for n in range(1, l_max):
            pm, pc = pc, (_const(2 * n + 1, c) * c * pc - _const(n, c) * pm) / _const(n + 1, c)
            cols.append(pc)
    return torch.stack(cols, dim=-1)


def spherical_basis(dist, angle, idx_kj, r_max: float, num_spherical: int, num_radial: int,
                    envelope_exponent: int = 5, edge_mask: Optional[torch.Tensor] = None):
    """``[T, num_spherical * num_radial]`` directional basis a_SBF(d_kj,
    angle_kji): the radial part per edge of ``dist`` [E], enveloped,
    gathered to the triplets by ``idx_kj`` and modulated by Y_l0(angle).

    ``edge_mask`` marks the real edges. A padding edge has an eps-clamped
    length of ~1e-6, where the upward recurrence grows by ~(2l+1)/x a level,
    to ~1e38 by l = 6; a zero gradient times such a local derivative is NaN
    in the backward. So padding rows are evaluated at ``0.5 * r_max``
    before the recurrence, and zeroed after: no huge value ever exists,
    forward or backward."""
    if edge_mask is not None:
        dist = torch.where(edge_mask, dist, _const(0.5 * r_max, dist))
    d = dist / _const(r_max, dist)
    dev = dist.device
    zeros, norms = _constants(num_spherical, num_radial, dev)
    rad = _sph_jl_diagonal(d[:, None, None] * zeros[None]) * norms[None]
    rad = rad * dimenet_envelope(d, envelope_exponent)[:, None, None]
    if edge_mask is not None:
        rad = torch.where(edge_mask[:, None, None], rad, torch.zeros((), dtype=rad.dtype,
                                                                     device=dev))
    y_l0 = legendre_cos(num_spherical - 1, angle)
    scale = torch.sqrt((2.0 * torch.arange(num_spherical, dtype=torch.float32, device=dev) + 1.0)
                       / (4.0 * math.pi))
    # the JAX package's scale is weakly typed: it takes the angles' dtype
    y_l0 = y_l0 * scale.to(y_l0.dtype)[None, :]
    out = rad.index_select(0, idx_kj) * y_l0[:, :, None]
    return out.reshape(out.shape[0], num_spherical * num_radial)
