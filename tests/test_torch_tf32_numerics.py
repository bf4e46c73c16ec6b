"""The f32 numerics of the tensor-core flash kernel (``csrc/flash_attention.cu``),
emulated on the CPU: why its f32 products are three TF32 products.

The kernel rounds each f32 operand to TF32 with ``cvt.rna.tf32.f32`` (keep 10
mantissa bits, round half away from zero), splits it as ``hi = rna(x)``,
``lo = rna(x - hi)`` and sums ``lo*hi + hi*lo + hi*hi`` on ``mma.sync``. The
emulation here (kept in this file, not on the kernel's path) repeats that in
torch: a product of two TF32 values is exact in f32, so an f32 matmul of the
rounded operands stands for one TF32 product. It runs the kernel's tiled
online softmax (64-key tiles, scores in log2 units, each tile's ``p . v``
added to the accumulator in f32) and holds the 3xTF32 block summary against
the plain version (``reference_block_summary``) and the JAX package's
``flash_block_summary`` in interpret mode, at the gate ``chip_smoke.py``
holds the kernel to: 1e-5 of each output's largest value. One TF32 product
misses that gate.

The fused edge kernel (``csrc/fused_edge.cu``, K2) runs its f32 product the
same way, with its own split and grouping, emulated below: W split once
(``hi = rna(w)``, ``lo = w - hi``, which the tensor core truncates to TF32),
the left operand ``relu(node_recv[ids] + edge_in)`` split per element the
same way, and each 16-deep k slice's three products (two 8-deep steps)
summed from zero and added to the running f32 sum. At a small shape with a long dummy row it passes
K2's f32 gate in ``chip_smoke.py`` (``1e-3 + 1e-4 x`` the largest output)
against the plain version and the JAX package's
``reference_edge_message_sum``; one TF32 product per step misses it.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hydragnn_tpu.ops.pallas_fused_edge import reference_edge_message_sum as j_edge_sum
from hydragnn_tpu.ops.pallas_flash_attention import flash_block_summary as j_block_summary
from hydragnn_tpu_torch.ops import flash_attention as t_flash
from hydragnn_tpu_torch.ops import fused_edge as t_fused

GATE = 1e-5  # chip_smoke.py TOLERANCES[("K4b", "float32")]: of each output's max
TILE = 64    # keys per tile, as the kernel's f32 d <= 32 instances


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round the f32 mantissa to 10 bits, half away
    from zero (add half an ulp of TF32 to the magnitude, drop 13 bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """``a @ b`` as the kernel forms it: three TF32 products (small terms
    first) or one."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if passes == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def _emulated_block_summary(q, k, v, key_mask, passes: int):
    """The kernel's block summary in f32: per head, per 64-key tile, scores
    in log2 units, the running max, one exp2 per score, ``p . v`` of the
    tile added to the accumulator in f32; then the wrapper's ``(m, l, o *
    l)``."""
    n_q, h, d = q.shape
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    m_out, l_out, acc_out = [], [], []
    for head in range(h):
        qh, kh, vh = q[:, head], k[:, head], v[:, head]
        m = torch.full((n_q, 1), -math.inf)
        l = torch.zeros(n_q, 1)
        acc = torch.zeros(n_q, d)
        for k0 in range(0, k.shape[0], TILE):
            valid = key_mask[k0:k0 + TILE]
            if not bool(valid.any()):
                continue  # an all-masked tile is skipped
            s = _mm(qh, kh[k0:k0 + TILE].T, passes) * scale_log2
            s = torch.where(valid[None, :], s, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * corr + p.sum(dim=1, keepdim=True)
            acc = acc * corr + _mm(p, vh[k0:k0 + TILE], passes)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)
        m_out.append(torch.where(m == -math.inf, -1e30, m * math.log(2.0))[:, 0])
        l_out.append(l[:, 0])
        acc_out.append(o * l)
    return torch.stack(m_out, 1), torch.stack(l_out, 1), torch.stack(acc_out, 1)


def _inputs(n_q, n_k, h, d, seed, p_mask=0.2):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(n, h, d)).astype(np.float32) for n in (n_q, n_k, n_k))
    key_mask = rng.random(n_k) > p_mask
    key_mask[TILE:2 * TILE] = False  # one all-masked tile between attended ones
    return q, k, v, key_mask


def _rel_errors(got, want):
    """Each output's largest error over its own largest value."""
    return [float((g - w).abs().max()) / float(w.abs().max()) for g, w in zip(got, want)]


SHAPES = [(130, 260, 2, 32), (64, 300, 1, 16), (257, 129, 2, 8)]


@pytest.mark.parametrize("n_q,n_k,h,d", SHAPES)
def pytest_three_tf32_products_pass_the_kernel_gate_against_the_plain_version(n_q, n_k, h, d):
    q, k, v, km = map(torch.from_numpy, _inputs(n_q, n_k, h, d, seed=n_q + d))
    got = _emulated_block_summary(q, k, v, km, passes=3)
    want = t_flash.reference_block_summary(q, k, v, km)
    assert max(_rel_errors(got, want)) <= GATE, _rel_errors(got, want)


@pytest.mark.parametrize("n_q,n_k,h,d", SHAPES)
def pytest_three_tf32_products_pass_the_kernel_gate_against_jax(n_q, n_k, h, d):
    q, k, v, km = _inputs(n_q, n_k, h, d, seed=n_q + d)
    got = _emulated_block_summary(*map(torch.from_numpy, (q, k, v, km)), passes=3)
    want = j_block_summary(*map(jnp.asarray, (q, k, v, km)), 128, 128, True)
    want = [torch.from_numpy(np.array(w, np.float32)) for w in want]
    assert max(_rel_errors(got, want)) <= GATE, _rel_errors(got, want)


@pytest.mark.parametrize("n_q,n_k,h,d", SHAPES)
def pytest_one_tf32_product_misses_the_kernel_gate(n_q, n_k, h, d):
    q, k, v, km = map(torch.from_numpy, _inputs(n_q, n_k, h, d, seed=n_q + d))
    want = t_flash.reference_block_summary(q, k, v, km)
    one = _rel_errors(_emulated_block_summary(q, k, v, km, passes=1), want)
    three = _rel_errors(_emulated_block_summary(q, k, v, km, passes=3), want)
    assert max(one) > 10 * GATE, one
    assert max(one) > 30 * max(three), (one, three)


@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 7.5, 1e20])  # lo stays a normal f32
def pytest_tf32_hi_plus_lo_reconstructs_f32_to_2_pow_minus_22(scale):
    x = torch.from_numpy(np.random.default_rng(1).normal(size=100_000).astype(np.float32)) * scale
    hi, lo = _split(x)
    for part in (hi, lo):  # both parts are TF32: the low 13 mantissa bits are zero
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0**-22 * x.double().abs()).all())
    # one TF32 value alone is only good to 2^-11
    assert float(((x.double() - hi.double()).abs() / x.double().abs()).max()) > 2.0**-14


def pytest_tf32_rounding_is_to_nearest_with_ties_away_from_zero():
    ulp = 2.0**-10  # TF32 ulp at 1.0
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0**-23, 1 + 1.5 * ulp, 3.0],
                     dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0], dtype=torch.float32)
    assert torch.equal(_tf32_rna(x), want)


K2_ATOL, K2_RTOL = 1e-3, 1e-4  # chip_smoke.py TOLERANCES[("K2", "float32")]


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 operand: the low 13 mantissa
    bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _k2_split(x: torch.Tensor):
    """K2's split: ``hi = rna(x)``; ``lo = x - hi`` (exact in f32) as the
    tensor core reads it."""
    hi = _tf32_rna(x)
    return hi, _tf32_trunc(x - hi)


K2_SLICE = 16  # f32 values of a k slice (csrc/fused_edge.cu Kind<float>::SLICE / 4)


def _emulated_fused_edge(node_recv, edge_in, w, b, ids, n, passes: int):
    """K2's f32 route: per k slice, ``lo*hi + hi*lo + hi*hi`` (or the one
    product) from zero, added to the running sum in f32; then bias, relu
    and the row sums in f32."""
    a_hi, a_lo = _k2_split(torch.relu(node_recv[ids.long()] + edge_in))
    w_hi, w_lo = _k2_split(w)
    acc = torch.zeros(edge_in.shape[0], w.shape[1])
    for k0 in range(0, w.shape[0], K2_SLICE):
        k = slice(k0, k0 + K2_SLICE)
        step = a_hi[:, k] @ w_hi[k]
        if passes == 3:
            step = (a_lo[:, k] @ w_hi[k] + a_hi[:, k] @ w_lo[k]) + step
        acc = acc + step
    msg = torch.relu(acc + b)
    return torch.zeros(n, w.shape[1]).index_add_(0, ids.long(), msg)


def _k2_inputs(e, n, ci, co, dummy, seed):
    """Ascending receiver ids with ``dummy`` padding edges on the last row."""
    rng = np.random.default_rng(seed)
    ids = np.sort(np.concatenate([rng.integers(0, n - 1, e - dummy),
                                  np.full(dummy, n - 1)])).astype(np.int64)
    nr = rng.normal(size=(n, ci)).astype(np.float32)
    ei = rng.normal(size=(e, ci)).astype(np.float32)
    w = (rng.normal(size=(ci, co)) / np.sqrt(ci)).astype(np.float32)
    b = (0.1 * rng.normal(size=co)).astype(np.float32)
    return nr, ei, w, b, ids


K2_SHAPES = [(700, 60, 96, 80, 300), (500, 40, 130, 70, 200), (1500, 100, 256, 128, 700)]


def _k2_err(got, want):
    want = torch.from_numpy(np.array(want, np.float32))
    scale = float(want.abs().max())
    return float((got - want).abs().max()), K2_ATOL + K2_RTOL * scale


@pytest.mark.parametrize("e,n,ci,co,dummy", K2_SHAPES + [(300, 30, 7, 5, 100)])
def pytest_k2_three_tf32_products_pass_the_gate_against_the_plain_version(e, n, ci, co, dummy):
    nr, ei, w, b, ids = map(torch.from_numpy, _k2_inputs(e, n, ci, co, dummy, seed=e))
    got = _emulated_fused_edge(nr, ei, w, b, ids, n, passes=3)
    err, gate = _k2_err(got, t_fused.reference_edge_message_sum(nr, ei, w, b, ids, n))
    assert err <= gate, (err, gate)


@pytest.mark.parametrize("e,n,ci,co,dummy", K2_SHAPES)
def pytest_k2_three_tf32_products_pass_the_gate_against_jax(e, n, ci, co, dummy):
    inputs = _k2_inputs(e, n, ci, co, dummy, seed=e)
    got = _emulated_fused_edge(*map(torch.from_numpy, inputs), n, passes=3)
    want = j_edge_sum(*map(jnp.asarray, inputs), n)
    err, gate = _k2_err(got, want)
    assert err <= gate, (err, gate)


@pytest.mark.parametrize("e,n,ci,co,dummy", K2_SHAPES)
def pytest_k2_one_tf32_product_misses_the_gate(e, n, ci, co, dummy):
    nr, ei, w, b, ids = map(torch.from_numpy, _k2_inputs(e, n, ci, co, dummy, seed=e))
    want = t_fused.reference_edge_message_sum(nr, ei, w, b, ids, n)
    one, gate = _k2_err(_emulated_fused_edge(nr, ei, w, b, ids, n, passes=1), want)
    three, _ = _k2_err(_emulated_fused_edge(nr, ei, w, b, ids, n, passes=3), want)
    assert one > gate, (one, gate)
    assert one > 100 * three, (one, three)


def pytest_k2_split_of_w_is_exact_and_its_parts_tf32():
    w = torch.from_numpy(np.random.default_rng(3).normal(size=(97, 33)).astype(np.float32))
    hi, lo = _k2_split(w)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert torch.equal(hi + (w - hi), w)  # the remainder is exact in f32
    err = (w.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0**-21 * w.double().abs()).all())
