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
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hydragnn_tpu.ops.pallas_flash_attention import flash_block_summary as j_block_summary
from hydragnn_tpu_torch.ops import flash_attention as t_flash

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
