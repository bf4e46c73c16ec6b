"""Int8 quantization primitives.

Counterpart of ``hydragnn_tpu/ops/quant.py``, bit for bit on the same
inputs. Per-channel symmetric int8 for inference weights: each output
channel of a dense kernel gets its own f32 scale (``amax / 127`` over the
input axis), so one wide-ranged channel's error never bleeds into its
neighbours. Symmetric (no zero point) keeps the integer product a plain
int8 x int8 contraction with an int32 accumulator and the dequant one
multiply.

The layouts are the JAX package's: ``w`` is the flax ``[in, out]`` kernel
(a branch bank ``[B, in, out]``) and its scale ``[1, out]``; the serving
plane (serve/quantize.py) passes torch's ``[out, in]`` weights transposed.

``int8_matmul`` is the w8a8 product. On a CUDA tensor it is
``torch._int_mm`` (cuBLASLt's int8 GEMM, int32 out), whose shape rules
(more than 16 rows, both widths multiples of 8) the operands meet by zero
padding, exact in int32; the serving plane pads the weights once when it
quantizes and ``int8_matmul`` pads the rows and the activations' width.
On the CPU it is the widened int32 product, the plain version: both give
the exact int32 sums. No TPU kernel stands behind it (the JAX package's is a
``lax.dot_general``), so it stays a library call.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: bumping this invalidates tuned-table entries for the int8_dot plan
#: (tune/plans.py)
KERNEL_VERSION = 1

#: symmetric int8 range: +-127 (-128 is unused, so negation is closed)
INT8_MAX = 127.0

#: ``torch._int_mm``'s rules on CUDA: rows > 16, both widths % 8 == 0
INT_MM_MIN_ROWS = 17
INT_MM_ALIGN = 8

#: ``_int_mm`` calls made by ``int8_matmul`` on CUDA tensors (a library
#: call, counted beside the hand-written kernels' launches)
int_mm_calls = 0


def normalize_tiles(rows: int, cols: int, k: int, block_m: int,
                    block_n: int, block_k: int) -> Tuple[int, int, int]:
    """Clamp an int8_dot block plan to the operand extents (padded to
    multiples of 128), the JAX package's normalize-before-key contract:
    equivalent plans collapse to one tuned-table entry."""

    def _clamp(block: int, extent: int) -> int:
        block = max(int(block), 8)
        if extent > 0:
            block = min(block, max(-(-int(extent) // 128) * 128, 8))
        return block

    return (_clamp(block_m, rows), _clamp(block_n, cols), _clamp(block_k, k))


def quantize_per_channel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a dense kernel
    ``[in, out]`` (or ``[B, in, out]``): the scale reduces over the input
    axis (``-2``) with keepdims, ``[1, out]``. An all-zero channel gets
    scale 1.0 (it quantizes and dequantizes to 0 exactly)."""
    amax = w.abs().amax(dim=-2, keepdim=True).to(torch.float32)
    scale = torch.where(amax > 0.0, amax / INT8_MAX, torch.ones_like(amax))
    q = torch.clamp(torch.round(w.to(torch.float32) / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * scale`` in ``dtype``."""
    return q.to(dtype) * scale.to(dtype)


def quantize_activations(x: torch.Tensor, act_scale) -> torch.Tensor:
    """Activations against a static calibrated scale (w8a8); out-of-range
    values saturate at +-127."""
    return torch.clamp(torch.round(x / act_scale), -INT8_MAX, INT8_MAX).to(torch.int8)


def _round_up(n: int, m: int) -> int:
    return -(-int(n) // m) * m


def pad_weight(w_q: torch.Tensor) -> torch.Tensor:
    """An int8 ``[K, N]`` kernel zero-padded to multiples of 8 in both
    widths and stored so that its transpose is contiguous (``[N, K]``
    row-major, the column-major operand cuBLASLt takes): ``_int_mm``'s
    second operand, made once when a layer is quantized."""
    k, n = w_q.shape
    out = w_q.new_zeros((_round_up(n, INT_MM_ALIGN), _round_up(k, INT_MM_ALIGN)))
    out[:n, :k] = w_q.t()
    return out.t()


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 x int8 contraction with an int32 accumulator: the last axis of
    ``x_q`` against the first of ``w_q`` (the dense-layer layout,
    ``[..., K] x [K, N]``). ``w_q`` may be wider than ``x_q`` is long along
    K (``pad_weight``'s zero rows, exact) and wider than N along its
    columns (the extra output columns are dropped by the caller).

    Announces the ``int8_dot`` plan under dtype ``int8`` (tune/runtime.py);
    the plan is advisory here, as in the JAX package."""
    lead = x_q.shape[:-1]
    x2 = x_q.reshape(-1, x_q.shape[-1])
    rows, k = x2.shape
    kw, n = w_q.shape
    try:  # keying/announcement only: never allowed to fail the product
        from ..tune.runtime import tile_plan

        tile_plan("int8_dot", {"rows": int(rows) if x_q.dim() > 1 else 1,
                               "cols": int(n), "k": int(k)}, dtype="int8")
    except Exception:  # noqa: BLE001 -- advisory plane
        pass
    if kw < k:
        raise ValueError(f"int8_matmul: x_q has K={k}, w_q only {kw} rows")
    if x2.is_cuda:
        global int_mm_calls
        if kw % INT_MM_ALIGN or n % INT_MM_ALIGN:
            w_q = pad_weight(w_q)
        m_pad = max(_round_up(rows, INT_MM_ALIGN), _round_up(INT_MM_MIN_ROWS, INT_MM_ALIGN))
        x2 = torch.nn.functional.pad(x2, (0, w_q.shape[0] - k, 0, m_pad - rows))
        int_mm_calls += 1
        out = torch._int_mm(x2, w_q)[:rows, :n]
    else:
        out = torch.matmul(x2.to(torch.int32), w_q[:k, :n].to(torch.int32))
    return out.reshape(*lead, n)
