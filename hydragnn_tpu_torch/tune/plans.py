"""Launch plans: the tunable launch constants of each CUDA kernel.

Counterpart of ``hydragnn_tpu/tune/plans.py``. A *plan* is a plain
``{param: int}`` dict naming a kernel's own launch constants; the JAX
package's Pallas block names do not carry over (a CUDA kernel has no
``block_rows`` / ``block_edges`` grid). This module is the registry of what
is tunable: per kernel its defaults (today's constants, so a missing
tuned-table entry reproduces today's launch exactly), its candidate grid
for sweeps, and its normalization (the values the launcher accepts, and
one canonical plan for every set of requests that run the same launch),
applied before a plan becomes a tuned-table key or reaches a kernel.

- ``segment_sum`` (K1, ``csrc/sorted_segment_sum.cu``): ``narrow_edges``
  (edges a narrow block owns: 128, 256 or 512; rows of C * itemsize <= 16
  bytes), ``max_rows`` and ``wide_iters`` (a wide block's rows are
  ``min(max_rows, TY * wide_iters)`` with TY = 256 / column threads, at
  most 512). A wide plan changes only how rows are split among blocks:
  every row is summed by the same threads in the same order, so its
  outputs equal the default plan's bit for bit. A narrow plan moves the
  block boundaries, and a row that crosses one is summed by another
  reduction: within the kernel's f32 rounding, not bit for bit.
- ``fused_edge`` (K2, ``csrc/fused_edge.cu``): ``rows_per_block`` (1-32;
  0 is today's rule, ``ops/fused_edge.py rows_per_block``: about 512 edges
  a block). A row's edge tiles start where its block's edges do, so
  another split adds each row's partial sums in other groups: within the
  kernel's rounding.
- ``multi_agg`` (K3, ``csrc/multi_agg.cu``): ``chunk_edges`` (edges per
  chunk of a split row, 256 or 512; the scratch is sized from it) and
  ``col_threads`` (column threads of a row, at most: 8, 16 or 32). Rows
  that are not split are walked in edge order whatever the plan, so only
  the split rows (the dummy padding row) change, within f32 rounding.
- ``flash_attention`` (K4 and K4b, ``csrc/flash_attention.cu``):
  ``block_k``, the keys per tile, a template constant: 0 (the instance's
  own, 64 at d = 32) or, at d = 32, half of it (the one more instance the
  library is built with). The online softmax rescales per tile, so a
  plan moves the outputs within the kernel's rounding.
- ``int8_dot`` (the w8a8 product, ``ops/quant.py`` ``int8_matmul``):
  ``block_m`` / ``block_n`` / ``block_k``, keyed under dtype ``int8`` so an
  int8 plan is never confused with an f32 or bf16 entry for the same
  shapes. As in the JAX package the plan is advisory: the product is
  ``torch._int_mm``, which takes no launch constants.

``KERNELS`` keys are the tuned-table kernel ids; versions are the sha256 of
each kernel's source (``KERNEL_VERSION``, ``ops/_build.source_digest``), so
an edited kernel invalidates its tuned entries by construction;
``int8_dot``'s is ``ops/quant.py`` ``KERNEL_VERSION``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Iterable, List, Tuple

SEGMENT = "segment_sum"
FUSED_EDGE = "fused_edge"
MULTI_AGG = "multi_agg"
FLASH = "flash_attention"
INT8_DOT = "int8_dot"

# kernel id -> its source under csrc/ (its KERNEL_VERSION)
SOURCES = {SEGMENT: "sorted_segment_sum", FUSED_EDGE: "fused_edge",
           MULTI_AGG: "multi_agg", FLASH: "flash_attention"}

_ITEMSIZE = {"float32": 4, "bfloat16": 2}
# K1: the narrow instances, the wide rows' cap, the wide block's threads
SEGMENT_NARROW_EDGES = (128, 256, 512)
SEGMENT_MAX_ROWS = 512
_SEGMENT_THREADS = 256
# K2: MAX_ROWS of csrc/fused_edge.cu
FUSED_EDGE_MAX_ROWS = 32
MULTI_AGG_CHUNKS = (256, 512)
MULTI_AGG_COL_THREADS = (1, 2, 4, 8, 16, 32)
# how far a sweep candidate's outputs may lie from the default plan's on the
# same operands, each output against its own largest magnitude: f32 sums in
# another order, and in bf16 an ulp or two of the rounded outputs (K1's
# narrow split rounds a crossing row once more, K4 rounds p against another
# running maximum)
AGREEMENT_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """What is tunable about one kernel: its tuned-table id, parameter
    names, defaults (today's launch) and the sweep's candidate grid."""

    kernel: str
    params: Tuple[str, ...]
    defaults: Dict[str, int]
    grid: Dict[str, Tuple[int, ...]]

    @property
    def version(self) -> str:
        return kernel_version(self.kernel)


KERNELS: Dict[str, KernelSpec] = {
    SEGMENT: KernelSpec(
        kernel=SEGMENT,
        params=("narrow_edges", "max_rows", "wide_iters"),
        defaults={"narrow_edges": 256, "max_rows": 128, "wide_iters": 4},
        grid={"narrow_edges": SEGMENT_NARROW_EDGES, "max_rows": (32, 64, 128, 256),
              "wide_iters": (2, 4, 8)},
    ),
    FUSED_EDGE: KernelSpec(
        kernel=FUSED_EDGE,
        params=("rows_per_block",),
        defaults={"rows_per_block": 0},
        grid={"rows_per_block": (0, 1, 2, 4, 8, 16, 32)},
    ),
    MULTI_AGG: KernelSpec(
        kernel=MULTI_AGG,
        params=("chunk_edges", "col_threads"),
        defaults={"chunk_edges": 256, "col_threads": 32},
        grid={"chunk_edges": MULTI_AGG_CHUNKS, "col_threads": (8, 16, 32)},
    ),
    FLASH: KernelSpec(
        kernel=FLASH,
        params=("block_k",),
        defaults={"block_k": 0},
        grid={"block_k": (0, 16, 32, 64)},
    ),
    INT8_DOT: KernelSpec(
        kernel=INT8_DOT,
        params=("block_m", "block_n", "block_k"),
        defaults={"block_m": 128, "block_n": 128, "block_k": 128},
        grid={"block_m": (64, 128, 256), "block_n": (128, 256),
              "block_k": (128, 256, 512)},
    ),
}

_VERSIONS: Dict[str, str] = {}


def kernel_version(kernel: str) -> str:
    """The kernel's ``KERNEL_VERSION``: the sha256 (16 hex digits) of its
    source and the shared headers, read once per process (``int8_dot``:
    ``ops/quant.py`` ``KERNEL_VERSION``)."""
    if kernel == INT8_DOT:
        from ..ops.quant import KERNEL_VERSION

        return str(KERNEL_VERSION)
    if kernel not in SOURCES:
        raise KeyError(f"unknown kernel {kernel!r}")
    if kernel not in _VERSIONS:
        from ..ops._build import source_digest

        _VERSIONS[kernel] = source_digest(SOURCES[kernel])
    return _VERSIONS[kernel]


def _snap(value: int, allowed: Tuple[int, ...]) -> int:
    """The largest allowed value at or below ``value``, else the smallest."""
    below = [a for a in allowed if a <= value]
    return max(below) if below else min(allowed)


def _clamp(value: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, int(value)))


def segment_wide_threads(channels: int) -> Tuple[int, int]:
    """(TX, TY) of K1's wide launch for ``channels`` columns."""
    tx = 2
    while tx < 32 and 2 * tx < channels:
        tx *= 2
    return tx, _SEGMENT_THREADS // tx


def fused_edge_default_rows(edges: int, num_segments: int) -> int:
    """Today's rows a K2 block owns: about 512 edges a block at the
    batch's mean in-degree, at most 32."""
    mean_degree = max(edges, 1) / max(num_segments, 1)
    return int(min(max(round(512 / mean_degree), 1), FUSED_EDGE_MAX_ROWS))


def flash_default_block_k(dtype: str, head_dim: int) -> int:
    """K4's own keys per tile (``Shape::BK_DEFAULT``): from the padded
    row's bytes, the MMA depth 8 (f32) or 16 (bf16)."""
    depth = 8 if str(dtype) == "float32" else 16
    row_bytes = max(int(head_dim), depth) * _ITEMSIZE.get(str(dtype), 4)
    return 64 if row_bytes <= 128 else 32 if row_bytes <= 256 else 16


def normalize(kernel: str, plan: Dict[str, int], shapes: Dict[str, Any]) -> Dict[str, int]:
    """``plan`` (missing keys from the defaults) as the launch the kernel
    will make for these shapes, in canonical form.

    ``shapes`` carries the operand facts each kernel needs: ``channels``
    and ``dtype`` (segment_sum), ``edges`` and ``num_segments``
    (fused_edge), ``dtype`` and ``head_dim`` (flash_attention)."""
    p = {**KERNELS[kernel].defaults, **{k: int(v) for k, v in plan.items()}}
    dtype = str(shapes.get("dtype", "float32"))
    if kernel == SEGMENT:
        c = int(shapes.get("channels", 1))
        if c * _ITEMSIZE.get(dtype, 4) <= 16:
            # a narrow launch: the wide constants play no part
            return {"narrow_edges": _snap(p["narrow_edges"], SEGMENT_NARROW_EDGES),
                    "max_rows": 128, "wide_iters": 4}
        _, ty = segment_wide_threads(c)
        rows = min(_clamp(p["max_rows"], 1, SEGMENT_MAX_ROWS), ty * _clamp(p["wide_iters"], 1, 64))
        return {"narrow_edges": 256, "max_rows": rows, "wide_iters": -(-rows // ty)}
    if kernel == FUSED_EDGE:
        rows = int(p["rows_per_block"])
        if rows <= 0:
            rows = fused_edge_default_rows(int(shapes.get("edges", 1)),
                                           int(shapes.get("num_segments", 1)))
        return {"rows_per_block": _clamp(rows, 1, FUSED_EDGE_MAX_ROWS)}
    if kernel == MULTI_AGG:
        return {"chunk_edges": _snap(p["chunk_edges"], MULTI_AGG_CHUNKS),
                "col_threads": _snap(p["col_threads"], MULTI_AGG_COL_THREADS)}
    if kernel == FLASH:
        own = flash_default_block_k(dtype, int(shapes.get("head_dim", 32)))
        allowed = (own // 2, own) if int(shapes.get("head_dim", 32)) == 32 else (own,)
        bk = int(p["block_k"])
        return {"block_k": own if bk <= 0 else _snap(bk, allowed)}
    if kernel == INT8_DOT:
        from ..ops.quant import normalize_tiles

        bm, bn, bk = normalize_tiles(int(shapes.get("rows", 0)), int(shapes.get("cols", 0)),
                                     int(shapes.get("k", 0)), p["block_m"], p["block_n"],
                                     p["block_k"])
        return {"block_m": bm, "block_n": bn, "block_k": bk}
    raise KeyError(f"unknown kernel {kernel!r}")


def default_plan(kernel: str, shapes: Dict[str, Any]) -> Dict[str, int]:
    """The defaults, normalized for these shapes: what a kernel with no
    tuned-table entry runs (today's launch)."""
    return normalize(kernel, KERNELS[kernel].defaults, shapes)


def candidates(kernel: str, shapes: Dict[str, Any], budget: int = 0) -> List[Dict[str, int]]:
    """The sweep's candidate plans: the grid's cartesian product,
    normalized and deduplicated (requests that make the same launch are ONE
    candidate), the defaults first, capped at ``budget`` candidates when
    positive."""
    spec = KERNELS[kernel]
    seen: Dict[Tuple[int, ...], Dict[str, int]] = {}
    pool: Iterable[Tuple[int, ...]] = itertools.product(*(spec.grid[p] for p in spec.params))
    plans = [dict(spec.defaults)] + [dict(zip(spec.params, combo)) for combo in pool]
    for plan in plans:
        norm = normalize(kernel, plan, shapes)
        key = tuple(norm[p] for p in spec.params)
        if key not in seen:
            seen[key] = norm
    out = list(seen.values())
    if budget and budget > 0:
        out = out[: max(1, int(budget))]
    return out
