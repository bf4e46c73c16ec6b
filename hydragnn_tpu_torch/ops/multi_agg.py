"""Multi-moment aggregation (K3): the hand-written CUDA kernel
``csrc/multi_agg.cu`` and its plain PyTorch version.

Counterpart of ``hydragnn_tpu/ops/pallas_multi_agg.py`` (``fused_multi_agg``,
whose ``_forward`` reaches ``pl.pallas_call``): per receiver row, the five
f32 moments ``(sum, count, min, max, sumsq)`` of the edge message
``m = (node_recv[ids] + edge_in) * gate`` (``node_recv`` and ``gate``
optional), in one pass, the messages never materialized. The message is
formed in the operand dtype and widened to f32 before any moment, as in the
JAX reference; a row without edges gets min = max = 0. ``segment_ids`` must
ascend; unlike the TPU kernel, every row is exact whatever its degree, the
dummy padding row included.

The wrapper reaches the operator ``hydragnn::multi_agg_moments`` (the
``names`` remat policy saves its outputs; ops/remat.py), which runs the
kernel for CUDA tensors (one launch, one scratch tensor) and the plain
version for CPU ones, through the same Function; on ``meta`` tensors (the
FLOP count) the wrapper takes the plain version; anything else raises.
``fused_multi_agg.launches`` counts kernel launches (``launches_by_case``
splits them by dtype and width, and by variant where it is not PNA's
``node_recv`` without a gate: ``/gate`` with one, ``/edge_in only``
without ``node_recv`` and gate).

The kernel's route is differentiable to any order, as the JAX kernel's
``custom_jvp`` (whose tangent rule is ``reference_multi_agg``) is: one
``torch.autograd.Function`` saves only its inputs, and its backward
recomputes the messages through ``reference_multi_agg`` and differentiates
that, so the backward launches no kernel. ``count`` has no gradient. min
and max split a row's gradient evenly over the edges that tie for it
(``scatter_reduce``'s rule, as JAX's scatter-min/max JVP averages over
ties); an empty row's 0 has none. With no gradient asked for, the forward
runs without the Function.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..tune.plans import MULTI_AGG
from ..tune.runtime import tile_plan
from . import _build
from .sorted_segment import (
    _DTYPE_CODES,
    _check_current_device,
    check_ids,
    count_launch,
    init_counters,
    needs_grad,
    recompute_backward,
)

_SIGNATURES = {
    "hg_multi_agg": (
        ctypes.c_int,
        (ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,),
    ),
}

# per device: the split rows' arrival counters, all 0 between calls (each
# call's kernel resets what it counted), grown as a call needs more. Calls
# that share a device run one after another on its current stream. A CUDA
# graph keeps the address it captured, so an outgrown buffer is kept alive
# (``_outgrown``), never freed; and none grows under capture, where its
# zeroing would run only at a replay.
_counters = {}
_outgrown = []


def _zeroed_counters(device, n: int):
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "fused_multi_agg: the arrival counters must grow under CUDA graph capture; "
                "run the call once eagerly before capturing it")
        if buf is not None:
            _outgrown.append(buf)
        size = max(n, 1) if buf is None else max(n, 2 * buf.numel())
        buf = _counters[device] = torch.zeros(size, dtype=torch.int32, device=device)
    return buf


def counter_blocks(c: int, col_threads: int) -> int:
    """Column blocks of a row whose arrival counters a launch may use: the
    grid's column extent with one column a thread (csrc/multi_agg.cu
    ``launch``; four a thread need no more)."""
    tx = 1
    while tx < col_threads and tx < c:
        tx *= 2
    return -(-c // tx)


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


# min/max masking sentinel of the plain version (the JAX reference's _BIG)
_BIG = 3.0e38


def reference_multi_agg(node_recv, edge_in, gate, segment_ids, num_segments: int,
                        mask=None):
    """Dense statement of the fused computation: the per-edge messages are
    materialized in the operand dtype, widened to f32 and reduced five
    ways; ``mask`` drops edges from every moment. Returns ``(sum [N, C],
    count [N], min [N, C], max [N, C], sumsq [N, C])``, all f32."""
    ids = segment_ids.long()
    # embedding's backward sorts the ids and sums each row in f32, in a
    # fixed order; advanced indexing's walks the dummy row's run of padding
    # edges one at a time, index_select's adds bf16 rows by atomics
    msg = edge_in if node_recv is None else F.embedding(ids, node_recv) + edge_in
    if gate is not None:
        msg = msg * gate
    msg = msg.float()
    ones = torch.ones(ids.shape[0], dtype=torch.float32, device=msg.device)
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (msg.dim() - mask.dim()))
        msg_0 = torch.where(m, msg, 0.0)
        msg_lo = torch.where(m, msg, _BIG)
        msg_hi = torch.where(m, msg, -_BIG)
        ones = torch.where(mask, ones, 0.0)
    else:
        msg_0 = msg_lo = msg_hi = msg
    shape = (num_segments,) + tuple(msg.shape[1:])
    zeros = torch.zeros(shape, dtype=torch.float32, device=msg.device)
    idx = ids.reshape(ids.shape + (1,) * (msg.dim() - 1)).expand_as(msg)
    s = zeros.index_add(0, ids, msg_0)
    cnt = torch.zeros(num_segments, dtype=torch.float32, device=msg.device).index_add_(0, ids, ones)
    mn = torch.full(shape, _BIG, device=msg.device).scatter_reduce_(0, idx, msg_lo, "amin")
    mx = torch.full(shape, -_BIG, device=msg.device).scatter_reduce_(0, idx, msg_hi, "amax")
    ssq = zeros.index_add(0, ids, msg_0 * msg_0)
    nonempty = (cnt > 0.0).reshape((num_segments,) + (1,) * (msg.dim() - 1))
    return s, cnt, torch.where(nonempty, mn, 0.0), torch.where(nonempty, mx, 0.0), ssq


def fused_multi_agg(node_recv, edge_in, gate, segment_ids, num_segments: int):
    """``(sum, count, min, max, sumsq)`` of ``(node_recv[ids] + edge_in) *
    gate`` over ascending ``segment_ids``. ``edge_in`` [E, C] (and ``gate``
    [E, C]) and ``node_recv`` [num_segments, C], one dtype (float32 or
    bfloat16); ``node_recv`` and ``gate`` may be None. Every moment is f32."""
    if edge_in.is_meta:
        return reference_multi_agg(node_recv, edge_in, gate, segment_ids, num_segments)
    if edge_in.device.type == "cpu":
        return _call(node_recv, edge_in, gate, segment_ids, num_segments)
    if edge_in.device.type != "cuda":
        raise ValueError(f"fused_multi_agg: unsupported device {edge_in.device}")
    dtype = edge_in.dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_multi_agg: dtype {dtype} not supported")
    if edge_in.dim() != 2 or not edge_in.is_contiguous():
        raise ValueError("fused_multi_agg: edge_in must be a contiguous [E, C] tensor")
    e, c = edge_in.shape
    for name, t, rows in (("node_recv", node_recv, num_segments), ("gate", gate, e)):
        if t is None:
            continue
        if t.device != edge_in.device or t.dtype != dtype:
            raise TypeError(
                f"fused_multi_agg: {name} is {t.dtype} on {t.device}, expected "
                f"{dtype} on {edge_in.device}"
            )
        if t.shape != (rows, c) or not t.is_contiguous():
            raise ValueError(
                f"fused_multi_agg: {name} must be a contiguous ({rows}, {c}) tensor, "
                f"got {tuple(t.shape)}"
            )
    check_ids(segment_ids, e, edge_in.device)
    if max(edge_in.numel(), num_segments * c) >= 2**31:
        raise ValueError("fused_multi_agg: more than 2**31 elements")
    return _call(node_recv, edge_in, gate, segment_ids, num_segments)


def _call(node_recv, edge_in, gate, segment_ids, num_segments: int):
    if needs_grad(node_recv, edge_in, gate):
        return _FusedMultiAgg.apply(node_recv, edge_in, gate, segment_ids, num_segments)
    return _multi_agg_op(node_recv, edge_in, gate, segment_ids, num_segments)


@torch.library.custom_op("hydragnn::multi_agg_moments", mutates_args=())
def _multi_agg_op(node_recv: Optional[torch.Tensor], edge_in: torch.Tensor,
                  gate: Optional[torch.Tensor], segment_ids: torch.Tensor, num_segments: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """K3 as an operator (the ``names`` remat policy saves its outputs):
    the kernel for CUDA tensors, the plain version for CPU ones."""
    if edge_in.device.type == "cuda":
        return _launch(node_recv, edge_in, gate, segment_ids, num_segments)
    return reference_multi_agg(node_recv, edge_in, gate, segment_ids, num_segments)


@_multi_agg_op.register_fake
def _(node_recv, edge_in, gate, segment_ids, num_segments):
    rows = edge_in.new_empty((num_segments, edge_in.shape[1]), dtype=torch.float32)
    return (rows, edge_in.new_empty((num_segments,), dtype=torch.float32), rows.clone(),
            rows.clone(), rows.clone())


class _FusedMultiAgg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, node_recv, edge_in, gate, segment_ids, num_segments):
        ctx.save_for_backward(node_recv, edge_in, gate, segment_ids)
        ctx.num_segments = num_segments
        s, cnt, mn, mx, ssq = _multi_agg_op(node_recv, edge_in, gate, segment_ids,
                                            num_segments)
        ctx.mark_non_differentiable(cnt)
        return s, cnt, mn, mx, ssq

    @staticmethod
    def backward(ctx, ds, dcnt, dmn, dmx, dssq):
        *inputs, segment_ids = ctx.saved_tensors

        def moments(*a):  # the four differentiable moments
            s, _, mn, mx, ssq = reference_multi_agg(*a, segment_ids, ctx.num_segments)
            return s, mn, mx, ssq

        return (*recompute_backward(ctx, moments, inputs, (ds, dmn, dmx, dssq)), None, None)


def _launch(node_recv, edge_in, gate, segment_ids, num_segments: int):
    e, c = edge_in.shape
    dtype = edge_in.dtype
    dev = edge_in.device
    s, mn, mx, ssq = (torch.empty((num_segments, c), dtype=torch.float32, device=dev)
                      for _ in range(4))
    cnt = torch.empty(num_segments, dtype=torch.float32, device=dev)
    if num_segments == 0:
        return s, cnt, mn, mx, ssq
    ids = segment_ids.to(torch.int64).contiguous()
    plan = tile_plan(MULTI_AGG, {"edges": int(e), "channels": int(c),
                                 "num_segments": int(num_segments),
                                 "has_recv": node_recv is not None,
                                 "has_gate": gate is not None}, dtype)
    lib = _build.load("multi_agg", _SIGNATURES)
    # the one scratch tensor: the split rows' edge ranges, then each edge
    # chunk's partial moments of the rows at its ends (csrc/multi_agg.cu)
    n_chunks = -(-e // plan["chunk_edges"])
    scratch = torch.empty(_round4(2 * num_segments) + n_chunks * 2 * c * 4,
                          dtype=torch.int32, device=dev)
    counters = _zeroed_counters(dev, num_segments * counter_blocks(c, plan["col_threads"]))
    _check_current_device(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.hg_multi_agg(
        None if node_recv is None else node_recv.data_ptr(), edge_in.data_ptr(),
        None if gate is None else gate.data_ptr(), ids.data_ptr(), counters.data_ptr(),
        scratch.data_ptr(), s.data_ptr(), cnt.data_ptr(), mn.data_ptr(), mx.data_ptr(),
        ssq.data_ptr(), int(e), int(num_segments), int(c), _DTYPE_CODES[dtype],
        plan["chunk_edges"], plan["col_threads"], stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused_multi_agg kernel launch failed: CUDA error {rc}")
    variant = ("" if node_recv is not None or gate is not None else "/edge_in only") + (
        "/gate" if gate is not None else "")
    count_launch(fused_multi_agg, f"{str(dtype)[6:]}/C{c}{variant}")
    return s, cnt, mn, mx, ssq


init_counters(fused_multi_agg)
