"""Fused gather -> edge dense -> sorted-segment sum (K2): the hand-written
CUDA kernel ``csrc/fused_edge.cu`` and its plain PyTorch version.

Counterpart of ``hydragnn_tpu/ops/pallas_fused_edge.py``
(``fused_edge_message_sum``, whose ``_forward`` reaches ``pl.pallas_call``):

    segment_sum(relu(relu(node_recv[ids] + edge_in) @ W + b), ids)

over ascending ``ids``, with per-edge messages kept out of device memory.
Padding edges are NOT masked here (as in the JAX package): they all land on
the final dummy node, whose row is garbage that every consumer masks.

The wrapper reaches the operator ``hydragnn::fused_edge_sum`` (the
``names`` remat policy saves its output; ops/remat.py), which runs the
kernel for CUDA tensors and the plain version's forward for CPU ones,
through the same Function; on ``meta`` tensors (the FLOP count) the
wrapper takes the plain version; anything else raises. ``fused_edge_message_sum.launches``
counts kernel launches (``launches_by_case`` splits them by dtype and
widths). A launch's rows per block come from ``tune.tile_plan`` (0 in the
plan: today's mean-degree rule, ``rows_per_block``).

The kernel's route is differentiable to any order, as the JAX kernel's
``custom_jvp`` (whose tangent rule is the dense reference, rematerialized)
is: one ``torch.autograd.Function`` saves only its inputs, and its
backward recomputes the messages through ``reference_edge_message_sum``
and differentiates that, so the backward launches no kernel. The plain
version is ordinary autograd.
"""

from __future__ import annotations

import ctypes

import torch

from ..tune.plans import FUSED_EDGE, fused_edge_default_rows
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
    segment_sum_plain,
)

_SIGNATURES = {
    "hg_fused_edge_message_sum": (
        ctypes.c_int,
        (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,),
    ),
}

def reference_edge_message_sum(node_recv, edge_in, weights, bias, segment_ids,
                               num_segments: int):
    """Dense plain statement of the fused function: the per-edge messages
    are materialized, then summed per row in f32."""
    pre = node_recv[segment_ids.long()] + edge_in
    msg = torch.relu(torch.relu(pre) @ weights + bias)
    return segment_sum_plain(msg, segment_ids, num_segments)


def rows_per_block(n_edges: int, num_segments: int) -> int:
    """Today's rows a block owns (the default plan): the batch's mean
    in-degree sets them so a block walks about four 128-edge tiles
    (csrc/fused_edge.cu), at most 32."""
    return fused_edge_default_rows(n_edges, num_segments)


def fused_edge_message_sum(node_recv, edge_in, weights, bias, segment_ids,
                           num_segments: int):
    """``node_recv`` [num_segments, Ci], ``edge_in`` [E, Ci], ``weights``
    [Ci, Co], ``bias`` [Co], one dtype (float32 or bfloat16); returns
    [num_segments, Co] in that dtype, accumulated in f32."""
    inputs = (node_recv, edge_in, weights, bias)
    if edge_in.is_meta:
        return reference_edge_message_sum(*inputs, segment_ids, num_segments)
    if edge_in.device.type == "cpu":
        return _call(inputs, segment_ids, num_segments)
    if edge_in.device.type != "cuda":
        raise ValueError(f"fused_edge_message_sum: unsupported device {edge_in.device}")
    dtype = edge_in.dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_edge_message_sum: dtype {dtype} not supported")
    for name, t, ndim in (("node_recv", node_recv, 2), ("edge_in", edge_in, 2),
                          ("weights", weights, 2), ("bias", bias, 1)):
        if t.device != edge_in.device or t.dtype != dtype:
            raise TypeError(
                f"fused_edge_message_sum: {name} is {t.dtype} on {t.device}, "
                f"expected {dtype} on {edge_in.device}"
            )
        if t.dim() != ndim or not t.is_contiguous():
            raise ValueError(
                f"fused_edge_message_sum: {name} must be a contiguous {ndim}-D tensor"
            )
    e, ci = edge_in.shape
    co = weights.shape[1]
    if node_recv.shape != (num_segments, ci) or weights.shape[0] != ci or bias.shape != (co,):
        raise ValueError(
            "fused_edge_message_sum: shapes node_recv "
            f"{tuple(node_recv.shape)}, edge_in {tuple(edge_in.shape)}, weights "
            f"{tuple(weights.shape)}, bias {tuple(bias.shape)} do not agree "
            f"with num_segments={num_segments}"
        )
    check_ids(segment_ids, e, edge_in.device)
    if max(edge_in.numel(), node_recv.numel(), num_segments * co, ci * co) >= 2**31:
        raise ValueError("fused_edge_message_sum: more than 2**31 elements")
    return _call(inputs, segment_ids, num_segments)


def _call(inputs, segment_ids, num_segments: int):
    if needs_grad(*inputs):
        return _FusedEdgeMessageSum.apply(*inputs, segment_ids, num_segments)
    return _fused_edge_op(*inputs, segment_ids, num_segments)


@torch.library.custom_op("hydragnn::fused_edge_sum", mutates_args=())
def _fused_edge_op(node_recv: torch.Tensor, edge_in: torch.Tensor, weights: torch.Tensor,
                   bias: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """K2 as an operator (the ``names`` remat policy saves its output): the
    kernel for CUDA tensors, the plain version's forward for CPU ones."""
    if edge_in.device.type == "cuda":
        return _launch(node_recv, edge_in, weights, bias, segment_ids, num_segments)
    return reference_edge_message_sum(node_recv, edge_in, weights, bias, segment_ids,
                                      num_segments)


@_fused_edge_op.register_fake
def _(node_recv, edge_in, weights, bias, segment_ids, num_segments):
    return edge_in.new_empty((num_segments, weights.shape[1]))


class _FusedEdgeMessageSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, node_recv, edge_in, weights, bias, segment_ids, num_segments):
        ctx.save_for_backward(node_recv, edge_in, weights, bias, segment_ids)
        ctx.num_segments = num_segments
        return _fused_edge_op(node_recv, edge_in, weights, bias, segment_ids, num_segments)

    @staticmethod
    def backward(ctx, dout):
        *inputs, segment_ids = ctx.saved_tensors
        grads = recompute_backward(
            ctx, lambda *a: reference_edge_message_sum(*a, segment_ids, ctx.num_segments),
            inputs, dout)
        return (*grads, None, None)


def _launch(node_recv, edge_in, weights, bias, segment_ids, num_segments: int):
    dtype = edge_in.dtype
    e, ci = edge_in.shape
    co = weights.shape[1]
    out = torch.empty((num_segments, co), dtype=dtype, device=edge_in.device)
    if out.numel() == 0:
        return out
    ids = segment_ids.to(torch.int64).contiguous()
    # scratch the library fills: the CSR row pointer, then W transposed
    # to [Co, Ci] (rows padded to 16 bytes), split into TF32 hi and lo parts
    # in f32 (csrc/fused_edge.cu)
    size = edge_in.element_size()
    ci_pad = -(-ci * size // 16) * 16 // size
    n_w = (2 if dtype == torch.float32 else 1) * co * ci_pad
    scratch = torch.empty(-(-(num_segments + 1) // 4) * 16 + n_w * size,
                          dtype=torch.uint8, device=edge_in.device)
    plan = tile_plan(FUSED_EDGE, {"edges": int(e), "ci": int(ci), "co": int(co),
                                  "num_segments": int(num_segments)}, dtype)
    lib = _build.load("fused_edge", _SIGNATURES)
    _check_current_device(edge_in.device)
    stream = torch.cuda.current_stream(edge_in.device).cuda_stream
    rc = lib.hg_fused_edge_message_sum(
        node_recv.data_ptr(), edge_in.data_ptr(), weights.data_ptr(),
        bias.data_ptr(), ids.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        int(e), int(num_segments), int(ci), int(co),
        plan["rows_per_block"], _DTYPE_CODES[dtype], stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused_edge_message_sum kernel launch failed: CUDA error {rc}")
    count_launch(fused_edge_message_sum, f"{str(dtype)[6:]}/{ci}x{co}")
    return out


init_counters(fused_edge_message_sum)
