"""Sorted-segment sum of edge messages (K1): the hand-written CUDA kernel
``csrc/sorted_segment_sum.cu`` and its plain PyTorch version.

Counterpart of ``hydragnn_tpu/ops/pallas_segment.py`` (``sorted_segment_sum``,
whose ``_forward`` reaches ``pl.pallas_call``). ``segment_ids`` must ascend
(receiver-sorted batches, ``GraphLoader(sort_edges=True)``); unlike the TPU
kernel, every row is exact whatever its degree, the over-degree dummy row
included. Accumulation is f32; the result comes back in the messages'
dtype.

The wrapper runs the plain version for a CPU tensor and the kernel for a
CUDA tensor (one launch: the kernel finds each row's edges itself, with no
row-pointer scratch); anything else raises. ``sorted_segment_sum.launches``
counts kernel launches (``launches_by_case`` splits them by dtype and
width; ``count_launch``: ``captured`` counts launches recorded into a CUDA
graph, ``replayed`` those its replays ran).

Both are differentiable to any order, as the JAX kernel's ``custom_jvp``
is: one ``torch.autograd.Function`` whose backward is the gather
``dout[ids]`` in differentiable torch ops (the TPU kernel has no backward
kernel, so neither has this one). Edges whose id lies outside
``[0, num_segments)`` are dropped by the forward and get a zero gradient.
With no gradient asked for, the forward runs without the Function.

Each launch takes its launch constants from ``tune.tile_plan`` (the tuned
table's entry for the shape, else today's constants; tune/plans.py). The
wrapper reaches the kernel through the operator ``hydragnn::segment_sum``
(``torch.library``; on a CPU tensor it runs the plain version's forward),
so the dispatcher sees it: the ``names`` remat policy saves its output
(ops/remat.py). On ``meta`` tensors (shapes only: the FLOP count of
obs/flops.py) the wrapper takes the plain version.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ..tune.plans import SEGMENT
from ..tune.runtime import tile_plan
from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_SIGNATURES = {
    "hg_sorted_segment_sum": (
        ctypes.c_int,
        (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,),
    ),
}


def _fixed_order_sum(messages, segment_ids, num_segments: int):
    """``torch.segment_reduce`` in f32 over the row bounds of the ascending
    ids, returned in the messages' dtype (on ``meta`` the output's shape
    alone: the row bounds are data)."""
    if messages.is_meta:
        return messages.new_empty((num_segments,) + tuple(messages.shape[1:]))
    ids = segment_ids.long()
    bounds = torch.searchsorted(
        ids, torch.arange(num_segments + 1, dtype=torch.int64, device=ids.device)
    )
    # the row bounds as offsets stay on the device (slicing by them would
    # read two of them back: a sync a call)
    out = torch.segment_reduce(messages.float(), "sum", offsets=bounds, axis=0, unsafe=True)
    return out.to(messages.dtype)


def _gather_rows(dout, segment_ids, num_segments: int):
    """The backward of every segment sum here: ``dout[ids]``, zero for ids
    outside ``[0, num_segments)``, in differentiable torch ops (its own
    backward is ``index_add_``)."""
    ids = segment_ids.long()
    padded = torch.cat([dout, dout.new_zeros((1,) + tuple(dout.shape[1:]))])
    return padded.index_select(0, torch.where((ids >= 0) & (ids < num_segments), ids,
                                              num_segments))


class _SortedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, messages, segment_ids, num_segments, forward):
        ctx.save_for_backward(segment_ids)
        ctx.num_segments = num_segments
        return forward(messages, segment_ids, num_segments)

    @staticmethod
    def backward(ctx, dout):
        (segment_ids,) = ctx.saved_tensors
        return _gather_rows(dout, segment_ids, ctx.num_segments), None, None, None


def needs_grad(*tensors) -> bool:
    """Whether a call takes part in autograd: grad mode on and an input
    (None for an absent optional one) that requires grad. The wrappers run
    their kernel's Function only then."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _differentiable(forward, messages, segment_ids, num_segments: int):
    if needs_grad(messages):
        return _SortedSegmentSum.apply(messages, segment_ids, num_segments, forward)
    return forward(messages, segment_ids, num_segments)


def sorted_segment_sum_plain(messages, segment_ids, num_segments: int):
    """The same function as the kernel, for CPU tensors and for comparison:
    ``torch.segment_reduce`` in f32 over the row lengths of the ascending
    ids, returned in the messages' dtype. Each row is summed in edge order,
    so two calls give the same bits on the card too (``index_add_`` adds in
    the order its atomics land). Edges whose id lies outside
    ``[0, num_segments)`` are dropped. Differentiable to any order through
    the kernel's Function."""
    return _differentiable(_fixed_order_sum, messages, segment_ids, num_segments)


def segment_sum_plain(messages, segment_ids, num_segments: int):
    """``index_add_`` in f32, returned in the messages' dtype: the segment
    sum for ids in any order."""
    out = torch.zeros(
        (num_segments,) + tuple(messages.shape[1:]),
        dtype=torch.float32, device=messages.device,
    )
    out.index_add_(0, segment_ids.long(), messages.float())
    return out.to(messages.dtype)


def _check_current_device(device) -> None:
    """The kernels launch in the current CUDA context: the tensors must live
    on the current device."""
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(
            f"tensors on {device} but the current CUDA device is "
            f"{torch.cuda.current_device()}; call torch.cuda.set_device first"
        )


def count_launch(wrapper, case: str) -> None:
    """One launch of ``wrapper``'s kernel for ``case``: counted in
    ``launches`` / ``launches_by_case`` where the kernel runs now, in
    ``captured`` / ``captured_by_case`` where it is recorded into a CUDA
    graph (the compile plane adds each replay's launches to ``replayed`` /
    ``replayed_by_case``; train/compile_plane.py)."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
        wrapper.captured_by_case[case] += 1
    else:
        wrapper.launches += 1
        wrapper.launches_by_case[case] += 1


def init_counters(wrapper) -> None:
    """``wrapper``'s launch counters, all at 0 (``count_launch``)."""
    for name in ("launches", "captured", "replayed"):
        setattr(wrapper, name, 0)
        setattr(wrapper, f"{name}_by_case", collections.Counter())


def check_ids(segment_ids, n_edges: int, device) -> None:
    if segment_ids.device != device:
        raise ValueError(f"segment_ids on {segment_ids.device}, messages on {device}")
    if segment_ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"segment_ids must be int32 or int64, got {segment_ids.dtype}")
    if segment_ids.shape != (n_edges,):
        raise ValueError(
            f"segment_ids shape {tuple(segment_ids.shape)} != ({n_edges},)"
        )


def recompute_backward(ctx, plain, inputs, douts):
    """The backward of a kernel's Function whose JAX counterpart's tangent
    rule is its plain reference: ``plain(*inputs)`` recomputed in torch ops
    from the saved ``inputs`` (None where an optional input is absent) and
    differentiated against ``douts``. Returns one gradient per input, None
    where none is needed; launches no kernel. Under a double backward (grad
    mode on) the recompute hangs off the saved inputs through fresh views,
    so each gradient is the partial of this op alone and differentiable in
    turn; otherwise off detached leaves."""
    want = ctx.needs_input_grad[:len(inputs)]
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        leaves = [None if t is None else t.view_as(t) if create and t.requires_grad
                  else t.detach().requires_grad_(w) for t, w in zip(inputs, want)]
        outs = plain(*leaves)
        wanted = [t for t, w in zip(leaves, want) if w]
        grads = iter(torch.autograd.grad(outs, wanted, douts, create_graph=create))
    return [next(grads) if w else None for w in want]


def sorted_segment_sum(messages, segment_ids, num_segments: int):
    """``out[i] = sum_{e: ids[e] == i} messages[e]`` over ascending ids.
    ``messages`` [E, C] float32/bfloat16; returns [num_segments, C]."""
    if messages.is_meta:
        return sorted_segment_sum_plain(messages, segment_ids, num_segments)
    if messages.device.type == "cpu":
        return _differentiable(_segment_sum_op, messages, segment_ids, num_segments)
    if messages.device.type != "cuda":
        raise ValueError(f"sorted_segment_sum: unsupported device {messages.device}")
    if messages.dtype not in _DTYPE_CODES:
        raise TypeError(f"sorted_segment_sum: dtype {messages.dtype} not supported")
    if messages.dim() != 2 or not messages.is_contiguous():
        raise ValueError("sorted_segment_sum: messages must be a contiguous [E, C] tensor")
    e, c = messages.shape
    check_ids(segment_ids, e, messages.device)
    if messages.numel() >= 2**31 or num_segments * c >= 2**31:
        raise ValueError("sorted_segment_sum: more than 2**31 elements")
    return _differentiable(_segment_sum_op, messages, segment_ids, num_segments)


@torch.library.custom_op("hydragnn::segment_sum", mutates_args=())
def _segment_sum_op(messages: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """K1 as an operator: the kernel for a CUDA tensor, the plain version's
    forward for a CPU one."""
    if messages.device.type == "cuda":
        return _launch(messages, segment_ids, num_segments)
    return _fixed_order_sum(messages, segment_ids, num_segments)


@_segment_sum_op.register_fake
def _(messages, segment_ids, num_segments):
    return messages.new_empty((num_segments,) + tuple(messages.shape[1:]))


def _launch(messages, segment_ids, num_segments: int):
    e, c = messages.shape
    out = torch.empty((num_segments, c), dtype=messages.dtype, device=messages.device)
    if out.numel() == 0:
        return out
    ids = segment_ids.to(torch.int64).contiguous()
    plan = tile_plan(SEGMENT, {"edges": int(e), "channels": int(c),
                               "num_segments": int(num_segments)}, messages.dtype)
    lib = _build.load("sorted_segment_sum", _SIGNATURES)
    _check_current_device(messages.device)
    stream = torch.cuda.current_stream(messages.device).cuda_stream
    rc = lib.hg_sorted_segment_sum(
        messages.data_ptr(), ids.data_ptr(), out.data_ptr(),
        int(e), int(num_segments), int(c), _DTYPE_CODES[messages.dtype],
        plan["narrow_edges"], plan["max_rows"], plan["wide_iters"], stream,
    )
    if rc != 0:
        raise RuntimeError(f"sorted_segment_sum kernel launch failed: CUDA error {rc}")
    count_launch(sorted_segment_sum, f"{str(messages.dtype)[6:]}/C{c}")
    return out


init_counters(sorted_segment_sum)
