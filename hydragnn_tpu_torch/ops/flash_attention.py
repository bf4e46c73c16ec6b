"""Segment-masked flash self-attention (K4) and the one-block online-softmax
summary of ring attention (K4b): the hand-written CUDA kernels of
``csrc/flash_attention.cu`` and their plain PyTorch versions.

Counterpart of ``hydragnn_tpu/ops/pallas_flash_attention.py``
(``flash_self_attention``, whose ``_forward`` reaches ``pl.pallas_call``):
softmax attention over flat ``[N, H, d]`` q/k/v restricted to same-graph
pairs of real nodes, with graphs contiguous along the node axis
(``node_graph`` ascending, padding nodes in the final dummy graph). Padding
rows and rows with no valid key come out 0.

The plain versions compute the kernel's function: scores, softmax and the
``p @ v`` accumulation in f32 from the operand values, with ``p`` rounded
to the operand dtype before ``p @ v`` (a no-op in f32), the result in the
operand dtype. In f32 they are the JAX package's references.
``reference_masked_attention`` is the flat ``[H, N, N]``-masked statement,
exact for any graph size; ``reference_gathered_attention`` is the per-graph
``[G, Nmax]`` layout (exact on graphs of at most ``max_nodes_per_graph``
nodes).

``flash_block_summary`` (counterpart of the JAX package's
``flash_block_summary``, the same ``_forward`` with ``emit_stats``) returns
the un-normalized partial ``(m, l, acc)`` of every query against one key
block, which ``parallel/ring_attention.py`` merges across ring steps;
``reference_block_summary`` is its plain version.

Each wrapper reaches its operator (``hydragnn::flash_attention_out``,
``hydragnn::flash_block_summary``: the ``names`` remat policy saves their
outputs; ops/remat.py), which runs the kernel for CUDA tensors and the
plain version for CPU ones, through the same Function; on ``meta`` tensors
(the FLOP count) the wrapper takes the plain version; anything else raises. Unlike the TPU kernel, K4's forward
needs no static node bound: each q tile's key window is derived on the
card from ``node_graph``. ``<wrapper>.launches`` counts kernel launches
(``launches_by_case`` splits them by dtype and head shape).

Both kernels' routes are differentiable to any order, as the JAX kernels'
``custom_jvp``s are: a ``torch.autograd.Function`` each, saving only the
inputs, whose backward recomputes through a plain version and
differentiates it, so no backward launches a kernel. K4's recompute is
``reference_gathered_attention`` over ``max_nodes_per_graph`` slots per
graph (G * Nmax^2 work, the JAX tangent rule's), not the flat N^2 one;
K4b's is ``reference_block_summary`` in blocks of query rows of at most
``_RECOMPUTE_BYTES`` of f32 scores each (each row's arithmetic is the
same; the key and value gradients sum over the blocks). Fully masked rows
get zero gradients. With no gradient asked for, the forwards run without
the Functions.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from ..tune.plans import FLASH
from ..tune.runtime import tile_plan
from . import _build
from .sorted_segment import (_DTYPE_CODES, _check_current_device, count_launch,
                             init_counters, needs_grad, recompute_backward)

# both entries: q, k, v, three row strides, four pointers, four sizes,
# scale_log2, dtype code, the plan's keys per tile, stream
_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 4
             + (ctypes.c_int,) * 4 + (ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p))
_SIGNATURES = {"hg_flash_attention": (ctypes.c_int, _ARGTYPES),
               "hg_flash_block_summary": (ctypes.c_int, _ARGTYPES)}

# head dims the kernel is built for (one template instance each; d below the
# tensor-core MMA depth is zero-padded inside the kernel)
HEAD_DIMS = (4, 8, 16, 32, 64, 128)

# masking constant of the JAX references (finite, so exp of differences
# never overflows)
_NEG = -1.0e30
# f32 scores per block of query rows in K4b's backward recompute: 256 MiB
# (a 8,194-key block with 8 heads: 1,023 rows a block)
_RECOMPUTE_BYTES = 2**28


def _softmax_apply(logits, valid, v, eq: str, dtype):
    """``softmax(logits) @ v`` over the last axis restricted to ``valid``
    keys, in f32 with ``p`` rounded to ``dtype`` for the product, as the
    un-normalized ``(acc, l, m)`` (``l`` and ``m`` keep the reduced axis);
    rows with no valid key give ``(0, 0, _NEG)``."""
    logits = torch.where(valid, logits, _NEG)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum(eq, p.to(dtype).float(), v.float())
    return acc, l, m


def reference_masked_attention(q, k, v, node_graph, node_mask):
    """Flat ``[H, N, N]``-masked softmax attention over ``[N, H, d]``."""
    d = q.shape[-1]
    gid = torch.where(node_mask, node_graph.long(), -1)
    valid = (gid[:, None] == gid[None, :]) & (gid[None, :] >= 0)  # [N(q), N(k)]
    logits = torch.einsum("ihd,jhd->hij", q.float(), k.float()) * (1.0 / math.sqrt(d))
    acc, l, _ = _softmax_apply(logits, valid[None], v, "hij,jhd->hid", q.dtype)
    out = acc / torch.clamp(l, min=1e-30)  # [H, N, d]; no valid key: 0
    return out.transpose(0, 1).to(q.dtype)


def reference_gathered_attention(q, k, v, node_graph, node_mask, num_graphs: int,
                                 max_nodes_per_graph: int):
    """Per-graph gathered dense attention: the nodes of each graph gathered
    into ``[G, Nmax, H, d]``, attention within each graph, scattered back."""
    n, _, d = q.shape
    nmax = max_nodes_per_graph
    counts = torch.zeros(num_graphs, dtype=torch.int64, device=q.device).index_add_(
        0, node_graph.long(), node_mask.long())
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(nmax, device=q.device)
    valid = slot[None, :] < counts[:, None]  # [G, Nmax]
    idx = torch.where(valid, starts[:, None] + slot[None, :], n - 1)
    # index_select, not q[idx]: its backward is index_add_, where advanced
    # indexing's sorts the (many duplicate) slot indices
    qg, kg, vg = (t.index_select(0, idx.reshape(-1)).view(idx.shape + t.shape[1:])
                  for t in (q, k, v))  # [G, Nmax, H, d]
    logits = torch.einsum("gihd,gjhd->ghij", qg.float(), kg.float()) * (1.0 / math.sqrt(d))
    acc, l, _ = _softmax_apply(logits, valid[:, None, None, :], vg, "ghij,gjhd->ghid",
                               q.dtype)
    og = (acc / torch.clamp(l, min=1e-30)).transpose(1, 2)  # [G, Nmax, H, d]
    og = og * valid[:, :, None, None]
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    out.index_add_(0, idx.reshape(-1), og.reshape(-1, *q.shape[1:]))
    return out.to(q.dtype)


def _unnormalize(o, m, l):
    """The block summary from the normalized output and the f32 statistics,
    at the JAX wrapper's rounding points: ``(m, l, o * l)`` in ``o``'s
    dtype (exact where ``l > 0``; all zero where ``l == 0``)."""
    dt = o.dtype
    l = l.to(dt)
    return m.to(dt), l, o * l[..., None]


def reference_block_summary(q, k, v, key_mask):
    """Online-softmax partial of ``q [n_q, H, d]`` against one key block
    ``k``/``v [n_k, H, d]`` with ``key_mask [n_k]``: ``m`` the row max of
    the scaled scores over valid keys, ``l = sum exp(s - m)``, ``acc = exp(s
    - m) @ v``, each ``[n_q, H(, d)]`` in the operand dtype. Queries are not
    masked; rows with no valid key give ``(-1e30, 0, 0)``."""
    d = q.shape[-1]
    logits = torch.einsum("qhd,khd->qhk", q.float(), k.float()) * (1.0 / math.sqrt(d))
    acc, l, m = _softmax_apply(logits, key_mask[None, None, :], v, "qhk,khd->qhd", q.dtype)
    o = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return _unnormalize(o, m[..., 0], l[..., 0])


def _check_qkv(fn, name, t, n, h, d, dtype, device):
    if t.device != device or t.dtype != dtype:
        raise TypeError(f"{fn}: {name} is {t.dtype} on {t.device}, "
                        f"expected {dtype} on {device}")
    if t.shape != (n, h, d) or t.stride(2) != 1 or t.stride(1) != d or t.stride(0) < h * d:
        raise ValueError(
            f"{fn}: {name} must be {(n, h, d)} [rows, H, d] with the "
            f"head and dimension axes contiguous, got shape {tuple(t.shape)} "
            f"strides {t.stride()}"
        )


def _check_heads(fn, q):
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{fn}: dtype {q.dtype} not supported")
    if q.dim() != 3:
        raise ValueError(f"{fn}: q must be [rows, H, d], got {tuple(q.shape)}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {q.shape[2]} not in {HEAD_DIMS}")


def flash_self_attention(q, k, v, node_graph, node_mask, num_graphs: int,
                         max_nodes_per_graph: int):
    """Same-graph softmax attention over ``q``/``k``/``v`` [N, H, d] (one
    dtype, float32 or bfloat16; each may be a row-strided view, such as a
    slice of a fused QKV projection). ``node_graph`` [N] ascending in
    ``[0, num_graphs)``, ``node_mask`` [N] bool; ``max_nodes_per_graph``
    bounds a real graph's nodes (the gradient's recompute gathers that many
    slots per graph; the forward needs no bound). Returns a contiguous
    [N, H, d] in the operand dtype."""
    if q.is_meta:
        return reference_masked_attention(q, k, v, node_graph, node_mask)
    if q.device.type == "cpu":
        return _attention_call(q, k, v, node_graph, node_mask, num_graphs,
                               max_nodes_per_graph)
    _check_heads("flash_self_attention", q)
    dtype = q.dtype
    n, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_qkv("flash_self_attention", name, t, n, h, d, dtype, q.device)
    for name, t, want in (("node_graph", node_graph, (torch.int64,)),
                          ("node_mask", node_mask, (torch.bool,))):
        if t.device != q.device or t.dtype not in want or t.shape != (n,):
            raise ValueError(f"flash_self_attention: {name} must be [{n}] {want[0]} on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if max(n * max(q.stride(0), k.stride(0), v.stride(0)), num_graphs) >= 2**31:
        raise ValueError("flash_self_attention: more than 2**31 elements")
    if num_graphs < 1:
        raise ValueError("flash_self_attention: num_graphs must be positive")
    return _attention_call(q, k, v, node_graph, node_mask, num_graphs, max_nodes_per_graph)


def _attention_call(q, k, v, node_graph, node_mask, num_graphs: int,
                    max_nodes_per_graph: int):
    if needs_grad(q, k, v):
        if max_nodes_per_graph < 1:
            raise ValueError("flash_self_attention: a gradient needs max_nodes_per_graph >= 1")
        return _FlashSelfAttention.apply(q, k, v, node_graph, node_mask, num_graphs,
                                         max_nodes_per_graph)
    return _attention_op(q, k, v, node_graph, node_mask, num_graphs)


@torch.library.custom_op("hydragnn::flash_attention_out", mutates_args=())
def _attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, node_graph: torch.Tensor,
                  node_mask: torch.Tensor, num_graphs: int) -> torch.Tensor:
    """K4 as an operator (the ``names`` remat policy saves its output): the
    kernel for CUDA tensors, the plain version for CPU ones."""
    if q.device.type == "cuda":
        return _launch_attention(q, k, v, node_graph, node_mask, num_graphs)
    return reference_masked_attention(q, k, v, node_graph, node_mask)


@_attention_op.register_fake
def _(q, k, v, node_graph, node_mask, num_graphs):
    return q.new_empty(q.shape)


class _FlashSelfAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, node_graph, node_mask, num_graphs, max_nodes_per_graph):
        ctx.save_for_backward(q, k, v, node_graph, node_mask)
        ctx.shape = (num_graphs, max_nodes_per_graph)
        return _attention_op(q, k, v, node_graph, node_mask, num_graphs)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, node_graph, node_mask = ctx.saved_tensors
        grads = recompute_backward(
            ctx, lambda *a: reference_gathered_attention(*a, node_graph, node_mask, *ctx.shape),
            (q, k, v), dout)
        return (*grads, None, None, None, None)


def _launch_attention(q, k, v, node_graph, node_mask, num_graphs: int):
    dtype = q.dtype
    n, h, d = q.shape
    out = torch.empty((n, h, d), dtype=dtype, device=q.device)
    if out.numel() == 0:
        return out
    node_graph = node_graph.contiguous()
    node_mask = node_mask.contiguous()
    # graph row pointer scratch, filled by the library's first kernel
    graph_ptr = torch.empty(num_graphs + 1, dtype=torch.int32, device=q.device)
    plan = tile_plan(FLASH, {"nodes": int(n), "keys": int(n), "heads": int(h),
                             "head_dim": int(d), "summary": False,
                             "graphs": int(num_graphs)}, dtype)
    lib = _build.load("flash_attention", _SIGNATURES)
    _check_current_device(q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.hg_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), int(q.stride(0)), int(k.stride(0)),
        int(v.stride(0)), node_graph.data_ptr(), node_mask.data_ptr(), graph_ptr.data_ptr(),
        out.data_ptr(), int(n), int(h), int(d), int(num_graphs),
        math.log2(math.e) / math.sqrt(d), _DTYPE_CODES[dtype], plan["block_k"], stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_self_attention kernel launch failed: CUDA error {rc}")
    count_launch(flash_self_attention, f"{str(dtype)[6:]}/H{h}xd{d}")
    return out


init_counters(flash_self_attention)


def flash_block_summary(q, k, v, key_mask):
    """Online-softmax partial ``(m [n_q, H], l [n_q, H], acc [n_q, H, d])``
    of ``q [n_q, H, d]`` against one key block ``k``/``v [n_k, H, d]``
    (one dtype, float32 or bfloat16; each may be a row-strided view) with
    ``key_mask [n_k]`` bool, in the operand dtype. ``n_q`` and ``n_k`` may
    differ. Rows with no valid key give ``(-1e30, 0, 0)``."""
    if q.is_meta:
        return reference_block_summary(q, k, v, key_mask)
    if q.device.type == "cpu":
        return _summary_call(q, k, v, key_mask)
    fn = "flash_block_summary"
    _check_heads(fn, q)
    dtype = q.dtype
    nq, h, d = q.shape
    nk = k.shape[0] if k.dim() == 3 else -1
    _check_qkv(fn, "q", q, nq, h, d, dtype, q.device)
    for name, t in (("k", k), ("v", v)):
        _check_qkv(fn, name, t, nk, h, d, dtype, q.device)
    if key_mask.device != q.device or key_mask.dtype != torch.bool or key_mask.shape != (nk,):
        raise ValueError(f"{fn}: key_mask must be [{nk}] bool on {q.device}, got "
                         f"{tuple(key_mask.shape)} {key_mask.dtype} on {key_mask.device}")
    if max(nq * q.stride(0), nk * max(k.stride(0), v.stride(0))) >= 2**31:
        raise ValueError(f"{fn}: more than 2**31 elements")
    return _summary_call(q, k, v, key_mask)


def _summary_call(q, k, v, key_mask):
    if needs_grad(q, k, v):
        return _FlashBlockSummary.apply(q, k, v, key_mask)
    return _summary_op(q, k, v, key_mask)


@torch.library.custom_op("hydragnn::flash_block_summary", mutates_args=())
def _summary_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4b as an operator (the ``names`` remat policy saves its outputs):
    the kernel for CUDA tensors, the plain version for CPU ones."""
    if q.device.type == "cuda":
        return _launch_summary(q, k, v, key_mask)
    return reference_block_summary(q, k, v, key_mask)


@_summary_op.register_fake
def _(q, k, v, key_mask):
    return q.new_empty(q.shape[:2]), q.new_empty(q.shape[:2]), q.new_empty(q.shape)


class _FlashBlockSummary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask):
        ctx.save_for_backward(q, k, v, key_mask)
        return _summary_op(q, k, v, key_mask)

    @staticmethod
    def backward(ctx, dm, dl, dacc):
        q, k, v, key_mask = ctx.saved_tensors
        rows = max(1, _RECOMPUTE_BYTES // (4 * q.shape[1] * max(k.shape[0], 1)))
        grads = None
        # one recompute per block of query rows (its scores alone alive):
        # its rows' q gradients, and its share of k's and v's
        for i in range(0, max(q.shape[0], 1), rows):
            sl = slice(i, i + rows)
            part = recompute_backward(
                ctx, lambda q_, k_, v_: reference_block_summary(q_[sl], k_, v_, key_mask),
                (q, k, v), (dm[sl], dl[sl], dacc[sl]))
            grads = part if grads is None else [
                None if a is None else a + b for a, b in zip(grads, part)]
        return (*grads, None)


def _launch_summary(q, k, v, key_mask):
    dtype = q.dtype
    nq, h, d = q.shape
    nk = k.shape[0]
    out = torch.empty((nq, h, d), dtype=dtype, device=q.device)
    m = torch.empty((nq, h), dtype=torch.float32, device=q.device)
    l = torch.empty((nq, h), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return _unnormalize(out, m, l)
    key_mask = key_mask.contiguous()
    plan = tile_plan(FLASH, {"nodes": int(nq), "keys": int(nk), "heads": int(h),
                             "head_dim": int(d), "summary": True, "graphs": 1}, dtype)
    lib = _build.load("flash_attention", _SIGNATURES)
    _check_current_device(q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.hg_flash_block_summary(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), int(q.stride(0)), int(k.stride(0)),
        int(v.stride(0)), key_mask.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
        int(nq), int(nk), int(h), int(d), math.log2(math.e) / math.sqrt(d),
        _DTYPE_CODES[dtype], plan["block_k"], stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_block_summary kernel launch failed: CUDA error {rc}")
    count_launch(flash_block_summary, f"{str(dtype)[6:]}/H{h}xd{d}")
    return _unnormalize(out, m, l)


init_counters(flash_block_summary)
