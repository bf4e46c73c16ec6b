"""Numerics statistics (N1): the raw moments of the numerics step, the
hand-written CUDA kernel ``csrc/numerics_stats.cu`` and its plain PyTorch
version.

Counterpart of the JAX package's numerics reductions
(``hydragnn_tpu/obs/numerics.py`` ``_stat_components``, which XLA fuses
into the jitted step; no Pallas kernel). ``numerics_stats(taps, masks,
leaves, group_sizes, tot)`` returns ``(stats, ok)``: ``stats`` [T + G, 5]
f32 holds the raw moments (obs/numerics.py ``STAT_FIELDS``: max |x|, sum
of squares, element count, non-finite count, bf16 underflow count) of each
probed activation ``taps[i]`` (bf16 or f32; its bool row mask
``masks[i]``, or None: padding rows count for nothing, their garbage NaN
included) and of each gradient group (``leaves`` in group order,
``group_sizes[g]`` leaves in group g); ``ok`` is the step's verdict (the
loss ``tot`` and the gradients' total sum of squares finite, as
train/guard.py ``step_ok``), None without ``tot``.

The wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors: one launch cuts every tensor into tiles and reduces each tile,
reading each input once, and one folds each segment's tiles in order (the
same bits every call). Anything else raises. ``numerics_stats.launches``
counts the calls that launched it (``count_launch``; its case names the
taps and groups).

The plain version writes every tensor into a persistent f32 buffer of
fixed-size chunks (one ``where`` a masked tap, one multi-tensor copy of the
leaves) and takes each statistic over all chunks at once, each segment's
chunk partials combined by index.
"""

from __future__ import annotations

import ctypes
import math
from collections import OrderedDict
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .sorted_segment import _check_current_device, count_launch, init_counters

STAT_WIDTH = 5
# smallest positive NORMAL bfloat16/float32 magnitude (bf16 shares f32's
# exponent): a nonzero bf16 value below it is subnormal
BF16_TINY = 1.1754944e-38
TILE = 4096  # elements a block of the kernel reduces (csrc/numerics_stats.cu kTile)
# the plain version's segments lie on chunks of this many elements
_CHUNK = 1 << 16

_SIGNATURES = {
    "hg_numerics_tiles": (ctypes.c_int, (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_void_p)),
    "hg_numerics_combine": (ctypes.c_int, (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int) + (ctypes.c_void_p,) * 4),
}

# the layouts (each with its device constants, the plain version's with its
# persistent buffer) kept, newest last
_LAYOUTS: "OrderedDict[Tuple, Any]" = OrderedDict()
_MAX_LAYOUTS = 16


def _cached(key, make):
    """A layout made once per signature (a host-to-device copy would sync
    the stream, and breaks a capture), the least recently used dropped past
    ``_MAX_LAYOUTS``."""
    got = _LAYOUTS.get(key)
    if got is None:
        with torch.inference_mode(False):
            got = make()
        _LAYOUTS[key] = got
        while len(_LAYOUTS) > _MAX_LAYOUTS:
            _LAYOUTS.popitem(last=False)
    else:
        _LAYOUTS.move_to_end(key)
    return got


def _distinct(masks: Sequence[Any]) -> Tuple[List[Any], Tuple[int, ...]]:
    """The distinct masks among ``masks`` (by identity) and each tensor's
    index among them (-1 for None)."""
    distinct: List[Any] = []
    pattern = []
    for m in masks:
        if m is None:
            pattern.append(-1)
            continue
        k = next((k for k, d in enumerate(distinct) if d is m), None)
        if k is None:
            distinct.append(m)
            k = len(distinct) - 1
        pattern.append(k)
    return distinct, tuple(pattern)


def _signature(taps, masks, leaves, group_sizes):
    """(the layout's key, the distinct masks, each tap's index among them)."""
    distinct, pattern = _distinct(masks)
    key = (str(leaves[0].device if leaves else taps[0].device),
           tuple((tuple(x.shape), x.dtype == torch.bfloat16) for x in taps), pattern,
           tuple(tuple(m.shape) for m in distinct), tuple(tuple(g.shape) for g in leaves),
           tuple(group_sizes))
    return key, distinct, pattern


def _segment_shapes(key):
    """Each output segment's shapes (a tap's own; a group's leaves') and
    whether it is bf16."""
    _, taps, _, _, leaves, group_sizes = key
    shapes = [(shape,) for shape, _ in taps]
    at = 0
    for n in group_sizes:
        shapes.append(tuple(leaves[at:at + n]))
        at += n
    return tuple(shapes), tuple(b for _, b in taps) + (False,) * len(group_sizes)


def _widths(key, distinct) -> List[int]:
    """Elements each tap's mask row covers (its size where unmasked)."""
    _, taps, pattern, mask_shapes, _, _ = key
    out = []
    for (shape, _), k in zip(taps, pattern):
        n = math.prod(shape)
        if k >= 0:
            rows = math.prod(mask_shapes[k])
            if (tuple(shape[:len(mask_shapes[k])]) != mask_shapes[k]
                    or distinct[k].dtype != torch.bool):
                raise ValueError(f"numerics_stats: a tap of shape {shape} with a mask of shape "
                                 f"{mask_shapes[k]} and dtype {distinct[k].dtype}")
            n //= max(rows, 1)
        out.append(n)
    return out


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


class _Tiles:
    """The kernel's layout: each input segment's row of the launch table
    (pointers filled at each call) and each output segment's first tile on
    the device."""

    def __init__(self, key, distinct, device):
        _, taps, pattern, _, leaves, group_sizes = key
        widths = _widths(key, distinct)
        sizes = [math.prod(shape) for shape, _ in taps] + [math.prod(s) for s in leaves]
        self.rows = np.zeros((len(sizes), 6), dtype=np.int64)
        seg_tile0, tile = [0], 0
        ends = set(np.cumsum([len(taps)] + list(group_sizes)).tolist())
        for i, n in enumerate(sizes):
            t = i < len(taps)
            self.rows[i, 2:] = (n, widths[i] if t else n, int(t and taps[i][1]), tile)
            tile += -(-n // TILE)
            if t or (i + 1) in ends:
                seg_tile0.append(tile)
        self.ntiles = tile
        self.nseg = len(seg_tile0) - 1
        self.ntaps = len(taps)
        self.seg_tile0 = torch.tensor(seg_tile0, dtype=torch.int32, device=device)


def _launch(taps, masks, leaves, key, distinct, tot):
    device = (leaves or taps)[0].device
    lay = _cached(("tiles",) + key, lambda: _Tiles(key, distinct, device))
    rows = lay.rows.copy()
    rows[:lay.ntaps, 0] = [x.data_ptr() for x in taps]
    rows[:lay.ntaps, 1] = [0 if m is None else m.data_ptr() for m in masks]
    rows[lay.ntaps:, 0] = [g.data_ptr() for g in leaves]
    partials = torch.empty((max(lay.ntiles, 1), STAT_WIDTH), dtype=torch.float32, device=device)
    out = torch.empty((lay.nseg, STAT_WIDTH), dtype=torch.float32, device=device)
    ok = None if tot is None else torch.empty((), dtype=torch.bool, device=device)
    lib = _build.load("numerics_stats", _SIGNATURES)
    _check_current_device(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.hg_numerics_tiles(rows.ctypes.data, len(rows), partials.data_ptr(), stream)
    if rc == 0:
        rc = lib.hg_numerics_combine(partials.data_ptr(), lay.seg_tile0.data_ptr(), lay.nseg,
                                     lay.ntaps, out.data_ptr(),
                                     None if tot is None else tot.data_ptr(),
                                     None if ok is None else ok.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"numerics_stats kernel launch failed: CUDA error {rc}")
    count_launch(numerics_stats, f"{lay.ntaps}taps/{lay.nseg - lay.ntaps}groups")
    return out, ok


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


class _Chunks:
    """The plain version's layout: a persistent f32 buffer of
    ``_CHUNK``-element chunks, each output segment (a tap, or a group's
    leaves taken together) on chunks of its own, the bf16 ones first; the
    views each call writes into, made once; the chunks' tails zeroed once
    (padding is finite and counts for nothing); each chunk's segment on the
    device; ``weights`` [S, K] and ``base`` [S] give the segments' element
    counts from the sums of the K distinct masks."""

    def __init__(self, key, distinct, device):
        shapes, bf16 = _segment_shapes(key)
        order = [i for i, b in enumerate(bf16) if b] + [i for i, b in enumerate(bf16) if not b]
        sizes = [sum(math.prod(s) for s in shapes[i]) for i in range(len(shapes))]
        chunks = {i: max(1, -(-sizes[i] // _CHUNK)) for i in order}
        self.nchunks = sum(chunks.values())
        self.n16 = sum(chunks[i] for i in order if bf16[i])
        self.buf = torch.zeros((self.nchunks, _CHUNK), dtype=torch.float32, device=device)
        flat = self.buf.view(-1)
        self.views: List[List[torch.Tensor]] = [[] for _ in shapes]
        owner, at = [], 0
        for i in order:
            off = at * _CHUNK
            for shape in shapes[i]:
                n = math.prod(shape)
                self.views[i].append(flat[off:off + n].view(shape))
                off += n
            owner += [i] * chunks[i]
            at += chunks[i]
        self.owner = torch.tensor(owner, dtype=torch.int64, device=device)
        self.nseg = len(shapes)
        self.ntaps = len(key[1])
        self.leaf_views = [v for seg in self.views[self.ntaps:] for v in seg]
        widths = _widths(key, distinct)
        weights = [[0.0] * len(distinct) for _ in shapes]
        base = [float(n) for n in sizes]
        for i, k in enumerate(key[2]):
            if k >= 0:
                weights[i][k], base[i] = float(widths[i]), 0.0
        # a 1-D zero: it takes part in type promotion, so ``where`` of a bf16
        # tap writes f32 into its view in one launch
        self.zero1 = torch.zeros(1, dtype=torch.float32, device=device)
        self.zeros = torch.zeros(self.nchunks, dtype=torch.float32, device=device)
        self.weights = torch.tensor(weights, dtype=torch.float32, device=device)
        self.base = torch.tensor(base, dtype=torch.float32, device=device)

    def reduce(self, counts: torch.Tensor) -> torch.Tensor:
        """[S, 5] f32 raw moments of each segment, the element counts
        ``counts``: one reduction a statistic over every chunk, then the
        chunks' partials combined by index. max |x| is the inf-norm (NaN
        propagates); the non-finite count is the 0-"norm" of ``x - x`` (0
        exactly where ``x`` is finite, NaN elsewhere); the underflow count,
        the nonzero |x| below the smallest normal, from the bf16 segments'
        chunks alone (an f32 copy of a bf16 subnormal is as small)."""
        buf = self.buf
        out = buf.new_zeros((self.nseg, STAT_WIDTH))
        out[:, 0].scatter_reduce_(0, self.owner,
                                  torch.linalg.vector_norm(buf, math.inf, dim=1), "amax")
        nonfin = torch.linalg.vector_norm(buf - buf, ord=0, dim=1)
        under = self.zeros
        if self.n16:
            ax = buf[:self.n16].abs()
            under = torch.linalg.vector_norm(torch.where(ax < BF16_TINY, ax, self.zero1),
                                             ord=0, dim=1)
            if self.n16 < self.nchunks:
                under = torch.cat([under, self.zeros[self.n16:]])
        out[:, 1:].index_add_(0, self.owner, torch.stack(
            [torch.linalg.vector_norm(buf, dim=1).square(), self.zeros, nonfin, under], dim=1))
        out[:, 2].copy_(counts)
        return out


def _plain(taps, masks, leaves, key, distinct, tot):
    device = (leaves or taps)[0].device
    ch = _cached(("chunks",) + key, lambda: _Chunks(key, distinct, device))
    with torch.no_grad():
        shaped = {}
        for x, k, (view,) in zip(taps, key[2], ch.views):
            if k < 0:
                view.copy_(x)
                continue
            m = shaped.get((k, x.dim()))
            if m is None:
                m = shaped[(k, x.dim())] = distinct[k].reshape(
                    tuple(distinct[k].shape) + (1,) * (x.dim() - distinct[k].dim()))
            torch.where(m, x, ch.zero1, out=view)
        if leaves:
            torch._foreach_copy_(ch.leaf_views, list(leaves))
        counts = ch.base if not distinct else torch.addmv(
            ch.base, ch.weights, torch.stack([m.sum(dtype=torch.float32) for m in distinct]))
        out = ch.reduce(counts)
        ok = None if tot is None else (
            torch.isfinite(tot) & torch.isfinite(out[ch.ntaps:, 1].sum()))
    return out, ok


def numerics_stats_plain(taps, masks, leaves, group_sizes, tot=None):
    """The same function as the kernel, in torch ops (any device)."""
    key, distinct, _ = _signature(taps, masks, leaves, group_sizes)
    return _plain(list(taps), list(masks), list(leaves), key, distinct, tot)


def numerics_stats(taps: Sequence[torch.Tensor], masks: Sequence[Optional[torch.Tensor]],
                   leaves: Sequence[torch.Tensor], group_sizes: Sequence[int],
                   tot: Optional[torch.Tensor] = None):
    """``(stats [T + G, 5] f32, ok or None)`` of the probed ``taps`` (each
    with its row mask or None) and the gradient groups of ``leaves``
    (``group_sizes`` leaves a group, in order); the kernel for CUDA
    tensors, the plain version for CPU ones."""
    first = (list(leaves) or list(taps))[0]
    if first.device.type == "cpu":
        return numerics_stats_plain(taps, masks, leaves, group_sizes, tot)
    if first.device.type != "cuda":
        raise ValueError(f"numerics_stats: unsupported device {first.device}")
    if sum(group_sizes) != len(leaves) or len(masks) != len(taps):
        raise ValueError("numerics_stats: group_sizes must cover the leaves, one mask a tap")
    taps = [x if x.is_contiguous() else x.contiguous() for x in taps]
    leaves = [g if g.is_contiguous() else g.contiguous() for g in leaves]
    for x in (*taps, *leaves):
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"numerics_stats: dtype {x.dtype} not supported")
    masks = [m if m is None or m.is_contiguous() else m.contiguous() for m in masks]
    key, distinct, _ = _signature(taps, masks, leaves, group_sizes)
    if any(g.dtype != torch.float32 for g in leaves):
        raise TypeError("numerics_stats: the gradient leaves must be float32")
    return _launch(taps, masks, leaves, key, distinct, tot)


init_counters(numerics_stats)
