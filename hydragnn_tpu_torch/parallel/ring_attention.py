"""Ring self-attention: exact attention over a node axis split across the
ranks of a process group, for graphs too large for one card.

Counterpart of ``hydragnn_tpu/parallel/ring_attention.py``. Every rank
holds its local query/key/value block ``[n_local, H, d]``; the key/value
blocks and their key mask rotate around the ring (rank ``i`` receives from
``i + 1`` and sends to ``i - 1``, ``torch.distributed.batch_isend_irecv``),
and the softmax is accumulated online (running max, denominator and
accumulator), so no rank ever holds the ``[N, N]`` scores. After ``n_ranks``
blocks each query has attended to every key. ``group=None`` is a ring of
one rank: one block, no rotation. The rotation is differentiable: its
backward sends the key and value gradients back round the ring to the
ranks that own the blocks, so every rank's ``k`` and ``v`` gradients hold
every rank's queries' terms.

``use_flash`` computes each block's partial with the block-summary kernel
(K4b, ``ops/flash_attention.flash_block_summary``) and merges it here in
plain PyTorch; the dense einsum route is the same math.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from ..ops.flash_attention import flash_block_summary


def _block_attend(q, k, v, kmask, m, denom, acc, scale, use_flash: bool = False):
    """One online-softmax step of ``q [n_q, H, d]`` against the key block
    ``k``/``v [n_k, H, d]``, ``kmask [n_k]``, updating the carries ``m``,
    ``denom [n_q, H]`` and ``acc [n_q, H, d]``."""
    if use_flash:
        m_b, l_b, acc_b = flash_block_summary(q, k, v, kmask)
        new_m = torch.maximum(m, m_b)
        corr = torch.exp(m - new_m)
        corr_b = torch.exp(m_b - new_m)
        denom = denom * corr + l_b * corr_b
        acc = acc * corr[..., None] + acc_b * corr_b[..., None]
        return new_m.to(m.dtype), denom, acc
    logits = torch.einsum("qhd,khd->qhk", q, k) * scale  # [n_q, H, n_k]
    valid = kmask[None, None, :]
    logits = torch.where(valid, logits, torch.finfo(logits.dtype).min)
    new_m = torch.maximum(m, logits.amax(dim=-1))
    # exp(min - new_m) underflows to 0 for a fully masked block, keeping
    # denom and acc unchanged
    corr = torch.exp(m - new_m)
    p = torch.where(valid, torch.exp(logits - new_m[..., None]), 0.0)
    denom = denom * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("qhk,khd->qhd", p, v)
    return new_m, denom, acc


def _send_recv(tensors: List[torch.Tensor], group, shift: int) -> List[torch.Tensor]:
    """Send each tensor ``shift`` ranks along the ring and receive the ones
    sent to this rank, in one batch of point-to-point operations: rank
    ``i`` receives rank ``i - shift``'s."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    send_to = dist.get_global_rank(group, (rank + shift) % world)
    recv_from = dist.get_global_rank(group, (rank - shift) % world)
    tensors = [t.contiguous() for t in tensors]
    received = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, received):
        ops.append(dist.P2POp(dist.isend, t, send_to, group))
        ops.append(dist.P2POp(dist.irecv, r, recv_from, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return received


class _Rotate(torch.autograd.Function):
    """``_send_recv`` of float tensors inside the autograd graph, as JAX's
    ``ppermute`` transposes: the gradient of what a rank received belongs
    to the rank that sent it, so the backward sends the incoming gradients
    the other way round the ring (itself a ``_Rotate``, so differentiable
    to any order)."""

    @staticmethod
    def forward(ctx, group, shift, *tensors):
        ctx.group, ctx.shift = group, shift
        return tuple(_send_recv(list(tensors), group, shift))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_Rotate.apply(ctx.group, -ctx.shift, *grads))


def _rotate(k, v, key_mask, group):
    """Rank ``i`` gets rank ``i + 1``'s key block, value block and key
    mask (each rank sends its own to ``i - 1``)."""
    k, v = _Rotate.apply(group, -1, k, v)
    (key_mask,) = _send_recv([key_mask], group, -1)
    return k, v, key_mask


def ring_self_attention(q, k, v, key_mask: Optional[torch.Tensor], group=None,
                        use_flash: bool = False):
    """Exact multi-head self-attention of the local queries over the keys
    of every rank of ``group``. Per rank: ``q``/``k``/``v [n_local, H, d]``
    (the same ``n_local`` on every rank), ``key_mask [n_local]`` bool
    marking real keys, or None. Returns ``[n_local, H, d]`` in ``q``'s
    dtype."""
    n_ranks = 1 if group is None else dist.get_world_size(group)
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]), device=q.device)).to(q.dtype)
    if key_mask is None:
        key_mask = torch.ones(k.shape[0], dtype=torch.bool, device=k.device)
    m = torch.full(q.shape[:-1], torch.finfo(q.dtype).min, dtype=q.dtype, device=q.device)
    denom = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
    acc = torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    # n_ranks - 1 attend + rotate steps, then the last block without the
    # rotation that would only bring the first block back
    if n_ranks > 1:
        for _ in range(n_ranks - 1):
            m, denom, acc = _block_attend(q, k, v, key_mask, m, denom, acc, scale, use_flash)
            k, v, key_mask = _rotate(k, v, key_mask, group)
    m, denom, acc = _block_attend(q, k, v, key_mask, m, denom, acc, scale, use_flash)
    return acc / torch.clamp(denom, min=1e-30)[..., None]
