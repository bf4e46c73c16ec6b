"""Edge geometry. Counterpart of ``hydragnn_tpu/ops/radial.py`` (only
``edge_vectors`` so far: the EGNN path needs nothing else)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def edge_vectors(pos, senders, receivers, edge_shifts: Optional[torch.Tensor] = None,
                 eps: float = 1e-12) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-edge displacement r_j - r_i (+ PBC shift) and its length [E, 1].

    Lengths are clamped away from 0 so padding self-edges (sender ==
    receiver) stay finite; mask downstream with ``edge_mask``."""
    vec = pos[senders] - pos[receivers]
    if edge_shifts is not None:
        vec = vec + edge_shifts
    d2 = torch.sum(vec * vec, dim=-1, keepdim=True)
    length = torch.sqrt(torch.clamp(d2, min=eps))
    return vec, length
