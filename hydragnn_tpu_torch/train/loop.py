"""Evaluation loop and the mixed-precision eval cast.

Counterpart of the eval side of ``hydragnn_tpu/train/loop.py``
(``cast_batch_bf16``, ``mp_cast_eval``, ``test_model``). The training step
and its epoch loop come with the training slice.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..data.graph import GraphBatch
from ..device import module_device
from .loss import multitask_loss

# float batch fields cast to bfloat16 under mixed precision (targets and
# masks stay f32/bool)
_MP_INPUT_FIELDS = ("x", "pos", "edge_attr", "edge_shifts", "pe", "rel_pe")


def cast_batch_bf16(batch: GraphBatch, keep_pos: bool = False) -> GraphBatch:
    """The model-input channels of ``batch`` in bfloat16 (``keep_pos``
    keeps f32 positions for the autograd-force objective)."""
    upd = {}
    for f in _MP_INPUT_FIELDS:
        if keep_pos and f == "pos":
            continue
        v = getattr(batch, f)
        if v is not None and v.is_floating_point():
            upd[f] = v.to(torch.bfloat16)
    return batch.replace(**upd)


def mp_cast_model(model: torch.nn.Module) -> torch.nn.Module:
    """A bfloat16 copy of ``model``: parameters AND batch-norm running
    statistics, as eval normalizes with the running statistics."""
    return copy.deepcopy(model).to(torch.bfloat16)


def mp_cast_eval(model: torch.nn.Module, batch: GraphBatch,
                 compute_grad_energy: bool = False):
    """Eval-side mixed-precision cast: ``(bf16 model copy, bf16 inputs)``."""
    return mp_cast_model(model), cast_batch_bf16(batch, keep_pos=compute_grad_energy)


def _weighted_avg(entries: List[Tuple[float, Dict[str, float], int]]):
    total_n = sum(n for _, _, n in entries) or 1
    tot = sum(l * n for l, _, n in entries) / total_n
    task_names = entries[0][1].keys() if entries else []
    tasks = {k: sum(t[k] * n for _, t, n in entries) / total_n for k in task_names}
    return tot, tasks


@torch.no_grad()
def test_model(model, loader, mixed_precision: bool = False
               ) -> Tuple[float, Dict[str, float], Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Full-dataset evaluation: (loss, per-task losses, predictions,
    targets), the last two flattened over real rows per head."""
    cfg = model.cfg
    device = module_device(model)
    run = mp_cast_model(model) if mixed_precision else model
    names_types = list(zip(cfg.output_names, cfg.output_type))
    entries = []
    preds: Dict[str, List[np.ndarray]] = {n: [] for n, _ in names_types}
    trues: Dict[str, List[np.ndarray]] = {n: [] for n, _ in names_types}
    for batch in loader:
        batch = batch.to(device)
        inputs = cast_batch_bf16(batch) if mixed_precision else batch
        outputs = run(inputs)
        tot, tasks = multitask_loss(outputs, batch, cfg)
        n = int(batch.graph_mask.sum())
        entries.append((float(tot), {k: float(v) for k, v in tasks.items()}, n))
        for name, t in names_types:
            if t == "graph":
                mask, target = batch.graph_mask, batch.graph_targets[name]
            else:
                mask, target = batch.node_mask, batch.node_targets[name]
            pred = outputs[name].float().reshape(target.shape)
            preds[name].append(pred[mask].cpu().numpy())
            trues[name].append(target[mask].cpu().numpy())
    tot, tasks = _weighted_avg(entries)
    return (tot, tasks,
            {k: np.concatenate(v) for k, v in preds.items()},
            {k: np.concatenate(v) for k, v in trues.items()})
