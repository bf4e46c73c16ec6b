"""Masked multi-task losses (eval side). Counterpart of
``hydragnn_tpu/train/loss.py``: every reduction runs over real rows only
(``graph_mask`` / ``node_mask``). Branch-weighted losses and variance heads
come with the training slice."""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def _elementwise(loss_type: str, err):
    lt = loss_type.lower()
    if lt in ("mse", "rmse"):
        return err**2
    if lt in ("mae", "l1"):
        return torch.abs(err)
    raise ValueError(f"unknown loss_function_type {loss_type!r}")


def masked_mean(values, mask):
    m = mask.reshape(mask.shape + (1,) * (values.dim() - mask.dim())).to(values.dtype)
    denom = torch.clamp(torch.sum(m) * values.shape[-1], min=1.0)
    return torch.sum(values * m) / denom


def head_loss(pred, target, mask, loss_type: str):
    loss = masked_mean(_elementwise(loss_type, pred - target), mask)
    if loss_type.lower() == "rmse":
        loss = torch.sqrt(loss)
    return loss


def multitask_loss(outputs: Dict[str, torch.Tensor], batch, cfg
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total weighted loss + per-task unweighted losses."""
    tot = 0.0
    tasks: Dict[str, torch.Tensor] = {}
    for name, t, w in zip(cfg.output_names, cfg.output_type,
                          cfg.normalized_task_weights):
        pred = outputs[name]
        if t == "graph":
            target, mask = batch.graph_targets[name], batch.graph_mask
        else:
            target, mask = batch.node_targets[name], batch.node_mask
        task = head_loss(pred, target.reshape(pred.shape), mask,
                         cfg.loss_function_type)
        tasks[name] = task
        tot = tot + w * task
    return tot, tasks
