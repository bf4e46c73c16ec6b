"""Masked multi-task losses and the energy-force objective.

Counterpart of ``hydragnn_tpu/train/loss.py``: every reduction runs over
real rows only (``graph_mask`` / ``node_mask``). ``compute_loss`` is the one
entry point of the train and eval steps; with ``compute_grad_energy`` the
model's single node head predicts per-node energy, the graph energy is its
masked sum per graph and the forces are ``-dE/dpos``, taken with
``create_graph=True`` so a loss on them trains the parameters (a double
backward through every op of the forward). Under ``GaussianNLLLoss`` each
head's loss is the Gaussian negative log likelihood of its ``__var``
output. A multibranch model weights every graph's loss by its branch's
``branch_loss_weights`` entry and, with ``branch_loss_metrics``, reports
the per-branch totals as ``branch<i>`` task losses.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import torch


def _elementwise(loss_type: str, err):
    lt = loss_type.lower()
    if lt in ("mse", "rmse"):  # rmse takes its root at the head level
        return err**2
    if lt in ("mae", "l1"):
        return torch.abs(err)
    raise ValueError(f"unknown loss_function_type {loss_type!r}")


def masked_mean(values, mask, row_weights=None):
    """Mean over real rows; ``row_weights`` (per row) makes it the weighted
    mean sum(w m v) / sum(w m C)."""
    m = mask.reshape(mask.shape + (1,) * (values.dim() - mask.dim())).to(values.dtype)
    if row_weights is not None:
        w = row_weights.reshape(row_weights.shape + (1,) * (values.dim() - row_weights.dim()))
        m = m * w.to(values.dtype)
    denom = torch.clamp(torch.sum(m) * values.shape[-1], min=1.0)
    return torch.sum(values * m) / denom


def head_loss(pred, target, mask, loss_type: str, row_weights=None):
    loss = masked_mean(_elementwise(loss_type, pred - target), mask, row_weights)
    if loss_type.lower() == "rmse":
        loss = torch.sqrt(loss)
    return loss


def gaussian_nll(pred, var, target, mask, eps: float = 1e-6, row_weights=None):
    """Gaussian negative log likelihood with a predicted variance (torch's
    ``GaussianNLLLoss`` with ``full=False``): the masked mean of
    ``0.5 (log v + (pred - target)^2 / v)``, ``v = max(var, eps)``."""
    return masked_mean(_nll_elementwise(pred, var, target, eps), mask, row_weights)


def _nll_elementwise(pred, var, target, eps: float = 1e-6):
    v = torch.clamp(var, min=eps)
    return 0.5 * (torch.log(v) + (pred - target) ** 2 / v)


def _per_branch_head_loss(per_elem, mask, branch_of_row, num_branches: int, loss_type: str):
    """[num_branches] masked means of one head's per-element loss, each
    over the rows of its branch."""
    m = mask.reshape(mask.shape + (1,) * (per_elem.dim() - mask.dim())).to(per_elem.dtype)
    dims = tuple(range(1, per_elem.dim()))
    row_num = torch.sum(per_elem * m, dim=dims)
    row_den = torch.sum(m.expand_as(per_elem), dim=dims)
    seg = torch.clamp(branch_of_row.long(), 0, num_branches - 1)
    num = row_num.new_zeros(num_branches).index_add(0, seg, row_num)
    den = row_den.new_zeros(num_branches).index_add(0, seg, row_den)
    out = num / torch.clamp(den, min=1.0)
    return torch.sqrt(out) if loss_type.lower() == "rmse" else out


@functools.lru_cache(maxsize=None)
def _branch_weights(weights: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """The per-branch loss weights as an f32 tensor on ``device``, made once
    (outside inference mode, so a training step can use it; and before any
    CUDA graph capture, which could not copy it from the host)."""
    with torch.inference_mode(False):
        return torch.tensor(weights, dtype=torch.float32, device=device)


def multitask_loss(outputs: Dict[str, torch.Tensor], batch, cfg
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total weighted loss + per-task unweighted losses (and, for a
    multibranch model with ``branch_loss_metrics``, the per-branch totals
    as ``branch<i>``)."""
    B = int(cfg.num_branches)
    graph_branch = batch.dataset_id.long()
    gw = None
    if B > 1 and cfg.branch_loss_weights:
        w_arr = _branch_weights(tuple(cfg.branch_loss_weights), graph_branch.device)
        gw = w_arr[torch.clamp(graph_branch, 0, B - 1)]
    want_branch = B > 1 and cfg.branch_loss_metrics
    branch_tot = None
    tot = 0.0
    tasks: Dict[str, torch.Tensor] = {}
    for name, t, w in zip(cfg.output_names, cfg.output_type,
                          cfg.normalized_task_weights):
        pred = outputs[name]
        if t == "graph":
            target, mask, rows = batch.graph_targets[name], batch.graph_mask, graph_branch
            row_w = gw
        else:
            target, mask = batch.node_targets[name], batch.node_mask
            rows = graph_branch[batch.node_graph]
            row_w = None if gw is None else gw[batch.node_graph]
        target = target.reshape(pred.shape)
        if cfg.var_output:
            task = gaussian_nll(pred, outputs[f"{name}__var"], target, mask, row_weights=row_w)
        else:
            task = head_loss(pred, target, mask, cfg.loss_function_type, row_weights=row_w)
        tasks[name] = task
        tot = tot + w * task
        if want_branch:
            if cfg.var_output:  # the NLL per element, never the rmse root
                per_elem = _nll_elementwise(pred, outputs[f"{name}__var"], target)
                per_branch_type = "mse"
            else:
                per_elem = _elementwise(cfg.loss_function_type, pred - target)
                per_branch_type = cfg.loss_function_type
            head = w * _per_branch_head_loss(per_elem, mask, rows, B, per_branch_type)
            branch_tot = head if branch_tot is None else branch_tot + head
    if want_branch:
        for b in range(B):
            tasks[f"branch{b}"] = branch_tot[b]
    return tot, tasks


def _graph_energies(apply_outputs: Callable, batch, cfg, create_graph: bool):
    """(graph energies [G], forces [N, 3]) of the batch: the node head's
    per-node energy summed per graph over real nodes, and ``-dE/dpos`` of
    the sum over real graphs."""
    if len(cfg.output_type) != 1 or cfg.output_type[0] != "node":
        raise ValueError(
            "energy-force training needs exactly one node head predicting "
            "nodal energy"
        )
    pos = batch.pos.detach().requires_grad_(True)
    node_mask_f = batch.node_mask.to(pos.dtype)
    with torch.enable_grad():
        outputs = apply_outputs(batch.replace(pos=pos))
        node_e = outputs[cfg.output_names[0]][:, 0] * node_mask_f
        graph_e = torch.zeros(batch.num_graphs, dtype=node_e.dtype,
                              device=node_e.device).index_add(0, batch.node_graph, node_e)
        e_sum = torch.sum(graph_e * batch.graph_mask.to(pos.dtype))
        (de_dpos,) = torch.autograd.grad(e_sum, pos, create_graph=create_graph)
    return graph_e, -de_dpos


def energy_force_loss(apply_outputs: Callable, batch, cfg, create_graph: bool = True):
    """Energy + autograd-force loss: ``(total, per-task losses,
    predictions)``, the predictions the graph energies [G, 1] and the
    masked forces [N, 3]. The force term's weight balances the two in the
    units of the data: ``e_w mean|E| / (mean|F| + 1e-8)``. Targets:
    ``graph_targets['energy']`` [G, 1] and ``node_targets['forces']``
    [N, 3]."""
    graph_e, forces = _graph_energies(apply_outputs, batch, cfg, create_graph)
    e_true = batch.graph_targets["energy"].reshape(-1)
    f_true = batch.node_targets["forces"]
    energy_loss = head_loss(graph_e[:, None], e_true[:, None], batch.graph_mask,
                            cfg.loss_function_type)
    force_loss = head_loss(forces, f_true, batch.node_mask, cfg.loss_function_type)
    e_w = cfg.normalized_task_weights[0]
    mean_abs_e = masked_mean(torch.abs(e_true)[:, None], batch.graph_mask)
    mean_abs_f = masked_mean(torch.abs(f_true), batch.node_mask)
    f_w = e_w * mean_abs_e / (mean_abs_f + 1e-8)
    tot = e_w * energy_loss + f_w * force_loss
    name = cfg.output_names[0]
    preds = {name: graph_e[:, None],
             "forces": forces * batch.node_mask.to(forces.dtype)[:, None]}
    return tot, {name: energy_loss, "forces": force_loss}, preds


def predict_energy_forces(apply_outputs: Callable, batch, cfg):
    """Inference-side graph energies [G] and masked forces [N, 3]."""
    graph_e, forces = _graph_energies(apply_outputs, batch, cfg, create_graph=False)
    return graph_e.detach(), (forces * batch.node_mask.to(forces.dtype)[:, None]).detach()


def compute_loss(apply_outputs: Callable, batch, cfg, compute_grad_energy: bool,
                 create_graph: bool = True):
    """The one loss of the train and eval steps: ``(total, per-task losses,
    outputs)``. ``apply_outputs(batch) -> outputs`` runs the model."""
    if compute_grad_energy:
        return energy_force_loss(apply_outputs, batch, cfg, create_graph)
    outputs = apply_outputs(batch)
    tot, tasks = multitask_loss(outputs, batch, cfg)
    return tot, tasks, outputs
