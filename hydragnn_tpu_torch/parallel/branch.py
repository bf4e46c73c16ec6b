"""Branch-parallel (``MultiTaskModelMP``) step builders over the engine.

Counterpart of ``hydragnn_tpu/parallel/branch.py``: the historical
``place_branch_state`` / ``make_branch_parallel_train_step`` /
``make_branch_parallel_eval_step`` (``examples/multibranch/train.py``),
each the ``branch`` preset over ``engine.make_mesh_train_step``, with the
routed data path (``routing.BranchRoutedLoader``). The ranks form a grid of
``num_branches`` model indices (``mesh.Grid``), model-major.
"""

from __future__ import annotations

from typing import Optional

from . import rules as R
from .engine import Objective, make_mesh_eval_step, make_mesh_train_step, place_state
from .mesh import Grid
from .routing import BranchRoutedLoader  # noqa: F401  (re-export)


def place_branch_state(state, grid: Optional[Grid] = None):
    """Place a single-process ``TrainState`` of a multibranch model: this
    rank's decoder branches and the whole encoder, with their optimizer
    state."""
    nb = state.model.cfg.num_branches
    return place_state(state, R.preset("branch", num_branches=nb), grid or Grid(nb))


def make_branch_parallel_train_step(num_branches: int, compute_grad_energy: bool = False,
                                    mixed_precision: bool = False,
                                    guard: Optional[bool] = None):
    """The step over a ``place_branch_state`` state; each rank's batches
    come from its branch (``BranchRoutedLoader``)."""
    return make_mesh_train_step(Objective(compute_grad_energy, mixed_precision, guard),
                                R.preset("branch", num_branches=num_branches))


def make_branch_parallel_eval_step(num_branches: int, compute_grad_energy: bool = False,
                                   mixed_precision: bool = False):
    return make_mesh_eval_step(Objective(compute_grad_energy, mixed_precision),
                               R.preset("branch", num_branches=num_branches))
