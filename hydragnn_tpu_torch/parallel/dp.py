"""Data-parallel and ZeRO step builders over the engine.

Counterpart of ``hydragnn_tpu/parallel/dp.py``: the historical
``make_parallel_train_step`` / ``make_parallel_eval_step`` (called by
``examples/multibranch/train.py``), each a ``zero_table`` preset over
``engine.make_mesh_train_step``. ``place_parallel_state`` places a
single-process ``TrainState`` by the same table first; every rank calls
it, inside a joined process group.
"""

from __future__ import annotations

from typing import Optional

from . import rules as R
from .engine import Objective, make_mesh_eval_step, make_mesh_train_step, place_state
from .mesh import Grid


def zero_table(zero_stage: int = 0, min_size: int = R.DEFAULT_MIN_SIZE) -> R.RuleTable:
    """``dp`` for stage 0, else the ``zero<stage>`` preset."""
    return R.preset(f"zero{min(int(zero_stage), 3)}" if zero_stage else "dp", min_size=min_size)


def place_parallel_state(state, zero_stage: int = 0, min_size: int = R.DEFAULT_MIN_SIZE,
                         grid: Optional[Grid] = None):
    return place_state(state, zero_table(zero_stage, min_size), grid or Grid())


def make_parallel_train_step(compute_grad_energy: bool = False, mixed_precision: bool = False,
                             zero_stage: int = 0, min_size: int = R.DEFAULT_MIN_SIZE,
                             guard: Optional[bool] = None):
    """``step(state, batch) -> (state, loss, per-task losses)`` over a
    state placed by ``place_parallel_state`` with the same stage."""
    return make_mesh_train_step(Objective(compute_grad_energy, mixed_precision, guard),
                                zero_table(zero_stage, min_size))


def make_parallel_eval_step(compute_grad_energy: bool = False, mixed_precision: bool = False):
    return make_mesh_eval_step(Objective(compute_grad_energy, mixed_precision), zero_table())
