"""Kernel autotuning plane: launch-plan sweeps and the tuned table.

Counterpart of ``hydragnn_tpu/tune``. Per-(kernel id + version, device
kind, ladder slot, dtype) sweeps of each CUDA kernel's launch constants,
with a content-addressed tuned-table cache:

- tune/plans.py — what is tunable: per-kernel params, defaults (today's
  launches), candidate grids, and the normalization (the launch a plan
  makes, in canonical form);
- tune/table.py — the sha256-keyed on-disk table (atomic publishes,
  corrupt entries degrade to the defaults);
- tune/sweep.py — the offline sweep: CUDA-event medians over the
  normalized candidates on shape-exact synthetic operands;
- tune/runtime.py — the process-global lookup each kernel wrapper
  consults before it launches (``tile_plan``), with the choice emitted as
  an event;
- ``python -m hydragnn_tpu_torch.tune`` — the offline CLI over a config's
  full SpecLadder.

``Training.autotune`` (off | cached | sweep) threads the plane through
training and prediction.
"""

from . import plans, runtime, sweep, table  # noqa: F401
from .plans import KERNELS, candidates, default_plan, normalize  # noqa: F401
from .runtime import deactivate, install, setup_autotune, tile_plan  # noqa: F401
from .sweep import config_slots, sweep_kernel, sweep_slots  # noqa: F401
from .table import TunedTable, device_kind, resolve_tune_cache  # noqa: F401
