"""hydragnn_tpu_torch: the PyTorch/CUDA port of ``hydragnn_tpu`` for NVIDIA
Hopper (H100).

Module names follow the JAX package, so ``hydragnn_tpu_torch/x/y.py`` is the
counterpart of ``hydragnn_tpu/x/y.py``. The hot-path kernels are written by
hand in CUDA C++ for ``sm_90a`` (``csrc/``) and built with ``nvcc`` at first
use (``ops/_build.py``). The package imports torch, numpy and scipy, never
jax or ``hydragnn_tpu``.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit device it raises
(``device.resolve_device``).
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy: `import hydragnn_tpu_torch` stays light (no model or kernel code)
    if name in ("run_training", "run_prediction", "run_server", "run_server_fleet",
                "prepare_data"):
        from . import api

        return getattr(api, name)
    if name == "resolve_device":
        from .device import resolve_device

        return resolve_device
    raise AttributeError(name)
