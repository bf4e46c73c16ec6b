"""Device resolution shared by every entry point.

The port runs on the GPU. A caller who wants the CPU (the tests, a laptop
smoke) says so with ``device="cpu"``; a missing GPU is an error, never a
quiet fall back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the current CUDA device and raises ``RuntimeError``
    when there is none; an explicit device is taken as given, and an
    explicit CUDA device that does not exist raises as well."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hydragnn_tpu_torch runs on a CUDA GPU and none is available; "
                "pass device='cpu' to run on the CPU explicitly"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def module_device(module: torch.nn.Module) -> Optional[torch.device]:
    """Device of a module's first parameter (None for a parameterless one)."""
    for p in module.parameters():
        return p.device
    return None
