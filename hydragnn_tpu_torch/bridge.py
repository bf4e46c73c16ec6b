"""Load a JAX package checkpoint tree into the port's modules.

``load_jax_variables(model, variables)`` takes the flax
``{"params": ..., "batch_stats": ...}`` tree as numpy arrays (for example
``jax.device_get(variables)`` exported by the JAX package) and fills the
port's ``HydraModel`` or ``MACEModel`` in place. The mapping is by name:

- ``graph_convs_<i>`` / ``feature_layers_<i>`` / ``heads_NN_<i>`` become the
  ``ModuleList`` entries ``graph_convs.<i>`` / ...;
- a Dense ``kernel`` [in, out] becomes ``weight`` [out, in] (a branch bank's
  [B, in, out] becomes [B, out, in]: the bank axis is kept);
- every other leaf keeps its name (``bias``, ``scale``, ``coords_range``,
  the batch-norm ``mean``/``var``/``count`` buffers, MACE's ``w<l>``,
  ``b0`` and ``w<k>_<l>``).

Module names are the flax ones: an auto-named layer (``Dense_<k>``,
numbered in call order) has the same name in the port.

It is strict: a leaf with no matching tensor, a shape that disagrees, or a
tensor of the model left unfilled raises ``ValueError``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_LIST_MODULE = re.compile(r"^(graph_convs|feature_layers|heads_NN)_(\d+)$")


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, tree


def torch_name(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """(torch state-dict name, transpose?) of a flax leaf path without its
    collection."""
    *mods, leaf = path
    mods = [_LIST_MODULE.sub(r"\1.\2", m) for m in mods]
    if leaf == "kernel":
        return ".".join(mods + ["weight"]), True
    return ".".join(mods + [leaf]), False


def load_jax_variables(model: torch.nn.Module, variables: Dict[str, Any]) -> None:
    # the parameters and persistent buffers (constants a module builds
    # itself, such as MACE's CG tensors, are not part of the tree)
    targets: Dict[str, torch.Tensor] = dict(model.state_dict(keep_vars=True))
    filled = set()
    unknown = sorted(set(variables) - {"params", "batch_stats"})
    if unknown:
        raise ValueError(f"unexpected variable collections {unknown}")
    for collection in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(collection, {})):
            name, transpose = torch_name(path)
            arr = np.asarray(leaf)
            if transpose:
                arr = np.swapaxes(arr, -1, -2)
            t = targets.get(name)
            if t is None:
                raise ValueError(
                    f"JAX leaf {collection}/{'/'.join(path)} has no counterpart "
                    f"{name!r} in the torch model"
                )
            if tuple(t.shape) != arr.shape:
                raise ValueError(
                    f"JAX leaf {collection}/{'/'.join(path)} shape {arr.shape} "
                    f"!= torch {name} shape {tuple(t.shape)}"
                )
            if name in filled:
                raise ValueError(f"torch tensor {name!r} filled twice")
            with torch.no_grad():
                t.copy_(torch.from_numpy(np.array(arr, copy=True)).to(t.dtype))
            filled.add(name)
    missing = sorted(set(targets) - filled)
    if missing:
        raise ValueError(f"torch tensors not filled from the JAX tree: {missing}")
