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
  ``b0`` and ``w<k>_<l>``);
- a leaf under a module the port builds once per branch (a ``branch_bank``
  module: the conv node heads) is split along its leading ``[B]`` axis
  into ``<module>.branches.<b>.<rest>``, the batch-norm statistics too.

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


def torch_arrays(model: torch.nn.Module, tree: Any, where: str = ""
                 ) -> Iterator[Tuple[str, np.ndarray, str]]:
    """``(torch name, array in torch layout, flax path)`` for every leaf of
    one flax collection ``tree`` (``params``, ``batch_stats``, or a
    gradient tree of the same structure), a branch bank's leaves split per
    branch."""
    banks = {n: len(m.branches) for n, m in model.named_modules()
             if getattr(m, "branch_bank", False)}
    for path, leaf in _leaves(tree):
        name, transpose = torch_name(path)
        arr = np.asarray(leaf)
        if transpose:
            arr = np.swapaxes(arr, -1, -2)
        at = f"{where}{'/'.join(path)}"
        bank = next((b for b in banks if name.startswith(b + ".")), None)
        if bank is None:
            yield name, arr, at
            continue
        if arr.ndim == 0 or arr.shape[0] != banks[bank]:
            raise ValueError(f"JAX leaf {at} shape {arr.shape} has no leading "
                             f"[{banks[bank]}] branch axis for {bank!r}")
        rest = name[len(bank) + 1:]
        for b in range(banks[bank]):
            yield f"{bank}.branches.{b}.{rest}", arr[b], at


def load_jax_variables(model: torch.nn.Module, variables: Dict[str, Any]) -> None:
    # the parameters and persistent buffers (constants a module builds
    # itself, such as MACE's CG tensors, are not part of the tree)
    targets: Dict[str, torch.Tensor] = dict(model.state_dict(keep_vars=True))
    filled = set()
    unknown = sorted(set(variables) - {"params", "batch_stats"})
    if unknown:
        raise ValueError(f"unexpected variable collections {unknown}")
    for collection in ("params", "batch_stats"):
        for name, arr, where in torch_arrays(model, variables.get(collection, {}),
                                             f"{collection}/"):
            t = targets.get(name)
            if t is None:
                raise ValueError(
                    f"JAX leaf {where} has no counterpart {name!r} in the torch model")
            if tuple(t.shape) != arr.shape:
                raise ValueError(
                    f"JAX leaf {where} shape {arr.shape} != torch {name} shape "
                    f"{tuple(t.shape)}")
            if name in filled:
                raise ValueError(f"torch tensor {name!r} filled twice")
            with torch.no_grad():
                t.copy_(torch.from_numpy(np.array(arr, copy=True)).to(t.dtype))
            filled.add(name)
    missing = sorted(set(targets) - filled)
    if missing:
        raise ValueError(f"torch tensors not filled from the JAX tree: {missing}")
