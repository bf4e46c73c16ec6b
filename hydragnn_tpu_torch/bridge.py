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

import dataclasses
import re
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

_LIST_NAMES = ("graph_convs", "feature_layers", "heads_NN")
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


@dataclasses.dataclass(frozen=True)
class FlaxLeaf:
    """One leaf of the flax variable tree of a port model: its '/'-joined
    ``path`` (without the collection), its ``shape`` in the flax layout,
    and the torch tensors that hold it (``names``: one, or one per branch
    of a ``branch_bank`` module, in branch order; ``transpose``: a Dense
    kernel, which torch keeps as ``[..., out, in]``)."""

    path: str
    shape: Tuple[int, ...]
    names: Tuple[str, ...]
    transpose: bool

    @property
    def lead_axis(self) -> int:
        """The torch axis of a one-tensor leaf that holds the flax leading
        axis (a 2-D kernel's leading flax axis is torch's last)."""
        return 1 if self.transpose and len(self.shape) == 2 else 0


def flax_path(name: str) -> Tuple[str, bool]:
    """(flax path, transposed?) of a torch state-dict name outside a branch
    bank: the inverse of ``torch_name``."""
    parts = name.split(".")
    out: List[str] = []
    i = 0
    while i < len(parts) - 1:
        p = parts[i]
        if p in _LIST_NAMES and i + 1 < len(parts) - 1 and parts[i + 1].isdigit():
            out.append(f"{p}_{parts[i + 1]}")
            i += 2
            continue
        out.append(p)
        i += 1
    leaf = parts[-1]
    if leaf == "weight":
        return "/".join(out + ["kernel"]), True
    return "/".join(out + [leaf]), False


def flax_leaves(model: torch.nn.Module, collection: str = "params") -> List[FlaxLeaf]:
    """The leaves of ``model``'s flax ``collection`` (``params``: the
    parameters; ``batch_stats``: the persistent buffers), in torch's order,
    with their flax paths and shapes: the names a rule table matches
    (``parallel/rules.py``)."""
    if collection == "params":
        named = list(model.named_parameters())
    elif collection == "batch_stats":
        params = {n for n, _ in model.named_parameters()}
        named = [(n, t) for n, t in model.state_dict(keep_vars=True).items() if n not in params]
    else:
        raise ValueError(f"unknown collection {collection!r}")
    banks = {n: len(m.branches) for n, m in model.named_modules()
             if getattr(m, "branch_bank", False)}
    grouped: Dict[str, List[Tuple[int, str, torch.Tensor]]] = {}
    order: List[str] = []
    meta: Dict[str, Tuple[bool, int]] = {}
    for name, t in named:
        bank = next((b for b in banks if name.startswith(b + ".branches.")), None)
        if bank is None:
            path, transpose = flax_path(name)
            branch, nb = 0, 0
        else:
            branch_s, rest = name[len(bank) + len(".branches."):].split(".", 1)
            path, transpose = flax_path(f"{bank}.{rest}")
            branch, nb = int(branch_s), banks[bank]
        if path not in grouped:
            grouped[path] = []
            order.append(path)
            meta[path] = (transpose, nb)
        grouped[path].append((branch, name, t))
    leaves = []
    for path in order:
        transpose, nb = meta[path]
        members = sorted(grouped[path])
        shape = tuple(members[0][2].shape)
        if transpose:
            shape = shape[:-2] + (shape[-1], shape[-2])
        if nb:
            shape = (nb,) + shape
        leaves.append(FlaxLeaf(path, shape, tuple(n for _, n, _ in members), transpose))
    return leaves
