"""Verbosity-leveled, rank-aware printing and run logging.

Counterpart of ``hydragnn_tpu/utils/printing.py`` (reference:
hydragnn/utils/print/print_utils.py). Levels 0-4 as in the reference
(print_utils.py:20-27); ``print_distributed`` prints on rank 0 only unless
the level is >= 4 (rank-prefixed everywhere, print_utils.py:42-53);
``setup_log`` attaches python logging to ``./logs/<name>/run.log`` and the
console (print_utils.py:63-91); ``print_model`` is the parameter summary in
the flax layout, so it names, shapes and counts what the JAX package's
does for the same config.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Iterable

from .ranks import is_primary, rank


def print_master(*args, verbosity_level: int = 2, verbosity: int = 2) -> None:
    if verbosity >= verbosity_level and is_primary():
        print(*args)


def print_distributed(verbosity: int, *args) -> None:
    """(reference: print_utils.py:42-53)"""
    if verbosity >= 4:
        print(f"[rank {rank()}]", *args)
    elif verbosity >= 1 and is_primary():
        print(*args)


def iterate_tqdm(iterable: Iterable, verbosity: int, **kwargs):
    """Rank-gated progress iterator (reference: print_utils.py:56-60)."""
    if verbosity >= 2 and is_primary():
        try:
            from tqdm import tqdm

            return tqdm(iterable, **kwargs)
        except ImportError:
            return iterable
    return iterable


def setup_log(name: str, path: str = "./logs") -> logging.Logger:
    """(reference: print_utils.py:63-91)"""
    run_dir = os.path.join(path, name)
    os.makedirs(run_dir, exist_ok=True)
    logger = logging.getLogger("hydragnn_tpu_torch")
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter(
        f"%(asctime)s [rank {rank()}] %(levelname)s: %(message)s"
    )
    fh = logging.FileHandler(os.path.join(run_dir, "run.log"))
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    ch = logging.StreamHandler(sys.stdout)
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    return logger


def print_model(model, verbosity: int = 2) -> int:
    """Parameter summary: each flax-layout parameter leaf's path, shape and
    size, and the total count (reference: print_model,
    hydragnn/utils/model/model.py:289-297). Returns the total; prints at
    verbosity >= 2 on rank 0."""
    import numpy as np

    from ..bridge import flax_leaves

    total = 0
    lines = []
    for leaf in sorted(flax_leaves(model), key=lambda l: tuple(l.path.split("/"))):
        n = int(np.prod(leaf.shape)) if leaf.shape else 1
        total += n
        lines.append(f"  {leaf.path}: {tuple(leaf.shape)} = {n}")
    if verbosity >= 2 and is_primary():
        print("\n".join(lines))
        print(f"Total trainable parameters: {total}")
    return total
