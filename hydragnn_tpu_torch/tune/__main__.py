"""``python -m hydragnn_tpu_torch.tune`` — offline launch-plan sweeps for a
config.

Counterpart of ``python -m hydragnn_tpu.tune``. Loads the config, builds
its data pipeline (the SpecLadder's pad levels come from the dataset,
exactly as training sees them), derives one sweep slot per kernel the
model launches per ladder level, and sweeps each into the tuned table. On
the CPU the wrappers run their plain versions: the timings are no launch
guidance (they key under the device "cpu" and a card's run never reads
them), but the whole plane runs — sweep, atomic table write, and the
100%-cache-hit second invocation.

    python -m hydragnn_tpu_torch.tune config.json
    python -m hydragnn_tpu_torch.tune config.json --budget 8 --trials 3
    python -m hydragnn_tpu_torch.tune config.json --cache-dir /nfs/tuned_table
    python -m hydragnn_tpu_torch.tune config.json --kernels segment_sum,fused_edge

Exit 0 with a per-slot report; the summary line counts entries, cache
hits, and fresh sweeps.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(
        prog="python -m hydragnn_tpu_torch.tune",
        description="offline CUDA launch-plan sweeps over a config's SpecLadder",
    )
    ap.add_argument("config", help="config JSON path")
    ap.add_argument("--budget", type=int, default=None,
                    help="max candidates per (kernel, slot) sweep "
                         "(default: Training.autotune_budget)")
    ap.add_argument("--trials", type=int, default=None,
                    help="timed calls per candidate (median-of-k)")
    ap.add_argument("--cache-dir", default=None,
                    help="tuned-table directory (default: the config's "
                         "Training.autotune_cache_dir resolution)")
    ap.add_argument("--kernels", default=None,
                    help="comma-separated kernel-id filter "
                         "(segment_sum,fused_edge,multi_agg,flash_attention)")
    ap.add_argument("--force", action="store_true",
                    help="re-sweep keys the table already holds")
    args = ap.parse_args(argv)

    from ..api import prepare_data
    from ..config import get_log_name_config, load_config
    from . import sweep as sweep_mod
    from .table import TunedTable, resolve_tune_cache

    config = load_config(args.config)
    config, loaders, _ = prepare_data(config)
    ladder = getattr(loaders[0], "ladder", None)
    empty = {"entries": 0, "hits": 0, "swept": 0, "results": []}
    if ladder is None:
        print("tune: the config's loader has no SpecLadder; nothing to sweep", file=sys.stderr)
        return empty

    training = config["NeuralNetwork"]["Training"]
    cache_dir = args.cache_dir or resolve_tune_cache(training, get_log_name_config(config))
    if not cache_dir:
        print("tune: tuned-table cache is disabled "
              "(Training.autotune_cache_dir=false / HYDRAGNN_TUNE_CACHE=off)"
              " — pass --cache-dir to sweep anyway", file=sys.stderr)
        return empty

    slots = sweep_mod.config_slots(config, ladder)
    if args.kernels:
        keep = {k.strip() for k in args.kernels.split(",") if k.strip()}
        slots = [s for s in slots if s[0] in keep]
    if not slots:
        print("tune: no CUDA kernel enabled by this config "
              "(use_sorted_aggregation / use_fused_edge_kernel / "
              "use_flash_attention all off?)", file=sys.stderr)
        return empty

    budget = args.budget if args.budget is not None else int(
        training.get("autotune_budget") or 0)
    trials = args.trials if args.trials is not None else sweep_mod.DEFAULT_TRIALS
    table = TunedTable(cache_dir)
    print(f"tune: {len(slots)} slot(s) over {len(ladder.specs)} ladder "
          f"level(s) -> {cache_dir}")
    census = sweep_mod.sweep_slots(slots, table, budget=budget, trials=trials,
                                   force=args.force, log=print)
    print(f"tune: {census['entries']} entr{'y' if census['entries'] == 1 else 'ies'}"
          f" ({census['hits']} cache hit(s), {census['swept']} swept)")
    return census


if __name__ == "__main__":
    main()
