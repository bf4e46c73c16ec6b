#!/usr/bin/env python3
"""How often the served GPS performer leaves its plain-version reference,
and which side moves, on one CUDA card.

Run from the root of a checkout on a machine with a GPU:

    python3 run-scripts/torch_performer_repeat.py [--root DIR] [--servers 3]
        [--repeats 8] [--deterministic]

``--root`` names the checkout whose ``chip_smoke.py`` and
``hydragnn_tpu_torch`` run (this one by default; an unpacked older commit to
compare). On chip_smoke.py's ``zoo performer`` cell (GIN 256 x 4 under GPS
performer attention, 8 heads, bf16 mixed precision, batch 16), each of
``--servers`` fresh servers answers the cell's 16 requests ``--repeats``
times. Each time the script holds the answers against the same bf16 cast
through the kernels' plain versions on the server's own micro-batches, as
``run_zoo`` does (its limits: 1e-3 of the largest row, 1e-5 the median),
and counts:

- passes that fail those limits, with the largest row's distance;
- answers that differ bit-wise from the first pass of the same server with
  the same micro-batches (the served route against itself);
- references that differ bit-wise from the first reference (the plain
  route against itself);

and, on the first served batch, how many distinct results 50 calls of the
performer's per-graph sum (``segment_sum_plain``: ``index_add_`` in f32 on
``[N, 8, 32, 32]`` rows) give, in f32 and cast to bf16. ``--deterministic``
runs everything under PyTorch's deterministic algorithms.
"""

import argparse
import contextlib
import copy
import sys
import time
from pathlib import Path

LIMITS = {"energy": (1e-3, 1e-5), "forces": (1e-3, 1e-5)}  # chip_smoke.py ZOO_RTOL


def rows_reading(got, want):
    """Per head (largest row, median row) of |got - want| over the head's
    largest |want|, as chip_smoke.py's ``_rows_gate`` reads them."""
    import numpy as np

    out = {}
    for k, w in want.items():
        g = got[k]
        scale = max(float(np.abs(w).max()), 1e-12)
        per_row = np.abs(g - w).reshape(len(w), -1).max(axis=1) / scale
        out[k] = (float(per_row.max()), float(np.median(per_row)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--servers", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=8)
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this script needs a CUDA GPU")
    import chip_smoke as cs
    import hydragnn_tpu_torch

    assert Path(hydragnn_tpu_torch.__file__).resolve().is_relative_to(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from hydragnn_tpu_torch.api import run_server
    from hydragnn_tpu_torch.data.graph import batch_graphs
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.ops import _build
    from hydragnn_tpu_torch.ops.sorted_segment import segment_sum_plain
    from hydragnn_tpu_torch.train.loop import cast_batch_bf16, mp_cast_model

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t0 = time.perf_counter()
    _build.build(("sorted_segment_sum",))
    print(f"root {root}: card {cs.card_line()}; K1 built in {time.perf_counter() - t0:.1f} s; "
          f"deterministic {args.deterministic}", flush=True)
    graphs = cs.gps_pna_dataset(128)
    config = cs.performer_cell_config()
    splits = split_dataset(graphs, 0.9, seed=0)
    requests = graphs[:16]
    mode = cs.deterministic() if args.deterministic else contextlib.nullcontext()
    totals = {"passes": 0, "failed": 0, "served_moved": 0, "reference_moved": 0}
    worst = {k: 0.0 for k in LIMITS}
    with mode:
        for s in range(args.servers):
            server = run_server(copy.deepcopy(config), datasets=splits, device=device,
                                seed=cs.SEED)
            assert server.wait_ready(timeout=600), server.failed
            first_served, first_ref = {}, {}
            ref_model = mp_cast_model(server.model)
            for r in range(args.repeats):
                handles = [server.submit(g) for g in requests]
                results = [h.result(timeout=600) for h in handles]
                groups = {}
                for i, h in enumerate(handles):
                    groups.setdefault(h.batch_index, []).append(i)
                key = tuple(tuple(idx) for idx in groups.values())
                order = [i for idx in groups.values() for i in idx]
                want = {"energy": [], "forces": []}
                for idx in groups.values():
                    gs = [requests[i] for i in idx]
                    batch = batch_graphs(gs, server.ladder.select_for(gs),
                                         sort_edges=server.sort_edges).to(device)
                    with torch.inference_mode(), cs.plain_versions(cs.PLAIN):
                        ref = ref_model(cast_batch_bf16(batch))
                    want["energy"].append(ref["energy"].float().cpu().numpy()[:len(gs)])
                    want["forces"].append(ref["forces"].float().cpu().numpy()[
                        np.flatnonzero(batch.node_mask.cpu().numpy())])
                    if s == 0 and r == 0 and idx is next(iter(groups.values())):
                        gen = torch.Generator(device=device).manual_seed(cs.SEED)
                        kv = torch.randn((batch.num_nodes, 8, 32, 32), generator=gen,
                                         device=device)
                        outs = [segment_sum_plain(kv, batch.node_graph, batch.num_graphs)
                                for _ in range(50)]
                        f32 = len({o.cpu().numpy().tobytes() for o in outs})
                        bf16 = len({o.bfloat16().float().cpu().numpy().tobytes() for o in outs})
                        print(f"segment_sum_plain on [{batch.num_nodes}, 8, 32, 32] rows into "
                              f"{batch.num_graphs} graphs, 50 calls: {f32} distinct results in "
                              f"f32, {bf16} cast to bf16", flush=True)
                got = {"energy": np.concatenate([results[i]["energy"] for i in order])
                       .reshape(-1, 1),
                       "forces": np.concatenate([results[i]["forces"] for i in order])}
                want = {k: np.concatenate(v).reshape(got[k].shape) for k, v in want.items()}
                reading = rows_reading(got, want)
                failed = any(reading[k][0] > LIMITS[k][0] or reading[k][1] > LIMITS[k][1]
                             for k in LIMITS)
                if key in first_served:
                    totals["served_moved"] += any(
                        not np.array_equal(got[k], first_served[key][k]) for k in got)
                    totals["reference_moved"] += any(
                        not np.array_equal(want[k], first_ref[key][k]) for k in want)
                else:
                    first_served[key], first_ref[key] = got, want
                totals["passes"] += 1
                totals["failed"] += failed
                for k in LIMITS:
                    worst[k] = max(worst[k], reading[k][0])
                print(f"server {s} pass {r}: {len(groups)} micro-batch(es); rows (largest, "
                      f"median) {reading}{'  FAILS the limits' if failed else ''}", flush=True)
            server.close()
    print(f"root {root}: {totals['failed']} of {totals['passes']} passes fail the limits "
          f"{LIMITS}; largest rows {worst}; the served answers moved in "
          f"{totals['served_moved']} repeats, the references in {totals['reference_moved']} "
          f"(deterministic {args.deterministic}); card {cs.card_line()}", flush=True)


if __name__ == "__main__":
    main()
