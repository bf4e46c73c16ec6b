#!/usr/bin/env python3
"""Device staging and loader prefetch against inline, on one CUDA card.

Run from the root of a checkout on a machine with a GPU:

    python3 run-scripts/torch_staging_ab.py

On chip_smoke.py's egnn_train cell (the SC25 EGNN, bf16, batch 32, through
K1 and K2) unpacked on a 4-level ladder, every level's CUDA graph captured
before the first step (``precompile: blocking``), over 356 OC20-shaped
graphs (10 train steps an epoch), it prints:

- the host's batch build alone: ms a batch of the train loader, 3 epochs;
- ``api.run_training`` for 2 epochs under each of ``double_buffer`` true /
  false and ``HYDRAGNN_NUM_WORKERS`` 2 / 0, with and without deterministic
  algorithms, each pair of legs twice in turn: the second epoch's ms a
  step (host clock, synchronized at both ends);
- the same two legs with the interpreter's thread switch interval at 0.5
  ms (``sys.setswitchinterval``): whether the staging threads' hand-offs
  of the interpreter lock cost the dispatching thread;
- one staged and one inline leg with the second epoch under
  ``torch.profiler`` (host and device activity): the host time of the
  step's ranges (``train/host_batch_build``, ``train/device_dispatch``),
  the host calls by their own time, and the device timeline
  (``device_timeline``): busy ms per stream and in all, and the compute
  stream's idle gaps, each split by whether the host call that launched
  the work after it began after the gap opened (the host was late) or
  before (the work waited on the device).

``--profiled`` runs only the two profiled legs.
"""

import contextlib
import copy
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
GRAPHS = 356
LEGS = ((True, 2), (False, 0), (True, 0), (False, 2), (True, 2), (False, 0))


GAP_NS = 50_000  # a compute-stream gap shorter than this is not counted


def device_timeline(prof, steps: int) -> None:
    """Print the profile's device activity: busy ms a step per stream and
    in all (the union of the streams' intervals), and the busiest (compute)
    stream's gaps of ``GAP_NS`` or more: their count and ms a step, split
    by whether the host call that launched the work after each gap
    started after the gap opened ("host late") or before it ("launched
    early": the work waited on the device, a stream event or a copy), and
    the largest few with their neighbours and what the other streams ran
    meanwhile."""
    import collections

    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    runtime = {e.correlation_id(): e for e in events
               if e.device_type() == DeviceType.CPU and e.name().startswith("cuda")}
    streams = collections.defaultdict(list)
    for e in events:
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            streams[e.device_resource_id()].append(e)

    def union(spans):
        total, end = 0, None
        for a, b in sorted(spans):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total

    busy = {sid: union([(e.start_ns(), e.end_ns()) for e in evs]) for sid, evs in streams.items()}
    every = union([(e.start_ns(), e.end_ns()) for evs in streams.values() for e in evs])
    first = min(e.start_ns() for evs in streams.values() for e in evs)
    last = max(e.end_ns() for evs in streams.values() for e in evs)
    print(f"  device: {every / 1e6 / steps:.2f} ms busy a step of {(last - first) / 1e6 / steps:.2f} "
          f"from the first device op to the last; by stream " + ", ".join(
              f"{sid}: {b / 1e6 / steps:.2f} ms ({len(streams[sid])} ops)"
              for sid, b in sorted(busy.items(), key=lambda kv: -kv[1])), flush=True)
    compute = max(streams, key=lambda sid: len(streams[sid]))  # the most ops
    evs = sorted(streams[compute], key=lambda e: e.start_ns())
    gaps, end, prev = [], None, None
    for e in evs:
        if end is not None and e.start_ns() - end >= GAP_NS:
            gaps.append((end, e.start_ns(), prev, e))
        if end is None or e.end_ns() > end:
            end, prev = e.end_ns(), e
    kinds = collections.Counter()
    for a, b, _, nxt in gaps:
        call = runtime.get(nxt.correlation_id())
        late = call is not None and call.start_ns() > a
        kinds["host late" if late else "launched early"] += b - a
    print(f"  compute stream {compute}: {len(gaps)} gaps of {GAP_NS / 1e3:.0f} us or more, "
          f"{sum(b - a for a, b, _, _ in gaps) / 1e6 / steps:.2f} ms a step: " + ", ".join(
              f"{k} {v / 1e6 / steps:.2f} ms" for k, v in kinds.items()), flush=True)
    for a, b, before, nxt in sorted(gaps, key=lambda g: g[0] - g[1])[:6]:
        call = runtime.get(nxt.correlation_id())
        other = [f"{e.name()[:40]} on {sid} {e.duration_ns() / 1e3:.0f} us"
                 for sid, es in streams.items() if sid != compute for e in es
                 if e.start_ns() < b and e.end_ns() > a][:3]
        print(f"    gap {(b - a) / 1e3:.0f} us at {(a - first) / 1e6:.2f} ms: after "
              f"{before.name()[:40]!r}, before {nxt.name()[:40]!r} launched by "
              f"{call.name() if call else '?'} "
              f"{'' if call is None else f'{(call.start_ns() - a) / 1e3:+.0f} us from the gap'}"
              f"; other streams meanwhile {other}", flush=True)


def leg(cs, splits, db, workers, det, profiled=False, switch=None):
    """One run_training of the cell; returns the second epoch's ms a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import hydragnn_tpu_torch.train.loop as loop
    from hydragnn_tpu_torch.api import run_training

    config = cs.graphs_config("blocking")
    config["NeuralNetwork"]["Training"].update(double_buffer=db, num_epoch=2)
    epochs = []
    real = loop.train_epoch

    def timed(loader, step_fn, state, **kw):
        last = len(epochs) == 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
              if last and profiled else contextlib.nullcontext()) as prof:
            out = real(loader, step_fn, state, **kw)
            torch.cuda.synchronize()
        epochs.append((time.perf_counter() - t0, len(loader)))
        if last and profiled:
            rows = {e.key: e for e in prof.key_averages()}
            for name in ("train/step", "train/host_batch_build", "train/device_dispatch"):
                if name in rows:
                    print(f"  range {name}: host {rows[name].cpu_time_total / 1e3:.2f} ms over "
                          f"{rows[name].count} calls", flush=True)
            print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=18),
                  flush=True)
            try:
                device_timeline(prof, len(loader))
            except Exception as e:  # noqa: BLE001 -- the leg's times still print
                print(f"  device timeline failed: {type(e).__name__}: {e}", flush=True)
        return out

    old = sys.getswitchinterval()
    with contextlib.ExitStack() as stack:
        if switch:
            sys.setswitchinterval(switch)
            stack.callback(sys.setswitchinterval, old)
        if det:
            stack.enter_context(cs.deterministic())
        stack.enter_context(cs._env(HYDRAGNN_NUM_WORKERS=workers, HYDRAGNN_DEVICE_PREFETCH=None))
        stack.enter_context(cs.swapped([(loop, "train_epoch", timed)]))
        run_training(copy.deepcopy(config), datasets=splits, seed=0)
    wall, steps = epochs[-1]
    ms = wall * 1e3 / steps
    print(f"leg double_buffer={db} workers={workers} deterministic={det} profiled={profiled} "
          f"switch={switch}: {ms:.2f} ms a step", flush=True)
    return ms


def main() -> None:
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    import chip_smoke as cs
    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.data import oc20_shaped_dataset, split_dataset
    from hydragnn_tpu_torch.ops import _build

    print(cs.card_line(), flush=True)
    _build.build(("sorted_segment_sum", "fused_edge"))
    torch.cuda.set_device(0)
    cs.warm_up_card()
    splits = split_dataset(oc20_shaped_dataset(GRAPHS), 0.9, seed=0)
    _, (tl, _, _), _ = prepare_data(copy.deepcopy(cs.graphs_config("blocking")), splits)
    tl.prefetch = 0
    for e in range(3):
        tl.set_epoch(e)
        t0 = time.perf_counter()
        n = len(list(tl))
        print(f"host batch build, epoch {e}: {(time.perf_counter() - t0) / n * 1e3:.2f} ms a "
              f"batch over {n}", flush=True)
    (REPO / "build").mkdir(exist_ok=True)
    os.chdir(tempfile.mkdtemp(prefix="staging_ab_", dir=REPO / "build"))
    if "--profiled" in sys.argv[1:]:
        for db, workers in LEGS[:2]:
            leg(cs, splits, db, workers, True, profiled=True)
        return
    for det in (True, False):
        for db, workers in LEGS:
            leg(cs, splits, db, workers, det)
    for db, workers in LEGS[:2]:
        leg(cs, splits, db, workers, True, switch=0.0005)
    for db, workers in LEGS[:2]:
        leg(cs, splits, db, workers, True, profiled=True)


if __name__ == "__main__":
    main()
