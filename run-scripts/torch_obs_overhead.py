#!/usr/bin/env python3
"""Per-step cost of the port's telemetry and numerics on one CUDA card.

Run from the root of a checkout on a machine with a GPU:

    python3 run-scripts/torch_obs_overhead.py

On 20 train batches of chip_smoke.py's egnn_train cell (the SC25 EGNN,
bf16, batch 32, through K1 and K2) it prints the host time of
``StepTelemetry.step_begin`` + ``on_step``, then 6 interleaved trials of
four epochs over those batches (ms per step, host clock around a
synchronised epoch): telemetry off, telemetry on (``{"enabled": True}``),
the numerics step with its NaN watch, and the numerics step alone; the
host time to enqueue one step on an idle card without and with numerics;
then, under ``torch.profiler``, the device time and kernel count of one step
without and with numerics, and the kernels the numerics step adds.
"""

import contextlib
import copy
import statistics
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

TRIALS = 6
BATCHES = 20
PROFILED_STEPS = 5


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.data.synthetic import oc20_shaped_dataset
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.obs.numerics import NanWatch
    from hydragnn_tpu_torch.obs.telemetry import StepTelemetry, resolve_telemetry
    from hydragnn_tpu_torch.ops import _build
    from hydragnn_tpu_torch.train.loop import make_train_step, train_epoch

    if not torch.cuda.is_available():
        cs.fail("needs a CUDA GPU")
    print(cs.card_line(), flush=True)
    _build.build(("sorted_segment_sum", "fused_edge"))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cs.warm_up_card()
    splits = split_dataset(oc20_shaped_dataset(cs.TRAIN_GRAPHS), 0.9, seed=0)
    config, (loader, _, _), _ = prepare_data(copy.deepcopy(cs.train_config()), splits)
    loader.set_epoch(0)
    batches = list(loader)[:BATCHES]
    model = create_model(config, device=device, seed=cs.SEED)
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as work, contextlib.chdir(work):
        st = cs._train_copy(model, device)
        step = make_train_step(st.model, mixed_precision=True)
        nstep = make_train_step(st.model, mixed_precision=True, numerics=True)
        telem = StepTelemetry(resolve_telemetry({"Telemetry": {"enabled": True}}), "overhead",
                              device=device)
        t0 = time.perf_counter()
        for i in range(2000):
            telem.step_begin()
            telem.on_step(batches[i % BATCHES], 0.0, real_graphs=32)
        torch.cuda.synchronize()
        print(f"host cost of step_begin + on_step: "
              f"{(time.perf_counter() - t0) / 2000 * 1e6:.1f} us", flush=True)
        legs = {"off": lambda: train_epoch(batches, step, st),
                "telemetry": lambda: train_epoch(batches, step, st, telemetry=telem),
                "numerics": lambda: train_epoch(batches, nstep, st,
                                                nan_watch=NanWatch(diagnose=nstep._nan_diagnose)),
                "numerics, no watch": lambda: train_epoch(batches, nstep, st)}
        for _ in range(2):  # warm every leg
            for fn in legs.values():
                fn()
        times = {k: [] for k in legs}
        for trial in range(TRIALS):
            for k, fn in legs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[k].append((time.perf_counter() - t0) / len(batches) * 1e3)
            print("trial", trial, {k: round(v[-1], 3) for k, v in times.items()}, flush=True)
        base = statistics.median(times["off"])
        for k, v in times.items():
            print(f"{k}: median {statistics.median(v):.3f} ms a step "
                  f"({(statistics.median(v) / base - 1) * 100:+.2f}%), min {min(v):.3f}",
                  flush=True)
        # the host's share: the time to enqueue one step on an idle card
        # (the call returns before the card is done), against the step's
        # time to the card's end
        for label, fn in (("off", lambda b: step(st, b)), ("numerics", lambda b: nstep(st, b))):
            host, whole = [], []
            for i in range(2 * BATCHES):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(batches[i % BATCHES])
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                host.append((t1 - t0) * 1e3)
                whole.append((time.perf_counter() - t0) * 1e3)
            print(f"{label}: host enqueue {statistics.median(host):.3f} ms a step (min "
                  f"{min(host):.3f}), to the card's end {statistics.median(whole):.3f} ms",
                  flush=True)
        kernels = {}
        for label, fn in (("off", lambda: step(st, batches[0])),
                          ("numerics", lambda: nstep(st, batches[0]))):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(PROFILED_STEPS):
                    fn()
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
            kernels[label] = {e.key: (e.self_device_time_total / PROFILED_STEPS / 1e3,
                                      e.count / PROFILED_STEPS) for e in ev}
            print(f"{label}: device {sum(v[0] for v in kernels[label].values()):.3f} ms a step, "
                  f"{sum(v[1] for v in kernels[label].values()):.0f} kernels a step", flush=True)
        added = {k: (v[0] - kernels["off"].get(k, (0, 0))[0],
                     v[1] - kernels["off"].get(k, (0, 0))[1])
                 for k, v in kernels["numerics"].items()}
        for k, (ms, n) in sorted(added.items(), key=lambda kv: -kv[1][0])[:25]:
            print(f"   added {k[:100]}: {ms:+.4f} ms x{n:+.0f}", flush=True)
        telem.close()


if __name__ == "__main__":
    main()
