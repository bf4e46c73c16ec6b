#!/usr/bin/env python3
"""Where the host waits in the port's train step, on one CUDA card.

Run from the root of a checkout on a machine with a GPU:

    python3 run-scripts/torch_step_host.py [--root DIR]

``--root`` takes the package and ``chip_smoke.py`` from another checkout
(an unpacked ``git archive`` of an older commit, say), so two versions can
be compared in one call. On 10 train batches of chip_smoke.py's egnn_train
cell (the SC25 EGNN, bf16, batch 32, through K1 and K2) it prints:

- the calls of one train step, and of one step with the numerics bundle,
  that PyTorch flags as synchronizing
  (``torch.cuda.set_sync_debug_mode``), by their innermost frames in the
  package, or for those of the backward's thread the autograd node it
  was running;
- the host's dispatch time of 10 steps against their wall time up to the
  card's last kernel (equal when the host waits for the card every step);
- the host time of ``StepTelemetry``'s per-step calls over 12 epochs of
  those steps with ``{"enabled": True}`` (``on_step``, the batch census
  inside it, and the window flush), per call;
- 12 interleaved epochs with telemetry off and on: the median ms a step
  of each (host clock around an epoch that ends with its loss read-back).
"""

import argparse
import collections
import contextlib
import copy
import statistics
import sys
import tempfile
import threading
import time
import traceback
import warnings
from pathlib import Path

EPOCHS = 12


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose package and chip_smoke.py to measure")
    root = Path(ap.parse_args().root).resolve()
    sys.path.insert(0, str(root))

    import torch

    import chip_smoke as cs
    import hydragnn_tpu_torch.obs.telemetry as tel
    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.data.synthetic import oc20_shaped_dataset
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.ops import _build
    from hydragnn_tpu_torch.train.loop import make_train_step, train_epoch

    if not torch.cuda.is_available():
        cs.fail("needs a CUDA GPU")
    print(f"root {root}", flush=True)
    print(cs.card_line(), flush=True)
    _build.build(("sorted_segment_sum", "fused_edge"))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cs.warm_up_card()
    splits = split_dataset(oc20_shaped_dataset(cs.TRAIN_GRAPHS), 0.9, seed=0)
    config, (loader, _, _), _ = prepare_data(copy.deepcopy(cs.train_config()), splits)
    loader.set_epoch(0)
    batches = list(loader)[:10]
    model = create_model(config, device=device, seed=cs.SEED)
    (root / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root / "build") as work, contextlib.chdir(work):
        st = cs._train_copy(model, device)
        step = make_train_step(st.model, mixed_precision=True)
        for _ in range(2):
            train_epoch(batches, step, st)

        sites = collections.Counter()
        running = threading.local()  # the backward node the engine runs
        backward = torch.Tensor.backward

        def named_backward(self, *a, **k):
            todo, seen = [self.grad_fn], set()
            while todo:
                fn = todo.pop()
                if fn is None or fn in seen:
                    continue
                seen.add(fn)
                fn.register_prehook(lambda grads, name=fn.name(): setattr(running, "node",
                                                                          name))
                todo.extend(f for f, _ in fn.next_functions)
            return backward(self, *a, **k)

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchronizing" not in str(message):  # the mode's own prototype notice
                return
            frames = [f for f in traceback.extract_stack()[:-1]
                      if "hydragnn_tpu_torch" in f.filename]
            sites[" <- ".join(f"{Path(f.filename).name}:{f.lineno}" for f in frames[::-1][:3])
                  or f"(autograd engine, in {getattr(running, 'node', '?')})"] += 1

        nstep = make_train_step(st.model, mixed_precision=True, numerics=True)
        nstep(st, batches[0])  # its cached layouts
        for label, fn in (("train step", step), ("numerics step", nstep)):
            sites.clear()
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = show
                torch.Tensor.backward = named_backward
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    fn(st, batches[1])
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                    torch.Tensor.backward = backward
            print(f"synchronizing calls in one {label}: {sum(sites.values())}", flush=True)
            for site, n in sites.most_common():
                print(f"  x{n} {site}", flush=True)

        host, wall = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches:
                step(st, b)
            host.append((time.perf_counter() - t0) * 1e3 / len(batches))
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3 / len(batches))
        print(f"10 steps, 5 times: host dispatch {statistics.median(host):.3f} ms a step, "
              f"wall {statistics.median(wall):.3f} ms a step (medians)", flush=True)

        telem = tel.StepTelemetry(tel.resolve_telemetry({"Telemetry": {"enabled": True}}),
                                  "step_host", device=device)
        for _ in range(2):
            train_epoch(batches, step, st, telemetry=telem)
        spent = collections.defaultdict(list)

        def timed(name, fn):
            def call(*a, **k):
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    spent[name].append(time.perf_counter() - t)
            return call

        census = tel.batch_census
        tel.batch_census = timed("batch_census", census)
        telem.on_step = timed("on_step", telem.on_step)
        telem.flush = timed("flush", telem.flush)
        ms = {"off": [], "on": []}
        try:
            for i in range(EPOCHS):
                for leg in (("off", "on") if i % 2 == 0 else ("on", "off")):
                    t0 = time.perf_counter()
                    train_epoch(batches, step, st, telemetry=telem if leg == "on" else None)
                    ms[leg].append((time.perf_counter() - t0) * 1e3 / len(batches))
        finally:
            tel.batch_census = census
            telem.close()
        for name in ("on_step", "batch_census", "flush"):
            v = sorted(spent[name])
            print(f"telemetry {name}: {len(v)} calls, p50 {v[len(v) // 2] * 1e3:.4f} ms, "
                  f"max {v[-1] * 1e3:.4f} ms, {sum(v) * 1e3 / len(spent['on_step']):.4f} ms "
                  f"a step", flush=True)
        print(f"{EPOCHS} interleaved epochs: telemetry off {statistics.median(ms['off']):.3f} ms "
              f"a step, on {statistics.median(ms['on']):.3f} ms a step (medians)", flush=True)


if __name__ == "__main__":
    main()
