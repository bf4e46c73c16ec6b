#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``hydragnn_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --kernels  # build + kernel checks only (a short first run)

Phases, each fatal on failure (exit code 1):

1. card: name and power limit from nvidia-smi, ``torch.cuda.get_device_name``;
2. build: every kernel of the served path, built by nvcc for sm_90a from
   ``hydragnn_tpu_torch/csrc/`` (one nvcc per source, all started together);
3. kernels: each kernel's wrapper on the card at the shapes the serving main
   path gives it (one real OC20-shaped packed batch of 32 graphs), held
   against its plain PyTorch version with a stated tolerance, then timed with
   CUDA events beside the plain version, one library call where PyTorch has
   one, and the bound (the larger of bytes over 3.35 TB/s and operations over
   the peak rate of the unit that runs them: the tensor cores for K2's
   product, at the TF32 rate for the three TF32 products of its f32 case);
4. serving: ``api.run_server`` on the SC25-shaped EGNN (hidden 866, 4 conv
   layers, equivariant, graph and node heads of width 889, batch 32, packed,
   bf16 mixed precision, sorted aggregation) with random weights from a seed;
   192 requests, every answer finite and of the right shape, launch counts
   showing 6 sorted-segment sums and 1 fused edge sum per served batch, and
   the served answers against the same weights run through the plain ops,
   both with the same bf16 cast (the same function) and in f32.

The last three lines are the card, the kernels JSON line and the result line.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM published peaks (dense): device memory, tensor-core products per
# operand type, and f32 arithmetic outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
# K2's f32 case splits each operand into TF32 hi + lo parts and runs three
# TF32 products (hi*hi, hi*lo, lo*hi) for f32 accuracy
MMA_PASSES = {"bfloat16": ("bfloat16", 1), "float32": ("tf32", 3)}
SEED = 0
N_REQUESTS = 192  # 1.5x the dataset: every graph once, a third of them twice


def fail(msg: str) -> None:
    print(f"CHIP_SMOKE FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0 and out.stdout.strip() != "", f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def serving_config(batch_size: int = 32, hidden: int = 866, head: int = 889):
    """The SC25-shaped EGNN cell of the JAX package's benchmark
    (bench.py ``_production_workload`` over ``_oc20_workload``)."""
    return {
        "Verbosity": {"level": 0},
        "Dataset": {
            "name": "oc20_shaped",
            "node_features": {
                "name": ["atomic_number", "cartesian_coordinates", "forces"],
                "dim": [1, 3, 3],
            },
            "graph_features": {"name": ["energy"], "dim": [1]},
        },
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "EGNN",
                "equivariance": True,
                "radius": 5.0,
                "max_neighbours": 20,
                "hidden_dim": hidden,
                "num_conv_layers": 4,
                "use_sorted_aggregation": True,
                "task_weights": [1.0, 100.0],
                "output_heads": {
                    "graph": {"num_sharedlayers": 2, "dim_sharedlayers": 50,
                              "num_headlayers": 3,
                              "dim_headlayers": [head, head, head]},
                    "node": {"num_headlayers": 3,
                             "dim_headlayers": [head, head, head], "type": "mlp"},
                },
            },
            "Variables_of_interest": {
                "input_node_features": [0, 1],
                "output_names": ["energy", "forces"],
                "output_index": [0, 2],
                "type": ["graph", "node"],
            },
            "Training": {
                "batch_size": batch_size,
                "num_epoch": 1,
                "loss_function_type": "mae",
                "num_pad_buckets": 6,
                "pack_batches": True,
                "mixed_precision": True,
                "Optimizer": {"type": "AdamW", "learning_rate": 1e-3},
            },
        },
    }


def kernel_cases(batch, device):
    """Inputs of every kernel case at the serving shapes, from a seed. The
    receiver ids are the real batch's; messages of padding edges are zero,
    as ``segment_sum`` masks them before K1 (K2 takes them unmasked)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED)
    ids = batch.receivers.to(device)
    mask = batch.edge_mask.to(device)[:, None]
    n, e = batch.num_nodes, batch.num_edges
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for c in (866, 3):
            msg = torch.randn(e, c, generator=gen, device=device)
            msg = torch.where(mask, msg, torch.zeros((), device=device)).to(dtype)
            cases.append(("K1", dtype, dict(messages=msg, segment_ids=ids, num_segments=n)))
        ci = co = 866
        cases.append(("K2", dtype, dict(
            node_recv=torch.randn(n, ci, generator=gen, device=device).to(dtype),
            edge_in=torch.randn(e, ci, generator=gen, device=device).to(dtype),
            weights=(torch.randn(ci, co, generator=gen, device=device) / math.sqrt(ci)).to(dtype),
            bias=(0.1 * torch.randn(co, generator=gen, device=device)).to(dtype),
            segment_ids=ids, num_segments=n,
        )))
    return cases


# (atol, rtol of max |plain|) per kernel and dtype. f32: the kernels sum in
# another order than index_add_/cuBLAS, a few ulp per term. bf16: both
# versions accumulate in f32 and round once, but K2's plain version rounds
# the product before adding the bias (the kernel adds it in f32), so a
# message may differ by an ulp or two of bf16 (2**-8) before the row sum.
TOLERANCES = {
    ("K1", "float32"): (1e-4, 1e-5),
    ("K1", "bfloat16"): (1e-2, 8e-3),
    ("K2", "float32"): (1e-3, 1e-4),
    ("K2", "bfloat16"): (5e-2, 2e-2),
}


# Served answers against the plain ops on the same weights, relative to each
# head's largest value, measured on an H100 at seed 0 with limits set at two
# to five times the reading. "bf16": against the same bf16 cast through the
# plain ops, the same function in another summation order: 1.1e-3 (energy),
# 2.0e-3 (forces). "f32": against the whole model in f32, what mixed
# precision costs: 2.2e-2 (energy), 4.6e-3 (forces). So a served path run
# wholly in f32 would lie about 2.2e-2 from the bf16 reference in energy,
# over its limit.
SERVE_RTOL = {
    "bf16": {"energy": 5e-3, "forces": 5e-3},
    "f32": {"energy": 5e-2, "forces": 1e-2},
}


def run_kernels(batch, device):
    import torch

    from hydragnn_tpu_torch.ops.fused_edge import (
        fused_edge_message_sum,
        reference_edge_message_sum,
    )
    from hydragnn_tpu_torch.ops.sorted_segment import (
        sorted_segment_sum,
        sorted_segment_sum_plain,
    )

    results = []
    for kernel, dtype, kw in kernel_cases(batch, device):
        dname = str(dtype)[6:]
        n, e = kw["num_segments"], kw["segment_ids"].shape[0]
        size = torch.tensor([], dtype=dtype).element_size()
        if kernel == "K1":
            c = kw["messages"].shape[1]
            fn = lambda kw=kw: sorted_segment_sum(**kw)
            plain = lambda kw=kw: sorted_segment_sum_plain(**kw)
            ids64 = kw["segment_ids"].long()
            base = torch.zeros(n, c, dtype=dtype, device=device)
            library = lambda base=base, ids64=ids64, kw=kw: base.index_add(0, ids64, kw["messages"])
            nbytes = (e * c + n * c) * size + e * 4
            ops_ms = e * c / PEAK_FLOPS["float32"] * 1e3  # one f32 add per element
            name = f"sorted_segment_sum ({dname}, C={c})"
            case = f"{dname}/C{c}"
            source, replaces = ("hydragnn_tpu_torch/csrc/sorted_segment_sum.cu",
                                "hydragnn_tpu/ops/pallas_segment.py:173")
            iters = 50
        else:
            ci, co = kw["weights"].shape
            fn = lambda kw=kw: fused_edge_message_sum(**kw)
            plain = lambda kw=kw: reference_edge_message_sum(**kw)
            library = None
            nbytes = ((n + e) * ci + ci * co + co + n * co) * size + e * 4
            unit, passes = MMA_PASSES[dname]
            # the product on the tensor cores; the gather add + relu and the
            # bias + relu + row sum in f32 outside them
            ops_ms = (passes * 2 * e * ci * co / PEAK_FLOPS[unit]
                      + (2 * e * ci + 3 * e * co) / PEAK_FLOPS["float32"]) * 1e3
            name = f"fused_edge_message_sum ({dname}, {ci}x{co})"
            case = f"{dname}/{ci}x{co}"
            source, replaces = ("hydragnn_tpu_torch/csrc/fused_edge.cu",
                                "hydragnn_tpu/ops/pallas_fused_edge.py:225")
            iters = 10
        out_k = fn()
        out_p = plain()
        torch.cuda.synchronize()
        check(out_k.dtype == dtype and out_k.shape == out_p.shape,
              f"{name}: kernel output {out_k.dtype} {tuple(out_k.shape)} vs plain "
              f"{out_p.dtype} {tuple(out_p.shape)}")
        err = float((out_k.float() - out_p.float()).abs().max())
        scale = float(out_p.float().abs().max())
        atol, rtol = TOLERANCES[(kernel, dname)]
        tol = atol + rtol * scale
        print(f"check {name}: max_abs_err {err:.6g} (tolerance {tol:.6g} = "
              f"{atol} + {rtol} x max|plain| {scale:.6g})", flush=True)
        check(math.isfinite(err) and err <= tol, f"{name}: kernel disagrees with its plain version")
        ms = cuda_ms(fn, iters)
        plain_ms = cuda_ms(plain, max(iters // 5, 2))
        library_ms = cuda_ms(library, iters) if library is not None else None
        bound_bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        bound_ops_ms = ops_ms
        results.append(dict(
            kernel=kernel, case=case, name=name, route="cuda", source=source,
            replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(bound_bytes_ms, bound_ops_ms),
            bound_by="bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
            library_ms=library_ms,
            shape=dict(E=e, N=n, **({"C": kw["messages"].shape[1]} if kernel == "K1"
                                     else {"Ci": kw["weights"].shape[0], "Co": kw["weights"].shape[1]})),
        ))
        print(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}, bound "
              f"{results[-1]['bound_ms']:.4f} ms ({results[-1]['bound_by']})", flush=True)
        del out_k, out_p
    return results


def profile_batch(server, graphs) -> None:
    """Where one served batch spends its time: host batching, the forward's
    wall time (median of 5), and one forward under torch.profiler: device
    time by kernel and the device's busy share of that forward."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hydragnn_tpu_torch.data.graph import batch_graphs

    spec = server.ladder.specs[-1]
    gs, n, e = [], 0, 0
    for g in graphs:  # the first graphs that fit one batch, as the batcher takes them
        if len(gs) == spec.n_graphs - 1 or n + g.num_nodes > spec.n_nodes - 1 \
                or e + g.num_edges > spec.n_edges:
            break
        gs.append(g)
        n, e = n + g.num_nodes, e + g.num_edges
    t0 = time.perf_counter()
    batch = batch_graphs(gs, server.ladder.select_for(gs), sort_edges=server.sort_edges)
    host_ms = (time.perf_counter() - t0) * 1e3
    walls = []
    for _ in range(6):
        t0 = time.perf_counter()
        server.forward(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    forward_ms = float(np.median(walls[1:]))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.forward(batch)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"profile: batch of {len(gs)} graphs, host batching {host_ms:.2f} ms, forward "
          f"{forward_ms:.2f} ms (median of 5), under the profiler {prof_wall_ms:.2f} ms "
          f"with the device busy {busy_ms:.2f} ms ({100 * busy_ms / prof_wall_ms:.1f}%)",
          flush=True)
    for dev_us, key, count in rows[:14]:
        print(f"profile: {dev_us / 1e3:9.3f} ms {100 * dev_us / 1e3 / max(busy_ms, 1e-9):5.1f}% "
              f"x{count:<4d} {key[:100]}", flush=True)


def run_serving(config, graphs, device, n_requests: int):
    import numpy as np
    import torch

    from hydragnn_tpu_torch.api import run_server
    from hydragnn_tpu_torch.data.graph import PadSpec, _round_up, batch_graphs
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.ops.fused_edge import fused_edge_message_sum
    from hydragnn_tpu_torch.ops.sorted_segment import sorted_segment_sum

    tr, va, te = split_dataset(graphs, 0.9, seed=0)
    arch, training = config["NeuralNetwork"]["Architecture"], config["NeuralNetwork"]["Training"]
    print(f"serve: {arch['mpnn_type']} hidden {arch['hidden_dim']}, {arch['num_conv_layers']} "
          f"conv layers, equivariant {arch['equivariance']}, heads "
          f"{arch['output_heads']['graph']['dim_headlayers']} / "
          f"{arch['output_heads']['node']['dim_headlayers']}, batch {training['batch_size']}, "
          f"packed {training['pack_batches']}, mixed precision {training['mixed_precision']}, "
          f"sorted aggregation {arch['use_sorted_aggregation']}, random weights (seed {SEED})",
          flush=True)
    t0 = time.perf_counter()
    server = run_server(config, datasets=(tr, va, te), device=device, seed=SEED)
    check(server.wait_ready(timeout=600), f"server warm-up failed: {server.failed}")
    print(f"serve: ready in {time.perf_counter() - t0:.2f} s (warm-up "
          f"{server.warmup_compiled})", flush=True)
    requests = [graphs[i % len(graphs)] for i in range(n_requests)]
    batches0 = server.stats()["batches"]

    # the main path: every launch count from 0, read right after
    sorted_segment_sum.launches = 0
    sorted_segment_sum.launches_by_case.clear()
    fused_edge_message_sum.launches = 0
    fused_edge_message_sum.launches_by_case.clear()
    t_start = time.perf_counter()
    handles = [server.submit(g) for g in requests]
    results = [h.result(timeout=600) for h in handles]
    t_end = max(h.done_at for h in handles)
    torch.cuda.synchronize()
    k1 = sorted_segment_sum.launches
    k1_cases = dict(sorted_segment_sum.launches_by_case)
    k2 = fused_edge_message_sum.launches
    k2_cases = dict(fused_edge_message_sum.launches_by_case)
    stats = server.stats()
    batches = stats["batches"] - batches0

    lat = np.asarray([h.done_at - h.submitted_at for h in handles]) * 1e3
    gps = n_requests / (t_end - t_start)
    print(f"serve: {n_requests} requests in {batches} batches, {gps:.1f} graphs/s, "
          f"latency p50 {np.percentile(lat, 50):.2f} ms p99 {np.percentile(lat, 99):.2f} ms",
          flush=True)
    print(f"serve: launches K1 {k1} {k1_cases}, K2 {k2} {k2_cases}", flush=True)
    per_batch = {k: round(1e3 * v / max(batches, 1), 3) for k, v in stats["seconds"].items()}
    print(f"serve: ms per batch in the serve loop (all batches since start, warm-up "
          f"excluded): {per_batch}", flush=True)
    check(stats["failed_batches"] == 0 and stats["rejected"] == 0, f"serving stats {stats}")
    check(batches > 0 and k1 == 6 * batches, f"K1 launched {k1} times in {batches} batches, expected 6 per batch")
    check(k2 == batches, f"K2 launched {k2} times in {batches} batches, expected 1 per batch")
    for g, r in zip(requests, results):
        check(set(r) == {"energy", "forces"}, f"served heads {sorted(r)}")
        check(r["energy"].shape == (1,) and r["forces"].shape == (g.num_nodes, 3),
              f"served shapes {r['energy'].shape} {r['forces'].shape} for {g.num_nodes} nodes")
        check(all(np.isfinite(v).all() for v in r.values()), "non-finite served output")

    # the same weights through the plain ops (unsorted route, no kernels):
    # with the server's bf16 cast (the same function, other summation
    # order), and in f32 (what mixed precision costs)
    ref_cfg = copy.deepcopy(config)
    arch = ref_cfg["NeuralNetwork"]["Architecture"]
    arch["use_sorted_aggregation"] = False
    arch["use_fused_edge_kernel"] = False
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.train.loop import cast_batch_bf16, mp_cast_model

    ref_cfg = update_config(ref_cfg, tr, va, te)
    ref = create_model(ref_cfg, device=device)
    ref.load_state_dict(server.model.state_dict())
    refs = {"bf16": (mp_cast_model(ref), cast_batch_bf16), "f32": (ref, lambda b: b)}
    worst = {(r, k): 0.0 for r in refs for k in SERVE_RTOL[r]}
    scale = dict.fromkeys(worst, 0.0)
    chunk = 32
    with torch.inference_mode():
        for s in range(0, min(len(graphs), n_requests), chunk):
            gs = requests[s:min(s + chunk, len(graphs), n_requests)]
            spec = PadSpec(
                n_nodes=_round_up(sum(g.num_nodes for g in gs) + 1, 8),
                n_edges=_round_up(sum(g.num_edges for g in gs), 128),
                n_graphs=len(gs) + 1,
            )
            batch = batch_graphs(gs, spec, sort_edges=True).to(device)
            for r, (model, cast) in refs.items():
                out = model(cast(batch))
                off = 0
                for i, g in enumerate(gs):
                    got = results[s + i]
                    want = {"energy": out["energy"][i].float().cpu().numpy(),
                            "forces": out["forces"][off:off + g.num_nodes].float().cpu().numpy()}
                    off += g.num_nodes
                    for k in SERVE_RTOL[r]:
                        worst[r, k] = max(worst[r, k], float(np.abs(got[k] - want[k]).max()))
                        scale[r, k] = max(scale[r, k], float(np.abs(want[k]).max()))
    for r in refs:
        rel = {k: worst[r, k] / max(scale[r, k], 1e-12) for k in SERVE_RTOL[r]}
        print(f"serve vs {r} plain ops: max abs err "
              f"{ {k: worst[r, k] for k in rel} }, max |ref| { {k: scale[r, k] for k in rel} }, "
              f"relative {rel} (tolerance {SERVE_RTOL[r]} of max |ref|)", flush=True)
        check(all(rel[k] <= SERVE_RTOL[r][k] for k in rel),
              f"served outputs disagree with the {r} plain model")
    profile_batch(server, graphs)
    server.close()
    return dict(k1=k1, k1_cases=k1_cases, k2=k2, k2_cases=k2_cases,
                batches=batches, graphs_per_s=gps,
                p50_ms=float(np.percentile(lat, 50)), p99_ms=float(np.percentile(lat, 99)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", action="store_true",
                    help="build and check the kernels only (no serving phase)")
    args = ap.parse_args()

    if not (REPO / "hydragnn_tpu_torch" / "__init__.py").is_file():
        fail(f"no hydragnn_tpu_torch package beside {__file__}: run from a checkout")
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA GPU")
    import hydragnn_tpu_torch

    check(Path(hydragnn_tpu_torch.__file__).resolve().is_relative_to(REPO),
          f"imported {hydragnn_tpu_torch.__file__}, not the checkout's package")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"device {kind} x{torch.cuda.device_count()}", flush=True)

    from hydragnn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    seconds = _build.build(["sorted_segment_sum", "fused_edge"])
    print(f"build: {seconds} s per kernel from {_build.CSRC.relative_to(REPO)}/ "
          f"(wall {time.perf_counter() - t0:.2f} s; nvcc {' '.join(_build.NVCC_FLAGS)}) "
          f"into {_build.BUILD_DIR.relative_to(REPO)}/", flush=True)
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.data.synthetic import oc20_shaped_dataset

    config = serving_config()
    graphs = oc20_shaped_dataset(128)
    _, (train_loader, _, _), _ = prepare_data(
        copy.deepcopy(config), datasets=split_dataset(graphs, 0.9, seed=0)
    )
    batch = next(iter(train_loader))
    print(f"batch: {int(batch.graph_mask.sum())} graphs, {int(batch.node_mask.sum())}/"
          f"{batch.num_nodes} nodes, {int(batch.edge_mask.sum())}/{batch.num_edges} edges",
          flush=True)
    kernels = run_kernels(batch, device)
    torch.cuda.synchronize()

    if not args.kernels:
        served = run_serving(config, graphs, device, N_REQUESTS)
        cases = {**served["k1_cases"], **served["k2_cases"]}
        for k in kernels:
            k["launches"] = cases.get(k["case"], 0)
        check(served["k1"] > 0 and served["k2"] > 0, "a kernel of the path never launched")
        print(f"serving: {served['graphs_per_s']:.1f} graphs/s, p50 {served['p50_ms']:.2f} ms, "
              f"p99 {served['p99_ms']:.2f} ms on {card}", flush=True)
    else:
        for k in kernels:
            k["launches"] = 0
    # the bf16 fused edge case is measured but not on the served path (the
    # last conv runs in f32 there), so it stays out of the kernels line
    on_path = [k for k in kernels if args.kernels or k["launches"] > 0]
    off_path = [k for k in kernels if k not in on_path]
    for k in off_path:
        print(f"measured off the served path: {json.dumps(k)}", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card, flush=True)
    print(json.dumps({"kernels": [{k: v[k] for k in keys} for v in on_path]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
