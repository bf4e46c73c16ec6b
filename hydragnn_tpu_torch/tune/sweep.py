"""The offline launch-plan sweep: measure candidates, persist winners.

Counterpart of ``hydragnn_tpu/tune/sweep.py``. Each candidate is pinned
(``runtime.forced``) and the kernel's wrapper called on synthetic but
shape-exact operands: each ladder slot's padded sizes, the model's channel
widths, ascending segment ids with the padding edges on the last row —
the same static facts the wrappers hand :func:`tune.runtime.tile_plan`, so
a sweep's table keys are the keys training will look up. On the card a
candidate's time is the median of its CUDA-event times over ``trials``
calls after ``warmup`` untimed ones, and a candidate whose outputs part
from the default plan's by more than ``plans.AGREEMENT_RTOL`` is dropped
(a launch that computes something else never wins). On the CPU the wrappers run their
plain versions, which no plan reaches: the sweep keys under the device
"cpu" (invisible to a card's run) and exercises the plane's bookkeeping,
not its timings.
"""

from __future__ import annotations

import statistics
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import plans
from .runtime import forced
from .table import TunedTable, device_kind

DEFAULT_TRIALS = 5
DEFAULT_WARMUP = 2


def measure(fn: Callable[[], Any], n_trials: int = DEFAULT_TRIALS,
            n_warmup: int = DEFAULT_WARMUP, device=None) -> float:
    """Median seconds of ``fn()`` over ``n_trials`` calls after ``n_warmup``
    untimed ones: CUDA-event times on a card, host times on the CPU."""
    import torch

    cuda = device is not None and torch.device(device).type == "cuda"
    for _ in range(max(1, n_warmup)):
        fn()
    times = []
    for _ in range(max(1, n_trials)):
        if cuda:
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def sorted_ids(edges: int, num_segments: int, real_edges: Optional[int] = None):
    """Ascending segment ids: ``real_edges`` (3/4 of the slot when None)
    spread evenly over the first ``num_segments - 1`` rows, the padding
    edges on the last row — the layout of a receiver-sorted padded batch."""
    import numpy as np

    real = int(edges * 3 // 4) if real_edges is None else int(real_edges)
    rows = max(num_segments - 1, 1)
    ids = np.full(edges, num_segments - 1, np.int64)
    ids[:real] = np.minimum(np.arange(real) * rows // max(real, 1), rows - 1)
    return ids


def build_call(kernel: str, shapes: Dict[str, Any], dtype: str, device="cpu",
               seed: int = 0) -> Callable[[], Any]:
    """A zero-argument call of ``kernel``'s wrapper on synthetic shape-exact
    operands (inference: no autograd) on ``device``."""
    import numpy as np
    import torch

    dt = getattr(torch, str(dtype))
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32).to(device, dt)

    if kernel in (plans.SEGMENT, plans.FUSED_EDGE, plans.MULTI_AGG):
        e, n = int(shapes["edges"]), int(shapes["num_segments"])
        ids = torch.as_tensor(sorted_ids(e, n)).to(device)
    if kernel == plans.SEGMENT:
        from ..ops.sorted_segment import sorted_segment_sum

        msg = arr(e, int(shapes["channels"]))
        return lambda: sorted_segment_sum(msg, ids, n)
    if kernel == plans.FUSED_EDGE:
        from ..ops.fused_edge import fused_edge_message_sum

        ci, co = int(shapes["ci"]), int(shapes["co"])
        nrecv, ein = arr(n, ci), arr(e, ci)
        w, b = arr(ci, co) * (1.0 / ci ** 0.5), arr(co)
        return lambda: fused_edge_message_sum(nrecv, ein, w, b, ids, n)
    if kernel == plans.MULTI_AGG:
        from ..ops.multi_agg import fused_multi_agg

        c = int(shapes["channels"])
        nrecv = arr(n, c) if shapes.get("has_recv", True) else None
        gate = arr(e, c) if shapes.get("has_gate", False) else None
        ein = arr(e, c)
        return lambda: fused_multi_agg(nrecv, ein, gate, ids, n)
    if kernel == plans.FLASH:
        from ..ops.flash_attention import flash_block_summary, flash_self_attention

        nq, h, d = int(shapes["nodes"]), int(shapes["heads"]), int(shapes["head_dim"])
        nk = int(shapes.get("keys", nq))
        q, k, v = arr(nq, h, d), arr(nk, h, d), arr(nk, h, d)
        if shapes.get("summary", False):
            key_mask = torch.ones(nk, dtype=torch.bool, device=device)
            return lambda: flash_block_summary(q, k, v, key_mask)
        g = max(int(shapes.get("graphs", 1)), 1)
        node_graph = torch.as_tensor(np.minimum(np.arange(nq) * g // max(nq, 1), g - 1)).to(device)
        node_mask = torch.ones(nq, dtype=torch.bool, device=device)
        return lambda: flash_self_attention(q, k, v, node_graph, node_mask, g, 0)
    raise KeyError(f"unknown kernel {kernel!r}")


def _outputs(out) -> List[Any]:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def agrees(got, want, dtype: str) -> bool:
    """Whether every output of ``got`` lies within ``plans.AGREEMENT_RTOL``
    of the same output of ``want``, against that output's largest
    magnitude (a NaN never agrees)."""
    tol = plans.AGREEMENT_RTOL[str(dtype)]
    got, want = _outputs(got), _outputs(want)
    if len(got) != len(want):
        return False
    for a, b in zip(got, want):
        if a.shape != b.shape:
            return False
        if b.numel() == 0:
            continue
        a, b = a.float(), b.float()
        if not float((a - b).abs().max()) <= tol * float(b.abs().max()):
            return False
    return True


def _device_of() -> str:
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def sweep_kernel(
    kernel: str,
    shapes: Dict[str, Any],
    dtype: str,
    table: TunedTable,
    budget: int = 0,
    trials: int = DEFAULT_TRIALS,
    device=None,
    force: bool = False,
) -> Dict[str, Any]:
    """Sweep one kernel on one shape signature and publish the winner.

    Returns a result record: ``cached=True`` when the table already held
    this key (nothing measured — the CLI's second invocation is 100% of
    these), else the candidate census, the winning plan, and the
    defaults' and the winner's medians. A candidate that fails to launch,
    or whose outputs part from the default plan's (``agrees``), is skipped
    with a warning."""
    from .runtime import _shape_key

    device = device or _device_of()
    spec = plans.KERNELS[kernel]
    dev = device_kind()
    key_shape = _shape_key(shapes)
    existing = table.lookup(kernel, spec.version, dev, dtype, key_shape)
    if existing is not None and not force:
        return {"kernel": kernel, "cached": True, "plan": existing, "shape": key_shape}

    full_shapes = {**shapes, "dtype": dtype}
    cands = plans.candidates(kernel, full_shapes, budget)
    default = plans.default_plan(kernel, full_shapes)
    t_sweep0 = time.perf_counter()
    call = build_call(kernel, shapes, dtype, device)
    with forced(kernel, default):
        want = call()
    timed: List[Tuple[float, Dict[str, int]]] = []
    default_s: Optional[float] = None
    dropped = 0
    for plan in cands:
        try:
            with forced(kernel, plan):
                got = want if plan == default else call()
                sec = measure(call, n_trials=trials, device=device)
        except Exception as e:  # a launch the card refuses
            warnings.warn(f"tune sweep: candidate {plan} for {kernel} failed ({e}); skipping",
                          RuntimeWarning, stacklevel=2)
            continue
        if not agrees(got, want, dtype):
            dropped += 1
            warnings.warn(f"tune sweep: candidate {plan} for {kernel} {key_shape}: its "
                          "outputs part from the default plan's; skipping",
                          RuntimeWarning, stacklevel=2)
            continue
        timed.append((sec, plan))
        if plan == default:
            default_s = sec
    if not timed:
        raise RuntimeError(f"tune sweep: every candidate failed for kernel {kernel!r} "
                           f"shapes {key_shape} — nothing to publish")
    best_s, best = min(timed, key=lambda t: t[0])
    table.store(
        kernel, spec.version, dev, dtype, key_shape, best,
        measured_us=best_s * 1e6,
        meta={"candidates": len(timed),
              "default_us": default_s * 1e6 if default_s is not None else None,
              "trials": trials},
    )
    _sweep_gauge().set(time.perf_counter() - t_sweep0, kernel=kernel)
    return {
        "kernel": kernel, "cached": False, "plan": best, "shape": key_shape,
        "candidates": len(timed), "dropped": dropped, "best_us": best_s * 1e6,
        "default_us": default_s * 1e6 if default_s is not None else None,
    }


def _sweep_gauge():
    from ..obs.registry import registry

    return registry().gauge(
        "hydragnn_tune_sweep_seconds",
        "Wall seconds of the last launch-plan sweep per kernel",
        labelnames=("kernel",),
    )


def config_slots(config: Dict[str, Any], ladder=None) -> List[Tuple[str, Dict[str, Any], str]]:
    """The (kernel, shapes, dtype) sweep slots a completed config implies:
    one slot per kernel the model launches per SpecLadder level, from the
    same static facts the wrappers hand ``tile_plan``: K1 at the hidden
    width (and at 3 for an equivariant model's coordinate update), K2 at
    the hidden width, K3 at the hidden width for the PNA convs, K4 per
    GPS head."""
    arch = config["NeuralNetwork"]["Architecture"]
    training = config["NeuralNetwork"].get("Training", {})
    hidden = int(arch.get("hidden_dim") or 0)
    heads = int(arch.get("global_attn_heads") or 0)
    dtype = "bfloat16" if training.get("mixed_precision") else "float32"
    mpnn = str(arch.get("mpnn_type", ""))
    pna = mpnn.upper().startswith("PNA")
    specs = list(ladder.specs) if ladder is not None else []
    slots: List[Tuple[str, Dict[str, Any], str]] = []
    for ps in specs:
        n, e = int(ps.n_nodes), int(ps.n_edges)
        if arch.get("use_sorted_aggregation"):
            widths = [hidden] + ([3] if arch.get("equivariance") and mpnn == "EGNN" else [])
            for c in widths:
                slots.append((plans.SEGMENT, {"edges": e, "channels": c, "num_segments": n},
                              dtype))
        if arch.get("use_fused_edge_kernel") and arch.get("use_sorted_aggregation"):
            slots.append((plans.FUSED_EDGE, {"edges": e, "ci": hidden, "co": hidden,
                                             "num_segments": n}, dtype))
        if pna and arch.get("use_sorted_aggregation"):
            slots.append((plans.MULTI_AGG, {"edges": e, "channels": hidden,
                                            "num_segments": n, "has_recv": True,
                                            "has_gate": False}, dtype))
        if arch.get("use_flash_attention") and heads and hidden % heads == 0:
            slots.append((plans.FLASH, {"nodes": n, "keys": n, "heads": heads,
                                        "head_dim": hidden // heads, "summary": False,
                                        "graphs": int(ps.n_graphs)}, dtype))
    return slots


def sweep_slots(
    slots: List[Tuple[str, Dict[str, Any], str]],
    table: TunedTable,
    budget: int = 0,
    trials: int = DEFAULT_TRIALS,
    device=None,
    force: bool = False,
    log: Optional[Callable[[str], None]] = None,
) -> Dict[str, Any]:
    """Sweep every slot into ``table`` (traced as a ``tune_sweep`` span
    when a tracer is live) and return the census the CLI prints:
    ``{"entries": N, "hits": H, "swept": S, "results": [...]}``."""
    import contextlib

    from ..obs import trace

    results = []
    tr = trace.active()
    span = tr.span("tune_sweep", slots=len(slots)) if tr is not None else contextlib.nullcontext()
    with span:
        for kernel, shapes, dtype in slots:
            res = sweep_kernel(kernel, shapes, dtype, table, budget=budget, trials=trials,
                               device=device, force=force)
            results.append(res)
            if log:
                if res.get("cached"):
                    log(f"  {kernel} {res['shape']}: HIT (cached) plan={res['plan']}")
                else:
                    d, b = res.get("default_us"), res.get("best_us")
                    gain = f" ({d / b:.2f}x vs default)" if d and b else ""
                    log(f"  {kernel} {res['shape']}: swept {res['candidates']} candidates"
                        f" best={b:.1f}us{gain} plan={res['plan']}")
    hits = sum(1 for r in results if r.get("cached"))
    from .runtime import _entries_gauge

    _entries_gauge().set(float(table.size()))
    return {"entries": len(results), "hits": hits, "swept": len(results) - hits,
            "results": results}
