#!/usr/bin/env python3
"""How far the served weights' reduced-precision routes move the SC25 EGNN,
on one CUDA card.

Run from the root of a checkout on a machine with a GPU:

    python3 run-scripts/torch_quant_sensitivity.py [--steps 0,20]

On chip_smoke.py's egnn cell (EGNN 866 x 4, equivariant, heads of 889,
batch 32 packed, f32 compute) over 128 OC20-shaped graphs, for each number
of AdamW training steps (mixed precision, as the egnn_train cell) it
prints, against the f32 model on 96 requests in batches of 16:

- the relative max error (the accuracy gate's: per head, the largest
  |route - f32| over the largest |f32|, real rows) of a uniform 2^-9
  perturbation of every weight (bf16's rounding, in f32), of
  ``cast_inference_weights`` bf16, of int8 weight-only and of w8a8
  (``quantize_state`` calibrated on the template graphs packed into one
  batch, as the server packs them, on the real rows as the port does, and
  on every row as the JAX package does), with the gate's own reading on
  the calibration batch;
- w8a8 one layer at a time (that layer int8 x int8, the rest weight-only),
  worst first, calibrated on every row: the layers whose static per-tensor
  activation scale the padding rows set.

It reads what ``Serving.quantization.exclude`` must hold for w8a8 to meet
``max_error`` on this cell; chip_smoke.py's ``serve_plane`` uses it.
"""

import argparse
import contextlib
import copy
import sys
import time
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", default="0,20", help="training steps before measuring, a list")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this script needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.data.graph import batch_graphs
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.data.synthetic import oc20_shaped_dataset
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.ops import _build
    from hydragnn_tpu_torch.serve import quantize as qz
    from hydragnn_tpu_torch.serve.quantize import QuantizedDense
    from hydragnn_tpu_torch.train import TrainState, make_optimizer
    from hydragnn_tpu_torch.train.loop import make_train_step
    from hydragnn_tpu_torch.train.state import InferenceState, cast_inference_weights

    device = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}", flush=True)
    _build.build(("sorted_segment_sum", "fused_edge"))
    graphs = oc20_shaped_dataset(128)
    config = cs.serving_config()
    config["NeuralNetwork"]["Training"]["mixed_precision"] = False
    done, (train_loader, _, test_loader), _ = prepare_data(
        copy.deepcopy(config), split_dataset(graphs, 0.9, seed=0))
    ladder = test_loader.ladder
    chunks = [graphs[i:i + 16] for i in range(0, 96, 16)]
    requests = [batch_graphs(c, ladder.select_for(c), sort_edges=True).to(device) for c in chunks]
    calib_graphs = []
    for g in test_loader.graphs:  # packed as GraphServer._quant_batches packs them
        if sum(x.num_nodes for x in calib_graphs) + g.num_nodes <= ladder.specs[-1].n_nodes - 1:
            calib_graphs.append(g)
    calib = [batch_graphs(calib_graphs, ladder.select_for(calib_graphs), sort_edges=True)]

    def every_row(on=True):
        """The JAX package's calibration and gate: every row, the padding's
        too (the port masks the real rows)."""
        if not on:
            return contextlib.nullcontext()
        return mock.patch.object(qz, "_real_rows", lambda batch, x: None)

    def masked(out, batch):
        return {k: v[batch.graph_mask if v.shape[0] == batch.num_graphs else batch.node_mask]
                for k, v in out.items()}

    def rel(model, ref):
        with torch.inference_mode():
            got = [masked(model(b), b) for b in requests]
        return {k: round(max(float((g[k] - r[k]).abs().max()) for g, r in zip(got, ref))
                         / max(float(r[k].abs().max()) for r in ref), 5) for k in ref[0]}

    train_loader.set_epoch(0)
    train = [b.to(device) for b in train_loader]
    for steps in (int(s) for s in args.steps.split(",")):
        model = create_model(done, device=device, seed=cs.SEED)
        if steps:
            state = TrainState.create(model, make_optimizer(
                model, {"type": "AdamW", "learning_rate": 1e-3}))
            step = make_train_step(model, mixed_precision=True)
            for i in range(steps):
                step(state, train[i % len(train)])
        model.eval()
        with torch.inference_mode():
            ref = [masked(model(b), b) for b in requests]
        gen = torch.Generator(device=device).manual_seed(0)
        jitter = copy.deepcopy(model)
        with torch.no_grad():
            for n, p in jitter.named_parameters():
                if n.endswith("weight"):
                    p.mul_(1 + 2 ** -9 * (torch.rand(p.shape, generator=gen, device=device) * 2 - 1))
        fp = InferenceState(model)
        t0 = time.perf_counter()
        wo = qz.quantize_state(model, fp, calib, "weight_only")
        with every_row():
            w8 = qz.quantize_state(model, fp, calib, "w8a8")
            w8_gate = qz.accuracy_report(fp, w8, calib)['max_error']
        print(f"steps {steps}: 2^-9 jitter {rel(jitter, ref)}, bf16 "
              f"{rel(cast_inference_weights(fp, 'bfloat16').model, ref)}, int8 weight-only "
              f"{rel(wo.model, ref)} (gate {qz.accuracy_report(fp, wo, calib)['max_error']})"
              f", w8a8 on every row {rel(w8.model, ref)} ({len(w8.w8a8)} layers; gate on every "
              f"row {w8_gate}; {time.perf_counter() - t0:.1f} s)", flush=True)
        one = []
        for name, m in w8.model.named_modules():
            if not (isinstance(m, QuantizedDense) and m.act_scale is not None):
                continue
            probe = copy.deepcopy(wo.model)
            parent, _, child = name.rpartition(".")
            setattr(probe.get_submodule(parent) if parent else probe, child, copy.deepcopy(m))
            one.append((rel(probe, ref), name))
        one.sort(key=lambda t: -max(t[0].values()))
        print(f"steps {steps}: w8a8 one layer at a time, worst first: "
              + "; ".join(f"{n} {e}" for e, n in one[:8]), flush=True)
        for ex in ((), ("graph_convs_3/MLP_0",)):
            for real in (False, True):
                with every_row(not real):
                    q = qz.quantize_state(model, fp, calib, "w8a8", ex)
                print(f"steps {steps}: w8a8 excluding {ex}, calibrated on "
                      f"{'real' if real else 'every'} rows: {rel(q.model, ref)} ({len(q.w8a8)} "
                      f"layers; gate on real rows "
                      f"{qz.accuracy_report(fp, q, calib)['max_error']})", flush=True)
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
