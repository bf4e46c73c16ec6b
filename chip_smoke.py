#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``hydragnn_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --kernels  # build + kernel checks only (a short first run)
    python3 chip_smoke.py --plane    # build + capture checks + the compile plane's phases
    python3 chip_smoke.py --data-plane  # build + the host data plane's phase
    python3 chip_smoke.py --serve-plane  # build + the serving plane's phase

Phases, each fatal on failure (exit code 1):

1. card: name and power limit from nvidia-smi, ``torch.cuda.get_device_name``;
2. build: every kernel of the paths, built by nvcc for sm_90a from
   ``hydragnn_tpu_torch/csrc/`` (one nvcc per source, all started together,
   in a thread while the paths' data, cases and gin_ring's requests are
   made);
3. kernels: each kernel's wrapper on the card at the shapes its path gives
   it (one real batch of that path: an OC20-shaped packed batch of 32
   graphs for K1/K2, an unpacked batch of 16 for K3/K4, the spanning BCC
   supercell of 8,192 atoms for K4b and K1 at C = 256; N1, the numerics
   step's statistics, on the egnn model's taps and gradients of that
   packed batch), held against its
   plain PyTorch version with a stated tolerance, then timed with CUDA
   events (and its device time under torch.profiler) beside the plain
   version, one library call where PyTorch has one, and the bound (the
   larger of bytes over 3.35 TB/s and operations over the peak rate of the
   unit that could run them: the tensor cores for K2's, K4's and K4b's
   products, at the TF32 rate for three TF32 products in f32; the f32 units
   for the rest), after a warm-up that brings the card's clocks up. The
   device time of each call is also listed by kernel name. K3 also runs on
   the same batch padded to the top of its serving ladder (a dummy row of
   ~17k edges), off the kernels line; a K3 call that is more than one
   device kernel fails. Then the ring-merge check: K4b over four key blocks
   merged through the ring's ``_block_attend`` against one K4b call over
   all keys; each kernel (K1, K2, K3, K4, K4b, N1) at its first case's shapes
   captured in a CUDA graph and replayed, against the eager call bit for
   bit and its plain version (``capture_checks``); K1's fixed-order plain version twice on the gin_ring shapes
   (the same bits, or it fails); then, for every kernel library, each
   kernel's tensor-core instruction count (``cuobjdump -sass``), registers
   and spills (``ptxas -v``): a flash or fused-edge instance without
   tensor-core instructions, or any spill, fails. K1's first- and
   second-order gradients at the EGNN shapes are held against
   ``index_add_``'s autograd (a route that shares none of K1's code);
4. serving ``egnn``: ``api.run_server`` on the SC25-shaped EGNN (hidden 866,
   4 conv layers, equivariant, graph and node heads of width 889, batch 32,
   packed, bf16 mixed precision, sorted aggregation) with random weights
   from a seed; 192 requests, every answer finite and of the right shape,
   launch counts per served batch (K1: once in bf16 and twice in f32 at
   each of C = 866 and C = 3; K2: once in f32), and the served answers
   against the same weights run through the plain ops, both with the same
   bf16 cast (the same function) and in f32;
5. serving ``gps_pna``: the same on GPS global attention over PNA (hidden
   256, 4 conv layers, 8 heads of 32, Laplacian PE of 4, graph head
   [256, 256], node head [256, 256], batch 16, not packed, bf16 mixed
   precision, sorted aggregation, so the multi-moment and flash kernels):
   K3 and K4 each once in bf16 and three times in f32 per served batch;
6. ``gin_ring``: sequence-parallel evaluation of one spanning graph (GIN
   with GPS ring attention, hidden 256, 4 conv layers, 8 heads of 32,
   Laplacian PE of 4, graph head [256, 256], batch 1, f32, sorted
   aggregation and the block-summary kernel) on a ring of one rank:
   ``parallel.make_sp_eval_step`` on 4 requests, each a BCC supercell of
   16^3 cells (8,192 atoms, ~98k periodic edges) whose node features are
   redrawn per request on one topology and one PE. K4b and K1 (C = 256) each
   four times in f32 per request; the answers against the same route
   through the kernels' plain versions (K1's a fixed-order sum, run twice,
   its largest difference printed) and against the dense fallback (outside
   the SP context: [8, N, N] f32 logits); ms per forward, nodes/s and the
   peak memory of both routes;
7. ``egnn_train``: the SC25-shaped EGNN of phase 4 trained at full width
   with the JAX benchmark's Training block (AdamW lr 1e-3, MAE, task
   weights [1, 100], bf16 mixed precision, packed batch 32 at the serving
   cell's budget, the non-finite step guard on), random weights from a
   seed, through ``train.make_train_step``, so K1 and K2 run forward and
   carry gradients (their backwards are torch ops). One step's gradients
   against the same step through the kernels' plain versions, in f32 and in
   bf16, printed beside controls (``train_routes``: the plain route again,
   each kernel alone, K1's sums in ``index_add_``'s order); every
   parameter's gradient finite and nonzero; a loss trajectory
   over every batch of 768 OC20-shaped graphs' train split (23 steps)
   through the kernels and through the plain versions, from one init; ms
   per step and graphs/s (from step 4), peak memory, one profiled step;
   the launches per step (the forward's: a backward launches no kernel);
   one epoch of ``api.run_training`` with no device given (on the egnn
   cell's split), its launches per step and eval batch; then one
   energy-force step (one node head, forces ``-dE/dpos`` by a
   double backward, f32) whose loss, forces and gradients are held against
   the plain route, printed beside the same controls; every route and
   rounding draws (the plain route carrying K1's kernel values in some
   calls, or correctly rounded sums) are printed against the same step in
   f64, and each K1 sum of that step against an f64 sum beside its plain
   version's (K1 no further from it, or it fails). The kernel checks of
   phase 3 also time K1's and K2's backwards;
8. ``gps_pna_train``: the gps_pna cell's model trained at full width
   through K3 and K4 with gradients (22 steps of 16 OC20-shaped graphs with
   PE 4, bf16 mixed precision, AdamW lr 1e-3, the guard on): one step's
   gradients against the plain versions in f32 and in bf16 beside
   controls, the two loss trajectories, launches per step (K3 and K4 once
   in bf16 and three times in f32, none in a backward), ms per step, peak
   memory, one profiled step, and one ``api.run_training`` epoch;
9. ``gin_ring_train``: the gin_ring cell's model trained through
   ``parallel.make_sp_train_step`` on a ring of one rank over phase 6's
   requests (4 epochs, AdamW lr 3e-3, f32): gradients against the K1/K4b
   plain route and against one step of the dense fallback, the
   trajectories' first epoch, launches per step (K1 and K4b four times
   each), ms per step, nodes/s, peak memory, and the last epoch's mean
   loss below the first's;
10. ``egnn_ckpt``: checkpointed training of phase 7's model and Training
   block on phase 4's graphs through ``api.run_training`` with
   ``Training.Checkpoint`` (3 epochs, retention 2), no device given, under
   ``./logs`` of a temporary directory: the checkpoint restored into a
   fresh model and AdamW bit for bit (parameters, buffers, moments,
   counters, LR); the files on disk as retention and the ``latest``
   pointer say, each payload against its sha256 sidecar; ``run_prediction``
   restored from disk against ``test_model`` on the in-memory state, and
   ``run_server`` restored from disk against servers of the in-memory
   weights over 192 requests (exactly, when two in-memory runs agree bit
   for bit; else within 4x their spread), its launches per served batch;
   a byte of the newest payload flipped: the server walks back to the
   previous epoch's file, reports it, and answers as its weights do; a
   SIGTERM sent as the step of batch 1 of epoch 1 starts: the run
   checkpoints with a loader-state sidecar and stops, ``continue: true``
   replays the rest of that epoch (the same graphs in the same order as an
   uninterrupted run), and those steps' losses are held against the
   uninterrupted run's on the same terms against a second uninterrupted
   run; every batch of epoch 1 poisoned (NaN features) under
   ``non_finite_policy: rollback``: one rollback, the restored state equal
   to the checkpoint file's bit for bit, the LR backed off by
   ``non_finite_lr_backoff``. It prints the seconds of every save and
   restore and the payload's bytes;
11. the message-passing zoo. ``pnaplus`` (served with phases 4-5): the
   JAX bench's PNA-family cell (PNAPlus hidden 256, 4 conv layers, heads
   [256, 256], batch 16, bf16 mixed precision), 192 requests through
   ``api.run_server`` against the plain ops and the same route through
   K3's plain version, K3 (``node_recv`` and the rbf gate) once in bf16 at
   C = 4 and three times in f32 at C = 256 per batch; ``pnaplus_train``
   (after ``egnn_ckpt``): that cell trained for 22 steps as
   ``gps_pna_train`` trains (``run_cell_train``); ``zoo``: PNAEq, PAINN,
   SAGE, GAT, MFC and CGCNN at the same widths, each one served batch
   against the same bf16 cast through the plain versions, its f32 step-0
   gradients against the plain route (PAINN's and PNAEq's, whose update
   blocks saturate at random init, printed beside each route's flipped
   clamp decisions and its distance from the step in f64, and gated by
   K1's or K3's values on the step against f64 and, with deterministic
   algorithms, by the kernel route against the plain route carrying the
   kernel's values) and two bf16 train steps against the plain route,
   launches per batch and step; ``schnet_md17``: the committed MD17 recipe
   (SchNet hidden 64, 512 samples, 100 epochs, energy-force) through
   ``api.run_training`` and ``api.run_prediction`` with PyTorch's
   deterministic algorithms, with one energy-force step held against K1's
   plain version, gated on the force and energy bounds of
   tests/test_examples.py (``--md17 ROUTE`` runs the recipe alone through
   K1 or its plain version, with or without deterministic algorithms,
   ungated). The kernel checks of phase 3 also
   hold K1 at C = 4, 256 and 1,536 (bf16) and 126 (f32) and K3's two
   variants at the zoo's and the MD17 recipe's shapes;
12. DimeNet (the spherical basis, the triplet channel), MACE (the O(3)
   algebra) and GPS performer attention. ``dimenet`` and ``mace`` (served
   with phases 4-5 and ``pnaplus``): the JAX bench's model cells with
   sorted aggregation (``model_cell_config``: 2 conv layers, OC20-shaped
   data, heads [256, 256], batch 16 not packed, bf16; DimeNet hidden 128,
   MACE hidden 256 at max_ell 2 and correlation 3), 192 requests each
   through ``api.run_server`` against the same bf16 cast through K1's
   plain version and against f32 plain ops; K1 per batch: DimeNet once at
   C = 4 and once at 128 in f32 (its spherical basis is f32), MACE twice in
   bf16 at C = 2,304 (256 channels x 9 irrep components).
   ``dimenet_train`` and ``mace_train`` (after ``pnaplus_train``): each cell
   trained through ``run_cell_train`` (step-0 gradients in f32 and bf16
   against K1's plain version, 22-step trajectories, ms per step, peak
   memory, a profiled step, one ``run_training`` epoch), then one
   energy-force step (forces by a double backward through K1, f32) against
   the plain route; DimeNet first takes a bf16 step on a batch with padding
   triplets (every gradient finite). ``performer`` (in ``zoo``): the JAX
   bench's performer cell (GIN hidden 256, 4 layers, 8 heads, PE 4), GIN's
   sums through K1 (bf16, C = 256), its served leg under deterministic
   algorithms (``ZOO_DETERMINISTIC_SERVED``). The kernel checks of phase 3 hold K1
   at C = 2,304 (bf16 and f32), 128 and 4 (f32) too.
13. The multibranch GFM recipe (examples/multibranch/multibranch_GFM260_SC25.json
   as committed: EGNN hidden 866, 4 layers, equivariant, 5 branches of
   graph heads 2 x 50 + 3 x 889 and mlp node heads 3 x 889, task weights
   [1, 100], MAE, batch 160, 3 pad buckets, bf16, balanced branch
   sampling, AdamW 1e-3), with per-branch loss weights [1, 2, 1, 0.5, 1]
   and the ``branch<i>`` scalars, on 1,920 OC20-shaped graphs drawn into the
   branches 40/25/15/12/8 %. ``gfm_train``: ``run_cell_train`` over 1
   epoch (11 steps; K1 and K2 as egnn_train per step) and
   ``run_training`` for 1 epoch, each branch's share of the draws;
   ``gfm``: ``api.run_server`` restores that checkpoint and answers 192
   requests over every branch, against the plain ops on its own
   micro-batches and against ``run_prediction`` branch by branch;
   ``gfm_convhead_train``: the recipe with conv node heads [889, 889, 889]
   (each branch a chain of 4 EGNN convs, K1 and K2 17 and 6 times a step)
   at batch 32, its first step's peak memory; ``gfm_nll``: the recipe under
   ``GaussianNLLLoss`` (one served batch with its variances, f32 step-0
   gradients, 4 steps against the plain route), then the mace cell under
   it; ``optimizers``: Adagrad, RMSprop, Adamax, Adadelta, LAMB and
   FusedLAMB 3 steps each on the card from one GFM batch's gradients
   against CPU copies, and the guard undoing a non-finite step;
   ``mlp_per_node``: GIN with a per-node MLP head, a served batch and an
   f32 step against K1's plain version. The GFM recipe's K1 and K2 cases
   are measured at its batch of 160 (``gfm/`` in the kernels line) and
   carry the launches of its phases.
14. The committed example recipes from their JSON alone, through
   ``api.run_training(config)`` (the path of a JSON file),
   ``run_prediction(config)`` and ``run_server(config)`` with no explicit
   datasets (``run_config_phase``, after the GFM phases). Their data is
   written at start-up by the port's own writers into a temporary
   directory under ``build/``. ``oc20_config``:
   examples/open_catalyst_2020/open_catalyst_2020.json with its script's
   ``--production`` overrides (EGNN hidden 866, 4 conv layers, node head
   [64, 64], packed batch 16, energy-force, f32, AdamW) on 512 OC20-shaped
   graphs in a columnar directory read in mmap mode, K2 four times a step;
   ``lsms_config``: examples/lsms/lsms.json (PNA hidden 16 x 4, a graph
   and two node heads, stratified split, charge-density correction) on 96
   FePt LSMS files converted to formation Gibbs energies, K3 at C = 1 and
   16. Each: ``prepare_data(config)`` against ``prepare_data(config,
   datasets)`` on the graphs the phase read back and split itself (the
   same completed config and batches, bit for bit); ``run_training`` (2
   epochs of the JSON's 10 and 20) against a run on those datasets, both
   under PyTorch's deterministic algorithms (the first 4 losses equal);
   the first 4 steps through the kernels against the plain versions
   (egnn_train's energy-force limits, pnaplus_train's limits; the later
   steps within the trajectory limit or 3x a rounding draw's distance);
   launches per step, eval batch and served batch; finite predictions;
   192 requests served from the run's checkpoint. It prints the seconds
   of ``prepare_data``, ms per step and graphs/s, the peak memory, and the
   served graphs/s and latency. The kernel checks of phase 3 hold K2 at
   oc20_config's first batch and K3 at lsms_config's (``oc20/`` and
   ``lsms/`` in the kernels line).

15. The multi-GPU slice (``parallel/engine.py``), after the phases of 14.
   ``dist_gfm_train``: the GFM recipe of 13 at full width (batch 160, bf16)
   through ``make_mesh_train_step`` at a world of one rank over a real NCCL
   process group, once per unrouted preset (dp, zero1, zero2, zero3; the
   state placed by ``place_state``), 4 steps each against
   ``make_train_step`` on the same batches under deterministic algorithms:
   every reduction is the identity there, so parameters, statistics,
   moments and losses agree bit for bit; ms per step of each preset beside
   the plain step's, peak memory, K1/K2 launches per step (egnn_train's)
   and ``torch.cuda.nccl.version()``. ``dist_run_training``: the entry
   point a user runs, ``python -m hydragnn_tpu_torch.launch --nprocs 1``
   starting ``dist_run_rank``: ``run_training`` on the recipe with
   ``zero_stage`` 3 (1 epoch) joins a group of one over NCCL, places the
   state by the zero3 table, records ``Parallel.resolved_rules`` in the
   saved config and writes the checkpoint; ``run_prediction`` from it
   gives the run's last test loss exactly. ``dist_ranks``: processes that
   share the card over gloo (NCCL refuses two ranks on one device; a
   collective gloo lacks fails the phase), 2 ranks under dp, zero1, zero2
   and zero3, AdamW, in one spawn, and 5 ranks under branch (one branch
   each; SGD for 2 steps, as Adam would hide a branch's loss weight, and
   the recipe's AdamW for 1), at batch 32 a rank: each rank's own tensors
   after its job's steps against one process's emulation of the same
   steps (``_emulated``: each row's gradients and statistics from the
   same start, combined with the world's weights, each decoder branch
   from its rank times its loss weight; bit for bit over 2 ranks), K1/K2
   launches per step at every rank, ms per step and the bytes each rank
   holds (optimizer state, parameters between steps).

16. The observability plane on the egnn cell, after the phases of 15.
   ``obs_train``: ``api.run_training`` of ``train_config`` (the SC25 EGNN,
   bf16, through K1 and K2, no device given) with the top-level
   ``Telemetry`` section on (windows of 5 steps, every step traced,
   numerics, ``/metrics`` on an ephemeral port) and ``NeuralNetwork.Profile``
   off, one epoch of ~20 steps; the records of ``metrics.jsonl``,
   ``trace.jsonl`` and ``events.jsonl`` against the port's schema; each
   window's step time and graphs/s within 10% of the phase's own CUDA
   events around the same steps; ``mfu_est`` in (0, 1) against the card's
   named peak; a mid-run scrape of ``/metrics`` holding the train series
   and ``/healthz`` 200; a touch-file capture of ``profile_steps`` steps
   naming K1's and K2's kernels and the step's ``train/*`` and region
   ranges; K1/K2 launches per step as egnn_train's; each probe's and
   gradient group's max |x| and rms through the kernels against the plain
   versions (egnn_train's largest-gradient limit); one batch poisoned after
   batching (``x[0, 0]`` NaN) through the numerics step: the guard skips
   it, ``numerics_provenance`` names ``embedding`` and one flight dump
   holds its files; the step-time A/Bs of run-scripts/telemetry_smoke.py
   (legs 3 and 5: telemetry on against off, numerics on against off, the
   best of 3 blocks of 5 interleaved pairs) within 2%, every pair printed.
   ``obs_serve``: ``api.run_server`` on the egnn serving config with
   ``Telemetry.trace`` at ``trace_sample`` 1.0, 64 requests: every request's
   span tree complete, the ``/metrics`` request histogram counting 64 (its
   p50 and p99 beside the client's), ``/readyz`` 200, K1/K2 launches per
   batch; a step sleeping past ``Serving.step_timeout_s``: its request gets
   ``WedgedStepError``, ``serve_wedge`` is emitted, the flight recorder
   dumps, a fresh runner answers the next request.

17. The compile and memory plane on the egnn cell (after ``egnn_train``).
   ``graphs_train``: ``api.run_training`` of the egnn_train cell unpacked on
   a 4-level ladder under ``precompile`` blocking and background, against
   off under deterministic algorithms (losses, history, every state tensor
   bit for bit) and, blocking, with atomics (egnn_train's trajectory
   limit); each level's capture seconds, pool bytes and launches a step
   through its graph; the eager step against the replayed one in
   alternating legs (ms, busy share, peak memory); an off-ladder batch
   under ``retrace_policy`` warn (one warning, one event) and error
   (``RetraceError``). ``graphs_serve``: the egnn server, every level
   captured at warm-up, the sentinel armed at error: 192 requests through
   the graphs and through the eager route in alternating rounds, the
   graphs' answers against the eager forward bit for bit. ``remat``: the
   step with ``conv_checkpointing`` under each ``remat_policy`` against the
   unwrapped step (gradients 0 apart, deterministic; peak memory, ms).
   ``tune``: the tune CLI over the energy-force cell's ladder (a columnar
   copy of its graphs), the table's entries keyed on the card and each
   kernel's source digest, a second run that sweeps nothing, every launch
   taking its tuned plan, the tuned outputs against the defaults' (bit for
   bit where only the row split changes). ``run_training`` and every
   server replay one CUDA graph per ladder level by default: the launch
   gates count the wrappers' launches and the graphs' replays.

18. ``data_plane``, the host data plane (after ``obs_serve``): (a) the
   egnn_train cell on a 4-level ladder, every level's graph captured
   (``precompile`` blocking), through ``api.run_training`` for 3 epochs of
   10 steps with device staging (``double_buffer: true``) and the loader's
   prefetch thread (2 batches) against both off, under deterministic
   algorithms: every loss and state tensor bit for bit, K1/K2 launches a
   step through the graphs as egnn_train's; the second epoch's ms a step
   and graphs/s, the third's device time under the profiler (the busy
   share against the second's wall), and the gauges ``hydragnn_device_prefetch_depth``
   and ``hydragnn_loader_prefetch_depth``; (b) the loader's stall watchdog:
   a fetch blocking past a 0.5 s ``stall_timeout`` raises
   ``LoaderStallError`` within the timeout plus one watchdog period,
   ``hydragnn_loader_stalls_total`` 1, a fetch that raises reaches the
   consumer, no producer thread left alive; (c)
   ``examples/ani1_x/ani1x_forces.json`` (EGNN 50 x 3, K1 and K2) and (d)
   ``examples/csce/csce_gap.json`` (PNA 200 x 6, K3) from their committed
   JSON, their data made by ``ani1x_shaped_dataset`` and
   ``smiles_table_dataset`` and written by ``ColumnarWriter`` (CSCE's with
   its SMILES strings): ``prepare_data``, ``run_training`` for 4 steps,
   then step 0's loss and gradients (and ANI-1x's forces head) and the
   same steps against the plain versions of the recipe's kernels
   (oc20_config's and lsms_config's limits); the kernel checks of phase 3
   hold K1 and K2 at ANI-1x's first batch and K3 at CSCE's (``ani1x/``
   and ``csce/`` in the kernels line); (e) a ``DistDataset`` (POSIX shared memory)
   over the egnn cell's graphs feeding ``GraphLoader`` with prefetch: its
   batches equal the list-backed loader's bit for bit, one step's loss
   the same; (f) the native cell-list builder (``g++`` at first use) on an
   open cluster of 32,768 atoms: the same edge set as cKDTree, both timed.
19. ``serve_plane``, the rest of the serving plane (after ``dist_ranks``,
   before ``obs_train``; its fleet starts before ``dist_run_training``,
   whose launch and ``dist_ranks``' two groups of ranks start beside it),
   on the egnn cell at full width trained 20 AdamW steps, its checkpoints
   under SGD (the model alone): (c)'s stream first, then (a) and (b) while
   the killed replica restarts, then the rest of (c); (a) ``Serving.hot_reload`` with ``drain_grace_s`` 1 s:
   192 requests paced 20 ms apart, the run's next checkpoint published
   after 48 of them; one swap, none dropped, every answer equal bit for bit
   to the eager forward with the weights of its batch (replays after the
   in-place swap read the new weights), the seconds from the pointer's
   commit to the first new answer; a bit-flipped next checkpoint rejected
   while the old one serves; ``/readyz`` 503 while a request is admitted
   in the grace window; (b) mixed precision off, the f32, bf16,
   int8 w8a8 and int8 weight-only servers on one checkpoint, 96 requests
   each: every route's relative max error against the f32 server held to
   ``Serving.quantization.max_error`` (0.05), K1/K2 launches a batch
   unchanged, graphs/s, p50/p99 and the weight bytes on the card of each,
   w8a8's ``_int_mm`` calls and int8 GEMM kernels under the profiler, the
   drift drill (``HYDRAGNN_FAULT_QUANT_DRIFT``) refused at a reload while
   the old weights serve; (c) ``api.run_server_fleet`` with 2 replica
   processes on the card over the config's data written by
   ``ColumnarWriter``: 192 requests through the router from 16 callers
   while replica 1 is killed (``HYDRAGNN_FAULT_REPLICA_KILL``): 0 failed,
   the retry counted, replica 1 back ready; local against fleet graphs/s
   and p50/p99; every answer of the stream against the in-process
   server's answer to the same request (bit for bit, or within the egnn
   cell's bf16 limit where the two batched it at different ladder levels,
   and nearer its own graph's answer than any other graph's); each
   replica's answers to graphs sent alone equal the in-process server's
   bit for bit; a second pass all cache hits,
   bit-identical; a rolling reload moves both replicas to the next
   checkpoint; K1 and K2 launched in each replica (its ``/stats``).

Each path sets every launch count to 0 just before its requests (or steps)
and reads them just after, and prints one ``profile:`` block (the
``egnn_ckpt`` phase and the phases of 14 print none). Every path runs in a temporary directory
under ``build/``, so its ``./logs`` (checkpoints written by
``run_training``, read by the servers) starts empty. The last three lines
are the card, the kernels JSON line and the result line.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import json
import os
import math
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM published peaks (dense): device memory, tensor-core products per
# operand type, and f32 arithmetic outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
# an f32-accurate product on the tensor cores splits each operand into TF32
# hi + lo parts and runs three TF32 products (hi*hi, hi*lo, lo*hi), as K2's
# f32 case does
MMA_PASSES = {"bfloat16": ("bfloat16", 1), "float32": ("tf32", 3)}
SEED = 0
N_REQUESTS = 192  # 1.5x the dataset: every graph once, a third of them twice
# padding edges of a GPS-PNA batch at the top of its serving ladder (33408
# edge slots against ~17k real edges), all received by the dummy node
LONG_ROW_EDGES = 16384
# the gin_ring supercell: 16^3 BCC cells (8,192 atoms), 4 requests on it,
# and the key blocks of the ring-merge check
GIN_RING_CELLS = 16
GIN_RING_REQUESTS = 4
MERGE_BLOCKS = 4

# the kernel libraries of the paths (hydragnn_tpu_torch/csrc/<name>.cu)
LIBRARIES = ("sorted_segment_sum", "fused_edge", "multi_agg", "flash_attention",
             "numerics_stats")
NATIVE_LIBRARIES = ("neighbors", "ddstore")  # hydragnn_tpu_torch/native/*.cpp, by g++
KERNELS = {  # kernel -> (module, wrapper) of hydragnn_tpu_torch.ops
    "K1": ("sorted_segment", "sorted_segment_sum"),
    "K2": ("fused_edge", "fused_edge_message_sum"),
    "K3": ("multi_agg", "fused_multi_agg"),
    "K4": ("flash_attention", "flash_self_attention"),
    "K4b": ("flash_attention", "flash_block_summary"),
    # no TPU kernel: the JAX package's numerics reductions, which XLA fuses
    "N1": ("numerics_stats", "numerics_stats"),
}


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


def warm_up_card(seconds: float = 2.0) -> None:
    """Keep the card busy for ``seconds`` (f32 matrix products) so that its
    clocks have left their idle state before anything is timed: a card that
    sat idle through the kernels' build runs the first timed calls slower."""
    import torch

    a = torch.randn(4096, 4096, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a = torch.tanh(a @ a * (1.0 / 64))
        torch.cuda.synchronize()


def device_ms(fn, iters: int):
    """Device time per call of ``fn``: the summed device time of every
    kernel and copy it launches, under torch.profiler, over ``iters`` calls
    (after as many calls profiled to warm the profiler up and not recorded:
    a cold profile can drop its first kernels), and the same split by
    kernel (or copy) name. Unlike ``cuda_ms`` it leaves out the host's time
    between launches, which is most of a wrapper's call time when its
    kernel takes microseconds. A profile that dropped device events (one
    that caught none, or caught some kernel fewer times than ``fn`` was
    called) is taken again, up to five times; then the time is None (not
    measured), beside the names the last profile caught."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    by_name = {}
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            for warm in (True, False):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                if warm:  # a step after the recorded calls would drop them
                    prof.step()
        events = [ev for ev in _device_events(prof) if _device_us(ev) > 0]
        by_name = {ev.key: _device_us(ev) / iters / 1e3 for ev in events}
        if events and all(ev.count >= iters for ev in events):
            return sum(by_name.values()), by_name
    return None, by_name


def _device_events(prof):
    """The profile's device kernels and copies, without the device-side
    ranges of user annotations (``Optimizer.step#AdamW.step`` spans the
    kernels it launched: counting it would count them twice)."""
    return [ev for ev in prof.key_averages() if str(ev.device_type).endswith("CUDA")
            and not getattr(ev, "is_user_annotation", False)]


def _device_us(ev) -> float:
    us = getattr(ev, "self_device_time_total", None)
    return ev.self_cuda_time_total if us is None else us


def _short(name: str, width: int = 90) -> str:
    """A kernel's name as the profiler gives it, cut to ``width``."""
    return name if len(name) <= width else name[:width - 3] + "..."


def _ptxas_by_kernel(log: str):
    """Registers and spill bytes (stores + loads) per kernel, by mangled
    name, from ``ptxas -v`` output."""
    import re

    info, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            cur = m.group(1)
            info.setdefault(cur, {"registers": None, "spill": 0})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            info[cur]["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            info[cur]["registers"] = int(m.group(1))
    return info


def library_report(names) -> None:
    """For each named kernel library, per kernel: the tensor-core
    instructions (HMMA, HGMMA) in the SASS that ``cuobjdump -sass`` prints,
    and the registers and spill bytes ``ptxas -v`` reported. Fails if a
    flash-attention or fused-edge instance has no tensor-core instruction
    or any kernel of these libraries spills."""
    import re

    from hydragnn_tpu_torch.ops import _build

    bin_dir = Path(_build.nvcc()).parent
    for name in names:
        out = subprocess.run([str(bin_dir / "cuobjdump"), "-sass", str(_build.library_path(name))],
                             capture_output=True, text=True, timeout=300)
        check(out.returncode == 0, f"cuobjdump -sass {name} failed: {out.stderr[-2000:]}")
        counts, fn = {}, None
        for line in out.stdout.splitlines():
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                counts[fn] = 0
            elif fn is not None and re.search(r"\bH(G)?MMA\b", line):
                counts[fn] += 1
        ptxas = _ptxas_by_kernel(_build.build_log.get(name, ""))
        demangled = subprocess.run([str(bin_dir / "cu++filt"), *counts],
                                   capture_output=True, text=True, timeout=60)
        labels = (demangled.stdout.splitlines() if demangled.returncode == 0
                  and len(demangled.stdout.splitlines()) == len(counts) else list(counts))
        spill = 0
        for label, (mangled, n) in sorted(zip(labels, counts.items())):
            p = ptxas.get(mangled, {"registers": None, "spill": None})
            print(f"sass {name}: {n:4d} tensor-core instructions (HMMA/HGMMA), "
                  f"{p['registers']} registers, {p['spill']} bytes spilled (ptxas) in {label}",
                  flush=True)
            spill += p["spill"] or 0
            if "flash_attention_kernel" in label or "fused_edge_kernel" in label:
                check(n > 0, f"{label}: no tensor-core instruction in its SASS")
        check(spill == 0, f"{name}: ptxas reports {spill} bytes of spill stores and loads")


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


def gps_pna_config(batch_size: int = 16, hidden: int = 256, head: int = 256,
                   heads: int = 8, layers: int = 4):
    """GPS global attention over PNA: the JAX package's GPS bench cell
    (bench.py ``_gps_cell_workload("flash")``) with PNA as the local MPNN
    and sorted aggregation on, the widths of its PNA cell
    (``_pna_cell_workload``); the fused and flash kernels follow from the
    card at config completion."""
    config = serving_config(batch_size=batch_size, hidden=hidden, head=head)
    arch = config["NeuralNetwork"]["Architecture"]
    arch.update(
        mpnn_type="PNA", num_conv_layers=layers, equivariance=False,
        global_attn_engine="GPS", global_attn_type="multihead",
        global_attn_heads=heads, pe_dim=4, dropout=0.0,
        output_heads={
            "graph": {"num_sharedlayers": 2, "dim_sharedlayers": 50,
                      "num_headlayers": 2, "dim_headlayers": [head, head]},
            "node": {"num_headlayers": 2, "dim_headlayers": [head, head], "type": "mlp"},
        },
    )
    config["NeuralNetwork"]["Training"]["pack_batches"] = False
    return config


def gps_pna_dataset(n: int = 128):
    """``oc20_shaped_dataset(n)`` with Laplacian PE of ``pe_dim`` attached
    before the split, as the bench does."""
    from hydragnn_tpu_torch.data import add_dataset_pe, oc20_shaped_dataset

    return add_dataset_pe(oc20_shaped_dataset(n), 4)


def gin_ring_config(hidden: int = 256, head: int = 256, heads: int = 8, layers: int = 4):
    """GIN with GPS ring attention over one spanning graph: the JAX
    package's GPS bench cell (bench.py ``_gps_cell_workload``: GIN, hidden
    256, 4 conv layers, 8 heads, PE 4, dropout 0) with the attention type,
    graph-only head and batch of 1 of its mesoscale example
    (examples/mesoscale/mesoscale.py), in f32; the sorted and block-summary
    kernels follow from the card at config completion."""
    return {
        "Verbosity": {"level": 0},
        "Dataset": {"name": "bcc_supercell", "node_features": {"dim": [1, 1, 1]},
                    "graph_features": {"dim": [1]}},
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "GIN", "hidden_dim": hidden, "num_conv_layers": layers,
                "global_attn_engine": "GPS", "global_attn_type": "ring",
                "global_attn_heads": heads, "pe_dim": 4, "dropout": 0.0,
                "task_weights": [1.0],
                "output_heads": {"graph": {"num_sharedlayers": 2, "dim_sharedlayers": 50,
                                           "num_headlayers": 2,
                                           "dim_headlayers": [head, head]}},
            },
            "Variables_of_interest": {"input_node_features": [0], "output_names": ["total"],
                                      "output_index": [0], "type": ["graph"]},
            "Training": {"batch_size": 1, "num_epoch": 1,
                         "Optimizer": {"type": "AdamW", "learning_rate": 3e-3}},
        },
    }


def gin_ring_requests(topology, n: int, pe_dim: int = 4):
    """``n`` spanning-graph requests on one supercell topology: the node
    features redrawn per request (``[x, x^2, x^3]``, x uniform in [0.2, 1],
    target their sum, as ``bcc_supercell`` draws them), MinMax over the
    requests, the variables of interest, and the Laplacian PE, computed
    once: it depends on the topology only. Returns (graphs, PE seconds)."""
    import dataclasses

    import numpy as np

    from hydragnn_tpu_torch.data import MinMax, VariablesOfInterest, add_graph_pe, extract_variables

    t0 = time.perf_counter()
    with_pe = add_graph_pe(topology, pe_dim)
    pe_s = time.perf_counter() - t0
    graphs = []
    for r in range(n):
        rng = np.random.default_rng(SEED + 1 + r)
        x = rng.uniform(0.2, 1.0, (topology.num_nodes, 1)).astype(np.float32)
        feats = np.concatenate([x, x**2, x**3], axis=1).astype(np.float32)
        graphs.append(dataclasses.replace(topology, x=feats,
                                          graph_y=np.asarray([feats.sum()], np.float32)))
    graphs = MinMax.fit(graphs).apply(graphs)
    voi = VariablesOfInterest([0], ["total"], ["graph"], [0], [1, 1, 1], [1])
    return [dataclasses.replace(extract_variables(g, voi), pe=with_pe.pe, rel_pe=with_pe.rel_pe)
            for g in graphs], pe_s


def gin_ring_spec(graph):
    """One spanning graph per batch, padded as the mesoscale example pads
    it for a ring of one rank: two padding nodes and edges, a dummy graph."""
    from hydragnn_tpu_torch.data.graph import PadSpec

    return PadSpec(n_nodes=graph.num_nodes + 2, n_edges=graph.num_edges + 2, n_graphs=2)


def _case(kernel, dtype, name, case, fn, plain, library, nbytes, ops_ms, iters, shape,
          check_exact=None, scale=None, backward=None, gradients=None, library_backward=None):
    source, replaces = {
        "K1": ("hydragnn_tpu_torch/csrc/sorted_segment_sum.cu",
               "hydragnn_tpu/ops/pallas_segment.py:173"),
        "K2": ("hydragnn_tpu_torch/csrc/fused_edge.cu",
               "hydragnn_tpu/ops/pallas_fused_edge.py:225"),
        "K3": ("hydragnn_tpu_torch/csrc/multi_agg.cu",
               "hydragnn_tpu/ops/pallas_multi_agg.py:306"),
        "K4": ("hydragnn_tpu_torch/csrc/flash_attention.cu",
               "hydragnn_tpu/ops/pallas_flash_attention.py:299"),
        "K4b": ("hydragnn_tpu_torch/csrc/flash_attention.cu",
                "hydragnn_tpu/ops/pallas_flash_attention.py:420"),
        "N1": ("hydragnn_tpu_torch/csrc/numerics_stats.cu",
               "hydragnn_tpu/obs/numerics.py:168"),
    }[kernel]
    return dict(kernel=kernel, dtype=str(dtype)[6:], name=name, case=case, fn=fn, plain=plain,
                library=library, nbytes=nbytes, ops_ms=ops_ms, iters=iters, shape=shape,
                source=source, replaces=replaces, check_exact=check_exact, scale=scale,
                backward=backward, gradients=gradients, library_backward=library_backward)


def backward_call(fn, kw, names):
    """A zero-argument call of the backward of ``fn(**kw)`` with respect to
    the inputs ``names`` (the kernel's Function: its backward is torch ops,
    no kernel), for timing: the forward runs once, here, and each call
    takes the gradients of its differentiable outputs again from the kept
    graph."""
    import torch

    leaves = {k: (v.detach().clone().requires_grad_(True) if k in names else v)
              for k, v in kw.items()}
    with torch.enable_grad():
        outs = [o for o in _outputs(fn(**leaves)) if o.requires_grad]
    douts = [torch.ones_like(o) for o in outs]
    inputs = [leaves[k] for k in names]
    return lambda: torch.autograd.grad(outs, inputs, douts, retain_graph=True)


def sdpa_backward_call(q, k, v, mask):
    """A zero-argument call of ``scaled_dot_product_attention``'s forward
    and backward on ``[H, N, d]`` operands with the boolean ``mask``: the
    library yardstick of K4's and K4b's backwards."""
    import torch
    import torch.nn.functional as F

    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    dout = torch.ones_like(q)

    def call():
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        return torch.autograd.grad(out, leaves, dout)

    return call


def first_and_second(fn, inputs, seed: int, scales=None):
    """The first and second derivatives of ``fn`` in each of ``inputs``:
    ``g = d/dx sum_i sum(w_i tanh(out_i / s_i))`` over its differentiable
    outputs, then ``d/dx sum_j <g_j, v_j>`` (a double backward, as the
    energy-force loss takes); ``w`` and ``v`` from a seed. ``s_i`` is the
    power of two at or above ``max |out_i|`` (so that tanh does not
    saturate), or ``scales[i]`` where given. Returns (first, second,
    scales), the first two lists over ``inputs``."""
    import torch

    xs = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = [o for o in _outputs(fn(*xs)) if o.requires_grad]
    if scales is None:
        scales = [2.0 ** math.ceil(math.log2(max(float(o.detach().float().abs().max()), 1e-30)))
                  for o in outs]
    dev = xs[0].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    loss = sum(torch.sum(torch.randn(o.shape, generator=gen, device=dev)
                         * torch.tanh(o.float() / s)) for o, s in zip(outs, scales))
    g = torch.autograd.grad(loss, xs, create_graph=True)
    vs = [torch.randn(x.shape, generator=gen, device=dev) for x in xs]
    gg = torch.autograd.grad(sum(torch.sum(a.float() * v) for a, v in zip(g, vs)), xs)
    return [t.detach() for t in g], list(gg), scales


def dense_attention(q, k, v, valid):
    """Softmax attention of ``q [n_q, H, d]`` over ``k``/``v [n_k, H, d]``
    restricted to ``valid [n_q, n_k]``, in f32 with ``torch.softmax`` and
    ordinary autograd: a route that shares no code with K4's Function or
    its references. Rows with no valid key give 0."""
    import torch

    scores = torch.einsum("qhd,khd->hqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    scores = scores.masked_fill(~valid[None], float("-inf"))
    some = valid.any(dim=-1)  # [n_q]
    p = torch.softmax(torch.where(some[None, :, None], scores, 0.0), dim=-1)
    out = torch.einsum("hqk,khd->qhd", p, v.float())
    return torch.where(some[:, None, None], out, 0.0)


def dense_block_summary(q, k, v, key_mask):
    """K4b's function, ``(m, l, acc)`` of ``q [n_q, H, d]`` against the
    keys where ``key_mask [n_k]`` holds, in f32 with ordinary autograd and
    ``-inf`` masking: a route that shares no code with K4b's Function or
    its reference. With no valid key: ``(-1e30, 0, 0)``."""
    import torch

    scores = torch.einsum("qhd,khd->qhk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    scores = scores.masked_fill(~key_mask, float("-inf"))
    some = bool(key_mask.any())
    m = scores.amax(dim=-1) if some else torch.full(scores.shape[:-1], -1.0e30,
                                                     device=q.device)
    p = torch.exp(scores - m[..., None])  # 0 at masked keys
    return m, p.sum(dim=-1), torch.einsum("qhk,khd->qhd", p, v.float())


def egnn_kernel_cases(batch, device, prefix: str = "", k2_dtypes=None):
    """K1 and K2 at the EGNN serving shapes, inputs from a seed. The
    receiver ids are the real batch's; messages of padding edges are zero,
    as ``segment_sum`` masks them before K1 (K2 takes them unmasked).
    ``prefix`` names another path's cases (``gfm/``: the GFM recipe's batch
    of 160); ``k2_dtypes`` limits K2's cases to those dtypes."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED)
    ids = batch.receivers.to(device)
    n, e = batch.num_nodes, batch.num_edges
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        cases += [_k1_case(ids, batch.edge_mask.to(device), n, c, dtype, gen, c, prefix)
                  for c in (866, 3)]
        if k2_dtypes is not None and dtype not in k2_dtypes:
            continue
        cases.append(_k2_case(ids, n, e, dtype, gen, prefix))
    return cases


def numerics_kernel_case(config, batch, device):
    """N1 at the obs_train step's shapes: the model of ``config`` (the egnn
    cell, random weights from the seed) on ``batch``, one bf16 train-mode
    forward with every probe on and its backward; its taps, their masks and
    the gradient leaves by group, against the plain version. The outputs:
    each statistic's column and the ok flag."""
    import torch

    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.obs.numerics import ProbeRecord, collecting, param_groups
    from hydragnn_tpu_torch.ops.numerics_stats import numerics_stats, numerics_stats_plain
    from hydragnn_tpu_torch.train.loop import _apply_fn, cast_batch_bf16, train_loss

    model = create_model(config, device=device, seed=SEED)
    model.train()
    rec = ProbeRecord()
    with collecting(rec):
        tot, _, _ = train_loss(_apply_fn(model, True, cast_buffers=False),
                               cast_batch_bf16(batch.to(device)), model.cfg)
    tot = tot.float()
    tot.backward()
    _, _, order, gshapes = param_groups(model)
    params = list(model.parameters())
    leaves = [params[k].grad if params[k].grad is not None else torch.zeros_like(params[k])
              for k in order]
    taps = [x.detach() for _, x, _ in rec.entries]
    masks = [m for _, _, m in rec.entries]
    sizes = tuple(len(g) for g in gshapes)
    tot = tot.detach()
    t, g = len(taps), len(sizes)
    elements = sum(x.numel() for x in taps) + sum(x.numel() for x in leaves)
    distinct = {id(m): m for m in masks if m is not None}.values()
    nbytes = (sum(x.numel() * x.element_size() for x in taps + leaves)
              + sum(m.numel() for m in distinct) + (t + g) * 5 * 4)

    def columns(out_ok):
        out, ok = out_ok
        return (*out.unbind(1), ok)

    return _case(
        "N1", torch.float32, f"numerics_stats ({t} taps, {g} groups)", f"{t}taps/{g}groups",
        lambda: columns(numerics_stats(taps, masks, leaves, sizes, tot)),
        lambda: columns(numerics_stats_plain(taps, masks, leaves, sizes, tot)),
        None, nbytes,
        elements * 6 / PEAK_FLOPS["float32"] * 1e3,  # |x|, x * x, three adds, a max
        20, dict(taps=t, groups=g, elements=elements), check_exact=(0, 2, 3, 4, 5),
    )


def _k2_case(ids, n, e, dtype, gen, prefix: str = "", ci: int = 866, co: int = 866):
    """K2 on ``ids`` at EGNN's width (``ci`` x ``co``), inputs from ``gen``;
    against its plain version, with its backward timed."""
    import torch

    from hydragnn_tpu_torch.ops.fused_edge import (
        fused_edge_message_sum,
        reference_edge_message_sum,
    )

    device = ids.device
    dname = str(dtype)[6:]
    size = torch.tensor([], dtype=dtype).element_size()
    kw = dict(
        node_recv=torch.randn(n, ci, generator=gen, device=device).to(dtype),
        edge_in=torch.randn(e, ci, generator=gen, device=device).to(dtype),
        weights=(torch.randn(ci, co, generator=gen, device=device) / math.sqrt(ci)).to(dtype),
        bias=(0.1 * torch.randn(co, generator=gen, device=device)).to(dtype),
        segment_ids=ids, num_segments=n,
    )
    unit, passes = MMA_PASSES[dname]
    return _case(
        "K2", dtype, f"{prefix}fused_edge_message_sum ({dname}, {ci}x{co})",
        f"{prefix}{dname}/{ci}x{co}",
        lambda: fused_edge_message_sum(**kw),
        lambda: reference_edge_message_sum(**kw),
        None,
        ((n + e) * ci + ci * co + co + n * co) * size + e * 4,
        # the product on the tensor cores; the gather add + relu and the
        # bias + relu + row sum in f32 outside them
        (passes * 2 * e * ci * co / PEAK_FLOPS[unit]
         + (2 * e * ci + 3 * e * co) / PEAK_FLOPS["float32"]) * 1e3,
        10, dict(E=e, N=n, Ci=ci, Co=co),
        backward=lambda: backward_call(
            fused_edge_message_sum, kw, ("node_recv", "edge_in", "weights", "bias")),
    )


def _k3_pna_case(ids, node_mask, n, e, c, dtype, gen, prefix: str = ""):
    """K3 on ``ids`` at width ``c``, PNA's variant (``node_recv``, no gate),
    inputs from ``gen``; against ``reference_multi_agg`` (count, min and max
    exactly), its gradients on the real rows (the path masks the dummy row
    downstream: in bf16 that row's ``node_recv`` gradient is a bf16 sum
    over the padding edges, in an order the atomics pick). Returns the case
    and its inputs."""
    import torch

    from hydragnn_tpu_torch.ops.multi_agg import fused_multi_agg, reference_multi_agg

    dname = str(dtype)[6:]
    size = torch.tensor([], dtype=dtype).element_size()
    kw = dict(node_recv=torch.randn(n, c, generator=gen, device=ids.device).to(dtype),
              edge_in=torch.randn(e, c, generator=gen, device=ids.device).to(dtype),
              gate=None, segment_ids=ids, num_segments=n)

    def real_rows(moments):
        return tuple(m[node_mask] for m in moments)

    return _case(
        "K3", dtype, f"{prefix}fused_multi_agg ({dname}, C={c})", f"{prefix}{dname}/C{c}",
        lambda: fused_multi_agg(**kw),
        lambda: reference_multi_agg(**kw),
        None,  # no one PyTorch call computes the five moments
        (e * c + n * c) * size + e * 8 + (4 * n * c + n) * 4,
        # add, square, sum, sumsq, min, max per message element, f32
        6 * e * c / PEAK_FLOPS["float32"] * 1e3,
        50, dict(E=e, N=n, C=c),
        check_exact=(1, 2, 3),  # count, min, max
        backward=lambda: backward_call(fused_multi_agg, kw, ("node_recv", "edge_in")),
        gradients=(lambda nr, ei: real_rows(fused_multi_agg(nr, ei, None, ids, n)),
                   ("reference_multi_agg's autograd",
                    lambda nr, ei: real_rows(reference_multi_agg(nr, ei, None, ids, n))),
                   [kw["node_recv"], kw["edge_in"]], 3),
    ), kw


def gps_kernel_cases(batch, device, nmax: int, channels: int = 256, heads: int = 8):
    """K3 and K4 at the GPS-PNA serving shapes, inputs from a seed: the
    real batch's receiver ids for K3 (no mask: padding edges land on the
    dummy row, as on the served path), its graph layout for K4 and the
    config's node bound ``nmax`` for K4's gradient. The path cases also
    carry their Functions' gradients and backwards."""
    import torch
    import torch.nn.functional as F

    from hydragnn_tpu_torch.ops.flash_attention import (
        flash_self_attention,
        reference_masked_attention,
    )
    from hydragnn_tpu_torch.ops.multi_agg import fused_multi_agg, reference_multi_agg

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    ids = batch.receivers.to(device)
    node_graph = batch.node_graph.to(device)
    node_mask = batch.node_mask.to(device)
    n, e, g = batch.num_nodes, batch.num_edges, batch.num_graphs
    c, d = channels, channels // heads
    sizes = batch.nodes_per_graph[batch.graph_mask].double()
    pairs = float((sizes * sizes).sum())  # same-graph (query, key) pairs per head
    same = (node_graph[:, None] == node_graph[None, :]) & node_mask[None, :] & node_mask[:, None]

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype)[6:]
        size = torch.tensor([], dtype=dtype).element_size()
        case, kw = _k3_pna_case(ids, node_mask, n, e, c, dtype, gen)
        cases.append(case)
        # off the kernels line: the same batch padded as the serving ladder's
        # top level pads it, with LONG_ROW_EDGES more padding edges, all on
        # the dummy row (node N - 1)
        el = e + LONG_ROW_EDGES
        kw = dict(kw, edge_in=torch.randn(el, c, generator=gen, device=device).to(dtype),
                  segment_ids=torch.cat([ids, torch.full((LONG_ROW_EDGES,), n - 1,
                                                         dtype=ids.dtype, device=device)]))
        cases.append(_case(
            "K3", dtype, f"fused_multi_agg ({dname}, C={c}, long dummy row)",
            f"{dname}/C{c}/long dummy row",
            lambda kw=kw: fused_multi_agg(**kw),
            lambda kw=kw: reference_multi_agg(**kw),
            None,
            (el * c + n * c) * size + el * 8 + (4 * n * c + n) * 4,
            6 * el * c / PEAK_FLOPS["float32"] * 1e3,
            50, dict(E=el, N=n, C=c, dummy_row_edges=int((kw["segment_ids"] == n - 1).sum())),
            check_exact=(1, 2, 3),
        ))
        q, k, v = (torch.randn(n, heads, d, generator=gen, device=device).to(dtype)
                   for _ in range(3))
        kw = dict(q=q, k=k, v=v, node_graph=node_graph, node_mask=node_mask)
        qh, kh, vh = (t.transpose(0, 1).contiguous() for t in (q, k, v))  # [H, N, d]
        cases.append(_case(
            "K4", dtype, f"flash_self_attention ({dname}, H={heads}, d={d})",
            f"{dname}/H{heads}xd{d}",
            lambda kw=kw: flash_self_attention(**kw, num_graphs=g, max_nodes_per_graph=nmax),
            lambda kw=kw: reference_masked_attention(**kw),
            lambda qh=qh, kh=kh, vh=vh: F.scaled_dot_product_attention(qh, kh, vh,
                                                                        attn_mask=same),
            4 * n * heads * d * size + n * 9,
            # q.k and p.v, 2 flops each per dimension and same-graph pair, at
            # the least time the card could take them: the tensor cores in
            # bf16, three TF32 products for f32 accuracy (as the kernel runs
            # them)
            MMA_PASSES[dname][1] * 4 * heads * d * pairs
            / PEAK_FLOPS[MMA_PASSES[dname][0]] * 1e3,
            50, dict(N=n, H=heads, d=d, G=int(batch.graph_mask.sum()), pairs_per_head=pairs),
            scale=float(v.float().abs().max()),  # the largest value an output can take
            backward=lambda kw=kw: backward_call(
                lambda **a: flash_self_attention(**a, num_graphs=g, max_nodes_per_graph=nmax),
                kw, ("q", "k", "v")),
            gradients=(lambda q_, k_, v_: flash_self_attention(q_, k_, v_, node_graph, node_mask,
                                                               g, nmax),
                       ("masked softmax attention's autograd",
                        lambda q_, k_, v_: dense_attention(q_, k_, v_, same)),
                       [q, k, v], 4),
            library_backward=lambda qh=qh, kh=kh, vh=vh: sdpa_backward_call(qh, kh, vh, same),
        ))
    return cases


def gin_ring_kernel_cases(batch, device, channels: int = 256, heads: int = 8):
    """K1 (f32, C = 256: GIN's neighbour sum) and K4b at the gin_ring
    shapes, inputs from a seed: the spanning batch's receiver ids for K1,
    its node mask as K4b's key mask (queries and keys: every node of the
    batch, padding included, as on the path)."""
    import torch
    import torch.nn.functional as F

    from hydragnn_tpu_torch.ops.flash_attention import (
        flash_block_summary,
        reference_block_summary,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    key_mask = batch.node_mask.to(device)
    n = batch.num_nodes
    c, d = channels, channels // heads
    valid = int(key_mask.sum())
    cases = [_k1_case(batch.receivers.to(device), batch.edge_mask.to(device), n, c,
                      torch.float32, gen, 5)]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        size = torch.tensor([], dtype=dtype).element_size()
        q, k, v = (torch.randn(n, heads, d, generator=gen, device=device).to(dtype)
                   for _ in range(3))
        kw4 = dict(q=q, k=k, v=v, key_mask=key_mask)
        qh, kh, vh = (t.transpose(0, 1).contiguous() for t in (q, k, v))  # [H, N, d]
        cases.append(_case(
            "K4b", dtype, f"flash_block_summary ({dname}, H={heads}, d={d})",
            f"{dname}/H{heads}xd{d}",
            lambda kw4=kw4: flash_block_summary(**kw4),
            lambda kw4=kw4: reference_block_summary(**kw4),
            # the normalized output only: SDPA has no (m, l) statistics
            lambda qh=qh, kh=kh, vh=vh: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=key_mask[None, :]),
            # q, k, v and the key mask in; m, l, acc out
            (3 * n * heads * d + n * heads * (d + 2)) * size + n,
            # q.k and p.v, 2 flops each per dimension and (query, valid key)
            # pair, priced as K4's: the tensor cores in bf16, three TF32
            # products for f32 accuracy
            MMA_PASSES[dname][1] * 4 * heads * d * n * valid
            / PEAK_FLOPS[MMA_PASSES[dname][0]] * 1e3,
            10, dict(n_q=n, n_k=n, valid_keys=valid, H=heads, d=d),
            # the path's dtype (f32) only: the bf16 case is off the path
            **(dict(backward=lambda kw4=kw4: backward_call(flash_block_summary, kw4,
                                                           ("q", "k", "v")),
                    gradients=(lambda q_, k_, v_: flash_block_summary(q_, k_, v_, key_mask),
                               ("masked softmax attention's autograd",
                                lambda q_, k_, v_: dense_block_summary(q_, k_, v_, key_mask)),
                               [q, k, v], 6),
                    library_backward=lambda qh=qh, kh=kh, vh=vh: sdpa_backward_call(
                        qh, kh, vh, key_mask[None, :]))
               if dtype == torch.float32 else {}),
        ))
    return cases


def plain_route_repeat_check(batch, device, channels: int = 256) -> None:
    """K1's plain version (the fixed-order route the plain-versions gates
    compare against) twice on the gin_ring shapes: the same bits, where
    ``index_add_``'s atomics add in another order on every call."""
    import torch

    from hydragnn_tpu_torch.ops.sorted_segment import segment_sum_plain, sorted_segment_sum_plain

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    ids = batch.receivers.to(device)
    msg = torch.randn(batch.num_edges, channels, generator=gen, device=device) * 100.0
    runs = [sorted_segment_sum_plain(msg, ids, batch.num_nodes) for _ in range(2)]
    atomics = [segment_sum_plain(msg, ids, batch.num_nodes) for _ in range(2)]
    torch.cuda.synchronize()
    differ = int((atomics[0] != atomics[1]).sum())
    print(f"check plain route: sorted_segment_sum_plain twice on {batch.num_edges} edges x "
          f"{channels}: bitwise equal {torch.equal(*runs)} (index_add_ twice: {differ} elements "
          f"differ)", flush=True)
    check(torch.equal(*runs), "the fixed-order plain route gave other bits on a second run")


def ring_merge_check(batch, device, heads: int = 8, d: int = 32, blocks: int = MERGE_BLOCKS):
    """K4b over ``blocks`` key blocks (n_q != n_k), merged through the
    ring's ``_block_attend``, against one K4b call over all the keys: f32,
    the path's dtype, at the gin_ring shapes. The merge rescales partials by
    exp of differences of f32 maxima, a few ulp: tolerance 1e-5 of max |v|."""
    import torch

    from hydragnn_tpu_torch.ops.flash_attention import flash_block_summary
    from hydragnn_tpu_torch.parallel.ring_attention import _block_attend

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    n = batch.num_nodes
    key_mask = batch.node_mask.to(device)
    q, k, v = (torch.randn(n, heads, d, generator=gen, device=device) for _ in range(3))
    m, l, acc = flash_block_summary(q, k, v, key_mask)
    whole = acc / torch.clamp(l, min=1e-30)[..., None]
    m = torch.full((n, heads), torch.finfo(torch.float32).min, device=device)
    denom, acc = torch.zeros(n, heads, device=device), torch.zeros_like(q)
    scale = 1.0 / math.sqrt(d)
    for kb, vb, mb in zip(k.chunk(blocks), v.chunk(blocks), key_mask.chunk(blocks)):
        m, denom, acc = _block_attend(q, kb, vb, mb, m, denom, acc, scale, use_flash=True)
    merged = acc / torch.clamp(denom, min=1e-30)[..., None]
    torch.cuda.synchronize()
    err = float((merged - whole).abs().max())
    tol = 1e-5 * float(v.abs().max())
    print(f"check ring merge: K4b over {blocks} key blocks of {k.chunk(blocks)[0].shape[0]} "
          f"against one call over {n} keys (f32, H={heads}, d={d}): max_abs_err {err:.6g} "
          f"(tolerance {tol:.6g} = 1e-5 x max |v|)", flush=True)
    check(math.isfinite(err) and err <= tol, "the merged K4b blocks disagree with one call")


# (atol, rtol of max |plain|) per kernel and dtype. K1/K2 f32: the kernels sum
# in another order than index_add_/cuBLAS, a few ulp per term. K1/K2 bf16:
# both versions accumulate in f32 and round once, but K2's plain version
# rounds the product before adding the bias (the kernel adds it in f32), so
# a message may differ by an ulp or two of bf16 (2**-8) before the row sum.
# K3: the messages are formed exactly as in the plain version, so count, min
# and max must agree exactly; sum and sumsq are f32 sums in another order,
# over up to ~17k terms on the long dummy row (measured 6.2e-6 of the
# largest sumsq there, 4.4e-6 on the served batch).
# K4 (scale: max |v|, the largest value an output row can take): f32 sums in
# another order; bf16 rounds p to bf16 against a running maximum where the
# plain version uses the row's final one (an ulp of bf16 on each p), and
# rounds the output.
# K4b (each of m, l, acc against its own largest value): f32 sums in another
# order and exp2 of log2-scaled scores where the plain version takes exp;
# bf16 rounds m, l and acc = o * l to bf16 (an ulp is 2**-8 of the value) and
# p against a running maximum, as K4.
TOLERANCES = {
    ("K1", "float32"): (1e-4, 1e-5),
    ("K1", "bfloat16"): (1e-2, 8e-3),
    ("K2", "float32"): (1e-3, 1e-4),
    ("K2", "bfloat16"): (5e-2, 2e-2),
    ("K3", "float32"): (0.0, 3e-5),
    ("K3", "bfloat16"): (0.0, 3e-5),
    ("K4", "float32"): (0.0, 1e-5),
    ("K4", "bfloat16"): (0.0, 2e-2),
    ("K4b", "float32"): (0.0, 1e-5),
    ("K4b", "bfloat16"): (0.0, 2e-2),
    # max |x| and the counts exact (the same values), the sums of squares
    # in another order
    ("N1", "float32"): (0.0, 1e-5),
}


# Each Function's first- and second-order gradients at the path's shapes
# against an independent route through ordinary autograd (K1: index_add_;
# K3: reference_multi_agg; K4, K4b: softmax attention written here),
# relative to each gradient's largest value: in f32 the forwards' sums in
# another order reach the gradients through tanh'; in bf16 K4 and its
# recompute round p to bf16 where the independent route keeps f32
GRAD_TOLERANCES = {"float32": 1e-4, "bfloat16": 3e-2}


# Served answers against the plain ops on the same weights, relative to each
# head's largest value: the largest error of any output row (a graph's
# energy, a node's forces), and the median over rows. Readings from this
# script on an H100 (NVIDIA H100 80GB HBM3, 700 W) at seed 0, as (largest,
# median) per head, with limits at about three times each.
# EGNN "bf16 plain ops" (the same bf16 cast through the plain ops: the same
# function in another summation order): energy (1.1e-3, 2.1e-6), forces
# (2.0e-3, 4.1e-7). EGNN "f32 plain ops" (the whole model in f32: what mixed
# precision costs): energy (2.2e-2, 4.7e-3), forces (4.6e-3, 2.1e-4); a
# served path run wholly in f32 would lie about 2.2e-2 from the bf16
# reference in energy, over its limit.
# GPS-PNA's largest errors are far looser, and not from the kernels: with
# random weights the activations grow layer by layer, the attention logits
# reach the hundreds and beyond, the softmax is near argmax, and a rounding
# difference flips a near-tie in a few rows. The medians show the rest
# agree: "bf16 plain ops" (dense attention, softmax in bf16 where K4 keeps
# f32): energy (0.105, 1.7e-2), forces (0.308, 1.9e-2); "f32 plain ops":
# (0.174, 3.5e-2), (0.250, 3.4e-2); "bf16 served route, plain versions" (the
# same function, K3 and K4 swapped for their plain versions on the card):
# (7.7e-2, 4.2e-3), (0.128, 2.2e-3); "f32 through the kernels" (the
# server's f32 model through K3 and K4 against the f32 plain ops): (1.4e-3
# to 1.6e-3, 3.6e-6 to 5.0e-6), (2.1e-2 to 4.9e-2, 1.9e-6 to 2.0e-6) in
# four runs (the plain ops' index_add_ and the cuBLAS kernels it picks vary
# from run to run), where a wrong kernel would move the median by orders of
# magnitude.
SERVE_RTOL = {  # reference -> head -> (largest row, median row)
    "egnn": {"bf16 plain ops": {"energy": (5e-3, 1e-5), "forces": (5e-3, 2e-6)},
             "f32 plain ops": {"energy": (5e-2, 1.5e-2), "forces": (1e-2, 1e-3)}},
    "gps_pna": {"bf16 plain ops": {"energy": (0.3, 5e-2), "forces": (0.75, 6e-2)},
                "f32 plain ops": {"energy": (0.5, 0.1), "forces": (0.75, 0.1)},
                "bf16 served route, plain versions": {"energy": (0.25, 1.5e-2),
                                                      "forces": (0.4, 1e-2)},
                "f32 through the kernels": {"energy": (1e-2, 2e-5), "forces": (0.15, 1e-5)}},
    # PNAPlus (first run): bf16 plain ops energy (1.2e-3, 1.9e-4), forces
    # (8.4e-4, 1.3e-4); f32 plain ops (0.13, 3.2e-2), (0.11, 2.2e-2); the
    # served route through K3's plain version (4.2e-6, 6.4e-7), (2.7e-6,
    # 3.4e-7); f32 through K3 (1.9e-6, 5.2e-7), (2.1e-6, 3.0e-7). Limits at
    # about four times, as the plain ops' index_add_ varies from run to run.
    # Every reference runs the server's own micro-batches, each at the
    # ladder level the server took for it: against fixed chunks of 32, one
    # graph's bf16 rounding flipped a ReLU in some of the server's
    # compositions (1.8e-4 from the reference, the server running K3's plain
    # version too), which no kernel causes
    "pnaplus": {"bf16 plain ops": {"energy": (5e-3, 1e-3), "forces": (5e-3, 1e-3)},
                "f32 plain ops": {"energy": (0.4, 0.1), "forces": (0.4, 0.1)},
                "bf16 served route, plain versions": {"energy": (2e-5, 3e-6),
                                                      "forces": (2e-5, 3e-6)},
                "f32 through the kernels": {"energy": (1e-5, 3e-6), "forces": (1e-5, 3e-6)}},
    # DimeNet (four runs): bf16 plain ops energy (3.5e-6 to 3.8e-6, 5.9e-7
    # to 7.4e-7), forces (1.0e-6 to 1.1e-6, 1.0e-7); f32 plain ops (0.117,
    # 3.5e-2), (0.129, 1.7e-2); the served route through K1's plain version
    # (3.6e-6 to 4.4e-6, 6.6e-7 to 9.1e-7), (1.0e-6 to 1.1e-6, 1.0e-7); f32
    # through K1 (1.9e-6 to 3.7e-6, 5.1e-7 to 6.4e-7), (9.8e-7 to 1.2e-6,
    # 1.1e-7). MACE (four runs): bf16 plain ops and the served route through
    # K1's plain version (5.3e-7, 1.2e-7), forces 0; f32 plain ops (1.0e-2,
    # 6.0e-3), (6.3e-3, 1.6e-3); f32 through K1 (1.0e-7 to 1.7e-7, 4.0e-8),
    # (1.7e-7, 2.1e-8). Limits at about three to five times
    "dimenet": {"bf16 plain ops": {"energy": (2e-5, 3e-6), "forces": (5e-6, 5e-7)},
                "f32 plain ops": {"energy": (0.35, 0.1), "forces": (0.4, 0.05)},
                "bf16 served route, plain versions": {"energy": (2e-5, 3e-6),
                                                      "forces": (5e-6, 5e-7)},
                "f32 through the kernels": {"energy": (1e-5, 2e-6), "forces": (5e-6, 5e-7)}},
    "mace": {"bf16 plain ops": {"energy": (3e-6, 6e-7), "forces": (3e-6, 6e-7)},
             "f32 plain ops": {"energy": (0.05, 0.02), "forces": (0.03, 5e-3)},
             "bf16 served route, plain versions": {"energy": (3e-6, 6e-7),
                                                   "forces": (3e-6, 6e-7)},
             "f32 through the kernels": {"energy": (1e-6, 2e-7), "forces": (1e-6, 2e-7)}},
}


# gin_ring answers (one graph total per request) against the same route through
# the kernels' plain versions and against the dense fallback, relative to the
# largest reference: (largest row, median row). All f32: the same function
# in another summation order. Readings from this script on an H100 (NVIDIA
# H100 80GB HBM3, 700 W) at seed 0, (largest, median): plain versions
# (8.1e-7, 3.7e-7), dense fallback (8.8e-7, 3.4e-7); limits at about four
# times each. The totals are dominated by GIN's local branch (its (1 + eps)
# x = 101 x), so these gates are coarse on the attention; the phase prints
# how far a wrong attention (K4b's partials given to the wrong queries)
# moves them, and fails if these limits would not catch it. The kernel
# checks are the tight ones.
GIN_RING_RTOL = {"ring route, plain versions": (3e-6, 1.5e-6),
                 "dense fallback": (3e-6, 1.5e-6)}


# egnn_train: the training path through K1 and K2 against the same steps
# through their plain versions (both differentiable to any order), on the
# same weights and batches. Per parameter max|g - g_plain| / max|g_plain|
# (largest parameter, median parameter; the denominator floored at
# GRAD_FLOOR of the largest gradient); the per-step relative difference of
# the losses over the trajectory; the energy-force step's loss, its forces
# per atom relative to the largest (largest row, median row) and its
# gradients. Readings from this script on an H100 (NVIDIA H100 80GB HBM3,
# 700 W) at seed 0: f32 gradients (6.8e-3 to 1.04e-2, 1.8e-3 to 2.8e-3),
# bf16 gradients (1.5e-2 to 2.1e-2, 2.9e-3 to 3.9e-3), trajectory 2.5e-3 to
# 5.5e-3, energy-force loss 6.9e-7 to 9.7e-7, forces (1.65e-2 to 1.66e-2,
# 9.8e-5 to 1.09e-4), gradients (4.5e-2 to 4.8e-2, 2.4e-3). Limits at about
# three times each, except the forces' largest row: the first limits,
# (0.01, 1e-3), failed on that row (1.66e-2), which no f32 route can bring
# under ~1.7e-2: the plain route and the plain route with K1's sums
# correctly rounded lie 1.69e-2 from the same step in f64 in their largest
# row (one atom's force hangs on a rounding-sized flip); the new limit is
# three times that. The plain route against itself and with K1 or K2
# alone swapped for its kernel are printed beside each reading: for the
# MAE step every control reads as far as the kernels do (its index_add_
# atomics land in another order; the forward's rounding flips ReLUs and
# MAE signs). In the energy-force step K1's kernel alone carries the whole
# gap, and its values do, not its Function: the plain route's graph with
# K1's kernel values reads the same, with correctly rounded sums it does
# not. K1's sums on that step's data lie closer to f64 than its plain
# version's in every call (gated below); the step through them lies
# further from the f64 step, as the plain route does with K1's kernel
# values in the conv-1 sum alone (PERF.md, Findings and Open questions).
GRAD_FLOOR = 1e-3
TRAIN_RTOL = {"f32 gradients": (0.03, 0.01), "bf16 gradients": (0.06, 0.012),
              "trajectory": 0.02, "energy-force loss": 4e-6,
              "energy-force forces": (0.05, 4e-4), "energy-force gradients": (0.15, 8e-3)}
# OC20-shaped graphs of the egnn_train cell (the first 128 are the serving
# cell's): 23 packed batches of 32 in its 90% train split
TRAIN_GRAPHS = 768
# K1 and K2 launches of one train step (its forward: the backwards launch no
# kernel), by case: the served batch's, as the cast is the same (bf16
# parameters and inputs; the coordinate mean's f32 counts promote conv
# layers 1-3 to f32); and of the energy-force step, all f32
TRAIN_PER_STEP = {"K1": {"bfloat16/C866": 1, "float32/C866": 2,
                         "bfloat16/C3": 1, "float32/C3": 2},
                  "K2": {"float32/866x866": 1}}
EF_PER_STEP = {"K1": {"float32/C866": 3, "float32/C3": 3}, "K2": {"float32/866x866": 1}}


# gps_pna_train: the gps_pna cell's model trained with the same Training
# block (its config is the JAX bench's: AdamW lr 1e-3, MAE, task weights
# [1, 100], bf16 mixed precision; the step guard on) on the train split of
# GPS_TRAIN_GRAPHS OC20-shaped graphs, batch 16, not packed. K3 and K4 run
# forward as in serving (conv layer 0 bf16, the rest promoted to f32); their
# backwards are torch ops. Limits: gradients per parameter (largest,
# median) and the per-step relative difference of the two trajectories,
# against the same steps through K3's and K4's plain versions. Readings
# from this script on an H100 (NVIDIA H100 80GB HBM3, 700 W) at seed 0,
# three runs: f32 gradients (0.0708 to 0.0709, 1.2e-5 to 1.6e-3) beside the
# plain route again (0.031, 7.9e-4 to 9.8e-4: its index_add_ atomics); bf16
# gradients (0.163 to 0.164, 0.049), which K4's kernel alone reproduces (in
# bf16 it rounds p against a running maximum, its plain version against
# the row's final one), beside the plain route again (0.027 to 0.089,
# 2.0e-3 to 3.6e-3); trajectories 3.5e-3 to 5.0e-3. Limits at about three
# times each.
GPS_TRAIN_GRAPHS = 384
GPS_TRAIN_PER_STEP = {"K3": {"bfloat16/C256": 1, "float32/C256": 3},
                      "K4": {"bfloat16/H8xd32": 1, "float32/H8xd32": 3}}
GPS_TRAIN_RTOL = {"f32 gradients": (0.2, 5e-3), "bf16 gradients": (0.5, 0.15),
                  "trajectory": 0.015}
# gin_ring_train: the gin_ring cell's model (f32) trained through
# make_sp_train_step on a ring of one rank, AdamW lr 3e-3 (the mesoscale
# example's), over the gin_ring phase's requests for GIN_RING_EPOCHS epochs.
# K1 and K4b run forward four times a step. Limits: gradients against the
# K1/K4b plain route and against the dense fallback (no SP context), and the
# trajectories' per-step difference, in the first epoch, relative to its
# mean loss. Readings from this script on an H100 (NVIDIA H100 80GB HBM3,
# 700 W) at seed 0, two runs: gradients against the plain route (8.0e-3,
# 5.5e-4), against the dense fallback (9.6e-3, 5.9e-4), the plain route
# against the dense fallback (8.7e-3, 6.9e-4); the first epoch's steps up to
# 8.8e-3 (later steps up to 0.94, and the plain route with K1 summing in
# index_add_'s order up to 0.41: with one graph per step a rounding
# difference grows). Limits at about three times each.
GIN_RING_EPOCHS = 4
GIN_RING_TRAIN_PER_STEP = {"K1": {"float32/C256": 4}, "K4b": {"float32/H8xd32": 4}}
GIN_RING_TRAIN_RTOL = {"plain route": (0.03, 2e-3), "dense fallback": (0.03, 2e-3),
                       "trajectory": 0.03}


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def run_kernels(cases):
    """Check every case against its plain version, then time it."""
    import torch

    results = []
    for kc in cases:
        name = kc["name"]
        out_k = _outputs(kc["fn"]())
        out_p = _outputs(kc["plain"]())
        torch.cuda.synchronize()
        check(len(out_k) == len(out_p), f"{name}: {len(out_k)} outputs vs {len(out_p)}")
        atol, rtol = TOLERANCES[(kc["kernel"], kc["dtype"])]
        err = 0.0
        for i, (a, b) in enumerate(zip(out_k, out_p)):
            check(a.dtype == b.dtype and a.shape == b.shape,
                  f"{name}: kernel output {i} {a.dtype} {tuple(a.shape)} vs plain "
                  f"{b.dtype} {tuple(b.shape)}")
            if i in (kc["check_exact"] or ()):
                check(torch.equal(a, b), f"{name}: output {i} is not exactly the plain one")
            err_i = float((a.float() - b.float()).abs().max())
            # each output against its own largest value, unless the case
            # names the scale
            scale = kc["scale"] if kc["scale"] is not None else float(b.float().abs().max())
            tol = atol + rtol * scale
            print(f"check {name}: output {i}: max_abs_err {err_i:.6g} (tolerance {tol:.6g} "
                  f"= {atol} + {rtol} x scale {scale:.6g})", flush=True)
            check(math.isfinite(err_i) and err_i <= tol,
                  f"{name}: kernel output {i} disagrees with its plain version")
            err = max(err, err_i)
        if kc["gradients"] is not None:
            fn, (route, independent), inputs, seed = kc["gradients"]
            want_1, want_2, scales = first_and_second(independent, inputs, seed)
            launches = _wrappers()[kc["kernel"]].launches
            got_1, got_2, _ = first_and_second(fn, inputs, seed, scales)
            torch.cuda.synchronize()
            check(_wrappers()[kc["kernel"]].launches == launches + 1,
                  f"{name}: the gradients launched {_wrappers()[kc['kernel']].launches - launches}"
                  " kernels, not the forward's one")
            rtol = GRAD_TOLERANCES[kc["dtype"]]
            for order, got, want in (("first", got_1, want_1), ("second", got_2, want_2)):
                for i, (a, b) in enumerate(zip(got, want)):
                    check(a.dtype == b.dtype and a.shape == b.shape,
                          f"{name}: {order}-order gradient {i} {a.dtype} {tuple(a.shape)} vs "
                          f"{b.dtype} {tuple(b.shape)}")
                    err_g = float((a.float() - b.float()).abs().max())
                    scale = float(b.float().abs().max())
                    print(f"check {name}: {order}-order gradient {i} against {route}: "
                          f"max_abs_err {err_g:.6g} (tolerance {rtol} x scale {scale:.6g})",
                          flush=True)
                    check(math.isfinite(err_g) and err_g <= rtol * scale,
                          f"{name}: the {order}-order gradient {i} disagrees with {route}")
            del got_1, got_2, want_1, want_2
        iters = kc["iters"]
        ms = cuda_ms(kc["fn"], iters)
        plain_ms = cuda_ms(kc["plain"], max(iters // 5, 2))
        library_ms = cuda_ms(kc["library"], iters) if kc["library"] is not None else None
        bound_bytes_ms = kc["nbytes"] / PEAK_BYTES_PER_S * 1e3
        bound_ops_ms = kc["ops_ms"]
        results.append(dict(
            kernel=kc["kernel"], case=kc["case"], name=name, route="cuda",
            source=kc["source"], replaces=kc["replaces"], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=max(bound_bytes_ms, bound_ops_ms),
            bound_by="bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
            library_ms=library_ms, shape=kc["shape"],
        ))
        print(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}, bound "
              f"{results[-1]['bound_ms']:.4f} ms ({results[-1]['bound_by']})", flush=True)
        dev, split = {}, {}
        for w in ("fn", "plain", "library"):
            dev[w], split[w] = (None, {}) if kc[w] is None else device_ms(kc[w], 10)
        shown = {w: "n/a" if kc[w] is None else "not measured" if t is None else f"{t:.4f} ms"
                 for w, t in dev.items()}
        print(f"device time {name} (torch.profiler, per call): kernel {shown['fn']}, "
              f"plain {shown['plain']}, library {shown['library']}; the kernel call's "
              f"device work by name: " + ", ".join(
                  f"{_short(key)} {ms:.4f} ms" for key, ms in sorted(split["fn"].items())),
              flush=True)
        if kc["kernel"] == "K3":  # one launch per call: no row-pointer or long-row kernel
            check(len(split["fn"]) == 1, f"{name}: {len(split['fn'])} device kernels per call")
        results[-1].update(backward_ms=None, backward_library_ms=None)
        if kc["backward"] is not None:
            launches = _wrappers()[kc["kernel"]].launches
            bwd = kc["backward"]()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            bwd()
            torch.cuda.synchronize()
            bwd_peak = (torch.cuda.max_memory_allocated() - base) / 2**20
            bwd_ms = cuda_ms(bwd, max(iters // 5, 2))
            bwd_dev, bwd_split = device_ms(bwd, 5)
            check(_wrappers()[kc["kernel"]].launches == launches + 1,
                  f"{name}: the backward launched a kernel")
            del bwd
            lib_ms = lib_dev = None
            if kc["library_backward"] is not None:
                lib = kc["library_backward"]()
                lib_ms = cuda_ms(lib, max(iters // 5, 2))
                lib_dev, _ = device_ms(lib, 5)
                del lib
            results[-1].update(backward_ms=bwd_ms, backward_device_ms=bwd_dev,
                               backward_library_ms=lib_ms)
            print(f"time {name} backward (torch ops, no kernel): {bwd_ms:.4f} ms, device "
                  f"{'not measured' if bwd_dev is None else f'{bwd_dev:.4f} ms'}, peak memory "
                  f"above its start {bwd_peak:.1f} MiB; library "
                  + ("n/a" if lib_ms is None else
                     f"(SDPA forward + backward) {lib_ms:.4f} ms, device "
                     + ("not measured" if lib_dev is None else f"{lib_dev:.4f} ms"))
                  + "; by name: " + ", ".join(
                      f"{_short(key, 60)} {ms:.4f} ms"
                      for key, ms in sorted(bwd_split.items(), key=lambda kv: -kv[1])[:6]),
                  flush=True)
        del out_k, out_p
    return results


def profile_batch(server, graphs, label: str) -> None:
    """Where one served batch spends its time: host batching, then
    ``profile_forward`` on its forward (the level's CUDA graph replay: the
    graphs stripped of their targets, as the server admits requests)."""
    from hydragnn_tpu_torch.data.graph import batch_graphs
    from hydragnn_tpu_torch.serve.server import _strip_targets

    spec = server.ladder.specs[-1]
    gs, n, e = [], 0, 0
    for g in map(_strip_targets, graphs):  # the first that fit one batch, as the batcher takes them
        if len(gs) == spec.n_graphs - 1 or n + g.num_nodes > spec.n_nodes - 1 \
                or e + g.num_edges > spec.n_edges:
            break
        gs.append(g)
        n, e = n + g.num_nodes, e + g.num_edges
    t0 = time.perf_counter()
    batch = batch_graphs(gs, server.ladder.select_for(gs), sort_edges=server.sort_edges)
    host_ms = (time.perf_counter() - t0) * 1e3
    profile_forward(label, f"batch of {len(gs)} graphs, host batching {host_ms:.2f} ms",
                    lambda: server.forward(batch))


def profile_forward(label: str, what: str, forward, noun: str = "forward",
                    groups=None) -> None:
    """The wall time of ``forward()`` (median of 5 after one more), then
    calls under torch.profiler (one to warm it up, not recorded: a cold
    profile can drop a call's first kernels, then two recorded): device time
    by kernel and the device's busy share, per call. ``noun`` names the call
    in the printed line; ``groups`` (name -> substrings of kernel names)
    sums the device time of the kernels each group matches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    walls = []
    for _ in range(6):
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    forward_ms = float(np.median(walls[1:]))
    calls, prof_walls = 2, []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=calls)) as prof:
        for i in range(1 + calls):
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            if i > 0:
                prof_walls.append((time.perf_counter() - t0) * 1e3)
            if i < calls:  # a step after the last call would end the cycle, and drop it
                prof.step()
    prof_wall_ms = float(np.mean(prof_walls))
    rows = [(_device_us(ev) / calls, ev.key, ev.count // calls) for ev in _device_events(prof)]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"profile: {label}: {what}, {noun} {forward_ms:.2f} ms (median of 5), under the "
          f"profiler {prof_wall_ms:.2f} ms with the device busy {busy_ms:.2f} ms per call "
          f"({100 * busy_ms / prof_wall_ms:.1f}% of the profiled call, "
          f"{100 * busy_ms / forward_ms:.1f}% of the median unprofiled one)", flush=True)
    for dev_us, key, count in rows[:20 if noun != "forward" else 14]:
        print(f"profile: {dev_us / 1e3:9.3f} ms {100 * dev_us / 1e3 / max(busy_ms, 1e-9):5.1f}% "
              f"x{count:<4d} {key[:100]}", flush=True)
    for name, parts in (groups or {}).items():
        ms = sum(r[0] for r in rows if any(p in r[1] for p in parts)) / 1e3
        print(f"profile: {label}: {name}: {ms:.3f} ms of the device time "
              f"({100 * ms / max(busy_ms, 1e-9):.1f}%)", flush=True)


def _wrappers():
    import importlib

    return {k: getattr(importlib.import_module(f"hydragnn_tpu_torch.ops.{mod}"), fn)
            for k, (mod, fn) in KERNELS.items()}


def _zero_launches(wrappers) -> None:
    """Every wrapper's launches, run and replayed (train/compile_plane.py), to 0."""
    for w in wrappers.values():
        w.launches = w.replayed = 0
        w.launches_by_case.clear()
        w.replayed_by_case.clear()


def _check_launches(label, wrappers, per_unit, units, unit="steps"):
    """Every kernel's launches against ``per_unit`` (by case) times the
    ``units`` (batches, requests or steps) driven; a kernel not named must
    not launch. A launch is one the wrapper ran or one a CUDA graph's
    replay ran (``replayed``: ``run_training`` and ``run_server`` replay
    each ladder level's captured step). Returns them by (kernel, case)."""
    launches = {k: (w.launches + w.replayed,
                    dict(collections.Counter(w.launches_by_case) + w.replayed_by_case))
                for k, w in wrappers.items()}
    print(f"{label}: launches in {units} {unit} " + ", ".join(
        f"{k} {n} {cases}" for k, (n, cases) in launches.items()), flush=True)
    for k, (_, cases) in launches.items():
        want = {case: per * units for case, per in per_unit.get(k, {}).items()}
        check(cases == want, f"{label}: {k} launched {cases} in {units} {unit}, expected {want}")
    return {(k, case): n for k, (_, cases) in launches.items() for case, n in cases.items()}


PLAIN = ("K1", "K2", "K3", "K4", "K4b", "N1")


@contextlib.contextmanager
def swapped(swaps):
    """Within the block, each ``(module, name, fn)`` of ``swaps`` has
    ``module.name`` set to ``fn``."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def plain_swaps(k1=None):
    """Kernel -> (module, name, plain version) of the model's call site of
    each kernel; ``k1`` replaces K1's plain version."""
    import hydragnn_tpu_torch.models.gps as gps
    import hydragnn_tpu_torch.ops.segment as segment
    import hydragnn_tpu_torch.parallel.ring_attention as ring
    from hydragnn_tpu_torch.ops.flash_attention import (
        reference_block_summary,
        reference_masked_attention,
    )
    from hydragnn_tpu_torch.ops.fused_edge import reference_edge_message_sum
    import hydragnn_tpu_torch.ops.numerics_stats as nstats
    from hydragnn_tpu_torch.ops.multi_agg import reference_multi_agg
    from hydragnn_tpu_torch.ops.sorted_segment import sorted_segment_sum_plain

    return {
        "K4": (gps, "flash_self_attention",
               lambda q, k, v, ng, nm, g, nmax: reference_masked_attention(q, k, v, ng, nm)),
        "K3": (segment, "fused_multi_agg", reference_multi_agg),
        "K1": (segment, "sorted_segment_sum", k1 or sorted_segment_sum_plain),
        "K2": (segment, "_fused_edge_message_sum", reference_edge_message_sum),
        "K4b": (ring, "flash_block_summary", reference_block_summary),
        "N1": (nstats, "numerics_stats", nstats.numerics_stats_plain),
    }


def plain_versions(swap=PLAIN, k1=None):
    """Within the block, the model's call sites of the kernels named in
    ``swap`` take the kernels' plain versions on the card (the same route,
    no kernel; each differentiable as its kernel's Function is). ``k1``
    replaces K1's plain version (``segment_sum_plain``: the same sums in
    ``index_add_``'s order, through ordinary autograd)."""
    swaps = plain_swaps(k1)
    return swapped([swaps[k] for k in swap])


def run_serving(label, config, graphs, device, n_requests: int, per_batch_cases, hook=None):
    """Serve ``n_requests`` through ``api.run_server`` and check them.
    ``per_batch_cases`` maps each kernel to its launches per served batch by
    case; a kernel not named must not launch. ``hook(server, requests,
    results)`` runs more checks before the server closes."""
    import numpy as np
    import torch

    from hydragnn_tpu_torch.api import run_server
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.data.graph import batch_graphs
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train.loop import cast_batch_bf16, mp_cast_model

    wrappers = _wrappers()
    tr, va, te = split_dataset(graphs, 0.9, seed=0)
    arch, training = config["NeuralNetwork"]["Architecture"], config["NeuralNetwork"]["Training"]
    attn = (f", GPS {arch['global_attn_type']} x{arch['global_attn_heads']} heads, PE "
            f"{arch['pe_dim']}" if arch.get("global_attn_engine") else "")
    print(f"serve {label}: {arch['mpnn_type']} hidden {arch['hidden_dim']}, "
          f"{arch['num_conv_layers']} conv layers, equivariant {arch['equivariance']}{attn}, "
          f"heads {head_dims(arch)}, batch {training['batch_size']}, "
          f"packed {training.get('pack_batches', False)}, mixed precision "
          f"{training['mixed_precision']}, "
          f"sorted aggregation {arch['use_sorted_aggregation']}, random weights (seed {SEED})",
          flush=True)
    t0 = time.perf_counter()
    server = run_server(config, datasets=(tr, va, te), device=device, seed=SEED)
    check(server.wait_ready(timeout=600), f"server warm-up failed: {server.failed}")
    print(f"serve {label}: ready in {time.perf_counter() - t0:.2f} s (warm-up "
          f"{server.warmup_compiled})", flush=True)
    requests = [graphs[i % len(graphs)] for i in range(n_requests)]
    batches0 = server.stats()["batches"]

    # the main path: every launch count from 0, read right after
    _zero_launches(wrappers)
    t_start = time.perf_counter()
    handles = [server.submit(g) for g in requests]
    results = [h.result(timeout=600) for h in handles]
    t_end = max(h.done_at for h in handles)
    torch.cuda.synchronize()
    stats = server.stats()
    batches = stats["batches"] - batches0
    launched = _check_launches(f"serve {label}", wrappers, per_batch_cases, batches, "batches")

    lat = np.asarray([h.done_at - h.submitted_at for h in handles]) * 1e3
    gps = n_requests / (t_end - t_start)
    print(f"serve {label}: {n_requests} requests in {batches} batches, {gps:.1f} graphs/s, "
          f"latency p50 {np.percentile(lat, 50):.2f} ms p99 {np.percentile(lat, 99):.2f} ms",
          flush=True)
    per_batch = {k: round(1e3 * v / max(batches, 1), 3) for k, v in stats["seconds"].items()}
    print(f"serve {label}: ms per batch in the serve loop (all batches since start, warm-up "
          f"excluded): {per_batch}", flush=True)
    check(stats["failed_batches"] == 0 and stats["rejected"] == 0, f"serving stats {stats}")
    check(batches > 0, f"{label}: no batch served")
    var = training.get("loss_function_type") == "GaussianNLLLoss"
    heads = {"energy", "forces"} | ({"energy__var", "forces__var"} if var else set())
    for g, r in zip(requests, results):
        check(set(r) == heads, f"served heads {sorted(r)}")
        check(all(r[k].shape == (1,) and r[k.replace("energy", "forces")].shape
                  == (g.num_nodes, 3) for k in heads if k.startswith("energy")),
              f"served shapes {r['energy'].shape} {r['forces'].shape} for {g.num_nodes} nodes")
        check(all(np.isfinite(v).all() for v in r.values()), "non-finite served output")
        check(not var or min(float(r[k].min()) for k in heads if k.endswith("__var")) >= 0,
              "a negative served variance")

    # the served answers against the same weights through the plain ops
    # (unsorted route, dense attention, no kernels) on the card, batch by
    # served batch: the same graphs at the same pad level, so the kernels
    # are the only difference from the plain versions. With the server's
    # bf16 cast (for EGNN the same function in another summation
    # order; GPS's dense attention takes its softmax in bf16 where K4 keeps
    # f32) and in f32 (what mixed precision costs). With GPS also against
    # the served route itself with the wrappers swapped for the kernels'
    # plain versions (the same function), and the server's f32 model through
    # the kernels against the f32 plain ops.
    plain = dict(use_sorted_aggregation=False, use_fused_edge_kernel=False,
                 use_flash_attention=False)
    models = {}
    for r, bf16 in (("bf16 plain ops", True), ("f32 plain ops", False)):
        ref_cfg = copy.deepcopy(config)
        ref_cfg["NeuralNetwork"]["Architecture"].update(plain)
        model = create_model(update_config(ref_cfg, tr, va, te), device=device)
        model.load_state_dict(server.model.state_dict())
        models[r] = (mp_cast_model(model), cast_batch_bf16) if bf16 else (model, lambda b: b)
    pairs = [("served", "bf16 plain ops"), ("served", "f32 plain ops")]
    if "bf16 served route, plain versions" in SERVE_RTOL[label]:
        models["bf16 served route, plain versions"] = (mp_cast_model(server.model), cast_batch_bf16)
        models["f32 through the kernels"] = (server.model, lambda b: b)
        pairs += [("served", "bf16 served route, plain versions"),
                  ("f32 through the kernels", "f32 plain ops")]
    # limits per comparison, named by its reference (or by the model held
    # against the f32 plain ops)
    rtol = {(a, r): SERVE_RTOL[label][r if a == "served" else a] for a, r in pairs}
    errs = {(a, r, k): [] for a, r in pairs for k in rtol[a, r]}  # per output row
    scale = dict.fromkeys(errs, 0.0)
    served_batches = {}
    for i, h in enumerate(handles):
        served_batches.setdefault(h.batch_index, []).append(i)
    with torch.inference_mode():
        for idx in served_batches.values():
            gs = [requests[i] for i in idx]
            batch = batch_graphs(gs, server.ladder.select_for(gs),
                                 sort_edges=server.sort_edges).to(device)
            outs = {"served": None}
            for r, (model, cast) in models.items():
                with plain_versions(PLAIN if r.endswith("plain versions") else ()):
                    out = model(cast(batch))
                outs[r] = {k: v.float().cpu().numpy() for k, v in out.items()}
            off = 0
            for i, g in enumerate(gs):
                rows = {"energy": slice(i, i + 1), "forces": slice(off, off + g.num_nodes)}
                off += g.num_nodes
                for a, r in pairs:
                    for k in rtol[a, r]:
                        got = results[idx[i]][k] if a == "served" else outs[a][k][rows[k]]
                        want = outs[r][k][rows[k]].reshape(got.shape)
                        errs[a, r, k].append(np.abs(got - want).reshape(got.shape[0], -1)
                                             .max(axis=1))
                        scale[a, r, k] = max(scale[a, r, k], float(np.abs(want).max()))
    for a, r in pairs:
        lim = rtol[a, r]
        err = {k: np.concatenate(errs[a, r, k]) for k in lim}
        rel = {k: err[k] / max(scale[a, r, k], 1e-12) for k in lim}
        worst = {k: float(v.max()) for k, v in rel.items()}
        median = {k: float(np.median(v)) for k, v in rel.items()}
        print(f"serve {label}: {a} vs {r}: max abs err "
              f"{ {k: float(v.max()) for k, v in err.items()} }, max |ref| "
              f"{ {k: scale[a, r, k] for k in lim} }, relative: largest {worst}, median "
              f"row {median} (tolerance (largest, median) {lim} of max |ref|)", flush=True)
        check(all(worst[k] <= lim[k][0] and median[k] <= lim[k][1] for k in lim),
              f"{label}: {a} disagrees with {r}")
    profile_batch(server, graphs, label)
    if hook is not None:
        hook(server, requests, results)
    server.close()
    print(f"serving {label}: {gps:.1f} graphs/s, p50 {np.percentile(lat, 50):.2f} ms, "
          f"p99 {np.percentile(lat, 99):.2f} ms", flush=True)
    return launched


def run_gin_ring(topology, topology_s: float, device, n_requests: int, requests=None):
    """SP evaluation of one spanning graph per request through
    ``parallel.make_sp_eval_step`` (a ring of one rank) and its checks;
    ``requests`` is ``gin_ring_requests``' result when made already (the
    smoke makes it while the kernels build). Returns the launches by
    (kernel, case), the completed config and the requests' batches (on the
    host)."""
    import numpy as np
    import torch

    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.data.graph import batch_graphs
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.parallel import make_sp_eval_step

    label = "gin_ring"
    wrappers = _wrappers()
    graphs, pe_s = requests or gin_ring_requests(topology, n_requests)
    n_atoms = topology.num_nodes
    print(f"{label}: BCC supercell of {GIN_RING_CELLS}^3 cells, {n_atoms} atoms, "
          f"{topology.num_edges} periodic edges: topology built in {topology_s:.2f} s, "
          f"Laplacian PE of 4 (dense eigh) in {pe_s:.2f} s", flush=True)
    config = update_config(gin_ring_config(), graphs, graphs[:1], graphs[:1])
    arch = config["NeuralNetwork"]["Architecture"]
    print(f"{label}: {arch['mpnn_type']} hidden {arch['hidden_dim']}, "
          f"{arch['num_conv_layers']} conv layers, GPS {arch['global_attn_type']} "
          f"x{arch['global_attn_heads']} heads, PE {arch['pe_dim']}, graph head "
          f"{arch['output_heads']['graph']['dim_headlayers']}, batch 1, f32, sorted aggregation "
          f"{arch['use_sorted_aggregation']} (in-degree bound {arch['max_in_degree']}), "
          f"block-summary kernel {arch['use_flash_attention']}, random weights (seed {SEED})",
          flush=True)
    check(arch["use_sorted_aggregation"] and arch["use_flash_attention"],
          f"{label}: config completion did not turn the kernels on")
    model = create_model(config, device=device, seed=SEED)
    evalf = make_sp_eval_step(model, device=device)
    spec = gin_ring_spec(graphs[0])
    t0 = time.perf_counter()
    batches = [batch_graphs([g], spec, sort_edges=True) for g in graphs]
    host_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    evalf(batches[0])  # warm-up, not counted
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()

    # the main path: every launch count from 0, read right after
    _zero_launches(wrappers)
    torch.cuda.reset_peak_memory_stats()
    walls, results = [], []
    for b in batches:
        t0 = time.perf_counter()
        results.append(evalf(b))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    ring_peak = torch.cuda.max_memory_allocated() - resident
    launched = _check_launches(label, wrappers, {"K1": {"float32/C256": 4},
                                                 "K4b": {"float32/H8xd32": 4}},
                               len(batches), "requests")
    for tot, tasks, out in results:
        check(set(out) == {"total"} and tuple(out["total"].shape) == (2, 1),
              f"{label}: outputs { {k: tuple(v.shape) for k, v in out.items()} }")
        check(bool(torch.isfinite(out["total"][0]).all()) and math.isfinite(float(tot))
              and math.isfinite(float(tasks["total"])), f"{label}: non-finite output or loss")
    print(f"{label}: losses " + ", ".join(f"{float(t):.6g}" for t, _, _ in results), flush=True)

    # the answers against the same route through the kernels' plain versions,
    # and against the dense fallback (no SP context: [H, N, N] f32 logits)
    refs = {}
    with plain_versions():
        refs["ring route, plain versions"] = [evalf(b)[2]["total"][0] for b in batches]
        again = [evalf(b)[2]["total"][0] for b in batches]
    drift = max(float((a - b).abs().max()) for a, b in zip(refs["ring route, plain versions"], again))
    print(f"{label}: the plain-versions route run twice: largest difference {drift:.6g}", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        refs["dense fallback"] = [model(b.to(device))["total"][0] for b in batches]
    torch.cuda.synchronize()
    dense_peak = torch.cuda.max_memory_allocated() - resident
    got = torch.stack([out["total"][0] for _, _, out in results]).float().cpu().numpy()
    for r, rows in refs.items():
        want = torch.stack(rows).float().cpu().numpy()
        err = np.abs(got - want).max(axis=1)
        scale = float(np.abs(want).max())
        rel = err / max(scale, 1e-12)
        worst, median = float(rel.max()), float(np.median(rel))
        lim = GIN_RING_RTOL[r]
        print(f"{label}: ring route vs {r}: max abs err {float(err.max()):.6g}, max |ref| "
              f"{scale:.6g}, relative: largest {worst:.6g}, median row {median:.6g} "
              f"(tolerance (largest, median) {lim} of max |ref|)", flush=True)
        check(worst <= lim[0] and median <= lim[1], f"{label}: the ring route disagrees with {r}")
    # what the gates can see: the same route with K4b's partials rolled by
    # one query (each query gets its neighbour's attention)
    import hydragnn_tpu_torch.parallel.ring_attention as ring

    summary = ring.flash_block_summary
    ring.flash_block_summary = lambda *a: tuple(t.roll(1, 0) for t in summary(*a))
    try:
        wrong = torch.stack([evalf(b)[2]["total"][0] for b in batches]).float().cpu().numpy()
    finally:
        ring.flash_block_summary = summary
    rel = np.abs(wrong - got).max(axis=1) / max(float(np.abs(got).max()), 1e-12)
    print(f"{label}: gate sensitivity: the attention rolled by one query moves the totals by "
          f"largest {float(rel.max()):.6g}, median row {float(np.median(rel)):.6g} of the largest",
          flush=True)
    check(float(rel.max()) > min(lim[0] for lim in GIN_RING_RTOL.values()),
          f"{label}: the answer gates would not see a wrong attention")

    ms = float(np.mean(walls))
    profile_forward(label, f"one spanning graph of {n_atoms} nodes, host batching "
                           f"{host_ms:.2f} ms", lambda: evalf(batches[0]))
    print(f"{label}: {ms:.2f} ms per forward (mean of {len(walls)}: "
          f"{', '.join(f'{w:.2f}' for w in walls)}), {n_atoms / ms * 1e3:.1f} nodes/s, peak "
          f"memory above the resident {resident / 2**20:.1f} MiB: ring route "
          f"{ring_peak / 2**20:.1f} MiB, dense fallback {dense_peak / 2**20:.1f} MiB", flush=True)
    return launched, config, batches


def train_config(energy_force: bool = False, **kw):
    """The egnn_train cell: ``serving_config``'s SC25-shaped EGNN with the
    JAX benchmark's Training block (bench.py ``_production_workload``:
    AdamW lr 1e-3, MAE, task weights [1, 100], bf16 mixed precision, packed
    batch 32, sorted aggregation, the non-finite step guard on). With
    ``energy_force``: one node head of nodal energy, forces ``-dE/dpos``
    (``compute_grad_energy``), the atomic number as the only node input,
    in f32, as the OC20 example trains it
    (examples/open_catalyst_2020/open_catalyst_2020.json)."""
    config = serving_config(**kw)
    return energy_force_config(config) if energy_force else config


def energy_force_config(config):
    """``config`` turned to the energy-force objective: one node head of
    nodal energy, forces ``-dE/dpos`` (``compute_grad_energy``), the atomic
    number as the only node input, in f32."""
    config = copy.deepcopy(config)
    nn_cfg = config["NeuralNetwork"]
    nn_cfg["Architecture"].update(task_weights=[1.0], output_heads={
        "node": nn_cfg["Architecture"]["output_heads"]["node"]})
    nn_cfg["Variables_of_interest"] = {
        "input_node_features": [0], "output_names": ["graph_energy"],
        "output_index": [0], "output_dim": [1], "type": ["node"]}
    nn_cfg["Training"].update(compute_grad_energy=True, mixed_precision=False)
    return config


def _train_copy(model, device, lr: float = 1e-3, guard: bool = True):
    """A copy of ``model`` (weights and batch-norm statistics) with a fresh
    AdamW of the cell (``lr``, the step guard's copies where ``guard``):
    two routes start from one init."""
    from hydragnn_tpu_torch.train import TrainState, make_optimizer

    m = copy.deepcopy(model).to(device)
    return TrainState.create(m, make_optimizer(m, {"type": "AdamW", "learning_rate": lr}),
                             guard=guard)


def route_gradients(model, batch, device, routes, make_step, **copy_kw):
    """route -> every parameter's gradient of one train step on ``batch``
    from ``model``'s weights, each route with its kernels swapped for their
    plain versions (``routes``: route -> (kernels to swap, K1's
    replacement)); ``make_step(state)`` is the step as a call of one
    batch."""
    grads = {}
    for route, (swap, k1) in routes.items():
        state = _train_copy(model, device, **copy_kw)
        with plain_versions(swap, k1):
            make_step(state)(batch)
        grads[route] = _grads(state)
        del state
    return grads


def trajectories(label, model, batches, device, make_step, swap, per_step, controls=None,
                 **copy_kw):
    """Train a copy of ``model`` over ``batches`` through the kernels (the
    main path: every launch count from 0 and the peak memory reset just
    before, read just after), another through the plain versions of
    ``swap``, and one through each of ``controls`` (name -> (kernels to
    swap, K1's replacement)), all from one init. Returns (losses through
    the kernels, through the plain versions, the wall seconds of steps 4
    on, the launches by (kernel, case), the peak memory in bytes, the
    kernels' final state, the controls' losses by name)."""
    import torch

    wrappers = _wrappers()
    routes = {"kernels": ((), None), "plain": (swap, None), **(controls or {})}
    losses, walls, peaks = {}, {}, {}
    for route, (swapped_out, k1) in routes.items():
        state = _train_copy(model, device, **copy_kw)
        step = make_step(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if route == "kernels":
            _zero_launches(wrappers)
        out, t0 = [], None
        with plain_versions(swapped_out, k1):
            for i, b in enumerate(batches):
                if i == 3:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                out.append(step(b)[1])
            torch.cuda.synchronize()
        walls[route] = time.perf_counter() - t0
        peaks[route] = torch.cuda.max_memory_allocated()
        if route == "kernels":
            launched = _check_launches(label, wrappers, per_step, len(batches))
            kernel_state = state
        losses[route] = torch.stack(out).float().cpu().numpy()
        del state, step
    print(f"{label}: by route, ms per step (steps 4-{len(batches)}) and peak memory: " + ", ".join(
        f"{r} {walls[r] * 1e3 / (len(batches) - 3):.2f} ms, {peaks[r] / 2**20:.1f} MiB"
        for r in routes), flush=True)
    return (losses.pop("kernels"), losses.pop("plain"), walls["kernels"], launched,
            peaks["kernels"], kernel_state, losses)


def train_routes():
    """The routes of one train step that the gates compare: route -> (the
    kernels swapped for their plain versions, K1's replacement). Besides
    the kernels and the plain versions: the plain route again (its
    ``index_add_`` atomics land in another order), each kernel alone, and
    the plain route with K1 summing in ``index_add_``'s order
    (``segment_sum_plain``, ordinary autograd): how far the same sums in
    another order move the answers."""
    from hydragnn_tpu_torch.ops.sorted_segment import segment_sum_plain

    return {"kernels": ((), None), "plain": (PLAIN, None),
            "the plain route again": (PLAIN, None),
            "K1's kernel, K2 plain": (("K2",), None),
            "K2's kernel, K1 plain": (("K1",), None),
            "the plain route with K1 in index_add_'s order": (PLAIN, segment_sum_plain)}


def k1_against_f64(readings: list):
    """Within the block, each call of K1 at the model's call site also sums
    its messages in f64 and in f32 through K1's fixed-order plain version
    and ``index_add_``; ``readings`` gets, per call, each f32 sum's error
    against the f64 one (largest and root-mean-square, relative to the f64
    sums' largest and root-mean-square)."""
    import torch

    import hydragnn_tpu_torch.ops.segment as segment
    from hydragnn_tpu_torch.ops.sorted_segment import (
        segment_sum_plain,
        sorted_segment_sum_plain,
    )

    inner = segment.sorted_segment_sum

    def summed(messages, segment_ids, num_segments):
        out = inner(messages, segment_ids, num_segments)
        with torch.no_grad():
            m, ids = messages.detach(), segment_ids.long()
            keep = ids < num_segments
            ref = torch.zeros((num_segments,) + tuple(m.shape[1:]), dtype=torch.float64,
                              device=m.device).index_add_(0, ids[keep], m[keep].double())
            top, rms = float(ref.abs().max()), float(ref.square().mean().sqrt())
            sums = {"kernel": out.detach(),
                    "fixed order": sorted_segment_sum_plain(m, segment_ids, num_segments),
                    "index_add_": segment_sum_plain(m, segment_ids, num_segments)}
            readings.append((f"{str(m.dtype)[6:]}/C{m.shape[1]}", {
                k: (float((v.double() - ref).abs().max()) / top,
                    float((v.double() - ref).square().mean().sqrt()) / rms)
                for k, v in sums.items()}))
        return out

    return swapped([(segment, "sorted_segment_sum", summed)])


def k1_values(calls=None):
    """K1's replacement for a rounding draw: the fixed-order plain version's
    autograd graph carrying other f32 values of the same sums, K1's kernel
    values in the calls numbered ``calls`` (from 0) and the plain
    version's in the rest; with ``calls`` None, every sum correctly
    rounded from f64."""
    import torch

    from hydragnn_tpu_torch.ops.sorted_segment import (
        sorted_segment_sum,
        sorted_segment_sum_plain,
    )

    seen = []

    def summed(messages, segment_ids, num_segments):
        out = sorted_segment_sum_plain(messages, segment_ids, num_segments)
        seen.append(None)
        with torch.no_grad():
            m = messages.detach()
            if calls is None:
                ids = segment_ids.long()
                keep = ids < num_segments
                v = torch.zeros(out.shape, dtype=torch.float64, device=out.device).index_add_(
                    0, ids[keep], m[keep].double()).to(out.dtype)
            elif len(seen) - 1 in calls:
                v = sorted_segment_sum(m, segment_ids, num_segments)
            else:
                return out
        # the values v (a one-ulp difference is exact in f32), out's graph
        return out + (v - out).detach()

    return summed


def pinned_clamps(masks: list, flips=None):
    """Within the block, the +-1e6 clamp of the PaiNN update block
    (``painn.update_clamp``: PAINN's and PNAEq's) records, call by call,
    which elements it saturates into the empty list ``masks``; given a
    filled ``masks`` (``flips`` a list), it saturates exactly those
    elements, whatever its input, and ``flips`` gets per call how many
    elements its own input would have saturated otherwise. Two routes
    through the same clamp decisions compute one function that is
    continuous in their roundings."""
    import torch

    import hydragnn_tpu_torch.models.painn as painn

    replay = iter(list(masks))

    def clamp(t):
        hi, lo = t > 1e6, t < -1e6
        if flips is None:
            masks.append((hi, lo))
            return torch.clamp(t, -1e6, 1e6)
        phi, plo = next(replay)
        flips.append(int(((hi != phi) | (lo != plo)).sum()))
        return torch.where(phi, t.new_full((), 1e6), torch.where(plo, t.new_full((), -1e6), t))

    return swapped([(painn, "update_clamp", clamp)])


def pinned_decisions(masks: list, flips=None):
    """Within the block, every ReLU (``torch.relu``, which ``F.relu``
    calls), every leaky ReLU of the port's layers and the variance clamp of
    the Gaussian NLL record, call by call, which elements they pass into
    the empty list ``masks``; given a filled ``masks`` (``flips`` a list)
    they take exactly those decisions, whatever their input, and ``flips``
    gets per call how many their own input would have taken otherwise. Two
    routes through the same decisions compute one function that is
    continuous in their roundings (``pinned_act`` does it for one MLP).
    Both routes must make the same calls in the same order: a kernel that
    fuses ReLUs (K2) has to run in both."""
    import torch

    import hydragnn_tpu_torch.models.layers as layers
    import hydragnn_tpu_torch.train.loss as loss

    replay = iter(list(masks))

    def decide(keep):
        if flips is None:
            masks.append(keep)
            return keep
        want = next(replay)
        flips.append(int((keep != want).sum()))
        return want

    def pinned_relu(t):
        return torch.where(decide(t > 0), t, t.new_zeros(()))

    def pinned_leaky(v, negative_slope=0.01):
        slope = torch.tensor(negative_slope, dtype=v.dtype, device=v.device)
        return torch.where(decide(v >= 0), v, slope * v)

    def pinned_nll(pred, var, target, eps=1e-6):
        v = torch.where(decide(var >= eps), var, var.new_full((), eps))
        return 0.5 * (torch.log(v) + (pred - target) ** 2 / v)

    return swapped([(torch, "relu", pinned_relu), (layers, "leaky_relu", pinned_leaky),
                    (loss, "_nll_elementwise", pinned_nll)])


def pinned_route_gradients(label, model, batch, device, mixed_precision, limit,
                           reference=("K1",)):
    """One train step's gradients through the kernels against the same step
    through the plain versions of ``reference`` (K2 runs in both: it fuses
    its ReLUs), every ReLU, leaky ReLU and variance clamp held to the
    reference's decisions (``pinned_decisions``), under deterministic
    algorithms; gated by ``grad_gate`` at ``limit``, beside the reference
    again on its own decisions. Prints how many decisions each route's own
    input would have flipped."""
    import torch

    from hydragnn_tpu_torch.train import make_train_step

    dname = "bf16" if mixed_precision else "f32"
    masks, flips, grads = [], {}, {}
    with deterministic():
        for route, swap in (("reference", reference), ("kernels", ()),
                            ("the reference again", reference)):
            state = _train_copy(model, device)
            flips[route] = None if route == "reference" else []
            with plain_versions(swap), pinned_decisions(masks, flips[route]):
                make_train_step(state.model, mixed_precision=mixed_precision)(state, batch)
            grads[route] = _grads(state)
            del state
        torch.cuda.synchronize()
    print(f"{label}: {dname} step 0 against the plain version of {'/'.join(reference)}, "
          f"{len(masks)} activation and clamp calls held to their decisions (deterministic "
          f"algorithms); decisions each route's own input would have flipped: kernels "
          f"{sum(flips['kernels'])}, the reference again {sum(flips['the reference again'])}",
          flush=True)
    gradients_present(f"{label}: {dname} step 0", grads["kernels"], grads["reference"])
    grad_gate(f"{dname} gradients vs {'/'.join(reference)} plain, decisions pinned",
              grads["kernels"], grads["reference"], limit,
              {"the reference again": grads["the reference again"]}, cell=label)


def pinned_act(mlp, masks: list, flips=None):
    """Within the block, the activation of the MLP ``mlp`` (a ReLU or a
    leaky ReLU) records, call by call, which elements it passes (input > 0)
    into the empty list ``masks``; given a filled ``masks`` (``flips`` a
    list), it passes exactly those elements and scales the rest by its
    slope, whatever their sign, and ``flips`` gets per call how many
    decisions its own input would have made otherwise (as
    ``pinned_clamps``)."""
    import torch

    act = mlp.act
    slope = -float(act(torch.tensor(-1.0)))
    replay = iter(list(masks))

    def pinned(t):
        if flips is None:
            masks.append(t > 0)
            return act(t)
        passed = next(replay)
        flips.append(int((passed != (t > 0)).sum()))
        return torch.where(passed, t, slope * t)

    return swapped([(mlp, "act", pinned)])


def f64_sums():
    """Within the block, the model's segment sums (K1's and K2's call sites
    and the graph pooling) add in their inputs' dtype by ``index_add_``,
    where the port's plain versions accumulate in f32: the sums of an f64
    reference step."""
    import torch

    import hydragnn_tpu_torch.ops.segment as segment

    def sum_in_dtype(messages, segment_ids, num_segments):
        out = messages.new_zeros((num_segments,) + tuple(messages.shape[1:]))
        return out.index_add(0, segment_ids.long(), messages)

    def edge_sum(node_recv, edge_in, weights, bias, segment_ids, num_segments):
        pre = node_recv[segment_ids.long()] + edge_in
        return sum_in_dtype(torch.relu(torch.relu(pre) @ weights + bias), segment_ids,
                            num_segments)

    return swapped([(segment, name, sum_in_dtype) for name in
                    ("sorted_segment_sum", "sorted_segment_sum_plain", "segment_sum_plain")]
                   + [(segment, "_fused_edge_message_sum", edge_sum),
                      (segment, "fused_multi_agg", moments_in_dtype)])


def moments_in_dtype(node_recv, edge_in, gate, segment_ids, num_segments):
    """K3's five moments, ``reference_multi_agg``'s statement with every
    moment in the messages' dtype (f64 for a reference step), where the
    port's plain version widens to f32 and stops there."""
    import torch

    ids = segment_ids.long()
    msg = edge_in if node_recv is None else node_recv[ids] + edge_in
    if gate is not None:
        msg = msg * gate
    shape = (num_segments,) + tuple(msg.shape[1:])
    idx = ids[:, None].expand_as(msg)
    big = torch.finfo(msg.dtype).max
    cnt = msg.new_zeros(num_segments).index_add(0, ids, msg.new_ones(ids.shape[0]))
    nonempty = (cnt > 0)[:, None]
    mn = msg.new_full(shape, big).scatter_reduce(0, idx, msg, "amin")
    mx = msg.new_full(shape, -big).scatter_reduce(0, idx, msg, "amax")
    return (msg.new_zeros(shape).index_add(0, ids, msg), cnt,
            torch.where(nonempty, mn, 0.0), torch.where(nonempty, mx, 0.0),
            msg.new_zeros(shape).index_add(0, ids, msg * msg))


def k3_against_f64(readings: list):
    """Within the block, each call of K3 at the model's call site also
    takes the same moments in f64 and through K3's plain version;
    ``readings`` gets, per call, the sum's and the sum of squares' error of
    each f32 route against f64 (largest and root-mean-square, relative to
    the f64 moment's), and whether the kernel's count, min and max equal
    the plain version's bit for bit."""
    import torch

    import hydragnn_tpu_torch.ops.segment as segment
    from hydragnn_tpu_torch.ops.multi_agg import reference_multi_agg

    inner = segment.fused_multi_agg

    def agg(node_recv, edge_in, gate, segment_ids, num_segments):
        out = inner(node_recv, edge_in, gate, segment_ids, num_segments)
        with torch.no_grad():
            ops = [None if t is None else t.detach() for t in (node_recv, edge_in, gate)]
            ref = moments_in_dtype(*[None if t is None else t.double() for t in ops],
                                   segment_ids, num_segments)
            plain = reference_multi_agg(*ops, segment_ids, num_segments)
            errs = {}
            for route, got in (("kernel", out), ("plain version", plain)):
                for i, moment in ((0, "sum"), (4, "sumsq")):
                    d = got[i].detach().double() - ref[i]
                    errs[f"{route} {moment}"] = (
                        float(d.abs().max()) / float(ref[i].abs().max()),
                        float(d.square().mean().sqrt()) / float(ref[i].square().mean().sqrt()))
            exact = all(bool(torch.equal(out[i].detach(), plain[i])) for i in (1, 2, 3))
            readings.append((f"{str(edge_in.dtype)[6:]}/C{edge_in.shape[1]}", errs, exact))
        return out

    return swapped([(segment, "fused_multi_agg", agg)])


def carried_values(kernel: str):
    """Within the block, the model's call site of ``kernel`` (K1 or K3)
    runs its plain version's autograd graph carrying the kernel's values
    (launched on the same inputs): the kernel route's forward, bit for
    bit, and the plain version's backward."""
    import torch

    import hydragnn_tpu_torch.ops.segment as segment
    from hydragnn_tpu_torch.ops.multi_agg import fused_multi_agg, reference_multi_agg
    from hydragnn_tpu_torch.ops.sorted_segment import (
        sorted_segment_sum,
        sorted_segment_sum_plain,
    )

    class Carry(torch.autograd.Function):
        @staticmethod
        def forward(ctx, out, values):
            return values.clone()

        @staticmethod
        def backward(ctx, grad):
            return grad, None

    def carry(outs, values):
        return tuple(Carry.apply(o, v) if o.requires_grad else v for o, v in zip(outs, values))

    def k1(messages, segment_ids, num_segments):
        return carry([sorted_segment_sum_plain(messages, segment_ids, num_segments)],
                     [sorted_segment_sum(messages.detach(), segment_ids, num_segments)])[0]

    def k3(node_recv, edge_in, gate, segment_ids, num_segments):
        ops = [None if t is None else t.detach() for t in (node_recv, edge_in, gate)]
        return carry(reference_multi_agg(node_recv, edge_in, gate, segment_ids, num_segments),
                     fused_multi_agg(*ops, segment_ids, num_segments))

    return swapped([(segment, "sorted_segment_sum", k1)] if kernel == "K1"
                   else [(segment, "fused_multi_agg", k3)])


@contextlib.contextmanager
def deterministic(caught: list = None):
    """Within the block, PyTorch's deterministic algorithms (``index_add_``
    and the gathers' backwards without atomics), warning where an op has
    none; ``caught`` gets those warnings' messages."""
    import warnings

    import torch

    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            yield
        if caught is not None:
            caught.extend(sorted({str(w.message)[:120] for w in got}))
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def _grads(state):
    return {n: p.grad.detach().float().clone() for n, p in state.model.named_parameters()}


def grad_reading(got, want):
    """Per parameter ``max|g - g_want| / max|g_want|``, the denominator
    floored at ``GRAD_FLOOR`` of the largest gradient of any parameter:
    (largest, its parameter, median, largest without the floor)."""
    import numpy as np

    top = max(float(w.abs().max()) for w in want.values())
    err = {n: float((got[n] - w).abs().max()) for n, w in want.items()}
    raw = {n: e / max(float(want[n].abs().max()), 1e-30) for n, e in err.items()}
    rel = {n: e / max(float(want[n].abs().max()), GRAD_FLOOR * top) for n, e in err.items()}
    worst = max(rel, key=rel.get)
    return rel[worst], worst, float(np.median(list(rel.values()))), max(raw.values())


def grad_gate(label: str, got, want, limit, controls, cell: str = "egnn_train") -> None:
    """Per parameter ``max|g - g_plain| / max|g_plain|``, the denominator
    floored at ``GRAD_FLOOR`` of the largest gradient of any parameter (a
    parameter whose gradient is zero in exact arithmetic, such as the bias
    of a dense layer that feeds a batch norm, holds rounding noise in both
    routes): the largest (and which parameter) and the median against
    ``limit`` (largest, median); the largest without the floor is printed
    too, and the same reading for each of ``controls`` (name -> gradients:
    the cell's other routes)."""
    top = max(float(w.abs().max()) for w in want.values())
    largest, worst, median, raw = grad_reading(got, want)
    print(f"{cell}: {label}: per-parameter max|g - g_ref| / max|g_ref| over "
          f"{len(want)} parameters (floor {GRAD_FLOOR} x {top:.6g}): largest {largest:.6g} "
          f"({worst}), median {median:.6g} "
          f"(limits {limit}); without the floor largest {raw:.6g}" + "".join(
              "; {}: largest {:.6g} ({}), median {:.6g}".format(name, *grad_reading(g, want)[:3])
              for name, g in controls.items()), flush=True)
    check(largest <= limit[0] and median <= limit[1],
          f"{cell}: {label}: gradients through the kernels disagree")


def gradients_present(label: str, grads, reference) -> None:
    """Every parameter that has a gradient in ``reference`` (the plain
    route's: a parameter the loss does not reach has none there either) has
    a finite, nonzero one in ``grads``."""
    import torch

    bad = [n for n, g in grads.items() if not bool(torch.isfinite(g).all())
           or (float(g.norm()) == 0.0 and float(reference[n].norm()) != 0.0)]
    unused = [n for n, g in reference.items() if float(g.norm()) == 0.0]
    print(f"{label}: gradients of {len(grads)} parameters: {len(bad)} not finite, or zero where "
          f"the plain route's is not {bad[:5]}; zero on the plain route too (no path to the "
          f"loss): {unused}", flush=True)
    check(not bad, f"{label}: parameters without a finite nonzero gradient: {bad[:5]}")


def trajectory_gate(label: str, lk, lp, limit: float, extra: str = "") -> None:
    """The two routes' loss trajectories: every loss finite, and each
    step's relative difference within ``limit``."""
    import numpy as np

    rel = np.abs(lk - lp) / np.abs(lp)
    print(f"{label}: losses through the kernels {lk[0]:.6g} -> {lk[-1]:.6g}, through the plain "
          f"versions {lp[0]:.6g} -> {lp[-1]:.6g} over {len(lk)} steps; per-step relative "
          f"difference largest {float(rel.max()):.6g} (step {int(rel.argmax())}), median "
          f"{float(np.median(rel)):.6g} (limit {limit}){extra}", flush=True)
    check(bool(np.isfinite(lk).all() and np.isfinite(lp).all()), f"{label}: a non-finite loss")
    check(float(rel.max()) <= limit, f"{label}: the trajectories part")


def run_training_epoch(label: str, config, splits, per_step, epochs: int = 1):
    """``api.run_training`` for ``epochs`` epochs (the config's
    ``num_epoch``) with no device given (the current CUDA device): every
    train step and every val/test batch launches the step's table
    ``per_step``, none in a backward; the state on the card, every step
    taken and every loss finite. Returns the launches by (kernel, case)."""
    import torch

    from hydragnn_tpu_torch.api import prepare_data, run_training

    wrappers = _wrappers()
    check(int(config["NeuralNetwork"]["Training"]["num_epoch"]) == epochs,
          f"{label}: num_epoch is not {epochs}")
    _, loaders, _ = prepare_data(copy.deepcopy(config), splits)
    units = epochs * sum(len(loader) for loader in loaders)
    _zero_launches(wrappers)
    t0 = time.perf_counter()
    _, state, hist = run_training(copy.deepcopy(config), datasets=splits, seed=SEED)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = _check_launches(f"{label} run_training", wrappers, per_step, units,
                               "steps and eval batches")
    print(f"{label}: run_training (no device given: {state.step.device}), {epochs} epoch(s) in "
          f"{seconds:.2f} s: {int(state.step)} steps, history {hist}, guard skips "
          f"{int(state.skipped_steps)}", flush=True)
    check(state.step.device.type == "cuda" and int(state.step) == epochs * len(loaders[0])
          and int(state.skipped_steps) == 0
          and all(math.isfinite(v) for k in ("train", "val", "test") for v in hist[k]),
          f"{label}: run_training did not train on the card")
    return launched


def run_egnn_train(graphs, serve_graphs, device, per_step):
    """Phase 7: the SC25-shaped EGNN trained at full width through K1 and K2
    with gradients (``make_train_step``), against the same steps through
    the kernels' plain versions; one epoch of ``api.run_training``; one
    energy-force step. Returns the launches by (kernel, case) of the kernel
    route's trajectory, the epoch and the energy-force step."""
    import torch

    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.data import GraphLoader, split_dataset
    from hydragnn_tpu_torch.data.pipeline import _pack_spec
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train import compute_loss, make_train_step

    label = "egnn_train"
    wrappers = _wrappers()
    config = train_config()
    tr, va, te = split_dataset(graphs, 0.9, seed=0)
    config = update_config(config, tr, va, te)
    arch, training = config["NeuralNetwork"]["Architecture"], config["NeuralNetwork"]["Training"]
    # the serving cell's packed budget, so the kernels run at the shapes
    # the kernel phase checked and timed
    spec = _pack_spec(serve_graphs, int(training["batch_size"]))
    loader = GraphLoader(tr, int(training["batch_size"]), spec=spec, pack=True,
                         shuffle=True, seed=0, sort_edges=True)
    batches = list(loader)
    steps = len(batches)
    check(steps >= 20, f"{label}: {steps} packed batches, fewer than 20 steps")
    print(f"{label}: {arch['mpnn_type']} hidden {arch['hidden_dim']}, {arch['num_conv_layers']} "
          f"conv layers, heads {arch['output_heads']['graph']['dim_headlayers']} / "
          f"{arch['output_heads']['node']['dim_headlayers']}, task weights "
          f"{arch['task_weights']}, AdamW lr 1e-3 (optax defaults), MAE, packed batch "
          f"{training['batch_size']} ({spec}), bf16 mixed precision, guard on, sorted "
          f"aggregation {arch['use_sorted_aggregation']}, fused edge "
          f"{arch['use_fused_edge_kernel']}; {len(tr)} training graphs, {steps} steps, "
          f"random weights (seed {SEED})", flush=True)
    model = create_model(config, device=device, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())

    # 1-2. one step's gradients through K1/K2 against the plain versions,
    # from the same weights on the same batch, in f32 and in bf16; every
    # parameter's gradient finite and nonzero
    routes = train_routes()
    for mp in (False, True):
        dname = "bf16" if mp else "f32"
        grads = route_gradients(model, batches[0], device, routes, lambda st, mp=mp: (
            lambda b: make_train_step(st.model, mixed_precision=mp)(st, b)))
        torch.cuda.synchronize()
        bad = [n for n, g in grads["kernels"].items()
               if not bool(torch.isfinite(g).all()) or float(g.norm()) == 0.0]
        print(f"{label}: {dname} step-0 gradients of {len(grads["kernels"])} parameters "
              f"({n_params} values): {len(bad)} not finite or zero {bad[:5]}", flush=True)
        check(not bad, f"{label}: parameters without a finite nonzero gradient: {bad[:5]}")
        grad_gate(f"{dname} gradients vs plain route", grads["kernels"], grads["plain"],
                  TRAIN_RTOL[f"{dname} gradients"],
                  {r: g for r, g in grads.items() if r not in ("kernels", "plain")})
        del grads

    # 3-5. the trajectories: every step through the kernels (the main path:
    # launch counts from 0, read right after) and through the plain versions
    lk, lp, wall, launched, peak, kernel_state, _ = trajectories(
        label, model, batches, device,
        lambda st: (lambda b: make_train_step(st.model, mixed_precision=True)(st, b)),
        PLAIN, per_step)
    skipped = int(kernel_state.skipped_steps)
    trajectory_gate(label, lk, lp, TRAIN_RTOL["trajectory"], f"; guard skips {skipped}")
    check(skipped == 0, f"{label}: the guard skipped {skipped} steps")
    real = sum(int(b.graph_mask.sum()) for b in batches[3:])
    ms = wall * 1e3 / (steps - 3)
    print(f"{label}: {ms:.2f} ms per step, {real / wall:.1f} graphs/s trained (steps 4-{steps}, "
          f"{real} real graphs); peak memory {peak / 2**20:.1f} MiB", flush=True)
    step = make_train_step(kernel_state.model, mixed_precision=True)
    profile_forward(label, f"one train step of {int(batches[0].graph_mask.sum())} graphs "
                           "(forward, backward, guard and AdamW)",
                    lambda: step(kernel_state, batches[0]), noun="step", groups={
                        "K1 (forward)": ["sorted_segment_sum_"],
                        "K2 (forward, with its row-pointer and W-layout kernels)":
                            ["fused_edge_kernel", "rowptr_kernel", "prep_w_kernel"],
                        "f32 GEMMs (cuBLAS and CUTLASS, forward and backward)":
                            ["gemm_f32f32", "sgemm"],
                        "bf16 GEMMs": ["bf16_s16816gemm"],
                        "AdamW and the guard's copy (multi-tensor kernels)":
                            ["multi_tensor_apply"],
                        "the guard's merge and other selects (where)": ["where"],
                        "gathers' backwards (index_add_, indexing backward)":
                            ["indexing_backward", "indexFuncLargeIndex", "index_add"],
                    })
    del kernel_state, step

    # the user's entry point: run_training with no device (the current CUDA
    # device), one epoch on the egnn cell's split (its budget, so the
    # kernels' shapes again): every train step and every val/test batch
    # launches the step's table, none in a backward
    rt_launched = run_training_epoch(label, train_config(),
                                     split_dataset(serve_graphs, 0.9, seed=0), per_step)

    # 6. one energy-force step at full width: forces -dE/dpos and the
    # parameter gradients (a double backward through K1 and K2) against the
    # plain route, f32, from the same weights on the same batch
    import dataclasses

    ef_graphs = [dataclasses.replace(g, x=g.x[:, :1]) for g in serve_graphs]
    tr, va, te = split_dataset(ef_graphs, 0.9, seed=0)
    ef_config = update_config(train_config(energy_force=True), tr, va, te)
    ef_model = create_model(ef_config, device=device, seed=SEED)
    batch = next(iter(GraphLoader(tr, 32, spec=spec, pack=True, shuffle=False,
                                  sort_edges=True))).to(device)
    res = {}
    for route, (swap, k1) in routes.items():
        m = copy.deepcopy(ef_model).train()
        if route == "kernels":
            torch.cuda.synchronize()
            _zero_launches(wrappers)
        with plain_versions(swap, k1):
            tot, tasks, preds = compute_loss(m, batch, m.cfg, True)
            tot.backward()
            torch.cuda.synchronize()
        if route == "kernels":
            ef_launched = _check_launches(f"{label} energy-force", wrappers, EF_PER_STEP, 1)
        res[route] = (tot.item(), preds["forces"].detach(),
                      {n: p.grad.detach().clone() for n, p in m.named_parameters()})
        del m, tot, tasks, preds
    # the same step in f64 (weights, inputs and sums): how far each f32
    # route lies from the exact forces and gradients
    m = copy.deepcopy(ef_model).double().train()
    b64 = batch.replace(**{f: getattr(batch, f).double() for f in ("x", "pos", "edge_attr",
                                                                    "edge_shifts")
                           if getattr(batch, f) is not None})
    with f64_sums():
        tot, tasks, preds = compute_loss(m, b64, m.cfg, True)
        tot.backward()
    f64 = (preds["forces"].detach(), {n: p.grad.detach() for n, p in m.named_parameters()})
    del m, b64, tot, tasks, preds
    # K1's sums on this step's data against f64 (the forward, with forces)
    readings = []
    with k1_against_f64(readings):
        compute_loss(copy.deepcopy(ef_model).train(), batch, ef_model.cfg, True)
    torch.cuda.synchronize()
    for i, (case, errs) in enumerate(readings):
        print(f"{label}: energy-force K1 call {i} ({case}) against an f64 sum, (largest, rms) "
              "relative: " + ", ".join(f"{k} ({a:.3g}, {r:.3g})" for k, (a, r) in errs.items()),
              flush=True)
        check(all(k <= p for k, p in zip(errs["kernel"], errs["fixed order"])),
              f"{label}: K1's sums in call {i} lie further from f64 than its plain version's")
    (tk, fk, gk), (tp, fp, gp) = res["kernels"], res["plain"]
    mask = batch.node_mask
    scale = float(fp[mask].abs().max())

    def rows(f):
        return (f - fp)[mask].abs().max(dim=1).values / scale

    frow = rows(fk)
    controls = [r for r in routes if r not in ("kernels", "plain")]
    lim = TRAIN_RTOL["energy-force forces"]
    print(f"{label}: energy-force step (f32, {int(mask.sum())} atoms): loss {tk:.6g} vs plain "
          f"{tp:.6g}; forces largest row {float(frow.max()):.6g}, median row "
          f"{float(frow.median()):.6g} of max |F_plain| {scale:.6g} (limits {lim})" + "".join(
              f"; {r}: largest row {float(rows(res[r][1]).max()):.6g}, median row "
              f"{float(rows(res[r][1]).median()):.6g}" for r in controls),
          flush=True)
    print(f"{label}: energy-force loss relative difference {abs(tk - tp) / abs(tp):.6g} "
          f"(limit {TRAIN_RTOL['energy-force loss']})" + "".join(
              f"; {r}: {abs(res[r][0] - tp) / abs(tp):.6g}" for r in controls), flush=True)
    check(math.isfinite(tk) and abs(tk - tp) <= TRAIN_RTOL["energy-force loss"] * abs(tp),
          f"{label}: the energy-force loss disagrees with the plain route")
    check(float(frow.max()) <= lim[0] and float(frow.median()) <= lim[1],
          f"{label}: the forces disagree with the plain route")
    bad = [n for n, g in gk.items() if not bool(torch.isfinite(g).all()) or float(g.norm()) == 0.0]
    check(not bad, f"{label}: energy-force parameters without a finite nonzero gradient: {bad[:5]}")
    grad_gate("energy-force gradients vs plain route", gk, gp, TRAIN_RTOL["energy-force gradients"],
              {r: res[r][2] for r in controls})
    # every route, and rounding draws (the plain route's graph with other
    # f32 values of K1's sums: its kernel's in some calls), against the f64
    # step: no gate, as one ulp in one sum can move the whole step (PERF.md)
    for draw, calls in (("K1's sums correctly rounded", None),
                        ("K1's kernel values in every call", set(range(6))),
                        *((f"K1's kernel values in call {c} only", {c}) for c in range(6)),
                        ("K1's kernel values in calls 1, 3 and 5 (C = 866)", {1, 3, 5})):
        m = copy.deepcopy(ef_model).train()
        with plain_versions(PLAIN, k1_values(calls)):
            tot, tasks, preds = compute_loss(m, batch, m.cfg, True)
            tot.backward()
        res[f"the plain route with {draw}"] = (
            tot.item(), preds["forces"].detach(),
            {n: p.grad.detach().clone() for n, p in m.named_parameters()})
        del m, tot, tasks, preds
    f_scale = float(f64[0][mask].abs().max())

    def from_f64(f, g):
        frows = (f - f64[0])[mask].abs().max(dim=1).values / f_scale
        return float(frows.max()), float(frows.median()), grad_reading(g, f64[1])[2]

    print(f"{label}: energy-force step against the same step in f64, (largest force row, median "
          f"force row, median parameter gradient) relative: " + "; ".join(
              "{} ({:.3g}, {:.3g}, {:.3g})".format(r, *from_f64(f, g))
              for r, (_, f, g) in res.items()), flush=True)
    merged = collections.Counter(launched)
    merged.update(rt_launched)
    merged.update(ef_launched)
    return merged


def run_gps_pna_train(graphs, device, per_step):
    """GPS-PNA trained at full width through K3 and K4 with gradients
    (``run_cell_train``). Returns the launches by (kernel, case)."""
    return run_cell_train("gps_pna_train", gps_pna_config(), graphs, device, per_step,
                          ("K3", "K4"), GPS_TRAIN_RTOL, {
                              "K3 (forward)": ["multi_agg_kernel"],
                              "K4 (forward, with its graph row-pointer kernel)":
                                  ["flash_attention_kernel", "graph_ptr"],
                              "f32 GEMMs (cuBLAS and CUTLASS, forward and backward)":
                                  ["gemm_f32f32", "sgemm"],
                              "bf16 GEMMs": ["bf16_s16816gemm"],
                              "AdamW and the guard's copy (multi-tensor kernels)":
                                  ["multi_tensor_apply"],
                              "scatter and gather backwards (K3's min/max, the gathers)":
                                  ["scatter", "indexing_backward", "indexFuncLargeIndex",
                                   "index_add"],
                          })


def run_gin_ring_train(config, batches, device, per_step):
    """The gin_ring cell's model trained through ``make_sp_train_step`` (a
    ring of one rank) on the gin_ring phase's requests, so K1 and K4b carry
    gradients; held against the K1/K4b plain route and against the dense
    fallback (no SP context). Returns the launches by (kernel, case) of the
    kernel route's trajectory."""
    import numpy as np
    import torch

    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.ops.sorted_segment import segment_sum_plain
    from hydragnn_tpu_torch.parallel import make_sp_train_step
    from hydragnn_tpu_torch.train import make_train_step

    label = "gin_ring_train"
    n_atoms = int(batches[0].node_mask.sum())
    print(f"{label}: the gin_ring model, f32, AdamW lr 3e-3 (the mesoscale example's), no step "
          f"guard, through make_sp_train_step on a ring of one rank; {len(batches)} requests "
          f"of {n_atoms} atoms ({batches[0].num_nodes} nodes), {GIN_RING_EPOCHS} epochs, random "
          f"weights (seed {SEED})", flush=True)
    model = create_model(config, device=device, seed=SEED)
    copy_kw = dict(lr=3e-3, guard=False)

    def sp_step(state):
        return make_sp_train_step(state.model, state)

    # one step's gradients through K1/K4b against their plain versions, the
    # plain route again beside; then against the dense fallback outside the
    # SP context (its [8, N, N] f32 scores in every layer: one step, its
    # memory freed before the trajectories)
    swap = ("K1", "K4b")
    routes = {"kernels": ((), None), "plain": (swap, None), "the plain route again": (swap, None)}
    grads = route_gradients(model, batches[0], device, routes, sp_step, **copy_kw)
    torch.cuda.synchronize()
    gradients_present(f"{label}: step 0", grads["kernels"], grads["plain"])
    grad_gate("gradients vs plain route", grads["kernels"], grads["plain"],
              GIN_RING_TRAIN_RTOL["plain route"],
              {"the plain route again": grads["the plain route again"]}, cell=label)
    torch.cuda.reset_peak_memory_stats()
    state = _train_copy(model, device, **copy_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    make_train_step(state.model)(state, batches[0])
    torch.cuda.synchronize()
    dense_ms = (time.perf_counter() - t0) * 1e3
    dense_peak = torch.cuda.max_memory_allocated()
    dense = _grads(state)
    del state
    torch.cuda.empty_cache()
    print(f"{label}: the dense-fallback step: {dense_ms:.2f} ms (one step), peak memory "
          f"allocated {dense_peak / 2**20:.1f} MiB", flush=True)
    grad_gate("gradients vs dense fallback", grads["kernels"], dense,
              GIN_RING_TRAIN_RTOL["dense fallback"],
              {"the plain route": grads["plain"]}, cell=label)
    del grads, dense

    # the trajectories over the epochs, through the kernels (the main path),
    # through the plain versions and through the plain versions with K1
    # summing in index_add_'s order (a rounding control), from one init. A
    # step's loss is one request's, and they range over orders of
    # magnitude, so each step's difference is read against the plain
    # route's mean loss of the first epoch. With one graph per step and lr
    # 3e-3, a rounding difference grows within the second epoch (the
    # control's shows it), so the first epoch is gated and the rest printed
    steps = batches * GIN_RING_EPOCHS
    control = "the plain route with K1 in index_add_'s order"
    lk, lp, wall, launched, peak, kernel_state, others = trajectories(
        label, model, steps, device, sp_step, swap, per_step,
        {control: (swap, segment_sum_plain)}, **copy_kw)
    ms = wall * 1e3 / (len(steps) - 3)
    print(f"{label}: {ms:.2f} ms per step (steps 4-{len(steps)}), {n_atoms / ms * 1e3:.1f} "
          f"nodes/s trained; peak memory allocated: ring route {peak / 2**20:.1f} MiB, dense "
          f"fallback step {dense_peak / 2**20:.1f} MiB", flush=True)
    first = float(np.abs(lp[:len(batches)]).mean())
    diff = np.abs(lk - lp) / first
    drift = np.abs(others[control] - lp) / first
    epochs = lk.reshape(GIN_RING_EPOCHS, len(batches)).mean(axis=1)
    limit = GIN_RING_TRAIN_RTOL["trajectory"]
    print(f"{label}: losses through the kernels " + ", ".join(f"{x:.6g}" for x in lk)
          + "; through the plain versions " + ", ".join(f"{x:.6g}" for x in lp)
          + f"; difference per step of the first epoch's mean {first:.6g}: first epoch "
          + ", ".join(f"{x:.3g}" for x in diff[:len(batches)]) + f" (limit {limit}), largest "
          f"over all steps {float(diff.max()):.6g} (step {int(diff.argmax())}); {control}: "
          f"first epoch largest {float(drift[:len(batches)].max()):.3g}, all steps largest "
          f"{float(drift.max()):.6g} (step {int(drift.argmax())}); mean loss per epoch through "
          "the kernels " + ", ".join(f"{x:.6g}" for x in epochs), flush=True)
    check(bool(np.isfinite(lk).all() and np.isfinite(lp).all()), f"{label}: a non-finite loss")
    check(float(diff[:len(batches)].max()) <= limit,
          f"{label}: the first epoch's trajectories part")
    check(epochs[-1] < epochs[0], f"{label}: the last epoch's loss is not below the first's")
    step = sp_step(kernel_state)
    profile_forward(label, f"one train step of one spanning graph of {n_atoms} atoms "
                           "(forward, backward and AdamW)",
                    lambda: step(batches[0]), noun="step", groups={
                        "K4b (forward)": ["flash_attention_kernel"],
                        "K1 (forward)": ["sorted_segment_sum_"],
                        "f32 GEMMs (cuBLAS and CUTLASS, forward and backward)":
                            ["gemm_f32f32", "sgemm"],
                        "AdamW (multi-tensor kernels)": ["multi_tensor_apply"],
                    })
    del kernel_state, step
    return launched


# egnn_ckpt: the egnn_train cell's model and Training block on the egnn
# cell's graphs (its 90% train split, 4 packed steps an epoch), with
# best-validation checkpoints kept to the newest CKPT_RETENTION, trained,
# stopped and resumed through api.run_training, restored by run_prediction
# and run_server, under ./logs of a temporary directory. Gates: the round
# trip bit for bit; prediction and serving restored from disk against the
# in-memory weights, exactly when two in-memory runs agree bit for bit,
# else within CKPT_REPEAT times their spread; the walk-back after a byte
# flip; the replayed steps of a SIGTERM stop against an uninterrupted run,
# on the same terms; the rollback bit for bit, its LR backed off.
CKPT_EPOCHS = 3
CKPT_RETENTION = 2
CKPT_KILL = (1, 1)  # SIGTERM as the step of batch 1 of epoch 1 starts
CKPT_WALKBACK_REQUESTS = 64
CKPT_REPEAT = 4.0
CKPT_ROLLBACK = {"non_finite_policy": "rollback", "non_finite_rollback_after": 2,
                 "non_finite_lr_backoff": 0.5}


@contextlib.contextmanager
def ckpt_probes(log=None, kill_at=None, poison=(), losses=None, saves=None, restores=None,
                policies=None):
    """Within the block, each ``run_training`` / ``run_prediction`` /
    ``run_server`` call records what the arguments ask for: ``log`` gets
    each train batch handed out as ((epoch, index), graph ids); the process
    gets SIGTERM as the step of batch ``kill_at`` starts (device staging
    draws the batches ahead of their steps, so the signal is keyed on the
    step, through the hand-out order); the batches of the
    epochs in ``poison`` have NaN features; ``losses`` gets each train
    step's loss (on the device); ``saves`` (file, seconds, bytes) of each
    checkpoint save; ``restores`` (file, seconds, payload right after) of
    each full restore; ``policies`` the epoch loop's ``NonFinitePolicy``."""
    import os
    import signal

    import torch

    import hydragnn_tpu_torch.api as api
    import hydragnn_tpu_torch.train.checkpoint as ck
    import hydragnn_tpu_torch.train.loop as loop

    base, make_step = api.GraphLoader, loop.make_train_step
    save, load, policy = ck.save_model, ck.load_existing_model, loop.NonFinitePolicy

    handed, stepped = [], []  # the train batches' positions handed out; the steps run

    class Loader(base):
        def __iter__(self):
            groups = self._groups()[self.start_batch:]
            for k, (grp, batch) in enumerate(zip(groups, super().__iter__())):
                if self.shuffle:  # the train split
                    pos = (self.epoch, self.start_batch + k)
                    handed.append(pos)
                    if log is not None:
                        log.append((pos, tuple(int(i) for i in grp)))
                    if self.epoch in poison:
                        batch = batch.replace(x=torch.full_like(batch.x, float("nan")))
                yield batch

    def recording_step(model, *a, **kw):
        step = make_step(model, *a, **kw)

        def run(state, batch):
            if kill_at is not None and handed[len(stepped)] == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            stepped.append(1)
            out = step(state, batch)
            if losses is not None:
                losses.append(out[1].clone())
            return out

        return run

    def timed_save(state, log_name, path="./logs", epoch=None, retention=0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fname = save(state, log_name, path, epoch, retention)
        if saves is not None:
            saves.append((os.path.basename(fname), time.perf_counter() - t0,
                          os.path.getsize(fname)))
        return fname

    def timed_load(template, log_name, path="./logs", loaded_entry=None):
        names = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = load(template, log_name, path, names)
        torch.cuda.synchronize()
        if restores is not None:
            restores.append((names[0], time.perf_counter() - t0, state.to_payload()))
        if loaded_entry is not None:
            loaded_entry.extend(names)
        return state

    class Policy(policy):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            if policies is not None:
                policies.append(self)

    with swapped([(api, "GraphLoader", Loader), (loop, "make_train_step", recording_step),
                  (ck, "save_model", timed_save), (ck, "load_existing_model", timed_load),
                  (loop, "NonFinitePolicy", Policy)]):
        yield


def payload_mismatches(a, b, prefix=""):
    """Keys where two checkpoint payloads (or parts) differ: tensors by
    dtype, shape and bits, everything else by value."""
    import torch

    if torch.is_tensor(a) or torch.is_tensor(b):
        same = (torch.is_tensor(a) and torch.is_tensor(b) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b))
        return [] if same else [prefix]
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{prefix}: keys"]
        return [m for k in a for m in payload_mismatches(a[k], b[k], f"{prefix}.{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)) and len(a) == len(b):
        return [m for i, (x, y) in enumerate(zip(a, b))
                for m in payload_mismatches(x, y, f"{prefix}[{i}]")]
    return [] if a == b else [prefix]


def relative_gap(got, want) -> float:
    """Largest |got - want| over the largest |want|, across a list of
    per-head dicts (served answers) or one dict of arrays (predictions)."""
    import numpy as np

    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    err = max(float(np.abs(np.asarray(g[k]) - np.asarray(w[k])).max())
              for g, w in zip(got, want) for k in w)
    scale = max(float(np.abs(np.asarray(w[k])).max()) for w in want for k in w)
    return err / max(scale, 1e-30)


def repeat_gate(label: str, gap: float, spread: float, what: str) -> None:
    """``gap`` exactly 0 when two reference runs agree bit for bit
    (``spread`` 0), else within CKPT_REPEAT times their spread."""
    limit = CKPT_REPEAT * spread
    print(f"egnn_ckpt: {label}: {gap:.6g} relative to the largest value; two reference runs "
          f"{spread:.6g} apart, limit {limit:.6g} ({'exact' if spread == 0 else f'{CKPT_REPEAT}x'})",
          flush=True)
    check(gap <= limit, f"egnn_ckpt: {label}: {what}")


def serve_requests(server, requests, wrappers=None, per_batch=None):
    """Serve ``requests`` (all submitted at once) and close the server;
    with ``wrappers``, every launch count from 0 just before and checked
    per served batch just after. Returns (answers, checkpoint label)."""
    import torch

    check(server.wait_ready(timeout=600), f"egnn_ckpt: server warm-up failed: {server.failed}")
    batches0 = server.stats()["batches"]
    if wrappers is not None:
        _zero_launches(wrappers)
    handles = [server.submit(g) for g in requests]
    answers = [h.result(timeout=600) for h in handles]
    torch.cuda.synchronize()
    stats = server.stats()
    server.close()
    check(stats["failed_batches"] == 0 and stats["rejected"] == 0, f"egnn_ckpt: serving {stats}")
    launched = None
    if wrappers is not None:
        launched = _check_launches("egnn_ckpt run_server (restored)", wrappers, per_batch,
                                   stats["batches"] - batches0, "batches")
    return answers, stats["current_checkpoint"], launched


def run_egnn_ckpt(graphs, device, per_step):
    """Phase 10: checkpointed training of the egnn_train cell's model on the
    egnn cell's graphs: ``run_training`` with ``Training.Checkpoint``, the
    round trip into a fresh model and optimizer, ``run_prediction`` and
    ``run_server`` restored from disk, the walk-back past a corrupt file, a
    SIGTERM stop mid-epoch and its resume, and a rollback. Returns the
    launches by (kernel, case) of the training run, the prediction and the
    restored server."""
    import hashlib
    import os

    import numpy as np
    import torch

    from hydragnn_tpu_torch.api import prepare_data, run_prediction, run_server, run_training
    from hydragnn_tpu_torch.config import get_log_name_config
    from hydragnn_tpu_torch.data import split_dataset
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.serve import GraphServer, ServeConfig
    from hydragnn_tpu_torch.train import (InferenceState, TrainState, latest_checkpoint_entry,
                                          load_existing_model, load_inference_entry,
                                          load_loader_state, make_optimizer, test_model)
    from hydragnn_tpu_torch.utils import preemption

    label = "egnn_ckpt"
    wrappers = _wrappers()
    splits = split_dataset(graphs, 0.9, seed=0)
    config = train_config()
    config["NeuralNetwork"]["Training"].update(num_epoch=CKPT_EPOCHS, Checkpoint=True,
                                               checkpoint_retention=CKPT_RETENTION)
    # a batch window far longer than the submissions take: every batch is
    # cut by the graph cap or the pad budget, in request order, so two
    # servers form the same batches
    config["Serving"] = {"batch_window_s": 1.0}
    done, loaders, _ = prepare_data(copy.deepcopy(config), splits)
    name = get_log_name_config(done)
    per_epoch = []
    for e in range(CKPT_EPOCHS):
        loaders[0].set_epoch(e)
        per_epoch.append(len(loaders[0]))
    evals = len(loaders[1]) + len(loaders[2])
    arch, training = done["NeuralNetwork"]["Architecture"], done["NeuralNetwork"]["Training"]
    print(f"{label}: the egnn_train cell's model (hidden {arch['hidden_dim']}, "
          f"{arch['num_conv_layers']} conv layers, heads "
          f"{arch['output_heads']['graph']['dim_headlayers']}, mixed precision "
          f"{training['mixed_precision']}, AdamW, the guard on), {len(splits[0])} training "
          f"graphs, {per_epoch} packed steps of {training['batch_size']} per epoch, "
          f"{CKPT_EPOCHS} epochs, Checkpoint true, retention {CKPT_RETENTION}, ./logs/{name}/ "
          "under a temporary directory", flush=True)

    # 1. the round trip: run_training with checkpoints (launch counts from 0
    # just before, read just after), then the checkpoint into a fresh model
    # and optimizer
    log_a, losses_a, saves = [], [], []
    _zero_launches(wrappers)
    t0 = time.perf_counter()
    with ckpt_probes(log=log_a, losses=losses_a, saves=saves):
        model, state, hist = run_training(copy.deepcopy(config), datasets=splits, seed=SEED)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = collections.Counter(_check_launches(
        f"{label} run_training", wrappers, per_step, sum(per_epoch) + CKPT_EPOCHS * evals,
        "steps and eval batches"))
    losses_a = torch.stack(losses_a).float().cpu().numpy()
    print(f"{label}: run_training (no device given: {state.step.device}), {CKPT_EPOCHS} epochs in "
          f"{seconds:.2f} s, history {hist}; saves (file, seconds, bytes): {saves}", flush=True)
    check(state.step.device.type == "cuda" and int(state.skipped_steps) == 0
          and bool(np.isfinite(losses_a).all()), f"{label}: run_training did not train on the card")
    run_dir = os.path.join("logs", name)
    saved = [int(f.split("_epoch")[1].split(".")[0]) for f, _, _ in saves]
    kept = sorted(set(saved))[-CKPT_RETENTION:]
    # the retained checkpoints, the pointer and the completed config, beside
    # run_training's metric writer (utils/writer.py): scalars.jsonl and,
    # where TensorBoard imports, its event file
    want_files = sorted([f"{name}_epoch{e}.pt{s}" for e in kept for s in ("", ".sha256")]
                        + ["latest", "config.json", "scalars.jsonl"])
    files = sorted(f for f in os.listdir(run_dir) if not f.startswith("events.out.tfevents."))
    latest = latest_checkpoint_entry(name)
    print(f"{label}: on disk {files}, latest -> {latest}, payload "
          f"{os.path.getsize(os.path.join(run_dir, latest))} bytes", flush=True)
    check(files == want_files and latest == f"{name}_epoch{saved[-1]}.pt",
          f"{label}: the files on disk are not what retention and the pointer say ({want_files})")
    for f in files:
        if f.endswith(".pt"):
            with open(os.path.join(run_dir, f), "rb") as fh:
                digest = hashlib.sha256(fh.read()).hexdigest()
            with open(os.path.join(run_dir, f + ".sha256")) as fh:
                check(fh.read().strip() == digest, f"{label}: {f}'s sidecar does not match it")
    fresh_model = create_model(done, device=device, seed=SEED + 1)
    fresh = TrainState.create(fresh_model, make_optimizer(
        fresh_model, done["NeuralNetwork"]["Training"]["Optimizer"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    load_existing_model(fresh, name)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    bad = payload_mismatches(state.to_payload(), fresh.to_payload())
    print(f"{label}: round trip into a fresh model and AdamW: restore {restore_s:.3f} s, "
          f"{len(bad)} of the parameters, buffers, moments, counters and LR differ {bad[:5]}",
          flush=True)
    check(not bad, f"{label}: the round trip is not bit-exact: {bad[:5]}")
    del fresh, fresh_model

    # 2. run_prediction restored from disk against test_model on the
    # in-memory state (twice: the card's spread)
    test_loader = loaders[2]
    mem = [test_model(state.model, test_loader, mixed_precision=True)[2] for _ in range(2)]
    _zero_launches(wrappers)
    t0 = time.perf_counter()
    disk = run_prediction(copy.deepcopy(config), datasets=splits)[2]
    torch.cuda.synchronize()
    print(f"{label}: run_prediction restored from disk in {time.perf_counter() - t0:.2f} s",
          flush=True)
    launched.update(_check_launches(f"{label} run_prediction", wrappers, per_step,
                                    len(test_loader), "eval batches"))
    repeat_gate("prediction restored from disk vs test_model in memory",
                relative_gap(disk, mem[0]), relative_gap(mem[1], mem[0]),
                "run_prediction disagrees with the in-memory model")

    # 3. run_server restored from disk against servers of the in-memory
    # weights (twice: the card's spread), N_REQUESTS requests each
    requests = [graphs[i % len(graphs)] for i in range(N_REQUESTS)]

    def memory_server(m):
        return GraphServer(m, test_loader.ladder, ServeConfig.from_config(done),
                           template_graphs=test_loader.graphs, mixed_precision=True,
                           sort_edges=True, device=device, log_name=name)

    t0 = time.perf_counter()
    server = run_server(copy.deepcopy(config), datasets=splits)
    print(f"{label}: run_server restored from disk and started in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    served, served_label, served_launched = serve_requests(server, requests, wrappers,
                                                           per_step)
    launched.update(served_launched)
    mem_served = [serve_requests(memory_server(state.model).start(), requests)[0]
                  for _ in range(2)]
    check(served_label == latest, f"{label}: the server reports {served_label}, not {latest}")
    serve_spread = relative_gap(mem_served[1], mem_served[0])
    repeat_gate(f"{N_REQUESTS} requests served from disk ({served_label}) vs the in-memory "
                "weights", relative_gap(served, mem_served[0]), serve_spread,
                "run_server disagrees with the in-memory model")

    # 4. the walk-back: a byte of the newest payload flipped; the server
    # restores the previous retained epoch, says so, and answers as that
    # epoch's weights do
    check(len(kept) == CKPT_RETENTION, f"{label}: {kept} retained, no previous epoch")
    previous = f"{name}_epoch{kept[-2]}.pt"
    with open(os.path.join(run_dir, latest), "r+b") as fh:
        fh.seek(os.path.getsize(os.path.join(run_dir, latest)) // 2)
        b = fh.read(1)
        fh.seek(-1, os.SEEK_CUR)
        fh.write(bytes([b[0] ^ 0xFF]))
    some = requests[:CKPT_WALKBACK_REQUESTS]
    walked, walked_label, _ = serve_requests(run_server(copy.deepcopy(config), datasets=splits),
                                             some)
    prev_model = create_model(done, device=device, seed=SEED + 2)
    load_inference_entry(InferenceState(prev_model), name, previous)
    prev_answers = serve_requests(memory_server(prev_model).start(), some)[0]
    moved = relative_gap(prev_answers, mem_served[0][:CKPT_WALKBACK_REQUESTS])
    print(f"{label}: {latest} flipped: the server restored {walked_label} (want {previous}); "
          f"that epoch's answers lie {moved:.6g} from the newest's", flush=True)
    check(walked_label == previous, f"{label}: the walk-back restored {walked_label}")
    repeat_gate(f"{CKPT_WALKBACK_REQUESTS} requests served after the walk-back vs {previous} "
                "in memory", relative_gap(walked, prev_answers), serve_spread,
                "the walked-back server does not answer as the previous epoch")
    del prev_model, server
    model.cpu()
    del model, state

    # 5. SIGTERM mid-epoch: a second uninterrupted run (the spread), the
    # stopped run, and its resume, each under ./logs of its own directory
    two = copy.deepcopy(config)
    two["NeuralNetwork"]["Training"].update(num_epoch=2, Checkpoint=False)
    steps = per_epoch[0] + per_epoch[1]
    name_two = get_log_name_config(prepare_data(copy.deepcopy(two), splits)[0])
    losses_b = []
    os.makedirs("uninterrupted")
    with contextlib.chdir("uninterrupted"), ckpt_probes(losses=losses_b):
        run_training(copy.deepcopy(two), datasets=splits, seed=SEED)
    losses_b = torch.stack(losses_b).float().cpu().numpy()
    spread = float(np.max(np.abs(losses_b - losses_a[:steps]) / np.abs(losses_a[:steps])))
    os.makedirs("sigterm")
    with contextlib.chdir("sigterm"):
        log_k, saves_k, losses_k = [], [], []
        with ckpt_probes(log=log_k, kill_at=CKPT_KILL, saves=saves_k, losses=losses_k):
            _, _, hist_k = run_training(copy.deepcopy(two), datasets=splits, seed=SEED)
        stopped = preemption.global_stop_noted()
        ls = load_loader_state(name_two)
        files_k = sorted(os.listdir(os.path.join("logs", name_two)))
        print(f"{label}: SIGTERM as the step of batch {CKPT_KILL[1]} of epoch {CKPT_KILL[0]} "
              f"started: {len(losses_k)} batches stepped ({len(log_k)} handed out to the "
              f"staging), history {hist_k}, loader state "
              f"{ls.to_dict() if ls else None}, saves {saves_k}, on disk {files_k}", flush=True)
        cursor = CKPT_KILL[1] + 1
        check(stopped and len(hist_k["train"]) == 2 and ls is not None
              and ls.to_dict() == {"epoch": 1, "next_batch": cursor, "seed": 0,
                                   "num_batches": per_epoch[1]}
              and "loader_state.json" in files_k and len(saves_k) == 1,
              f"{label}: the SIGTERM stop did not checkpoint with its loader state")
        resumed = copy.deepcopy(two)
        resumed["NeuralNetwork"]["Training"]["continue"] = True
        log_r, losses_r = [], []
        with ckpt_probes(log=log_r, losses=losses_r):
            _, state_r, _ = run_training(resumed, datasets=splits, seed=SEED)
    n_tail = per_epoch[1] - cursor
    want = [e for e in log_a if e[0][0] == 1 and e[0][1] >= cursor]
    replay_ok = log_r[:n_tail] == want
    losses_r = torch.stack(losses_r).float().cpu().numpy()
    start = per_epoch[0] + cursor
    gap = float(np.max(np.abs(losses_r[:n_tail] - losses_a[start:start + n_tail])
                       / np.abs(losses_a[start:start + n_tail])))
    print(f"{label}: resumed: replayed {[p for p, _ in log_r[:n_tail]]} (graph ids "
          f"{'the same, in the same order' if replay_ok else 'DIFFERENT'} as the uninterrupted "
          f"run's), then {len(log_r) - n_tail} batches; losses {losses_r[:n_tail].tolist()} "
          f"against {losses_a[start:start + n_tail].tolist()}; the second uninterrupted run "
          f"lies {spread:.6g} from the first over {steps} steps", flush=True)
    check(replay_ok and int(state_r.step) == start + n_tail + per_epoch[1],
          f"{label}: the resumed run did not replay the rest of epoch {CKPT_KILL[0]}")
    repeat_gate("the resumed steps' losses vs the uninterrupted run's", gap, spread,
                "the resumed steps part from the uninterrupted run")
    del state_r

    # 6. rollback: every batch of epoch 1 poisoned (NaN features), so
    # rollback_after consecutive skips restore epoch 0's checkpoint
    rb = copy.deepcopy(config)
    rb["NeuralNetwork"]["Training"].update(CKPT_ROLLBACK)
    os.makedirs("rollback")
    with contextlib.chdir("rollback"):
        restores, policies = [], []
        with ckpt_probes(poison=(1,), restores=restores, policies=policies):
            _, state_rb, hist_rb = run_training(rb, datasets=splits, seed=SEED)
        check(len(restores) == 1, f"{label}: {len(restores)} restores, expected 1")
        entry, restore_rb_s, got = restores[0]
        want_payload = torch.load(os.path.join("logs", name, entry), weights_only=True)
    bad = payload_mismatches(got, want_payload)
    backoff = CKPT_ROLLBACK["non_finite_lr_backoff"]
    print(f"{label}: rollback: epoch 1's {per_epoch[1]} batches poisoned; restored {entry} in "
          f"{restore_rb_s:.3f} s, {len(bad)} tensors or values differ from the file {bad[:5]}; "
          f"rollbacks_done {policies[0].rollbacks_done}; LR {hist_rb['lr']} (checkpoint "
          f"{want_payload['lr']} x {backoff}); history {hist_rb}", flush=True)
    check(not bad and policies[0].rollbacks_done == 1
          and math.isclose(hist_rb["lr"][1], want_payload["lr"] * backoff, rel_tol=1e-12)
          and all(math.isfinite(v) for v in hist_rb["val"]),
          f"{label}: the rollback did not restore the checkpoint and back the LR off")
    del state_rb
    print(f"{label}: save seconds {[round(s, 3) for _, s, _ in saves]} for "
          f"{saves[-1][2]} bytes each; restore {restore_s:.3f} s (round trip), "
          f"{restore_rb_s:.3f} s (rollback)", flush=True)
    return launched


# ---------------------------------------------------------------------------
# the message-passing zoo: the JAX bench's PNA-family cell (pnaplus,
# pnaplus_train), the other convs at its widths (zoo), and the MD17
# energy-force recipe (schnet_md17)

# the zoo phase's convs, each at the PNA-family cell's widths and data
ZOO_CELL = ("PNAEq", "PAINN", "SAGE", "GAT", "MFC", "CGCNN")
# kernel launches of one served batch or one train step (bf16 mixed
# precision: conv layer 0 in bf16; wherever an f32 operand (the degree
# scalers' counts, PAINN's f32 zero vectors, a mean's f32 counts) promotes
# a layer's output, the later layers run in f32). PNAPlus's first layer
# aggregates at the input width (4: the atomic number and the position);
# GAT sums its six heads of 256 flattened (C = 1,536) in every layer; CGCNN
# keeps the input width throughout
PNAPLUS_PER_UNIT = {"K3": {"bfloat16/C4/gate": 1, "float32/C256/gate": 3}}
ZOO_PER_UNIT = {
    "PNAEq": {"K3": {"bfloat16/C256/edge_in only": 1, "float32/C256/edge_in only": 3}},
    "PAINN": {"K1": {"bfloat16/C256": 1, "float32/C256": 3}},
    "SAGE": {"K1": {"bfloat16/C4": 1, "float32/C256": 3}},
    "GAT": {"K1": {"bfloat16/C1536": 4}},
    "MFC": {"K1": {"bfloat16/C4": 1, "bfloat16/C256": 3}},
    "CGCNN": {"K1": {"bfloat16/C4": 4}},
    # GIN's four sums under GPS performer attention, all bf16 (the
    # attention's per-graph moments are plain segment sums)
    "performer": {"K1": {"bfloat16/C256": 4}},
}
# schnet_md17: one energy-force step or eval batch (f32): K1 once per
# SchNet layer at its 126 filters
MD17_PER_UNIT = {"K1": {"float32/C126": 3}}
# the MD17 recipe (examples/md17/md17.json, BASELINE.md): 512 samples,
# 100 epochs, gated on tests/test_examples.py's full-tier bounds
# (:117-122): force MAE under 0.8x the zero predictor's, force correlation
# above 0.5, energy MAE under 0.7x the test-mean predictor's. The outcome
# of its 1,200 steps hangs on roundings: at seed 0 on an H100 (NVIDIA H100
# 80GB HBM3, 700 W) the force ratio read 0.560 to 0.772 over six runs
# through K1 with PyTorch's default (atomic) index_add_, 0.788 once through
# K1's plain version, and 0.6035 in both runs through K1 with
# deterministic algorithms (0.720 through the plain version so), bit for
# bit the same losses. So the phase trains and predicts with deterministic
# algorithms; ``--md17 ROUTE`` runs the recipe alone through each route
MD17_SAMPLES = 512
MD17_EPOCHS = 100
MD17_GATES = {"force MAE / zero predictor": 0.8, "force correlation": 0.5,
              "energy MAE / test-mean predictor": 0.7}
PNAPLUS_TRAIN_GRAPHS = 384
# limits of the new phases, each against the same weights through the
# kernels' plain versions (the same function, the sums in another order),
# at about three times the readings of this script on an H100 (NVIDIA
# H100 80GB HBM3, 700 W) at seed 0: served answers per head and row
# relative to the head's largest, (largest row, median row); step-0
# gradients per parameter (largest, median), floored as GRAD_FLOOR; loss
# trajectories per step relative; the energy-force step's loss, forces
# per atom and gradients. Readings, first run: pnaplus_train f32
# gradients (8.4e-3, 3.1e-5) beside the plain route again (9.4e-3,
# 3.0e-5), bf16 (7.4e-3, 1.5e-3) beside (7.4e-3, 1.7e-3), trajectory
# 1.9e-2 at step 20 (median 1.0e-3); the zoo's served answers: PNAEq
# energy (2.5e-2, 2.7e-3) and forces (0.43, 3.4e-6), PAINN (1.1e-2,
# 2.1e-6) and (0.14, 5.5e-7), SAGE (4.6e-7, 1.9e-7) and (6.5e-7,
# 1.9e-7), GAT (6.3e-3, 1.5e-3) and (1.3e-2, 3.3e-3), MFC and CGCNN 0;
# two bf16 steps' losses: PAINN 2.7e-3, GAT 5.8e-4, PNAEq 4.4e-4, SAGE
# 1.4e-6, MFC and CGCNN 0; schnet_md17's step: loss 2.2e-7, forces
# (4.5e-6, 4.6e-7), gradients (7.7e-6, 1.2e-6) beside the plain route
# again (4.5e-6, 3.5e-7). PAINN's and PNAEq's update blocks reach their
# +-1e6 clamp from conv layer 1 or 2 on with random weights at this width,
# so one rounding can flip a row's saturation: their largest rows are
# loose, their medians tight. The zoo gates the f32 step-0 gradients of
# SAGE, GAT, MFC and CGCNN against the plain route, PAINN's and PNAEq's as
# ZOO_CARRIED says, and every conv's two bf16 steps by their losses
# (PAINN's 2.7e-3 in every run). Second run: pnaplus_train
# f32 gradients (1.4e-2, 9.9e-4), the plain route again the same;
# trajectory 3.1e-2 at step 20; PNAEq's served energy (1.7e-2, 6.4e-3).
PNAPLUS_TRAIN_RTOL = {"f32 gradients": (0.05, 3e-3), "bf16 gradients": (0.03, 5e-3),
                      "trajectory": 0.1}
ZOO_RTOL = {
    "PNAEq": {"served": {"energy": (0.1, 2e-2), "forces": (1.0, 1e-5)}},
    "PAINN": {"served": {"energy": (0.05, 1e-5), "forces": (0.5, 2e-6)}},
    "SAGE": {"served": {"energy": (2e-6, 1e-6), "forces": (2e-6, 1e-6)}},
    "GAT": {"served": {"energy": (0.02, 5e-3), "forces": (0.04, 1e-2)}},
    "MFC": {"served": {"energy": (1e-3, 1e-5), "forces": (1e-3, 1e-5)}},
    "CGCNN": {"served": {"energy": (1e-3, 1e-5), "forces": (1e-3, 1e-5)}},
    # GIN under performer attention: the served answers equal the plain
    # versions' bit for bit (five runs); the f32 step-0 gradients read
    # (0.021 to 0.034, 6.5e-4 to 2.6e-3), the plain route again (0.020 to
    # 0.034, 1.6e-4 to 1.8e-3), at the last layers' projections, where the
    # relu feature map's zero crossings carry the summation order's rounding
    "performer": {"served": {"energy": (1e-3, 1e-5), "forces": (1e-3, 1e-5)},
                  "gradients": (0.1, 8e-3)},
}
# cells whose served leg (the server's warm-up captures, its answers and the
# plain versions' reference) runs under deterministic algorithms: the
# performer's per-graph sums (kv_sum, k_sum) are index_add_ in f32, cast to
# bf16, whose order atomics change from call to call (50 calls at the served
# shapes gave 50 distinct sums); the served answers left the reference in 1
# of 64 passes on two commits, by one row at 3.7e-3 / 1.7e-2, and in 0 of 16
# under deterministic algorithms, where the sum gives one result
# (run-scripts/torch_performer_repeat.py on an H100 80GB HBM3, 700 W)
ZOO_DETERMINISTIC_SERVED = ("performer",)
# f32 step-0 gradients: (largest, median), but for the convs whose update
# blocks saturate at random init (below)
ZOO_GRAD_RTOL = (0.05, 5e-3)
# PAINN's and PNAEq's f32 step-0 gradients at this cell hang on roundings.
# Their update blocks saturate the +-1e6 clamp from conv layer 1 or 2 on,
# and a flip of one clamp decision can move the whole step (PAINN read 898
# from the plain route in one run of this script on an H100, 0.029 in the
# next, as far as the plain route again); PNAEq's std aggregator takes
# E[x^2] - E[x]^2 of large messages, so every f32 route lies ~1 (median
# parameter) from the same step in f64, the plain route too. The zoo
# prints those readings, each route's flipped clamp decisions and its
# distance from f64, and gates what the kernel decides: its values on the
# step against f64 sums (no further than ZOO_VALUES_FACTOR times its plain
# version's; K1's read 5.8e-8 to 6.8e-8 against 1.2e-7 to 1.5e-7, K3's
# 2.2e-7 to 3.7e-7 against 6.5e-6 to 1.2e-5) and, with deterministic
# algorithms (one forward, no atomics), the kernel route's gradients
# against the plain route carrying the kernel's values: 0 for both, as the
# kernel route again
ZOO_CARRIED = {"PAINN": "K1", "PNAEq": "K3"}
ZOO_CARRIED_RTOL = (1e-5, 1e-6)
ZOO_VALUES_FACTOR = 2.0
ZOO_LOSS_RTOL = 0.01  # the two bf16 steps' losses, every conv
MD17_RTOL = {"loss": 4e-6, "forces": (2e-5, 2e-6), "gradients": (5e-5, 1e-5)}


def pna_cell_config(mpnn_type: str = "PNAPlus", batch_size: int = 16, hidden: int = 256,
                    head: int = 256, layers: int = 4):
    """The JAX package's PNA-family bench cell (bench.py
    ``_pna_cell_workload("PNAPlus_fused")``): hidden 256, 4 conv layers,
    radius 5, 20 neighbours, sorted aggregation and the fused flag, graph
    head [256, 256] over a shared 2 x 50 and node head [256, 256], task
    weights [1, 100], batch 16 not packed, bf16 mixed precision, the bench's
    Training block (AdamW lr 1e-3, MAE); PNAPlus with 5 radial functions
    and envelope exponent 5. The zoo phase puts each of its convs at the
    same widths."""
    config = serving_config(batch_size=batch_size, hidden=hidden, head=head)
    arch = config["NeuralNetwork"]["Architecture"]
    arch.update(
        mpnn_type=mpnn_type, num_conv_layers=layers, equivariance=False,
        use_fused_edge_kernel=True,
        output_heads={
            "graph": {"num_sharedlayers": 2, "dim_sharedlayers": 50,
                      "num_headlayers": 2, "dim_headlayers": [head, head]},
            "node": {"num_headlayers": 2, "dim_headlayers": [head, head], "type": "mlp"},
        },
    )
    if mpnn_type == "PNAPlus":
        arch.update(num_radial=5, envelope_exponent=5)
    config["NeuralNetwork"]["Training"]["pack_batches"] = False
    return config


def model_cell_config(mpnn_type: str):
    """The JAX package's MACE and DimeNet bench cells (bench.py
    ``_model_cell_workload``) with sorted aggregation on (its
    ``BENCH_CELL_SORTED=1``, the ``mace_sorted`` cell): 2 conv layers, radius
    5, 20 neighbours, graph head [256, 256] over a shared 2 x 50, node head
    [256, 256], task weights [1, 100], batch 16 not packed, bf16 mixed
    precision, the bench's Training block (AdamW lr 1e-3, MAE). MACE: hidden
    256, 8 Bessel radial functions, max_ell and node_max_ell 2, correlation
    3, envelope exponent 5. DimeNet: hidden 128, 6 radial and 7 spherical
    functions, basis 8, interaction 64, output 256, 1 residual before the
    skip and 2 after, envelope exponent 5."""
    per_model = {
        "MACE": dict(hidden_dim=256, num_radial=8, max_ell=2, node_max_ell=2, correlation=3,
                     radial_type="bessel", envelope_exponent=5),
        "DimeNet": dict(hidden_dim=128, num_radial=6, num_spherical=7, basis_emb_size=8,
                        int_emb_size=64, out_emb_size=256, num_before_skip=1,
                        num_after_skip=2, envelope_exponent=5),
    }
    config = pna_cell_config(mpnn_type, layers=2)
    config["NeuralNetwork"]["Architecture"].update(per_model[mpnn_type])
    return config


def performer_cell_config():
    """The JAX package's GPS performer bench cell (bench.py
    ``_gps_cell_workload("performer")``): GIN hidden 256, 4 conv layers, GPS
    performer attention with 8 heads, PE 4, dropout 0, graph head [256,
    256] over a shared 2 x 50, node head [256, 256], batch 16, bf16 mixed
    precision, with sorted aggregation on (so GIN's sums take K1)."""
    config = pna_cell_config("GIN")
    config["NeuralNetwork"]["Architecture"].update(
        global_attn_engine="GPS", global_attn_type="performer", global_attn_heads=8, pe_dim=4,
        dropout=0.0)
    return config


def md17_config(num_epoch: int = 100):
    """The committed MD17 recipe (examples/md17/md17.json: SchNet hidden 64,
    3 conv layers, radius 5, 32 neighbours, one node head of nodal energy,
    ``compute_grad_energy``, MAE, AdamW lr 2e-3, batch 32, perc_train 0.7,
    100 epochs) over explicit datasets: the example's columnar shard is
    left out."""
    config = json.loads((REPO / "examples" / "md17" / "md17.json").read_text())
    config["Verbosity"] = {"level": 0}
    config["Dataset"] = {"name": "md17_shaped",
                         "node_features": {"name": ["atomic_number"], "dim": [1]}}
    config["NeuralNetwork"]["Training"]["num_epoch"] = num_epoch
    return config


def _k1_case(ids, edge_mask, n, c, dtype, gen, seed, prefix: str = ""):
    """K1 on ``ids`` at width ``c``: messages from ``gen``, zero on padding
    edges (``segment_sum`` masks them before K1); against its fixed-order
    plain version, ``index_add`` as the library call, first- and
    second-order gradients against ``index_add_``'s autograd."""
    import torch

    from hydragnn_tpu_torch.ops.sorted_segment import (
        segment_sum_plain,
        sorted_segment_sum,
        sorted_segment_sum_plain,
    )

    dev, e = ids.device, ids.shape[0]
    dname = str(dtype)[6:]
    size = torch.tensor([], dtype=dtype).element_size()
    msg = torch.randn(e, c, generator=gen, device=dev)
    kw = dict(messages=torch.where(edge_mask[:, None], msg, torch.zeros((), device=dev)).to(dtype),
              segment_ids=ids, num_segments=n)
    base = torch.zeros(n, c, dtype=dtype, device=dev)
    return _case(
        "K1", dtype, f"{prefix}sorted_segment_sum ({dname}, C={c})", f"{prefix}{dname}/C{c}",
        lambda: sorted_segment_sum(**kw),
        lambda: sorted_segment_sum_plain(**kw),
        lambda: base.index_add(0, ids, kw["messages"]),
        (e * c + n * c) * size + e * 4,
        e * c / PEAK_FLOPS["float32"] * 1e3,  # one f32 add per element
        50, dict(E=e, N=n, C=c),
        backward=lambda: backward_call(sorted_segment_sum, kw, ("messages",)),
        gradients=(lambda m: sorted_segment_sum(m, ids, n),
                   ("index_add_'s autograd", lambda m: segment_sum_plain(m, ids, n)),
                   [kw["messages"]], seed),
    )


def _k3_case(ids, node_mask, n, c, dtype, gen, with_recv_and_gate: bool, seed):
    """K3 on ``ids`` at width ``c``: PNAPlus's variant (``node_recv`` and a
    gate) or PNAEq's (``edge_in`` alone); against ``reference_multi_agg``
    (count, min and max exactly), with its gradients on the real rows."""
    import torch

    from hydragnn_tpu_torch.ops.multi_agg import fused_multi_agg, reference_multi_agg

    dev, e = ids.device, ids.shape[0]
    dname = str(dtype)[6:]
    size = torch.tensor([], dtype=dtype).element_size()

    def rand(rows):
        return torch.randn(rows, c, generator=gen, device=dev).to(dtype)

    kw = dict(node_recv=rand(n) if with_recv_and_gate else None, edge_in=rand(e),
              gate=rand(e) if with_recv_and_gate else None, segment_ids=ids, num_segments=n)
    names = ("node_recv", "edge_in", "gate") if with_recv_and_gate else ("edge_in",)
    variant = "gate" if with_recv_and_gate else "edge_in only"

    def on_rows(fn):
        def call(*xs):
            args = dict(kw, **dict(zip(names, xs)))
            return tuple(m[node_mask] for m in fn(**args))

        return call

    operands = (n * c + 2 * e * c) if with_recv_and_gate else e * c
    return _case(
        "K3", dtype, f"fused_multi_agg ({dname}, C={c}, {variant})", f"{dname}/C{c}/{variant}",
        lambda: fused_multi_agg(**kw),
        lambda: reference_multi_agg(**kw),
        None,  # no one PyTorch call computes the five moments
        operands * size + e * 8 + (4 * n * c + n) * 4,
        # (add, multiply,) square, sum, sumsq, min, max per message element
        (6 if with_recv_and_gate else 5) * e * c / PEAK_FLOPS["float32"] * 1e3,
        50, dict(E=e, N=n, C=c),
        check_exact=(1, 2, 3),  # count, min, max
        backward=lambda: backward_call(fused_multi_agg, kw, names),
        gradients=(on_rows(fused_multi_agg),
                   ("reference_multi_agg's autograd", on_rows(reference_multi_agg)),
                   [kw[k] for k in names], seed),
    )


def zoo_kernel_cases(batch, md17_batch, device):
    """K1 and K3 at the zoo's, the model cells' and the MD17 recipe's
    shapes, inputs from a seed: the PNA-family cell's batch of 16
    OC20-shaped graphs (the DimeNet and MACE cells batch the same graphs)
    for K1 at C = 4 (SAGE's, MFC's and CGCNN's input width), 256 (GIN's
    under the performer too), 1,536 (GAT's six heads) and 2,304 (MACE's 256
    channels x 9 irrep components) in bf16, at C = 4 and 128 (DimeNet's) and
    2,304 in f32, and for K3's two variants (PNAPlus's at C = 4 in bf16 and
    256 in f32, PNAEq's at 256 in both); the MD17 batch of 32 molecules for
    K1 at SchNet's 126 filters in f32."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    ids = batch.receivers.to(device)
    edge_mask = batch.edge_mask.to(device)
    node_mask = batch.node_mask.to(device)
    n = batch.num_nodes
    cases = [_k1_case(ids, edge_mask, n, c, torch.bfloat16, gen, 7 + c)
             for c in (4, 256, 1536, 2304)]
    # DimeNet's output-block sums (f32: its spherical basis is f32) at its
    # layer-0 width (4, the input's) and its hidden width; MACE's in f32
    # (gradients, energy-force)
    cases += [_k1_case(ids, edge_mask, n, c, torch.float32, gen, 11 + c) for c in (4, 128, 2304)]
    cases.append(_k1_case(md17_batch.receivers.to(device), md17_batch.edge_mask.to(device),
                          md17_batch.num_nodes, 126, torch.float32, gen, 8))
    for dtype, c, full in ((torch.bfloat16, 4, True), (torch.float32, 256, True),
                           (torch.bfloat16, 256, False), (torch.float32, 256, False)):
        cases.append(_k3_case(ids, node_mask, n, c, dtype, gen, full, 9 + c))
    return cases


def head_dims(arch) -> str:
    """The graph and node heads' widths (the first branch's, in the
    multibranch list form), and the node head's type."""
    heads = {k: (v[0]["architecture"] if isinstance(v, list) else v)
             for k, v in arch["output_heads"].items()}
    branches = max((len(v) for v in arch["output_heads"].values() if isinstance(v, list)),
                   default=1)
    return " / ".join(f"{k} {h['dim_headlayers']}" + (f" ({h.get('type', 'mlp')})"
                                                      if k == "node" else "")
                      for k, h in heads.items()) + (f", {branches} branches" if branches > 1
                                                     else "")


def run_cell_train(label, config, graphs, device, per_step, swap, rtol, groups, epochs=1,
                   splits=None, min_steps=20, pinned_grads=False):
    """A cell's model trained at full width through its kernels with
    gradients (``make_train_step``, bf16 mixed precision), against the same
    steps through the plain versions of ``swap``: one step's gradients in
    f32 and in bf16 beside controls (the plain route again, each kernel
    alone), the loss trajectories over ``epochs`` epochs, launches per
    step, ms per step, peak memory, one profiled step (its device time
    summed by ``groups``), one ``api.run_training`` of ``epochs`` epochs
    (the config's ``num_epoch``). ``pinned_grads`` gates the step-0
    gradients against K1's plain version with every activation's decisions
    held to that route's (``pinned_route_gradients``), and prints the
    unpinned kernels' reading beside (without the controls, which only an
    unpinned gate reads: cut for time, PERF.md §4). Returns the launches by
    (kernel, case) of the kernel route's trajectory and the run."""
    import torch

    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.data import split_dataset
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train import make_train_step

    splits = splits or split_dataset(graphs, 0.9, seed=0)
    done, (loader, _, _), _ = prepare_data(copy.deepcopy(config), splits)
    arch, training = done["NeuralNetwork"]["Architecture"], done["NeuralNetwork"]["Training"]
    batches = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        batches += list(loader)
    steps = len(batches)
    check(steps >= min_steps, f"{label}: {steps} batches, fewer than {min_steps} steps")
    attn = (f", GPS {arch['global_attn_type']} x{arch['global_attn_heads']} heads, PE "
            f"{arch['pe_dim']}" if arch.get("global_attn_engine") else "")
    print(f"{label}: {arch['mpnn_type']} hidden {arch['hidden_dim']}, {arch['num_conv_layers']} "
          f"conv layers{attn}, heads {head_dims(arch)}, task weights "
          f"{arch['task_weights']}, AdamW lr 1e-3, {training['loss_function_type']}, batch "
          f"{training['batch_size']} (not packed, node bound {arch['max_nodes_per_graph']}), "
          f"bf16 mixed precision, guard on, sorted aggregation "
          f"{arch['use_sorted_aggregation']}, multi-moment {arch['use_fused_edge_kernel']}, "
          f"flash {arch['use_flash_attention']}; {len(splits[0])} training graphs, {steps} "
          f"steps, random weights (seed {SEED})", flush=True)
    check(arch["use_sorted_aggregation"] and arch["use_fused_edge_kernel"]
          and (arch["use_flash_attention"] or not arch.get("global_attn_engine")),
          f"{label}: config completion did not turn the kernels on")
    model = create_model(done, device=device, seed=SEED)

    # one step's gradients through the kernels against their plain
    # versions, from the same weights on the same batch, in f32 and in
    # bf16, beside the plain route again and each kernel alone; every
    # parameter the loss reaches has a finite, nonzero gradient
    routes = {"kernels": ((), None), "plain": (swap, None)}
    if not pinned_grads:  # the controls of the unpinned gate
        routes["the plain route again"] = (swap, None)
        if len(swap) > 1:
            routes.update({f"{k}'s kernel, the rest plain": (tuple(s for s in swap if s != k),
                                                              None) for k in swap})
    for mp in (False, True):
        dname = "bf16" if mp else "f32"
        if pinned_grads:
            pinned_route_gradients(label, model, batches[0], device, mp,
                                   rtol[f"{dname} gradients"])
        grads = route_gradients(model, batches[0], device, routes, lambda st, mp=mp: (
            lambda b: make_train_step(st.model, mixed_precision=mp)(st, b)))
        torch.cuda.synchronize()
        gradients_present(f"{label}: {dname} step 0", grads["kernels"], grads["plain"])
        controls = {r: g for r, g in grads.items() if r not in ("kernels", "plain")}
        if pinned_grads:  # unpinned, printed: the pinned gate above is the gate
            print(f"{label}: {dname} gradients vs plain route, unpinned: largest, its "
                  f"parameter, median " + "; ".join(
                      "{}: {:.6g} ({}), {:.6g}".format(r, *grad_reading(g, grads["plain"])[:3])
                      for r, g in {"kernels": grads["kernels"], **controls}.items()),
                  flush=True)
        else:
            grad_gate(f"{dname} gradients vs plain route", grads["kernels"], grads["plain"],
                      rtol[f"{dname} gradients"], controls, cell=label)
        del grads

    # the trajectories, through the kernels (the main path) and through the
    # plain versions, from one init
    lk, lp, wall, launched, peak, kernel_state, _ = trajectories(
        label, model, batches, device,
        lambda st: (lambda b: make_train_step(st.model, mixed_precision=True)(st, b)),
        swap, per_step)
    skipped = int(kernel_state.skipped_steps)
    trajectory_gate(label, lk, lp, rtol["trajectory"], f"; guard skips {skipped}")
    check(skipped == 0, f"{label}: the guard skipped {skipped} steps")
    real = sum(int(b.graph_mask.sum()) for b in batches[3:])
    ms = wall * 1e3 / (steps - 3)
    print(f"{label}: {ms:.2f} ms per step, {real / wall:.1f} graphs/s trained (steps 4-{steps}, "
          f"{real} real graphs); peak memory {peak / 2**20:.1f} MiB", flush=True)
    step = make_train_step(kernel_state.model, mixed_precision=True)
    profile_forward(label, f"one train step of {int(batches[0].graph_mask.sum())} graphs "
                           "(forward, backward, guard and AdamW)",
                    lambda: step(kernel_state, batches[0]), noun="step", groups=groups)
    del kernel_state, step
    rt_launched = run_training_epoch(label, config, splits, per_step, epochs)
    merged = collections.Counter(launched)
    merged.update(rt_launched)
    return merged


def _rows_gate(label, what, got, want, limits):
    """Per output row ``max|got - want|`` over the largest ``|want|`` of the
    head, for each head of ``want`` (dicts of host arrays, real rows
    only): (largest, median) against ``limits[head]``."""
    import numpy as np

    readings = {}
    for k, w in want.items():
        err = np.abs(got[k] - w).reshape(w.shape[0], -1).max(axis=1)
        rel = err / max(float(np.abs(w).max()), 1e-12)
        readings[k] = (float(rel.max()), float(np.median(rel)))
    print(f"{label}: {what}: relative (largest, median) row {readings} (limits {limits})",
          flush=True)
    check(all(np.isfinite(got[k]).all() for k in want), f"{label}: non-finite {what}")
    check(all(a <= limits[k][0] and m <= limits[k][1] for k, (a, m) in readings.items()),
          f"{label}: {what} disagree")


def clamp_flips(clamps, reference):
    """Per call of the update block's clamp, how many elements ``clamps``
    (one route's decisions, ``pinned_clamps``) saturate where
    ``reference`` does not or the other way round."""
    return [int(((h != rh) | (lo != rlo)).sum()) for (h, lo), (rh, rlo) in zip(clamps, reference)]


def zoo_carried_gate(label, kernel, model, batch, grads, clamps) -> None:
    """The f32 step-0 gradients of a conv whose update block saturates its
    +-1e6 clamp at this cell (``ZOO_CARRIED``: PAINN through K1, PNAEq
    through K3), where a rounding can flip one clamp decision and move the
    whole step (PERF.md, Findings). Printed: each route of ``grads``
    against the plain route, with how many clamp decisions (``clamps``,
    route -> decisions) it flips against the plain route's; the kernel
    route held to the plain route's clamp decisions; every route against
    the same step in f64. Gated: ``kernel``'s values on this step against
    f64 sums, no further than ``ZOO_VALUES_FACTOR`` times its plain
    version's (K3's count, min and max equal to its plain version's); and,
    with PyTorch's deterministic algorithms, the kernel route's gradients
    against the plain route's carrying the kernel's values (the same
    forward, the plain version's backward), within ``ZOO_CARRIED_RTOL``."""
    import torch

    from hydragnn_tpu_torch.train import compute_loss

    def grads_of(m, b, *contexts):
        m = copy.deepcopy(m).train()
        with contextlib.ExitStack() as stack:
            for c in contexts:
                stack.enter_context(c)
            tot, _, _ = compute_loss(m, b, m.cfg, False)
            tot.backward()
        return {n: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                for n, p in m.named_parameters()}

    batch = batch.to(next(model.parameters()).device)
    plain = clamps["plain"]
    flips = {r: clamp_flips(c, plain) for r, c in clamps.items() if r != "plain"}
    grads = dict(grads)
    route = "the kernels held to the plain route's clamp decisions"
    flips[route] = []
    grads[route] = grads_of(model, batch, pinned_clamps(plain, flips[route]))
    b64 = batch.replace(**{f: getattr(batch, f).double() for f in ("x", "pos", "edge_attr",
                                                                    "edge_shifts")
                           if getattr(batch, f) is not None})
    c64 = []
    g64 = grads_of(copy.deepcopy(model).double(), b64, f64_sums(), pinned_clamps(c64))
    flips["f64"] = clamp_flips(c64, plain)
    print(f"{label}: update-block clamp: {len(plain)} calls, saturated on the plain route "
          f"{[int(h.sum() + lo.sum()) for h, lo in plain]} of {plain[0][0].numel()} elements "
          "each; decisions flipped against the plain route's per call: " + "; ".join(
              f"{r} {f}" for r, f in flips.items()), flush=True)
    print(f"{label}: f32 step-0 gradients, per-parameter (largest, its parameter, median) "
          f"against the plain route (printed: the gate is below): " + "; ".join(
              "{} ({:.6g}, {}, {:.6g})".format(r, *grad_reading(g, grads["plain"])[:3])
              for r, g in grads.items() if r != "plain"), flush=True)
    print(f"{label}: the same against the step in f64 (weights, inputs, sums and moments): "
          + "; ".join("{} ({:.6g}, {}, {:.6g})".format(r, *grad_reading(g, g64)[:3])
                      for r, g in grads.items()), flush=True)
    del g64, b64, c64

    caught = []
    with deterministic(caught):
        gk = grads_of(model, batch)
        gc = grads_of(model, batch, carried_values(kernel))
        again = grads_of(model, batch)
    largest, worst, median, _ = grad_reading(gk, gc)
    print(f"{label}: deterministic algorithms: the kernel route against the plain route "
          f"carrying {kernel}'s values: largest {largest:.6g} ({worst}), median {median:.6g} "
          f"(limits {ZOO_CARRIED_RTOL}); the kernel route again: largest "
          "{:.6g}, median {:.6g}; warnings {}".format(*grad_reading(again, gk)[::2], caught),
          flush=True)
    check(largest <= ZOO_CARRIED_RTOL[0] and median <= ZOO_CARRIED_RTOL[1],
          f"{label}: the kernel route's gradients disagree with the plain route's carrying "
          f"{kernel}'s values")
    readings = []
    with torch.no_grad(), (k1_against_f64 if kernel == "K1" else k3_against_f64)(readings):
        compute_loss(copy.deepcopy(model).train(), batch, model.cfg, False)
    for i, (case, errs, *exact) in enumerate(readings):
        print(f"{label}: {kernel} call {i} ({case}) against f64, (largest, rms) relative: "
              + ", ".join(f"{k} ({a:.3g}, {r:.3g})" for k, (a, r) in errs.items())
              + (f"; count, min, max as the plain version's bit for bit: {exact[0]}"
                 if exact else ""), flush=True)
        pairs = ([("kernel", "fixed order")] if kernel == "K1" else
                 [(f"kernel {m}", f"plain version {m}") for m in ("sum", "sumsq")])
        check(all(k <= ZOO_VALUES_FACTOR * p for a, b in pairs
                  for k, p in zip(errs[a], errs[b])) and all(exact),
              f"{label}: {kernel}'s values in call {i} lie further from f64 than "
              f"{ZOO_VALUES_FACTOR}x its plain version's")


def run_zoo(cells, device, per_unit):
    """Each cell of ``cells`` (name -> (config, graphs): each conv of
    ``ZOO_CELL`` at the PNA-family cell's widths and data, hidden 256, 4
    conv layers, batch 16, bf16 mixed precision, sorted, fused where the
    conv has a fused route; and the GPS performer cell): one batch of 16
    requests served through ``api.run_server`` against the same bf16 cast
    through the kernels' plain versions, then two train steps through the
    kernels against the same steps through the plain versions (step-0
    gradients, both losses); launches per served batch and per step; one
    profiled step. Returns the launches by (kernel, case)."""
    import numpy as np
    import torch

    from hydragnn_tpu_torch.api import prepare_data, run_server
    from hydragnn_tpu_torch.data.graph import batch_graphs
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.ops.sorted_segment import segment_sum_plain
    from hydragnn_tpu_torch.train import make_train_step
    from hydragnn_tpu_torch.train.loop import cast_batch_bf16, mp_cast_model

    wrappers = _wrappers()
    launched = collections.Counter()
    for name, (config, graphs) in cells.items():
        label = f"zoo {name}"
        splits = split_dataset(graphs, 0.9, seed=0)
        requests = graphs[:16]
        done, (loader, _, _), _ = prepare_data(copy.deepcopy(config), splits)
        arch = done["NeuralNetwork"]["Architecture"]
        check(arch["use_sorted_aggregation"], f"{label}: sorted aggregation is off")
        exact = contextlib.ExitStack()
        if name in ZOO_DETERMINISTIC_SERVED:
            exact.enter_context(deterministic())
        t0 = time.perf_counter()
        server = run_server(config, datasets=splits, device=device, seed=SEED)
        check(server.wait_ready(timeout=600), f"{label}: server warm-up failed: {server.failed}")
        ready_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in server.model.parameters())
        batches0 = server.stats()["batches"]
        _zero_launches(wrappers)
        t0 = time.perf_counter()
        handles = [server.submit(g) for g in requests]
        results = [h.result(timeout=600) for h in handles]
        torch.cuda.synchronize()
        serve_ms = (time.perf_counter() - t0) * 1e3
        served = server.stats()["batches"] - batches0
        launched.update(_check_launches(f"{label} served", wrappers, per_unit[name], served,
                                        "batches"))
        attn = (f", GPS {arch['global_attn_type']} x{arch['global_attn_heads']} heads"
                if arch.get("global_attn_engine") else "")
        print(f"{label}: {arch['mpnn_type']} hidden {arch['hidden_dim']}, "
              f"{arch['num_conv_layers']} conv layers{attn}, {n_params} parameters, fused "
              f"{arch['use_fused_edge_kernel']}; server "
              f"ready in {ready_s:.2f} s; {len(requests)} requests in {served} batches, "
              f"{serve_ms:.2f} ms", flush=True)
        check(all(isinstance(r, dict) and set(r) == {"energy", "forces"} for r in results),
              f"{label}: served {results[:1]}")
        # the same bf16 cast through the kernels' plain versions, on the
        # server's own micro-batches (how the admission window splits the
        # requests varies run to run, and another composition pads to
        # another ladder level, whose GEMM shapes round otherwise in bf16)
        served_batches = {}
        for i, h in enumerate(handles):
            served_batches.setdefault(h.batch_index, []).append(i)
        order = [i for idx in served_batches.values() for i in idx]
        want = {"energy": [], "forces": []}
        ref_model = mp_cast_model(server.model)
        for idx in served_batches.values():
            gs = [requests[i] for i in idx]
            batch = batch_graphs(gs, server.ladder.select_for(gs),
                                 sort_edges=server.sort_edges).to(device)
            with torch.inference_mode(), plain_versions(PLAIN):
                ref = ref_model(cast_batch_bf16(batch))
            want["energy"].append(ref["energy"].float().cpu().numpy()[:len(gs)])
            want["forces"].append(ref["forces"].float().cpu().numpy()[
                np.flatnonzero(batch.node_mask.cpu().numpy())])
        got = {"energy": np.concatenate([results[i]["energy"] for i in order]).reshape(-1, 1),
               "forces": np.concatenate([results[i]["forces"] for i in order])}
        _rows_gate(label, f"served answers vs the same bf16 cast, plain versions, on the "
                          f"server's {len(served_batches)} micro-batches", got,
                   {k: np.concatenate(v).reshape(got[k].shape) for k, v in want.items()},
                   ZOO_RTOL[name]["served"])
        model = server.model
        server.close()
        exact.close()

        loader.set_epoch(0)
        steps = [b for _, b in zip(range(2), loader)]
        # step-0 gradients in f32 from the served weights, through the
        # kernels against the plain versions, beside the plain route again
        # and the plain route with K1 summing in index_add_'s order; each
        # route's clamp decisions in PAINN's and PNAEq's update blocks
        routes = {"kernels": ((), None), "plain": (PLAIN, None),
                  "the plain route again": (PLAIN, None),
                  "the plain route with K1 in index_add_'s order": (PLAIN, segment_sum_plain)}
        clamps = []

        def recording_step(state):
            def run(b):
                clamps.append([])
                with pinned_clamps(clamps[-1]):
                    return make_train_step(state.model)(state, b)
            return run

        grads = route_gradients(model, steps[0], device, routes, recording_step)
        gradients_present(f"{label}: f32 step 0", grads["kernels"], grads["plain"])
        if name in ZOO_CARRIED:
            zoo_carried_gate(label, ZOO_CARRIED[name], model, steps[0], grads,
                             dict(zip(routes, clamps)))
        else:
            grad_gate("f32 step-0 gradients vs plain route", grads["kernels"], grads["plain"],
                      ZOO_RTOL[name].get("gradients", ZOO_GRAD_RTOL),
                      {r: g for r, g in grads.items() if r not in ("kernels", "plain")},
                      cell=label)
        del grads, clamps
        # two bf16 train steps through the kernels (the main path) and
        # through the plain versions, from the served weights: the losses
        res = {}
        for route, swap in (("kernels", ()), ("plain", PLAIN)):
            state = _train_copy(model, device)
            step = make_train_step(state.model, mixed_precision=True)
            torch.cuda.synchronize()
            if route == "kernels":
                _zero_launches(wrappers)
            t0 = time.perf_counter()
            with plain_versions(swap):
                losses = [step(state, b)[1] for b in steps]
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if route == "kernels":
                launched.update(_check_launches(f"{label} train", wrappers, per_unit[name],
                                                len(steps)))
            res[route] = (torch.stack(losses).float().cpu().numpy(), state, step, wall)
        (lk, kstate, kstep, kwall), (lp, _, _, pwall) = res["kernels"], res["plain"]
        print(f"{label}: 2 train steps (bf16 mixed precision) in {kwall * 1e3:.2f} ms through "
              f"the kernels, {pwall * 1e3:.2f} ms through the plain versions", flush=True)
        trajectory_gate(label, lk, lp, ZOO_LOSS_RTOL,
                        f"; guard skips {int(kstate.skipped_steps)}")
        check(int(kstate.skipped_steps) == 0, f"{label}: the guard skipped a step")
        profile_forward(label, f"one train step of {int(steps[0].graph_mask.sum())} graphs "
                               "(forward, backward, guard and AdamW)",
                        lambda: kstep(kstate, steps[0]), noun="step", groups={
                            "K1 (forward)": ["sorted_segment_sum"],
                            "K3 (forward)": ["multi_agg_kernel"],
                            "f32 GEMMs": ["gemm_f32f32", "sgemm"],
                            "bf16 GEMMs": ["bf16_s16816gemm"],
                            "scatter and gather backwards": ["scatter", "indexing_backward",
                                                             "indexFuncLargeIndex", "index_add"],
                        })
        del res, kstate, kstep, model
    return launched


def run_schnet_md17(graphs, device, per_unit, num_epoch: int):
    """The committed MD17 recipe (``md17_config``) on ``graphs``
    (``md17_shaped_dataset``): one energy-force step through K1 against the
    same step through K1's plain version (loss, forces, gradients); then
    ``api.run_training`` (no device given; the main path: every launch of
    K1, per train step and eval batch, counted) and ``api.run_prediction``
    restored from disk, both with PyTorch's deterministic algorithms, gated on tests/test_examples.py's full-tier bounds
    (``MD17_GATES``); one profiled step. Returns the launches by (kernel,
    case)."""
    import numpy as np
    import torch

    from hydragnn_tpu_torch.api import prepare_data, run_prediction, run_training
    from hydragnn_tpu_torch.data import split_dataset
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train import compute_loss, make_train_step

    label = "schnet_md17"
    wrappers = _wrappers()
    config = md17_config(num_epoch)
    training = config["NeuralNetwork"]["Training"]
    splits = split_dataset(graphs, training["perc_train"], seed=0)
    done, loaders, _ = prepare_data(copy.deepcopy(config), splits)
    arch = done["NeuralNetwork"]["Architecture"]
    check(arch["use_sorted_aggregation"], f"{label}: sorted aggregation is off")
    model = create_model(done, device=device, seed=SEED)
    loaders[0].set_epoch(0)
    batch = next(iter(loaders[0])).to(device)
    print(f"{label}: {arch['mpnn_type']} hidden {arch['hidden_dim']}, {arch['num_conv_layers']} "
          f"conv layers, {model.graph_convs[0].Dense_0.weight.shape[0]} filters, "
          f"{arch['num_gaussians'] or 50} Gaussians (config {arch['num_gaussians']}), radius "
          f"{arch['radius']}, {arch['max_neighbours']} neighbours, batch "
          f"{training['batch_size']}, {training['loss_function_type']}, AdamW lr "
          f"{training['Optimizer']['learning_rate']}, energy-force, f32; "
          f"{len(graphs)} samples split {[len(s) for s in splits]}, {num_epoch} epochs; batch "
          f"{int(batch.node_mask.sum())} atoms, {int(batch.edge_mask.sum())} edges", flush=True)

    # one energy-force step through K1 against K1's plain version
    res = {}
    for route, swap in (("kernels", ()), ("plain", ("K1",)), ("the plain route again", ("K1",))):
        m = copy.deepcopy(model).train()
        torch.cuda.synchronize()
        if route == "kernels":
            _zero_launches(wrappers)
        with plain_versions(swap):
            tot, _, preds = compute_loss(m, batch, m.cfg, True)
            tot.backward()
            torch.cuda.synchronize()
        if route == "kernels":
            ef_launched = _check_launches(f"{label} energy-force step", wrappers, per_unit, 1)
        res[route] = (tot.item(), preds["forces"].detach(),
                      {n: p.grad.detach().clone() for n, p in m.named_parameters()})
        del m, tot, preds
    (tk, fk, gk), (tp, fp, gp) = res["kernels"], res["plain"]
    mask = batch.node_mask
    print(f"{label}: energy-force loss relative difference {abs(tk - tp) / abs(tp):.6g} (limit "
          f"{MD17_RTOL['loss']}); the plain route again "
          f"{abs(res['the plain route again'][0] - tp) / abs(tp):.6g}", flush=True)
    check(math.isfinite(tk) and abs(tk - tp) <= MD17_RTOL["loss"] * abs(tp),
          f"{label}: the energy-force loss disagrees with the plain route")
    _rows_gate(label, "energy-force forces vs the plain route", {"forces": fk[mask].cpu().numpy()},
               {"forces": fp[mask].cpu().numpy()}, {"forces": MD17_RTOL["forces"]})
    gradients_present(f"{label}: energy-force step", gk, gp)
    grad_gate("energy-force gradients vs plain route", gk, gp, MD17_RTOL["gradients"],
              {"the plain route again": res["the plain route again"][2]}, cell=label)

    # the recipe: the main path, with PyTorch's deterministic algorithms
    # (MD17_GATES: the outcome of 1,200 steps moves with the atomics' order)
    units = num_epoch * sum(len(loader) for loader in loaders)
    torch.cuda.synchronize()
    _zero_launches(wrappers)
    caught = []
    t0 = time.perf_counter()
    with deterministic(caught):
        _, state, hist = run_training(copy.deepcopy(config), datasets=splits, seed=SEED)
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launched = _check_launches(f"{label} run_training", wrappers, per_unit, units,
                               "steps and eval batches")
    steps = int(state.step)
    print(f"{label}: run_training (no device given: {state.step.device}) {num_epoch} epochs, "
          f"{steps} steps in {train_s:.2f} s ({train_s * 1e3 / max(steps, 1):.2f} ms per step "
          f"with its share of the evaluation); train loss {hist['train'][0]:.6g} -> "
          f"{hist['train'][-1]:.9g}, val {hist['val'][0]:.6g} -> {hist['val'][-1]:.9g}; guard "
          f"skips {int(state.skipped_steps)}; deterministic algorithms, warnings {caught}",
          flush=True)
    check(state.step.device.type == "cuda" and steps == num_epoch * len(loaders[0])
          and all(math.isfinite(v) for k in ("train", "val", "test") for v in hist[k]),
          f"{label}: run_training did not train on the card")
    with deterministic():
        readings = md17_readings(label, config, splits)
    check(readings["force correlation"] > MD17_GATES["force correlation"]
          and all(readings[k] < MD17_GATES[k] for k in MD17_GATES if k != "force correlation"),
          f"{label}: the recipe misses tests/test_examples.py's bounds")
    step = make_train_step(state.model, compute_grad_energy=True)
    profile_forward(label, f"one energy-force train step of {int(batch.graph_mask.sum())} "
                           "molecules (forward, forces, backward, guard and AdamW)",
                    lambda: step(state, batch), noun="step", groups={
                        "K1 (forward)": ["sorted_segment_sum"],
                        "f32 GEMMs": ["gemm_f32f32", "sgemm", "gemm"],
                        "gathers and their backwards": ["index", "scatter", "gather"],
                        "AdamW and the guard's copy": ["multi_tensor_apply"],
                    })
    merged = collections.Counter(launched)
    merged.update(ef_launched)
    return merged


def md17_readings(label, config, splits):
    """``api.run_prediction`` restored from disk on the MD17 recipe's test
    split: the readings of tests/test_examples.py's full-tier gates
    (``MD17_GATES``)."""
    import numpy as np

    from hydragnn_tpu_torch.api import run_prediction

    t0 = time.perf_counter()
    tot, _, preds, trues = run_prediction(copy.deepcopy(config), datasets=splits)
    pred_s = time.perf_counter() - t0
    pf, tf = preds["forces"].ravel(), trues["forces"].ravel()
    force_mae = float(np.mean(np.abs(pf - tf)))
    zero_mae = float(np.mean(np.abs(tf)))
    corr = float(np.corrcoef(pf, tf)[0, 1]) if pf.std() > 0 and tf.std() > 0 else 0.0
    pe, te = preds["graph_energy"].ravel(), trues["graph_energy"].ravel()
    energy_mae = float(np.mean(np.abs(pe - te)))
    mean_mae = float(np.mean(np.abs(te - te.mean())))
    readings = {"force MAE / zero predictor": force_mae / zero_mae, "force correlation": corr,
                "energy MAE / test-mean predictor": energy_mae / mean_mae}
    print(f"{label}: run_prediction restored from disk in {pred_s:.2f} s: test loss {tot:.6g}; "
          f"energy MAE {energy_mae:.6g} (test-mean predictor {mean_mae:.6g}); force MAE "
          f"{force_mae:.6g} (zero predictor {zero_mae:.6g}, corr {corr:.4f}); gates "
          f"{readings} against {MD17_GATES} (correlation above, the others below)", flush=True)
    return readings


MD17_ROUTES = ("kernels", "plain", "kernels-deterministic", "plain-deterministic")


def run_md17_route(graphs, route: str) -> None:
    """The MD17 recipe alone through ``route`` (``MD17_ROUTES``: K1's
    kernel or its plain version, with or without PyTorch's deterministic
    algorithms): ``run_training`` and the gates' readings, to tell the
    spread of the recipe's outcome by route and by the atomics of
    ``index_add_``. Ungated."""
    import torch

    from hydragnn_tpu_torch.api import run_training
    from hydragnn_tpu_torch.data import split_dataset

    config = md17_config(MD17_EPOCHS)
    splits = split_dataset(graphs, config["NeuralNetwork"]["Training"]["perc_train"], seed=0)
    label = f"md17 route {route}"
    caught = []
    with contextlib.ExitStack() as stack:
        if route.startswith("plain"):
            stack.enter_context(plain_versions(("K1",)))
        if route.endswith("deterministic"):
            stack.enter_context(deterministic(caught))
        t0 = time.perf_counter()
        _, state, hist = run_training(copy.deepcopy(config), datasets=splits, seed=SEED)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        readings = md17_readings(label, config, splits)
    print(f"{label}: {int(state.step)} steps in {train_s:.2f} s, train loss "
          f"{hist['train'][-1]:.9g}, val {hist['val'][-1]:.9g}; warnings {caught}", flush=True)
    print(f"md17 readings: {json.dumps({'route': route, **readings})}", flush=True)


# ---------------------------------------------------------------------------
# the model cells: DimeNet (spherical basis, triplet channel) and MACE (O(3)
# algebra), served (dimenet, mace) and trained (dimenet_train, mace_train)

MODEL_CELLS = ("DimeNet", "MACE")
MODEL_TRAIN_GRAPHS = 384
# K1 launches of one served batch or bf16 train step, by case. DimeNet's
# spherical basis is f32 (its Bessel zeros are f32 constants), which
# promotes each layer's interaction and output block to f32: its output
# block sums at the layer-0 width (the hidden width is the input's, 4) and
# at 128. MACE sums its [E, 256 x 9] messages once per layer, in bf16
MODEL_PER_UNIT = {"DimeNet": {"K1": {"float32/C4": 1, "float32/C128": 1}},
                  "MACE": {"K1": {"bfloat16/C2304": 2}}}
# the energy-force step (f32; the atomic number is the only input, so
# DimeNet's layer 0 takes the hidden width too)
MODEL_EF_PER_STEP = {"DimeNet": {"K1": {"float32/C128": 2}},
                     "MACE": {"K1": {"float32/C2304": 2}}}
# limits of the model cells' training phases against K1's plain version,
# at about three times the readings of this script on an H100 (NVIDIA H100
# 80GB HBM3, 700 W) at seed 0, as pnaplus_train's are read. DimeNet's
# energy-force step has an ill-conditioned atom: the node head's first
# layer meets a pre-activation of 2.64e-7 there in the f64 step (the
# smallest of any atom), so a rounding decides that leaky ReLU, and every
# f32 route's force at that atom read 1.78e-2 of the largest from the f64
# step's (the loss 2.0e-5, the gradients (2.5e-2, 1.8e-3)). Which side a
# route lands on hangs on roundings: in one of six runs the kernel route's
# largest force row read 5.7e-3 from the plain route's. So the kernel route
# takes the plain route's decisions in the node head's activations
# (``pinned_act``), and its limits are about three times the readings of
# the runs where both routes decided alike. Readings by route against the
# plain route, the plain route again beside them, over six runs: DimeNet
# f32 gradients (4.7e-6 to 1.5e-5, 1.5e-6 to 1.8e-6), again
# (6.6e-6 to 1.9e-5, 1.2e-6 to 1.7e-6); bf16 (5.5e-3 to 3.6e-2, 0 to
# 1.1e-5), again (4.5e-3 to 4.2e-2, 0 to 1.1e-5), and in a seventh run
# (2.2e-2, 3.5e-3), again (2.2e-2, 3.2e-3): one bf16 ulp is 3.9e-3 of a
# value, and a rounding that lands the other way early in the step (the
# triplet sum's index_add_ atomics, on either route) reaches most
# gradients, so the bf16 median limit is about three times that run's;
# trajectories 1.1e-3 to 3.0e-3; the energy-force step when both routes agree: loss 0 to 1.6e-7,
# forces (2.2e-6 to 3.6e-6, 1.7e-7 to 1.9e-7), gradients (5.9e-5 to
# 8.0e-5, 1.5e-6 to 2.4e-6). MACE: f32 gradients (1.2e-7 to 1.8e-7, 4.7e-9
# to 5.4e-9), again (7.5e-8 to 1.2e-7, below 1e-18); bf16 (6.2e-5 to
# 3.9e-3, 0 to 1.3e-11), again (0 to 3.9e-3, below 1e-14); trajectories
# 2.3e-4 to 4.5e-4; the energy-force step: loss 0, forces (8.7e-7 to
# 1.1e-6, 2.4e-7), gradients (1.2e-7, 3.9e-10 to 6.9e-10)
MODEL_RTOL = {
    "DimeNet": {"f32 gradients": (5e-5, 6e-6), "bf16 gradients": (0.12, 1.2e-2),
                "trajectory": 0.01, "energy-force loss": 5e-7,
                "energy-force forces": (1e-5, 6e-7), "energy-force gradients": (3e-4, 8e-6)},
    "MACE": {"f32 gradients": (1e-6, 3e-8), "bf16 gradients": (0.015, 1e-6),
             "trajectory": 2e-3, "energy-force loss": 1e-6,
             "energy-force forces": (5e-6, 1e-6), "energy-force gradients": (6e-7, 5e-9)},
}
MODEL_GROUPS = {
    "K1 (forward)": ["sorted_segment_sum"],
    "f32 GEMMs (forward and backward)": ["gemm_f32f32", "sgemm"],
    "bf16 GEMMs": ["bf16_s16816gemm"],
    "AdamW and the guard's copy (multi-tensor kernels)": ["multi_tensor_apply"],
    "scatter and gather backwards": ["scatter", "indexing_backward", "indexFuncLargeIndex",
                                     "index_add"],
}


def run_energy_force_step(label, config, graphs, device, per_step, limits):
    """One energy-force step of the cell's model (``energy_force_config``:
    forces ``-dE/dpos`` by a double backward through K1, f32) from seeded
    weights on the first batch of the split, through K1 against the same
    step through K1's plain version, beside the plain route again: the
    loss, the forces per atom, every parameter's gradient (finite and
    nonzero where the plain route's is), and K1's launches. Where the node
    head is an MLP (DimeNet), the other routes take the plain route's
    decisions in its activations (``pinned_act``), and how many each would
    have flipped is printed; every route against the same step in f64 (its
    own decisions) is printed beside them. The three routes run PyTorch's
    deterministic algorithms: with its atomics, DimeNet's plain route once
    read 1.48e-6 (loss) and 5.7e-3 (forces) from both the kernel route and
    the plain route again, which agreed. Returns the launches by (kernel,
    case)."""
    import dataclasses

    import torch

    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train import compute_loss

    wrappers = _wrappers()
    ef_graphs = [dataclasses.replace(g, x=g.x[:, :1]) for g in graphs]
    done, (loader, _, _), _ = prepare_data(energy_force_config(config),
                                           split_dataset(ef_graphs, 0.9, seed=0))
    model = create_model(done, device=device, seed=SEED)
    loader.set_epoch(0)
    batch = next(iter(loader)).to(device)
    res, decisions, flips, caught = {}, [], {}, []
    for route, swap in (("plain", ("K1",)), ("kernels", ()), ("the plain route again", ("K1",))):
        m = copy.deepcopy(model).train()
        torch.cuda.synchronize()
        if route == "kernels":
            _zero_launches(wrappers)
        if hasattr(m, "heads_NN"):
            flips[route] = None if route == "plain" else []
            pin = pinned_act(m.heads_NN[0].MLP_0, decisions, flips[route])
        else:
            pin = contextlib.nullcontext()
        with deterministic(caught), plain_versions(swap), pin:
            tot, _, preds = compute_loss(m, batch, m.cfg, True)
            tot.backward()
            torch.cuda.synchronize()
        if route == "kernels":
            launched = _check_launches(f"{label} energy-force", wrappers, per_step, 1)
        res[route] = (tot.item(), preds["forces"].detach(),
                      {n: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                       for n, p in m.named_parameters()})
        del m, tot, preds
    (tk, fk, gk), (tp, fp, gp), (ta, fa, ga) = (res[r] for r in ("kernels", "plain",
                                                                   "the plain route again"))
    mask = batch.node_mask
    scale = float(fp[mask].abs().max())

    def rows(f, ref=fp):
        return (f - ref)[mask].abs().max(dim=1).values / scale

    frow, again = rows(fk), rows(fa)
    # the same step in f64 (weights, inputs and sums): where each f32 route
    # lies from it, and the node head's first layer's smallest
    # |pre-activation| per atom (a leaky ReLU decision there hangs on a
    # rounding), printed, ungated
    m64 = copy.deepcopy(model).double().train()
    b64 = batch.replace(**{f: getattr(batch, f).double() for f in ("x", "pos", "edge_attr",
                                                                    "edge_shifts")
                           if getattr(batch, f) is not None})
    head = dict(m64.named_modules())["heads_NN.0.MLP_0.Dense_0" if hasattr(m64, "heads_NN")
                                     else f"readout{m64.cfg.num_conv_layers}_head0.Dense_0"]
    pre = []
    hook = head.register_forward_hook(lambda mod, i, o: pre.append(o.detach()[0]))
    with f64_sums():
        tot64, _, preds64 = compute_loss(m64, b64, m64.cfg, True)
        tot64.backward()
    hook.remove()
    f64 = (preds64["forces"].detach().float(), {n: p.grad.detach().float()
                                                for n, p in m64.named_parameters()})
    margin = pre[0].abs().min(dim=1).values.float()
    atoms = torch.nonzero(mask).flatten()
    part = int(atoms[int(frow[:].argmax())])
    least = int(atoms[int(margin[mask].argmin())])
    print(f"{label}: energy-force step against the same step in f64 (weights, inputs, sums): "
          f"loss {abs(float(tot64) - tk) / abs(float(tot64)):.3g} (kernels), "
          f"{abs(float(tot64) - tp) / abs(float(tot64)):.3g} (plain); (largest force row, its "
          f"atom, median row; largest and median gradient) " + "; ".join(
              "{} ({:.3g}, {}, {:.3g}; {:.3g}, {:.3g})".format(
                  r, float(rows(f, f64[0]).max()), int(atoms[int(rows(f, f64[0]).argmax())]),
                  float(rows(f, f64[0]).median()), *grad_reading(g, f64[1])[::2])
              for r, (_, f, g) in res.items())
          + f"; the node head's first layer in f64: smallest |pre-activation| of any atom "
          f"{float(margin[mask].min()):.3g} (atom {least}), at atom {part} (where the kernel "
          f"route's forces part most from the plain route's) {float(margin[part]):.3g}",
          flush=True)
    del m64, b64, tot64, preds64, f64, pre
    if flips:
        print(f"{label}: energy-force step: the node head's activations held to the plain "
              f"route's decisions; decisions each route's own input would have flipped, per "
              f"layer: kernels {flips['kernels']}, the plain route again "
              f"{flips['the plain route again']}", flush=True)
    lim = limits["energy-force forces"]
    print(f"{label}: energy-force step (f32, {int(mask.sum())} atoms): loss {tk:.6g} vs plain "
          f"{tp:.6g}, relative {abs(tk - tp) / abs(tp):.6g} (limit "
          f"{limits['energy-force loss']}; the plain route again {abs(ta - tp) / abs(tp):.6g}); "
          f"forces largest row {float(frow.max()):.6g}, median row {float(frow.median()):.6g} "
          f"of max |F_plain| {scale:.6g} (limits {lim}; the plain route again "
          f"{float(again.max()):.6g}, {float(again.median()):.6g}); deterministic "
          f"algorithms, warnings {sorted(set(caught))}", flush=True)
    check(math.isfinite(tk) and abs(tk - tp) <= limits["energy-force loss"] * abs(tp),
          f"{label}: the energy-force loss disagrees with the plain route")
    check(bool(torch.isfinite(fk).all()) and float(frow.max()) <= lim[0]
          and float(frow.median()) <= lim[1], f"{label}: the forces disagree with the plain route")
    gradients_present(f"{label}: energy-force step", gk, gp)
    grad_gate("energy-force gradients vs plain route", gk, gp, limits["energy-force gradients"],
              {"the plain route again": ga}, cell=label)
    return launched


def padding_triplets_check(label, model, batch, device) -> None:
    """A bf16 mixed-precision train step of DimeNet on a batch with padding
    triplets: every gradient finite (padding edges have eps-clamped
    lengths, where the spherical basis's recurrence would reach ~1e38
    without its mask, and a backward NaN), no step skipped."""
    import torch

    from hydragnn_tpu_torch.train import make_train_step

    pad = int((~batch.trip_mask).sum())
    state = _train_copy(model, device)
    make_train_step(state.model, mixed_precision=True)(state, batch)
    bad = [n for n, g in _grads(state).items() if not bool(torch.isfinite(g).all())]
    print(f"{label}: bf16 step with {pad} padding triplets of {batch.trip_mask.numel()} (on "
          f"{int((~batch.edge_mask).sum())} padding edges): {len(bad)} non-finite gradients "
          f"{bad[:5]}, guard skips {int(state.skipped_steps)}", flush=True)
    check(pad > 0, f"{label}: the batch holds no padding triplet")
    check(not bad and int(state.skipped_steps) == 0,
          f"{label}: non-finite gradients with padding triplets")


def run_model_cell_train(mpnn_type, graphs, device):
    """``<model>_train``: the cell trained as ``pnaplus_train`` (through
    ``run_cell_train``: step-0 gradients in f32 and bf16 against K1's plain
    version, the two 22-step trajectories, ms per step, peak memory, one
    profiled step, one ``run_training`` epoch), then one energy-force step
    against the plain route; for DimeNet a bf16 step with padding triplets
    first. Returns the launches by (kernel, case)."""
    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.models.create import create_model

    label = f"{mpnn_type.lower()}_train"
    config = model_cell_config(mpnn_type)
    t0 = time.perf_counter()
    if mpnn_type == "DimeNet":
        done, (loader, _, _), _ = prepare_data(copy.deepcopy(config),
                                               split_dataset(graphs, 0.9, seed=0))
        loader.set_epoch(0)
        padding_triplets_check(label, create_model(done, device=device, seed=SEED),
                               next(iter(loader)).to(device), device)
    launched = run_cell_train(label, config, graphs, device, MODEL_PER_UNIT[mpnn_type],
                              ("K1",), MODEL_RTOL[mpnn_type], MODEL_GROUPS)
    launched.update(run_energy_force_step(label, config, graphs, device,
                                          MODEL_EF_PER_STEP[mpnn_type], MODEL_RTOL[mpnn_type]))
    print(f"{label}: phase in {time.perf_counter() - t0:.1f} s", flush=True)
    return launched


# ---------------------------------------------------------------------------
# the multibranch GFM recipe


# examples/multibranch/multibranch_GFM260_SC25.json as committed: EGNN
# hidden 866, 4 conv layers, equivariant, sorted aggregation; 5 branches, each
# with graph heads (2 x 50 shared, 3 x 889) and mlp node heads (3 x 889);
# task weights [1, 100], MAE, batch 160, 3 pad buckets, bf16 mixed
# precision, balanced branch sampling, AdamW 1e-3. The cells add per-branch
# loss weights and the per-branch loss scalars, and train GFM_EPOCHS epochs
GFM_JSON = "examples/multibranch/multibranch_GFM260_SC25.json"
GFM_SHARES = (0.40, 0.25, 0.15, 0.12, 0.08)  # each branch's share of the data
GFM_BRANCH_LOSS_WEIGHTS = [1.0, 2.0, 1.0, 0.5, 1.0]
GFM_GRAPHS = 1920  # 1,728 train graphs: 11 balanced batches of 160 an epoch
GFM_EPOCHS = 1  # 11 steps (cut from 2 epochs, 22 steps: PERF.md §4)
GFM_SERVE_GRAPHS = 128
# K1 and K2 per step (and per served batch) of the mlp-head recipe are the
# encoder's, TRAIN_PER_STEP (conv layer 0 in bf16, layers 1-3 promoted to
# f32, the last through K2); mlp heads launch none. With conv node heads at
# [889, 889, 889] each of the 5 branches adds 3 equivariant EGNN convs (K1 at
# the messages' width, the model's hidden 866, and at C = 3 for the
# coordinate mean, f32 as the encoder's output is) and the output conv
# through K2
GFM_CONVHEAD_PER_STEP = {"K1": {"bfloat16/C866": 1, "float32/C866": 17,
                                "bfloat16/C3": 1, "float32/C3": 17},
                         "K2": {"float32/866x866": 6}}
GFM_CONVHEAD_BATCH = 32  # the egnn_train batch (PERF.md: the batch cut)
GFM_CONVHEAD_GRAPHS = 214  # 192 train graphs: 6 balanced batches of 32 (cut from 11: PERF.md §4)
# gfm_train's gates are egnn_train's (TRAIN_RTOL): the same unpinned
# comparison, read 1.27e-2 to 1.55e-2 / 2.6e-3 to 3.8e-3 in f32 beside the
# plain route again at 5.9e-3 to 1.5e-2. The conv-head cell's step-0
# gradients are held to K1's plain route with every decision pinned, which
# reads far lower: f32 (2.82e-5, 5.53e-6), bf16 (9.78e-3, 5.87e-4) in five
# runs, the pinned reference again 0 and 0; limits at about three times.
# Its 11-step trajectory (unpinned) read 1.2e-3 to 3.1e-3 in six runs
GFM_CONVHEAD_RTOL = {"f32 gradients": (1e-4, 2e-5), "bf16 gradients": (3e-2, 2e-3),
                     "trajectory": 1e-2}
# gfm_nll's 4 steps with the decisions pinned, from variances near 4: the
# per-step relative loss difference read 7.03e-6 in four runs
GFM_NLL_TRAJECTORY_RTOL = 2e-5
# served answers, (largest row, median row) of max |reference| per head (a
# ``__var`` output under its head's limit), at about three times the
# readings of four to six runs: the server against the same bf16 cast
# through the plain ops on its own micro-batches, energy (2.03e-7, 1.3e-8
# to 1.9e-8), forces (5.4e-7 to 1.14e-6, 3.8e-9 to 4.0e-9), and against
# each branch's run_prediction answers (other micro-batch compositions),
# energy (0 to 1.6e-7, 0 to 1.5e-8), forces (0 to 1.27e-6, 0 to 6.2e-9);
# against the f32 plain ops energy (3.24e-3, 1.96e-4), forces (3.48e-3,
# 2.31e-5)
GFM_SERVE_RTOL = {"bf16 plain ops": {"energy": (1e-6, 6e-8), "forces": (4e-6, 2e-8)},
                  "f32 plain ops": {"energy": (1e-2, 6e-4), "forces": (1e-2, 7e-5)}}
# gfm_nll's served batch with its variances against the plain route: energy
# (9.2e-7 to 1.38e-6, 1.6e-7 to 1.84e-7), energy__var (2.84e-6 to 6.08e-6,
# 8.4e-8 to 1.1e-7), forces (9.9e-7 to 1.35e-6, 4.81e-8), forces__var
# (1.31e-6 to 1.75e-6, 2.9e-9 to 3.0e-9) in six runs
GFM_NLL_SERVE_RTOL = {"energy": (2e-5, 6e-7), "forces": (5e-6, 1.5e-7)}
# mace_nll's and mlp_per_node's served batches read 0 and 0 in six runs;
# their limits are the mace cell's served ones
SMALL_SERVE_RTOL = SERVE_RTOL["mace"]["bf16 plain ops"]
# f32 step-0 gradients against K1's plain version, six runs each: mace_nll
# (3.36e-7, 1.23e-8), the plain route again (4.9e-8 to 5.3e-8, 4.5e-20);
# mlp_per_node (1.22e-6, 4.17e-7), the plain route again 0 and 0. gfm_nll's
# unpinned step-0 gradients keep egnn_train's limits: (5.7e-3 to 1.96e-2,
# 1.4e-3 to 2.7e-3), the plain route again (1.8e-3 to 1.26e-2)
MACE_NLL_GRAD_RTOL = (1e-6, 4e-8)
MLP_PER_NODE_GRAD_RTOL = (4e-6, 1.5e-6)
GFM_NLL_STEPS = 4
GFM_NLL_GRAPHS = 720  # 648 train graphs: 4 balanced batches of 160 (+ a short one)
GFM_GROUPS = {
    "K1 (forward)": ["sorted_segment_sum_"],
    "K2 (forward, with its row-pointer and W-layout kernels)":
        ["fused_edge_kernel", "rowptr_kernel", "prep_w_kernel"],
    "f32 GEMMs (cuBLAS and CUTLASS, forward and backward)": ["gemm_f32f32", "sgemm"],
    "bf16 GEMMs": ["bf16_s16816gemm"],
    "AdamW and the guard's copy (multi-tensor kernels)": ["multi_tensor_apply"],
    "the branch banks' einsums and gathers (bmm, gather)": ["bmm", "gather"],
    "gathers' backwards (index_add_, indexing backward)":
        ["indexing_backward", "indexFuncLargeIndex", "index_add"],
}
OPTIMIZER_KINDS = ("Adagrad", "RMSprop", "Adamax", "Adadelta", "LAMB", "FusedLAMB")
OPT_STEPS = 3
OPT_RTOL = 1e-6  # card against CPU copies, of each tensor's largest value
MLP_PER_NODE_PER_UNIT = {"K1": {"bfloat16/C4": 1, "bfloat16/C256": 1}}
MLP_PER_NODE_STEP = {"K1": {"float32/C4": 1, "float32/C256": 1}}
MACE_NLL_PER_UNIT = {"K1": {"bfloat16/C2304": 2}}
MACE_NLL_STEP = {"K1": {"float32/C2304": 2}}


def gfm_config(node_type: str = "mlp", batch_size: int = 0, loss: str = "",
               num_epoch: int = GFM_EPOCHS):
    """The committed GFM recipe, with ``GFM_BRANCH_LOSS_WEIGHTS`` and the
    per-branch loss scalars, ``num_epoch`` epochs; ``node_type``,
    ``batch_size`` and ``loss`` override the recipe's where given."""
    config = json.loads((REPO / GFM_JSON).read_text())
    config["Verbosity"] = {"level": 0}
    arch = config["NeuralNetwork"]["Architecture"]
    arch.update(branch_loss_weights=list(GFM_BRANCH_LOSS_WEIGHTS), branch_loss_metrics=True)
    for head in arch["output_heads"]["node"]:
        head["architecture"]["type"] = node_type
    training = config["NeuralNetwork"]["Training"]
    training["num_epoch"] = num_epoch
    if batch_size:
        training["batch_size"] = batch_size
    if loss:
        training["loss_function_type"] = loss
    return config


def gfm_dataset(n: int):
    """``n`` OC20-shaped graphs, each drawn into one of the 5 branches
    (``dataset_id``) with the uneven shares ``GFM_SHARES``, from the seed."""
    import dataclasses

    import numpy as np

    from hydragnn_tpu_torch.data.synthetic import oc20_shaped_dataset

    ids = np.random.default_rng(SEED).choice(len(GFM_SHARES), size=n, p=GFM_SHARES)
    return [dataclasses.replace(g, dataset_id=int(i))
            for g, i in zip(oc20_shaped_dataset(n), ids)]


def branch_shares(label: str, splits, config, epochs: int) -> None:
    """Each branch's share of the data and of the train loader's draws over
    ``epochs`` epochs (balanced sampling: a fifth each)."""
    import numpy as np

    from hydragnn_tpu_torch.api import prepare_data

    _, (loader, _, _), _ = prepare_data(copy.deepcopy(config), splits)
    draws = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        draws += [b.dataset_id.numpy()[b.graph_mask.numpy()] for b in loader]
    draws = np.concatenate(draws)
    data = np.bincount([g.dataset_id for g in splits[0]], minlength=5) / len(splits[0])
    share = np.bincount(draws, minlength=5) / draws.size
    print(f"{label}: branch shares of the train split {np.round(data, 4).tolist()}, of the "
          f"{draws.size} draws over {epochs} epochs {np.round(share, 4).tolist()}", flush=True)
    check(bool(np.all(np.abs(share - 0.2) < 0.05)), f"{label}: the draws are not balanced")


def run_gfm_train(graphs, device):
    """``gfm_train``: the committed GFM recipe at full width through K1 and
    K2 (``run_cell_train``: step-0 gradients in f32 and bf16 against their
    plain versions, the 11-step trajectories, launches per step, ms per
    step, peak memory, a profiled step, ``api.run_training`` for
    ``GFM_EPOCHS`` epochs), with each branch's share of the draws. Returns
    the launches."""
    from hydragnn_tpu_torch.data.pipeline import split_dataset

    label = "gfm_train"
    t0 = time.perf_counter()
    splits = split_dataset(graphs, 0.9, seed=0)
    config = gfm_config()
    branch_shares(label, splits, config, GFM_EPOCHS)
    launched = run_cell_train(label, config, graphs, device, TRAIN_PER_STEP, ("K1", "K2"),
                              TRAIN_RTOL, GFM_GROUPS, epochs=GFM_EPOCHS, splits=splits,
                              min_steps=11)
    print(f"{label}: phase in {time.perf_counter() - t0:.1f} s", flush=True)
    return launched


def gfm_prediction_hook(config, graphs, device):
    """Served answers against ``api.run_prediction`` (restored from the
    same checkpoint) over the served graphs, branch by branch."""
    def hook(server, requests, results):
        import numpy as np

        from hydragnn_tpu_torch.api import run_prediction
        from hydragnn_tpu_torch.data.pipeline import split_dataset

        tr, va, _ = split_dataset(graphs, 0.9, seed=0)
        _, _, preds, _ = run_prediction(copy.deepcopy(config), datasets=(tr, va, graphs),
                                        device=device)
        offs = np.cumsum([0] + [g.num_nodes for g in graphs])
        branch = np.asarray([g.dataset_id for g in graphs])
        for b in range(len(GFM_SHARES)):
            idx = np.nonzero(branch == b)[0]
            check(idx.size > 0, f"gfm: no request of branch {b}")
            line = []
            for k, (lim_max, lim_med) in GFM_SERVE_RTOL["bf16 plain ops"].items():
                want = [preds[k][i:i + 1] if k == "energy" else preds[k][offs[i]:offs[i + 1]]
                        for i in idx]
                got = [results[i].get(k).reshape(w.shape) for i, w in zip(idx, want)]
                scale = max(float(np.abs(w).max()) for w in want)
                rows = np.concatenate([np.abs(g - w).max(axis=1) for g, w in zip(got, want)])
                rel = rows / max(scale, 1e-12)
                line.append(f"{k} largest {float(rel.max()):.3g} median "
                            f"{float(np.median(rel)):.3g} (limits {(lim_max, lim_med)})")
                check(float(rel.max()) <= lim_max and float(np.median(rel)) <= lim_med,
                      f"gfm: branch {b}'s served {k} disagrees with run_prediction")
            print(f"serve gfm: branch {b} ({idx.size} graphs) against run_prediction: "
                  + "; ".join(line), flush=True)
    return hook


def run_gfm_serving(graphs, device):
    """``gfm``: ``api.run_server`` restores gfm_train's checkpoint and
    answers N_REQUESTS requests over the 5 branches (each request's
    ``dataset_id`` picks its decoder), held against the plain ops on the
    server's own micro-batches and against run_prediction per branch."""
    t0 = time.perf_counter()
    config = gfm_config()
    SERVE_RTOL.setdefault("gfm", GFM_SERVE_RTOL)
    launched = run_serving("gfm", config, graphs, device, N_REQUESTS, TRAIN_PER_STEP,
                           hook=gfm_prediction_hook(config, graphs, device))
    print(f"serve gfm: phase in {time.perf_counter() - t0:.1f} s", flush=True)
    return launched


def run_gfm_convhead_train(graphs, device):
    """``gfm_convhead_train``: the recipe with conv node heads at
    [889, 889, 889] (5 branches of 4 EGNN convs, the last through K2), batch
    32, trained as gfm_train for 1 epoch, with the first step's peak
    memory. Returns the launches."""
    import torch

    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train import make_train_step

    label = "gfm_convhead_train"
    t0 = time.perf_counter()
    splits = split_dataset(graphs, 0.9, seed=0)
    config = gfm_config("conv", batch_size=GFM_CONVHEAD_BATCH, num_epoch=1)
    done, (loader, _, _), _ = prepare_data(copy.deepcopy(config), splits)
    loader.set_epoch(0)
    batch = next(iter(loader))
    state = _train_copy(create_model(done, device=device, seed=SEED), device)
    params = sum(p.numel() for p in state.model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    make_train_step(state.model, mixed_precision=True)(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: {params} parameters; the first step of {int(batch.graph_mask.sum())} "
          f"graphs ({int(batch.edge_mask.sum())} edges): peak memory {peak / 2**30:.2f} GiB "
          f"({(peak - base) / 2**30:.2f} GiB over the state's "
          f"{base / 2**30:.2f} GiB); at batch 160 (x{160 / GFM_CONVHEAD_BATCH:.0f} the "
          f"activations) about {(base + (peak - base) * 160 / GFM_CONVHEAD_BATCH) / 2**30:.1f} "
          f"GiB", flush=True)
    del state
    branch_shares(label, splits, config, 1)
    # the step-0 gradients with every activation held to K1's plain
    # route's decisions: 8 convs deep, the f32 step through K2's kernel alone
    # read 3.22e-2 against the plain route in one parameter of a head chain
    # (over egnn_train's limit, 3e-2), and the plain route against itself
    # 3.29e-2 with PyTorch's atomics: roundings flip ReLUs
    launched = run_cell_train(label, config, graphs, device, GFM_CONVHEAD_PER_STEP,
                              ("K1", "K2"), GFM_CONVHEAD_RTOL, GFM_GROUPS, epochs=1,
                              splits=splits, min_steps=6, pinned_grads=True)
    print(f"{label}: phase in {time.perf_counter() - t0:.1f} s", flush=True)
    return launched


def _outputs_gate(label, what, got, want, mask_of, limits):
    """Every output of ``got`` against ``want`` on real rows, (largest
    row, median row) of each output's max |want| within ``limits`` (by
    output, a ``__var`` output under its head's limit)."""
    import numpy as np

    line = []
    for k, w in want.items():
        m = mask_of(k).cpu().numpy()
        w = w.float().cpu().numpy()[m]
        g = got[k].float().cpu().numpy()[m]
        rows = np.abs(g - w).reshape(w.shape[0], -1).max(axis=1) / max(
            float(np.abs(w).max()), 1e-12)
        lim = limits[k.split("__")[0]]
        line.append(f"{k} ({float(rows.max()):.3g}, {float(np.median(rows)):.3g})")
        check(bool(np.isfinite(g).all()) and float(rows.max()) <= lim[0]
              and float(np.median(rows)) <= lim[1], f"{label}: {what}: {k} disagrees")
    print(f"{label}: {what}: (largest row, median row) of max |reference| "
          + ", ".join(line) + f" (limits {limits})", flush=True)


def served_batch_gate(label, model, batch, per_unit, limits):
    """One served batch (the server's bf16 eval cast) through the kernels
    (launches counted) against the same cast through their plain
    versions. Returns the launches."""
    import torch

    from hydragnn_tpu_torch.train.loop import cast_batch_bf16, mp_cast_model

    wrappers = _wrappers()
    m = mp_cast_model(model).eval()
    b = cast_batch_bf16(batch)
    with torch.inference_mode():
        _zero_launches(wrappers)
        got = m(b)
        torch.cuda.synchronize()
        launched = _check_launches(f"{label} served batch", wrappers, per_unit, 1, "batches")
        with plain_versions(PLAIN):
            want = m(b)

    def mask_of(k):
        return batch.graph_mask if k.startswith("energy") else batch.node_mask

    _outputs_gate(label, "one served batch, bf16, kernels vs plain versions", got, want,
                  mask_of, limits)
    return launched


def unit_variance(model) -> None:
    """Each head's last layer: its variance half (``<name>__var`` the
    square of it) given a bias of 2 and a tenth of its weights, in place."""
    import torch

    for head, d in zip(model.heads_NN, model.cfg.output_dim):
        mlp = getattr(head, "MLP_0", head)
        last = getattr(mlp, f"Dense_{len(mlp.features) - 1}")
        with torch.no_grad():
            last.bias[..., d:] = 2.0
            last.weight[..., d:, :] *= 0.1


def run_gfm_nll(graphs, mace_graphs, device):
    """``gfm_nll``: the recipe under ``GaussianNLLLoss`` (every head twice
    as wide, ``<name>__var`` its second half squared): one served batch with
    its variances and step-0 gradients through K1 and K2 against their plain
    versions, and GFM_NLL_STEPS train steps through K1 against its plain
    version with the decisions pinned (``pinned_decisions``), the variances
    started near 4 (``unit_variance``); then the mace cell under
    ``GaussianNLLLoss``: one served batch and one f32 step's gradients
    against K1's plain version. Returns the launches (GFM, MACE)."""
    import torch

    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train import make_train_step

    label = "gfm_nll"
    t0 = time.perf_counter()
    config = gfm_config(loss="GaussianNLLLoss", num_epoch=1)
    done, (loader, _, _), _ = prepare_data(copy.deepcopy(config),
                                           split_dataset(graphs, 0.9, seed=0))
    loader.set_epoch(0)
    batches = list(loader)[:GFM_NLL_STEPS]
    model = create_model(done, device=device, seed=SEED)
    check(model.cfg.var_output, f"{label}: no variance heads")
    launched = served_batch_gate(label, model, batches[0].to(device), TRAIN_PER_STEP,
                                 GFM_NLL_SERVE_RTOL)
    grads = route_gradients(model, batches[0], device,
                            {"kernels": ((), None), "plain": (("K1", "K2"), None),
                             "the plain route again": (("K1", "K2"), None)},
                            lambda st: (lambda b: make_train_step(st.model)(st, b)))
    torch.cuda.synchronize()
    gradients_present(f"{label}: f32 step 0", grads["kernels"], grads["plain"])
    grad_gate("f32 gradients vs plain route", grads["kernels"], grads["plain"],
              TRAIN_RTOL["f32 gradients"], {"the plain route again": grads["the plain route again"]},
              cell=label)
    del grads
    # the steps through K1's kernel against K1's plain version (K2 in both),
    # every ReLU and variance clamp held to the plain route's decisions, from
    # the seeded weights with each variance half's last layer given a bias of
    # 2 and a tenth of its weights (variances near 4): at the seeded init the
    # variances sit at the NLL's 1e-6 clamp (the largest gradient 3e6), and
    # two routes part by ~0.77 of the loss within 4 steps unpinned, ~100x
    # pinned, as AdamW moves every parameter by its learning rate whatever
    # the gradient's rounding
    unit_variance(model)
    masks, flips, losses, skipped = [], [], {}, {}
    wrappers = _wrappers()
    with deterministic():
        for route, swap in (("K1 plain", ("K1",)), ("kernels", ())):
            state = _train_copy(model, device)
            step = make_train_step(state.model, mixed_precision=True)
            torch.cuda.synchronize()
            if route == "kernels":
                _zero_launches(wrappers)
            out = []
            with plain_versions(swap), pinned_decisions(
                    masks, flips if route == "kernels" else None):
                for b in batches:
                    out.append(step(state, b)[1])
                torch.cuda.synchronize()
            if route == "kernels":
                steps_launched = _check_launches(label, wrappers, TRAIN_PER_STEP, len(batches))
            losses[route] = torch.stack(out).float().cpu().numpy()
            skipped[route] = int(state.skipped_steps)
            del state, step
    trajectory_gate(label, losses["kernels"], losses["K1 plain"], GFM_NLL_TRAJECTORY_RTOL,
                    f" (against K1's plain version, decisions pinned: {len(flips)} calls, "
                    f"{sum(flips)} flipped by the kernel route's own input; deterministic "
                    f"algorithms); guard skips {skipped}")
    check(max(skipped.values()) == 0, f"{label}: the guard skipped a step")
    del model
    launched = collections.Counter(launched)
    launched.update(steps_launched)

    mlabel = "mace_nll"
    mconfig = model_cell_config("MACE")
    mconfig["NeuralNetwork"]["Training"]["loss_function_type"] = "GaussianNLLLoss"
    done, (loader, _, _), _ = prepare_data(copy.deepcopy(mconfig),
                                           split_dataset(mace_graphs, 0.9, seed=0))
    loader.set_epoch(0)
    batch = next(iter(loader))
    mmodel = create_model(done, device=device, seed=SEED)
    check(mmodel.cfg.var_output, f"{mlabel}: no variance heads")
    mace_launched = collections.Counter(served_batch_gate(
        mlabel, mmodel, batch.to(device), MACE_NLL_PER_UNIT, SMALL_SERVE_RTOL))
    wrappers = _wrappers()
    _zero_launches(wrappers)
    grads = route_gradients(mmodel, batch, device, {"kernels": ((), None)},
                            lambda st: (lambda b: make_train_step(st.model)(st, b)))
    torch.cuda.synchronize()
    mace_launched.update(_check_launches(f"{mlabel} f32 step", wrappers, MACE_NLL_STEP, 1))
    grads.update(route_gradients(mmodel, batch, device,
                                 {"plain": (("K1",), None),
                                  "the plain route again": (("K1",), None)},
                                 lambda st: (lambda b: make_train_step(st.model)(st, b))))
    gradients_present(f"{mlabel}: f32 step 0", grads["kernels"], grads["plain"])
    grad_gate("f32 gradients vs plain route", grads["kernels"], grads["plain"],
              MACE_NLL_GRAD_RTOL, {"the plain route again": grads["the plain route again"]},
              cell=mlabel)
    print(f"{label}: phase in {time.perf_counter() - t0:.1f} s", flush=True)
    return launched, mace_launched


def run_optimizers(graphs, device):
    """``optimizers``: each of the six optimizers written for the port
    (optax's semantics) takes OPT_STEPS steps on the card from one real
    GFM batch's gradients (bf16 step through the kernels), against the same
    steps on CPU copies: parameters and state to OPT_RTOL of each tensor's
    largest value; then a non-finite step, which the guard must undo
    exactly (parameters and state bit for bit)."""
    import torch

    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train import TrainState, make_optimizer, make_train_step
    from hydragnn_tpu_torch.train.guard import guarded_update, step_ok
    from hydragnn_tpu_torch.train.optimizer import optimizer_step, state_tensors

    label = "optimizers"
    t0 = time.perf_counter()
    done, (loader, _, _), _ = prepare_data(copy.deepcopy(gfm_config(num_epoch=1)),
                                           split_dataset(graphs, 0.9, seed=0))
    loader.set_epoch(0)
    model = create_model(done, device=device, seed=SEED)
    state = _train_copy(model, device)
    make_train_step(state.model, mixed_precision=True)(state, next(iter(loader)))
    grads = [p.grad.detach().clone() for p in state.model.parameters()]
    del state
    # three steps' gradients: the batch's, scaled and flipped
    scales = (1.0, -0.5, 2.0)
    worst = {}
    for kind in OPTIMIZER_KINDS:
        opt_config = {"type": kind, "learning_rate": 1e-3}
        card = copy.deepcopy(model)
        host = copy.deepcopy(model).cpu()
        sc = TrainState.create(card, make_optimizer(card, opt_config))
        oh = make_optimizer(host, opt_config)
        t1 = time.perf_counter()
        for k in range(OPT_STEPS):
            for p, g in zip(card.parameters(), grads):
                p.grad = g * scales[k]
            optimizer_step(sc.optimizer, [p.grad for p in card.parameters()])
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t1) * 1e3 / OPT_STEPS
        for k in range(OPT_STEPS):
            for p, g in zip(host.parameters(), grads):
                p.grad = g.cpu() * scales[k]
            optimizer_step(oh, [p.grad for p in host.parameters()])
        pairs = list(zip(list(card.parameters()) + list(state_tensors(sc.optimizer)),
                         list(host.parameters()) + list(state_tensors(oh))))
        check(len(list(state_tensors(sc.optimizer))) >= len(grads),
              f"{label}: {kind} keeps no state")
        rel = max(float((a.detach().cpu() - b.detach()).abs().max())
                  / max(float(b.detach().abs().max()), 1e-30) for a, b in pairs)
        worst[kind] = rel
        # the guard: a step with a non-finite gradient leaves the parameters
        # and the state exactly as they were
        before = [t.clone() for t in sc.held]
        for p, g in zip(card.parameters(), grads):
            p.grad = g.clone()
        card_grads = [p.grad for p in card.parameters()]
        card_grads[0].view(-1)[0] = float("nan")
        sc.guard.save()
        with torch.no_grad():
            guarded_update(sc, step_ok(torch.ones((), device=device), card_grads),
                           lambda: optimizer_step(sc.optimizer, card_grads))
        restored = all(torch.equal(a, b) for a, b in zip(before, sc.held))
        print(f"{label}: {kind}: {OPT_STEPS} steps on the card, {card_ms:.2f} ms a step; "
              f"parameters and state against CPU copies: largest difference {rel:.3g} of the "
              f"tensor's largest value (limit {OPT_RTOL}); a non-finite step undone exactly "
              f"{restored} (skips {int(sc.skipped_steps)})", flush=True)
        check(rel <= OPT_RTOL, f"{label}: {kind} on the card parts from its CPU copy")
        check(restored and int(sc.skipped_steps) == 1, f"{label}: {kind}: the guard failed")
        del card, host, sc, oh
    print(f"{label}: phase in {time.perf_counter() - t0:.1f} s", flush=True)


def mlp_per_node_config():
    """The JAX package's mlp_per_node training test's model
    (tests/test_training.py ``pytest_train_mlp_per_node_head``: GIN, an
    ``mlp_per_node`` node head [10, 10] alone, task weight 1), here at the
    zoo's width (hidden 256, 2 conv layers), batch 16, bf16, sorted
    aggregation, over graphs of varying size as that test's fixture has
    them: each node decoded by the MLP of its position in its graph, modulo
    the first training graph's size."""
    config = pna_cell_config("GIN", layers=2)
    nn_cfg = config["NeuralNetwork"]
    nn_cfg["Architecture"].update(
        task_weights=[1.0],
        output_heads={"node": {"num_headlayers": 2, "dim_headlayers": [10, 10],
                               "type": "mlp_per_node"}})
    nn_cfg["Variables_of_interest"].update(output_names=["forces"], output_index=[2],
                                           type=["node"])
    return config


def run_mlp_per_node(graphs, device):
    """``mlp_per_node``: one served batch and one f32 step's gradients
    through K1 against its plain version. Returns the launches."""
    import torch

    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train import make_train_step

    label = "mlp_per_node"
    done, (loader, _, _), _ = prepare_data(mlp_per_node_config(),
                                           split_dataset(graphs, 0.9, seed=0))
    loader.set_epoch(0)
    batch = next(iter(loader))
    model = create_model(done, device=device, seed=SEED)
    head = model.heads_NN[0].VmapMLP_0.Dense_0.weight
    print(f"{label}: GIN hidden 256, 2 conv layers, per-node MLP bank {tuple(head.shape)} "
          f"(branches, node positions, out, in)", flush=True)
    launched = collections.Counter(served_batch_gate(
        label, model, batch.to(device), MLP_PER_NODE_PER_UNIT, SMALL_SERVE_RTOL))
    wrappers = _wrappers()
    _zero_launches(wrappers)
    grads = route_gradients(model, batch, device, {"kernels": ((), None)},
                            lambda st: (lambda b: make_train_step(st.model)(st, b)))
    torch.cuda.synchronize()
    launched.update(_check_launches(f"{label} f32 step", wrappers, MLP_PER_NODE_STEP, 1))
    grads.update(route_gradients(model, batch, device,
                                 {"plain": (("K1",), None),
                                  "the plain route again": (("K1",), None)},
                                 lambda st: (lambda b: make_train_step(st.model)(st, b))))
    gradients_present(f"{label}: f32 step 0", grads["kernels"], grads["plain"])
    grad_gate("f32 gradients vs plain route", grads["kernels"], grads["plain"],
              MLP_PER_NODE_GRAD_RTOL, {"the plain route again": grads["the plain route again"]},
              cell=label)
    return launched


# oc20_config and lsms_config: the committed example recipes run from their
# JSON alone, through run_training(config), run_prediction(config) and
# run_server(config) with no explicit datasets. oc20_config is
# OC20_JSON with its example script's --production overrides (EGNN hidden 866, 4
# conv layers: the SC25 shape; f32, energy-force, packed batch 16, AdamW)
# on OC20_CONFIG_GRAPHS OC20-shaped graphs written by the port's
# ColumnarWriter and read in mmap mode; lsms_config is LSMS_JSON (PNA
# hidden 16 x 4, one graph and two node heads, f32) on LSMS_CONFIGS FePt
# LSMS text files converted to formation Gibbs energies by data/lsms.py.
# Cut: CONFIG_EPOCHS epochs of the JSONs' 10 and 20; the generators stand
# in for the recipes' datasets, which are not in the repo.
OC20_JSON = "examples/open_catalyst_2020/open_catalyst_2020.json"
LSMS_JSON = "examples/lsms/lsms.json"
OC20_CONFIG_GRAPHS = 512
LSMS_CONFIGS = 96
CONFIG_EPOCHS = 2
CONFIG_STEPS = 4  # the first steps whose losses the gates hold
# launches per train step, eval batch and served batch (f32 throughout):
# with equivariance off every EGNN layer takes K2 (none takes K1); PNA's
# conv layer 0 sums at the input width (one feature), layers 1-3 at 16
CONFIG_PER_STEP = {"oc20_config": {"K2": {"float32/866x866": 4}},
                   "lsms_config": {"K3": {"float32/C1": 1, "float32/C16": 3}}}
# the kernel route against the same steps through the plain versions: the
# egnn_train cell's energy-force limits (step 0's loss, forces per atom and
# gradients) and its trajectory limit for the later steps; pnaplus_train's
# f32 gradient and trajectory limits for lsms_config, whose step-0 loss is
# held to the trajectory limit
CONFIG_RTOL = {
    "oc20_config": {"loss": TRAIN_RTOL["energy-force loss"],
                    "forces": TRAIN_RTOL["energy-force forces"],
                    "gradients": TRAIN_RTOL["energy-force gradients"],
                    "trajectory": TRAIN_RTOL["trajectory"]},
    "lsms_config": {"loss": PNAPLUS_TRAIN_RTOL["trajectory"],
                    "gradients": PNAPLUS_TRAIN_RTOL["f32 gradients"],
                    "trajectory": PNAPLUS_TRAIN_RTOL["trajectory"]},
}
def _rounded_f64(fn):
    """``fn`` evaluated in f64 and its outputs rounded back to its inputs'
    floating dtype: a kernel's plain version with correctly rounded sums."""
    import torch

    def call(*args, **kw):
        floats = [a for a in (*args, *kw.values())
                  if isinstance(a, torch.Tensor) and a.is_floating_point()]

        def up(a):
            return a.double() if isinstance(a, torch.Tensor) and a.is_floating_point() else a

        out = fn(*map(up, args), **{k: up(v) for k, v in kw.items()})
        down = (lambda o: o.to(floats[0].dtype) if o.is_floating_point() else o)
        return tuple(map(down, out)) if isinstance(out, tuple) else down(out)

    return call


# the kernel of each phase whose plain version, in f64 and rounded back,
# is the phase's rounding draw
CONFIG_KERNEL = {"oc20_config": "K2", "lsms_config": "K3"}
LSMS_Z = (26.0, 78.0)  # Fe, Pt
LSMS_PURE_ENERGY = (-3.2, -5.1)  # per atom, Rydberg


def write_lsms_raw(dir_path: Path, num_configs: int, seed: int = 11) -> None:
    """FePt BCC supercells (2 x 2 x 2 cells, 16 sites) as LSMS text files,
    as examples/lsms/lsms.py writes them: the header the total energy, one
    row per atom [Z, q, x, y, z, charge density, magnetic moment];
    configurations 0 and 1 pure Fe and pure Pt, the rest random
    occupations with closed-form targets."""
    import numpy as np

    dir_path.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    a = 2.85
    cells = np.array([(x, y, z) for x in range(2) for y in range(2) for z in range(2)], float)
    sites = np.concatenate([cells, cells + 0.5]) * a
    n = sites.shape[0]
    z_fe, z_pt = LSMS_Z
    for i in range(num_configs):
        if i < 2:
            zs = np.full(n, LSMS_Z[i])
        else:
            zs = np.where(rng.random(n) < rng.uniform(0.1, 0.9), z_fe, z_pt)
        x_fe = float(np.mean(zs == z_fe))
        enthalpy = -4.0 * 0.8 * x_fe * (1.0 - x_fe) * n / 16.0
        total = float(np.sum(np.where(zs == z_fe, *LSMS_PURE_ENERGY))) + enthalpy
        pos = sites + rng.normal(0.0, 0.03, sites.shape)
        q_net = np.where(zs == z_fe, -0.2 * (1 - x_fe), 0.2 * x_fe)
        rho = zs + q_net  # the raw charge density includes the proton count
        moment = np.where(zs == z_fe, 2.2, 0.35)
        with open(dir_path / f"config_{i:04d}.txt", "w") as f:
            f.write(f"{total!r} 0.0\n")
            for k in range(n):
                f.write(f"{zs[k]:.1f} 0.0 {pos[k, 0]:.6f} {pos[k, 1]:.6f} {pos[k, 2]:.6f} "
                        f"{rho[k]:.6f} {moment[k]:.4f}\n")


def config_phase_data(root: Path):
    """The data of oc20_config and lsms_config under ``root``, written by
    the port's own writers, and each phase's config: the committed JSON
    with the phase's overrides and the data's path. Returns {label:
    config}."""
    from hydragnn_tpu_torch.data import (
        ColumnarWriter,
        convert_total_energy_to_formation_gibbs,
        oc20_shaped_dataset,
    )

    t0 = time.perf_counter()
    oc20 = json.loads((REPO / OC20_JSON).read_text())
    arch = oc20["NeuralNetwork"]["Architecture"]
    arch.update(hidden_dim=866, num_conv_layers=4)  # the example script's --production
    path = root / "oc20_columnar"
    ColumnarWriter(str(path)).add(oc20_shaped_dataset(
        OC20_CONFIG_GRAPHS, radius=arch["radius"], max_neighbours=arch["max_neighbours"])).save()
    oc20["Dataset"]["path"]["total"] = str(path)
    oc20_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lsms = json.loads((REPO / LSMS_JSON).read_text())
    write_lsms_raw(root / "FePt_raw", LSMS_CONFIGS)
    converted = convert_total_energy_to_formation_gibbs(str(root / "FePt_raw"), LSMS_Z,
                                                        create_plots=False)
    lsms["Dataset"]["path"]["total"] = converted.output_dir
    gibbs = converted.formation_gibbs_energies
    print(f"config data: {OC20_CONFIG_GRAPHS} OC20-shaped graphs written by ColumnarWriter in "
          f"{oc20_s:.2f} s; {LSMS_CONFIGS} LSMS files written and converted to formation Gibbs "
          f"energies ([{gibbs.min():.4f}, {gibbs.max():.4f}] Ry) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for config in (oc20, lsms):
        config["NeuralNetwork"]["Training"]["num_epoch"] = CONFIG_EPOCHS
    return {"oc20_config": oc20, "lsms_config": lsms}


def config_kernel_cases(batches, device):
    """K2 at oc20_config's first packed batch (f32, 866 x 866, its backward
    timed: the energy-force step differentiates through it twice) and K3
    at lsms_config's first batch (PNA's variant in f32 at 1 and 16
    channels), named ``oc20/`` and ``lsms/``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    b = batches["oc20_config"]
    cases = [_k2_case(b.receivers.to(device), b.num_nodes, b.num_edges, torch.float32, gen,
                      "oc20/")]
    b = batches["lsms_config"]
    for c in (1, 16):
        cases.append(_k3_pna_case(b.receivers.to(device), b.node_mask.to(device), b.num_nodes,
                                  b.num_edges, c, torch.float32, gen, "lsms/")[0])
    return cases


def example_kernel_cases(batches, device):
    """The data_plane recipes' kernels at their first train batches (f32),
    named ``ani1x/`` and ``csce/``: K1 at ANI-1x's hidden width and at the
    coordinates' 3 channels and K2 at hidden x hidden (EGNN); K3 at CSCE's
    input width and hidden width (PNA's variant)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    cases = []
    for label, (config, b) in batches.items():
        nn_cfg = config["NeuralNetwork"]
        hidden = nn_cfg["Architecture"]["hidden_dim"]
        prefix = f"{label.split('_')[0]}/"
        ids = b.receivers.to(device)
        if label == "ani1x_config":
            cases += [_k1_case(ids, b.edge_mask.to(device), b.num_nodes, c, torch.float32, gen,
                               c, prefix) for c in (hidden, 3)]
            cases.append(_k2_case(ids, b.num_nodes, b.num_edges, torch.float32, gen, prefix,
                                  hidden, hidden))
        else:
            width = len(nn_cfg["Variables_of_interest"]["input_node_features"])
            cases += [_k3_pna_case(ids, b.node_mask.to(device), b.num_nodes, b.num_edges, c,
                                   torch.float32, gen, prefix)[0] for c in (width, hidden)]
    return cases


def read_back(label: str, config):
    """The phase's own read of its data into model-ready graphs, with the
    port's readers: the columnar dataset (its ``Dataset.mode``) with the
    input columns selected (energy-force: no min-max), or the LSMS files
    with their radius graphs, min-max normalized, the variables
    extracted."""
    from hydragnn_tpu_torch.config import voi_from_config
    from hydragnn_tpu_torch.data import (
        ColumnarDataset,
        MinMax,
        extract_variables,
        finalize_graphs,
        load_raw_dataset,
        select_input_columns,
    )

    ds, arch = config["Dataset"], config["NeuralNetwork"]["Architecture"]
    voi = voi_from_config(config)
    if label == "oc20_config":
        dataset = ColumnarDataset(ds["path"]["total"], mode=ds.get("mode", "mmap"))
        graphs = [select_input_columns(g, voi) for g in dataset]
        dataset.close()
        return graphs
    nf, gf = ds["node_features"], ds["graph_features"]
    raw = finalize_graphs(
        load_raw_dataset(ds["path"]["total"], "LSMS", node_feature_cols=nf["column_index"],
                         node_feature_dims=nf["dim"], graph_feature_cols=gf["column_index"],
                         graph_feature_dims=gf["dim"],
                         charge_density_correction=ds["charge_density_correction"]),
        radius=arch["radius"], max_neighbours=arch["max_neighbours"])
    return [extract_variables(g, voi) for g in MinMax.fit(raw).apply(raw)]


def same_batches(a, b) -> bool:
    """Two GraphBatches hold the same arrays, bit for bit."""
    import torch

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, dict):
            if x.keys() != y.keys() or not all(torch.equal(x[k], y[k]) for k in x):
                return False
        elif isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype and torch.equal(x, y)):
                return False
        elif x != y:
            return False
    return True


@contextlib.contextmanager
def step_probe(losses: list, seconds: list, graphs: list):
    """Within the block, every train step that ``train_validate_test``
    builds records its loss (on the device), its seconds (synchronized at
    both ends) and its real graphs."""
    import torch

    import hydragnn_tpu_torch.train.loop as loop

    make_step = loop.make_train_step

    def probed(model, *a, **kw):
        step = make_step(model, *a, **kw)

        def run(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            losses.append(out[1].detach().clone())
            graphs.append(int(batch.graph_mask.sum()))
            return out

        return run

    with swapped([(loop, "make_train_step", probed)]):
        yield


def run_config_phase(label: str, config, device, n_requests: int):
    """One committed example recipe from its JSON alone (``config``: the
    JSON with the phase's overrides, written to ``<label>.json`` and passed
    to ``run_training`` as a path):

    - ``prepare_data(config)`` against ``prepare_data(config, datasets)`` on
      the graphs the phase read back (``read_back``) and split itself: the
      same completed config, and every batch of every split (the train
      loader's of each epoch) the same, bit for bit;
    - ``run_training(config)`` (CONFIG_EPOCHS epochs, no device given) and
      ``run_training`` on the explicit datasets (1 epoch: a distinct log
      name), both under PyTorch's deterministic algorithms: their first
      CONFIG_STEPS losses equal; launches per step and eval batch; the
      completed config written to the run directory;
    - the first CONFIG_STEPS steps through the kernels against the same
      steps through the plain versions (``CONFIG_RTOL``): step 0's loss
      and gradients (and forces, energy-force), the later steps' losses;
    - ``run_prediction(config)``: finite predictions, each head's MAE over
      the zero predictor's printed;
    - ``run_server(config)`` restored from the run's checkpoint: ``n_requests``
      test graphs, finite answers of every head, launches per batch.

    Prints the seconds of ``prepare_data``, ms per step and graphs/s
    trained, the peak memory, the served graphs/s and latency. Returns the
    launches by (kernel, case) of the three calls."""
    import numpy as np
    import torch

    from hydragnn_tpu_torch import api
    from hydragnn_tpu_torch.config import get_log_name_config
    from hydragnn_tpu_torch.data import split_dataset
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train import make_train_step, predict_energy_forces

    wrappers = _wrappers()
    per_step, rtol = CONFIG_PER_STEP[label], CONFIG_RTOL[label]
    training = config["NeuralNetwork"]["Training"]
    ef = bool(training.get("compute_grad_energy", False))
    ds = config["Dataset"]
    t0 = time.perf_counter()
    api._load_raw_dataset(copy.deepcopy(config))
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    done, loaders, mm = api.prepare_data(copy.deepcopy(config))
    prep_s = time.perf_counter() - t0
    splits = split_dataset(read_back(label, config), training["perc_train"], seed=0,
                           stratified=ds.get("compositional_stratified_splitting", False))
    t0 = time.perf_counter()
    done_e, loaders_e, mm_e = api.prepare_data(copy.deepcopy(config), splits)
    prep_e_s = time.perf_counter() - t0
    arch = done["NeuralNetwork"]["Architecture"]
    print(f"{label}: {ds['format']} data from {Path(ds['path']['total']).name} "
          f"({ds.get('mode', 'mmap') if ds['format'] == 'columnar' else 'text'}); "
          f"{arch['mpnn_type']} hidden {arch['hidden_dim']} x {arch['num_conv_layers']}, heads "
          f"{head_dims(arch)}, batch {done['NeuralNetwork']['Training']['batch_size']} (packed "
          f"{training.get('pack_batches', False)}), energy-force {ef}, sorted aggregation "
          f"{arch['use_sorted_aggregation']}, fused {arch['use_fused_edge_kernel']}, "
          f"equivariance {arch['equivariance']}; splits {[len(s) for s in splits]}, min-max "
          f"{'none' if mm is None else 'fitted'}; prepare_data from the config {prep_s:.2f} s "
          f"(the read alone {read_s:.2f} s; then validation, min-max, split, config completion "
          f"and the pad ladder), from the explicit datasets {prep_e_s:.2f} s", flush=True)
    check(arch["use_sorted_aggregation"] and arch["use_fused_edge_kernel"],
          f"{label}: config completion did not turn the kernels on")
    check(done == done_e, f"{label}: the completed configs differ")
    compared = 0
    for name, a, b in zip(("train", "val", "test"), loaders, loaders_e):
        for epoch in range(CONFIG_EPOCHS if name == "train" else 1):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            ba, bb = list(a), list(b)
            check(len(ba) == len(bb) and all(same_batches(x, y) for x, y in zip(ba, bb)),
                  f"{label}: the {name} batches of epoch {epoch} differ from the explicit "
                  "datasets'")
            compared += len(ba)
    print(f"{label}: prepare_data(config) and prepare_data(config, datasets): the same completed "
          f"config, the same {compared} batches bit for bit", flush=True)

    # run_training from the JSON's path, then on the explicit datasets
    cfg_path = Path(f"{label}.json").resolve()
    cfg_path.write_text(json.dumps(config))
    log_name = get_log_name_config(done)
    runs, caught = {}, []
    for run, (cfg, splits_in) in {"config": (str(cfg_path), None),
                                  "datasets": (dict(copy.deepcopy(config)), splits)}.items():
        if run == "datasets":
            cfg["NeuralNetwork"]["Training"]["num_epoch"] = 1
        losses, seconds, graphs = [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches(wrappers)
        t0 = time.perf_counter()
        with deterministic(caught), step_probe(losses, seconds, graphs):
            _, state, hist = api.run_training(cfg, datasets=splits_in, seed=SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        epochs = CONFIG_EPOCHS if run == "config" else 1
        units = int(state.step) + epochs * (len(loaders[1]) + len(loaders[2]))
        counts = _check_launches(f"{label} run_training ({run})", wrappers, per_step, units,
                                 "steps and eval batches")
        check(state.step.device.type == "cuda" and int(state.step) == len(losses)
              and int(state.skipped_steps) == 0
              and all(math.isfinite(v) for k in ("train", "val", "test") for v in hist[k]),
              f"{label}: run_training ({run}) did not train on the card")
        runs[run] = (torch.stack(losses).float().cpu().numpy(), seconds, graphs, wall,
                     torch.cuda.max_memory_allocated(), hist, counts)
    la, seconds, graphs, wall, peak, hist, counts = runs["config"]
    launched = collections.Counter(counts)
    lb = runs["datasets"][0]
    written = Path("logs") / log_name / "config.json"
    check(written.is_file() and json.loads(written.read_text()) == json.loads(json.dumps(done)),
          f"{label}: run_training did not write the completed config to {written}")
    n = CONFIG_STEPS
    print(f"{label}: run_training(config) {CONFIG_EPOCHS} epochs in {wall:.2f} s: {len(la)} "
          f"steps, history {hist}; step time (synchronized at both ends) median "
          f"{np.median(seconds[3:]) * 1e3:.2f} ms over steps 4-{len(la)}, "
          f"{sum(graphs[3:]) / sum(seconds[3:]):.1f} graphs/s trained; peak memory "
          f"{peak / 2**20:.1f} MiB; the first {n} losses {la[:n].tolist()}, on the explicit "
          f"datasets {lb[:n].tolist()}; deterministic algorithms, warnings "
          f"{sorted(set(caught))}", flush=True)
    check(len(la) >= n and len(lb) >= n and np.array_equal(la[:n], lb[:n]),
          f"{label}: the first {n} losses differ between the config's data and the explicit "
          "datasets")

    # the first steps through the kernels against the plain versions
    lr = training["Optimizer"]["learning_rate"]
    loaders[0].set_epoch(0)
    batches = list(loaders[0])[:n]
    model = create_model(done, device=device, seed=SEED)

    def make_step(st):
        return lambda b: make_train_step(st.model, compute_grad_energy=ef)(st, b)

    with deterministic():
        grads = route_gradients(model, batches[0], device,
                                {"kernels": ((), None), "plain": (PLAIN, None),
                                 "the plain route again": (PLAIN, None)}, make_step, lr=lr)
        gradients_present(f"{label}: step 0", grads["kernels"], grads["plain"])
        grad_gate("step-0 gradients vs plain route", grads["kernels"], grads["plain"],
                  rtol["gradients"], {"the plain route again": grads["the plain route again"]},
                  cell=label)
        del grads
        lk, lp, _, _, _, _, _ = trajectories(label, model, batches, device, make_step, PLAIN,
                                             per_step, lr=lr)
        # a rounding draw: the plain route with the kernel's plain version
        # evaluated in f64 and rounded back (its sums correctly rounded)
        state = _train_copy(model, device, lr=lr)
        step = make_step(state)
        mod, name, plain = plain_swaps()[CONFIG_KERNEL[label]]
        with swapped([(mod, name, _rounded_f64(plain))]):
            lc = np.asarray([float(step(b)[1]) for b in batches])
        del state, step
    step0 = abs(float(lk[0]) - float(lp[0])) / abs(float(lp[0]))
    print(f"{label}: step 0's loss through the kernels {lk[0]:.8g}, plain {lp[0]:.8g}, relative "
          f"{step0:.3g} (limit {rtol['loss']}); the kernel route's {n} losses equal "
          f"run_training's: {bool(np.array_equal(lk, la[:n]))}", flush=True)
    check(step0 <= rtol["loss"], f"{label}: step 0's loss disagrees with the plain route")
    # the later steps amplify a step's roundings (the loss may jump tenfold
    # from step to step at random init): the limit is the trajectory limit
    # or three times the rounding draw's largest distance, whichever is larger
    draw = float((np.abs(lc - lp) / np.abs(lp)).max())
    trajectory_gate(label, lk, lp, max(rtol["trajectory"], 3 * draw),
                    f"; the rounding draw {lc.tolist()}, largest relative {draw:.3g}")
    if ef:
        b = batches[0].to(device)
        forces = {}
        for route, swap in (("kernels", ()), ("plain", PLAIN)):
            m = copy.deepcopy(model).eval()
            with deterministic(), plain_versions(swap):
                forces[route] = predict_energy_forces(m, b, m.cfg)[1]
            del m
        mask = b.node_mask
        rows = ((forces["kernels"] - forces["plain"])[mask].abs().max(dim=1).values
                / float(forces["plain"][mask].abs().max()))
        lim = rtol["forces"]
        print(f"{label}: forces at the initial weights (eval), kernels vs plain: largest row "
              f"{float(rows.max()):.6g}, median row {float(rows.median()):.6g} (limits {lim})",
              flush=True)
        check(float(rows.max()) <= lim[0] and float(rows.median()) <= lim[1],
              f"{label}: the forces disagree with the plain route")
    del model

    # run_prediction and run_server from the run's checkpoint
    _zero_launches(wrappers)
    t0 = time.perf_counter()
    tot, _, preds, trues = api.run_prediction(copy.deepcopy(config))
    pred_s = time.perf_counter() - t0
    launched.update(_check_launches(f"{label} run_prediction", wrappers, per_step,
                                    len(loaders[2]), "batches"))
    ratios = {k: float(np.abs(preds[k] - trues[k]).mean() / np.abs(trues[k]).mean())
              for k in preds}
    print(f"{label}: run_prediction(config) in {pred_s:.2f} s: test loss {tot:.6g}; MAE over the "
          f"zero predictor's by head {ratios}", flush=True)
    check(all(np.isfinite(v).all() for v in preds.values()) and math.isfinite(tot),
          f"{label}: non-finite predictions")
    t0 = time.perf_counter()
    server = api.run_server(copy.deepcopy(config))
    check(server.wait_ready(timeout=600), f"{label}: server warm-up failed: {server.failed}")
    ready_s = time.perf_counter() - t0
    test = splits[2]
    requests = [test[i % len(test)] for i in range(n_requests)]
    batches0 = server.stats()["batches"]
    _zero_launches(wrappers)
    t_start = time.perf_counter()
    handles = [server.submit(g) for g in requests]
    results = [h.result(timeout=600) for h in handles]
    t_end = max(h.done_at for h in handles)
    torch.cuda.synchronize()
    stats = server.stats()
    server.close()
    served = stats["batches"] - batches0
    launched.update(_check_launches(f"{label} run_server", wrappers, per_step, served, "batches"))
    check(stats["failed_batches"] == 0 and stats["rejected"] == 0 and served > 0,
          f"{label}: serving {stats}")
    check(stats["current_checkpoint"] is not None,
          f"{label}: the server did not restore the run's checkpoint")
    var = done["NeuralNetwork"]["Variables_of_interest"]
    for g, r in zip(requests, results):
        check(set(r) == set(var["output_names"]), f"{label}: served heads {sorted(r)}")
        for name, t in zip(var["output_names"], var["type"]):
            rows = 1 if t == "graph" else g.num_nodes
            check(r[name].reshape(rows, -1).shape[0] == rows and np.isfinite(r[name]).all(),
                  f"{label}: served {name} of shape {r[name].shape} for {g.num_nodes} nodes")
    lat = np.asarray([h.done_at - h.submitted_at for h in handles]) * 1e3
    print(f"{label}: run_server(config) ready in {ready_s:.2f} s from "
          f"{stats['current_checkpoint']}; {n_requests} requests in {served} batches, "
          f"{n_requests / (t_end - t_start):.1f} graphs/s, latency p50 "
          f"{np.percentile(lat, 50):.2f} ms p99 {np.percentile(lat, 99):.2f} ms", flush=True)
    return launched


# dist_gfm_train and dist_ranks: the multi-GPU slice. dist_gfm_train runs
# the GFM recipe at full width (batch 160, bf16) through the distributed
# step (parallel/engine.py) at a world of one rank over a real NCCL process
# group, for each unrouted preset, against make_train_step on the same
# batches under deterministic algorithms: every reduction is then the
# identity, so the two agree bit for bit (parameters, statistics, moments,
# losses). dist_run_training runs the entry point a user runs, `python -m
# hydragnn_tpu_torch.launch --nprocs 1 -- ...` calling run_training on the
# recipe with gfm_zero3.json's legacy key zero_stage 3: the launcher
# (torchrun), setup_distributed joining a group of one over NCCL,
# resolve_parallel, the rank's loaders, the engine's step on the placed
# state, rank 0's config and checkpoint, then run_prediction from that
# checkpoint. dist_ranks runs processes that share the one card over gloo
# (NCCL refuses two ranks on one device; a collective gloo lacks fails the
# phase): 2 ranks under dp, zero1, zero2 and zero3 and 5 ranks under
# branch (one branch each), at batch 32 a rank (cut: the batch), each
# rank's parameters after its job's steps against one process that
# computes the real-graph-weighted mean of the same rows' gradients
# (encoder over every rank, each decoder branch from its own rank times
# its loss weight), elements a rounding can turn round (a step-0 gradient
# below 1e-6 of the largest, or a sum over the rows that cancels to within
# 1e-5 of its terms) bounded by 2 lr a step. Limits: parameters relative
# to the largest, at ~3x the chip's readings.
DIST_PRESETS = ("dp", "zero1", "zero2", "zero3")
DIST_GFM_STEPS = 4
DIST_RANKS_BATCH = 32
# (job, preset, ranks, optimizer, steps): the recipe's AdamW where the
# optimizer's own state is placed (ZeRO); branch under SGD,
# since Adam hides a branch's gradient weight (any constant factor cancels
# in m / sqrt(v)) and, from the second step on, turns the 5-term sum's
# order into +-lr flips that cascade (under AdamW for 3 steps this script
# read 4.83e-3 of the largest parameter, at an encoder weight); and branch
# under the recipe's AdamW for 1 step, where a flip can only come from a
# step-0 sum that rounds to either sign, which the emulation marks
DIST_SGD = {"type": "SGD", "learning_rate": 1e-3}
# (2 steps a job, cut from 3: PERF.md §4): the second step carries the
# sharded AdamW moments the first one stored
DIST_RANKS_JOBS = (("dp", "dp", 2, None, 2), ("zero1", "zero1", 2, None, 2),
                   ("zero2", "zero2", 2, None, 2), ("zero3", "zero3", 2, None, 2),
                   ("branch", "branch", 5, DIST_SGD, 2), ("branch_adamw", "branch", 5, None, 1))
DIST_LR = 1e-3  # the recipe's and DIST_SGD's: a noise element moves at most 2 lr a step
# largest relative difference, by job: 2 ranks add two terms, which
# commutes, so they equal the emulation bit for bit (0 in every run);
# branch's 5 terms sum in gloo's order: 1.65e-7 in two runs (readings from
# this script on an H100, NVIDIA H100 80GB HBM3, 700 W), the limit 3x;
# branch_adamw 1.33e-7 (one run), the same limit
DIST_RANKS_RTOL = {"dp": 0.0, "zero1": 0.0, "zero2": 0.0, "zero3": 0.0, "branch": 5e-7,
                   "branch_adamw": 5e-7}
DIST_NOISE = 1e-6
DIST_RANKS_TIMEOUT = 420.0
DIST_RUN_GRAPHS = 360  # 324 train graphs: 2 batches of 160 and a short one (cut from 720: PERF.md §4)
DIST_RUN_TIMEOUT = 300.0
# run_prediction's loss from the saved checkpoint against the run's own
# last test loss (the same model, batches and kernels), relative: 0 in five
# runs (NVIDIA H100 80GB HBM3, 700 W), so equal
DIST_RUN_RTOL = 0.0


def _payload_diff(a, b):
    """(tensors that differ, largest absolute difference) of two payloads'
    model and optimizer state."""
    import torch

    pairs = [(f"model/{k}", v, b["model"][k]) for k, v in a["model"].items()]
    for i, st in a["optimizer"]["state"].items():
        pairs += [(f"opt/{i}/{k}", torch.as_tensor(v), torch.as_tensor(b["optimizer"]["state"][i][k]))
                  for k, v in st.items()]
    bad = [n for n, x, y in pairs if not torch.equal(x, y)]
    top = max((float((x.double() - y.double()).abs().max()) for n, x, y in pairs if n in bad),
              default=0.0)
    return bad, top


def run_dist_gfm_train(graphs, device):
    """``dist_gfm_train``: the GFM recipe at full width through the
    distributed step of every unrouted preset at a world of one rank over
    NCCL, against ``make_train_step``; ms per step, peak memory, K1/K2
    launches per step. Returns the launches (the gfm/ cases' shapes)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.parallel import (Grid, Objective, init_group, make_mesh_train_step,
                                             place_state)
    from hydragnn_tpu_torch.parallel import rules as R
    from hydragnn_tpu_torch.train import TrainState, make_optimizer, make_train_step
    from hydragnn_tpu_torch.utils.ranks import free_port

    label = "dist_gfm_train"
    t0 = time.perf_counter()
    done, (loader, _, _), _ = prepare_data(gfm_config(), split_dataset(graphs, 0.9, seed=0))
    loader.set_epoch(0)
    batches = [b for _, b in zip(range(DIST_GFM_STEPS), loader)]
    opt_cfg = done["NeuralNetwork"]["Training"]["Optimizer"]
    model = create_model(done, device=device, seed=SEED)
    init_group(1, 0, f"tcp://127.0.0.1:{free_port()}", device=device, timeout_s=300)
    print(f"{label}: NCCL {torch.cuda.nccl.version()}, world {dist.get_world_size()}, backend "
          f"{dist.get_backend()}; GFM recipe, batch {int(batches[0].graph_mask.sum())}, "
          f"{len(batches)} steps a preset, deterministic algorithms", flush=True)
    wrappers = _wrappers()
    launched = collections.Counter()
    try:
        with deterministic():
            runs = {}
            for preset in (None,) + DIST_PRESETS:
                m = copy.deepcopy(model)
                state = TrainState.create(m, make_optimizer(m, opt_cfg))
                if preset is None:
                    plain = make_train_step(m, mixed_precision=True)
                    step = plain
                else:
                    table = R.preset(preset)
                    state = place_state(state, table, Grid())
                    step = make_mesh_train_step(Objective(mixed_precision=True), table)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _zero_launches(wrappers)
                walls, losses = [], []
                for b in batches:
                    t1 = time.perf_counter()
                    state, tot, _ = step(state, b)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t1)
                    losses.append(float(tot))
                name = preset or "make_train_step"
                got = _check_launches(f"{label} {name}", wrappers, TRAIN_PER_STEP, len(batches))
                if preset is not None:
                    launched.update(got)
                peak = torch.cuda.max_memory_allocated() / 2**20
                shards = len(state.placement.shards) if preset else 0
                runs[name] = (state.to_payload(), losses, float(np.median(walls[1:])) * 1e3)
                print(f"{label}: {name}: {runs[name][2]:.2f} ms per step (median of steps "
                      f"2-{len(batches)}), peak {peak:.1f} MiB, {shards} leaves sharded, "
                      f"losses {losses}", flush=True)
                del state, step, m
            want = runs.pop("make_train_step")
            for name, (payload, losses, ms) in runs.items():
                bad, top = _payload_diff(payload, want[0])
                print(f"{label}: {name} vs make_train_step: {len(bad)} tensors differ "
                      f"(largest {top:.3g}), losses equal {losses == want[1]}; {ms:.2f} against "
                      f"{want[2]:.2f} ms per step", flush=True)
                check(not bad and losses == want[1],
                      f"{label}: {name} is not make_train_step's step bit for bit: {bad[:4]}")
    finally:
        dist.destroy_process_group()
    print(f"{label}: phase in {time.perf_counter() - t0:.1f} s", flush=True)
    return launched


def dist_run_rank(out: str) -> None:
    """The rank that ``dist_run_training``'s launcher starts: the GFM recipe
    with ``zero_stage`` 3 through ``run_training`` (1 epoch) and
    ``run_prediction``, each from the config as a user passes it. Writes
    what the phase checks to ``out`` (JSON)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from hydragnn_tpu_torch.api import run_prediction, run_training
    from hydragnn_tpu_torch.config import get_log_name_config
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.parallel import rules as R
    from hydragnn_tpu_torch.train.checkpoint import SUFFIX

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = gfm_config(num_epoch=1)
    config["NeuralNetwork"]["Training"]["Optimizer"]["zero_stage"] = 3
    splits = split_dataset(gfm_dataset(DIST_RUN_GRAPHS), 0.9, seed=0)
    wrappers = _wrappers()
    _zero_launches(wrappers)
    t0 = time.perf_counter()
    _, state, hist = run_training(copy.deepcopy(config), datasets=splits, seed=SEED)
    torch.cuda.synchronize()
    res = {"train_s": time.perf_counter() - t0, "backend": dist.get_backend(),
           "world": dist.get_world_size(), "device": torch.cuda.current_device(),
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
           "launches": {k: dict(w.launches_by_case) for k, w in wrappers.items()},
           "losses": hist["train"] + hist["val"] + hist["test"]}
    pl = state.placement
    res["shards"] = 0 if pl is None else len(pl.shards)
    res["stored_sharded"] = 0 if pl is None else sum(s.store_sharded for s in pl.shards)
    run_dir = Path("logs") / get_log_name_config(config)
    saved = json.loads((run_dir / "config.json").read_text())
    recorded = saved.get("Parallel", {}).get("resolved_rules")
    res["resolved_rules"] = recorded
    res["shards_params"] = bool(recorded) and R.table_from_recorded(recorded).shards("params")
    res["checkpoint_bytes"] = sum(p.stat().st_size for p in run_dir.iterdir()
                                  if p.suffix == SUFFIX)
    res["files"] = sorted(p.name for p in run_dir.iterdir())
    tot, _, preds, _ = run_prediction(copy.deepcopy(config), datasets=splits)
    res["prediction"] = {"loss": float(tot), "finite": all(
        bool(np.isfinite(np.asarray(p)).all()) for p in preds.values()),
        "rows": {k: list(np.asarray(p).shape) for k, p in preds.items()}}
    res["test_graphs"] = len(splits[2])
    Path(out).write_text(json.dumps(res))
    dist.destroy_process_group()


def start_dist_run_training():
    """Start ``dist_run_training``'s launch (``python -m
    hydragnn_tpu_torch.launch --nprocs 1`` running ``dist_run_rank`` on the
    card) and return it: it runs beside ``dist_ranks`` (no timing gate
    in either), and ``run_dist_run_training`` waits for it."""
    out = Path.cwd() / "dist_run.json"
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); import chip_smoke; "
            f"chip_smoke.dist_run_rank({str(out)!r})")
    cmd = [sys.executable, "-m", "hydragnn_tpu_torch.launch", "--nprocs", "1", "--",
           sys.executable, "-c", code]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.Popen(cmd, env=env, start_new_session=True), out, time.perf_counter()


def run_dist_run_training(started):
    """``dist_run_training``: the launch ``start_dist_run_training`` made.
    Checks that the rank joined a group of one over NCCL, trained through
    the placed zero3 state with K1 and K2, recorded
    ``Parallel.resolved_rules`` in the saved config, wrote the checkpoint,
    and that ``run_prediction`` from it gives finite answers for every test
    graph. Returns the launches."""
    import signal

    label = "dist_run_training"
    proc, out, t0 = started
    try:
        rc = proc.wait(timeout=max(DIST_RUN_TIMEOUT - (time.perf_counter() - t0), 1.0))
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        if proc.poll() is None or rc is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    check(rc == 0, f"{label}: the launched rank exited {rc} (None: past "
                   f"{DIST_RUN_TIMEOUT} s)")
    res = json.loads(out.read_text())
    launches = {k: {c: n for c, n in v.items() if n} for k, v in res["launches"].items()}
    print(f"{label}: launch --nprocs 1 -> run_training: backend {res['backend']}, world "
          f"{res['world']}, cuda:{res['device']}; {res['shards']} leaves placed, "
          f"{res['stored_sharded']} stored sharded (zero3); 1 epoch in {res['train_s']:.1f} s "
          f"(train, val, test losses {res['losses']}), peak {res['peak_mib']:.1f} MiB; "
          f"Parallel.resolved_rules {json.dumps(res['resolved_rules'])}; run directory "
          f"{res['files']}, checkpoint {res['checkpoint_bytes']} bytes; run_prediction from it: "
          f"loss {res['prediction']['loss']:.6g}, rows {res['prediction']['rows']}; K1/K2 "
          f"launches {launches}; phase in {time.perf_counter() - t0:.1f} s", flush=True)
    check(res["backend"] == "nccl" and res["world"] == 1,
          f"{label}: the rank did not join a group of one over NCCL")
    check(res["stored_sharded"] > 0, f"{label}: the state was not placed by the zero3 table")
    check(res["shards_params"], f"{label}: the saved config records no zero3 table")
    check(res["checkpoint_bytes"] > 0, f"{label}: rank 0 wrote no checkpoint")
    check(all(math.isfinite(x) for x in res["losses"]) and res["prediction"]["finite"]
          and all(r[0] == res["test_graphs"] for n, r in res["prediction"]["rows"].items()
                  if n == "energy"),
          f"{label}: non-finite losses or predictions, or not one energy per test graph")
    test_loss, pred_loss = res["losses"][-1], res["prediction"]["loss"]
    rel = abs(pred_loss - test_loss) / max(abs(test_loss), 1e-30)
    print(f"{label}: run_prediction's loss against the run's last test loss {test_loss:.9g}: "
          f"{rel:.3g} relative (limit {DIST_RUN_RTOL})", flush=True)
    check(rel <= DIST_RUN_RTOL, f"{label}: run_prediction from the checkpoint parts from the run")
    check(all(launches.get(k) for k in TRAIN_PER_STEP),
          f"{label}: the run launched no {[k for k in TRAIN_PER_STEP if not launches.get(k)]}")
    return collections.Counter({(k, c): n for k, v in launches.items() for c, n in v.items()})


def _dist_rows(train, preset, world, steps):
    """Per step, each rank's graphs: consecutive blocks of the train split,
    or (branch) each rank the next block of its branch."""
    if preset == "branch":
        by = [[g for g in train if g.dataset_id == b] for b in range(world)]
        return [[by[r][s * DIST_RANKS_BATCH:(s + 1) * DIST_RANKS_BATCH] for r in range(world)]
                for s in range(steps)]
    return [[train[(s * world + r) * DIST_RANKS_BATCH:(s * world + r + 1) * DIST_RANKS_BATCH]
             for r in range(world)] for s in range(steps)]


def _emulated(job, device):
    """One process's reading of the distributed steps: each row's gradients
    and batch-norm statistics from the same starting state, combined with
    the world's weights, then the optimizer. Under ``branch`` row r's
    gradients come from a one-branch copy of the model holding branch r's
    decoders (the shape a rank computes: five branches decoded at once
    round differently in bf16): the encoder's weighted by the rows' real
    graphs, branch r's decoders by its loss weight alone. Returns the whole
    model's state dict and, per parameter, the elements whose update a
    rounding can turn round (on the CPU): a step-0 gradient of rounding
    noise (below ``DIST_NOISE`` of the largest), or, at any step, a sum
    over the rows that cancels to within 1e-5 of its terms' sizes (the
    ranks add in another order, and Adam moves such an element by about lr
    either way)."""
    import torch

    from hydragnn_tpu_torch.data.graph import batch_graphs
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train import make_optimizer, optimizer_step
    from hydragnn_tpu_torch.train.loop import _apply_fn, cast_batch_bf16
    from hydragnn_tpu_torch.train.loss import compute_loss

    done = job["config"]
    model = create_model(done, device=device, seed=SEED)
    model.load_state_dict(torch.load(job["init"]))
    opt = make_optimizer(model, job["optimizer"])
    weights = done["NeuralNetwork"]["Architecture"].get("branch_loss_weights") or []
    routed = job["preset"] == "branch"
    # the model a row runs through, and its tensors' slices of the whole one's
    row_model = model
    if routed:
        row_model = type(model)(dataclasses.replace(
            model.cfg, num_branches=1, branch_loss_weights=None,
            branch_loss_metrics=False)).to(device).train()
    decoder = lambda name: routed and name.split(".")[0] in ("graph_shared", "heads_NN")  # noqa

    def part(name, t, r):  # a decoder bank's branch r, [1, ...]
        return t[r:r + 1] if decoder(name) else t

    whole = dict(model.state_dict(keep_vars=True))
    keep = set(whole)
    named = [(n, p) for n, p in model.named_parameters()]
    row_named = list(row_model.named_parameters())
    bufs = [(n, b) for n, b in model.named_buffers() if n in keep and b.is_floating_point()]
    row_bufs = dict(row_model.named_buffers())
    apply = _apply_fn(row_model, True, cast_buffers=False)
    quiet = None
    model.train()
    for rows in job["rows"]:
        start = {n: b.clone() for n, b in bufs}
        n = [float(len(r)) for r in rows]
        acc = {name: torch.zeros_like(p) for name, p in named}
        size = {name: torch.zeros_like(p) for name, p in named}  # the terms' sizes
        sacc = {name: torch.zeros_like(b) for name, b in bufs}
        for r, graphs in enumerate(rows):
            with torch.no_grad():
                if routed:
                    for name, t in row_model.state_dict(keep_vars=True).items():
                        src = start[name] if name in start else whole[name]
                        t.data.copy_(part(name, src.data, r))
                else:
                    for name, b in bufs:
                        b.copy_(start[name])
            batch = batch_graphs(graphs, job["spec"], sort_edges=True)
            if routed:
                batch = batch.replace(dataset_id=torch.zeros_like(batch.dataset_id))
            batch = cast_batch_bf16(batch.to(device))
            for _, p in row_named:
                p.grad = None
            tot, _, _ = compute_loss(apply, batch, row_model.cfg, False)
            tot.float().backward()
            with torch.no_grad():
                for name, p in row_named:
                    if p.grad is None:
                        continue
                    if decoder(name):  # branch r's decoder: its rank alone
                        term = p.grad * weights[r]
                        part(name, acc[name], r).add_(term)
                        part(name, size[name], r).add_(term.abs())
                    else:
                        term = p.grad * (n[r] / sum(n))
                        acc[name].add_(term)
                        size[name].add_(term.abs())
                for name, _ in bufs:
                    b = row_bufs[name] if routed else whole[name]
                    sacc[name].add_(b * (n[r] / sum(n)))
        with torch.no_grad():
            grads = [acc[name] for name, _ in named]
            for (_, p), g in zip(named, grads):
                p.grad = g
            for name, b in bufs:
                b.copy_(sacc[name])
            cancels = {name: acc[name].abs() < 1e-5 * size[name] for name, _ in named}
            if quiet is None:
                top = max(float(a.abs().max()) for a in acc.values())
                quiet = {name: (acc[name].abs() < DIST_NOISE * top).cpu() for name, _ in named}
            for name, _ in named:
                quiet[name] |= cancels[name].cpu()
            optimizer_step(opt, grads)
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}, quiet


def _dist_rank(rank, world, store, job_paths, out_dir):
    """One rank of ``dist_ranks``: joins the gloo group on the card and, for
    each job in turn, places the job's initial state by its preset, takes
    its rows' steps, and compares its own tensors with the emulation's."""
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from hydragnn_tpu_torch.parallel import init_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the ranks share the host's cores: one rank's intra-op threads each
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    device = torch.device(torch.load(job_paths[0], weights_only=False)["device"])
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    init_group(world, rank, f"file://{store}", device=device, backend="gloo", timeout_s=300)
    try:
        for job_path in job_paths:
            _dist_rank_job(rank, torch.load(job_path, weights_only=False), device, sync,
                           Path(out_dir))
            dist.barrier()
    finally:
        dist.destroy_process_group()


def _dist_rank_job(rank, job, device, sync, out_dir):
    """One job of ``_dist_rank``; its result goes to
    ``out_dir/<job>/rank<r>.json``."""
    import torch

    from hydragnn_tpu_torch.data.graph import batch_graphs
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.parallel import Grid, Objective, make_mesh_train_step, place_state
    from hydragnn_tpu_torch.parallel import rules as R
    from hydragnn_tpu_torch.train import TrainState, make_optimizer
    from hydragnn_tpu_torch.train.optimizer import state_tensors

    out = {"rank": rank}
    try:
        done = job["config"]
        model = create_model(done, device=device, seed=SEED)
        model.load_state_dict(torch.load(job["init"]))
        table = R.preset(job["preset"], num_branches=len(
            done["NeuralNetwork"]["Architecture"]["output_heads"]["graph"]))
        grid = Grid(table.model_size if table.routed else 1)
        state = place_state(TrainState.create(model, make_optimizer(model, job["optimizer"])),
                            table, grid)
        step = make_mesh_train_step(Objective(mixed_precision=True), table, grid)
        wrappers = _wrappers()
        _zero_launches(wrappers)
        walls = []
        with deterministic():
            for rows in job["rows"]:
                batch = batch_graphs(rows[rank], job["spec"], sort_edges=True)
                sync()
                t1 = time.perf_counter()
                state, tot, _ = step(state, batch)
                sync()
                walls.append(time.perf_counter() - t1)
        out["launches"] = {k: dict(w.launches_by_case) for k, w in wrappers.items()}
        out["ms"] = [w * 1e3 for w in walls]
        out["skipped"] = int(state.skipped_steps)
        out["opt_bytes"] = int(sum(t.numel() * t.element_size()
                                   for t in state_tensors(state.optimizer)))
        # a stage-3 leaf's parameters are empty between steps: its slice counts
        out["param_bytes"] = int(sum(t.numel() * t.element_size() for t in [
            *state.model.parameters(),
            *(s.local for s in state.placement.shards if s.store_sharded)]))
        pl = state.placement
        expected, quiet = job["expected"], job["quiet"]
        top = max(float(v.abs().max()) for k, v in expected.items() if k in quiet)
        rel = noise = 0.0
        worst = ("", 0.0)
        local = dict(state.model.state_dict())
        for s in pl.shards:  # a stage-3 leaf's parameters: this rank's slice
            if s.store_sharded:
                stream = torch.cat([expected[n].reshape(-1) for n in s.leaf.names])
                qs = torch.cat([quiet[n].reshape(-1) for n in s.leaf.names])
                got = s.local.detach().cpu()
                sl = slice(s.rank * s.c, (s.rank + 1) * s.c)
                err = (got - stream[sl]).abs()
                rel = max(rel, float(torch.where(qs[sl], 0.0, err).max()) / top)
                noise = max(noise, float(err.max()))
                for n in s.leaf.names:
                    local.pop(n, None)
        for lname, t in local.items():
            want = pl._local_from(lname, expected.__getitem__)
            err = (t.detach().float().cpu() - want.float()).abs()
            gname = pl.local_to_global.get(lname, lname)
            if gname in quiet:
                qs = pl._local_from(lname, quiet.__getitem__)
                e = float(torch.where(qs, 0.0, err).max()) / top
                if e > worst[1]:
                    i = int(torch.where(qs, 0.0, err).reshape(-1).argmax())
                    worst = (f"{lname}[{i}] got {float(t.reshape(-1)[i]):.6g} want "
                             f"{float(want.reshape(-1)[i]):.6g}", e)
                rel = max(rel, e)
                noise = max(noise, float(err.max()))
            else:  # batch-norm statistics
                rel = max(rel, float(err.max()) / max(float(want.abs().max()), 1e-30))
        out.update(rel=rel, noise=noise, worst=worst[0])
    finally:
        (out_dir / job["name"]).mkdir(exist_ok=True)
        (out_dir / job["name"] / f"rank{rank}.json").write_text(json.dumps(out))


def run_dist_ranks(graphs, device):
    """``dist_ranks``: the distributed step over processes that share the
    card through gloo, against one process's emulation of the same steps
    (``_emulated``); per preset each rank's largest relative parameter
    difference, ms per step, optimizer-state bytes and K1/K2 launches."""
    import torch
    import torch.multiprocessing as mp

    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.data.graph import PadSpec
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.models.create import create_model

    label = "dist_ranks"
    t0 = time.perf_counter()
    splits = split_dataset(graphs, 0.9, seed=0)
    done, _, _ = prepare_data(gfm_config(batch_size=DIST_RANKS_BATCH), splits)
    work = Path(tempfile.mkdtemp(prefix="dist_ranks_", dir=Path.cwd()))
    init = str(work / "init.pt")  # the seeded weights every job starts from
    torch.save({k: v.detach().cpu() for k, v in create_model(
        done, device=device, seed=SEED).state_dict().items()}, init)
    # every job of one world size in one spawn (one group): the processes'
    # start-up (~8 s each to reach the card) is paid once per world size
    groups = collections.defaultdict(list)
    for name, preset, world, optimizer, steps in DIST_RANKS_JOBS:
        rows = _dist_rows(splits[0], preset, world, steps)
        flat = [r for step_rows in rows for r in step_rows]
        spec = PadSpec(int(math.ceil((max(sum(g.num_nodes for g in r) for r in flat) + 1) / 8)) * 8,
                       int(math.ceil(max(sum(g.num_edges for g in r) for r in flat) / 128)) * 128,
                       DIST_RANKS_BATCH + 1)
        job = {"config": done, "init": init, "name": name, "preset": preset, "rows": rows,
               "spec": spec, "device": str(device),
               "optimizer": optimizer or done["NeuralNetwork"]["Training"]["Optimizer"]}
        with deterministic():
            job["expected"], job["quiet"] = _emulated(job, device)
        torch.save(job, work / f"{name}.pt")
        groups[world].append((name, job["optimizer"]["type"], steps))
    results = {}
    # every world size's group started at once (each its own store): the
    # processes' start-ups overlap
    t1 = time.perf_counter()
    started = {world: mp.start_processes(
        _dist_rank, args=(world, str(work / f"{world}.store"),
                          [str(work / f"{name}.pt") for name, _, _ in jobs], str(work)),
        nprocs=world, join=False, start_method="spawn") for world, jobs in groups.items()}
    deadline = time.monotonic() + DIST_RANKS_TIMEOUT
    for world, jobs in groups.items():
        ctx = started[world]
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                for c in started.values():
                    for p in c.processes:
                        p.kill()
                fail(f"{label}: the {world} ranks did not finish in {DIST_RANKS_TIMEOUT} s")
        for name, kind, steps in jobs:
            results[name] = (world, kind, steps, [json.loads(
                (work / name / f"rank{r}.json").read_text()) for r in range(world)])
            (work / f"{name}.pt").unlink()
        print(f"{label}: {len(jobs)} jobs over {world} ranks done {time.perf_counter() - t1:.1f} s "
              "after the groups' start (the processes' start included)", flush=True)
    for name, (world, kind, steps, res) in results.items():
        for r in res:
            want = {k: {c: n * steps for c, n in per.items()}
                    for k, per in TRAIN_PER_STEP.items()}
            got = {k: v for k, v in r["launches"].items() if v}
            check(got == want, f"{label}: {name} rank {r['rank']}: launches {got}, "
                               f"expected {want}")
            check(r["skipped"] == 0, f"{label}: {name} rank {r['rank']} skipped steps")
        rels = [r["rel"] for r in res]
        noise = max(r["noise"] for r in res)
        mean_ms = [round(sum(r["ms"][1:] or r["ms"]) / len(r["ms"][1:] or r["ms"]), 2)
                   for r in res]
        print(f"{label}: {name} over {world} ranks sharing the card (gloo), {kind}, {steps} "
              f"steps: parameters and statistics vs the one-process emulation, largest "
              f"relative per rank {[f'{x:.3g}' for x in rels]} (limit "
              f"{DIST_RANKS_RTOL[name]}; rank 0's at {res[0].get('worst') or 'none'}), elements "
              f"a rounding can turn round within {noise:.3g} (bound {2 * DIST_LR * steps}); ms "
              f"per step by rank {mean_ms}; optimizer-state bytes by rank "
              f"{[r['opt_bytes'] for r in res]}, parameter bytes held between steps "
              f"{[r['param_bytes'] for r in res]}; K1/K2 launches per step as "
              f"egnn_train's on every rank", flush=True)
        check(max(rels) <= DIST_RANKS_RTOL[name], f"{label}: {name}: a rank's parameters "
                                                  "part from the emulation")
        check(noise <= 2 * DIST_LR * steps, f"{label}: {name}: noise elements part")
    print(f"{label}: phase in {time.perf_counter() - t0:.1f} s", flush=True)


def run_gfm_phases(device, gfm_graphs, oc20, mace_graphs):
    """Every GFM phase in order; returns the launches of the GFM recipe's
    phases (counted against the ``gfm/`` kernel cases) and of the rest."""
    gfm = collections.Counter()
    rest = collections.Counter()
    gfm.update(run_gfm_train(gfm_graphs, device))
    gfm.update(run_gfm_serving(gfm_graphs[:GFM_SERVE_GRAPHS], device))
    gfm.update(run_gfm_convhead_train(gfm_graphs[:GFM_CONVHEAD_GRAPHS], device))
    nll, mace = run_gfm_nll(gfm_graphs[:GFM_NLL_GRAPHS], mace_graphs, device)
    gfm.update(nll)
    rest.update(mace)
    run_optimizers(gfm_graphs[:GFM_SERVE_GRAPHS], device)
    rest.update(run_mlp_per_node(oc20, device))
    return gfm, rest


# ---------------------------------------------------------------------------
# the observability plane (obs_train, obs_serve)
# ---------------------------------------------------------------------------

OBS_TELEMETRY = {"enabled": True, "interval_steps": 5, "trace": True, "trace_interval_steps": 1,
                 "numerics": True, "http_port": 0}
OBS_WINDOW_RTOL = 0.10  # each window's step time and graphs/s against the phase's own events
OBS_AB_BUDGET = 0.02  # telemetry_smoke.py's step-time budget, best of interleaved blocks
OBS_AB_BLOCKS = 3
OBS_AB_TRIALS = 5  # pairs a block (cut from telemetry_smoke.py's 10: PERF.md §4)
OBS_AB_STEPS = 10  # steps an epoch of the A/B (one window of the default interval)
OBS_PROBE_RTOL = TRAIN_RTOL["bf16 gradients"][0]  # egnn_train's largest-gradient limit
OBS_SERVE_REQUESTS = 64
OBS_STEP_TIMEOUT_S = 2.0
OBS_WEDGE_SLEEP_S = 4.0
OBS_TRAIN_SERIES = ("hydragnn_step_time_seconds", "hydragnn_goodput_per_second",
                    "hydragnn_padding_waste_fraction", "hydragnn_mfu_estimate",
                    "hydragnn_numerics_max_abs", "hydragnn_device_memory_peak_bytes")
OBS_TRACE_NAMES = ("train/step", "train/host_batch_build", "train/device_dispatch", "dataload",
                   "train_step")
OBS_KERNEL_NAMES = {"K1": "sorted_segment_sum", "K2": "fused_edge_kernel"}


def http_get(url: str):
    """(status, body) of a GET on the loopback endpoint."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def read_jsonl(path) -> list:
    path = Path(path)
    return [json.loads(line) for line in path.read_text().splitlines()] if path.exists() else []


def validate_streams(label: str, run_dir) -> dict:
    """Every record of the run's ``metrics.jsonl``, ``trace.jsonl`` and
    ``events.jsonl`` against the port's schema; the records by file."""
    from hydragnn_tpu_torch.obs.schema import (validate_event_record, validate_metrics_record,
                                               validate_span_record)

    out = {}
    for name, validate in (("metrics.jsonl", validate_metrics_record),
                           ("trace.jsonl", validate_span_record),
                           ("events.jsonl", validate_event_record)):
        recs = read_jsonl(Path(run_dir) / name)
        bad = [(r, e) for r in recs for e in validate(r)]
        print(f"{label}: {name} {len(recs)} records, kinds "
              f"{dict(collections.Counter(r.get('kind', r.get('name')) for r in recs))}, "
              f"{len(bad)} invalid", flush=True)
        check(not bad, f"{label}: {name} records fail the schema: {bad[:3]}")
        out[name] = recs
    return out


def histogram_buckets(text: str, name: str, labels: str = "") -> dict:
    """A Prometheus histogram's cumulative buckets in ``text``: upper bound
    -> count."""
    import re

    return {float("inf") if le == "+Inf" else float(le): float(v) for le, v in re.findall(
        rf'^{name}_bucket{{{labels}{"," if labels else ""}le="([^"]+)"}} (\S+)$', text, re.M)}


def histogram_quantile(after: dict, before: dict, q: float):
    """The q-quantile of what a histogram gained from ``before`` to
    ``after`` (``histogram_buckets``; the registry is the process's, so
    earlier phases' observations are in both): the upper bound of the
    bucket holding it, and the count gained."""
    rows = sorted((le, n - before.get(le, 0.0)) for le, n in after.items())
    total = rows[-1][1] if rows else 0.0
    return next((le for le, v in rows if v >= q * total), float("nan")), total


def obs_ab(label: str, batches, legs, blocks: int = OBS_AB_BLOCKS,
           trials: int = OBS_AB_TRIALS) -> float:
    """run-scripts/telemetry_smoke.py's A/B protocol (legs 3 and 5): blocks
    of interleaved (off, on) epochs over ``batches``; the best block's
    on/off ratio. ``legs`` maps "off"/"on" to ``(state, step, train_epoch
    keywords)`` callables. Two adjustments to the card's shared host,
    whose speed drifts by ~10% within seconds: each pair runs its legs in
    turn (off first, then on first), and a block's ratio is the median of
    its pairs' ratios (each pair's legs seconds apart), not the ratio of
    the legs' medians; and the objects alive before it are frozen out of
    the garbage collector's passes (``gc.freeze``: their cost grows with
    this process's heap, not with what a leg does). Prints every pair, and
    each block's allocator churn (device allocations and frees, retries),
    and first the host's load and this process's live threads (what else
    shares the host clock)."""
    import gc
    import os

    import numpy as np
    import torch

    from hydragnn_tpu_torch.train.loop import train_epoch

    print(f"{label}: host load {[round(x, 2) for x in os.getloadavg()]} on {os.cpu_count()} "
          f"cores; threads alive {sorted(t.name for t in threading.enumerate())}", flush=True)
    gc.collect()
    gc.freeze()
    ratios = []
    for block in range(blocks):
        mem0 = torch.cuda.memory_stats()
        pairs = []
        for trial in range(trials):
            ms = {}
            for leg in (("off", "on") if trial % 2 == 0 else ("on", "off")):
                state, step, kw = legs[leg]()
                t0 = time.perf_counter()
                train_epoch(batches, step, state, **kw)
                ms[leg] = (time.perf_counter() - t0) / len(batches) * 1e3
            pairs.append(ms["on"] / ms["off"])
            print(f"{label}: block {block} pair {trial}: off {ms['off']:.3f} ms on "
                  f"{ms['on']:.3f} ms per step ({(pairs[-1] - 1) * 100:+.2f}%)", flush=True)
        ratios.append(float(np.median(pairs)))
        mem = torch.cuda.memory_stats()
        churn = {k: mem.get(k, 0) - mem0.get(k, 0)
                 for k in ("num_device_alloc", "num_device_free", "num_alloc_retries")}
        print(f"{label}: block {block}: median of the pairs {(ratios[-1] - 1) * 100:+.2f}% "
              f"(allocator {churn}, {mem.get('reserved_bytes.all.current', 0) / 2**30:.1f} GiB "
              "reserved)", flush=True)
    gc.unfreeze()
    best = min(ratios)
    print(f"{label}: overhead {(best - 1) * 100:+.2f}% (best of {blocks} blocks; all "
          f"{[round((r - 1) * 100, 2) for r in ratios]}%), budget "
          f"{OBS_AB_BUDGET * 100:.0f}%", flush=True)
    return best


def run_obs_train(graphs, device, per_step):
    """``obs_train``: ``api.run_training`` on ``train_config`` (the SC25
    EGNN, bf16, through K1 and K2, no device given) with ``OBS_TELEMETRY``
    (windows of 5 steps, every step traced, numerics, ``/metrics`` on an
    ephemeral port) and ``NeuralNetwork.Profile`` off, one epoch (~20
    steps); a touch file arms the on-demand profile. Gates: the streams'
    records validate; each window's step time and graphs/s within 10% of
    this phase's own CUDA events around the same steps; ``mfu_est`` in
    (0, 1) against the card's named peak; a scrape of ``/metrics`` during
    the run holds the train series and ``/healthz`` answers 200; the
    capture of ``profile_steps`` steps names K1's and K2's kernels and the
    step's spans and regions; K1/K2 launches per step and eval batch as
    egnn_train's, N1 (the numerics) once a train step. Then, on the run's
    weights: each probe's and gradient group's max |x| and rms through the
    kernels (N1 among them) against the plain versions on one batch; one batch poisoned after batching through the numerics
    step (the guard skips it, ``numerics_provenance`` names ``embedding``,
    one flight dump with its files); and the step-time A/Bs, telemetry on
    against off and numerics on against off, within 2%. Returns the
    launches by (kernel, case) of the run."""
    import torch

    import hydragnn_tpu_torch.obs.telemetry as obs_telemetry
    from hydragnn_tpu_torch.api import prepare_data, run_training
    from hydragnn_tpu_torch.config import get_log_name_config
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.obs.flightrec import FlightRecorder
    from hydragnn_tpu_torch.obs.numerics import NanWatch, finalize_stats
    from hydragnn_tpu_torch.obs.telemetry import StepTelemetry, peak_flops, resolve_telemetry
    from hydragnn_tpu_torch.train.loop import make_train_step, train_epoch

    label = "obs_train"
    wrappers = _wrappers()
    kind = torch.cuda.get_device_name(device)
    check(peak_flops(kind) is not None, f"{label}: no peak named for {kind!r}")
    config = train_config()
    config["Telemetry"] = dict(OBS_TELEMETRY)
    config["NeuralNetwork"]["Profile"] = {"enable": 0}
    splits = split_dataset(graphs, 0.9, seed=0)
    _, loaders, _ = prepare_data(copy.deepcopy(config), splits)
    units = sum(len(loader) for loader in loaders)
    run_dir = Path("logs") / get_log_name_config(config)
    run_dir.mkdir(parents=True)
    (run_dir / "profile_trigger").touch()

    # this phase's own clock: CUDA events around every train step the run
    # dispatches (the compile plane's step: a level's first visit runs
    # eagerly, the rest replay its CUDA graph), and a scrape of /metrics
    # and /healthz mid-run
    from hydragnn_tpu_torch.train import compile_plane as cp

    events, scraped, telems = [], {}, []
    real_launch, real_init = cp.CompilePlane.launch, obs_telemetry.StepTelemetry.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        telems.append(self)

    def launch(self, *a, **kw):
        step, eval_step = real_launch(self, *a, **kw)

        def timed(state, batch):
            before = torch.cuda.Event(enable_timing=True)
            after = torch.cuda.Event(enable_timing=True)
            before.record()
            out = step(state, batch)
            after.record()
            events.append((before, after, int(batch.graph_mask.sum())))
            if len(events) == 12 and telems and telems[0].endpoint_port:
                base = f"http://127.0.0.1:{telems[0].endpoint_port}"
                scraped["metrics"] = http_get(base + "/metrics")
                scraped["healthz"] = http_get(base + "/healthz")
            return out

        timed.__dict__.update(step.__dict__)
        return timed, eval_step

    _zero_launches(wrappers)
    t0 = time.perf_counter()
    with swapped([(cp.CompilePlane, "launch", launch),
                  (obs_telemetry.StepTelemetry, "__init__", init)]):
        model, state, hist = run_training(copy.deepcopy(config), datasets=splits, seed=SEED)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # N1 runs in each train step's numerics, not in the eval batches
    numerics_runs = dict(collections.Counter(wrappers["N1"].launches_by_case)
                         + wrappers["N1"].replayed_by_case)
    launched = _check_launches(f"{label} run_training",
                               {k: w for k, w in wrappers.items() if k != "N1"}, per_step, units,
                               "steps and eval batches")
    steps = len(events)
    print(f"{label}: N1 launches in {steps} train steps {numerics_runs}", flush=True)
    check(len(numerics_runs) == 1 and sum(numerics_runs.values()) == steps,
          f"{label}: N1 launched {numerics_runs} in {steps} train steps, expected one a step")
    launched.update({("N1", c): n for c, n in numerics_runs.items()})
    print(f"{label}: run_training with Telemetry {OBS_TELEMETRY}, 1 epoch in {seconds:.2f} s: "
          f"{steps} steps, history {hist}, guard skips {int(state.skipped_steps)}", flush=True)
    check(steps == int(state.step) == len(loaders[0]) >= 16 and int(state.skipped_steps) == 0,
          f"{label}: {steps} steps timed, state at step {int(state.step)}")

    streams = validate_streams(label, run_dir)
    windows = [r for r in streams["metrics.jsonl"] if r["kind"] == "step_window"]
    check(sum(w["steps"] for w in windows) == steps and len(windows) >= 4,
          f"{label}: windows {[w['steps'] for w in windows]} for {steps} steps")
    for w in windows:
        first, last = events[w["step"] - w["steps"]], events[w["step"] - 1]
        own = first[0].elapsed_time(last[1]) / 1e3
        graphs_w = sum(e[2] for e in events[w["step"] - w["steps"]:w["step"]])
        own_ms, own_gps = own / w["steps"] * 1e3, graphs_w / own
        gaps = (abs(w["step_time_ms"] / own_ms - 1), abs(w["graphs_per_sec"] / own_gps - 1))
        print(f"{label}: window to step {w['step']} ({w['steps']} steps, {w['buckets']}): "
              f"step_time_ms {w['step_time_ms']} vs own events {own_ms:.3f} ({gaps[0]:.2%}), "
              f"graphs_per_sec {w['graphs_per_sec']} vs {own_gps:.2f} ({gaps[1]:.2%}), mfu_est "
              f"{w['mfu_est']} against {peak_flops(kind) / 1e12:.1f} TFLOP/s ({kind}), padding "
              f"waste {w['padding_waste']}", flush=True)
        check(max(gaps) <= OBS_WINDOW_RTOL,
              f"{label}: window to step {w['step']} {gaps} from the phase's own events")
        check(w["mfu_est"] is not None and 0.0 < w["mfu_est"] < 1.0,
              f"{label}: mfu_est {w['mfu_est']} not in (0, 1)")
    from hydragnn_tpu_torch.obs import flops as obs_flops

    for sig, f in obs_flops.cached().items():
        print(f"{label}: FLOPs per train step at level {sig[-1]}: {f:.4e} (meta count, "
              "matrix products)", flush=True)
    numerics = [r for r in streams["metrics.jsonl"] if r["kind"] == "numerics"]
    check(len(numerics) == len(windows), f"{label}: {len(numerics)} numerics records")
    print(f"{label}: last numerics window, activations "
          f"{ {k: (v['max_abs'], v['rms']) for k, v in numerics[-1]['activations'].items()} }",
          flush=True)
    names = collections.Counter(s["name"] for s in streams["trace.jsonl"])
    check(names["train/step"] == names["train/device_dispatch"] == steps,
          f"{label}: span counts {dict(names)}")
    code, text = scraped.get("metrics", (None, ""))
    missing = [s for s in OBS_TRAIN_SERIES if f"\n{s}" not in text]
    print(f"{label}: /metrics mid-run {code}, {len(text)} bytes, missing {missing}; /healthz "
          f"{scraped.get('healthz', (None,))[0]}", flush=True)
    check(code == 200 and not missing and scraped["healthz"][0] == 200,
          f"{label}: the mid-run scrape {code}, missing {missing}")
    traces = sorted((run_dir / "profile_on_demand").glob("step*/trace.json"))
    check(len(traces) == 1, f"{label}: on-demand captures {traces}")
    trace = json.loads(traces[0].read_text())
    trace_names = {e.get("name", "") for e in trace.get("traceEvents", [])}
    found = {k: sum(v in n for n in trace_names) for k, v in OBS_KERNEL_NAMES.items()}
    ranges = {n: n in trace_names for n in OBS_TRACE_NAMES}
    print(f"{label}: on-demand capture {traces[0].relative_to(run_dir)} "
          f"({traces[0].stat().st_size} bytes): kernels {found}, ranges {ranges}", flush=True)
    check(all(found.values()) and all(ranges.values()),
          f"{label}: the capture lacks {found} {ranges}")

    # the probes through the kernels against the plain versions, on the
    # run's weights and one batch (one numerics step each, bf16 as trained)
    loaders[0].set_epoch(0)
    batches = list(loaders[0])
    stats = {}
    for route in ("kernels", "plain"):
        st = _train_copy(model, device)
        step = make_train_step(st.model, mixed_precision=True, numerics=True)
        with plain_versions(PLAIN if route == "plain" else ()):
            out = step(st, batches[0])
        meta = step._numerics_meta
        stats[route] = {
            **{("act", n): finalize_stats(r) for n, r in zip(meta["act_names"], out[3]["act"].cpu())},
            **{("grad", n): finalize_stats(r) for n, r in zip(meta["grad_names"],
                                                              out[3]["grad"].cpu())}}
        del st, step, out
    worst = 0.0
    for key, want in stats["plain"].items():
        got = stats["kernels"][key]
        gap = max(abs(got[s] - want[s]) / max(abs(want[s]), 1e-30) for s in ("max_abs", "rms"))
        worst = max(worst, gap)
        print(f"{label}: probe {key[0]} {key[1]}: max_abs {got['max_abs']:.6g} vs plain "
              f"{want['max_abs']:.6g}, rms {got['rms']:.6g} vs {want['rms']:.6g} ({gap:.3e})",
              flush=True)
    check(stats["kernels"].keys() == stats["plain"].keys() and worst <= OBS_PROBE_RTOL,
          f"{label}: probes through the kernels {worst:.3e} from the plain versions "
          f"(limit {OBS_PROBE_RTOL})")

    # one batch poisoned after batching through the numerics step
    st = _train_copy(model, device)
    step = make_train_step(st.model, mixed_precision=True, numerics=True)
    bad = batches[1].replace(x=batches[1].x.clone())
    bad.x[0, 0] = float("nan")
    watch = NanWatch(diagnose=step._nan_diagnose, lag=2)
    flight_dir = Path("obs_poison")
    recorder = FlightRecorder(str(flight_dir)).install()
    try:
        from hydragnn_tpu_torch.obs.events import events as event_log

        # the ring is bounded: earlier phases' events (each run's tile-plan
        # choices among them) may fill it, so it starts empty here
        event_log().clear()
        st, _, _, _ = train_epoch([batches[0], bad] + batches[2:5], step, st, nan_watch=watch)
        prov = [e for e in event_log().snapshot() if e["kind"] == "numerics_provenance"]
    finally:
        recorder.uninstall()
    skips = watch.take()
    dumps = [d for d in (flight_dir / "flightrec").iterdir() if not d.name.startswith(".tmp")]
    files = sorted(p.name for p in dumps[0].iterdir()) if dumps else []
    print(f"{label}: poisoned batch 1: guard skips {int(st.skipped_steps)}, provenance "
          f"{skips}, events {prov}, flight dumps {[d.name for d in dumps]} {files}", flush=True)
    check(int(st.skipped_steps) == 1 and len(skips) == 1 and skips[0]["layer"] == "embedding"
          and len(prov) == 1 and prov[0]["layer"] == "embedding" and len(dumps) == 1
          and {"meta.json", "events.json", "spans.json", "metrics.prom",
               "memory.json"} <= set(files),
          f"{label}: NaN provenance {skips} {prov} {files}")
    del st, step, watch

    # the step-time A/Bs on OBS_AB_STEPS batches an epoch, each leg with
    # its own settings (telemetry_smoke.py legs 3 and 5)
    ab_batches = batches[:OBS_AB_STEPS]
    st = _train_copy(model, device)
    plain_step = make_train_step(st.model, mixed_precision=True)
    telem = StepTelemetry(resolve_telemetry({"Telemetry": {"enabled": True}}), "obs_ab",
                          device=device)
    from hydragnn_tpu_torch.obs.flops import train_flops_for

    telem.attach_flops(train_flops_for(st.model, False, True))
    # the legs copy each batch inline, as before device staging was the
    # loop's default: its producer thread is host-clock noise to a 2% A/B
    # and the same in both legs (PERF.md §4)
    inline = {"prefetch_depth": 0}
    train_epoch(ab_batches, plain_step, st, **inline)  # warm
    train_epoch(ab_batches, plain_step, st, telemetry=telem, **inline)
    best = obs_ab(f"{label} telemetry A/B", ab_batches, {
        "off": lambda: (st, plain_step, inline),
        "on": lambda: (st, plain_step, {"telemetry": telem, **inline})})
    telem.close()
    check(best <= 1 + OBS_AB_BUDGET, f"{label}: telemetry costs {(best - 1) * 100:.2f}% a step")
    num_step = make_train_step(st.model, mixed_precision=True, numerics=True)
    train_epoch(ab_batches, num_step, st, nan_watch=NanWatch(diagnose=num_step._nan_diagnose),
                **inline)
    best = obs_ab(f"{label} numerics A/B", ab_batches, {
        "off": lambda: (st, plain_step, inline),
        "on": lambda: (st, num_step, {"nan_watch": NanWatch(diagnose=num_step._nan_diagnose),
                                      **inline})})
    check(best <= 1 + OBS_AB_BUDGET, f"{label}: numerics costs {(best - 1) * 100:.2f}% a step")
    check(int(st.skipped_steps) == 0, f"{label}: the A/B steps skipped {int(st.skipped_steps)}")
    return launched


def run_obs_serve(graphs, device, per_batch):
    """``obs_serve``: ``api.run_server`` on the egnn serving config with
    ``Telemetry.trace`` on at ``trace_sample`` 1.0 and
    ``Serving.step_timeout_s`` ``OBS_STEP_TIMEOUT_S``: 64 requests, each
    request's span tree complete (its ``serve/request`` root with
    ``serve/admit`` and ``serve/queue_wait``, and its batch's
    ``serve/step`` with its four children, in its trace or linked), the
    ``/metrics`` request histogram counting 64 (its p50 and p99 beside the
    client's own; the registry is the process's, so the count is what the
    64 added), ``/readyz`` 200, K1/K2 launches per served batch; then a
    step that sleeps past the timeout: its request fails with
    ``WedgedStepError``, ``serve_wedge`` is emitted, the flight recorder
    dumps, and the next request is answered. Returns the launches by
    (kernel, case) of the 64 requests."""
    import numpy as np
    import torch

    from hydragnn_tpu_torch.api import run_server
    from hydragnn_tpu_torch.config import get_log_name_config
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.obs.events import events as event_log
    from hydragnn_tpu_torch.serve import WedgedStepError

    label = "obs_serve"
    wrappers = _wrappers()
    config = serving_config()
    config["Telemetry"] = {"trace": True, "trace_sample": 1.0}
    config["Serving"] = {"step_timeout_s": OBS_STEP_TIMEOUT_S, "http_port": 0}
    run_dir = Path("logs") / get_log_name_config(config)
    server = run_server(config, datasets=split_dataset(graphs, 0.9, seed=0), device=device,
                        seed=SEED)
    try:
        check(server.wait_ready(timeout=600), f"{label}: warm-up failed: {server.failed}")
        base = f"http://127.0.0.1:{server.http_port}"
        ready = http_get(base + "/readyz")[0]
        requests = [graphs[i % len(graphs)] for i in range(OBS_SERVE_REQUESTS)]
        batches0 = server.stats()["batches"]
        hist = "hydragnn_serve_request_latency_seconds"
        before = histogram_buckets(http_get(base + "/metrics")[1], hist, 'outcome="ok"')
        _zero_launches(wrappers)
        handles = [server.submit(g) for g in requests]
        results = [h.result(timeout=600) for h in handles]
        torch.cuda.synchronize()
        batches = server.stats()["batches"] - batches0
        launched = _check_launches(label, wrappers, per_batch, batches, "batches")
        check(all(all(np.isfinite(v).all() for v in r.values()) for r in results),
              f"{label}: a non-finite answer")
        code, text = http_get(base + "/metrics")
        lat = np.asarray([h.done_at - h.submitted_at for h in handles])
        after = histogram_buckets(text, hist, 'outcome="ok"')
        p50, count = histogram_quantile(after, before, 0.5)
        p99, _ = histogram_quantile(after, before, 0.99)
        print(f"{label}: {OBS_SERVE_REQUESTS} requests in {batches} batches; /readyz {ready}; "
              f"/metrics {code}: request histogram count {count:g}, p50 <= {p50:g} s, p99 <= "
              f"{p99:g} s (bucket bounds) beside the client's p50 "
              f"{np.percentile(lat, 50):.4f} s p99 {np.percentile(lat, 99):.4f} s", flush=True)
        check(ready == 200 and code == 200 and count == OBS_SERVE_REQUESTS,
              f"{label}: /readyz {ready}, /metrics {code}, count {count}")

        # the watchdog: a step that sleeps past the timeout, then a fresh runner
        forward, slept = server.forward, []

        def wedged(batch):
            if not slept:
                slept.append(1)
                time.sleep(OBS_WEDGE_SLEEP_S)
            return forward(batch)

        n0 = len(event_log().snapshot())
        server.forward = wedged
        err = server.submit(requests[0]).error(timeout=60)
        wedge = [e for e in event_log().snapshot()[n0:] if e["kind"] == "serve_wedge"]
        after = server.predict([requests[1]], timeout=60)[0]
        print(f"{label}: a step sleeping {OBS_WEDGE_SLEEP_S} s past step_timeout_s "
              f"{OBS_STEP_TIMEOUT_S}: {type(err).__name__}, events {wedge}; the next request "
              f"{'answered' if isinstance(after, dict) else after}", flush=True)
        check(isinstance(err, WedgedStepError) and len(wedge) == 1 and isinstance(after, dict)
              and server.stats()["wedged_batches"] == 1, f"{label}: the watchdog {err} {wedge}")
        time.sleep(OBS_WEDGE_SLEEP_S)  # the abandoned step ends before the server closes
    finally:
        server.close()
    dumps = [d.name for d in (run_dir / "flightrec").iterdir()] if (run_dir / "flightrec").exists() else []
    check(any(d.endswith("serve_wedge-h0") for d in dumps), f"{label}: flight dumps {dumps}")
    streams = validate_streams(label, run_dir)
    spans = streams["trace.jsonl"]
    by_id = {s["spanId"]: s for s in spans}
    kids = collections.defaultdict(list)
    for s in spans:
        if "parentSpanId" in s:
            kids[s["parentSpanId"]].append(s)
    roots = [s for s in spans if s["name"] == "serve/request"]
    ok_roots = [r for r in roots if r.get("status", {}).get("code") == 1]
    steps = {s["spanId"]: s for s in spans if s["name"] == "serve/step"}
    incomplete = []
    for r in ok_roots:
        names = sorted(k["name"] for k in kids[r["spanId"]])
        linked = [l["spanId"] for l in r.get("links", [])] + [
            k["spanId"] for k in kids[r["spanId"]] if k["name"] == "serve/step"]
        step_ok = all(sorted(k["name"] for k in kids[sid]) == [
            "serve/batch_form", "serve/bucket_select", "serve/device_step", "serve/respond"]
            for sid in linked if sid in steps)
        if not ({"serve/admit", "serve/queue_wait"} <= set(names) and linked and step_ok):
            incomplete.append((r["spanId"], names, linked))
    print(f"{label}: {len(spans)} spans, {len(roots)} request roots ({len(ok_roots)} ok, the "
          f"rest the wedged one), {len(steps)} step spans, {len(incomplete)} incomplete trees",
          flush=True)
    check(len(ok_roots) == OBS_SERVE_REQUESTS + 1 == len(roots) - 1 and not incomplete,
          f"{label}: incomplete span trees {incomplete[:3]}")
    return launched


# -- the compile and memory plane (train/compile_plane.py, ops/remat.py, tune/)

GRAPHS_TRAIN_BUCKETS = 4  # num_pad_buckets of the graphs_* cells (unpacked batches)
GRAPHS_TRAIN_GRAPHS = 400  # 360 train graphs: 12 steps an epoch (cut from 768: PERF.md §4)
GRAPHS_AB_PAIRS = 4  # alternating (eager, replayed) legs of the step-time A/B
GRAPHS_AB_STEPS = 8  # steps a leg
REMAT_STEPS = 3  # timed steps a policy
TUNE_BUDGET = 3  # candidate plans a slot
TUNE_TRIALS = 2  # timed calls a candidate (cut from 3: PERF.md §4)
PLANE_KERNELS = {"sorted_segment_sum": "K1", "fused_edge_message_sum": "K2",
                 "fused_multi_agg": "K3", "flash_self_attention": "K4",
                 "flash_block_summary": "K4b", "numerics_stats": "N1"}


def capture_checks(cases):
    """Each kernel (K1, K2, K3, K4, K4b, N1) at its first case's path shapes
    captured in a CUDA graph and replayed: the replay's outputs (zeroed
    before it, so the replay writes them) equal the eager call's bit for
    bit and the plain version's within the case's tolerance; the capture
    counts one launch as ``captured`` and none as run, so the ``ctypes``
    launch landed on the capturing stream."""
    import torch

    seen = set()
    for kc in cases:
        k = kc["kernel"]
        if k in seen:
            continue
        seen.add(k)
        w = _wrappers()[k]
        name = kc["name"]
        eager = _outputs(kc["fn"]())
        plain = _outputs(kc["plain"]())
        torch.cuda.synchronize()
        launches, captured = w.launches, w.captured
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            static = _outputs(kc["fn"]())
        capture_s = time.perf_counter() - t0
        check(w.launches == launches and w.captured == captured + 1,
              f"capture {name}: {w.launches - launches} launches run, "
              f"{w.captured - captured} recorded (want 0 and 1)")
        with torch.no_grad():
            for t in static:
                t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(static, eager))
        atol, rtol = TOLERANCES[(k, kc["dtype"])]
        errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(static, plain)]
        tols = [atol + rtol * (kc["scale"] if kc["scale"] is not None
                               else float(b.float().abs().max())) for b in plain]
        print(f"capture {name}: captured in {capture_s * 1e3:.1f} ms, replayed: equal to the "
              f"eager call bit for bit {same}; against the plain version max_abs_err "
              f"{[f'{e:.3g}' for e in errs]} (tolerance {[f'{t:.3g}' for t in tols]})",
              flush=True)
        check(same, f"capture {name}: the replay differs from the eager call")
        check(all(e <= t for e, t in zip(errs, tols)),
              f"capture {name}: the replay disagrees with the plain version")
        del graph, static
    check(seen == set(KERNELS), f"capture checks cover {sorted(seen)}, not {sorted(KERNELS)}")


@contextlib.contextmanager
def recorded_planes():
    """Within the block, every compile plane that finishes is appended to
    the returned list (``run_training`` keeps its plane to itself)."""
    from hydragnn_tpu_torch.train import compile_plane as cp

    planes = []
    real = cp.CompilePlane.finish

    def finish(self, verbosity: int = 0):
        planes.append(self)
        return real(self, verbosity)

    with swapped([(cp.CompilePlane, "finish", finish)]):
        yield planes


@contextlib.contextmanager
def step_losses():
    """Within the block, each epoch's per-step train losses, as
    ``train_epoch`` reads them back, appended to the returned list (its
    val and test reads land there too, one list each)."""
    import hydragnn_tpu_torch.train.loop as loop

    got = []
    real = loop._read_entries

    def reading(entries):
        rows = real(entries)
        got.append([r[0] for r in rows])
        return rows

    with swapped([(loop, "_read_entries", reading)]):
        yield got


def graphs_config(mode: str = "off", policy: str = "warn"):
    """The egnn_train cell unpacked on a ladder of ``GRAPHS_TRAIN_BUCKETS``
    levels, with ``Training.precompile`` ``mode``."""
    config = train_config()
    config["NeuralNetwork"]["Training"].update(
        pack_batches=False, num_pad_buckets=GRAPHS_TRAIN_BUCKETS, precompile=mode,
        retrace_policy=policy)
    return config


def plane_launches(rep, kind: str):
    """kernel -> case -> launches of each ``kind`` graph of a compile
    plane's report, one dict per graph (the same for every level of a
    step)."""
    return [{PLANE_KERNELS[w]: cases for w, cases in g["launches"].items()}
            for label, g in rep["graphs"].items() if label.startswith(kind)]


def replayed_by_kernel(rep):
    """(kernel, case) -> launches the report's graph replays ran."""
    out = collections.Counter()
    for g in rep["graphs"].values():
        for w, cases in g["launches"].items():
            for c, n in cases.items():
                out[PLANE_KERNELS[w], c] += n * g["replays"]
    return out


def _state_tensors(state):
    return [t.detach().clone() for t in state.held] + [
        state.step.clone(), state.skipped_steps.clone()]


def run_graphs_train(graphs, device, per_step):
    """``graphs_train``: the egnn_train cell (bf16, K1 and K2) on a ladder
    of 4 levels through ``api.run_training`` under ``precompile`` blocking
    and background against off: under deterministic algorithms the
    per-step losses, the history and every tensor of the state equal off's
    bit for bit; with atomics, blocking's per-step losses within
    egnn_train's trajectory limit. Each plane: every (train, eval) level
    captured (capture seconds, pool bytes), ``time_to_first_step``, K1 and
    K2 launches a step counted through the graphs (each train and eval
    graph records egnn_train's table). Then the step-time A/B of the same
    cell's eager step against its replayed graphs in alternating legs over
    prebuilt batches, each leg's busy share, peak memory with and without
    graphs; and the sentinel: an off-ladder batch gives one warning and
    one ``retrace_violation`` event under ``warn`` and ``RetraceError``
    under ``error``. Returns the launches by (kernel, case) of the
    replayed steps."""
    import warnings

    import numpy as np
    import torch

    from hydragnn_tpu_torch.api import prepare_data, run_training
    from hydragnn_tpu_torch.data.graph import PadSpec, batch_graphs
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.obs.events import EV_RETRACE_VIOLATION, events
    from hydragnn_tpu_torch.train import compile_plane as cp
    from hydragnn_tpu_torch.train.loop import make_eval_step, make_train_step

    label = "graphs_train"
    t_phase = time.perf_counter()
    splits = split_dataset(graphs, 0.9, seed=0)
    runs = {}
    for det, modes in ((True, ("off", "blocking", "background")), (False, ("blocking",))):
        for mode in modes:
            key = ("deterministic" if det else "atomics", mode)
            with contextlib.ExitStack() as stack:
                if det:
                    stack.enter_context(deterministic())
                planes = stack.enter_context(recorded_planes())
                losses = stack.enter_context(step_losses())
                t0 = time.perf_counter()
                _, state, hist = run_training(copy.deepcopy(graphs_config(mode)),
                                              datasets=splits, seed=SEED)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            rep = planes[-1].report()
            runs[key] = dict(state=_state_tensors(state), hist=hist, losses=losses[0], rep=rep,
                             seconds=seconds)
            print(f"{label}: run_training, {key[0]}, precompile {mode}: {seconds:.2f} s, "
                  f"{len(losses[0])} steps, losses {losses[0][0]:.6g} -> {losses[0][-1]:.6g}; "
                  f"{cp.format_report(rep)}", flush=True)
            if mode != "off":
                # blocking captures every level before step 0; background
                # each level the run visits, after its first (eager) visit
                want = (rep["specializations"] if mode == "blocking"
                        else rep["precompiled"])
                check(len(rep["graphs"]) == rep["precompiled"] == want > 2,
                      f"{label} {key}: {len(rep['graphs'])} graphs, {rep['precompiled']} of "
                      f"{rep['specializations']} levels captured")
                check(rep["violations"] == 0 and not rep["warmup_errors"],
                      f"{label} {key}: violations or warm-up errors")
                for g_label, g in rep["graphs"].items():
                    print(f"{label}: {key[0]} {mode} {g_label}: capture {g['capture_s']:.4f} s, "
                          f"{g['replays']} replays, pool {g['pool_bytes']} bytes (kept "
                          f"{g['kept_bytes']}), launches {g['launches']}", flush=True)
                for kind in ("train", "eval"):
                    for got in plane_launches(rep, kind):
                        check(got == per_step, f"{label} {key}: a {kind} graph records "
                                               f"{got}, expected {per_step}")
                replays = sum(g["replays"] for lbl, g in rep["graphs"].items()
                              if lbl.startswith("train"))
                check(replays >= len(losses[0]) - (GRAPHS_TRAIN_BUCKETS if mode == "background"
                                                   else 0),
                      f"{label} {key}: {replays} train replays for {len(losses[0])} steps")
    base = runs["deterministic", "off"]
    for mode in ("blocking", "background"):
        r = runs["deterministic", mode]
        diff = sum(0 if torch.equal(a, b) else 1 for a, b in zip(r["state"], base["state"]))
        print(f"{label}: deterministic, {mode} against off: {diff} of {len(r['state'])} state "
              f"tensors differ, per-step losses equal {r['losses'] == base['losses']}, history "
              f"equal {r['hist'] == base['hist']}", flush=True)
        check(diff == 0 and r["losses"] == base["losses"] and r["hist"] == base["hist"],
              f"{label}: precompile {mode} parts from off under deterministic algorithms")
    # with PyTorch's atomics (index_add_ and the gathers' backwards add in
    # an order that changes from run to run) against off's deterministic run
    lk = np.asarray(runs["atomics", "blocking"]["losses"])
    lo = np.asarray(base["losses"])
    trajectory_gate(f"{label} (atomics, blocking against off)", lk, lo, TRAIN_RTOL["trajectory"])

    # the step-time A/B: the cell's eager step against its replayed graphs
    done, (tl, _, _), _ = prepare_data(copy.deepcopy(graphs_config("blocking")), splits)
    tl.set_epoch(0)
    batches = list(tl)[:GRAPHS_AB_STEPS]
    model = create_model(done, device=device, seed=SEED)
    state = _train_copy(model, device)
    del model
    eager = make_train_step(state.model, mixed_precision=True)
    plane = cp.CompilePlane(mode="blocking", retrace_policy="warn", log_name=label)
    t0 = time.perf_counter()
    graphed, _ = plane.launch(eager, make_eval_step(state.model, mixed_precision=True), state,
                              tl, skip_eval=True)
    blocking_s = time.perf_counter() - t0
    legs = {"eager": eager, "replayed": graphed}

    def leg_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            fn(state, b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / len(batches)

    for fn in legs.values():
        leg_ms(fn)  # warm: the first visits, the allocator
    times = {k: [] for k in legs}
    for p in range(GRAPHS_AB_PAIRS):
        for k in (("eager", "replayed") if p % 2 == 0 else ("replayed", "eager")):
            times[k].append(leg_ms(legs[k]))
    med = {k: float(np.median(v)) for k, v in times.items()}
    busy, peak = {}, {}
    for k, fn in legs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dev_ms, _ = device_ms(lambda: [fn(state, b) for b in batches], 1)
        peak[k] = torch.cuda.max_memory_allocated() / 2**20
        wall = leg_ms(fn) * len(batches)
        busy[k] = None if dev_ms is None else dev_ms / wall
    rep = plane.report()
    replayed = plane_launches(rep, "train")
    print(f"{label}: the step, eager against replayed, {GRAPHS_AB_PAIRS} alternating legs of "
          f"{len(batches)} steps (ms a step): eager {[round(x, 2) for x in times['eager']]}, "
          f"replayed {[round(x, 2) for x in times['replayed']]}; medians eager "
          f"{med['eager']:.2f}, replayed {med['replayed']:.2f} ({med['eager'] / med['replayed']:.2f}x)"
          f"; device busy share "
          + ", ".join(f"{k} {'not measured' if v is None else f'{v:.1%}'}" for k, v in busy.items())
          + f"; peak memory {', '.join(f'{k} {v:.1f} MiB' for k, v in peak.items())}; blocking "
          f"captures in {blocking_s:.2f} s, pool bytes {rep['hbm_by_spec']}; launches a step "
          f"through the graph {replayed}", flush=True)
    for got in replayed:
        check(got == per_step, f"{label}: a replayed step launches {got}, expected {per_step}")

    # the sentinel, armed by the blocking plane: batches past the top
    # level's nodes
    top = tl.ladder.specs[-1]
    g0 = splits[0][0]
    off = [batch_graphs([g0], PadSpec(top.n_nodes + 8 * i, top.n_edges, top.n_graphs),
                        sort_edges=True) for i in (1, 2)]
    check(cp.sentinel().armed, f"{label}: the blocking plane left the sentinel unarmed")
    events().clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        graphed(state, off[0])
    warned = [w for w in caught if "retrace sentinel" in str(w.message)]
    viol = [e for e in events().snapshot() if e["kind"] == EV_RETRACE_VIOLATION]
    print(f"{label}: an off-ladder batch ({off[0].num_nodes} nodes) under warn: "
          f"{len(warned)} warning(s), {len(viol)} violation event(s); first lines: "
          f"{str(warned[0].message).splitlines()[:3] if warned else None}", flush=True)
    check(len(warned) == 1 and len(viol) == 1, f"{label}: warn policy")
    cp.sentinel().arm("error")
    try:
        graphed(state, off[1])
        raised = False
    except cp.RetraceError:
        raised = True
    plane.finish()
    del legs, graphed, plane, state, eager
    torch.cuda.empty_cache()
    print(f"{label}: the next off-ladder batch under error raises RetraceError: {raised}",
          flush=True)
    check(raised, f"{label}: error policy")
    launched = collections.Counter()
    for r in runs.values():
        launched.update(replayed_by_kernel(r["rep"]))
    print(f"{label}: phase in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launched


def run_graphs_serve(graphs, device, per_batch):
    """``graphs_serve``: the egnn server (``api.run_server``) with every
    ladder level captured at warm-up and the sentinel armed at ``error``;
    192 requests served by the graphs and by the same server's eager route
    in alternating rounds (graphs/s, p50 / p99); every served micro-batch
    replayed against the eager forward on the same batch, bit for bit, and
    the served answers against it; K1/K2 launches per batch counted
    through the graphs. Returns the launches by (kernel, case)."""
    import numpy as np
    import torch

    from hydragnn_tpu_torch.api import run_server
    from hydragnn_tpu_torch.data.graph import batch_graphs
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.serve.server import _strip_targets
    from hydragnn_tpu_torch.train import compile_plane as cp
    from hydragnn_tpu_torch.train.compile_plane import _signature_of

    label = "graphs_serve"
    t_phase = time.perf_counter()
    wrappers = _wrappers()
    t0 = time.perf_counter()
    server = run_server(serving_config(), datasets=split_dataset(graphs, 0.9, seed=0),
                        device=device, seed=SEED)
    check(server.wait_ready(timeout=600), f"{label}: warm-up failed: {server.failed}")
    graph_set = server._graphs
    print(f"{label}: ready in {time.perf_counter() - t0:.2f} s; levels captured "
          + ", ".join(f"{g.label} in {g.capture_s:.4f} s (pool {g.pool_bytes} bytes)"
                      for g in graph_set.graphs.values())
          + f"; sentinel armed {cp.sentinel().armed} at {cp.sentinel()._policy}", flush=True)
    check(len(graph_set.graphs) == len(server.warmup_compiled) > 0, f"{label}: levels captured")
    check(cp.sentinel().armed and cp.sentinel()._policy == "error", f"{label}: sentinel")
    requests = [graphs[i % len(graphs)] for i in range(N_REQUESTS)]
    rounds = {"graphs": [], "eager": []}
    launched = None
    for r in range(4):
        route = ("graphs", "eager", "eager", "graphs")[r]
        server._graphs = graph_set if route == "graphs" else None
        batches0 = server.stats()["batches"]
        _zero_launches(wrappers)
        t_start = time.perf_counter()
        handles = [server.submit(g) for g in requests]
        results = [h.result(timeout=600) for h in handles]
        t_end = max(h.done_at for h in handles)
        torch.cuda.synchronize()
        n_batches = server.stats()["batches"] - batches0
        lat = np.asarray([h.done_at - h.submitted_at for h in handles]) * 1e3
        rounds[route].append((N_REQUESTS / (t_end - t_start), np.percentile(lat, 50),
                              np.percentile(lat, 99), n_batches))
        if route == "graphs" and launched is None:
            launched = {(k, c): w.replayed_by_case[c] for k, w in wrappers.items()
                        for c in w.replayed_by_case}
            ran = {k: w.launches for k, w in wrappers.items()}
            want = {(k, c): n * n_batches for k, cases in per_batch.items()
                    for c, n in cases.items()}
            print(f"{label}: launches in {n_batches} batches through the graphs {launched}, "
                  f"run eagerly {ran}", flush=True)
            check(launched == want and not any(ran.values()),
                  f"{label}: launches {launched} (eager {ran}), expected {want}")
            graphed = (handles, results)
    server._graphs = graph_set
    for route, rows in rounds.items():
        print(f"{label}: {route}: " + "; ".join(
            f"{gps:.1f} graphs/s, p50 {p50:.2f} ms, p99 {p99:.2f} ms ({n} batches)"
            for gps, p50, p99, n in rows), flush=True)
    # each micro-batch the graphs served, again through the graph and the
    # eager forward: the same kernels on the same batch
    handles, results = graphed
    by_batch = {}
    for i, h in enumerate(handles):
        by_batch.setdefault(h.batch_index, []).append(i)
    diff = 0
    for idx in by_batch.values():
        gs = [_strip_targets(requests[i]) for i in idx]  # as the server admits them
        batch = batch_graphs(gs, server.ladder.select_for(gs), sort_edges=server.sort_edges)
        g = graph_set.graphs[_signature_of(batch)]
        out_g = {k: v.float().cpu().numpy() for k, v in g.run(batch, clone=False).items()}
        with torch.inference_mode():
            out_e = {k: v.float().cpu().numpy()
                     for k, v in server._placed_forward(batch.to(device)).items()}
        diff += sum(int(not np.array_equal(out_g[k], out_e[k])) for k in out_e)
        off = 0
        for j, gr in zip(idx, gs):
            rows = {"energy": slice(idx.index(j), idx.index(j) + 1),
                    "forces": slice(off, off + gr.num_nodes)}
            off += gr.num_nodes
            for k in ("energy", "forces"):
                diff += int(not np.array_equal(results[j][k], out_e[k][rows[k]].reshape(
                    results[j][k].shape)))
    print(f"{label}: {len(by_batch)} served batches replayed and run eagerly, their answers "
          f"and the served ones: {diff} differ", flush=True)
    check(diff == 0, f"{label}: the graphs' answers part from the eager route")
    server.close()
    check(not cp.sentinel().armed, f"{label}: close() left the sentinel armed")
    print(f"{label}: phase in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launched


def run_remat(graphs, device):
    """``remat``: the egnn_train cell's step (bf16, K1 and K2) unwrapped and
    with ``conv_checkpointing`` under each ``remat_policy``: every
    gradient of the first step 0 apart from the unwrapped step's under
    deterministic algorithms; peak memory above the state and ms a step
    of each, eager and replayed from a CUDA graph of the step (what the
    default ``precompile`` runs: a selective policy's dispatch mode costs
    host time only where the step runs eagerly)."""
    import dataclasses as dc

    import torch

    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.ops.remat import REMAT_POLICIES
    from hydragnn_tpu_torch.train import TrainState, make_optimizer
    from hydragnn_tpu_torch.train.compile_plane import GraphSet, _signature_of
    from hydragnn_tpu_torch.train.loop import make_train_step

    label = "remat"
    t_phase = time.perf_counter()
    done, (tl, _, _), _ = prepare_data(copy.deepcopy(train_config()),
                                       split_dataset(graphs, 0.9, seed=0))
    tl.set_epoch(0)
    host_batch = next(iter(tl))
    batch = host_batch.to(device)
    model = create_model(done, device=device, seed=SEED)
    base = None
    for name, ckpt, policy in [("unwrapped", False, "full")] + [
            (f"conv_checkpointing, {p}", True, p) for p in REMAT_POLICIES]:
        m = copy.deepcopy(model)
        m.cfg = dc.replace(m.cfg, conv_checkpointing=ckpt, remat_policy=policy)
        state = TrainState.create(m, make_optimizer(m, {"type": "AdamW", "learning_rate": 1e-3}))
        step = make_train_step(m, mixed_precision=True)
        with deterministic():
            step(state, batch)
        grads = _grads(state)
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(state, batch)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - start) / 2**20
        ms = cuda_ms(lambda: step(state, batch), REMAT_STEPS, warmup=1)
        graph = GraphSet(lambda b, s=state, f=step: f.placed(s, b), device).capture(
            _signature_of(host_batch), f"{label}: {name}", host_batch)
        replayed = cuda_ms(lambda: graph.replay(clone=False), REMAT_STEPS, warmup=1)
        check(bool(torch.isfinite(graph.out[1])), f"{label}: {name}: a replayed loss not finite")
        if base is None:
            base = (grads, peak, ms, replayed)
        worst = max(float((grads[k] - base[0][k]).abs().max()) for k in grads)
        print(f"{label}: {name}: peak {peak:.1f} MiB above the state ({base[1]:.1f} "
              f"unwrapped), {ms:.2f} ms a step ({base[2]:.2f} unwrapped), replayed {replayed:.2f} "
              f"({base[3]:.2f} unwrapped); first-step gradients against the unwrapped step, "
              f"deterministic: largest difference {worst:.3g}", flush=True)
        check(worst == 0.0, f"{label}: {name}: the gradients part from the unwrapped step")
        del m, state, step, grads, graph
    print(f"{label}: phase in {time.perf_counter() - t_phase:.1f} s", flush=True)


def run_tune(graphs, device, root: Path):
    """``tune``: the ``python -m hydragnn_tpu_torch.tune`` CLI's ``main``
    over the ladder of the egnn_train cell's energy-force form (f32: K1 at C = 866 and 3, K2;
    its graphs written to a columnar directory under ``root``) on a small
    budget; the table's entries, keyed on the card's name and each
    kernel's source digest; a second run (cached) sweeps nothing and hits
    every slot; with the table installed, every slot's launch takes its
    tuned plan; each tuned plan's outputs against the defaults' on the
    sweep's operands: bit for bit where the plan only splits rows among
    blocks (K1 wide), else within the kernel's tolerance."""
    import torch

    from hydragnn_tpu_torch.data import ColumnarWriter
    from hydragnn_tpu_torch.obs.events import EV_TILE_PLAN, events
    from hydragnn_tpu_torch.tune import plans, runtime
    from hydragnn_tpu_torch.tune.__main__ import main as tune_main
    from hydragnn_tpu_torch.tune.sweep import build_call
    from hydragnn_tpu_torch.tune.table import TunedTable

    label = "tune"
    t_phase = time.perf_counter()
    data = root / "egnn_columnar"
    ColumnarWriter(str(data)).add(graphs).save()
    config = graphs_config("off")
    config = energy_force_config(config)
    config["Dataset"].update(format="columnar", path={"total": str(data)})
    config["NeuralNetwork"]["Training"]["perc_train"] = 0.9
    path = root / "egnn_tune.json"
    path.write_text(json.dumps(config))
    table_dir = root / "tuned_table"
    argv = [str(path), "--budget", str(TUNE_BUDGET), "--trials", str(TUNE_TRIALS),
            "--cache-dir", str(table_dir)]
    # the CLI's main (what ``python -m hydragnn_tpu_torch.tune`` runs; a CPU
    # test runs the module itself) in this process: a second process would
    # pay ~20 s to reach the card and read the data again (PERF.md §4)
    t0 = time.perf_counter()
    first = tune_main(argv)
    first_s = time.perf_counter() - t0
    check(first["swept"] == first["entries"] > 0, f"{label}: the first run swept {first}")
    entries = [json.loads(p.read_text()) for p in sorted(table_dir.glob("*.json"))]
    kind = torch.cuda.get_device_name()
    for e in entries:
        f = e["key_fields"]
        print(f"{label}: entry {f['kernel']} version {f['version']} on {f['device']} "
              f"{f['dtype']} {f['shape']}: {e['plan']} ({e['measured_us']:.2f} us, defaults "
              f"{e['meta'].get('default_us')} us, {e['meta']['candidates']} candidates)",
              flush=True)
        check(f["device"] == kind and f["version"] == plans.kernel_version(f["kernel"]),
              f"{label}: an entry keyed on {f['device']} / {f['version']}")
    t0 = time.perf_counter()
    census = tune_main(argv)
    second_s = time.perf_counter() - t0
    print(f"{label}: first run {first_s:.2f} s, {len(entries)} entries; second "
          f"run {second_s:.2f} s: {census['entries']} slots, {census['hits']} hits, "
          f"{census['swept']} swept", flush=True)
    check(census["swept"] == 0 and census["hits"] == census["entries"] == len(entries) > 0,
          f"{label}: the second run swept")
    table = TunedTable(str(table_dir))
    runtime.install(table, "cached")
    events().clear()
    for res in census["results"]:
        kernel, shape, tuned = res["kernel"], res["shape"], res["plan"]
        dtype = "float32"
        call = build_call(kernel, shape, dtype, device)
        call()
        torch.cuda.synchronize()
        default = plans.default_plan(kernel, {**shape, "dtype": dtype})
        with runtime.forced(kernel, default):
            want = _outputs(call())
        with runtime.forced(kernel, tuned):
            got = _outputs(call())
        torch.cuda.synchronize()
        k = {"segment_sum": "K1", "fused_edge": "K2"}[kernel]
        rows_only = kernel == "segment_sum" and shape["channels"] * 4 > 16
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        atol, rtol = TOLERANCES[(k, dtype)]
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        tol = max(atol + rtol * float(b.abs().max()) for b in want)
        print(f"{label}: {kernel} {shape}: tuned {tuned} against defaults {default}: bit for "
              f"bit {same}, max_abs_err {err:.3g} (tolerance {tol:.3g}; "
              f"{'rows split only: exact' if rows_only else 'another summation grouping'})",
              flush=True)
        check(same if rows_only or tuned == default else err <= tol,
              f"{label}: {kernel} {shape}: the tuned plan's outputs part from the defaults'")
    sources = collections.Counter(e["source"] for e in events().snapshot()
                                  if e["kind"] == EV_TILE_PLAN)
    runtime.deactivate()
    print(f"{label}: lookups with the table installed: {dict(sources)}", flush=True)
    check(sources.get("tuned", 0) == len(entries) and not sources.get("default"),
          f"{label}: a launch did not take its tuned plan")
    print(f"{label}: phase in {time.perf_counter() - t_phase:.1f} s", flush=True)


def run_plane_phases(device, train_graphs, serve_graphs, root: Path):
    """The compile and memory plane's phases in order: ``graphs_train``,
    ``graphs_serve``, ``remat``, ``tune``; returns the graphs' launches by
    (kernel, case)."""
    launched = collections.Counter()
    launched.update(run_graphs_train(train_graphs[:GRAPHS_TRAIN_GRAPHS], device, TRAIN_PER_STEP))
    launched.update(run_graphs_serve(serve_graphs, device, TRAIN_PER_STEP))
    run_remat(train_graphs, device)
    run_tune(train_graphs, device, root)
    return launched


# data_plane: the host data plane on the egnn cell and two example
# recipes. (a) the egnn_train cell through run_training with device staging
# and loader prefetch on against both off, under deterministic algorithms;
# (b) the loader's stall watchdog; (c) examples/ani1_x/ani1x_forces.json and
# (d) examples/csce/csce_gap.json from their committed JSON, their data made
# by the port's generators; (e) a DistDataset feeding GraphLoader; (f) the
# native cell-list neighbor builder against cKDTree.
DATA_PLANE_GRAPHS = 356  # 320 train graphs: 10 steps of 32 an epoch
# epoch 0 the warm-up, epoch 1 timed, epoch 2 profiled (the profiler, even
# recording device activity alone, slows the host's launches)
DATA_PLANE_EPOCHS = 3
DATA_PLANE_LEGS = {"staged": (True, 2), "inline": (False, 0)}  # double_buffer, loader prefetch
STALL_TIMEOUT_S = 0.5
STALL_BLOCK_S = 1.5  # the wedged fetch: past the timeout, within the teardown join
STALL_SLACK_S = 0.05  # thread scheduling beyond the timeout plus one watchdog period
EXAMPLE_STEPS = 4  # the example recipes' steps (HYDRAGNN_MAX_NUM_BATCH)
EXAMPLE_GRAPHS = {"ani1x_config": 192, "csce_config": 192}  # 134 train graphs: 4 full batches
EXAMPLE_JSON = {"ani1x_config": "examples/ani1_x/ani1x_forces.json",
                "csce_config": "examples/csce/csce_gap.json"}
EXAMPLE_KERNELS = {"ani1x_config": ("K1", "K2"), "csce_config": ("K3",)}
# each recipe's first steps against the plain versions of its kernels,
# under the limits of the config phase on the same kernels (oc20_config:
# K1 and K2, lsms_config: K3), and the kernel whose sums the rounding draw
# evaluates in f64
EXAMPLE_RTOL = {"ani1x_config": ("K2", CONFIG_RTOL["oc20_config"]),
                "csce_config": ("K3", CONFIG_RTOL["lsms_config"])}
DIST_DATASET_GRAPHS = 288  # of the egnn cell's graphs: 259 train graphs, 9 batches
NATIVE_ATOMS = 32768
NATIVE_RADIUS = 5.0
NATIVE_DENSITY = 0.05  # atoms per cubic Angstrom (~50 neighbours within 5 A)


@contextlib.contextmanager
def _env(**values):
    """Within the block, each environment variable set (a value) or unset
    (None)."""
    import os

    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v



def run_staging(graphs, device, per_step):
    """(a) The egnn_train cell (bf16, a 4-level ladder, ``precompile``
    blocking: a graph replayed per level) through ``api.run_training`` for
    ``DATA_PLANE_EPOCHS`` epochs, once with ``double_buffer: true`` and the
    loader's prefetch at 2 (``HYDRAGNN_NUM_WORKERS``), once with both off,
    under deterministic algorithms: every loss and every state tensor equal
    bit for bit; K1/K2 launches a step through the graphs as egnn_train's.
    The second epoch is timed (synchronized at both ends): ms a step and
    graphs/s; the third profiled (device time, CUDA activity only): the
    busy share against the second's wall; and the two gauges. Returns the
    launches by (kernel, case)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import hydragnn_tpu_torch.train.loop as loop
    from hydragnn_tpu_torch.api import run_training
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.obs.registry import registry

    label = "data_plane (a)"
    splits = split_dataset(graphs, 0.9, seed=0)
    with profile(activities=[ProfilerActivity.CUDA]):  # CUPTI up before the timed epochs
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize()
    runs = {}
    for leg, (db, workers) in DATA_PLANE_LEGS.items():
        config = graphs_config("blocking")
        config["NeuralNetwork"]["Training"].update(double_buffer=db,
                                                   num_epoch=DATA_PLANE_EPOCHS)
        epochs = []
        real_epoch = loop.train_epoch

        def timed_epoch(loader, step_fn, state, **kw):
            profiled = len(epochs) == DATA_PLANE_EPOCHS - 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if profiled:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    out = real_epoch(loader, step_fn, state, **kw)
                    torch.cuda.synchronize()
            else:
                out = real_epoch(loader, step_fn, state, **kw)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            dev = (sum(_device_us(ev) for ev in _device_events(prof)) / 1e3
                   if profiled else None)
            epochs.append((wall, len(loader), dev))
            return out

        registry().gauge("hydragnn_loader_prefetch_depth", labelnames=("source",)).remove(
            source="train")
        with contextlib.ExitStack() as stack:
            stack.enter_context(deterministic())
            stack.enter_context(_env(HYDRAGNN_NUM_WORKERS=workers,
                                     HYDRAGNN_DEVICE_PREFETCH=None))
            planes = stack.enter_context(recorded_planes())
            losses = stack.enter_context(step_losses())
            stack.enter_context(swapped([(loop, "train_epoch", timed_epoch)]))
            _, state, hist = run_training(copy.deepcopy(config), datasets=splits, seed=SEED)
            torch.cuda.synchronize()
        rep = planes[-1].report()
        gauges = {name: registry().get(name).value(**lab) for name, lab in (
            ("hydragnn_device_prefetch_depth", {}),
            ("hydragnn_loader_prefetch_depth", {"source": "train"}))}
        # the timed epoch's wall against the profiled epoch's device time
        # (the same graphs in another order, on the same ladder)
        wall, steps, _ = epochs[-2]
        prof_wall, prof_steps, dev = epochs[-1]
        dev = dev * steps / prof_steps if dev else None
        n_graphs = len(splits[0])
        runs[leg] = dict(state=_state_tensors(state), losses=losses, hist=hist, rep=rep)
        print(f"{label}: {leg} (double_buffer {db}, loader prefetch {workers}): epoch "
              f"{DATA_PLANE_EPOCHS - 2} {wall * 1e3 / steps:.2f} ms a step over {steps} steps, "
              f"{n_graphs / wall:.1f} graphs/s; device busy "
              f"{'not measured' if not dev else f'{dev / (wall * 1e3):.1%}'} "
              f"({'-' if dev is None else f'{dev / steps:.2f}'} ms of device time a step in "
              f"epoch {DATA_PLANE_EPOCHS - 1}, profiled: {prof_wall * 1e3 / prof_steps:.2f} ms "
              f"a step of wall); gauges {gauges}; losses {losses[0][0]:.6g} -> "
              f"{losses[-3][-1]:.6g}", flush=True)
        check(gauges["hydragnn_device_prefetch_depth"] == (2.0 if db else 0.0),
              f"{label}: {leg}: the device staging gauge reads "
              f"{gauges['hydragnn_device_prefetch_depth']}")
        check(rep["precompiled"] == rep["specializations"] > 2 and rep["violations"] == 0,
              f"{label}: {leg}: {rep['precompiled']} of {rep['specializations']} levels "
              "captured, or a violation")
        for kind in ("train", "eval"):
            for got in plane_launches(rep, kind):
                check(got == per_step, f"{label}: {leg}: a {kind} graph records {got}, "
                                       f"expected {per_step}")
    a, b = runs["staged"], runs["inline"]
    diff = sum(0 if torch.equal(x, y) else 1 for x, y in zip(a["state"], b["state"]))
    same_losses = a["losses"] == b["losses"] and a["hist"] == b["hist"]
    print(f"{label}: staged against inline: {diff} of {len(a['state'])} state tensors differ, "
          f"every loss equal {same_losses} ({sum(map(len, a['losses']))} readings)", flush=True)
    check(diff == 0 and same_losses, f"{label}: staging changed the run")
    check(np.isfinite(np.asarray(a["losses"][0])).all(), f"{label}: a non-finite loss")
    launched = collections.Counter()
    for r in runs.values():
        launched.update(replayed_by_kernel(r["rep"]))
    return launched


class _StallingGraphs:
    """A dataset whose ``__getitem__`` blocks ``seconds`` once, at index
    ``at`` (a wedged fetch), or raises there (``fail``)."""

    def __init__(self, graphs, at: int, seconds: float = 0.0, fail: bool = False):
        self.graphs, self.at, self.seconds, self.fail = graphs, at, seconds, fail
        self.blocked = 0

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, i):
        if i == self.at and not self.blocked:
            self.blocked += 1
            if self.fail:
                raise OSError(f"fetch of sample {i} failed")
            time.sleep(self.seconds)
        return self.graphs[i]


def run_watchdog(graphs) -> None:
    """(b) The loader's stall watchdog: a fetch blocking past
    ``stall_timeout`` raises ``LoaderStallError`` within the timeout plus
    one watchdog period of the consumer's ask, counted once in
    ``hydragnn_loader_stalls_total`` with a ``loader_stall`` event; a
    fetch that raises delivers its exception to the consumer; neither
    leaves the producer thread alive."""
    from hydragnn_tpu_torch.data import pipeline
    from hydragnn_tpu_torch.data.graph import SpecLadder
    from hydragnn_tpu_torch.obs.events import EV_LOADER_STALL, events
    from hydragnn_tpu_torch.obs.registry import registry

    label = "data_plane (b)"
    ladder = SpecLadder.for_dataset(graphs, 8)
    events().clear()
    stall = _StallingGraphs(graphs, at=40, seconds=STALL_BLOCK_S)
    loader = pipeline.GraphLoader(stall, 8, spec=ladder, shuffle=False, prefetch=2,
                                  stall_timeout=STALL_TIMEOUT_S, source="stall_check")
    delivered, raised, t_ask = 0, None, None
    it = iter(loader)
    try:
        while True:
            t_ask = time.time()
            next(it)
            delivered += 1
    except pipeline.LoaderStallError as e:
        raised = e
    except StopIteration:
        pass
    ev = [e for e in events().snapshot() if e["kind"] == EV_LOADER_STALL]
    waited = ev[0]["ts"] - t_ask if ev else float("nan")
    stalls = registry().get("hydragnn_loader_stalls_total").value(source="stall_check")
    thread = loader._producer_thread
    thread.join(timeout=STALL_BLOCK_S)
    limit = STALL_TIMEOUT_S + pipeline._WATCHDOG_TICK_S + STALL_SLACK_S
    print(f"{label}: a fetch blocking {STALL_BLOCK_S} s after {delivered} batches: "
          f"{type(raised).__name__} {waited:.3f} s after the consumer's ask (limit {limit:.3f} "
          f"s: timeout {STALL_TIMEOUT_S} + one watchdog period "
          f"{pipeline._WATCHDOG_TICK_S} + {STALL_SLACK_S}); hydragnn_loader_stalls_total "
          f"{stalls}; {len(ev)} loader_stall event(s) ({ev[0]['cause'] if ev else None}); the "
          f"producer alive afterwards {thread.is_alive()}", flush=True)
    check(raised is not None and waited <= limit, f"{label}: the wedged producer")
    check(stalls == 1 and len(ev) == 1 and not thread.is_alive(),
          f"{label}: the stall's counter, event or producer thread")
    failing = _StallingGraphs(graphs, at=40, fail=True)
    loader = pipeline.GraphLoader(failing, 8, spec=ladder, shuffle=False, prefetch=2,
                                  stall_timeout=STALL_TIMEOUT_S, source="stall_check")
    got = None
    try:
        for _ in loader:
            pass
    except OSError as e:
        got = e
    thread = loader._producer_thread
    thread.join(timeout=STALL_BLOCK_S)
    print(f"{label}: a fetch raising in the producer reaches the consumer as "
          f"{type(got).__name__}: {got}; the producer alive afterwards {thread.is_alive()}",
          flush=True)
    check(got is not None and "sample 40" in str(got) and not thread.is_alive(),
          f"{label}: the producer's exception")


def example_data(label: str, root: Path):
    """The recipe's data made by the port's generator and written by the
    port's ``ColumnarWriter`` (CSCE's with its SMILES strings), and its
    config: the committed JSON with the data's path. Returns (config,
    seconds)."""
    from hydragnn_tpu_torch.data import ColumnarWriter, ani1x_shaped_dataset
    from hydragnn_tpu_torch.data import smiles as port_smiles

    t0 = time.perf_counter()
    config = json.loads((REPO / EXAMPLE_JSON[label]).read_text())
    arch = config["NeuralNetwork"]["Architecture"]
    path = root / label
    n = EXAMPLE_GRAPHS[label]
    if label == "ani1x_config":
        ColumnarWriter(str(path)).add(ani1x_shaped_dataset(
            number_configurations=n, radius=arch["radius"],
            max_neighbours=arch["max_neighbours"])).save()
    else:
        strings = []
        parse = port_smiles.smiles_to_graph

        def recording(s, *a, **kw):
            g = parse(s, *a, **kw)
            strings.append(s)
            return g

        with swapped([(port_smiles, "smiles_to_graph", recording)]):
            graphs = port_smiles.smiles_table_dataset(number_configurations=n)
        check(len(strings) == len(graphs), f"{label}: {len(strings)} strings for "
                                           f"{len(graphs)} molecules")
        w = ColumnarWriter(str(path)).add(graphs)
        w.add_string("smiles", strings)
        w.save()
        check(port_smiles.columnar_schema_current(str(path)),
              f"{label}: the written feature table is not the current SMILES schema")
    config["Dataset"]["path"]["total"] = str(path)
    config["NeuralNetwork"]["Training"]["num_epoch"] = 1
    return config, time.perf_counter() - t0


def run_example_config(label: str, config, data_s: float, device):
    """(c), (d) One example recipe from its committed JSON: ``prepare_data``
    then ``run_training`` (the config written to ``<label>.json`` and passed
    as a path, no device given; ``EXAMPLE_STEPS`` steps, no val/test)
    under deterministic algorithms, each kernel of the path launched every
    step; then the same first steps through the kernels against the plain
    versions of the recipe's kernels (``EXAMPLE_RTOL``): step 0's loss and
    gradients (and ANI-1x's forces head at the initial weights), and the
    later steps within the trajectory limit or three rounding draws.
    Returns the launches by (kernel, case) of ``run_training``."""
    import numpy as np

    from hydragnn_tpu_torch import api
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train import make_train_step

    wrappers = _wrappers()
    kernel, rtol = EXAMPLE_RTOL[label]
    t0 = time.perf_counter()
    done, loaders, _ = api.prepare_data(copy.deepcopy(config))
    prep_s = time.perf_counter() - t0
    arch = done["NeuralNetwork"]["Architecture"]
    cfg_path = Path(f"{label}.json").resolve()
    cfg_path.write_text(json.dumps(config))
    losses, seconds, graphs = [], [], []
    _zero_launches(wrappers)
    with contextlib.ExitStack() as stack:
        stack.enter_context(deterministic())
        stack.enter_context(_env(HYDRAGNN_MAX_NUM_BATCH=EXAMPLE_STEPS, HYDRAGNN_VALTEST=0))
        stack.enter_context(step_probe(losses, seconds, graphs))
        _, state, hist = api.run_training(str(cfg_path), seed=SEED)
    steps = int(state.step)
    counts = {k: dict(collections.Counter(w.launches_by_case) + w.replayed_by_case)
              for k, w in wrappers.items()}
    per_step = {k: {c: n // steps for c, n in cases.items()} for k, cases in counts.items()
                if cases}
    print(f"{label}: {EXAMPLE_JSON[label]}: {EXAMPLE_GRAPHS[label]} graphs made and written in "
          f"{data_s:.2f} s; {arch['mpnn_type']} hidden {arch['hidden_dim']} x "
          f"{arch['num_conv_layers']}, heads {head_dims(arch)}, batch "
          f"{done['NeuralNetwork']['Training']['batch_size']}, sorted aggregation "
          f"{arch['use_sorted_aggregation']}, fused {arch['use_fused_edge_kernel']}; "
          f"prepare_data {prep_s:.2f} s; run_training {steps} steps, losses "
          f"{[round(float(v), 6) for v in losses]}, step ms {[round(s * 1e3, 2) for s in seconds]}"
          f"; launches {counts}", flush=True)
    check(state.step.device.type == "cuda" and steps == EXAMPLE_STEPS == len(losses)
          and int(state.skipped_steps) == 0 and all(math.isfinite(float(v)) for v in losses),
          f"{label}: run_training did not take {EXAMPLE_STEPS} finite steps on the card")
    for k in EXAMPLE_KERNELS[label]:
        check(bool(counts[k]), f"{label}: {k} never launched")
    check(all(n % steps == 0 for cases in counts.values() for n in cases.values())
          and set(k for k, c in counts.items() if c) == set(EXAMPLE_KERNELS[label]),
          f"{label}: launches {counts} are not the same every step of its kernels")
    lr = config["NeuralNetwork"]["Training"]["Optimizer"]["learning_rate"]
    loaders[0].set_epoch(0)
    batches = list(loaders[0])[:EXAMPLE_STEPS]
    model = create_model(done, device=device, seed=SEED)

    def make_step(st):
        return lambda b: make_train_step(st.model)(st, b)

    swap = EXAMPLE_KERNELS[label]
    with deterministic():
        grads = route_gradients(model, batches[0], device,
                                {"kernels": ((), None), "plain": (swap, None),
                                 "the plain route again": (swap, None)}, make_step, lr=lr)
        gradients_present(f"{label}: step 0", grads["kernels"], grads["plain"])
        grad_gate("step-0 gradients vs plain route", grads["kernels"], grads["plain"],
                  rtol["gradients"], {"the plain route again": grads["the plain route again"]},
                  cell=label)
        del grads
        if "forces" in rtol:
            forces_gate(label, model, batches[0].to(device), swap, rtol["forces"])
        lk, lp, _, _, _, _, _ = trajectories(label, model, batches, device, make_step, swap,
                                             per_step, lr=lr)
        st = _train_copy(model, device, lr=lr)
        step = make_step(st)
        mod, name, plain = plain_swaps()[kernel]
        with swapped([(mod, name, _rounded_f64(plain))]):
            lc = np.asarray([float(step(b)[1]) for b in batches])
        del st, step, model
    la = np.asarray([float(v) for v in losses])
    step0 = abs(float(lk[0]) - float(lp[0])) / abs(float(lp[0]))
    print(f"{label}: step 0's loss through the kernels {lk[0]:.8g}, the plain versions of "
          f"{'/'.join(swap)} {lp[0]:.8g}, relative {step0:.3g} (limit {rtol['loss']}); the "
          f"kernel route's losses equal run_training's: {bool(np.array_equal(lk, la))}",
          flush=True)
    check(step0 <= rtol["loss"], f"{label}: step 0's loss disagrees with the plain versions")
    draw = float((np.abs(lc - lp) / np.abs(lp)).max())
    trajectory_gate(label, lk, lp, max(rtol["trajectory"], 3 * draw),
                    f"; the rounding draw {lc.tolist()}, largest relative {draw:.3g}")
    return {(k, c): n for k, cases in counts.items() for c, n in cases.items()}


def forces_gate(label: str, model, batch, swap, lim) -> None:
    """The node head ``forces`` at ``model``'s initial weights (eval),
    through the kernels against the plain versions of ``swap``: each real
    row's largest difference over the plain route's largest value, the
    largest and the median row against ``lim``."""
    import torch

    forces = {}
    for route, kernels in (("kernels", ()), ("plain", swap)):
        m = copy.deepcopy(model).eval()
        with deterministic(), plain_versions(kernels):
            forces[route] = m(batch)["forces"].float().detach()
        del m
    mask = batch.node_mask
    rows = ((forces["kernels"] - forces["plain"])[mask].abs().max(dim=1).values
            / float(forces["plain"][mask].abs().max()))
    print(f"{label}: the forces head at the initial weights (eval), kernels vs plain: largest "
          f"row {float(rows.max()):.6g}, median row {float(rows.median()):.6g} (limits {lim})",
          flush=True)
    check(bool(torch.isfinite(forces["kernels"]).all()) and float(rows.max()) <= lim[0]
          and float(rows.median()) <= lim[1], f"{label}: the forces disagree with the plain route")


def run_dist_dataset(graphs, device) -> None:
    """(e) A ``DistDataset`` over the egnn cell's graphs (a POSIX
    shared-memory store named after this process, unlinked at the end)
    feeding ``GraphLoader`` with prefetch on: every batch equal to the
    list-backed loader's bit for bit, and one train step on the first
    batch of each gives the same loss (deterministic, one init)."""
    import os

    import torch

    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.data import DistDataset, GraphLoader, split_dataset
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train import make_train_step

    label = "data_plane (e)"
    done, (tl, _, _), _ = prepare_data(copy.deepcopy(graphs_config("off")),
                                       split_dataset(graphs, 0.9, seed=0))
    from hydragnn_tpu_torch.data.ddstore import _pack_graph

    t0 = time.perf_counter()
    # the arena sized by the samples (POSIX shared memory may be small)
    need = sum(len(_pack_graph(g)) for g in tl.graphs)
    store = DistDataset(tl.graphs, name=f"chip_smoke_dds_{os.getpid()}",
                        capacity_bytes=need + need // 4 + (1 << 20),
                        max_items=len(tl.graphs) + 1)
    put_s = time.perf_counter() - t0
    try:
        kw = dict(spec=tl.ladder, shuffle=True, seed=0, sort_edges=tl.sort_edges)
        listed = list(GraphLoader(tl.graphs, 32, **kw))
        t0 = time.perf_counter()
        stored = list(GraphLoader(store, 32, prefetch=2, **kw))
        read_s = time.perf_counter() - t0
        same = len(listed) == len(stored) and all(same_batches(a, b)
                                                  for a, b in zip(listed, stored))
        model = create_model(done, device=device, seed=SEED)
        loss = {}
        with deterministic():
            for name, b in (("list", listed[0]), ("store", stored[0])):
                st = _train_copy(model, device)
                loss[name] = float(make_train_step(st.model, mixed_precision=True)(st, b)[1])
                del st
        del model
        print(f"{label}: DistDataset of {len(store)} graphs ({store.store.used_bytes} bytes) "
              f"populated in {put_s:.2f} s; {len(stored)} batches through GraphLoader(prefetch "
              f"2) in {read_s:.2f} s, equal to the list-backed loader's bit for bit {same}; one "
              f"step's loss {loss}", flush=True)
        check(same and loss["list"] == loss["store"] and math.isfinite(loss["list"]),
              f"{label}: the store's batches or step")
    finally:
        store.close(unlink=True)


def run_native_neighbors() -> None:
    """(f) The native cell-list builder on an open-boundary cluster of
    ``NATIVE_ATOMS`` atoms (uniform at ``NATIVE_DENSITY``): its edge set
    equals cKDTree's; both times printed."""
    import numpy as np

    from hydragnn_tpu_torch.data import neighbors

    label = "data_plane (f)"
    rng = np.random.default_rng(SEED)
    side = (NATIVE_ATOMS / NATIVE_DENSITY) ** (1.0 / 3.0)
    pos = rng.uniform(0.0, side, (NATIVE_ATOMS, 3))
    t0 = time.perf_counter()
    neighbors._native_lib()
    build_s = time.perf_counter() - t0
    times, keys = {}, {}
    for route, flag in (("native", "1"), ("cKDTree", "0")):
        with _env(HYDRAGNN_NATIVE_NEIGHBORS=flag):
            t0 = time.perf_counter()
            s, r = neighbors.radius_graph(pos, NATIVE_RADIUS)
            times[route] = time.perf_counter() - t0
        keys[route] = np.sort(r.astype(np.int64) * NATIVE_ATOMS + s)
    same = np.array_equal(keys["native"], keys["cKDTree"])
    print(f"{label}: {NATIVE_ATOMS} atoms, radius {NATIVE_RADIUS}: {keys['native'].size} edges "
          f"native in {times['native']:.3f} s (library ready in {build_s:.2f} s), "
          f"{keys['cKDTree'].size} cKDTree in {times['cKDTree']:.3f} s; the same edge set "
          f"{same}", flush=True)
    check(same and keys["native"].size > 0, f"{label}: the edge sets differ")


def run_data_plane(device, train_graphs, examples):
    """The ``data_plane`` phase: (a)-(f) above, in order (``examples``:
    label -> ``example_data``'s (config, seconds), made while the kernels
    built). Returns the launches by (kernel, case)."""
    from hydragnn_tpu_torch.data.synthetic import oc20_shaped_dataset

    t_phase = time.perf_counter()
    launched = collections.Counter()
    launched.update(run_staging(oc20_shaped_dataset(DATA_PLANE_GRAPHS), device,
                                TRAIN_PER_STEP))
    run_watchdog(train_graphs[:128])
    for label, (config, data_s) in examples.items():
        prefix = label.split("_")[0]
        launched.update({(k, f"{prefix}/{c}"): n for (k, c), n in run_example_config(
            label, config, data_s, device).items()})
    run_dist_dataset(train_graphs[:DIST_DATASET_GRAPHS], device)
    run_native_neighbors()
    print(f"data_plane: phase in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launched


# ---------------------------------------------------------------------------
# serve_plane: hot reload, reduced-precision weights, the replica fleet
# ---------------------------------------------------------------------------

SERVE_PLANE_REQUESTS = 192
SERVE_PLANE_WEIGHT_REQUESTS = 96  # a route's stream of (b): 3 full batches
SERVE_PLANE_PACE_S = 0.02  # (a)'s stream: one request every 20 ms (3.8 s)
SERVE_PLANE_PUBLISH_AT = 48  # (a) publishes the second checkpoint after these requests
SERVE_PLANE_GRACE_S = 1.0
# the drift drill runs last, on the weight-only server (it publishes epoch 3)
SERVE_PLANE_ROUTES = (("float32", None), ("bfloat16", None), ("int8", "w8a8"),
                      ("int8", "weight_only"))
SERVE_PLANE_MAX_ERROR = 0.05  # Serving.quantization.max_error (the default), every route
# the served run is trained first (AdamW, as egnn_train): at its random
# initialization the cell's batch norms hold their initial statistics and
# bf16 rounding alone moved the energies 9.3% on an H100 (PERF.md §6);
# run-scripts/torch_quant_sensitivity.py reads both states
SERVE_PLANE_TRAIN_STEPS = 20
# w8a8 keeps the last conv's node MLP in f32 (Serving.quantization.exclude):
# its input concatenates the node features with K2's edge sum, whose scale
# sets the one static activation scale of both; int8 x int8 there moved the
# energies 11.5% (calibrated on real rows; 26.9% on every row), w8a8 without
# it 1.96% (run-scripts/torch_quant_sensitivity.py on an H100, PERF.md §6)
SERVE_PLANE_W8A8_EXCLUDE = ("graph_convs_3/MLP_0",)
# the f32 routes' launches a served batch (mixed precision off: every K1 call f32)
SERVE_PLANE_PER_BATCH = {"K1": {"float32/C866": 3, "float32/C3": 3},
                         "K2": {"float32/866x866": 1}}
SERVE_PLANE_KILL_AT = 40  # replica 1 dies before its 41st /predict
SERVE_PLANE_FLEET_CLIENTS = 16  # concurrent router callers of (c)'s stream
SERVE_PLANE_IDENTITY = 8  # graphs each replica and the local server answer alone
# the fleet's answers against the in-process server's where the two batched
# a request at different ladder levels: the egnn cell's limit for the same
# bf16 cast through other kernels (SERVE_RTOL, largest row)
SERVE_PLANE_FLEET_RTOL = SERVE_RTOL["egnn"]["bf16 plain ops"]["energy"][0]
SERVE_PLANE_READY_S = 420.0
INT8_GEMM_KERNELS = ("i8", "s8", "int8", "imma", "igemm")  # cuBLASLt int8 GEMM names


def _rel_max(got: list, want: list) -> dict:
    """Per head: the largest |got - want| over every answer over the
    largest |want|."""
    import numpy as np

    out = {}
    for k in want[0]:
        err = max(float(np.abs(a[k] - b[k]).max()) for a, b in zip(got, want))
        ref = max(float(np.abs(b[k]).max()) for b in want)
        out[k] = err / max(ref, 1e-12)
    return out


def _per_request(got: list, want: list) -> dict:
    """Per head: the median and the largest of each answer's max |got -
    want| over the largest |want| (where the relative max error sits)."""
    import numpy as np

    out = {}
    for k in want[0]:
        ref = max(float(np.abs(b[k]).max()) for b in want)
        e = np.asarray([float(np.abs(a[k] - b[k]).max()) / max(ref, 1e-12)
                        for a, b in zip(got, want)])
        out[k] = (round(float(np.median(e)), 6), round(float(e.max()), 6))
    return out


def _latency(handles_or_ms) -> str:
    import numpy as np

    lat = np.asarray(handles_or_ms)
    return f"p50 {np.percentile(lat, 50):.2f} ms p99 {np.percentile(lat, 99):.2f} ms"


def _publish(state, log_name: str, epoch: int, flip: bool = False):
    """Save ``state`` as the run's epoch ``epoch`` (payload, sidecar, then
    the ``latest`` pointer); ``flip`` flips one bit of the payload after the
    commit (a corrupt candidate). Returns (entry, the commit's clock)."""
    from hydragnn_tpu_torch.train.checkpoint import save_model
    from hydragnn_tpu_torch.utils.faultinject import flip_bit

    path = save_model(state, log_name, epoch=epoch)
    t_commit = time.perf_counter()
    if flip:
        flip_bit(path)
    return os.path.basename(path), t_commit


def _one_step(state, batch, device):
    """One SGD step of the run (the next checkpoint's weights)."""
    import torch

    from hydragnn_tpu_torch.train.loop import make_train_step

    make_train_step(state.model)(state, batch.to(device))
    torch.cuda.synchronize()


def _eager_answers(server, model, requests, handles, cast):
    """Each served batch rebuilt (its graphs in request order at its
    level) and run eagerly through ``model`` on ``cast(batch)``: the answers
    in request order."""
    import torch

    from hydragnn_tpu_torch.data.graph import batch_graphs

    by_batch = collections.defaultdict(list)
    for i, h in enumerate(handles):
        by_batch[h.batch_index].append(i)
    out = [None] * len(requests)
    with torch.inference_mode():
        for idx in by_batch.values():
            gs = [requests[i] for i in idx]
            batch = batch_graphs(gs, server.ladder.select_for(gs), sort_edges=True)
            o = {k: v.float().cpu().numpy()
                 for k, v in model(cast(batch.to(server.device))).items()}
            off = 0
            for p, (i, g) in enumerate(zip(idx, gs)):
                out[i] = {"energy": o["energy"][p], "forces": o["forces"][off:off + g.num_nodes]}
                off += g.num_nodes
    return out


def _same(got, want) -> bool:
    import numpy as np

    return all(np.array_equal(a[k], b[k]) for a, b in zip(got, want) for k in b)


def run_serve_reload(label, config, splits, requests, device, state, log_name, per_batch):
    """(a) ``hot_reload`` on a run directory holding epoch 0: a paced
    stream of requests during which epoch 1 (one more step of the run) is
    published; the swap count, every answer against the eager forward
    with the weights its batch ran on (bit for bit: the replays after the
    swap read the new weights in place), no request dropped, the seconds
    from the pointer's commit to the first answer on the new weights; a
    bit-flipped epoch 2 rejected while epoch 1 keeps serving; the drain's
    grace window. Returns (launches, the entries)."""
    import torch

    from hydragnn_tpu_torch.api import run_server
    from hydragnn_tpu_torch.train.loop import cast_batch_bf16, mp_cast_model

    wrappers = _wrappers()
    train_batch = next(iter(_train_loader(config, splits)))
    e0, _ = _publish(state, log_name, 0)
    ref = {e0: mp_cast_model(state.model).eval()}
    _one_step(state, train_batch, device)  # epoch 1's weights, published mid-stream
    cfg = copy.deepcopy(config)
    cfg["Serving"] = {"hot_reload": True, "reload_poll_s": 0.05,
                      "drain_grace_s": SERVE_PLANE_GRACE_S, "http_port": 0}
    t0 = time.perf_counter()
    server = run_server(cfg, datasets=splits, device=device)
    check(server.wait_ready(timeout=600), f"{label}: warm-up failed: {server.failed}")
    check(server.current_checkpoint == e0, f"{label}: restored {server.current_checkpoint}")
    print(f"{label}: (a) reload server ready in {time.perf_counter() - t0:.2f} s on {e0}",
          flush=True)
    watcher = server._watcher
    batches0 = server.stats()["batches"]
    _zero_launches(wrappers)
    handles, published = [], {}
    t_start = time.perf_counter()
    for i, g in enumerate(requests):
        if i == SERVE_PLANE_PUBLISH_AT:
            e1, published["t_commit"] = _publish(state, log_name, 1)
            ref[e1] = mp_cast_model(state.model).eval()
        handles.append(server.submit(g))
        time.sleep(max(0.0, t_start + (i + 1) * SERVE_PLANE_PACE_S - time.perf_counter()))
    answers = [h.result(timeout=600) for h in handles]
    torch.cuda.synchronize()
    stats = server.stats()
    launched = _check_launches(f"{label} (a) reload stream", wrappers, per_batch,
                               stats["batches"] - batches0, "batches")
    labels = [h.checkpoint for h in handles]
    swapped = [i for i, c in enumerate(labels) if c == e1]
    check(stats["reloads"] == 1 and watcher.installed == 1 and watcher.rejected == 0,
          f"{label}: swaps {stats['reloads']}, watcher {watcher.installed} installed / "
          f"{watcher.rejected} rejected")
    check(stats["failed_batches"] == 0 and stats["rejected"] == 0 and len(answers) == len(requests),
          f"{label}: dropped requests: {stats}")
    check(bool(swapped) and set(labels) == {e0, e1} and labels == sorted(labels, key=[e0, e1].index),
          f"{label}: answers by checkpoint {collections.Counter(labels)}, not e0 then e1")
    first_new = min(handles[i].done_at for i in swapped)
    want = [None] * len(requests)
    for entry in (e0, e1):
        idx = [i for i, c in enumerate(labels) if c == entry]
        got = _eager_answers(server, ref[entry], [requests[i] for i in idx],
                             [handles[i] for i in idx], cast_batch_bf16)
        for i, w in zip(idx, got):
            want[i] = w
    check(_same(answers, want), f"{label}: a served answer differs from the eager forward with "
                                f"the weights of its batch")
    print(f"{label}: (a) {len(requests)} requests in {stats['batches'] - batches0} batches, "
          f"{len(requests) - len(swapped)} on {e0}, {len(swapped)} on {e1} (1 swap, 0 dropped), "
          f"every answer equal to the eager forward with its batch's weights bit for bit; "
          f"pointer commit to the first answer on {e1}: "
          f"{first_new - published['t_commit']:.3f} s", flush=True)
    # a corrupt candidate: epoch 2 bit-flipped; the walk-back lands on
    # epoch 1, which is rejected, and epoch 1 keeps serving
    _one_step(state, train_batch, device)
    e2, _ = _publish(state, log_name, 2, flip=True)
    t0 = time.perf_counter()
    while watcher.rejected == 0 and time.perf_counter() - t0 < 30:
        time.sleep(0.05)
    check(watcher.rejected == 1, f"{label}: the corrupt {e2} was not rejected")
    tail = requests[:32]
    hs = [server.submit(g) for g in tail]
    got = [h.result(timeout=600) for h in hs]
    check({h.checkpoint for h in hs} == {e1} and _same(
        got, _eager_answers(server, ref[e1], tail, hs, cast_batch_bf16)),
        f"{label}: after the rejection the answers are not epoch 1's")
    # the drain's grace window: /readyz 503 at once, admissions still open
    port = server.http_port
    server.initiate_drain()
    code, _ = http_get(f"http://127.0.0.1:{port}/readyz")
    h = server.submit(requests[0])
    check(code == 503 and h.result(timeout=60) is not None,
          f"{label}: draining /readyz {code}, or a request in the grace window failed")
    print(f"{label}: (a) {e2} (one bit flipped) rejected, {len(tail)} requests on {e1} after it; "
          f"draining: /readyz {code}, a request admitted in the {SERVE_PLANE_GRACE_S} s grace",
          flush=True)
    server.close()
    return launched, (e0, e1, e2)


def _train_loader(config, splits):
    from hydragnn_tpu_torch.api import prepare_data

    _, (train_loader, _, _), _ = prepare_data(copy.deepcopy(config), splits)
    return train_loader


def run_serve_weights(label, config, splits, requests, device, state, log_name, entry):
    """(b) The f32, bf16 and int8 (weight-only and w8a8) servers on the
    same checkpoint, mixed precision off: each route's relative max error
    against the f32 server's answers, held to ``Serving.quantization.
    max_error``; K1 and K2 launches a batch unchanged; w8a8's ``_int_mm``
    device kernels under the profiler; graphs/s, p50/p99 and the weight
    bytes on the card of each route; the drift drill refused at a reload
    with epoch 1 still serving. Returns the launches."""
    import torch

    from hydragnn_tpu_torch.api import run_server
    from hydragnn_tpu_torch.data.graph import batch_graphs
    from hydragnn_tpu_torch.obs.events import EV_QUANT_DRIFT
    from hydragnn_tpu_torch.obs.events import events as event_log
    from hydragnn_tpu_torch.ops import quant
    from hydragnn_tpu_torch.serve.quantize import QuantizedDense

    wrappers = _wrappers()
    launched = collections.Counter()
    f32_answers, names, report = None, {}, []
    train_batch = next(iter(_train_loader(config, splits)))
    for dtype, mode in SERVE_PLANE_ROUTES:
        route = dtype if mode is None else f"{dtype} {mode}"
        cfg = copy.deepcopy(config)
        cfg["NeuralNetwork"]["Training"]["mixed_precision"] = False
        drill = dtype == "int8" and mode == "weight_only"
        cfg["Serving"] = {"weights_dtype": dtype, "http_port": -1, "hot_reload": drill,
                          "reload_poll_s": 3600.0}
        if mode is not None:
            cfg["Serving"]["quantization"] = {
                "mode": mode, "max_error": SERVE_PLANE_MAX_ERROR,
                "exclude": list(SERVE_PLANE_W8A8_EXCLUDE if mode == "w8a8" else ())}
        t0 = time.perf_counter()
        server = run_server(cfg, datasets=splits, device=device)
        check(server.wait_ready(timeout=600), f"{label} {route}: warm-up failed: {server.failed}")
        ready_s = time.perf_counter() - t0
        check(server.current_checkpoint == entry, f"{label} {route}: on {server.current_checkpoint}")
        batches0 = server.stats()["batches"]
        _zero_launches(wrappers)
        t_start = time.perf_counter()
        handles = [server.submit(g) for g in requests]
        answers = [h.result(timeout=600) for h in handles]
        gps = len(requests) / (max(h.done_at for h in handles) - t_start)
        torch.cuda.synchronize()
        stats = server.stats()
        launched.update(_check_launches(f"{label} (b) {route}", wrappers, SERVE_PLANE_PER_BATCH,
                                        stats["batches"] - batches0, "batches"))
        lat = [1e3 * (h.done_at - h.submitted_at) for h in handles]
        nbytes = server.weight_nbytes()
        if f32_answers is None:
            f32_answers, errs, spread = answers, {k: 0.0 for k in answers[0]}, {}
        else:
            errs = _rel_max(answers, f32_answers)
            spread = _per_request(answers, f32_answers)
            check(max(errs.values()) <= SERVE_PLANE_MAX_ERROR,
                  f"{label} {route}: relative max error {errs} past {SERVE_PLANE_MAX_ERROR}")
        gate = stats.get("quantization")
        print(f"{label}: (b) {route}: ready in {ready_s:.2f} s, {len(requests)} requests in "
              f"{stats['batches'] - batches0} batches, {gps:.1f} graphs/s, {_latency(lat)}; "
              f"weight bytes on the card {nbytes} ({nbytes / 2**20:.2f} MiB); relative max error "
              f"against f32 {errs} (limit {SERVE_PLANE_MAX_ERROR}; per request, median and "
              f"largest: {spread})" + (f"; gate {gate}" if gate else ""), flush=True)
        report.append((route, gps, nbytes, errs))
        if mode == "w8a8":
            # the int8 products of one eager forward, under the profiler
            w8a8 = [m for m in server._serve_model.modules()
                    if isinstance(m, QuantizedDense) and m.act_scale is not None]
            gs = [g for g, h in zip(requests, handles) if h.batch_index == handles[0].batch_index]
            batch = batch_graphs(gs, server.ladder.select_for(gs),
                                 sort_edges=server.sort_edges).to(server.device)
            for _ in range(2):  # the first profile warms the profiler up (a cold one drops kernels)
                calls0 = quant.int_mm_calls
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    server._placed_forward(batch)
                    torch.cuda.synchronize()
            n_calls = quant.int_mm_calls - calls0
            kernels = {e.key: e.count for e in _device_events(prof)}
            int8 = {k: n for k, n in kernels.items()
                    if any(s in k.lower() for s in INT8_GEMM_KERNELS)}
            check(n_calls == len(w8a8) > 0 and sum(int8.values()) >= len(w8a8),
                  f"{label} w8a8: {n_calls} _int_mm calls and "
                  f"{sum(int8.values())} int8 GEMM kernels for {len(w8a8)} w8a8 layers")
            int8_product_row(label, batch)
            print(f"{label}: (b) w8a8: {len(w8a8)} layers run int8 x int8; one eager forward "
                  f"made {n_calls} _int_mm calls, {sum(int8.values())} int8 "
                  f"device kernels ({ {_short(k, 70): n for k, n in int8.items()} }) of "
                  f"{sum(kernels.values())}", flush=True)
        if drill:
            # the drift drill: the next checkpoint, quantized with its
            # scales distorted, is refused by the gate; epoch 1 serves on
            _one_step(state, train_batch, device)
            e3, _ = _publish(state, log_name, 3)
            served = {n: t.detach().clone() for n, t in server._served_tensors.items()}
            event_log().clear()
            os.environ["HYDRAGNN_FAULT_QUANT_DRIFT"] = f"{e3}:8"
            try:
                verdict = server._watcher.poll_once()
            finally:
                os.environ.pop("HYDRAGNN_FAULT_QUANT_DRIFT")
            drift = [e for e in event_log().snapshot() if e["kind"] == EV_QUANT_DRIFT]
            hs = [server.submit(g) for g in requests[:32]]
            after = [h.result(timeout=600) for h in hs]
            unchanged = all(torch.equal(t, served[n]) for n, t in server._served_tensors.items())
            check(verdict == "rejected" and len(drift) == 1 and drift[0]["candidate"] == e3
                  and server.current_checkpoint == entry and unchanged
                  and {h.checkpoint for h in hs} == {entry}
                  and _same(after, _eager_answers(server, server._serve_model, requests[:32],
                                                  hs, lambda b: b)),
                  f"{label}: the drift drill: {verdict}, events {drift}, serving "
                  f"{server.current_checkpoint}, served tensors unchanged {unchanged}")
            print(f"{label}: (b) drift drill: {e3} refused (QuantizationDriftError, max error "
                  f"{drift[0]['max_error']:.3g} past {drift[0]['limit']}), {entry} still "
                  f"serving: every served tensor unchanged, 32 answers from it", flush=True)
        server.close()
    return launched


PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core rate of the H100 SXM, ops/s


def int8_product_row(label: str, batch) -> None:
    """The int8 product (``ops/quant.py`` ``int8_matmul``: ``torch._int_mm``,
    a library call behind no TPU kernel) at the EGNN's widths, 866 x 866,
    on a served batch's edge rows and node rows: its time beside the f32
    (TF32 off) and bf16 GEMM of the same shape, its bound (int8 operations
    over the int8 rate, or bytes over 3.35 TB/s), bit for bit against the
    card's f64 product (exact: every partial sum is an integer below
    866 * 127^2 < 2^53) and, on the node rows, against the plain version
    (the widened int32 product on the CPU)."""
    import torch

    from hydragnn_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k = n = 866
    w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
    w_pad = quant.pad_weight(w)
    for what, rows in (("edges", batch.num_edges), ("nodes", batch.num_nodes)):
        x = torch.randint(-127, 128, (rows, k), generator=gen, device="cuda", dtype=torch.int8)
        got = quant.int8_matmul(x, w_pad)[:, :n]
        want = (x.double() @ w.double()).to(torch.int32)
        check(torch.equal(got, want), f"{label}: _int_mm differs from the exact product")
        if what == "nodes":
            check(torch.equal(got.cpu(), quant.int8_matmul(x.cpu(), w.cpu())),
                  f"{label}: _int_mm differs from its plain version")
        xf, wf = x.float(), w.float()
        xb, wb = xf.bfloat16(), wf.bfloat16()
        ms = cuda_ms(lambda: quant.int8_matmul(x, w_pad), 20)
        f32 = cuda_ms(lambda: torch.mm(xf, wf), 20)
        bf16 = cuda_ms(lambda: torch.mm(xb, wb), 20)
        ops = 2.0 * rows * k * n
        nbytes = rows * k + k * n + 4 * rows * n
        bound = max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES_PER_S) * 1e3
        print(f"{label}: int8 product [{rows}, {k}] x [{k}, {n}] ({what}): _int_mm "
              f"{ms:.4f} ms (bound {bound:.4f} ms, "
              f"{'operations' if ops / PEAK_INT8_OPS > nbytes / PEAK_BYTES_PER_S else 'bytes'}), "
              f"f32 GEMM {f32:.4f} ms, bf16 GEMM {bf16:.4f} ms; equal to the exact product"
              + (" and to the plain version" if what == "nodes" else ""),
              flush=True)


def _fleet_data(graphs, root: Path):
    """The egnn cell's graphs in the raw layout its config's Dataset
    section describes (x = atomic number, coordinates, forces; graph_y =
    energy), written by the port's ColumnarWriter: what the replicas load."""
    import numpy as np

    from hydragnn_tpu_torch.data import ColumnarWriter

    raw = [dataclasses.replace(
        g, x=np.concatenate([g.x, g.node_targets["forces"]], axis=1).astype(np.float32),
        graph_y=np.asarray(g.graph_targets["energy"], np.float32),
        graph_targets=None, node_targets=None) for g in graphs]
    path = root / "serve_plane_columnar"
    ColumnarWriter(str(path)).add(raw).save()
    return path


def _replica_stats(fleet):
    with fleet._lock:
        reps = [r for r in fleet._replicas.values() if r.port is not None]
    return {r.index: fleet._replica_stat(r, "kernel_launches") for r in reps}, \
        {r.index: fleet._replica_stat(r, "current_checkpoint") for r in reps}


def start_serve_fleet(label, config, graphs, state, log_name, root: Path):
    """(c)'s start: the config's Dataset written to disk, the run's newest
    weights published in the fleet's own run directory (``root/fleet``, the
    replicas' working directory) and ``run_server_fleet`` with 2 replicas
    on the card, not waited for: they start while (a) and (b) run (their
    graphs/s and latencies are read beside the replicas' start). Returns
    what ``run_serve_fleet`` needs."""
    from hydragnn_tpu_torch.api import prepare_data, run_server_fleet
    from hydragnn_tpu_torch.obs.events import events as event_log

    cfg = copy.deepcopy(config)
    cfg["Dataset"].update({"format": "columnar", "mode": "mmap",
                           "path": {"total": str(_fleet_data(graphs, root))}})
    cfg["Serving"] = {"prediction_cache": True, "fleet_restart_backoff_s": 0.5,
                      "reload_probe_requests": 8, "router_timeout_s": 120.0}
    fleet_dir = root / "fleet"
    fleet_dir.mkdir()
    config_path = fleet_dir / "serve_plane_fleet.json"
    config_path.write_text(json.dumps(cfg))
    _, loaders, _ = prepare_data(json.loads(json.dumps(cfg)))
    pool = [g for loader in loaders for g in loader.graphs]
    event_log().clear()
    with contextlib.chdir(fleet_dir):
        entry, _ = _publish(state, log_name, 0)
        t0 = time.perf_counter()
        fleet = run_server_fleet(str(config_path), replicas=2, per_replica_env={
            1: {"HYDRAGNN_FAULT_REPLICA_KILL": f"1:{SERVE_PLANE_KILL_AT}"}})
    print(f"{label}: (c) 2 replicas started on {entry} (the run's weights), from "
          f"{fleet_dir.name}/", flush=True)
    return {"fleet": fleet, "t0": t0, "config_path": config_path, "dir": fleet_dir,
            "requests": [pool[i % len(pool)] for i in range(SERVE_PLANE_REQUESTS)],
            "entry": entry}


def run_fleet_stream(label, ctx):
    """(c)'s stream, on the fleet ``start_serve_fleet`` started, through its
    router: 192 requests from 16 callers while replica 1 is killed before
    its 41st request: 0 failed, the retry counted, the supervisor's
    ``replica_exit``. Returns (the answers, the fleet's graphs/s, the exit
    event); replica 1 restarts while (a) and (b) run."""
    import concurrent.futures

    from hydragnn_tpu_torch.obs.events import events as event_log

    fleet, requests = ctx["fleet"], ctx["requests"]
    check(fleet.wait_ready(timeout=SERVE_PLANE_READY_S), f"{label}: the fleet did not "
          f"become ready: {fleet.replica_state()}")
    print(f"{label}: (c) 2 replicas ready {time.perf_counter() - ctx['t0']:.2f} s after "
          f"their start ({fleet.replica_state()})", flush=True)
    router = fleet.router()
    fleet._refresh_cache_context()
    check(router.cache is not None and router.cache.context is not None,
          f"{label}: the prediction cache has no context")

    def call(g):
        t = time.perf_counter()
        out = router.predict(g)
        return out, 1e3 * (time.perf_counter() - t)

    t_start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(SERVE_PLANE_FLEET_CLIENTS) as ex:
        results = list(ex.map(call, requests))
    fleet_s = time.perf_counter() - t_start
    first = [r for r, _ in results]
    st = router.stats()
    t_wait = time.perf_counter()
    while True:  # the supervisor notices the death within a tick or two
        exits = [e for e in event_log().snapshot() if e["kind"] == "replica_exit"]
        if exits or time.perf_counter() - t_wait > 30:
            break
        time.sleep(0.1)
    check(st["failed"] == 0 and st["succeeded"] == len(requests) and st["retries"] >= 1
          and exits and exits[0]["replica"] == 1,
          f"{label}: router {st}, exits {exits}")
    print(f"{label}: (c) fleet: {len(requests)} requests from {SERVE_PLANE_FLEET_CLIENTS} "
          f"callers, {len(requests) / fleet_s:.1f} graphs/s, {_latency([m for _, m in results])}"
          f"; replica 1 killed before its request {SERVE_PLANE_KILL_AT + 1}: 0 failed, "
          f"{st['retries']} retried; router "
          f"{ {k: st[k] for k in ('succeeded', 'retries', 'hedges', 'cache_hits')} }",
          flush=True)
    return first, len(requests) / fleet_s, exits[0]


def fleet_against_local(label, requests, got, want) -> None:
    """(c)'s first pass through the router (across the kill, its retries and
    hedges included) against the in-process server's answers to the same
    requests, request by request: the same heads and shapes, and bit for bit,
    or, where the two servers batched the request at different ladder
    levels (whose GEMM shapes round otherwise in bf16), within
    ``SERVE_PLANE_FLEET_RTOL`` of the head's largest value; and each answer
    nearer the in-process server's answer to its own graph than to its
    answer to any other graph with as many atoms, so an answer delivered to
    the wrong caller fails."""
    import numpy as np

    ref = {k: max(float(np.abs(w[k]).max()) for w in want) for k in want[0]}

    def dist(a, b):
        if set(a) != set(b) or any(a[k].shape != b[k].shape for k in b):
            return float("inf")
        return max(float(np.abs(a[k] - b[k]).max()) / max(ref[k], 1e-12) for k in b)

    errs = [dist(a, b) for a, b in zip(got, want)]
    exact = sum(all(np.array_equal(a[k], b[k]) for k in b) for a, b in zip(got, want))
    answers = {}  # atoms -> graph -> the in-process server's answer
    for g, w in zip(requests, want):
        answers.setdefault(g.num_nodes, {})[id(g)] = w
    nearest_other = [min((dist(a, w) for other, w in answers[g.num_nodes].items()
                          if other != id(g)), default=float("inf"))
                     for g, a in zip(requests, got)]
    wrong = [i for i, (e, o) in enumerate(zip(errs, nearest_other))
             if e > SERVE_PLANE_FLEET_RTOL or not (e < o or e == 0.0)]
    check(len(got) == len(want) and not wrong,
          f"{label}: the fleet's answers to requests {wrong[:8]} lie "
          f"{[errs[i] for i in wrong[:8]]} of the head's largest value from the in-process "
          f"server's (limit {SERVE_PLANE_FLEET_RTOL}), and "
          f"{[nearest_other[i] for i in wrong[:8]]} from its answer to another graph")
    print(f"{label}: (c) the fleet's {len(got)} answers against the in-process server's: "
          f"{exact} bit for bit, the largest of the rest {max(errs):.3g} of the head's "
          f"largest value (limit {SERVE_PLANE_FLEET_RTOL}); each nearer its own graph's "
          f"answer than any other graph's, the nearest other at least "
          f"{min(nearest_other):.3g}", flush=True)


def finish_serve_fleet(label, ctx, device, state, log_name, launched, stream):
    """(c) after the stream: the in-process server on the same config (its
    graphs/s and p50/p99 beside the fleet's; the stream's 192 answers held
    against its own, ``fleet_against_local``), replica 1 back ready (the
    seconds since its exit); each replica's answers to 8 graphs sent alone
    against the in-process server's, bit for bit; a second pass all cache
    hits, bit-identical; a rolling reload to the next checkpoint on both
    replicas; K1 and K2 launched in each replica. ``launched`` gathers the
    in-process server's launches."""
    import torch

    from hydragnn_tpu_torch.api import run_server
    from hydragnn_tpu_torch.serve import HTTPReplicaClient

    fleet, requests, config_path = ctx["fleet"], ctx["requests"], ctx["config_path"]
    first, fleet_gps, exit_event = stream
    router = fleet.router()
    local = None
    try:
        # the in-process server on the same config
        wrappers = _wrappers()
        with contextlib.chdir(ctx["dir"]):
            local = run_server(str(config_path), device=device)
        check(local.wait_ready(timeout=600), f"{label}: local server: {local.failed}")
        batches0 = local.stats()["batches"]
        _zero_launches(wrappers)
        t_start = time.perf_counter()
        handles = [local.submit(g) for g in requests]
        local_answers = [h.result(timeout=600) for h in handles]
        local_gps = len(requests) / (max(h.done_at for h in handles) - t_start)
        torch.cuda.synchronize()
        launched.update(_check_launches(
            f"{label} (c) local server", wrappers,
            {"K1": {"bfloat16/C866": 1, "float32/C866": 2, "bfloat16/C3": 1, "float32/C3": 2},
             "K2": {"float32/866x866": 1}}, local.stats()["batches"] - batches0, "batches"))
        lat = [1e3 * (h.done_at - h.submitted_at) for h in handles]
        print(f"{label}: (c) local server on the same config: {local_gps:.1f} graphs/s, "
              f"{_latency(lat)} (fleet {fleet_gps:.1f} graphs/s)", flush=True)
        fleet_against_local(label, requests, first, local_answers)
        check(fleet.wait_ready(timeout=SERVE_PLANE_READY_S), f"{label}: replica 1 did not come "
              f"back: {fleet.replica_state()}")
        back_s = time.time() - exit_event["ts"]
        check(fleet.replica_state()[1]["restarts"] >= 1, f"{label}: {fleet.replica_state()}")
        launches0, on = _replica_stats(fleet)
        check(set(on.values()) == {local.current_checkpoint},
              f"{label}: replicas on {on}, the local server on {local.current_checkpoint}")
        clients = {i: HTTPReplicaClient(f"http://127.0.0.1:{r.port}", name=f"replica{i}")
                   for i, r in fleet._replicas.items()}
        for g in requests[:SERVE_PLANE_IDENTITY]:
            want = local.submit(g).result(timeout=600)
            for i, c in clients.items():
                got = c.predict(g, timeout_s=120.0)
                check(all(got[k].tobytes() == want[k].tobytes() for k in want),
                      f"{label}: replica {i}'s answer differs from the in-process server's")
        local.close()
        local = None
        hits0 = router.stats()["cache_hits"]
        again = [router.predict(g) for g in requests]
        hits = router.stats()["cache_hits"] - hits0
        check(hits == len(requests) and all(a[k].tobytes() == b[k].tobytes()
                                            for a, b in zip(again, first) for k in b),
              f"{label}: second pass {hits} hits of {len(requests)}, or a hit differs")
        print(f"{label}: (c) replica 1 back ready {back_s:.2f} s after its exit; each "
              f"replica's answers to {SERVE_PLANE_IDENTITY} graphs served alone equal the "
              f"in-process server's bit for bit; second pass {hits} cache hits of "
              f"{len(requests)}, bit-identical", flush=True)
        # the rolling reload to the next checkpoint
        with contextlib.chdir(ctx["dir"]):
            e1, _ = _publish(state, log_name, 1)
        t0 = time.perf_counter()
        res = fleet.rolling_reload(requests[:8], timeout_s=300.0)
        launches1, on = _replica_stats(fleet)
        check(res["status"] == "done" and res["installed"] == 2 and set(on.values()) == {e1},
              f"{label}: rolling reload {res}, replicas on {on}")
        for i in (1, 2):
            for k in ("sorted_segment_sum", "fused_edge_message_sum"):
                before = sum(launches0.get(i, {}).get(k, {}).values())
                after = sum(launches1[i].get(k, {}).values())
                check(after > before, f"{label}: replica {i} launched {k} {after - before} "
                                      f"times in (c)'s later passes")
        print(f"{label}: (c) rolling reload to {e1} in {time.perf_counter() - t0:.2f} s: {res}; "
              f"kernel launches a replica {launches1}", flush=True)
        for i in (1, 2):
            log = Path(fleet.run_dir) / f"replica_{i}.log"
            lines = [ln for ln in log.read_text().splitlines() if "REPLICA_READY" in ln]
            print(f"{label}: (c) replica {i}: {lines}", flush=True)
    finally:
        if local is not None:
            local.close()
        fleet.close()


def prepare_serve_plane(device, graphs, root: Path):
    """``serve_plane``'s start: the egnn cell at full width trained
    ``SERVE_PLANE_TRAIN_STEPS`` AdamW steps (mixed precision, as
    egnn_train), its checkpoints under SGD (the model alone: saves and
    restores move the 88 MB of weights), and the fleet of (c) started in
    ``root/fleet`` (``start_serve_fleet``): the full smoke makes it before
    the multi-GPU phases, whose processes start beside the replicas'
    (no timing gate in them). Returns what ``run_serve_plane`` needs."""
    import torch

    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.config.config import get_log_name_config
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train import TrainState, make_optimizer
    from hydragnn_tpu_torch.train.loop import make_train_step

    label = "serve_plane"
    config = serving_config()
    splits = split_dataset(graphs, 0.9, seed=0)
    done, _, _ = prepare_data(copy.deepcopy(config), splits)
    log_name = get_log_name_config(done)
    model = create_model(done, device=device, seed=SEED)
    t0 = time.perf_counter()
    train = TrainState.create(model, make_optimizer(model, {"type": "AdamW", "learning_rate": 1e-3}))
    step = make_train_step(model, mixed_precision=True)
    loader = _train_loader(config, splits)
    loader.set_epoch(0)
    batches = list(loader)
    for i in range(SERVE_PLANE_TRAIN_STEPS):
        step(train, batches[i % len(batches)].to(device))
    torch.cuda.synchronize()
    print(f"{label}: the run trained {SERVE_PLANE_TRAIN_STEPS} steps in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    model.eval()
    state = TrainState.create(model, make_optimizer(model, {"type": "SGD", "learning_rate": 1e-3}))
    return {"config": config, "splits": splits, "log_name": log_name, "state": state,
            "graphs": graphs, "root": root,
            "fleet": start_serve_fleet(label, config, graphs, state, log_name, root)}


def run_serve_plane(device, prepared):
    """The ``serve_plane`` phase on what ``prepare_serve_plane`` made: (c)'s
    stream with replica 1 killed, then (a) hot reload and (b) the weights'
    routes while replica 1 restarts, then the rest of (c). Returns the
    launches by (kernel, case)."""
    t_phase = time.perf_counter()
    label = "serve_plane"
    config, splits, state = prepared["config"], prepared["splits"], prepared["state"]
    log_name, graphs, ctx = prepared["log_name"], prepared["graphs"], prepared["fleet"]
    requests = [graphs[i % len(graphs)] for i in range(SERVE_PLANE_REQUESTS)]
    launched = collections.Counter()
    per_batch = {"K1": {"bfloat16/C866": 1, "float32/C866": 2, "bfloat16/C3": 1,
                        "float32/C3": 2}, "K2": {"float32/866x866": 1}}
    try:
        stream = run_fleet_stream(label, ctx)
        with contextlib.chdir(prepared["root"]):
            got, entries = run_serve_reload(label, config, splits, requests, device, state,
                                            log_name, per_batch)
            launched.update(got)
            print(f"{label}: (c) stream and (a) in {time.perf_counter() - t_phase:.1f} s",
                  flush=True)
            # (b) serves epoch 1: the pointer names the corrupt epoch 2,
            # whose walk-back restores it
            launched.update(run_serve_weights(label, config, splits,
                                              requests[:SERVE_PLANE_WEIGHT_REQUESTS], device,
                                              state, log_name, entries[1]))
        print(f"{label}: (c) stream, (a) and (b) in {time.perf_counter() - t_phase:.1f} s",
              flush=True)
    except BaseException:
        ctx["fleet"].close()
        raise
    finish_serve_fleet(label, ctx, device, state, log_name, launched, stream)
    print(f"{label}: phase in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launched


def main() -> None:
    with contextlib.ExitStack() as stack:
        run_smoke(stack)


def run_smoke(stack: contextlib.ExitStack) -> None:
    t_main = time.perf_counter()

    def clock(phase: str) -> None:  # the script time each phase ends at (PERF.md §4)
        print(f"clock: {phase} done at {time.perf_counter() - t_main:.1f} s", flush=True)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", action="store_true",
                    help="build and check the kernels only (no serving phase)")
    ap.add_argument("--plane", action="store_true",
                    help="build, the kernels' CUDA-graph capture checks and the compile and "
                         "memory plane's phases only (graphs_train, graphs_serve, remat, tune)")
    ap.add_argument("--data-plane", action="store_true",
                    help="build, then the host data plane's phase only (data_plane)")
    ap.add_argument("--serve-plane", action="store_true",
                    help="build, then the serving plane's phase only (serve_plane: hot reload, "
                         "the bf16 and int8 routes, the replica fleet)")
    ap.add_argument("--md17", choices=MD17_ROUTES,
                    help="run only the MD17 recipe through this route (K1's kernel or its "
                         "plain version, with or without deterministic algorithms), ungated")
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

    if args.md17:
        _build.build(("sorted_segment_sum",))
        from hydragnn_tpu_torch.data.synthetic import md17_shaped_dataset

        (REPO / "build").mkdir(exist_ok=True)
        work = stack.enter_context(tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                                               dir=REPO / "build"))
        stack.enter_context(contextlib.chdir(work))
        run_md17_route(md17_shaped_dataset(MD17_SAMPLES), args.md17)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return
    # the kernels build (one nvcc per source, all together) while this
    # thread makes the paths' data, their cases and gin_ring's requests
    # (its dense PE); a wrapper that loads a library meanwhile waits for
    # the build (``_build.load`` takes the same lock)
    build_out = {}

    def build_all():
        try:
            with _build._lock:
                t0 = time.perf_counter()
                build_out["seconds"] = _build.build(LIBRARIES)
                build_out["wall"] = time.perf_counter() - t0
            # the data plane's C++ (g++), after the kernels' nvcc
            from hydragnn_tpu_torch.native.build import build_library

            t0 = time.perf_counter()
            build_out["native"] = [build_library(n) for n in NATIVE_LIBRARIES]
            build_out["native_s"] = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 -- raised in the main thread
            build_out["error"] = e

    nvcc_thread = threading.Thread(target=build_all, name="nvcc", daemon=True)
    nvcc_thread.start()
    if args.serve_plane:
        from hydragnn_tpu_torch.data.synthetic import oc20_shaped_dataset

        graphs = oc20_shaped_dataset(128)
        nvcc_thread.join()
        if "error" in build_out:
            raise build_out["error"]
        print(f"build: {build_out['seconds']} s per kernel", flush=True)
        warm_up_card()
        (REPO / "build").mkdir(exist_ok=True)
        work = stack.enter_context(tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                                               dir=REPO / "build"))
        stack.enter_context(contextlib.chdir(work))
        run_serve_plane(device, prepare_serve_plane(device, graphs, Path(work)))
        print(f"chip_smoke: every phase in {time.perf_counter() - t_main:.1f} s", flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return

    from hydragnn_tpu_torch.api import prepare_data
    from hydragnn_tpu_torch.data.graph import batch_graphs
    from hydragnn_tpu_torch.data.pipeline import split_dataset
    from hydragnn_tpu_torch.data.synthetic import (
        bcc_supercell,
        md17_shaped_dataset,
        oc20_shaped_dataset,
    )

    # gin_ring's supercell, and its requests' dense Laplacian PE in a thread
    # of their own (numpy's eigh leaves the GIL), beside the data below
    t0 = time.perf_counter()
    topology = bcc_supercell(GIN_RING_CELLS, jitter=0.03, seed=SEED)
    topology_s = time.perf_counter() - t0
    ring_out = {}

    def ring_pe():
        try:
            ring_out["requests"] = gin_ring_requests(topology, GIN_RING_REQUESTS)
        except BaseException as e:  # noqa: BLE001 -- raised in the main thread
            ring_out["error"] = e

    ring_thread = threading.Thread(target=ring_pe, name="ring_pe", daemon=True)
    if not (args.kernels or args.plane or args.data_plane):
        ring_thread.start()
    # one real batch of each path gives its kernels' shapes
    oc20 = oc20_shaped_dataset(128)
    paths = {"egnn": (serving_config(), oc20),
             "gps_pna": (gps_pna_config(), gps_pna_dataset(128)),
             "pnaplus": (pna_cell_config(), oc20),
             **{m.lower(): (model_cell_config(m), oc20) for m in MODEL_CELLS}}
    t0 = time.perf_counter()
    md17 = md17_shaped_dataset(MD17_SAMPLES)
    print(f"md17_shaped_dataset({MD17_SAMPLES}) in {time.perf_counter() - t0:.2f} s", flush=True)
    cases, first = [], {}
    for label, (config, graphs) in (*paths.items(), ("schnet_md17", (md17_config(), md17))):
        done, (train_loader, _, _), _ = prepare_data(
            copy.deepcopy(config), datasets=split_dataset(
                graphs, 0.7 if label == "schnet_md17" else 0.9, seed=0)
        )
        first[label] = batch = next(iter(train_loader))
        print(f"batch {label}: {int(batch.graph_mask.sum())} graphs, "
              f"{int(batch.node_mask.sum())}/{batch.num_nodes} nodes, "
              f"{int(batch.edge_mask.sum())}/{batch.num_edges} edges", flush=True)
        if label == "egnn":
            cases += egnn_kernel_cases(batch, device)
            egnn_config = done
        elif label == "gps_pna":
            nmax = int(done["NeuralNetwork"]["Architecture"]["max_nodes_per_graph"])
            cases += gps_kernel_cases(batch, device, nmax)
    cases += zoo_kernel_cases(first["pnaplus"], first["schnet_md17"], device)
    # the GFM recipe's batch of 160 (its K1 and K2 cases, named gfm/)
    t0 = time.perf_counter()
    gfm_graphs = gfm_dataset(GFM_GRAPHS)
    print(f"gfm_dataset({GFM_GRAPHS}) in {time.perf_counter() - t0:.2f} s", flush=True)
    _, (gfm_loader, _, _), _ = prepare_data(gfm_config(), datasets=split_dataset(
        gfm_graphs, 0.9, seed=0))
    gfm_loader.set_epoch(0)
    batch = next(iter(gfm_loader))
    print(f"batch gfm: {int(batch.graph_mask.sum())} graphs, "
          f"{int(batch.node_mask.sum())}/{batch.num_nodes} nodes, "
          f"{int(batch.edge_mask.sum())}/{batch.num_edges} edges", flush=True)
    cases += egnn_kernel_cases(batch, device, prefix="gfm/", k2_dtypes=(torch.float32,))
    # the example recipes' data (oc20_config, lsms_config), written once;
    # their first train batches give the shapes of their cases
    (REPO / "build").mkdir(exist_ok=True)
    data_root = Path(stack.enter_context(tempfile.TemporaryDirectory(prefix="chip_smoke_data_",
                                                                      dir=REPO / "build")))
    config_phases = config_phase_data(data_root)
    config_batches = {}
    for label, config in config_phases.items():
        _, (loader, _, _), _ = prepare_data(copy.deepcopy(config))
        loader.set_epoch(0)
        config_batches[label] = batch = next(iter(loader))
        print(f"batch {label}: {int(batch.graph_mask.sum())} graphs, "
              f"{int(batch.node_mask.sum())}/{batch.num_nodes} nodes, "
              f"{int(batch.edge_mask.sum())}/{batch.num_edges} edges", flush=True)
    cases += config_kernel_cases(config_batches, device)
    # the data plane's example recipes' data, made while the kernels build;
    # their first train batches give the shapes of their cases
    examples = ({label: example_data(label, data_root) for label in EXAMPLE_JSON}
                if not args.plane else {})
    example_batches = {}
    for label, (config, _) in examples.items():
        done, (loader, _, _), _ = prepare_data(copy.deepcopy(config))
        loader.set_epoch(0)
        example_batches[label] = (done, batch := next(iter(loader)))
        print(f"batch {label}: {int(batch.graph_mask.sum())} graphs, "
              f"{int(batch.node_mask.sum())}/{batch.num_nodes} nodes, "
              f"{int(batch.edge_mask.sum())}/{batch.num_edges} edges", flush=True)
    cases += example_kernel_cases(example_batches, device)
    batch = batch_graphs([topology], gin_ring_spec(topology), sort_edges=True)
    print(f"batch gin_ring: 1 graph, {int(batch.node_mask.sum())}/{batch.num_nodes} nodes, "
          f"{int(batch.edge_mask.sum())}/{batch.num_edges} edges", flush=True)
    cases += gin_ring_kernel_cases(batch, device)
    # the obs_train step's numerics (its cell is the egnn model, trained):
    # its forward runs K1 and K2, so it comes after the data, once the
    # kernels are built, while gin_ring's PE may still run
    cases.append(numerics_kernel_case(egnn_config, first["egnn"], device))
    ring_requests = None
    if ring_thread.is_alive() or ring_out:
        t0 = time.perf_counter()
        ring_thread.join()
        if "error" in ring_out:
            raise ring_out["error"]
        ring_requests = ring_out["requests"]
        print(f"gin_ring requests and their PE made while the kernels built, in "
              f"{ring_requests[1]:.2f} s (the cases waited {time.perf_counter() - t0:.2f} s "
              f"for them)", flush=True)
    nvcc_thread.join()
    if "error" in build_out:
        raise build_out["error"]
    print(f"build: {build_out['seconds']} s per kernel from {_build.CSRC.relative_to(REPO)}/ "
          f"(wall {build_out['wall']:.2f} s; nvcc {' '.join(_build.NVCC_FLAGS)}) "
          f"into {_build.BUILD_DIR.relative_to(REPO)}/; the native C++ "
          f"{[Path(p).name for p in build_out['native']]} by g++ in "
          f"{build_out['native_s']:.2f} s", flush=True)
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    warm_up_card()
    if args.data_plane:
        del cases
        work = stack.enter_context(tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                                               dir=REPO / "build"))
        stack.enter_context(contextlib.chdir(work))
        run_data_plane(device, oc20_shaped_dataset(TRAIN_GRAPHS), examples)
        print(f"chip_smoke: every phase in {time.perf_counter() - t_main:.1f} s", flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return
    if args.plane:
        capture_checks(cases)
        del cases
        work = stack.enter_context(tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                                               dir=REPO / "build"))
        stack.enter_context(contextlib.chdir(work))
        run_plane_phases(device, oc20_shaped_dataset(TRAIN_GRAPHS), paths["egnn"][1], data_root)
        print(f"chip_smoke: every phase in {time.perf_counter() - t_main:.1f} s", flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return
    clock("build and cases")
    kernels = run_kernels(cases)
    clock("kernels")
    capture_checks(cases)
    del cases  # their inputs, so the phases' memory readings start clean
    ring_merge_check(batch, device)
    plain_route_repeat_check(batch, device)
    torch.cuda.synchronize()
    library_report(LIBRARIES)
    clock("kernel checks")

    launched = collections.Counter()
    if not args.kernels:
        # every path's ./logs (run_training's checkpoints, the servers'
        # restores) lies in a temporary directory under the checkout's build/
        (REPO / "build").mkdir(exist_ok=True)
        work = stack.enter_context(tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                                               dir=REPO / "build"))
        stack.enter_context(contextlib.chdir(work))
        per_batch_cases = {
            "egnn": {"K1": {"bfloat16/C866": 1, "float32/C866": 2,
                            "bfloat16/C3": 1, "float32/C3": 2},
                     "K2": {"float32/866x866": 1}},
            # the degree scalers' f32 counts promote PNA's output, so only
            # conv layer 0 runs in bf16 (PERF.md, Findings)
            "gps_pna": {"K3": {"bfloat16/C256": 1, "float32/C256": 3},
                        "K4": {"bfloat16/H8xd32": 1, "float32/H8xd32": 3}},
            "pnaplus": PNAPLUS_PER_UNIT,
            **{m.lower(): MODEL_PER_UNIT[m] for m in MODEL_CELLS},
        }
        for label, (config, graphs) in paths.items():
            t0 = time.perf_counter()
            launched.update(run_serving(label, config, graphs, device, N_REQUESTS,
                                        per_batch_cases[label]))
            print(f"serve {label}: phase in {time.perf_counter() - t0:.1f} s", flush=True)
        clock("serving")
        ring_launched, ring_config, ring_batches = run_gin_ring(topology, topology_s, device,
                                                                GIN_RING_REQUESTS, ring_requests)
        launched.update(ring_launched)
        clock("gin_ring")
        train_graphs = oc20_shaped_dataset(TRAIN_GRAPHS)
        launched.update(run_egnn_train(train_graphs, paths["egnn"][1], device, TRAIN_PER_STEP))
        clock("egnn_train")
        t0 = time.perf_counter()
        launched.update(run_plane_phases(device, train_graphs, paths["egnn"][1], data_root))
        print(f"plane phases in {time.perf_counter() - t0:.1f} s", flush=True)
        clock("plane phases")
        launched.update(run_gps_pna_train(gps_pna_dataset(GPS_TRAIN_GRAPHS), device,
                                          GPS_TRAIN_PER_STEP))
        clock("gps_pna_train")
        launched.update(run_gin_ring_train(ring_config, ring_batches, device,
                                           GIN_RING_TRAIN_PER_STEP))
        clock("gin_ring_train")
        launched.update(run_egnn_ckpt(paths["egnn"][1], device, TRAIN_PER_STEP))
        clock("egnn_ckpt")
        launched.update(run_cell_train(
            "pnaplus_train", pna_cell_config(), oc20_shaped_dataset(PNAPLUS_TRAIN_GRAPHS), device,
            PNAPLUS_PER_UNIT, ("K3",), PNAPLUS_TRAIN_RTOL, {
                "K3 (forward)": ["multi_agg_kernel"],
                "f32 GEMMs (forward and backward)": ["gemm_f32f32", "sgemm"],
                "bf16 GEMMs": ["bf16_s16816gemm"],
                "AdamW and the guard's copy (multi-tensor kernels)": ["multi_tensor_apply"],
                "scatter and gather backwards (K3's min/max, the gathers)":
                    ["scatter", "indexing_backward", "indexFuncLargeIndex", "index_add"],
            }))
        clock("pnaplus_train")
        for m in MODEL_CELLS:
            launched.update(run_model_cell_train(m, oc20_shaped_dataset(MODEL_TRAIN_GRAPHS),
                                                 device))
        clock("model cells")
        t0 = time.perf_counter()
        launched.update(run_zoo({**{name: (pna_cell_config(name), oc20) for name in ZOO_CELL},
                                 "performer": (performer_cell_config(), paths["gps_pna"][1])},
                                device, ZOO_PER_UNIT))
        print(f"zoo: phase in {time.perf_counter() - t0:.1f} s", flush=True)
        clock("zoo")
        launched.update(run_schnet_md17(md17, device, MD17_PER_UNIT, MD17_EPOCHS))
        clock("schnet_md17")
        t0 = time.perf_counter()
        gfm_launched, rest = run_gfm_phases(device, gfm_graphs, oc20,
                                            oc20_shaped_dataset(MODEL_TRAIN_GRAPHS))
        launched.update({(k, f"gfm/{c}"): n for (k, c), n in gfm_launched.items()})
        launched.update(rest)
        print(f"gfm phases in {time.perf_counter() - t0:.1f} s", flush=True)
        clock("gfm phases")
        for label, config in config_phases.items():
            t0 = time.perf_counter()
            prefix = label.split("_")[0]
            launched.update({(k, f"{prefix}/{c}"): n for (k, c), n in run_config_phase(
                label, config, device, N_REQUESTS).items()})
            print(f"{label}: phase in {time.perf_counter() - t0:.1f} s", flush=True)
        clock("config phases")
        # the multi-GPU slice: the GFM recipe through the distributed step
        # (its K1/K2 calls at the gfm/ shapes), then ranks sharing the card
        launched.update({(k, f"gfm/{c}"): n
                         for (k, c), n in run_dist_gfm_train(gfm_graphs, device).items()})
        clock("dist_gfm_train")
        # serve_plane's fleet, dist_run_training's launch and dist_ranks'
        # groups start together: their processes' start-ups overlap (none of
        # the three gates a time)
        Path("serve_plane").mkdir()
        with contextlib.chdir("serve_plane"):
            serve_prepared = prepare_serve_plane(device, paths["egnn"][1], Path.cwd())
        try:
            dist_run = start_dist_run_training()
            run_dist_ranks(gfm_graphs, device)
            clock("dist_ranks")
            launched.update({(k, f"gfm/{c}"): n
                             for (k, c), n in run_dist_run_training(dist_run).items()})
            clock("dist_run_training")
        except BaseException:
            serve_prepared["fleet"]["fleet"].close()
            raise
        # the serving plane: hot reload, the weights' routes, the fleet
        launched.update(run_serve_plane(device, serve_prepared))
        clock("serve_plane")
        # the observability plane on the egnn cell, training then serving,
        # each in its own directory (an empty ./logs)
        for label, phase in (
                ("obs_train", lambda: run_obs_train(train_graphs, device, TRAIN_PER_STEP)),
                ("obs_serve", lambda: run_obs_serve(paths["egnn"][1], device,
                                                    per_batch_cases["egnn"]))):
            t0 = time.perf_counter()
            Path(label).mkdir()
            with contextlib.chdir(label):
                launched.update(phase())
            print(f"{label}: phase in {time.perf_counter() - t0:.1f} s", flush=True)
            clock(label)
        # the host data plane: staging, the watchdog, two example recipes,
        # the sample store, the native neighbor builder
        Path("data_plane").mkdir()
        with contextlib.chdir("data_plane"):
            launched.update(run_data_plane(device, train_graphs, examples))
        clock("data_plane")
    for k in kernels:
        k["launches"] = launched.get((k["kernel"], k["case"]), 0)
    # the bf16 fused edge and block-summary cases are measured but not on a
    # path (the last EGNN conv and the SP path run in f32), so they stay out
    # of the kernels line; launches count every path, training included
    on_path = [k for k in kernels if args.kernels or k["launches"] > 0]
    off_path = [k for k in kernels if k not in on_path]
    for k in off_path:
        print(f"measured off the served path: {json.dumps(k)}", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "backward_ms",
            "backward_library_ms")
    print(f"chip_smoke: every phase in {time.perf_counter() - t_main:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [{k: v[k] for k in keys} for v in on_path]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
