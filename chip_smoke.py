#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Fulcrum (``src/repro_torch``) on one
NVIDIA Hopper card, and hold every kernel against its plain version.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``. It
builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` on first use
(into ``build/kernels``), then runs these phases, printing one JSON line
each and stopping with a traceback at the first failure:

 1. ``device``: the card (``nvidia-smi`` name and power limit, also printed
    raw on a line of its own) and the kernels' build time.
 2. ``kernels``: each kernel against its plain PyTorch version on the card
    at the engine's full shapes — the max-plus scan at 8192 lanes x 8192
    events, the lane sort at 512 x 8192, at 1 x 32768 (its global-pass
    path) and at the sweeps' sort chunks, 577 x 7263 and 34663 x 121, and
    the fused fleet window on the K = 512 fleet's second window and on a
    shedding one — with times, the bytes-over-bandwidth bound and the
    one-call library yardstick where PyTorch has one.
 3. ``execute``: the README quickstart (GMD concurrent plan for mobilenet,
    executed over a 120 s Poisson trace) on ``backend="cuda"`` and again on
    ``"cpu"``, compared to the engine tolerance.
 4. ``serve_dynamic``: the README's open-loop dynamic case, the same way.
 5. ``serve_closed_loop``: the closed loop of ``serve_dynamic`` (resnet50,
    40 W, 0.1 s, 30 s windows): the README's case on uniform arrivals, then
    three burst cases on Poisson arrivals (45 / 60 / 180 / 50 req/s) that
    shed, defer with a cap, and degrade the plan with mid-window splits. On
    ``"cuda"`` and on ``"cpu"``: the same decisions per window, latencies
    to the engine tolerance; fails unless the shed case sheds and the
    degrade-bs case splits. Per window: the plan, splits, shed / deferred /
    carried counts, goodput, p95, the latency error and the wall; then the
    shed case once under ``torch.profiler`` (K1 / K2 device time against
    the host's).
 6. ``multi_tenant``: the README's 3 tenants + resnet18 training through
    ``execute_multi_tenant``, multi-tenant ``serve_dynamic`` open and
    closed (shedding), one tenant against the pair path (bitwise), and the
    10,000-lane point of ``benchmarks/bench_multi_tenant.py``'s lane
    scaling (2 tenants, ``(pm, bss)`` cycling), each on ``"cuda"`` against
    ``"cpu"``; K1 and K2 timed against their plain versions at that
    batch's own chunk shapes.
 7. ``oracle_sweep``: the paper-scale sweep of
    ``benchmarks/bench_solver.py`` through the oracle's batched grid
    solvers (41 training problems against 441 modes, 51,168 inference
    problems against 2,205 (mode, bs) entries, 6,560 concurrent ones) and
    ``bench_multi_tenant.py``'s full grid around the README's three tenants
    with resnet18 training (96 problems), on ``"cuda"`` and on ``"cpu"``:
    solutions bitwise equal, every 997th (every training problem, two
    multi-tenant ones) equal to the scalar ``problem.solve_*`` loop;
    configs/s per backend, solver launches, and the device's idle share
    under the profiler.
 8. ``strategies``: the fitted strategies (ALS, RND-k, NN-k) on
    ``benchmarks/common.py``'s strided grids at the benchmarks' 300 NN
    epochs, each on ``"cuda"`` and again on ``"cpu"``, against the
    oracle's optima: resnet18 training, mobilenet inference, resnet18 +
    mobilenet through ``Fulcrum.solve_concurrent`` and the README's three
    tenants with resnet18 training through ``solve_multi_tenant``
    (solved, ground-truth violations, median gap, modes profiled,
    profiling cost, wall); then ``serve_dynamic(strategy="als145")``'s
    closed loop (mobilenet, 30 W, 0.1 s), which must launch K1 and K2, and
    the NN predictor: cuda against cpu at 10 and 100 epochs, ms per fit
    and per epoch at 300, device launches per epoch. Fails on an ALS or
    RND ground-truth violation, on RND differing between the backends
    (profiles, cost, solutions) or on predictions beyond ``NN_TOL``;
    where ALS or NN-k profile other modes on the two backends (their
    float32 fits part at these epochs), the record says how many and
    both answers' quality.
 9. ``fleet``: ``serve_fleet`` on K devices (mobilenet, 30 W, 0.1 s, 5 s
    Poisson windows): the README's two examples at K = 8 (the second with
    shedding, backlog migration and a 216 W shared cap), the scaling rows
    of ``benchmarks/bench_fleet.py`` at K = 8, 64 and 512 (each also
    served by ``serve_fleet_sequential``, the K single-device loops) and
    its admission matrix at K = 64 (shed, defer, degrade-bs; migration on;
    a 27 W x K shared cap). Every batched run on ``"cuda"`` against
    ``"cpu"``, the sequential loops against the batched run: the same
    decisions per window and device, latencies to the engine tolerance;
    one K1 and one K2 launch per window that serves, K2's routes; wall,
    device-windows/s, the batched speedup, goodput, shed / deferred /
    migrated counts, and the K = 64 row under the profiler. Then the fused
    window (``serve_fleet(fused=True)``) on the README's two fleets, the
    scaling rows at K = 64 and 512 and the shed and defer rows, each on
    ``"cuda"`` against the row's unfused cuda run and against the fused
    window on ``"cpu"``: the same decisions, one ``fused_window`` and one
    K2 launch a window and no K1; device-windows/s and the speedup over
    the unfused row; degrade-bs refused; the K = 64 row under the profiler
    (idle share, copies per window).
10. ``sweep``: ``simulate_batch`` over every (power mode x inference
    minibatch size) of the default space (2,205 lanes, 120 s at 60 req/s),
    then the 100k-lane point of ``benchmarks/bench_interleave_engine.py``;
    both checked against the CPU backend, with each kernel timed and checked
    against its plain version on the card at the sweep's own shapes.

11. ``generate``: ``GenerationServer`` on zamba2-1.2b at full width (38
    layers) serving bs 4, a 512-token prompt and 32 greedy tokens on the
    card: wall, prefill and per-token decode times, and the attention and
    SSD kernels' launches per prefill (one per attention site, one per
    Mamba2 layer). Then a copy cut to 2 layers (still full width) in
    float32 compute, run on ``"cuda"`` and on ``"cpu"``: logits within
    1e-3 and 8 greedy tokens equal.
12. ``families``: the dense, ssm, vlm and audio configurations
    (``FAMILIES``), each through ``GenerationServer`` at full width and
    depth in bf16 (bs 4, a 512-position prompt, internvl2-1b's 256 vision
    patches and 256 text tokens, 16 greedy tokens): load s and peak
    memory, wall, prefill ms, decode ms per token beside their bounds
    (every weight outside the vocabulary tables times every prompt token
    at the bf16 rate; every bf16 weight read once a token), and one K3
    launch per attention layer (K4 per Mamba2 layer) per prefill;
    stablelm-12b's at head dim 160. Then a 1-layer full-width float32 copy
    of each on ``"cuda"`` and on ``"cpu"`` (bs 2, 64 text tokens): logits
    within 1e-3, 8 greedy tokens equal up to the first step whose top-two
    logits on ``"cpu"`` lie within that tolerance (reported).
    mamba2-780m, internvl2-1b and stablelm-12b also take one float32
    training step on both (``FAM_TRAIN``'s batch x 256 text tokens):
    losses within 1e-4, gradients within 1e-3 of each leaf's largest |g|
    (K4's backward at n = 128, K3's under GQA 7 and at D = 160 under GQA
    4).
13. ``moe``: mixtral-8x22b and arctic-480b at full published width with
    their depth cut to fit the card (``MOE_LAYERS``: 12 of 56 and 2 of 35
    layers), each served as the families are, in bf16: load s, peak
    memory, prefill ms, decode ms per token, one K3 launch per layer per
    prefill. The served layer 0, all its experts, on a (4, 512, d) bf16
    input: ``moe_apply`` twice on cuda, bitwise equal; its routing (expert,
    queue position, keep mask, drops: Arctic's 128 experts hold 10 slots a
    group) equal to cpu's from the same float32 router away from near ties
    (counted), and y within 2e-2 of its largest |y| of a plain dispatch on
    the card (a loop over experts) from cpu's routing. Mixtral again on
    one prompt of 8704 tokens, past its 8192-token window (its dispatch in
    8 groups of 1088): K3 launched once per layer with that window, a KV
    cache of 8192 slots, finite logits, 8 greedy tokens. Then float32
    copies cuda against cpu as the families' (1 Mixtral layer; 1 Arctic
    layer with 16 of its 128 experts), and one layer's ``moe_apply`` on a
    (2, 512, d) input: twice on cuda, bitwise equal, and its routing,
    drops and y equal to cpu's away from near ties (counted).
14. ``serve_interleaved``: ``ManagedInterleaveRuntime`` (no trainer) over
    ``BatchInferenceServer(zamba2-1.2b, seq_len 2048, bs 8)`` and a uniform
    trace at 80% of the measured minibatch rate for 5 s: p50 / p99 latency
    and the kernels' launches per minibatch; then one minibatch under
    ``torch.profiler`` (device busy time, idle share, top kernels). Then the
    runtime's admission gate: the same server behind
    ``AdmissionPolicy("shed").gate`` on a uniform 5 s trace at 150% of the
    minibatch rate, which must shed exactly the engine mask's count.
15. ``train``: ``Trainer`` on zamba2-1.2b at full width and depth (remat on,
    float32 params, bf16 compute, AdamW) for a few steps of bs 4 x 512
    tokens: ms per step, tokens/s, first and last loss (finite), peak
    memory and every kernel's launches per step (forward, remat's second
    forward, backward), and one step under ``torch.profiler``. Then a
    2-layer full-width float32 copy takes one step on ``"cuda"`` and on
    ``"cpu"`` from the same params and batch: losses within 1e-4, every
    gradient leaf within 1e-3 of its largest |g|.
16. ``serve_train_interleaved``: the runtime with that ``Trainer`` (warm
    from the train phase) and the ``serve_interleaved`` server on a uniform
    5 s trace whose batch period is the minibatch time plus 2.5 training
    steps: trained minibatches (at least one), p50 / p99 latency with and
    without the trainer, and the largest overrun of a training step past
    its predicted end.
17. ``tiled_matmul``: the ``kernels.ops.tiled_matmul`` entry point on the
    serving minibatch's MLP up-projection, (16384, 2048) x (2048, 8192)
    bf16, against ``torch.matmul``.

The kernel phase also holds the attention kernel (K3) and the SSD chunk
kernel (K4) against their plain versions at the shapes of the
``serve_interleaved`` forward, K3 again at the train phase's shape and at
windowed, ragged and D = 128 shapes, their backward kernels at the same
shapes (K3's also in float32 at the main and the train shapes), and the
tiled matmul (K5) at the up-projection's shape and at a ragged and an
edge shape in both types, its bf16 checks with their per-row share,
and K4's forward again at edge shapes (``SSD_CHECKS``: a partial last
tile, head groups that are not full, a one-row chunk), each check with
its share of ``SSD_TOL``'s ``allclose`` limit for y and the states (at
``SSD_SHAPE`` the largest over ``SSD_DRAWS`` input draws). For the
families: K4 both ways at mamba2-780m's serving shape (``SSD_N128_SHAPE``,
n = 128) and K3 at minitron-4b's prefill (``ATTN_GQA_SHAPE``, D = 128),
timed with their bounds; K3 at stablelm-12b's head dim 160, both ways at
its prefill (``ATTN_D160_SHAPE``) beside SDPA and its backward, and at
a ragged windowed shape (``ATTN_D160_CHECKS``) in both types, and a head
dim outside ``HEAD_DIMS`` refused with no launch; for the MoE pair, K3 at each configuration's
prefill (``moe_attention_shapes``: Mixtral's GQA 6 and Arctic's GQA 7)
and at Mixtral's windowed prompt, beside SDPA (given the window as a
mask).
K3 (both ways) and K4's backward are compared element by element, each
output's share of its limit beside its RMS (``ATTN_TOL``); K3 is timed
at the main and the train shapes beside SDPA, whose share of the same
limit is printed as a yardstick. Float32 comparisons run with TF32 off
(``torch.backends.cuda.matmul`` and ``torch.backends.cudnn``).

Every path phase sets the kernels' launch counts to 0 before it runs and
fails unless each kernel of its path launched. The line before the last
lists every kernel (``{"kernels": [...]}``); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
before printing any result.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

ENG_TOL = dict(rtol=1e-9, atol=1e-8)      # docs/exactness.md, engine tier
# tests/test_kernels.py's tolerance of the SSD kernel
SSD_TOL = dict(rtol=2e-4, atol=1e-4)
MODEL_TOL = dict(rtol=1e-3, atol=1e-3)   # cuda vs cpu logits, float32
# K3 forward and backward, and K4's backward, against their plain versions
# element by element (tests/test_torch_cuda.py): |got - want| <= tol
# (|want| + scale). K3 in bf16: the scale is per row (a query for O and dQ,
# a key for dK and dV), the RMS of that row of want over D, floored at
# ATTN_ROW_FLOOR x want's RMS and at ATTN_ABS_FLOOR; the tensor cores take
# bf16 operands, so P and dS are rounded to bf16 before their products, and
# a row whose few large terms cancel moves by more than tol x its own small
# values. K3 in float32 and K4: the scale is want's RMS, or GRAD_FLOOR
# where that is smaller (a gradient that is exactly 0 has no scale of its
# own). Both attention backwards form rowsum(dO O) from the forward
# kernel's output; bf16 rounds O, dQ, dK and dV.
ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ATTN_ROW_FLOOR, ATTN_ABS_FLOOR = 0.05, 1e-3
SSD_BWD_TOL = 2e-4
GRAD_FLOOR = 0.1
MM_TOL = {"float32": 1e-3, "bfloat16": 3e-2}   # tests/test_kernels.py
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-4, 1e-3    # cuda vs cpu, float32 step
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
FP64_OPS_PER_S = 34e12                    # H100 SXM data sheet, float64
#                                           outside the tensor cores
OPS_PER_S = {"float64": FP64_OPS_PER_S,
             "float32": 67e12,            # outside the tensor cores
             "bfloat16": 989e12,          # dense, tensor cores
             # float32-accurate products on the tensor cores: split TF32
             # (hi.hi + hi.lo + lo.hi) does each three times at 495 TFLOP/s
             "tf32x3": 495e12 / 3}
# the kernel phase's shapes: the engine's full lane chunk; for the sort, a
# report-builder sort chunk, one row long enough for the sort's
# global-memory passes, and the sort chunks the two sweep phases really
# give (_sort_chunks over their latencies): 2,205 lanes of 7,263 requests
# in chunks of up to 577 rows, 100k lanes of 121 in chunks of up to 34,663
MAXPLUS_SHAPE = (8192, 8192)
SORT_SHAPES = {"lane_sort": (512, 8192), "lane_sort_global_pass": (1, 32768),
               "lane_sort_sweep_chunk": (577, 7263),
               "lane_sort_sweep_100k_chunk": (34663, 121)}
# the sweep: one 120 s Poisson trace at 60 req/s over the whole default
# space, then bench_interleave_engine.py's 100k-lane point
SWEEP_TRACE = (60.0, 120.0, 0)            # rate, duration, seed
BIG_LANES, BIG_TRACE = 100_000, (32.0, 4.0, 7)
# the closed loop: resnet50 at 40 W with a 0.1 s budget over 30 s windows;
# the README's case, then three burst cases on Poisson arrivals (seed 0)
CLOSED_LOOP = ("resnet50", 40.0, 0.1, 30.0)
_BURST = dict(rate_estimator="ewma", rate_margin=1.5, feedback=True,
              carry_backlog=True, burst_quantile=0.95, split_backlog=64,
              mode_switch_s=0.5)
CLOSED_LOOP_CASES = {
    "readme": ([45.0, 60.0, 115.0, 50.0], "uniform",
               dict(rate_estimator="ewma", rate_margin=1.5, feedback=True,
                    carry_backlog=True, mode_switch_s=0.5)),
    "shed": ([45.0, 60.0, 180.0, 50.0], "poisson",
             dict(_BURST, admission="shed")),
    "defer": ([45.0, 60.0, 180.0, 50.0], "poisson",
              dict(_BURST, admission="defer", defer_cap=500)),
    "degrade-bs": ([45.0, 60.0, 180.0, 50.0], "poisson",
                   dict(rate_estimator="ewma", carry_backlog=True,
                        split_backlog=64, admission="degrade-bs")),
}
# multi-tenant: the README's three tenants under 45 W with resnet18
# training; serve_dynamic over three 30 s windows of per-stream rates; the
# 10,000-lane point of bench_multi_tenant.py's lane scaling
MT_RATE_WINDOWS = [[40.0, 60.0, 20.0], [60.0, 90.0, 30.0],
                   [40.0, 60.0, 20.0]]
MT_LANES = 10_000
MT_LANE_TRACES = ((20.0, 4.0, 11), (12.0, 4.0, 13))   # rate, duration, seed
MT_BS_CYCLE = ([4, 8], [8, 16], [16, 4], [32, 8])
# the oracle sweep: benchmarks/bench_solver.py's paper-scale grids
# (benchmarks/common.py --full, rebuilt here: that module imports the JAX
# package) against resnet18 training and mobilenet inference, then
# bench_multi_tenant.py's full grid around the README's three tenants with
# resnet18 training
ORACLE_POWERS = range(10, 51)
ORACLE_INFER = ([0.05 + 0.01 * i for i in range(96)], range(30, 91, 5))
ORACLE_CONCURRENT = ([0.5 + 0.1 * i for i in range(16)], range(30, 121, 10))
ORACLE_MT = (range(20, 56, 5), (0.75, 1.0, 1.5, 2.0), (0.5, 0.75, 1.0))
MT_TENANTS = (("mobilenet", 40.0, 0.8), ("lstm", 60.0, 0.5),
              ("resnet50", 20.0, 1.5))
ORACLE_SCALAR_STRIDE = 997      # every n-th problem against problem.solve_*
# the fitted strategies (ALS, RND-k, NN-k) on benchmarks/common.py's strided
# grids (full=False) with the benchmarks' NN epochs, rebuilt here, each step
# on cuda and again on cpu: resnet18 training, mobilenet inference (the
# quadrants of bench_infer.py), the pair of bench_concurrent.py through
# Fulcrum.solve_concurrent, the README's three tenants with resnet18
# training through Fulcrum.solve_multi_tenant (ORACLE_MT's 96 problems)
NN_EPOCHS = 300
STRAT_TRAIN = ("resnet18", ("als50", "rnd50", "rnd250", "nn250"))
STRAT_INFER = ("mobilenet", ((0.05, 1.0), (30.0, 90.0)),
               ("als145", "rnd150", "rnd250", "nn250"))
STRAT_CONCURRENT = (("resnet18", "mobilenet"), ((0.5, 2.0), (30.0, 120.0)),
                    ("als145", "rnd150", "rnd250", "nn250"))
STRAT_MT = ("resnet18", ("als145", "rnd150", "nn250"))
# the closed loop answered by one fitted ALS model: mobilenet at 30 W and
# 0.1 s, 30 s windows, the README's controller (CLOSED_LOOP_CASES' readme)
STRAT_SERVE = ("mobilenet", 30.0, 0.1, (45.0, 60.0, 90.0, 50.0), 30.0)
# the NN predictor on cuda against cpu: within NN_TOL of the largest
# |prediction| after each of NN_CHECK_EPOCHS; timed at NN_EPOCHS, and under
# the profiler for NN_PROFILE_EPOCHS (launches per epoch)
NN_TOL = 1e-5
NN_CHECK_EPOCHS = (10, 100)
NN_PROFILE_EPOCHS = 30
NN_DRIFT_EPOCHS = (10, 100, 300)
# the fleet: mobilenet at 30 W and 0.1 s over 5 s Poisson windows; the
# README's two examples (K = 8), bench_fleet.py's scaling rows and its
# admission matrix under a 27 W x K shared cap
FLEET = ("mobilenet", 30.0, 0.1, 5.0)
FLEET_CL = dict(rate_estimator="ewma", rate_margin=1.5, feedback=True,
                carry_backlog=True)
FLEET_README = {
    "readme": ([220.0, 360.0, 280.0], dict(seed=3, dispatch="least-backlog"),
               FLEET_CL),
    "readme_overload": ([720.0, 1080.0, 240.0],
                        dict(seed=3, dispatch="least-backlog",
                             migrate_backlog=True, fleet_power_budget=216.0),
                        dict(FLEET_CL, burst_quantile=0.95,
                             admission="shed"))}
FLEET_KS = (8, 64, 512)
FLEET_SEQ_KS = (8, 64, 512)     # where the sequential loops are timed
FLEET_RATES = (0.9, 1.4, 0.7, 1.1)             # x 30 req/s x K
FLEET_ADM_K, FLEET_ADM_RATES = 64, (3.0, 4.5, 1.0, 2.5)
FLEET_ADM_MODES = {"shed": {}, "defer": dict(defer_cap=2000),
                   "degrade-bs": {}}
# the fused window runs the README's fleets, these scaling rows and these
# admission rows (degrade-bs re-plans on the host and is refused), each
# against the unfused cuda run of the same row; the kernel phase holds the
# kernel against its plain version on the K = 512 scaling row's second
# window (a carried backlog and previous modes) and on the admission
# matrix's shed row run at K = 512
FLEET_FUSED_KS = (64, 512)
FLEET_FUSED_ADM = ("shed", "defer")
FUSED_K = 512
# the runtime's admission gate: a uniform trace at this multiple of the
# server's minibatch rate, for this long, against a budget of 2 minibatches
GATE_LOAD, GATE_DURATION = 1.5, 5.0
# the model phases: zamba2-1.2b at full width
ARCH = "zamba2-1.2b"
GEN_BS, GEN_PROMPT, GEN_STEPS = 4, 512, 32
PARITY_LAYERS, PARITY_PROMPT, PARITY_STEPS = 2, 256, 8
SERVE_SEQ, SERVE_BS, SERVE_DURATION, SERVE_LOAD = 2048, 8, 5.0, 0.8
# the kernel phase's model shapes: those of the serve_interleaved forward
# (B, H, S, D) and (b, nc, l, h, p, n), then K3 windowed and ragged
ATTN_SHAPE = (SERVE_BS, 32, SERVE_SEQ, 64)
ATTN_CHECKS = ((1, 32, 1024, 64, 512), (2, 32, 300, 64, None),
               (1, 8, 300, 128, 100))
SSD_SHAPE = (SERVE_BS, SERVE_SEQ // 256, 256, 64, 64, 64)
# K4's forward is also checked where a grouped, tiled kernel has edges: a
# partial last tile with p and n past 64 and not multiples of 8 and a head
# group that is not full; a full chunk at n = 128 with 11 heads (a full
# group and a partial one); a one-row chunk with p, n under 8
SSD_CHECKS = ((1, 1, 100, 5, 100, 128), (1, 2, 256, 11, 64, 128),
              (2, 1, 1, 3, 8, 4))
# K4's forward at SSD_SHAPE on this many input draws: its share of the
# limit varies with the inputs, and the largest is reported
SSD_DRAWS = 4
# the families phase: each configuration of the dense, ssm, vlm and audio
# families served at full width and depth in bf16 (bs 4, a 512-position
# prompt: internvl2-1b's is 256 vision patches and 256 text tokens, 16
# greedy tokens; stablelm-12b's K3 at head dim 160). Then each on such a
# full-width float32 copy, cuda against cpu (bs 2, 64 text tokens after any
# patches, 8 greedy tokens), and a float32 training step of FAM_TRAIN's
# three (the batch given x 256 text tokens after any patches): K4's
# backward at n = 128, K3's under GQA 7 and at D = 160 under GQA 4
# (stablelm-12b's step on cpu, 1.31 B float32 parameters with AdamW's m
# and v, takes ~20 s, so its batch is 1). The copies are one layer deep to
# keep the script's time
FAMILIES = ("stablelm-1.6b", "minitron-4b", "qwen2.5-14b", "stablelm-12b",
            "mamba2-780m", "internvl2-1b", "musicgen-medium")
FAM_BS, FAM_PROMPT, FAM_STEPS = 4, 512, 16
FAM_PARITY_BS, FAM_PARITY_TEXT, FAM_PARITY_STEPS = 2, 64, 8
FAM_PARITY_LAYERS = 1
FAM_TRAIN = {"mamba2-780m": 2, "internvl2-1b": 2, "stablelm-12b": 1}
FAM_TRAIN_TEXT = 256
# the kernel phase's checks at those shapes: K4 at mamba2-780m's serving
# shape (bs 8 x 2048 tokens: 48 heads, p 64, n 128), both ways; K3 at
# minitron-4b's prefill (bs 4 x 512, 24 heads, D = 128)
SSD_N128_SHAPE = (8, 8, 256, 48, 64, 128)
ATTN_GQA_SHAPE = (4, 24, 512, 128)
# K3 at stablelm-12b's head dim (5120 / 32 = 160): its prefill after
# _repeat_kv (bs 4 x 512, 32 heads from 8 KV heads), both ways, timed; a
# ragged S with a window, both ways in float32 and bf16 (the forward in
# bf16 timed beside SDPA given the window as a mask); and a head dim
# outside HEAD_DIMS, which must raise and launch nothing
ATTN_D160_SHAPE = (FAM_BS, 32, FAM_PROMPT, 160)
ATTN_D160_CHECKS = ((1, 32, 300, 160, 64),)
ATTN_REFUSED_D = 96
# the moe phase: mixtral-8x22b and arctic-480b at full published width with
# the depth cut to fit one card (bf16 layers of 5.01 and 27.2 GB), each
# served as the families are (FAM_BS, FAM_PROMPT, FAM_STEPS); Mixtral's
# sliding window at full width (bs 1, a prompt past its 8192-token window,
# whose dispatch falls into 8 groups of 1088 tokens, then greedy tokens);
# float32 copies cuda against cpu as the families' are, cut further (a
# float32 Arctic layer with 128 experts is 54.4 GB), and one layer's
# moe_apply on a (B, S, d) input on both (MOE_PARITY_APPLY_SHAPE; the
# served bf16 layer's on the card at MOE_APPLY_SHAPE), whose routing is
# held equal except for choices within MOE_NEAR_TIE of a tie. The float32
# copies' cpu halves are most of the phase's time: the Mixtral copy is one
# layer deep and the parity input bs 2, to keep the script's time
MOE_LAYERS = {"mixtral-8x22b": 12, "arctic-480b": 2}
MOE_WINDOW_PROMPT, MOE_WINDOW_STEPS = 8704, 8
MOE_PARITY_CUTS = {"mixtral-8x22b": dict(num_layers=1),
                   "arctic-480b": dict(num_layers=1, n_experts=16)}
MOE_APPLY_SHAPE = (4, 512)
MOE_PARITY_APPLY_SHAPE = (2, 512)
MOE_NEAR_TIE = 1e-6
# the served bf16 layer's moe_apply against a plain dispatch on the card:
# y within this share of its largest |y| (bf16 products of other shapes)
MOE_SERVED_TOL = 2e-2
# training: bs 4 x 512 tokens at full width; the cuda-vs-cpu step on a
# 2-layer full-width copy; the interleaved trace's slack per batch
TRAIN_BS, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 3
PARITY_TRAIN_SEQ = 256
INTERLEAVE_TRAIN_STEPS = 2.5
# K3's backward is also checked at the shape the train phase gives it
ATTN_TRAIN_SHAPE = (TRAIN_BS, 32, TRAIN_SEQ, 64)
# K5: the serving minibatch's MLP up-projection (bs 8 x 2048 tokens,
# d_model 2048 -> d_ff 8192); a ragged shape, whose rows are not 16-byte
# multiples; an edge shape whose rows are, with no dimension a multiple of
# the kernel's tiles (M, K, N)
MM_SHAPE = (SERVE_BS * SERVE_SEQ, 2048, 8192)
MM_RAGGED = (1000, 777, 1531)
MM_EDGES = (1000, 776, 1528)

KERNEL_ROWS = {
    "maxplus_scan": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/maxplus_scan.cu",
        replaces="src/repro/kernels/fulcrum/maxplus_scan.py:56"),
    "lane_sort": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/lane_sort.cu",
        replaces="src/repro/kernels/fulcrum/lane_sort.py:52"),
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:70"),
    "flash_attention_bwd": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:70"),
    "ssd_chunk": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/ssd_chunk.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:57"),
    "ssd_chunk_bwd": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:57"),
    "tiled_matmul": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/tiled_matmul.cu",
        replaces="src/repro/kernels/tiled_matmul/tiled_matmul.py:37"),
    # the reference's fused window is a jax.jit program, not Pallas: the
    # row names its window function
    "fused_window": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/fused_window.cu",
        replaces="src/repro/core/fused_window.py:154"),
}
ENGINE_KERNELS = ("maxplus_scan", "lane_sort")
# a fused fleet window: the fused kernel, then the report builder's sort
FUSED_KERNELS = ("fused_window", "lane_sort")
# the device functions of K3's two sources, as the profiler names them
K3_FUNCTIONS = ("flash_attention_tc", "flash_attention_kernel",
                "rowdot_kernel", "rowvec_tc", "dkdv_tc", "dkdv_kernel",
                "dq_tc", "dq_kernel")
# and of K4's forward (csrc/ssd_chunk.cu) and backward (ssd_chunk_bwd.cu)
K4_FUNCTIONS = ("ssd_chunk_kernel",)
K4_BWD_FUNCTIONS = ("query_pass", "state_pass", "key_pass",
                    "finish_dA_kernel", "group_sum_kernel")
# and of the engine's K1 (csrc/maxplus_scan.cu) and K2 (csrc/lane_sort.cu)
K1_FUNCTIONS = ("maxplus_scan_kernel",)
K2_FUNCTIONS = ("sort_rows_warp", "sort_rows_block", "sort_pieces",
                "merge_pieces", "merge_global", "count_over")
# and of the fused fleet window (csrc/fused_window.cu)
KF_FUNCTIONS = ("fused_window_kernel",)
MODEL_KERNELS = ("flash_attention", "ssd_chunk")
TRAIN_KERNELS = MODEL_KERNELS + ("flash_attention_bwd", "ssd_chunk_bwd")


START = time.perf_counter()


def emit(obj: dict) -> None:
    if "phase" in obj:      # seconds since the start, to see where time goes
        obj["at_s"] = time.perf_counter() - START
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls, after one
    warm-up call, between CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float,
          ops_per_s: float = FP64_OPS_PER_S) -> tuple[float, str]:
    """Least time (ms) for the work: the larger of bytes over the memory
    rate and operations over the card's rate for their type (float64 by
    default)."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")


def float32_bound(nbytes: float, ops: float) -> tuple[float, str, float]:
    """``bound`` for float32-accurate work, which the card does either on
    the CUDA cores or on the tensor cores in split TF32: the lower of the
    two, and the CUDA-core figure alone."""
    cuda_cores = bound(nbytes, ops, OPS_PER_S["float32"])
    least = min(cuda_cores, bound(nbytes, ops, OPS_PER_S["tf32x3"]))
    return least[0], least[1], cuda_cores[0]


# ---------------------------------------------------------------------------
# inputs made on the card from a seed
# ---------------------------------------------------------------------------

def maxplus_case(torch, lanes: int, K: int, gen, dev):
    """Ragged engine-like lanes: sorted batch-ready times (mean gap 15 ms),
    service times near the gap (queues build and drain), +inf / 0 padding,
    carried clocks, +inf t_tr (no training) and caps on some lanes."""
    f64 = dict(dtype=torch.float64, device=dev)
    sizes = torch.randint(0, K + 1, (lanes,), generator=gen, device=dev)
    sizes[0] = K
    ready = torch.cumsum(torch.rand((lanes, K), generator=gen, **f64) * 0.03,
                         dim=1)
    exec_t = 0.001 + torch.rand((lanes, K), generator=gen, **f64) * 0.029
    pad = torch.arange(K, device=dev)[None, :] >= sizes[:, None]
    ready = ready.masked_fill(pad, float("inf"))
    exec_t = exec_t.masked_fill(pad, 0.0)

    def some(p, val, other):
        return torch.where(torch.rand(lanes, generator=gen, **f64) < p,
                           val, other)

    t_tr = some(0.3, torch.full((lanes,), float("inf"), **f64),
                0.005 + torch.rand(lanes, generator=gen, **f64) * 0.05)
    cap = some(0.5, torch.full((lanes,), float("inf"), **f64),
               torch.randint(0, 5, (lanes,), generator=gen,
                             device=dev).double())
    clock = some(0.5, torch.zeros(lanes, **f64),
                 torch.rand(lanes, generator=gen, **f64) * 2.0)
    return (ready, exec_t, t_tr, cap, clock), ~pad


def sort_case(torch, lanes: int, R: int, gen, dev):
    """Latency-like rows (0.1 ms .. 10 s) of random length, +inf padded,
    and per-lane budgets."""
    f64 = dict(dtype=torch.float64, device=dev)
    sizes = torch.randint(0, R + 1, (lanes,), generator=gen, device=dev)
    sizes[0] = R
    mat = 1e-4 + torch.rand((lanes, R), generator=gen, **f64) * 10.0
    pad = torch.arange(R, device=dev)[None, :] >= sizes[:, None]
    mat = mat.masked_fill(pad, float("inf"))
    budgets = 0.1 + torch.rand(lanes, generator=gen, **f64) * 5.0
    return mat, budgets


# ---------------------------------------------------------------------------
# kernel-against-plain comparisons
# ---------------------------------------------------------------------------

def check_maxplus(torch, K1, args, valid, what: str) -> float:
    c, f = K1.maxplus_scan(*args)
    torch.cuda.synchronize()
    cp, fp = K1.maxplus_scan_plain(*args)
    close = torch.isclose(c, cp, **ENG_TOL) | ~valid
    if not bool(close.all()):
        fail(f"{what}: maxplus_scan completions differ from the plain "
             f"version beyond {ENG_TOL} at {int((~close).sum())} events")
    fill_gap = float((f - fp).abs().max()) if f.numel() else 0.0
    if fill_gap > 2:
        fail(f"{what}: maxplus_scan fills differ by {fill_gap} (> 2)")
    diff = (c - cp).abs().masked_fill(~valid, 0.0)
    return float(diff.max()) if diff.numel() else 0.0


def check_sort(torch, K2, mat, budgets, what: str) -> str:
    """Hold the lane sort to its plain version (equal values and counts);
    returns the route its launch took, read from ``lane_sort.routes``."""
    before = dict(K2.lane_sort.routes)
    srt, viol = K2.lane_sort(mat, budgets)
    torch.cuda.synchronize()
    taken = [r for r, n in K2.lane_sort.routes.items() if n != before[r]]
    if taken != [K2.route(mat.shape[1])]:
        fail(f"{what}: lane_sort took routes {taken}, the rule says "
             f"{K2.route(mat.shape[1])}")
    srt_p, viol_p = K2.lane_sort_plain(mat, budgets)
    if not torch.equal(srt, srt_p):
        fail(f"{what}: lane_sort values differ from torch.sort")
    if not torch.equal(viol, viol_p):
        fail(f"{what}: lane_sort violation counts differ")
    return taken[0]


def time_maxplus(torch, K1, args, valid, reps: int) -> dict:
    L, K = args[0].shape
    err = check_maxplus(torch, K1, args, valid, f"{L}x{K}")
    ms = cuda_ms(torch, lambda: K1.maxplus_scan(*args), reps)
    plain_ms = cuda_ms(torch, lambda: K1.maxplus_scan_plain(*args),
                       max(1, reps // 10))
    # each input read once, each output written once: ready, exec and c
    # (24 B per event) plus 4 per-lane float64 vectors; about 8 float64
    # operations per event (recurrence max + add; fill sub, div, floor,
    # two clips, add)
    b_ms, by = bound(24.0 * L * K + 32.0 * L, 8.0 * L * K)
    return {"shape": [L, K], "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": by,
            "max_abs_err": err}


def time_sort(torch, K2, mat, budgets, reps: int) -> dict:
    L, R = mat.shape
    way = check_sort(torch, K2, mat, budgets, f"{L}x{R}")
    ms = cuda_ms(torch, lambda: K2.lane_sort(mat, budgets), reps)
    plain_ms = cuda_ms(torch, lambda: K2.lane_sort_plain(mat, budgets), reps)
    library_ms = cuda_ms(torch, lambda: torch.sort(mat, dim=1), reps)
    # one read and one write of every element, the budgets, the counts;
    # a comparison sort needs at least R log2 R comparisons per row
    r_log = max(1.0, math.log2(max(R, 1)))
    b_ms, by = bound(16.0 * L * R + 12.0 * L, L * R * r_log)
    return {"shape": [L, R], "route": way, "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
            "bound_by": by, "max_abs_err": 0.0}


def fused_inputs(rt, K: int, rates, spec_kw: dict, cfg_kw: dict) -> tuple:
    """The fused window's wrapper arguments as the fleet's main path gives
    them: ``serve_fleet(fused=True)`` on the card at K devices over
    ``rates``; the last window's, with its carried backlog and previous
    modes."""
    FW, seen = rt["FW"], []
    inner = FW.fused_window           # the importer's name of the wrapper

    def record(*args):
        seen.append(tuple(a.clone() if hasattr(a, "clone") else a
                          for a in args))
        return inner(*args)

    FW.fused_window = record
    try:
        fleet_run(rt, rt["F"].serve_fleet, K, rates, spec_kw, cfg_kw, "cuda",
                  11, fused=True)
    finally:
        FW.fused_window = inner
    return seen[-1]


def check_fused(torch, np, rt, args, what: str) -> tuple:
    """The fused kernel against its plain version on the same card inputs:
    every field bitwise but the fold's (latencies, the last completion),
    which meet ENG_TOL. Returns (max |Δ| of the fold, the kernel's
    unpacked result)."""
    KF, FW = rt["KF"], rt["FW"]
    got = KF.fused_window(*args)
    torch.cuda.synchronize()
    want = KF.fused_window_plain(*args)
    g, w = (FW.unpack_window(x.cpu().numpy()) for x in (got, want))
    for f in KF.OUT_FIELDS:
        if f != "clock_out" and g[f].tobytes() != w[f].tobytes():
            fail(f"{what}: fused_window's {f} differs from the plain "
                 f"version at {int(np.count_nonzero(g[f] != w[f]))} devices")
    if g["adm_times"].tobytes() != w["adm_times"].tobytes():
        fail(f"{what}: fused_window's admitted times differ")
    err = 0.0
    for f in ("latencies", "clock_out"):
        a, b = np.asarray(w[f]), np.asarray(g[f])
        if not np.allclose(b, a, **ENG_TOL):
            fail(f"{what}: fused_window's {f} differ beyond {ENG_TOL}")
        fin = np.isfinite(a)
        if fin.any():
            err = max(err, float(np.abs(b[fin] - a[fin]).max()))
    return err, g


def time_fused(torch, np, rt, args, shed_args, reps: int) -> dict:
    """The fused kernel on the K = 512 scaling row's window: checked, timed
    beside its plain version, with its device time under the profiler;
    also checked and timed on the K = 512 shed row's window (admission
    on)."""
    KF = rt["KF"]
    t, p, bsf, ids, rows = args[:5]
    K, T = rows.shape[0], rows.shape[1] - KF.N_IN
    err, g = check_fused(torch, np, rt, args, f"fused_window {K}x{T}")
    shed_err, sg = check_fused(torch, np, rt, shed_args,
                               "fused_window, shed row")
    if not sg["n_rej"].any():
        fail("fused_window: the shed row's window rejected nothing")
    ms = cuda_ms(torch, lambda: KF.fused_window(*args), reps)
    plain_ms = cuda_ms(torch, lambda: KF.fused_window_plain(*args), 2)
    prof = profile_device(torch, lambda: [KF.fused_window(*args)
                                          for _ in range(reps)])
    N = t.shape[0]
    # each input read once, each output written once: the grid's three
    # float64 columns and int32 mode ids, the rows, the result; about 9
    # float64 operations per grid entry per rung a device runs (two
    # products, a difference, two quotients, a sum, three comparisons), 4
    # per arrival an admitting device judges, 2 per batch folded and 1 per
    # latency
    nbytes = 28.0 * N + 8.0 * rows.numel() + 8.0 * K * (KF.N_OUT + 2 * T)
    adm = int(g["n_adm"].sum() + g["n_rej"].sum()) if args[7] else 0
    served = int((g["n_batches"] * np.where(
        g["solved"], bsf.cpu().numpy()[g["sel"]], 0)).sum())
    ops = (9.0 * N * int(g["rungs"].sum()) + 4.0 * adm
           + 2.0 * int(g["n_batches"].sum()) + served)
    b_ms, by = bound(nbytes, ops)
    shed_ms = cuda_ms(torch, lambda: KF.fused_window(*shed_args), reps)
    return {"shape": [K, T], "grid_entries": N, "trims": bool(args[7]),
            "kernel_ms": ms,
            "kernel_device_ms": prof["kf_device_ms"] / max(1, reps),
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms,
            "bound_by": by, "bound_bytes": nbytes, "bound_ops": ops,
            "rungs_run": int(g["rungs"].sum()),
            "solved": int(g["solved"].sum()), "max_abs_err": err,
            "shed_row": {"shape": [shed_args[4].shape[0],
                                   shed_args[4].shape[1] - KF.N_IN],
                         "rejected": int(sg["n_rej"].sum()),
                         "kernel_ms": shed_ms, "max_abs_err": shed_err}}


def attention_pairs(S: int, window) -> int:
    """(query, key) pairs a causal (windowed) attention row set visits."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def grad_scale(torch, want, dtype: str):
    """want's RMS or GRAD_FLOOR, whichever is larger, and want's RMS."""
    rms = float(want.square().mean().sqrt())
    return max(rms, GRAD_FLOOR), rms


def attention_scale(torch, want, dtype: str):
    """The scale of K3's element-wise limit for ``want`` (see ATTN_TOL):
    per row in bf16, ``grad_scale`` in float32; and want's RMS."""
    if dtype != "bfloat16":
        return grad_scale(torch, want, dtype)
    rms = float(want.square().mean().sqrt())
    row = want.square().mean(dim=-1, keepdim=True).sqrt()
    return row.clamp_min(max(ATTN_ROW_FLOOR * rms, ATTN_ABS_FLOOR)), rms


def limit_record(torch, got, want, tol: float, scale_of, dtype: str) -> dict:
    """|got - want| against tol (|want| + scale): max |got - want|, want's
    RMS and largest |value|, and the largest share of its limit that any
    element takes (at most 1 to pass; NaN where got is not finite)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    scale, rms = scale_of(torch, w, dtype)
    return {"max_abs_err": float(diff.max()), "rms": rms,
            "max_abs": float(w.abs().max()),
            "limit_share": float((diff / (tol * (w.abs() + scale))).max())}


def check_attention(torch, K3, shape, dtype, window, gen, dev) -> tuple:
    """K3's forward against its plain version element by element; returns
    the inputs, the plain output and the record."""
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    got = K3.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    want = K3.flash_attention_plain(q, k, v, window=window)
    dt = str(dtype).split(".")[-1]
    rec = limit_record(torch, got, want, ATTN_TOL[dt], attention_scale, dt)
    if not rec["limit_share"] <= 1.0:
        fail(f"flash_attention {shape} {dt} window={window}: differs from "
             f"the plain version by {rec['max_abs_err']} at most, "
             f"{rec['limit_share']} of the limit {ATTN_TOL[dt]} (|want| + "
             f"scale; RMS {rec['rms']})")
    return (q, k, v, want), {"shape": list(shape), "window": window,
                             "dtype": dt, **rec}


def sdpa_share(torch, got, want) -> float:
    """The largest share of K3's bf16 limit that SDPA's result takes: a
    yardstick of the rule, not a gate."""
    return limit_record(torch, got, want, ATTN_TOL["bfloat16"],
                        attention_scale, "bfloat16")["limit_share"]


def attention_fwd_timed(torch, K3, shape, gen, dev, reps: int,
                        plain_reps: int, window=None) -> dict:
    """K3's bf16 causal (windowed) forward at ``shape``: checked, timed
    beside its plain version and SDPA (given the window as a boolean mask),
    with its bound and TFLOP/s of the least work."""
    B, H, S, D = shape
    (q, k, v, want), rec = check_attention(torch, K3, shape, torch.bfloat16,
                                           window, gen, dev)
    sdpa_kw = dict(is_causal=True)
    if window is not None:
        pos = torch.arange(S, device=dev)
        gap = pos[:, None] - pos[None, :]
        sdpa_kw = dict(attn_mask=(gap >= 0) & (gap < window))
    sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention,
                             **sdpa_kw)
    rec["sdpa_limit_share"] = sdpa_share(torch, sdpa(q, k, v), want)
    del want
    ms = cuda_ms(torch, lambda: K3.flash_attention(q, k, v, window=window),
                 reps)
    plain_ms = cuda_ms(torch, lambda: K3.flash_attention_plain(
        q, k, v, window=window), plain_reps)
    library_ms = cuda_ms(torch, lambda: sdpa(q, k, v), reps)
    # q, k, v read once and o written once; 4 D flops (QK^T and PV) per
    # visible (query, key) pair, at the bf16 tensor rate
    flops = 4.0 * D * B * H * attention_pairs(S, window)
    b_ms, by = bound(4.0 * B * H * S * D * q.element_size(), flops,
                     OPS_PER_S["bfloat16"])
    del q, k, v
    torch.cuda.empty_cache()
    return {**rec, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": by,
            "tflops": flops / ms / 1e9, "library_tflops":
            flops / library_ms / 1e9}


def time_attention(torch, K3, gen, dev, reps: int) -> dict:
    """K3 at the serve_interleaved forward's shape and at the train phase's
    in bf16 (timed, with SDPA as the library yardstick), then checked at
    the windowed and ragged shapes in float32 and bf16."""
    main = attention_fwd_timed(torch, K3, ATTN_SHAPE, gen, dev, reps, 2)
    train = attention_fwd_timed(torch, K3, ATTN_TRAIN_SHAPE, gen, dev,
                                4 * reps, reps)
    checks = []
    for (b, h, s, d, window) in ATTN_CHECKS:
        for dtype in (torch.float32, torch.bfloat16):
            _, rec = check_attention(torch, K3, (b, h, s, d), dtype, window,
                                     gen, dev)
            checks.append(rec)
    torch.cuda.empty_cache()
    return {**main, "library": "scaled_dot_product_attention(is_causal=True)",
            "train_shape": train, "checks": checks}


def check_head_dim_refused(torch, K3, dev) -> dict:
    """K3 on a head dim outside ``HEAD_DIMS`` (``ATTN_REFUSED_D``): a
    ``ValueError`` naming the head dims it takes, and no launch — no
    fallback to the plain version."""
    q = torch.zeros((1, 2, 64, ATTN_REFUSED_D), dtype=torch.bfloat16,
                    device=dev)
    n0 = K3.flash_attention.launches
    try:
        K3.flash_attention(q, q, q)
    except ValueError as e:
        msg = str(e)
    else:
        fail(f"flash_attention at head dim {ATTN_REFUSED_D} did not raise")
    if str(K3.HEAD_DIMS) not in msg or K3.flash_attention.launches != n0:
        fail(f"flash_attention at head dim {ATTN_REFUSED_D}: expected a "
             f"refusal naming {K3.HEAD_DIMS} and no launch, got {msg!r} and "
             f"{K3.flash_attention.launches - n0} launch(es)")
    return {"head_dim": ATTN_REFUSED_D, "refused": msg}


def time_attention_d160(torch, K3, gen, dev) -> dict:
    """K3 at head dim 160: forward and backward in bf16 at
    ``ATTN_D160_SHAPE``, timed beside SDPA and its backward; the
    ``ATTN_D160_CHECKS`` shapes both ways in float32 and bf16, the bf16
    forward timed beside SDPA with the window as a mask; and
    ``check_head_dim_refused``."""
    fwd = attention_fwd_timed(torch, K3, ATTN_D160_SHAPE, gen, dev, 10, 2)
    bwd = attention_bwd_timed(torch, K3, ATTN_D160_SHAPE, gen, dev, 10, 1)
    edges, checks = [], []
    for (b, h, s, d, window) in ATTN_D160_CHECKS:
        edges.append(attention_fwd_timed(torch, K3, (b, h, s, d), gen, dev,
                                         10, 2, window=window))
        for dtype in (torch.float32, torch.bfloat16):
            checks.append(check_attention(torch, K3, (b, h, s, d), dtype,
                                          window, gen, dev)[1])
            checks.append({"backward": True, **check_attention_bwd(
                torch, K3, (b, h, s, d), dtype, window, gen, dev)[1]})
    torch.cuda.empty_cache()
    return {"forward": fwd, "backward": bwd, "edges": edges,
            "checks": checks, "refusal": check_head_dim_refused(torch, K3,
                                                                dev)}


def ssd_case(torch, shape, gen, dev):
    """Mamba2-like SSD inputs: dt = softplus(N(0,1) - 2), A in -[1, 16)."""
    b, nc, l, h, p, n = shape
    f32 = dict(dtype=torch.float32, device=dev)
    x = torch.randn((b, nc, l, h, p), generator=gen, **f32)
    dt = torch.nn.functional.softplus(
        torch.randn((b, nc, l, h), generator=gen, **f32) - 2.0)
    A = -(1.0 + 15.0 * torch.rand(h, generator=gen, **f32))
    B = torch.randn((b, nc, l, n), generator=gen, **f32)
    C = torch.randn((b, nc, l, n), generator=gen, **f32)
    return x, (dt * A).contiguous(), dt, B, C


def ssd_share(torch, got, want) -> float:
    """The largest share of ``SSD_TOL``'s allclose limit, |got - want| /
    (atol + rtol |want|), that any element takes (at most 1 to pass)."""
    limit = SSD_TOL["atol"] + SSD_TOL["rtol"] * want.abs()
    return float(((got - want).abs() / limit).max()) if got.numel() else 0.0


def check_ssd(torch, K4, shape, gen, dev) -> tuple:
    """K4's forward against its plain version at ``shape``: ``allclose``
    within ``SSD_TOL`` for y and the states, each with its largest share
    of that limit. Returns the inputs and the record."""
    args = ssd_case(torch, shape, gen, dev)
    y, st = K4.ssd_chunk(*args)
    torch.cuda.synchronize()
    yp, stp = K4.ssd_chunk_plain(*args)
    err = {"y": float((y - yp).abs().max()),
           "st": float((st - stp).abs().max())}
    share = {"y": ssd_share(torch, y, yp), "st": ssd_share(torch, st, stp)}
    if not (torch.allclose(y, yp, **SSD_TOL)
            and torch.allclose(st, stp, **SSD_TOL)):
        fail(f"ssd_chunk {shape}: differs from the plain version by {err} "
             f"at most, {share} of the limit (tolerance {SSD_TOL})")
    return args, {"shape": list(shape), "max_abs_err": max(err.values()),
                  "max_abs_err_by_output": err, "limit_share": share}


def ssd_fwd_work(shape) -> tuple[float, float]:
    """Bytes and operations K4's forward needs at ``shape``: x, dA, dt, B,
    C read once, y and the states written once; the least work is C B^T
    below the diagonal once per (batch, chunk) (it does not depend on the
    head), then per head the masked product with x below the diagonal and
    the state product, 2 flops per multiply-add."""
    b, nc, l, h, p, n = shape
    tri = l * (l + 1) // 2
    nbytes = 4.0 * (2 * b * nc * l * h * p + 2 * b * nc * l * h
                    + 2 * b * nc * l * n + b * nc * h * n * p)
    return nbytes, 2.0 * b * nc * (tri * n + h * (tri * p + l * n * p))


def ssd_bwd_work(shape) -> tuple[float, float]:
    """Bytes and operations K4's backward needs at ``shape``: x, dy, dA,
    dt, B, C, dst read once; dx, ddA, ddt, dB, dC written once. Least work:
    G = C B^T, dC = dG B and dB = dG^T C below the diagonal once per
    (batch, chunk) (the heads' dG summed first), then per head dy x^T and
    M^T dy below the diagonal and the two state products, 2 flops per
    multiply-add."""
    b, nc, l, h, p, n = shape
    tri = l * (l + 1) // 2
    nbytes = 4.0 * (3 * b * nc * l * h * p + 4 * b * nc * l * h
                    + 4 * b * nc * l * n + b * nc * h * n * p)
    ops = 2.0 * b * nc * (3 * tri * n + h * (2 * tri * p + 2 * l * n * p))
    return nbytes, ops


def time_ssd(torch, K4, gen, dev, reps: int) -> dict:
    """K4's forward at the serve_interleaved forward's shape (checked on
    ``SSD_DRAWS`` draws, the first timed; the largest share is the
    record's), then checked at ``SSD_CHECKS``."""
    args, rec = check_ssd(torch, K4, SSD_SHAPE, gen, dev)
    ms = cuda_ms(torch, lambda: K4.ssd_chunk(*args), reps)
    plain_ms = cuda_ms(torch, lambda: K4.ssd_chunk_plain(*args), 2)
    nbytes, ops = ssd_fwd_work(SSD_SHAPE)
    b_ms, by, b32_ms = float32_bound(nbytes, ops)
    del args
    torch.cuda.empty_cache()
    draws = [rec] + [check_ssd(torch, K4, SSD_SHAPE, gen, dev)[1]
                     for _ in range(SSD_DRAWS - 1)]
    shares = [d["limit_share"] for d in draws]
    for key in ("limit_share", "max_abs_err_by_output"):
        rec[key] = {k: max(d[key][k] for d in draws) for k in ("y", "st")}
    rec["max_abs_err"] = max(d["max_abs_err"] for d in draws)
    rec["limit_share_draws"] = shares
    torch.cuda.empty_cache()
    checks = []
    for shape in SSD_CHECKS:
        _, check = check_ssd(torch, K4, shape, gen, dev)
        checks.append(check)
    return {**rec, "dtype": "float32", "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "library": "none: no single PyTorch call computes the SSD chunk",
            "bound_ms": b_ms, "bound_by": by, "bound_float32_ms": b32_ms,
            "tflops": ops / ms / 1e9, "checks": checks}


def time_ssd_at(torch, K4, shape, gen, dev, reps: int) -> dict:
    """K4's forward at ``shape``: checked against its plain version, timed
    beside it, with its bound."""
    args, rec = check_ssd(torch, K4, shape, gen, dev)
    ms = cuda_ms(torch, lambda: K4.ssd_chunk(*args), reps)
    plain_ms = cuda_ms(torch, lambda: K4.ssd_chunk_plain(*args), 2)
    nbytes, ops = ssd_fwd_work(shape)
    b_ms, by, b32_ms = float32_bound(nbytes, ops)
    del args
    torch.cuda.empty_cache()
    return {**rec, "dtype": "float32", "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": by,
            "bound_float32_ms": b32_ms, "tflops": ops / ms / 1e9}


def check_grads(torch, what: str, names, got, want, tol: float,
                scale_of=grad_scale, dtype: str = "float32") -> dict:
    """Kernel gradients against their plain versions, element by element:
    |got - want| <= tol (|want| + scale), ``scale_of`` giving the scale;
    fails at the first gradient past its limit. Records each gradient's
    max |got - want| beside want's RMS and largest |value|, and the largest
    share of its limit that any element takes (``limit_record``)."""
    recs = {}
    for name, got_, want_ in zip(names, got, want):
        rec = recs[f"d{name}"] = limit_record(torch, got_, want_, tol,
                                              scale_of, dtype)
        if not rec["limit_share"] <= 1.0:
            fail(f"{what}: d{name} differs from the plain backward by "
                 f"{rec['max_abs_err']} at most, {rec['limit_share']} of "
                 f"the limit {tol} (|want| + scale; RMS {rec['rms']})")
    return {"max_abs_err": max(r["max_abs_err"] for r in recs.values()),
            "limit_share": max(r["limit_share"] for r in recs.values()),
            "grads": recs}


def check_attention_bwd(torch, K3, shape, dtype, window, gen, dev) -> tuple:
    """K3's backward kernel against its plain backward; returns the inputs
    and the comparison's record."""
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(4))
    out, lse = K3.flash_attention_fwd(q, k, v, window)
    got = K3.flash_attention_bwd(q, k, v, out, lse, do, window)
    torch.cuda.synchronize()
    want = K3.flash_attention_bwd_plain(q, k, v, out, do, window)
    dt = str(dtype).split(".")[-1]
    rec = check_grads(torch, f"flash_attention_bwd {shape} {dt} "
                             f"window={window}", "qkv", got, want,
                      ATTN_TOL[dt], attention_scale, dt)
    del got, want
    return (q, k, v, out, lse, do), {"shape": list(shape), "window": window,
                                     "dtype": dt, **rec}


def attention_bwd_timed(torch, K3, shape, gen, dev, reps: int,
                        plain_reps: int) -> dict:
    """K3's bf16 causal backward at ``shape``: checked, timed beside its
    plain version and SDPA's backward, with its bound and TFLOP/s of the
    least work. SDPA's gradients are read against the plain backward of
    SDPA's own output under the same rule, as a yardstick."""
    B, H, S, D = shape
    (q, k, v, out, lse, do), rec = check_attention_bwd(
        torch, K3, shape, torch.bfloat16, None, gen, dev)
    ms = cuda_ms(torch, lambda: K3.flash_attention_bwd(q, k, v, out, lse, do),
                 reps)
    plain_ms = cuda_ms(
        torch, lambda: K3.flash_attention_bwd_plain(q, k, v, out, do),
        plain_reps)
    # the three kernels' shares of one call (D, dK/dV pass, dQ pass)
    prof = profile_device(torch, lambda: K3.flash_attention_bwd(
        q, k, v, out, lse, do))
    rec["split_ms"] = {e["name"][:60]: e["device_ms"] for e in prof["top"]}
    torch.cuda.empty_cache()
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref = torch.nn.functional.scaled_dot_product_attention(*leaves,
                                                           is_causal=True)
    sdpa_grads = torch.autograd.grad(ref, leaves, do, retain_graph=True)
    want = K3.flash_attention_bwd_plain(q, k, v, ref.detach(), do)
    rec["sdpa_limit_share"] = {f"d{n}": sdpa_share(torch, g, w) for n, g, w
                               in zip("qkv", sdpa_grads, want)}
    del sdpa_grads, want
    torch.cuda.empty_cache()
    library_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        ref, leaves, do, retain_graph=True), reps)
    del leaves, ref
    # q, k, v, o, do read once (and the float32 logsumexp), dq, dk, dv
    # written once; 10 D flops per visible pair (q k^T recomputed, do v^T,
    # dv, dq, dk), at the bf16 tensor rate
    flops = 10.0 * D * B * H * attention_pairs(S, None)
    b_ms, by = bound(8.0 * B * H * S * D * q.element_size() + 4.0 * B * H * S,
                     flops, OPS_PER_S["bfloat16"])
    del q, k, v, out, lse, do
    torch.cuda.empty_cache()
    return {**rec, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": by,
            "tflops": flops / ms / 1e9,
            "library_tflops": flops / library_ms / 1e9}


def time_attention_bwd(torch, K3, gen, dev, reps: int) -> dict:
    """K3's backward at the serve_interleaved forward's shape and at the
    train phase's in bf16 (timed, with SDPA's backward as the library
    yardstick), then checked in float32 at both shapes and at the windowed
    and ragged shapes in float32 and bf16."""
    main = attention_bwd_timed(torch, K3, ATTN_SHAPE, gen, dev, reps, 1)
    train = attention_bwd_timed(torch, K3, ATTN_TRAIN_SHAPE, gen, dev,
                                4 * reps, reps)
    checks = [(ATTN_SHAPE, None, (torch.float32,)),
              (ATTN_TRAIN_SHAPE, None, (torch.float32,))]
    checks += [(c[:4], c[4], (torch.float32, torch.bfloat16))
               for c in ATTN_CHECKS]
    recs = []
    for shape, window, dtypes in checks:
        for dtype in dtypes:
            _, rec = check_attention_bwd(torch, K3, shape, dtype, window, gen,
                                         dev)
            recs.append(rec)
            torch.cuda.empty_cache()
    return {**main, "library": "backward of scaled_dot_product_attention("
                               "is_causal=True) (torch.autograd.grad over its "
                               "graph)",
            "train_shape": train, "checks": recs}


def time_ssd_bwd(torch, K4, gen, dev, reps: int, shape=SSD_SHAPE) -> dict:
    """K4's backward at ``shape`` (the serve_interleaved forward's by
    default), with the chunk's |cs| in the hundreds (A in -[1, 16), l =
    256)."""
    b, nc, l, h, p, n = shape
    args = ssd_case(torch, shape, gen, dev)
    dy = torch.randn(args[0].shape, generator=gen, device=dev)
    dst = torch.randn((b, nc, h, n, p), generator=gen, device=dev)
    got = K4.ssd_chunk_bwd(*args, dy, dst)
    torch.cuda.synchronize()
    want = K4.ssd_chunk_bwd_plain(*args, dy, dst)
    rec = check_grads(torch, f"ssd_chunk_bwd {shape}",
                      ("x", "dA", "dt", "B", "C"), got, want, SSD_BWD_TOL)
    del got, want
    ms = cuda_ms(torch, lambda: K4.ssd_chunk_bwd(*args, dy, dst), reps)
    plain_ms = cuda_ms(torch, lambda: K4.ssd_chunk_bwd_plain(*args, dy, dst),
                       1)
    # the kernels' shares of one call
    prof = profile_device(torch, lambda: K4.ssd_chunk_bwd(*args, dy, dst))
    split_ms = {e["name"][:60]: e["device_ms"] for e in prof["top"]}
    nbytes, ops = ssd_bwd_work(shape)
    b_ms, by, b32_ms = float32_bound(nbytes, ops)
    del args, dy, dst
    torch.cuda.empty_cache()
    return {"shape": list(shape), "dtype": "float32", "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "library": "none: no single PyTorch call computes the SSD chunk's "
                       "gradient",
            "bound_ms": b_ms, "bound_by": by, "bound_float32_ms": b32_ms,
            "tflops": ops / ms / 1e9, "split_ms": split_ms,
            "max_abs_err": rec["max_abs_err"],
            "limit_share": rec["limit_share"], "grads": rec["grads"]}


def matmul_share(torch, got, want) -> float:
    """The largest share of ``MM_TOL`` x (|want| + the RMS of want's row)
    that any element of a bf16 product takes: a per-row view of the
    ``allclose`` check beside it, as K3 reports its share."""
    g, w = got.float(), want.float()
    row = w.square().mean(dim=1, keepdim=True).sqrt()
    return float(((g - w).abs()
                  / (MM_TOL["bfloat16"] * (w.abs() + row))).max())


def check_matmul(torch, K5, shape, dtype, gen, dev) -> tuple:
    """K5 against its plain version at ``shape`` (M, K, N), through the
    route its wrapper picks (recorded): allclose within ``MM_TOL``, and in
    bf16 the per-row share of the same tolerance."""
    M, K, N = shape
    a = torch.randn((M, K), generator=gen, device=dev).to(dtype)
    b = (torch.randn((K, N), generator=gen, device=dev)
         / math.sqrt(K)).to(dtype)
    way = K5.route(a, b)
    before = K5.tiled_matmul.routes[way]
    got = K5.tiled_matmul(a, b)
    torch.cuda.synchronize()
    if K5.tiled_matmul.routes[way] != before + 1:
        fail(f"tiled_matmul {shape} {dtype}: did not launch the {way} route")
    want = K5.tiled_matmul_plain(a, b)
    dt = str(dtype).split(".")[-1]
    tol = MM_TOL[dt]
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        fail(f"tiled_matmul {shape} {dtype}: differs from the plain version by "
             f"{err} (tolerance {tol})")
    rec = {"shape": list(shape), "dtype": dt, "route": way,
           "max_abs_err": err, "allclose": True}
    if dtype == torch.bfloat16:
        rec["limit_share"] = matmul_share(torch, got, want)
    return (a, b), rec


def time_matmul(torch, K5, gen, dev, reps: int) -> dict:
    """K5 at the MLP up-projection's shape in bf16 (timed, with
    ``torch.matmul`` as the library yardstick), then checked at the ragged
    shape (no dimension a multiple of 8) and at the edge shape (K and N
    multiples of 8, no dimension a multiple of a tile) in both types."""
    M, K, N = MM_SHAPE
    (a, b), rec = check_matmul(torch, K5, MM_SHAPE, torch.bfloat16, gen, dev)
    ms = cuda_ms(torch, lambda: K5.tiled_matmul(a, b), reps)
    plain_ms = cuda_ms(torch, lambda: K5.tiled_matmul_plain(a, b), 2)
    library_ms = cuda_ms(torch, lambda: torch.matmul(a, b), reps)
    # a, b read once, c written once; 2 M N K flops at the bf16 tensor rate
    b_ms, by = bound(2.0 * (M * K + K * N + M * N), 2.0 * M * N * K,
                     OPS_PER_S["bfloat16"])
    del a, b
    checks = [check_matmul(torch, K5, shape, dtype, gen, dev)[1]
              for shape in (MM_RAGGED, MM_EDGES)
              for dtype in (torch.float32, torch.bfloat16)]
    torch.cuda.empty_cache()
    return {**rec, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": "torch.matmul",
            "bound_ms": b_ms, "bound_by": by,
            "tflops": 2.0 * M * N * K / ms / 1e9, "checks": checks}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch, build) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    nvcc_s = build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for name in build.SOURCES
             for ln in (build.build_log(name) or "").splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    out = {"phase": "device", "nvidia_smi": smi,
           "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(),
           "capability": list(torch.cuda.get_device_capability(0)),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "build_s": build_s, "nvcc_s": nvcc_s, "ptxas": ptxas}
    emit(out)
    return out


def moe_attention_shapes(C) -> dict:
    """K3's (shape, window) on the moe phase's path, from the MOE_LAYERS
    configurations: each one's prefill (FAM_BS x FAM_PROMPT, its query
    heads, its head dim) and, where it has a window, its prompt past it
    (bs 1 x MOE_WINDOW_PROMPT)."""
    shapes = {}
    for arch in MOE_LAYERS:
        cfg = C.get_config(arch)
        h, d = cfg.n_heads, cfg.resolved_head_dim
        shapes[arch] = ((FAM_BS, h, FAM_PROMPT, d), None)
        if cfg.sliding_window is not None:
            shapes[arch + ".window"] = ((1, h, MOE_WINDOW_PROMPT, d),
                                        cfg.sliding_window)
    return shapes


def phase_kernels(torch, np, rt, K1, K2, K3, K4, K5, seed: int) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    args, valid = maxplus_case(torch, *MAXPLUS_SHAPE, gen, dev)
    k1 = time_maxplus(torch, K1, args, valid, reps=10)
    del args, valid
    k2 = {}
    for key, shape in SORT_SHAPES.items():
        mat, bud = sort_case(torch, *shape, gen, dev)
        k2[key] = time_sort(torch, K2, mat, bud, reps=20)
        del mat, bud
    torch.cuda.empty_cache()
    k3 = time_attention(torch, K3, gen, dev, reps=10)
    k4 = time_ssd(torch, K4, gen, dev, reps=10)
    k3b = time_attention_bwd(torch, K3, gen, dev, reps=5)
    k4b = time_ssd_bwd(torch, K4, gen, dev, reps=5)
    k5 = time_matmul(torch, K5, gen, dev, reps=10)
    # the families phase's shapes: mamba2-780m's SSD at n = 128, both ways,
    # and minitron-4b's prefill attention at D = 128 (24 heads from 8 KV
    # heads)
    k4_n128 = time_ssd_at(torch, K4, SSD_N128_SHAPE, gen, dev, reps=10)
    k4b_n128 = time_ssd_bwd(torch, K4, gen, dev, reps=5,
                            shape=SSD_N128_SHAPE)
    k3_d128 = attention_fwd_timed(torch, K3, ATTN_GQA_SHAPE, gen, dev, 10, 2)
    # stablelm-12b's: K3 at head dim 160, both ways
    k3_d160 = time_attention_d160(torch, K3, gen, dev)
    # the moe phase's: each configuration's prefill, and Mixtral's prompt
    # past its window
    k3_moe = {name: attention_fwd_timed(torch, K3, shape, gen, dev,
                                        *((10, 2) if window is None
                                          else (3, 1)), window=window)
              for name, (shape, window)
              in moe_attention_shapes(rt["C"]).items()}
    kf = time_fused(torch, np, rt, fused_inputs(
        rt, FUSED_K, [30.0 * m * FUSED_K for m in FLEET_RATES[:2]],
        dict(seed=3, dispatch="least-backlog"),
        dict(FLEET_CL, mode_switch_s=0.25)),
        fused_inputs(rt, FUSED_K,
                     [30.0 * m * FUSED_K for m in FLEET_ADM_RATES[:2]],
                     dict(seed=3, dispatch="least-backlog",
                          migrate_backlog=True,
                          fleet_power_budget=27.0 * FUSED_K),
                     dict(FLEET_CL, mode_switch_s=0.25, burst_quantile=0.95,
                          admission="shed")), reps=20)
    out = {"phase": "kernels", "maxplus_scan": k1, **k2,
           "maxplus_scan_library": "no single PyTorch call computes the "
                                   "max-plus recurrence with fills",
           "flash_attention": k3, "ssd_chunk": k4,
           "flash_attention_bwd": k3b, "ssd_chunk_bwd": k4b,
           "tiled_matmul": k5, "fused_window": kf,
           "ssd_chunk_n128": k4_n128, "ssd_chunk_bwd_n128": k4b_n128,
           "flash_attention_d128_gqa": k3_d128,
           "flash_attention_d160": k3_d160,
           "flash_attention_moe": k3_moe,
           "fused_window_library": "no single PyTorch call plans, admits "
                                   "and folds a window"}
    emit(out)
    return out


class Launches:
    """Reads the kernels' launch counts around one path phase."""

    def __init__(self, wrappers: dict):
        self.wrappers = wrappers          # kernel name -> counting wrapper

    def reset(self) -> None:
        for fn in self.wrappers.values():
            fn.launches = 0

    def read(self, phase: str, path=ENGINE_KERNELS) -> dict:
        """Every kernel's count; fails unless each kernel of the phase's
        path launched."""
        got = {name: fn.launches for name, fn in self.wrappers.items()}
        for name in path:
            if got[name] < 1:
                fail(f"{phase}: kernel {name} was not launched on the path")
        return got


def compare_reports(np, ref, got, what: str) -> float:
    """Engine tolerance between two runs of the same lanes: latencies within
    ENG_TOL, training minibatches within +-2. Returns the max |Δlatency|."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(ref, got)):
        la = np.asarray(a.latencies, np.float64)
        lb = np.asarray(b.latencies, np.float64)
        if la.shape != lb.shape or not np.allclose(lb, la, **ENG_TOL):
            fail(f"{what}: lane {i} latencies differ beyond {ENG_TOL}")
        if abs(a.train_minibatches - b.train_minibatches) > 2:
            fail(f"{what}: lane {i} trained {b.train_minibatches} vs "
                 f"{a.train_minibatches}")
        if la.size:
            worst = max(worst, float(np.abs(lb - la).max()))
        if not np.array_equal(b._sorted, np.sort(lb)):
            fail(f"{what}: lane {i} report cache is not its sorted latencies")
    return worst


def phase_execute(torch, np, rt, launches: Launches) -> dict:
    P, S, Fulcrum = rt["P"], rt["S"], rt["Fulcrum"]
    w_tr = rt["TRAIN"]["mobilenet"]
    w_in = rt["INFER"]["mobilenet"]
    f = Fulcrum(rt["DeviceModel"]())
    plan = f.solve_concurrent(w_tr, w_in, P.ConcurrentProblem(35.0, 1.0, 60.0),
                              strategy="gmd")
    if plan is None:
        fail("execute: GMD found no plan for the README quickstart")
    trace = S.ArrivalTrace.poisson(60.0, duration=120.0, seed=0)
    launches.reset()
    t0 = time.perf_counter()
    rep = f.execute(plan, w_in, w_tr, trace=trace, backend="cuda")
    wall = time.perf_counter() - t0
    counts = launches.read("execute")
    ref = f.execute(plan, w_in, w_tr, trace=trace, backend="cpu")
    err = compare_reports(np, [ref], [rep], "execute")
    out = {"phase": "execute", "plan": {"pm": str(plan.solution.pm),
                                        "bs": plan.solution.bs,
                                        "tau_tr": plan.solution.tau_tr},
           "requests": len(trace), "p95_latency_s": rep.latency_quantile(0.95),
           "train_throughput": rep.train_throughput, "power_w": rep.power,
           "train_minibatches": [rep.train_minibatches,
                                 ref.train_minibatches],
           "max_abs_latency_err_s": err, "wall_s": wall, "launches": counts}
    emit(out)
    return out


def phase_serve_dynamic(torch, np, rt, launches: Launches) -> dict:
    f = rt["Fulcrum"](rt["DeviceModel"]())
    w = rt["INFER"]["resnet50"]
    rates = [45.0, 60.0, 115.0, 50.0]
    launches.reset()
    t0 = time.perf_counter()
    got = f.serve_dynamic(w, 40.0, 0.1, rates, strategy="gmd",
                          window_duration=30.0, backend="cuda")
    wall = time.perf_counter() - t0
    counts = launches.read("serve_dynamic")
    ref = f.serve_dynamic(w, 40.0, 0.1, rates, strategy="gmd",
                          window_duration=30.0, backend="cpu")
    for a, b in zip(ref, got):
        if (a.solution, a.replanned) != (b.solution, b.replanned):
            fail("serve_dynamic: plans differ between cuda and cpu")
        if abs(a.goodput - b.goodput) * max(1, a.offered_requests) > 1:
            fail("serve_dynamic: goodput differs by more than one request")
    err = compare_reports(np, [w.report for w in ref],
                          [w.report for w in got], "serve_dynamic")
    out = {"phase": "serve_dynamic",
           "windows": [{"rate": w.rate, "pm": str(w.solution.pm),
                        "bs": w.solution.bs, "replanned": w.replanned,
                        "p95_latency_s": w.report.latency_quantile(0.95),
                        "violation_rate": w.report.violation_rate(0.1),
                        "goodput": w.goodput} for w in got],
           "max_abs_latency_err_s": err, "wall_s": wall, "launches": counts}
    emit(out)
    return out


def compare_windows(np, ref, got, what: str) -> list:
    """Two serving runs of the same inputs, ``ref`` on cpu and ``got`` on
    cuda: per window the same plan, replanning, splits, shed / deferred /
    carried / offered counts, estimated rate and mode-switch charge;
    latencies within ENG_TOL (per tenant), training minibatches within +-2
    and goodput within one offered request. Returns each window's max
    |Δlatency|."""
    keys = ("solution", "replanned", "splits", "shed_requests",
            "deferred_requests", "carried_requests", "offered_requests",
            "estimated_rate", "mode_switch_s")
    errs = []
    for i, (a, b) in enumerate(zip(ref, got)):
        for k in keys:
            if getattr(a, k) != getattr(b, k):
                fail(f"{what}: window {i} {k} is {getattr(b, k)} on cuda, "
                     f"{getattr(a, k)} on cpu")
        if abs(a.goodput - b.goodput) * max(1, a.offered_requests) > 1:
            fail(f"{what}: window {i} goodput differs by more than one "
                 f"request")
        if (a.report is None) != (b.report is None):
            fail(f"{what}: window {i} served on one backend only")
        errs.append(0.0 if a.report is None
                    else compare_multi(np, a.report, b.report,
                                       f"{what} window {i}"))
    if len(ref) != len(got):
        fail(f"{what}: {len(got)} windows on cuda, {len(ref)} on cpu")
    return errs


def compare_multi(np, ref, got, what: str) -> float:
    """One report, or one multi-tenant report tenant by tenant, from cpu
    and cuda: latencies within ENG_TOL, training within +-2, a report's
    sorted cache (where the report builder filled it) equal to its sorted
    latencies. Returns the max |Δlatency|."""
    pairs = list(zip(ref.streams, got.streams)) \
        if hasattr(ref, "streams") else [(ref, got)]
    if hasattr(ref, "streams") and len(ref.streams) != len(got.streams):
        fail(f"{what}: tenant counts differ")
    worst = 0.0
    for j, (a, b) in enumerate(pairs):
        la = np.asarray(a.latencies, np.float64)
        lb = np.asarray(b.latencies, np.float64)
        if la.shape != lb.shape or not np.allclose(lb, la, **ENG_TOL):
            fail(f"{what}: tenant {j} latencies differ beyond {ENG_TOL}")
        if la.size:
            worst = max(worst, float(np.abs(lb - la).max()))
        if b._sorted is not None and not np.array_equal(b._sorted,
                                                        np.sort(lb)):
            fail(f"{what}: tenant {j} report cache is not its sorted "
                 f"latencies")
    if abs(ref.train_minibatches - got.train_minibatches) > 2:
        fail(f"{what}: trained {got.train_minibatches} vs "
             f"{ref.train_minibatches}")
    return worst


def add_counts(total: dict, counts: dict) -> dict:
    return {k: total.get(k, 0) + n for k, n in counts.items()}


def timed_windows(f) -> list:
    """Wall milliseconds of each call of this Fulcrum's closed-loop window
    step, in window order."""
    ms, step = [], f._closed_loop_window

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = step(*args, **kwargs)
        ms.append(1e3 * (time.perf_counter() - t0))
        return out

    f._closed_loop_window = timed
    return ms


def window_records(windows, errs, ms=None) -> list:
    """What each window planned, shed, deferred, carried and served."""
    out = []
    for i, w in enumerate(windows):
        sol, rep = w.solution, w.report
        rec = {"rate": w.rate, "estimated_rate": w.estimated_rate,
               "plan": None if sol is None else
               {"pm": str(sol.pm), "bs": getattr(sol, "bss", None) or sol.bs,
                "tau_tr": sol.tau_tr},
               "replanned": w.replanned, "splits": w.splits,
               "offered": w.offered_requests, "shed": w.shed_requests,
               "deferred": w.deferred_requests,
               "carried": w.carried_requests, "goodput": w.goodput,
               "max_abs_latency_err_s": errs[i]}
        if rep is not None:
            rec["p95_latency_s"] = (rep.worst_latency_quantile(0.95)
                                    if hasattr(rep, "streams")
                                    else rep.latency_quantile(0.95))
            rec["train_minibatches"] = rep.train_minibatches
        if ms is not None:
            rec["wall_ms"] = ms[i]
        out.append(rec)
    return out


def phase_serve_closed_loop(torch, np, rt, launches: Launches) -> dict:
    """The single-stream closed loop on cuda against cpu, case by case,
    then the shed case under the profiler."""
    CC, Fulcrum = rt["CC"], rt["Fulcrum"]
    name, power, budget, window = CLOSED_LOOP
    w = rt["INFER"][name]

    def serve(case, backend, f=None):
        rates, arrivals, kw = CLOSED_LOOP_CASES[case]
        f = f or Fulcrum(rt["DeviceModel"]())
        return f.serve_dynamic(w, power, budget, rates, strategy="gmd",
                               window_duration=window, arrivals=arrivals,
                               seed=0, controller=CC.ControllerConfig(**kw),
                               backend=backend)

    cases, total = {}, {}
    for case in CLOSED_LOOP_CASES:
        f = Fulcrum(rt["DeviceModel"]())
        ms = timed_windows(f)
        launches.reset()
        t0 = time.perf_counter()
        got = serve(case, "cuda", f)
        wall = time.perf_counter() - t0
        counts = launches.read(f"serve_closed_loop/{case}")
        total = add_counts(total, counts)
        t0 = time.perf_counter()
        ref = serve(case, "cpu")
        cpu_wall = time.perf_counter() - t0
        errs = compare_windows(np, ref, got, f"serve_closed_loop/{case}")
        cases[case] = {"arrivals": CLOSED_LOOP_CASES[case][1],
                       "wall_s": wall, "cpu_backend_wall_s": cpu_wall,
                       "launches": counts,
                       "max_abs_latency_err_s": max(errs),
                       "windows": window_records(got, errs, ms)}
    if sum(w["shed"] for w in cases["shed"]["windows"]) < 1:
        fail("serve_closed_loop: the shed case shed no request")
    if sum(w["splits"] for w in cases["degrade-bs"]["windows"]) < 1:
        fail("serve_closed_loop: the degrade-bs case split no window")
    profile = profile_device(torch, lambda: serve("shed", "cuda"))
    out = {"phase": "serve_closed_loop", "workload": name,
           "power_budget_w": power, "latency_budget_s": budget,
           "window_s": window, "cases": cases, "launches": total,
           "profile_shed": {k: profile[k] for k in (
               "wall_s", "device_busy_s", "idle_share", "device_ops",
               "k1_device_ms", "k1_kernels", "k2_device_ms", "k2_kernels",
               "cost_s")}}
    emit(out)
    return out


def lane_scaling_args(rt, lanes: int) -> tuple:
    """bench_multi_tenant.py's lane scaling at ``lanes`` lanes: every lane
    the 2-stream (mobilenet + lstm) scenario over two short Poisson traces,
    mobilenet training, (power mode, per-stream bs) cycling."""
    S, INFER = rt["S"], rt["INFER"]
    modes = rt["PowerModeSpace"]().all_modes()
    traces = [S.ArrivalTrace.poisson(r, d, seed=sd)
              for r, d, sd in MT_LANE_TRACES]
    return (rt["DeviceModel"](), rt["TRAIN"]["mobilenet"],
            [[INFER["mobilenet"], INFER["lstm"]]] * lanes,
            [modes[(7 * i) % len(modes)] for i in range(lanes)],
            [list(MT_BS_CYCLE[i % len(MT_BS_CYCLE)]) for i in range(lanes)],
            [traces] * lanes)


def lane_scaling_kernels(torch, np, rt, args, reports) -> dict:
    """K1 at each engine chunk of the lane-scaling batch and K2 at each of
    its sort chunks, re-made from the batch's inputs, each checked against
    its plain version on the card and timed."""
    S, K1, K2 = rt["S"], rt["K1"], rt["K2"]
    dev = torch.device("cuda")
    n = len(args[3])
    lanes = S._multi_lane_events(*args, [None] * n)
    readies = [ln[2] for ln in lanes]
    execs = [ln[3] for ln in lanes]
    k_pad = S._pow2(max(r.size for r in readies))
    k1 = []
    for s, e, lanes_pad in S._lane_chunks(n):
        host = S._chunk_inputs(readies, execs,
                               np.array([ln[1][0] for ln in lanes]),
                               np.full(n, np.inf),
                               np.array([ln[6] for ln in lanes]), s, e,
                               lanes_pad, k_pad)
        kargs = [torch.from_numpy(x).to(dev) for x in host]
        k1.append(time_maxplus(torch, K1, kargs, torch.isfinite(kargs[0]),
                               reps=10))
    lats = [np.asarray(r.latencies, np.float64)
            for mt in reports for r in mt.streams]
    k2 = []
    for i, j in S._sort_chunks([a.size for a in lats]):
        mat = torch.from_numpy(S._pad_rows(lats[i:j])).to(dev)
        budgets = torch.full((j - i,), 0.5, dtype=torch.float64, device=dev)
        k2.append(time_sort(torch, K2, mat, budgets, reps=10))
    torch.cuda.empty_cache()
    return {"maxplus_scan_chunks": k1, "lane_sort_chunks": k2}


def phase_multi_tenant(torch, np, rt, launches: Launches) -> dict:
    """The multi-tenant engine and serving loops on cuda against cpu."""
    P, S, CC, Fulcrum = rt["P"], rt["S"], rt["CC"], rt["Fulcrum"]
    INFER, w_tr = rt["INFER"], rt["TRAIN"]["resnet18"]
    specs = (P.StreamSpec(40.0, 0.8, INFER["mobilenet"]),
             P.StreamSpec(60.0, 0.5, INFER["lstm"]),
             P.StreamSpec(20.0, 1.5, INFER["resnet50"]))
    prob = P.MultiTenantProblem(45.0, specs)
    budgets = [sp.latency_budget for sp in specs]
    f = Fulcrum(rt["DeviceModel"]())
    plan = f.solve_multi_tenant(w_tr, prob, "gmd")
    if plan is None:
        fail("multi_tenant: GMD found no plan for the README's 3 tenants")
    out = {"phase": "multi_tenant"}
    total = {}

    def on_card(what, fn):
        nonlocal total
        launches.reset()
        t0 = time.perf_counter()
        res = fn("cuda")
        wall = time.perf_counter() - t0
        counts = launches.read(f"multi_tenant/{what}")
        total = add_counts(total, counts)
        t0 = time.perf_counter()
        ref = fn("cpu")
        return res, ref, {"wall_s": wall,
                          "cpu_backend_wall_s": time.perf_counter() - t0,
                          "launches": counts}

    got, ref, rec = on_card("execute", lambda b: f.execute_multi_tenant(
        plan, prob, w_tr, duration=60.0, arrivals="poisson", backend=b))
    rec["max_abs_latency_err_s"] = compare_multi(np, ref, got,
                                                 "multi_tenant/execute")
    out["execute"] = {"plan": {"pm": str(plan.solution.pm),
                               "bss": list(plan.solution.bss),
                               "tau_tr": plan.solution.tau_tr},
                      "requests": [len(r.trace) for r in got.streams],
                      "violation_rates": got.violation_rates(budgets),
                      "p95_latency_s": [r.latency_quantile(0.95)
                                        for r in got.streams],
                      "train_minibatches": got.train_minibatches, **rec}

    closed = CC.ControllerConfig(
        rate_estimator="ewma", rate_margin=1.5, feedback=True,
        carry_backlog=True, burst_quantile=0.95, mode_switch_s=0.5,
        admission="shed")
    for loop, cfg in (("serve_open", None), ("serve_shed", closed)):
        got, ref, rec = on_card(loop, lambda b: Fulcrum(
            rt["DeviceModel"]()).serve_dynamic(
                specs, 45.0, None, MT_RATE_WINDOWS, "gmd",
                window_duration=30.0, arrivals="poisson", seed=0, w_tr=w_tr,
                controller=cfg, backend=b))
        errs = compare_windows(np, ref, got, f"multi_tenant/{loop}")
        out[loop] = {**rec, "max_abs_latency_err_s": max(errs),
                     "windows": window_records(got, errs)}
    if sum(w["shed"] for w in out["serve_shed"]["windows"]) < 1:
        fail("multi_tenant: the closed loop shed no request")

    # one tenant hands K1 the pair path's inputs: the same bits on the card
    pm = rt["PowerModeSpace"]().maxn()
    trace = S.ArrivalTrace.poisson(60.0, 120.0, seed=0)
    launches.reset()
    pair = S.simulate(f.device, w_tr, INFER["mobilenet"], pm, 4, trace,
                      tau_cap=2, backend="cuda")
    one = S.simulate_multi_tenant(f.device, w_tr, [INFER["mobilenet"]], pm,
                                  [4], [trace], tau_cap=2, backend="cuda")
    counts = launches.read("multi_tenant/one_tenant")
    total = add_counts(total, counts)
    rep = one.streams[0]
    if not (np.asarray(rep.latencies).tobytes()
            == np.asarray(pair.latencies).tobytes()
            and rep.sorted_latencies.tobytes()
            == pair.sorted_latencies.tobytes()
            and one.train_minibatches == pair.train_minibatches):
        fail("multi_tenant: one tenant differs from the pair path on cuda")
    out["one_tenant_bitwise"] = {"requests": len(trace), "launches": counts,
                                 "train_minibatches": one.train_minibatches}

    args = lane_scaling_args(rt, MT_LANES)
    # fill the device model's (workload, mode, bs) timing cache first, so
    # that neither timed run pays for it
    S.simulate_multi_tenant_batch(*args, backend="cpu")
    torch.cuda.reset_peak_memory_stats()
    got, ref, rec = on_card("lanes_10k", lambda b:
                            S.simulate_multi_tenant_batch(*args, backend=b))
    peak = torch.cuda.max_memory_allocated()
    worst = max(compare_multi(np, a, b, f"multi_tenant/lanes_10k lane {i}")
                for i, (a, b) in enumerate(zip(ref, got)))
    out["lanes_10k"] = {
        "lanes": MT_LANES, "streams": 2,
        "requests_per_lane": sum(len(t) for t in args[5][0]),
        "engine_chunks": len(S._lane_chunks(MT_LANES)),
        "configs_per_s": MT_LANES / rec["wall_s"],
        "cpu_backend_configs_per_s": MT_LANES / rec["cpu_backend_wall_s"],
        "max_abs_latency_err_s": worst, "max_memory_allocated_bytes": peak,
        **rec, "kernels": lane_scaling_kernels(torch, np, rt, args, got)}
    out["launches"] = total
    emit(out)
    return out


def as_dicts(sols) -> list:
    return [None if s is None else dataclasses.asdict(s) for s in sols]


def mt_problems(rt) -> list:
    """bench_multi_tenant.py's grid around the README's three tenants."""
    P, INFER = rt["P"], rt["INFER"]
    return [P.MultiTenantProblem(float(pb), tuple(
        P.StreamSpec(r * rs, lat * ls, INFER[name])
        for name, r, lat in MT_TENANTS))
        for pb in ORACLE_MT[0] for ls in ORACLE_MT[1] for rs in ORACLE_MT[2]]


def oracle_problems(rt) -> dict:
    """The sweep's problem batches, as benchmarks/common.py builds them."""
    P = rt["P"]
    pows = [float(p) for p in ORACLE_POWERS]
    return {"train": [P.TrainProblem(p) for p in pows],
            "infer": [P.InferProblem(p, float(lat), float(r)) for p in pows
                      for lat in ORACLE_INFER[0] for r in ORACLE_INFER[1]],
            "concurrent": [P.ConcurrentProblem(p, float(lat), float(r))
                           for p in pows for lat in ORACLE_CONCURRENT[0]
                           for r in ORACLE_CONCURRENT[1]],
            "multi_tenant": mt_problems(rt)}


def oracle_scalar_check(rt, oracle, w_tr, w_in, name, probs, sols) -> int:
    """Every ``ORACLE_SCALAR_STRIDE``-th problem (every training problem,
    two multi-tenant ones) against the scalar ``problem.solve_*`` loop over
    the oracle's observation dicts. Returns how many were checked."""
    P = rt["P"]
    tobs = oracle.train_observations(w_tr)
    iobs = oracle.infer_observations(w_in)
    scalar = {"train": lambda pr: P.solve_train(pr, tobs),
              "infer": lambda pr: P.solve_infer(pr, iobs),
              "concurrent": lambda pr: P.solve_concurrent(pr, tobs, iobs),
              "multi_tenant": lambda pr: P.solve_multi_tenant(
                  pr, tobs, [oracle.infer_observations(s.workload)
                             for s in pr.streams])}[name]
    stride = {"train": 1, "multi_tenant": len(probs) // 2}.get(
        name, ORACLE_SCALAR_STRIDE)
    idx = range(0, len(probs), stride)
    for i in idx:
        if as_dicts([sols[i]]) != as_dicts([scalar(probs[i])]):
            fail(f"oracle_sweep: {name} problem {i} differs from the "
                 f"scalar solver")
    return len(idx)


def phase_oracle_sweep(torch, np, rt, launches: Launches) -> dict:
    """bench_solver.py's paper-scale sweep and a multi-tenant batch through
    the oracle's batched solvers on cuda and on cpu: solutions bitwise
    equal, a sample also equal to the scalar loops."""
    B, Oracle = rt["B"], rt["Oracle"]
    oracle = Oracle(rt["DeviceModel"]())
    w_tr, w_in = rt["TRAIN"]["resnet18"], rt["INFER"]["mobilenet"]
    probs = oracle_problems(rt)
    solve = {
        "train": lambda ps, b: oracle.solve_train_batch(w_tr, ps, b),
        "infer": lambda ps, b: oracle.solve_infer_batch(w_in, ps, b),
        "concurrent": lambda ps, b: oracle.solve_concurrent_batch(
            w_tr, w_in, ps, b),
        "multi_tenant": lambda ps, b: oracle.solve_multi_tenant_batch(
            w_tr, ps, b)}
    # materialize the grids and upload their columns before any timing
    for name, fn in solve.items():
        for b in ("cuda", "cpu"):
            fn(probs[name][:8], b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    variants, n_all, cuda_s, cpu_s = {}, 0, 0.0, 0.0
    for name, fn in solve.items():
        ps = probs[name]
        d0 = B.dispatch_count("solver")
        t0 = time.perf_counter()
        got = fn(ps, "cuda")
        wall = time.perf_counter() - t0
        chunks = B.dispatch_count("solver") - d0
        t0 = time.perf_counter()
        ref = fn(ps, "cpu")
        cpu_wall = time.perf_counter() - t0
        if as_dicts(got) != as_dicts(ref):
            fail(f"oracle_sweep: {name} solutions differ between cuda and "
                 f"cpu")
        checked = oracle_scalar_check(rt, oracle, w_tr, w_in, name, ps, got)
        n_all, cuda_s, cpu_s = n_all + len(ps), cuda_s + wall, \
            cpu_s + cpu_wall
        variants[name] = {
            "problems": len(ps), "solved": sum(s is not None for s in got),
            "cuda_s": wall, "cpu_s": cpu_wall,
            "cuda_configs_per_s": len(ps) / wall,
            "cpu_configs_per_s": len(ps) / cpu_wall,
            "solver_launches": chunks, "scalar_checked": checked}
    counts = launches.read("oracle_sweep", path=())
    peak = torch.cuda.max_memory_allocated()
    profile = profile_device(torch, lambda: [fn(probs[name], "cuda")
                                             for name, fn in solve.items()])
    out = {"phase": "oracle_sweep", "train_workload": w_tr.name,
           "infer_workload": w_in.name,
           "observations": {"train_modes": len(oracle.train_grid(w_tr)),
                            "infer_entries": len(oracle.infer_grid(w_in))},
           "variants": variants, "problems": n_all,
           "cuda_configs_per_s": n_all / cuda_s,
           "cpu_configs_per_s": n_all / cpu_s,
           "solutions_bitwise_cuda_vs_cpu": True,
           "max_memory_allocated_bytes": peak, "launches": counts,
           "profile": {k: profile[k] for k in (
               "wall_s", "device_busy_s", "idle_share", "device_ops",
               "top", "cost_s")}}
    emit(out)
    return out


def strategy_problems(rt) -> dict:
    """benchmarks/common.py's strided grids (full=False) and the
    multi-tenant grid."""
    P = rt["P"]
    return {"train": [P.TrainProblem(float(b)) for b in range(10, 51, 2)],
            "infer": [P.InferProblem(float(p), lat, float(r))
                      for p in range(10, 51, 5)
                      for lat in (0.05, 0.1, 0.2, 0.4, 0.7, 1.0)
                      for r in range(30, 91, 20)],
            "concurrent": [P.ConcurrentProblem(float(p), lat, float(r))
                           for p in range(10, 51, 5)
                           for lat in (0.5, 1.0, 1.5, 2.0)
                           for r in range(30, 121, 30)],
            "multi_tenant": mt_problems(rt)}


def strategy_profiles(rt, strat) -> tuple:
    """Every profile a strategy took, profiler by profiler, in order, and
    the strategy's runs and profiling cost."""
    top, profs = rt["strategy_profilers"](strat)
    return ([(j, str(pm), bs) for j, prof in enumerate(profs)
             for (pm, bs) in prof.cache], (top.num_runs, top.profile_cost_s))


def judge(rt, oracle, scenario: str, ws, pairs, sols) -> dict:
    """Each answer against the ground truth, as benchmarks/bench_train.py,
    bench_infer.py and bench_concurrent.py count it (the multi-tenant
    answers like the concurrent ones): solved, violations and the median
    excess time (train) or latency (infer) or training-throughput loss
    (concurrent, multi-tenant) over the oracle's optimum, in percent."""
    P = rt["P"]
    solved, viols, gaps = 0, 0, []
    for (prob, opt), sol in zip(pairs, sols):
        if sol is None:
            continue
        if scenario == "train":
            t, p = oracle.true_train(ws[0], sol.pm)
            viols += p > prob.power_budget + 1e-9
            solved += 1                  # bench_train counts it solved
            gaps.append(100.0 * (t - opt.time) / max(opt.time, 1e-12))
            continue
        if scenario == "infer":
            t, p = oracle.true_infer(ws[0], sol.pm, sol.bs)
            bad = (p > prob.power_budget + 1e-9
                   or P.peak_latency(sol.bs, prob.arrival_rate, t)
                   > prob.latency_budget + 1e-9
                   or not P.sustainable(sol.bs, prob.arrival_rate, t))
            gap = P.peak_latency(sol.bs, prob.arrival_rate, t) - opt.time
            scale = opt.time
        elif scenario == "concurrent":
            t_in, p_in = oracle.true_infer(ws[1], sol.pm, sol.bs)
            t_tr, p_tr = oracle.true_train(ws[0], sol.pm)
            bad = (max(p_in, p_tr) > prob.power_budget + 1e-9
                   or P.peak_latency(sol.bs, prob.arrival_rate, t_in)
                   > prob.latency_budget + 1e-9
                   or not P.sustainable(sol.bs, prob.arrival_rate, t_in))
            gap = opt.throughput - P.train_throughput(
                sol.bs, prob.arrival_rate, t_in, t_tr)
            scale = opt.throughput
        else:
            rates = [s.arrival_rate for s in prob.streams]
            truth = [oracle.true_infer(s.workload, sol.pm, bs)
                     for s, bs in zip(prob.streams, sol.bss)]
            t_ins = [t for t, _ in truth]
            t_tr, p_tr = oracle.true_train(ws[0], sol.pm)
            bad = (max([p for _, p in truth] + [p_tr])
                   > prob.power_budget + 1e-9
                   or not P.multi_sustainable(sol.bss, rates, t_ins)
                   or any(P.multi_peak_latency(sol.bss, rates, t_ins, j)
                          > s.latency_budget + 1e-9
                          for j, s in enumerate(prob.streams)))
            gap = opt.throughput - P.multi_interleave_tau(
                sol.bss, rates, t_ins, t_tr) / P.multi_cycle(sol.bss, rates)
            scale = opt.throughput
        if bad:
            viols += 1
            continue
        solved += 1
        gaps.append(100.0 * gap / max(scale, 1e-12))
    return {"solved": solved, "violations": viols,
            "median_gap_pct": statistics.median(gaps) if gaps else None}


def strategy_run(rt, oracle, scenario: str, ws, pairs, name: str,
                 quadrants, backend: str) -> tuple:
    """One fitted strategy through the Fulcrum facade on one backend:
    ``strategy_for`` + ``solve_batch`` (train, infer, as the benchmarks),
    ``solve_concurrent`` / ``solve_multi_tenant`` per problem."""
    Q = rt["QuadrantRanges"]
    f = rt["Fulcrum"](rt["DeviceModel"](), nn_epochs=NN_EPOCHS,
                      backend=backend,
                      quadrants=None if quadrants is None
                      else Q(latency=quadrants[0], arrival=quadrants[1]))
    probs = [prob for prob, _ in pairs]
    t0 = time.perf_counter()
    if scenario in ("train", "infer"):
        strat = f.strategy_for(scenario, name, *ws)
        sols = strat.solve_batch(probs)
    elif scenario == "concurrent":
        plans = [f.solve_concurrent(ws[0], ws[1], prob, name)
                 for prob in probs]
        sols = [pl and pl.solution for pl in plans]
        strat = f.strategy_for(scenario, name, *ws)
    else:
        plans = [f.solve_multi_tenant(ws[0], prob, name) for prob in probs]
        sols = [pl and pl.solution for pl in plans]
        strat = f.strategy_for(scenario, name, ws[0],
                               *[s.workload for s in probs[0].streams])
    wall = time.perf_counter() - t0
    keys, (runs, cost) = strategy_profiles(rt, strat)
    rec = {**judge(rt, oracle, scenario, ws, pairs, sols), "modes": runs,
           "profile_cost_s": cost, "wall_s": wall}
    return rec, keys, sols


def strategy_step(rt, oracle, scenario: str, ws, names, quadrants,
                  probs) -> dict:
    """Every strategy of one scenario on cuda and on cpu. Fails when an ALS
    or RND answer violates its budget by the ground truth (they answer from
    observed profiles only), or when RND's profiles, cost or solutions
    differ between the backends (its draws are Python's ``random``). ALS
    and NN-k pick from float32 predictions that part between two correct
    runs at these epochs: where their profiles differ, the record says by
    how many modes and gives both answers' quality."""
    if scenario == "train":
        opts = oracle.solve_train_batch(ws[0], probs, "cuda")
    elif scenario == "infer":
        opts = oracle.solve_infer_batch(ws[0], probs, "cuda")
    elif scenario == "concurrent":
        opts = oracle.solve_concurrent_batch(ws[0], ws[1], probs, "cuda")
    else:
        opts = oracle.solve_multi_tenant_batch(ws[0], probs, "cuda")
    pairs = [(prob, opt) for prob, opt in zip(probs, opts)
             if opt is not None and (scenario in ("train", "infer")
                                     or opt.throughput > 0)]
    out = {"workloads": [w.name for w in ws], "problems": len(probs),
           "solvable": len(pairs), "strategies": {}}
    for name in names:
        got, keys, sols = strategy_run(rt, oracle, scenario, ws, pairs, name,
                                       quadrants, "cuda")
        ref, ref_keys, ref_sols = strategy_run(rt, oracle, scenario, ws,
                                               pairs, name, quadrants, "cpu")
        for b, rec in (("cuda", got), ("cpu", ref)):
            if name.startswith(("als", "rnd")) and rec["violations"]:
                fail(f"strategies: {scenario} {name} on {b} violated "
                     f"{rec['violations']} budgets by the ground truth")
        same = keys == ref_keys
        if name.startswith("rnd") and not (
                same and (got["modes"], got["profile_cost_s"])
                == (ref["modes"], ref["profile_cost_s"])
                and as_dicts(sols) == as_dicts(ref_sols)):
            fail(f"strategies: {scenario} {name} differs between cuda and "
                 f"cpu")
        out["strategies"][name] = {
            "cuda": got, "cpu": ref, "same_profiles": same,
            "modes_differ": len(set(keys) ^ set(ref_keys)),
            "solutions_equal": as_dicts(sols) == as_dicts(ref_sols)}
    return out


def nn_case(rt, width: int) -> tuple:
    """50 random profiles (width 4: resnet18 training, 5: mobilenet
    inference: the (mode, bs) pairs), their times and powers, and every key
    to predict; tests/test_torch_cuda.py and test_torch_strategies.py
    build their predictor data with it."""
    NN = rt["NN"]
    rng = random.Random(width)
    modes = rt["PowerModeSpace"]().all_modes()
    if width == 4:
        keys, w = [(pm, None) for pm in modes], rt["TRAIN"]["resnet18"]
    else:
        keys = [(pm, bs) for pm in modes for bs in rt["P"].INFER_BATCH_SIZES]
        w = rt["INFER"]["mobilenet"]
    dev = rt["DeviceModel"]()
    seen = rng.sample(keys, 50)
    tp = [dev.time_power(w, pm, bs) for pm, bs in seen]
    feats = [NN.mode_features(pm, bs) for pm, bs in seen]
    every = [NN.mode_features(pm, bs) for pm, bs in keys]
    return (feats, [t for t, _ in tp], [p for _, p in tp], every)


def drift_case(rt) -> tuple:
    """ALSConcurrent's and ALSMultiTenant's first fit (mobilenet's
    inference time on their 25 initial profiles, NN seed 0). One gradient
    entry of its first step cancels to 1.8e-8, near Adam's eps, so float32
    fits that round it differently part within 100 epochs (ROADMAP queue
    3, F1); tests/test_torch_strategies.py builds the case with it."""
    NN = rt["NN"]
    rng = random.Random(0)
    modes = rt["PowerModeSpace"]().all_modes()
    dev, w = rt["DeviceModel"](), rt["INFER"]["mobilenet"]
    seen = [(pm, rng.choice(rt["P"].INFER_BATCH_SIZES))
            for pm in rng.sample(modes, 25)]
    feats = [NN.mode_features(pm, bs) for pm, bs in seen]
    times = [dev.time_power(w, pm, bs)[0] for pm, bs in seen]
    every = [NN.mode_features(pm, bs) for pm in modes
             for bs in rt["P"].INFER_BATCH_SIZES]
    return feats, times, every


def predictor_step(torch, np, rt) -> dict:
    """The NN predictor on cuda against cpu from the same initial weights
    (drawn on the host): within NN_TOL of the largest |prediction| after
    NN_CHECK_EPOCHS, both feature widths and targets; wall ms per fit and
    per epoch at NN_EPOCHS on each backend; device launches per epoch under
    the profiler; the drift case's share cuda against cpu and each
    backend's float32 fit against the host's float64 fit (``NN.DTYPE``
    widened for that fit alone) at NN_DRIFT_EPOCHS (not judged)."""
    NN = rt["NN"]

    def fit(x, y, epochs, backend):
        m = NN.NNPredictor.fit(x, y, epochs=epochs, backend=backend)
        if backend == "cuda":
            torch.cuda.synchronize()
        return m

    def share(x, y, every, epochs):
        a = fit(x, y, epochs, "cpu").predict(every)
        b = fit(x, y, epochs, "cuda").predict(every)
        return float(np.abs(b - a).max() / np.abs(a).max())

    checks = {}
    for width in (4, 5):
        feats, times, powers, every = nn_case(rt, width)
        for target, y in (("time", times), ("power", powers)):
            for epochs in NN_CHECK_EPOCHS:
                s = share(feats, y, every, epochs)
                if not s <= NN_TOL:
                    fail(f"strategies: NN predictions (width {width}, "
                         f"{target}, {epochs} epochs) differ between cuda "
                         f"and cpu by {s:.3g} of the largest")
                checks[f"w{width}_{target}_{epochs}"] = s
    feats, times, _, _ = nn_case(rt, 5)
    timed = {}
    for backend in ("cuda", "cpu"):
        fit(feats, times, 5, backend)            # warm
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fit(feats, times, NN_EPOCHS, backend)
            walls.append(1e3 * (time.perf_counter() - t0))
        walls.sort()
        timed[backend] = {"fit_ms": walls, "ms_per_epoch":
                          walls[1] / NN_EPOCHS}
    prof = profile_device(torch, lambda: fit(feats, times,
                                             NN_PROFILE_EPOCHS, "cuda"))
    timed["cuda"]["launches_per_epoch"] = prof["device_ops"] \
        / NN_PROFILE_EPOCHS
    timed["cuda"]["idle_share"] = prof["idle_share"]
    x, y, every = drift_case(rt)
    drift = {str(e): share(x, y, every, e) for e in NN_DRIFT_EPOCHS}
    from_f64 = {}
    for e in NN_DRIFT_EPOCHS:
        NN.DTYPE = np.float64
        try:
            exact = fit(x, y, e, "cpu").predict(every)
        finally:
            NN.DTYPE = np.float32
        from_f64[str(e)] = {
            b: float(np.abs(fit(x, y, e, b).predict(every) - exact).max()
                     / np.abs(exact).max()) for b in ("cuda", "cpu")}
    return {"max_share_of_largest": checks, "tolerance": NN_TOL,
            "timed": timed, "drift_case": drift,
            "drift_case_from_float64": from_f64}


def phase_strategies(torch, np, rt, launches: Launches) -> dict:
    """The fitted strategies on the card: train, infer, concurrent and
    multi-tenant steps against the oracle (``strategy_step``), the closed
    loop answered by ALS through K1 and K2, and the NN predictor."""
    TRAIN, INFER, Oracle = rt["TRAIN"], rt["INFER"], rt["Oracle"]
    oracle = Oracle(rt["DeviceModel"]())
    probs = strategy_problems(rt)
    out = {"phase": "strategies", "nn_epochs": NN_EPOCHS}
    name, names = STRAT_TRAIN
    out["train"] = strategy_step(rt, oracle, "train", (TRAIN[name],), names,
                                 None, probs["train"])
    name, quads, names = STRAT_INFER
    out["infer"] = strategy_step(rt, oracle, "infer", (INFER[name],), names,
                                 quads, probs["infer"])
    (tr, inf), quads, names = STRAT_CONCURRENT
    out["concurrent"] = strategy_step(rt, oracle, "concurrent",
                                      (TRAIN[tr], INFER[inf]), names, quads,
                                      probs["concurrent"])
    name, names = STRAT_MT
    out["multi_tenant"] = strategy_step(rt, oracle, "multi_tenant",
                                        (TRAIN[name],), names, None,
                                        probs["multi_tenant"])

    # the closed loop answered by one fitted ALS model, through K1 and K2
    name, power, budget, rates, window = STRAT_SERVE
    w = INFER[name]
    cfg = rt["CC"].ControllerConfig(**CLOSED_LOOP_CASES["readme"][2])
    runs = {}
    for backend in ("cuda", "cpu"):
        f = rt["Fulcrum"](rt["DeviceModel"](), nn_epochs=NN_EPOCHS,
                          backend=backend)
        if backend == "cuda":
            launches.reset()
        t0 = time.perf_counter()
        wins = f.serve_dynamic(w, power, budget, list(rates),
                               strategy="als145", window_duration=window,
                               controller=cfg)     # on the Fulcrum's backend
        wall = time.perf_counter() - t0
        if backend == "cuda":
            counts = launches.read("strategies")
        strat = f.strategy_for("dynamic", "als145", w)
        runs[backend] = (wins, wall, *strategy_profiles(rt, strat))
    (got, wall, keys, cost), (ref, cpu_wall, ref_keys, ref_cost) = \
        runs["cuda"], runs["cpu"]
    same = keys == ref_keys
    same_plans = [a.solution == b.solution for a, b in zip(ref, got)]
    # with the same profiles, or where ALS's picks differ but every window
    # commits the same plan, the windows must agree; otherwise the record
    # compares the plans
    errs = compare_windows(np, ref, got, "strategies serving") \
        if same or all(same_plans) else [None] * len(got)
    out["serving"] = {
        "workload": w.name, "power_w": power, "latency_budget_s": budget,
        "same_profiles": same, "modes_differ": len(set(keys) ^ set(ref_keys)),
        "same_plans": same_plans, "modes": [cost[0], ref_cost[0]],
        "wall_s": wall, "cpu_wall_s": cpu_wall,
        "windows": window_records(got, errs),
        "cpu_plans": [None if v.solution is None else
                      {"pm": str(v.solution.pm), "bs": v.solution.bs}
                      for v in ref]}
    out["predictor"] = predictor_step(torch, np, rt)
    out["launches"] = counts
    emit(out)
    return out


def compare_fleets(np, ref, got, what: str) -> float:
    """Two fleet runs of the same inputs: per window the same dispatch,
    shed / deferred / migrated / offered counts and water-filled grants;
    per device the same plan (pm, bs, tau_tr, power), replanning, counts,
    estimated rate and mode-switch charge; a plan's latency, the
    latencies and the queue clocks within ENG_TOL, goodput within one
    offered request. Returns the max |Δlatency|."""
    if len(ref) != len(got):
        fail(f"{what}: {len(got)} windows against {len(ref)}")
    tol = lambda a, b: abs(a - b) <= ENG_TOL["atol"] + ENG_TOL["rtol"] * abs(a)
    worst = 0.0
    for i, (a, b) in enumerate(zip(ref, got)):
        w = f"{what} window {i}"
        if (a.dispatch_counts.tolist(), a.offered_requests, a.shed_requests,
                a.deferred_requests, a.migrated_requests) != \
                (b.dispatch_counts.tolist(), b.offered_requests,
                 b.shed_requests, b.deferred_requests, b.migrated_requests):
            fail(f"{w}: dispatch or shed / deferred / migrated counts differ")
        if (None if a.power_budgets is None else a.power_budgets.tolist()) \
                != (None if b.power_budgets is None
                    else b.power_budgets.tolist()):
            fail(f"{w}: water-filled power budgets differ")
        if abs(a.goodput - b.goodput) * max(1, a.offered_requests) > 1:
            fail(f"{w}: goodput differs by more than one request")
        for d, (da, db) in enumerate(zip(a.devices, b.devices)):
            keys = ("replanned", "carried_requests", "offered_requests",
                    "shed_requests", "deferred_requests", "estimated_rate",
                    "mode_switch_s")
            if [getattr(da, k) for k in keys] != [getattr(db, k)
                                                   for k in keys]:
                fail(f"{w} device {d}: counts or estimates differ")
            if (da.solution is None) != (db.solution is None) \
                    or (da.report is None) != (db.report is None):
                fail(f"{w} device {d}: served on one run only")
            if da.solution is None:
                continue
            pa, pb = dataclasses.asdict(da.solution), \
                dataclasses.asdict(db.solution)
            ta, tb = pa.pop("time"), pb.pop("time")
            if pa != pb or not tol(ta, tb):
                fail(f"{w} device {d}: plans differ ({pa} vs {pb})")
            worst = max(worst, compare_multi(np, da.report, db.report,
                                             f"{w} device {d}"))
            qa, qb = da.report.queue_state, db.report.queue_state
            if qa.pending.tolist() != qb.pending.tolist() \
                    or not tol(qa.clock, qb.clock):
                fail(f"{w} device {d}: queue states differ")
    return worst


def fleet_run(rt, fn, K: int, rates, spec_kw: dict, cfg_kw: dict,
              backend: str, seed: int, fused: bool = False) -> tuple:
    """One fleet serving run (``fn`` is serve_fleet or
    serve_fleet_sequential; ``fused`` asks serve_fleet for the fused
    window) and its wall seconds."""
    F, CC = rt["F"], rt["CC"]
    name, power, budget, window = FLEET
    t0 = time.perf_counter()
    wins = fn(rt["INFER"][name], power, budget, list(rates),
              F.FleetSpec(K, **spec_kw), window_duration=window,
              arrivals="poisson", seed=seed, backend=backend,
              controller=CC.ControllerConfig(**cfg_kw),
              **({"fused": True} if fused else {}))
    return wins, time.perf_counter() - t0


def fleet_record(np, wins, K: int, wall: float) -> dict:
    """What a fleet run served: device-windows per second, goodput, shed /
    deferred / migrated counts and latency quantiles over served requests."""
    budget = FLEET[2]
    lats = [np.asarray(d.report.latencies, np.float64)
            for w in wins for d in w.devices if d.report is not None]
    lat = np.concatenate(lats) if lats else np.empty(0)
    offered = sum(w.offered_requests for w in wins)
    return {"devices": K, "windows": len(wins), "wall_s": wall,
            "configs_per_s": K * len(wins) / wall,
            "offered": offered, "served": int(lat.size),
            "goodput": int(np.count_nonzero(lat <= budget)) / max(offered, 1),
            "shed": sum(w.shed_requests for w in wins),
            "deferred": sum(w.deferred_requests for w in wins),
            "migrated": sum(w.migrated_requests for w in wins),
            "solved_device_windows": sum(d.solution is not None
                                         for w in wins for d in w.devices),
            "p50_latency_s": float(np.quantile(lat, 0.5)) if lat.size
            else None,
            "p99_latency_s": float(np.quantile(lat, 0.99)) if lat.size
            else None,
            "goodput_by_window": [w.goodput for w in wins]}


def phase_fleet(torch, np, rt, launches: Launches) -> dict:
    """The K-device fleet: the README's two examples, bench_fleet.py's
    scaling rows at K = 8, 64, 512 (batched against the sequential loops)
    and its admission matrix at K = 64, each batched run on cuda against
    cpu; one K1 and one K2 launch per window that serves."""
    F, K2 = rt["F"], rt["K2"]
    out, total = {"phase": "fleet"}, {}
    unfused = {}                  # row -> (its unfused cuda run, wall s)
    # the device model's timing caches and the grid warm up first
    fleet_run(rt, F.serve_fleet, 2, [60.0], {}, FLEET_CL, "cuda", 0)
    fleet_run(rt, F.serve_fleet, 2, [60.0], {}, FLEET_CL, "cuda", 0,
              fused=True)
    fleet_run(rt, F.serve_fleet_sequential, 2, [60.0], {}, FLEET_CL, "cuda",
              0)

    def sorts(got):
        """One sort chunk per window that has a latency to sort (K <= 8,192
        lanes, far below the sort chunk's elements)."""
        return sum(any(d.report is not None and len(d.report.latencies)
                       for d in w.devices) for w in got)

    def on_card(what, K, rates, spec_kw, cfg_kw, seed):
        nonlocal total
        routes = dict(K2.lane_sort.routes)
        launches.reset()
        got, wall = fleet_run(rt, F.serve_fleet, K, rates, spec_kw, cfg_kw,
                              "cuda", seed)
        counts = launches.read(f"fleet/{what}")
        routes = {r: n - routes[r] for r, n in K2.lane_sort.routes.items()}
        # one engine chunk per window that runs a lane, one sort chunk per
        # window that has a latency to sort (K <= 8,192 lanes, and far
        # below the sort chunk's elements)
        want = {"maxplus_scan": sum(
            any(d.report is not None for d in w.devices) for w in got),
            "lane_sort": sorts(got), "fused_window": 0}
        for k, n in want.items():
            if counts[k] != n:
                fail(f"fleet/{what}: {k} launched {counts[k]} times, not "
                     f"once for each of {n} windows")
        total = add_counts(total, counts)
        ref, cpu_wall = fleet_run(rt, F.serve_fleet, K, rates, spec_kw,
                                  cfg_kw, "cpu", seed)
        err = compare_fleets(np, ref, got, f"fleet/{what} cuda vs cpu")
        rec = fleet_record(np, got, K, wall)
        rec.update(cpu_backend_wall_s=cpu_wall, launches=counts,
                   lane_sort_routes=routes, max_abs_latency_err_s=err)
        unfused[what] = (got, wall)
        return got, rec

    def fused_on_card(what, K, rates, spec_kw, cfg_kw, seed):
        """The same row through the fused window on the card (one launch a
        window, no K1), against the row's unfused cuda run and against the
        fused window on cpu."""
        nonlocal total
        launches.reset()
        got, wall = fleet_run(rt, F.serve_fleet, K, rates, spec_kw, cfg_kw,
                              "cuda", seed, fused=True)
        counts = launches.read(f"fleet/fused_{what}", FUSED_KERNELS)
        want = {"fused_window": len(got), "maxplus_scan": 0,
                "lane_sort": sorts(got)}
        for k, n in want.items():
            if counts[k] != n:
                fail(f"fleet/fused_{what}: {k} launched {counts[k]} times, "
                     f"not {n} ({len(got)} windows)")
        if not all(any(d.report is not None for d in w.devices) for w in got):
            fail(f"fleet/fused_{what}: a window served no device")
        total = add_counts(total, counts)
        ref, unf_wall = unfused[what]
        err = compare_fleets(np, ref, got,
                             f"fleet/fused_{what} vs the unfused cuda run")
        cpu, cpu_wall = fleet_run(rt, F.serve_fleet, K, rates, spec_kw,
                                  cfg_kw, "cpu", seed, fused=True)
        cpu_err = compare_fleets(np, cpu, got,
                                 f"fleet/fused_{what} cuda vs cpu")
        rec = fleet_record(np, got, K, wall)
        rec.update(unfused_wall_s=unf_wall,
                   unfused_configs_per_s=K * len(got) / unf_wall,
                   speedup_over_unfused=unf_wall / wall,
                   cpu_backend_wall_s=cpu_wall, launches=counts,
                   launches_per_window={k: n / len(got)
                                        for k, n in counts.items() if n},
                   max_abs_latency_err_vs_unfused_s=err,
                   max_abs_latency_err_vs_cpu_s=cpu_err)
        return rec

    for case, (rates, spec_kw, cfg_kw) in FLEET_README.items():
        got, rec = on_card(case, 8, rates, spec_kw, cfg_kw, 0)
        rec["windows_detail"] = [
            {"rate": w.rate, "dispatch_counts": w.dispatch_counts.tolist(),
             "goodput": w.goodput, "shed": w.shed_requests,
             "migrated": w.migrated_requests,
             "attributed_power_w": w.attributed_power,
             "power_budgets_w": None if w.power_budgets is None
             else w.power_budgets.tolist()} for w in got]
        out[case] = rec
    scaling = {}
    for K in FLEET_KS:
        spec_kw = dict(seed=3, dispatch="least-backlog")
        cfg_kw = dict(FLEET_CL, mode_switch_s=0.25)
        rates = [30.0 * m * K for m in FLEET_RATES]
        got, rec = on_card(f"k{K}", K, rates, spec_kw, cfg_kw, 11)
        if K in FLEET_SEQ_KS:
            k1 = rt["K1"].maxplus_scan.launches
            seq, seq_wall = fleet_run(rt, F.serve_fleet_sequential, K, rates,
                                      spec_kw, cfg_kw, "cuda", 11)
            rec.update(
                sequential_wall_s=seq_wall,
                sequential_configs_per_s=K * len(rates) / seq_wall,
                speedup=seq_wall / rec["wall_s"],
                sequential_k1_launches=rt["K1"].maxplus_scan.launches - k1,
                max_abs_latency_err_vs_sequential_s=compare_fleets(
                    np, seq, got, f"fleet/k{K} batched vs sequential"))
        scaling[f"k{K}"] = rec
    out["scaling"] = scaling
    matrix = {}
    K = FLEET_ADM_K
    for mode, extra in FLEET_ADM_MODES.items():
        spec_kw = dict(seed=3, dispatch="least-backlog", migrate_backlog=True,
                       fleet_power_budget=27.0 * K)
        cfg_kw = dict(FLEET_CL, mode_switch_s=0.25, burst_quantile=0.95,
                      admission=mode, **extra)
        _, rec = on_card(f"admission_{mode}", K,
                         [30.0 * m * K for m in FLEET_ADM_RATES], spec_kw,
                         cfg_kw, 11)
        matrix[mode] = rec
    if sum(matrix["shed"][k] for k in ("shed", "migrated")) < 1:
        fail("fleet: the admission matrix shed and migrated nothing")
    out["admission"] = matrix
    fused = {}
    for case, (rates, spec_kw, cfg_kw) in FLEET_README.items():
        fused[case] = fused_on_card(case, 8, rates, spec_kw, cfg_kw, 0)
    for K in FLEET_FUSED_KS:
        fused[f"k{K}"] = fused_on_card(
            f"k{K}", K, [30.0 * m * K for m in FLEET_RATES],
            dict(seed=3, dispatch="least-backlog"),
            dict(FLEET_CL, mode_switch_s=0.25), 11)
    K = FLEET_ADM_K
    for mode in FLEET_FUSED_ADM:
        fused[f"admission_{mode}"] = fused_on_card(
            f"admission_{mode}", K, [30.0 * m * K for m in FLEET_ADM_RATES],
            dict(seed=3, dispatch="least-backlog", migrate_backlog=True,
                 fleet_power_budget=27.0 * K),
            dict(FLEET_CL, mode_switch_s=0.25, burst_quantile=0.95,
                 admission=mode, **FLEET_ADM_MODES[mode]), 11)
    if fused["admission_shed"]["shed"] < 1:
        fail("fleet: the fused shed row shed nothing")
    try:
        fleet_run(rt, F.serve_fleet, 8, [220.0], {},
                  dict(FLEET_CL, admission="degrade-bs"), "cuda", 0,
                  fused=True)
        fail("fleet: the fused window served degrade-bs instead of refusing")
    except ValueError as e:
        if "degrade-bs" not in str(e):
            fail(f"fleet: the fused degrade-bs refusal says {e}")
    fused["degrade_bs_refused"] = True
    fprof = profile_device(torch, lambda: fleet_run(
        rt, F.serve_fleet, 64, [30.0 * m * 64 for m in FLEET_RATES],
        dict(seed=3, dispatch="least-backlog"),
        dict(FLEET_CL, mode_switch_s=0.25), "cuda", 11, fused=True))
    fused["profile_k64"] = {k: fprof[k] for k in (
        "wall_s", "device_busy_s", "idle_share", "device_ops", "copies",
        "kf_device_ms", "kf_kernels", "k1_kernels", "k2_device_ms",
        "k2_kernels", "top", "cost_s")}
    fused["profile_k64"]["copies_per_window"] = \
        fprof["copies"] / len(FLEET_RATES)
    out["fused"] = fused
    profile = profile_device(torch, lambda: fleet_run(
        rt, F.serve_fleet, 64, [30.0 * m * 64 for m in FLEET_RATES],
        dict(seed=3, dispatch="least-backlog"),
        dict(FLEET_CL, mode_switch_s=0.25), "cuda", 11))
    out["profile_k64"] = {k: profile[k] for k in (
        "wall_s", "device_busy_s", "idle_share", "device_ops", "copies",
        "k1_device_ms", "k1_kernels", "k2_device_ms", "k2_kernels", "top",
        "cost_s")}
    out["profile_k64"]["copies_per_window"] = \
        profile["copies"] / len(FLEET_RATES)
    out["launches"] = total
    emit(out)
    return out


def sweep_kernels(torch, np, rt, lanes, reports) -> dict:
    """The sweep's own work, re-made stage by stage from its inputs: the
    host's per-lane event prep and padding of the engine's first chunk, the
    copies to and from the card, the engine kernel, and every report-builder
    sort chunk (host padding and kernel). Each kernel is checked against its
    plain version on the card and timed."""
    S, K1, K2 = rt["S"], rt["K1"], rt["K2"]
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    tps, ttr, lane_times, readies, execs = S._lane_events(*lanes)
    events_s = time.perf_counter() - t0
    k_pad = S._pow2(max(r.size for r in readies))
    s, e, lanes_pad = S._lane_chunks(len(readies))[0]
    t0 = time.perf_counter()
    host = S._chunk_inputs(readies, execs, np.array([t for t, _ in ttr]),
                           np.full(len(readies), np.inf),
                           np.array([c for _, c in lane_times]), s, e,
                           lanes_pad, k_pad)
    pad_s = time.perf_counter() - t0
    h2d_ms = cuda_ms(torch, lambda: [torch.from_numpy(x).to(dev)
                                     for x in host], 3)
    args = [torch.from_numpy(x).to(dev) for x in host]
    valid = torch.isfinite(args[0])
    k1 = time_maxplus(torch, K1, args, valid, reps=5)
    d2h_ms = cuda_ms(torch, lambda: args[0].cpu(), 3)
    del args, valid
    lats = [np.asarray(r.latencies, np.float64) for r in reports]
    sorts, sort_pad_s = [], 0.0
    for i, j in S._sort_chunks([a.size for a in lats]):
        t0 = time.perf_counter()
        rows = S._pad_rows(lats[i:j])
        sort_pad_s += time.perf_counter() - t0
        mat = torch.from_numpy(rows).to(dev)
        budgets = torch.full((j - i,), 0.1, dtype=torch.float64, device=dev)
        sorts.append(time_sort(torch, K2, mat, budgets, reps=5))
    torch.cuda.empty_cache()
    return {"host_lane_events_s": events_s, "host_pad_chunk_s": pad_s,
            "h2d_chunk_ms": h2d_ms, "maxplus_scan": k1, "d2h_c_ms": d2h_ms,
            "host_pad_sort_rows_s": sort_pad_s, "lane_sort_chunks": sorts}


def run_sweep(torch, np, rt, launches: Launches, name: str, pms, bss,
              trace) -> tuple[dict, list, tuple]:
    S = rt["S"]
    dev_model = rt["DeviceModel"]()
    w_tr, w_in = rt["TRAIN"]["mobilenet"], rt["INFER"]["mobilenet"]
    traces = [trace] * len(pms)
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    t0 = time.perf_counter()
    got = S.simulate_batch(dev_model, w_tr, w_in, pms, bss, traces,
                           backend="cuda")
    wall = time.perf_counter() - t0
    counts = launches.read(name)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    ref = S.simulate_batch(dev_model, w_tr, w_in, pms, bss, traces,
                           backend="cpu")
    cpu_wall = time.perf_counter() - t0
    err = compare_reports(np, ref, got, name)
    rec = {"lanes": len(pms), "requests_per_lane": len(trace),
           "wall_s": wall, "configs_per_s": len(pms) / wall,
           "cpu_backend_wall_s": cpu_wall, "launches": counts,
           "max_memory_allocated_bytes": peak,
           "max_abs_latency_err_s": err,
           "trained_total": int(sum(r.train_minibatches for r in got))}
    lanes = (dev_model, w_tr, w_in, pms, bss, traces, [None] * len(pms))
    return rec, got, lanes


def phase_sweep(torch, np, rt, launches: Launches) -> dict:
    S = rt["S"]
    modes = rt["PowerModeSpace"]().all_modes()
    configs = [(pm, bs) for pm in modes for bs in rt["P"].INFER_BATCH_SIZES]
    pms = [pm for pm, _ in configs]
    bss = [bs for _, bs in configs]
    full, reports, lanes = run_sweep(
        torch, np, rt, launches, "sweep", pms, bss,
        S.ArrivalTrace.poisson(*SWEEP_TRACE))
    full["kernels"] = sweep_kernels(torch, np, rt, lanes, reports)
    del reports, lanes
    n = BIG_LANES
    big, _, _ = run_sweep(
        torch, np, rt, launches, "sweep_100k",
        [pms[i % len(pms)] for i in range(n)],
        [bss[i % len(bss)] for i in range(n)],
        S.ArrivalTrace.poisson(*BIG_TRACE))
    big["engine_chunks"] = len(S._lane_chunks(n))
    out = {"phase": "sweep", "full_space": full, "lanes_100k": big}
    emit(out)
    return out


def model_sites(cfg) -> tuple[int, int]:
    """(attention applications, Mamba2 layers) of one forward: every layer
    of a dense-block stack attends; a hybrid stack attends at its shared
    block's sites."""
    if cfg.arch_type == "hybrid":
        return cfg.n_attn_sites, cfg.num_layers
    if cfg.arch_type == "ssm":
        return 0, cfg.num_layers
    return cfg.num_layers, 0


def model_kernels(cfg) -> tuple:
    """The forward kernels a model of ``cfg`` launches."""
    attn, ssd = model_sites(cfg)
    return (("flash_attention",) if attn else ()) + \
        (("ssd_chunk",) if ssd else ())


def check_model_launches(cfg, counts: dict, runs: int, what: str,
                         train_steps: int = 0) -> None:
    """One attention-kernel launch per attention application and one SSD
    launch per Mamba2 layer, per prefill or forward; a training step adds
    its forward, with remat a second forward in the backward pass, and one
    launch of each backward kernel per application and per layer."""
    forwards = runs + train_steps * (2 if cfg.remat else 1)
    attn, ssd = model_sites(cfg)
    want = {"flash_attention": attn * forwards,
            "ssd_chunk": ssd * forwards,
            "flash_attention_bwd": attn * train_steps,
            "ssd_chunk_bwd": ssd * train_steps}
    for name, n in want.items():
        if counts[name] != n:
            fail(f"{what}: {name} launched {counts[name]} times, expected "
                 f"{n} ({runs} forward(s), {train_steps} training step(s))")


def phase_generate(torch, np, rt, launches: Launches, seed: int) -> dict:
    """Full-width greedy generation on the card, then a 2-layer full-width
    float32 copy on cuda against cpu."""
    C, SV = rt["C"], rt["SV"]
    cfg = C.get_config(ARCH)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    srv = SV.GenerationServer(cfg, max_seq=GEN_PROMPT + GEN_STEPS,
                              bs=GEN_BS, seed=seed, backend="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(seed)
    prompt = C.make_batch(cfg, GEN_PROMPT, GEN_BS, "prefill", gen)
    srv.generate(prompt, 1, GEN_PROMPT)          # warm-up (library init)
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    timings = {}
    t0 = time.perf_counter()
    tokens = srv.generate(prompt, GEN_STEPS, GEN_PROMPT, timings=timings)
    wall = time.perf_counter() - t0
    counts = launches.read("generate", MODEL_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    check_model_launches(cfg, counts, 1, "generate")
    if tokens.shape != (GEN_BS, GEN_STEPS) or tokens.min() < 0 \
            or tokens.max() >= cfg.padded_vocab:
        fail(f"generate: tokens of shape {tokens.shape} out of the vocab")
    logits, _ = srv.prefill(prompt)
    if tuple(logits.shape) != (GEN_BS, 1, cfg.padded_vocab) \
            or not bool(torch.isfinite(logits.float()).all()):
        fail("generate: prefill logits are not finite of the right shape")
    del srv, logits
    torch.cuda.empty_cache()

    # parity: the same width cut to PARITY_LAYERS layers, float32 compute,
    # the same weights on cuda and on cpu
    small = dataclasses.replace(cfg, num_layers=PARITY_LAYERS,
                                compute_dtype=torch.float32)
    gpu = SV.GenerationServer(small, max_seq=PARITY_PROMPT + PARITY_STEPS,
                              bs=1, seed=seed + 1, backend="cuda")
    cpu = SV.GenerationServer(small, max_seq=PARITY_PROMPT + PARITY_STEPS,
                              bs=1, backend="cpu", params=gpu.params)
    toks = C.make_batch(small, PARITY_PROMPT, 1, "prefill",
                        torch.Generator().manual_seed(seed))
    lg, _ = gpu.prefill(toks)
    lc, _ = cpu.prefill(toks)
    logit_err = float((lg.cpu() - lc).abs().max())
    if not torch.allclose(lg.cpu(), lc, **MODEL_TOL):
        fail(f"generate parity: cuda and cpu prefill logits differ by "
             f"{logit_err} (tolerance {MODEL_TOL})")
    tg = gpu.generate(toks, PARITY_STEPS, PARITY_PROMPT)
    tc = cpu.generate(toks, PARITY_STEPS, PARITY_PROMPT)
    if not np.array_equal(tg, tc):
        fail(f"generate parity: greedy tokens differ: cuda {tg.tolist()} "
             f"cpu {tc.tolist()}")
    del gpu, cpu
    torch.cuda.empty_cache()
    dec = timings["decode_s"]
    out = {"phase": "generate", "arch": ARCH, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "bs": GEN_BS, "prompt": GEN_PROMPT,
           "steps": GEN_STEPS, "params": cfg.param_count(),
           "init_s": init_s, "wall_s": wall,
           "prefill_ms": 1e3 * timings["prefill_s"],
           "decode_ms_per_token": 1e3 * sum(dec) / len(dec),
           "decode_ms_min": 1e3 * min(dec), "decode_ms_max": 1e3 * max(dec),
           "tokens_per_s": GEN_BS * GEN_STEPS / wall,
           "first_tokens": tokens[0][:8].tolist(),
           "max_memory_allocated_bytes": peak, "launches": counts,
           "parity": {"layers": PARITY_LAYERS, "prompt": PARITY_PROMPT,
                      "steps": PARITY_STEPS, "max_abs_logit_err": logit_err,
                      "max_abs_logit": float(lc.abs().max()),
                      "tokens": tg[0].tolist()}}
    emit(out)
    return out


def prompt_len(cfg, text: int) -> int:
    """Positions of a prompt of ``text`` tokens: a vlm prompt starts with
    its ``n_patches`` vision patches."""
    return text + (cfg.n_patches if cfg.arch_type == "vlm" else 0)


def greedy(torch, srv, prompt: dict, steps: int, plen: int) -> tuple:
    """``GenerationServer.generate``'s greedy loop through the server's
    ``prefill`` / ``decode`` / ``next_tokens``, keeping what it drops: the
    tokens (bs, steps) (audio: codebook 0's) and, per step and row, the
    decided logits' top-two gap and largest |logit| (float32, host), and
    the prefill's logits (host)."""
    logits, cache = srv.prefill(prompt)
    first = logits.cpu()
    pos = torch.full((srv.bs,), plen, dtype=torch.int32, device=srv.device)
    toks, gaps, tops = [], [], []
    for _ in range(steps):
        row = logits[:, -1, 0] if logits.dim() == 4 else logits[:, -1]
        top2 = row.float().topk(2, dim=-1).values.cpu()
        gaps.append(top2[:, 0] - top2[:, 1])
        tops.append(top2[:, 0].abs())
        nxt = srv.next_tokens(logits)
        toks.append(nxt.reshape(srv.bs, -1)[:, 0].cpu())
        logits, cache = srv.decode(cache, nxt, pos)
        pos = pos + 1
    return (torch.stack(toks, 1).numpy(), torch.stack(gaps, 1).numpy(),
            torch.stack(tops, 1).numpy(), first)


def parity_servers(torch, rt, cfg, seed: int, **cut) -> tuple:
    """A FAM_PARITY_LAYERS full-width float32 copy of ``cfg`` (or one cut
    as ``cut`` says) served on cuda, and on cpu from the same weights."""
    SV = rt["SV"]
    small = dataclasses.replace(cfg, compute_dtype=torch.float32,
                                **{"num_layers": FAM_PARITY_LAYERS, **cut})
    max_seq = prompt_len(small, FAM_PARITY_TEXT) + FAM_PARITY_STEPS
    gpu = SV.GenerationServer(small, max_seq=max_seq, bs=FAM_PARITY_BS,
                              seed=seed + 1, backend="cuda")
    cpu = SV.GenerationServer(small, max_seq=max_seq, bs=FAM_PARITY_BS,
                              backend="cpu", params=gpu.params)
    return gpu, cpu


def family_parity(torch, np, rt, gpu, cpu, seed: int) -> dict:
    """The ``parity_servers`` pair: prefill logits within MODEL_TOL, then
    greedy tokens equal up to the first step where the cpu's top-two
    logits lie within MODEL_TOL of each other (reported; the two may part
    from there)."""
    C, small = rt["C"], gpu.cfg
    plen = prompt_len(small, FAM_PARITY_TEXT)
    prompt = C.make_batch(small, plen, FAM_PARITY_BS, "prefill",
                          torch.Generator().manual_seed(seed))
    tg, _, _, lg = greedy(torch, gpu, prompt, FAM_PARITY_STEPS, plen)
    tc, gaps, tops, lc = greedy(torch, cpu, prompt, FAM_PARITY_STEPS, plen)
    logit_err = float((lg - lc).abs().max())
    if not torch.allclose(lg, lc, **MODEL_TOL):
        fail(f"families {small.name} parity: cuda and cpu prefill logits "
             f"differ by {logit_err} (tolerance {MODEL_TOL})")
    close = gaps < MODEL_TOL["atol"] + MODEL_TOL["rtol"] * tops
    near_tie = [int(j) for j in np.nonzero(close.any(axis=0))[0]]
    held = near_tie[0] if near_tie else FAM_PARITY_STEPS
    parted = [int(j) for j in np.nonzero((tg != tc).any(axis=0))[0]]
    if parted and parted[0] < held:
        fail(f"families {small.name} parity: greedy tokens differ at step "
             f"{parted[0]} before any near tie: cuda {tg.tolist()} cpu "
             f"{tc.tolist()}")
    del lg, lc
    return {"layers": small.num_layers,
            **({"experts": small.n_experts} if small.n_experts else {}),
            "bs": FAM_PARITY_BS, "prompt": plen, "steps": FAM_PARITY_STEPS,
            "max_abs_logit_err": logit_err,
            "min_top2_gap_cpu": float(gaps.min()),
            "first_near_tie_step": near_tie[0] if near_tie else None,
            "first_parted_step": parted[0] if parted else None,
            "tokens_equal": not parted, "tokens_cpu": tc[0].tolist()}


def serve_family(torch, rt, launches: Launches, cfg, seed: int,
                 check=None) -> dict:
    """``GenerationServer`` at full width and depth in bf16: load, one
    warm-up token, then FAM_STEPS greedy tokens timed; every attention
    layer (K3) or Mamba2 layer (K4) launched once per prefill. ``check``,
    where given, takes the server before it is freed; its record is kept
    as ``served_layer``."""
    C, SV = rt["C"], rt["SV"]
    dev = torch.device("cuda")
    plen = FAM_PROMPT
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = SV.GenerationServer(cfg, max_seq=plen + FAM_STEPS, bs=FAM_BS,
                              seed=seed, backend="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated()
    prompt = C.make_batch(cfg, plen, FAM_BS, "prefill",
                          torch.Generator(device=dev).manual_seed(seed))
    srv.generate(prompt, 1, plen)               # warm-up (library init)
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    timings = {}
    t0 = time.perf_counter()
    tokens = srv.generate(prompt, FAM_STEPS, plen, timings=timings)
    wall = time.perf_counter() - t0
    counts = launches.read(f"families {cfg.name}", model_kernels(cfg))
    peak = torch.cuda.max_memory_allocated()
    check_model_launches(cfg, counts, 1, f"families {cfg.name}")
    vocab = cfg.padded_vocab
    if tokens.shape != (FAM_BS, FAM_STEPS) or tokens.min() < 0 \
            or tokens.max() >= vocab:
        fail(f"families {cfg.name}: tokens of shape {tokens.shape} out of "
             f"the vocab")
    logits, _ = srv.prefill(prompt)
    want = (FAM_BS, 1) + ((cfg.n_codebooks,) if cfg.arch_type == "audio"
                          else ()) + (vocab,)
    if tuple(logits.shape) != want \
            or not bool(torch.isfinite(logits.float()).all()):
        fail(f"families {cfg.name}: prefill logits of shape "
             f"{tuple(logits.shape)} (want {want}) or not finite")
    del logits
    served = {} if check is None else {"served_layer": check(srv)}
    del srv
    torch.cuda.empty_cache()
    dec = timings["decode_s"]
    return {"arch": cfg.name, "arch_type": cfg.arch_type,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "heads": [cfg.n_heads, cfg.n_kv_heads],
            "head_dim": cfg.resolved_head_dim if cfg.n_heads else None,
            "params": cfg.param_count(),
            "bs": FAM_BS, "prompt": plen, "steps": FAM_STEPS,
            "load_s": load_s, "load_peak_bytes": load_peak, "wall_s": wall,
            "prefill_ms": 1e3 * timings["prefill_s"],
            "decode_ms_per_token": 1e3 * sum(dec) / len(dec),
            "decode_ms_min": 1e3 * min(dec), "decode_ms_max": 1e3 * max(dec),
            # a token's least time: every bf16 weight read once (the tied
            # heads read their whole tables)
            "decode_weights_bound_ms": 1e3 * 2.0 * cfg.param_count()
            / HBM_BYTES_PER_S,
            "tokens_per_s": FAM_BS * FAM_STEPS / wall,
            "first_tokens": tokens[0][:8].tolist(),
            "max_memory_allocated_bytes": peak, "launches": counts,
            **served}


def prefill_bound_ms(cfg, bs: int, plen: int) -> float:
    """A prefill's least time on the card: every weight outside the
    vocabulary tables (``param_count`` counts one table, audio one a
    codebook) times every prompt position, 2 flops each, at the bf16
    rate. Attention's own products and the last position's head are left
    out, so it is a lower bound."""
    tables = cfg.padded_vocab * cfg.d_model * (
        cfg.n_codebooks if cfg.arch_type == "audio" else 1)
    flops = 2.0 * (cfg.param_count() - tables) * bs * plen
    return 1e3 * flops / OPS_PER_S["bfloat16"]


def phase_families(torch, np, rt, launches: Launches, seed: int) -> dict:
    """The dense, ssm, vlm and audio configurations: each served at full
    width and depth on the card, a FAM_PARITY_LAYERS float32 copy cuda
    against cpu, and FAM_TRAIN's float32 training step cuda against
    cpu."""
    C = rt["C"]
    runs, total = {}, {name: 0 for name in launches.wrappers}
    for arch in FAMILIES:
        cfg = C.get_config(arch)
        t0 = time.perf_counter()
        rec = serve_family(torch, rt, launches, cfg, seed)
        rec["prefill_bound_ms"] = prefill_bound_ms(cfg, FAM_BS, FAM_PROMPT)
        total = add_counts(total, rec["launches"])
        gpu, cpu = parity_servers(torch, rt, cfg, seed)
        rec["parity"] = family_parity(torch, np, rt, gpu, cpu, seed)
        del gpu, cpu
        torch.cuda.empty_cache()
        if arch in FAM_TRAIN:
            rec["train_parity"] = train_parity(
                torch, np, rt, cfg, seed, bs=FAM_TRAIN[arch],
                seq=prompt_len(cfg, FAM_TRAIN_TEXT), launches=launches,
                layers=FAM_PARITY_LAYERS)
            torch.cuda.empty_cache()
        rec["wall_s_all"] = time.perf_counter() - t0
        runs[arch] = rec
        emit({"phase": "families." + arch, **rec})
    out = {"phase": "families", "archs": list(FAMILIES),
           "launches": total,
           "summary": {a: {k: r.get(k) for k in
                           ("prefill_ms", "prefill_bound_ms",
                            "decode_ms_per_token", "decode_weights_bound_ms",
                            "load_s", "max_memory_allocated_bytes")}
                       for a, r in runs.items()}}
    emit(out)
    return out


def moe_window(torch, rt, launches: Launches, cfg, seed: int) -> dict:
    """Mixtral at full width (its depth cut) in bf16 on one prompt of
    MOE_WINDOW_PROMPT tokens, past its sliding window: one K3 launch per
    layer, each with the configuration's window, a ring-buffer KV cache of
    the window's length, finite logits, then MOE_WINDOW_STEPS greedy tokens
    in the vocabulary."""
    C, SV, L = rt["C"], rt["SV"], rt["L"]
    dev = torch.device("cuda")
    plen, steps = MOE_WINDOW_PROMPT, MOE_WINDOW_STEPS
    window = cfg.sliding_window
    g_row = L.moe_groups(plen, cfg.moe_group_size)
    if plen <= window or (g_row, plen // g_row) != (8, 1088):
        fail(f"moe window: a {plen}-token prompt must pass the {window} "
             f"window in 8 groups of 1088, got {g_row} of {plen // g_row}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = SV.GenerationServer(cfg, max_seq=plen + steps, bs=1, seed=seed,
                              backend="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    prompt = C.make_batch(cfg, plen, 1, "prefill",
                          torch.Generator(device=dev).manual_seed(seed + 3))
    windows, kernel = [], L.flash_attention

    def recording(q, k, v, window=None):
        windows.append(window)
        return kernel(q, k, v, window=window)

    L.flash_attention = recording          # the model's name for K3
    try:
        launches.reset()
        t0 = time.perf_counter()
        logits, cache = srv.prefill(prompt)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        counts = launches.read("moe window", ("flash_attention",))
    finally:
        L.flash_attention = kernel
    check_model_launches(cfg, counts, 1, "moe window")
    clen = cache["kv"]["k"].shape[2]
    if windows != [window] * cfg.num_layers or clen != window:
        fail(f"moe window: K3 took windows {windows}, the cache {clen} "
             f"slots; expected {window} for each of {cfg.num_layers} layers")
    vocab = cfg.padded_vocab
    if tuple(logits.shape) != (1, 1, vocab) \
            or not bool(torch.isfinite(logits.float()).all()):
        fail("moe window: prefill logits not finite of shape (1, 1, V)")
    pos = torch.full((1,), plen, dtype=torch.int32, device=dev)
    toks, dec = [], []
    for _ in range(steps):
        nxt = srv.next_tokens(logits)
        toks.append(int(nxt[0, 0]))
        t0 = time.perf_counter()
        logits, cache = srv.decode(cache, nxt, pos)
        torch.cuda.synchronize()
        dec.append(time.perf_counter() - t0)
        pos = pos + 1
    if min(toks) < 0 or max(toks) >= vocab \
            or not bool(torch.isfinite(logits.float()).all()):
        fail(f"moe window: greedy tokens {toks} or logits out of range")
    peak = torch.cuda.max_memory_allocated()
    del srv, logits, cache
    torch.cuda.empty_cache()
    return {"bs": 1, "prompt": plen, "steps": steps, "window": window,
            "cache_len": clen, "groups_per_row": g_row,
            "tokens_per_group": plen // g_row, "load_s": load_s,
            "prefill_ms": 1e3 * prefill_s,
            "decode_ms_per_token": 1e3 * sum(dec) / len(dec),
            "tokens": toks, "max_memory_allocated_bytes": peak,
            "launches": counts}


def near_tie_groups(torch, r, k: int) -> tuple:
    """Per group of routing ``r``: the count of choices whose probability
    lies within MOE_NEAR_TIE of the next one among a token's k + 1 largest
    (exact ties are decided alike on both backends and are not counted),
    whether the group holds none, and the smallest positive margin."""
    top = r.probs.sort(dim=-1, descending=True).values[..., :k + 1]
    gaps = top[..., :-1] - top[..., 1:]
    near = ((gaps <= MOE_NEAR_TIE) & (gaps > 0)).sum(dim=(1, 2))
    return near, near == 0, float(gaps[gaps > 0].min())


def compare_routing(torch, what: str, rg, rc) -> dict:
    """Routing ``rg`` (cuda) against ``rc`` (cpu) of the same tokens and
    router: each choice's expert, queue position and keep mask equal in
    every group with no near tie (``near_tie_groups``), the dropped counts
    equal where no group holds one."""
    near, held, margin = near_tie_groups(torch, rc, rc.expert.shape[-1])
    if not bool(held.any()):
        fail(f"{what}: every group holds a near tie")
    for name in ("expert", "pos", "keep"):
        if not torch.equal(getattr(rg, name).cpu()[held],
                           getattr(rc, name)[held]):
            fail(f"{what}: {name} differs between cuda and cpu away from "
                 f"any near tie")
    dropped = (int((~rg.keep).sum()), int((~rc.keep).sum()))
    if bool(held.all()) and dropped[0] != dropped[1]:
        fail(f"{what}: dropped {dropped} (cuda, cpu)")
    return {"groups": int(held.numel()), "capacity": rc.capacity,
            "dropped_cuda": dropped[0], "dropped_cpu": dropped[1],
            "choices": int(rc.expert.numel()),
            "near_tie_choices": int(near.sum()),
            "groups_compared": int(held.sum()), "smallest_margin": margin,
            "held": held}


def plain_moe(torch, L, p, xg, r, spec):
    """The plain version of ``moe_apply``'s dispatch and combine on grouped
    tokens ``xg`` (G, T, d) routed by ``r``: one expert at a time, its
    SwiGLU FFN in xg's dtype on the tokens of its kept choices, times
    their gates in xg's dtype, summed in float32 and rounded once, then
    the dense residual. No slot table, no capacity layout."""
    F = torch.nn.functional
    g, t, d = xg.shape
    dt, k = xg.dtype, r.expert.shape[-1]
    flat = xg.reshape(g * t, d)
    expert = r.expert.to(xg.device).reshape(g * t, k)
    gate = r.gate.to(xg.device).reshape(g * t, k)
    y = torch.zeros((g * t, d), dtype=torch.float32, device=xg.device)
    for e in range(spec.n_experts):
        rows, cols = torch.nonzero((expert == e) & (gate > 0), as_tuple=True)
        if not rows.numel():
            continue
        xe = flat[rows]
        h = F.silu(xe @ p["w1"][e].to(dt)) * (xe @ p["w3"][e].to(dt))
        ye = h @ p["w2"][e].to(dt)
        y.index_add_(0, rows, gate[rows, cols].to(dt).float()[:, None]
                     * ye.float())           # one row per token and expert
    y = y.to(dt).reshape(g, t, d)
    if spec.dense_residual:
        y = y + L.mlp_apply(p["dense"], xg)
    return y


def moe_served_check(torch, rt, srv, seed: int) -> dict:
    """The served configuration's layer 0, every expert at its served
    dtype, on a MOE_APPLY_SHAPE input in that dtype: ``moe_apply`` twice
    on cuda (bitwise equal: no atomics); its routing against cpu's from
    the same float32 router (``compare_routing``), and y within
    MOE_SERVED_TOL of its largest |y| of ``plain_moe`` on the card from
    cpu's routing, in the groups compared."""
    L, cfg = rt["L"], srv.cfg
    dev = torch.device("cuda")
    spec = cfg.moe_spec
    p = srv.params["layers"][0]["moe"]
    b, s = MOE_APPLY_SHAPE
    g_row = L.moe_groups(s, spec.group_size)
    g, t, d = b * g_row, s // g_row, cfg.d_model
    x = torch.randn((b, s, d), device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed + 4)).to(cfg.compute_dtype)
    y, _ = L.moe_apply(p, x, spec)
    again, _ = L.moe_apply(p, x, spec)
    if not torch.equal(y, again):
        fail(f"moe {cfg.name} served layer: two cuda runs differ")
    ms = cuda_ms(torch, lambda: L.moe_apply(p, x, spec), 3)
    xg = x.reshape(g, t, d)
    rg = L.moe_route(p["router"], xg, spec)
    rc = L.moe_route(p["router"].cpu(), xg.cpu(), spec)
    rec = compare_routing(torch, f"moe {cfg.name} served layer", rg, rc)
    held = rec.pop("held").to(dev)
    want = plain_moe(torch, L, p, xg, rc, spec)[held].float()
    got = y.reshape(g, t, d)[held].float()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    if not err <= MOE_SERVED_TOL * scale:
        fail(f"moe {cfg.name} served layer: y differs from the plain "
             f"dispatch by {err} (limit {MOE_SERVED_TOL} x {scale})")
    out = {"shape": [b, s, d], "dtype": str(x.dtype).split(".")[-1],
           "experts": spec.n_experts, **rec,
           "occupied_experts": int(rc.expert[rc.keep].unique().numel()),
           "max_abs_y_err": err, "max_abs_y": scale,
           "deterministic": True, "cuda_ms": ms}
    del x, y, again, rg, want, got
    return out


def moe_apply_parity(torch, rt, gpu, cpu, seed: int) -> dict:
    """The first layer's ``moe_apply`` of a ``parity_servers`` pair on a
    MOE_PARITY_APPLY_SHAPE input, twice on cuda (bitwise equal: no
    atomics) and once on cpu: the routing as ``compare_routing`` holds it,
    y within MODEL_TOL in the groups it compares."""
    L, cfg = rt["L"], gpu.cfg
    dev = torch.device("cuda")
    spec = cfg.moe_spec
    pg, pc = (srv.params["layers"][0]["moe"] for srv in (gpu, cpu))
    b, s = MOE_PARITY_APPLY_SHAPE
    x = torch.randn((b, s, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed))
    yg, aux_g = L.moe_apply(pg, x, spec)
    again, _ = L.moe_apply(pg, x, spec)
    if not torch.equal(yg, again):
        fail(f"moe {cfg.name} moe_apply: two cuda runs differ")
    ms = cuda_ms(torch, lambda: L.moe_apply(pg, x, spec), 3)
    t0 = time.perf_counter()
    yc, aux_c = L.moe_apply(pc, x.cpu(), spec)
    cpu_s = time.perf_counter() - t0
    g_row = L.moe_groups(s, spec.group_size)
    xg = x.reshape(b * g_row, s // g_row, cfg.d_model)
    rg = L.moe_route(pg["router"], xg, spec)
    rc = L.moe_route(pc["router"], xg.cpu(), spec)
    rec = compare_routing(torch, f"moe {cfg.name} moe_apply", rg, rc)
    held = rec.pop("held")
    rows = held.reshape(b, g_row).repeat_interleave(s // g_row, dim=1)
    ygc = yg.cpu()
    err = float((ygc - yc).abs()[rows].max())
    if not torch.allclose(ygc[rows], yc[rows], **MODEL_TOL):
        fail(f"moe {cfg.name} moe_apply: y differs by {err} (tolerance "
             f"{MODEL_TOL})")
    out = {"shape": [b, s, cfg.d_model], "experts": spec.n_experts, **rec,
           "max_abs_y_err": err, "max_abs_y": float(yc.abs().max()),
           "aux_cuda": float(aux_g), "aux_cpu": float(aux_c),
           "deterministic": True, "cuda_ms": ms, "cpu_s": cpu_s}
    del x, yg, again, rg
    return out


def phase_moe(torch, np, rt, launches: Launches, seed: int) -> dict:
    """The MoE configurations at full published width with their depth cut
    to MOE_LAYERS: each served as the families are, its served layer 0
    held against cpu's routing and a plain dispatch, Mixtral's window on a
    prompt past it, a float32 copy cuda against cpu, and that copy's
    moe_apply cuda against cpu."""
    C = rt["C"]
    runs, total = {}, {name: 0 for name in launches.wrappers}
    for arch, layers in MOE_LAYERS.items():
        full = C.get_config(arch)
        cfg = dataclasses.replace(full, num_layers=layers)
        t0 = time.perf_counter()
        rec = serve_family(torch, rt, launches, cfg, seed,
                           check=lambda srv: moe_served_check(torch, rt, srv,
                                                              seed))
        rec["cut"] = {"layers": layers, "of": full.num_layers}
        rec["experts"], rec["top_k"] = cfg.n_experts, cfg.top_k
        total = add_counts(total, rec["launches"])
        if cfg.sliding_window is not None:
            rec["window_run"] = moe_window(torch, rt, launches, cfg, seed)
            total = add_counts(total, rec["window_run"]["launches"])
        t1 = time.perf_counter()
        gpu, cpu = parity_servers(torch, rt, full, seed,
                                  **MOE_PARITY_CUTS[arch])
        rec["parity"] = family_parity(torch, np, rt, gpu, cpu, seed)
        rec["moe_apply"] = moe_apply_parity(torch, rt, gpu, cpu, seed)
        rec["parity_s"] = time.perf_counter() - t1
        del gpu, cpu
        torch.cuda.empty_cache()
        rec["wall_s_all"] = time.perf_counter() - t0
        runs[arch] = rec
        emit({"phase": "moe." + arch, **rec})
    out = {"phase": "moe", "archs": list(MOE_LAYERS), "launches": total,
           "summary": {a: {k: r.get(k) for k in
                           ("cut", "prefill_ms", "decode_ms_per_token",
                            "decode_weights_bound_ms", "load_s",
                            "max_memory_allocated_bytes")}
                       for a, r in runs.items()}}
    emit(out)
    return out


def profile_device(torch, fn) -> dict:
    """One call of ``fn`` (a minibatch forward, a training step) under
    ``torch.profiler``, tracing the device only (host operators add events
    that take longer to reduce than the step itself): the device's busy time
    (the sum of kernel time) against the wall, the number of kernels and
    copies it ran, K3's device time and kernels (forward and backward),
    K4's forward's and backward's, K1's and K2's, the fused window's, the
    host-device copies, the kernels with the most device time, and what the
    profiled call cost in all (``cost_s``, the reduction included)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t_cost = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # device-side entries only: the runtime's launch calls are host
        # entries
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        # the attribute's name moved between PyTorch releases
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((e.key, us, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(us for _, us, _ in rows) / 1e6
    k3 = [(us, n) for k, us, n in rows if any(f in k for f in K3_FUNCTIONS)]
    k4 = [(us, n) for k, us, n in rows if any(f in k for f in K4_FUNCTIONS)]
    k4b = [(us, n) for k, us, n in rows
           if any(f in k for f in K4_BWD_FUNCTIONS)]
    k1 = [(us, n) for k, us, n in rows if any(f in k for f in K1_FUNCTIONS)]
    k2 = [(us, n) for k, us, n in rows if any(f in k for f in K2_FUNCTIONS)]
    kf = [(us, n) for k, us, n in rows if any(f in k for f in KF_FUNCTIONS)]
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": (1.0 - busy / wall) if rows else None,
            "device_ops": sum(n for _, _, n in rows),
            "k3_device_ms": sum(us for us, _ in k3) / 1e3,
            "k3_kernels": sum(n for _, n in k3),
            "k4_device_ms": sum(us for us, _ in k4) / 1e3,
            "k4_kernels": sum(n for _, n in k4),
            "k4_bwd_device_ms": sum(us for us, _ in k4b) / 1e3,
            "k4_bwd_kernels": sum(n for _, n in k4b),
            "k1_device_ms": sum(us for us, _ in k1) / 1e3,
            "k1_kernels": sum(n for _, n in k1),
            "k2_device_ms": sum(us for us, _ in k2) / 1e3,
            "k2_kernels": sum(n for _, n in k2),
            "kf_device_ms": sum(us for us, _ in kf) / 1e3,
            "kf_kernels": sum(n for _, n in kf),
            "copies": sum(n for k, _, n in rows if k.startswith("Memcpy")),
            "top": [{"name": k[:120], "device_ms": us / 1e3, "count": n}
                    for k, us, n in rows[:15]],
            "cost_s": time.perf_counter() - t_cost}


def phase_serve_interleaved(torch, np, rt, launches: Launches,
                            seed: int) -> dict:
    """Fulcrum's real-mode executor serving a uniform trace with the
    full-width batch-inference server, no trainer."""
    C, SV, IR, S = rt["C"], rt["SV"], rt["IR"], rt["S"]
    cfg = C.get_config(ARCH)
    t0 = time.perf_counter()
    srv = SV.BatchInferenceServer(cfg, seq_len=SERVE_SEQ, bs=SERVE_BS,
                                  seed=seed, backend="cuda")
    init_s = time.perf_counter() - t0
    t_mb = srv.minibatch_time(iters=3)
    rate = SERVE_LOAD * SERVE_BS / t_mb
    trace = S.ArrivalTrace.uniform(rate, SERVE_DURATION)
    runtime = IR.ManagedInterleaveRuntime(
        None, srv, IR.InterleaveConfig(rate, SERVE_BS, latency_budget=2 * t_mb,
                                       duration=SERVE_DURATION), trace=trace)
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    t0 = time.perf_counter()
    rep = runtime.run()
    wall = time.perf_counter() - t0
    counts = launches.read("serve_interleaved", MODEL_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    minibatches = len(rep.latencies) // SERVE_BS
    if minibatches < 1 or len(rep.latencies) != minibatches * SERVE_BS:
        fail(f"serve_interleaved: served {len(rep.latencies)} requests of "
             f"{len(trace)}")
    check_model_launches(cfg, counts, minibatches, "serve_interleaved")
    logits = srv.infer()
    if tuple(logits.shape) != (SERVE_BS, SERVE_SEQ, cfg.padded_vocab) \
            or not bool(torch.isfinite(logits.float()).all()):
        fail("serve_interleaved: logits are not finite of the right shape")
    del logits
    profile = profile_device(torch, srv.infer)
    gate = runtime_gate(np, rt, srv, t_mb)
    del srv
    torch.cuda.empty_cache()
    out = {"phase": "serve_interleaved", "arch": ARCH, "seq_len": SERVE_SEQ,
           "bs": SERVE_BS, "init_s": init_s, "minibatch_s": t_mb,
           "rate": rate, "requests": len(trace),
           "served": len(rep.latencies), "minibatches": minibatches,
           "wall_s": wall, "p50_latency_s": rep.latency_quantile(0.5),
           "p99_latency_s": rep.latency_quantile(0.99),
           "violation_rate": rep.violation_rate(2 * t_mb),
           "max_memory_allocated_bytes": peak, "launches": counts,
           "profile": profile, "admission_gate": gate}
    emit(out)
    return out


def runtime_gate(np, rt, srv, t_mb: float) -> dict:
    """The runtime behind ``AdmissionPolicy("shed").gate`` with the
    measured minibatch time as the service time, on a uniform trace at
    GATE_LOAD x the minibatch rate: it must shed exactly the engine mask's
    count for the same inputs. The admitted tail is recorded beside the
    budget, not held to it: the card's minibatch times vary around the
    measured one."""
    CC, IR, S = rt["CC"], rt["IR"], rt["S"]
    budget = 2 * t_mb
    rate = GATE_LOAD * SERVE_BS / t_mb
    trace = S.ArrivalTrace.uniform(rate, GATE_DURATION)
    policy = CC.AdmissionPolicy("shed")
    want = int(np.count_nonzero(~policy.admit(trace.times, budget, SERVE_BS,
                                              t_mb, 0.0)))
    runtime = IR.ManagedInterleaveRuntime(
        None, srv, IR.InterleaveConfig(rate, SERVE_BS, latency_budget=budget,
                                       duration=GATE_DURATION),
        trace=trace, admission=policy.gate(SERVE_BS, t_mb, budget))
    t0 = time.perf_counter()
    rep = runtime.run()
    wall = time.perf_counter() - t0
    if want < 1 or rep.shed_requests != want:
        fail(f"serve_interleaved: the gate shed {rep.shed_requests}, the "
             f"engine mask {want}")
    admitted = len(trace) - want
    if len(rep.latencies) != admitted // SERVE_BS * SERVE_BS:
        fail(f"serve_interleaved: the gated runtime served "
             f"{len(rep.latencies)} of {admitted} admitted requests")
    return {"load": GATE_LOAD, "rate": rate, "budget_s": budget,
            "offered": len(trace), "shed": rep.shed_requests,
            "engine_mask_shed": want, "served": len(rep.latencies),
            "wall_s": wall, "p50_latency_s": rep.latency_quantile(0.5),
            "p99_latency_s": rep.latency_quantile(0.99),
            "violation_rate": rep.violation_rate(budget)}


def train_parity(torch, np, rt, cfg, seed: int, bs: int = 1,
                 seq: int = PARITY_TRAIN_SEQ, launches=None,
                 layers: int = PARITY_LAYERS) -> dict:
    """One training step of a ``layers``-deep full-width float32 copy on
    cuda and on cpu from the same params and batch (``bs`` x ``seq``
    positions):
    losses within TRAIN_LOSS_TOL, every gradient leaf within
    TRAIN_GRAD_TOL of its largest |g|. With ``launches`` given, the cuda
    step must launch each kernel of its path as ``check_model_launches``
    counts one training step."""
    ST, T, A = rt["ST"], rt["T"], rt["A"]
    small = dataclasses.replace(cfg, num_layers=layers,
                                compute_dtype=torch.float32)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    base = rt["M"].init_params(small, gen, dev)
    batch = next(iter(rt["D"].SyntheticTokenSource(small, bs, seq,
                                                   seed=seed)))
    out = {}
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        params = T.tree_map(lambda t: t.detach().to(device).clone()
                            .requires_grad_(), base)
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        if launches is not None and name == "cuda":
            launches.reset()
        t0 = time.perf_counter()
        metrics, grads = ST.loss_and_grads(params, b, small)
        state = A.init_opt_state(params)
        A.adamw_update(grads, state, params, A.AdamWConfig())
        loss = float(metrics["loss"])
        if launches is not None and name == "cuda":
            what = f"{cfg.name} training step"
            counts = launches.read(what, model_kernels(small))
            check_model_launches(small, counts, 0, what, 1)
        out[name] = (loss, [g.cpu() for g in T.leaves(grads)],
                     [p.detach().cpu() for p in T.leaves(params)],
                     time.perf_counter() - t0)
    (lg, gg, pg, tg), (lc, gc, pc, tc) = out["cuda"], out["cpu"]
    if not (math.isfinite(lg) and abs(lg - lc) <= TRAIN_LOSS_TOL):
        fail(f"train parity: cuda loss {lg} vs cpu {lc} (tolerance "
             f"{TRAIN_LOSS_TOL})")
    worst = 0.0
    for i, (a, b) in enumerate(zip(gg, gc)):
        err = float((a - b).abs().max())
        scale = max(float(b.abs().max()), 1e-30)
        worst = max(worst, err / scale)
        if err > TRAIN_GRAD_TOL * scale:
            fail(f"train parity: gradient leaf {i} differs by {err} "
                 f"(tolerance {TRAIN_GRAD_TOL} x {scale})")
    return {"layers": layers, "bs": bs, "seq": seq,
            "launches": counts if launches is not None else None,
            "loss_cuda": lg, "loss_cpu": lc, "max_grad_err_share": worst,
            "max_abs_param_diff_after_step": max(
                float((a - b).abs().max()) for a, b in zip(pg, pc)),
            "cuda_s": tg, "cpu_s": tc}


def phase_train(torch, np, rt, launches: Launches, seed: int) -> tuple:
    """The full-width 38-layer trainer for a few steps, then the 2-layer
    float32 cuda-vs-cpu step. Returns the phase's record and the trainer,
    warm, for ``serve_train_interleaved``."""
    C, TL, A = rt["C"], rt["TL"], rt["A"]
    cfg = C.get_config(ARCH)
    t0 = time.perf_counter()
    trainer = TL.Trainer(cfg, TRAIN_BS, TRAIN_SEQ, A.AdamWConfig(), seed=seed,
                         backend="cuda")
    try:
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = trainer.train(1, log_every=0)          # library set-up
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        launches.reset()
        rep = trainer.train(TRAIN_STEPS, log_every=0)
        counts = launches.read("train", TRAIN_KERNELS)
        peak = torch.cuda.max_memory_allocated()
        profile = profile_device(torch, trainer.step_minibatch)
        check_model_launches(cfg, counts, 0, "train", TRAIN_STEPS)
        losses = warm.losses + rep.losses
        if not all(math.isfinite(x) for x in losses):
            fail(f"train: losses are not finite: {losses}")
        t0 = time.perf_counter()
        parity = train_parity(torch, np, rt, cfg, seed)
        parity["wall_s"] = time.perf_counter() - t0
    except BaseException:
        trainer.close()
        raise
    step_s = sum(rep.step_times) / len(rep.step_times)
    out = {"phase": "train", "arch": ARCH, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "params": cfg.param_count(),
           "remat": cfg.remat, "bs": TRAIN_BS, "seq": TRAIN_SEQ,
           "steps": TRAIN_STEPS, "init_s": init_s, "warm_step_s": warm_s,
           "ms_per_step": 1e3 * step_s, "step_ms": [1e3 * x for x in
                                                    rep.step_times],
           "tokens_per_s": TRAIN_BS * TRAIN_SEQ / step_s,
           "first_loss": losses[0], "last_loss": losses[-1],
           "losses": losses, "max_memory_allocated_bytes": peak,
           "launches": counts,
           "launches_per_step": {k: v / TRAIN_STEPS for k, v in counts.items()},
           "parity": parity, "profile": profile}
    emit(out)
    return out, trainer


class TimedTrainer:
    """A trainer as the runtime sees it, measured: its minibatch time is
    measured once, and each step records how long it took."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.t_tr = None
        self.samples: list = []
        self.step_s: list = []

    def train_minibatch_time(self) -> float:
        if self.t_tr is None:
            # the trainer is warm from the train phase: one step to settle
            # beside the server, then the mean of three, each kept
            self.samples = [self.trainer.train_minibatch_time(warmup=0,
                                                              iters=1)
                            for _ in range(4)]
            self.t_tr = sum(self.samples[1:]) / 3
        return self.t_tr

    def step_minibatch(self) -> None:
        t0 = time.perf_counter()
        self.trainer.step_minibatch()
        self.step_s.append(time.perf_counter() - t0)


def phase_serve_train_interleaved(torch, np, rt, launches: Launches, trainer,
                                  seed: int) -> dict:
    """Fulcrum's real-mode executor filling inference slack with training
    minibatches of the train phase's full-width trainer (closed here),
    against the same trace served without a trainer."""
    C, SV, IR, S = rt["C"], rt["SV"], rt["IR"], rt["S"]
    cfg = C.get_config(ARCH)
    try:
        srv = SV.BatchInferenceServer(cfg, seq_len=SERVE_SEQ, bs=SERVE_BS,
                                      seed=seed, backend="cuda")
        t_mb = srv.minibatch_time(iters=3)
        timed = TimedTrainer(trainer)
        t_tr = timed.train_minibatch_time()
        period = t_mb + INTERLEAVE_TRAIN_STEPS * t_tr
        rate = SERVE_BS / period
        # 5 s, unless a step is so slow that no whole batch would form
        duration = max(SERVE_DURATION, 1.01 * period)
        trace = S.ArrivalTrace.uniform(rate, duration)
        icfg = IR.InterleaveConfig(rate, SERVE_BS, latency_budget=2 * period,
                                   duration=duration)
        runtime = IR.ManagedInterleaveRuntime(timed, srv, icfg, trace=trace)
        torch.cuda.reset_peak_memory_stats()
        launches.reset()
        t0 = time.perf_counter()
        rep = runtime.run()
        wall = time.perf_counter() - t0
        counts = launches.read("serve_train_interleaved", TRAIN_KERNELS)
        peak = torch.cuda.max_memory_allocated()
        step_s, samples = list(timed.step_s), list(timed.samples)
    finally:
        trainer.close()
    minibatches = len(rep.latencies) // SERVE_BS
    if rep.train_minibatches < 1:
        fail("serve_train_interleaved: no training minibatch ran in the "
             "inference slack")
    if minibatches < 1 or len(rep.latencies) != minibatches * SERVE_BS:
        fail(f"serve_train_interleaved: served {len(rep.latencies)} requests "
             f"of {len(trace)}")
    check_model_launches(cfg, counts, minibatches, "serve_train_interleaved",
                         rep.train_minibatches)
    del trainer, timed, runtime
    torch.cuda.empty_cache()
    alone = IR.ManagedInterleaveRuntime(None, srv, icfg, trace=trace).run()
    del srv
    torch.cuda.empty_cache()
    overrun = max(x - t_tr for x in step_s)
    out = {"phase": "serve_train_interleaved", "arch": ARCH,
           "seq_len": SERVE_SEQ, "bs": SERVE_BS, "minibatch_s": t_mb,
           "train_bs": TRAIN_BS, "train_seq": TRAIN_SEQ, "train_step_s": t_tr,
           "train_step_samples_s": samples,
           "batch_period_s": period, "rate": rate, "duration_s": duration,
           "requests": len(trace),
           "served": len(rep.latencies), "minibatches": minibatches,
           "trained_minibatches": rep.train_minibatches, "wall_s": wall,
           "p50_latency_s": rep.latency_quantile(0.5),
           "p99_latency_s": rep.latency_quantile(0.99),
           "p50_latency_s_without_trainer": alone.latency_quantile(0.5),
           "p99_latency_s_without_trainer": alone.latency_quantile(0.99),
           "train_step_s_in_run": step_s,
           "max_train_overrun_s": overrun,
           "max_memory_allocated_bytes": peak, "launches": counts}
    emit(out)
    return out


def phase_tiled_matmul(torch, rt, launches: Launches, seed: int) -> dict:
    """The ``kernels.ops.tiled_matmul`` entry point on the serving
    minibatch's MLP up-projection, against ``torch.matmul``."""
    OPS = rt["OPS"]
    M, K, N = MM_SHAPE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device=dev)
         / math.sqrt(K)).to(torch.bfloat16)
    routes = dict(OPS.tiled_matmul.routes)
    launches.reset()
    t0 = time.perf_counter()
    y = OPS.tiled_matmul(x, w)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches.read("tiled_matmul", ("tiled_matmul",))
    routes = {k: n - routes[k] for k, n in OPS.tiled_matmul.routes.items()}
    ref = torch.matmul(x, w)
    err = float((y.float() - ref.float()).abs().max())
    tol = MM_TOL["bfloat16"]
    if tuple(y.shape) != (M, N) or not bool(torch.isfinite(y).all()) \
            or not torch.allclose(y.float(), ref.float(), rtol=tol, atol=tol):
        fail(f"tiled_matmul: the entry point's product differs from "
             f"torch.matmul by {err} (tolerance {tol})")
    del x, w, y, ref
    torch.cuda.empty_cache()
    out = {"phase": "tiled_matmul", "shape": [M, K, N], "dtype": "bfloat16",
           "wall_s": wall, "max_abs_err_vs_torch_matmul": err,
           "launches": counts, "routes": routes}
    emit(out)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the kernel-phase inputs and the models' "
                         "random weights")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 comparisons
    torch.backends.cudnn.allow_tf32 = False

    import repro_torch.kernels.flash_attention.flash_attention as K3
    import repro_torch.kernels.fulcrum.fused_window as KF
    import repro_torch.kernels.fulcrum.lane_sort as K2
    import repro_torch.kernels.fulcrum.maxplus_scan as K1
    import repro_torch.kernels.ssd_scan.ssd_scan as K4
    import repro_torch.kernels.tiled_matmul.tiled_matmul as K5
    from repro_torch import tree as T
    from repro_torch.configs import base as C
    from repro_torch.core import backend as B
    from repro_torch.core import controller as CC
    from repro_torch.core import fleet as F
    from repro_torch.core import fused_window as FW
    from repro_torch.core import nn_model as NN
    from repro_torch.core import problem as P
    from repro_torch.core import simulate as S
    from repro_torch.core.als import QuadrantRanges
    from repro_torch.core.device_model import (DeviceModel, INFER_WORKLOADS,
                                               TRAIN_WORKLOADS)
    from repro_torch.core.oracle import Oracle
    from repro_torch.core.powermode import PowerModeSpace
    from repro_torch.core.scheduler import Fulcrum, strategy_profilers
    from repro_torch.data import pipeline as D
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as OPS
    from repro_torch.launch import steps as ST
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.optim import adamw as A
    from repro_torch.runtime import interleave_runtime as IR
    from repro_torch.runtime import serving as SV
    from repro_torch.runtime import train_loop as TL
    rt = dict(P=P, S=S, K1=K1, K2=K2, Fulcrum=Fulcrum, DeviceModel=DeviceModel,
              PowerModeSpace=PowerModeSpace, TRAIN=TRAIN_WORKLOADS,
              INFER=INFER_WORKLOADS, C=C, SV=SV, IR=IR, TL=TL, A=A, ST=ST,
              T=T, M=M, L=L, D=D, OPS=OPS, CC=CC, B=B, F=F, Oracle=Oracle,
              KF=KF, FW=FW, NN=NN, QuadrantRanges=QuadrantRanges,
              strategy_profilers=strategy_profilers)

    device = phase_device(torch, build)
    kern = phase_kernels(torch, np, rt, K1, K2, K3, K4, K5, args.seed)
    launches = Launches({"maxplus_scan": K1.maxplus_scan,
                         "lane_sort": K2.lane_sort,
                         "flash_attention": K3.flash_attention,
                         "flash_attention_bwd": K3.flash_attention_bwd,
                         "ssd_chunk": K4.ssd_chunk,
                         "ssd_chunk_bwd": K4.ssd_chunk_bwd,
                         "tiled_matmul": K5.tiled_matmul,
                         "fused_window": KF.fused_window})
    paths = {"execute": phase_execute(torch, np, rt, launches),
             "serve_dynamic": phase_serve_dynamic(torch, np, rt, launches),
             "serve_closed_loop": phase_serve_closed_loop(torch, np, rt,
                                                          launches),
             "multi_tenant": phase_multi_tenant(torch, np, rt, launches),
             "oracle_sweep": phase_oracle_sweep(torch, np, rt, launches),
             "strategies": phase_strategies(torch, np, rt, launches),
             "fleet": phase_fleet(torch, np, rt, launches)}
    sweep = phase_sweep(torch, np, rt, launches)
    paths["sweep"] = sweep["full_space"]
    paths["sweep_100k"] = sweep["lanes_100k"]
    paths["generate"] = phase_generate(torch, np, rt, launches, args.seed)
    paths["families"] = phase_families(torch, np, rt, launches, args.seed)
    paths["moe"] = phase_moe(torch, np, rt, launches, args.seed)
    paths["serve_interleaved"] = phase_serve_interleaved(torch, np, rt,
                                                         launches, args.seed)
    paths["train"], trainer = phase_train(torch, np, rt, launches, args.seed)
    paths["serve_train_interleaved"] = phase_serve_train_interleaved(
        torch, np, rt, launches, trainer, args.seed)
    del trainer
    paths["tiled_matmul"] = phase_tiled_matmul(torch, rt, launches, args.seed)

    rows = []
    for name, meta in KERNEL_ROWS.items():
        by_phase = {p: rec["launches"][name] for p, rec in paths.items()}
        m = kern[name]
        rows.append({"name": name, **meta,
                     "launches": sum(by_phase.values()),
                     "launches_by_phase": by_phase,
                     "max_abs_err": m["max_abs_err"], "ms": m["kernel_ms"],
                     "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": m["bound_by"], "library_ms": m["library_ms"],
                     "shape": m["shape"]})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                 "count": device["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
