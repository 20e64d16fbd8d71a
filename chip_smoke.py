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
    events, the lane sort at 512 x 8192 and at 1 x 32768 (its global-pass
    path) — with times, the bytes-over-bandwidth bound and the one-call
    library yardstick where PyTorch has one.
 3. ``execute``: the README quickstart (GMD concurrent plan for mobilenet,
    executed over a 120 s Poisson trace) on ``backend="cuda"`` and again on
    ``"cpu"``, compared to the engine tolerance.
 4. ``serve_dynamic``: the README's open-loop dynamic case, the same way.
 5. ``sweep``: ``simulate_batch`` over every (power mode x inference
    minibatch size) of the default space (2,205 lanes, 120 s at 60 req/s),
    then the 100k-lane point of ``benchmarks/bench_interleave_engine.py``;
    both checked against the CPU backend, with each kernel timed and checked
    against its plain version on the card at the sweep's own shapes.

Every path phase sets the kernels' launch counts to 0 before it runs and
fails unless each kernel launched. The line before the last lists every
kernel (``{"kernels": [...]}``); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
before printing any result.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

ENG_TOL = dict(rtol=1e-9, atol=1e-8)      # docs/exactness.md, engine tier
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
FP64_OPS_PER_S = 34e12                    # H100 SXM data sheet, float64
#                                           outside the tensor cores
# the kernel phase's shapes: the engine's full lane chunk, a report-builder
# sort chunk, and one row long enough for the sort's global-memory passes
MAXPLUS_SHAPE = (8192, 8192)
SORT_SHAPES = ((512, 8192), (1, 32768))
# the sweep: one 120 s Poisson trace at 60 req/s over the whole default
# space, then bench_interleave_engine.py's 100k-lane point
SWEEP_TRACE = (60.0, 120.0, 0)            # rate, duration, seed
BIG_LANES, BIG_TRACE = 100_000, (32.0, 4.0, 7)

KERNEL_ROWS = {
    "maxplus_scan": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/maxplus_scan.cu",
        replaces="src/repro/kernels/fulcrum/maxplus_scan.py:56"),
    "lane_sort": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/lane_sort.cu",
        replaces="src/repro/kernels/fulcrum/lane_sort.py:52"),
}


def emit(obj: dict) -> None:
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


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time (ms) for the work: the larger of bytes over the memory
    rate and float64 operations over the float64 rate."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / FP64_OPS_PER_S
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")


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


def check_sort(torch, K2, mat, budgets, what: str) -> float:
    srt, viol = K2.lane_sort(mat, budgets)
    torch.cuda.synchronize()
    srt_p, viol_p = K2.lane_sort_plain(mat, budgets)
    if not torch.equal(srt, srt_p):
        fail(f"{what}: lane_sort values differ from torch.sort")
    if not torch.equal(viol, viol_p):
        fail(f"{what}: lane_sort violation counts differ")
    return 0.0


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
    err = check_sort(torch, K2, mat, budgets, f"{L}x{R}")
    ms = cuda_ms(torch, lambda: K2.lane_sort(mat, budgets), reps)
    plain_ms = cuda_ms(torch, lambda: K2.lane_sort_plain(mat, budgets), reps)
    library_ms = cuda_ms(torch, lambda: torch.sort(mat, dim=1), reps)
    # one read and one write of every element, the budgets, the counts;
    # a comparison sort needs at least R log2 R comparisons per row
    r_log = max(1.0, math.log2(max(R, 1)))
    b_ms, by = bound(16.0 * L * R + 12.0 * L, L * R * r_log)
    return {"shape": [L, R], "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": by,
            "max_abs_err": err}


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


def phase_kernels(torch, K1, K2, seed: int) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    args, valid = maxplus_case(torch, *MAXPLUS_SHAPE, gen, dev)
    k1 = time_maxplus(torch, K1, args, valid, reps=10)
    del args, valid
    mat, bud = sort_case(torch, *SORT_SHAPES[0], gen, dev)
    k2 = time_sort(torch, K2, mat, bud, reps=20)
    mat, bud = sort_case(torch, *SORT_SHAPES[1], gen, dev)
    k2_global = time_sort(torch, K2, mat, bud, reps=20)
    torch.cuda.empty_cache()
    out = {"phase": "kernels", "maxplus_scan": k1, "lane_sort": k2,
           "lane_sort_global_pass": k2_global,
           "maxplus_scan_library": "no single PyTorch call computes the "
                                   "max-plus recurrence with fills"}
    emit(out)
    return out


class Launches:
    """Reads the kernels' launch counts around one path phase."""

    def __init__(self, K1, K2):
        self.K1, self.K2 = K1, K2

    def reset(self) -> None:
        self.K1.maxplus_scan.launches = 0
        self.K2.lane_sort.launches = 0

    def read(self, phase: str) -> dict:
        got = {"maxplus_scan": self.K1.maxplus_scan.launches,
               "lane_sort": self.K2.lane_sort.launches}
        for name, n in got.items():
            if n < 1:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the kernel-phase inputs")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    import repro_torch.kernels.fulcrum.lane_sort as K2
    import repro_torch.kernels.fulcrum.maxplus_scan as K1
    from repro_torch.core import problem as P
    from repro_torch.core import simulate as S
    from repro_torch.core.device_model import (DeviceModel, INFER_WORKLOADS,
                                               TRAIN_WORKLOADS)
    from repro_torch.core.powermode import PowerModeSpace
    from repro_torch.core.scheduler import Fulcrum
    from repro_torch.kernels import build
    rt = dict(P=P, S=S, K1=K1, K2=K2, Fulcrum=Fulcrum, DeviceModel=DeviceModel,
              PowerModeSpace=PowerModeSpace, TRAIN=TRAIN_WORKLOADS,
              INFER=INFER_WORKLOADS)

    device = phase_device(torch, build)
    kern = phase_kernels(torch, K1, K2, args.seed)
    launches = Launches(K1, K2)
    paths = {"execute": phase_execute(torch, np, rt, launches),
             "serve_dynamic": phase_serve_dynamic(torch, np, rt, launches)}
    sweep = phase_sweep(torch, np, rt, launches)
    paths["sweep"] = sweep["full_space"]
    paths["sweep_100k"] = sweep["lanes_100k"]

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
