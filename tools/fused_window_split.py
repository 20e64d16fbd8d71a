"""Split the fused fleet window's device time by part, and time builds of
its kernel from several checkouts against each other, on the card.

Each ROOT is a checkout holding ``src/repro_torch/kernels/csrc/
fused_window.cu`` (this tree, ``.``, or another commit's file unpacked
under ``build/``); it is named by its directory. Each source is built
twice with ``build.NVCC_FLAGS`` into ``build/kf_split/``: as it is, and as
the diagnostic build (``-DKF_STAMPS``) whose thread 0 stamps the SM clock
at the end of each part. A source without stamps (the first design, PR
21) gets this tree's stamp block and a stamp after each of its parts:
the rungs, the staging, the admission (with its compaction at each
commit), the fold and the tails. The ptxas lines of every build are
printed.

The three windows of ``chip_smoke.fused_shapes`` are captured once, from
``serve_fleet(fused=True)`` on the card with ``fused_window_plain`` in the
wrapper's place (so no build of the kernel runs before it is measured,
and every build meets the same inputs); every build is
held against this tree's ``fused_window_plain`` on each (``chip_smoke.
compare_fused``), then timed in ``--rounds`` rounds, the roots in order
and then reversed (A B B A), each time between CUDA events over ``--reps``
launches of its launcher and under the profiler (device time a launch);
then the diagnostic builds' splits (``chip_smoke.fused_split``). One JSON
line per result, all of them also in ``chiprun_out/fused_window_split.json``.
Needs a Hopper card; from the repository root:

    python3 tools/fused_window_split.py build/parent .
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import repro_torch.kernels.fulcrum.fused_window as KF  # noqa: E402
from repro_torch.core import controller as CC  # noqa: E402
from repro_torch.core import fleet as F  # noqa: E402
from repro_torch.core import fused_window as FW  # noqa: E402
from repro_torch.core.device_model import INFER_WORKLOADS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

SOURCE = Path("src/repro_torch/kernels/csrc/fused_window.cu")
OUT = ROOT / "build" / "kf_split"
# the first design's parts, and where each one ends in its source: (the
# line, the stamp put before (-) or after (+) it)
FIRST_LABELS = "rungs,staging,admission,fold,tails"
FIRST_STAMPS = (
    ("  const int64_t k = blockIdx.x;\n", "-", "  KF_STAMP_BEGIN();\n"),
    ("  const int bs = (int)bsf[sel];\n", "-", "  KF_STAMP(1);\n"),
    ("  if (solved && !trims && staged) ct = tv;      // everything is "
     "admitted\n", "+", "  KF_STAMP(2);\n"),
    ("    // the engine: c = max(c, ready_j) + t_in from clock_in over the\n",
     "-", "    KF_STAMP(3);\n"),
    ("    s_nadm = n_adm;\n", "-", "    KF_STAMP(4);\n"),
    ("    if (i >= n_served) lat_g[i] = INFINITY;\n  }\n", "+",
     "  KF_STAMP_END(5);\n"))


def stamped(src: str) -> str:
    """``src`` with stamps: as it is if it has its own, else with this
    tree's stamp block and ``FIRST_STAMPS``."""
    if "// stamps: begin" in src:
        return src
    own = (ROOT / SOURCE).read_text()
    block = own[own.index("// stamps: begin"):own.index("// stamps: end")]
    head = "#include <stdint.h>\n"
    for line, _, _ in ((head, "", ""),) + FIRST_STAMPS:
        if src.count(line) != 1:
            raise SystemExit(f"not the first design: no one line {line!r}")
    src = src.replace(head, f'{head}#define KF_STAMP_LABELS "{FIRST_LABELS}"'
                      f"\n{block}\n")
    for line, where, stamp in FIRST_STAMPS:
        src = src.replace(line, stamp + line if where == "-" else line + stamp)
    return src


def compile_all(roots: list) -> dict:
    """Every root's plain and stamped library, built in parallel:
    {(root name, "plain" | "stamps"): ctypes library}."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for r in roots:
        src = Path(r) / SOURCE
        copy = OUT / f"{Path(r).resolve().name}_stamps.cu"
        copy.write_text(stamped(src.read_text()))
        for kind, path, extra in (("plain", src, ()),
                                  ("stamps", copy, ("-DKF_STAMPS",))):
            lib = OUT / f"lib{Path(r).resolve().name}_{kind}.so"
            procs[(Path(r).resolve().name, kind)] = (lib, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, *extra, "-o", str(lib),
                 str(path)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    libs = {}
    sigs = dict(cs.KF_STAMP_SIGNATURES,
                fused_window_launch=KF._SIGNATURES["fused_window_launch"])
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        emit({"build": key, "rc": proc.returncode,
              "ptxas": [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln
                        or "error" in ln or "Compiling" in ln]})
        if proc.returncode:
            raise SystemExit(f"{key} did not build:\n{log}")
        L = ctypes.CDLL(str(lib))
        for fn, (argtypes, restype) in sigs.items():
            if key[1] == "plain" and fn != "fused_window_launch":
                continue
            getattr(L, fn).argtypes = list(argtypes)
            getattr(L, fn).restype = restype
        libs[key] = L
    return libs


RESULTS = []


def emit(obj: dict) -> None:
    RESULTS.append(obj)
    print(json.dumps(obj), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_window_split: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit({"nvidia_smi": smi})
    names = [Path(r).resolve().name for r in args.roots]
    libs = compile_all(args.roots)
    rt = dict(F=F, CC=CC, INFER=INFER_WORKLOADS, FW=FW, KF=KF)
    wrapper, FW.fused_window = FW.fused_window, KF.fused_window_plain
    try:
        shapes = cs.fused_shapes(rt)
    finally:
        FW.fused_window = wrapper
    for shape, call in shapes.items():
        rows = call[4]
        K, T = rows.shape[0], rows.shape[1] - KF.N_IN
        want = KF.fused_window_plain(*call)
        out = torch.empty((K, KF.N_OUT + 2 * T), dtype=torch.float64,
                          device=rows.device)
        rec = {"shape_name": shape, "shape": [K, T], "nvidia_smi": smi,
               "route": KF.route(K, T, call[0].shape[0], call[8]),
               "trims": bool(call[7])}
        for n in names:
            for kind in ("plain", "stamps"):
                out.fill_(float("nan"))
                cs.launch_fused(torch, KF, libs[(n, kind)], call, out)
                torch.cuda.synchronize()
                rec[f"max_abs_err_{n}_{kind}"] = cs.compare_fused(
                    np, rt, out, want, f"{n} ({kind}) at {shape}")[0]
        times = {n: {"event_ms": [], "device_ms": []} for n in names}
        for _ in range(args.rounds):
            for n in names + names[::-1]:
                lib = libs[(n, "plain")]
                times[n]["event_ms"].append(cs.cuda_ms(
                    torch, lambda: cs.launch_fused(torch, KF, lib, call, out),
                    args.reps))
                prof = cs.profile_device(torch, lambda: [
                    cs.launch_fused(torch, KF, lib, call, out)
                    for _ in range(args.reps)])
                times[n]["device_ms"].append(
                    prof["kf_device_ms"] / max(1, prof["kf_kernels"]))
        rec["times"] = times
        rec["split"] = {n: cs.fused_split(torch, np, KF, libs[(n, "stamps")],
                                          call) for n in names}
        emit(rec)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "fused_window_split.json").write_text(json.dumps(RESULTS,
                                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
