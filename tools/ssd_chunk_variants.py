"""Time variants of K4's CUDA sources against each other on the card.

Each argument is a directory holding an edited copy of
``csrc/ssd_chunk.cu`` (a forward variant) or ``csrc/ssd_chunk_bwd.cu`` (a
backward variant) with the ``hopper.cuh`` it includes; the variant is
named after its directory. Every source is built with ``build.NVCC_FLAGS``
into ``build/variants/`` and its ptxas register and spill lines printed.
The forward variants are then held against ``ssd_chunk_plain`` at
``chip_smoke.SSD_SHAPE`` on four input draws and at ``SSD_CHECKS`` (each
one's share of ``SSD_TOL``'s limit, and whether its output has the first
variant's bits), and timed at ``SSD_SHAPE`` in four alternating rounds of
20 launches; the backward variants are compared bit for bit and timed in
four rounds of 5. One JSON line per result. Needs a Hopper card; from the
repository root:

    python3 tools/ssd_chunk_variants.py build/var_src/a build/var_src/b
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import repro_torch.kernels.ssd_scan.ssd_scan as K4  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

ROUNDS = 4


def compile_variant(src: Path, out: Path) -> ctypes.CDLL:
    lib = out / f"lib{src.parent.name}.so"
    r = subprocess.run(["/usr/local/cuda/bin/nvcc", *build.NVCC_FLAGS, "-o",
                        str(lib), str(src)], capture_output=True, text=True)
    print(json.dumps({"variant": src.parent.name, "rc": r.returncode,
                      "ptxas": [ln.strip() for ln in
                                (r.stdout + r.stderr).splitlines()
                                if "registers" in ln or "spill" in ln
                                or "error" in ln]}), flush=True)
    if r.returncode:
        raise SystemExit(f"{src} did not build")
    L = ctypes.CDLL(str(lib))
    if src.name == "ssd_chunk_bwd.cu":
        L.ssd_chunk_bwd_launch.argtypes = ([ctypes.c_void_p] * 13
                                           + [ctypes.c_int64] * 5
                                           + [ctypes.c_void_p])
        L.ssd_chunk_bwd_scratch.argtypes = [ctypes.c_int64] * 5
        L.ssd_chunk_bwd_scratch.restype = ctypes.c_int64
    else:
        L.ssd_chunk_launch.argtypes = ([ctypes.c_void_p] * 7
                                       + [ctypes.c_int64] * 5
                                       + [ctypes.c_void_p])
    return L


def forward(L, args, shape):
    b, nc, l, h, p, n = shape
    y = torch.empty_like(args[0])
    st = torch.empty((b, nc, h, n, p), device=y.device)
    err = L.ssd_chunk_launch(*[t.data_ptr() for t in args], y.data_ptr(),
                             st.data_ptr(), b * nc, l, h, p, n,
                             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ssd_chunk_launch returned {err}")
    return y, st


def backward(L, args, dy, dst):
    b, nc, l, h, p = args[0].shape
    n = args[3].shape[-1]
    outs = [torch.empty_like(t) for t in args]
    scratch = torch.empty(L.ssd_chunk_bwd_scratch(b * nc, l, h, p, n),
                          device=dy.device)
    err = L.ssd_chunk_bwd_launch(
        *[t.data_ptr() for t in (*args, dy, dst, *outs, scratch)],
        b * nc, l, h, p, n, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ssd_chunk_bwd_launch returned {err}")
    return outs


def rounds(fns: dict, reps: int) -> dict:
    ms = {name: [] for name in fns}
    for _ in range(ROUNDS):
        for name, fn in fns.items():
            ms[name].append(cs.cuda_ms(torch, fn, reps))
    return ms


def main(dirs: list[str]) -> int:
    if not torch.cuda.is_available():
        print("ssd_chunk_variants: needs a CUDA card", file=sys.stderr)
        return 2
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    srcs = [next(Path(d).glob("ssd_chunk*.cu")) for d in dirs]
    with ThreadPoolExecutor(len(srcs)) as ex:
        libs = dict(zip((s.parent.name for s in srcs),
                        ex.map(lambda s: compile_variant(s, out), srcs)))
    fwd = [s.parent.name for s in srcs if s.name == "ssd_chunk.cu"]
    bwd = [s.parent.name for s in srcs if s.name == "ssd_chunk_bwd.cu"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for shape in [cs.SSD_SHAPE] * 4 + list(cs.SSD_CHECKS):
        args = cs.ssd_case(torch, shape, gen, dev)
        yp, stp = K4.ssd_chunk_plain(*args)
        first = None
        for name in fwd:
            y, st = forward(libs[name], args, shape)
            torch.cuda.synchronize()
            same = first is None or (torch.equal(y, first[0])
                                     and torch.equal(st, first[1]))
            first = first or (y, st)
            print(json.dumps({"check": name, "shape": shape,
                              "share": {"y": cs.ssd_share(torch, y, yp),
                                        "st": cs.ssd_share(torch, st, stp)},
                              "same_bits_as_first": same}), flush=True)
        del args, yp, stp, first
    torch.cuda.empty_cache()
    args = cs.ssd_case(torch, cs.SSD_SHAPE, gen, dev)
    if fwd:
        print(json.dumps({"forward_ms": rounds(
            {name: (lambda L=libs[name]: forward(L, args, cs.SSD_SHAPE))
             for name in fwd}, 20)}), flush=True)
    if bwd:
        dy = torch.randn(args[0].shape, generator=gen, device=dev)
        b, nc, l, h, p, n = cs.SSD_SHAPE
        dst = torch.randn((b, nc, h, n, p), generator=gen, device=dev)
        grads = [backward(libs[name], args, dy, dst) for name in bwd]
        torch.cuda.synchronize()
        print(json.dumps({"backward_same_bits_as_first": {
            name: all(torch.equal(u, v) for u, v in zip(g, grads[0]))
            for name, g in zip(bwd, grads)}}), flush=True)
        del grads
        print(json.dumps({"backward_ms": rounds(
            {name: (lambda L=libs[name]: backward(L, args, dy, dst))
             for name in bwd}, 5)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
