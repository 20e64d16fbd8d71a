"""Build the port's CUDA C++ kernels and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C launcher and is compiled on its
own by ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the repository
root (git-ignored), the first time a kernel is launched. A library's file
name carries a digest of its source, the ``csrc`` headers it includes
(``hopper.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is loaded as it is. ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.

Nothing here runs at import, so ``import repro_torch`` needs neither CUDA
nor a compiler. The launchers take device pointers and PyTorch's current
stream as ``c_void_p`` and return the ``cudaError_t`` of the launch
(0 = success); every library also exports ``error_string`` to name it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("maxplus_scan", "lane_sort", "flash_attention",
           "flash_attention_bwd", "ssd_chunk", "ssd_chunk_bwd",
           "tiled_matmul", "fused_window")

_LIBS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source at first launch and need the CUDA toolkit")
    return nvcc


def _source(name: str) -> bytes:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes by name."""
    src = (CSRC / f"{name}.cu").read_bytes()
    heads = re.findall(rb'^#include "([^"]+)"', src, flags=re.M)
    return src + b"".join((CSRC / h.decode()).read_bytes() for h in heads)


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for the current source
    and headers."""
    digest = hashlib.sha256(_source(name)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Sequence[str] = SOURCES) -> dict:
    """Compile every listed source whose library is missing, one ``nvcc``
    each, all started together. Returns ``{name: seconds}`` for the sources
    it compiled (the ptxas report of each lands beside its library as
    ``.log``); raises ``RuntimeError`` with the compiler's output on
    failure."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter())
    seconds, failed = {}, []
    for n, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {n}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)         # atomic: a reader never sees half
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def build_log(name: str) -> Optional[str]:
    """The compiler's report (registers, shared memory, spills) of the
    current build of ``name``, if it was built in this checkout."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else None


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use.
    ``signatures`` maps each C function to its ``(argtypes, restype)``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restype
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch "
                           f"({lib.error_string(err).decode()})")
