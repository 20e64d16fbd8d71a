"""Where the port's engine runs, and the host-dispatch counters.

Counterpart of ``repro.core.backend``. The port has two backends:

 * ``"cuda"`` (the default) — the hand-written Hopper kernels
   (``repro_torch/kernels/csrc``) on the current CUDA device. It needs a
   card of compute capability 9.0 or newer; without one ``resolve_backend``
   raises ``RuntimeError``.
 * ``"cpu"`` — the kernels' plain PyTorch versions on the host. Tests ask
   for it by name.

No environment variable changes the default and nothing degrades: a caller
that did not ask for the CPU never silently runs there. Resolving a backend
is the only place that touches CUDA, so ``import repro_torch`` neither
initialises a device nor builds anything.

The dispatch counters count host -> device program launches by layer, as in
the reference (``"engine"``: one per max-plus-scan lane chunk, ``"sort"``:
one per lane-sort chunk, ``"solver"``: one per grid-solver chunk).
"""
from __future__ import annotations

from typing import Optional

import torch

#: Backends the engine entry points accept; the first is the default.
BACKENDS = ("cuda", "cpu")

_MIN_CAPABILITY = (9, 0)


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"use one of {'/'.join(repr(b) for b in BACKENDS)}")


def resolve_backend(backend: Optional[str] = None) -> str:
    """Map a request to the backend that runs: ``None`` means ``"cuda"``.
    ``"cuda"`` raises ``RuntimeError`` unless a Hopper-class card is
    present; it is never replaced by the CPU."""
    backend = BACKENDS[0] if backend is None else backend
    check_backend(backend)
    if backend == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("backend='cuda' needs a CUDA device; "
                               "pass backend='cpu' to run the plain versions")
        cap = torch.cuda.get_device_capability()
        if cap < _MIN_CAPABILITY:
            raise RuntimeError(
                f"backend='cuda' needs compute capability >= 9.0 (the "
                f"kernels are built for sm_90a); this device has {cap}")
    return backend


def torch_device(backend: str) -> torch.device:
    """The tensor device a resolved backend computes on."""
    return torch.device("cuda" if backend == "cuda" else "cpu")


_DISPATCH_COUNTS: dict = {"engine": 0, "sort": 0}


def record_dispatch(kind: str) -> None:
    """Record one device-program launch of the given layer."""
    _DISPATCH_COUNTS[kind] = _DISPATCH_COUNTS.get(kind, 0) + 1


def dispatch_count(kind: Optional[str] = None) -> int:
    """Launches since import: one layer's count, or the total."""
    if kind is not None:
        return _DISPATCH_COUNTS.get(kind, 0)
    return sum(_DISPATCH_COUNTS.values())
