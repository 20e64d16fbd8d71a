"""Per-lane padded sort of the report builder: the CUDA kernel's wrapper and
its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/fulcrum/lane_sort.py::lane_sort``
(body ``_lane_sort_kernel``). The engine's batched report builder
(``core.simulate._presort_reports``) fills every lane's quantile and
violation-rate cache from one ascending sort of a ``+inf``-padded (lanes, R)
float64 latency matrix per sort chunk.

Contract (``repro/kernels/fulcrum/ref.py::lane_sort_ref`` /
``lane_violations_ref``): the rows sorted ascending and, when per-lane
``budgets`` are given, the int32 count of each row's finite entries strictly
above its budget. A sort only permutes, so the result is checked for
equality, never tolerance.

 * ``lane_sort_plain`` is ``torch.sort`` plus the masked count.
 * ``lane_sort`` launches ``csrc/lane_sort.cu`` for CUDA tensors and takes
   the plain version only for CPU tensors. Its kernel is a bitonic network
   per row over R padded to a power of two, Rp, by one of three routes
   that ``route`` picks from R alone before the launch:

   - ``"warp"``, Rp <= 32 E = 512 (E = 16 doubles a thread): one warp per
     row, the row in registers, every stage in the thread or through warp
     shuffles; no shared memory and no barrier.
   - ``"block"``, 512 < Rp <= 16384: one block of Rp / E threads per row,
     the row in registers; only the stages of distance >= 512 go through
     shared memory, one round trip (two barriers) for each merge size.
   - ``"global"``, Rp > 16384: a global-memory pass for every stage of
     distance >= 16384 and shared-memory sorts of 16384-value pieces, so
     rows up to the engine's 4M-element sort chunks never leave the kernel.

   It is bound by bytes, 16 B per element (read once, written once), on
   the warp and block routes. ``lane_sort.launches`` counts launches,
   ``lane_sort.routes`` counts them by route.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_SIGNATURES = {
    "lane_sort_launch": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2 + [ctypes.c_void_p],
        ctypes.c_int),
    "lane_sort_work_width": ([ctypes.c_int64], ctypes.c_int64),
    "lane_sort_route": ([ctypes.c_int64], ctypes.c_int)}
# the routes in the order of the launcher's codes (lane_sort_route)
ROUTES = ("warp", "block", "global")
E = 16                        # doubles a thread holds in registers
WARP_MAX, BLOCK_MAX = 32 * E, 16384


def route(R: int) -> str:
    """The kernel route for rows of ``R`` values: ``"warp"`` when R padded
    to a power of two is at most ``WARP_MAX``, ``"block"`` up to
    ``BLOCK_MAX``, else ``"global"``. The launcher applies the same rule."""
    Rp = 1 << max(int(R) - 1, 0).bit_length()
    return "warp" if Rp <= WARP_MAX else "block" if Rp <= BLOCK_MAX \
        else "global"


def lane_sort_plain(mat: torch.Tensor, budgets: Optional[torch.Tensor] = None):
    """``torch.sort`` of each row, plus the violation counts if asked."""
    srt = torch.sort(mat, dim=1).values
    if budgets is None:
        return srt
    over = torch.isfinite(mat) & (mat > budgets[:, None])
    return srt, over.sum(dim=1, dtype=torch.int32)


def _check(mat: torch.Tensor, budgets: Optional[torch.Tensor]) -> None:
    """Raise on inputs the kernel does not take."""
    if mat.dim() != 2:
        raise ValueError(f"mat must be (lanes, R), got {tuple(mat.shape)}")
    for name, x in (("mat", mat), ("budgets", budgets)):
        if x is None:
            continue
        if x.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {x.dtype}")
        if x.device != mat.device:
            raise ValueError(f"{name} is on {x.device}, mat on {mat.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if budgets is not None and tuple(budgets.shape) != (mat.shape[0],):
        raise ValueError(f"budgets must be (lanes,) = ({mat.shape[0]},), "
                         f"got {tuple(budgets.shape)}")


def lane_sort(mat: torch.Tensor, budgets: Optional[torch.Tensor] = None):
    """Rows of ``mat`` sorted ascending, or ``(sorted, counts)`` when
    ``budgets`` is given.

    CUDA tensors launch the hand-written kernel by ``route``'s route on the
    current stream (and add one to ``lane_sort.launches`` and to that
    route's count in ``lane_sort.routes``); CPU tensors run the plain
    version. Anything else raises."""
    build.refuse_dtensor("lane_sort", mat, budgets)
    _check(mat, budgets)
    if mat.device.type == "cpu":
        return lane_sort_plain(mat, budgets)
    if mat.device.type != "cuda":
        raise ValueError(f"lane_sort runs on cuda or cpu tensors, "
                         f"not {mat.device}")
    L, R = mat.shape
    out = torch.empty_like(mat)
    counts = None
    if budgets is not None:
        counts = torch.empty(L, dtype=torch.int32, device=mat.device)
    if L and R:
        way = route(R)
        lib = build.load("lane_sort", _SIGNATURES)
        width = lib.lane_sort_work_width(R)  # scratch, global route only
        work = torch.empty((L, width), dtype=torch.float64,
                           device=mat.device) if width else None
        with torch.cuda.device(mat.device):
            err = lib.lane_sort_launch(
                mat.data_ptr(), None if budgets is None else budgets.data_ptr(),
                out.data_ptr(), None if counts is None else counts.data_ptr(),
                None if work is None else work.data_ptr(), L, R,
                torch.cuda.current_stream().cuda_stream)
        build.check(lib, err, f"lane_sort ({way})")
        lane_sort.launches += 1
        lane_sort.routes[way] += 1
    elif counts is not None:
        counts.zero_()                 # no entries, so nothing is over
    return out if counts is None else (out, counts)


lane_sort.launches = 0
lane_sort.routes = dict.fromkeys(ROUTES, 0)
