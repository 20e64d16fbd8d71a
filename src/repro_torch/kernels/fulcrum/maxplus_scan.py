"""Managed-interleaving max-plus scan: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/fulcrum/maxplus_scan.py::
maxplus_scan`` (body ``_maxplus_kernel``), the engine's hot path: every
managed completion time and every training slack-fill count of a
``simulate_batch`` comes out of it, one launch per lane chunk.

Contract (``repro/kernels/fulcrum/ref.py::maxplus_scan_ref``): ``ready``,
``exec_t`` are (lanes, K) float64 event matrices padded with ``+inf`` / 0;
``t_tr``, ``tau_cap``, ``clock`` are (lanes,) float64 (``+inf`` t_tr = no
training, ``+inf`` cap = uncapped). Returns the completions
``c_k = max(c_{k-1}, ready_k) + exec_k`` from ``c_{-1} = clock`` and the
per-lane sum of ``clip(floor((ready_k - c_{k-1}) / t_tr), 0, tau_cap)``
over finite events.

 * ``maxplus_scan_plain`` is the Pallas body's Hillis-Steele doubling in
   torch ops, in the same order, so on the CPU it is bitwise equal to the
   Pallas kernel in interpret mode.
 * ``maxplus_scan`` launches ``csrc/maxplus_scan.cu`` for CUDA tensors and
   takes the plain version only for CPU tensors. Its kernel (a warp per
   lane, a warp-shuffle scan of per-thread max-plus maps; see the source's
   note) is bound by bytes: 24 B per event over the card's memory rate. It
   scans in another order, so it meets the reference to ``atol=1e-8,
   rtol=1e-9`` with fills within the floor-boundary slack (+-2 per lane),
   as ``docs/exactness.md`` sets for every non-NumPy engine tier.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_SIGNATURES = {"maxplus_scan_launch": (
    [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 2 + [ctypes.c_void_p],
    ctypes.c_int)}


def maxplus_scan_plain(ready: torch.Tensor, exec_t: torch.Tensor,
                       t_tr: torch.Tensor, tau_cap: torch.Tensor,
                       clock: torch.Tensor) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The Pallas body's doubling scan in torch ops, on any device."""
    L, K = ready.shape
    if L == 0 or K == 0:
        return (torch.zeros_like(ready),
                torch.zeros(L, dtype=ready.dtype, device=ready.device))
    a = exec_t
    b = ready + exec_t
    d = 1
    while d < K:                              # Hillis-Steele over (a, b)
        b_s = torch.cat([b.new_full((L, d), -torch.inf), b[:, :-d]], dim=1)
        a_s = torch.cat([a.new_zeros((L, d)), a[:, :-d]], dim=1)
        b = torch.maximum(b_s + a, b)         # b first: the round's own a
        a = a_s + a
        d *= 2
    clk = clock[:, None]
    c = torch.maximum(clk + a, b)
    start = torch.cat([clk, c[:, :-1]], dim=1)
    fills = torch.minimum(
        torch.clamp_min(torch.floor((ready - start) / t_tr[:, None]), 0.0),
        tau_cap[:, None])
    fills = torch.where(torch.isfinite(ready), fills, fills.new_zeros(()))
    return c, fills.sum(dim=1)


def _check(ready, exec_t, t_tr, tau_cap, clock) -> None:
    """Raise on inputs the kernel does not take."""
    if ready.dim() != 2 or exec_t.shape != ready.shape:
        raise ValueError("ready and exec_t must be (lanes, K) of one shape, "
                         f"got {tuple(ready.shape)} and {tuple(exec_t.shape)}")
    for name, x in (("t_tr", t_tr), ("tau_cap", tau_cap), ("clock", clock)):
        if tuple(x.shape) != (ready.shape[0],):
            raise ValueError(f"{name} must be (lanes,) = "
                             f"({ready.shape[0]},), got {tuple(x.shape)}")
    for name, x in (("ready", ready), ("exec_t", exec_t), ("t_tr", t_tr),
                    ("tau_cap", tau_cap), ("clock", clock)):
        if x.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {x.dtype}")
        if x.device != ready.device:
            raise ValueError(f"{name} is on {x.device}, ready on "
                             f"{ready.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def maxplus_scan(ready: torch.Tensor, exec_t: torch.Tensor,
                 t_tr: torch.Tensor, tau_cap: torch.Tensor,
                 clock: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Managed completions (lanes, K) and fill sums (lanes,).

    CUDA tensors launch the hand-written kernel on the current stream (and
    add one to ``maxplus_scan.launches``); CPU tensors run the plain
    version. Anything else raises."""
    _check(ready, exec_t, t_tr, tau_cap, clock)
    if ready.device.type == "cpu":
        return maxplus_scan_plain(ready, exec_t, t_tr, tau_cap, clock)
    if ready.device.type != "cuda":
        raise ValueError(f"maxplus_scan runs on cuda or cpu tensors, "
                         f"not {ready.device}")
    L, K = ready.shape
    c = torch.empty_like(ready)
    fills = torch.empty(L, dtype=torch.float64, device=ready.device)
    if L == 0:
        return c, fills
    lib = build.load("maxplus_scan", _SIGNATURES)
    with torch.cuda.device(ready.device):
        err = lib.maxplus_scan_launch(
            ready.data_ptr(), exec_t.data_ptr(), t_tr.data_ptr(),
            tau_cap.data_ptr(), clock.data_ptr(), c.data_ptr(),
            fills.data_ptr(), L, K, torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "maxplus_scan")
    maxplus_scan.launches += 1
    return c, fills


maxplus_scan.launches = 0
