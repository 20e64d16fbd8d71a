"""Mamba2 SSD intra-chunk product: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas kernel ``repro/kernels/ssd_scan/ssd_scan.py::
ssd_chunk`` (body ``_ssd_chunk_kernel``). Every Mamba2 layer's prefill and
full-sequence forward runs it once, through ``kernels.ops.ssd_scan``.

Contract (``repro/kernels/ssd_scan/ref.py::ssd_chunk_ref``), per (batch,
chunk, head) with ``cs`` the in-chunk cumulative sum of ``dA``:

  y[i]  = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j      (l, p)
  st    = sum_j B_j^T exp(cs_last - cs_j) dt_j x_j                (n, p)

x (b, nc, l, h, p), dA and dt (b, nc, l, h), B and C (b, nc, l, n) (one SSM
group shared by every head), all float32. Returns y (b, nc, l, h, p) and
the chunk states (b, nc, h, n, p), both float32.

 * ``ssd_chunk_plain`` is that product in torch ops; it takes ``exp`` of
   the segment sums only where ``j <= i`` (above the diagonal they are
   positive and may overflow). Both versions form ``cs`` in float64 and
   round it once (``chunk_cumsum``).
 * ``ssd_chunk`` launches ``csrc/ssd_chunk.cu`` for CUDA tensors and takes
   the plain version only for CPU tensors. It takes ``l <= 256`` and
   ``p, n <= 128``. ``C B^T`` does not depend on the head, so a block owns
   (batch and chunk, a 64-row tile, a group of 8 heads) and forms it once
   for the group: query blocks keep ``G = C B^T`` of their tile against
   every key tile at or below it in shared memory, then each of four warp
   teams turns it into the masked ``M`` for one head at a time in
   registers and multiplies by the head's ``x`` tiles, which stream
   through a ``cp.async`` ring; state blocks (64 state rows each) hold the
   chunk's ``B`` and form ``(B o w)^T x`` per head. Every product runs on
   the tensor cores (``mma.sync`` m16n8k8) in split TF32, as the backward's
   do: plain TF32 would miss the 1e-4 tolerance. It is bound by bytes (621
   MB at the serving shape (8, 8, 256, 64, 64, 64), 0.185 ms; the least
   work as split TF32 takes 0.158 ms).

The gradient (the reference differentiates ``ssd_chunk_ref``'s jnp ops; the
port's forward is a kernel, so its backward is one too):

 * ``ssd_chunk`` is differentiable: when grad is enabled and an input
   requires it, the call goes through ``SSDChunkFn``, whose backward gives
   the gradients of ``x``, ``dA``, ``dt``, ``B`` and ``C`` from the
   upstream ``dy`` and ``dstates`` — on the card through
   ``ssd_chunk_bwd`` (``csrc/ssd_chunk_bwd.cu``), on the CPU through
   ``ssd_chunk_bwd_plain``.
 * ``ssd_chunk_bwd_plain`` is the explicit gradient in torch ops. ``B`` and
   ``C`` are shared by every head, so their gradients sum over heads; the
   gradient of ``cs`` runs back to ``dA`` as a reverse cumulative sum
   (summed in float64 and rounded once, as ``cs`` is formed); ``exp`` is
   again taken only below the diagonal, where above it ``0 * inf`` would
   be a NaN in the gradient.
 * ``ssd_chunk_bwd`` launches the backward kernels. A block owns (batch
   and chunk, a 64-row tile, a group of 8 heads), so the products that do
   not depend on the head — ``G = C B^T`` and those of the heads' summed
   ``dG`` with ``B`` and ``C`` — run once per group, not once per head: a
   query-tile pass (``dC``, the row terms of ``dcs``, the group's summed
   ``dG`` per tile pair into scratch), a chunk-state pass, a key-tile pass
   (``dx``, ``ddt``, the column terms, ``dB``); then a reverse cumulative
   sum for ``ddA`` and a sum of the groups' ``dB``, ``dC`` partials —
   deterministic, no atomics. Every product runs on the tensor cores
   (``mma.sync`` m16n8k8) in split TF32: each float32 operand becomes
   ``hi = tf32(v)`` and ``lo = tf32(v - hi)``, rounded to nearest, and the
   float32 accumulator takes ``hi.hi + hi.lo + lo.hi``. Plain TF32 (10
   mantissa bits) would take ~7x the element-wise limit the kernel is held
   to (``2e-4 (|want| + max(RMS, 0.1))``); the split stays within float32's
   rounding there (``tests/test_torch_ssd.py`` emulates both). It is
   bound by operations: the least work three times over at the TF32
   rate.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_CHUNK = 256
MAX_DIM = 128

_SIGNATURES = {"ssd_chunk_launch": (
    [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 5 + [ctypes.c_void_p],
    ctypes.c_int)}
_BWD_SIGNATURES = {
    "ssd_chunk_bwd_launch": (
        [ctypes.c_void_p] * 13 + [ctypes.c_int64] * 5 + [ctypes.c_void_p],
        ctypes.c_int),
    "ssd_chunk_bwd_scratch": ([ctypes.c_int64] * 5, ctypes.c_int64)}


def chunk_cumsum(dA: torch.Tensor) -> torch.Tensor:
    """In-chunk cumulative sum of ``dA`` (b, nc, l, h) over ``l``, summed in
    float64 and rounded once to float32, as the kernel forms it. A float32
    scan rounds at every step, in an order that differs between devices;
    with |cs| in the hundreds its error reaches 1e-5 absolute, and
    ``exp(cs_i - cs_j)`` carries it as a relative error."""
    return torch.cumsum(dA.double(), dim=2).float()


def ssd_chunk_plain(x: torch.Tensor, dA: torch.Tensor, dt: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor) -> tuple[torch.Tensor,
                                                               torch.Tensor]:
    """The intra-chunk product in torch ops, on any device. y and the states
    come back contiguous, in the kernel's layout, so a gradient made like
    them (``ones_like``) reaches ``ssd_chunk_bwd_plain`` with the strides
    the autograd backward gives it: einsum sums in a stride-dependent
    order."""
    l = x.shape[2]
    cs = chunk_cumsum(dA)                                 # (b, nc, l, h)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]     # (b, nc, i, j, h)
    causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    causal = causal[None, None, :, :, None]
    decay = torch.exp(seg.masked_fill(~causal, 0.0)).masked_fill(~causal, 0.0)
    scores = torch.einsum("bcin,bcjn->bcij", C, B)        # (b, nc, i, j)
    w = scores[..., None] * decay * dt[:, :, None, :, :]  # (b, nc, i, j, h)
    y = torch.einsum("bcijh,bcjhp->bcihp", w, x)
    wb = torch.exp(cs[:, :, -1:, :] - cs) * dt            # (b, nc, l, h)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", B, wb, x)
    return y.contiguous(), states.contiguous()


def ssd_chunk_bwd_plain(x: torch.Tensor, dA: torch.Tensor, dt: torch.Tensor,
                        B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                        dstates: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(dx, ddA, ddt, dB, dC) of ``ssd_chunk_plain`` for the upstream
    gradients ``dy`` (like y) and ``dstates`` (like the states), in torch
    ops on any device."""
    l = x.shape[2]
    cs = chunk_cumsum(dA)                                 # (b, nc, l, h)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]     # (b, nc, i, j, h)
    causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    causal = causal[None, None, :, :, None]
    L = torch.exp(seg.masked_fill(~causal, 0.0)).masked_fill(~causal, 0.0)
    G = torch.einsum("bcin,bcjn->bcij", C, B)[..., None]  # (b, nc, i, j, 1)
    dtj = dt[:, :, None, :, :]                            # (b, nc, 1, j, h)
    M = G * L * dtj                                       # (b, nc, i, j, h)
    dM = torch.einsum("bcihp,bcjhp->bcijh", dy, x) * causal
    dG = dM * L * dtj
    E = dM * M
    dx = torch.einsum("bcijh,bcihp->bcjhp", M, dy)
    dC = torch.einsum("bcijh,bcjn->bcin", dG, B)
    dB = torch.einsum("bcijh,bcin->bcjn", dG, C)
    ddt = (dM * G * L).sum(dim=2)                         # (b, nc, j, h)
    dcs = E.sum(dim=3) - E.sum(dim=2)                     # (b, nc, l, h)
    # chunk states: st = sum_j B_j^T w_j x_j, w_j = exp(cs_last - cs_j) dt_j
    decay = torch.exp(cs[:, :, -1:, :] - cs)              # (b, nc, l, h)
    w = decay * dt
    xd = torch.einsum("bcjhp,bchnp->bcjhn", x, dstates)   # (dst x_j)
    bd = torch.einsum("bcjn,bchnp->bcjhp", B, dstates)    # (dst^T B_j)
    dw = torch.einsum("bcjn,bcjhn->bcjh", B, xd)
    dx = dx + w[..., None] * bd
    dB = dB + torch.einsum("bcjh,bcjhn->bcjn", w, xd)
    ddt = ddt + decay * dw
    dcs = dcs - w * dw
    dcs[:, :, -1] += (w * dw).sum(dim=2)
    ddA = torch.flip(torch.cumsum(torch.flip(dcs.double(), [2]), dim=2),
                     [2]).float()
    return dx, ddA, ddt, dB, dC


def _check(x, dA, dt, B, C) -> None:
    """Raise on inputs the kernel does not take."""
    if x.dim() != 5:
        raise ValueError(f"x must be (b, nc, l, h, p), got {tuple(x.shape)}")
    b, nc, l, h, p = x.shape
    for name, t, shape in (("dA", dA, (b, nc, l, h)), ("dt", dt, (b, nc, l, h)),
                           ("B", B, (b, nc, l, B.shape[-1])),
                           ("C", C, (b, nc, l, B.shape[-1]))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in (("x", x), ("dA", dA), ("dt", dt), ("B", B), ("C", C)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_dims(l: int, p: int, n: int) -> None:
    if l > MAX_CHUNK or p > MAX_DIM or n > MAX_DIM:
        raise ValueError(f"the kernel takes chunks up to {MAX_CHUNK} and "
                         f"head / state dims up to {MAX_DIM}, got l={l}, "
                         f"p={p}, n={n}")


def _launch_forward(x, dA, dt, B, C) -> tuple[torch.Tensor, torch.Tensor]:
    b, nc, l, h, p = x.shape
    n = B.shape[-1]
    _check_dims(l, p, n)
    y = torch.empty_like(x)
    states = torch.empty((b, nc, h, n, p), dtype=torch.float32,
                         device=x.device)
    if x.numel() == 0 or n == 0:
        return y.zero_(), states.zero_()
    lib = build.load("ssd_chunk", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.ssd_chunk_launch(
            x.data_ptr(), dA.data_ptr(), dt.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), states.data_ptr(), b * nc, l, h, p, n,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "ssd_chunk")
    ssd_chunk.launches += 1
    return y, states


def ssd_chunk_bwd(x: torch.Tensor, dA: torch.Tensor, dt: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                  dstates: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(dx, ddA, ddt, dB, dC) from the backward kernels, for CUDA tensors.
    Adds one to ``ssd_chunk_bwd.launches``; raises on inputs the kernels do
    not take."""
    build.refuse_dtensor("ssd_chunk_bwd", x, dA, dt, B, C, dy, dstates)
    _check(x, dA, dt, B, C)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_bwd launches the CUDA kernel; "
                         f"{x.device} tensors take ssd_chunk_bwd_plain")
    b, nc, l, h, p = x.shape
    n = B.shape[-1]
    _check_dims(l, p, n)
    for name, t, shape in (("dy", dy, x.shape),
                           ("dstates", dstates, (b, nc, h, n, p))):
        if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{tuple(shape)} tensor on {x.device}")
    dx, ddA, ddt, dB, dC = (torch.empty_like(t) for t in (x, dA, dt, B, C))
    if x.numel() == 0 or n == 0:
        return tuple(t.zero_() for t in (dx, ddA, ddt, dB, dC))
    lib = build.load("ssd_chunk_bwd", _BWD_SIGNATURES)
    scratch = torch.empty(lib.ssd_chunk_bwd_scratch(b * nc, l, h, p, n),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.ssd_chunk_bwd_launch(
            x.data_ptr(), dA.data_ptr(), dt.data_ptr(), B.data_ptr(),
            C.data_ptr(), dy.data_ptr(), dstates.data_ptr(), dx.data_ptr(),
            ddA.data_ptr(), ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            scratch.data_ptr(), b * nc, l, h, p, n,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "ssd_chunk_bwd")
    ssd_chunk_bwd.launches += 1
    return dx, ddA, ddt, dB, dC


ssd_chunk_bwd.launches = 0


class SSDChunkFn(torch.autograd.Function):
    """The intra-chunk product with a hand-written gradient: the kernels on
    CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, dA, dt, B, C):
        if x.device.type == "cpu":
            y, states = ssd_chunk_plain(x, dA, dt, B, C)
        else:
            y, states = _launch_forward(x, dA, dt, B, C)
        ctx.save_for_backward(x, dA, dt, B, C)
        return y, states

    @staticmethod
    def backward(ctx, dy, dstates):
        x, dA, dt, B, C = ctx.saved_tensors
        b, nc, l, h, p = x.shape
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dstates = (x.new_zeros((b, nc, h, B.shape[-1], p)) if dstates is None
                   else dstates.contiguous())
        bwd = ssd_chunk_bwd_plain if x.device.type == "cpu" else ssd_chunk_bwd
        return bwd(x, dA, dt, B, C, dy, dstates)


def ssd_chunk(x: torch.Tensor, dA: torch.Tensor, dt: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor) -> tuple[torch.Tensor,
                                                         torch.Tensor]:
    """Intra-chunk SSD: (y (b, nc, l, h, p), states (b, nc, h, n, p)).

    CUDA tensors launch the hand-written kernel on the current stream (and
    add one to ``ssd_chunk.launches``); CPU tensors run the plain version.
    Anything else raises, and so does a chunk longer than 256 or a head or
    state dim above 128. Differentiable through ``SSDChunkFn`` when grad is
    enabled and an input requires it."""
    build.refuse_dtensor("ssd_chunk", x, dA, dt, B, C)
    _check(x, dA, dt, B, C)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_chunk runs on cuda or cpu tensors, "
                         f"not {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dA, dt, B, C)):
        return SSDChunkFn.apply(x, dA, dt, B, C)
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dA, dt, B, C)
    return _launch_forward(x, dA, dt, B, C)


ssd_chunk.launches = 0
