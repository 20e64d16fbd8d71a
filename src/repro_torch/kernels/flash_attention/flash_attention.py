"""Causal (optionally sliding-window) flash attention: the CUDA kernel's
wrapper and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/flash_attention/
flash_attention.py::flash_attention`` (body ``_flash_kernel``). The model's
prefill and full-sequence forward run it at every shared-attention site of
the hybrid stack.

Contract (``repro/kernels/flash_attention/ref.py::attention_ref``): q, k, v
are (B, H, S, D) with one H for all three, bf16 or float32; query ``i``
attends to keys ``j <= i`` (and ``j > i - window`` when a window is given)
with scale ``1/sqrt(D)``; the softmax runs in float32 and the output comes
back in the input dtype.

 * ``flash_attention_plain`` is that masked softmax in torch ops (scores
   masked to ``-1e30`` in float32), for any S and D.
 * ``flash_attention`` launches ``csrc/flash_attention.cu`` for CUDA
   tensors and takes the plain version only for CPU tensors. The kernel
   takes ``D in HEAD_DIMS`` (64, 128, 160) and any S: unlike the TPU
   kernel (``S % 128 == 0``) it masks the ragged tail itself; the TPU
   kernel takes any D, and every other D raises on CUDA tensors (no
   fallback). At D = 160 its shared-memory tiles are padded to 192
   columns, which TMA fills with zeros and nothing stores. In bf16 it runs
   on the tensor cores: one block per (batch x head, 128-query tile), two
   warpgroups of 64 rows, K and V streamed through shared memory by TMA
   (CUDA tensors must start 16-byte aligned), S = Q K^T and O += P V as
   ``wgmma`` with P rounded to bf16, the online softmax in float32
   registers. In float32 it runs on CUDA cores, one block per 64-query
   tile. Both skip tiles above the causal diagonal and tiles wholly
   outside the window. It is bound by operations: ``4 D`` flops per
   visible (query, key) pair over the card's rate for the input type.

The gradient (the reference differentiates ``attention_ref``'s jnp ops;
the port's forward is a kernel, so its backward is one too):

 * ``flash_attention`` is differentiable: when grad is enabled and an input
   requires it, the call goes through ``FlashAttentionFn``. On the card the
   forward kernel then also writes each row's float32 logsumexp, and the
   backward launches ``csrc/flash_attention_bwd.cu`` through
   ``flash_attention_bwd``; on the CPU both directions run the plain
   versions. Without grad (serving) the kernel writes no logsumexp.
 * ``flash_attention_bwd_plain`` is the explicit gradient in torch ops, of
   the same inputs as the kernel's (the forward's output ``O`` among them):
   probabilities ``P`` in float32, ``D = rowsum(dO * O)``, ``dS = P (dO
   V^T - D)``, ``dQ = dS K / sqrt(D)``, ``dK = dS^T Q / sqrt(D)``, ``dV =
   P^T dO``. ``O`` comes in the input type, as the kernel reads it: in bf16
   its rounding moves ``D`` by up to a few thousandths, and ``dQ``, ``dK``
   with it — further than any difference between the kernel and its plain
   version, so both form ``D`` alike.
 * ``flash_attention_bwd`` launches the backward kernels: one pass forms
   ``D = rowsum(dO * O)``, one block per key tile accumulates ``dK, dV``
   over the query tiles that see it, one block per query tile accumulates
   ``dQ`` — a deterministic split with no atomics (at D = 160 the dK, dV
   pass is two launches, one per gradient, so that its accumulators fit in
   a thread's registers). It recomputes ``P`` from ``Q, K`` and the
   logsumexp, keeps the forward's masking (causal, window, the ragged tail
   past S) and accumulates in float32; in bf16 its products are ``wgmma``
   with ``P`` and ``dS`` rounded to bf16. It is bound by operations: ``10
   D`` flops per visible pair (it does ``14 D``, ``16 D`` at D = 160: each
   pass recomputes ``S`` and, but for the dV pass, ``dO V^T``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 160)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_SIGNATURES = {"flash_attention_launch": (
    [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 4 + [ctypes.c_int]
    + [ctypes.c_void_p], ctypes.c_int)}
_BWD_SIGNATURES = {"flash_attention_bwd_launch": (
    [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 4 + [ctypes.c_int]
    + [ctypes.c_void_p], ctypes.c_int)}


def _probs(q: torch.Tensor, k: torch.Tensor,
           window: Optional[int]) -> torch.Tensor:
    """Float32 attention probabilities (B, H, S, S) under the causal
    (windowed) mask."""
    s = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    scores = scores.masked_fill(~mask, NEG_INF)
    return torch.softmax(scores, dim=-1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          window: Optional[int] = None) -> torch.Tensor:
    """Masked softmax attention in torch ops, on any device."""
    probs = _probs(q, k, window)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              do: torch.Tensor, window: Optional[int] = None
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention_plain`` for the output gradient
    ``do``, given the forward's output ``out``, in torch ops on any device,
    in the input dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    probs = _probs(q, k, window)
    dof = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", probs, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    ds = probs * (dp - (dof * out.float()).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_aligned(name: str, x: torch.Tensor) -> None:
    """The bf16 kernels load through TMA, which needs 16-byte aligned base
    addresses: raise on a CUDA tensor that starts elsewhere."""
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{name} must start at a 16-byte aligned address, "
                         f"got {x.data_ptr():#x}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    """Raise on inputs the kernel does not take."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must be (B, H, S, D) of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{x.dtype}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        _check_aligned(name, x)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: Optional[int] = None, with_lse: bool = True
                        ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The forward kernel on CUDA tensors (checked by the caller): the
    output and, with ``with_lse``, the rows' float32 logsumexp (B, H, S)
    that ``flash_attention_bwd`` takes. Adds one to
    ``flash_attention.launches``."""
    B, H, S, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {D}")
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B * H * S == 0:
        return out, lse
    lib = build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B * H, S, D, 0 if window is None else window, _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, window: Optional[int] = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the backward kernels, for CUDA tensors: ``out`` and
    ``lse`` are the forward's output and logsumexp, ``do`` the output
    gradient. Adds one to ``flash_attention_bwd.launches``; raises on inputs
    the kernels do not take."""
    _check(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd launches the CUDA kernel; "
                         f"{q.device} tensors take flash_attention_bwd_plain")
    B, H, S, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {D}")
    for name, t in (("out", out), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {q.dtype} tensor "
                             f"of q's shape on {q.device}")
        _check_aligned(name, t)
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous float32 (B, H, S) tensor")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if B * H * S == 0:
        return dq, dk, dv
    # the rows' D = rowsum(dO O) (float32 reads the first B H S values);
    # bf16 keeps there lse log2 e and D, rows padded to whole 64-row tiles
    # for the kernels' 16-byte bulk copies, the padding 0
    s_pad = -(-S // 64) * 64
    dsum = torch.zeros(2 * B * H * s_pad, dtype=torch.float32,
                       device=q.device)
    lib = build.load("flash_attention_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B * H, S, D,
            0 if window is None else window, _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a hand-written gradient: the kernels on CUDA tensors,
    the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, window), None
        else:
            out, lse = flash_attention_fwd(q, k, v, window)
        ctx.window = window
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        if q.device.type == "cpu":
            grads = flash_attention_bwd_plain(q, k, v, out, do, ctx.window)
        else:
            grads = flash_attention_bwd(q, k, v, out, lse, do, ctx.window)
        return (*grads, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: Optional[int] = None) -> torch.Tensor:
    """(B, H, S, D) -> (B, H, S, D) causal attention in the input dtype.

    CUDA tensors launch the hand-written kernel on the current stream (and
    add one to ``flash_attention.launches``); CPU tensors run the plain
    version. Anything else raises, and so does a head dim the kernel does
    not take. Differentiable through ``FlashAttentionFn`` when grad is
    enabled and an input requires it."""
    _check(q, k, v, window)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                         f"not {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window)
    return flash_attention_fwd(q, k, v, window, with_lse=False)[0]


flash_attention.launches = 0
