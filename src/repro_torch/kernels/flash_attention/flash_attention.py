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
   takes ``D in {64, 128}`` and any S: unlike the TPU kernel
   (``S % 128 == 0``) it masks the ragged tail itself. One block per
   (batch x head, 64-query tile) loops over 64-key tiles with the online
   softmax (running max, normaliser and accumulator in float32 registers),
   skipping tiles above the causal diagonal and tiles wholly outside the
   window. It computes on CUDA cores in float32 whatever the input type,
   so it is bound by operations: ``4 D`` flops per visible (query, key)
   pair over the card's rate for the input type.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_SIGNATURES = {"flash_attention_launch": (
    [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [ctypes.c_int]
    + [ctypes.c_void_p], ctypes.c_int)}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          window: Optional[int] = None) -> torch.Tensor:
    """Masked softmax attention in torch ops, on any device."""
    s = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


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
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: Optional[int] = None) -> torch.Tensor:
    """(B, H, S, D) -> (B, H, S, D) causal attention in the input dtype.

    CUDA tensors launch the hand-written kernel on the current stream (and
    add one to ``flash_attention.launches``); CPU tensors run the plain
    version. Anything else raises, and so does a head dim the kernel does
    not take."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                         f"not {q.device}")
    B, H, S, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {D}")
    out = torch.empty_like(q)
    if B * H * S == 0:
        return out
    lib = build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B * H, S, D, 0 if window is None else window, _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
