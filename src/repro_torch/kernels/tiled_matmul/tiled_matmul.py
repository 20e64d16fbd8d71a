"""Tiled matrix product: the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces the Pallas kernel ``repro/kernels/tiled_matmul/tiled_matmul.py::
tiled_matmul`` (body ``_mm_kernel``), reached through the entry point
``kernels.ops.tiled_matmul``. No model path calls it: the model's products
stay ``torch.matmul``, as the reference's are ``jnp.einsum``.

Contract (``repro/kernels/tiled_matmul/ref.py::matmul_ref``): ``a`` (M, K)
and ``b`` (K, N) of one dtype, bf16 or float32; the product is summed in
float32 and returned in the input dtype. The reference's ``block_m``,
``block_n`` and ``block_k`` are TPU tiling, not part of the function, and
are not taken.

 * ``tiled_matmul_plain`` is ``a.float() @ b.float()`` cast back, for any
   shape and device (run it with TF32 off for float32 comparisons).
 * ``tiled_matmul`` launches ``csrc/tiled_matmul.cu`` for CUDA tensors and
   takes the plain version only for CPU tensors, for any M, N, K, by one
   of three routes that ``route`` picks from dtype, shape and pointer
   alignment before the launch (a route is never a retry after a failure):

   - ``"tma"``: bf16 with both pointers 16-byte aligned and K and N
     multiples of 8, so that every row of ``a`` and ``b`` starts on 16
     bytes, as a TMA tensor map needs (the launcher refuses any other K
     or N). 128 x 256 output tiles, a 4-stage
     ring of 64-deep K steps filled by TMA, ``wgmma`` on two consumer
     warpgroups; boxes past the edges load as zeros.
   - ``"mma_sync"``: any other bf16 input, through ``mma.sync`` with a
     128 x 128 tile per block.
   - ``"float32"``: CUDA cores in float32, without TF32.

   It is bound by operations: ``2 M N K`` flops. ``tiled_matmul.launches``
   counts launches, ``tiled_matmul.routes`` counts them by route.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
# the launcher's code of each route
ROUTES = {"float32": 0, "mma_sync": 1, "tma": 2}

_SIGNATURES = {"tiled_matmul_launch": (
    [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_int]
    + [ctypes.c_void_p], ctypes.c_int)}


def tiled_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` summed in float32, in the input dtype, on any device."""
    return (a.float() @ b.float()).to(a.dtype)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    """Raise on inputs the kernel does not take."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"need a (M, K) and b (K, N), got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    for name, x in (("a", a), ("b", b)):
        if x.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b.dtype != a.dtype:
        raise TypeError(f"b is {b.dtype}, a is {a.dtype}")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")


def route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel route for ``a @ b`` (inputs that ``_check`` takes): a
    pure function of dtype, shape and pointer alignment, on any device.
    ``"tma"`` needs every row of ``a`` and ``b`` to start on 16 bytes: the
    inputs are contiguous, so aligned base pointers and K and N multiples
    of 8 bf16 values. A one-row ``a`` counts as contiguous whatever its
    row stride, so the rule reads the shape, never the strides."""
    if a.dtype == torch.float32:
        return "float32"
    K, N = b.shape
    rows_16 = (K % 8 == 0 and N % 8 == 0
               and all(x.data_ptr() % 16 == 0 for x in (a, b)))
    return "tma" if rows_16 else "mma_sync"


def tiled_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) in the input dtype, float32-accumulated.

    CUDA tensors launch the hand-written kernel by ``route``'s route on the
    current stream (and add one to ``tiled_matmul.launches`` and to that
    route's count in ``tiled_matmul.routes``); CPU tensors run the plain
    version. Anything else raises."""
    _check(a, b)
    if a.device.type == "cpu":
        return tiled_matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"tiled_matmul runs on cuda or cpu tensors, "
                         f"not {a.device}")
    (M, K), N = a.shape, b.shape[1]
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M * N == 0:
        return c
    if K == 0:
        return c.zero_()
    way = route(a, b)
    lib = build.load("tiled_matmul", _SIGNATURES)
    with torch.cuda.device(a.device):
        err = lib.tiled_matmul_launch(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K, ROUTES[way],
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, f"tiled_matmul ({way})")
    tiled_matmul.launches += 1
    tiled_matmul.routes[way] += 1
    return c


tiled_matmul.launches = 0
tiled_matmul.routes = dict.fromkeys(ROUTES, 0)
