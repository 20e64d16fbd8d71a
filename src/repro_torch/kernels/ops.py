"""Public wrappers that combine a kernel with the torch ops around it.

Counterpart of ``repro.kernels.ops``. ``ssd_scan`` is the full SSD scan of
a Mamba2 layer: the intra-chunk kernel (``ssd_scan.ssd_chunk``, K4) plus the
inter-chunk recurrence over the ``nc`` chunks and the off-diagonal term, in
torch ops (O(nc) small steps); its gradient runs through torch autograd,
with the kernel's own backward for the intra-chunk part. ``tiled_matmul``
is the entry point of the tiled-matmul kernel (K5). The attention kernel
needs no wrapper: the model calls ``flash_attention`` directly.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.ssd_scan import chunk_cumsum, ssd_chunk
# the entry point of K5 (the reference's ``block_*`` arguments are TPU
# tiling and are not taken)
from repro_torch.kernels.tiled_matmul.tiled_matmul import \
    tiled_matmul  # noqa: F401


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor) -> tuple[torch.Tensor,
                                                        torch.Tensor]:
    """Full SSD scan, float32. x: (b, nc, l, h, p); dt: (b, nc, l, h);
    A: (h,); B, C: (b, nc, l, n) (one group). Returns y (b, nc, l, h, p)
    and the final state (b, h, p, n) — the SSM cache's layout, transposed
    once from the kernel's (n, p) chunk states."""
    b, nc, l, h, p = x.shape
    dA = (dt * A[None, None, None, :]).contiguous()
    y_diag, states = ssd_chunk(x.contiguous(), dA, dt.contiguous(),
                               B.contiguous(), C.contiguous())
    dA_cs = chunk_cumsum(dA)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])            # (b, nc, h)
    carry = states.new_zeros((b, h, states.shape[3], p))    # (b, h, n, p)
    prev = []
    for c in range(nc):                                    # state entering c
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                        # (b, nc, h, n, p)
    state_decay = torch.exp(dA_cs)                         # (b, nc, l, h)
    y_off = torch.einsum("bcln,bchnp,bclh->bclhp", C, prev, state_decay)
    return y_diag + y_off, carry.transpose(-1, -2)
