"""Hardware constants of the port's target, the NVIDIA H100 SXM, for the
roofline of ``core.gpu_adapter`` and the dry run's analytic model.

Counterpart of ``repro.launch.mesh``, whose v5e constants these names
follow: ``PEAK_FLOPS_BF16``, ``HBM_BW``, ``ICI_BW`` and ``HBM_BYTES`` hold
the H100's figures (data sheet), and ``Hardware`` bundles them so a caller
can pass another card's (the tests pass the reference's v5e numbers).

The mesh constructors, ``make_production_mesh`` and ``make_host_mesh``,
wait for the pod layer's second half (ROADMAP queue 1 item 8b), with the
DTensor placements and the sharded steps.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM hardware constants (per card), from the data sheet.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12                  # bytes/s, HBM3
ICI_BW = 450e9                    # bytes/s, NVLink 4: 900 GB/s per card
                                  # both ways, this is one direction
HBM_BYTES = 80e9                  # 80 GB of HBM3 per card


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One accelerator's roofline constants (per chip or card)."""
    peak_flops_bf16: float        # FLOP/s
    hbm_bw: float                 # bytes/s
    ici_bw: float                 # bytes/s of the chip-to-chip links
    hbm_bytes: float              # device memory, bytes


H100 = Hardware(PEAK_FLOPS_BF16, HBM_BW, ICI_BW, HBM_BYTES)
