"""Execution approaches for concurrent training + inference (paper §3, Fig 2).

Thin wrappers over the trace-driven engine in ``core.simulate``, with the
reference's fixed-rate signature (counterpart of ``repro.core.interleave``):
 * managed   — Fulcrum's approach: explicit alternation at minibatch
   granularity; training only fills slack, so inference never queues
   behind it.
 * native    — GPU time-slicing at kernel granularity (heavy jitter).
 * streams   — space-sharing via priority streams (tail jitter).

``backend`` is the engine's (``"cuda"`` by default, or ``"cpu"``); call
``core.simulate.simulate`` directly for Poisson or piecewise traces.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.device_model import DeviceModel, WorkloadProfile
from repro_torch.core.powermode import PowerMode
from repro_torch.core.simulate import (ArrivalTrace, ExecutionReport,  # noqa: F401
                                       simulate)


def simulate_managed(device: DeviceModel, w_tr: Optional[WorkloadProfile],
                     w_in: WorkloadProfile, pm: PowerMode, bs: int,
                     arrival_rate: float, duration: float = 120.0,
                     backend: Optional[str] = None) -> ExecutionReport:
    """Fulcrum managed interleaving: one DNN at a time, switched at minibatch
    boundaries; training fills slack conservatively."""
    return simulate(device, w_tr, w_in, pm, bs,
                    ArrivalTrace.uniform(arrival_rate, duration),
                    approach="managed", backend=backend)


def simulate_native(device: DeviceModel, w_tr: WorkloadProfile,
                    w_in: WorkloadProfile, pm: PowerMode, bs: int,
                    arrival_rate: float, duration: float = 120.0,
                    seed: int = 0,
                    backend: Optional[str] = None) -> ExecutionReport:
    """Native kernel-level time-sharing: inference kernels contend with
    training kernels (~2x slowdown +- jitter)."""
    return simulate(device, w_tr, w_in, pm, bs,
                    ArrivalTrace.uniform(arrival_rate, duration),
                    approach="native", seed=seed, backend=backend)


def simulate_streams(device: DeviceModel, w_tr: WorkloadProfile,
                     w_in: WorkloadProfile, pm: PowerMode, bs: int,
                     arrival_rate: float, duration: float = 120.0,
                     seed: int = 0,
                     backend: Optional[str] = None) -> ExecutionReport:
    """CUDA-streams space sharing, inference on the high-priority stream."""
    return simulate(device, w_tr, w_in, pm, bs,
                    ArrivalTrace.uniform(arrival_rate, duration),
                    approach="streams", seed=seed, backend=backend)
