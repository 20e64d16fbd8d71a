"""Carry the plan-and-execute path's state into the port's objects.

This path has no learned weights. What crosses from a run of the JAX
package (or from a saved run) is state: workload profiles, power modes,
arrival-trace times and queue states. Each converter takes that state as
plain fields and NumPy arrays, never as the reference's objects, so the
port stays free of the ``repro`` package; ``dataclasses.asdict`` of a
reference object gives exactly the fields these take. The tests feed both
packages identical inputs through here.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from repro_torch.core.device_model import WorkloadProfile
from repro_torch.core.powermode import PowerMode
from repro_torch.core.simulate import ArrivalTrace, QueueState


def workload_profile(fields: Mapping) -> WorkloadProfile:
    """A workload profile from its fields (name, kind, work terms, power)."""
    return WorkloadProfile(**dict(fields))


def power_mode(fields: Mapping) -> PowerMode:
    """A power mode from its (cores, cpuf, gpuf, memf) fields."""
    return PowerMode(**{k: int(v) for k, v in dict(fields).items()})


def arrival_trace(times: np.ndarray, duration: float,
                  kind: str = "uniform") -> ArrivalTrace:
    """An arrival trace over the given float64 timestamps (copied)."""
    return ArrivalTrace(np.array(times, np.float64), float(duration), kind)


def queue_state(pending: np.ndarray, clock: float = 0.0) -> QueueState:
    """A window-boundary queue state: pending arrival times and the clock."""
    return QueueState(np.array(pending, np.float64), float(clock))
