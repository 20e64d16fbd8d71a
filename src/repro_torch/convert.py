"""Carry the reference's state and weights into the port's objects.

What crosses from a run of the JAX package (or from a saved run) is plain
data: workload profiles, power modes, arrival-trace times and queue states
for the plan-and-execute path, model parameters for the model substrate,
the optimizer state for training, and the NN predictor's initial weights.
Each converter takes that data as plain fields, NumPy arrays and nested
dicts, never as the reference's objects, so the port stays free of the
``repro`` package;
``dataclasses.asdict`` of a reference object gives exactly the fields
these take, ``jax.tree.map(np.asarray, params)`` a parameter tree
``model_params`` takes, and ``jax.tree.map(np.asarray, opt_state)`` an
optimizer state ``opt_state`` takes. The tests feed both packages
identical inputs through here.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.device_model import WorkloadProfile
from repro_torch.core.powermode import PowerMode
from repro_torch.core.simulate import ArrivalTrace, QueueState
from repro_torch.models.model import ModelConfig


def workload_profile(fields: Mapping) -> WorkloadProfile:
    """A workload profile from its fields (name, kind, work terms, power)."""
    return WorkloadProfile(**dict(fields))


def power_mode(fields: Mapping) -> PowerMode:
    """A power mode from its (cores, cpuf, gpuf, memf) fields."""
    return PowerMode(**{k: int(v) for k, v in dict(fields).items()})


def arrival_trace(times: np.ndarray, duration: float, kind: str = "uniform",
                  stream_ids: Optional[np.ndarray] = None,
                  n_streams: Optional[int] = None) -> ArrivalTrace:
    """An arrival trace over the given float64 timestamps (copied); a
    merged multi-tenant trace also carries each request's stream id and
    the stream count."""
    ids = None if stream_ids is None else np.array(stream_ids, np.int64)
    return ArrivalTrace(np.array(times, np.float64), float(duration), kind,
                        ids, None if n_streams is None else int(n_streams))


def queue_state(pending: np.ndarray, clock: float = 0.0,
                stream_ids: Optional[np.ndarray] = None) -> QueueState:
    """A window-boundary queue state: pending arrival times, the clock and,
    for a multi-tenant window, each pending request's stream id."""
    ids = None if stream_ids is None else np.array(stream_ids, np.int64)
    return QueueState(np.array(pending, np.float64), float(clock), ids)


def _tensors(tree: Any, device) -> Any:
    if isinstance(tree, Mapping):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def model_params(tree: Mapping, cfg: ModelConfig, device=None) -> dict:
    """The port's parameters from a reference parameter tree given as
    nested dicts of NumPy arrays (same names and layouts). The reference
    stacks the per-layer params on a leading axis of length
    ``cfg.num_layers``; the port keeps them as a list of per-layer dicts."""
    params = _tensors(tree, device)
    stacked = params["layers"]

    def layer(i: int, t: Any) -> Any:
        if isinstance(t, dict):
            return {k: layer(i, v) for k, v in t.items()}
        if t.shape[0] != cfg.num_layers:
            raise ValueError(f"stacked layer param has leading axis "
                             f"{t.shape[0]}, config has {cfg.num_layers} "
                             f"layers")
        return t[i]

    params["layers"] = [layer(i, stacked) for i in range(cfg.num_layers)]
    return params


def opt_state(tree: Mapping, cfg: ModelConfig, device=None) -> dict:
    """The port's AdamW state from the reference's, given as nested dicts of
    NumPy arrays: ``m``, ``v`` (and ``master``, if present) are parameter
    trees converted by ``model_params``; ``step`` becomes an int32
    scalar."""
    out = {k: model_params(tree[k], cfg, device)
           for k in ("m", "v", "master") if k in tree}
    out["step"] = torch.tensor(int(np.asarray(tree["step"])),
                               dtype=torch.int32, device=device)
    return out


def nn_params(tree) -> list:
    """The NN predictor's initial parameters (``core.nn_model``) from the
    reference's: one ``{"w", "b"}`` of arrays per layer, ``w`` of shape
    (in, out). Returns float32 CPU tensors, as ``_init_params`` does."""
    return [{k: torch.from_numpy(np.array(layer[k], np.float32))
             for k in ("w", "b")} for layer in tree]
