"""Pareto-front utilities over (power, time) trade-off points.

Vectorized on the grid-evaluation engine's conventions: stable lexsort +
cumulative-min instead of a Python scan. Semantics are identical to the
scalar reference — stable sort by (power, signed objective), keep entries
that strictly improve the running best, first occurrence wins on ties.
NaN objectives never win (``front_lookup`` prefers a finite-objective
feasible entry over a NaN one).

The port's own copy of ``repro.core.pareto``, kept line for line: host
NumPy, bitwise the reference (the same keys, in the same order).
"""
from __future__ import annotations

from typing import Hashable

import numpy as np


def pareto_front(points: dict, lower_is_better: bool = True) -> dict:
    """points: {key: (power, objective)}. Returns the subset on the Pareto
    front: least objective for any power (and vice versa). For objectives
    where higher is better (throughput), pass lower_is_better=False."""
    if not points:
        return {}
    sign = 1.0 if lower_is_better else -1.0
    keys = list(points)
    pw = np.fromiter((points[k][0] for k in keys), np.float64, len(keys))
    obj = sign * np.fromiter((points[k][1] for k in keys), np.float64, len(keys))
    order = np.lexsort((obj, pw))        # stable: by power, then signed obj
    o = obj[order]
    # NaN objectives never enter the front (NaN < x is False, as in the
    # scalar loop) and must not poison the running minimum for later points
    o_min = np.where(np.isnan(o), np.inf, o)
    prev_best = np.concatenate(([np.inf], np.minimum.accumulate(o_min)[:-1]))
    front: dict = {}
    for i in order[o < prev_best]:       # strict improvement only
        k = keys[i]
        front[k] = points[k]
    return front


def on_front(points: dict, key: Hashable, lower_is_better: bool = True) -> bool:
    return key in pareto_front(points, lower_is_better)


def front_lookup(front: dict, power_budget: float,
                 lower_is_better: bool = True):
    """Best front entry with power <= budget. Returns (key, (p, obj)) or None."""
    if not front:
        return None
    sign = 1.0 if lower_is_better else -1.0
    keys = list(front)
    pw = np.fromiter((front[k][0] for k in keys), np.float64, len(keys))
    obj = sign * np.fromiter((front[k][1] for k in keys), np.float64, len(keys))
    feas = pw <= power_budget
    if not feas.any():
        return None
    masked = np.where(feas & ~np.isnan(obj), obj, np.inf)
    i = int(np.argmin(masked))
    if not np.isfinite(masked[i]):  # every feasible objective is inf/NaN:
        i = int(np.argmax(feas))    # keep the first feasible entry
    k = keys[i]
    return (k, front[k])
