"""The fused fleet window: one window's plan, admission and execution as
one launch.

Counterpart of ``repro.core.fused_window``. The unfused fleet loop
(``core.fleet.serve_fleet``) pays, every window, for up to four solver
rungs (each with its ``InferProblem``s and ``Solution``s built on the
host), a per-device admission loop on the host and a ``simulate_batch``
engine launch. ``fused_fleet_window`` runs all of it for every device as
one call of the wrapper ``fused_window`` (on ``"cuda"``
the hand-written kernel ``csrc/fused_window.cu``, one block per device; on
``"cpu"`` its plain version): the four masked ladder rungs, the
mode-switch charge from the previous window's mode ids, the deadline-drop
admission recurrence, the compaction of the admitted requests and the
batch-ready max-plus fold. The window's host inputs go to the device as
one float64 matrix and the results come back as one, so a window costs
one host-to-device copy, one launch and one device-to-host copy; the
grid's columns and its mode ids are uploaded once per grid and device.

Nothing is compiled per shape, so rows are not padded to powers of two.

Exactness: the ladder, the switch charge, the admission and the compaction
are bitwise the reference's NumPy tier (and its fused program); latencies
and the clocks after the window are in the engine's tolerance tier
(``docs/exactness.md``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.backend import (record_dispatch, resolve_backend,
                                      torch_device)
from repro_torch.core.grid_eval import ObservationGrid, device_grid_arrays
from repro_torch.kernels.fulcrum import fused_window as KF
from repro_torch.kernels.fulcrum.fused_window import fused_window


def grid_mode_ids(grid: ObservationGrid) -> np.ndarray:
    """Per-grid-entry power-mode ids (first-appearance order), memoized on
    the grid: the window compares these ints to charge mode switches (id
    equality is ``PowerMode`` equality)."""
    ids = grid.__dict__.get("_mode_ids")
    if ids is None:
        first: dict = {}
        ids = np.array([first.setdefault(pm, len(first))
                        for pm in grid.modes], np.int32)
        grid.__dict__["_mode_ids"] = ids
    return ids


def device_mode_ids(grid: ObservationGrid, device: torch.device
                    ) -> torch.Tensor:
    """``grid_mode_ids`` on ``device``, uploaded once per grid and device
    beside the grid's columns (``grid_eval.device_grid_arrays``)."""
    key = ("mode_ids", str(device))
    ids = grid._device_cols.get(key)
    if ids is None:
        ids = torch.from_numpy(grid_mode_ids(grid)).to(device)
        grid._device_cols[key] = ids
    return ids


def _grid_max_bs(grid: ObservationGrid) -> int:
    """The grid's largest batch size: the plain version's admission ring
    (a forming batch never holds more members than its bs) and the
    kernel's quotient tables (whole batch sizes up to it) are this long."""
    return int(grid.bs.max()) if grid.bs is not None and len(grid) else 1


def pack_window(ts, ps, pbud, bud, nominal, est, hi, clock0, live,
                prev_mode, eff_times: Sequence[np.ndarray],
                n_carry) -> np.ndarray:
    """The window's host inputs as one (K, N_IN + T) float64 matrix: each
    device's ``IN_FIELDS``, then its arrivals padded with ``+inf``."""
    K = len(eff_times)
    T = max((len(v) for v in eff_times), default=0)
    rows = np.full((K, KF.N_IN + T), np.inf)
    cols = dict(ts=ts, ps=ps, pbud=pbud, bud=bud, nominal=nominal, est=est,
                hi=hi, clock0=clock0, live=live, prev_mode=prev_mode,
                n_times=[len(v) for v in eff_times], n_carry=n_carry)
    for i, f in enumerate(KF.IN_FIELDS):
        rows[:, i] = np.asarray(cols[f], np.float64)
    for d, v in enumerate(eff_times):
        rows[d, KF.N_IN:KF.N_IN + len(v)] = v
    return rows


def unpack_window(out: np.ndarray) -> dict:
    """The per-device arrays of one window's (K, N_OUT + 2 T) result."""
    T = (out.shape[1] - KF.N_OUT) // 2
    res = {f: out[:, i] for i, f in enumerate(KF.OUT_FIELDS)}
    res["solved"] = res["solved"] != 0.0
    for f in ("sel", "mode_id", "n_rej", "n_carry_rej", "n_adm",
              "n_batches", "rung", "rungs"):
        res[f] = res[f].astype(np.int64)
    res["adm_times"] = out[:, KF.N_OUT:KF.N_OUT + T]
    res["latencies"] = out[:, KF.N_OUT + T:]
    return res


def fused_fleet_window(grid: ObservationGrid, ts: np.ndarray, ps: np.ndarray,
                       pbud: np.ndarray, bud: np.ndarray, nominal: np.ndarray,
                       est: np.ndarray, hi: np.ndarray, live: np.ndarray,
                       prev_mode: np.ndarray,
                       eff_times: Sequence[np.ndarray],
                       n_carry: np.ndarray, clock0: np.ndarray,
                       switch_cost: float, adm_budget: float, trims: bool,
                       backend: Optional[str] = None) -> dict:
    """Run one fleet window fused: plan ladder, admission and engine as one
    launch over the K devices, on ``backend`` (``"cuda"`` by default, or
    ``"cpu"``).

    ``eff_times[d]`` is device d's effective arrival vector ``[carried
    pending, dispatched window arrivals]``, ``n_carry[d]`` its pending
    prefix length, ``clock0[d]`` the pre-switch engine clock ``max(carry
    clock, t0)``, ``prev_mode[d]`` the mode id it committed to last (-1:
    none). Returns per-device NumPy arrays: the selection (``solved`` /
    ``sel`` / ``lam`` / ``power`` / ``mode_id``, and ``rung`` / ``rungs``),
    the mode-switch charge and the clock after it (``switch`` /
    ``clock_in``), the admission account (``n_rej`` / ``n_carry_rej``), and
    the execution over the admitted requests (``adm_times`` padded with
    +inf, ``n_adm``, ``n_batches``, ``latencies`` padded with +inf,
    ``clock_out``). Only a solved device's entries mean anything."""
    dev = torch_device(resolve_backend(backend))
    rows = pack_window(ts, ps, pbud, bud, nominal, est, hi, clock0, live,
                       prev_mode, eff_times, n_carry)
    t, p, bsf = device_grid_arrays(grid, dev)
    record_dispatch("fused")
    out = fused_window(t, p, bsf, device_mode_ids(grid, dev),
                          torch.from_numpy(rows).to(dev), float(switch_cost),
                          float(adm_budget), bool(trims), _grid_max_bs(grid))
    return unpack_window(out.cpu().numpy())
