"""Vectorized grid evaluation (the 273k-config sweep substrate), on torch.

Counterpart of ``repro.core.grid_eval``. The paper's evaluation solves every
(power budget, latency budget, arrival rate) triple against the observed
441-mode x 5-batch-size profile grid; this module does it in two steps:

 * ``materialize`` builds the device model as dense ``(cores, cpuf, gpuf,
   memf[, bs])`` time/power tensors per workload on the host, in NumPy, as
   the reference does — perturbations are computed once per axis value and
   every ``**`` on an axis value is a Python scalar ``**`` (NumPy's SIMD
   ``pow`` can differ from libm by 1 ulp), so the grid is bitwise the
   reference's;
 * ``ObservationGrid`` is a flat columnar view of an observation set (dense
   grid or any ``{pm: (t, p)}`` / ``{(pm, bs): (t, p)}`` dict);
 * ``solve_train_batch``, ``solve_infer_batch``, ``solve_concurrent_batch``,
   ``solve_infer_fleet_batch`` and ``solve_multi_tenant_batch`` solve a
   whole batch of problems as float64 masked argmin / argmax reductions in
   torch on the backend's device (``"cuda"`` by default, or ``"cpu"``),
   chunked by ``CHUNK_ELEMS`` problems x observations to bound memory.
   Their expressions are the reference's jax kernels', one op at a time.

Exactness contract: on either backend every returned solution is bitwise
the reference's NumPy tier's (and so the scalar ``problem.solve_*``
loops'). A masked argmin / argmax reassociates nothing: each element is
the same chain of correctly rounded IEEE-754 operations (``+ - * /``,
``floor``, comparisons), each a torch op of its own so that nothing fuses
``a * b + c`` into an FMA; ``torch.argmin`` returns the first occurrence
of the minimum, which is the scalar loops' first-strict-improvement rule;
and the multi-tenant ``busy`` / ``total`` sums run in stream order.
``tests/test_torch_grid_eval.py`` holds this against the reference.

A grid's columns are uploaded once per grid and device
(``device_grid_arrays``); every chunk is one batch of device work and
counts one ``"solver"`` dispatch.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import problem as P
from repro_torch.core.backend import (record_dispatch, resolve_backend,
                                      torch_device)
from repro_torch.core.device_model import (MAX_CORES, MAX_CPUF, MAX_GPUF,
                                           MAX_MEMF, DeviceModel,
                                           WorkloadProfile, _pert)
from repro_torch.core.powermode import PowerMode, PowerModeSpace

# Cap on problems x observations elements held per solver chunk. Each chunk
# materializes a handful of float64 (K, N) temporaries, so 4M elements keeps
# peak memory in the low hundreds of MB even for the concurrent solver.
CHUNK_ELEMS = 4 << 20

_INF = float("inf")


# ---------------------------------------------------------------------------
# columnar observation sets
# ---------------------------------------------------------------------------

class ObservationGrid:
    """Flat columnar view of an observation set, in iteration order.

    ``bs`` is None for training-style grids ({pm: (t, p)}) and an int array
    for inference-style grids ({(pm, bs): (t, p)}).
    """

    def __init__(self, modes: list, t: np.ndarray, p: np.ndarray,
                 bs: Optional[np.ndarray] = None):
        self.modes = modes
        self.t = np.ascontiguousarray(t, dtype=np.float64)
        self.p = np.ascontiguousarray(p, dtype=np.float64)
        self.bs = None if bs is None else np.ascontiguousarray(bs, np.int64)
        self._index: Optional[dict] = None
        self._device_cols: dict = {}   # device -> uploaded (t, p, bs) columns

    def __len__(self) -> int:
        return len(self.modes)

    def key(self, i: int):
        if self.bs is None:
            return self.modes[i]
        return (self.modes[i], int(self.bs[i]))

    @property
    def index(self) -> dict:
        """{key: flat position}; first occurrence wins on duplicates."""
        if self._index is None:
            idx: dict = {}
            for i in range(len(self.modes)):
                idx.setdefault(self.key(i), i)
            self._index = idx
        return self._index

    def lookup(self, pm: PowerMode, bs: Optional[int] = None) -> tuple[float, float]:
        i = self.index[pm if self.bs is None else (pm, bs)]
        return float(self.t[i]), float(self.p[i])

    def to_dict(self) -> dict:
        return {self.key(i): (float(self.t[i]), float(self.p[i]))
                for i in range(len(self.modes))}

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_train_dict(cls, obs: dict) -> "ObservationGrid":
        modes = list(obs)
        t = np.fromiter((obs[k][0] for k in modes), np.float64, len(modes))
        p = np.fromiter((obs[k][1] for k in modes), np.float64, len(modes))
        return cls(modes, t, p)

    @classmethod
    def from_infer_dict(cls, obs: dict) -> "ObservationGrid":
        keys = list(obs)
        modes = [pm for pm, _ in keys]
        bs = np.fromiter((b for _, b in keys), np.int64, len(keys))
        t = np.fromiter((obs[k][0] for k in keys), np.float64, len(keys))
        p = np.fromiter((obs[k][1] for k in keys), np.float64, len(keys))
        return cls(modes, t, p, bs)


def as_train_grid(obs: Union[dict, ObservationGrid]) -> ObservationGrid:
    return obs if isinstance(obs, ObservationGrid) else \
        ObservationGrid.from_train_dict(obs)


def as_infer_grid(obs: Union[dict, ObservationGrid]) -> ObservationGrid:
    return obs if isinstance(obs, ObservationGrid) else \
        ObservationGrid.from_infer_dict(obs)


def cached_grid(owner, attr: str, obs: dict, kind: str) -> ObservationGrid:
    """Memoize the columnar view of ``obs`` on ``owner.<attr>`` so repeated
    queries against a fitted strategy reuse the flattening and the grid's
    uploaded columns. Invalidated when the observation count changes —
    sufficient for profiler-backed strategies, whose caches only grow; a
    strategy that *replaces* observations wholesale must also reset
    ``owner.<attr>`` to None on refit."""
    cache = getattr(owner, attr, None)
    if cache is None or cache[0] != len(obs):
        grid = (ObservationGrid.from_train_dict(obs) if kind == "train"
                else ObservationGrid.from_infer_dict(obs))
        cache = (len(obs), grid)
        setattr(owner, attr, cache)
    return cache[1]


def device_grid_arrays(grid: ObservationGrid, device: torch.device) -> tuple:
    """The grid's ``(t, p, bs as float64)`` columns on ``device`` (``bs`` is
    None for a training grid), uploaded once per grid and device and
    memoized on the grid, so a sweep's chunks and a fleet's four solves per
    window reuse one copy."""
    key = str(device)
    cols = grid._device_cols.get(key)
    if cols is None:
        bsf = None if grid.bs is None else \
            torch.from_numpy(grid.bs.astype(np.float64)).to(device)
        cols = (torch.from_numpy(grid.t).to(device),
                torch.from_numpy(grid.p).to(device), bsf)
        grid._device_cols[key] = cols
    return cols


# ---------------------------------------------------------------------------
# dense device-model tensors (host NumPy, as in the reference)
# ---------------------------------------------------------------------------

def _axis_pert(name: str, dim: str, values: Sequence[int],
               scale: float = 0.05) -> np.ndarray:
    return np.array([_pert(name, dim, v, scale) for v in values])


def _dense_closed_form(w: WorkloadProfile, space: PowerModeSpace,
                       bs_eff: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Replay DeviceModel.time_power's expression tree over the full
    (cores, cpuf, gpuf, memf, bs) grid. Elementwise ops on float64 are the
    same IEEE-754 operations the scalar path performs, so the result is
    bitwise identical per grid point."""
    cores_i = space.values["cores"]
    cpuf_i = space.values["cpuf"]
    gpuf_i = space.values["gpuf"]
    memf_i = space.values["memf"]
    gpuf = np.asarray(gpuf_i, np.float64)[None, None, :, None]
    memf = np.asarray(memf_i, np.float64)[None, None, None, :]

    pert_gpuf = _axis_pert(w.name, "gpuf", gpuf_i)[None, None, :, None]
    pert_cpuf = _axis_pert(w.name, "cpuf", cpuf_i)[None, :, None, None]
    pert_cores = _axis_pert(w.name, "cores", cores_i)[:, None, None, None]
    pert_memf = _axis_pert(w.name, "memf", memf_i)[None, None, None, :]
    # power perturbation keys mix (gpuf, cpuf, memf): one hash per combination
    pert_power = np.empty((1, len(cpuf_i), len(gpuf_i), len(memf_i)))
    for j, cf in enumerate(cpuf_i):
        for k, gf in enumerate(gpuf_i):
            for m, mf in enumerate(memf_i):
                pert_power[0, j, k, m] = _pert(
                    w.name, "power", gf * 31 + cf * 7 + mf, 0.015)

    # pow() per axis value with Python scalar math: NumPy's SIMD pow can
    # differ from libm by 1 ulp, which would break bitwise identity with the
    # scalar path. The remaining +,*,/ are correctly rounded either way.
    cpuf_pow = np.array([(v / MAX_CPUF) ** 0.9 for v in cpuf_i])[None, :, None, None]
    cores_pow = np.array([(min(c, w.cpu_parallelism) / w.cpu_parallelism) ** 0.7
                          for c in cores_i])[:, None, None, None]
    gpu_s = (gpuf / MAX_GPUF) * pert_gpuf
    cpu_s = cpuf_pow * cores_pow * pert_cpuf * pert_cores
    mem_s = (memf / MAX_MEMF) * pert_memf

    # trailing bs axis
    t_gpu = (w.gpu_fixed + w.gpu_per_sample * bs_eff) / gpu_s[..., None]
    t_cpu = (w.cpu_fixed + w.cpu_per_sample * bs_eff) / cpu_s[..., None]
    t_mem = (w.mem_fixed + w.mem_per_sample * bs_eff) / mem_s[..., None]
    t = t_gpu + t_cpu + t_mem

    util = bs_eff / (bs_eff + w.util_half_bs)
    f_gpu, f_cpu, f_mem = t_gpu / t, t_cpu / t, t_mem / t
    f_gpu_power = np.array([(v / MAX_GPUF) ** 1.3
                            for v in gpuf_i])[None, None, :, None]
    f_cpu_power = (np.array([(c / MAX_CORES) ** 0.8
                             for c in cores_i])[:, None, None, None]
                   * np.array([(v / MAX_CPUF) ** 1.3
                               for v in cpuf_i])[None, :, None, None])
    mem_power = np.array([(v / MAX_MEMF) ** 1.1
                          for v in memf_i])[None, None, None, :]
    p = (w.p_idle
         + w.p_gpu * (0.35 + 0.65 * util) * f_gpu_power[..., None] * (0.4 + 0.6 * f_gpu)
         + w.p_cpu * f_cpu_power[..., None] * (0.5 + 0.5 * f_cpu)
         + w.p_mem * mem_power[..., None] * (0.5 + 0.5 * f_mem))
    p = p * pert_power[..., None]
    return t, p


def materialize(device: DeviceModel, w: WorkloadProfile, space: PowerModeSpace,
                batch_sizes: Optional[Sequence[int]] = None) -> ObservationGrid:
    """Dense ground-truth grid for one workload: every mode in ``space``
    (x every batch size, for inference grids). Flattening follows
    ``space.all_modes()`` mode-major / bs-minor order — exactly the insertion
    order of the scalar oracle's observation dicts."""
    modes = space.all_modes()
    if type(device) is DeviceModel and isinstance(modes[0], PowerMode):
        if batch_sizes is None:
            bs_eff = np.array([float(w.train_bs)])
        else:
            bs_eff = np.array([float(b) for b in batch_sizes])
        t, p = _dense_closed_form(w, space, bs_eff)
        t = t.reshape(len(modes), -1)
        p = p.reshape(len(modes), -1)
    else:
        # another device model (a subclass): one scalar call per grid point
        # — still a one-off, amortized over every problem solved against it
        bss = [None] if batch_sizes is None else list(batch_sizes)
        t = np.empty((len(modes), len(bss)))
        p = np.empty((len(modes), len(bss)))
        for i, pm in enumerate(modes):
            for j, b in enumerate(bss):
                t[i, j], p[i, j] = device.time_power(w, pm, b)
    if batch_sizes is None:
        return ObservationGrid(modes, t[:, 0], p[:, 0])
    B = t.shape[1]
    flat_modes = [pm for pm in modes for _ in range(B)]
    bs = np.tile(np.asarray(batch_sizes, np.int64), len(modes))
    return ObservationGrid(flat_modes, t.reshape(-1), p.reshape(-1), bs)


# ---------------------------------------------------------------------------
# batched solvers: masked reductions in torch, one chunk of problems at a time
# ---------------------------------------------------------------------------

def _chunks(n_problems: int, n_obs: int):
    step = max(1, CHUNK_ELEMS // max(n_obs, 1))
    for s in range(0, n_problems, step):
        yield s, min(n_problems, s + step)


def _problem_cols(problems, *fields) -> list[np.ndarray]:
    return [np.fromiter((getattr(pr, f) for pr in problems),
                        np.float64, len(problems)) for f in fields]


def _upload(dev: torch.device, *cols: np.ndarray) -> list[torch.Tensor]:
    """Host problem columns as float64 tensors on ``dev``, in one copy."""
    stacked = torch.from_numpy(np.stack(cols)).to(dev)
    return list(stacked.unbind(0))


def _fetch(*xs: torch.Tensor) -> list[np.ndarray]:
    """Per-problem results back on the host."""
    return [x.cpu().numpy() for x in xs]


def _pick(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row k's entry at column ``idx[k]`` of a (problems, entries) tensor."""
    return x.gather(1, idx[:, None])[:, 0]


def solve_train_batch(problems: Sequence[P.TrainProblem],
                      obs: Union[dict, ObservationGrid],
                      backend: Optional[str] = None
                      ) -> list[Optional[P.Solution]]:
    """Batched ``problem.solve_train``: argmax theta_tr s.t. p <= p-hat for
    every problem at once (the reference's ``train_kernel``)."""
    backend = resolve_backend(backend)
    grid = as_train_grid(obs)
    out: list[Optional[P.Solution]] = [None] * len(problems)
    if not len(grid) or not len(problems):
        return out
    dev = torch_device(backend)
    t, p, _ = device_grid_arrays(grid, dev)
    budgets, = _problem_cols(problems, "power_budget")
    for s, e in _chunks(len(problems), len(grid)):
        record_dispatch("solver")
        b, = _upload(dev, budgets[s:e])
        feas = p[None, :] <= b[:, None]
        idx = torch.where(feas, t[None, :], _INF).argmin(dim=1)
        idx, ok = _fetch(idx, feas.any(dim=1))
        for k in np.flatnonzero(ok):
            i = int(idx[k])
            tk = float(grid.t[i])
            out[s + k] = P.Solution(pm=grid.modes[i], time=tk,
                                    power=float(grid.p[i]),
                                    throughput=1.0 / tk)
    return out


def solve_infer_batch(problems: Sequence[P.InferProblem],
                      obs: Union[dict, ObservationGrid],
                      backend: Optional[str] = None
                      ) -> list[Optional[P.Solution]]:
    """Batched ``problem.solve_infer``: argmin peak latency s.t. power,
    latency, and sustainability constraints, over a batch of problems (the
    reference's ``infer_kernel``)."""
    backend = resolve_backend(backend)
    grid = as_infer_grid(obs)
    out: list[Optional[P.Solution]] = [None] * len(problems)
    if not len(grid) or not len(problems):
        return out
    dev = torch_device(backend)
    t, p, bsf = device_grid_arrays(grid, dev)
    pb, lb, ar = _problem_cols(problems, "power_budget", "latency_budget",
                               "arrival_rate")
    for s, e in _chunks(len(problems), len(grid)):
        record_dispatch("solver")
        b_p, b_l, b_a = _upload(dev, pb[s:e], lb[s:e], ar[s:e])
        lam = (bsf[None, :] - 1.0) / b_a[:, None] + t[None, :]
        feas = ((p[None, :] <= b_p[:, None])
                & (t[None, :] <= bsf[None, :] / b_a[:, None])
                & (lam <= b_l[:, None]))
        idx = torch.where(feas, lam, _INF).argmin(dim=1)
        idx, ok, lam_sel = _fetch(idx, feas.any(dim=1), _pick(lam, idx))
        for k in np.flatnonzero(ok):
            i = int(idx[k])
            out[s + k] = P.Solution(pm=grid.modes[i], bs=int(grid.bs[i]),
                                    time=float(lam_sel[k]),
                                    power=float(grid.p[i]))
    return out


def solve_infer_fleet_batch(problems: Sequence[P.InferProblem],
                            rate_his: Sequence[float],
                            obs: Union[dict, ObservationGrid],
                            time_scales: Sequence[float],
                            power_scales: Sequence[float],
                            backend: Optional[str] = None
                            ) -> list[Optional[P.Solution]]:
    """Batched ``problem.solve_infer_interval`` across K heterogeneous
    devices sharing one *base* observation grid: device k's grid is the base
    grid scaled elementwise by its ``(time_scales[k], power_scales[k])``
    (the ``PerturbedDeviceModel`` law — the same IEEE multiply as profiling
    the device point by point). Row k solves ``problems[k]`` against device
    k: sustainability at ``max(rate_his[k], arrival_rate)``, latency budget
    and objective at the problem's (low-end) rate. Every problem column —
    ``power_budget`` included — is per row, which is how a fleet's
    water-filled power grants thread through (the reference's
    ``fleet_kernel``)."""
    backend = resolve_backend(backend)
    grid = as_infer_grid(obs)
    out: list[Optional[P.Solution]] = [None] * len(problems)
    if not len(grid) or not len(problems):
        return out
    n = len(problems)
    if not (len(rate_his) == len(time_scales) == len(power_scales) == n):
        raise ValueError("rate_his / time_scales / power_scales must align "
                         "with the problems")
    dev = torch_device(backend)
    t, p, bsf = device_grid_arrays(grid, dev)
    pb, lb, ar = _problem_cols(problems, "power_budget", "latency_budget",
                               "arrival_rate")
    hi = np.maximum(np.asarray(rate_his, np.float64), ar)
    ts = np.asarray(time_scales, np.float64)
    ps = np.asarray(power_scales, np.float64)
    for s, e in _chunks(n, len(grid)):
        record_dispatch("solver")
        b_p, b_l, b_a, b_h, k_t, k_p = _upload(
            dev, pb[s:e], lb[s:e], ar[s:e], hi[s:e], ts[s:e], ps[s:e])
        t_k = t[None, :] * k_t[:, None]
        p_k = p[None, :] * k_p[:, None]
        lam = (bsf[None, :] - 1.0) / b_a[:, None] + t_k
        feas = ((p_k <= b_p[:, None])
                & (t_k <= bsf[None, :] / b_h[:, None])
                & (lam <= b_l[:, None]))
        idx = torch.where(feas, lam, _INF).argmin(dim=1)
        idx, ok, lam_sel, p_sel = _fetch(idx, feas.any(dim=1),
                                         _pick(lam, idx), _pick(p_k, idx))
        for k in np.flatnonzero(ok):
            i = int(idx[k])
            out[s + k] = P.Solution(pm=grid.modes[i], bs=int(grid.bs[i]),
                                    time=float(lam_sel[k]),
                                    power=float(p_sel[k]))
    return out


def _align_train(infer_grid: ObservationGrid, train_grid: ObservationGrid):
    """Per-infer-entry train observations; entries whose mode is absent from
    the train grid are masked out (the scalar loop skips them)."""
    tindex = train_grid.index
    pos = np.fromiter((tindex.get(pm, -1) for pm in infer_grid.modes),
                      np.int64, len(infer_grid))
    valid = pos >= 0
    safe = np.maximum(pos, 0)
    t_tr = np.where(valid, train_grid.t[safe], np.nan)
    p_tr = np.where(valid, train_grid.p[safe], np.nan)
    return t_tr, p_tr, valid


def solve_concurrent_batch(problems: Sequence[P.ConcurrentProblem],
                           train_obs: Union[dict, ObservationGrid],
                           infer_obs: Union[dict, ObservationGrid],
                           backend: Optional[str] = None
                           ) -> list[Optional[P.Solution]]:
    """Batched ``problem.solve_concurrent``: lexicographic argmax of
    (training throughput, -peak latency) under the interleaving feasibility
    mask, for every problem at once (the reference's
    ``concurrent_kernel``)."""
    backend = resolve_backend(backend)
    tg = as_train_grid(train_obs)
    ig = as_infer_grid(infer_obs)
    out: list[Optional[P.Solution]] = [None] * len(problems)
    if not len(tg) or not len(ig) or not len(problems):
        return out
    pb, lb, ar = _problem_cols(problems, "power_budget", "latency_budget",
                               "arrival_rate")
    t_tr, p_tr, valid = _align_train(ig, tg)
    with np.errstate(invalid="ignore"):
        pmax = np.maximum(ig.p, p_tr)
    dev = torch_device(backend)
    t_in, _, bsf = device_grid_arrays(ig, dev)
    t_tr_d, pmax_d = _upload(dev, t_tr, pmax)
    valid_d = torch.from_numpy(valid).to(dev)
    for s, e in _chunks(len(problems), len(ig)):
        record_dispatch("solver")
        b_p, b_l, b_a = _upload(dev, pb[s:e], lb[s:e], ar[s:e])
        cycle = bsf[None, :] / b_a[:, None]
        lam = (bsf[None, :] - 1.0) / b_a[:, None] + t_in[None, :]
        feas = (valid_d[None, :] & (pmax_d[None, :] <= b_p[:, None])
                & (t_in[None, :] <= cycle) & (lam <= b_l[:, None]))
        tau = torch.where(feas, torch.clamp_min(torch.floor(
            (cycle - t_in[None, :]) / t_tr_d[None, :]), 0.0), 0.0)
        theta = torch.where(feas, tau / cycle, -_INF)
        best = theta.amax(dim=1, keepdim=True)
        idx = torch.where(feas & (theta >= best), lam, _INF).argmin(dim=1)
        idx, ok, tau_s, theta_s, lam_s = _fetch(
            idx, feas.any(dim=1), _pick(tau, idx), _pick(theta, idx),
            _pick(lam, idx))
        for k in np.flatnonzero(ok):
            i = int(idx[k])
            out[s + k] = P.Solution(
                pm=ig.modes[i], bs=int(ig.bs[i]), tau_tr=int(tau_s[k]),
                time=float(lam_s[k]), power=float(pmax[i]),
                throughput=float(theta_s[k]))
    return out


# ---------------------------------------------------------------------------
# multi-tenant: N inference streams + optional training fill (problem.
# solve_multi_tenant batched). Candidates are the cross-product of per-stream
# (pm, bs) grid entries sharing one mode, enumerated stream-0-major in grid
# order — the scalar reference's exact scan (and tie-break) order.
# ---------------------------------------------------------------------------

_MISS = object()


class _MultiCandidates:
    """Columnar joint candidate set for one (stream grids, specs) tuple."""

    def __init__(self, grids: Sequence[ObservationGrid],
                 train_grid: Optional[ObservationGrid],
                 specs: Sequence) -> None:
        n = len(grids)
        masks = []
        for g, spec in zip(grids, specs):
            if spec.batch_sizes is None:
                masks.append(None)
            else:
                allowed = set(int(b) for b in spec.batch_sizes)
                masks.append(np.fromiter((int(b) in allowed for b in g.bs),
                                         bool, len(g)))
        # streams 1..n-1: {pm: [flat indices]} in grid order
        by_pm: list[dict] = []
        for g, m in zip(grids[1:], masks[1:]):
            d: dict = {}
            for i in range(len(g)):
                if m is None or m[i]:
                    d.setdefault(g.modes[i], []).append(i)
            by_pm.append(d)
        tindex = None if train_grid is None else train_grid.index
        inner_cache: dict = {}
        cols: list[list] = [[] for _ in range(n)]
        g0, m0 = grids[0], masks[0]
        for i in range(len(g0)):
            if m0 is not None and not m0[i]:
                continue
            pm = g0.modes[i]
            if tindex is not None and pm not in tindex:
                continue
            blk = inner_cache.get(pm, _MISS)
            if blk is _MISS:
                lists = [d.get(pm) for d in by_pm]
                if any(ls is None for ls in lists):
                    blk = None
                else:
                    mesh = np.meshgrid(*[np.asarray(ls, np.int64)
                                         for ls in lists], indexing="ij") \
                        if lists else []
                    blk = [mg.ravel() for mg in mesh]
                inner_cache[pm] = blk
            if blk is None:
                continue
            width = blk[0].size if blk else 1
            cols[0].append(np.full(width, i, np.int64))
            for j, b in enumerate(blk):
                cols[j + 1].append(b)
        if cols[0]:
            self.idx = [np.concatenate(c) for c in cols]
        else:
            self.idx = [np.empty(0, np.int64) for _ in range(n)]
        K = self.idx[0].size
        self.K, self.n = K, n
        self.modes = [grids[0].modes[int(i)] for i in self.idx[0]]
        self.t_in = np.empty((K, n))
        self.bsf = np.empty((K, n))
        self.bss = np.empty((K, n), np.int64)
        pmax = np.full(K, -np.inf)
        for j, g in enumerate(grids):
            ix = self.idx[j]
            self.t_in[:, j] = g.t[ix]
            self.bss[:, j] = g.bs[ix]
            self.bsf[:, j] = self.bss[:, j].astype(np.float64)
            pmax = np.maximum(pmax, g.p[ix])
        if train_grid is not None:
            tpos = np.fromiter((tindex[pm] for pm in self.modes), np.int64, K)
            self.t_tr = train_grid.t[tpos]
            pmax = np.maximum(pmax, train_grid.p[tpos])
        else:
            self.t_tr = None
        self.pmax = pmax


def _multi_spec_key(specs) -> tuple:
    """The per-stream structure that must be uniform across a problem batch:
    the observation sets are shared, so workloads and allowed batch sizes
    must match (rates and budgets may vary)."""
    return tuple((getattr(s.workload, "name", s.workload),
                  None if s.batch_sizes is None else tuple(s.batch_sizes))
                 for s in specs)


def _multi_rate_arrays(cand: "_MultiCandidates", rates: torch.Tensor,
                       t_in: torch.Tensor, bsf: torch.Tensor,
                       total: Optional[torch.Tensor]):
    """The rate-dependent part of the reduction for a chunk of problems:
    ``(sustainable, base, slack, lam)`` over (problems, candidates[,
    streams]), replaying problem.multi_* op for op (a single stream is the
    pair expressions). ``rates`` is (problems, streams)."""
    a = rates[:, None, :]
    cycle = bsf[None] / a
    sus = (t_in[None] <= cycle).all(dim=2)
    lam = (bsf[None] - 1.0) / a + t_in[None]
    if cand.n == 1:
        base = cycle[..., 0]
        slack = base - t_in[None, :, 0]
        return sus, base, slack, lam
    base = cycle.amin(dim=2)
    busy = torch.zeros_like(base)
    for j in range(cand.n):          # stream order, as the scalar reference
        busy = busy + t_in[None, :, j] * (base * rates[:, j, None]
                                          / bsf[None, :, j])
    slack = base - busy
    sus = sus & (slack >= 0.0)
    lam = lam + (total[:, None] - t_in)[None]
    return sus, base, slack, lam


def solve_multi_tenant_batch(problems: Sequence["P.MultiTenantProblem"],
                             train_obs: Optional[Union[dict, ObservationGrid]],
                             infer_obs: Sequence[Union[dict, ObservationGrid]],
                             backend: Optional[str] = None
                             ) -> list[Optional["P.MultiTenantSolution"]]:
    """Batched ``problem.solve_multi_tenant``: every problem must share the
    stream count, train flag, and per-stream batch-size restrictions; rates,
    latency budgets, and power budgets vary per problem (the reference's
    ``multi_train`` / ``multi_infer`` kernels)."""
    backend = resolve_backend(backend)
    out: list[Optional[P.MultiTenantSolution]] = [None] * len(problems)
    if not len(problems):
        return out
    p0 = problems[0]
    n = p0.n_streams
    if len(infer_obs) != n:
        raise ValueError(f"expected {n} observation sets, got {len(infer_obs)}")
    skey = _multi_spec_key(p0.streams)
    for pr in problems:
        if pr.n_streams != n or pr.train != p0.train \
                or _multi_spec_key(pr.streams) != skey \
                or pr.priorities != p0.priorities:
            raise ValueError("solve_multi_tenant_batch needs a uniform "
                             "stream shape (count, train flag, workloads, "
                             "batch sizes, priorities) across the problem "
                             "batch")
    weights = p0.priority_weights()
    grids = [as_infer_grid(o) for o in infer_obs]
    tg = as_train_grid(train_obs) if p0.train else None
    if any(not len(g) for g in grids) or (tg is not None and not len(tg)):
        return out
    cand = _MultiCandidates(grids, tg, p0.streams)
    if not cand.K:
        return out
    dev = torch_device(backend)
    pb = np.fromiter((pr.power_budget for pr in problems), np.float64,
                     len(problems))
    ar = np.array([[s.arrival_rate for s in pr.streams] for pr in problems])
    lb = np.array([[s.latency_budget for s in pr.streams] for pr in problems])
    t_in = torch.from_numpy(cand.t_in).to(dev)
    bsf = torch.from_numpy(cand.bsf).to(dev)
    pmax = torch.from_numpy(cand.pmax).to(dev)
    t_tr = None if cand.t_tr is None else torch.from_numpy(cand.t_tr).to(dev)
    wts = None if weights is None \
        else torch.tensor(weights, dtype=torch.float64, device=dev)
    total = None
    if n > 1:
        total = torch.zeros(cand.K, dtype=torch.float64, device=dev)
        for j in range(n):           # stream order, as the scalar reference
            total = total + t_in[:, j]
    for s, e in _chunks(len(problems), cand.K * n):
        record_dispatch("solver")
        b_p = torch.from_numpy(pb[s:e]).to(dev)
        b_a = torch.from_numpy(ar[s:e]).to(dev)
        b_l = torch.from_numpy(lb[s:e]).to(dev)
        sus, base, slack, lam = _multi_rate_arrays(cand, b_a, t_in, bsf,
                                                   total)
        feas = (sus & (pmax[None] <= b_p[:, None])
                & (lam <= b_l[:, None, :]).all(dim=2))
        # the priority-weighted worst-latency secondary objective (scalar:
        # max_j(w_j * lam_j)); unset priorities apply no multiplication at
        # all — the bitwise-default contract
        worst = (lam if wts is None else lam * wts).amax(dim=2)
        if t_tr is None:
            idx = torch.where(feas, worst, _INF).argmin(dim=1)
            idx, ok, lam_s = _fetch(idx, feas.any(dim=1),
                                    lam[torch.arange(e - s, device=dev), idx])
            tau_s = theta_s = None
        else:
            tau = torch.where(feas, torch.clamp_min(
                torch.floor(slack / t_tr[None]), 0.0), 0.0)
            theta = torch.where(feas, tau / base, -_INF)
            best = theta.amax(dim=1, keepdim=True)
            idx = torch.where(feas & (theta >= best), worst,
                              _INF).argmin(dim=1)
            idx, ok, lam_s, tau_s, theta_s = _fetch(
                idx, feas.any(dim=1),
                lam[torch.arange(e - s, device=dev), idx],
                _pick(tau, idx), _pick(theta, idx))
        for k in np.flatnonzero(ok):
            i = int(idx[k])
            out[s + k] = P.MultiTenantSolution(
                pm=cand.modes[i], bss=tuple(int(b) for b in cand.bss[i]),
                tau_tr=None if tau_s is None else int(tau_s[k]),
                times=tuple(float(x) for x in lam_s[k]),
                power=float(cand.pmax[i]),
                throughput=0.0 if theta_s is None else float(theta_s[k]))
    return out
