"""Trace-driven execution engine on PyTorch (paper §3 Fig. 2, §5.4).

Counterpart of ``repro.core.simulate`` (all but its scalar reference
loops):

 * ``ArrivalTrace``, ``QueueState``, ``ExecutionReport`` and the host
   helpers are the reference's, copied (the port imports nothing from
   ``repro``). ``ArrivalTrace.uniform`` / ``poisson`` make the same NumPy
   generator calls, so they reproduce the reference's times bitwise.
 * The managed engine replays a committed plan as the max-plus recurrence
   ``c_k = max(c_{k-1}, ready_k) + exec_k`` on the device: lanes are
   dispatched in ``_LANE_CHUNK`` chunks padded to power-of-two lane buckets
   and ONE global power-of-two event count (absorbing ``+inf`` / 0
   padding), and each chunk is one launch of the ``maxplus_scan`` kernel,
   which also sums the training slack fills.
 * The batched report builder (``_presort_reports``) cuts the reports into
   sort chunks of at most ``_SORT_CHUNK_ELEMS`` padded elements and sorts
   each with one launch of the ``lane_sort`` kernel, filling every report's
   quantile / violation-rate cache.
 * The multi-tenant engine (``simulate_multi_tenant[_batch]``) merges each
   lane's per-stream batch-ready events on the host into one event axis
   with a per-event service time and runs them through the same
   ``maxplus_scan`` launches; lanes may have different tenant counts.
 * The native and streams approaches stay seeded NumPy models, as in the
   reference.

Backends (``core.backend``): ``"cuda"`` (default) launches the kernels;
``"cpu"`` runs their plain PyTorch versions. Both meet the reference's
NumPy engine to the tolerance ``docs/exactness.md`` sets for every
accelerator tier: latencies within ``atol=1e-8 s, rtol=1e-9`` and training
minibatch counts within the floor-boundary slack (+-2). The sort only
permutes, so report statistics are exact functions of the latencies.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.backend import (record_dispatch, resolve_backend,
                                      torch_device)
from repro_torch.core.device_model import DeviceModel, WorkloadProfile
from repro_torch.core.powermode import PowerMode
from repro_torch.kernels.fulcrum.lane_sort import lane_sort
from repro_torch.kernels.fulcrum.maxplus_scan import maxplus_scan


# ---------------------------------------------------------------------------
# arrival traces
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ArrivalTrace:
    """Sorted request-arrival timestamps (seconds) driving one simulation.
    ``stream_ids`` (multi-tenant traces) records which tenant each request
    belongs to; ``merge``/``split`` round-trip that provenance."""
    times: np.ndarray
    duration: float
    kind: str = "uniform"
    stream_ids: Optional[np.ndarray] = None
    n_streams: Optional[int] = None   # tenant count of a merged trace

    def __post_init__(self):
        object.__setattr__(self, "times",
                           np.ascontiguousarray(self.times, np.float64))
        if self.stream_ids is not None:
            object.__setattr__(self, "stream_ids",
                               np.ascontiguousarray(self.stream_ids, np.int64))

    def __len__(self) -> int:
        return int(self.times.size)

    @property
    def mean_rate(self) -> float:
        return len(self) / self.duration if self.duration > 0 else 0.0

    def shifted(self, t0: float) -> "ArrivalTrace":
        return ArrivalTrace(self.times + t0, self.duration, self.kind,
                            self.stream_ids, self.n_streams)

    def clip(self, t0: float, t1: float, rebase: bool = False) -> "ArrivalTrace":
        """The [t0, t1) window view of this trace. Times stay absolute —
        the carryover convention — unless ``rebase`` shifts them to the
        window origin."""
        if t1 < t0:
            raise ValueError(f"empty window: t1={t1} < t0={t0}")
        m = (self.times >= t0) & (self.times < t1)
        ids = self.stream_ids[m] if self.stream_ids is not None else None
        return ArrivalTrace(self.times[m] - (t0 if rebase else 0.0),
                            t1 - t0, self.kind, ids, self.n_streams)

    @staticmethod
    def concat(traces: Sequence["ArrivalTrace"],
               duration: Optional[float] = None) -> "ArrivalTrace":
        """Concatenate traces whose times are already in nondecreasing order
        (e.g. carried-over pending requests followed by the next window's
        arrivals). ``duration`` defaults to the longest piece's."""
        if not traces:
            return ArrivalTrace(np.empty(0), float(duration or 0.0))
        times = np.concatenate([t.times for t in traces])
        if times.size > 1 and np.any(np.diff(times) < 0):
            raise ValueError("concat needs nondecreasing times across pieces;"
                             " use merge() for interleaved streams")
        ids = None
        if all(t.stream_ids is not None for t in traces):
            ids = np.concatenate([t.stream_ids for t in traces])
        n_streams = max((t.n_streams for t in traces
                         if t.n_streams is not None), default=None)
        if duration is None:
            duration = max(t.duration for t in traces)
        return ArrivalTrace(times, float(duration), traces[0].kind,
                            ids, n_streams)

    @staticmethod
    def merge(traces: Sequence["ArrivalTrace"]) -> "ArrivalTrace":
        """Merge per-stream traces into one multi-tenant trace. Stream ``j``
        of the result is ``traces[j]``; arrival order is a stable sort on
        time, so simultaneous arrivals keep stream order."""
        if not traces:
            return ArrivalTrace(np.empty(0), 0.0, "merged",
                                np.empty(0, np.int64), 0)
        times = np.concatenate([t.times for t in traces])
        ids = np.concatenate([np.full(len(t), j, np.int64)
                              for j, t in enumerate(traces)])
        order = np.argsort(times, kind="stable")
        duration = max(t.duration for t in traces)
        return ArrivalTrace(times[order], float(duration), "merged",
                            ids[order], len(traces))

    def split(self, n_streams: Optional[int] = None) -> list["ArrivalTrace"]:
        """Per-stream traces of a merged trace (provenance round-trip)."""
        if self.stream_ids is None:
            raise ValueError("trace has no stream provenance; use merge()")
        n = n_streams if n_streams is not None else self.n_streams
        if n is None:       # foreign ids without a recorded count: infer
            n = int(self.stream_ids.max() + 1) if len(self) else 0
        return [ArrivalTrace(self.times[self.stream_ids == j], self.duration,
                             self.kind) for j in range(int(n))]

    @classmethod
    def uniform(cls, rate: float, duration: float) -> "ArrivalTrace":
        """Fixed-rate ticks at i/rate."""
        n = int(rate * duration)
        return cls(np.arange(n, dtype=np.float64) / rate, float(duration))

    @classmethod
    def poisson(cls, rate: float, duration: float, seed: int = 0) -> "ArrivalTrace":
        """Seeded Poisson process: exponential inter-arrival gaps (the
        reference's generator calls, so the same seed gives the same
        times)."""
        if rate <= 0.0:                       # idle window: no arrivals
            return cls(np.empty(0), float(duration), "poisson")
        rng = np.random.default_rng(seed)
        mean = rate * duration
        n = max(8, int(mean + 6.0 * math.sqrt(mean) + 8))
        t = np.cumsum(rng.exponential(1.0 / rate, n))
        while t.size and t[-1] < duration:        # undershoot: extend (rare)
            t = np.concatenate([t, t[-1] + np.cumsum(
                rng.exponential(1.0 / rate, n))])
        return cls(t[t < duration], float(duration), "poisson")

    @classmethod
    def piecewise(cls, rates: Sequence[float], window_duration: float,
                  seed: Optional[int] = None) -> "ArrivalTrace":
        """Piecewise-rate trace: one window per rate (the §5.4 dynamic
        scenario). Uniform ticks within each window, Poisson when ``seed``
        is given."""
        parts, t0 = [], 0.0
        for i, r in enumerate(rates):
            if r > 0:
                w = (cls.uniform(r, window_duration) if seed is None
                     else cls.poisson(r, window_duration, seed + i))
                parts.append(t0 + w.times)
            t0 += window_duration
        times = np.concatenate(parts) if parts else np.empty(0)
        return cls(times, t0, "piecewise")


# ---------------------------------------------------------------------------
# window-boundary queue state (backlog carryover)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class QueueState:
    """Managed-engine state at a window boundary: the *original* arrival
    timestamps of requests never served (the trailing partial minibatch)
    and the completion time of the last executed minibatch (``clock``),
    before which the engine may not start work."""
    pending: np.ndarray
    clock: float = 0.0
    stream_ids: Optional[np.ndarray] = None

    def __post_init__(self):
        object.__setattr__(self, "pending",
                           np.ascontiguousarray(self.pending, np.float64))
        if self.stream_ids is not None:
            object.__setattr__(self, "stream_ids",
                               np.ascontiguousarray(self.stream_ids, np.int64))

    def __len__(self) -> int:
        return int(self.pending.size)

    def pending_for(self, j: int) -> np.ndarray:
        """Pending arrivals of stream ``j`` of a multi-tenant state."""
        if self.stream_ids is None:
            return self.pending if j == 0 else np.empty(0)
        return self.pending[self.stream_ids == j]


# ---------------------------------------------------------------------------
# execution report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ExecutionReport:
    approach: str
    latencies: Sequence[float]        # per-request latency (s), queue + exec
    train_minibatches: int
    duration: float
    power: float
    trace: Optional[ArrivalTrace] = None   # the arrivals that were executed
    queue_state: Optional[QueueState] = dataclasses.field(   # end-of-window
        default=None, repr=False, compare=False)             # engine state
    drift_s: Optional[float] = None   # runtime-vs-engine max |Δlatency| (s)
    # graceful-degradation accounting, filled by the serving drivers — 0 /
    # None when no admission control ran
    shed_requests: int = 0
    deferred_requests: int = 0
    goodput: Optional[float] = None   # in-budget served / offered fraction
    # this report's time-weighted share of the device's interleaved-window
    # power (0 for an idle window)
    attributed_power: Optional[float] = dataclasses.field(
        default=None, compare=False)
    _sorted: Optional[np.ndarray] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def train_throughput(self) -> float:
        return self.train_minibatches / self.duration

    @property
    def sorted_latencies(self) -> np.ndarray:
        """Ascending latencies; the cache behind every quantile / violation
        query, filled for a whole batch by ``_presort_reports``."""
        if self._sorted is None:
            self._sorted = np.sort(np.asarray(self.latencies, np.float64))
        return self._sorted

    def latency_quantile(self, q: float) -> float:
        """Nearest-rank quantile: the ceil(q*n)-th order statistic."""
        n = len(self.latencies)
        if n == 0:
            return 0.0
        xs = self.sorted_latencies
        return float(xs[min(n - 1, max(0, math.ceil(q * n) - 1))])

    def violation_rate(self, latency_budget: float) -> float:
        n = len(self.latencies)
        if n == 0:
            return 0.0
        xs = self.sorted_latencies
        return float(n - np.searchsorted(xs, latency_budget, side="right")) / n


# ---------------------------------------------------------------------------
# host-side helpers (copied from the reference)
# ---------------------------------------------------------------------------

def _batch_ready(times: np.ndarray, bs: int) -> np.ndarray:
    """Arrival time of the bs-th request of each full minibatch; a trailing
    partial batch never runs."""
    return times[bs - 1::bs]


def _queue_completions(ready: np.ndarray, exec_t: np.ndarray) -> np.ndarray:
    """c_k = max(c_{k-1}, ready_k) + exec_k as one array program:
    c_k = max_{j<=k}(ready_j - E_{j-1}) + E_k with E = cumsum(exec)."""
    if ready.size == 0:
        return ready.copy()
    E = np.cumsum(exec_t)
    offset = np.concatenate(([0.0], E[:-1]))
    return np.maximum.accumulate(ready - offset) + E


def _latencies(completions: np.ndarray, times: np.ndarray,
               bs: int) -> np.ndarray:
    return np.repeat(completions, bs) - times[:completions.size * bs]


def first_backlog_crossing(times: np.ndarray, completions: np.ndarray,
                           bs: int, threshold: int) -> Optional[int]:
    """Index of the first arrival at which the backlog — requests arrived
    but not yet completed, counting the arriving request itself — exceeds
    ``threshold``, given the run's batch completion times (each completion
    retires one ``bs``-sized minibatch); ``None`` when it never crosses.
    ``times`` is the run's *effective* arrival vector (carried pending
    requests first). The closed loop splits a window at the returned
    arrival's timestamp (``ArrivalTrace.clip`` + ``QueueState`` chaining)."""
    times = np.asarray(times, np.float64)
    if times.size == 0:
        return None
    comps = np.asarray(completions, np.float64)
    done = int(bs) * np.searchsorted(comps, times, side="right")
    backlog = np.arange(1, times.size + 1) - done
    idx = np.flatnonzero(backlog > int(threshold))
    return int(idx[0]) if idx.size else None


def _time_power(device: DeviceModel, w: WorkloadProfile, pm: PowerMode,
                bs: Optional[int]) -> tuple[float, float]:
    """Device timings memoized on the device instance (they are pure
    functions of (workload, mode, bs)); the cache dies with the device."""
    cache = device.__dict__.setdefault("_simulate_time_power_cache", {})
    key = (w, pm, bs)
    out = cache.get(key)
    if out is None:
        out = cache[key] = device.time_power(w, pm, bs)
    return out


def _attribute_power(power: float, busys: Sequence[float]) -> list[float]:
    """Split a device's interleaved-window power across its consumers in
    proportion to busy time; an idle window attributes 0 to everyone."""
    total = float(sum(busys))
    if total <= 0.0:
        return [0.0 for _ in busys]
    return [power * (b / total) for b in busys]


def _carry_times(trace: ArrivalTrace,
                 carry_in: Optional[QueueState]) -> tuple[np.ndarray, float]:
    """A window's effective arrival vector and starting clock: carried
    pending requests re-enter ahead of the window's own arrivals."""
    if carry_in is None:
        return trace.times, 0.0
    times = trace.times if not len(carry_in) \
        else np.concatenate([carry_in.pending, trace.times])
    return times, float(carry_in.clock)


def _pow2(n: int, floor: int = 8) -> int:
    return max(floor, 1 << max(0, n - 1).bit_length())


def _pad_lanes(readies: Sequence[np.ndarray], execs: Sequence[np.ndarray],
               lanes_pad: Optional[int] = None,
               k_pad: Optional[int] = None) -> tuple[np.ndarray, np.ndarray]:
    """Stack ragged per-lane event vectors into (lanes_pad, k_pad) arrays,
    both axes defaulting to the next power of two. Padding lanes/events are
    absorbing (ready = +inf, exec = 0)."""
    if k_pad is None:
        k_pad = _pow2(max((r.size for r in readies), default=0))
    if lanes_pad is None:
        lanes_pad = _pow2(len(readies))
    ready = np.full((lanes_pad, k_pad), np.inf)
    exec_t = np.zeros((lanes_pad, k_pad))
    for i, (r, e) in enumerate(zip(readies, execs)):
        ready[i, :r.size] = r
        exec_t[i, :e.size] = e
    return ready, exec_t


def _tau_array(tau_caps: Sequence[Optional[int]]) -> np.ndarray:
    return np.array([np.inf if c is None else float(max(0, int(c)))
                     for c in tau_caps])


# ---------------------------------------------------------------------------
# batched report builder: chunked per-lane sorts through the lane_sort kernel
# ---------------------------------------------------------------------------

# Cap on lanes x requests elements per padded sort matrix (~32 MB float64):
# chunking keeps peak memory flat and lets each chunk pad to its OWN width.
_SORT_CHUNK_ELEMS = 4 << 20


def _sort_chunks(sizes: Sequence[int]) -> list[tuple[int, int]]:
    """The reference's chunking: consecutive reports [i, j) whose padded
    matrix (count x widest) stays within ``_SORT_CHUNK_ELEMS``."""
    chunks, i = [], 0
    while i < len(sizes):
        j, width = i + 1, max(sizes[i], 1)
        while j < len(sizes):
            width = max(width, sizes[j])
            if (j + 1 - i) * width > _SORT_CHUNK_ELEMS:
                break
            j += 1
        chunks.append((i, j))
        i = j
    return chunks


def _pad_rows(rows: Sequence[np.ndarray]) -> np.ndarray:
    """Rows stacked into a (len, widest) matrix padded with +inf."""
    mat = np.full((len(rows), max(a.size for a in rows)), np.inf)
    for i, a in enumerate(rows):
        mat[i, :a.size] = a
    return mat


def _sort_lane_chunk(lats: list[np.ndarray], reports, backend: str) -> None:
    """Sort one chunk of lanes with one ``lane_sort`` launch. Every chunk is
    padded and sorted on the backend, however ragged: the padded matrix is
    bounded by ``_SORT_CHUNK_ELEMS`` either way."""
    mat = torch.from_numpy(_pad_rows(lats)).to(torch_device(backend))
    record_dispatch("sort")
    srt = lane_sort(mat).cpu().numpy()
    for i, (r, a) in enumerate(zip(reports, lats)):
        # copy: a view would pin the whole padded matrix per report
        r._sorted = srt[i, :a.size].copy()


def _presort_reports(reports: Sequence[ExecutionReport],
                     backend: str) -> None:
    """Fill every report's quantile/violation cache with chunked sorts over
    +inf-padded (lane, request) matrices."""
    lats = [np.asarray(r.latencies, np.float64) for r in reports]
    if max((a.size for a in lats), default=0) == 0:
        for r in reports:
            r._sorted = np.empty(0)
        return
    for i, j in _sort_chunks([a.size for a in lats]):
        _sort_lane_chunk(lats[i:j], reports[i:j], backend)


# ---------------------------------------------------------------------------
# the stochastic approaches: seeded NumPy models, as in the reference
# ---------------------------------------------------------------------------

def _native_engine(device: DeviceModel, w_tr: WorkloadProfile,
                   w_in: WorkloadProfile, pm: PowerMode, bs: int,
                   trace: ArrivalTrace, seed: int = 0,
                   tau_cap: Optional[int] = None) -> ExecutionReport:
    """Native kernel-level time-sharing: inference contends with training
    (~2x slowdown +- jitter); training gets the leftover GPU share."""
    rng = np.random.default_rng(seed)
    t_in, p_in = _time_power(device, w_in, pm, bs)
    t_tr, p_tr = _time_power(device, w_tr, pm, None)
    ready = _batch_ready(trace.times, bs)
    exec_t = t_in * (1.0 + rng.uniform(0.5, 1.6, ready.size))
    c = _queue_completions(ready, exec_t)
    train_share = max(0.0, trace.duration - float(exec_t.sum())) \
        * float(rng.uniform(0.85, 0.95))
    trained = int(train_share / t_tr)
    return ExecutionReport("native", _latencies(c, trace.times, bs), trained,
                           trace.duration, max(p_in, p_tr), trace)


def _streams_engine(device: DeviceModel, w_tr: WorkloadProfile,
                    w_in: WorkloadProfile, pm: PowerMode, bs: int,
                    trace: ArrivalTrace, seed: int = 0,
                    tau_cap: Optional[int] = None) -> ExecutionReport:
    """CUDA-streams space sharing, inference on the high-priority stream:
    throughput-friendly, but block-level resource blocking fattens the
    tail."""
    rng = np.random.default_rng(seed)
    t_in, p_in = _time_power(device, w_in, pm, bs)
    t_tr, p_tr = _time_power(device, w_tr, pm, None)
    ready = _batch_ready(trace.times, bs)
    K = ready.size
    slowdown = 1.0 + rng.uniform(0.05, 0.45, K)
    blocked = rng.random(K) < 0.18
    extra = rng.uniform(0.5, 2.0, K) * (t_tr / max(t_in, 1e-6))
    exec_t = t_in * (slowdown + np.where(blocked, extra, 0.0))
    c = _queue_completions(ready, exec_t)
    trained = int(trace.duration * float(rng.uniform(0.75, 0.9)) / t_tr)
    return ExecutionReport("streams", _latencies(c, trace.times, bs), trained,
                           trace.duration, max(p_in, p_tr) * 1.03, trace)


ENGINES: dict[str, Callable[..., ExecutionReport]] = {
    "native": _native_engine,
    "streams": _streams_engine,
}

APPROACHES = ("managed",) + tuple(ENGINES)


# ---------------------------------------------------------------------------
# the managed engine: chunked lane dispatch through the maxplus_scan kernel
# ---------------------------------------------------------------------------

# lanes dispatched per launch: bounds the padded chunk matrix to
# _LANE_CHUNK x K_pad floats however many lanes a sweep has
_LANE_CHUNK = 8192


def _lane_chunks(n: int) -> list[tuple[int, int, int]]:
    """(start, end, padded lane count) of every engine chunk of n lanes."""
    return [(s, min(n, s + _LANE_CHUNK),
             min(_LANE_CHUNK, _pow2(min(n, s + _LANE_CHUNK) - s)))
            for s in range(0, n, _LANE_CHUNK)]


def _chunk_inputs(readies: Sequence[np.ndarray], execs: Sequence[np.ndarray],
                  t_trs: np.ndarray, tau_caps: np.ndarray,
                  clocks: np.ndarray, s: int, e: int, lanes_pad: int,
                  k_pad: int) -> tuple[np.ndarray, ...]:
    """The padded host inputs of lanes [s, e) of one engine chunk. Padding
    lanes are absorbing: +inf ready, 0 exec, +inf t_tr and cap, clock 0."""
    m = e - s
    ready, exec_t = _pad_lanes(readies[s:e], execs[s:e],
                               lanes_pad=lanes_pad, k_pad=k_pad)
    ttr = np.full(lanes_pad, np.inf)
    ttr[:m] = t_trs[s:e]
    cap = np.full(lanes_pad, np.inf)
    cap[:m] = tau_caps[s:e]
    clk = np.zeros(lanes_pad)
    clk[:m] = clocks[s:e]
    return ready, exec_t, ttr, cap, clk


def _run_engine(backend: str, readies: Sequence[np.ndarray],
                execs: Sequence[np.ndarray], t_trs: np.ndarray,
                tau_caps: np.ndarray, clocks: np.ndarray,
                ) -> tuple[list[np.ndarray], np.ndarray]:
    """Chunked lane dispatch: every chunk is padded to a power-of-two lane
    bucket and ONE global power-of-two event count (over all lanes), moved
    to the backend's device and scanned by one ``maxplus_scan`` launch.
    Returns each lane's trimmed completion vector and its fill sum."""
    dev = torch_device(backend)
    n = len(readies)
    k_pad = _pow2(max((r.size for r in readies), default=0))
    comps: list[np.ndarray] = []
    trained = np.empty(n)
    for s, e, lanes_pad in _lane_chunks(n):
        host = _chunk_inputs(readies, execs, t_trs, tau_caps, clocks, s, e,
                             lanes_pad, k_pad)
        record_dispatch("engine")
        c, f = maxplus_scan(*(torch.from_numpy(x).to(dev) for x in host))
        c, f = c.cpu().numpy(), f.cpu().numpy()
        comps.extend(c[i, :readies[s + i].size] for i in range(e - s))
        trained[s:e] = f[:e - s]
    return comps, trained


def _lane_events(device: DeviceModel, w_tr: Optional[WorkloadProfile],
                 w_in: WorkloadProfile, pms: Sequence[PowerMode],
                 bss: Sequence[int], traces: Sequence[ArrivalTrace],
                 carries: Sequence[Optional[QueueState]],
                 devices: Optional[Sequence[DeviceModel]] = None):
    """Per-lane host inputs of the managed engine: inference and training
    (time, power), effective arrivals with their start clock, and the
    batch-ready / execution-time event vectors. ``devices`` gives each lane
    its own device model (``device`` serves every lane otherwise)."""
    devs = [device] * len(pms) if devices is None else devices
    tps = [_time_power(dv, w_in, pm, int(bs))
           for dv, pm, bs in zip(devs, pms, bss)]
    ttr = [_time_power(dv, w_tr, pm, None) if w_tr else (np.inf, 0.0)
           for dv, pm in zip(devs, pms)]
    lane_times = [_carry_times(tr, ci) for tr, ci in zip(traces, carries)]
    readies = [_batch_ready(times, int(bs))
               for (times, _), bs in zip(lane_times, bss)]
    execs = [np.broadcast_to(np.float64(t), r.shape)
             for (t, _), r in zip(tps, readies)]
    return tps, ttr, lane_times, readies, execs


def batch_ready_events(arrivals: Sequence[Sequence[float]],
                       bss: Sequence[int]) -> list[tuple]:
    """Per-stream batch-ready events merged into device order: one
    ``(ready time, stream index, start request index)`` tuple per full
    minibatch, sorted by ready time with ties broken by stream then
    position — the managed engines' merge order. The real runtime
    (``runtime.interleave_runtime``) replays events in this order."""
    events = []
    for j, (arr, b) in enumerate(zip(arrivals, bss)):
        b = int(b)
        for k in range(len(arr) // b):
            events.append((arr[k * b + b - 1], j, k * b))
    events.sort()
    return events


# ---------------------------------------------------------------------------
# multi-tenant managed interleaving: N inference streams + training fill
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MultiTenantReport:
    """Per-tenant execution reports plus the shared training/power account
    of one N-stream managed run."""
    streams: list                     # one ExecutionReport per tenant
    train_minibatches: int
    duration: float
    power: float
    trace: Optional[ArrivalTrace] = None   # the merged trace that was run
    queue_state: Optional[QueueState] = dataclasses.field(  # end-of-window
        default=None, repr=False, compare=False)            # engine state
    # graceful-degradation accounting across all tenants, filled by the
    # serving loops and the runtime's admission gate
    shed_requests: int = 0
    deferred_requests: int = 0
    goodput: Optional[float] = None
    # the training job's time-weighted share of the device power; each
    # tenant's share is on its stream report, and together they sum to
    # ``power`` (0 everywhere for an idle window)
    train_attributed_power: Optional[float] = None

    @property
    def train_throughput(self) -> float:
        return self.train_minibatches / self.duration

    def worst_latency_quantile(self, q: float) -> float:
        return max((r.latency_quantile(q) for r in self.streams), default=0.0)

    def violation_rates(self, budgets: Sequence[float]) -> list:
        return [r.violation_rate(b) for r, b in zip(self.streams, budgets)]


def _carry_stream_traces(traces: Sequence[ArrivalTrace],
                         carry_in: Optional[QueueState],
                         ) -> tuple[list[ArrivalTrace], float]:
    """Per-stream effective traces of a multi-tenant window: each stream's
    carried pending requests re-enter ahead of its window arrivals."""
    if carry_in is None:
        return list(traces), 0.0
    out = []
    for j, tr in enumerate(traces):
        pend = carry_in.pending_for(j)
        times = tr.times if pend.size == 0 \
            else np.concatenate([pend, tr.times])
        out.append(ArrivalTrace(times, tr.duration, tr.kind))
    return out, float(carry_in.clock)


def _multi_tenant_state(times_by_stream: Sequence[np.ndarray],
                        bss: Sequence[int], completions: np.ndarray,
                        clock: float) -> QueueState:
    """End-of-window queue state of an N-stream run: each stream's trailing
    partial minibatch, merged back into (time, stream) order."""
    pend = [t[(t.size // int(b)) * int(b):]
            for t, b in zip(times_by_stream, bss)]
    times = np.concatenate(pend) if pend else np.empty(0)
    ids = np.concatenate([np.full(p.size, j, np.int64)
                          for j, p in enumerate(pend)]) \
        if pend else np.empty(0, np.int64)
    order = np.argsort(times, kind="stable")
    out_clock = float(completions[-1]) if completions.size else clock
    return QueueState(times[order], out_clock, ids[order])


def _merge_events(traces: Sequence[ArrivalTrace], bss: Sequence[int],
                  t_ins: Sequence[float]):
    """Batch-ready events of all streams merged into device order: a stable
    sort on ready time, ties by stream index. Returns (ready, exec_t,
    stream_of_event); ``exec_t`` is the per-event service time the
    ``maxplus_scan`` kernel reads."""
    readies = [_batch_ready(tr.times, int(b)) for tr, b in zip(traces, bss)]
    ready = np.concatenate(readies) if readies else np.empty(0)
    sid = np.concatenate([np.full(r.size, j, np.int64)
                          for j, r in enumerate(readies)]) \
        if readies else np.empty(0, np.int64)
    order = np.argsort(ready, kind="stable")
    ready, sid = ready[order], sid[order]
    exec_t = np.asarray(t_ins, np.float64)[sid] if ready.size \
        else np.empty(0)
    return ready, exec_t, sid


def _multi_lane_events(device: DeviceModel, w_tr: Optional[WorkloadProfile],
                       stream_workloads: Sequence[Sequence[WorkloadProfile]],
                       pms: Sequence[PowerMode], bsss: Sequence[Sequence[int]],
                       tracess: Sequence[Sequence[ArrivalTrace]],
                       carries: Sequence[Optional[QueueState]]) -> list:
    """Per-lane host inputs of the multi-tenant engine: one ``(tps, ttr,
    ready, exec_t, sid, eff, clock)`` per lane — the streams' inference and
    training (time, power), the merged event vectors with each event's
    stream, the effective per-stream traces and the start clock."""
    lanes = []
    for ws, pm, bss, traces, ci in zip(stream_workloads, pms, bsss, tracess,
                                       carries):
        if not (len(ws) == len(bss) == len(traces)):
            raise ValueError("stream workloads / batch sizes / traces "
                             "must align")
        tps = [_time_power(device, w, pm, int(b)) for w, b in zip(ws, bss)]
        ttr = _time_power(device, w_tr, pm, None) if w_tr else (np.inf, 0.0)
        eff, clock = _carry_stream_traces(traces, ci)
        ready, exec_t, sid = _merge_events(eff, bss, [t for t, _ in tps])
        lanes.append((tps, ttr, ready, exec_t, sid, eff, clock))
    return lanes


def simulate_multi_tenant(device: DeviceModel,
                          w_tr: Optional[WorkloadProfile],
                          stream_workloads: Sequence[WorkloadProfile],
                          pm: PowerMode, bss: Sequence[int],
                          traces: Sequence[ArrivalTrace],
                          tau_cap: Optional[int] = None,
                          backend: Optional[str] = None,
                          carry_in: Optional[QueueState] = None,
                          ) -> MultiTenantReport:
    """N-stream managed interleaving on one device: the streams' minibatches
    are served in ready order (one DNN at a time) and training fills the
    remaining slack. Runs as a one-lane ``simulate_multi_tenant_batch`` on
    ``backend``. With one stream the kernel gets exactly the pair engine's
    inputs, so the result equals ``simulate``'s bitwise on either backend.
    ``carry_in`` resumes from a previous window's per-stream queue state."""
    n = len(stream_workloads)
    if not (len(bss) == len(traces) == n):
        raise ValueError("stream workloads / batch sizes / traces must align")
    return simulate_multi_tenant_batch(
        device, w_tr, [stream_workloads], [pm], [bss], [traces],
        tau_caps=[tau_cap], carry_ins=[carry_in], backend=backend)[0]


def simulate_multi_tenant_batch(
        device: DeviceModel, w_tr: Optional[WorkloadProfile],
        stream_workloads: Sequence[Sequence[WorkloadProfile]],
        pms: Sequence[PowerMode], bsss: Sequence[Sequence[int]],
        tracess: Sequence[Sequence[ArrivalTrace]],
        tau_caps: Optional[Sequence[Optional[int]]] = None,
        backend: Optional[str] = None,
        carry_ins: Optional[Sequence[Optional[QueueState]]] = None,
        ) -> list[MultiTenantReport]:
    """Run many N-stream managed simulations as one batch, one lane per
    multi-tenant run. Lanes may have *different* tenant counts: the host
    merges each lane's events (stable time sort, ties by stream index) into
    one event axis with a per-event service time, and the lanes share the
    chunked ``maxplus_scan`` launches of ``simulate_batch``. All reports of
    all lanes and streams share one report-builder pass (``lane_sort``).
    ``carry_ins`` gives each lane a carried per-stream ``QueueState``."""
    n = len(pms)
    if not (len(stream_workloads) == len(bsss) == len(tracess) == n):
        raise ValueError("stream_workloads / pms / bsss / tracess must align")
    caps = list(tau_caps) if tau_caps is not None else [None] * n
    if len(caps) != n:
        raise ValueError("tau_caps must align with the lanes")
    carries = list(carry_ins) if carry_ins is not None else [None] * n
    if len(carries) != n:
        raise ValueError("carry_ins must align with the lanes")
    if n == 0:
        return []
    backend = resolve_backend(backend)
    lanes = _multi_lane_events(device, w_tr, stream_workloads, pms, bsss,
                               tracess, carries)
    comps, trained_f = _run_engine(backend,
                                   [ln[2] for ln in lanes],
                                   [ln[3] for ln in lanes],
                                   np.array([ln[1][0] for ln in lanes]),
                                   _tau_array(caps),
                                   np.array([ln[6] for ln in lanes]))
    out, flat = [], []
    for i, (tps, ttr, _, _, sid, eff, clock) in enumerate(lanes):
        comp = comps[i]
        trained = int(round(float(trained_f[i]))) if w_tr else 0
        power = ttr[1] if trained else 0.0
        for _, p_in in tps:
            power = max(power, p_in)
        duration = max((tr.duration for tr in tracess[i]), default=0.0)
        streams, busys = [], []
        for j, (tr, b) in enumerate(zip(eff, bsss[i])):
            comp_j = comp[sid == j]
            lat = np.repeat(comp_j, int(b)) - tr.times[:comp_j.size * int(b)]
            busys.append(comp_j.size * tps[j][0])
            streams.append(ExecutionReport("managed", lat, 0, tr.duration,
                                           power, tr))
        attr = _attribute_power(power,
                                busys + [trained * ttr[0] if trained
                                         else 0.0])
        for rep, a in zip(streams, attr):
            rep.attributed_power = a
        flat.extend(streams)
        state = _multi_tenant_state([tr.times for tr in eff], bsss[i], comp,
                                    clock)
        out.append(MultiTenantReport(streams, trained, duration, power,
                                     ArrivalTrace.merge(eff),
                                     queue_state=state,
                                     train_attributed_power=attr[-1]))
    _presort_reports(flat, backend)
    return out


def simulate(device: DeviceModel, w_tr: Optional[WorkloadProfile],
             w_in: WorkloadProfile, pm: PowerMode, bs: int,
             trace: ArrivalTrace, approach: str = "managed", seed: int = 0,
             tau_cap: Optional[int] = None,
             backend: Optional[str] = None,
             carry_in: Optional[QueueState] = None) -> ExecutionReport:
    """Run one execution approach over an arrival trace.

    The managed approach runs on ``backend`` (``"cuda"`` by default, or
    ``"cpu"``) as a one-lane ``simulate_batch``; native/streams are the
    seeded NumPy models. ``carry_in`` (managed only) resumes from a previous
    window's ``QueueState``."""
    if approach not in APPROACHES:
        raise ValueError(f"unknown approach {approach!r}; "
                         f"use one of {sorted(APPROACHES)}")
    if carry_in is not None and approach != "managed":
        raise ValueError("carry-in backlog is only defined for the "
                         "deterministic managed approach")
    backend = resolve_backend(backend)
    if approach == "managed":
        return simulate_batch(device, w_tr, w_in, [pm], [bs], [trace],
                              tau_caps=[tau_cap], carry_ins=[carry_in],
                              backend=backend)[0]
    return ENGINES[approach](device, w_tr, w_in, pm, bs, trace, seed,
                             tau_cap)


def simulate_batch(device: DeviceModel, w_tr: Optional[WorkloadProfile],
                   w_in: WorkloadProfile, pms: Sequence[PowerMode],
                   bss: Sequence[int], traces: Sequence[ArrivalTrace],
                   tau_caps: Optional[Sequence[Optional[int]]] = None,
                   approach: str = "managed", seed: int = 0,
                   backend: Optional[str] = None,
                   carry_ins: Optional[Sequence[Optional[QueueState]]] = None,
                   devices: Optional[Sequence[DeviceModel]] = None,
                   ) -> list[ExecutionReport]:
    """Run many (power mode, batch size, trace) simulations as one batch,
    one report per lane. Managed lanes run as chunked ``maxplus_scan``
    launches on ``backend``; native/streams lanes use the seeded NumPy
    models. Either way the reports' quantile/violation caches are filled by
    the batched report builder on ``backend``. ``carry_ins`` (managed only)
    gives each lane a carried ``QueueState``. ``devices`` gives each lane
    its own device model (the fleet: lanes ARE devices); the scan is
    unchanged — heterogeneity enters only through each lane's (t, p)
    timings, which reach the kernel as its per-lane ``exec`` times."""
    n = len(pms)
    if not (len(bss) == len(traces) == n):
        raise ValueError("pms / bss / traces must align")
    caps = list(tau_caps) if tau_caps is not None else [None] * n
    if len(caps) != n:
        raise ValueError("tau_caps must align with the lanes")
    carries = list(carry_ins) if carry_ins is not None else [None] * n
    if len(carries) != n:
        raise ValueError("carry_ins must align with the lanes")
    devs = list(devices) if devices is not None else [device] * n
    if len(devs) != n:
        raise ValueError("devices must align with the lanes")
    if approach != "managed" and any(ci is not None for ci in carries):
        raise ValueError("carry-in backlog is only defined for the "
                         "deterministic managed approach")
    if n == 0:
        return []
    backend = resolve_backend(backend)
    if approach != "managed":
        engine = ENGINES[approach]
        reports = [engine(dv, w_tr, w_in, pm, int(bs), tr, seed, cap)
                   for dv, pm, bs, tr, cap
                   in zip(devs, pms, bss, traces, caps)]
        _presort_reports(reports, backend)
        return reports
    tps, ttr, lane_times, readies, execs = _lane_events(
        device, w_tr, w_in, pms, bss, traces, carries, devs)
    comps, trained_f = _run_engine(backend, readies, execs,
                                   np.array([t for t, _ in ttr]),
                                   _tau_array(caps),
                                   np.array([cl for _, cl in lane_times]))
    reports = []
    for i, (tr, bs) in enumerate(zip(traces, bss)):
        comp = comps[i]
        times, clock = lane_times[i]
        trained = int(round(float(trained_f[i]))) if w_tr else 0
        power = max(tps[i][1], ttr[i][1] if trained else 0.0)
        state = QueueState(times[comp.size * int(bs):],
                           float(comp[-1]) if comp.size else clock)
        attr = _attribute_power(power, [comp.size * tps[i][0],
                                        trained * ttr[i][0] if trained
                                        else 0.0])
        reports.append(ExecutionReport(
            "managed", _latencies(comp, times, int(bs)), trained,
            tr.duration, power, tr, queue_state=state,
            attributed_power=attr[0]))
    _presort_reports(reports, backend)
    return reports
