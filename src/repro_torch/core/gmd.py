"""GMD: Gradient-descent based Multi-Dimensional search (paper §5.1, Alg. 1).

Profiles a midpoint mode plus one probe per dimension, fits time/power slopes,
and repeatedly bisects along the dimension with the highest slope ratio
rho = m_time / m_pow, pruning half-lines via power monotonicity. Variants:

 * training   — power is the only constraint; ~10 profiles (§5.1.2)
 * inference  — bs is a special dimension: search at bs=1 first, then
   backtrack to larger bs for modes that satisfy power but cannot keep up
   with the arrival rate; 11 profiles (§5.1.3)
 * concurrent — branch-and-bound the largest feasible bs at MAXN (from 64
   down), search with the *dominant* workload's slopes, backtrack to smaller
   bs; 15 profiles (§5.1.4)

The port's own copy of ``repro.core.gmd``, kept line for line: host-side
scalar search, no accelerator work. Plans must equal the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import problem as P
from repro_torch.core.device_model import Profiler
from repro_torch.core.powermode import DIMS, PowerMode, PowerModeSpace

POWER_SLOPE_EPS = 0.25   # W; below this a power delta is noise (thresholding
                         # logic of §5.1.2 - avoids artificially inflated rho)


@dataclasses.dataclass
class _DimState:
    lo: int                  # inclusive candidate index range
    hi: int
    rho: float = 0.0
    last: Optional[tuple[int, float, float]] = None   # (idx, t, p) for slope updates

    @property
    def empty(self) -> bool:
        return self.lo > self.hi


class _GMDBase:
    """Shared bisection machinery; subclasses define feasibility/objective."""

    def __init__(self, profiler: Profiler, space: Optional[PowerModeSpace] = None,
                 max_tries: int = 10):
        self.profiler = profiler
        self.space = space or PowerModeSpace()
        self.max_tries = max_tries

    # -- hooks -------------------------------------------------------------
    def _profile(self, pm: PowerMode) -> tuple[float, float]:
        raise NotImplementedError

    def _runs_used(self) -> Optional[int]:
        """Fresh profiling runs consumed so far (None -> count probes)."""
        return None

    def _power_budget(self) -> float:
        raise NotImplementedError

    def _note_candidate(self, pm: PowerMode, t: float, p: float) -> None:
        pass

    # -- slope bookkeeping ---------------------------------------------------
    def _slope(self, v1, t1, p1, v2, t2, p2) -> float:
        if v1 == v2:
            return 0.0
        m_time = (t2 - t1) / (v2 - v1)
        m_pow = (p2 - p1) / (v2 - v1)
        if abs(p2 - p1) < POWER_SLOPE_EPS:   # negligible power change
            return 0.0
        return abs(m_time / m_pow)

    def _need_reserve(self) -> bool:
        """True if the search should stop early to save profiles for
        backtracking (no solution exists yet among observations)."""
        return False

    RESERVE = 0

    # -- main search ---------------------------------------------------------
    def search(self) -> None:
        """Run the multi-dimensional bisection; candidates are reported via
        _note_candidate. Total profile budget = max_tries (probes included)."""
        sp = self.space
        budget = self._power_budget()
        runs0 = self._runs_used()

        def spent(fallback: int) -> int:
            used = self._runs_used()
            return fallback if used is None else used - runs0

        mid = sp.midpoint()
        t_mid, p_mid = self._profile(mid)
        self._note_candidate(mid, t_mid, p_mid)
        over = p_mid > budget
        tries = 1

        # 4 probes: one per dimension, lowest value if over budget else
        # highest (step (2) of §5.1.2). They fit the initial slopes and count
        # against the profiling budget; pruning uses only the midpoint.
        dims: dict[str, _DimState] = {}
        current = mid
        for dim in self.space.values:
            vals = sp.values[dim]
            mi = sp.index(dim, mid.value(dim))
            st = _DimState(lo=0, hi=mi - 1) if over else \
                _DimState(lo=mi + 1, hi=len(vals) - 1)
            probe_idx = 0 if over else len(vals) - 1
            if probe_idx != mi and spent(tries) < self.max_tries:
                pm = mid.replace(**{dim: vals[probe_idx]})
                t, p = self._profile(pm)
                tries += 1
                self._note_candidate(pm, t, p)
                st.rho = self._slope(vals[probe_idx], t, p, vals[mi], t_mid, p_mid)
                st.last = (probe_idx, t, p)
            dims[dim] = st

        # bisect along the highest-slope-ratio dimension, anchored at
        # `current`; feasible profiles raise the anchor (joint exploration),
        # infeasible ones in the over-budget regime lower it.
        while spent(tries) < self.max_tries:
            if self.RESERVE and spent(tries) >= self.max_tries - self.RESERVE \
                    and self._need_reserve():
                break               # keep budget for bs backtracking
            live = {d: s for d, s in dims.items() if not s.empty}
            if not live:
                break
            dim = max(live, key=lambda d: live[d].rho)
            st = live[dim]
            vals = sp.values[dim]
            idx = (st.lo + st.hi) // 2
            pm = current.replace(**{dim: vals[idx]})
            if pm.value(dim) == current.value(dim) and st.lo == st.hi:
                st.lo = st.hi + 1      # nothing new on this line
                continue
            t, p = self._profile(pm)
            tries += 1
            self._note_candidate(pm, t, p)
            if p > budget:
                st.hi = idx - 1
                if over:
                    # anchor down so the other dims search a feasible region
                    down = vals[st.lo] if not st.empty else vals[0]
                    current = current.replace(**{dim: down})
            else:
                st.lo = idx + 1
                current = pm           # anchor later lines at feasible value
            if st.last is not None:
                st.rho = self._slope(vals[st.last[0]], st.last[1], st.last[2],
                                     vals[idx], t, p)
            st.last = (idx, t, p)


# ---------------------------------------------------------------------------
# standalone training
# ---------------------------------------------------------------------------

class GMDTrain(_GMDBase):
    def __init__(self, profiler: Profiler, space=None, max_tries: int = 10):
        super().__init__(profiler, space, max_tries)

    def solve(self, prob: P.TrainProblem) -> Optional[P.Solution]:
        self._prob = prob
        self._obs: dict[PowerMode, tuple[float, float]] = {}
        self.search()
        return P.solve_train(prob, self._obs)

    def _profile(self, pm):
        return self.profiler.profile(pm)

    def _runs_used(self):
        return self.profiler.num_runs

    def _power_budget(self):
        return self._prob.power_budget

    def _note_candidate(self, pm, t, p):
        self._obs[pm] = (t, p)


# ---------------------------------------------------------------------------
# standalone inference
# ---------------------------------------------------------------------------

class GMDInfer(_GMDBase):
    def __init__(self, profiler: Profiler, space=None, max_tries: int = 11,
                 batch_sizes=tuple(P.INFER_BATCH_SIZES)):
        super().__init__(profiler, space, max_tries)
        self.batch_sizes = list(batch_sizes)

    RESERVE = 3

    def _need_reserve(self) -> bool:
        return P.solve_infer(self._prob, self._obs) is None

    def solve(self, prob: P.InferProblem) -> Optional[P.Solution]:
        self._prob = prob
        self._bs = self.batch_sizes[0]          # start at bs=1 (min latency)
        self._obs: dict[tuple[PowerMode, int], tuple[float, float]] = {}
        self._solve_runs0 = self.profiler.num_runs
        # probe MAXN first (cf. the concurrent variant's branch-and-bound):
        # it bounds the achievable latency — if MAXN cannot sustain the rate
        # at this bs, no slower mode can, and backtracking skips the bs.
        maxn = self.space.maxn()
        t, p = self.profiler.profile(maxn, self._bs)
        self._obs[(maxn, self._bs)] = (t, p)
        self.search()
        sol = P.solve_infer(prob, self._obs)
        if sol is not None:
            return sol
        # Backtracking (§5.1.3): modes under the power budget whose inference
        # rate cannot keep up at bs=1 -> sublinear time growth means a larger
        # bs can satisfy the arrival rate. Fastest feasible-power modes first.
        feas = [(pm, t, p) for (pm, b), (t, p) in self._obs.items()
                if b == self._bs and p <= prob.power_budget]
        feas.sort(key=lambda x: x[1])
        cands = feas[:1]
        # second candidate with power headroom (power grows with bs)
        headroom = [c for c in feas[1:] if c[2] <= 0.85 * prob.power_budget]
        cands += headroom[:1] if headroom else feas[1:2]
        # secondary goal is MIN latency: spend the remaining budget even
        # after a first feasible solution appears (smaller bs first).
        for bs in self.batch_sizes[1:]:
            for pm, t1, _ in cands:
                if self.profiler.num_runs - self._solve_runs0 >= self.max_tries:
                    return P.solve_infer(prob, self._obs)
                # skip bs values provably unsustainable even at perfectly
                # sublinear scaling (t(bs) >= t(1) always)
                if t1 > bs / prob.arrival_rate:
                    continue
                t, p = self.profiler.profile(pm, bs)
                self._obs[(pm, bs)] = (t, p)
        return P.solve_infer(prob, self._obs)

    def _profile(self, pm):
        return self.profiler.profile(pm, self._bs)

    def _runs_used(self):
        return self.profiler.num_runs

    def _power_budget(self):
        return self._prob.power_budget

    def _note_candidate(self, pm, t, p):
        self._obs[(pm, self._bs)] = (t, p)


# ---------------------------------------------------------------------------
# concurrent training + inference
# ---------------------------------------------------------------------------

class ConcurrentProfiler:
    """Profiles a (train, infer) pair: one visit to a power mode runs both
    workloads (interleaved), counting a single profiling run."""

    def __init__(self, train_profiler: Profiler, infer_profiler: Profiler):
        self.train = train_profiler
        self.infer = infer_profiler
        self.visited: set = set()

    @property
    def num_runs(self) -> int:
        return len(self.visited)

    @property
    def profile_cost_s(self) -> float:
        return self.train.profile_cost_s + self.infer.profile_cost_s

    def profile(self, pm: PowerMode, bs: int):
        t_tr, p_tr = self.train.profile(pm)
        t_in, p_in = self.infer.profile(pm, bs)
        self.visited.add((pm, bs))
        return (t_tr, p_tr), (t_in, p_in)


class GMDConcurrent(_GMDBase):
    def __init__(self, cprofiler: ConcurrentProfiler, space=None,
                 max_tries: int = 15, batch_sizes=tuple(P.INFER_BATCH_SIZES)):
        super().__init__(cprofiler.infer, space, max_tries)
        self.cp = cprofiler
        self.batch_sizes = list(batch_sizes)

    def solve(self, prob: P.ConcurrentProblem) -> Optional[P.Solution]:
        self._prob = prob
        self._train_obs: dict[PowerMode, tuple[float, float]] = {}
        self._infer_obs: dict[tuple[PowerMode, int], tuple[float, float]] = {}

        # Branch and bound (E): largest bs whose latency MAXN can meet; any
        # slower mode only increases execution time, so bigger bs are dead.
        maxn = self.space.maxn()
        chosen = None
        for bs in sorted(self.batch_sizes, reverse=True):
            t_in, p_in = self.cp.infer.profile(maxn, bs)
            self._infer_obs[(maxn, bs)] = (t_in, p_in)
            lam = P.peak_latency(bs, prob.arrival_rate, t_in)
            if lam <= prob.latency_budget and P.sustainable(bs, prob.arrival_rate, t_in):
                chosen = bs
                break
        if chosen is None:
            return None
        t_tr, p_tr = self.cp.train.profile(maxn)
        self._train_obs[maxn] = (t_tr, p_tr)
        self._bs = chosen

        self.search()
        sol = self._solve_obs()
        if sol is not None:
            return sol

        # Backtracking (F): only modes that keep up with the arrival rate can
        # be rescued by a smaller bs (smaller bs further lowers the rate).
        cands = []
        for (pm, b), (t_in, p_in) in self._infer_obs.items():
            if b != self._bs or pm in (maxn,):
                continue
            if p_in <= prob.power_budget and P.sustainable(b, prob.arrival_rate, t_in):
                cands.append((pm, P.peak_latency(b, prob.arrival_rate, t_in)))
        cands.sort(key=lambda x: x[1])
        lower = [b for b in self.batch_sizes if b < self._bs]
        for bs in sorted(lower, reverse=True):
            for pm, _ in cands:
                if self.cp.num_runs >= self.max_tries:
                    break
                (t_tr, p_tr), (t_in, p_in) = self.cp.profile(pm, bs)
                self._train_obs[pm] = (t_tr, p_tr)
                self._infer_obs[(pm, bs)] = (t_in, p_in)
                sol = self._solve_obs()
                if sol is not None:
                    return sol
        return self._solve_obs()

    def _solve_obs(self):
        return P.solve_concurrent(self._prob, self._train_obs, self._infer_obs)

    # -- hooks: profile both, use the dominant workload's time for slopes ----
    def _profile(self, pm):
        (t_tr, p_tr), (t_in, p_in) = self.cp.profile(pm, self._bs)
        self._train_obs[pm] = (t_tr, p_tr)
        self._infer_obs[(pm, self._bs)] = (t_in, p_in)
        # dominant workload = the one drawing more power (§5.1.4); power is a
        # system-wide constraint set by the max of the two.
        if p_tr >= p_in:
            return t_tr, max(p_tr, p_in)
        return t_in, max(p_tr, p_in)

    def _power_budget(self):
        return self._prob.power_budget

    def _note_candidate(self, pm, t, p):
        pass   # candidates tracked via _train_obs/_infer_obs


# ---------------------------------------------------------------------------
# multi-tenant: train + N inference streams
# ---------------------------------------------------------------------------

class MultiTenantProfiler:
    """Profiles a train workload plus N inference streams: one visit to a
    power mode runs every workload back-to-back (interleaved), counting a
    single profiling run — the N-stream ConcurrentProfiler."""

    def __init__(self, train_profiler: Optional[Profiler],
                 stream_profilers: list):
        self.train = train_profiler
        self.streams = list(stream_profilers)
        self.visited: set = set()

    @property
    def n_streams(self) -> int:
        return len(self.streams)

    @property
    def num_runs(self) -> int:
        return len(self.visited)

    @property
    def profile_cost_s(self) -> float:
        cost = self.train.profile_cost_s if self.train else 0.0
        return cost + sum(p.profile_cost_s for p in self.streams)

    def profile(self, pm: PowerMode, bss):
        train_tp = self.train.profile(pm) if self.train else None
        stream_tps = [p.profile(pm, int(b))
                      for p, b in zip(self.streams, bss)]
        self.visited.add((pm, tuple(int(b) for b in bss)))
        return train_tp, stream_tps

    def infer_observed(self) -> list:
        return [p.observed() for p in self.streams]


class GMDMultiTenant(_GMDBase):
    """GMD over the N-stream problem: branch-and-bound each stream's largest
    feasible minibatch size at MAXN, bisect with the *dominant* workload's
    slopes (one mode visit profiles all streams), then backtrack streams to
    smaller bs. Profiling budget grows with the tenant count."""

    def __init__(self, mtprofiler: MultiTenantProfiler, space=None,
                 max_tries: Optional[int] = None,
                 batch_sizes=tuple(P.INFER_BATCH_SIZES)):
        n = mtprofiler.n_streams
        if max_tries is None:
            max_tries = 15 + 4 * (n - 1)       # 15 at N=1 (§5.1.4)
        super().__init__(mtprofiler.streams[0], space, max_tries)
        self.mp = mtprofiler
        self.batch_sizes = list(batch_sizes)

    def solve(self, prob: P.MultiTenantProblem) -> Optional[P.MultiTenantSolution]:
        self._prob = prob
        maxn = self.space.maxn()
        rates = [s.arrival_rate for s in prob.streams]

        # Branch and bound per stream: largest bs whose solo latency MAXN
        # can meet — any slower mode only increases execution time, so
        # bigger bs are dead (cf. GMDConcurrent step E).
        allowed = []
        chosen = []
        for j, spec in enumerate(prob.streams):
            allowed.append([b for b in self.batch_sizes
                            if spec.batch_sizes is None
                            or b in spec.batch_sizes])
            pick = None
            for bs in sorted(allowed[j], reverse=True):
                t_in, _ = self.mp.streams[j].profile(maxn, bs)
                lam = P.peak_latency(bs, spec.arrival_rate, t_in)
                if lam <= spec.latency_budget and \
                        P.sustainable(bs, spec.arrival_rate, t_in):
                    pick = bs
                    break
            if pick is None:
                return None
            chosen.append(pick)
        # Blocking-aware shrink to fixpoint (the N>1 coupling the pair B&B
        # has no analogue for): with every tenant at its solo pick, a
        # stream's peak latency also carries the other tenants' service
        # times — shrink violating streams one step until all budgets fit
        # at MAXN (profiles are cached, so re-evaluation is free).
        while len(chosen) > 1:
            t_ins = [self.mp.streams[j].profile(maxn, b)[0]
                     for j, b in enumerate(chosen)]

            def shrink(k) -> bool:
                lower = [b for b in allowed[k] if b < chosen[k]]
                if lower:
                    chosen[k] = max(lower)
                return bool(lower)

            viol = [j for j, spec in enumerate(prob.streams)
                    if P.multi_peak_latency(chosen, rates, t_ins, j)
                    > spec.latency_budget]
            if not viol:
                break
            moved = False
            for j in viol:
                # own queueing + service overruns -> only stream j can help
                if P.peak_latency(chosen[j], rates[j], t_ins[j]) \
                        > prob.streams[j].latency_budget:
                    moved |= shrink(j)
            if not moved:
                # blocking-bound: the largest service time is the blocker
                for k in sorted(range(len(chosen)),
                                key=lambda k: -t_ins[k]):
                    if shrink(k):
                        moved = True
                        break
            if not moved:
                break
        if self.mp.train:
            self.mp.train.profile(maxn)
        self.mp.visited.add((maxn, tuple(chosen)))
        self._bss = chosen

        self.search()
        sol = self._solve_obs()
        if sol is not None:
            return sol

        # Backtracking: shrink one stream at a time (largest-contribution
        # first) on modes that keep up with every arrival rate.
        cands = []
        obs = self.mp.infer_observed()
        for pm in {pm for (pm, _) in self.mp.visited}:
            if pm == maxn:
                continue
            try:
                t_ins = [obs[j][(pm, b)][0] for j, b in enumerate(self._bss)]
            except KeyError:
                continue
            if all(P.sustainable(b, r, t)
                   for b, r, t in zip(self._bss, rates, t_ins)):
                cands.append((pm, max(t_ins)))
        cands.sort(key=lambda x: x[1])
        for j in range(self.mp.n_streams):
            lower = [b for b in self.batch_sizes if b < self._bss[j]]
            for bs in sorted(lower, reverse=True):
                for pm, _ in cands:
                    if self.mp.num_runs >= self.max_tries:
                        return self._solve_obs()
                    bss = list(self._bss)
                    bss[j] = bs
                    self.mp.profile(pm, bss)
                    sol = self._solve_obs()
                    if sol is not None:
                        return sol
        return self._solve_obs()

    def _solve_obs(self):
        train_obs = self.mp.train.observed_modes() if self.mp.train else None
        return P.solve_multi_tenant(self._prob, train_obs,
                                    self.mp.infer_observed())

    # -- hooks: profile everything, dominant workload drives the slopes -----
    def _profile(self, pm):
        train_tp, stream_tps = self.mp.profile(pm, self._bss)
        cands = list(stream_tps) + ([train_tp] if train_tp else [])
        t_dom, p_dom = max(cands, key=lambda tp: tp[1])   # dominant = max power
        p_sys = max(p for _, p in cands)
        return t_dom, p_sys

    def _runs_used(self):
        return self.mp.num_runs

    def _power_budget(self):
        return self._prob.power_budget

    def _need_reserve(self) -> bool:
        return self._solve_obs() is None

    RESERVE = 3

    def _note_candidate(self, pm, t, p):
        pass   # candidates tracked via the profilers' caches
