"""Problem formulation (§4): the optimization variants, the managed-
interleaving feasibility math, and the observed-profile solver every strategy
(oracle, RND, ALS, GMD backtracking) shares.

Notation follows Table 2: a solution is (pm [, beta_in [, tau_tr]]).

The paper evaluates a training+inference *pair*; the multi-tenant
generalization (``StreamSpec`` / ``MultiTenantProblem`` /
``solve_multi_tenant``) models N inference streams sharing the accelerator
with an optional training fill workload. ``ConcurrentProblem`` and
``InferProblem`` are the N=1 views of it: ``as_multi_tenant()`` lifts them,
and the N=1 multi-tenant math replays the pair expressions bitwise (the
exactness contract enforced by ``tests/test_multi_tenant.py``).

Contract: this module is the **scalar reference** for the whole solver layer.
Inputs are problem dataclasses plus observation dicts ``{pm: (t, p)}`` /
``{(pm, bs): (t, p)}`` whose iteration order is authoritative (ties resolve
to the first-scanned entry); no randomness, no NumPy — pure-Python float
ops define the IEEE-754 expression trees that ``core.grid_eval`` must replay
bitwise. Invariants: solvers never mutate their inputs; a returned solution
is always feasible under the problem's budgets and the sustainability/
blocking math defined here; infeasible problems return ``None``. See
``docs/architecture.md`` for where this layer sits.

The port's own copy of ``repro.core.problem``, kept line for line: solving
stays scalar Python on the host, and plans equal the reference's exactly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.powermode import PowerMode

INFER_BATCH_SIZES = [1, 4, 16, 32, 64]   # paper §6 (BERT capped at 32)


@dataclasses.dataclass(frozen=True)
class TrainProblem:
    power_budget: float                       # p-hat (W)


@dataclasses.dataclass(frozen=True)
class InferProblem:
    power_budget: float
    latency_budget: float                     # lambda-hat (s/request, peak)
    arrival_rate: float                       # alpha (requests/s)

    def as_multi_tenant(self, workload=None,
                        batch_sizes=None) -> "MultiTenantProblem":
        """This problem as a single-stream multi-tenant problem (no train)."""
        return MultiTenantProblem(
            self.power_budget,
            (StreamSpec(self.arrival_rate, self.latency_budget, workload,
                        batch_sizes),),
            train=False)


@dataclasses.dataclass(frozen=True)
class ConcurrentProblem:
    power_budget: float
    latency_budget: float
    arrival_rate: float

    def as_multi_tenant(self, workload=None,
                        batch_sizes=None) -> "MultiTenantProblem":
        """This problem as a train + single-stream multi-tenant problem."""
        return MultiTenantProblem(
            self.power_budget,
            (StreamSpec(self.arrival_rate, self.latency_budget, workload,
                        batch_sizes),),
            train=True)


# ---------------------------------------------------------------------------
# multi-tenant problems: one train workload + N inference streams
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """One inference tenant: its arrival rate, per-request latency budget,
    the workload it runs (a WorkloadProfile; opaque to this layer), and the
    minibatch sizes its plan may choose (None = any observed size)."""
    arrival_rate: float
    latency_budget: float
    workload: Optional[object] = None
    batch_sizes: Optional[tuple] = None

    def with_rate(self, rate: float) -> "StreamSpec":
        return dataclasses.replace(self, arrival_rate=float(rate))


@dataclasses.dataclass(frozen=True)
class MultiTenantProblem:
    """N tenant inference streams sharing one accelerator (and one power
    mode) with — when ``train`` — a training workload filling the slack.
    Primary objective: max training throughput (min worst-tenant latency
    when ``train`` is False); secondary: min worst-tenant latency.

    ``priorities`` (one positive weight per stream, optional) makes the
    latency side of the objective priority-aware: the solver minimizes the
    worst *priority-weighted* latency ``max_j(w_j * lam_j)`` with
    ``w_j = priority_j / max(priorities)``, so a high-priority tenant's
    latency dominates the tie-break and low-priority tenants absorb the
    slack. Unset (the default) means no weighting is applied at all —
    today's unweighted results are reproduced bitwise. Per-stream latency
    *budgets* stay hard constraints regardless of priority."""
    power_budget: float
    streams: tuple
    train: bool = True
    priorities: Optional[tuple] = None

    def __post_init__(self):
        object.__setattr__(self, "streams", tuple(self.streams))
        if not self.streams:
            raise ValueError("MultiTenantProblem needs at least one stream")
        if self.priorities is not None:
            pr = tuple(float(p) for p in self.priorities)
            if len(pr) != len(self.streams):
                raise ValueError(f"expected {len(self.streams)} priorities, "
                                 f"got {len(pr)}")
            if any(p <= 0.0 for p in pr):
                raise ValueError("priorities must be positive")
            object.__setattr__(self, "priorities", pr)

    @property
    def n_streams(self) -> int:
        return len(self.streams)

    def priority_weights(self) -> Optional[tuple]:
        """Per-stream objective weights ``priority_j / max(priorities)``;
        ``None`` (no weighting applied — the bitwise default) when
        priorities are unset."""
        if self.priorities is None:
            return None
        mx = max(self.priorities)
        return tuple(p / mx for p in self.priorities)

    def pair_view(self) -> ConcurrentProblem:
        """The equivalent pair problem (requires exactly one stream)."""
        if self.n_streams != 1:
            raise ValueError(f"{self.n_streams} streams have no pair view")
        s = self.streams[0]
        if self.train:
            return ConcurrentProblem(self.power_budget, s.latency_budget,
                                     s.arrival_rate)
        raise ValueError("pair_view of a no-train problem is an InferProblem; "
                         "use infer_view()")

    def infer_view(self) -> InferProblem:
        if self.n_streams != 1:
            raise ValueError(f"{self.n_streams} streams have no infer view")
        s = self.streams[0]
        return InferProblem(self.power_budget, s.latency_budget,
                            s.arrival_rate)


@dataclasses.dataclass(frozen=True)
class Solution:
    pm: PowerMode
    bs: Optional[int] = None
    tau_tr: Optional[int] = None
    # achieved metrics (as observed/predicted by the solving strategy)
    time: float = 0.0            # train minibatch time or inference latency
    power: float = 0.0
    throughput: float = 0.0      # training minibatches/s (concurrent)


@dataclasses.dataclass(frozen=True)
class MultiTenantSolution:
    """A committed multi-tenant plan: one power mode, one minibatch size per
    stream, the interleave factor, and the per-stream achieved latencies."""
    pm: PowerMode
    bss: tuple                   # one minibatch size per stream
    tau_tr: Optional[int] = None
    times: tuple = ()            # per-stream peak latency (s)
    power: float = 0.0
    throughput: float = 0.0      # training minibatches/s (0 when no train)

    @property
    def time(self) -> float:
        """Worst-tenant peak latency."""
        return max(self.times) if self.times else 0.0

    @property
    def bs(self) -> Optional[int]:
        """The single-stream view's minibatch size (N=1 only)."""
        return int(self.bss[0]) if len(self.bss) == 1 else None

    def stream_solution(self, i: int) -> Solution:
        """Stream ``i``'s slice of the plan as a pair-shaped Solution."""
        return Solution(pm=self.pm, bs=int(self.bss[i]), tau_tr=self.tau_tr,
                        time=float(self.times[i]), power=self.power,
                        throughput=self.throughput)


# ---------------------------------------------------------------------------
# managed-interleaving math (§4, Fig. 3/4)
# ---------------------------------------------------------------------------

def queueing_time(bs: int, arrival_rate: float) -> float:
    return (bs - 1) / arrival_rate


def peak_latency(bs: int, arrival_rate: float, t_in: float) -> float:
    """lambda_in = (beta-1)/alpha + t_in."""
    return queueing_time(bs, arrival_rate) + t_in


def sustainable(bs: int, arrival_rate: float, t_in: float) -> bool:
    """Inference rate keeps up with arrival rate (Fig. 3b): processing one
    minibatch must not take longer than it takes the next one to queue up."""
    return t_in <= bs / arrival_rate


def interleave_tau(bs: int, arrival_rate: float, t_in: float, t_tr: float) -> int:
    """Integral number of training minibatches per inference cycle."""
    slack = bs / arrival_rate - t_in
    return max(0, int(math.floor(slack / t_tr)))


def train_throughput(bs: int, arrival_rate: float, t_in: float, t_tr: float) -> float:
    """theta_tr under managed interleaving (train minibatches / s)."""
    tau = interleave_tau(bs, arrival_rate, t_in, t_tr)
    return tau / (bs / arrival_rate)


# ---------------------------------------------------------------------------
# N-stream feasibility math. One stream replays the pair expressions bitwise;
# N > 1 charges each stream's service time pro-rata against the shortest
# stream period (the base interleaving cycle) and adds worst-case head-of-
# line blocking (one in-flight batch of every other tenant) to peak latency.
# ---------------------------------------------------------------------------

def multi_cycle(bss: Sequence[int], rates: Sequence[float]) -> float:
    """Base interleaving cycle: the shortest stream batch period."""
    return min(b / r for b, r in zip(bss, rates))


def multi_slack(bss: Sequence[int], rates: Sequence[float],
                t_ins: Sequence[float]) -> float:
    """Idle time per base cycle once every stream is served at its rate."""
    cycle = multi_cycle(bss, rates)
    if len(bss) == 1:                      # the exact pair expression
        return cycle - t_ins[0]
    busy = 0.0
    for b, r, t in zip(bss, rates, t_ins):
        busy += t * (cycle * r / b)        # fractional batches per cycle
    return cycle - busy


def multi_blocking(t_ins: Sequence[float], i: int) -> float:
    """Worst-case head-of-line blocking seen by stream ``i``: one batch of
    every other tenant in service/queued ahead (total-minus-own form, so the
    vectorized solver reproduces it exactly)."""
    if len(t_ins) == 1:
        return 0.0
    total = 0.0
    for t in t_ins:
        total += t
    return total - t_ins[i]


def multi_peak_latency(bss, rates, t_ins, i: int) -> float:
    """Stream ``i``'s peak latency: queueing + own service + blocking."""
    lam = peak_latency(bss[i], rates[i], t_ins[i])
    blk = multi_blocking(t_ins, i)
    return lam if blk == 0.0 else lam + blk


def multi_sustainable(bss, rates, t_ins) -> bool:
    """Every stream keeps up on its own AND the joint schedule has
    non-negative slack (a single device serves all streams)."""
    for b, r, t in zip(bss, rates, t_ins):
        if not sustainable(b, r, t):
            return False
    return len(bss) == 1 or multi_slack(bss, rates, t_ins) >= 0.0


def multi_interleave_tau(bss, rates, t_ins, t_tr: float) -> int:
    """Training minibatches per base cycle under N-stream interleaving."""
    slack = multi_slack(bss, rates, t_ins)
    return max(0, int(math.floor(slack / t_tr)))


# ---------------------------------------------------------------------------
# observed-profile solvers
# observations: {pm: (t, p)} for training; {(pm, bs): (t, p)} for inference.
# concurrent: train_obs {pm: (t,p)} + infer_obs {(pm,bs): (t,p)}
#
# These are the scalar reference implementations. For sweeps over many
# problem configurations use core.grid_eval.solve_*_batch — bitwise-identical
# vectorized counterparts that solve a whole batch as one array program.
# ---------------------------------------------------------------------------

def solve_train(problem: TrainProblem, obs: dict) -> Optional[Solution]:
    """arg max theta_tr  s.t.  p_tr <= p-hat."""
    best = None
    for pm, (t, p) in obs.items():
        if p <= problem.power_budget and (best is None or t < best.time):
            best = Solution(pm=pm, time=t, power=p, throughput=1.0 / t)
    return best


def solve_infer(problem: InferProblem, obs: dict) -> Optional[Solution]:
    """arg min lambda_in  s.t.  lambda <= budget, p <= budget, sustainable."""
    best = None
    for (pm, bs), (t, p) in obs.items():
        if p > problem.power_budget:
            continue
        if not sustainable(bs, problem.arrival_rate, t):
            continue
        lam = peak_latency(bs, problem.arrival_rate, t)
        if lam > problem.latency_budget:
            continue
        if best is None or lam < best.time:
            best = Solution(pm=pm, bs=bs, time=lam, power=p)
    return best


def solve_infer_interval(problem: InferProblem, rate_hi: float,
                         obs: dict) -> Optional[Solution]:
    """``solve_infer`` for a rate *interval*: the closed-loop controller
    plans against an estimated rate (``problem.arrival_rate``, the low end)
    but wants service headroom up to a margined ``rate_hi``. Sustainability
    must hold at the high rate (that is where the queue would build), while
    the latency budget — and the objective — are judged at the low rate,
    where the batch-fill wait ``(bs-1)/alpha`` is longest. Degenerates to
    ``solve_infer`` when ``rate_hi == arrival_rate``. Same scan order and
    first-strict-improvement tie-break as every scalar solver here."""
    best = None
    for (pm, bs), (t, p) in obs.items():
        if p > problem.power_budget:
            continue
        if not sustainable(bs, max(rate_hi, problem.arrival_rate), t):
            continue
        lam = peak_latency(bs, problem.arrival_rate, t)
        if lam > problem.latency_budget:
            continue
        if best is None or lam < best.time:
            best = Solution(pm=pm, bs=bs, time=lam, power=p)
    return best


# ---------------------------------------------------------------------------
# burst-quantile planning + drainability (§5.4 burst survival). A Poisson
# window at mean rate alpha sees alpha*T arrivals only on average; planning
# at the mean leaves every upper-tail window queueing-infeasible. These
# helpers let the closed loop plan at the window's arrival-count quantile
# and check whether a committed plan can drain the window's demand — and if
# not, how much must be shed or deferred. Pure-Python float ops, like every
# solver in this module.
# ---------------------------------------------------------------------------

def _norm_ppf(q: float) -> float:
    """Standard-normal quantile via Newton iteration on ``math.erf`` (the
    CDF is smooth and monotone, so this converges fast from 0 for any
    non-degenerate q); used only where the exact Poisson pmf underflows."""
    x = 0.0
    for _ in range(64):
        cdf = 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))
        pdf = math.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)
        if pdf <= 0.0:
            break
        step = (cdf - q) / pdf
        x -= step
        if abs(step) < 1e-12:
            break
    return x


def poisson_quantile(mean: float, q: float) -> int:
    """Smallest k with P[N <= k] >= q for N ~ Poisson(mean).

    Exact pmf summation (the recursion p_k = p_{k-1} * mean / k) while
    ``exp(-mean)`` is representable; above that (mean > ~700 — far past any
    window this repo plans) a Cornish-Fisher-corrected normal quantile
    ``mean + z*sqrt(mean) + (z^2 - 1)/6``, whose error is O(1) counts."""
    if not 0.0 <= q < 1.0:
        raise ValueError(f"quantile must be in [0, 1), got {q}")
    if mean <= 0.0:
        return 0
    if mean <= 700.0:
        p = math.exp(-mean)
        cdf, k = p, 0
        while cdf < q:
            k += 1
            p *= mean / k
            cdf += p
        return k
    z = _norm_ppf(q)
    return max(0, int(math.ceil(mean + math.sqrt(mean) * z
                                + (z * z - 1.0) / 6.0)))


def burst_rate(rate: float, duration: float, q: float) -> float:
    """The rate to size a window's service headroom for: the window's
    Poisson arrival-count q-quantile divided by the duration — never below
    the mean rate, and the mean rate itself when quantile planning is off
    (q <= 0) or the window is degenerate."""
    if q <= 0.0 or rate <= 0.0 or duration <= 0.0:
        return float(rate)
    return max(float(rate),
               poisson_quantile(float(rate) * float(duration), q)
               / float(duration))


def drain_capacity(bs: int, t_in: float, duration: float) -> int:
    """Requests a committed (bs, t_in) plan can serve within ``duration``
    seconds of exclusive managed service: full minibatches only (a trailing
    partial batch never runs, as in the engine)."""
    if duration <= 0.0:
        return 0
    if t_in <= 0.0:
        return int(1e18)
    return int(math.floor(duration / t_in)) * int(bs)


def min_shed(n_requests: int, bs: int, t_in: float, duration: float) -> int:
    """The minimal number of requests to shed (or defer past the window) so
    the remainder can drain within the window under the committed plan."""
    return max(0, int(n_requests) - drain_capacity(bs, t_in, duration))


def drainable(n_pending: int, rate: float, bs: int, t_in: float,
              duration: float) -> bool:
    """Given the carried backlog (``n_pending`` requests already queued) and
    the estimated arrival rate, can the committed plan drain the window's
    demand within the window?"""
    demand = int(n_pending) + int(math.ceil(max(0.0, float(rate))
                                            * float(duration)))
    return min_shed(demand, bs, t_in, duration) == 0


def solve_infer_capacity(power_budget: float, obs: dict) -> Optional[Solution]:
    """Graceful-degradation plan (AdmissionPolicy mode ``degrade-bs``): when
    no plan can drain the window within the latency budget, pick the highest
    service rate bs/t_in under the power budget alone — latency and
    sustainability are waived; violations are accepted to preserve goodput.
    The returned ``time`` is the plan's *service* time (not a peak latency —
    there is no rate this plan is judged against). First-scanned entry wins
    ties, as in every scalar solver here."""
    best, best_cap = None, -1.0
    for (pm, bs), (t, p) in obs.items():
        if p > power_budget:
            continue
        cap = bs / t if t > 0.0 else float("inf")
        if cap > best_cap:
            best = Solution(pm=pm, bs=bs, time=t, power=p)
            best_cap = cap
    return best


def water_fill(demands: np.ndarray, total: float) -> np.ndarray:
    """Water-filling allocation of one shared budget across demands: when
    the demands fit (``sum(demands) <= total``) every demand is met and the
    slack is split evenly; otherwise the classic level allocation
    ``min(demand_i, level)`` with the level chosen so the grants sum exactly
    to ``total`` — small demands are met in full, large demands are clipped
    to the common level. Deterministic closed form (sort + prefix sums), so
    the batched and sequential fleet drivers compute bitwise-identical
    per-device power budgets (``FleetSpec.fleet_power_budget``)."""
    d = np.asarray(demands, np.float64)
    total = float(total)
    if d.ndim != 1 or d.size == 0:
        raise ValueError("water_fill needs a 1-D, non-empty demand vector")
    if total < 0.0 or np.any(d < 0.0):
        raise ValueError("demands and total must be non-negative")
    if float(d.sum()) <= total:
        return d + (total - float(d.sum())) / d.size
    ds = np.sort(d, kind="stable")
    K = d.size
    filled = 0.0               # sum of demands already met in full
    for k in range(K):
        level = (total - filled) / (K - k)
        if level <= float(ds[k]):
            return np.minimum(d, level)
        filled += float(ds[k])
    return np.minimum(d, float(ds[-1]))     # unreachable: sum(d) > total


def solve_concurrent(problem: ConcurrentProblem, train_obs: dict,
                     infer_obs: dict) -> Optional[Solution]:
    """Primary: arg max theta_tr s.t. lambda <= budget and max(p) <= budget.
    Secondary: arg min lambda_in."""
    best = None
    for (pm, bs), (t_in, p_in) in infer_obs.items():
        if pm not in train_obs:
            continue
        t_tr, p_tr = train_obs[pm]
        p = max(p_in, p_tr)
        if p > problem.power_budget:
            continue
        if not sustainable(bs, problem.arrival_rate, t_in):
            continue
        lam = peak_latency(bs, problem.arrival_rate, t_in)
        if lam > problem.latency_budget:
            continue
        tau = interleave_tau(bs, problem.arrival_rate, t_in, t_tr)
        theta = tau / (bs / problem.arrival_rate)
        cand = Solution(pm=pm, bs=bs, tau_tr=tau, time=lam, power=p, throughput=theta)
        if best is None or (cand.throughput, -cand.time) > (best.throughput, -best.time):
            best = cand
    return best


def _stream_candidates(obs: dict, spec: StreamSpec) -> dict:
    """{pm: [(bs, t, p), ...]} in observation order, restricted to the
    spec's allowed minibatch sizes."""
    allowed = None if spec.batch_sizes is None else set(spec.batch_sizes)
    out: dict = {}
    for (pm, bs), (t, p) in obs.items():
        if allowed is not None and bs not in allowed:
            continue
        out.setdefault(pm, []).append((bs, t, p))
    return out


def solve_multi_tenant(problem: MultiTenantProblem, train_obs: Optional[dict],
                       infer_obs: Sequence[dict]) -> Optional[MultiTenantSolution]:
    """Scalar reference for the N-stream problem: scan the cross-product of
    per-stream (pm, bs) observations sharing one power mode. Primary
    objective: training throughput (worst-tenant latency when no train);
    secondary: min worst-tenant latency. With one stream this replays
    ``solve_concurrent`` / ``solve_infer`` op-for-op (bitwise contract)."""
    n = problem.n_streams
    if len(infer_obs) != n:
        raise ValueError(f"expected {n} observation sets, got {len(infer_obs)}")
    rates = [s.arrival_rate for s in problem.streams]
    spec0 = problem.streams[0]
    allowed0 = None if spec0.batch_sizes is None else set(spec0.batch_sizes)
    rest = [_stream_candidates(obs, s)
            for obs, s in zip(infer_obs[1:], problem.streams[1:])]
    weights = problem.priority_weights()
    best = None
    best_key = None
    # stream 0 scans its observations in dict order — with one stream this
    # is solve_concurrent's/solve_infer's exact scan (and tie-break) order
    for (pm, bs0), (t0, p0) in infer_obs[0].items():
        if allowed0 is not None and bs0 not in allowed0:
            continue
        if problem.train and (train_obs is None or pm not in train_obs):
            continue
        per_stream = [c.get(pm) for c in rest]
        if any(ps is None for ps in per_stream):
            continue
        t_tr = p_tr = None
        if problem.train:
            t_tr, p_tr = train_obs[pm]
        for combo in _cross(per_stream):
            bss = [bs0] + [c[0] for c in combo]
            t_ins = [t0] + [c[1] for c in combo]
            p = p0
            for c in combo:
                p = max(p, c[2])
            if p_tr is not None:
                p = max(p, p_tr)
            if p > problem.power_budget:
                continue
            if not multi_sustainable(bss, rates, t_ins):
                continue
            lams = [multi_peak_latency(bss, rates, t_ins, i)
                    for i in range(n)]
            if any(lam > s.latency_budget
                   for lam, s in zip(lams, problem.streams)):
                continue
            worst = max(lams) if weights is None \
                else max(w * lam for w, lam in zip(weights, lams))
            if problem.train:
                tau = multi_interleave_tau(bss, rates, t_ins, t_tr)
                theta = tau / multi_cycle(bss, rates)
                key = (theta, -worst)
            else:
                tau, theta = None, 0.0
                key = (-worst,)
            if best is None or key > best_key:
                best = MultiTenantSolution(pm=pm, bss=tuple(bss), tau_tr=tau,
                                           times=tuple(lams), power=p,
                                           throughput=theta)
                best_key = key
    return best


def solve_multi_tenant_interval(problem: MultiTenantProblem,
                                rate_his: Sequence[float],
                                train_obs: Optional[dict],
                                infer_obs: Sequence[dict]
                                ) -> Optional[MultiTenantSolution]:
    """``solve_multi_tenant`` for per-stream rate *intervals* — the N-stream
    counterpart of ``solve_infer_interval``. Sustainability (and the joint
    slack) must hold at each stream's margined high rate ``max(rate_hi,
    arrival_rate)``, where the queue would build; the per-stream latency
    budgets — and the latency side of the objective — are judged at the
    problem's (low-end estimate) rates, where the batch-fill wait is
    longest. The training-throughput objective is judged at the high rates
    too: the committed tau_tr is the slack *guaranteed* under the margined
    load (the engine fills conservatively regardless). Degenerates to
    ``solve_multi_tenant`` when every high rate equals the stream rate, and
    with one stream replays ``solve_infer_interval`` op-for-op. Same scan
    order and first-strict-improvement tie-break as every solver here."""
    n = problem.n_streams
    if len(rate_his) != n:
        raise ValueError(f"expected {n} high rates, got {len(rate_his)}")
    rates = [s.arrival_rate for s in problem.streams]
    his = [max(float(h), r) for h, r in zip(rate_his, rates)]
    spec0 = problem.streams[0]
    allowed0 = None if spec0.batch_sizes is None else set(spec0.batch_sizes)
    rest = [_stream_candidates(obs, s)
            for obs, s in zip(infer_obs[1:], problem.streams[1:])]
    weights = problem.priority_weights()
    best = None
    best_key = None
    for (pm, bs0), (t0, p0) in infer_obs[0].items():
        if allowed0 is not None and bs0 not in allowed0:
            continue
        if problem.train and (train_obs is None or pm not in train_obs):
            continue
        per_stream = [c.get(pm) for c in rest]
        if any(ps is None for ps in per_stream):
            continue
        t_tr = p_tr = None
        if problem.train:
            t_tr, p_tr = train_obs[pm]
        for combo in _cross(per_stream):
            bss = [bs0] + [c[0] for c in combo]
            t_ins = [t0] + [c[1] for c in combo]
            p = p0
            for c in combo:
                p = max(p, c[2])
            if p_tr is not None:
                p = max(p, p_tr)
            if p > problem.power_budget:
                continue
            if not multi_sustainable(bss, his, t_ins):
                continue
            lams = [multi_peak_latency(bss, rates, t_ins, i)
                    for i in range(n)]
            if any(lam > s.latency_budget
                   for lam, s in zip(lams, problem.streams)):
                continue
            worst = max(lams) if weights is None \
                else max(w * lam for w, lam in zip(weights, lams))
            if problem.train:
                tau = multi_interleave_tau(bss, his, t_ins, t_tr)
                theta = tau / multi_cycle(bss, his)
                key = (theta, -worst)
            else:
                tau, theta = None, 0.0
                key = (-worst,)
            if best is None or key > best_key:
                best = MultiTenantSolution(pm=pm, bss=tuple(bss), tau_tr=tau,
                                           times=tuple(lams), power=p,
                                           throughput=theta)
                best_key = key
    return best


def _cross(per_stream):
    """Cross product of per-stream candidate lists, earlier-stream-major
    (the enumeration order the vectorized solver reproduces)."""
    if not per_stream:
        yield ()
        return
    for c in per_stream[0]:
        for tail in _cross(per_stream[1:]):
            yield (c,) + tail
