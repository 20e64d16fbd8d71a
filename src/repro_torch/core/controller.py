"""Closed-loop dynamic serving controller (paper §5.4), on the port.

Counterpart of ``repro.core.controller``, host float64 code copied from it
so that it gives the reference's bits on the same inputs.
``Fulcrum.serve_dynamic`` re-plans once per rate window; this module holds
the state that closes the loop:

 * ``RateEstimator`` — the rate to plan the next window for: ``"oracle"``
   passes the announced rate through, ``"ewma"`` estimates it from the
   observed arrival timestamps of executed windows (an EWMA over
   inter-arrival gaps, warm-started across windows).
 * ``FeedbackPolicy`` — the latency budget to plan the next window
   against: a scale in (0, 1] tightened when the previous window's
   *executed* violation rate or tail broke the budget, relaxed back toward
   nominal while windows run clean.
 * ``AdmissionPolicy`` — burst survival: the deadline-drop mask
   (``_admit_mask``, ``_admit_mask_multi``) runs the managed engine's own
   batching recurrence over the admitted subsequence, and ``gate`` applies
   it to a trace for the real runtime.
 * ``ControllerState`` — one estimator and one policy per stream, the
   carried ``QueueState``, the deferred backlog, and the previous power
   mode for mode-switch accounting.

``FleetControllerState`` holds one ``ControllerState`` per device of a
K-device fleet and the fleet's deferred backlog (``core.fleet``).

``ControllerConfig`` bundles the knobs; its defaults are the open loop
(``closed_loop`` is False). The admission mask is exact
against the engine it imitates only where that engine is bitwise (the
reference's NumPy tier); the port's engine is in the tolerance tier, so an
admitted request meets its budget to within that tolerance.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.simulate import ArrivalTrace, QueueState

_ESTIMATORS = ("oracle", "ewma")
_ADMISSIONS = ("none", "shed", "defer", "degrade-bs")


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Knobs of one closed-loop dynamic serving run.

    The defaults are the open-loop §5.4 configuration (oracle rates, no
    feedback, no backlog carryover, free mode switches) — ``closed_loop``
    is then False and ``serve_dynamic`` replays all windows as one engine
    batch."""
    rate_estimator: str = "oracle"   # "oracle" (announced) | "ewma" (observed)
    ewma_alpha: float = 0.01         # per-gap EWMA weight; effective memory
    #   is ~(2-alpha)/alpha gaps (~200 at the default — a few seconds of
    #   arrivals at paper rates, so the estimate still turns over well
    #   within one window but averages enough exponential gaps to hold its
    #   relative error near 1/sqrt(ESS) ~ 7% on Poisson traces)
    rate_margin: float = 1.0         # plan for margin * estimated rate
    feedback: bool = False           # executed-latency budget feedback
    tighten: float = 0.5             # max fractional budget cut per window
    relax: float = 0.5               # recovery fraction toward nominal
    target_violation: float = 0.0    # tolerated executed violation rate
    tail_quantile: float = 0.95      # executed tail the policy reacts to
    min_budget_scale: float = 0.2    # effective budget floor (x nominal)
    mode_switch_s: float = 0.0       # wall cost charged when the pm changes
    carry_backlog: bool = False      # chain QueueState across windows
    # -- burst survival (admission control + mid-window re-planning) --------
    admission: str = "none"          # AdmissionPolicy mode (see _ADMISSIONS)
    admission_headroom: float = 1.0  # admit against headroom * nominal budget
    burst_quantile: float = 0.0      # plan service headroom at the window's
    #   Poisson arrival-count quantile (0 = plan at the mean-rate estimate)
    split_backlog: Optional[int] = None   # re-enter the controller when the
    #   backlog crosses this mid-window (None = window boundaries only)
    max_splits: int = 2              # re-planning splits per window, at most
    defer_cap: Optional[int] = None  # max deferred backlog (overflow is shed)
    priorities: Optional[tuple] = None    # per-stream admission priorities
    #   (multi-tenant hook: lower-priority streams shed earlier)

    def __post_init__(self):
        if self.rate_estimator not in _ESTIMATORS:
            raise ValueError(f"unknown rate estimator "
                             f"{self.rate_estimator!r}; use {_ESTIMATORS}")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if self.rate_margin <= 0.0:
            raise ValueError("rate_margin must be positive")
        if not 0.0 <= self.tighten <= 1.0 or not 0.0 <= self.relax <= 1.0:
            raise ValueError("tighten/relax must be in [0, 1]")
        if not 0.0 < self.min_budget_scale <= 1.0:
            raise ValueError("min_budget_scale must be in (0, 1]")
        if self.mode_switch_s < 0.0:
            raise ValueError("mode_switch_s must be >= 0")
        if self.admission not in _ADMISSIONS:
            raise ValueError(f"unknown admission mode {self.admission!r}; "
                             f"use {_ADMISSIONS}")
        if self.admission_headroom <= 0.0:
            raise ValueError("admission_headroom must be positive")
        if not 0.0 <= self.burst_quantile < 1.0:
            raise ValueError("burst_quantile must be in [0, 1)")
        if self.split_backlog is not None and self.split_backlog <= 0:
            raise ValueError("split_backlog must be positive (or None)")
        if self.max_splits < 0:
            raise ValueError("max_splits must be >= 0")
        if self.defer_cap is not None and self.defer_cap < 0:
            raise ValueError("defer_cap must be >= 0 (or None)")
        if self.priorities is not None:
            pr = tuple(float(p) for p in self.priorities)
            if not pr or any(p <= 0.0 for p in pr):
                raise ValueError("priorities must be positive floats")
            object.__setattr__(self, "priorities", pr)

    @property
    def closed_loop(self) -> bool:
        """True when any knob makes window k+1 depend on window k."""
        return (self.rate_estimator != "oracle" or self.rate_margin != 1.0
                or self.feedback or self.carry_backlog
                or self.mode_switch_s > 0.0
                or self.admission != "none" or self.burst_quantile > 0.0
                or self.split_backlog is not None)

    def admission_policy(self) -> "AdmissionPolicy":
        """The config's admission knobs bundled for the serving loops."""
        return AdmissionPolicy(self.admission, self.admission_headroom,
                               self.priorities)


# ---------------------------------------------------------------------------
# SLO-aware admission control (§5.4 burst survival)
# ---------------------------------------------------------------------------

def _admit_mask(times: np.ndarray, budgets: np.ndarray, bs: int, t_in: float,
                clock: float) -> np.ndarray:
    """Deadline-drop admission over one window's effective arrivals (carried
    pending requests first, then the window's own — exactly the vector the
    managed engine would run). A virtual copy of the engine runs the same
    recurrence over the *admitted* subsequence: ``clock`` is when the device
    frees up, ``batch`` the forming minibatch's member indices. Whenever the
    batch fills, its completion is ``max(clock, ready) + t_in`` — the
    engine's own fold — and the oldest members whose wait already exceeds
    their budget are dropped (deadline-expired work is shed rather than
    served late, the classic load-shedding rule, implementable online
    because a member's deadline passes *before* the batch it slows down
    commits). Dropping re-opens the batch, so the next arrival both refills
    it and re-times it; the batch only commits when every member meets its
    budget. The admitted subsequence therefore replays through the engine
    with zero violations by construction on a bitwise engine (the
    reference's NumPy tier); the port's engine reassociates its sums, so
    there the admitted latencies meet the budget within the engine
    tolerance. On an uncongested feasible window nothing drops.

    Rejected requests never occupy a batch slot: admission is what keeps
    the virtual queue inside the budget, which is why admitted-request
    satisfaction holds even when the offered load cannot drain. A trailing
    partial batch is admitted untouched — the engine carries it to the next
    window, where the next admission pass re-judges it as backlog."""
    times = np.asarray(times, np.float64)
    n = times.size
    admit = np.ones(n, bool)
    if n == 0:
        return admit
    budgets = np.asarray(budgets, np.float64)
    c = float(clock)
    bs, t_in = int(bs), float(t_in)
    batch: list[int] = []
    for i in range(n):
        batch.append(i)
        if len(batch) < bs:
            continue
        comp = max(c, float(times[i])) + t_in
        while batch and (comp - float(times[batch[0]])
                         > float(budgets[batch[0]]) + 1e-12):
            admit[batch.pop(0)] = False
        if len(batch) == bs:
            c = comp
            batch = []
    return admit


def _admit_mask_multi(times: np.ndarray, sids: np.ndarray,
                      bss: Sequence[int], t_ins: Sequence[float],
                      budgets: np.ndarray, clock: float) -> np.ndarray:
    """N-stream form of ``_admit_mask``: one shared virtual device clock
    (every tenant's batches serialize on the accelerator, so congestion in
    one stream delays all), per-stream forming batches. ``budgets`` is
    per-*request* (the policy bakes priorities in before calling),
    ``times``/``sids`` must be time-sorted."""
    times = np.asarray(times, np.float64)
    n = times.size
    admit = np.ones(n, bool)
    if n == 0:
        return admit
    sids = np.asarray(sids, np.int64)
    budgets = np.asarray(budgets, np.float64)
    bss = [int(b) for b in bss]
    t_ins = [float(t) for t in t_ins]
    batches: list[list[int]] = [[] for _ in bss]
    c = float(clock)
    for i in range(n):
        j = int(sids[i])
        batches[j].append(i)
        if len(batches[j]) < bss[j]:
            continue
        comp = max(c, float(times[i])) + t_ins[j]
        while batches[j] and (comp - float(times[batches[j][0]])
                              > float(budgets[batches[j][0]]) + 1e-12):
            admit[batches[j].pop(0)] = False
        if len(batches[j]) == bss[j]:
            c = comp
            batches[j] = []
    return admit


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """SLO-aware admission control for the closed-loop serving loops.

    Modes:
     * ``"none"``    — admit everything (the plain closed loop).
     * ``"shed"``    — drop requests whose predicted completion under the
       committed plan cannot meet the latency budget (load the window
       provably cannot drain), including carried backlog already past it.
     * ``"defer"``   — same predictor, but rejected requests re-enter the
       next (sub-)window re-timestamped at its start: re-submission
       semantics — the latency clock restarts, and the config's
       ``defer_cap`` bounds the deferred backlog (overflow is shed).
     * ``"degrade-bs"`` — trim nothing; when the window's demand is not
       drainable under the committed plan, swap in the max-service-rate
       plan (``problem.solve_infer_capacity``) and accept the violations:
       the goodput-over-latency end of the tradeoff curve.

    ``headroom`` scales the admission threshold (< 1 rejects earlier,
    buying slack against fill-time variance). ``priorities`` is the
    multi-tenant hook: per-stream positive weights, normalized to the
    largest; a stream's admission budget is scaled by its weight, so as the
    shared queue builds, lower-priority streams start shedding while
    higher-priority tenants still admit."""
    mode: str = "none"
    headroom: float = 1.0
    priorities: Optional[tuple] = None

    def __post_init__(self):
        if self.mode not in _ADMISSIONS:
            raise ValueError(f"unknown admission mode {self.mode!r}; "
                             f"use {_ADMISSIONS}")
        if self.headroom <= 0.0:
            raise ValueError("admission headroom must be positive")

    @property
    def active(self) -> bool:
        return self.mode != "none"

    @property
    def trims(self) -> bool:
        """Whether this mode removes requests from the window's trace."""
        return self.mode in ("shed", "defer")

    def stream_budget_scales(self, n_streams: int) -> np.ndarray:
        """Per-stream admission-budget scales: headroom times the priority
        weight (normalized so the highest-priority stream keeps the full
        headroom). All-ones priorities when none are configured."""
        if self.priorities is None:
            pr = np.ones(n_streams)
        else:
            if len(self.priorities) != n_streams:
                raise ValueError(f"{len(self.priorities)} priorities for "
                                 f"{n_streams} streams")
            pr = np.asarray(self.priorities, np.float64)
            pr = pr / pr.max()
        return self.headroom * pr

    def admit(self, times: np.ndarray, nominal_budget: float, bs: int,
              t_in: float, clock: float) -> np.ndarray:
        """Single-stream admission mask over the effective arrival vector."""
        buds = np.full(np.asarray(times).shape[0] if np.ndim(times) else 0,
                       self.headroom * float(nominal_budget))
        return _admit_mask(times, buds, bs, t_in, clock)

    def admit_multi(self, times: np.ndarray, sids: np.ndarray,
                    bss: Sequence[int], t_ins: Sequence[float],
                    nominal_budgets: Sequence[float],
                    clock: float) -> np.ndarray:
        """Multi-tenant admission mask over time-sorted merged arrivals."""
        scales = self.stream_budget_scales(len(nominal_budgets))
        per_stream = scales * np.asarray(nominal_budgets, np.float64)
        sids = np.asarray(sids, np.int64)
        buds = per_stream[sids] if sids.size else np.empty(0)
        return _admit_mask_multi(times, sids, bss, t_ins, buds, clock)

    def gate(self, bs: int, t_in: float, budget: float):
        """A trace-trimming callable for the real runtime
        (``runtime.interleave_runtime``): ``gate(trace) -> (admitted_trace,
        n_shed)`` applying exactly the engine-side admission mask, so a
        runtime run under a FakeClock sheds the identical request set."""
        def _gate(trace):
            if not self.trims:
                return trace, 0
            mask = self.admit(trace.times, budget, bs, t_in, 0.0)
            if mask.all():
                return trace, 0
            return (ArrivalTrace(trace.times[mask], trace.duration,
                                 trace.kind),
                    int(np.count_nonzero(~mask)))
        return _gate


class RateEstimator:
    """Arrival-rate estimate for one stream, fed by executed windows.

    ``"oracle"`` returns the announced rate untouched. ``"ewma"`` keeps an
    exponentially weighted moving average of observed inter-arrival gaps
    (per-gap weight ``alpha``), warm-started across windows: the mean gap —
    and the last arrival timestamp, so the gap spanning a window boundary
    counts too — carries from window to window, and the estimate is its
    reciprocal. Before anything was observed (window 0) the announced rate
    bootstraps the estimate. A window with fewer than two arrivals folds one
    right-censored pseudo-gap equal to the window duration, so idle windows
    decay the estimate instead of pinning it."""

    def __init__(self, kind: str = "ewma", alpha: float = 0.2):
        if kind not in _ESTIMATORS:
            raise ValueError(f"unknown rate estimator {kind!r}; "
                             f"use {_ESTIMATORS}")
        self.kind = kind
        self.alpha = float(alpha)
        self._mean_gap: Optional[float] = None
        self._last_arrival: Optional[float] = None

    def estimate(self, announced_rate: float) -> float:
        """The rate to plan the next window for."""
        if self.kind == "oracle" or self._mean_gap is None:
            return float(announced_rate)
        return 1.0 / self._mean_gap if self._mean_gap > 0.0 else 0.0

    def observe(self, times: np.ndarray, duration: float) -> None:
        """Fold one executed window's observed arrival timestamps (this
        window's own arrivals only — carried-over requests were observed by
        the window they arrived in) into the estimate."""
        if self.kind == "oracle":
            return
        times = np.asarray(times, np.float64)
        gaps = np.diff(times)
        if (self._last_arrival is not None and times.size
                and times[0] > self._last_arrival):
            gaps = np.concatenate([[times[0] - self._last_arrival], gaps])
        if times.size:
            self._last_arrival = float(times[-1])
        if gaps.size == 0:
            gaps = np.array([float(duration)])
            if times.size == 0:
                # the idle span is folded as this pseudo-gap; drop the
                # boundary anchor so the next window's first arrival does
                # not fold the same span again as a real gap
                self._last_arrival = None
        if self._mean_gap is None:
            m, gaps = float(gaps[0]), gaps[1:]
        else:
            m = self._mean_gap
        if gaps.size:
            # exact EWMA over the gap sequence, vectorized:
            # m <- (1-a)^n m + a * sum_i (1-a)^(n-1-i) g_i
            a = self.alpha
            decay = (1.0 - a) ** np.arange(gaps.size - 1, -1, -1)
            m = (1.0 - a) ** gaps.size * m + a * float(decay @ gaps)
        self._mean_gap = m


class FeedbackPolicy:
    """Effective-latency-budget governor for one stream.

    State is ``scale`` in (0, 1]: the next window is planned against
    ``scale * nominal`` while the *executed* violation rate is judged
    against the nominal budget. After each executed window:

     * violating (rate above ``target_violation``): multiply the scale by
       ``1 - tighten * severity`` where severity is the larger of the
       executed violation rate and the executed tail's fractional overshoot
       of the nominal budget, both clipped to 1 — monotone in the violation
       rate, floored at ``min_budget_scale``. The cut is deliberately
       *bounded per window* (at most a ``tighten`` fraction): a queue-
       flooded window can report tails orders of magnitude over budget, and
       jumping the scale straight to ``nominal/tail`` would demand plans no
       power mode can deliver (the next window would go unserved, worse
       than the violation being corrected).
     * clean: move the scale back toward 1 by ``relax`` of the remaining
       gap (never above nominal).

    With ``feedback`` off the policy is inert (scale pinned at 1)."""

    def __init__(self, cfg: ControllerConfig):
        self.cfg = cfg
        self.scale = 1.0

    def effective_budget(self, nominal: float) -> float:
        return float(nominal) * self.scale

    def update(self, violation_rate: float, tail_latency: float,
               nominal: float) -> None:
        if not self.cfg.feedback:
            return
        c = self.cfg
        if violation_rate > c.target_violation:
            overshoot = float(tail_latency) / max(float(nominal), 1e-12) - 1.0
            severity = min(1.0, max(float(violation_rate),
                                    min(1.0, max(0.0, overshoot))))
            self.scale = max(c.min_budget_scale,
                             self.scale * (1.0 - c.tighten * severity))
        else:
            self.scale = min(1.0, self.scale + c.relax * (1.0 - self.scale))


class ControllerState:
    """Cross-window state of one closed-loop serving run: per-stream
    rate estimators and feedback policies, the carried queue state, and the
    previously committed power mode."""

    def __init__(self, cfg: ControllerConfig, n_streams: int = 1):
        self.cfg = cfg
        self.estimators = [RateEstimator(cfg.rate_estimator, cfg.ewma_alpha)
                           for _ in range(n_streams)]
        self.policies = [FeedbackPolicy(cfg) for _ in range(n_streams)]
        self.carry: Optional[QueueState] = None
        self.prev_pm = None
        # deferred-request backlog (AdmissionPolicy mode "defer"): per-stream
        # counts only — a deferred request re-enters re-timestamped at the
        # next (sub-)window start, so its original arrival time is moot
        self.deferred = np.zeros(n_streams, np.int64)

    # -- deferred requests (admission mode "defer") --------------------------
    def push_deferred(self, counts: Sequence[int]) -> int:
        """Queue per-stream rejected-request counts for re-submission at the
        next (sub-)window start. The config's ``defer_cap`` bounds the total
        deferred backlog — without it, sustained overload would snowball the
        re-offer queue forever; overflow is trimmed from the streams with
        the largest deferred counts and returned (the loop records it as
        shed)."""
        self.deferred = self.deferred + np.asarray(counts, np.int64)
        cap = self.cfg.defer_cap
        dropped = 0
        if cap is not None:
            total = int(self.deferred.sum())
            while total > cap:
                j = int(np.argmax(self.deferred))
                take = min(int(self.deferred[j]), total - cap)
                self.deferred[j] -= take
                total -= take
                dropped += take
        return dropped

    def pop_deferred(self, t0: float) -> list[np.ndarray]:
        """The deferred backlog re-submitted at ``t0``: one arrival vector
        per stream, every request re-timestamped to the (sub-)window start
        (its latency clock restarts at re-submission). Clears the backlog —
        requests the next admission pass rejects again are re-deferred (or
        shed) by the loop."""
        out = [np.full(int(c), float(t0)) for c in self.deferred]
        self.deferred = np.zeros_like(self.deferred)
        return out

    # -- planning inputs ----------------------------------------------------
    def plan_rates(self, announced: Sequence[float], t0: float = 0.0,
                   duration: Optional[float] = None,
                   margin: Optional[float] = None,
                   pressure: bool = True) -> list[float]:
        """Per-stream rates to plan the next window for: the margin-scaled
        estimate, compensated for queue pressure when backlog carries — a
        window starting at ``t0`` that inherits a clock overrun has only
        ``duration - overrun`` seconds to serve both its own arrivals and
        the carried pending requests, so the plan must sustain
        ``(rate * duration + pending) / (duration - overrun)`` to drain the
        backlog within the window (overrun capped at 90% of the window, or
        the required rate would explode). ``margin`` overrides the config's
        rate margin; ``pressure=False`` skips the backlog compensation —
        the loops use that for the latency-budget side of an interval
        plan, where the *true* arrival-rate estimate governs the batch-fill
        wait once the backlog has drained."""
        m = self.cfg.rate_margin if margin is None else float(margin)
        rates = [m * e.estimate(r)
                 for e, r in zip(self.estimators, announced)]
        if (not pressure or not self.cfg.carry_backlog or self.carry is None
                or duration is None or duration <= 0.0):
            return rates
        overrun = max(0.0, min(0.9 * float(duration),
                               float(self.carry.clock) - float(t0)))
        avail = float(duration) - overrun
        return [(r * float(duration) + len(self.carry.pending_for(j)))
                / avail for j, r in enumerate(rates)]

    def plan_budgets(self, nominal: Sequence[float]) -> list[float]:
        """Per-stream effective latency budgets for the next plan."""
        return [p.effective_budget(b)
                for p, b in zip(self.policies, nominal)]

    # -- mode-switch accounting ---------------------------------------------
    def mode_switch(self, pm) -> float:
        """Commit to a power mode; the wall cost this window pays for
        switching into it (0 for the first window — nothing to switch
        from — and while the mode is unchanged)."""
        cost = self.cfg.mode_switch_s \
            if self.prev_pm is not None and pm != self.prev_pm else 0.0
        self.prev_pm = pm
        return cost

    # -- engine carry-in ----------------------------------------------------
    def window_carry_in(self, t0: float, switch_s: float) -> QueueState:
        """The engine's carry-in for a window starting at ``t0``: the carried
        backlog (when enabled) with the clock advanced by the mode-switch
        cost — the engine may not serve before the switch completes."""
        pending, ids, clock = np.empty(0), None, float(t0)
        if self.cfg.carry_backlog and self.carry is not None:
            pending, ids = self.carry.pending, self.carry.stream_ids
            clock = max(float(self.carry.clock), clock)
        return QueueState(pending, clock + float(switch_s), ids)

    def observe_unserved(self, traces: Sequence, duration: float) -> None:
        """An unsolvable window: nothing serves, but arrivals were still
        observable (the estimators fold them in) and, with carryover
        enabled, they queue for the next solvable window."""
        for est, tr in zip(self.estimators, traces):
            est.observe(tr.times, duration)
        self.defer_window(traces)

    def defer_window(self, traces: Sequence) -> None:
        """Queue an unserved window's arrivals into the carried backlog
        (backlogged requests do not vanish); no-op with carryover off."""
        if not self.cfg.carry_backlog:
            return
        carry = self.carry if self.carry is not None \
            else QueueState(np.empty(0), 0.0, np.empty(0, np.int64))
        times = np.concatenate([carry.pending] + [t.times for t in traces])
        ids = np.concatenate(
            [carry.stream_ids if carry.stream_ids is not None
             else np.zeros(len(carry.pending), np.int64)]
            + [np.full(len(t), j, np.int64) for j, t in enumerate(traces)])
        order = np.argsort(times, kind="stable")
        self.carry = QueueState(times[order], carry.clock, ids[order])

    # -- executed-window feedback -------------------------------------------
    def observe(self, traces: Sequence, reports: Sequence,
                nominal_budgets: Sequence[float], duration: float,
                queue_state: Optional[QueueState]) -> None:
        """Fold one executed window back into the state: per-stream arrival
        observations (the window's own trace, not carried requests),
        executed violation/tail feedback against the *nominal* budgets, and
        the end-of-window queue state."""
        for est, pol, tr, rep, bud in zip(self.estimators, self.policies,
                                          traces, reports, nominal_budgets):
            est.observe(tr.times, duration)
            pol.update(rep.violation_rate(bud),
                       rep.latency_quantile(self.cfg.tail_quantile), bud)
        self.carry = queue_state


class FleetControllerState:
    """Array-of-struct controller state for a K-device fleet
    (``Scenario.FLEET``): device ``d`` is governed by exactly the scalar
    ``ControllerState(cfg, 1)`` a standalone single-device closed loop
    would hold, so parity with K sequential loops is by construction —
    same estimator floats, same feedback scales, same carried queue
    states. The ``plan_*`` methods return per-device arrays the batched
    fleet planner consumes; this O(K) Python bookkeeping is negligible
    against the batched solve + batched simulate it feeds (measured in
    ``benchmarks/bench_fleet.py``)."""

    def __init__(self, cfg: ControllerConfig, n_devices: int):
        if n_devices <= 0:
            raise ValueError("a fleet needs at least one device")
        self.cfg = cfg
        self.devices = [ControllerState(cfg, 1) for _ in range(n_devices)]
        # fleet-level deferred backlog (admission mode "defer"): unlike the
        # per-device ``ControllerState.deferred`` counters, a request a
        # device rejects re-enters the *dispatcher* at the next window
        # start — it may land on any device, not the one it bounced off
        self.fleet_deferred = 0

    def __len__(self) -> int:
        return len(self.devices)

    # -- fleet-level deferred requests (admission mode "defer") -------------
    def push_fleet_deferred(self, n: int) -> int:
        """Queue ``n`` rejected requests for fleet-wide re-submission at the
        next window start (they re-enter the dispatcher, re-timestamped).
        The config's ``defer_cap`` bounds the fleet's total deferred
        backlog; the overflow is returned for the serving loop to record as
        shed — charged, like the per-device counters, to the device that
        pushed it."""
        self.fleet_deferred += int(n)
        cap = self.cfg.defer_cap
        if cap is None or self.fleet_deferred <= cap:
            return 0
        dropped = self.fleet_deferred - cap
        self.fleet_deferred = cap
        return dropped

    def pop_fleet_deferred(self) -> int:
        """Drain the fleet's deferred backlog for re-dispatch: the count of
        requests to prepend (re-timestamped at the window start) to the next
        window's aggregate arrivals. Requests the next admission pass
        rejects again are re-deferred (or shed) by the serving loop."""
        n, self.fleet_deferred = self.fleet_deferred, 0
        return n

    def plan_rates(self, announced: Sequence[float], t0: float = 0.0,
                   duration: Optional[float] = None,
                   margin: Optional[float] = None,
                   pressure: bool = True) -> np.ndarray:
        """Per-device planning rates (one announced rate per device)."""
        return np.array([st.plan_rates([r], t0, duration, margin=margin,
                                       pressure=pressure)[0]
                         for st, r in zip(self.devices, announced)])

    def plan_budgets(self, nominal: Sequence[float]) -> np.ndarray:
        """Per-device effective latency budgets."""
        return np.array([st.plan_budgets([b])[0]
                         for st, b in zip(self.devices, nominal)])

    def mode_switch(self, d: int, pm) -> float:
        """Commit device ``d`` to a power mode (solved devices only — an
        unsolved device keeps its previous mode, as in the scalar loop)."""
        return self.devices[d].mode_switch(pm)

    def window_carry_in(self, d: int, t0: float, switch_s: float) -> QueueState:
        return self.devices[d].window_carry_in(t0, switch_s)

    def observe(self, d: int, trace, report, nominal_budget: float,
                duration: float, queue_state: Optional[QueueState]) -> None:
        self.devices[d].observe([trace], [report], [nominal_budget],
                                duration, queue_state)

    def observe_unserved(self, d: int, trace, duration: float) -> None:
        self.devices[d].observe_unserved([trace], duration)
