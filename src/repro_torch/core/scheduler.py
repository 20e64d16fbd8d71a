"""Fulcrum: the top-level scheduler (paper Fig. 5), on the port's engine.

Counterpart of ``repro.core.scheduler`` for the plan-and-execute path:
given a workload tuple, a problem and a strategy name, Fulcrum profiles via
the strategy, commits to a (power mode [, beta_in [, tau_tr]]) plan, and
replays it with the trace-driven engine (``core.simulate``). GMD solves in
host-side scalar Python and gives the reference's plans exactly; executing
runs on ``backend="cuda"`` (default, the hand-written kernels) or
``backend="cpu"``.

It carries the reference's strategy registry: GMD for every scenario,
never cached (it is profiling), and the fitted ALS / RND / NN strategies
(``core.als``, ``core.baselines``), cached per workload tuple and reused.
Those fit their NN predictors and answer through the batched grid solvers
on ``Fulcrum(backend=...)``'s backend (``"cuda"`` by default, or
``"cpu"``), where the engine calls also run unless a call names its own
``backend``. RND's plans are the reference's exactly; ALS and NN-k pick
from float32 predictions, held to a tolerance (``core.nn_model``). The
scheduler has ``execute`` and ``execute_multi_tenant``, ``solve_dynamic``
and ``solve_dynamic_multi_tenant``, ``serve_dynamic`` in all its forms: the
open loop (all windows replayed as one engine batch), the closed loop of
``core.controller`` (rate estimation, budget feedback, backlog carryover,
mode-switch cost, admission control and mid-window splits), and their
multi-tenant counterparts over the merged-event engine; ``serve_fleet``
(``core.fleet``, the K-device fleet) and the ground-truth ``oracle``
(``core.oracle``).

The closed loop judges discrete decisions (admission, splits, feedback)
on the engine's completions, which the port computes in the engine's
tolerance tier (``docs/exactness.md``), not bitwise: a decision whose
value sits within that tolerance of its threshold can go the other way
than on the reference's NumPy tier.

Contract: solving never executes and executing never re-solves —
``execute`` replays exactly the committed plan (pm, bs, tau_tr cap).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core import problem as P
from repro_torch.core.als import (ALSConcurrent, ALSInfer, ALSMultiTenant,
                                  ALSTrain, QuadrantRanges)
from repro_torch.core.baselines import (NNConcurrentBaseline,
                                        NNInferBaseline,
                                        NNMultiTenantBaseline,
                                        NNTrainBaseline, RNDConcurrent,
                                        RNDInfer, RNDMultiTenant, RNDTrain)
from repro_torch.core.controller import ControllerConfig, ControllerState
from repro_torch.core.device_model import DeviceModel, Profiler, WorkloadProfile
from repro_torch.core.gmd import (ConcurrentProfiler, GMDConcurrent, GMDInfer,
                                  GMDMultiTenant, GMDTrain,
                                  MultiTenantProfiler)
from repro_torch.core.oracle import Oracle
from repro_torch.core.powermode import PowerModeSpace
from repro_torch.core.simulate import (ArrivalTrace, ExecutionReport,
                                       MultiTenantReport, QueueState,
                                       first_backlog_crossing, simulate,
                                       simulate_batch, simulate_multi_tenant,
                                       simulate_multi_tenant_batch)


class Scenario(enum.Enum):
    TRAIN = "train"
    INFER = "infer"
    CONCURRENT = "concurrent"
    CONCURRENT_INFERENCE = "concurrent_inference"
    DYNAMIC = "dynamic"
    MULTI_TENANT = "multi_tenant"
    FLEET = "fleet"

    @property
    def canonical(self) -> "Scenario":
        """The solver family a scenario maps onto: concurrent inference is
        the concurrent problem with the non-urgent inference in the training
        role; dynamic and fleet are per-window inference (§5.4)."""
        return _CANONICAL.get(self, self)


_CANONICAL = {Scenario.CONCURRENT_INFERENCE: Scenario.CONCURRENT,
              Scenario.DYNAMIC: Scenario.INFER,
              Scenario.FLEET: Scenario.INFER}


def as_nonurgent(w: WorkloadProfile, bs: int = 32) -> WorkloadProfile:
    """Cast an inference workload into the training role of the concurrent
    problem: a non-urgent batch inference at a fixed minibatch size (§5.4)."""
    if w.name.endswith("-nonurgent"):
        return w
    return dataclasses.replace(w, name=f"{w.name}-nonurgent", train_bs=bs)


# ---------------------------------------------------------------------------
# strategy registry: one table for every (scenario, strategy) pair
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StrategySpec:
    factory: Callable                 # (fulcrum, *workloads) -> strategy
    cached: bool = True               # fitted models are reusable; GMD is not


_REGISTRY: dict[tuple[Scenario, str], StrategySpec] = {}


def register_strategy(scenario: Scenario, name: str, factory: Callable,
                      cached: bool = True) -> None:
    _REGISTRY[(scenario, name)] = StrategySpec(factory, cached)


def available_strategies(scenario: Scenario) -> list[str]:
    canon = scenario.canonical
    return sorted(name for (sc, name) in _REGISTRY if sc is canon)


def strategy_profilers(strat) -> tuple:
    """The profiler a strategy counts its runs and cost on (its
    ``profiler``, ``cp`` or ``mp``; None for a strategy without one) and
    every single-workload profiler it feeds, in a fixed order."""
    if hasattr(strat, "profiler"):
        return strat.profiler, [strat.profiler]
    if hasattr(strat, "cp"):
        return strat.cp, [strat.cp.train, strat.cp.infer]
    if hasattr(strat, "mp"):
        return strat.mp, [strat.mp.train] + list(strat.mp.streams)
    return None, []


def _prof(f: "Fulcrum", w: WorkloadProfile) -> Profiler:
    return Profiler(f.device, w)


def _cprof(f: "Fulcrum", w_tr: WorkloadProfile,
           w_in: WorkloadProfile) -> ConcurrentProfiler:
    return ConcurrentProfiler(Profiler(f.device, w_tr),
                              Profiler(f.device, w_in))


def _mtprof(f: "Fulcrum", w_tr: Optional[WorkloadProfile],
            *stream_ws: WorkloadProfile) -> MultiTenantProfiler:
    return MultiTenantProfiler(
        Profiler(f.device, w_tr) if w_tr is not None else None,
        [Profiler(f.device, w) for w in stream_ws])


register_strategy(Scenario.TRAIN, "gmd",
                  lambda f, w: GMDTrain(_prof(f, w), f.space), cached=False)
register_strategy(Scenario.TRAIN, "als50",
                  lambda f, w: ALSTrain(_prof(f, w), f.space,
                                        nn_epochs=f.nn_epochs,
                                        backend=f.backend))
register_strategy(Scenario.TRAIN, "rnd50",
                  lambda f, w: RNDTrain(_prof(f, w), 50, f.space,
                                        backend=f.backend))
register_strategy(Scenario.TRAIN, "rnd250",
                  lambda f, w: RNDTrain(_prof(f, w), 250, f.space,
                                        backend=f.backend))
register_strategy(Scenario.TRAIN, "nn250",
                  lambda f, w: NNTrainBaseline(_prof(f, w), 250, f.space,
                                               nn_epochs=f.nn_epochs,
                                               backend=f.backend))

register_strategy(Scenario.INFER, "gmd",
                  lambda f, w: GMDInfer(_prof(f, w), f.space), cached=False)
register_strategy(Scenario.INFER, "als145",
                  lambda f, w: ALSInfer(_prof(f, w), f.quadrants, f.space,
                                        nn_epochs=f.nn_epochs,
                                        backend=f.backend))
register_strategy(Scenario.INFER, "rnd150",
                  lambda f, w: RNDInfer(_prof(f, w), 150, f.space,
                                        backend=f.backend))
register_strategy(Scenario.INFER, "rnd250",
                  lambda f, w: RNDInfer(_prof(f, w), 250, f.space,
                                        backend=f.backend))
register_strategy(Scenario.INFER, "nn250",
                  lambda f, w: NNInferBaseline(_prof(f, w), 250, f.space,
                                               nn_epochs=f.nn_epochs,
                                               backend=f.backend))

register_strategy(Scenario.CONCURRENT, "gmd",
                  lambda f, w_tr, w_in: GMDConcurrent(_cprof(f, w_tr, w_in),
                                                      f.space), cached=False)
register_strategy(Scenario.CONCURRENT, "als145",
                  lambda f, w_tr, w_in: ALSConcurrent(
                      _cprof(f, w_tr, w_in), f.quadrants, f.space,
                      nn_epochs=f.nn_epochs, backend=f.backend))
register_strategy(Scenario.CONCURRENT, "rnd150",
                  lambda f, w_tr, w_in: RNDConcurrent(
                      _cprof(f, w_tr, w_in), 150, f.space,
                      backend=f.backend))
register_strategy(Scenario.CONCURRENT, "rnd250",
                  lambda f, w_tr, w_in: RNDConcurrent(
                      _cprof(f, w_tr, w_in), 250, f.space,
                      backend=f.backend))
register_strategy(Scenario.CONCURRENT, "nn250",
                  lambda f, w_tr, w_in: NNConcurrentBaseline(
                      _cprof(f, w_tr, w_in), 250, f.space,
                      nn_epochs=f.nn_epochs, backend=f.backend))

register_strategy(Scenario.MULTI_TENANT, "gmd",
                  lambda f, w_tr, *ws: GMDMultiTenant(_mtprof(f, w_tr, *ws),
                                                      f.space), cached=False)
register_strategy(Scenario.MULTI_TENANT, "als145",
                  lambda f, w_tr, *ws: ALSMultiTenant(
                      _mtprof(f, w_tr, *ws), f.quadrants, f.space,
                      nn_epochs=f.nn_epochs, backend=f.backend))
register_strategy(Scenario.MULTI_TENANT, "rnd150",
                  lambda f, w_tr, *ws: RNDMultiTenant(
                      _mtprof(f, w_tr, *ws), 150, f.space,
                      backend=f.backend))
register_strategy(Scenario.MULTI_TENANT, "rnd250",
                  lambda f, w_tr, *ws: RNDMultiTenant(
                      _mtprof(f, w_tr, *ws), 250, f.space,
                      backend=f.backend))
register_strategy(Scenario.MULTI_TENANT, "nn250",
                  lambda f, w_tr, *ws: NNMultiTenantBaseline(
                      _mtprof(f, w_tr, *ws), 250, f.space,
                      nn_epochs=f.nn_epochs, backend=f.backend))


# ---------------------------------------------------------------------------
# plans and per-window results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Plan:
    solution: P.Solution
    strategy: str
    profiling_runs: int
    profiling_cost_s: float
    scenario: Optional[Scenario] = None


@dataclasses.dataclass
class WindowReport:
    """One §5.4 rate window: the rate (a per-stream tuple for multi-tenant
    windows), the (re)planned solution, and the engine's execution report
    (a MultiTenantReport for multi-tenant windows) over that window's
    arrival trace(s). The controller fields record how the window was
    planned: the rate it was actually planned for (the announced rate under
    the open-loop oracle configuration, the estimate under ``"ewma"``),
    whether the committed plan differs from the previous window's,
    the wall seconds charged for switching power modes into this window's
    plan, and how many backlogged requests were carried into the window.

    The burst-survival fields account for graceful degradation
    (``AdmissionPolicy``): how many of the window's offered requests were
    shed at admission, how many were deferred to the next window
    (re-submission semantics — their latency clock restarts), the goodput —
    requests served within the *nominal* latency budget as a fraction of
    the window's own offered arrivals (deferred re-offers served this
    window count toward the numerator, so a drain window can transiently
    exceed 1) — and how many times the window was split for mid-window
    re-planning."""
    rate: object                      # float | tuple[float, ...]
    solution: Optional[object]        # Solution | MultiTenantSolution
    report: Optional[object]          # ExecutionReport | MultiTenantReport
    estimated_rate: Optional[object] = None
    replanned: bool = False
    mode_switch_s: float = 0.0
    carried_requests: int = 0
    shed_requests: int = 0
    deferred_requests: int = 0
    goodput: Optional[float] = None
    offered_requests: int = 0         # the window's own arrivals
    splits: int = 0


def _poisson_seed(seed: int, window: int, stream: int, n_streams: int) -> int:
    """Collision-free per-(window, stream) Poisson trace seed: windows
    advance in strides of the stream count, so distinct (window, stream)
    pairs never share a seed. (The previous ``seed + 101*window + stream``
    scheme collided whenever a later window's low stream landed on an
    earlier window's stream index >= 101 — impossible per call today, but a
    silent trap for wider tenant counts; the stride now adapts.)"""
    return seed + window * max(1, int(n_streams)) + stream


def _open_goodput(rep, latency_budget) -> Optional[float]:
    """Open-loop goodput: requests served within the nominal budget as a
    fraction of the window's offered arrivals; ``None`` without a budget."""
    if latency_budget is None:
        return None
    if rep is None:
        return 0.0
    lats = np.asarray(rep.latencies, np.float64)
    offered = len(rep.trace) if rep.trace is not None else int(lats.size)
    good = int(np.count_nonzero(lats <= float(latency_budget)))
    return good / offered if offered else 1.0


def _replan_flags(sols: Sequence, key) -> list[bool]:
    """Whether each window's committed plan differs from the previously
    committed one (unsolved windows commit nothing)."""
    flags, prev = [], None
    for sol in sols:
        if sol is None:
            flags.append(False)
            continue
        k = key(sol)
        flags.append(k != prev)
        prev = k
    return flags


class Fulcrum:
    def __init__(self, device: Optional[DeviceModel] = None,
                 space: Optional[PowerModeSpace] = None,
                 quadrants: Optional[QuadrantRanges] = None,
                 nn_epochs: int = 400, backend: Optional[str] = None):
        """``backend`` is where the fitted strategies fit their NNs and
        solve and where the engine calls run unless a call names its own
        (None: ``"cuda"``)."""
        self.device = device or DeviceModel()
        self.space = space or PowerModeSpace()
        self.quadrants = quadrants or QuadrantRanges(latency=(0.05, 2.0),
                                                     arrival=(30.0, 120.0))
        self.nn_epochs = nn_epochs
        self.backend = backend
        self.oracle = Oracle(self.device, self.space)
        self._fitted: dict = {}     # reusable fitted strategies (ALS/RND/NN)

    # -- solve --------------------------------------------------------------
    def solve(self, scenario, workloads: Sequence[WorkloadProfile], prob,
              strategy: str = "gmd") -> Optional[Plan]:
        scenario = Scenario(scenario)
        s = self._strategy(scenario, strategy, *workloads)
        return self._plan(s.solve(prob), s, strategy, scenario)

    def solve_train(self, w: WorkloadProfile, prob: P.TrainProblem,
                    strategy: str = "gmd") -> Optional[Plan]:
        return self.solve(Scenario.TRAIN, (w,), prob, strategy)

    def solve_infer(self, w: WorkloadProfile, prob: P.InferProblem,
                    strategy: str = "gmd") -> Optional[Plan]:
        return self.solve(Scenario.INFER, (w,), prob, strategy)

    def solve_concurrent(self, w_tr: WorkloadProfile, w_in: WorkloadProfile,
                         prob: P.ConcurrentProblem,
                         strategy: str = "gmd") -> Optional[Plan]:
        return self.solve(Scenario.CONCURRENT, (w_tr, w_in), prob, strategy)

    def solve_concurrent_inference(self, w_nonurgent: WorkloadProfile,
                                   w_urgent: WorkloadProfile,
                                   prob: P.ConcurrentProblem,
                                   strategy: str = "gmd",
                                   nonurgent_bs: int = 32) -> Optional[Plan]:
        """§5.4 concurrent inferences: maximize the non-urgent inference's
        throughput under the urgent inference's latency deadline."""
        return self.solve(Scenario.CONCURRENT_INFERENCE,
                          (as_nonurgent(w_nonurgent, nonurgent_bs), w_urgent),
                          prob, strategy)

    def solve_multi_tenant(self, w_tr: Optional[WorkloadProfile],
                           prob: P.MultiTenantProblem,
                           strategy: str = "gmd") -> Optional[Plan]:
        """N tenant inference streams + a training fill workload under one
        power budget; the Plan's solution is a MultiTenantSolution."""
        ws = tuple(s.workload for s in prob.streams)
        if any(w is None for w in ws):
            raise ValueError("every StreamSpec needs a workload to solve a "
                             "multi-tenant scenario")
        if prob.train and w_tr is None:
            raise ValueError("prob.train is set but no train workload given")
        return self.solve(Scenario.MULTI_TENANT,
                          (w_tr if prob.train else None,) + ws, prob, strategy)

    def strategy_for(self, scenario, name: str, *workloads: WorkloadProfile):
        """Resolve (scenario, strategy) through the registry; fitted
        strategies are cached per workload tuple, GMD never is."""
        return self._strategy(Scenario(scenario), name, *workloads)

    def _strategy(self, scenario: Scenario, name: str,
                  *workloads: WorkloadProfile):
        if scenario is Scenario.CONCURRENT_INFERENCE:
            # the scenario's defining cast, applied regardless of entry point
            workloads = (as_nonurgent(workloads[0]),) + workloads[1:]
        spec = _REGISTRY.get((scenario.canonical, name))
        if spec is None:
            raise KeyError(
                f"no strategy {name!r} for scenario {scenario.value!r}; "
                f"available: {available_strategies(scenario)}")
        if not spec.cached:
            return spec.factory(self, *workloads)
        key = (scenario.canonical.value, name,
               tuple(w.name if w is not None else None for w in workloads))
        if key not in self._fitted:
            self._fitted[key] = spec.factory(self, *workloads)
        return self._fitted[key]

    def _plan(self, sol, strat, name, scenario=None) -> Optional[Plan]:
        if sol is None:
            return None
        prof, _ = strategy_profilers(strat)
        runs = prof.num_runs if prof is not None else 0
        cost = prof.profile_cost_s if prof is not None else 0.0
        return Plan(solution=sol, strategy=name, profiling_runs=runs,
                    profiling_cost_s=cost, scenario=scenario)

    # -- execute (trace-driven engine over the device model) ----------------
    def _backend(self, backend: Optional[str]) -> Optional[str]:
        return self.backend if backend is None else backend

    def execute(self, plan: Plan, w_in: WorkloadProfile,
                w_tr: Optional[WorkloadProfile] = None,
                arrival_rate: Optional[float] = None,
                duration: float = 120.0,
                trace: Optional[ArrivalTrace] = None,
                approach: str = "managed", seed: int = 0,
                backend: Optional[str] = None) -> ExecutionReport:
        """Execute a solved plan: its power mode and minibatch size drive the
        engine, managed slack-fill is capped at the committed tau_tr, and
        the report carries the trace that was run."""
        backend = self._backend(backend)
        if trace is None:
            if arrival_rate is None:
                raise ValueError("execute() needs an arrival_rate or a trace")
            trace = ArrivalTrace.uniform(arrival_rate, duration)
        sol = plan.solution
        if sol.bs is None:
            raise ValueError(
                f"plan ({plan.strategy}) has no inference minibatch size; "
                "solve an infer/concurrent scenario before executing")
        return simulate(self.device, w_tr, w_in, sol.pm, sol.bs, trace,
                        approach=approach, seed=seed, tau_cap=sol.tau_tr,
                        backend=backend)

    def execute_multi_tenant(self, plan: Plan, prob: P.MultiTenantProblem,
                             w_tr: Optional[WorkloadProfile] = None,
                             traces: Optional[Sequence[ArrivalTrace]] = None,
                             duration: float = 120.0,
                             arrivals: str = "uniform",
                             seed: int = 0,
                             backend: Optional[str] = None
                             ) -> MultiTenantReport:
        """Execute a multi-tenant plan: per-stream minibatch sizes drive the
        N-stream managed engine over one trace per tenant (built from each
        stream's arrival rate unless given), slack-fill capped at tau_tr."""
        backend = self._backend(backend)
        sol = plan.solution
        if not isinstance(sol, P.MultiTenantSolution):
            raise ValueError(f"plan ({plan.strategy}) is not multi-tenant; "
                             "use execute()")
        if prob.train and w_tr is None:
            raise ValueError("prob.train is set but no train workload given; "
                             "executing without it would silently drop the "
                             "plan's training fill")
        specs = prob.streams
        if traces is None:
            traces = [ArrivalTrace.uniform(s.arrival_rate, duration)
                      if arrivals == "uniform"
                      else ArrivalTrace.poisson(s.arrival_rate, duration,
                                                seed + j)
                      for j, s in enumerate(specs)]
        return simulate_multi_tenant(
            self.device, w_tr if prob.train else None,
            [s.workload for s in specs], sol.pm, sol.bss, traces,
            tau_cap=sol.tau_tr, backend=backend)

    # -- dynamic arrival rates (§5.4): re-planning controller ----------------
    def _dynamic_solver(self, w: WorkloadProfile, strategy: str
                        ) -> tuple[Callable, Optional[Callable],
                                   Optional[Callable]]:
        """One-window solvers carrying planning state across windows (the
        §5.4 reuse rules): GMD shares one profiler — cached profiles are
        free, so every window re-searches at full budget but mostly hits
        the cache; only genuinely new (pm, bs) profiles count against
        max_tries — and fitted strategies answer every window
        from one model. Returns ``(solve, interval_solve, capacity_solve)``:
        ``interval_solve(prob, rate_hi)`` plans the rate interval
        [prob.arrival_rate, rate_hi] (closed-loop margin headroom);
        ``capacity_solve(power_budget)`` returns the max-service-rate plan
        over the profiled observations (the ``degrade-bs`` admission
        fallback). Both are None for fitted strategies, which only answer
        point problems."""
        if strategy == "gmd":
            prof = Profiler(self.device, w)

            def solve(prob: P.InferProblem) -> Optional[P.Solution]:
                sol = P.solve_infer(prob, prof.observed())
                if sol is None:
                    GMDInfer(prof, self.space).solve(prob)
                    sol = P.solve_infer(prob, prof.observed())
                return sol

            def interval_solve(prob: P.InferProblem,
                               rate_hi: float) -> Optional[P.Solution]:
                sol = P.solve_infer_interval(prob, rate_hi, prof.observed())
                if sol is None:
                    # profile modes able to serve the high-rate demand,
                    # then re-scan the interval over the grown cache
                    GMDInfer(prof, self.space).solve(
                        dataclasses.replace(prob, arrival_rate=rate_hi))
                    sol = P.solve_infer_interval(prob, rate_hi,
                                                 prof.observed())
                return sol

            def capacity_solve(power_budget: float) -> Optional[P.Solution]:
                return P.solve_infer_capacity(power_budget, prof.observed())

            return solve, interval_solve, capacity_solve
        return self._strategy(Scenario.DYNAMIC, strategy, w).solve, None, None

    def solve_dynamic(self, w: WorkloadProfile, power_budget: float,
                      latency_budget: float, rates: Sequence[float],
                      strategy: str = "gmd") -> list[Optional[P.Solution]]:
        """One solution per rate window, reusing planning state across
        windows: GMD keeps its profiler cache and only re-searches/backtracks
        when the existing observations stop satisfying the new rate; fitted
        strategies are fitted once and answer every window."""
        probs = [P.InferProblem(power_budget, latency_budget, float(r))
                 for r in rates]
        if strategy != "gmd":
            strat = self._strategy(Scenario.DYNAMIC, strategy, w)
            if hasattr(strat, "solve_batch"):
                return list(strat.solve_batch(probs))
        solve, _, _ = self._dynamic_solver(w, strategy)
        return [solve(prob) for prob in probs]

    def _dynamic_multi_solver(self, specs: Sequence[P.StreamSpec],
                              strategy: str,
                              w_tr: Optional[WorkloadProfile]
                              ) -> tuple[Callable, Optional[Callable]]:
        """The multi-tenant counterpart of ``_dynamic_solver``: GMD shares
        one MultiTenantProfiler across windows; fitted strategies answer
        every window from one model. Returns ``(solve, interval_solve)`` —
        the second only for GMD, judging sustainability and training
        throughput at margined per-stream rates while the latency budgets
        hold at the unmargined estimates (``solve_multi_tenant_interval``);
        fitted strategies answer point problems only and get ``None``."""
        if strategy == "gmd":
            mp = _mtprof(self, w_tr, *[s.workload for s in specs])

            def solve(prob: P.MultiTenantProblem
                      ) -> Optional[P.MultiTenantSolution]:
                tobs = mp.train.observed_modes() if mp.train else None
                sol = P.solve_multi_tenant(prob, tobs, mp.infer_observed())
                if sol is None:
                    GMDMultiTenant(mp, self.space).solve(prob)
                    tobs = mp.train.observed_modes() if mp.train else None
                    sol = P.solve_multi_tenant(prob, tobs,
                                               mp.infer_observed())
                return sol

            def interval_solve(prob: P.MultiTenantProblem,
                               rate_his: Sequence[float]
                               ) -> Optional[P.MultiTenantSolution]:
                tobs = mp.train.observed_modes() if mp.train else None
                sol = P.solve_multi_tenant_interval(prob, rate_his, tobs,
                                                    mp.infer_observed())
                if sol is None:
                    # profile toward the margined rates so modes with that
                    # much service headroom enter the observation set
                    GMDMultiTenant(mp, self.space).solve(
                        P.MultiTenantProblem(
                            prob.power_budget,
                            tuple(dataclasses.replace(
                                s, arrival_rate=float(h))
                                for s, h in zip(prob.streams, rate_his)),
                            train=prob.train, priorities=prob.priorities))
                    tobs = mp.train.observed_modes() if mp.train else None
                    sol = P.solve_multi_tenant_interval(
                        prob, rate_his, tobs, mp.infer_observed())
                return sol

            return solve, interval_solve
        return self._strategy(Scenario.MULTI_TENANT, strategy, w_tr,
                              *[s.workload for s in specs]).solve, None

    def solve_dynamic_multi_tenant(self, specs: Sequence[P.StreamSpec],
                                   power_budget: float,
                                   rate_windows: Sequence[Sequence[float]],
                                   strategy: str = "gmd",
                                   w_tr: Optional[WorkloadProfile] = None
                                   ) -> list[Optional[P.MultiTenantSolution]]:
        """Dynamic multi-tenant re-planning: one window per per-stream rate
        vector. GMD shares one MultiTenantProfiler across windows (cached
        profiles are free, as in solve_dynamic); fitted strategies answer
        every window from one model."""
        train = w_tr is not None
        probs = [P.MultiTenantProblem(
            power_budget,
            tuple(s.with_rate(r) for s, r in zip(specs, rvec)), train=train)
            for rvec in rate_windows]
        for rvec in rate_windows:
            if len(rvec) != len(specs):
                raise ValueError("each rate window needs one rate per stream")
        if strategy != "gmd":
            strat = self._strategy(Scenario.MULTI_TENANT, strategy,
                                   w_tr if train else None,
                                   *[s.workload for s in specs])
            return list(strat.solve_batch(probs))
        solve, _ = self._dynamic_multi_solver(specs, strategy, w_tr)
        return [solve(prob) for prob in probs]

    def serve_dynamic(self, w, power_budget: float,
                      latency_budget: Optional[float], rates: Sequence,
                      strategy: str = "gmd", window_duration: float = 30.0,
                      arrivals: str = "uniform", seed: int = 0,
                      w_tr: Optional[WorkloadProfile] = None,
                      backend: Optional[str] = None,
                      controller: Optional[ControllerConfig] = None
                      ) -> list[WindowReport]:
        """Solve and *execute* a dynamic trace: re-plan per rate window, then
        run the engine over each window's arrival trace (uniform ticks or
        seeded Poisson), emitting one ExecutionReport per window.

        ``controller`` selects the loop (``core.controller``). The default
        config is *open loop* — each window planned from its announced rate
        with the nominal budget, windows independent — and windows then
        replay as one engine batch (one ``maxplus_scan`` lane per window).
        A closed-loop config (EWMA rate estimation, executed-latency
        feedback, backlog carryover, mode-switch cost) runs the windows
        sequentially in absolute time: window k+1 is planned from window
        k's executed report and resumes from its queue state.

        Multi-tenant form: pass ``w`` as a sequence of StreamSpecs (their
        latency budgets apply; ``latency_budget`` is ignored) and each entry
        of ``rates`` as a per-stream rate vector; windows then re-plan the
        N-stream problem and execute the merged trace, reporting one
        MultiTenantReport per window. Controller state (rate estimates,
        budget feedback) is kept per stream."""
        backend = self._backend(backend)
        cfg = controller if controller is not None else ControllerConfig()
        if isinstance(w, (list, tuple)) and w \
                and isinstance(w[0], P.StreamSpec):
            return self._serve_dynamic_multi(tuple(w), power_budget, rates,
                                             strategy, window_duration,
                                             arrivals, seed, w_tr, backend,
                                             cfg)
        if cfg.closed_loop:
            return self._serve_closed_loop(w, power_budget, latency_budget,
                                           rates, strategy, window_duration,
                                           arrivals, seed, backend, cfg)
        sols = self.solve_dynamic(w, power_budget, latency_budget, rates,
                                  strategy)
        lanes = []       # solved windows, executed as one engine batch
        for i, (rate, sol) in enumerate(zip(rates, sols)):
            if sol is not None:
                trace = (ArrivalTrace.uniform(rate, window_duration)
                         if arrivals == "uniform"
                         else ArrivalTrace.poisson(rate, window_duration,
                                                   seed + i))
                lanes.append((i, sol, trace))
        reps = simulate_batch(self.device, None, w,
                              [sol.pm for _, sol, _ in lanes],
                              [sol.bs for _, sol, _ in lanes],
                              [tr for _, _, tr in lanes], backend=backend)
        by_window = {i: rep for (i, _, _), rep in zip(lanes, reps)}
        replanned = _replan_flags(sols, lambda s: (s.pm, s.bs, s.tau_tr))
        return [WindowReport(float(rate), sol, by_window.get(i),
                             estimated_rate=float(rate), replanned=rp,
                             goodput=_open_goodput(by_window.get(i),
                                                   latency_budget),
                             offered_requests=len(by_window[i].trace)
                             if i in by_window
                             and by_window[i].trace is not None else 0)
                for i, (rate, sol, rp)
                in enumerate(zip(rates, sols, replanned))]

    def serve_fleet(self, w: WorkloadProfile, power_budget: float,
                    latency_budget: float, rates: Sequence[float],
                    fleet, window_duration: float = 30.0,
                    arrivals: str = "uniform", seed: int = 0,
                    backend: Optional[str] = None,
                    controller: Optional[ControllerConfig] = None):
        """``Scenario.FLEET``: serve one aggregate dynamic trace on a
        K-device heterogeneous fleet (``fleet`` is a ``core.fleet.FleetSpec``
        or a device count), dispatching each window's arrivals across
        devices and stepping all K closed-loop controller windows as one
        batched program (one batched grid solve per ladder rung, one
        ``simulate_batch`` with per-lane devices per window). Fleet-wide
        resource control is opt-in: ``controller.admission`` runs the
        deadline-drop mask per device with rejected requests shed or
        re-entering the *dispatcher* (defer), ``FleetSpec.migrate_backlog``
        re-dispatches carried backlog between windows, and
        ``FleetSpec.fleet_power_budget`` water-fills one shared cap into
        per-device budgets. Returns one ``FleetWindowReport`` per window;
        the same decisions as K sequential single-device loops
        (``fleet.serve_fleet_sequential``) for every feature combination."""
        from repro_torch.core import fleet as F
        backend = self._backend(backend)
        spec = F.FleetSpec(int(fleet)) if not isinstance(fleet, F.FleetSpec) \
            else fleet
        return F.serve_fleet(w, power_budget, latency_budget, rates, spec,
                             window_duration=window_duration,
                             arrivals=arrivals, seed=seed, backend=backend,
                             controller=controller, space=self.space)

    def _serve_closed_loop(self, w, power_budget, latency_budget, rates,
                           strategy, window_duration, arrivals, seed,
                           backend, cfg) -> list[WindowReport]:
        """Single-stream closed loop: one window at a time, in absolute
        time (window k starts at k * window_duration), each plan fed by the
        controller's rate estimate and effective budget, each executed
        report folded back into the controller state. Burst survival rides
        on top (``_closed_loop_window``): admission control trims the
        window's trace before execution, burst-quantile planning sizes the
        service headroom at the window's Poisson arrival-count quantile,
        and a backlog crossing splits the window to re-enter the controller
        early. With those knobs at their defaults the pass degenerates to
        the plain closed loop."""
        state = ControllerState(cfg, 1)
        adm = cfg.admission_policy()
        solvers = self._dynamic_solver(w, strategy)
        out: list[WindowReport] = []
        prev_key = None
        for i, rate in enumerate(rates):
            t0 = i * window_duration
            win = (ArrivalTrace.uniform(rate, window_duration)
                   if arrivals == "uniform"
                   else ArrivalTrace.poisson(rate, window_duration,
                                             seed + i)).shifted(t0)
            wr = self._closed_loop_window(
                w, power_budget, latency_budget, float(rate), win, t0,
                t0 + window_duration, window_duration, state, adm, cfg,
                solvers, backend, prev_key)
            if wr.solution is not None:
                prev_key = (wr.solution.pm, wr.solution.bs,
                            wr.solution.tau_tr)
            out.append(wr)
        return out

    def _closed_loop_window(self, w, power_budget, latency_budget, rate,
                            win, t0, t1, window_duration, state, adm, cfg,
                            solvers, backend, prev_key) -> WindowReport:
        """One announced rate window of the single-stream closed loop,
        possibly served as several sub-windows: plan, admission-trim,
        execute — and when the backlog crosses ``cfg.split_backlog``
        mid-window, replay only the prefix up to the crossing arrival (a
        prefix of the full run, by the carryover replay contract; within
        the engine tolerance on the port's engine),
        fold it into the controller state, and re-enter planning at the
        crossing. Deferred requests re-enter the next sub-window
        re-timestamped at its start."""
        solve, interval_solve, capacity_solve = solvers
        t_cur, remaining = t0, win
        splits = 0
        subs = []                 # (sol, rep, switch_s) per executed piece
        shed = deferred_out = 0
        est0 = carried0 = None
        unserved = False
        while True:
            # first sub-window: the plain loop's planning inputs (dur is the
            # announced duration, not t1 - t0, which can differ in the last
            # float ulp)
            dur = window_duration if t_cur == t0 else t1 - t_cur
            hi = state.plan_rates([rate], t_cur, dur)[0]
            # the interval's low end is the raw rate estimate — no backlog
            # compensation: once the carried backlog drains, arrivals
            # resume at the estimate, and that is the rate the batch-fill
            # wait (and so the budget check) must be judged at
            est = state.plan_rates([rate], t_cur, dur,
                                   margin=1.0, pressure=False)[0]
            if cfg.burst_quantile > 0.0:
                # survive the window's upper-tail arrival count, not just
                # its mean: service headroom sized at the Poisson quantile
                hi = max(hi, P.burst_rate(est, dur, cfg.burst_quantile))
            bud = state.plan_budgets([latency_budget])[0]
            carried = len(state.carry) if cfg.carry_backlog \
                and state.carry is not None else 0
            if est0 is None:
                est0, carried0 = est, carried
            sol = None
            if hi > est:
                # margin headroom: sustainable up to the margined rate,
                # latency budget held at the estimate — the batch-fill
                # wait (bs-1)/alpha is longest at the LOW rate, so a plan
                # sized for the high rate alone would silently break the
                # budget whenever fewer requests actually arrive. When the
                # full-margin interval is infeasible (the device cannot
                # give that much headroom and stay within budget), shrink
                # the margin rather than forfeiting all headroom at once.
                if interval_solve is not None:
                    sol = interval_solve(
                        P.InferProblem(power_budget, bud, est), hi)
                    if sol is None:
                        # dead zone: no plan serves the margined rate AND
                        # holds the budget at the estimate. Prefer the
                        # high end — an unsustainable plan floods the
                        # window (and, with carryover, taxes the next),
                        # while a too-big batch overshoots the budget by a
                        # bounded fill-wait only
                        sol = solve(P.InferProblem(power_budget, bud, hi))
                else:
                    # fitted strategies answer point problems only: take
                    # the margined plan if it passes the down-move guard
                    cand = solve(P.InferProblem(power_budget, bud, hi))
                    if cand is not None:
                        t_in = cand.time - P.queueing_time(cand.bs, hi)
                        if P.peak_latency(cand.bs, est, t_in) <= bud + 1e-12:
                            sol = cand
            if sol is None:
                sol = solve(P.InferProblem(power_budget, bud, est))
            if sol is None and bud < latency_budget:
                # a budget our own feedback tightened into infeasibility:
                # serving at the nominal budget beats not serving at all
                sol = solve(P.InferProblem(power_budget,
                                           float(latency_budget), est))
            deferred_in = state.pop_deferred(t_cur)[0] if adm.active \
                else None
            if adm.mode == "degrade-bs" and sol is not None:
                sol = self._degrade_plan(w, power_budget, sol, est, carried
                                         + (deferred_in.size
                                            if deferred_in is not None
                                            else 0),
                                         dur, hi, solve, capacity_solve)
            if sol is None:
                if deferred_in is not None and deferred_in.size:
                    # nothing serves this piece: re-defer the re-offers
                    shed += state.push_deferred([int(deferred_in.size)])
                state.observe_unserved([remaining], dur)
                unserved = True
                break
            switch_s = state.mode_switch(sol.pm)
            carry_in = state.window_carry_in(t_cur, switch_s)
            eff = remaining
            if deferred_in is not None and deferred_in.size:
                eff = ArrivalTrace.concat(
                    [ArrivalTrace(deferred_in, remaining.duration,
                                  remaining.kind), remaining],
                    duration=remaining.duration)
            run_trace, run_carry = eff, carry_in
            rej_times = None
            if adm.trims:
                t_in = self.device.time_power(w, sol.pm, sol.bs)[0]
                k0 = len(carry_in)
                all_times = np.concatenate([carry_in.pending, eff.times])
                mask = adm.admit(all_times, latency_budget, sol.bs, t_in,
                                 carry_in.clock)
                if not mask.all():
                    run_carry = QueueState(carry_in.pending[mask[:k0]],
                                           carry_in.clock)
                    run_trace = ArrivalTrace(eff.times[mask[k0:]],
                                             eff.duration, eff.kind)
                    rej_times = all_times[~mask]
            rep = simulate(self.device, None, w, sol.pm, sol.bs, run_trace,
                           "managed", tau_cap=sol.tau_tr, backend=backend,
                           carry_in=run_carry)
            split_t = None
            if cfg.split_backlog is not None and splits < cfg.max_splits:
                split_t = self._find_split(run_carry, run_trace, rep,
                                           sol.bs, cfg.split_backlog,
                                           t_cur, t1, window_duration)
            if split_t is not None:
                # serve only the prefix up to the crossing — a prefix of
                # the run above (clip keeps absolute times; the
                # chained QueueState re-enters the identical recurrence) —
                # and re-plan the remainder from the crossing
                rep = simulate(self.device, None, w, sol.pm, sol.bs,
                               run_trace.clip(t_cur, split_t), "managed",
                               tau_cap=sol.tau_tr, backend=backend,
                               carry_in=run_carry)
            t_hi = t1 if split_t is None else split_t
            if rej_times is not None:
                # admission decisions stand only for the piece that ran;
                # rejections at/after a split are re-decided next pass
                n_rej = int(np.count_nonzero(rej_times < t_hi))
                if adm.mode == "defer":
                    dropped = state.push_deferred([n_rej])
                    deferred_out += n_rej - dropped
                    shed += dropped
                else:
                    shed += n_rej
            raw_obs = remaining if split_t is None \
                else remaining.clip(t_cur, split_t)
            state.observe([raw_obs], [rep], [latency_budget],
                          dur if split_t is None else split_t - t_cur,
                          rep.queue_state)
            subs.append((sol, rep, switch_s))
            if split_t is None:
                break
            splits += 1
            t_cur = split_t
            remaining = remaining.clip(split_t, t1)
        offered = len(win)
        if not subs:
            return WindowReport(rate, None, None, estimated_rate=est0,
                                carried_requests=carried0,
                                shed_requests=shed,
                                deferred_requests=deferred_out,
                                goodput=0.0 if offered else 1.0,
                                offered_requests=offered, splits=splits)
        sol_f, rep_f, _ = subs[-1]
        if len(subs) == 1 and not unserved:
            rep, switch_total = rep_f, subs[0][2]
        else:
            lats = np.concatenate([np.asarray(r.latencies, np.float64)
                                   for _, r, _ in subs])
            rep = ExecutionReport(
                "managed", lats,
                sum(r.train_minibatches for _, r, _ in subs),
                window_duration, max(r.power for _, r, _ in subs), win,
                queue_state=rep_f.queue_state)
            switch_total = sum(s for _, _, s in subs)
        good = int(np.count_nonzero(np.asarray(rep.latencies, np.float64)
                                    <= latency_budget))
        gp = good / offered if offered else 1.0
        rep.shed_requests, rep.deferred_requests = shed, deferred_out
        rep.goodput = gp
        key = (sol_f.pm, sol_f.bs, sol_f.tau_tr)
        return WindowReport(rate, sol_f, rep, estimated_rate=est0,
                            replanned=key != prev_key,
                            mode_switch_s=switch_total,
                            carried_requests=carried0,
                            shed_requests=shed,
                            deferred_requests=deferred_out,
                            goodput=gp, offered_requests=offered,
                            splits=splits)

    def _degrade_plan(self, w, power_budget, sol, est, n_waiting, dur, hi,
                      solve, capacity_solve):
        """The ``degrade-bs`` admission mode: when the window's demand
        (carried backlog + deferred re-offers + estimated arrivals) is not
        drainable under the committed plan, swap in a higher-capacity plan
        and accept the latency violations — serve everything, degraded.
        GMD takes the max-service-rate plan over its profiled observations;
        fitted strategies (no observation dict) re-solve at the margined
        rate with the latency budget waived."""
        t_in = self.device.time_power(w, sol.pm, sol.bs)[0]
        if P.drainable(n_waiting, est, sol.bs, t_in, dur):
            return sol
        cand = capacity_solve(power_budget) if capacity_solve is not None \
            else solve(P.InferProblem(power_budget, float("inf"), hi))
        if cand is None:
            return sol
        c_t = self.device.time_power(w, cand.pm, cand.bs)[0]
        return cand if cand.bs / c_t > sol.bs / t_in else sol

    def _find_split(self, carry, trace, rep, bs, threshold, t_cur, t1,
                    window_duration):
        """Where to split a running window for mid-window re-planning: the
        timestamp of the first arrival whose backlog exceeds the threshold,
        provided it falls strictly inside the piece and leaves a meaningful
        remainder (>= 5% of the window) to re-plan."""
        bs = int(bs)
        lats = np.asarray(rep.latencies, np.float64)
        times = np.concatenate([carry.pending, trace.times]) if len(carry) \
            else trace.times
        # batch completions, recovered from the report's latencies (the
        # last request of each minibatch: latency + arrival = completion;
        # ulp-level roundtrip error cannot move a count-based crossing)
        comps = lats[bs - 1::bs] + times[bs - 1:lats.size:bs]
        idx = first_backlog_crossing(times, comps, bs, threshold)
        if idx is None:
            return None
        ts = float(times[idx])
        if ts <= t_cur or (t1 - ts) < 0.05 * window_duration:
            return None
        return ts

    def _serve_dynamic_multi(self, specs, power_budget, rate_windows,
                             strategy, window_duration, arrivals, seed,
                             w_tr, backend, cfg) -> list[WindowReport]:
        if cfg.closed_loop:
            return self._serve_multi_closed_loop(
                specs, power_budget, rate_windows, strategy, window_duration,
                arrivals, seed, w_tr, backend, cfg)
        n = len(specs)
        sols = self.solve_dynamic_multi_tenant(specs, power_budget,
                                               rate_windows, strategy, w_tr)
        lanes = []
        for i, (rvec, sol) in enumerate(zip(rate_windows, sols)):
            if sol is not None:
                traces = [ArrivalTrace.uniform(r, window_duration)
                          if arrivals == "uniform"
                          else ArrivalTrace.poisson(
                              r, window_duration, _poisson_seed(seed, i, j, n))
                          for j, r in enumerate(rvec)]
                lanes.append((i, sol, traces))
        reps = simulate_multi_tenant_batch(
            self.device, w_tr, [[s.workload for s in specs] for _ in lanes],
            [sol.pm for _, sol, _ in lanes],
            [sol.bss for _, sol, _ in lanes],
            [traces for _, _, traces in lanes],
            tau_caps=[sol.tau_tr for _, sol, _ in lanes], backend=backend)
        by_window = {i: rep for (i, _, _), rep in zip(lanes, reps)}
        replanned = _replan_flags(
            sols, lambda s: (s.pm, tuple(s.bss), s.tau_tr))
        nominals = [s.latency_budget for s in specs]
        gps, offers = {}, {}
        for (i, _, traces), rep in zip(lanes, reps):
            offered = sum(len(tr) for tr in traces)
            good = sum(int(np.count_nonzero(
                np.asarray(r.latencies, np.float64) <= nb))
                for r, nb in zip(rep.streams, nominals))
            gps[i] = good / offered if offered else 1.0
            offers[i] = offered
            rep.goodput = gps[i]
        return [WindowReport(tuple(float(r) for r in rvec), sol,
                             by_window.get(i),
                             estimated_rate=tuple(float(r) for r in rvec),
                             replanned=rp, goodput=gps.get(i, 0.0),
                             offered_requests=offers.get(i, 0))
                for i, (rvec, sol, rp)
                in enumerate(zip(rate_windows, sols, replanned))]

    def _serve_multi_closed_loop(self, specs, power_budget, rate_windows,
                                 strategy, window_duration, arrivals, seed,
                                 w_tr, backend, cfg) -> list[WindowReport]:
        """N-stream closed loop: per-stream rate estimators and feedback
        policies (each tenant's budget tightens and relaxes independently),
        one merged engine run per window with shared backlog carryover.

        Burst survival mirrors the single-stream loop: GMD plans through
        the rate-*interval* solve (``solve_multi_tenant_interval`` —
        sustainability and training throughput judged at the margined
        per-stream rates, latency budgets at the unmargined estimates;
        fitted strategies keep the point solve + down-move guard), the
        burst quantile lifts each stream's high rate to its window arrival-
        count quantile, and a ``shed``/``defer`` policy trims the merged
        arrival vector through the priority-aware multi gate before the
        engine runs. Windows are not split mid-flight here (the N-stream
        engine's merged batching makes a prefix replay stream-coupled);
        ``degrade-bs`` likewise degenerates to no trimming — both are
        single-stream refinements."""
        n = len(specs)
        state = ControllerState(cfg, n)
        adm = cfg.admission_policy()
        solve, interval_solve = self._dynamic_multi_solver(specs, strategy,
                                                           w_tr)
        nominals = [s.latency_budget for s in specs]
        train = w_tr is not None
        out: list[WindowReport] = []
        prev_key = None
        for i, rvec in enumerate(rate_windows):
            if len(rvec) != n:
                raise ValueError("each rate window needs one rate per stream")
            t0 = i * window_duration
            traces = [(ArrivalTrace.uniform(r, window_duration)
                       if arrivals == "uniform"
                       else ArrivalTrace.poisson(
                           r, window_duration,
                           _poisson_seed(seed, i, j, n))).shifted(t0)
                      for j, r in enumerate(rvec)]
            est = state.plan_rates(rvec, t0, window_duration)
            # low end raw (no backlog compensation), as in the single-
            # stream loop: the budget guard belongs at the estimate
            base = state.plan_rates(rvec, t0, window_duration, margin=1.0,
                                    pressure=False)
            if cfg.burst_quantile > 0.0:
                # survive each stream's upper-tail arrival count, not just
                # its mean: headroom sized at the Poisson window quantile
                est = [max(e, P.burst_rate(b, window_duration,
                                           cfg.burst_quantile))
                       for e, b in zip(est, base)]
            buds = state.plan_budgets(nominals)
            carried = len(state.carry) if cfg.carry_backlog \
                and state.carry is not None else 0

            def _prob(rs, bs_):
                return P.MultiTenantProblem(
                    power_budget,
                    tuple(dataclasses.replace(s, arrival_rate=float(r),
                                              latency_budget=float(b))
                          for s, r, b in zip(specs, rs, bs_)), train=train,
                    priorities=cfg.priorities)

            sol = None
            if est != base:
                if interval_solve is not None:
                    # rate-interval plan: sustainability and training
                    # throughput at the margined rates, latency budgets
                    # pinned at the unmargined estimates
                    sol = interval_solve(_prob(base, buds), est)
                    if sol is None:
                        # dead zone — prefer the high end, as in the
                        # single-stream loop: an unsustainable plan
                        # floods every stream's shared queue
                        sol = solve(_prob(est, buds))
                else:
                    # fitted strategies answer point problems only: keep
                    # the margined plan if every stream's batch-fill wait
                    # still fits its budget at the unmargined estimate
                    sol = solve(_prob(est, buds))
                    if sol is not None:
                        for lam, b_, rm, rb, bud in zip(sol.times, sol.bss,
                                                        est, base, buds):
                            t_in = lam - P.queueing_time(b_, rm)
                            if P.peak_latency(b_, rb, t_in) > bud + 1e-12:
                                sol = None
                                break
            if sol is None:
                est = base
                sol = solve(_prob(est, buds))
            if sol is None and any(b < nb
                                   for b, nb in zip(buds, nominals)):
                # feedback-tightened into infeasibility: fall back to the
                # nominal per-stream budgets rather than dropping the window
                sol = solve(P.MultiTenantProblem(
                    power_budget,
                    tuple(dataclasses.replace(s, arrival_rate=float(r))
                          for s, r in zip(specs, est)), train=train,
                    priorities=cfg.priorities))
            rate = tuple(float(r) for r in rvec)
            deferred_in = state.pop_deferred(t0) if adm.active else None
            shed = deferred_out = 0
            if sol is None:
                if deferred_in is not None:
                    # nothing serves this window: re-defer the re-offers
                    shed += state.push_deferred(
                        [int(d.size) for d in deferred_in])
                state.observe_unserved(traces, window_duration)
                offered = sum(len(tr) for tr in traces)
                out.append(WindowReport(rate, None, None,
                                        estimated_rate=tuple(est),
                                        carried_requests=carried,
                                        shed_requests=shed,
                                        goodput=0.0 if offered else 1.0,
                                        offered_requests=offered))
                continue
            switch_s = state.mode_switch(sol.pm)
            carry_in = state.window_carry_in(t0, switch_s)
            eff = traces
            if deferred_in is not None and any(d.size for d in deferred_in):
                eff = [ArrivalTrace(np.concatenate([d, tr.times]),
                                    tr.duration, tr.kind) if d.size else tr
                       for d, tr in zip(deferred_in, traces)]
            run_traces, run_carry = eff, carry_in
            rej = [0] * n
            if adm.trims:
                t_ins = [self.device.time_power(s.workload, sol.pm, b)[0]
                         for s, b in zip(specs, sol.bss)]
                pend = carry_in.pending
                psids = carry_in.stream_ids if carry_in.stream_ids \
                    is not None else np.zeros(len(pend), np.int64)
                cat_times = np.concatenate(
                    [pend] + [tr.times for tr in eff])
                cat_sids = np.concatenate(
                    [psids] + [np.full(len(tr), j, np.int64)
                               for j, tr in enumerate(eff)])
                order = np.argsort(cat_times, kind="stable")
                m_sorted = adm.admit_multi(
                    cat_times[order], cat_sids[order], sol.bss, t_ins,
                    nominals, carry_in.clock)
                mask = np.empty(cat_times.size, bool)
                mask[order] = m_sorted
                if not mask.all():
                    k0 = pend.size
                    run_carry = QueueState(pend[mask[:k0]], carry_in.clock,
                                           psids[mask[:k0]])
                    run_traces, off = [], k0
                    for j, tr in enumerate(eff):
                        mj = mask[off:off + len(tr)]
                        off += len(tr)
                        rej[j] = int(np.count_nonzero(~mj))
                        run_traces.append(
                            tr if mj.all()
                            else ArrivalTrace(tr.times[mj], tr.duration,
                                              tr.kind))
                    rej = [r + int(np.count_nonzero(~mask[:k0]
                                                    & (psids == j)))
                           for j, r in enumerate(rej)]
            rep = simulate_multi_tenant(
                self.device, w_tr if train else None,
                [s.workload for s in specs], sol.pm, sol.bss, run_traces,
                tau_cap=sol.tau_tr, backend=backend, carry_in=run_carry)
            if any(rej):
                if adm.mode == "defer":
                    dropped = state.push_deferred(rej)
                    deferred_out += sum(rej) - dropped
                    shed += dropped
                else:
                    shed += sum(rej)
            state.observe(traces, rep.streams, nominals, window_duration,
                          rep.queue_state)
            offered = sum(len(tr) for tr in traces)
            good = sum(int(np.count_nonzero(
                np.asarray(r.latencies, np.float64) <= nb))
                for r, nb in zip(rep.streams, nominals))
            gp = good / offered if offered else 1.0
            rep.shed_requests, rep.deferred_requests = shed, deferred_out
            rep.goodput = gp
            key = (sol.pm, tuple(sol.bss), sol.tau_tr)
            out.append(WindowReport(rate, sol, rep,
                                    estimated_rate=tuple(est),
                                    replanned=key != prev_key,
                                    mode_switch_s=switch_s,
                                    carried_requests=carried,
                                    shed_requests=shed,
                                    deferred_requests=deferred_out,
                                    goodput=gp, offered_requests=offered))
            prev_key = key
        return out
