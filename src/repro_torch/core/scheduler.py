"""Fulcrum: the top-level scheduler (paper Fig. 5), on the port's engine.

Counterpart of ``repro.core.scheduler`` for the plan-and-execute path:
given a workload tuple, a problem and a strategy name, Fulcrum profiles via
the strategy, commits to a (power mode [, beta_in [, tau_tr]]) plan, and
replays it with the trace-driven engine (``core.simulate``). Solving is
host-side scalar Python and gives the reference's plans exactly; executing
runs on ``backend="cuda"`` (default, the hand-written kernels) or
``backend="cpu"``.

This slice carries the GMD strategy of every scenario (the fitted ALS / RND
/ NN strategies need the NN predictor, not ported yet: asking for them
raises the reference's ``KeyError``), ``execute``, ``solve_dynamic``, and
``serve_dynamic``'s open loop (all windows replayed as one
``simulate_batch``). The closed loop and the multi-tenant engine are later
slices; ``serve_dynamic`` raises ``NotImplementedError`` for them.

Contract: solving never executes and executing never re-solves —
``execute`` replays exactly the committed plan (pm, bs, tau_tr cap).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core import problem as P
from repro_torch.core.device_model import DeviceModel, Profiler, WorkloadProfile
from repro_torch.core.gmd import (ConcurrentProfiler, GMDConcurrent, GMDInfer,
                                  GMDMultiTenant, GMDTrain,
                                  MultiTenantProfiler)
from repro_torch.core.powermode import PowerModeSpace
from repro_torch.core.simulate import (ArrivalTrace, ExecutionReport,
                                       simulate, simulate_batch)


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

# (scenario, name) -> factory(fulcrum, *workloads) -> strategy. GMD is
# profiling itself, so every solve builds a fresh strategy.
_REGISTRY: dict[tuple[Scenario, str], Callable] = {}


def register_strategy(scenario: Scenario, name: str,
                      factory: Callable) -> None:
    _REGISTRY[(scenario, name)] = factory


def available_strategies(scenario: Scenario) -> list[str]:
    canon = scenario.canonical
    return sorted(name for (sc, name) in _REGISTRY if sc is canon)


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
                  lambda f, w: GMDTrain(_prof(f, w), f.space))
register_strategy(Scenario.INFER, "gmd",
                  lambda f, w: GMDInfer(_prof(f, w), f.space))
register_strategy(Scenario.CONCURRENT, "gmd",
                  lambda f, w_tr, w_in: GMDConcurrent(_cprof(f, w_tr, w_in),
                                                      f.space))
register_strategy(Scenario.MULTI_TENANT, "gmd",
                  lambda f, w_tr, *ws: GMDMultiTenant(_mtprof(f, w_tr, *ws),
                                                      f.space))


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
    """One §5.4 rate window: the rate, the (re)planned solution, and the
    engine's execution report over that window's arrival trace, with how the
    window was planned (``estimated_rate``, ``replanned``) and the
    burst-survival accounting (the open loop sheds and defers nothing; its
    goodput is the in-budget share of the window's offered arrivals)."""
    rate: object                      # float | tuple[float, ...]
    solution: Optional[object]        # Solution | MultiTenantSolution
    report: Optional[object]          # ExecutionReport
    estimated_rate: Optional[object] = None
    replanned: bool = False
    mode_switch_s: float = 0.0
    carried_requests: int = 0
    shed_requests: int = 0
    deferred_requests: int = 0
    goodput: Optional[float] = None
    offered_requests: int = 0         # the window's own arrivals
    splits: int = 0


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
                 space: Optional[PowerModeSpace] = None):
        self.device = device or DeviceModel()
        self.space = space or PowerModeSpace()

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

    def _strategy(self, scenario: Scenario, name: str,
                  *workloads: WorkloadProfile):
        if scenario is Scenario.CONCURRENT_INFERENCE:
            # the scenario's defining cast, applied regardless of entry point
            workloads = (as_nonurgent(workloads[0]),) + workloads[1:]
        factory = _REGISTRY.get((scenario.canonical, name))
        if factory is None:
            raise KeyError(
                f"no strategy {name!r} for scenario {scenario.value!r}; "
                f"available: {available_strategies(scenario)}")
        return factory(self, *workloads)

    def _plan(self, sol, strat, name, scenario=None) -> Optional[Plan]:
        if sol is None:
            return None
        prof = getattr(strat, "profiler", None) or getattr(strat, "cp", None) \
            or getattr(strat, "mp", None)
        runs = prof.num_runs if prof is not None else 0
        cost = prof.profile_cost_s if prof is not None else 0.0
        return Plan(solution=sol, strategy=name, profiling_runs=runs,
                    profiling_cost_s=cost, scenario=scenario)

    # -- execute (trace-driven engine over the device model) ----------------
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

    # -- dynamic arrival rates (§5.4) ----------------------------------------
    def _dynamic_solver(self, w: WorkloadProfile, strategy: str) -> Callable:
        """One-window solver carrying planning state across windows: GMD
        shares one profiler, so cached profiles are free and every window
        re-searches at full budget but mostly hits the cache."""
        if strategy != "gmd":
            return self._strategy(Scenario.DYNAMIC, strategy, w).solve
        prof = Profiler(self.device, w)

        def solve(prob: P.InferProblem) -> Optional[P.Solution]:
            sol = P.solve_infer(prob, prof.observed())
            if sol is None:
                GMDInfer(prof, self.space).solve(prob)
                sol = P.solve_infer(prob, prof.observed())
            return sol

        return solve

    def solve_dynamic(self, w: WorkloadProfile, power_budget: float,
                      latency_budget: float, rates: Sequence[float],
                      strategy: str = "gmd") -> list[Optional[P.Solution]]:
        """One solution per rate window, reusing planning state across
        windows."""
        probs = [P.InferProblem(power_budget, latency_budget, float(r))
                 for r in rates]
        solve = self._dynamic_solver(w, strategy)
        return [solve(prob) for prob in probs]

    def serve_dynamic(self, w, power_budget: float,
                      latency_budget: Optional[float], rates: Sequence,
                      strategy: str = "gmd", window_duration: float = 30.0,
                      arrivals: str = "uniform", seed: int = 0,
                      backend: Optional[str] = None,
                      controller=None) -> list[WindowReport]:
        """Solve and *execute* a dynamic trace, open loop: each window is
        planned from its announced rate with the nominal budget, windows are
        independent, and all solved windows replay as one
        ``simulate_batch`` (one engine lane per window) over uniform ticks
        or seeded Poisson arrivals."""
        if controller is not None:
            raise NotImplementedError("the closed-loop controller is not "
                                      "ported yet; omit controller")
        if isinstance(w, (list, tuple)):
            raise NotImplementedError("multi-tenant serving needs the "
                                      "multi-tenant engine, not ported yet")
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
