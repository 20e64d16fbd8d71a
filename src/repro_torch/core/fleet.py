"""Fleet-scale serving (``Scenario.FLEET``): K devices as one batched program.

Counterpart of ``repro.core.fleet`` on the port's solvers and engine. A
fleet is K heterogeneous edge devices (``fleet_device`` — the base Orin
model with deterministic per-device time/power multipliers) fed by one
aggregate arrival stream. Each window:

 1. **dispatch** — the window's aggregate arrivals are split across devices
    by deterministic weighted round-robin: each arrival, in time order, goes
    to the device minimizing ``(n_d + 1) / w_d`` (ties to the lowest index),
    where ``n_d`` counts this window's assignments so far. ``"capacity"``
    starts every window's counts at zero with ``w_d = 1 / time_scale_d``
    (faster devices take proportionally more); ``"least-backlog"`` seeds the
    counts with each device's carried backlog. The dispatched window keeps
    provenance: the merged trace's ``stream_ids`` are device indices, so
    ``ArrivalTrace.split`` recovers exactly the per-device traces that ran.
 2. **plan** — the K per-device closed-loop controller windows run the
    ladder (EWMA rate estimate, feedback-scaled budget, burst quantile,
    interval solve -> high-rate fallback -> estimate -> nominal-budget
    retry), but each rung is ONE ``grid_eval.solve_infer_fleet_batch`` call
    over the still-unsolved devices, a masked argmin on the backend's
    device: every device's observation grid is the shared base grid scaled
    by its (time, power) multipliers.
 3. **execute** — all solved devices run as one ``simulate_batch`` call
    with per-lane devices (``devices=``): each device's service time reaches
    the max-plus scan (K1) as its lane's ``exec`` times, and the report
    pass sorts every device's latencies with the lane sort (K2).

Fleet-wide resource control rides on top of the same three passes (all
opt-in; with the knobs at their defaults every step below is skipped):

 * **global admission** (``ControllerConfig.admission``) — each solved
   device runs the deadline-drop mask (``AdmissionPolicy.admit`` over
   ``[carried pending, dispatched arrivals]`` with the device's own
   ``t_in``). ``"shed"`` drops rejections; ``"defer"`` pushes them into a
   single fleet-level re-offer queue — at the next window start they
   re-enter the *dispatcher*, re-timestamped, and may land on any device
   (``FleetControllerState.push_fleet_deferred`` / ``pop_fleet_deferred``,
   ``defer_cap`` overflow shed); ``"degrade-bs"`` swaps a non-drainable
   device's plan for its max-service-rate plan
   (``problem.solve_infer_capacity``), trimming nothing.
 * **backlog migration** (``FleetSpec.migrate_backlog``) — between windows,
   every device's carried ``QueueState`` backlog is pooled and re-dispatched
   by the same capped key-merge as arrivals. A request that stays keeps its
   timestamp; a request that moves is re-timestamped at the window start.
   Device clocks never migrate — a busy device stays busy.
 * **shared power budget** (``FleetSpec.fleet_power_budget``) — one fleet
   cap allocated per window by water-filling (``problem.water_fill``) over
   the previous window's per-device ``attributed_power``, floored so idle
   devices can re-enter and capped at the per-device ``power_budget``. The
   grants thread into ``solve_infer_fleet_batch`` as its per-problem
   power-budget column.

``serve_fleet_sequential`` is the reference: the same fleet as K
independent single-device closed loops run one after another (scalar
solvers over each device's own observation dict, one single-lane engine
call per device per window). The cross-device decisions (dispatch,
deferral, migration, water-filling, admission masks) are shared helpers
called identically by both serving loops.

Exactness. The solves are bitwise the reference's NumPy tier
(``grid_eval``), and so are the host decisions built on them. The engine is
in the tolerance tier of ``docs/exactness.md``: latencies within ``atol=1e-8,
rtol=1e-9`` of the reference's NumPy engine, and the closed loop judges its
admission and feedback on those values, so a value within that tolerance of
a threshold could decide the other way (none does in the tests' cases). On
``"cpu"`` the plain max-plus scan gives every lane the same bits however
many lanes and events it is padded to (padding only combines with identity
elements), so ``serve_fleet`` equals ``serve_fleet_sequential`` bitwise
there; on ``"cuda"`` the kernel's association depends on the padded event
count, so the two agree within the engine tolerance.

``serve_fleet(fused=True)`` runs each window as one launch
(``core.fused_window``): the ladder, admission and engine of every device in
one kernel (``csrc/fused_window.cu`` on ``"cuda"``, its plain version on
``"cpu"``), the same host bookkeeping around it. It supports admission
none / shed / defer; ``degrade-bs`` re-plans on the host between solve and
execute and is refused. The one remaining single-device refinement is
mid-window re-entry (``split_backlog``): configs requesting it are rejected
rather than silently ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import problem as P
from repro_torch.core.backend import resolve_backend
from repro_torch.core.controller import (AdmissionPolicy, ControllerConfig,
                                         ControllerState, FleetControllerState)
from repro_torch.core.device_model import (DeviceModel, PerturbedDeviceModel,
                                           WorkloadProfile, fleet_device)
from repro_torch.core.fused_window import fused_fleet_window
from repro_torch.core.grid_eval import materialize, solve_infer_fleet_batch
from repro_torch.core.powermode import PowerModeSpace
from repro_torch.core.simulate import (ArrivalTrace, ExecutionReport,
                                       QueueState, _presort_reports, simulate,
                                       simulate_batch)

_DISPATCHES = ("capacity", "least-backlog")


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """One fleet: how many devices, how they differ, how arrivals are
    dispatched, and which fleet-wide resource controls are on. Heterogeneity
    is sampled deterministically per (seed, index) via collision-free draws
    (``device_model._device_pert``), so a spec names the same fleet in every
    process. ``migrate_backlog`` and ``fleet_power_budget`` default off —
    the default spec runs K isolated closed loops."""
    n_devices: int
    seed: int = 0
    time_spread: float = 0.10     # per-device service-time spread (+-)
    power_spread: float = 0.05    # per-device power spread (+-)
    dispatch: str = "capacity"    # "capacity" | "least-backlog"
    migrate_backlog: bool = False  # re-dispatch carried backlog each window
    fleet_power_budget: Optional[float] = None   # shared cap, water-filled
    #   across devices per window (None = one per-device cap each)

    def __post_init__(self):
        if self.n_devices <= 0:
            raise ValueError("a fleet needs at least one device")
        if not 0.0 <= self.time_spread < 1.0 \
                or not 0.0 <= self.power_spread < 1.0:
            raise ValueError("spreads must be in [0, 1)")
        if self.dispatch not in _DISPATCHES:
            raise ValueError(f"unknown dispatch policy {self.dispatch!r}; "
                             f"use {_DISPATCHES}")
        if self.fleet_power_budget is not None \
                and self.fleet_power_budget <= 0.0:
            raise ValueError("fleet_power_budget must be positive (or None)")

    def devices(self) -> list[PerturbedDeviceModel]:
        return [fleet_device(d, self.seed, self.time_spread,
                             self.power_spread)
                for d in range(self.n_devices)]


@dataclasses.dataclass
class FleetWindowReport:
    """One fleet window: the per-device ``WindowReport``s (scheduler-shaped,
    index = device) plus the fleet-level dispatch and goodput account.
    ``trace`` is the dispatched aggregate window — ``trace.split(K)``
    recovers each device's arrivals (provenance round-trip). With admission
    ``"defer"`` the dispatched trace also carries the re-offered requests
    (re-timestamped at the window start), so ``len(trace)`` can exceed
    ``offered_requests`` — the window's own arrivals."""
    rate: float                       # aggregate announced rate
    devices: list                     # one WindowReport per device
    trace: ArrivalTrace               # merged; stream_ids = device indices
    dispatch_counts: np.ndarray       # arrivals dispatched per device
    offered_requests: int
    goodput: float                    # fleet-wide in-budget served / offered
    shed_requests: int = 0            # admission-rejected, dropped
    deferred_requests: int = 0        # admission-rejected, re-offered
    migrated_requests: int = 0        # backlog moved between devices
    power_budgets: Optional[np.ndarray] = None   # per-device water-filled
    #   grants (None unless FleetSpec.fleet_power_budget is set)

    @property
    def attributed_power(self) -> float:
        """Summed per-device attributed power (satellite of the per-tenant
        attribution account): each executed report's time-weighted share —
        idle devices attribute 0, so this is the fleet's busy power."""
        return float(sum(wr.report.attributed_power or 0.0
                         for wr in self.devices if wr.report is not None))


def dispatch_arrivals(times: np.ndarray, weights: np.ndarray,
                      counts0: Optional[np.ndarray] = None) -> np.ndarray:
    """Deterministic weighted round-robin dispatch: arrival k (time order)
    goes to the device minimizing ``(counts0_d + n_d + 1) / w_d`` over the
    running assignment counts ``n_d``, ties to the lowest device index.
    Returns the per-arrival device index vector.

    Implemented as a merge, not a loop: device d's j-th assignment has key
    ``(counts0_d + j + 1) / w_d`` — strictly increasing per device — and the
    greedy order is exactly the first N keys in (key, device) order. Each
    device can own at most ``(N + C + K) * w_d / W - counts0_d`` of the
    first N keys (the N-th smallest key is at most ``(N + C + K) / W``
    with ``C = sum(counts0)``, ``W = sum(w)``), so only ~N + O(K) candidate
    keys are materialized however large K * N is."""
    weights = np.asarray(weights, np.float64)
    K = weights.size
    n = int(np.asarray(times).size)
    if K <= 0:
        raise ValueError("dispatch needs at least one device")
    if np.any(weights <= 0.0):
        raise ValueError("dispatch weights must be positive")
    c0 = np.zeros(K, np.int64) if counts0 is None \
        else np.asarray(counts0, np.int64)
    if c0.size != K:
        raise ValueError("counts0 must align with the weights")
    if n == 0:
        return np.empty(0, np.int64)
    W = float(weights.sum())
    C = int(c0.sum())
    caps = np.ceil((n + C + K) * weights / W).astype(np.int64) - c0 + 2
    caps = np.clip(caps, 0, n)
    keys, devs = [], []
    for d in range(K):
        m = int(caps[d])
        if m <= 0:
            continue
        keys.append((c0[d] + 1.0 + np.arange(m)) / weights[d])
        devs.append(np.full(m, d, np.int64))
    keys = np.concatenate(keys)
    devs = np.concatenate(devs)
    order = np.argsort(keys, kind="stable")   # stable: device-major input,
    return devs[order[:n]]                    # equal keys -> lowest index


def split_window(agg: ArrivalTrace, sid: np.ndarray, n_devices: int,
                 ) -> tuple[ArrivalTrace, list[ArrivalTrace]]:
    """The dispatched forms of one aggregate window: the merged trace with
    device provenance, and the per-device traces (absolute times, so the
    carryover replay contract applies per device)."""
    merged = ArrivalTrace(agg.times, agg.duration, agg.kind,
                          np.asarray(sid, np.int64), int(n_devices))
    return merged, merged.split(n_devices)


def _check_fleet_features(spec: FleetSpec, cfg: ControllerConfig) -> None:
    """Per-feature capability checks: one clear error per unsupported
    combination."""
    if cfg.split_backlog is not None:
        raise ValueError(
            "fleet serving batches whole controller windows; mid-window "
            "backlog splits (split_backlog) are a single-device refinement "
            "(serve them per device via Fulcrum.serve_dynamic)")
    if spec.migrate_backlog and not cfg.carry_backlog:
        raise ValueError(
            "backlog migration re-dispatches carried QueueState backlog "
            "between windows; it needs controller carry_backlog=True "
            "(or turn FleetSpec.migrate_backlog off)")


def _fleet_scales(spec: FleetSpec) -> tuple[list, np.ndarray, np.ndarray,
                                            np.ndarray, np.ndarray]:
    """(devices, time_scales, power_scales, weights, shares): dispatch
    weight = 1 / time_scale (a device's service capacity), announced-rate
    share = normalized weight."""
    devs = spec.devices()
    ts = np.array([d.time_scale for d in devs])
    ps = np.array([d.power_scale for d in devs])
    wts = 1.0 / ts
    return devs, ts, ps, wts, wts / wts.sum()


def _window_trace(rate: float, i: int, window_duration: float,
                  arrivals: str, seed: int) -> ArrivalTrace:
    t0 = i * window_duration
    win = (ArrivalTrace.uniform(rate, window_duration)
           if arrivals == "uniform"
           else ArrivalTrace.poisson(rate, window_duration, seed + i))
    return win.shifted(t0)


def _backlog_counts(states: Sequence[ControllerState],
                    cfg: ControllerConfig) -> np.ndarray:
    """Per-device carried-backlog counts (0 with carryover off) — both the
    ``carried_requests`` account and the ``"least-backlog"`` dispatch seed."""
    return np.array([len(st.carry)
                     if cfg.carry_backlog and st.carry is not None else 0
                     for st in states], np.int64)


def _dispatch_fleet_window(agg: ArrivalTrace, n_deferred: int, t0: float,
                           weights: np.ndarray,
                           counts0: Optional[np.ndarray], K: int):
    """One window's dispatch pass, deferred re-offers included: the
    ``n_deferred`` fleet-level re-offers are re-timestamped at the window
    start and prepended to the aggregate arrivals (they sort first — the
    defer contract says they re-enter at the start), then the whole vector
    is dispatched by the capped key-merge. Returns ``(merged, dtr, own_dtr,
    deferred_counts, counts)``: the provenance-tagged merged trace, the
    per-device traces that run, the per-device *own-arrival* traces (the
    window's arrivals minus re-offers — what estimators observe and what
    ``offered_requests`` counts), how many re-offers each device drew, and
    the full dispatch counts."""
    if n_deferred:
        eff = ArrivalTrace(
            np.concatenate([np.full(n_deferred, float(t0)), agg.times]),
            agg.duration, agg.kind)
    else:
        eff = agg
    sid = dispatch_arrivals(eff.times, weights, counts0)
    merged, dtr = split_window(eff, sid, K)
    counts = np.bincount(sid, minlength=K).astype(np.int64)
    def_counts = np.bincount(sid[:n_deferred], minlength=K).astype(np.int64)
    if n_deferred:
        own = ArrivalTrace(agg.times, agg.duration, agg.kind,
                           np.asarray(sid[n_deferred:], np.int64), K)
        own_dtr = own.split(K)
    else:
        own_dtr = dtr
    return merged, dtr, own_dtr, def_counts, counts


def _migrate_backlog(states: Sequence[ControllerState], weights: np.ndarray,
                     t0: float) -> int:
    """Between-window backlog migration: pool every device's carried pending
    requests (time order, home-device-major on ties) and re-dispatch the
    pool through the same capped key-merge as arrivals — with no seed
    counts, the greedy ``(j + 1) / w_d`` keys equalize the queues, i.e.
    least-backlog placement over the pooled backlog. A request that stays on
    its home device keeps its original timestamp (its replay is bitwise the
    no-migration one); a request that moves is re-timestamped at the window
    start ``t0`` — re-submission semantics, exactly the defer contract — so
    the receiving device's ``[pending, window arrivals]`` vector stays
    nondecreasing and replays exactly. Device clocks never move: a busy
    device stays busy until its own clock. Returns how many requests moved
    (0 leaves every ``QueueState`` untouched)."""
    pend, home = [], []
    for d, st in enumerate(states):
        if st.carry is not None and len(st.carry):
            pend.append(np.asarray(st.carry.pending, np.float64))
            home.append(np.full(len(st.carry), d, np.int64))
    if not pend:
        return 0
    times = np.concatenate(pend)
    homes = np.concatenate(home)
    order = np.argsort(times, kind="stable")
    times, homes = times[order], homes[order]
    sid = dispatch_arrivals(times, weights)
    moved = sid != homes
    n_moved = int(np.count_nonzero(moved))
    if n_moved == 0:
        return 0
    new_times = np.where(moved, float(t0), times)
    for d, st in enumerate(states):
        pend_d = np.sort(new_times[sid == d], kind="stable")
        if st.carry is None and pend_d.size == 0:
            continue
        clock = float(st.carry.clock) if st.carry is not None else float(t0)
        st.carry = QueueState(pend_d, clock)
    return n_moved


def _fleet_power_budgets(spec: FleetSpec, power_budget: float,
                         prev_attr: np.ndarray, K: int) -> np.ndarray:
    """Per-device power budgets for one window. Without a fleet budget,
    every device keeps the per-device cap. With one, the shared cap is
    water-filled (``problem.water_fill``) over demand = the previous
    window's per-device attributed power —
    floored at ``fleet_budget / 4K`` (an idle device must keep enough budget
    to serve again, or a zero-demand fixed point would starve it forever)
    and capped at the per-device ``power_budget`` (a grant the device's own
    envelope cannot use is forfeited, never redistributed — keeps the grant
    sum <= the fleet budget)."""
    if spec.fleet_power_budget is None:
        return np.full(K, float(power_budget))
    total = float(spec.fleet_power_budget)
    demands = np.maximum(np.asarray(prev_attr, np.float64),
                         total / (4.0 * K))
    return np.minimum(P.water_fill(demands, total), float(power_budget))


def _attributed_by_device(device_reports: Sequence) -> np.ndarray:
    """The per-device attributed power of one executed window — next
    window's water-filling demand vector (0 for unserved devices)."""
    return np.array([(wr.report.attributed_power or 0.0)
                     if wr is not None and wr.report is not None else 0.0
                     for wr in device_reports], np.float64)


def _admit_fleet_device(adm: AdmissionPolicy, latency_budget: float, sol,
                        t_in: float, carry_in: QueueState,
                        trace: ArrivalTrace,
                        ) -> tuple[ArrivalTrace, QueueState, int]:
    """One device's admission pass, exactly the single-device
    ``_closed_loop_window`` sequence: the deadline-drop mask runs over
    ``[carried pending, dispatched arrivals]`` from the carried clock with
    the device's own ``t_in`` (the engine's own recurrence — the admitted
    subsequence replays with zero nominal-budget violations by
    construction). Returns the trimmed ``(trace, carry_in, n_rejected)``;
    untouched inputs when everything admits."""
    k0 = len(carry_in)
    all_times = np.concatenate([np.asarray(carry_in.pending, np.float64),
                                trace.times])
    mask = adm.admit(all_times, latency_budget, sol.bs, t_in,
                     carry_in.clock)
    if mask.all():
        return trace, carry_in, 0
    run_carry = QueueState(carry_in.pending[mask[:k0]], carry_in.clock)
    run_trace = ArrivalTrace(trace.times[mask[k0:]], trace.duration,
                             trace.kind)
    return run_trace, run_carry, int(np.count_nonzero(~mask))


def _degrade_fleet_plan(sol, est: float, n_waiting: int, duration: float,
                        power_budget: float, obs: dict):
    """The ``degrade-bs`` admission mode per device (the fleet form of the
    scheduler's ``_degrade_plan``): when the device's demand — carried
    backlog + re-offers dispatched to it + estimated arrivals — is not
    drainable under the committed plan, swap in its max-service-rate plan
    under its (possibly water-filled) power budget and accept the
    violations."""
    t_in = obs[(sol.pm, sol.bs)][0]
    if P.drainable(n_waiting, est, sol.bs, t_in, duration):
        return sol
    cand = P.solve_infer_capacity(float(power_budget), obs)
    if cand is None:
        return sol
    c_t = obs[(cand.pm, cand.bs)][0]
    return cand if cand.bs / c_t > sol.bs / t_in else sol


def _open_window(state: FleetControllerState, cfg: ControllerConfig,
                 adm: AdmissionPolicy, spec: FleetSpec, wts: np.ndarray,
                 shares: np.ndarray, rate: float, i: int,
                 window_duration: float, arrivals: str, seed: int,
                 power_budget: float, latency_budget: float,
                 prev_attr: np.ndarray) -> tuple:
    """Window ``i``'s host preamble, shared by both batched loops (unfused
    and fused): its arrivals, backlog migration, the deferred re-offers'
    return, dispatch, the announced rates, the water-filled power grants,
    and the ladder's per-device inputs. Returns ``(t0, agg, n_mig, carried,
    merged, dtr, own_dtr, def_counts, counts, announced, pbud, hi, est,
    bud)``."""
    K = spec.n_devices
    t0 = i * window_duration
    agg = _window_trace(rate, i, window_duration, arrivals, seed)
    n_mig = _migrate_backlog(state.devices, wts, t0) \
        if spec.migrate_backlog else 0
    n_def = state.pop_fleet_deferred() if adm.active else 0
    carried = _backlog_counts(state.devices, cfg)
    counts0 = carried if spec.dispatch == "least-backlog" else None
    merged, dtr, own_dtr, def_counts, counts = _dispatch_fleet_window(
        agg, n_def, t0, wts, counts0, K)
    announced = rate * shares
    pbud = _fleet_power_budgets(spec, power_budget, prev_attr, K)
    hi = state.plan_rates(announced, t0, window_duration)
    est = state.plan_rates(announced, t0, window_duration,
                           margin=1.0, pressure=False)
    if cfg.burst_quantile > 0.0:
        hi = np.maximum(hi, [P.burst_rate(e, window_duration,
                                          cfg.burst_quantile)
                             for e in est])
    bud = state.plan_budgets([latency_budget] * K)
    return (t0, agg, n_mig, carried, merged, dtr, own_dtr, def_counts,
            counts, announced, pbud, hi, est, bud)


def _unserved_report(announced: float, est: float, carried: int,
                     shed: int, own: ArrivalTrace):
    """The report of a device that served nothing this window."""
    from repro_torch.core.scheduler import WindowReport
    offered = len(own)
    return WindowReport(float(announced), None, None,
                        estimated_rate=float(est),
                        carried_requests=int(carried),
                        shed_requests=int(shed),
                        goodput=0.0 if offered else 1.0,
                        offered_requests=offered)


def _goodput(rep, latency_budget: float, offered: int) -> float:
    good = int(np.count_nonzero(
        np.asarray(rep.latencies, np.float64) <= latency_budget))
    return good / offered if offered else 1.0


def _fleet_report(rate, device_reports, merged, counts, latency_budget,
                  offered, shed, deferred, migrated,
                  power_budgets) -> FleetWindowReport:
    good = sum(int(np.count_nonzero(
        np.asarray(wr.report.latencies, np.float64) <= latency_budget))
        for wr in device_reports if wr.report is not None)
    return FleetWindowReport(float(rate), device_reports, merged,
                             counts, int(offered),
                             good / offered if offered else 1.0,
                             shed_requests=int(shed),
                             deferred_requests=int(deferred),
                             migrated_requests=int(migrated),
                             power_budgets=power_budgets)


def _device_unserved(state: FleetControllerState, d: int, n_def: int,
                     shed_d: np.ndarray, own: ArrivalTrace,
                     window_duration: float) -> None:
    """Device ``d`` serves nothing this window: its deferred re-offers are
    deferred again (what overflows is shed) and its controller observes an
    unserved window."""
    if n_def:
        shed_d[d] += state.push_fleet_deferred(int(n_def))
    state.observe_unserved(d, own, window_duration)


def _split_rejected(state: FleetControllerState, adm: AdmissionPolicy,
                    d: int, n_rej: int, shed_d: np.ndarray,
                    def_out_d: np.ndarray) -> None:
    """Device ``d``'s ``n_rej`` admission rejections: deferred under
    ``"defer"`` (what overflows the queue is shed), else shed."""
    if not n_rej:
        return
    if adm.mode == "defer":
        dropped = state.push_fleet_deferred(n_rej)
        def_out_d[d] = n_rej - dropped
        shed_d[d] = dropped
    else:
        shed_d[d] = n_rej


def _close_window(state: FleetControllerState, spec: FleetSpec, served,
                  rate: float, agg: ArrivalTrace, merged, counts, own_dtr,
                  announced, est, carried, shed_d: np.ndarray,
                  def_out_d: np.ndarray, n_mig: int, pbud: np.ndarray,
                  prev_keys: list, latency_budget: float,
                  window_duration: float) -> FleetWindowReport:
    """Window close, shared by both batched loops: each served device's
    report (goodput, shed and deferred counts, the controller's
    observation, the replan flag) in device order, the unserved devices'
    reports, and the fleet report. ``served`` holds ``(device, solution,
    mode-switch seconds, ExecutionReport)`` in device order."""
    from repro_torch.core.scheduler import WindowReport
    device_reports: list = [None] * spec.n_devices
    for d, sol, switch_s, rep in served:
        offered = len(own_dtr[d])
        gp = _goodput(rep, latency_budget, offered)
        rep.goodput = gp
        rep.shed_requests = int(shed_d[d])
        rep.deferred_requests = int(def_out_d[d])
        state.observe(d, own_dtr[d], rep, latency_budget,
                      window_duration, rep.queue_state)
        key = (sol.pm, sol.bs, sol.tau_tr)
        device_reports[d] = WindowReport(
            float(announced[d]), sol, rep,
            estimated_rate=float(est[d]),
            replanned=key != prev_keys[d], mode_switch_s=switch_s,
            carried_requests=int(carried[d]),
            shed_requests=int(shed_d[d]),
            deferred_requests=int(def_out_d[d]), goodput=gp,
            offered_requests=offered)
        prev_keys[d] = key
    for d in range(spec.n_devices):
        if device_reports[d] is None:
            device_reports[d] = _unserved_report(
                announced[d], est[d], carried[d], shed_d[d], own_dtr[d])
    return _fleet_report(
        rate, device_reports, merged, counts, latency_budget,
        offered=len(agg), shed=int(shed_d.sum()),
        deferred=int(def_out_d.sum()), migrated=n_mig,
        power_budgets=pbud.copy()
        if spec.fleet_power_budget is not None else None)


def serve_fleet(w: WorkloadProfile, power_budget: float,
                latency_budget: float, rates: Sequence[float],
                spec: FleetSpec, window_duration: float = 30.0,
                arrivals: str = "uniform", seed: int = 0,
                backend: Optional[str] = None,
                controller: Optional[ControllerConfig] = None,
                space: Optional[PowerModeSpace] = None,
                fused: Optional[bool] = None,
                ) -> list[FleetWindowReport]:
    """Serve a dynamic aggregate trace on a K-device fleet, stepping all K
    per-device closed-loop windows as one batched program per window: one
    dispatch pass (deferred re-offers re-entering first), one batched solve
    per ladder rung (per-device water-filled power budgets when the spec
    sets a fleet cap), one admission pass over the solved lanes, one
    ``simulate_batch`` over the admitted traces, all on ``backend``
    (``"cuda"`` by default, or ``"cpu"``). It makes the decisions of
    ``serve_fleet_sequential`` (the K independent scalar loops), bitwise on
    ``"cpu"`` (see the module's note on exactness).

    ``fused=True`` runs each window through the fused window instead — ONE
    launch per window (``core.fused_window``) on the same backend, with the
    same decisions and latencies within the engine tolerance. It never
    falls back to the unfused loop; admission ``degrade-bs`` is refused."""
    cfg = controller if controller is not None else ControllerConfig()
    _check_fleet_features(spec, cfg)
    adm = cfg.admission_policy()
    if fused:
        if adm.mode == "degrade-bs":
            raise ValueError(
                "admission mode 'degrade-bs' re-plans on the host between "
                "solve and simulate (problem.solve_infer_capacity over the "
                "device dict); serve it unfused — the fused window supports "
                "admission none/shed/defer")
        return _serve_fleet_fused(w, power_budget, latency_budget, rates,
                                  spec, window_duration, arrivals, seed,
                                  cfg, adm, space, resolve_backend(backend))
    K = spec.n_devices
    devs, ts, ps, wts, shares = _fleet_scales(spec)
    grid = materialize(DeviceModel(), w, space or PowerModeSpace(),
                       P.INFER_BATCH_SIZES)
    eng_backend = resolve_backend(backend)
    state = FleetControllerState(cfg, K)
    obs_cache: dict[int, dict] = {}     # degrade-bs only: per-device grids
    base_obs: list = []                 # the shared base dict, converted at
    #   most once per serve_fleet call (not once per device)

    def device_obs(d: int) -> dict:
        if d not in obs_cache:
            if not base_obs:
                base_obs.append(grid.to_dict())
            obs_cache[d] = {k: (t * ts[d], p * ps[d])
                            for k, (t, p) in base_obs[0].items()}
        return obs_cache[d]

    prev_keys: list = [None] * K
    prev_attr = np.full(K, float(power_budget))
    out: list[FleetWindowReport] = []
    for i, rate in enumerate(rates):
        (t0, agg, n_mig, carried, merged, dtr, own_dtr, def_counts, counts,
         announced, pbud, hi, est, bud) = _open_window(
            state, cfg, adm, spec, wts, shares, float(rate), i,
            window_duration, arrivals, seed, power_budget, latency_budget,
            prev_attr)
        # the closed-loop ladder, vectorized over the device axis: every
        # rung is one batched fleet solve over the still-unsolved devices
        sols: list[Optional[P.Solution]] = [None] * K
        live = est > 0.0            # a zero estimate has no rate to plan at
        unsolved = np.ones(K, bool)

        def rung(mask, rates_lo, budgets, rate_his):
            sel = np.flatnonzero(mask)
            if not sel.size:
                return
            probs = [P.InferProblem(float(pbud[d]), float(budgets[d]),
                                    float(rates_lo[d])) for d in sel]
            res = solve_infer_fleet_batch(probs, rate_his[sel], grid,
                                          ts[sel], ps[sel],
                                          backend=eng_backend)
            for d, s in zip(sel, res):
                sols[d] = s
                unsolved[d] = s is None

        # 1. margin headroom: sustainable up to hi, budget held at est
        rung(live & (hi > est), est, bud, hi)
        # 2. dead zone: prefer the high end (see _closed_loop_window)
        rung(live & (hi > est) & unsolved, hi, bud, hi)
        # 3. the point plan at the estimate
        rung(live & unsolved, est, bud, est)
        # 4. feedback tightened into infeasibility: retry at nominal
        nominal = np.full(K, float(latency_budget))
        rung(live & unsolved & (bud < nominal), est, nominal, est)
        lanes = []              # (device, sol, switch_s, run_trace, carry)
        shed_d = np.zeros(K, np.int64)
        def_out_d = np.zeros(K, np.int64)
        for d in range(K):
            sol = sols[d]
            if sol is not None and adm.mode == "degrade-bs":
                sol = _degrade_fleet_plan(
                    sol, float(est[d]), int(carried[d] + def_counts[d]),
                    window_duration, float(pbud[d]), device_obs(d))
                sols[d] = sol
            if sol is None:
                _device_unserved(state, d, def_counts[d], shed_d,
                                 own_dtr[d], window_duration)
                continue
            switch_s = state.mode_switch(d, sol.pm)
            carry_in = state.window_carry_in(d, t0, switch_s)
            run_trace, run_carry = dtr[d], carry_in
            if adm.trims:
                t_in = devs[d].time_power(w, sol.pm, sol.bs)[0]
                run_trace, run_carry, n_rej = _admit_fleet_device(
                    adm, latency_budget, sol, t_in, carry_in, dtr[d])
                _split_rejected(state, adm, d, n_rej, shed_d, def_out_d)
            lanes.append((d, sol, switch_s, run_trace, run_carry))
        reps = simulate_batch(
            DeviceModel(), None, w,
            [sol.pm for _, sol, _, _, _ in lanes],
            [sol.bs for _, sol, _, _, _ in lanes],
            [rt for _, _, _, rt, _ in lanes],
            tau_caps=[sol.tau_tr for _, sol, _, _, _ in lanes],
            backend=eng_backend,
            carry_ins=[rc for _, _, _, _, rc in lanes],
            devices=[devs[d] for d, _, _, _, _ in lanes])
        fr = _close_window(
            state, spec, [(d, sol, switch_s, rep) for
                          (d, sol, switch_s, _, _), rep in zip(lanes, reps)],
            rate, agg, merged, counts, own_dtr, announced, est, carried,
            shed_d, def_out_d, n_mig, pbud, prev_keys, latency_budget,
            window_duration)
        out.append(fr)
        prev_attr = _attributed_by_device(fr.devices)
    return out


def _serve_fleet_fused(w: WorkloadProfile, power_budget: float,
                       latency_budget: float, rates: Sequence[float],
                       spec: FleetSpec, window_duration: float,
                       arrivals: str, seed: int, cfg: ControllerConfig,
                       adm: AdmissionPolicy,
                       space: Optional[PowerModeSpace], backend: str,
                       ) -> list[FleetWindowReport]:
    """The fused driver behind ``serve_fleet(fused=True)``: the unfused
    loop's host bookkeeping (dispatch, deferral, migration, water-filling,
    controller states), but the window's plan ladder, admission recurrence
    and engine run as ONE launch (``core.fused_window.fused_fleet_window``)
    instead of up to four solver rungs, a host admission pass and an engine
    launch. Reports are rebuilt from the fetched arrays with the float ops
    ``simulate_batch`` would apply; the report builder then sorts them (K2
    on the card). The decisions are the unfused loop's; latencies agree
    within the engine tolerance."""
    K = spec.n_devices
    devs, ts, ps, wts, shares = _fleet_scales(spec)
    grid = materialize(DeviceModel(), w, space or PowerModeSpace(),
                       P.INFER_BATCH_SIZES)
    state = FleetControllerState(cfg, K)
    prev_keys: list = [None] * K
    prev_mode = np.full(K, -1, np.int32)    # committed mode ids; -1 = none
    prev_attr = np.full(K, float(power_budget))
    adm_budget = adm.headroom * float(latency_budget)
    out: list[FleetWindowReport] = []
    for i, rate in enumerate(rates):
        (t0, agg, n_mig, carried, merged, dtr, own_dtr, def_counts, counts,
         announced, pbud, hi, est, bud) = _open_window(
            state, cfg, adm, spec, wts, shares, float(rate), i,
            window_duration, arrivals, seed, power_budget, latency_budget,
            prev_attr)
        nominal = np.full(K, float(latency_budget))
        live = est > 0.0
        # the engine-side carry-in, flattened: device d's effective arrival
        # vector [carried pending, dispatched arrivals] and its pre-switch
        # clock max(carried clock, t0) — window_carry_in minus the switch
        # cost, which the window charges from prev_mode
        eff: list[np.ndarray] = []
        n_carry = np.zeros(K, np.int64)
        clock0 = np.full(K, float(t0))
        for d in range(K):
            st = state.devices[d]
            if cfg.carry_backlog and st.carry is not None:
                pend = np.asarray(st.carry.pending, np.float64)
                clock0[d] = max(float(st.carry.clock), float(t0))
                n_carry[d] = pend.size
                eff.append(np.concatenate([pend, dtr[d].times])
                           if pend.size else dtr[d].times)
            else:
                eff.append(dtr[d].times)
        res = fused_fleet_window(grid, ts, ps, pbud, bud, nominal, est, hi,
                                 live, prev_mode, eff, n_carry, clock0,
                                 float(cfg.mode_switch_s), adm_budget,
                                 adm.trims, backend=backend)
        shed_d = np.zeros(K, np.int64)
        def_out_d = np.zeros(K, np.int64)
        served = []             # (device, sol, switch_s, report)
        for d in range(K):
            if not res["solved"][d]:
                _device_unserved(state, d, def_counts[d], shed_d,
                                 own_dtr[d], window_duration)
                continue
            sel = int(res["sel"][d])
            sol = P.Solution(pm=grid.modes[sel], bs=int(grid.bs[sel]),
                             time=float(res["lam"][d]),
                             power=float(res["power"][d]))
            switch_s = state.mode_switch(d, sol.pm)   # == res["switch"]
            n_rej = int(res["n_rej"][d])
            _split_rejected(state, adm, d, n_rej, shed_d, def_out_d)
            bs = sol.bs
            n_adm = int(res["n_adm"][d])
            nb = int(res["n_batches"][d])
            ctv = np.asarray(res["adm_times"][d][:n_adm], np.float64)
            if adm.trims and n_rej:
                # rebuilt exactly as _admit_fleet_device does: the admitted
                # window arrivals follow the admitted carry prefix
                nca = int(n_carry[d]) - int(res["n_carry_rej"][d])
                run_tr = ArrivalTrace(ctv[nca:].copy(), dtr[d].duration,
                                      dtr[d].kind)
            else:
                run_tr = dtr[d]
            power = float(res["power"][d])
            rep = ExecutionReport(
                "managed",
                np.asarray(res["latencies"][d][:nb * bs], np.float64).copy(),
                0, run_tr.duration, power, run_tr,
                queue_state=QueueState(ctv[nb * bs:].copy(),
                                       float(res["clock_out"][d])),
                attributed_power=power if nb else 0.0)
            served.append((d, sol, switch_s, rep))
            prev_mode[d] = int(res["mode_id"][d])
        _presort_reports([rep for _, _, _, rep in served], backend)
        fr = _close_window(
            state, spec, served, rate, agg, merged, counts, own_dtr,
            announced, est, carried, shed_d, def_out_d, n_mig, pbud,
            prev_keys, latency_budget, window_duration)
        out.append(fr)
        prev_attr = _attributed_by_device(fr.devices)
    return out


def serve_fleet_sequential(w: WorkloadProfile, power_budget: float,
                           latency_budget: float, rates: Sequence[float],
                           spec: FleetSpec, window_duration: float = 30.0,
                           arrivals: str = "uniform", seed: int = 0,
                           backend: Optional[str] = None,
                           controller: Optional[ControllerConfig] = None,
                           space: Optional[PowerModeSpace] = None,
                           ) -> list[FleetWindowReport]:
    """The reference: the SAME fleet served as K independent single-device
    closed loops run sequentially — scalar solvers over each device's own
    observation dict, one single-lane engine call per device per window.
    The cross-device steps (dispatch, fleet deferral, migration,
    water-filling, admission) are the same shared helpers ``serve_fleet``
    calls, in the same device order, so the contract extends to every
    admission/migration/shared-budget combination: ``serve_fleet`` must
    make its decisions; ``backend`` runs each device's engine call."""
    cfg = controller if controller is not None else ControllerConfig()
    _check_fleet_features(spec, cfg)
    adm = cfg.admission_policy()
    K = spec.n_devices
    devs, ts, ps, wts, shares = _fleet_scales(spec)
    base = materialize(DeviceModel(), w, space or PowerModeSpace(),
                       P.INFER_BATCH_SIZES).to_dict()
    # device d's observation dict: the base grid rescaled entrywise — the
    # same floats a per-device profile of PerturbedDeviceModel would yield
    obs = [{k: (t * ts[d], p * ps[d]) for k, (t, p) in base.items()}
           for d in range(K)]
    fstate = FleetControllerState(cfg, K)
    states = fstate.devices
    prev_keys: list = [None] * K
    prev_attr = np.full(K, float(power_budget))
    out: list[FleetWindowReport] = []
    from repro_torch.core.scheduler import WindowReport
    for i, rate in enumerate(rates):
        t0 = i * window_duration
        agg = _window_trace(float(rate), i, window_duration, arrivals, seed)
        n_mig = _migrate_backlog(states, wts, t0) \
            if spec.migrate_backlog else 0
        n_def = fstate.pop_fleet_deferred() if adm.active else 0
        carried = _backlog_counts(states, cfg)
        counts0 = carried if spec.dispatch == "least-backlog" else None
        merged, dtr, own_dtr, def_counts, counts = _dispatch_fleet_window(
            agg, n_def, t0, wts, counts0, K)
        announced = float(rate) * shares
        pbud = _fleet_power_budgets(spec, power_budget, prev_attr, K)
        shed_d = np.zeros(K, np.int64)
        def_out_d = np.zeros(K, np.int64)
        device_reports: list = []
        for d in range(K):
            st = states[d]
            hi = st.plan_rates([announced[d]], t0, window_duration)[0]
            est = st.plan_rates([announced[d]], t0, window_duration,
                                margin=1.0, pressure=False)[0]
            if cfg.burst_quantile > 0.0:
                hi = max(hi, P.burst_rate(est, window_duration,
                                          cfg.burst_quantile))
            bud = st.plan_budgets([latency_budget])[0]
            pb = float(pbud[d])
            sol = None
            if est > 0.0:
                if hi > est:
                    sol = P.solve_infer_interval(
                        P.InferProblem(pb, bud, est), hi, obs[d])
                    if sol is None:
                        sol = P.solve_infer(
                            P.InferProblem(pb, bud, hi), obs[d])
                if sol is None:
                    sol = P.solve_infer(
                        P.InferProblem(pb, bud, est), obs[d])
                if sol is None and bud < latency_budget:
                    sol = P.solve_infer(
                        P.InferProblem(pb, float(latency_budget), est),
                        obs[d])
            if sol is not None and adm.mode == "degrade-bs":
                sol = _degrade_fleet_plan(
                    sol, float(est), int(carried[d] + def_counts[d]),
                    window_duration, pb, obs[d])
            offered = len(own_dtr[d])
            if sol is None:
                if def_counts[d]:
                    shed_d[d] += fstate.push_fleet_deferred(
                        int(def_counts[d]))
                st.observe_unserved([own_dtr[d]], window_duration)
                device_reports.append(_unserved_report(
                    announced[d], est, carried[d], shed_d[d], own_dtr[d]))
                continue
            switch_s = st.mode_switch(sol.pm)
            carry_in = st.window_carry_in(t0, switch_s)
            run_trace, run_carry = dtr[d], carry_in
            if adm.trims:
                t_in = devs[d].time_power(w, sol.pm, sol.bs)[0]
                run_trace, run_carry, n_rej = _admit_fleet_device(
                    adm, latency_budget, sol, t_in, carry_in, dtr[d])
                if n_rej:
                    if adm.mode == "defer":
                        dropped = fstate.push_fleet_deferred(n_rej)
                        def_out_d[d] = n_rej - dropped
                        shed_d[d] = dropped
                    else:
                        shed_d[d] = n_rej
            rep = simulate(devs[d], None, w, sol.pm, sol.bs, run_trace,
                           "managed", tau_cap=sol.tau_tr, backend=backend,
                           carry_in=run_carry)
            gp = _goodput(rep, latency_budget, offered)
            rep.goodput = gp
            rep.shed_requests = int(shed_d[d])
            rep.deferred_requests = int(def_out_d[d])
            st.observe([own_dtr[d]], [rep], [latency_budget],
                       window_duration, rep.queue_state)
            key = (sol.pm, sol.bs, sol.tau_tr)
            device_reports.append(WindowReport(
                float(announced[d]), sol, rep, estimated_rate=float(est),
                replanned=key != prev_keys[d], mode_switch_s=switch_s,
                carried_requests=int(carried[d]),
                shed_requests=int(shed_d[d]),
                deferred_requests=int(def_out_d[d]), goodput=gp,
                offered_requests=offered))
            prev_keys[d] = key
        out.append(_fleet_report(
            rate, device_reports, merged, counts, latency_budget,
            offered=len(agg), shed=int(shed_d.sum()),
            deferred=int(def_out_d.sum()), migrated=n_mig,
            power_budgets=pbud.copy()
            if spec.fleet_power_budget is not None else None))
        prev_attr = _attributed_by_device(device_reports)
    return out
