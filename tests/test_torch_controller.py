"""The port's closed-loop controller (``repro_torch.core.controller``) and
closed-loop ``serve_dynamic`` against the reference's, mirroring
``tests/test_controller.py``.

Tolerances. The controller is host float64 code copied from the reference:
its estimators, feedback scales, queue states and seeds equal the
reference's bitwise on the same inputs. The port's engine (``"cpu"``, the
kernels' plain versions) is in the engine tolerance tier of
``docs/exactness.md``: latencies within ``atol=1e-8, rtol=1e-9`` of the
reference's NumPy engine, training minibatches within +-2. A closed loop
judges discrete decisions on those values, and on every case here they
come out the same: per window the plan ``(pm, bs|bss, tau_tr)``,
``replanned``, ``splits``, the shed / deferred / carried / offered counts,
``estimated_rate`` and ``mode_switch_s`` are equal, latencies meet the
engine tolerance, and goodput is within one request of the offered count.
"""
import dataclasses
import math
import random

import numpy as np
import pytest

from repro.core import problem as RP
from repro.core import simulate as RS
from repro.core.controller import ControllerConfig as RefConfig
from repro.core.controller import ControllerState as RefState
from repro.core.controller import FeedbackPolicy as RefFeedback
from repro.core.controller import RateEstimator as RefEstimator
from repro.core.device_model import DeviceModel as RefDevice
from repro.core.device_model import INFER_WORKLOADS as REF_INFER
from repro.core.device_model import TRAIN_WORKLOADS as REF_TRAIN
from repro.core.powermode import PowerModeSpace as RefSpace
from repro.core.scheduler import Fulcrum as RefFulcrum
from repro.core.scheduler import Scenario as RefScenario
from repro.core.scheduler import _poisson_seed as ref_poisson_seed
from repro.core.scheduler import register_strategy as ref_register
from repro_torch import convert
from repro_torch.core import problem as P
from repro_torch.core import simulate as S
from repro_torch.core.controller import (ControllerConfig, ControllerState,
                                         FeedbackPolicy, RateEstimator)
from repro_torch.core.device_model import (DeviceModel, INFER_WORKLOADS,
                                           TRAIN_WORKLOADS)
from repro_torch.core.powermode import PowerModeSpace
from repro_torch.core.scheduler import Fulcrum, Scenario, _poisson_seed
from repro_torch.core.scheduler import register_strategy

ENG_TOL = dict(rtol=1e-9, atol=1e-8)
DEV, REF_DEV = DeviceModel(), RefDevice()
MODES, REF_MODES = PowerModeSpace().all_modes(), RefSpace().all_modes()


# ---------------------------------------------------------------------------
# comparing a closed loop window by window
# ---------------------------------------------------------------------------

def _lats(rep):
    return np.asarray(rep.latencies, np.float64)


def _assert_reports_close(ref, got):
    np.testing.assert_allclose(_lats(got), _lats(ref), **ENG_TOL)
    assert abs(got.train_minibatches - ref.train_minibatches) <= 2


def assert_windows_match(ref, got):
    """Per window: the discrete decisions equal, latencies within the
    engine tolerance, goodput within one offered request."""
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        assert (None if b.solution is None
                else dataclasses.asdict(b.solution)) == \
            (None if a.solution is None else dataclasses.asdict(a.solution))
        assert (b.replanned, b.splits, b.shed_requests, b.deferred_requests,
                b.carried_requests, b.offered_requests, b.mode_switch_s) == \
            (a.replanned, a.splits, a.shed_requests, a.deferred_requests,
             a.carried_requests, a.offered_requests, a.mode_switch_s)
        assert b.estimated_rate == a.estimated_rate
        assert b.rate == a.rate
        assert abs(b.goodput - a.goodput) * max(1, a.offered_requests) <= 1
        assert (a.report is None) == (b.report is None)
        if a.report is None:
            continue
        assert (b.report.shed_requests, b.report.deferred_requests) == \
            (a.report.shed_requests, a.report.deferred_requests)
        if hasattr(a.report, "streams"):
            assert len(b.report.streams) == len(a.report.streams)
            for ra, rb in zip(a.report.streams, b.report.streams):
                np.testing.assert_allclose(_lats(rb), _lats(ra), **ENG_TOL)
            assert abs(b.report.train_minibatches
                       - a.report.train_minibatches) <= 2
        else:
            _assert_reports_close(a.report, b.report)
        qa, qb = a.report.queue_state, b.report.queue_state
        assert qb.pending.tolist() == qa.pending.tolist()
        assert abs(qb.clock - qa.clock) <= 1e-8 + 1e-9 * abs(qa.clock)


def serve_both(name, budget, rates, cfg, **kw):
    """One single-stream ``serve_dynamic`` on the reference's NumPy engine
    and on the port's ``"cpu"`` backend, from the same arguments."""
    ref = RefFulcrum(REF_DEV).serve_dynamic(
        REF_INFER[name], 40.0, budget, rates, "gmd",
        controller=RefConfig(**cfg), backend="numpy", **kw)
    got = Fulcrum(DEV).serve_dynamic(
        INFER_WORKLOADS[name], 40.0, budget, rates, "gmd",
        controller=ControllerConfig(**cfg), backend="cpu", **kw)
    return ref, got


# ---------------------------------------------------------------------------
# rate estimation and feedback: the reference's floats
# ---------------------------------------------------------------------------

def _gap_windows(seed):
    """Windows of arrivals to fold: uniform, Poisson, one arrival, idle."""
    rng = np.random.default_rng(seed)
    out, t0 = [], 0.0
    for k in range(6):
        kind = int(rng.integers(4))
        rate = float(rng.uniform(5.0, 120.0))
        if kind == 0:
            times = RS.ArrivalTrace.uniform(rate, 10.0).times
        elif kind == 1:
            times = RS.ArrivalTrace.poisson(rate, 10.0, seed=k).times
        elif kind == 2:
            times = np.array([float(rng.uniform(0.0, 10.0))])
        else:
            times = np.empty(0)
        out.append(t0 + times)
        t0 += 10.0
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("alpha", [0.01, 0.2, 1.0])
def test_ewma_estimates_equal_the_reference(seed, alpha):
    ref, got = RefEstimator("ewma", alpha), RateEstimator("ewma", alpha)
    assert got.estimate(55.0) == ref.estimate(55.0) == 55.0
    for times in _gap_windows(seed):
        ref.observe(times, 10.0)
        got.observe(times.copy(), 10.0)
        assert got.estimate(7.0) == ref.estimate(7.0)
        assert got._mean_gap == ref._mean_gap
        assert got._last_arrival == ref._last_arrival


def test_ewma_converges_and_oracle_passes_through():
    est = RateEstimator("ewma", alpha=0.05)
    for k in range(4):
        est.observe(S.ArrivalTrace.uniform(40.0, 30.0).shifted(k * 30.0)
                    .times, 30.0)
    assert est.estimate(999.0) == pytest.approx(40.0, rel=1e-6)
    oracle = RateEstimator("oracle")
    oracle.observe(S.ArrivalTrace.uniform(90.0, 10.0).times, 10.0)
    assert oracle.estimate(42.0) == 42.0
    with pytest.raises(ValueError, match="estimator"):
        RateEstimator("magic")


@pytest.mark.parametrize("seed", range(3))
def test_feedback_scales_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    kw = dict(feedback=True, tighten=float(rng.uniform(0.1, 1.0)),
              relax=float(rng.uniform(0.1, 1.0)),
              target_violation=float(rng.choice([0.0, 0.05])),
              min_budget_scale=float(rng.uniform(0.2, 0.6)))
    ref, got = RefFeedback(RefConfig(**kw)), FeedbackPolicy(
        ControllerConfig(**kw))
    for _ in range(30):
        v = float(rng.choice([0.0, rng.uniform(0.0, 1.0)]))
        tail = float(rng.uniform(0.01, 1.0))
        ref.update(v, tail, 0.1)
        got.update(v, tail, 0.1)
        assert got.scale == ref.scale
        assert got.effective_budget(0.1) == ref.effective_budget(0.1)
    inert = FeedbackPolicy(ControllerConfig())
    inert.update(1.0, 10.0, 0.1)
    assert inert.scale == 1.0


def test_feedback_monotone_in_violation_rate():
    scales = []
    for v in (0.0, 0.05, 0.2, 0.5, 1.0):
        pol = FeedbackPolicy(ControllerConfig(feedback=True))
        pol.update(v, tail_latency=0.2, nominal=0.1)
        scales.append(pol.scale)
    assert scales == sorted(scales, reverse=True)
    assert scales[0] == 1.0 and scales[-1] < 1.0


_CONFIGS = [dict(), dict(rate_estimator="ewma"), dict(feedback=True),
            dict(carry_backlog=True), dict(mode_switch_s=0.5),
            dict(rate_margin=1.2), dict(admission="shed"),
            dict(admission="none"), dict(burst_quantile=0.95),
            dict(split_backlog=64), dict(priorities=(2, 1))]


@pytest.mark.parametrize("kw", _CONFIGS)
def test_controller_config_equals_the_reference(kw):
    got, ref = ControllerConfig(**kw), RefConfig(**kw)
    assert got.closed_loop == ref.closed_loop
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert dataclasses.asdict(got.admission_policy()) == \
        dataclasses.asdict(ref.admission_policy())


@pytest.mark.parametrize("kw,match", [
    (dict(rate_estimator="magic"), "estimator"),
    (dict(ewma_alpha=0.0), "ewma_alpha"), (dict(rate_margin=0.0), "margin"),
    (dict(tighten=2.0), "tighten"), (dict(min_budget_scale=0.0), "min_"),
    (dict(mode_switch_s=-1.0), "mode_switch_s"),
    (dict(admission="magic"), "admission"),
    (dict(admission_headroom=0.0), "headroom"),
    (dict(burst_quantile=1.0), "burst_quantile"),
    (dict(split_backlog=0), "split_backlog"), (dict(max_splits=-1), "max_"),
    (dict(defer_cap=-1), "defer_cap"), (dict(priorities=(1.0, 0.0)), "prio")])
def test_controller_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        RefConfig(**kw)
    with pytest.raises(ValueError, match=match):
        ControllerConfig(**kw)


# ---------------------------------------------------------------------------
# controller state, traces and seeds
# ---------------------------------------------------------------------------

def test_controller_state_equals_the_reference():
    """Planning rates under backlog pressure, budgets, mode switches,
    carry-ins and an unserved window's backlog: the reference's floats."""
    kw = dict(rate_estimator="ewma", feedback=True, carry_backlog=True,
              mode_switch_s=0.75, rate_margin=1.5)
    ref, got = RefState(RefConfig(**kw), 2), ControllerState(
        ControllerConfig(**kw), 2)
    tr = [RS.ArrivalTrace.poisson(40.0, 10.0, seed=1),
          RS.ArrivalTrace.uniform(25.0, 10.0)]
    ref.observe_unserved(tr, 10.0)
    got.observe_unserved([convert.arrival_trace(t.times, t.duration)
                          for t in tr], 10.0)
    assert got.carry.pending.tolist() == ref.carry.pending.tolist()
    assert got.carry.stream_ids.tolist() == ref.carry.stream_ids.tolist()
    for t0 in (10.0, 13.5):
        assert got.plan_rates([30.0, 20.0], t0, 10.0) == \
            ref.plan_rates([30.0, 20.0], t0, 10.0)
        assert got.plan_rates([30.0, 20.0], t0, 10.0, margin=1.0,
                              pressure=False) == \
            ref.plan_rates([30.0, 20.0], t0, 10.0, margin=1.0,
                           pressure=False)
    assert got.plan_budgets([0.1, 0.5]) == ref.plan_budgets([0.1, 0.5])
    for pm, rpm in [(MODES[0], REF_MODES[0]), (MODES[0], REF_MODES[0]),
                    (MODES[3], REF_MODES[3])]:
        assert got.mode_switch(pm) == ref.mode_switch(rpm)
    a, b = got.window_carry_in(10.0, 0.75), ref.window_carry_in(10.0, 0.75)
    assert (a.pending.tolist(), a.stream_ids.tolist(), a.clock) == \
        (b.pending.tolist(), b.stream_ids.tolist(), b.clock)


def test_mode_switch_charged_and_carry_in_clock():
    state = ControllerState(ControllerConfig(mode_switch_s=2.0), 1)
    assert state.mode_switch(MODES[0]) == 0.0     # first commit: free
    assert state.mode_switch(MODES[0]) == 0.0     # unchanged: free
    assert state.mode_switch(MODES[1]) == 2.0     # switch: charged
    qs = state.window_carry_in(10.0, 2.0)
    assert qs.clock == 12.0 and len(qs) == 0


def test_trace_clip_and_concat_equal_the_reference():
    ref = RS.ArrivalTrace.poisson(40.0, 30.0, seed=2)
    trace = S.ArrivalTrace.poisson(40.0, 30.0, seed=2)
    for t0, t1, rebase in [(0.0, 10.0, False), (10.0, 20.0, True),
                           (20.0, 31.0, False)]:
        a, b = trace.clip(t0, t1, rebase), ref.clip(t0, t1, rebase)
        assert a.times.tolist() == b.times.tolist()
        assert a.duration == b.duration
    parts = [trace.clip(0.0, 10.0), trace.clip(10.0, 20.0),
             trace.clip(20.0, 31.0)]
    back = S.ArrivalTrace.concat(parts, duration=trace.duration)
    assert back.times.tolist() == ref.times.tolist()
    with pytest.raises(ValueError, match="nondecreasing"):
        S.ArrivalTrace.concat([parts[1], parts[0]])
    with pytest.raises(ValueError, match="empty window"):
        trace.clip(2.0, 1.0)


def test_poisson_seed_scheme_equals_the_reference():
    seen = set()
    for i in range(300):
        for j in range(4):
            s = _poisson_seed(7, i, j, 4)
            assert s == ref_poisson_seed(7, i, j, 4) and s not in seen
            seen.add(s)


def test_queue_state_contents():
    """Pending = the trailing partial minibatch (original times), clock =
    the last completion, both as the reference's."""
    trace = S.ArrivalTrace.uniform(10.0, 1.05)     # 10 arrivals, bs 4
    pm, rpm = PowerModeSpace().maxn(), RefSpace().maxn()
    got = S.simulate(DEV, None, INFER_WORKLOADS["mobilenet"], pm, 4, trace,
                     backend="cpu")
    ref = RS.simulate(REF_DEV, None, REF_INFER["mobilenet"], rpm, 4,
                      RS.ArrivalTrace.uniform(10.0, 1.05), backend="numpy")
    assert got.queue_state.pending.tolist() == trace.times[8:].tolist()
    assert got.queue_state.clock == ref.queue_state.clock
    carry = S.QueueState(np.array([0.01, 0.02]), 0.6)
    got = S.simulate(DEV, None, INFER_WORKLOADS["mobilenet"], pm, 4, trace,
                     carry_in=carry, backend="cpu")
    ref = RS.simulate(REF_DEV, None, REF_INFER["mobilenet"], rpm, 4,
                      RS.ArrivalTrace.uniform(10.0, 1.05), backend="numpy",
                      carry_in=RS.QueueState(np.array([0.01, 0.02]), 0.6))
    _assert_reports_close(ref, got)
    assert got.queue_state.pending.tolist() == \
        ref.queue_state.pending.tolist()


# ---------------------------------------------------------------------------
# backlog carryover: windowed == one long trace, within the tolerance
# ---------------------------------------------------------------------------

def _carryover_config(seed):
    """test_controller.py's generator, on both packages' objects."""
    rng = np.random.default_rng(seed)
    names_tr, names_in = list(REF_TRAIN), list(REF_INFER)
    w_tr = (names_tr[rng.integers(5)] if rng.random() < 0.7 else None)
    w_in = names_in[rng.integers(5)]
    m = int(rng.integers(len(MODES)))
    bs = [1, 4, 16, 32][rng.integers(4)]
    rate = float(rng.uniform(5.0, 120.0))
    duration = float(rng.uniform(20.0, 60.0))
    seed_tr = None if rng.random() < 0.5 else int(rng.integers(1000))
    cap = None if rng.random() < 0.7 else int(rng.integers(0, 4))
    K = int(rng.integers(2, 6))
    return w_tr, w_in, m, bs, rate, duration, seed_tr, cap, K


def _trace(mod, rate, duration, seed):
    return (mod.ArrivalTrace.uniform(rate, duration) if seed is None
            else mod.ArrivalTrace.poisson(rate, duration, seed))


@pytest.mark.parametrize("seed", range(8))
def test_windowed_carryover_equals_long_trace(seed):
    w_tr, w_in, m, bs, rate, duration, seed_tr, cap, K = \
        _carryover_config(seed)
    wt = TRAIN_WORKLOADS[w_tr] if w_tr else None
    trace = _trace(S, rate, duration, seed_tr)
    ref = RS.simulate(REF_DEV, REF_TRAIN[w_tr] if w_tr else None,
                      REF_INFER[w_in], REF_MODES[m], bs,
                      _trace(RS, rate, duration, seed_tr), tau_cap=cap,
                      backend="numpy")
    long = S.simulate(DEV, wt, INFER_WORKLOADS[w_in], MODES[m], bs, trace,
                      tau_cap=cap, backend="cpu")
    W = trace.duration / K
    carry, lats, trained = None, [], 0
    for k in range(K):
        hi = (k + 1) * W if k < K - 1 else trace.duration + 1.0
        rep = S.simulate(DEV, wt, INFER_WORKLOADS[w_in], MODES[m], bs,
                         trace.clip(k * W, hi), tau_cap=cap, carry_in=carry,
                         backend="cpu")
        carry = rep.queue_state
        lats.extend(_lats(rep).tolist())
        trained += rep.train_minibatches
    for want in (long, ref):
        np.testing.assert_allclose(np.asarray(lats), _lats(want), **ENG_TOL)
        # each window may flip a quotient-boundary fill (docs/exactness.md)
        assert abs(trained - want.train_minibatches) <= 2 * K
        assert carry.pending.tolist() == want.queue_state.pending.tolist()
        assert abs(carry.clock - want.queue_state.clock) < 1e-7


def test_windowed_carryover_multi_tenant():
    names, bss = ["mobilenet", "lstm"], [4, 16]
    pm, rpm = PowerModeSpace().maxn(), RefSpace().maxn()
    w_tr = TRAIN_WORKLOADS["resnet18"]
    traces = [S.ArrivalTrace.poisson(30.0, 24.0, seed=1),
              S.ArrivalTrace.uniform(50.0, 24.0)]
    ref = RS.simulate_multi_tenant(
        REF_DEV, REF_TRAIN["resnet18"], [REF_INFER[n] for n in names], rpm,
        bss, [RS.ArrivalTrace.poisson(30.0, 24.0, seed=1),
              RS.ArrivalTrace.uniform(50.0, 24.0)], backend="numpy")
    ws = [INFER_WORKLOADS[n] for n in names]
    long = S.simulate_multi_tenant(DEV, w_tr, ws, pm, bss, traces,
                                   backend="cpu")
    carry, lats, trained = None, [[], []], 0
    for k in range(3):
        hi = (k + 1) * 8.0 if k < 2 else 25.0
        rep = S.simulate_multi_tenant(
            DEV, w_tr, ws, pm, bss, [tr.clip(k * 8.0, hi) for tr in traces],
            carry_in=carry, backend="cpu")
        carry = rep.queue_state
        trained += rep.train_minibatches
        for j, r in enumerate(rep.streams):
            lats[j].extend(_lats(r).tolist())
    for want in (long, ref):
        for j, r in enumerate(want.streams):
            np.testing.assert_allclose(np.asarray(lats[j]), _lats(r),
                                       **ENG_TOL)
        assert abs(trained - want.train_minibatches) <= 2 * 3
        assert carry.pending.tolist() == want.queue_state.pending.tolist()
        assert carry.stream_ids.tolist() == \
            want.queue_state.stream_ids.tolist()
        assert abs(carry.clock - want.queue_state.clock) < 1e-7


# ---------------------------------------------------------------------------
# closed-loop serve_dynamic against the reference's
# ---------------------------------------------------------------------------

_BURST = dict(rate_estimator="ewma", rate_margin=1.5, feedback=True,
              carry_backlog=True, burst_quantile=0.95, split_backlog=64,
              mode_switch_s=0.5)
# resnet50, 40 W, 0.1 s, 30 s windows: the README's closed loop, then the
# three burst cases (Poisson seed 0): each reaches another branch of the
# burst-survival loop (shedding, a capped deferral, degraded plans split
# mid-window)
CASES = {
    "readme": ([45.0, 60.0, 115.0, 50.0], "uniform",
               dict(rate_estimator="ewma", rate_margin=1.5, feedback=True,
                    carry_backlog=True, mode_switch_s=0.5)),
    "shed": ([45.0, 60.0, 180.0, 50.0], "poisson",
             dict(_BURST, admission="shed")),
    "defer": ([45.0, 60.0, 180.0, 50.0], "poisson",
              dict(_BURST, admission="defer", defer_cap=500)),
    "degrade-bs": ([45.0, 60.0, 180.0, 50.0], "poisson",
                   dict(rate_estimator="ewma", carry_backlog=True,
                        split_backlog=64, admission="degrade-bs")),
}


@pytest.mark.parametrize("case", CASES)
def test_closed_loop_cases_match_the_reference(case):
    rates, arrivals, cfg = CASES[case]
    ref, got = serve_both("resnet50", 0.1, rates, cfg, window_duration=30.0,
                          arrivals=arrivals, seed=0)
    assert_windows_match(ref, got)
    if case == "shed":
        assert [w.shed_requests for w in got] == [377, 237, 1988, 0]
    if case == "defer":
        assert [w.deferred_requests for w in got] == [377, 500, 500, 0]
    if case == "degrade-bs":
        assert [w.splits for w in got] == [0, 2, 1, 0]


def test_closed_loop_estimates_and_carryover():
    """test_controller.py's closed-loop cases: EWMA estimates with
    carryover on Poisson arrivals, mode-switch charges, and the EWMA +
    feedback loop on ten windows."""
    ref, got = serve_both("mobilenet", 0.5, [40.0, 70.0, 40.0, 40.0],
                          dict(rate_estimator="ewma", carry_backlog=True),
                          window_duration=10.0, arrivals="poisson")
    assert_windows_match(ref, got)
    assert got[0].estimated_rate == 40.0
    assert got[2].estimated_rate == pytest.approx(70.0, rel=0.3)
    ref, got = serve_both("mobilenet", 0.5, [40.0, 60.0],
                          dict(mode_switch_s=0.5), window_duration=10.0)
    assert_windows_match(ref, got)
    rng = random.Random(42)
    rates = [max(30.0, min(76.0, rng.gauss(60, math.sqrt(60))))
             for _ in range(10)]
    ref, got = serve_both("mobilenet", 0.1, rates,
                          dict(rate_estimator="ewma", rate_margin=1.5,
                               feedback=True, carry_backlog=True),
                          window_duration=30.0)
    assert_windows_match(ref, got)
    ok = sum(w.report is not None and w.report.violation_rate(0.1) <= 0.05
             for w in got)
    assert ok / len(got) >= 0.9


def test_closed_loop_multi_tenant_per_stream_state():
    windows = [(40.0, 50.0), (70.0, 20.0), (30.0, 60.0)]
    cfg = dict(rate_estimator="ewma", feedback=True, carry_backlog=True)
    ref = RefFulcrum(REF_DEV).serve_dynamic(
        (RP.StreamSpec(40.0, 1.0, REF_INFER["mobilenet"]),
         RP.StreamSpec(50.0, 0.6, REF_INFER["lstm"])), 40.0, None, windows,
        "gmd", window_duration=10.0, arrivals="poisson",
        w_tr=REF_TRAIN["mobilenet"], controller=RefConfig(**cfg),
        backend="numpy")
    got = Fulcrum(DEV).serve_dynamic(
        (P.StreamSpec(40.0, 1.0, INFER_WORKLOADS["mobilenet"]),
         P.StreamSpec(50.0, 0.6, INFER_WORKLOADS["lstm"])), 40.0, None,
        windows, "gmd", window_duration=10.0, arrivals="poisson",
        w_tr=TRAIN_WORKLOADS["mobilenet"], controller=ControllerConfig(**cfg),
        backend="cpu")
    assert_windows_match(ref, got)
    assert isinstance(got[2].estimated_rate, tuple)
    assert got[2].estimated_rate[0] == pytest.approx(70.0, rel=0.35)
    assert got[2].estimated_rate[1] == pytest.approx(20.0, rel=0.35)


def test_open_loop_default_equals_explicit_config():
    f = Fulcrum(DEV)
    w = INFER_WORKLOADS["mobilenet"]
    a = f.serve_dynamic(w, 40.0, 0.5, [40.0, 70.0, 55.0], "gmd",
                        window_duration=10.0, backend="cpu")
    b = f.serve_dynamic(w, 40.0, 0.5, [40.0, 70.0, 55.0], "gmd",
                        window_duration=10.0, backend="cpu",
                        controller=ControllerConfig())
    for wa, wb in zip(a, b):
        assert _lats(wa.report).tolist() == _lats(wb.report).tolist()
        assert wa.solution == wb.solution and wa.estimated_rate == wa.rate


# ---------------------------------------------------------------------------
# the fitted-strategy branches, through a registered stub strategy
# ---------------------------------------------------------------------------

class _PointStrategy:
    """A fitted strategy's interface over a fixed observation set: point
    problems only (no interval or capacity solve), and ``solve_batch``."""

    def __init__(self, solve_fn, obs):
        self.solve_fn, self.obs = solve_fn, obs

    def solve(self, prob):
        return self.solve_fn(prob, self.obs)

    def solve_batch(self, probs):
        return [self.solve(p) for p in probs]


def _infer_obs(dev, modes, w):
    return {(pm, bs): dev.time_power(w, pm, bs)
            for pm in modes[::7] for bs in P.INFER_BATCH_SIZES}


ref_register(RefScenario.INFER, "point-stub",
             lambda f, w: _PointStrategy(RP.solve_infer,
                                         _infer_obs(f.device, REF_MODES, w)))
register_strategy(Scenario.INFER, "point-stub",
                  lambda f, w: _PointStrategy(P.solve_infer,
                                              _infer_obs(f.device, MODES, w)))


@pytest.mark.parametrize("extra", [dict(), dict(admission="degrade-bs",
                                                split_backlog=64),
                                   dict(admission="shed",
                                        burst_quantile=0.95)])
def test_fitted_strategy_branches_match_the_reference(extra):
    """A margined closed loop on a point-only strategy takes the down-move
    guard instead of the interval solve, and ``degrade-bs`` re-solves at
    the margined rate with the budget waived (no capacity solve)."""
    cfg = dict(rate_estimator="ewma", rate_margin=1.5, feedback=True,
               carry_backlog=True, **extra)
    rates = [45.0, 60.0, 180.0, 50.0]
    ref = RefFulcrum(REF_DEV).serve_dynamic(
        REF_INFER["resnet50"], 40.0, 0.1, rates, "point-stub",
        window_duration=30.0, arrivals="poisson", seed=0,
        controller=RefConfig(**cfg), backend="numpy")
    got = Fulcrum(DEV).serve_dynamic(
        INFER_WORKLOADS["resnet50"], 40.0, 0.1, rates, "point-stub",
        window_duration=30.0, arrivals="poisson", seed=0,
        controller=ControllerConfig(**cfg), backend="cpu")
    assert_windows_match(ref, got)
    assert any(w.solution is not None for w in got)
    sols = Fulcrum(DEV).solve_dynamic(INFER_WORKLOADS["lstm"], 30.0, 0.3,
                                      [20.0, 80.0], "point-stub")
    want = RefFulcrum(REF_DEV).solve_dynamic(REF_INFER["lstm"], 30.0, 0.3,
                                             [20.0, 80.0], "point-stub")
    assert [None if s is None else dataclasses.asdict(s) for s in sols] == \
        [None if s is None else dataclasses.asdict(s) for s in want]
