"""Burst survival in the port: admission control, deferral and mid-window
re-planning against the reference's, mirroring ``tests/test_admission.py``.

Tolerances. The admission masks (``_admit_mask``, ``_admit_mask_multi``,
``AdmissionPolicy.admit`` / ``admit_multi``), ``first_backlog_crossing``,
the burst quantiles and the deferral state are host float64 code copied
from the reference: equal to it bitwise on the same inputs. What the
engine replays is in the engine tolerance tier (``atol=1e-8,
rtol=1e-9``): a window split at an arrival matches the unsplit run within
it, and an admitted request meets its budget within it, ``latency <=
budget + atol + rtol * budget`` (on the reference's NumPy tier it is
exact). The closed loops compare as in ``tests/test_torch_controller.py``:
discrete decisions per window equal, latencies within the tolerance.
"""
import numpy as np
import pytest

from repro.core import problem as RP
from repro.core import simulate as RS
from repro.core.controller import AdmissionPolicy as RefPolicy
from repro.core.controller import ControllerConfig as RefConfig
from repro.core.controller import ControllerState as RefState
from repro.core.controller import _admit_mask as ref_admit_mask
from repro.core.controller import _admit_mask_multi as ref_admit_mask_multi
from repro.core.device_model import DeviceModel as RefDevice
from repro.core.device_model import INFER_WORKLOADS as REF_INFER
from repro.core.scheduler import Fulcrum as RefFulcrum
from repro.runtime.clock import FakeClock as RefFakeClock
from repro.runtime.interleave_runtime import InterleaveConfig as RefICfg
from repro.runtime.interleave_runtime import \
    ManagedInterleaveRuntime as RefRuntime
from repro_torch.core import problem as P
from repro_torch.core import simulate as S
from repro_torch.core.controller import (AdmissionPolicy, ControllerConfig,
                                         ControllerState, _admit_mask,
                                         _admit_mask_multi)
from repro_torch.core.device_model import DeviceModel, INFER_WORKLOADS
from repro_torch.core.powermode import PowerModeSpace
from repro_torch.core.scheduler import Fulcrum
from repro_torch.runtime.clock import FakeClock
from repro_torch.runtime.interleave_runtime import (InterleaveConfig,
                                                    ManagedInterleaveRuntime)
from test_torch_controller import assert_windows_match, serve_both

ENG_TOL = dict(rtol=1e-9, atol=1e-8)
DEV, REF_DEV = DeviceModel(), RefDevice()
SPACE = PowerModeSpace()
MODES = SPACE.all_modes()


def _within_budget(rep, budget):
    """Every latency within ``budget`` to the engine tolerance."""
    lats = np.asarray(rep.latencies, np.float64)
    return bool(np.all(lats <= budget + ENG_TOL["atol"]
                       + ENG_TOL["rtol"] * budget))


# ---------------------------------------------------------------------------
# burst quantiles and drainability (the port's problem.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mean", [0.0, 0.5, 3.0, 20.0, 200.0, 2000.0])
@pytest.mark.parametrize("q", [0.0, 0.5, 0.95, 0.999])
def test_poisson_quantile_and_burst_rate_equal_the_reference(mean, q):
    assert P.poisson_quantile(mean, q) == RP.poisson_quantile(mean, q)
    assert P.burst_rate(mean, 10.0, q) == RP.burst_rate(mean, 10.0, q)


def test_drain_capacity_min_shed_and_drainable():
    assert P.drain_capacity(4, 0.05, 30.0) == 2400
    assert P.min_shed(2500, 4, 0.05, 30.0) == 100
    assert P.drainable(0, 80.0, 4, 0.05, 30.0)
    assert not P.drainable(1, 80.0, 4, 0.05, 30.0)
    assert not P.drainable(0, 81.0, 4, 0.05, 30.0)


# ---------------------------------------------------------------------------
# the admission masks: the reference's bits
# ---------------------------------------------------------------------------

def _flood(rng, n):
    """Sorted arrivals over-running a bs/t_in service, with a stale carried
    head, per-request budgets near the service time, and a device clock."""
    bs = int(rng.choice([1, 2, 4, 8]))
    t_in = float(rng.uniform(0.005, 0.05))
    rate = float(rng.uniform(0.5, 4.0)) * bs / t_in
    times = np.sort(rng.uniform(0.0, n / rate, n))
    times[: int(rng.integers(0, 5))] = 0.0
    budgets = rng.uniform(1.5, 6.0, n) * t_in
    clock = float(rng.choice([0.0, rng.uniform(0.0, 0.3)]))
    return times, budgets, bs, t_in, clock


@pytest.mark.parametrize("seed", range(6))
def test_admit_mask_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    times, budgets, bs, t_in, clock = _flood(rng, int(rng.integers(1, 600)))
    got = _admit_mask(times, budgets, bs, t_in, clock)
    assert np.array_equal(got, ref_admit_mask(times, budgets, bs, t_in,
                                              clock))
    pol, ref = AdmissionPolicy("shed", 0.8), RefPolicy("shed", 0.8)
    assert np.array_equal(pol.admit(times, 0.1, bs, t_in, clock),
                          ref.admit(times, 0.1, bs, t_in, clock))


@pytest.mark.parametrize("seed", range(6))
def test_admit_mask_multi_equals_the_reference(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(2, 5))
    k = int(rng.integers(1, 800))
    times = np.sort(rng.uniform(0.0, 2.0, k))
    sids = rng.integers(0, n, k)
    bss = [int(rng.choice([1, 4, 8])) for _ in range(n)]
    t_ins = [float(rng.uniform(0.002, 0.02)) for _ in range(n)]
    budgets = rng.uniform(0.01, 0.2, k)
    clock = float(rng.uniform(0.0, 0.2))
    assert np.array_equal(
        _admit_mask_multi(times, sids, bss, t_ins, budgets, clock),
        ref_admit_mask_multi(times, sids, bss, t_ins, budgets, clock))
    prio = tuple(float(p) for p in rng.uniform(0.2, 1.0, n))
    nominal = [float(b) for b in rng.uniform(0.02, 0.2, n)]
    assert np.array_equal(
        AdmissionPolicy("shed", 0.9, prio).admit_multi(
            times, sids, bss, t_ins, nominal, clock),
        RefPolicy("shed", 0.9, prio).admit_multi(
            times, sids, bss, t_ins, nominal, clock))


def test_admit_mask_edges():
    """Uncongested admits all; a stale carried head is shed first; a
    trailing partial batch is admitted untouched; empty is empty; one
    stream through the multi mask is the single-stream mask."""
    pol = AdmissionPolicy("shed")
    assert pol.admit(S.ArrivalTrace.uniform(20.0, 10.0).times, 0.5, 4,
                     0.01, 0.0).all()
    times = np.concatenate([np.zeros(4), 5.0 + np.arange(8) * 0.01])
    mask = _admit_mask(times, np.full(times.size, 0.2), 4, 0.01, clock=5.0)
    assert not mask[:4].any() and mask[4:].all()
    assert _admit_mask(np.array([0.0, 0.1, 0.2]), np.full(3, 1e-6), 4, 10.0,
                       0.0).all()
    assert pol.admit(np.empty(0), 0.1, 4, 0.01, 0.0).size == 0
    trace = S.ArrivalTrace.poisson(300.0, 3.0, seed=7)
    assert np.array_equal(
        pol.admit(trace.times, 0.12, 4, 0.02, 0.0),
        pol.admit_multi(trace.times, np.zeros(len(trace), np.int64), [4],
                        [0.02], [0.12], 0.0))


def test_admit_multi_priorities_shed_low_priority_first():
    n = 400
    t = np.repeat(np.arange(n) * 0.004, 2)
    sids = np.tile([0, 1], n)
    mask = AdmissionPolicy("shed", priorities=(1.0, 0.25)).admit_multi(
        t, sids, [4, 4], [0.02, 0.02], [0.15, 0.15], 0.0)
    assert np.count_nonzero(~mask[sids == 1]) > \
        np.count_nonzero(~mask[sids == 0])


def test_admission_policy_validation():
    with pytest.raises(ValueError, match="admission mode"):
        AdmissionPolicy("drop-tail")
    with pytest.raises(ValueError, match="headroom"):
        AdmissionPolicy("shed", headroom=0.0)
    with pytest.raises(ValueError, match="priorities"):
        AdmissionPolicy("shed", priorities=(1.0,)).stream_budget_scales(2)
    assert not AdmissionPolicy("none").active
    assert AdmissionPolicy("defer").trims
    assert not AdmissionPolicy("degrade-bs").trims


# ---------------------------------------------------------------------------
# deferral state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [None, 0, 6, 40])
def test_push_pop_deferred_equals_the_reference(cap):
    got = ControllerState(ControllerConfig(admission="defer", defer_cap=cap),
                          3)
    ref = RefState(RefConfig(admission="defer", defer_cap=cap), 3)
    rng = np.random.default_rng(3)
    for k in range(5):
        counts = [int(c) for c in rng.integers(0, 12, 3)]
        assert got.push_deferred(counts) == ref.push_deferred(counts)
        if k % 2:
            a, b = got.pop_deferred(12.5 + k), ref.pop_deferred(12.5 + k)
            assert [x.tolist() for x in a] == [x.tolist() for x in b]
    assert got.deferred.tolist() == ref.deferred.tolist()


# ---------------------------------------------------------------------------
# mid-window re-planning: backlog crossing and the split replay
# ---------------------------------------------------------------------------

def test_first_backlog_crossing_counts_uncompleted():
    times = np.arange(8, dtype=np.float64)
    comps = np.array([2.5, 4.5])
    assert S.first_backlog_crossing(times, comps, 2, 3) == 7
    assert S.first_backlog_crossing(times, comps, 2, 2) == 2
    assert S.first_backlog_crossing(times, comps, 2, 99) is None
    assert S.first_backlog_crossing(np.empty(0), comps, 2, 0) is None


@pytest.mark.parametrize("seed", range(6))
def test_first_backlog_crossing_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    bs = int(rng.choice([1, 4, 8]))
    times = np.sort(rng.uniform(0.0, 10.0, int(rng.integers(1, 400))))
    comps = np.sort(rng.uniform(0.0, 12.0, times.size // bs))
    for threshold in (0, 8, 24, 64):
        assert S.first_backlog_crossing(times, comps, bs, threshold) == \
            RS.first_backlog_crossing(times, comps, bs, threshold)


@pytest.mark.parametrize("seed", range(4))
def test_split_at_an_arrival_matches_the_unsplit_run(seed):
    """Clip a window at an arrival, chain the QueueState: the two halves
    meet the unsplit run within the engine tolerance."""
    rng = np.random.default_rng(seed)
    w = list(INFER_WORKLOADS.values())[rng.integers(5)]
    pm = MODES[rng.integers(len(MODES))]
    bs = [1, 4, 8][rng.integers(3)]
    trace = S.ArrivalTrace.poisson(float(rng.uniform(30, 120)), 8.0,
                                   seed=seed)
    split_t = float(trace.times[rng.integers(1, len(trace) - 1)])
    whole = S.simulate(DEV, None, w, pm, bs, trace, backend="cpu")
    head = S.simulate(DEV, None, w, pm, bs, trace.clip(0.0, split_t),
                      backend="cpu")
    tail = S.simulate(DEV, None, w, pm, bs, trace.clip(split_t, 9.0),
                      carry_in=head.queue_state, backend="cpu")
    lats = np.concatenate([np.asarray(head.latencies, np.float64),
                           np.asarray(tail.latencies, np.float64)])
    np.testing.assert_allclose(lats, np.asarray(whole.latencies, np.float64),
                               **ENG_TOL)


@pytest.mark.parametrize("seed", range(4))
def test_admitted_requests_meet_the_budget_within_the_tolerance(seed):
    rng = np.random.default_rng(seed)
    w = list(INFER_WORKLOADS.values())[rng.integers(5)]
    pm = MODES[rng.integers(len(MODES))]
    bs = [2, 4, 8][rng.integers(3)]
    t_in = DEV.time_power(w, pm, bs)[0]
    budget = float(rng.uniform(2.5, 6.0)) * t_in
    trace = S.ArrivalTrace.poisson(3.0 * bs / t_in, 5.0, seed=seed)
    mask = AdmissionPolicy("shed").admit(trace.times, budget, bs, t_in, 0.0)
    assert not mask.all() and mask.any()
    admitted = S.ArrivalTrace(trace.times[mask], trace.duration, trace.kind)
    assert _within_budget(S.simulate(DEV, None, w, pm, bs, admitted,
                                     backend="cpu"), budget)
    raw = S.simulate(DEV, None, w, pm, bs, trace, backend="cpu")
    assert raw.violation_rate(budget) > 0.0


# ---------------------------------------------------------------------------
# the burst-survival loops against the reference's
# ---------------------------------------------------------------------------

_PLAIN = dict(rate_estimator="ewma", rate_margin=1.5, feedback=True,
              carry_backlog=True, mode_switch_s=0.5)

# test_admission.py's loops on mobilenet, 40 W, 0.1 s, 10 s Poisson windows
LOOPS = {
    "plain": ([60.0, 80.0, 45.0, 70.0], 3, _PLAIN),
    "none": ([60.0, 80.0, 45.0, 70.0], 3, dict(_PLAIN, admission="none")),
    "splits": ([20.0, 120.0, 120.0], 5,
               dict(rate_estimator="ewma", carry_backlog=True,
                    admission="none", split_backlog=24, max_splits=2)),
    "shed": ([300.0, 300.0, 300.0], 3,
             dict(_PLAIN, admission="shed", burst_quantile=0.95)),
    "defer": ([300.0, 60.0, 60.0], 3,
              dict(_PLAIN, admission="defer", burst_quantile=0.95,
                   defer_cap=2000)),
    "degrade-bs": ([300.0, 500.0], 3,
                   dict(_PLAIN, admission="degrade-bs",
                        burst_quantile=0.95)),
}


@pytest.mark.parametrize("loop", LOOPS)
def test_burst_loops_match_the_reference(loop):
    rates, seed, cfg = LOOPS[loop]
    ref, got = serve_both("mobilenet", 0.1, rates, cfg,
                          window_duration=10.0, arrivals="poisson",
                          seed=seed)
    assert_windows_match(ref, got)
    if loop in ("shed", "defer"):
        for w in got:
            assert _within_budget(w.report, 0.1)
    if loop == "shed":
        assert sum(w.shed_requests for w in got) > 0
    if loop == "defer":
        assert got[0].deferred_requests > 0
    if loop == "splits":
        assert sum(w.splits for w in got) >= 2
    if loop == "degrade-bs":
        assert all(w.shed_requests == w.deferred_requests == 0 for w in got)


def test_multi_tenant_shed_matches_the_reference():
    cfg = dict(rate_estimator="ewma", carry_backlog=True, admission="shed",
               burst_quantile=0.95, priorities=(1.0, 0.5))
    windows = [(100.0, 60.0), (130.0, 78.0)]
    ref = RefFulcrum(REF_DEV).serve_dynamic(
        (RP.StreamSpec(100.0, 0.1, REF_INFER["mobilenet"]),
         RP.StreamSpec(60.0, 0.2, REF_INFER["lstm"])), 55.0, None, windows,
        "gmd", window_duration=10.0, arrivals="poisson", seed=2,
        controller=RefConfig(**cfg), backend="numpy")
    specs = (P.StreamSpec(100.0, 0.1, INFER_WORKLOADS["mobilenet"]),
             P.StreamSpec(60.0, 0.2, INFER_WORKLOADS["lstm"]))
    got = Fulcrum(DEV).serve_dynamic(
        specs, 55.0, None, windows, "gmd", window_duration=10.0,
        arrivals="poisson", seed=2, controller=ControllerConfig(**cfg),
        backend="cpu")
    assert_windows_match(ref, got)
    assert sum(w.shed_requests for w in got) > 0
    for w in got:
        for rep, spec in zip(w.report.streams, specs):
            assert _within_budget(rep, spec.latency_budget)


# ---------------------------------------------------------------------------
# the runtime's admission gate
# ---------------------------------------------------------------------------

class _Server:
    def __init__(self, clock, t_in):
        self.clock, self.t_in = clock, t_in

    def infer(self):
        self.clock.advance(self.t_in)


def test_runtime_gate_equals_the_engine_mask_and_the_reference_runtime():
    """The gate sheds the engine mask's request set; the gated FakeClock
    run equals the reference runtime's gated run bitwise and the port's
    engine on the admitted trace within the tolerance."""
    w = INFER_WORKLOADS["mobilenet"]
    pm = SPACE.maxn()
    bs = 4
    t_in = DEV.time_power(w, pm, bs)[0]
    budget = 4.0 * t_in
    trace = S.ArrivalTrace.poisson(3.0 * bs / t_in, 4.0, seed=11)
    mask = AdmissionPolicy("shed").admit(trace.times, budget, bs, t_in, 0.0)
    admitted = S.ArrivalTrace(trace.times[mask], trace.duration, trace.kind)

    clock = FakeClock()
    rep = ManagedInterleaveRuntime(
        None, _Server(clock, t_in),
        InterleaveConfig(arrival_rate=0.0, infer_bs=bs,
                         latency_budget=budget),
        trace=trace, clock=clock,
        admission=AdmissionPolicy("shed").gate(bs, t_in, budget)).run()
    assert rep.shed_requests == int(np.count_nonzero(~mask)) > 0
    eng = S.simulate(DEV, None, w, pm, bs, admitted, backend="cpu")
    np.testing.assert_allclose(np.asarray(rep.latencies, np.float64),
                               np.asarray(eng.latencies, np.float64),
                               **ENG_TOL)
    assert _within_budget(rep, budget)

    rclock = RefFakeClock()
    ref = RefRuntime(
        None, _Server(rclock, t_in),
        RefICfg(arrival_rate=0.0, infer_bs=bs, latency_budget=budget),
        trace=RS.ArrivalTrace(trace.times.copy(), trace.duration, trace.kind),
        clock=rclock,
        admission=RefPolicy("shed").gate(bs, t_in, budget)).run()
    assert rep.latencies == ref.latencies
    assert rep.shed_requests == ref.shed_requests


def test_runtime_gate_passes_through_and_rejects_merged_traces():
    gate = AdmissionPolicy("degrade-bs").gate(4, 0.01, 0.1)
    trace = S.ArrivalTrace.uniform(500.0, 1.0)
    assert gate(trace) == (trace, 0)
    merged = S.ArrivalTrace.merge([S.ArrivalTrace.uniform(10.0, 2.0)] * 2)
    with pytest.raises(ValueError, match="single-stream"):
        ManagedInterleaveRuntime(
            None, None, InterleaveConfig(arrival_rate=0.0, infer_bs=4,
                                         latency_budget=0.1),
            trace=merged, admission=AdmissionPolicy("shed").gate(4, 0.01,
                                                                 0.1))
