"""The port's K-device fleet (``repro_torch.core.fleet``) against the
reference's, mirroring ``tests/test_fleet.py``.

Tolerances. Dispatch, deferral, migration and water-filling are host code
copied from the reference: equal on the same inputs. The solves are the
port's ``grid_eval`` solvers, bitwise the reference's NumPy tier. The
engine (``"cpu"``, the kernels' plain versions) is in the tolerance tier
of ``docs/exactness.md``: latencies within ``atol=1e-8, rtol=1e-9`` of the
reference's NumPy engine. Against the reference, every window makes the
same decisions — the dispatch counts, each device's plan (pm, bs, tau_tr)
and its power, the shed / deferred / migrated / carried / offered counts,
the water-filled budgets, estimated rates and mode-switch charges; a
plan's latency ``time`` is within the engine tolerance (the high-rate
rung plans at a rate that folds in the carried clock, an engine value);
goodput within one offered request. ``serve_fleet`` against the port's own
``serve_fleet_sequential`` on ``"cpu"`` is bitwise: the plain max-plus scan
gives a lane the same bits however many lanes and events it is padded to
(padding combines only with identity elements), so the batched and the
one-lane engine calls agree exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import fleet as RF
from repro.core import simulate as RS
from repro.core.controller import ControllerConfig as RefConfig
from repro.core.controller import FleetControllerState as RefFleetState
from repro.core.device_model import DeviceModel as RefDevice
from repro.core.device_model import INFER_WORKLOADS as REF_INFER
from repro.core.device_model import TRAIN_WORKLOADS as REF_TRAIN
from repro.core.device_model import fleet_device as ref_fleet_device
from repro.core.powermode import PowerModeSpace as RefSpace
from repro_torch.core import fleet as F
from repro_torch.core import simulate as S
from repro_torch.core.controller import ControllerConfig, FleetControllerState
from repro_torch.core.device_model import (DeviceModel, INFER_WORKLOADS,
                                           TRAIN_WORKLOADS, fleet_device)
from repro_torch.core.powermode import PowerModeSpace
from repro_torch.core.scheduler import Fulcrum, Scenario

ENG_TOL = dict(rtol=1e-9, atol=1e-8)
DEV, REF_DEV = DeviceModel(), RefDevice()
MODES, REF_MODES = PowerModeSpace().all_modes(), RefSpace().all_modes()
W_IN, REF_W_IN = INFER_WORKLOADS["mobilenet"], REF_INFER["mobilenet"]


# ---------------------------------------------------------------------------
# comparing two fleet runs window by window
# ---------------------------------------------------------------------------

def _close(a: float, b: float) -> bool:
    return abs(a - b) <= ENG_TOL["atol"] + ENG_TOL["rtol"] * abs(a)


def _plan(sol):
    """A plan's decisions and power (exact), and its latency (``time``)."""
    d = dataclasses.asdict(sol)
    return d, d.pop("time")


def assert_fleets_match(ref, got, exact=False):
    """Per window, the same decisions; latencies (and a plan's ``time``)
    within the engine tolerance, or bitwise with ``exact``."""
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        assert b.dispatch_counts.tolist() == a.dispatch_counts.tolist()
        assert b.trace.stream_ids.tolist() == a.trace.stream_ids.tolist()
        assert b.trace.times.tolist() == a.trace.times.tolist()
        assert (b.rate, b.offered_requests, b.shed_requests,
                b.deferred_requests, b.migrated_requests) == \
            (a.rate, a.offered_requests, a.shed_requests,
             a.deferred_requests, a.migrated_requests)
        assert (b.power_budgets is None) == (a.power_budgets is None)
        if a.power_budgets is not None:
            assert b.power_budgets.tolist() == a.power_budgets.tolist()
        assert abs(b.goodput - a.goodput) * max(1, a.offered_requests) \
            <= (0 if exact else 1)
        assert len(b.devices) == len(a.devices)
        for da, db in zip(a.devices, b.devices):
            assert (db.rate, db.estimated_rate, db.replanned,
                    db.mode_switch_s, db.carried_requests,
                    db.offered_requests, db.shed_requests,
                    db.deferred_requests) == \
                (da.rate, da.estimated_rate, da.replanned, da.mode_switch_s,
                 da.carried_requests, da.offered_requests, da.shed_requests,
                 da.deferred_requests)
            assert abs(db.goodput - da.goodput) \
                * max(1, da.offered_requests) <= (0 if exact else 1)
            assert (db.solution is None) == (da.solution is None)
            assert (db.report is None) == (da.report is None)
            if da.solution is None:
                continue
            (pa, ta), (pb, tb) = _plan(da.solution), _plan(db.solution)
            assert pb == pa
            assert tb == ta if exact else _close(ta, tb)
            ra, rb = da.report, db.report
            la = np.asarray(ra.latencies, np.float64)
            lb = np.asarray(rb.latencies, np.float64)
            if exact:
                assert lb.tobytes() == la.tobytes()
            else:
                np.testing.assert_allclose(lb, la, **ENG_TOL)
            assert rb.sorted_latencies.tolist() == np.sort(lb).tolist()
            assert (rb.shed_requests, rb.deferred_requests, rb.power,
                    rb.attributed_power) == \
                (ra.shed_requests, ra.deferred_requests, ra.power,
                 ra.attributed_power)
            qa, qb = ra.queue_state, rb.queue_state
            assert qb.pending.tolist() == qa.pending.tolist()
            assert qb.clock == qa.clock if exact else _close(qa.clock,
                                                              qb.clock)
        assert b.attributed_power == a.attributed_power


def serve_both(K, cfg, rates, spec_kw=None, power=30.0, latency=0.2,
               fn="serve_fleet", **kw):
    """One fleet run on the reference's NumPy tier and on the port's
    ``"cpu"`` backend, from the same arguments."""
    spec_kw = spec_kw or {}
    kw = dict(dict(window_duration=3.0, arrivals="poisson", seed=7), **kw)
    ref = getattr(RF, fn)(REF_W_IN, power, latency, rates,
                          RF.FleetSpec(K, **spec_kw), backend="numpy",
                          controller=RefConfig(**cfg), **kw)
    got = getattr(F, fn)(W_IN, power, latency, rates,
                         F.FleetSpec(K, **spec_kw), backend="cpu",
                         controller=ControllerConfig(**cfg), **kw)
    return ref, got


# ---------------------------------------------------------------------------
# fleets, devices and dispatch: the reference's
# ---------------------------------------------------------------------------

def test_fleet_devices_are_the_references():
    spec, ref = F.FleetSpec(16, seed=9, time_spread=0.3), \
        RF.FleetSpec(16, seed=9, time_spread=0.3)
    for d, r in zip(spec.devices(), ref.devices()):
        assert (d.time_scale, d.power_scale, d.index) == \
            (r.time_scale, r.power_scale, r.index)
    d = fleet_device(5, seed=9)
    assert d.time_scale == ref_fleet_device(5, seed=9).time_scale
    for pm in MODES[:8]:
        t0, p0 = DEV.time_power(W_IN, pm, 16)
        assert d.time_power(W_IN, pm, 16) == (t0 * d.time_scale,
                                              p0 * d.power_scale)


@pytest.mark.parametrize("kw,match", [
    (dict(n_devices=0), "at least one"),
    (dict(n_devices=4, time_spread=1.5), "spreads"),
    (dict(n_devices=4, dispatch="round-trip"), "dispatch"),
    (dict(n_devices=2, fleet_power_budget=0.0), "fleet_power_budget")])
def test_fleet_spec_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        F.FleetSpec(**kw)


def _greedy_dispatch(n, weights, counts0=None):
    counts = (np.zeros(len(weights), np.int64) if counts0 is None
              else np.asarray(counts0, np.int64).copy())
    out = np.empty(n, np.int64)
    for k in range(n):
        out[k] = int(np.argmin((counts + 1.0) / weights))
        counts[out[k]] += 1
    return out


@pytest.mark.parametrize("seed", range(6))
def test_dispatch_matches_the_greedy_definition_and_the_reference(seed):
    rng = np.random.default_rng(seed)
    K = int(rng.integers(1, 12))
    n = int(rng.integers(0, 400))
    wts = rng.uniform(0.5, 2.0, K)
    c0 = rng.integers(0, 30, K) if rng.random() < 0.5 else None
    got = F.dispatch_arrivals(np.zeros(n), wts, c0)
    assert got.tolist() == _greedy_dispatch(n, wts, c0).tolist()
    assert got.tolist() == RF.dispatch_arrivals(np.zeros(n), wts, c0).tolist()


def test_dispatch_is_proportional_and_round_trips_provenance():
    sid = F.dispatch_arrivals(np.zeros(400), np.array([1.0, 1.0, 2.0]))
    assert np.bincount(sid, minlength=3).tolist() == [100, 100, 200]
    agg = S.ArrivalTrace.poisson(80.0, 5.0, seed=3)
    wts = np.array([1.0, 1.3, 0.8, 1.1])
    sid = F.dispatch_arrivals(agg.times, wts)
    merged, per_dev = F.split_window(agg, sid, 4)
    assert merged.n_streams == 4 and len(merged) == len(agg)
    for d, (tr, tr2) in enumerate(zip(per_dev, merged.split(4))):
        assert tr.times.tolist() == agg.times[sid == d].tolist()
        assert tr.times.tolist() == tr2.times.tolist()
        assert tr.duration == agg.duration
    with pytest.raises(ValueError, match="positive"):
        F.dispatch_arrivals(np.zeros(3), np.array([1.0, 0.0]))


# ---------------------------------------------------------------------------
# FleetControllerState: the reference's per-device states and deferrals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [None, 0, 25])
def test_fleet_controller_state_defers_as_the_reference(cap):
    cfg = dict(rate_estimator="ewma", carry_backlog=True, admission="defer",
               defer_cap=cap, feedback=True, rate_margin=1.5)
    got = FleetControllerState(ControllerConfig(**cfg), 3)
    ref = RefFleetState(RefConfig(**cfg), 3)
    assert len(got) == len(ref) == 3
    for n in (10, 0, 30, 7):
        assert got.push_fleet_deferred(n) == ref.push_fleet_deferred(n)
        assert got.fleet_deferred == ref.fleet_deferred
    assert got.pop_fleet_deferred() == ref.pop_fleet_deferred()
    assert got.fleet_deferred == ref.fleet_deferred == 0
    for d in range(3):
        tr = S.ArrivalTrace.poisson(40.0 + 10 * d, 2.0, seed=d)
        rtr = RS.ArrivalTrace.poisson(40.0 + 10 * d, 2.0, seed=d)
        got.observe_unserved(d, tr, 2.0)
        ref.observe_unserved(d, rtr, 2.0)
        assert got.mode_switch(d, MODES[d]) == ref.mode_switch(d,
                                                               REF_MODES[d])
        assert got.mode_switch(d, MODES[d + 1]) == \
            ref.mode_switch(d, REF_MODES[d + 1])
        cg, cr = got.window_carry_in(d, 2.0, 0.25), \
            ref.window_carry_in(d, 2.0, 0.25)
        assert (cg.pending.tolist(), cg.clock) == (cr.pending.tolist(),
                                                   cr.clock)
    ann = [30.0, 45.0, 60.0]
    assert got.plan_rates(ann, 2.0, 2.0).tolist() == \
        ref.plan_rates(ann, 2.0, 2.0).tolist()
    assert got.plan_budgets([0.1] * 3).tolist() == \
        ref.plan_budgets([0.1] * 3).tolist()
    with pytest.raises(ValueError, match="at least one"):
        FleetControllerState(ControllerConfig(), 0)


# ---------------------------------------------------------------------------
# simulate_batch(devices=...): per-lane devices into the max-plus scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_simulate_batch_with_per_lane_devices_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = 7
    idx = rng.integers(0, len(MODES), n)
    bss = [int(b) for b in rng.choice([1, 4, 16, 32], n)]
    devs = [fleet_device(d, seed=seed, time_spread=0.3) for d in range(n)]
    ref_devs = [ref_fleet_device(d, seed=seed, time_spread=0.3)
                for d in range(n)]
    rates = rng.uniform(10.0, 90.0, n)
    traces = [S.ArrivalTrace.poisson(float(r), 4.0, seed=seed * 10 + i)
              for i, r in enumerate(rates)]
    ref_traces = [RS.ArrivalTrace.poisson(float(r), 4.0, seed=seed * 10 + i)
                  for i, r in enumerate(rates)]
    clocks = rng.uniform(0.0, 1.0, n)
    carries = [None if i % 3 == 0 else S.QueueState(
        np.sort(rng.uniform(0.0, clocks[i], i)), float(clocks[i]))
        for i in range(n)]
    ref_carries = [None if c is None else RS.QueueState(c.pending, c.clock)
                   for c in carries]
    w_tr = TRAIN_WORKLOADS["mobilenet"] if seed % 2 else None
    rw_tr = REF_TRAIN["mobilenet"] if seed % 2 else None
    caps = [None if i % 2 else 2 for i in range(n)]
    got = S.simulate_batch(DEV, w_tr, W_IN, [MODES[i] for i in idx], bss,
                           traces, tau_caps=caps, backend="cpu",
                           carry_ins=carries, devices=devs)
    ref = RS.simulate_batch(REF_DEV, rw_tr, REF_W_IN,
                            [REF_MODES[i] for i in idx], bss, ref_traces,
                            tau_caps=caps, backend="numpy",
                            carry_ins=ref_carries, devices=ref_devs)
    for a, b, dv in zip(ref, got, devs):
        np.testing.assert_allclose(b.latencies, a.latencies, **ENG_TOL)
        assert abs(b.train_minibatches - a.train_minibatches) <= 2
        assert b.power == a.power
        assert b.queue_state.pending.tolist() == a.queue_state.pending.tolist()
    # each lane is its own device: the same lanes on the base device differ
    base = S.simulate_batch(DEV, w_tr, W_IN, [MODES[i] for i in idx], bss,
                            traces, tau_caps=caps, backend="cpu",
                            carry_ins=carries)
    assert any(not np.array_equal(a.latencies, b.latencies)
               for a, b in zip(base, got) if len(a.latencies))
    with pytest.raises(ValueError, match="devices"):
        S.simulate_batch(DEV, None, W_IN, [MODES[0]], [4], traces[:1],
                         backend="cpu", devices=devs[:2])


# ---------------------------------------------------------------------------
# serve_fleet: the reference's decisions, window by window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_serve_fleet_matches_the_reference_and_the_sequential_loops(seed):
    rng = np.random.default_rng(seed)
    K = int(rng.integers(2, 9))
    spec_kw = dict(seed=seed, dispatch=("capacity", "least-backlog")[seed % 2])
    cfg = dict(rate_estimator="ewma", feedback=bool(seed % 2),
               carry_backlog=True, mode_switch_s=0.25 * (seed % 2),
               burst_quantile=0.9 if seed == 1 else 0.0)
    rates = [float(r) for r in rng.uniform(20.0, 500.0, 4)]
    kw = dict(seed=seed + 100)
    ref, got = serve_both(K, cfg, rates, spec_kw, **kw)
    assert_fleets_match(ref, got)
    seq = F.serve_fleet_sequential(W_IN, 30.0, 0.2, rates,
                                   F.FleetSpec(K, **spec_kw), backend="cpu",
                                   controller=ControllerConfig(**cfg),
                                   window_duration=3.0, arrivals="poisson",
                                   **kw)
    assert_fleets_match(got, seq, exact=True)


def test_serve_fleet_with_idle_devices_matches_the_reference():
    cfg = dict(rate_estimator="ewma", carry_backlog=True)
    ref, got = serve_both(8, cfg, [2.0, 1.0], dict(seed=1),
                          window_duration=2.0, seed=5)
    assert_fleets_match(ref, got)
    idle = [d for d, c in enumerate(got[0].dispatch_counts) if c == 0]
    assert idle
    for d in idle:
        assert got[0].devices[d].goodput == 1.0
        assert got[0].devices[d].offered_requests == 0


@pytest.mark.parametrize("case", ["readme", "overload"])
def test_readme_fleets_match_the_reference(case):
    """The README's two fleet examples, on 3 s windows."""
    cfg = dict(rate_estimator="ewma", rate_margin=1.5, feedback=True,
               carry_backlog=True)
    spec_kw = dict(seed=3, dispatch="least-backlog")
    rates = [220.0, 360.0, 280.0]
    if case == "overload":
        cfg.update(burst_quantile=0.95, admission="shed")
        spec_kw.update(migrate_backlog=True, fleet_power_budget=216.0)
        rates = [720.0, 1080.0, 240.0]
    ref, got = serve_both(8, cfg, rates, spec_kw, latency=0.1)
    assert_fleets_match(ref, got)
    assert all(w.attributed_power > 0.0 for w in got)
    if case == "overload":
        assert sum(w.shed_requests for w in got) > 0
        assert sum(w.migrated_requests for w in got) > 0


def test_scenario_fleet_and_the_scheduler_facade():
    assert Scenario.FLEET.canonical is Scenario.INFER
    out = Fulcrum(DEV).serve_fleet(W_IN, 30.0, 0.2, [100.0, 150.0], 4,
                                   window_duration=2.0, backend="cpu")
    assert len(out) == 2 and len(out[0].devices) == 4
    direct = F.serve_fleet(W_IN, 30.0, 0.2, [100.0, 150.0], F.FleetSpec(4),
                           window_duration=2.0, backend="cpu")
    assert_fleets_match(direct, out, exact=True)
    ref = RF.serve_fleet(REF_W_IN, 30.0, 0.2, [100.0, 150.0],
                         RF.FleetSpec(4), window_duration=2.0,
                         backend="numpy")
    assert_fleets_match(ref, out)


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------

def test_fused_window_and_backlog_splits_are_refused():
    # the fused window re-plans nothing on the host: degrade-bs is refused
    with pytest.raises(ValueError, match="degrade-bs"):
        F.serve_fleet(W_IN, 30.0, 0.2, [50.0], F.FleetSpec(2), fused=True,
                      backend="cpu",
                      controller=ControllerConfig(admission="degrade-bs"))
    for fn in (F.serve_fleet, F.serve_fleet_sequential):
        with pytest.raises(ValueError, match="split_backlog"):
            fn(W_IN, 30.0, 0.2, [50.0], F.FleetSpec(2), backend="cpu",
               controller=ControllerConfig(split_backlog=1))
        with pytest.raises(ValueError, match="carry_backlog"):
            fn(W_IN, 30.0, 0.2, [50.0], F.FleetSpec(2, migrate_backlog=True),
               backend="cpu", controller=ControllerConfig())


def test_the_default_backend_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    for fn in (F.serve_fleet, F.serve_fleet_sequential):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(W_IN, 30.0, 0.2, [50.0], F.FleetSpec(2))
