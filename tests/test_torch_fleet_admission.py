"""Fleet-wide resource control on the port (global admission, backlog
migration, shared power budget) against the reference's, mirroring
``tests/test_fleet_admission.py``.

Tolerances as in ``tests/test_torch_fleet.py`` (whose window comparison
this file uses): per window the reference's decisions — dispatch, each
device's plan and power, shed / deferred / migrated counts, the
water-filled budgets — with latencies within ``atol=1e-8, rtol=1e-9`` of
the reference's NumPy engine; the port's batched fleet against its own
sequential loops bitwise on ``"cpu"``. The admission mask runs on engine
values in that tolerance tier, so an admitted request meets its budget to
within it (ROADMAP.md, deviations).
"""
import numpy as np
import pytest

from repro.core import fleet as RF
from repro.core import problem as RP
from repro.core.controller import ControllerConfig as RefConfig
from repro.core.controller import ControllerState as RefState
from repro.core.simulate import QueueState as RefQueueState
from repro_torch.core import fleet as F
from repro_torch.core import problem as P
from repro_torch.core import simulate as S
from repro_torch.core.controller import ControllerConfig, ControllerState
from repro_torch.core.device_model import INFER_WORKLOADS
from test_torch_fleet import ENG_TOL, assert_fleets_match, serve_both

W_IN = INFER_WORKLOADS["mobilenet"]

# the closed-loop config the admission benches use, fleet-sized windows
_CL = dict(rate_estimator="ewma", rate_margin=1.5, feedback=True,
           carry_backlog=True, mode_switch_s=0.25, burst_quantile=0.95)


def _cfg(mode, **over):
    kw = dict(_CL, admission=mode)
    if mode == "defer":
        kw["defer_cap"] = 500
    kw.update(over)
    return kw


def _within_budget(rep, budget):
    """Every latency within ``budget`` to the engine tolerance."""
    lats = np.asarray(rep.latencies, np.float64)
    return bool(np.all(lats <= budget + ENG_TOL["atol"]
                       + ENG_TOL["rtol"] * budget))


# ---------------------------------------------------------------------------
# every admission mode x migration x shared budget, against the reference
# and against the port's sequential loops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("mode", ["shed", "defer", "degrade-bs"])
@pytest.mark.parametrize("mig,fleet_budget", [(False, None), (True, None),
                                              (False, 130.0), (True, 130.0)])
def test_admission_fleet_matches_the_reference_and_the_sequential_loops(
        K, mode, mig, fleet_budget):
    spec_kw = dict(seed=3, time_spread=0.3, dispatch="least-backlog",
                   migrate_backlog=mig, fleet_power_budget=fleet_budget)
    rates = [400.0, 800.0, 120.0, 600.0]     # overload: the gates must act
    kw = dict(latency=0.05, window_duration=2.0, seed=11)
    ref, got = serve_both(K, _cfg(mode), rates, spec_kw, **kw)
    assert_fleets_match(ref, got)
    _, seq = serve_both(K, _cfg(mode), rates, spec_kw,
                        fn="serve_fleet_sequential", **kw)
    assert_fleets_match(got, seq, exact=True)
    if mode in ("shed", "defer") and fleet_budget is None:
        assert sum(w.shed_requests + w.deferred_requests for w in got) > 0
    if mig and fleet_budget is None and K > 1:
        assert sum(w.migrated_requests for w in got) > 0


@pytest.mark.parametrize("seed", range(4))
def test_admission_fleet_random_scenarios_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    mode = ("shed", "defer", "degrade-bs")[seed % 3]
    spec_kw = dict(seed=seed, time_spread=float(rng.uniform(0.0, 0.4)),
                   dispatch=("capacity", "least-backlog")[seed % 2],
                   migrate_backlog=bool(seed % 2),
                   fleet_power_budget=(None, 80.0)[(seed // 2) % 2])
    K = int(rng.integers(1, 7))
    rates = [float(r) for r in rng.uniform(20.0, 900.0, 4)]
    ref, got = serve_both(K, _cfg(mode), rates, spec_kw, latency=0.05,
                          window_duration=2.0, seed=seed + 50)
    assert_fleets_match(ref, got)


# ---------------------------------------------------------------------------
# flood admission: admitted requests meet the budget, deferrals re-enter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["shed", "defer"])
def test_fleet_flood_admitted_requests_meet_the_budget(mode):
    spec = F.FleetSpec(4, seed=3, time_spread=0.3)
    rates = [1200.0, 1200.0, 1200.0]            # ~3x sustainable per device
    kw = dict(window_duration=2.0, arrivals="poisson", seed=7, backend="cpu")
    wins = F.serve_fleet(W_IN, 40.0, 0.1, rates, spec,
                         controller=ControllerConfig(
                             **_cfg(mode, defer_cap=200)), **kw)
    trimmed = set()
    for fw in wins:
        assert fw.shed_requests + fw.deferred_requests > 0
        for d, wr in enumerate(fw.devices):
            if wr.report is not None:
                assert _within_budget(wr.report, 0.1)
            if wr.shed_requests + wr.deferred_requests > 0:
                trimmed.add(d)
    assert len(trimmed) > 1                     # fleet-wide, not one lane
    raw = F.serve_fleet(W_IN, 40.0, 0.1, rates, spec,
                        controller=ControllerConfig(**_CL), **kw)
    assert any(wr.report is not None and wr.report.violation_rate(0.1) > 0.0
               for fw in raw for wr in fw.devices)


def test_fleet_deferred_requests_reenter_the_dispatcher():
    wins = F.serve_fleet(W_IN, 40.0, 0.1, [900.0, 300.0, 100.0],
                         F.FleetSpec(3, seed=3, time_spread=0.3),
                         window_duration=2.0, arrivals="poisson", seed=7,
                         backend="cpu",
                         controller=ControllerConfig(**_cfg("defer")))
    assert wins[0].deferred_requests > 0
    for i, (prev, cur) in enumerate(zip(wins, wins[1:]), start=1):
        extra = len(cur.trace) - cur.offered_requests
        assert extra == prev.deferred_requests
        assert np.all(cur.trace.times[:extra] == i * 2.0)
        assert int(cur.dispatch_counts.sum()) == len(cur.trace)


# ---------------------------------------------------------------------------
# migration and water-filling: the reference's host code
# ---------------------------------------------------------------------------

def _states(mod_state, mod_queue, cfg, pendings, clocks):
    states = []
    for pend, clock in zip(pendings, clocks):
        st = mod_state(cfg, 1)
        if pend is not None:
            st.carry = mod_queue(np.asarray(pend, np.float64), float(clock))
        states.append(st)
    return states


def test_migrate_backlog_is_the_references_and_conserves():
    pendings = [np.linspace(0.0, 1.8, 40), np.empty(0), [1.0, 1.5], None]
    clocks = [2.4, 2.0, 2.1, 0.0]
    got = _states(ControllerState, S.QueueState,
                  ControllerConfig(carry_backlog=True), pendings, clocks)
    ref = _states(RefState, RefQueueState, RefConfig(carry_backlog=True),
                  pendings, clocks)
    moved = F._migrate_backlog(got, np.ones(4), t0=2.0)
    assert moved == RF._migrate_backlog(ref, np.ones(4), t0=2.0) > 0
    for a, b in zip(ref, got):
        assert b.carry.pending.tolist() == a.carry.pending.tolist()
        assert b.carry.clock == a.carry.clock
    assert sum(len(s.carry) for s in got) == 42
    sizes = [len(s.carry) for s in got]
    assert max(sizes) - min(sizes) <= 1
    still = _states(ControllerState, S.QueueState,
                    ControllerConfig(carry_backlog=True), [[0.5], [0.6]],
                    [1.0, 1.0])
    carries = [s.carry for s in still]
    assert F._migrate_backlog(still, np.ones(2), t0=1.0) == 0
    assert all(s.carry is c for s, c in zip(still, carries))


@pytest.mark.parametrize("demands,total", [([1.0, 2.0, 3.0], 9.0),
                                           ([1.0, 5.0, 10.0], 8.0),
                                           ([4.0], 2.0)])
def test_water_fill_is_the_references(demands, total):
    got = P.water_fill(np.array(demands), total)
    assert got.tolist() == RP.water_fill(np.array(demands), total).tolist()


def test_fleet_power_budget_bounds_grants_and_plans():
    fb = 120.0
    wins = F.serve_fleet(W_IN, 30.0, 0.05, [400.0, 800.0, 300.0],
                         F.FleetSpec(5, seed=3, time_spread=0.3,
                                     fleet_power_budget=fb),
                         window_duration=2.0, arrivals="poisson", seed=11,
                         backend="cpu",
                         controller=ControllerConfig(**_cfg("shed")))
    served = 0
    for fw in wins:
        assert float(fw.power_budgets.sum()) <= fb + 1e-9
        assert np.all(fw.power_budgets >= fb / 20.0 - 1e-12)   # the floor
        assert np.all(fw.power_budgets <= 30.0 + 1e-12)
        assert fw.attributed_power <= fb + 1e-9
        for d, wr in enumerate(fw.devices):
            if wr.report is not None:
                served += 1
                assert wr.solution.power <= fw.power_budgets[d] + 1e-12
    assert served > 0


def test_fleet_defaults_keep_every_new_account_inert():
    """The default spec is K isolated closed loops: no shed, deferral,
    migration or grants, and the reference's decisions."""
    cfg = dict(rate_estimator="ewma", rate_margin=1.5, feedback=True,
               carry_backlog=True, mode_switch_s=0.25)
    ref, got = serve_both(3, cfg, [60.0, 90.0, 45.0],
                          dict(seed=2, dispatch="least-backlog"),
                          latency=0.1, window_duration=5.0, seed=9)
    assert_fleets_match(ref, got)
    for fw in got:
        assert (fw.shed_requests, fw.deferred_requests,
                fw.migrated_requests, fw.power_budgets) == (0, 0, 0, None)
