"""The port's multi-tenant engine and serving loops against the reference's,
mirroring ``tests/test_multi_tenant.py``.

Tolerances. With one tenant, ``simulate_multi_tenant`` hands the
``maxplus_scan`` kernel exactly the pair engine's inputs, so on the port's
``"cpu"`` backend its result is *bitwise* the one of ``simulate`` (the card
test of ``tests/test_torch_cuda.py`` checks the same on ``"cuda"``). With
more tenants the port is in the engine tolerance tier against the
reference's NumPy engine (``docs/exactness.md``): latencies within
``atol=1e-8, rtol=1e-9``, training minibatches within +-2 per lane, powers
and queue-state pending times equal. Plans are host float64 code and equal
the reference's; the serving loops compare per window as in
``tests/test_torch_controller.py``.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import problem as RP
from repro.core import simulate as RS
from repro.core.controller import ControllerConfig as RefConfig
from repro.core.device_model import DeviceModel as RefDevice
from repro.core.device_model import INFER_WORKLOADS as REF_INFER
from repro.core.device_model import TRAIN_WORKLOADS as REF_TRAIN
from repro.core.powermode import PowerModeSpace as RefSpace
from repro.core.scheduler import Fulcrum as RefFulcrum
from repro.core.scheduler import Scenario as RefScenario
from repro.core.scheduler import register_strategy as ref_register
from repro_torch.core import problem as P
from repro_torch.core import simulate as S
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.device_model import (DeviceModel, INFER_WORKLOADS,
                                           TRAIN_WORKLOADS)
from repro_torch.core.powermode import PowerModeSpace
from repro_torch.core.scheduler import Fulcrum, Scenario, register_strategy
from test_torch_controller import _PointStrategy, assert_windows_match

ENG_TOL = dict(rtol=1e-9, atol=1e-8)
DEV, REF_DEV = DeviceModel(), RefDevice()
MODES, REF_MODES = PowerModeSpace().all_modes(), RefSpace().all_modes()
TRAIN_NAMES, INFER_NAMES = list(REF_TRAIN), list(REF_INFER)


def _lats(rep):
    return np.asarray(rep.latencies, np.float64)


def _lane(rng, n, seed):
    """One multi-tenant lane as names and numbers both packages build from:
    training workload, stream workloads, power mode index, minibatch sizes,
    per-stream (rate, duration, Poisson seed or None) and a tau cap."""
    w_tr = TRAIN_NAMES[rng.integers(5)] if rng.random() < 0.8 else None
    ws = [INFER_NAMES[rng.integers(5)] for _ in range(n)]
    m = int(rng.integers(len(MODES)))
    bss = [int([1, 4, 16, 32][rng.integers(4)]) for _ in range(n)]
    trs = [(float(rng.uniform(1, 60)), float(rng.uniform(5, 25)),
            None if rng.random() < 0.5 else seed * 31 + j)
           for j in range(n)]
    cap = None if rng.random() < 0.7 else int(rng.integers(0, 4))
    return w_tr, ws, m, bss, trs, cap


def _traces(mod, trs, t0=0.0):
    return [(mod.ArrivalTrace.uniform(r, d) if s is None
             else mod.ArrivalTrace.poisson(r, d, seed=s)).shifted(t0)
            for r, d, s in trs]


def _assert_multi_close(ref, got):
    assert len(got.streams) == len(ref.streams)
    for a, b in zip(ref.streams, got.streams):
        np.testing.assert_allclose(_lats(b), _lats(a), **ENG_TOL)
        assert b.attributed_power == pytest.approx(a.attributed_power,
                                                   rel=1e-6, abs=1e-9)
        assert b.trace.times.tolist() == a.trace.times.tolist()
    assert abs(got.train_minibatches - ref.train_minibatches) <= 2
    assert (got.power, got.duration) == (ref.power, ref.duration)
    assert got.queue_state.pending.tolist() == \
        ref.queue_state.pending.tolist()
    assert got.queue_state.stream_ids.tolist() == \
        ref.queue_state.stream_ids.tolist()
    assert got.trace.stream_ids.tolist() == ref.trace.stream_ids.tolist()


# ---------------------------------------------------------------------------
# one tenant == the pair path, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_single_tenant_run_is_bitwise_the_pair_path(seed):
    rng = np.random.default_rng(seed)
    for _ in range(6):
        w_tr, ws, m, bss, trs, cap = _lane(rng, 1, seed)
        wt = TRAIN_WORKLOADS[w_tr] if w_tr else None
        # a carried backlog arrived before the window, which starts at 1 s
        trace = _traces(S, trs, 1.0)[0]
        carry = None if rng.random() < 0.5 else S.QueueState(
            np.sort(rng.uniform(0.0, 0.5, int(rng.integers(0, 4)))),
            float(rng.uniform(0.0, 1.5)))
        pair = S.simulate(DEV, wt, INFER_WORKLOADS[ws[0]], MODES[m], bss[0],
                          trace, tau_cap=cap, carry_in=carry, backend="cpu")
        multi = S.simulate_multi_tenant(
            DEV, wt, [INFER_WORKLOADS[ws[0]]], MODES[m], bss, [trace],
            tau_cap=cap, carry_in=carry, backend="cpu")
        rep = multi.streams[0]
        assert _lats(rep).tobytes() == _lats(pair).tobytes()
        assert rep.sorted_latencies.tobytes() == \
            pair.sorted_latencies.tobytes()
        assert multi.train_minibatches == pair.train_minibatches
        assert multi.power == pair.power
        assert rep.attributed_power == pair.attributed_power
        assert multi.queue_state.pending.tobytes() == \
            pair.queue_state.pending.tobytes()
        assert multi.queue_state.clock == pair.queue_state.clock


# ---------------------------------------------------------------------------
# N > 1 against the reference, ragged tenant counts in one batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_multi_tenant_run_matches_the_reference(seed):
    rng = np.random.default_rng(seed + 50)
    for _ in range(4):
        w_tr, ws, m, bss, trs, cap = _lane(rng, int(rng.integers(2, 5)),
                                           seed)
        ref = RS.simulate_multi_tenant(
            REF_DEV, REF_TRAIN[w_tr] if w_tr else None,
            [REF_INFER[w] for w in ws], REF_MODES[m], bss,
            _traces(RS, trs), tau_cap=cap, backend="numpy")
        got = S.simulate_multi_tenant(
            DEV, TRAIN_WORKLOADS[w_tr] if w_tr else None,
            [INFER_WORKLOADS[w] for w in ws], MODES[m], bss,
            _traces(S, trs), tau_cap=cap, backend="cpu")
        _assert_multi_close(ref, got)


@pytest.mark.parametrize("counts", [(1, 2, 4), (4, 1, 3, 2, 1), (2,) * 9])
def test_ragged_batch_matches_the_reference(counts):
    """Lanes of different tenant counts in one batch, each with a carried
    per-stream queue state (arrived before the window, which starts at
    1 s), share the engine's launches."""
    rng = np.random.default_rng(sum(counts))
    lanes = [_lane(rng, n, i) for i, n in enumerate(counts)]
    w_tr = "mobilenet"
    carries = []
    for _, ws, _, _, _, _ in lanes:
        k = int(rng.integers(0, 6))
        carries.append((np.sort(rng.uniform(0.0, 0.5, k)),
                        rng.integers(0, len(ws), k),
                        float(rng.uniform(0.0, 1.5))))
    args = [([ws for _, ws, _, _, _, _ in lanes]),
            [m for _, _, m, _, _, _ in lanes],
            [bss for _, _, _, bss, _, _ in lanes],
            [trs for _, _, _, _, trs, _ in lanes],
            [cap for *_, cap in lanes]]
    ref = RS.simulate_multi_tenant_batch(
        REF_DEV, REF_TRAIN[w_tr], [[REF_INFER[w] for w in ws]
                                   for ws in args[0]],
        [REF_MODES[m] for m in args[1]], args[2],
        [_traces(RS, trs, 1.0) for trs in args[3]], tau_caps=args[4],
        carry_ins=[RS.QueueState(p, c, s) for p, s, c in carries],
        backend="numpy")
    got = S.simulate_multi_tenant_batch(
        DEV, TRAIN_WORKLOADS[w_tr], [[INFER_WORKLOADS[w] for w in ws]
                                     for ws in args[0]],
        [MODES[m] for m in args[1]], args[2],
        [_traces(S, trs, 1.0) for trs in args[3]], tau_caps=args[4],
        carry_ins=[S.QueueState(p, c, s) for p, s, c in carries],
        backend="cpu")
    assert len(got) == len(ref) == len(counts)
    for a, b in zip(ref, got):
        _assert_multi_close(a, b)
        for r in b.streams:
            assert np.array_equal(r._sorted, np.sort(_lats(r)))


def test_batch_input_checks():
    w = INFER_WORKLOADS["lstm"]
    tr = S.ArrivalTrace.uniform(10.0, 1.0)
    assert S.simulate_multi_tenant_batch(DEV, None, [], [], [], [],
                                         backend="cpu") == []
    with pytest.raises(ValueError, match="align"):
        S.simulate_multi_tenant(DEV, None, [w, w], MODES[0], [4], [tr, tr],
                                backend="cpu")
    with pytest.raises(ValueError, match="align"):
        S.simulate_multi_tenant_batch(DEV, None, [[w]], [MODES[0]], [[4]],
                                      [[tr]], tau_caps=[None, None],
                                      backend="cpu")


# ---------------------------------------------------------------------------
# merged traces round-trip provenance as the reference's do
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_merge_and_split_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    streams = [np.sort(np.round(rng.uniform(0, 20, int(rng.integers(0, 50))),
                                2)) for _ in range(int(rng.integers(1, 6)))]
    got = S.ArrivalTrace.merge([S.ArrivalTrace(t, 10.0 + j)
                                for j, t in enumerate(streams)])
    ref = RS.ArrivalTrace.merge([RS.ArrivalTrace(t, 10.0 + j)
                                 for j, t in enumerate(streams)])
    assert got.times.tolist() == ref.times.tolist()
    assert got.stream_ids.tolist() == ref.stream_ids.tolist()
    assert (got.duration, got.n_streams, got.kind) == \
        (ref.duration, ref.n_streams, ref.kind)
    for a, t in zip(got.split(), streams):
        assert a.times.tolist() == t.tolist()
    with pytest.raises(ValueError, match="provenance"):
        S.ArrivalTrace.uniform(10.0, 1.0).split()


# ---------------------------------------------------------------------------
# the scheduler's multi-tenant entry points
# ---------------------------------------------------------------------------

def _readme_specs(mod, infer):
    return (mod.StreamSpec(40.0, 0.8, infer["mobilenet"]),
            mod.StreamSpec(60.0, 0.5, infer["lstm"]),
            mod.StreamSpec(20.0, 1.5, infer["resnet50"]))


def test_execute_multi_tenant_readme_case_matches_the_reference():
    """The README's 3 tenants + resnet18 training, 60 s of Poisson."""
    rprob = RP.MultiTenantProblem(45.0, _readme_specs(RP, REF_INFER))
    prob = P.MultiTenantProblem(45.0, _readme_specs(P, INFER_WORKLOADS))
    rf, f = RefFulcrum(REF_DEV), Fulcrum(DEV)
    rplan = rf.solve_multi_tenant(REF_TRAIN["resnet18"], rprob, "gmd")
    plan = f.solve_multi_tenant(TRAIN_WORKLOADS["resnet18"], prob, "gmd")
    assert dataclasses.asdict(plan.solution) == \
        dataclasses.asdict(rplan.solution)
    ref = rf.execute_multi_tenant(rplan, rprob, REF_TRAIN["resnet18"],
                                  duration=60.0, arrivals="poisson")
    got = f.execute_multi_tenant(plan, prob, TRAIN_WORKLOADS["resnet18"],
                                 duration=60.0, arrivals="poisson",
                                 backend="cpu")
    _assert_multi_close(ref, got)
    budgets = [s.latency_budget for s in prob.streams]
    assert got.violation_rates(budgets) == ref.violation_rates(budgets)
    assert got.worst_latency_quantile(0.95) == pytest.approx(
        ref.worst_latency_quantile(0.95), rel=1e-9, abs=1e-8)
    with pytest.raises(ValueError, match="not multi-tenant"):
        f.execute_multi_tenant(f.solve_infer(INFER_WORKLOADS["lstm"],
                                             P.InferProblem(30, 0.5, 30)),
                               prob, backend="cpu")
    with pytest.raises(ValueError, match="train workload"):
        f.execute_multi_tenant(plan, prob, None, backend="cpu")


RATE_WINDOWS = [[40.0, 60.0, 20.0], [60.0, 90.0, 30.0], [40.0, 60.0, 20.0]]


def test_solve_dynamic_multi_tenant_equals_the_reference():
    ref = RefFulcrum(REF_DEV).solve_dynamic_multi_tenant(
        _readme_specs(RP, REF_INFER), 45.0, RATE_WINDOWS,
        w_tr=REF_TRAIN["resnet18"])
    got = Fulcrum(DEV).solve_dynamic_multi_tenant(
        _readme_specs(P, INFER_WORKLOADS), 45.0, RATE_WINDOWS,
        w_tr=TRAIN_WORKLOADS["resnet18"])
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in ref]
    with pytest.raises(ValueError, match="one rate per stream"):
        Fulcrum(DEV).solve_dynamic_multi_tenant(
            _readme_specs(P, INFER_WORKLOADS), 45.0, [[40.0, 60.0]])


# the README's 3 tenants over three 30 s windows: open loop, then closed
# with shedding (ewma, margin 1.5, feedback, carryover, burst quantile)
_SHED = dict(rate_estimator="ewma", rate_margin=1.5, feedback=True,
             carry_backlog=True, burst_quantile=0.95, mode_switch_s=0.5,
             admission="shed")


@pytest.mark.parametrize("loop", ["open", "shed", "defer"])
@pytest.mark.parametrize("arrivals", ["uniform", "poisson"])
def test_multi_tenant_serve_dynamic_matches_the_reference(loop, arrivals):
    cfg = {"open": None, "shed": _SHED,
           "defer": dict(_SHED, admission="defer", defer_cap=300)}[loop]
    ref = RefFulcrum(REF_DEV).serve_dynamic(
        _readme_specs(RP, REF_INFER), 45.0, None, RATE_WINDOWS, "gmd",
        window_duration=30.0, arrivals=arrivals, seed=0,
        w_tr=REF_TRAIN["resnet18"],
        controller=None if cfg is None else RefConfig(**cfg),
        backend="numpy")
    got = Fulcrum(DEV).serve_dynamic(
        _readme_specs(P, INFER_WORKLOADS), 45.0, None, RATE_WINDOWS, "gmd",
        window_duration=30.0, arrivals=arrivals, seed=0,
        w_tr=TRAIN_WORKLOADS["resnet18"],
        controller=None if cfg is None else ControllerConfig(**cfg),
        backend="cpu")
    assert_windows_match(ref, got)
    if (loop, arrivals) == ("shed", "poisson"):
        assert [w.shed_requests for w in got] == [1355, 77, 1260]


# ---------------------------------------------------------------------------
# the fitted-strategy branches, through a registered stub strategy
# ---------------------------------------------------------------------------

def _multi_stub(mod, dev, modes):
    def factory(f, w_tr, *ws):
        sub = modes[::9]
        tobs = {pm: dev.time_power(w_tr, pm) for pm in sub} if w_tr else None
        iobs = [{(pm, bs): dev.time_power(w, pm, bs) for pm in sub
                 for bs in mod.INFER_BATCH_SIZES} for w in ws]
        return _PointStrategy(
            lambda prob, obs: mod.solve_multi_tenant(prob, *obs),
            (tobs, iobs))
    return factory


ref_register(RefScenario.MULTI_TENANT, "multi-stub",
             _multi_stub(RP, REF_DEV, REF_MODES))
register_strategy(Scenario.MULTI_TENANT, "multi-stub",
                  _multi_stub(P, DEV, MODES))


@pytest.mark.parametrize("cfg", [None, dict(rate_estimator="ewma",
                                            rate_margin=1.5,
                                            carry_backlog=True,
                                            admission="shed")])
def test_fitted_strategy_multi_tenant_branches_match_the_reference(cfg):
    """Open loop: the strategy's ``solve_batch``; closed with a margin: the
    point solve and the per-stream down-move guard."""
    ref = RefFulcrum(REF_DEV).serve_dynamic(
        _readme_specs(RP, REF_INFER), 45.0, None, RATE_WINDOWS, "multi-stub",
        window_duration=30.0, arrivals="poisson", seed=1,
        w_tr=REF_TRAIN["resnet18"],
        controller=None if cfg is None else RefConfig(**cfg),
        backend="numpy")
    got = Fulcrum(DEV).serve_dynamic(
        _readme_specs(P, INFER_WORKLOADS), 45.0, None, RATE_WINDOWS,
        "multi-stub", window_duration=30.0, arrivals="poisson", seed=1,
        w_tr=TRAIN_WORKLOADS["resnet18"],
        controller=None if cfg is None else ControllerConfig(**cfg),
        backend="cpu")
    assert_windows_match(ref, got)
    assert any(w.solution is not None for w in got)
