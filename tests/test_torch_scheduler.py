"""The port's scheduler against the reference's: GMD plans equal exactly
(power mode, minibatch size, tau_tr, achieved metrics, profiling runs and
cost) across workloads and budgets, infeasible problems return ``None`` in
both, and executing a plan on the port's engine (``backend="cpu"``) meets
the reference's NumPy engine within the engine tolerance — for
``execute`` on a Poisson trace and for the README's open-loop
``serve_dynamic`` case. The strategy registry is the reference's (names
per scenario, the ``KeyError``, fitted strategies cached per workload
tuple, GMD never); RND's plans equal the reference's in every scenario, and
the closed loop answered by ALS (shared predictions, as in
``test_torch_strategies.py``) makes the reference's decisions per window."""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from repro.core import als as ref_als
from repro.core import problem as RP
from repro.core import simulate as RS
from repro.core.controller import ControllerConfig as RefConfig
from repro.core.device_model import DeviceModel as RefDevice
from repro.core.device_model import INFER_WORKLOADS as REF_INFER
from repro.core.device_model import TRAIN_WORKLOADS as REF_TRAIN
from repro.core.scheduler import Fulcrum as RefFulcrum
from repro.core.scheduler import Scenario as RefScenario
from repro.core.scheduler import available_strategies as ref_available
from repro_torch.core import als
from repro_torch.core import problem as P
from repro_torch.core import simulate as S
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.device_model import (DeviceModel, INFER_WORKLOADS,
                                           TRAIN_WORKLOADS)
from repro_torch.core.scheduler import Fulcrum, Scenario, available_strategies

from test_torch_controller import assert_windows_match
from test_torch_strategies import SharedNN

ENG_TOL = dict(rtol=1e-9, atol=1e-8)


def _sol_key(sol):
    """Every field of a solution, the power mode as a plain tuple."""
    if sol is None:
        return None
    d = dataclasses.asdict(sol)
    d["pm"] = dataclasses.astuple(sol.pm)
    return d


def _assert_plans_equal(ref, got):
    if ref is None:
        assert got is None
        return
    assert got is not None
    assert _sol_key(got.solution) == _sol_key(ref.solution)
    assert got.strategy == ref.strategy
    assert got.profiling_runs == ref.profiling_runs
    assert got.profiling_cost_s == ref.profiling_cost_s
    assert got.scenario.value == ref.scenario.value


def _pair(backend=None):
    return RefFulcrum(RefDevice()), Fulcrum(DeviceModel(), backend=backend)


@pytest.mark.parametrize("name", ["resnet18", "mobilenet", "yolov8n",
                                  "bert", "lstm"])
@pytest.mark.parametrize("budget", [12.0, 20.0, 35.0, 60.0])
def test_solve_train_plans_equal(name, budget):
    rf, f = _pair()
    _assert_plans_equal(
        rf.solve_train(REF_TRAIN[name], RP.TrainProblem(budget)),
        f.solve_train(TRAIN_WORKLOADS[name], P.TrainProblem(budget)))


@pytest.mark.parametrize("name", ["mobilenet", "resnet50", "bert", "lstm"])
@pytest.mark.parametrize("budget,lat,rate", [(30.0, 0.5, 30.0),
                                             (40.0, 0.1, 60.0),
                                             (25.0, 2.0, 100.0),
                                             (15.0, 0.05, 200.0)])
def test_solve_infer_plans_equal(name, budget, lat, rate):
    rf, f = _pair()
    _assert_plans_equal(
        rf.solve_infer(REF_INFER[name], RP.InferProblem(budget, lat, rate)),
        f.solve_infer(INFER_WORKLOADS[name], P.InferProblem(budget, lat,
                                                            rate)))


@pytest.mark.parametrize("tr,inf", [("mobilenet", "mobilenet"),
                                    ("resnet18", "resnet50"),
                                    ("bert", "lstm"), ("yolov8n", "bert")])
@pytest.mark.parametrize("budget,lat,rate", [(35.0, 1.0, 60.0),
                                             (50.0, 0.5, 30.0),
                                             (20.0, 0.2, 90.0)])
def test_solve_concurrent_plans_equal(tr, inf, budget, lat, rate):
    rf, f = _pair()
    _assert_plans_equal(
        rf.solve_concurrent(REF_TRAIN[tr], REF_INFER[inf],
                            RP.ConcurrentProblem(budget, lat, rate)),
        f.solve_concurrent(TRAIN_WORKLOADS[tr], INFER_WORKLOADS[inf],
                           P.ConcurrentProblem(budget, lat, rate)))


@pytest.mark.parametrize("nonurgent,urgent", [("resnet50", "mobilenet"),
                                              ("bert", "lstm")])
def test_solve_concurrent_inference_plans_equal(nonurgent, urgent):
    rf, f = _pair()
    _assert_plans_equal(
        rf.solve_concurrent_inference(REF_INFER[nonurgent], REF_INFER[urgent],
                                      RP.ConcurrentProblem(40.0, 0.5, 40.0)),
        f.solve_concurrent_inference(INFER_WORKLOADS[nonurgent],
                                     INFER_WORKLOADS[urgent],
                                     P.ConcurrentProblem(40.0, 0.5, 40.0)))


def test_infeasible_problem_returns_none_in_both():
    rf, f = _pair()
    ref = rf.solve_infer(REF_INFER["bert"], RP.InferProblem(5.0, 0.01, 500.0))
    got = f.solve_infer(INFER_WORKLOADS["bert"],
                        P.InferProblem(5.0, 0.01, 500.0))
    assert ref is None and got is None
    assert f.solve_train(TRAIN_WORKLOADS["bert"], P.TrainProblem(1.0)) is None


def test_solve_multi_tenant_plans_equal():
    rf, f = _pair()
    ref_prob = RP.MultiTenantProblem(45.0, (
        RP.StreamSpec(40.0, 0.8, REF_INFER["mobilenet"]),
        RP.StreamSpec(60.0, 0.5, REF_INFER["lstm"])))
    prob = P.MultiTenantProblem(45.0, (
        P.StreamSpec(40.0, 0.8, INFER_WORKLOADS["mobilenet"]),
        P.StreamSpec(60.0, 0.5, INFER_WORKLOADS["lstm"])))
    ref = rf.solve_multi_tenant(REF_TRAIN["resnet18"], ref_prob, "gmd")
    got = f.solve_multi_tenant(TRAIN_WORKLOADS["resnet18"], prob, "gmd")
    assert got.solution.bss == ref.solution.bss
    assert dataclasses.astuple(got.solution.pm) == \
        dataclasses.astuple(ref.solution.pm)
    assert (got.solution.tau_tr, got.solution.times, got.solution.power,
            got.solution.throughput) == \
        (ref.solution.tau_tr, ref.solution.times, ref.solution.power,
         ref.solution.throughput)
    assert (got.profiling_runs, got.profiling_cost_s) == \
        (ref.profiling_runs, ref.profiling_cost_s)


def test_unknown_strategy_raises_the_reference_key_error():
    """An unknown name raises the reference's ``KeyError``, listing the
    scenario's strategies, now the fitted ones too."""
    rf, f = _pair()
    for scenario, w in ((Scenario.INFER, "lstm"), (Scenario.DYNAMIC, "lstm"),
                        (Scenario.CONCURRENT_INFERENCE, "bert")):
        with pytest.raises(KeyError) as want:
            rf.strategy_for(RefScenario(scenario.value), "als999",
                            REF_INFER[w], REF_INFER[w])
        with pytest.raises(KeyError, match="als145") as got:
            f.strategy_for(scenario, "als999", INFER_WORKLOADS[w],
                           INFER_WORKLOADS[w])
        assert str(got.value) == str(want.value)
    with pytest.raises(KeyError, match="nn250"):
        f.solve_dynamic(INFER_WORKLOADS["lstm"], 30.0, 0.5, [30.0], "als999")


# ---------------------------------------------------------------------------
# the strategy registry and the fitted-strategy cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", list(Scenario))
def test_available_strategies_equal_the_reference(scenario):
    assert available_strategies(scenario) == \
        ref_available(RefScenario(scenario.value))


def test_fulcrum_takes_the_reference_arguments_and_defaults():
    ref = inspect.signature(RefFulcrum.__init__).parameters
    got = inspect.signature(Fulcrum.__init__).parameters
    assert list(got)[:len(ref)] == list(ref) and list(got)[len(ref):] == \
        ["backend"]
    assert got["nn_epochs"].default == ref["nn_epochs"].default == 400
    rf, f = _pair()
    assert dataclasses.astuple(f.quadrants) == \
        dataclasses.astuple(rf.quadrants) == ((0.05, 2.0), (30.0, 120.0))
    assert f.nn_epochs == rf.nn_epochs and f.backend is None
    s = Fulcrum(backend="cpu", nn_epochs=7).strategy_for(
        "infer", "als145", INFER_WORKLOADS["lstm"])
    assert (s.backend, s.nn_epochs, s.ranges) == ("cpu", 7, f.quadrants)


def test_engine_calls_run_on_the_facades_backend():
    """An engine call that names no backend runs where its ``Fulcrum`` was
    asked to run (here ``"cpu"``), as the same call naming it does; a
    ``Fulcrum`` asked for nothing runs its engine calls on the card."""
    f = Fulcrum(DeviceModel(), backend="cpu")
    w_tr, w_in = TRAIN_WORKLOADS["mobilenet"], INFER_WORKLOADS["mobilenet"]
    plan = f.solve_concurrent(w_tr, w_in, P.ConcurrentProblem(35.0, 1.0,
                                                              60.0))
    runs = {}
    for kw in ({}, {"backend": "cpu"}):
        runs[len(kw)] = (
            f.execute(plan, w_in, w_tr, arrival_rate=60.0, duration=10.0,
                      **kw).latencies,
            [w.report.latencies for w in f.serve_dynamic(
                w_in, 30.0, 0.1, [45.0, 90.0], window_duration=5.0,
                **kw)])
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_array_equal(a, b)
    mprob = P.MultiTenantProblem(45.0, (
        P.StreamSpec(40.0, 0.8, w_in),
        P.StreamSpec(60.0, 0.5, INFER_WORKLOADS["lstm"])))
    mplan = f.solve_multi_tenant(TRAIN_WORKLOADS["resnet18"], mprob)
    a, b = (f.execute_multi_tenant(mplan, mprob, TRAIN_WORKLOADS["resnet18"],
                                   duration=10.0, **kw)
            for kw in ({}, {"backend": "cpu"}))
    assert a.train_minibatches == b.train_minibatches
    for x, y in zip(a.streams, b.streams):
        np.testing.assert_array_equal(x.latencies, y.latencies)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Fulcrum(DeviceModel()).execute(plan, w_in, w_tr,
                                           arrival_rate=60.0, duration=10.0)


def test_strategy_accepts_scenario_by_value():
    f = Fulcrum(DeviceModel(), backend="cpu")
    s = f.strategy_for("infer", "rnd150", INFER_WORKLOADS["lstm"])
    assert s is f.strategy_for(Scenario.INFER, "rnd150",
                               INFER_WORKLOADS["lstm"])


def test_fitted_strategy_cached_per_workload():
    f = Fulcrum(DeviceModel(), backend="cpu")
    w1, w2 = INFER_WORKLOADS["mobilenet"], INFER_WORKLOADS["lstm"]
    a = f.strategy_for(Scenario.INFER, "rnd150", w1)
    assert f.strategy_for(Scenario.INFER, "rnd150", w1) is a
    assert f.strategy_for(Scenario.INFER, "rnd150", w2) is not a
    assert f.strategy_for(Scenario.INFER, "rnd250", w1) is not a
    # the dynamic and fleet scenarios resolve to the same fitted object
    assert f.strategy_for(Scenario.DYNAMIC, "rnd150", w1) is a
    assert f.strategy_for(Scenario.FLEET, "rnd150", w1) is a
    assert set(f._fitted) == {("infer", "rnd150", (w1.name,)),
                              ("infer", "rnd150", (w2.name,)),
                              ("infer", "rnd250", (w1.name,))}


def test_gmd_is_never_cached():
    f = Fulcrum(DeviceModel())
    w = INFER_WORKLOADS["mobilenet"]
    a = f.strategy_for(Scenario.INFER, "gmd", w)
    b = f.strategy_for(Scenario.INFER, "gmd", w)
    assert a is not b
    assert not f._fitted                      # nothing was cached


def test_solve_reuses_fitted_across_calls():
    f = Fulcrum(DeviceModel(), backend="cpu")
    w = INFER_WORKLOADS["mobilenet"]
    p1 = f.solve_infer(w, P.InferProblem(40.0, 0.5, 60.0), "rnd150")
    p2 = f.solve_infer(w, P.InferProblem(35.0, 0.4, 50.0), "rnd150")
    # the same fitted object answers the second problem: no new profiling
    assert p2.profiling_runs == p1.profiling_runs == 150
    assert len(f._fitted) == 1


@pytest.mark.parametrize("strategy", ["rnd50", "rnd250"])
@pytest.mark.parametrize("budget", [12.0, 25.0, 45.0])
def test_rnd_train_plans_equal_the_reference(strategy, budget):
    rf, f = _pair("cpu")
    _assert_plans_equal(
        rf.solve_train(REF_TRAIN["resnet18"], RP.TrainProblem(budget),
                       strategy),
        f.solve_train(TRAIN_WORKLOADS["resnet18"], P.TrainProblem(budget),
                      strategy))


@pytest.mark.parametrize("strategy", ["rnd150", "rnd250"])
def test_rnd_plans_equal_the_reference_in_every_scenario(strategy):
    rf, f = _pair("cpu")
    for budget, lat, rate in ((30.0, 0.5, 30.0), (40.0, 0.1, 60.0),
                              (20.0, 1.0, 90.0)):
        _assert_plans_equal(
            rf.solve_infer(REF_INFER["mobilenet"],
                           RP.InferProblem(budget, lat, rate), strategy),
            f.solve_infer(INFER_WORKLOADS["mobilenet"],
                          P.InferProblem(budget, lat, rate), strategy))
        _assert_plans_equal(
            rf.solve_concurrent(REF_TRAIN["resnet18"], REF_INFER["mobilenet"],
                                RP.ConcurrentProblem(budget, 2 * lat, rate),
                                strategy),
            f.solve_concurrent(TRAIN_WORKLOADS["resnet18"],
                               INFER_WORKLOADS["mobilenet"],
                               P.ConcurrentProblem(budget, 2 * lat, rate),
                               strategy))
        _assert_plans_equal(
            rf.solve_concurrent_inference(
                REF_INFER["resnet50"], REF_INFER["mobilenet"],
                RP.ConcurrentProblem(budget, 2 * lat, rate), strategy),
            f.solve_concurrent_inference(
                INFER_WORKLOADS["resnet50"], INFER_WORKLOADS["mobilenet"],
                P.ConcurrentProblem(budget, 2 * lat, rate), strategy))


def test_solve_dynamic_fitted_strategy_reuses_model_and_equals_reference():
    rf, f = _pair("cpu")
    w = INFER_WORKLOADS["mobilenet"]
    rates = [40.0, 60.0, 80.0, 140.0]
    a = f.solve_dynamic(w, 40.0, 0.5, rates, "rnd150")
    b = f.solve_dynamic(w, 40.0, 0.5, rates, "rnd150")
    assert len(f._fitted) == 1                # one fitted model, reused
    assert [_sol_key(s) for s in a] == [_sol_key(s) for s in b]
    want = rf.solve_dynamic(REF_INFER["mobilenet"], 40.0, 0.5, rates,
                            "rnd150")
    assert [_sol_key(s) for s in a] == [_sol_key(s) for s in want]
    assert any(s is not None for s in a)


def test_multi_tenant_fitted_strategy_cached_and_equals_reference():
    rf, f = _pair("cpu")
    specs = (P.StreamSpec(40.0, 0.8, INFER_WORKLOADS["mobilenet"]),
             P.StreamSpec(60.0, 0.5, INFER_WORKLOADS["lstm"]))
    ref_specs = (RP.StreamSpec(40.0, 0.8, REF_INFER["mobilenet"]),
                 RP.StreamSpec(60.0, 0.5, REF_INFER["lstm"]))
    w_tr, ref_w_tr = TRAIN_WORKLOADS["mobilenet"], REF_TRAIN["mobilenet"]
    p1 = f.solve_multi_tenant(w_tr, P.MultiTenantProblem(40.0, specs),
                              "rnd150")
    p2 = f.solve_multi_tenant(w_tr, P.MultiTenantProblem(30.0, specs),
                              "rnd150")
    assert p1 is not None and p2 is not None
    assert p2.profiling_runs == p1.profiling_runs   # no re-profiling
    assert len(f._fitted) == 1
    for plan, budget in ((p1, 40.0), (p2, 30.0)):
        want = rf.solve_multi_tenant(
            ref_w_tr, RP.MultiTenantProblem(budget, ref_specs), "rnd150")
        assert dataclasses.asdict(plan.solution) == \
            dataclasses.asdict(want.solution)
        assert (plan.profiling_runs, plan.profiling_cost_s) == \
            (want.profiling_runs, want.profiling_cost_s)


# the README's closed loop on mobilenet at 30 W and 0.1 s, answered by ALS
ALS_LOOP = dict(rate_estimator="ewma", rate_margin=1.5, feedback=True,
                carry_backlog=True, mode_switch_s=0.5)


def test_serve_dynamic_with_als145_matches_the_reference(monkeypatch):
    """The closed loop with a fitted strategy answering every window from
    one model (shared predictions: one memo of the reference's NN fits)."""
    shared = SharedNN()
    shared.patch(monkeypatch, "ref", ref_als)
    shared.patch(monkeypatch, "port", als)
    rates = [45.0, 60.0, 90.0, 50.0]
    ref = RefFulcrum(RefDevice(), nn_epochs=50).serve_dynamic(
        REF_INFER["mobilenet"], 30.0, 0.1, rates, "als145",
        window_duration=30.0, controller=RefConfig(**ALS_LOOP),
        backend="numpy")
    got = Fulcrum(DeviceModel(), nn_epochs=50, backend="cpu").serve_dynamic(
        INFER_WORKLOADS["mobilenet"], 30.0, 0.1, rates, "als145",
        window_duration=30.0, controller=ControllerConfig(**ALS_LOOP))
    assert shared.calls["port"] == shared.calls["ref"]
    assert_windows_match(ref, got)
    assert all(w.solution is not None for w in got)


def test_execute_on_poisson_trace_matches_reference():
    """The README quickstart: solve, then execute over a 120 s Poisson
    trace."""
    rf, f = _pair()
    ref_plan = rf.solve_concurrent(REF_TRAIN["mobilenet"],
                                   REF_INFER["mobilenet"],
                                   RP.ConcurrentProblem(35.0, 1.0, 60.0))
    plan = f.solve_concurrent(TRAIN_WORKLOADS["mobilenet"],
                              INFER_WORKLOADS["mobilenet"],
                              P.ConcurrentProblem(35.0, 1.0, 60.0))
    _assert_plans_equal(ref_plan, plan)
    ref = rf.execute(ref_plan, REF_INFER["mobilenet"], REF_TRAIN["mobilenet"],
                     trace=RS.ArrivalTrace.poisson(60.0, 120.0, seed=0))
    got = f.execute(plan, INFER_WORKLOADS["mobilenet"],
                    TRAIN_WORKLOADS["mobilenet"],
                    trace=S.ArrivalTrace.poisson(60.0, 120.0, seed=0),
                    backend="cpu")
    np.testing.assert_allclose(got.latencies, ref.latencies, **ENG_TOL)
    assert abs(got.train_minibatches - ref.train_minibatches) <= 2
    assert got.power == ref.power
    assert got.latency_quantile(0.95) == pytest.approx(
        ref.latency_quantile(0.95), rel=1e-9, abs=1e-8)


@pytest.mark.parametrize("arrivals", ["uniform", "poisson"])
def test_serve_dynamic_open_loop_matches_reference(arrivals):
    """The README's open-loop case: resnet50, 40 W, 0.1 s, four 30 s
    windows."""
    rf, f = _pair()
    rates = [45.0, 60.0, 115.0, 50.0]
    ref = rf.serve_dynamic(REF_INFER["resnet50"], 40.0, 0.1, rates,
                           strategy="gmd", window_duration=30.0,
                           arrivals=arrivals, seed=3)
    got = f.serve_dynamic(INFER_WORKLOADS["resnet50"], 40.0, 0.1, rates,
                          strategy="gmd", window_duration=30.0,
                          arrivals=arrivals, seed=3, backend="cpu")
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        assert _sol_key(b.solution) == _sol_key(a.solution)
        assert (b.replanned, b.rate, b.estimated_rate, b.offered_requests) \
            == (a.replanned, a.rate, a.estimated_rate, a.offered_requests)
        np.testing.assert_allclose(b.report.latencies, a.report.latencies,
                                   **ENG_TOL)
        assert abs(b.goodput - a.goodput) * a.offered_requests <= 1
        assert b.report.violation_rate(0.1) == pytest.approx(
            a.report.violation_rate(0.1), abs=1.0 / a.offered_requests)


def test_solve_dynamic_equals_reference():
    rf, f = _pair()
    rates = [20.0, 80.0, 140.0, 35.0, 0.5]
    ref = rf.solve_dynamic(REF_INFER["lstm"], 30.0, 0.3, rates)
    got = f.solve_dynamic(INFER_WORKLOADS["lstm"], 30.0, 0.3, rates)
    assert [_sol_key(s) for s in got] == [_sol_key(s) for s in ref]

