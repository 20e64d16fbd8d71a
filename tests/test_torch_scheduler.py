"""The port's scheduler against the reference's: GMD plans equal exactly
(power mode, minibatch size, tau_tr, achieved metrics, profiling runs and
cost) across workloads and budgets, infeasible problems return ``None`` in
both, and executing a plan on the port's engine (``backend="cpu"``) meets
the reference's NumPy engine within the engine tolerance — for
``execute`` on a Poisson trace and for the README's open-loop
``serve_dynamic`` case."""
import dataclasses

import numpy as np
import pytest

from repro.core import problem as RP
from repro.core import simulate as RS
from repro.core.device_model import DeviceModel as RefDevice
from repro.core.device_model import INFER_WORKLOADS as REF_INFER
from repro.core.device_model import TRAIN_WORKLOADS as REF_TRAIN
from repro.core.scheduler import Fulcrum as RefFulcrum
from repro_torch.core import problem as P
from repro_torch.core import simulate as S
from repro_torch.core.device_model import (DeviceModel, INFER_WORKLOADS,
                                           TRAIN_WORKLOADS)
from repro_torch.core.scheduler import Fulcrum, Scenario

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


def _pair():
    return RefFulcrum(RefDevice()), Fulcrum(DeviceModel())


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


def test_strategies_not_ported_raise_the_reference_key_error():
    f = Fulcrum()
    with pytest.raises(KeyError, match="als145"):
        f.solve_infer(INFER_WORKLOADS["lstm"], P.InferProblem(30, 0.5, 30),
                      strategy="als145")
    with pytest.raises(KeyError, match="nn250"):
        f.solve_dynamic(INFER_WORKLOADS["lstm"], 30.0, 0.5, [30.0], "nn250")
    with pytest.raises(KeyError, match="rnd150"):
        f.solve(Scenario.CONCURRENT_INFERENCE, (INFER_WORKLOADS["bert"],
                                                INFER_WORKLOADS["lstm"]),
                P.ConcurrentProblem(40.0, 0.5, 40.0), strategy="rnd150")


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

