"""The port's trace-driven engine (``backend="cpu"``: the kernels' plain
versions) against the reference's NumPy engine, mirroring the jax / pallas
cases of ``tests/test_simulate.py``: latencies within ``ENG_TOL``
(``docs/exactness.md``), training minibatches within the floor-boundary
slack (+-2), queue-state pending times equal, native/streams bitwise, the
batched report builder's statistics exact and its chunking invisible.

Both packages get identical inputs: the reference's objects are carried
across through ``repro_torch.convert`` (plain fields and NumPy arrays).
"""
import dataclasses

import numpy as np
import pytest

from repro.core import simulate as RS
from repro.core.device_model import DeviceModel as RefDevice
from repro.core.device_model import INFER_WORKLOADS as REF_INFER
from repro.core.device_model import TRAIN_WORKLOADS as REF_TRAIN
from repro.core.powermode import PowerModeSpace as RefSpace
from repro_torch import convert
from repro_torch.core import backend as B
from repro_torch.core import interleave as I
from repro_torch.core import simulate as S
from repro_torch.core.device_model import (DeviceModel, INFER_WORKLOADS,
                                           TRAIN_WORKLOADS)
from repro_torch.core.powermode import PowerModeSpace

ENG_TOL = dict(rtol=1e-9, atol=1e-8)
REF_DEV, DEV = RefDevice(), DeviceModel()
REF_MODES = RefSpace().all_modes()
REF_TRAIN_WS = list(REF_TRAIN.values())
REF_INFER_WS = list(REF_INFER.values())


def _w(w):
    return None if w is None else convert.workload_profile(
        dataclasses.asdict(w))


def _pm(pm):
    return convert.power_mode(dataclasses.asdict(pm))


def _tr(tr):
    return convert.arrival_trace(tr.times, tr.duration, tr.kind)


def _qs(qs):
    return None if qs is None else convert.queue_state(qs.pending, qs.clock)


def _random_config(rng):
    """test_simulate.py's generator of (w_tr, w_in, pm, bs, trace, cap)."""
    w_tr = (REF_TRAIN_WS[rng.integers(5)] if rng.random() < 0.8 else None)
    w_in = REF_INFER_WS[rng.integers(5)]
    pm = REF_MODES[rng.integers(len(REF_MODES))]
    bs = [1, 4, 16, 32, 64][rng.integers(5)]
    rate = float(rng.uniform(1.0, 120.0))
    duration = float(rng.uniform(5.0, 60.0))
    kind = int(rng.integers(3))
    if kind == 0:
        trace = RS.ArrivalTrace.uniform(rate, duration)
    elif kind == 1:
        trace = RS.ArrivalTrace.poisson(rate, duration,
                                        seed=int(rng.integers(1000)))
    else:
        trace = RS.ArrivalTrace.piecewise(
            [float(rng.uniform(1.0, 100.0)) for _ in range(4)], duration / 4)
    tau_cap = None if rng.random() < 0.7 else int(rng.integers(0, 4))
    return w_tr, w_in, pm, bs, trace, tau_cap


def _assert_engine_close(ref, got):
    np.testing.assert_allclose(np.asarray(got.latencies, np.float64),
                               np.asarray(ref.latencies, np.float64),
                               **ENG_TOL)
    # fill counts may flip only on quotient-boundary cases (floor vs replay)
    assert abs(ref.train_minibatches - got.train_minibatches) <= 2
    if bool(ref.train_minibatches) == bool(got.train_minibatches):
        assert ref.power == got.power
    assert ref.duration == got.duration
    if ref.queue_state is not None:
        np.testing.assert_array_equal(got.queue_state.pending,
                                      ref.queue_state.pending)
        np.testing.assert_allclose(got.queue_state.clock,
                                   ref.queue_state.clock, **ENG_TOL)


def _assert_presorted(rep):
    assert rep._sorted is not None         # the builder filled the cache
    np.testing.assert_array_equal(
        rep._sorted, np.sort(np.asarray(rep.latencies, np.float64)))


# ---------------------------------------------------------------------------
# carried state: identical inputs in both packages
# ---------------------------------------------------------------------------

def test_workload_tables_carry_across_exactly():
    for ref_table, table in ((REF_TRAIN, TRAIN_WORKLOADS),
                             (REF_INFER, INFER_WORKLOADS)):
        assert list(ref_table) == list(table)
        for name, w in ref_table.items():
            assert dataclasses.asdict(w) == dataclasses.asdict(table[name])
            assert _w(w) == table[name]
    assert [dataclasses.astuple(m) for m in REF_MODES] == \
        [dataclasses.astuple(m) for m in PowerModeSpace().all_modes()]


@pytest.mark.parametrize("rate,duration,seed", [(60.0, 120.0, 0),
                                                (7.5, 30.0, 11),
                                                (250.0, 4.0, 3),
                                                (0.0, 5.0, 1)])
def test_traces_reproduce_the_reference_bitwise(rate, duration, seed):
    pairs = [(RS.ArrivalTrace.poisson(rate, duration, seed),
              S.ArrivalTrace.poisson(rate, duration, seed)),
             (RS.ArrivalTrace.uniform(rate, duration),
              S.ArrivalTrace.uniform(rate, duration)),
             (RS.ArrivalTrace.piecewise([rate, rate / 2 + 1.0], duration,
                                        seed=seed),
              S.ArrivalTrace.piecewise([rate, rate / 2 + 1.0], duration,
                                       seed=seed))]
    for ref, got in pairs:
        assert got.times.tobytes() == ref.times.tobytes()
        assert (got.duration, got.kind) == (ref.duration, ref.kind)


def test_device_timings_equal_the_reference():
    rng = np.random.default_rng(1)
    for _ in range(50):
        pm = REF_MODES[rng.integers(len(REF_MODES))]
        w = (REF_TRAIN_WS + REF_INFER_WS)[rng.integers(10)]
        bs = [None, 1, 4, 16, 32, 64][rng.integers(6)]
        assert DEV.time_power(_w(w), _pm(pm), bs) == \
            REF_DEV.time_power(w, pm, bs)


# ---------------------------------------------------------------------------
# managed engine: cpu tier vs the NumPy reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_cpu_engine_matches_numpy_randomized(seed):
    rng = np.random.default_rng(100 + seed)
    w_tr = REF_TRAIN_WS[seed % 5] if seed % 2 == 0 else None
    w_in = REF_INFER_WS[seed % 5]
    pms, bss, traces, caps = [], [], [], []
    for _ in range(8):
        _, _, pm, bs, trace, cap = _random_config(rng)
        pms.append(pm), bss.append(bs), traces.append(trace), caps.append(cap)
    ref = RS.simulate_batch(REF_DEV, w_tr, w_in, pms, bss, traces,
                            tau_caps=caps, backend="numpy")
    got = S.simulate_batch(DEV, _w(w_tr), _w(w_in), [_pm(p) for p in pms],
                           bss, [_tr(t) for t in traces], tau_caps=caps,
                           backend="cpu")
    for a, b in zip(ref, got):
        _assert_engine_close(a, b)
        _assert_presorted(b)
        assert b.attributed_power == pytest.approx(a.attributed_power,
                                                   rel=1e-9)


@pytest.mark.parametrize("seed", range(3))
def test_cpu_engine_carry_ins_match_numpy(seed):
    """Carried backlog: pending requests re-enter ahead of the window and
    the clock may overrun the first batches."""
    rng = np.random.default_rng(400 + seed)
    w_tr = REF_TRAIN_WS[seed]
    w_in = REF_INFER_WS[seed + 1]
    pms, bss, traces, caps, carries = [], [], [], [], []
    for _ in range(6):
        _, _, pm, bs, trace, cap = _random_config(rng)
        t0 = float(rng.uniform(1.0, 5.0))
        pend = np.sort(rng.uniform(0.0, t0, int(rng.integers(0, 40))))
        clock = float(rng.uniform(0.0, t0 + 2.0)) if rng.random() < 0.8 \
            else 0.0
        pms.append(pm), bss.append(bs), caps.append(cap)
        traces.append(trace.shifted(t0))
        carries.append(RS.QueueState(pend, clock))
    ref = RS.simulate_batch(REF_DEV, w_tr, w_in, pms, bss, traces,
                            tau_caps=caps, backend="numpy",
                            carry_ins=carries)
    got = S.simulate_batch(DEV, _w(w_tr), _w(w_in), [_pm(p) for p in pms],
                           bss, [_tr(t) for t in traces], tau_caps=caps,
                           backend="cpu", carry_ins=[_qs(c) for c in carries])
    for a, b in zip(ref, got):
        _assert_engine_close(a, b)


def test_cpu_single_simulate_matches_numpy():
    w_tr, w_in = REF_TRAIN["mobilenet"], REF_INFER["mobilenet"]
    trace = RS.ArrivalTrace.poisson(60.0, 30.0, seed=7)
    ref = RS.simulate(REF_DEV, w_tr, w_in, RefSpace().maxn(), 16, trace,
                      "managed")
    got = S.simulate(DEV, _w(w_tr), _w(w_in), PowerModeSpace().maxn(), 16,
                     _tr(trace), "managed", backend="cpu")
    _assert_engine_close(ref, got)


def test_cpu_engine_backlogged_within_tolerance():
    """Unsustainable config: the scan must track the queue buildup too."""
    trace = RS.ArrivalTrace.uniform(60.0, 20.0)
    args = (REF_TRAIN["mobilenet"], REF_INFER["bert"], REF_MODES[0], 16)
    ref = RS.simulate(REF_DEV, *args, trace, "managed")
    got = S.simulate(DEV, _w(args[0]), _w(args[1]), _pm(args[2]), 16,
                     _tr(trace), "managed", backend="cpu")
    assert ref.queue_state.clock > trace.duration    # backlog really built
    _assert_engine_close(ref, got)


def test_lane_chunking_is_invisible_and_counted(monkeypatch):
    """Chunks share one global event pad, so each lane's scan is the same
    whatever chunk it lands in: chunked results equal unchunked ones."""
    rng = np.random.default_rng(8)
    w_in = INFER_WORKLOADS["lstm"]
    modes = PowerModeSpace().all_modes()
    pms = [modes[int(rng.integers(len(modes)))] for _ in range(11)]
    bss = [int(b) for b in rng.choice([1, 4, 16], 11)]
    traces = [S.ArrivalTrace.poisson(float(rng.uniform(5, 40)), 6.0, seed=i)
              for i in range(11)]
    whole = S.simulate_batch(DEV, TRAIN_WORKLOADS["lstm"], w_in, pms, bss,
                             traces, backend="cpu")
    monkeypatch.setattr(S, "_LANE_CHUNK", 4)
    n0 = B.dispatch_count("engine")
    chunked = S.simulate_batch(DEV, TRAIN_WORKLOADS["lstm"], w_in, pms, bss,
                               traces, backend="cpu")
    assert B.dispatch_count("engine") - n0 == 3
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a.latencies, b.latencies)
        assert a.train_minibatches == b.train_minibatches


@pytest.mark.parametrize("approach", ["native", "streams"])
def test_native_and_streams_bitwise(approach):
    rng = np.random.default_rng(21)
    for _ in range(6):
        _, w_in, pm, bs, trace, _ = _random_config(rng)
        w_tr = REF_TRAIN_WS[int(rng.integers(5))]
        seed = int(rng.integers(100))
        ref = RS.simulate(REF_DEV, w_tr, w_in, pm, bs, trace, approach,
                          seed=seed)
        got = S.simulate(DEV, _w(w_tr), _w(w_in), _pm(pm), bs, _tr(trace),
                         approach, seed=seed, backend="cpu")
        assert got.latencies.tobytes() == ref.latencies.tobytes()
        assert (got.train_minibatches, got.power) == \
            (ref.train_minibatches, ref.power)


def test_interleave_wrappers_match_the_reference():
    from repro.core import interleave as RI
    pm = RefSpace().maxn()
    w_tr, w_in = REF_TRAIN["resnet18"], REF_INFER["resnet50"]
    for name in ("simulate_managed", "simulate_native", "simulate_streams"):
        ref = getattr(RI, name)(REF_DEV, w_tr, w_in, pm, 4, 40.0, 15.0)
        got = getattr(I, name)(DEV, _w(w_tr), _w(w_in), _pm(pm), 4, 40.0,
                               15.0, backend="cpu")
        _assert_engine_close(ref, got)


def test_unknown_approach_and_misaligned_lanes_raise():
    trace = S.ArrivalTrace.uniform(10.0, 1.0)
    maxn = PowerModeSpace().maxn()
    with pytest.raises(ValueError, match="unknown approach"):
        S.simulate(DEV, None, INFER_WORKLOADS["lstm"], maxn, 1, trace,
                   approach="magic", backend="cpu")
    with pytest.raises(ValueError, match="align"):
        S.simulate_batch(DEV, None, INFER_WORKLOADS["lstm"], [maxn], [1, 4],
                         [trace], backend="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        S.simulate_batch(DEV, None, INFER_WORKLOADS["lstm"], [maxn], [1],
                         [trace], backend="numpy")


# ---------------------------------------------------------------------------
# batched report builder
# ---------------------------------------------------------------------------

def test_report_builder_matches_per_report_statistics_and_reference():
    rng = np.random.default_rng(5)
    pms = [REF_MODES[int(rng.integers(len(REF_MODES)))] for _ in range(4)]
    traces = [RS.ArrivalTrace.poisson(float(rng.uniform(10, 60)), 15.0,
                                      seed=i) for i in range(4)]
    w_in = REF_INFER["mobilenet"]
    ref = RS.simulate_batch(REF_DEV, None, w_in, pms, [4, 16, 1, 32], traces)
    got = S.simulate_batch(DEV, None, _w(w_in), [_pm(p) for p in pms],
                           [4, 16, 1, 32], [_tr(t) for t in traces],
                           backend="cpu")
    for a, rep in zip(ref, got):
        _assert_presorted(rep)
        xs = np.asarray(rep.latencies, np.float64)
        for q in (0.01, 0.5, 0.75, 0.95, 1.0):
            fresh = S.ExecutionReport("managed", xs.tolist(), 0, 1.0, 0.0)
            assert rep.latency_quantile(q) == fresh.latency_quantile(q)
            assert rep.latency_quantile(q) == pytest.approx(
                a.latency_quantile(q), rel=1e-9, abs=1e-8)
        for budget in (0.0, float(np.median(xs)) if xs.size else 0.5, 10.0):
            want = (float(np.count_nonzero(xs > budget)) / xs.size
                    if xs.size else 0.0)
            assert rep.violation_rate(budget) == want


def test_presort_chunking_bitwise_identical(monkeypatch):
    """Tiny sort chunks: each report's sorted cache must equal one
    unchunked NumPy sort of its latencies, and each chunk is one launch
    of the report builder's sort."""
    rng = np.random.default_rng(9)
    reports = []
    for _ in range(13):
        xs = rng.uniform(0.0, 3.0, int(rng.integers(0, 40))).tolist()
        reports.append(S.ExecutionReport("managed", xs, 0, 1.0, 0.0))
    want = [np.sort(np.asarray(r.latencies, np.float64)) for r in reports]
    monkeypatch.setattr(S, "_SORT_CHUNK_ELEMS", 64)
    chunks = S._sort_chunks([len(r.latencies) for r in reports])
    assert len(chunks) > 3
    n0 = B.dispatch_count("sort")
    S._presort_reports(reports, "cpu")
    assert B.dispatch_count("sort") - n0 == len(chunks)
    for rep, w in zip(reports, want):
        np.testing.assert_array_equal(rep._sorted, w)


def test_presort_highly_ragged_chunk_is_sorted_padded():
    """The reference sorts highly ragged chunks per report on the host; the
    port pads and sorts them in one launch, with the same result."""
    rng = np.random.default_rng(3)
    reports = [S.ExecutionReport("managed", rng.uniform(0, 1, n).tolist(),
                                 0, 1.0, 0.0) for n in [500, 1, 0, 2, 3]]
    n0 = B.dispatch_count("sort")
    S._presort_reports(reports, "cpu")
    assert B.dispatch_count("sort") - n0 == 1
    for rep in reports:
        _assert_presorted(rep)
