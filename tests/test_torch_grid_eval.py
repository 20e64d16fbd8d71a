"""The port's grid solvers and oracle (``repro_torch.core.grid_eval``,
``repro_torch.core.oracle``) against the reference's NumPy tier, mirroring
``tests/test_grid_eval.py``.

Tolerance: none. The dense grids are host NumPy code copied from the
reference, and every batched solver on the ``"cpu"`` backend returns the
reference's solutions bitwise (``dataclasses.asdict`` equal, every float
included): a masked argmin / argmax reassociates nothing, and
``torch.argmin`` takes the first of equal values as the scalar loops do.
The grids here force ties (coarse value pools, duplicated (t, p) entries)
and include problems with no feasible entry.
"""
import dataclasses
import random

import numpy as np
import pytest
import torch

from repro.core import grid_eval as RG
from repro.core import problem as RP
from repro.core.device_model import DeviceModel as RefDevice
from repro.core.device_model import INFER_WORKLOADS as REF_INFER
from repro.core.device_model import TRAIN_WORKLOADS as REF_TRAIN
from repro.core.oracle import Oracle as RefOracle
from repro.core.powermode import PowerModeSpace as RefSpace
from repro_torch.core import backend as B
from repro_torch.core import grid_eval as G
from repro_torch.core import problem as P
from repro_torch.core.device_model import (DeviceModel, INFER_WORKLOADS,
                                           TRAIN_WORKLOADS)
from repro_torch.core.oracle import Oracle
from repro_torch.core.powermode import PowerModeSpace
from repro_torch.core.scheduler import Fulcrum

DEV, REF_DEV = DeviceModel(), RefDevice()
SPACE, REF_SPACE = PowerModeSpace(), RefSpace()
MODES, REF_MODES = SPACE.all_modes(), REF_SPACE.all_modes()
BSS = list(P.INFER_BATCH_SIZES)


def _as(sols):
    """Solutions as plain dicts, comparable across the two packages."""
    return [None if s is None else dataclasses.asdict(s) for s in sols]


def _both(kind, *args):
    """One problem of ``kind`` in each package, from the same numbers."""
    return getattr(RP, kind)(*args), getattr(P, kind)(*args)


def _problems(kind, rows):
    pairs = [_both(kind, *r) for r in rows]
    return [a for a, _ in pairs], [b for _, b in pairs]


# ---------------------------------------------------------------------------
# dense device-model grids
# ---------------------------------------------------------------------------

def _assert_grids_equal(ref, got):
    assert got.t.tobytes() == ref.t.tobytes()
    assert got.p.tobytes() == ref.p.tobytes()
    assert [dataclasses.asdict(m) for m in got.modes] == \
        [dataclasses.asdict(m) for m in ref.modes]
    assert (got.bs is None) == (ref.bs is None)
    if ref.bs is not None:
        assert got.bs.tolist() == ref.bs.tolist()


@pytest.mark.parametrize("kind,name", [("train", "resnet18"),
                                       ("train", "bert"),
                                       ("infer", "mobilenet"),
                                       ("infer", "bert")])
def test_dense_grid_is_bitwise_the_reference_and_the_scalar_model(kind,
                                                                  name):
    bss = None if kind == "train" else BSS
    table, ref_table = ((TRAIN_WORKLOADS, REF_TRAIN) if kind == "train"
                        else (INFER_WORKLOADS, REF_INFER))
    got = G.materialize(DEV, table[name], SPACE, bss)
    _assert_grids_equal(RG.materialize(REF_DEV, ref_table[name], REF_SPACE,
                                       bss), got)
    # and every point is the port's own scalar device model, bitwise
    for i in range(0, len(got), 7):
        pm = got.modes[i]
        b = None if got.bs is None else int(got.bs[i])
        assert (float(got.t[i]), float(got.p[i])) == \
            DEV.time_power(table[name], pm, b)


def test_grid_lookup_dict_roundtrip_and_cached_view():
    w = TRAIN_WORKLOADS["lstm"]
    grid = G.materialize(DEV, w, SPACE)
    d = grid.to_dict()
    assert list(d) == MODES                      # insertion order preserved
    pm = SPACE.midpoint()
    assert grid.lookup(pm) == d[pm] == DEV.time_power(w, pm)

    class Owner:
        cache = None
    g1 = G.cached_grid(Owner, "cache", d, "train")
    assert G.cached_grid(Owner, "cache", d, "train") is g1
    d2 = dict(list(d.items())[:10])
    assert len(G.cached_grid(Owner, "cache", d2, "train")) == 10


def test_a_subclassed_device_model_materializes_point_by_point():
    class Slow(DeviceModel):
        def time_power(self, w, pm, bs=None):
            t, p = DeviceModel.time_power(self, w, pm, bs)
            return 2.0 * t, p

    w = INFER_WORKLOADS["lstm"]
    space = PowerModeSpace([4, 12], [729, 2201], [306, 1300], [665, 3199])
    grid = G.materialize(Slow(), w, space, [1, 16])
    for i in range(len(grid)):
        pm, b = grid.key(i)
        assert (float(grid.t[i]), float(grid.p[i])) == \
            Slow().time_power(w, pm, b)


# ---------------------------------------------------------------------------
# randomized observation sets: the batched solvers == the reference, bitwise
# ---------------------------------------------------------------------------

def _rand_train_obs(rng):
    """The same random {pm: (t, p)} in each package; coarse value pools
    force ties so first-occurrence tie-breaking is hit."""
    sub = rng.sample(range(len(MODES)), rng.randrange(1, 50))
    vals = [(rng.choice([0.1, 0.25, round(rng.uniform(0.01, 1.0), 3)]),
             rng.choice([12.0, 30.0, round(rng.uniform(5.0, 60.0), 2)]))
            for _ in sub]
    return ({REF_MODES[i]: v for i, v in zip(sub, vals)},
            {MODES[i]: v for i, v in zip(sub, vals)})


def _rand_infer_obs(rng, dup=False):
    """The same random {(pm, bs): (t, p)} in each package; with ``dup``
    every value is drawn from a handful of (t, p) pairs, so many entries
    are exact duplicates."""
    sub = rng.sample(range(len(MODES)), rng.randrange(1, 50))
    pool = [(0.05, 15.0), (0.2, 15.0), (0.05, 30.0), (0.02, 40.0)]
    keys, vals = [], []
    for i in sub:
        for _ in range(2):
            keys.append((i, rng.choice(BSS)))
            vals.append(rng.choice(pool) if dup else
                        (rng.choice([0.05, 0.2, round(rng.uniform(0.005, 2.0),
                                                      3)]),
                         rng.choice([15.0, round(rng.uniform(5.0, 60.0),
                                                 2)])))
    return ({(REF_MODES[i], b): v for (i, b), v in zip(keys, vals)},
            {(MODES[i], b): v for (i, b), v in zip(keys, vals)})


@pytest.mark.parametrize("seed", range(3))
def test_solve_train_batch_is_bitwise_the_reference(seed):
    rng = random.Random(7 + seed)
    for _ in range(12):
        ref_obs, obs = _rand_train_obs(rng)
        rows = [(rng.choice([0.0, 11.0, rng.uniform(1, 70)]),)
                for _ in range(15)]
        rp, pp = _problems("TrainProblem", rows)
        got = G.solve_train_batch(pp, obs, backend="cpu")
        assert _as(got) == _as(RG.solve_train_batch(rp, ref_obs))
        assert _as(got) == _as([P.solve_train(pr, obs) for pr in pp])
    # a budget below every observed power: no solution
    assert G.solve_train_batch([P.TrainProblem(0.0)], obs,
                               backend="cpu") == [None]


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("seed", range(2))
def test_solve_infer_batch_is_bitwise_the_reference(seed, dup):
    rng = random.Random(8 + seed)
    for _ in range(12):
        ref_obs, obs = _rand_infer_obs(rng, dup)
        rows = [(rng.uniform(1, 70), rng.choice([0.01, 0.3, 2.0]),
                 rng.choice([5.0, 30.0, 60.0, 200.0])) for _ in range(15)]
        rp, pp = _problems("InferProblem", rows)
        got = G.solve_infer_batch(pp, obs, backend="cpu")
        assert _as(got) == _as(RG.solve_infer_batch(rp, ref_obs))
        assert _as(got) == _as([P.solve_infer(pr, obs) for pr in pp])


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("seed", range(2))
def test_solve_concurrent_batch_is_bitwise_the_reference(seed, dup):
    rng = random.Random(9 + seed)
    for _ in range(12):
        ref_iobs, iobs = _rand_infer_obs(rng, dup)
        # train obs cover only part of the inference modes (the scalar loop
        # skips uncovered modes; the batched mask must too)
        imodes = sorted({MODES.index(pm) for pm, _ in iobs})
        tsub = rng.sample(imodes, max(1, len(imodes) // 2))
        tvals = [(round(rng.uniform(0.01, 1.0), 3),
                  round(rng.uniform(5.0, 60.0), 2)) for _ in tsub]
        ref_tobs = {REF_MODES[i]: v for i, v in zip(tsub, tvals)}
        tobs = {MODES[i]: v for i, v in zip(tsub, tvals)}
        rows = [(rng.uniform(1, 70), rng.choice([0.05, 0.5, 2.0]),
                 rng.choice([10.0, 30.0, 60.0])) for _ in range(15)]
        rp, pp = _problems("ConcurrentProblem", rows)
        got = G.solve_concurrent_batch(pp, tobs, iobs, backend="cpu")
        assert _as(got) == _as(RG.solve_concurrent_batch(rp, ref_tobs,
                                                         ref_iobs))
        assert _as(got) == _as([P.solve_concurrent(pr, tobs, iobs)
                                for pr in pp])


def test_align_train_is_the_reference():
    rng = random.Random(3)
    ref_iobs, iobs = _rand_infer_obs(rng)
    imodes = sorted({MODES.index(pm) for pm, _ in iobs})
    tsub = imodes[::2]
    ref_tobs = {REF_MODES[i]: (0.1 * (k + 1), 20.0 + k)
                for k, i in enumerate(tsub)}
    tobs = {MODES[i]: (0.1 * (k + 1), 20.0 + k) for k, i in enumerate(tsub)}
    got = G._align_train(G.as_infer_grid(iobs), G.as_train_grid(tobs))
    ref = RG._align_train(RG.as_infer_grid(ref_iobs),
                          RG.as_train_grid(ref_tobs))
    for a, b in zip(ref, got):
        assert np.asarray(b).tobytes() == np.asarray(a).tobytes()
    assert not got[2].all() and got[2].any()


def _fleet_case(rng, n):
    ts = rng.uniform(0.9, 1.1, n)
    ps = rng.uniform(0.95, 1.05, n)
    rows = [(float(rng.uniform(10, 55)), float(rng.uniform(0.05, 1.5)),
             float(rng.uniform(5, 150))) for _ in range(n)]
    his = np.array([r[2] * float(rng.uniform(1.0, 1.6)) for r in rows])
    return ts, ps, rows, his


@pytest.mark.parametrize("seed", range(3))
def test_solve_infer_fleet_batch_is_bitwise_the_reference(seed):
    rng = np.random.default_rng(11 + seed)
    grid = G.materialize(DEV, INFER_WORKLOADS["mobilenet"], SPACE, BSS)
    ref_grid = RG.materialize(REF_DEV, REF_INFER["mobilenet"], REF_SPACE,
                              BSS)
    ts, ps, rows, his = _fleet_case(rng, 40)
    rows[0] = (1.0, 0.5, 50.0)                   # no feasible entry
    rp, pp = _problems("InferProblem", rows)
    got = G.solve_infer_fleet_batch(pp, his, grid, ts, ps, backend="cpu")
    assert _as(got) == _as(RG.solve_infer_fleet_batch(rp, his, ref_grid, ts,
                                                      ps))
    assert got[0] is None and sum(s is not None for s in got) > 20
    base = grid.to_dict()
    for k in range(0, 40, 5):                    # the scalar interval solve
        obs = {key: (t * ts[k], p * ps[k]) for key, (t, p) in base.items()}
        assert _as([got[k]]) == _as([P.solve_infer_interval(
            pp[k], float(his[k]), obs)])


def test_fleet_solver_validates_alignment():
    grid = G.materialize(DEV, INFER_WORKLOADS["mobilenet"], SPACE, BSS)
    probs = [P.InferProblem(30.0, 0.5, 50.0)] * 2
    with pytest.raises(ValueError, match="align"):
        G.solve_infer_fleet_batch(probs, [60.0], grid, [1.0, 1.0],
                                  [1.0, 1.0], backend="cpu")


def _mt_obs(stride):
    sub = range(0, len(MODES), stride)
    w_tr, w_a, w_b = (TRAIN_WORKLOADS["resnet18"], INFER_WORKLOADS["mobilenet"],
                      INFER_WORKLOADS["lstm"])
    rw_tr, rw_a, rw_b = (REF_TRAIN["resnet18"], REF_INFER["mobilenet"],
                         REF_INFER["lstm"])
    tobs = {MODES[i]: DEV.time_power(w_tr, MODES[i]) for i in sub}
    ref_tobs = {REF_MODES[i]: REF_DEV.time_power(rw_tr, REF_MODES[i])
                for i in sub}
    iobs = [{(MODES[i], b): DEV.time_power(w, MODES[i], b)
             for i in sub for b in BSS} for w in (w_a, w_b)]
    ref_iobs = [{(REF_MODES[i], b): REF_DEV.time_power(w, REF_MODES[i], b)
                 for i in sub for b in BSS} for w in (rw_a, rw_b)]
    return ref_tobs, tobs, ref_iobs, iobs


def _mt_problems(mod, rng_vals, train, priorities, batch_sizes):
    out = []
    for pb, r0, r1, l0, l1 in rng_vals:
        streams = (mod.StreamSpec(r0, l0, "mobilenet", batch_sizes),
                   mod.StreamSpec(r1, l1, "lstm"))
        out.append(mod.MultiTenantProblem(pb, streams, train=train,
                                          priorities=priorities))
    return out


@pytest.mark.parametrize("train,priorities,batch_sizes", [
    (True, None, None), (False, None, None), (True, (3.0, 1.0), None),
    (False, (1.0, 2.0), (4, 16, 32))])
def test_solve_multi_tenant_batch_is_bitwise_the_reference(train, priorities,
                                                           batch_sizes):
    rng = np.random.default_rng(5)
    ref_tobs, tobs, ref_iobs, iobs = _mt_obs(9)
    vals = [(float(rng.choice([5.0, rng.uniform(15, 55)])),
             float(rng.choice([20.0, rng.uniform(5, 60)])),
             float(rng.choice([20.0, rng.uniform(5, 60)])),
             float(rng.uniform(0.1, 1.0)), float(rng.uniform(0.1, 1.0)))
            for _ in range(30)]
    pp = _mt_problems(P, vals, train, priorities, batch_sizes)
    rp = _mt_problems(RP, vals, train, priorities, batch_sizes)
    got = G.solve_multi_tenant_batch(pp, tobs if train else None, iobs,
                                     backend="cpu")
    assert _as(got) == _as(RG.solve_multi_tenant_batch(
        rp, ref_tobs if train else None, ref_iobs))
    assert _as(got) == _as([P.solve_multi_tenant(pr, tobs if train else None,
                                                 iobs) for pr in pp])
    assert any(s is None for s in got) and any(s is not None for s in got)


def test_multi_tenant_batch_needs_a_uniform_stream_shape():
    _, tobs, _, iobs = _mt_obs(40)
    a = P.MultiTenantProblem(30.0, (P.StreamSpec(10.0, 0.5, "mobilenet"),
                                    P.StreamSpec(10.0, 0.5, "lstm")))
    b = dataclasses.replace(a, train=False)
    with pytest.raises(ValueError, match="uniform"):
        G.solve_multi_tenant_batch([a, b], tobs, iobs, backend="cpu")
    with pytest.raises(ValueError, match="observation sets"):
        G.solve_multi_tenant_batch([a], tobs, iobs[:1], backend="cpu")
    assert G.solve_multi_tenant_batch([], tobs, iobs, backend="cpu") == []


def test_empty_observations_and_problems():
    assert G.solve_train_batch([P.TrainProblem(30.0)], {},
                               backend="cpu") == [None]
    assert G.solve_infer_batch([], {}, backend="cpu") == []
    assert G.solve_concurrent_batch([P.ConcurrentProblem(30.0, 1.0, 60.0)],
                                    {}, {}, backend="cpu") == [None]


@pytest.mark.parametrize("solver", ["train", "infer", "concurrent", "fleet",
                                    "multi"])
def test_chunked_solves_equal_one_chunk_and_count_each_chunk(solver,
                                                             monkeypatch):
    rng = np.random.default_rng(10)
    oracle = Oracle(DEV, SPACE)
    w_tr, w_in = TRAIN_WORKLOADS["resnet18"], INFER_WORKLOADS["mobilenet"]
    n = 64
    if solver == "train":
        probs = [P.TrainProblem(float(b)) for b in rng.uniform(5, 60, n)]
        run = lambda: oracle.solve_train_batch(w_tr, probs, "cpu")
        width = len(MODES)
    elif solver in ("infer", "fleet"):
        ts, ps, rows, his = _fleet_case(rng, n)
        probs = [P.InferProblem(*r) for r in rows]
        grid = oracle.infer_grid(w_in)
        run = (lambda: oracle.solve_infer_batch(w_in, probs, "cpu")) \
            if solver == "infer" else (lambda: G.solve_infer_fleet_batch(
                probs, his, grid, ts, ps, backend="cpu"))
        width = len(grid)
    elif solver == "concurrent":
        probs = [P.ConcurrentProblem(float(rng.uniform(10, 50)),
                                     float(rng.uniform(0.5, 2.0)),
                                     float(rng.uniform(30, 120)))
                 for _ in range(n)]
        run = lambda: oracle.solve_concurrent_batch(w_tr, w_in, probs, "cpu")
        width = len(oracle.infer_grid(w_in))
    else:
        _, tobs, _, iobs = _mt_obs(40)
        vals = [(float(rng.uniform(15, 55)), 20.0, 30.0, 0.6, 0.6)
                for _ in range(n)]
        probs = _mt_problems(P, vals, True, None, None)
        run = lambda: G.solve_multi_tenant_batch(probs, tobs, iobs,
                                                 backend="cpu")
        width = G._MultiCandidates([G.as_infer_grid(o) for o in iobs],
                                   G.as_train_grid(tobs),
                                   probs[0].streams).K * 2
    whole = run()
    monkeypatch.setattr(G, "CHUNK_ELEMS", width * 16)   # 16 problems a chunk
    before = B.dispatch_count("solver")
    chunked = run()
    assert B.dispatch_count("solver") - before == n // 16
    assert _as(chunked) == _as(whole)


# ---------------------------------------------------------------------------
# the oracle: the dense 441 x 5 sweep == the reference and the scalar loops
# ---------------------------------------------------------------------------

def test_oracle_batch_is_bitwise_the_reference_and_the_scalar_loops():
    oracle, ref = Oracle(DEV, SPACE), RefOracle(REF_DEV, REF_SPACE)
    w_tr, w_in = TRAIN_WORKLOADS["mobilenet"], INFER_WORKLOADS["mobilenet"]
    rw_tr, rw_in = REF_TRAIN["mobilenet"], REF_INFER["mobilenet"]
    tobs = oracle.train_observations(w_tr)
    iobs = oracle.infer_observations(w_in)
    assert len(tobs) == 441 and len(iobs) == 441 * 5

    rp, pp = _problems("TrainProblem", [(float(b),) for b in range(8, 61, 4)])
    got = oracle.solve_train_batch(w_tr, pp, "cpu")
    assert _as(got) == _as(ref.solve_train_batch(rw_tr, rp))
    assert _as(got) == _as([P.solve_train(pr, tobs) for pr in pp])

    rows = [(float(b), lat, rate) for b in (12, 25, 40, 55)
            for lat in (0.05, 0.3, 1.0) for rate in (30.0, 60.0, 90.0)]
    rp, pp = _problems("InferProblem", rows)
    got = oracle.solve_infer_batch(w_in, pp, "cpu")
    assert _as(got) == _as(ref.solve_infer_batch(rw_in, rp))
    assert _as(got) == _as([P.solve_infer(pr, iobs) for pr in pp])

    rows = [(float(b), lat, rate) for b in (15, 30, 45)
            for lat in (0.5, 1.0, 2.0) for rate in (30.0, 60.0, 120.0)]
    rp, pp = _problems("ConcurrentProblem", rows)
    got = oracle.solve_concurrent_batch(w_tr, w_in, pp, "cpu")
    assert _as(got) == _as(ref.solve_concurrent_batch(rw_tr, rw_in, rp))
    assert _as(got) == _as([P.solve_concurrent(pr, tobs, iobs) for pr in pp])
    # single-problem forms are batches of one
    assert _as([oracle.solve_concurrent(w_tr, w_in, pp[4], "cpu")]) == \
        _as(got[4:5])
    assert _as([oracle.solve_infer(w_in, P.InferProblem(*rows[4]),
                                   "cpu")]) == \
        _as(ref.solve_infer_batch(rw_in, [RP.InferProblem(*rows[4])]))


def test_oracle_multi_tenant_is_bitwise_the_reference():
    specs = [("mobilenet", 40.0, 0.8), ("lstm", 60.0, 0.5),
             ("resnet50", 20.0, 1.5)]

    def probs(mod, table):
        return [mod.MultiTenantProblem(float(pb), tuple(
            mod.StreamSpec(r * rs, lat * ls, table[name])
            for name, r, lat in specs))
            for pb in (25, 45) for ls in (1.0, 2.0) for rs in (0.5, 1.0)]

    got = Oracle(DEV, SPACE).solve_multi_tenant_batch(
        TRAIN_WORKLOADS["resnet18"], probs(P, INFER_WORKLOADS), "cpu")
    ref = RefOracle(REF_DEV, REF_SPACE).solve_multi_tenant_batch(
        REF_TRAIN["resnet18"], probs(RP, REF_INFER))
    assert _as(got) == _as(ref)
    assert sum(s is not None for s in got) >= 4
    with pytest.raises(ValueError, match="workload"):
        Oracle(DEV, SPACE).solve_multi_tenant(
            None, P.MultiTenantProblem(30.0, (P.StreamSpec(1.0, 1.0),)),
            "cpu")


def test_oracle_true_lookups_match_the_device():
    oracle = Oracle(DEV, SPACE)
    w = INFER_WORKLOADS["resnet50"]
    pm = SPACE.midpoint()
    assert oracle.true_infer(w, pm, 16) == DEV.time_power(w, pm, 16)
    w_tr = TRAIN_WORKLOADS["yolov8n"]
    assert oracle.true_train(w_tr, pm) == DEV.time_power(w_tr, pm)
    off = pm.replace(cpuf=123)                  # off-grid: the device model
    assert oracle.true_train(w_tr, off) == DEV.time_power(w_tr, off)
    assert oracle.true_infer(w, off, 4) == DEV.time_power(w, off, 4)


def test_fulcrum_carries_an_oracle_over_its_device_and_space():
    f = Fulcrum(DEV, SPACE)
    assert isinstance(f.oracle, Oracle)
    assert f.oracle.device is DEV and f.oracle.space is SPACE


def test_the_default_backend_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    grid = G.materialize(DEV, TRAIN_WORKLOADS["lstm"], SPACE)
    with pytest.raises(RuntimeError, match="CUDA"):
        G.solve_train_batch([P.TrainProblem(30.0)], grid)
    with pytest.raises(RuntimeError, match="CUDA"):
        Oracle(DEV, SPACE).solve_train(TRAIN_WORKLOADS["lstm"],
                                       P.TrainProblem(30.0))
    with pytest.raises(ValueError, match="unknown backend"):
        G.solve_train_batch([P.TrainProblem(30.0)], grid, backend="numpy")
