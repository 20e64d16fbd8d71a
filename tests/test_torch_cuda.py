"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card of compute
capability 9.0 or newer, so on a CPU machine this file counts no pass. On a
Hopper machine (no jax needed) run::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances: the max-plus scan meets its plain version to the engine
tolerance of ``docs/exactness.md`` (it scans in another order), fills
within +-2; the sort and its counts are equal. Flash attention, forward
and backward, meets its plain version element by element, |got - want| <=
tol (|want| + scale): tol 1e-4 in float32 with the scale want's RMS (or
0.1, where that is smaller), tol 2e-2 in bf16 with a scale per row (a
query for O and dQ, a key for dK and dV): the RMS of that row of want,
floored at 0.05 x want's RMS and at 1e-3. The bf16 kernels feed the
tensor cores P and dS rounded to bf16; where a row's few large terms
cancel, that moves it by more than 2e-2 of its own small values. Both
backwards form rowsum(dO O) from the forward kernel's output. K3 is held
so at head dims from 1 to 256 (``WIDE_CASES``: ragged, windowed, and a B x
H past grid y's 65,535), each by the route its wrapper picks; the dense
model at head dims 96 and 256 (``head_dim_model``) serves and trains as
on the CPU, and 257 is refused with no launch. The SSD
chunk meets its plain version within rtol 2e-4, atol 1e-4
(``tests/test_kernels.py``'s tolerance), its backward element by element
within 2e-4 (|want| + max(RMS, 0.1)).
The engine's multi-tenant batches, windowed carry-ins, per-lane fleet
devices, a closed loop with shedding and a K = 8 fleet meet the CPU
backend to the same engine tolerance with the same decisions per window;
one tenant gives the pair path's bits. The batched grid solvers on the card
return the CPU backend's solutions bitwise.
The fused fleet window's kernel meets its plain version bitwise in every
selection, count, clock before the fold and admitted time, latencies and
the last completion within the engine tolerance, on both of ``route``'s
routes (rows up to ``STAGE_MAX_T`` arrivals staged in shared memory, longer
ones on the global rows, at the limit and one past it), on grids whose
entries tie, at bs = 1 and 64 alone, with batch sizes inside and outside
the kernel's quotient tables, where every judged batch drops, where drops
reach into carried prefixes, with no arrivals, and from 1 device to
2,000; ``serve_fleet(
fused=True)`` on the card makes the CPU backend's decisions with one
``fused_window`` launch per window and no K1 launch.
The tiled matmul meets its plain version within ``tests/test_kernels.py``'s
1e-3 (float32) and 3e-2 (bf16), by the route its wrapper picks (bf16
through TMA and wgmma where rows are 16-byte multiples, else mma.sync).
Float32 comparisons run with TF32 off for matrix products and cuDNN.
The sharded steps run once on a world of one NCCL rank through
``launch.ranks`` (reduced zamba2-1.2b, float32): logits within 1e-5 of the
unsharded steps' largest |logit|, K3 and K4 launched on the rank's
shards; and so does the sharded train step with remat: loss, grad norm
and every gradient leaf within 1e-5 of the unsharded step's, K3 and K4
twice per site or layer and their backwards once.
"""
import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import base as TC
from repro_torch.core import simulate as S
from repro_torch.core.device_model import INFER_WORKLOADS, TRAIN_WORKLOADS
from repro_torch.core.powermode import PowerModeSpace
from repro_torch.kernels import build
from repro_torch.kernels.fulcrum import fused_window as KF
from repro_torch.kernels.fulcrum import lane_sort as K2
from repro_torch.kernels.fulcrum.lane_sort import lane_sort, lane_sort_plain
from repro_torch.kernels.fulcrum.maxplus_scan import (maxplus_scan,
                                                      maxplus_scan_plain)
from repro_torch.kernels.flash_attention import flash_attention as K3
from repro_torch.kernels.ssd_scan import ssd_scan as K4
from repro_torch.kernels.tiled_matmul import tiled_matmul as K5
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import model as TM
from repro_torch.runtime.serving import GenerationServer

ENG_TOL = dict(rtol=1e-9, atol=1e-8)

pytestmark = pytest.mark.gpu


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a CUDA card of compute capability >= 9.0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _maxplus_case(rng, lanes, kmax):
    """Ragged +inf / 0 padded lanes with clocks, +inf t_tr and caps."""
    sizes = rng.integers(0, kmax + 1, lanes)
    K = max(int(sizes.max(initial=0)), 1)
    ready = np.full((lanes, K), np.inf)
    exec_t = np.zeros((lanes, K))
    for i, nsz in enumerate(sizes):
        ready[i, :nsz] = np.sort(rng.uniform(0.0, 5.0, nsz))
        exec_t[i, :nsz] = rng.uniform(0.01, 0.5, nsz)
    t_tr = np.where(rng.random(lanes) < 0.3, np.inf,
                    rng.uniform(0.05, 0.5, lanes))
    cap = np.where(rng.random(lanes) < 0.5, np.inf,
                   rng.integers(0, 5, lanes).astype(np.float64))
    clock = np.where(rng.random(lanes) < 0.5, 0.0,
                     rng.uniform(0.0, 2.0, lanes))
    return ready, exec_t, t_tr, cap, clock, sizes


def _sort_case(rng, lanes, reqs):
    mat = np.full((lanes, reqs), np.inf)
    for i in range(lanes):
        nsz = int(rng.integers(0, reqs + 1))
        mat[i, :nsz] = rng.uniform(1e-4, 10.0, nsz)
    return mat


@pytest.mark.parametrize("seed,lanes,kmax", [(0, 1, 16), (1, 7, 33),
                                             (2, 64, 5), (3, 17, 120),
                                             (4, 9, 300), (5, 3, 1000),
                                             (6, 40, 129)])
def test_cuda_maxplus_matches_plain(hopper, seed, lanes, kmax):
    rng = np.random.default_rng(seed)
    ready, exec_t, t_tr, cap, clock, sizes = _maxplus_case(rng, lanes, kmax)
    args = [torch.tensor(a, device=hopper)
            for a in (ready, exec_t, t_tr, cap, clock)]
    n0 = maxplus_scan.launches
    c, f = maxplus_scan(*args)
    torch.cuda.synchronize()
    assert maxplus_scan.launches == n0 + 1
    cp, fp = maxplus_scan_plain(*args)
    c, f, cp, fp = (x.cpu().numpy() for x in (c, f, cp, fp))
    for i, nsz in enumerate(sizes):
        np.testing.assert_allclose(c[i, :nsz], cp[i, :nsz], **ENG_TOL)
    assert np.all(np.abs(f - fp) <= 2)


@pytest.mark.parametrize("lanes,reqs,kind", [
    (1, 1, "ragged"), (9, 17, "ragged"), (33, 64, "ragged"),
    (37, 121, "ragged"), (3, 256, "ragged"), (3, 257, "ragged"),
    (4, 7263, "ragged"), (5, 16384, "ragged"), (2, 16384, "ragged"),
    (2, 16385, "ragged"), (1, 40000, "ragged"), (3, 70000, "ragged"),
    (6, 500, "ties"), (3, 300, "all_inf")])
def test_cuda_lane_sort_equals_plain(hopper, lanes, reqs, kind):
    """Ragged +inf-padded rows; "ties": every value one of 8 numbers;
    "all_inf": the first lane has no entry (all +inf)."""
    rng = np.random.default_rng(lanes * reqs)
    if kind == "ties":
        mat = rng.choice(rng.uniform(1e-4, 10.0, 8), (lanes, reqs))
    else:
        mat = _sort_case(rng, lanes, reqs)
    if kind == "all_inf":
        mat[0] = np.inf
    mat = torch.tensor(mat, device=hopper)
    budgets = torch.tensor(rng.uniform(0.1, 5.0, lanes), device=hopper)
    n0, r0 = lane_sort.launches, lane_sort.routes[K2.route(reqs)]
    srt, viol = lane_sort(mat, budgets)
    torch.cuda.synchronize()
    assert lane_sort.launches == n0 + 1
    assert lane_sort.routes[K2.route(reqs)] == r0 + 1
    srt_p, viol_p = lane_sort_plain(mat, budgets)
    assert torch.equal(srt, srt_p) and torch.equal(viol, viol_p)
    assert torch.equal(lane_sort(mat), srt_p)


def test_cuda_lane_sort_launcher_takes_the_wrappers_route(hopper):
    lib = build.load("lane_sort", K2._SIGNATURES)
    for R in (1, 31, 121, 512, 513, 7263, 16384, 16385, 4 << 20):
        assert K2.ROUTES[lib.lane_sort_route(R)] == K2.route(R)


def test_cuda_wrappers_raise_on_inputs_the_kernels_do_not_take(hopper):
    r = torch.zeros((2, 4), dtype=torch.float64, device=hopper)
    v = torch.zeros(2, dtype=torch.float64, device=hopper)
    with pytest.raises(TypeError, match="float64"):
        maxplus_scan(r.float(), r.float(), v, v, v)
    with pytest.raises(ValueError, match="is on"):
        maxplus_scan(r, r, v.cpu(), v, v)
    with pytest.raises(TypeError, match="float64"):
        lane_sort(r.float())


def test_cuda_engine_matches_cpu_engine(hopper):
    rng = np.random.default_rng(12)
    modes = PowerModeSpace().all_modes()
    pms = [modes[int(rng.integers(len(modes)))] for _ in range(13)]
    bss = [int(b) for b in rng.choice([1, 4, 16, 32, 64], 13)]
    traces = [S.ArrivalTrace.poisson(float(rng.uniform(10, 90)), 20.0, seed=i)
              for i in range(13)]
    caps = [None if rng.random() < 0.6 else int(rng.integers(0, 4))
            for _ in range(13)]
    args = (S.DeviceModel(), TRAIN_WORKLOADS["resnet18"],
            INFER_WORKLOADS["mobilenet"], pms, bss, traces)
    got = S.simulate_batch(*args, tau_caps=caps, backend="cuda")
    ref = S.simulate_batch(*args, tau_caps=caps, backend="cpu")
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.latencies, a.latencies, **ENG_TOL)
        assert abs(a.train_minibatches - b.train_minibatches) <= 2
        np.testing.assert_array_equal(b._sorted, np.sort(b.latencies))


@pytest.mark.parametrize("counts", [(1, 2, 4), (4, 1, 3, 2, 1), (2,) * 20])
def test_cuda_multi_tenant_batch_matches_cpu(hopper, counts):
    """Lanes of 1, 2, 3 and 4 tenants in one batch, with carried per-stream
    queue states: K1 on per-event service times, K2 over every stream."""
    rng = np.random.default_rng(len(counts))
    modes = PowerModeSpace().all_modes()
    names = list(INFER_WORKLOADS)
    ws, pms, bsss, tracess, carries = [], [], [], [], []
    for i, n in enumerate(counts):
        ws.append([INFER_WORKLOADS[names[int(rng.integers(5))]]
                   for _ in range(n)])
        pms.append(modes[int(rng.integers(len(modes)))])
        bsss.append([int(b) for b in rng.choice([1, 4, 16, 32], n)])
        tracess.append([S.ArrivalTrace.poisson(float(rng.uniform(5, 60)),
                                               20.0, seed=7 * i + j)
                        .shifted(1.0) for j in range(n)])
        k = int(rng.integers(0, 6))
        carries.append(S.QueueState(np.sort(rng.uniform(0.0, 0.5, k)),
                                    float(rng.uniform(0.0, 1.5)),
                                    rng.integers(0, n, k)))
    args = (S.DeviceModel(), TRAIN_WORKLOADS["resnet18"], ws, pms, bsss,
            tracess)
    got = S.simulate_multi_tenant_batch(*args, carry_ins=carries,
                                        backend="cuda")
    ref = S.simulate_multi_tenant_batch(*args, carry_ins=carries,
                                        backend="cpu")
    for a, b in zip(ref, got):
        assert len(b.streams) == len(a.streams)
        for ra, rb in zip(a.streams, b.streams):
            np.testing.assert_allclose(rb.latencies, ra.latencies, **ENG_TOL)
            np.testing.assert_array_equal(rb._sorted, np.sort(rb.latencies))
        assert abs(a.train_minibatches - b.train_minibatches) <= 2
        assert b.queue_state.pending.tolist() == \
            a.queue_state.pending.tolist()


def test_cuda_single_tenant_run_is_bitwise_the_pair_path(hopper):
    """One tenant feeds K1 the pair path's inputs: the same bits on the
    card, latencies, sorted cache and training count."""
    modes = PowerModeSpace().all_modes()
    dev, w_tr = S.DeviceModel(), TRAIN_WORKLOADS["mobilenet"]
    for i, (name, bs) in enumerate([("mobilenet", 4), ("lstm", 16),
                                    ("resnet50", 1)]):
        w, pm = INFER_WORKLOADS[name], modes[37 * i]
        trace = S.ArrivalTrace.poisson(40.0, 30.0, seed=i).shifted(1.0)
        carry = S.QueueState(np.array([0.2, 0.4]), 1.3)
        pair = S.simulate(dev, w_tr, w, pm, bs, trace, tau_cap=2,
                          carry_in=carry, backend="cuda")
        multi = S.simulate_multi_tenant(dev, w_tr, [w], pm, [bs], [trace],
                                        tau_cap=2, carry_in=carry,
                                        backend="cuda")
        rep = multi.streams[0]
        assert np.asarray(rep.latencies).tobytes() == \
            np.asarray(pair.latencies).tobytes()
        assert rep.sorted_latencies.tobytes() == \
            pair.sorted_latencies.tobytes()
        assert multi.train_minibatches == pair.train_minibatches
        assert multi.queue_state.clock == pair.queue_state.clock


def test_cuda_windowed_carryover_matches_the_long_trace(hopper):
    """A trace replayed as windows chained through queue states on the
    card meets its one-call replay within the engine tolerance."""
    dev, pm = S.DeviceModel(), PowerModeSpace().all_modes()[123]
    w_tr, w_in = TRAIN_WORKLOADS["resnet18"], INFER_WORKLOADS["mobilenet"]
    trace = S.ArrivalTrace.poisson(70.0, 40.0, seed=5)
    long = S.simulate(dev, w_tr, w_in, pm, 8, trace, tau_cap=3,
                      backend="cuda")
    carry, lats, trained = None, [], 0
    for k in range(4):
        hi = (k + 1) * 10.0 if k < 3 else 41.0
        rep = S.simulate(dev, w_tr, w_in, pm, 8, trace.clip(k * 10.0, hi),
                         tau_cap=3, carry_in=carry, backend="cuda")
        carry = rep.queue_state
        lats.extend(np.asarray(rep.latencies).tolist())
        trained += rep.train_minibatches
    np.testing.assert_allclose(lats, long.latencies, **ENG_TOL)
    assert abs(trained - long.train_minibatches) <= 2 * 4
    assert carry.pending.tolist() == long.queue_state.pending.tolist()
    assert abs(carry.clock - long.queue_state.clock) < 1e-7


def test_cuda_closed_loop_shed_matches_cpu(hopper):
    """The burst case with shedding (resnet50, 40 W, 0.1 s, Poisson 45 /
    60 / 180 / 50 req/s over 30 s windows) on the card and on the CPU: the
    same decisions per window, latencies within the engine tolerance."""
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.core.scheduler import Fulcrum
    cfg = ControllerConfig(rate_estimator="ewma", rate_margin=1.5,
                           feedback=True, carry_backlog=True,
                           burst_quantile=0.95, split_backlog=64,
                           mode_switch_s=0.5, admission="shed")
    runs = [Fulcrum(S.DeviceModel()).serve_dynamic(
        INFER_WORKLOADS["resnet50"], 40.0, 0.1, [45.0, 60.0, 180.0, 50.0],
        window_duration=30.0, arrivals="poisson", seed=0, controller=cfg,
        backend=b) for b in ("cpu", "cuda")]
    for a, b in zip(*runs):
        assert (b.solution, b.replanned, b.splits, b.shed_requests,
                b.carried_requests, b.estimated_rate) == \
            (a.solution, a.replanned, a.splits, a.shed_requests,
             a.carried_requests, a.estimated_rate)
        if a.report is not None:
            np.testing.assert_allclose(b.report.latencies, a.report.latencies,
                                       **ENG_TOL)
    assert sum(w.shed_requests for w in runs[1]) > 0


def _solutions(sols):
    return [None if s is None else dataclasses.asdict(s) for s in sols]


def _solver_run(solver, n):
    """``run(backend)`` for one batched solver over ``n`` problems."""
    from repro_torch.core import grid_eval as G
    from repro_torch.core import problem as P
    from repro_torch.core.oracle import Oracle
    rng = np.random.default_rng(n)
    oracle = Oracle(S.DeviceModel())
    w_tr, w_in = TRAIN_WORKLOADS["resnet18"], INFER_WORKLOADS["mobilenet"]
    rows = [(float(rng.uniform(10, 55)), float(rng.uniform(0.05, 2.0)),
             float(rng.uniform(5, 150))) for _ in range(n)]
    if solver == "train":
        probs = [P.TrainProblem(r[0]) for r in rows]
        return lambda b: oracle.solve_train_batch(w_tr, probs, b)
    if solver == "infer":
        probs = [P.InferProblem(*r) for r in rows]
        return lambda b: oracle.solve_infer_batch(w_in, probs, b)
    if solver == "ties":
        # a grid of a few (t, p) values repeated: ties everywhere
        pool = [(0.05, 15.0), (0.2, 15.0), (0.05, 30.0), (0.02, 40.0)]
        modes = PowerModeSpace().all_modes()
        obs = {(pm, bs): pool[(i + bs) % 4]
               for i, pm in enumerate(modes) for bs in (1, 4, 16)}
        probs = [P.InferProblem(*r) for r in rows]
        return lambda b: G.solve_infer_batch(probs, obs, b)
    if solver == "concurrent":
        probs = [P.ConcurrentProblem(*r) for r in rows]
        return lambda b: oracle.solve_concurrent_batch(w_tr, w_in, probs, b)
    if solver == "fleet":
        probs = [P.InferProblem(*r) for r in rows]
        his = [r[2] * float(rng.uniform(1.0, 1.6)) for r in rows]
        ts, ps = rng.uniform(0.7, 1.3, n), rng.uniform(0.9, 1.1, n)
        grid = oracle.infer_grid(w_in)
        return lambda b: G.solve_infer_fleet_batch(probs, his, grid, ts, ps,
                                                   backend=b)
    train = solver == "multi_train"
    probs = [P.MultiTenantProblem(r[0], (
        P.StreamSpec(r[2] / 3.0, r[1], INFER_WORKLOADS["mobilenet"]),
        P.StreamSpec(r[2] / 2.0, r[1] / 2.0, INFER_WORKLOADS["lstm"])),
        train=train) for r in rows]
    return lambda b: oracle.solve_multi_tenant_batch(w_tr, probs, b)


@pytest.mark.parametrize("n", [1, 37, 300])
@pytest.mark.parametrize("solver", ["train", "infer", "ties", "concurrent",
                                    "fleet", "multi_train", "multi_infer"])
def test_cuda_solvers_are_bitwise_the_cpu_backend(hopper, solver, n):
    """Every batched grid solver on the card returns the CPU backend's
    solutions bitwise (and the CPU backend is the reference's NumPy tier,
    tests/test_torch_grid_eval.py): masked argmin / argmax, no
    reassociation, the first of equal values."""
    run = _solver_run(solver, n)
    got, ref = run("cuda"), run("cpu")
    assert _solutions(got) == _solutions(ref)
    assert any(s is not None for s in ref) or n == 1


def test_cuda_simulate_batch_with_per_lane_devices_matches_cpu(hopper):
    """Per-lane fleet devices: each lane's service time reaches K1 as its
    exec times; cuda within the engine tolerance of cpu."""
    from repro_torch.core.device_model import fleet_device
    rng = np.random.default_rng(3)
    modes = PowerModeSpace().all_modes()
    n = 21
    devs = [fleet_device(d, seed=3, time_spread=0.3) for d in range(n)]
    pms = [modes[int(i)] for i in rng.integers(0, len(modes), n)]
    bss = [int(b) for b in rng.choice([1, 4, 16, 32], n)]
    traces = [S.ArrivalTrace.poisson(float(rng.uniform(10, 90)), 8.0, seed=i)
              for i in range(n)]
    carries = [S.QueueState(np.sort(rng.uniform(0.0, 0.3, i % 4)),
                            float(rng.uniform(0.0, 0.5))) for i in range(n)]
    args = (S.DeviceModel(), None, INFER_WORKLOADS["mobilenet"], pms, bss,
            traces)
    got = S.simulate_batch(*args, carry_ins=carries, devices=devs,
                           backend="cuda")
    ref = S.simulate_batch(*args, carry_ins=carries, devices=devs,
                           backend="cpu")
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.latencies, a.latencies, **ENG_TOL)
        np.testing.assert_array_equal(b._sorted, np.sort(b.latencies))
        assert b.queue_state.pending.tolist() == \
            a.queue_state.pending.tolist()
        assert (b.power, b.attributed_power) == (a.power, a.attributed_power)


def test_cuda_fleet_window_matches_cpu(hopper):
    """The README's overload fleet (K = 8, mobilenet, 30 W, 0.1 s, shed,
    migration, a 216 W shared cap) on the card and on the CPU: per window
    the same dispatch, plans, shed / migrated counts and grants, latencies
    within the engine tolerance; one K1 and one K2 launch per window."""
    from repro_torch.core import fleet as F
    from repro_torch.core.controller import ControllerConfig
    spec = F.FleetSpec(8, seed=3, dispatch="least-backlog",
                       migrate_backlog=True, fleet_power_budget=216.0)
    cfg = ControllerConfig(rate_estimator="ewma", rate_margin=1.5,
                           feedback=True, carry_backlog=True,
                           burst_quantile=0.95, admission="shed")

    def serve(backend):
        return F.serve_fleet(INFER_WORKLOADS["mobilenet"], 30.0, 0.1,
                             [720.0, 1080.0, 240.0], spec,
                             window_duration=5.0, arrivals="poisson", seed=0,
                             controller=cfg, backend=backend)

    ref = serve("cpu")
    k1, k2 = maxplus_scan.launches, lane_sort.launches
    got = serve("cuda")
    assert (maxplus_scan.launches - k1, lane_sort.launches - k2) == (3, 3)
    for a, b in zip(ref, got):
        assert b.dispatch_counts.tolist() == a.dispatch_counts.tolist()
        assert (b.shed_requests, b.deferred_requests, b.migrated_requests) \
            == (a.shed_requests, a.deferred_requests, a.migrated_requests)
        assert b.power_budgets.tolist() == a.power_budgets.tolist()
        for da, db in zip(a.devices, b.devices):
            assert (db.solution is None) == (da.solution is None)
            if da.solution is None:
                continue
            pa, pb = (dataclasses.asdict(da.solution),
                      dataclasses.asdict(db.solution))
            ta, tb = pa.pop("time"), pb.pop("time")
            assert pb == pa and abs(tb - ta) <= 1e-8 + 1e-9 * ta
            np.testing.assert_allclose(db.report.latencies,
                                       da.report.latencies, **ENG_TOL)
    assert sum(w.shed_requests for w in got) > 0


# ---------------------------------------------------------------------------
# the fused fleet window (its CPU tests import the case generator and the
# fleet matrix from here: this file needs no jax)
# ---------------------------------------------------------------------------

FUSED_MATRIX = {    # tests/test_fleet.py's, name -> (spec, controller)
    "heterogeneous": (dict(time_spread=0.25, power_spread=0.15), dict()),
    "carried-backlog": (dict(), dict(rate_estimator="ewma",
                                     carry_backlog=True,
                                     mode_switch_s=0.25)),
    "shed": (dict(), dict(admission="shed", carry_backlog=True,
                          mode_switch_s=0.25)),
    "defer": (dict(dispatch="least-backlog"),
              dict(admission="defer", defer_cap=25, carry_backlog=True,
                   rate_estimator="ewma", rate_margin=1.5, feedback=True,
                   mode_switch_s=0.25)),
    "water-filled": (dict(migrate_backlog=True, fleet_power_budget=80.0),
                     dict(carry_backlog=True, feedback=True)),
}
# idle devices: rates so low whole windows dispatch nothing to some lanes
FUSED_RATES = {"idle": [2.0, 0.0, 1.0],
               "default": [60.0, 110.0, 25.0, 80.0]}


def fused_window_case(grid, seed, K=24, t0=6.0):
    """A random fleet window's ``fused_fleet_window`` arguments after the
    grid: power grants some of which nothing fits, tight feedback budgets
    (rung 4), interval plans (rungs 1 and 2), idle devices (est = 0),
    previous mode ids or none, carried prefixes from before t0 (admission
    rejects inside them), an empty device 0, clocks past t0."""
    from repro_torch.core.fused_window import grid_mode_ids
    rng = np.random.default_rng(seed)
    ids = grid_mode_ids(grid)
    ts, ps = rng.uniform(0.8, 1.25, K), rng.uniform(0.85, 1.15, K)
    pbud = rng.choice([10.0, 20.0, 30.0, 45.0], K)
    nominal = rng.choice([0.1, 0.3], K)
    bud = nominal * rng.choice([1.0, 0.6, 0.05], K, p=[0.5, 0.3, 0.2])
    est = rng.choice([0.0, 5.0, 30.0, 120.0, 250.0, 450.0], K) \
        * rng.uniform(0.7, 1.3, K)
    hi = est * rng.choice([0.9, 1.0, 1.3, 2.0], K)
    prev = np.where(rng.random(K) < 0.3, -1,
                    ids[rng.integers(0, len(ids), K)]).astype(np.int32)
    eff, n_carry, clock0 = [], np.zeros(K, np.int64), np.full(K, t0)
    for d in range(K):
        n = 0 if d == 0 else int(rng.integers(1, 4 * max(est[d], 10.0)))
        nc = int(rng.integers(0, min(n, 30) + 1)) if rng.random() < 0.5 \
            else 0
        eff.append(np.concatenate([np.sort(t0 - rng.uniform(0.0, 0.6, nc)),
                                   np.sort(t0 + rng.uniform(0.0, 3.0,
                                                            n - nc))]))
        n_carry[d] = nc
        if rng.random() < 0.5:
            clock0[d] = t0 + rng.uniform(0.0, 0.4)
    return (ts, ps, pbud, bud, nominal, est, hi, est > 0.0, prev, eff,
            n_carry, clock0, 0.25, 0.9 * 0.1)


def doubled_grid(grid, cls, how):
    """``grid`` (an ``ObservationGrid`` of the class ``cls``) with every
    entry twice, as two copies one after the other (``"concat"``) or each
    entry beside its copy (``"repeat"``): each lam ties with its copy's."""
    twice = (lambda x: np.concatenate([x, x])) if how == "concat" \
        else (lambda x: np.repeat(x, 2))
    modes = grid.modes * 2 if how == "concat" \
        else [m for m in grid.modes for _ in range(2)]
    return cls(modes, twice(grid.t), twice(grid.p), twice(grid.bs))


def _fused_grid(how=None):
    """mobilenet's inference grid, or ``doubled_grid`` of it."""
    from repro_torch.core import problem as P
    from repro_torch.core.grid_eval import ObservationGrid, materialize
    g = materialize(S.DeviceModel(), INFER_WORKLOADS["mobilenet"],
                    PowerModeSpace(), P.INFER_BATCH_SIZES)
    return g if how is None else doubled_grid(g, ObservationGrid, how)


def _fused_kernel_vs_plain(dev, grid, args, trims):
    """One window through the kernel and through the plain version on the
    card: every field bitwise but the fold's, which meets the tolerance."""
    from repro_torch.core import fused_window as FW
    rows = torch.from_numpy(FW.pack_window(*args[:7], args[11], args[7],
                                           args[8], args[9],
                                           args[10])).to(dev)
    t, p, bsf = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in
                 (grid.t, grid.p, grid.bs.astype(np.float64)))
    ids = torch.from_numpy(FW.grid_mode_ids(grid)).to(dev)
    call = (t, p, bsf, ids, rows, args[12], args[13], trims,
            FW._grid_max_bs(grid))
    n0 = KF.fused_window.launches
    got = KF.fused_window(*call)
    torch.cuda.synchronize()
    assert KF.fused_window.launches == n0 + 1
    want = KF.fused_window_plain(*call)
    g, w = (FW.unpack_window(x.cpu().numpy()) for x in (got, want))
    for f in KF.OUT_FIELDS:
        if f != "clock_out":
            assert g[f].tobytes() == w[f].tobytes(), f
    assert g["adm_times"].tobytes() == w["adm_times"].tobytes()
    np.testing.assert_allclose(g["latencies"], w["latencies"], **ENG_TOL)
    np.testing.assert_allclose(g["clock_out"], w["clock_out"], **ENG_TOL)
    return g


@pytest.mark.parametrize("trims", [True, False])
@pytest.mark.parametrize("K", [6, 64, 512])
def test_cuda_fused_window_matches_plain(hopper, K, trims):
    grid = _fused_grid()
    g = _fused_kernel_vs_plain(hopper, grid, fused_window_case(grid, K, K),
                               trims)
    assert g["solved"].any() and (g["n_rej"].any() == trims)


@pytest.mark.parametrize("how", ["concat", "repeat"])
def test_cuda_fused_window_ties_go_to_the_first_entry(hopper, how):
    grid = _fused_grid(how)
    args = fused_window_case(_fused_grid(), 3, 64)
    g = _fused_kernel_vs_plain(hopper, grid, args, True)
    assert g["solved"].any()


def test_cuda_fused_window_global_route(hopper):
    """Rows past the launcher's shared-memory staging limit: the serial
    part works on the global rows."""
    grid = _fused_grid()
    args = list(fused_window_case(grid, 5, 8))
    rng = np.random.default_rng(5)
    lib = build.load("fused_window", KF._SIGNATURES)
    stage_max_t = lib.fused_window_stage_max_t()
    assert stage_max_t == 12288                  # 2 T doubles <= 192 KiB
    big = stage_max_t + 700
    args[9] = list(args[9])
    for d in (1, 2, 3):
        args[9][d] = np.sort(6.0 + rng.uniform(0.0, 30.0, big - d))
        args[10][d] = 0
    args[5][1:4] = args[6][1:4] = 400.0          # plannable, busy
    args[7] = args[5] > 0.0
    args[2][1:4], args[3][1:4], args[4][1:4] = 45.0, 0.3, 0.3
    args[13] = 0.3                               # the admission budget
    g = _fused_kernel_vs_plain(hopper, grid, args, True)
    assert g["solved"][1:4].all() and g["n_adm"][1:4].max() > stage_max_t


def _assert_fleet_runs_close(ref, got):
    """Per window the same dispatch, shed / deferred / migrated counts,
    grants, plans and queue states; latencies and clocks within the engine
    tolerance."""
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        assert b.dispatch_counts.tolist() == a.dispatch_counts.tolist()
        assert (b.offered_requests, b.shed_requests, b.deferred_requests,
                b.migrated_requests) == (a.offered_requests,
                                         a.shed_requests,
                                         a.deferred_requests,
                                         a.migrated_requests)
        assert (None if b.power_budgets is None else
                b.power_budgets.tolist()) == \
            (None if a.power_budgets is None else a.power_budgets.tolist())
        for da, db in zip(a.devices, b.devices):
            assert (db.replanned, db.mode_switch_s, db.carried_requests,
                    db.shed_requests, db.deferred_requests,
                    db.estimated_rate) == \
                (da.replanned, da.mode_switch_s, da.carried_requests,
                 da.shed_requests, da.deferred_requests, da.estimated_rate)
            assert (db.solution is None) == (da.solution is None)
            if da.solution is None:
                continue
            pa, pb = (dataclasses.asdict(da.solution),
                      dataclasses.asdict(db.solution))
            ta, tb = pa.pop("time"), pb.pop("time")
            assert pb == pa and abs(tb - ta) <= 1e-8 + 1e-9 * abs(ta)
            np.testing.assert_allclose(db.report.latencies,
                                       da.report.latencies, **ENG_TOL)
            np.testing.assert_array_equal(db.report._sorted,
                                          np.sort(db.report.latencies))
            qa, qb = da.report.queue_state, db.report.queue_state
            assert qb.pending.tolist() == qa.pending.tolist()
            np.testing.assert_allclose(qb.clock, qa.clock, **ENG_TOL)


@pytest.mark.parametrize("case", sorted(FUSED_MATRIX))
def test_cuda_fused_fleet_matches_cpu(hopper, case):
    from repro_torch.core import fleet as F
    from repro_torch.core.controller import ControllerConfig
    spec_kw, cfg_kw = FUSED_MATRIX[case]
    rates = FUSED_RATES["idle" if case == "heterogeneous" else "default"]

    def serve(backend):
        return F.serve_fleet(INFER_WORKLOADS["mobilenet"], 30.0, 0.15, rates,
                             F.FleetSpec(6, seed=3, **spec_kw),
                             window_duration=3.0, arrivals="poisson",
                             seed=17, backend=backend, fused=True,
                             controller=ControllerConfig(**cfg_kw))

    ref = serve("cpu")
    k1, kf = maxplus_scan.launches, KF.fused_window.launches
    got = serve("cuda")
    assert KF.fused_window.launches - kf == len(rates)
    assert maxplus_scan.launches == k1
    _assert_fleet_runs_close(ref, got)


def test_cuda_fused_window_builds_once_across_shapes(hopper):
    """Windows of different K and T load one library, built once."""
    grid = _fused_grid()
    _fused_kernel_vs_plain(hopper, grid, fused_window_case(grid, 1, 3), True)
    lib = build._LIBS["fused_window"]
    path = build.library_path("fused_window")
    mtime = path.stat().st_mtime_ns
    for K in (1, 17, 200):
        _fused_kernel_vs_plain(hopper, grid, fused_window_case(grid, K, K),
                               K % 2 == 1)
    assert build._LIBS["fused_window"] is lib
    assert path.stat().st_mtime_ns == mtime
    assert len(list(path.parent.glob("libfused_window-*.so"))) >= 1


def grid_of_bs(grid, b):
    """``grid``'s entries of batch size ``b`` alone."""
    from repro_torch.core.grid_eval import ObservationGrid
    keep = np.flatnonzero(grid.bs == b)
    return ObservationGrid([grid.modes[i] for i in keep], grid.t[keep],
                           grid.p[keep], grid.bs[keep])


def scaled_bs_grid(grid, how):
    """``grid`` with its batch sizes times 4 (largest 256), times 5
    (largest 320) or plus one half."""
    from repro_torch.core.grid_eval import ObservationGrid
    bs = {"x4": grid.bs * 4, "x5": grid.bs * 5, "half": grid.bs + 0.5}[how]
    return ObservationGrid(list(grid.modes), grid.t, grid.p, bs)


def _long_rows(grid, seed, T):
    """``fused_window_case`` of 6 devices whose devices 1-3 are busy and
    plannable with T, T - 1 and T - 2 arrivals and no carried prefix."""
    args = list(fused_window_case(grid, seed, 6))
    rng = np.random.default_rng(seed)
    args[9] = list(args[9])
    for d in (1, 2, 3):
        args[9][d] = np.sort(6.0 + rng.uniform(0.0, 30.0, T + 1 - d))
        args[10][d] = 0
    args[5][1:4] = args[6][1:4] = 400.0
    args[7] = args[5] > 0.0
    args[2][1:4], args[3][1:4], args[4][1:4] = 45.0, 0.3, 0.3
    args[13] = 0.3
    return args


@pytest.mark.parametrize("trims", [True, False])
@pytest.mark.parametrize("bs", [1, 64])
def test_cuda_fused_window_at_one_batch_size(hopper, bs, trims):
    """A grid of one batch size: bs = 1 (every arrival is a batch, judged
    on its own) and the grid's largest, with latency budgets of 0.6 s and
    an admission budget of 0.3 s, so that devices plan at bs = 64 too."""
    grid = grid_of_bs(_fused_grid(), bs)
    args = list(fused_window_case(grid, 7, 48))
    args[3] = args[4] = np.full(48, 0.6)
    args[13] = 0.3
    g = _fused_kernel_vs_plain(hopper, grid, args, trims)
    s = g["solved"]
    assert s.any() and (grid.bs[g["sel"][s]] == bs).all()
    assert g["n_batches"][s].any() and g["n_rej"].any() == trims


@pytest.mark.parametrize("how", ["x4", "x5", "half"])
def test_cuda_fused_window_with_and_without_the_quotient_tables(hopper, how):
    """The ladder reads (bs - 1) / est, bs / est and the same over hi from
    per-block tables where bs is a whole number up to max_bs <= 256 (x4:
    max_bs 256, the tables' last entry), and divides where it is not (x5:
    max_bs 320; half: no whole bs); every rung decides some device."""
    grid = scaled_bs_grid(_fused_grid(), how)
    g = _fused_kernel_vs_plain(hopper, grid, fused_window_case(grid, 17, 48),
                               True)
    assert set(g["rung"].tolist()) == {0, 1, 2, 3, 4}
    assert g["n_batches"].any()


@pytest.mark.parametrize("bs", [None, 1])
def test_cuda_fused_window_where_every_judged_batch_drops(hopper, bs):
    """A zero admission budget: every member of every batch judged waits
    past it (t_in > 1e-12), so only a trailing partial batch is admitted,
    and at bs = 1 every arrival drops."""
    grid = _fused_grid() if bs is None else grid_of_bs(_fused_grid(), bs)
    args = list(fused_window_case(grid, 9, 32))
    args[13] = 0.0
    g = _fused_kernel_vs_plain(hopper, grid, args, True)
    s = g["solved"]
    n = np.array([len(v) for v in args[9]])
    assert s.any() and not g["n_batches"][s].any()
    assert (g["n_rej"][s] + g["n_adm"][s] == n[s]).all()
    assert (g["n_adm"][s] < grid.bs[g["sel"][s]]).all()
    if bs == 1:
        assert not g["n_adm"].any() and g["n_rej"][s].sum() == n[s].sum()


def test_cuda_fused_window_drops_reach_into_the_carried_prefix(hopper):
    grid = _fused_grid()
    args = fused_window_case(grid, 11, 64)
    g = _fused_kernel_vs_plain(hopper, grid, args, True)
    assert (g["n_carry_rej"] > 0).sum() > 1
    assert (g["n_carry_rej"] <= np.minimum(args[10], g["n_rej"])).all()


@pytest.mark.parametrize("trims", [True, False])
def test_cuda_fused_window_with_no_arrivals(hopper, trims):
    grid = _fused_grid()
    args = list(fused_window_case(grid, 1, 8))
    args[9] = [np.empty(0)] * 8
    args[10] = np.zeros(8, np.int64)
    g = _fused_kernel_vs_plain(hopper, grid, args, trims)
    assert g["solved"].any() and g["latencies"].shape == (8, 0)
    assert (g["clock_out"] == g["clock_in"]).all()


@pytest.mark.parametrize("extra", [0, 1])
def test_cuda_fused_window_at_the_staging_limit(hopper, extra):
    """Rows of exactly ``STAGE_MAX_T`` arrivals (the last staged length)
    and one more (the first on the global route), each launch on the
    route ``route`` names."""
    grid = _fused_grid()
    T = KF.STAGE_MAX_T + extra
    args = _long_rows(grid, 5 + extra, T)
    before = dict(KF.fused_window.routes)
    g = _fused_kernel_vs_plain(hopper, grid, args, True)
    from repro_torch.core import fused_window as FW
    way = KF.route(6, T, len(grid), FW._grid_max_bs(grid))
    assert way == ("staged", "global")[extra]
    assert {r: n - before[r] for r, n in KF.fused_window.routes.items()} \
        == {r: int(r == way) for r in KF.ROUTES}
    assert g["solved"][1:4].all() and g["n_rej"][1:4].any()
    assert g["n_adm"][1:4].max() > KF.STAGE_MAX_T - 100


@pytest.mark.parametrize("K", [1, 2000])
def test_cuda_fused_window_from_one_device_to_more_than_stay_resident(
        hopper, K):
    """One device (the K = 8 case's device 5, which plans, drops and
    commits), and 2,000: more blocks than the card holds at once."""
    grid = _fused_grid()
    args = fused_window_case(grid, 13, 8 if K == 1 else K)
    if K == 1:
        args = [a if np.isscalar(a) else a[5:6] for a in args]
    g = _fused_kernel_vs_plain(hopper, grid, args, True)
    assert g["solved"].any() and g["n_batches"].any() and g["n_rej"].any()


def test_cuda_fused_window_launcher_takes_the_wrappers_route(hopper):
    lib = build.load("fused_window", KF._SIGNATURES)
    assert lib.fused_window_stage_max_t() == KF.STAGE_MAX_T
    for T in (0, 1, KF.STAGE_MAX_T, KF.STAGE_MAX_T + 1, 1 << 30):
        for K, N, mb in ((0, 1, 1), (1, 2205, 64), (2000, 1, KF.MAX_RING)):
            assert KF.ROUTES[lib.fused_window_route(K, T, N, mb)] == \
                KF.route(K, T, N, mb)


def _attn_close(got, want, dtype, what):
    """K3's rule (the module's docstring): |got - want| <= tol (|want| +
    scale), per row in bf16. A limit tied to the largest |value|, or an
    atol of 2e-2 in bf16, would pass a kernel that scaled the small late
    outputs and gradients by 0.95."""
    if dtype == torch.float32:
        _close(got, want, 1e-4, what)
        return
    g, w = got.float(), want.float()
    rms = float(w.square().mean().sqrt())
    scale = w.square().mean(dim=-1, keepdim=True).sqrt().clamp_min(
        max(0.05 * rms, 1e-3))
    share = float(((g - w).abs() / (2e-2 * (w.abs() + scale))).max())
    assert share <= 1.0, f"{what}: {share} of the limit (RMS {rms})"


# D = 160 (stablelm-12b's head dim): the kernels' tiles are padded to 192
# columns; full and ragged tiles, windows, and the model's prefill shape
D160_CASES = [(1, 2, 256, 160, None), (2, 3, 300, 160, None),
              (1, 2, 300, 160, 64), (1, 1, 1, 160, None),
              (1, 2, 65, 160, 1), (4, 32, 512, 160, None)]
# every width from 1 to 256: the CUDA-core route below D = 8 in bf16, the
# zero-padded copy (1, 100), the column halves at width 256 (200, 256),
# ragged with a window and without; the reference's own test shape (D =
# 32); a B x H past grid y's 65,535
WIDE_DIMS = (1, 8, 32, 48, 80, 96, 100, 112, 192, 200, 256)
WIDE_CASES = ([(1, 2, 300, d, 64) for d in WIDE_DIMS]
              + [(2, 3, 129, d, None) for d in WIDE_DIMS]
              + [(2, 1, 256, 32, None), (1, 65600, 64, 64, None)])


@pytest.mark.parametrize("B,H,S,D,window", [
    (1, 2, 256, 64, None), (2, 3, 300, 64, None), (1, 2, 300, 128, 50),
    (1, 1, 1, 64, None), (2, 2, 129, 128, None), (1, 4, 1000, 64, 512),
    (1, 2, 65, 64, 1), (8, 32, 2048, 64, None)] + D160_CASES + WIDE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_matches_plain(hopper, B, H, S, D, window, dtype):
    gen = torch.Generator(device=hopper).manual_seed(B * S + D)
    q, k, v = (torch.randn((B, H, S, D), generator=gen, device=hopper)
               .to(dtype) for _ in range(3))
    n0 = K3.flash_attention.launches
    got = K3.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert K3.flash_attention.launches == n0 + 1
    assert got.dtype == dtype
    want = K3.flash_attention_plain(q, k, v, window=window)
    _attn_close(got, want, dtype, "O")


def test_cuda_flash_attention_refuses_misaligned_views(hopper):
    """The bf16 kernels load through TMA, which needs 16-byte aligned base
    addresses: a contiguous view at an odd offset raises, it never falls
    back."""
    flat = torch.randn(2 * 64 * 64 + 1, device=hopper).to(torch.bfloat16)
    bad = flat[1:].view(1, 2, 64, 64)
    good = flat[:-1].view(1, 2, 64, 64)
    assert bad.is_contiguous() and bad.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte"):
        K3.flash_attention(bad, good, good)
    out, lse = K3.flash_attention_fwd(good, good, good)
    with pytest.raises(ValueError, match="16-byte"):
        K3.flash_attention_bwd(good, good, good, out, lse, bad)


def _ssd_inputs(shape, dev, seed):
    b, nc, l, h, p, n = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    x = torch.randn((b, nc, l, h, p), generator=gen, **f32)
    dt = torch.nn.functional.softplus(
        torch.randn((b, nc, l, h), generator=gen, **f32) - 2.0)
    A = -(1.0 + 15.0 * torch.rand(h, generator=gen, **f32))
    B = torch.randn((b, nc, l, n), generator=gen, **f32)
    C = torch.randn((b, nc, l, n), generator=gen, **f32)
    return x, (dt * A).contiguous(), dt, B, C


@pytest.mark.parametrize("shape", [(2, 2, 256, 8, 64, 64),     # full width
                                   (1, 3, 32, 16, 32, 16),     # reduced
                                   (1, 1, 100, 2, 100, 128),
                                   (2, 1, 1, 3, 8, 4),
                                   # h not a multiple of the head group
                                   (1, 1, 100, 5, 100, 128),
                                   (1, 2, 256, 11, 64, 128)])
def test_cuda_ssd_chunk_matches_plain(hopper, shape):
    args = _ssd_inputs(shape, hopper, sum(shape))
    n0 = K4.ssd_chunk.launches
    y, st = K4.ssd_chunk(*args)
    torch.cuda.synchronize()
    assert K4.ssd_chunk.launches == n0 + 1
    yp, stp = K4.ssd_chunk_plain(*args)
    torch.testing.assert_close(y, yp, rtol=2e-4, atol=1e-4)
    torch.testing.assert_close(st, stp, rtol=2e-4, atol=1e-4)


def test_cuda_model_kernels_refuse_what_they_do_not_take(hopper):
    q = torch.zeros((1, 1, 8, 257), device=hopper)
    n0 = K3.flash_attention.launches
    with pytest.raises(ValueError, match="MAX_HEAD_DIM = 256"):
        K3.flash_attention(q, q, q)
    assert K3.flash_attention.launches == n0
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K3.flash_attention(q.half(), q.half(), q.half())
    for shape in [(1, 1, 300, 1, 8, 8), (1, 1, 8, 1, 200, 8),
                  (1, 1, 8, 1, 8, 129)]:
        with pytest.raises(ValueError, match="takes chunks up to"):
            K4.ssd_chunk(*_ssd_inputs(shape, hopper, 0))


def test_cuda_generation_matches_cpu_on_the_reduced_model(hopper):
    cfg = dataclasses.replace(TC.reduced(TC.get_config("zamba2-1.2b")),
                              compute_dtype=torch.float32)
    gpu = GenerationServer(cfg, max_seq=80, bs=2, backend="cuda")
    cpu = GenerationServer(cfg, max_seq=80, bs=2, backend="cpu",
                           params=gpu.params)
    toks = torch.randint(0, cfg.vocab_size, (2, 70), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    lg, _ = gpu.prefill({"tokens": toks})
    lc, _ = cpu.prefill({"tokens": toks})
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(gpu.generate({"tokens": toks}, 8, 70),
                                  cpu.generate({"tokens": toks}, 8, 70))


FAMILIES = ["stablelm-1.6b", "minitron-4b", "qwen2.5-14b", "stablelm-12b",
            "mamba2-780m", "internvl2-1b", "musicgen-medium"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_cuda_family_generation_matches_cpu_on_the_reduced_model(hopper,
                                                                 arch):
    """The dense, ssm, vlm and audio families' reduced models in float32
    on cuda (K3 / K4) against cpu: prefill logits within 1e-3, 8 greedy
    tokens equal, every attention or Mamba2 layer launching its kernel
    once per prefill."""
    cfg = dataclasses.replace(TC.reduced(TC.get_config(arch)),
                              compute_dtype=torch.float32)
    gpu = GenerationServer(cfg, max_seq=80, bs=2, backend="cuda")
    cpu = GenerationServer(cfg, max_seq=80, bs=2, backend="cpu",
                           params=gpu.params)
    prompt = TC.make_batch(cfg, 70, 2, "prefill",
                           torch.Generator().manual_seed(1))
    kernel = K4.ssd_chunk if cfg.arch_type == "ssm" else K3.flash_attention
    n0 = kernel.launches
    lg, _ = gpu.prefill(prompt)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + cfg.num_layers
    lc, _ = cpu.prefill(prompt)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(gpu.generate(prompt, 8, 70),
                                  cpu.generate(prompt, 8, 70))


MOE_ARCHS = ["mixtral-8x22b", "arctic-480b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_cuda_moe_generation_matches_cpu_on_the_reduced_model(hopper, arch):
    """The reduced MoE models in float32 on cuda against cpu, a 70-token
    prompt past Mixtral's reduced window of 64: prefill logits within
    1e-3, 8 greedy tokens equal, one K3 launch per layer per prefill."""
    cfg = dataclasses.replace(TC.reduced(TC.get_config(arch)),
                              compute_dtype=torch.float32)
    gpu = GenerationServer(cfg, max_seq=80, bs=2, backend="cuda")
    cpu = GenerationServer(cfg, max_seq=80, bs=2, backend="cpu",
                           params=gpu.params)
    assert gpu.params["layers"][0]["moe"]["router"].dtype == torch.float32
    prompt = TC.make_batch(cfg, 70, 2, "prefill",
                           torch.Generator().manual_seed(4))
    n0 = K3.flash_attention.launches
    lg, _ = gpu.prefill(prompt)
    torch.cuda.synchronize()
    assert K3.flash_attention.launches == n0 + cfg.num_layers
    lc, _ = cpu.prefill(prompt)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(gpu.generate(prompt, 8, 70),
                                  cpu.generate(prompt, 8, 70))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_cuda_moe_apply_is_deterministic_and_matches_cpu(hopper, arch,
                                                         capacity_factor):
    """``moe_apply`` on cuda equals itself bitwise over two runs (its
    dispatch writes distinct indices only: no atomics) and meets cpu
    within 1e-3 with the same routing and drops, in float32, at s = 300
    (two dispatch groups a row)."""
    cfg = dataclasses.replace(TC.reduced(TC.get_config(arch)),
                              compute_dtype=torch.float32,
                              capacity_factor=capacity_factor)
    spec = cfg.moe_spec
    pg = TM.init_params(cfg, torch.Generator(device=hopper).manual_seed(5),
                        hopper)["layers"][0]["moe"]
    pc = T.tree_map(lambda t: t.cpu(), pg)
    x = torch.randn((4, 300, cfg.d_model),
                    generator=torch.Generator().manual_seed(6))
    y1, aux1 = TM.L.moe_apply(pg, x.to(hopper), spec)
    y2, aux2 = TM.L.moe_apply(pg, x.to(hopper), spec)
    assert torch.equal(y1, y2) and torch.equal(aux1, aux2)
    yc, auxc = TM.L.moe_apply(pc, x, spec)
    torch.testing.assert_close(y1.cpu(), yc, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(aux1.cpu(), auxc, rtol=1e-5, atol=1e-6)
    xg = x.reshape(8, 150, cfg.d_model)
    rg = TM.L.moe_route(pg["router"], xg.to(hopper), spec)
    rc = TM.L.moe_route(pc["router"], xg, spec)
    assert torch.equal(rg.expert.cpu(), rc.expert)
    assert torch.equal(rg.keep.cpu(), rc.keep)
    if capacity_factor == 0.5:
        assert int((~rc.keep).sum()) > 0


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_cuda_moe_apply_matches_cpu_over_arctic_experts(hopper,
                                                        capacity_factor):
    """Arctic's routing at its served size, 128 experts over one group of
    512 tokens a row (10 slots an expert, 4 at factor 0.5), at the reduced
    width in float32: each choice's expert, queue position and keep mask
    equal to cpu's in every group with no choice within 1e-6 of a tie,
    choices dropped, y within 1e-3."""
    cfg = dataclasses.replace(TC.reduced(TC.get_config("arctic-480b")),
                              compute_dtype=torch.float32, n_experts=128,
                              moe_group_size=1024,
                              capacity_factor=capacity_factor)
    spec = cfg.moe_spec
    pg = TM.init_params(cfg, torch.Generator(device=hopper).manual_seed(9),
                        hopper)["layers"][0]["moe"]
    pc = T.tree_map(lambda t: t.cpu(), pg)
    x = torch.randn((4, 512, cfg.d_model),
                    generator=torch.Generator().manual_seed(10))
    rg = TM.L.moe_route(pg["router"], x.to(hopper), spec)
    rc = TM.L.moe_route(pc["router"], x, spec)
    assert rc.capacity == {1.25: 10, 0.5: 4}[capacity_factor]
    top = rc.probs.sort(dim=-1, descending=True).values[..., :3]
    gaps = top[..., :-1] - top[..., 1:]
    held = ((gaps <= 1e-6) & (gaps > 0)).sum(dim=(1, 2)) == 0
    assert held.any()
    for name in ("expert", "pos", "keep"):
        assert torch.equal(getattr(rg, name).cpu()[held],
                           getattr(rc, name)[held])
    assert int((~rc.keep).sum()) > 0
    yg, _ = TM.L.moe_apply(pg, x.to(hopper), spec)
    yc, _ = TM.L.moe_apply(pc, x, spec)
    torch.testing.assert_close(yg.cpu()[held], yc[held], rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_cuda_moe_training_step_matches_cpu(hopper, arch):
    """A narrow MoE copy at the full configuration's GQA (Mixtral's 6,
    Arctic's 7) and head dim 128, remat on, in float32: one training
    step on cuda launches K3's forward twice a layer (remat) and its
    backward once; loss, xent and the moe aux within 1e-4 of cpu's,
    every gradient leaf within 1e-3 of its largest |g|."""
    full = TC.get_config(arch)
    group = full.n_heads // full.n_kv_heads
    cfg = dataclasses.replace(TC.reduced(full), d_model=group * 128,
                              n_heads=group, n_kv_heads=1, head_dim=128,
                              compute_dtype=torch.float32, remat=True)
    base = TM.init_params(cfg, torch.Generator(device=hopper).manual_seed(11),
                          hopper)
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 101))
    out = {}
    for dev in (hopper, torch.device("cpu")):
        params = T.tree_map(lambda t: t.detach().to(dev).clone()
                            .requires_grad_(), base)
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).int().to(dev),
                 "labels": torch.from_numpy(toks[:, 1:]).int().to(dev)}
        n0 = (K3.flash_attention.launches, K3.flash_attention_bwd.launches)
        metrics, grads = loss_and_grads(params, batch, cfg)
        torch.cuda.synchronize()
        if dev.type == "cuda":
            assert (K3.flash_attention.launches,
                    K3.flash_attention_bwd.launches) == \
                (n0[0] + 2 * cfg.num_layers, n0[1] + cfg.num_layers)
        out[dev.type] = ({k: float(v) for k, v in metrics.items()},
                         [g.cpu() for g in T.leaves(grads)])
    (mg, gg), (mc, gc) = out["cuda"], out["cpu"]
    for k in ("loss", "xent", "moe_aux"):
        assert abs(mg[k] - mc[k]) <= 1e-4, (k, mg[k], mc[k])
    for a, b in zip(gg, gc):
        _near(a, b, 1e-3, "gradient")


def test_cuda_grouped_ssm_matches_cpu(hopper):
    """Two B/C groups: one K4 launch per group of heads in prefill, y and
    the states within 1e-3 of cpu; then one decode step."""
    spec = TM.L.SSMSpec(d_model=64, d_state=16, expand=2, head_dim=16,
                        n_groups=2, chunk=32)
    pc = TM._ssm_init(torch.Generator().manual_seed(7), spec, None)
    pg = T.tree_map(lambda t: t.to(hopper), pc)
    x = torch.randn((2, 70, 64), generator=torch.Generator().manual_seed(8))
    n0 = K4.ssd_chunk.launches
    yg, sg = TM.L.ssm_apply(pg, x.to(hopper), spec, return_state=True)
    torch.cuda.synchronize()
    assert K4.ssd_chunk.launches == n0 + 2
    yc, sc = TM.L.ssm_apply(pc, x, spec, return_state=True)
    torch.testing.assert_close(yg.cpu(), yc, rtol=1e-3, atol=1e-3)
    for name in ("conv", "ssm"):
        torch.testing.assert_close(sg[name].cpu(), sc[name], rtol=1e-3,
                                   atol=1e-3)
    x1 = torch.randn((2, 1, 64), generator=torch.Generator().manual_seed(9))
    dg, _ = TM.L.ssm_apply(pg, x1.to(hopper), spec, sg)
    dc, _ = TM.L.ssm_apply(pc, x1, spec, sc)
    torch.testing.assert_close(dg.cpu(), dc, rtol=1e-3, atol=1e-3)


def test_cuda_int8_cache_decodes_as_cpu(hopper):
    """The int8 KV cache on cuda against cpu: prefill logits within 1e-3
    and 8 greedy tokens equal on the reduced stablelm-1.6b."""
    cfg = dataclasses.replace(TC.reduced(TC.get_config("stablelm-1.6b")),
                              compute_dtype=torch.float32,
                              kv_cache_quant=True)
    gpu = GenerationServer(cfg, max_seq=80, bs=2, backend="cuda")
    cpu = GenerationServer(cfg, max_seq=80, bs=2, backend="cpu",
                           params=gpu.params)
    prompt = TC.make_batch(cfg, 70, 2, "prefill",
                           torch.Generator().manual_seed(2))
    lg, cache = gpu.prefill(prompt)
    assert cache["kv"]["k"].dtype == torch.int8
    torch.testing.assert_close(lg.cpu(), cpu.prefill(prompt)[0], rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_array_equal(gpu.generate(prompt, 8, 70),
                                  cpu.generate(prompt, 8, 70))


def _narrow_stablelm(head_dim):
    """stablelm-12b reduced to 2 layers of 2 heads at ``head_dim`` (its
    real one is 5120 / 32 = 160), in float32."""
    cfg = dataclasses.replace(TC.reduced(TC.get_config("stablelm-12b")),
                              d_model=2 * head_dim, n_heads=2, n_kv_heads=2,
                              head_dim=0, compute_dtype=torch.float32)
    assert cfg.resolved_head_dim == head_dim
    return cfg


def head_dim_model(M, name, **over):
    """``chip_smoke.HEAD_DIM_MODELS[name]`` as a ``ModelConfig`` of ``M``
    (the port's ``models.model`` or the reference's), narrowed to 2 layers
    of 2 heads at its head dim: d_model 192 for phi3-mini-widths (head dim
    d_model / heads = 96, as its own), 128 with ``head_dim`` 256 set for
    gemma-7b-widths (as its own sets it, wider than d_model), d_ff 256, a
    512-token vocabulary; ``over`` sets other fields."""
    cfg = smoke()[0].head_dim_config(M, name)
    narrow = dict(num_layers=2, n_heads=2, n_kv_heads=2, d_ff=256,
                  vocab_size=512, vocab_pad_multiple=128,
                  d_model=128 if cfg.head_dim else 2 * cfg.resolved_head_dim)
    return dataclasses.replace(cfg, **{**narrow, **over})


def _serves_as_cpu(dev, cfg):
    """A float32 ``cfg`` through K3 on cuda: its prefill launches K3 once a
    layer, its logits within 1e-3 of cpu's, 8 greedy tokens equal; one
    training step launches K3's backward once a layer, the loss within
    1e-4 and every gradient leaf within 1e-3 of its largest |g| of
    cpu's."""
    gpu = GenerationServer(cfg, max_seq=80, bs=2, backend="cuda")
    cpu = GenerationServer(cfg, max_seq=80, bs=2, backend="cpu",
                           params=gpu.params)
    prompt = TC.make_batch(cfg, 70, 2, "prefill",
                           torch.Generator().manual_seed(3))
    n0 = K3.flash_attention.launches
    lg, _ = gpu.prefill(prompt)
    torch.cuda.synchronize()
    assert K3.flash_attention.launches == n0 + cfg.num_layers
    torch.testing.assert_close(lg.cpu(), cpu.prefill(prompt)[0], rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_array_equal(gpu.generate(prompt, 8, 70),
                                  cpu.generate(prompt, 8, 70))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 101))
    out = {}
    for d in (dev, torch.device("cpu")):
        params = T.tree_map(lambda t: t.detach().float().to(d).clone()
                            .requires_grad_(), gpu.params)
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).int().to(d),
                 "labels": torch.from_numpy(toks[:, 1:]).int().to(d)}
        n0 = K3.flash_attention_bwd.launches
        metrics, grads = loss_and_grads(params, batch, cfg)
        torch.cuda.synchronize()
        if d.type == "cuda":
            assert K3.flash_attention_bwd.launches == n0 + cfg.num_layers
        out[d.type] = (float(metrics["loss"]),
                       [g.cpu() for g in T.leaves(grads)])
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    assert abs(lg - lc) <= 1e-4
    for a, b in zip(gg, gc):
        _near(a, b, 1e-3, "gradient")


def test_cuda_serves_head_dim_160_as_cpu(hopper):
    """stablelm-12b's head dim through K3 on cuda, as ``_serves_as_cpu``
    holds it."""
    _serves_as_cpu(hopper, _narrow_stablelm(160))


@pytest.mark.parametrize("name", ["phi3-mini-widths", "gemma-7b-widths"])
def test_cuda_serves_head_dims_96_and_256_as_cpu(hopper, name):
    """The dense block at phi-3-mini's head dim 96 and gemma-7b's 256
    (``head_dim_model``) through K3 on cuda, as ``_serves_as_cpu`` holds
    it."""
    cfg = head_dim_model(TM, name, compute_dtype=torch.float32)
    assert cfg.resolved_head_dim == {"phi3-mini-widths": 96,
                                     "gemma-7b-widths": 256}[name]
    _serves_as_cpu(hopper, cfg)


def test_cuda_refuses_head_dim_257_without_a_fallback(hopper):
    """A head dim past ``MAX_HEAD_DIM`` raises on cuda, naming the limit,
    and launches nothing: the wrapper at 257, and a server at 258 (RoPE
    takes even head dims only, so the model's path meets K3 at 258)."""
    assert K3.MAX_HEAD_DIM == 256
    q = torch.zeros((1, 2, 64, 257), dtype=torch.bfloat16, device=hopper)
    n0 = K3.flash_attention.launches
    with pytest.raises(ValueError, match=r"MAX_HEAD_DIM = 256, got 257"):
        K3.flash_attention(q, q, q)
    srv = GenerationServer(_narrow_stablelm(258), max_seq=40, bs=1,
                           backend="cuda")
    prompt = TC.make_batch(srv.cfg, 32, 1, "prefill",
                           torch.Generator().manual_seed(3))
    with pytest.raises(ValueError, match=r"MAX_HEAD_DIM = 256, got 258"):
        srv.prefill(prompt)
    assert K3.flash_attention.launches == n0


@pytest.mark.parametrize("shape", [(1, 2, 256, 48, 64, 128),
                                   (2, 1, 200, 48, 64, 128)])
def test_cuda_ssd_chunk_at_n128_matches_plain_both_ways(hopper, shape):
    """K4 at mamba2-780m's heads, head dim and state (48, 64, 128), full
    and partial chunks, forward and backward."""
    x, dA, dt, B, C = _ssd_inputs(shape, hopper, sum(shape) + 2)
    leaves = [t.clone().requires_grad_() for t in (x, dA, dt, B, C)]
    y, st = K4.ssd_chunk(*leaves)
    yp, stp = K4.ssd_chunk_plain(x, dA, dt, B, C)
    torch.testing.assert_close(y.detach(), yp, rtol=2e-4, atol=1e-4)
    torch.testing.assert_close(st.detach(), stp, rtol=2e-4, atol=1e-4)
    gen = torch.Generator(device=hopper).manual_seed(8)
    dy = torch.randn(y.shape, generator=gen, device=hopper)
    dst = torch.randn(st.shape, generator=gen, device=hopper)
    n0 = K4.ssd_chunk_bwd.launches
    torch.autograd.backward((y, st), (dy, dst))
    torch.cuda.synchronize()
    assert K4.ssd_chunk_bwd.launches == n0 + 1
    want = K4.ssd_chunk_bwd_plain(x, dA, dt, B, C, dy, dst)
    for name, leaf, w in zip(("x", "dA", "dt", "B", "C"), leaves, want):
        _close(leaf.grad, w, 2e-4, f"d{name}")


def _close(got, want, tol, what):
    """Element by element, |got - want| <= tol (|want| + scale), the scale
    being want's RMS or 0.1, whichever is larger (a kernel gradient that is
    exactly 0, as for a chunk of one step, has no scale of its own). A
    limit tied to the largest |value| would pass a kernel that zeroed the
    small gradients of late positions."""
    g, w = got.float(), want.float()
    scale = max(float(w.square().mean().sqrt()), 0.1)
    share = float(((g - w).abs() / (tol * (w.abs() + scale))).max())
    assert share <= 1.0, f"{what}: {share} of the limit (RMS {scale})"


def _near(got, want, tol, what):
    """|got - want| within ``tol`` of want's largest |value|."""
    scale = max(float(want.float().abs().max()), 1e-30)
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


@pytest.mark.parametrize("B,H,S,D,window", [
    (1, 2, 256, 64, None), (2, 3, 300, 64, None), (1, 2, 300, 128, 50),
    (1, 1, 1, 64, None), (2, 2, 129, 128, None), (1, 4, 1000, 64, 512),
    (1, 2, 65, 64, 1), (4, 32, 512, 64, None), (8, 32, 2048, 64, None)]
    + D160_CASES + WIDE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_bwd_matches_plain(hopper, B, H, S, D, window,
                                                dtype):
    gen = torch.Generator(device=hopper).manual_seed(B * S + D + 1)
    q, k, v, do = (torch.randn((B, H, S, D), generator=gen, device=hopper)
                   .to(dtype) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n0 = K3.flash_attention_bwd.launches
    out = K3.flash_attention(*leaves, window=window)
    out.backward(do)
    torch.cuda.synchronize()
    assert K3.flash_attention_bwd.launches == n0 + 1
    want = K3.flash_attention_bwd_plain(q, k, v, out.detach(), do, window)
    for name, leaf, w in zip("qkv", leaves, want):
        assert leaf.grad.dtype == dtype
        _attn_close(leaf.grad, w, dtype, f"d{name}")


@pytest.mark.parametrize("shape,scale", [((2, 2, 256, 8, 64, 64), 1.0),
                                         ((1, 2, 256, 4, 64, 64), 3.0),
                                         ((1, 3, 32, 16, 32, 16), 1.0),
                                         ((1, 1, 100, 2, 100, 128), 1.0),
                                         ((2, 1, 1, 3, 8, 4), 1.0)])
def test_cuda_ssd_chunk_bwd_matches_plain(hopper, shape, scale):
    """``scale`` 3 puts |cs| at the end of a 256-chunk in the hundreds."""
    x, dA, dt, B, C = _ssd_inputs(shape, hopper, sum(shape) + 1)
    dA = (dA * scale).contiguous()
    leaves = [t.clone().requires_grad_() for t in (x, dA, dt, B, C)]
    n0 = K4.ssd_chunk_bwd.launches
    y, st = K4.ssd_chunk(*leaves)
    gen = torch.Generator(device=hopper).manual_seed(7)
    dy = torch.randn(y.shape, generator=gen, device=hopper)
    dst = torch.randn(st.shape, generator=gen, device=hopper)
    torch.autograd.backward((y, st), (dy, dst))
    torch.cuda.synchronize()
    assert K4.ssd_chunk_bwd.launches == n0 + 1
    want = K4.ssd_chunk_bwd_plain(x, dA, dt, B, C, dy, dst)
    for name, leaf, w in zip(("x", "dA", "dt", "B", "C"), leaves, want):
        assert bool(torch.isfinite(leaf.grad).all()), name
        _close(leaf.grad, w, 2e-4, f"d{name}")


def test_cuda_forward_outputs_carry_a_gradient(hopper):
    """The kernels write their outputs through ctypes; without the autograd
    functions a CUDA forward would cut the gradient."""
    q = torch.randn((1, 2, 70, 64), device=hopper, requires_grad=True)
    out = K3.flash_attention(q, q.detach(), q.detach())
    assert out.grad_fn is not None
    x, dA, dt, B, C = _ssd_inputs((1, 1, 32, 2, 8, 4), hopper, 3)
    y, st = K4.ssd_chunk(x.requires_grad_(), dA, dt, B, C)
    assert y.grad_fn is not None and st.grad_fn is not None
    with torch.no_grad():
        assert K3.flash_attention(q, q, q).grad_fn is None


@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (256, 384, 128),
                                   (128, 256, 512), (100, 37, 53),
                                   (1, 1, 1), (257, 300, 129),
                                   (512, 2048, 1024), (1000, 776, 1528),
                                   (64, 8, 8), (1, (7, 8), 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tiled_matmul_matches_plain(hopper, M, K, N, dtype):
    """A ``K`` of (K, row) slices ``a`` from a buffer of rows ``row``
    values long: the one-row (1, 7) case has stride (8, 1) and is
    contiguous, and takes ``mma.sync`` in bf16."""
    K, row = K if isinstance(K, tuple) else (K, K)
    gen = torch.Generator(device=hopper).manual_seed(M + K + N)
    a = torch.randn((M + 1, row), generator=gen, device=hopper)
    a = a.to(dtype)[:M, :K]
    assert a.is_contiguous()
    b = torch.randn((K, N), generator=gen, device=hopper).to(dtype)
    way = K5.route(a, b)
    n0, r0 = K5.tiled_matmul.launches, K5.tiled_matmul.routes[way]
    got = K5.tiled_matmul(a, b)
    torch.cuda.synchronize()
    assert K5.tiled_matmul.launches == n0 + 1 and got.dtype == dtype
    assert K5.tiled_matmul.routes[way] == r0 + 1
    tol = 1e-3 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), K5.tiled_matmul_plain(a, b).float(),
                               rtol=tol, atol=tol)


def test_cuda_training_gradients_match_cpu_at_full_width(hopper):
    """Two layers of zamba2-1.2b at full width in float32, remat on: the
    loss within 1e-4 and each gradient leaf within 1e-3 of its largest
    |g| between the kernels and the plain versions."""
    cfg = dataclasses.replace(TC.get_config("zamba2-1.2b"), num_layers=2,
                              compute_dtype=torch.float32)
    base = TM.init_params(cfg, torch.Generator(device=hopper).manual_seed(0),
                          hopper)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (1, 301)).astype(np.int32)
    out = {}
    for dev in (hopper, torch.device("cpu")):
        params = T.tree_map(lambda t: t.detach().to(dev).clone()
                            .requires_grad_(), base)
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
                 "labels": torch.from_numpy(toks[:, 1:]).to(dev)}
        metrics, grads = loss_and_grads(params, batch, cfg)
        out[dev.type] = (float(metrics["loss"]),
                         [g.cpu() for g in T.leaves(grads)])
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    assert abs(lg - lc) <= 1e-4
    for a, b in zip(gg, gc):
        _near(a, b, 1e-3, "gradient")


# ---------------------------------------------------------------------------
# the fitted strategies: the NN predictor, RND-k, ALS, the closed loop
# ---------------------------------------------------------------------------

NN_TOL = 1e-5          # of the largest |prediction|, cuda against cpu


@functools.lru_cache(maxsize=None)
def smoke():
    """``chip_smoke.py`` loaded as a module, and the table of the port's
    modules that its data builders read: the one copy of the predictor's
    test data (``nn_case``, ``drift_case``)."""
    import importlib.util
    from repro_torch.core import nn_model, problem
    from repro_torch.core.device_model import DeviceModel
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, dict(NN=nn_model, P=problem, DeviceModel=DeviceModel,
                     PowerModeSpace=PowerModeSpace, TRAIN=TRAIN_WORKLOADS,
                     INFER=INFER_WORKLOADS)


def nn_data(width):
    """Profiles of 50 random modes (width 4: resnet18 training) or (mode,
    bs) pairs (width 5: mobilenet inference): features, times, powers, and
    the features of every key to predict."""
    mod, rt = smoke()
    return tuple(np.array(a) for a in mod.nn_case(rt, width))


@pytest.mark.parametrize("epochs", [10, 100])
@pytest.mark.parametrize("width", [4, 5])
def test_cuda_nn_predictor_matches_cpu(hopper, width, epochs):
    """From the same initial weights (drawn on the host) the card's fit
    predicts within 1e-5 of the largest |prediction| of the CPU's."""
    from repro_torch.core.nn_model import NNPredictor
    feats, t, p, every = nn_data(width)
    for y in (t, p):
        want = NNPredictor.fit(feats, y, epochs=epochs, backend="cpu")
        got = NNPredictor.fit(feats, y, epochs=epochs, backend="cuda")
        assert got.mean.is_cuda
        a, b = want.predict(every), got.predict(every)
        assert np.abs(b - a).max() <= NN_TOL * np.abs(a).max()


def _strategy_problems(P, scenario):
    if scenario == "train":
        return [P.TrainProblem(float(b)) for b in range(10, 51, 4)]
    if scenario == "infer":
        return [P.InferProblem(float(b), lat, float(r))
                for b in (15, 30, 45) for lat in (0.1, 0.4) for r in (30, 90)]
    if scenario == "concurrent":
        return [P.ConcurrentProblem(float(b), lat, float(r))
                for b in (15, 30, 45) for lat in (0.5, 2.0) for r in (30, 90)]
    return [P.MultiTenantProblem(float(b), (
        P.StreamSpec(40.0, 0.8, INFER_WORKLOADS["mobilenet"]),
        P.StreamSpec(60.0, 0.5, INFER_WORKLOADS["lstm"])))
        for b in (25, 40, 55)]


def _profiles(strat):
    """Every profile a strategy took, in order, with its run count and
    cost."""
    from repro_torch.core.scheduler import strategy_profilers
    top, profs = strategy_profilers(strat)
    return ([list(prof.cache.items()) for prof in profs], top.num_runs,
            top.profile_cost_s)


def _fitted(scenario, name, backend, **kw):
    from repro_torch.core import problem as P
    from repro_torch.core.scheduler import Fulcrum
    f = Fulcrum(backend=backend, **kw)
    probs = _strategy_problems(P, scenario)
    ws = (INFER_WORKLOADS["mobilenet"],) if scenario == "infer" else \
        (TRAIN_WORKLOADS["resnet18"],) if scenario == "train" else \
        (TRAIN_WORKLOADS["resnet18"], INFER_WORKLOADS["mobilenet"]) \
        if scenario == "concurrent" else \
        (TRAIN_WORKLOADS["resnet18"],) + tuple(s.workload
                                               for s in probs[0].streams)
    strat = f.strategy_for(scenario, name, *ws)
    return strat, probs, strat.solve_batch(probs)


@pytest.mark.parametrize("scenario,name", [
    ("train", "rnd50"), ("train", "rnd250"), ("infer", "rnd150"),
    ("infer", "rnd250"), ("concurrent", "rnd150"),
    ("multi_tenant", "rnd150")])
def test_cuda_rnd_is_bitwise_cpu(hopper, scenario, name):
    """RND-k profiles the same modes on either backend (Python's random),
    at the same cost, and the card's solvers answer bitwise."""
    got, _, sols = _fitted(scenario, name, "cuda")
    ref, _, ref_sols = _fitted(scenario, name, "cpu")
    assert _profiles(got) == _profiles(ref)
    assert _solutions(sols) == _solutions(ref_sols)
    assert any(s is not None for s in sols)


@pytest.mark.parametrize("scenario,name", [("train", "als50"),
                                           ("infer", "als145"),
                                           ("concurrent", "als145")])
def test_cuda_als_answers_violate_no_budget(hopper, scenario, name):
    """ALS fits its NNs on the card but answers from observed profiles
    only, so no answer breaks its budget by the ground truth."""
    from repro_torch.core import problem as P
    from repro_torch.core.device_model import DeviceModel
    from repro_torch.core.oracle import Oracle
    oracle = Oracle(DeviceModel())
    _, probs, sols = _fitted(scenario, name, "cuda", nn_epochs=100)
    w_tr, w_in = TRAIN_WORKLOADS["resnet18"], INFER_WORKLOADS["mobilenet"]
    assert any(s is not None for s in sols)
    for prob, sol in zip(probs, sols):
        if sol is None:
            continue
        if scenario == "train":
            assert oracle.true_train(w_tr, sol.pm)[1] <= prob.power_budget
            continue
        t, p = oracle.true_infer(w_in, sol.pm, sol.bs)
        if scenario == "concurrent":
            p = max(p, oracle.true_train(w_tr, sol.pm)[1])
        assert p <= prob.power_budget + 1e-9
        assert P.sustainable(sol.bs, prob.arrival_rate, t)
        assert P.peak_latency(sol.bs, prob.arrival_rate, t) <= \
            prob.latency_budget + 1e-9


def test_cuda_serve_dynamic_with_als145_launches_k1_and_k2(hopper):
    """The closed loop answered by one fitted ALS model (mobilenet, 30 W,
    0.1 s, the README's controller) replays its plans through K1 and K2,
    a plan in every window."""
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.core.scheduler import Fulcrum
    cfg = ControllerConfig(rate_estimator="ewma", rate_margin=1.5,
                           feedback=True, carry_backlog=True,
                           mode_switch_s=0.5)
    n1, n2 = maxplus_scan.launches, lane_sort.launches
    wins = Fulcrum(nn_epochs=100, backend="cuda").serve_dynamic(
        INFER_WORKLOADS["mobilenet"], 30.0, 0.1, [45.0, 60.0, 90.0, 50.0],
        "als145", window_duration=30.0, controller=cfg)
    assert maxplus_scan.launches > n1 and lane_sort.launches > n2
    assert all(w.solution is not None and w.report is not None
               for w in wins)


def test_cuda_sharded_steps_on_one_rank_match_the_unsharded_ones(hopper):
    """A world-1 NCCL run through ``launch.ranks`` of reduced zamba2-1.2b
    in float32 (``torch_pod_ranks.card_case``): the sharded prefill and 4
    decode steps within 1e-5 of the unsharded steps' largest |logit|, K3
    and K4 launched on the rank's shards."""
    from repro_torch.launch import ranks
    target = str(Path(__file__).with_name("torch_pod_ranks.py"))
    cfg = TC.reduced(TC.get_config("zamba2-1.2b"))
    (got,) = ranks.run(f"{target}:card_case",
                       {"arch": "zamba2-1.2b", "batch": 2, "prompt": 40,
                        "steps": 4}, 1, device="cuda", wall_s=300)
    worst = max(e / s for e, s in zip(got["err"], got["scale"]))
    print(f"sharded vs unsharded: largest difference {max(got['err'])}, "
          f"{worst} of the largest |logit|")
    assert worst <= 1e-5
    assert got["launches"] == {"flash_attention": cfg.n_attn_sites,
                               "ssd_chunk": cfg.num_layers}


def test_cuda_sharded_train_step_on_one_rank_matches_the_unsharded_one(
        hopper):
    """A world-1 NCCL run through ``launch.ranks`` of reduced zamba2-1.2b
    in float32 with remat (``torch_pod_ranks.card_train_case``): the
    sharded train step's loss, grad norm and every gradient leaf within
    1e-5 of the unsharded step's (of each leaf's largest |g|), K3 and K4
    launched on the rank's shards twice per site or layer (remat) and
    their backwards once."""
    from repro_torch.launch import ranks
    target = str(Path(__file__).with_name("torch_pod_ranks.py"))
    cfg = TC.reduced(TC.get_config("zamba2-1.2b"))
    (got,) = ranks.run(f"{target}:card_train_case",
                       {"arch": "zamba2-1.2b", "batch": 2, "seq": 40}, 1,
                       device="cuda", wall_s=300)
    print(f"sharded vs unsharded train step: {got}")
    assert got["loss"] <= 1e-5 and got["grad_norm"] <= 1e-5
    assert got["grads"] <= 1e-5
    sites, layers = cfg.n_attn_sites, cfg.num_layers
    assert got["launches"] == {"flash_attention": 2 * sites,
                               "flash_attention_bwd": sites,
                               "ssd_chunk": 2 * layers,
                               "ssd_chunk_bwd": layers}
