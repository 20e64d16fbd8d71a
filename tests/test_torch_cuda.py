"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card of compute
capability 9.0 or newer, so on a CPU machine this file counts no pass. On a
Hopper machine (no jax needed) run::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances: the max-plus scan meets its plain version to the engine
tolerance of ``docs/exactness.md`` (it scans in another order), fills
within +-2; the sort and its counts are equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import simulate as S
from repro_torch.core.device_model import INFER_WORKLOADS, TRAIN_WORKLOADS
from repro_torch.core.powermode import PowerModeSpace
from repro_torch.kernels.fulcrum.lane_sort import lane_sort, lane_sort_plain
from repro_torch.kernels.fulcrum.maxplus_scan import (maxplus_scan,
                                                      maxplus_scan_plain)

ENG_TOL = dict(rtol=1e-9, atol=1e-8)

pytestmark = pytest.mark.gpu


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a CUDA card of compute capability >= 9.0")
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


@pytest.mark.parametrize("lanes,reqs", [(1, 1), (9, 17), (33, 64),
                                        (5, 16384), (2, 16385),
                                        (1, 40000), (3, 70000)])
def test_cuda_lane_sort_equals_plain(hopper, lanes, reqs):
    rng = np.random.default_rng(lanes * reqs)
    mat = torch.tensor(_sort_case(rng, lanes, reqs), device=hopper)
    budgets = torch.tensor(rng.uniform(0.1, 5.0, lanes), device=hopper)
    n0 = lane_sort.launches
    srt, viol = lane_sort(mat, budgets)
    torch.cuda.synchronize()
    assert lane_sort.launches == n0 + 1
    srt_p, viol_p = lane_sort_plain(mat, budgets)
    assert torch.equal(srt, srt_p) and torch.equal(viol, viol_p)
    assert torch.equal(lane_sort(mat), srt_p)


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
