"""The port's two engine kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, which is held to the
Pallas kernel run in interpret mode under x64 — bitwise for the max-plus
scan (the same doubling in the same order) and equal for the sort — and to
the reference's oracles (``ref.py``) and an independent scalar replay within
the engine tolerance of ``docs/exactness.md`` (``ENG_TOL``; fills within
the floor-boundary slack of +-2 per lane). The cases mirror
``tests/test_kernels.py``: ragged lanes, carried clocks, ``+inf`` t_tr and
caps, empty edges.

The CUDA kernels themselves are held to these plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fulcrum.lane_sort import lane_sort as pallas_lane_sort
from repro.kernels.fulcrum.maxplus_scan import maxplus_scan as pallas_maxplus
from repro.kernels.fulcrum.ref import (lane_sort_ref, lane_violations_ref,
                                       maxplus_scan_ref)
from repro_torch.kernels.fulcrum.lane_sort import lane_sort
from repro_torch.kernels.fulcrum.lane_sort import route as lane_sort_route
from repro_torch.kernels.fulcrum.maxplus_scan import (maxplus_scan,
                                                      maxplus_scan_plain)

ENG_TOL = dict(rtol=1e-9, atol=1e-8)
MAXPLUS_CASES = [(0, 1, 16), (1, 7, 33), (2, 64, 5), (3, 17, 120)]
SORT_CASES = [(0, 1, 1), (1, 9, 17), (2, 33, 64), (3, 8, 100)]


def _maxplus_case(rng, lanes, kmax):
    """Ragged lanes padded the engine's way (+inf ready / 0 exec), with
    random nonzero clocks (backlog carryover) and +inf t_tr / tau_cap
    (no-training / uncapped lanes) — test_kernels.py's generator."""
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


def _maxplus_scalar(ready, exec_t, t_tr, cap, clock):
    """Independent oracle: the managed recurrence replayed event by event."""
    lanes, K = ready.shape
    c = np.empty((lanes, K))
    fills = np.zeros(lanes)
    for i in range(lanes):
        t = clock[i]
        for k in range(K):
            if np.isfinite(ready[i, k]):
                gap = ready[i, k] - t
                fills[i] += min(max(np.floor(gap / t_tr[i]), 0.0), cap[i])
            t = max(t, ready[i, k]) + exec_t[i, k]
            c[i, k] = t
    return c, fills


def _pallas_maxplus(*args):
    with jax.enable_x64(True):
        c, f = pallas_maxplus(*(jnp.asarray(a) for a in args), interpret=True)
        return np.asarray(c), np.asarray(f)


def _port_maxplus(*args, device="cpu"):
    c, f = maxplus_scan(*(torch.tensor(a, device=device) for a in args))
    return c.cpu().numpy(), f.cpu().numpy()


def _sort_case(rng, lanes, reqs):
    mat = np.full((lanes, reqs), np.inf)
    for i in range(lanes):
        nsz = int(rng.integers(0, reqs + 1))
        mat[i, :nsz] = rng.uniform(1e-4, 10.0, nsz)
    return mat


# ---------------------------------------------------------------------------
# max-plus scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,lanes,kmax", MAXPLUS_CASES)
def test_plain_maxplus_bitwise_equals_pallas(seed, lanes, kmax):
    rng = np.random.default_rng(seed)
    args = _maxplus_case(rng, lanes, kmax)[:5]
    c_p, f_p = _pallas_maxplus(*args)
    c, f = _port_maxplus(*args)
    np.testing.assert_array_equal(c, c_p)
    np.testing.assert_array_equal(f, f_p)


@pytest.mark.parametrize("seed,lanes,kmax", MAXPLUS_CASES)
def test_plain_maxplus_matches_ref_and_scalar(seed, lanes, kmax):
    rng = np.random.default_rng(seed)
    ready, exec_t, t_tr, cap, clock, sizes = _maxplus_case(rng, lanes, kmax)
    c, fills = _port_maxplus(ready, exec_t, t_tr, cap, clock)
    with jax.enable_x64(True):
        cr, fr = maxplus_scan_ref(*(jnp.asarray(a) for a in
                                    (ready, exec_t, t_tr, cap, clock)))
    cr, fr = np.asarray(cr), np.asarray(fr)
    cs, fs = _maxplus_scalar(ready, exec_t, t_tr, cap, clock)
    for i, nsz in enumerate(sizes):
        np.testing.assert_allclose(c[i, :nsz], cr[i, :nsz], **ENG_TOL)
        np.testing.assert_allclose(c[i, :nsz], cs[i, :nsz], **ENG_TOL)
    np.testing.assert_allclose(fills, fr, **ENG_TOL)
    assert np.all(np.abs(fills - fs) <= 2)     # floor-boundary slack


@pytest.mark.parametrize("shape", [(0, 4), (3, 0), (0, 0)])
def test_maxplus_empty_edges(shape):
    L, K = shape
    z = torch.zeros(L, dtype=torch.float64)
    c, f = maxplus_scan(torch.zeros(shape, dtype=torch.float64),
                        torch.zeros(shape, dtype=torch.float64), z, z, z)
    assert tuple(c.shape) == shape and tuple(f.shape) == (L,)
    assert not f.any()


def test_maxplus_wrapper_rejects_what_the_kernel_does_not_take():
    r = torch.zeros((2, 4), dtype=torch.float64)
    v = torch.zeros(2, dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        maxplus_scan(r.float(), r.float(), v, v, v)
    with pytest.raises(ValueError, match="contiguous"):
        maxplus_scan(torch.zeros((4, 2), dtype=torch.float64).t(), r, v, v, v)
    with pytest.raises(ValueError, match="one shape"):
        maxplus_scan(r, r[:, :2].contiguous(), v, v, v)
    with pytest.raises(ValueError, match="lanes"):
        maxplus_scan(r, r, v[:1], v, v)
    meta = torch.zeros((2, 4), dtype=torch.float64, device="meta")
    mv = torch.zeros(2, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        maxplus_scan(meta, meta, mv, mv, mv)


def test_cpu_tensors_take_the_plain_version_without_counting():
    n0 = maxplus_scan.launches
    rng = np.random.default_rng(5)
    args = [torch.tensor(a) for a in _maxplus_case(rng, 5, 9)[:5]]
    c, f = maxplus_scan(*args)
    cp, fp = maxplus_scan_plain(*args)
    assert torch.equal(c, cp) and torch.equal(f, fp)
    assert maxplus_scan.launches == n0      # only card launches count


# ---------------------------------------------------------------------------
# lane sort
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,lanes,reqs", SORT_CASES)
def test_plain_lane_sort_equals_pallas_and_numpy(seed, lanes, reqs):
    rng = np.random.default_rng(50 + seed)
    mat = _sort_case(rng, lanes, reqs)
    budgets = rng.uniform(0.1, 5.0, lanes)
    with jax.enable_x64(True):
        srt_p, viol_p = pallas_lane_sort(jnp.asarray(mat),
                                         jnp.asarray(budgets), interpret=True)
        ref = lane_sort_ref(jnp.asarray(mat))
        vref = lane_violations_ref(jnp.asarray(mat), jnp.asarray(budgets))
    srt, viol = lane_sort(torch.tensor(mat), torch.tensor(budgets))
    assert viol.dtype == torch.int32
    np.testing.assert_array_equal(srt.numpy(), np.asarray(srt_p))
    np.testing.assert_array_equal(srt.numpy(), np.sort(mat, axis=1))
    np.testing.assert_array_equal(srt.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(viol.numpy(), np.asarray(viol_p))
    np.testing.assert_array_equal(viol.numpy(), np.asarray(vref))


def test_lane_sort_without_budgets_returns_only_the_sorted_rows():
    mat = _sort_case(np.random.default_rng(77), 11, 23)
    out = lane_sort(torch.tensor(mat))
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(out.numpy(), np.sort(mat, axis=1))


@pytest.mark.parametrize("shape", [(0, 5), (4, 0)])
def test_lane_sort_empty_edges(shape):
    srt, viol = lane_sort(torch.zeros(shape, dtype=torch.float64),
                          torch.zeros(shape[0], dtype=torch.float64))
    assert tuple(srt.shape) == shape and tuple(viol.shape) == (shape[0],)
    assert not viol.any()


def test_lane_sort_wrapper_rejects_what_the_kernel_does_not_take():
    m = torch.zeros((3, 4), dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        lane_sort(m.float())
    with pytest.raises(ValueError, match="lanes"):
        lane_sort(m, torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError, match=r"\(lanes, R\)"):
        lane_sort(torch.zeros(4, dtype=torch.float64))
    n0 = lane_sort.launches
    lane_sort(m)
    assert lane_sort.launches == n0


@pytest.mark.parametrize("R,way", [
    (1, "warp"), (121, "warp"), (512, "warp"), (513, "block"),
    (7263, "block"), (16384, "block"), (16385, "global"),
    (4 << 20, "global")])
def test_lane_sort_route_is_a_rule_of_the_row_length(R, way):
    """Rows padded to at most 32 E = 512 values (E = 16 doubles a thread)
    take one warp each, up to 16384 one block each, longer rows the global
    passes."""
    assert lane_sort_route(R) == way
