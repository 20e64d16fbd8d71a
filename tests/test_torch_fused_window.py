"""The port's fused fleet window (``repro_torch.core.fused_window``, its
kernel's plain version on ``"cpu"``) against the reference's fused program
(``repro.core.fused_window``, a ``jax.jit`` program) and against the
unfused fleet paths, mirroring ``tests/test_fleet.py``'s fused cases.

The reference's program needs ``backend.require_jax``, which imports a
module this image's jax no longer has; the ``ref_jax`` fixture patches the
two names that call it (``repro.core.fused_window.require_jax`` and
``repro.core.grid_eval.require_jax``) with the same triple from the current
jax, for the test's duration. Nothing of the reference changes.

Tolerances. Per window, on every device the reference solves: the
selection (``solved``, ``sel``, ``lam``, ``power``, ``mode_id``), the
switch charge and the clock after it, the admission counts, the admitted
times, ``n_adm`` and ``n_batches`` bitwise; latencies and ``clock_out``
within the engine tolerance ``atol=1e-8, rtol=1e-9`` (the reference folds
with an associative scan, the port's plain version with the engine's
doubling). Per fleet run, ``tests/test_torch_fleet.py``'s comparison: every
decision per window equal, latencies within the engine tolerance; against
the port's own unfused ``"cpu"`` path bitwise (both fold with the plain
max-plus scan, which pads only with identity elements).
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import fleet as RF
from repro.core import fused_window as RFW
from repro.core import grid_eval as RG
from repro.core import problem as RP
from repro.core.controller import ControllerConfig as RefConfig
from repro.core.device_model import DeviceModel as RefDevice
from repro.core.device_model import INFER_WORKLOADS as REF_INFER
from repro.core.powermode import PowerModeSpace as RefSpace
from repro_torch.core import backend as B
from repro_torch.core import fleet as F
from repro_torch.core import fused_window as FW
from repro_torch.core import problem as P
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.device_model import DeviceModel, INFER_WORKLOADS
from repro_torch.core.grid_eval import materialize
from repro_torch.core.powermode import PowerModeSpace
from repro_torch.kernels.fulcrum import fused_window as K
from test_torch_cuda import (FUSED_MATRIX, FUSED_RATES, doubled_grid,
                             fused_window_case)
from test_torch_fleet import ENG_TOL, assert_fleets_match

W_IN, REF_W_IN = INFER_WORKLOADS["mobilenet"], REF_INFER["mobilenet"]
EXACT = ("solved", "sel", "lam", "power", "mode_id", "switch", "clock_in",
         "n_rej", "n_carry_rej", "n_adm", "n_batches")


@pytest.fixture
def ref_jax(monkeypatch):
    import jax
    shim = lambda: (jax, jax.numpy, lambda: jax.enable_x64(True))  # noqa
    monkeypatch.setattr(RFW, "require_jax", shim)
    monkeypatch.setattr(RG, "require_jax", shim)


@functools.lru_cache(maxsize=None)
def _grids():
    grid = materialize(DeviceModel(), W_IN, PowerModeSpace(),
                       P.INFER_BATCH_SIZES)
    ref = RG.materialize(RefDevice(), REF_W_IN, RefSpace(),
                         RP.INFER_BATCH_SIZES)
    return grid, ref


def _window(seed, K=24):
    return fused_window_case(_grids()[0], seed, K)


def assert_windows_match(ref, got, n_times):
    """Bitwise on every solved device's decisions and admitted times,
    latencies and ``clock_out`` within the engine tolerance."""
    assert got["solved"].tolist() == ref["solved"].tolist()
    s = np.flatnonzero(ref["solved"])
    for f in EXACT:
        a = np.asarray(ref[f])[s]
        b = np.asarray(got[f])[s]
        assert b.astype(a.dtype).tobytes() == a.tobytes(), f
    T = max(n_times, default=0)
    for d in s:
        n = int(ref["n_adm"][d])
        assert got["adm_times"][d][:n].tobytes() == \
            ref["adm_times"][d][:n].tobytes()
        assert np.isinf(got["adm_times"][d][n:]).all()
        np.testing.assert_allclose(got["latencies"][d],
                                   ref["latencies"][d][:T], **ENG_TOL)
        assert np.isinf(ref["latencies"][d][T:]).all()
    np.testing.assert_allclose(got["clock_out"][s], ref["clock_out"][s],
                               **ENG_TOL)


# ---------------------------------------------------------------------------
# one window: the port's fused window against the reference's program
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trims", [True, False])
@pytest.mark.parametrize("seed", range(6))
def test_window_matches_the_reference_fused_program(ref_jax, seed, trims):
    grid, rgrid = _grids()
    args = _window(seed)
    ref = RFW.fused_fleet_window(rgrid, *args, trims)
    got = FW.fused_fleet_window(grid, *args, trims, backend="cpu")
    assert_windows_match(ref, got, [len(v) for v in args[9]])
    if not trims:
        assert not got["n_rej"].any()


def test_windows_cover_every_rung_and_edge():
    """The random windows above reach each rung, unsolved and empty
    devices, mode switches, rejections inside carried prefixes, and the
    grid's smallest and largest batch sizes."""
    grid = _grids()[0]
    seen = {"rung": set(), "bs": set()}
    switch = carry_rej = empty_served = 0
    for seed in range(6):
        args = _window(seed)
        got = FW.fused_fleet_window(grid, *args, True, backend="cpu")
        s = got["solved"]
        seen["rung"] |= set(got["rung"].tolist())
        seen["bs"] |= set(grid.bs[got["sel"][s]].tolist())
        switch += int(np.count_nonzero(got["switch"][s]))
        carry_rej += int(got["n_carry_rej"][s].sum())
        empty_served += int(s[0])
        assert not got["rung"][~s].any() and got["rung"][s].all()
        assert not got["rungs"][~args[7]].any()      # idle devices run none
    assert seen["rung"] == {0, 1, 2, 3, 4}
    assert {1, 64} <= seen["bs"]
    assert switch and carry_rej and empty_served


def test_empty_window_and_idle_fleet(ref_jax):
    grid, rgrid = _grids()
    args = list(_window(1, K=5))
    args[9] = [np.empty(0)] * 5                      # nothing arrived
    args[10] = np.zeros(5, np.int64)
    ref = RFW.fused_fleet_window(rgrid, *args, True)
    got = FW.fused_fleet_window(grid, *args, True, backend="cpu")
    assert got["latencies"].shape == (5, 0)
    assert_windows_match(ref, got, [0] * 5)
    assert (got["clock_out"] == got["clock_in"]).all()


def test_mode_ids_are_power_mode_equality():
    grid, rgrid = _grids()
    ids = FW.grid_mode_ids(grid)
    assert ids.tolist() == RFW.grid_mode_ids(rgrid).tolist()
    assert FW.grid_mode_ids(grid) is ids                     # memoized
    for i in (0, 5, 1000, len(grid) - 1):
        same = np.flatnonzero(ids == ids[i])
        assert all(grid.modes[j] == grid.modes[i] for j in same)
    dev = FW.device_mode_ids(grid, torch.device("cpu"))
    assert dev.dtype == torch.int32 and dev.tolist() == ids.tolist()
    assert FW.device_mode_ids(grid, torch.device("cpu")) is dev
    assert FW._grid_max_bs(grid) == RFW._grid_max_bs(rgrid) == 64


# ---------------------------------------------------------------------------
# the wrapper on CPU tensors
# ---------------------------------------------------------------------------

def _wrapper_args(seed=2):
    grid = _grids()[0]
    args = _window(seed, K=6)
    rows = torch.from_numpy(FW.pack_window(*args[:7], args[11], args[7],
                                           args[8], args[9], args[10]))
    t, p, bsf = (torch.from_numpy(x) for x in
                 (grid.t, grid.p, grid.bs.astype(np.float64)))
    ids = torch.from_numpy(FW.grid_mode_ids(grid))
    return t, p, bsf, ids, rows


def test_wrapper_takes_the_plain_version_on_cpu_tensors():
    t, p, bsf, ids, rows = _wrapper_args()
    before = K.fused_window.launches
    got = K.fused_window(t, p, bsf, ids, rows, 0.25, 0.09, True, 64)
    want = K.fused_window_plain(t, p, bsf, ids, rows, 0.25, 0.09, True, 64)
    assert K.fused_window.launches == before       # no kernel launched
    assert got.shape == (6, K.N_OUT + 2 * (rows.shape[1] - K.N_IN))
    assert got.numpy().tobytes() == want.numpy().tobytes()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    t, p, bsf, ids, rows = _wrapper_args()
    call = lambda *a, mb=64: K.fused_window(*a, 0.25, 0.09, True, mb)  # noqa
    with pytest.raises(TypeError, match="mode_ids"):
        call(t, p, bsf, ids.long(), rows)
    with pytest.raises(TypeError, match="rows"):
        call(t, p, bsf, ids, rows.float())
    with pytest.raises(ValueError, match="grid columns"):
        call(t, p[:-1], bsf, ids, rows)
    with pytest.raises(ValueError, match="rows must be"):
        call(t, p, bsf, ids, rows[:, :K.N_IN - 1])
    with pytest.raises(ValueError, match="contiguous"):
        call(t, p, bsf, ids, rows.t().contiguous().t())
    with pytest.raises(ValueError, match="max_bs"):
        call(t, p, bsf, ids, rows, mb=K.MAX_RING + 1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        call(*(x.to("meta") for x in (t, p, bsf, ids, rows)))


# ---------------------------------------------------------------------------
# serve_fleet(fused=True): the reference's fused matrix
# ---------------------------------------------------------------------------

_KW = dict(window_duration=3.0, arrivals="poisson", seed=17)


def _case(case):
    spec_kw, cfg_kw = FUSED_MATRIX[case]
    rates = FUSED_RATES["idle" if case == "heterogeneous" else "default"]
    return spec_kw, cfg_kw, rates


def _port(case, fused, backend="cpu"):
    spec_kw, cfg_kw, rates = _case(case)
    return F.serve_fleet(W_IN, 30.0, 0.15, rates, F.FleetSpec(6, seed=3,
                                                              **spec_kw),
                         backend=backend, fused=fused,
                         controller=ControllerConfig(**cfg_kw), **_KW)


def _ref(case, fn="serve_fleet", **kw):
    spec_kw, cfg_kw, rates = _case(case)
    return getattr(RF, fn)(REF_W_IN, 30.0, 0.15, rates,
                           RF.FleetSpec(6, seed=3, **spec_kw),
                           controller=RefConfig(**cfg_kw), **_KW, **kw)


@functools.lru_cache(maxsize=None)
def _fused_run(case):
    """The port's fused run of a case, its wrapper calls and launches by
    layer (the engine's, K1's, must not move)."""
    calls = []
    inner = FW.fused_window                 # the importer's name
    FW.fused_window = lambda *a: calls.append(1) or inner(*a)
    try:
        before = {k: B.dispatch_count(k) for k in ("fused", "engine")}
        got = _port(case, True)
        moved = {k: B.dispatch_count(k) - n for k, n in before.items()}
    finally:
        FW.fused_window = inner
    return got, len(calls), moved


@pytest.mark.parametrize("case", sorted(FUSED_MATRIX))
def test_fused_fleet_matches_the_reference_fused_program(ref_jax, case):
    got, calls, moved = _fused_run(case)
    assert calls == moved["fused"] == len(got)      # one call per window
    assert moved["engine"] == 0                     # no K1
    assert_fleets_match(_ref(case, backend="jax", fused=True), got)


@pytest.mark.parametrize("case", sorted(FUSED_MATRIX))
def test_fused_fleet_is_the_unfused_cpu_path(case):
    got = _fused_run(case)[0]
    assert_fleets_match(_port(case, False), got, exact=True)


@pytest.mark.parametrize("case", sorted(FUSED_MATRIX))
def test_fused_fleet_matches_the_reference_sequential_loops(case):
    got = _fused_run(case)[0]
    assert_fleets_match(_ref(case, "serve_fleet_sequential",
                             backend="numpy"), got)


@pytest.mark.parametrize("mode", ["shed", "defer"])
def test_fused_fleet_under_overload_rejects_as_the_reference(ref_jax, mode):
    """Rates past what six devices drain (60 / 400 / 25 / 300 req/s): the
    fused admission rejects inside windows and carried prefixes, and every
    decision is the reference fused program's and its sequential loops'."""
    cfg = dict(admission=mode, carry_backlog=True, mode_switch_s=0.25,
               defer_cap=40 if mode == "defer" else None)
    rates = [60.0, 400.0, 25.0, 300.0]
    got = F.serve_fleet(W_IN, 30.0, 0.15, rates, F.FleetSpec(6, seed=3),
                        backend="cpu", fused=True,
                        controller=ControllerConfig(**cfg), **_KW)
    for fn, kw in (("serve_fleet", dict(backend="jax", fused=True)),
                   ("serve_fleet_sequential", dict(backend="numpy"))):
        ref = getattr(RF, fn)(REF_W_IN, 30.0, 0.15, rates,
                              RF.FleetSpec(6, seed=3),
                              controller=RefConfig(**cfg), **_KW, **kw)
        assert_fleets_match(ref, got)
    assert sum(w.shed_requests for w in got) > 0
    if mode == "defer":
        assert sum(w.deferred_requests for w in got) > 0


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_fused_degrade_bs_is_refused(backend):
    with pytest.raises(ValueError, match="degrade-bs"):
        F.serve_fleet(W_IN, 30.0, 0.15, [50.0], F.FleetSpec(2), fused=True,
                      backend=backend,
                      controller=ControllerConfig(admission="degrade-bs"))


def test_fused_run_leaves_the_unfused_cpu_path_bit_for_bit():
    """tests/test_fleet_admission.py's opt-in proof on the port: a fused run
    first (grid columns and mode ids uploaded, counters bumped) leaves the
    unfused run's results unchanged bit for bit."""
    spec = F.FleetSpec(3, seed=2, dispatch="least-backlog")
    cfg = ControllerConfig(rate_estimator="ewma", rate_margin=1.5,
                           feedback=True, carry_backlog=True,
                           mode_switch_s=0.25)
    kw = dict(window_duration=5.0, arrivals="poisson", seed=9,
              controller=cfg, backend="cpu")
    rates = [60.0, 90.0, 45.0]
    before = F.serve_fleet(W_IN, 30.0, 0.1, rates, spec, **kw)
    fused = F.serve_fleet(W_IN, 30.0, 0.1, rates, spec, fused=True, **kw)
    after = F.serve_fleet(W_IN, 30.0, 0.1, rates, spec, **kw)
    assert_fleets_match(before, after, exact=True)
    assert_fleets_match(before, fused, exact=True)
    ref = RF.serve_fleet(REF_W_IN, 30.0, 0.1, rates,
                         RF.FleetSpec(3, seed=2, dispatch="least-backlog"),
                         window_duration=5.0, arrivals="poisson", seed=9,
                         backend="numpy",
                         controller=RefConfig(rate_estimator="ewma",
                                              rate_margin=1.5, feedback=True,
                                              carry_backlog=True,
                                              mode_switch_s=0.25))
    assert_fleets_match(ref, after)


@pytest.mark.parametrize("how", ["concat", "repeat"])
def test_window_ties_go_to_the_first_entry(ref_jax, how):
    from repro_torch.core.grid_eval import ObservationGrid
    grid, rgrid = _grids()
    grid2 = doubled_grid(grid, ObservationGrid, how)
    rgrid2 = doubled_grid(rgrid, RG.ObservationGrid, how)
    args = _window(3)
    ref = RFW.fused_fleet_window(rgrid2, *args, True)
    got = FW.fused_fleet_window(grid2, *args, True, backend="cpu")
    assert_windows_match(ref, got, [len(v) for v in args[9]])
    once = FW.fused_fleet_window(grid, *args, True, backend="cpu")
    assert got["solved"].any()
    first = once["sel"] if how == "concat" else 2 * once["sel"]
    assert got["sel"].tolist() == first.tolist()     # never the copy


def test_fused_default_backend_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        F.serve_fleet(W_IN, 30.0, 0.15, [50.0], F.FleetSpec(2), fused=True)


def test_the_scheduler_facade_keeps_the_reference_signature():
    """``Fulcrum.serve_fleet`` takes the reference facade's parameters,
    with its defaults: the fused window is reached through
    ``fleet.serve_fleet(fused=True)`` only, as in the reference."""
    import inspect
    from repro.core.scheduler import Fulcrum as RefFulcrum
    from repro_torch.core.scheduler import Fulcrum
    ours, ref = (inspect.signature(f.serve_fleet).parameters
                 for f in (Fulcrum, RefFulcrum))
    assert list(ours) == list(ref)
    assert [p.default for p in ours.values()] == \
        [p.default for p in ref.values()]
    assert "fused" not in ours
