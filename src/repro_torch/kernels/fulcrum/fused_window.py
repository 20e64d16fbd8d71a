"""One fleet window as one launch: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of the reference's jitted window program
(``repro/core/fused_window.py::_fused_kernel``, a ``jax.jit`` program, not
Pallas). For every device of a K-device fleet it plans, admits and executes
one closed-loop window:

 1. **the ladder** — up to four rungs, each a masked first-occurrence argmin
    over the device's row of the (device x grid entry) plane: the grid's
    ``(t, p, bs)`` columns scaled by the device's ``(ts, ps)``, sustainable
    at ``b_h``, objective and latency budget at the rate ``ar``. Rung r runs
    only where the device's own gate needs it: ``interval = live & hi >
    est`` (rung 1 at ``(est, max(hi, est), bud)``), then ``interval &
    unsolved`` (rung 2 at ``(hi, hi, bud)``), then ``live & unsolved``
    (rung 3 at ``(est, est, bud)``), then ``... & bud < nominal`` (rung 4 at
    ``(est, est, nominal)``);
 2. **the switch charge** — ``switch_cost`` when the selected entry's mode
    id differs from ``prev_mode`` (``-1``: no previous mode), added to the
    pre-switch clock ``clock0``;
 3. **admission** (``trims``) — ``controller._admit_mask``'s deadline-drop
    recurrence over the device's arrivals from the switched clock, then the
    admitted subsequence compacted in order;
 4. **the engine** — the batch-ready fold ``c = max(c, ready_j) + t_in``
    over the admitted batches, each request's latency and the lane's last
    completion.

Layout. A window is one float64 matrix in and one out, so it costs one
host-to-device copy, one launch and one device-to-host copy. Row k of
``rows`` is device k: the ``IN_FIELDS`` (integers and flags as exact
float64), then its ``T`` arrival times padded with ``+inf``. Row k of the
result holds the ``OUT_FIELDS``, then ``T`` admitted times and ``T``
latencies, both padded with ``+inf``. ``rung`` is the rung that solved the
device (0: none), ``rungs`` how many rungs it ran. An unsolved device is
inert: entry 0 selected, ``lam`` ``+inf``, no switch, nothing admitted or
executed, ``clock_out = clock_in``.

Exactness. The ladder, the switch charge, the admission and the
compaction are bitwise the reference's: the same correctly rounded
float64 operations in the same order (the kernel writes each with
``__dmul_rn`` / ``__dadd_rn`` / ``__dsub_rn`` / ``__ddiv_rn``, so nothing
contracts to an FMA), ties to the lower entry. The fold is the engine's
tolerance tier (``docs/exactness.md``): the plain version runs it as
``maxplus_scan_plain``'s doubling, the kernel one batch after another,
the reference as an associative scan; latencies and ``clock_out`` agree
within ``atol=1e-8, rtol=1e-9``.

 * ``fused_window_plain`` computes the window in torch ops, vectorized
   over devices (rungs as masked argmins, admission as a loop over arrival
   positions with a bounded drop loop, compaction by a prefix count).
 * ``fused_window`` launches ``csrc/fused_window.cu`` (one block per
   device) for CUDA tensors, takes the plain version only for CPU
   tensors, and counts launches in ``fused_window.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fulcrum.maxplus_scan import maxplus_scan_plain

IN_FIELDS = ("ts", "ps", "pbud", "bud", "nominal", "est", "hi", "clock0",
             "live", "prev_mode", "n_times", "n_carry")
OUT_FIELDS = ("solved", "sel", "lam", "power", "mode_id", "switch",
              "clock_in", "n_rej", "n_carry_rej", "n_adm", "n_batches",
              "clock_out", "rung", "rungs")
N_IN, N_OUT = len(IN_FIELDS), len(OUT_FIELDS)
ADMIT_EPS = 1e-12             # controller._admit_mask's slack
MAX_RING = 1024               # the largest batch size the kernel takes

_IN = {f: i for i, f in enumerate(IN_FIELDS)}
_SIGNATURES = {"fused_window_launch": (
    [ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_void_p] * 2
    + [ctypes.c_int64] * 2 + [ctypes.c_double] * 2 + [ctypes.c_int] * 2
    + [ctypes.c_void_p], ctypes.c_int),
    "fused_window_stage_max_t": ([], ctypes.c_int64)}


def _rung(t, p, bsf, ts, ps, pb, ar, b_h, b_l):
    """Masked first-occurrence argmin of each row: (index, any feasible,
    selected lam), index 0 and lam +inf where nothing is feasible."""
    tk = t[None, :] * ts[:, None]
    pk = p[None, :] * ps[:, None]
    lam = (bsf[None, :] - 1.0) / ar[:, None] + tk
    feas = ((pk <= pb[:, None]) & (tk <= bsf[None, :] / b_h[:, None])
            & (lam <= b_l[:, None]))
    lam_sel = torch.where(feas, lam, torch.inf)
    idx = lam_sel.argmin(dim=1)
    return idx, feas.any(dim=1), lam_sel.gather(1, idx[:, None])[:, 0]


def _admit(times, n, bs, t_in, clock, thr, max_bs):
    """``controller._admit_mask`` for every row at once: a ring of each
    row's forming-batch member indices, drops from its front while the
    batch's completion leaves the oldest member past ``thr``."""
    R, T = times.shape
    ar = torch.arange(R, device=times.device)
    admit = torch.ones((R, T), dtype=torch.bool, device=times.device)
    ring = torch.zeros((R, max_bs), dtype=torch.long, device=times.device)
    h = torch.zeros(R, dtype=torch.long, device=times.device)
    m = torch.zeros_like(h)
    c = clock
    for i in range(int(n.max()) if R else 0):
        valid = i < n
        pos = (h + m) % max_bs
        ring[ar, pos] = torch.where(valid, i, ring[ar, pos])
        m = m + valid.long()
        full = valid & (m == bs)
        comp = torch.maximum(c, times[:, i]) + t_in
        for _ in range(max_bs):          # a batch drops at most bs members
            j = ring[ar, h % max_bs]
            drop = full & (m > 0) & (comp - times[ar, j] > thr)
            if not bool(drop.any()):
                break
            admit[ar[drop], j[drop]] = False
            h = h + drop.long()
            m = m - drop.long()
        commit = full & (m == bs)
        c = torch.where(commit, comp, c)
        m = torch.where(commit, 0, m)
    return admit


def fused_window_plain(t: torch.Tensor, p: torch.Tensor, bsf: torch.Tensor,
                       mode_ids: torch.Tensor, rows: torch.Tensor,
                       switch_cost: float, adm_budget: float, trims: bool,
                       max_bs: int) -> torch.Tensor:
    """The window in torch ops, on any device: (K, N_OUT + 2 T)."""
    K, T = rows.shape[0], rows.shape[1] - N_IN
    dev = rows.device
    col = {f: rows[:, i] for f, i in _IN.items()}
    ts, ps, est, hi, bud, nom = (col[f] for f in
                                 ("ts", "ps", "est", "hi", "bud", "nominal"))
    live = col["live"] != 0.0
    times = rows[:, N_IN:]
    n = col["n_times"].long()
    n_carry = col["n_carry"].long()
    sel = torch.zeros(K, dtype=torch.long, device=dev)
    lam = torch.full((K,), torch.inf, dtype=torch.float64, device=dev)
    rung = torch.zeros(K, dtype=torch.long, device=dev)
    rungs = torch.zeros_like(rung)
    solved = torch.zeros(K, dtype=torch.bool, device=dev)

    def run(need, r, ar, b_h, b_l):
        idx = need.nonzero()[:, 0]
        if idx.numel() == 0:
            return
        got, ok, lam_r = _rung(t, p, bsf, ts[idx], ps[idx], col["pbud"][idx],
                               ar[idx], b_h[idx], b_l[idx])
        rungs[idx] += 1
        won = idx[ok]
        sel[won], lam[won], rung[won] = got[ok], lam_r[ok], r
        solved[won] = True

    interval = live & (hi > est)
    run(interval, 1, est, torch.maximum(hi, est), bud)
    run(interval & ~solved, 2, hi, hi, bud)
    un12 = live & ~solved
    run(un12, 3, est, est, bud)
    run(un12 & ~solved & (bud < nom), 4, est, est, nom)

    bs = bsf[sel].long()
    t_in = t[sel] * ts
    power = p[sel] * ps
    mode = mode_ids[sel].long()
    prev = col["prev_mode"].long()
    switch = torch.where(solved & (prev >= 0) & (mode != prev),
                         switch_cost, 0.0)
    clock_in = col["clock0"] + switch

    iota = torch.arange(T, device=dev)
    in_range = (iota[None, :] < n[:, None]) & solved[:, None]
    admit = torch.ones((K, T), dtype=torch.bool, device=dev)
    if trims and bool(solved.any()):
        a = solved.nonzero()[:, 0]
        admit[a] = _admit(times[a], n[a], bs[a], t_in[a], clock_in[a],
                          float(adm_budget) + ADMIT_EPS, max_bs)
    keep = admit & in_range
    rej = ~admit & in_range
    n_rej = rej.sum(dim=1)
    n_carry_rej = (rej & (iota[None, :] < n_carry[:, None])).sum(dim=1)
    n_adm = keep.sum(dim=1)
    # the admitted times in order: each goes to its prefix count's slot
    slot = torch.where(keep, keep.cumsum(dim=1) - 1, T)
    ctimes = torch.full((K, T + 1), torch.inf, dtype=torch.float64,
                        device=dev)
    ctimes.scatter_(1, slot, times)
    ctimes = ctimes[:, :T]

    nb = n_adm // bs.clamp_min(1)
    n_b = int(nb.max()) if K else 0
    jb = torch.arange(n_b, device=dev)
    validb = jb[None, :] < nb[:, None]
    last = ((jb[None, :] + 1) * bs[:, None] - 1).clamp(0, max(T - 1, 0))
    ready = torch.where(validb, ctimes.gather(1, last), torch.inf)
    ex = torch.where(validb, t_in[:, None], 0.0)
    inf = torch.full((K,), torch.inf, dtype=torch.float64, device=dev)
    comp, _ = maxplus_scan_plain(ready, ex, inf, inf, clock_in)
    # column n_b holds clock_in: the last completion of a lane with none
    comp = torch.cat([comp, clock_in[:, None]], dim=1)
    served = iota[None, :] < (nb * bs)[:, None]
    bidx = (iota[None, :] // bs.clamp_min(1)[:, None]).clamp(max=n_b)
    lat = torch.where(served, comp.gather(1, bidx) - ctimes, torch.inf)
    clock_out = comp.gather(1, torch.where(nb > 0, nb - 1, n_b)[:, None])[:, 0]

    head = torch.stack([solved.double(), sel.double(), lam, power,
                        mode.double(), switch, clock_in, n_rej.double(),
                        n_carry_rej.double(), n_adm.double(), nb.double(),
                        clock_out, rung.double(), rungs.double()], dim=1)
    return torch.cat([head, ctimes, lat], dim=1)


def _check(t, p, bsf, mode_ids, rows, max_bs) -> None:
    """Raise on inputs the kernel does not take."""
    N = t.shape[0] if t.dim() == 1 else -1
    if N < 1 or p.shape != t.shape or bsf.shape != t.shape \
            or mode_ids.shape != t.shape:
        raise ValueError("t, p, bsf and mode_ids must be (N,) grid columns "
                         "of one length, N >= 1")
    if rows.dim() != 2 or rows.shape[1] < N_IN:
        raise ValueError(f"rows must be (K, {N_IN} + T), got "
                         f"{tuple(rows.shape)}")
    for name, x in (("t", t), ("p", p), ("bsf", bsf), ("rows", rows)):
        if x.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {x.dtype}")
    if mode_ids.dtype != torch.int32:
        raise TypeError(f"mode_ids must be int32, got {mode_ids.dtype}")
    for name, x in (("t", t), ("p", p), ("bsf", bsf),
                    ("mode_ids", mode_ids), ("rows", rows)):
        if x.device != rows.device:
            raise ValueError(f"{name} is on {x.device}, rows on "
                             f"{rows.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= max_bs <= MAX_RING:
        raise ValueError(f"max_bs must be in [1, {MAX_RING}], got {max_bs}")


def fused_window(t: torch.Tensor, p: torch.Tensor, bsf: torch.Tensor,
                 mode_ids: torch.Tensor, rows: torch.Tensor,
                 switch_cost: float, adm_budget: float, trims: bool,
                 max_bs: int) -> torch.Tensor:
    """One fleet window, (K, N_OUT + 2 T) (see the module's layout).

    CUDA tensors launch the hand-written kernel on the current stream (and
    add one to ``fused_window.launches``); CPU tensors run the plain
    version. Anything else raises."""
    _check(t, p, bsf, mode_ids, rows, max_bs)
    if rows.device.type == "cpu":
        return fused_window_plain(t, p, bsf, mode_ids, rows, switch_cost,
                                  adm_budget, trims, max_bs)
    if rows.device.type != "cuda":
        raise ValueError(f"fused_window runs on cuda or cpu tensors, "
                         f"not {rows.device}")
    K, T = rows.shape[0], rows.shape[1] - N_IN
    out = torch.empty((K, N_OUT + 2 * T), dtype=torch.float64,
                      device=rows.device)
    if K == 0:
        return out
    lib = build.load("fused_window", _SIGNATURES)
    with torch.cuda.device(rows.device):
        err = lib.fused_window_launch(
            t.data_ptr(), p.data_ptr(), bsf.data_ptr(), mode_ids.data_ptr(),
            t.shape[0], rows.data_ptr(), out.data_ptr(), K, T,
            float(switch_cost), float(adm_budget), int(bool(trims)),
            int(max_bs), torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "fused_window")
    fused_window.launches += 1
    return out


fused_window.launches = 0
