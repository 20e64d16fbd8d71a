"""ALS: Active Learning-based Sampling (paper §5.3, Alg. 2).

Greedy Sampling on the output (GSy): an NN predictor, trained on profiled
modes, guides *which* modes to profile next — those on the predicted Pareto
whose predicted power is farthest from already-profiled powers (max power
diversity). Crucially the NN never answers the optimization query: only the
**observed** partial Pareto does, so ALS cannot violate budgets through
prediction error (§5.3.1).

 * training:   10 random init + 8 rounds x 5 greedy samples  (<= 50 modes)
 * inference:  25 init (5 per bs) + 6 rounds x 4 quadrants x 5 (<= 145)
 * concurrent: 25 init + 3 rounds x 4 quadrants x 10           (<= 145)

The port's copy of ``repro.core.als``, with the reference's control flow:
the ``random.Random(seed)`` draws, the NN seeds of every fit, the quadrant
pruning, the predicted Pareto and the greedy power-diverse picks. Each
strategy takes a ``backend`` (``"cuda"``, the default, or ``"cpu"``): where
its NNs fit and where the batched grid solvers answer. The picks follow
float32 predictions, which two correct runs meet only within a tolerance
(``core.nn_model``); answers come from observed profiles only.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional

import numpy as np

from repro_torch.core import grid_eval as G
from repro_torch.core import problem as P
from repro_torch.core.device_model import Profiler
from repro_torch.core.gmd import ConcurrentProfiler
from repro_torch.core.nn_model import NNPredictor, mode_features
from repro_torch.core.pareto import pareto_front
from repro_torch.core.powermode import PowerModeSpace


def _greedy_power_diverse(cand_powers: dict, seen_powers: list[float], k: int) -> list:
    """Pick k candidates maximizing min |predicted power - profiled powers|."""
    seen = list(seen_powers)
    picked = []
    cands = dict(cand_powers)
    for _ in range(min(k, len(cands))):
        key = max(cands, key=lambda c: min((abs(cands[c] - s) for s in seen),
                                           default=float("inf")))
        picked.append(key)
        seen.append(cands[key])
        del cands[key]
    return picked


class ALSTrain:
    def __init__(self, profiler: Profiler, space: Optional[PowerModeSpace] = None,
                 rounds: int = 8, init_samples: int = 10, per_round: int = 5,
                 nn_epochs: int = 400, seed: int = 0,
                 backend: Optional[str] = None):
        self.profiler = profiler
        self.space = space or PowerModeSpace()
        self.rounds, self.init_samples, self.per_round = rounds, init_samples, per_round
        self.nn_epochs = nn_epochs
        self.seed = seed
        self.backend = backend
        self._fitted = False

    def fit(self) -> None:
        """Sample + profile; reusable for any problem config of this workload."""
        rng = random.Random(self.seed)
        modes = self.space.all_modes()
        train_set = rng.sample(modes, self.init_samples)
        for pm in train_set:
            self.profiler.profile(pm)

        for rnd in range(self.rounds):
            obs = self.profiler.observed()
            feats = np.array([mode_features(pm) for (pm, _) in obs])
            times = np.array([t for (t, _) in obs.values()])
            pows = np.array([p for (_, p) in obs.values()])
            nn_t = NNPredictor.fit(feats, times, epochs=self.nn_epochs, seed=rnd,
                                   backend=self.backend)
            nn_p = NNPredictor.fit(feats, pows, epochs=self.nn_epochs,
                                   seed=rnd + 100, backend=self.backend)

            test = [pm for pm in modes if (pm, None) not in obs]
            if not test:
                break
            tf = np.array([mode_features(pm) for pm in test])
            pred_t = nn_t.predict(tf)
            pred_p = nn_p.predict(tf)
            points = {pm: (float(pp), float(tt))
                      for pm, pp, tt in zip(test, pred_p, pred_t)}
            front = pareto_front(points)               # predicted Pareto
            cand_powers = {pm: pw for pm, (pw, _) in front.items()}
            seen_powers = [p for (_, p) in obs.values()]
            for pm in _greedy_power_diverse(cand_powers, seen_powers, self.per_round):
                self.profiler.profile(pm)
        self._fitted = True

    def solve(self, prob: P.TrainProblem) -> Optional[P.Solution]:
        return self.solve_batch([prob])[0]

    def solve_batch(self, probs, backend: Optional[str] = None):
        """Answer a batch of problems from the observed profiles in one
        masked reduction (profiling stays point-by-point via the Profiler)."""
        if not self._fitted:
            self.fit()
        grid = G.cached_grid(self, "_grid", self.profiler.observed_modes(),
                             "train")
        return G.solve_train_batch(probs, grid, backend or self.backend)


# ---------------------------------------------------------------------------
# inference: 4-quadrant sampling over (latency budget, arrival rate)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuadrantRanges:
    latency: tuple[float, float]        # full (lo, hi) range of budgets
    arrival: tuple[float, float]

    def quadrants(self):
        lmid = 0.5 * (self.latency[0] + self.latency[1])
        amid = 0.5 * (self.arrival[0] + self.arrival[1])
        for lat in ((self.latency[0], lmid), (lmid, self.latency[1])):
            for arr in ((self.arrival[0], amid), (amid, self.arrival[1])):
                yield lat, arr


class ALSInfer:
    def __init__(self, profiler: Profiler, ranges: QuadrantRanges,
                 space: Optional[PowerModeSpace] = None,
                 rounds: int = 6, init_per_bs: int = 5, per_quadrant: int = 5,
                 nn_epochs: int = 400, seed: int = 0,
                 batch_sizes=tuple(P.INFER_BATCH_SIZES),
                 backend: Optional[str] = None):
        self.profiler = profiler
        self.ranges = ranges
        self.space = space or PowerModeSpace()
        self.rounds, self.init_per_bs, self.per_quadrant = rounds, init_per_bs, per_quadrant
        self.nn_epochs = nn_epochs
        self.seed = seed
        self.batch_sizes = list(batch_sizes)
        self.backend = backend
        self._fitted = False

    def _predictors(self):
        obs = self.profiler.observed()
        feats = np.array([mode_features(pm, bs) for (pm, bs) in obs])
        times = np.array([t for (t, _) in obs.values()])
        pows = np.array([p for (_, p) in obs.values()])
        nn_t = NNPredictor.fit(feats, times, epochs=self.nn_epochs,
                               backend=self.backend)
        nn_p = NNPredictor.fit(feats, pows, epochs=self.nn_epochs, seed=1,
                               backend=self.backend)
        return nn_t, nn_p

    def fit(self) -> None:
        rng = random.Random(self.seed)
        modes = self.space.all_modes()
        for bs in self.batch_sizes:
            for pm in rng.sample(modes, self.init_per_bs):
                self.profiler.profile(pm, bs)

        for rnd in range(self.rounds):
            nn_t, nn_p = self._predictors()
            obs = self.profiler.observed()
            test = [(pm, bs) for pm in modes for bs in self.batch_sizes
                    if (pm, bs) not in obs]
            if not test:
                break
            tf = np.array([mode_features(pm, bs) for pm, bs in test])
            pred_t, pred_p = nn_t.predict(tf), nn_p.predict(tf)
            seen_powers = [p for (_, p) in obs.values()]

            for lat_rng, arr_rng in self.ranges.quadrants():
                # conservative pruning: keep candidates meeting the quadrant's
                # peak latency and its lowest arrival rate (§5.3.3)
                keep = {}
                for (pm, bs), tt, pp in zip(test, pred_t, pred_p):
                    lam = P.peak_latency(bs, arr_rng[0], float(tt))
                    if lam <= lat_rng[1] and P.sustainable(bs, arr_rng[0], float(tt)):
                        keep[(pm, bs)] = (float(pp), lam)
                if not keep:
                    continue
                front = pareto_front(keep)
                cand_powers = {k: pw for k, (pw, _) in front.items()}
                for pm, bs in _greedy_power_diverse(cand_powers, seen_powers,
                                                    self.per_quadrant):
                    self.profiler.profile(pm, bs)
                    seen_powers.append(self.profiler.observed()[(pm, bs)][1])
        self._fitted = True

    def solve(self, prob: P.InferProblem) -> Optional[P.Solution]:
        return self.solve_batch([prob])[0]

    def solve_batch(self, probs, backend: Optional[str] = None):
        if not self._fitted:
            self.fit()
        grid = G.cached_grid(self, "_grid", self.profiler.observed(), "infer")
        return G.solve_infer_batch(probs, grid, backend or self.backend)


# ---------------------------------------------------------------------------
# concurrent training + inference
# ---------------------------------------------------------------------------

class ALSConcurrent:
    def __init__(self, cprofiler: ConcurrentProfiler, ranges: QuadrantRanges,
                 space: Optional[PowerModeSpace] = None,
                 rounds: int = 3, init_modes: int = 25, per_quadrant: int = 10,
                 nn_epochs: int = 400, seed: int = 0,
                 batch_sizes=tuple(P.INFER_BATCH_SIZES),
                 backend: Optional[str] = None):
        self.cp = cprofiler
        self.ranges = ranges
        self.space = space or PowerModeSpace()
        self.rounds, self.init_modes, self.per_quadrant = rounds, init_modes, per_quadrant
        self.nn_epochs = nn_epochs
        self.seed = seed
        self.batch_sizes = list(batch_sizes)
        self.backend = backend
        self._fitted = False

    def fit(self) -> None:
        rng = random.Random(self.seed)
        modes = self.space.all_modes()
        for pm in rng.sample(modes, self.init_modes):
            self.cp.profile(pm, rng.choice(self.batch_sizes))

        for rnd in range(self.rounds):
            iobs = self.cp.infer.observed()
            tobs = self.cp.train.observed()
            ifeats = np.array([mode_features(pm, bs) for (pm, bs) in iobs])
            nn_ti = NNPredictor.fit(ifeats, np.array([t for t, _ in iobs.values()]),
                                    epochs=self.nn_epochs, backend=self.backend)
            nn_pi = NNPredictor.fit(ifeats, np.array([p for _, p in iobs.values()]),
                                    epochs=self.nn_epochs, seed=1,
                                    backend=self.backend)
            tfeats = np.array([mode_features(pm) for (pm, _) in tobs])
            nn_tt = NNPredictor.fit(tfeats, np.array([t for t, _ in tobs.values()]),
                                    epochs=self.nn_epochs, seed=2,
                                    backend=self.backend)
            nn_pt = NNPredictor.fit(tfeats, np.array([p for _, p in tobs.values()]),
                                    epochs=self.nn_epochs, seed=3,
                                    backend=self.backend)

            test = [(pm, bs) for pm in modes for bs in self.batch_sizes
                    if (pm, bs) not in iobs]
            if not test:
                break
            itf = np.array([mode_features(pm, bs) for pm, bs in test])
            ttf = np.array([mode_features(pm) for pm, _ in test])
            p_ti, p_pi = nn_ti.predict(itf), nn_pi.predict(itf)
            p_tt, p_pt = nn_tt.predict(ttf), nn_pt.predict(ttf)
            seen_powers = [p for (_, p) in iobs.values()] + \
                          [p for (_, p) in tobs.values()]

            for lat_rng, arr_rng in self.ranges.quadrants():
                keep = {}
                for (pmbs, tti, ppi, ttt, ppt) in zip(test, p_ti, p_pi, p_tt, p_pt):
                    pm, bs = pmbs
                    lam = P.peak_latency(bs, arr_rng[0], float(tti))
                    if lam > lat_rng[1] or not P.sustainable(bs, arr_rng[0], float(tti)):
                        continue
                    theta = P.train_throughput(bs, arr_rng[0], float(tti), max(float(ttt), 1e-6))
                    dom_p = max(float(ppi), float(ppt))   # dominant power
                    keep[(pm, bs)] = (dom_p, theta)
                if not keep:
                    continue
                # Pareto of predicted throughput (higher better) vs power
                front = pareto_front(keep, lower_is_better=False)
                cand_powers = {k: pw for k, (pw, _) in front.items()}
                for pm, bs in _greedy_power_diverse(cand_powers, seen_powers,
                                                    self.per_quadrant):
                    self.cp.profile(pm, bs)
                    seen_powers.append(self.cp.infer.observed()[(pm, bs)][1])
        self._fitted = True

    def solve(self, prob: P.ConcurrentProblem) -> Optional[P.Solution]:
        return self.solve_batch([prob])[0]

    def solve_batch(self, probs, backend: Optional[str] = None):
        if not self._fitted:
            self.fit()
        return G.solve_concurrent_batch(
            probs,
            G.cached_grid(self, "_tgrid", self.cp.train.observed_modes(), "train"),
            G.cached_grid(self, "_igrid", self.cp.infer.observed(), "infer"),
            backend or self.backend)


# ---------------------------------------------------------------------------
# multi-tenant: N streams, GSy sampling with per-stream predictors
# ---------------------------------------------------------------------------

class ALSMultiTenant:
    """ALS over the N-stream problem: one mode visit profiles every stream
    (and the train workload), per-stream NNs predict (time, power), and the
    per-quadrant predicted Pareto of (dominant power, predicted training
    throughput) guides sampling. Candidates use one shared bs per visit — a
    sampling heuristic only; the solve scans the full per-stream cross
    product of observations."""

    def __init__(self, mtprofiler, ranges: QuadrantRanges,
                 space: Optional[PowerModeSpace] = None,
                 rounds: int = 3, init_modes: int = 25, per_quadrant: int = 10,
                 nn_epochs: int = 400, seed: int = 0,
                 batch_sizes=tuple(P.INFER_BATCH_SIZES),
                 backend: Optional[str] = None):
        self.mp = mtprofiler
        self.ranges = ranges
        self.space = space or PowerModeSpace()
        self.rounds, self.init_modes, self.per_quadrant = rounds, init_modes, per_quadrant
        self.nn_epochs = nn_epochs
        self.seed = seed
        self.batch_sizes = list(batch_sizes)
        self.backend = backend
        self._fitted = False

    def fit(self) -> None:
        rng = random.Random(self.seed)
        modes = self.space.all_modes()
        n = self.mp.n_streams
        for pm in rng.sample(modes, self.init_modes):
            bs = rng.choice(self.batch_sizes)
            self.mp.profile(pm, [bs] * n)

        for rnd in range(self.rounds):
            stream_nns = []
            for j, prof in enumerate(self.mp.streams):
                obs = prof.observed()
                feats = np.array([mode_features(pm, bs) for (pm, bs) in obs])
                nn_t = NNPredictor.fit(
                    feats, np.array([t for t, _ in obs.values()]),
                    epochs=self.nn_epochs, seed=2 * j + rnd,
                    backend=self.backend)
                nn_p = NNPredictor.fit(
                    feats, np.array([p for _, p in obs.values()]),
                    epochs=self.nn_epochs, seed=2 * j + rnd + 50,
                    backend=self.backend)
                stream_nns.append((nn_t, nn_p))
            nn_tt = nn_pt = None
            if self.mp.train:
                tobs = self.mp.train.observed()
                tfeats = np.array([mode_features(pm) for (pm, _) in tobs])
                nn_tt = NNPredictor.fit(
                    tfeats, np.array([t for t, _ in tobs.values()]),
                    epochs=self.nn_epochs, seed=rnd + 100,
                    backend=self.backend)
                nn_pt = NNPredictor.fit(
                    tfeats, np.array([p for _, p in tobs.values()]),
                    epochs=self.nn_epochs, seed=rnd + 150,
                    backend=self.backend)

            visited = {(pm, bss[0]) for (pm, bss) in self.mp.visited}
            test = [(pm, bs) for pm in modes for bs in self.batch_sizes
                    if (pm, bs) not in visited]
            if not test:
                break
            itf = np.array([mode_features(pm, bs) for pm, bs in test])
            preds = [(nn_t.predict(itf), nn_p.predict(itf))
                     for nn_t, nn_p in stream_nns]
            if nn_tt is not None:
                ttf = np.array([mode_features(pm) for pm, _ in test])
                p_tt, p_pt = nn_tt.predict(ttf), nn_pt.predict(ttf)
            seen_powers = [p for prof in self.mp.streams
                           for (_, p) in prof.observed().values()]

            for lat_rng, arr_rng in self.ranges.quadrants():
                keep = {}
                for i, (pm, bs) in enumerate(test):
                    t_ins = [float(pt[i]) for pt, _ in preds]
                    bss = [bs] * n
                    rates = [arr_rng[0]] * n
                    if not P.multi_sustainable(bss, rates, t_ins):
                        continue
                    if any(P.multi_peak_latency(bss, rates, t_ins, j)
                           > lat_rng[1] for j in range(n)):
                        continue
                    dom_p = max(float(pp[i]) for _, pp in preds)
                    if nn_tt is not None:
                        t_tr = max(float(p_tt[i]), 1e-6)
                        tau = P.multi_interleave_tau(bss, rates, t_ins, t_tr)
                        obj = tau / P.multi_cycle(bss, rates)
                        dom_p = max(dom_p, float(p_pt[i]))
                    else:
                        obj = -max(P.multi_peak_latency(bss, rates, t_ins, j)
                                   for j in range(n))
                    keep[(pm, bs)] = (dom_p, obj)
                if not keep:
                    continue
                front = pareto_front(keep, lower_is_better=False)
                cand_powers = {k: pw for k, (pw, _) in front.items()}
                for pm, bs in _greedy_power_diverse(cand_powers, seen_powers,
                                                    self.per_quadrant):
                    self.mp.profile(pm, [bs] * n)
                    seen_powers.append(
                        self.mp.streams[0].observed()[(pm, bs)][1])
        self._fitted = True

    def solve(self, prob: P.MultiTenantProblem) -> Optional[P.MultiTenantSolution]:
        return self.solve_batch([prob])[0]

    def solve_batch(self, probs, backend: Optional[str] = None):
        if not self._fitted:
            self.fit()
        tgrid = G.cached_grid(self, "_tgrid", self.mp.train.observed_modes(),
                              "train") if self.mp.train else None
        igrids = [G.cached_grid(self, f"_igrid{j}", prof.observed(), "infer")
                  for j, prof in enumerate(self.mp.streams)]
        return G.solve_multi_tenant_batch(probs, tgrid, igrids,
                                          backend or self.backend)
