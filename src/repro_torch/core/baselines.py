"""Baseline strategies (paper §6): RND-k random sampling with observed-Pareto
lookup, and the NN-k prediction-based baseline (PowerTrain-style) whose
*predicted* Pareto answers queries — and can therefore violate budgets.

Query answering runs on the vectorized grid engine: after fitting, the
observed (or predicted) profiles are flattened into an `ObservationGrid`
once, and `solve`/`solve_batch` are masked reductions over it — a whole
problem sweep is one array program instead of a per-problem Python scan.
Profiling itself still goes through the scalar `Profiler`, point by point.

The port's copy of ``repro.core.baselines``. Every strategy takes a
``backend`` (``"cuda"``, the default, or ``"cpu"``): where the NN-k
predictors fit and where the batched grid solvers answer. RND-k draws with
Python's ``random`` as the reference does, so its profiles are the
reference's and its answers bitwise the reference's.
"""
from __future__ import annotations

import random
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import grid_eval as G
from repro_torch.core import problem as P
from repro_torch.core.device_model import Profiler
from repro_torch.core.gmd import ConcurrentProfiler
from repro_torch.core.nn_model import NNPredictor, mode_features
from repro_torch.core.powermode import PowerModeSpace


class RNDTrain:
    """RND-k: profile k random modes, answer from the observed profiles."""

    def __init__(self, profiler: Profiler, k: int, space=None, seed: int = 0,
                 backend: Optional[str] = None):
        self.profiler, self.k = profiler, k
        self.space = space or PowerModeSpace()
        self.seed = seed
        self.backend = backend
        self._fitted = False

    def fit(self):
        rng = random.Random(self.seed)
        for pm in rng.sample(self.space.all_modes(), self.k):
            self.profiler.profile(pm)
        self._fitted = True

    def solve(self, prob: P.TrainProblem) -> Optional[P.Solution]:
        return self.solve_batch([prob])[0]

    def solve_batch(self, probs: Sequence[P.TrainProblem],
                    backend: Optional[str] = None) -> list[Optional[P.Solution]]:
        if not self._fitted:
            self.fit()
        grid = G.cached_grid(self, "_grid", self.profiler.observed_modes(),
                             "train")
        return G.solve_train_batch(probs, grid, backend or self.backend)


class RNDInfer:
    """RND-150/250: k//5 random modes, each profiled at all 5 batch sizes."""

    def __init__(self, profiler: Profiler, k: int, space=None, seed: int = 0,
                 batch_sizes=tuple(P.INFER_BATCH_SIZES),
                 backend: Optional[str] = None):
        self.profiler, self.k = profiler, k
        self.space = space or PowerModeSpace()
        self.seed = seed
        self.batch_sizes = list(batch_sizes)
        self.backend = backend
        self._fitted = False

    def fit(self):
        rng = random.Random(self.seed)
        n_modes = max(1, self.k // len(self.batch_sizes))
        for pm in rng.sample(self.space.all_modes(), n_modes):
            for bs in self.batch_sizes:
                self.profiler.profile(pm, bs)
        self._fitted = True

    def solve(self, prob: P.InferProblem) -> Optional[P.Solution]:
        return self.solve_batch([prob])[0]

    def solve_batch(self, probs: Sequence[P.InferProblem],
                    backend: Optional[str] = None) -> list[Optional[P.Solution]]:
        if not self._fitted:
            self.fit()
        grid = G.cached_grid(self, "_grid", self.profiler.observed(), "infer")
        return G.solve_infer_batch(probs, grid, backend or self.backend)


class RNDMultiTenant:
    """RND-k for N streams: k//5 random modes, every stream profiled at all
    batch sizes per visit; answers ride the batched multi-tenant solver."""

    def __init__(self, mtprofiler, k: int, space=None, seed: int = 0,
                 batch_sizes=tuple(P.INFER_BATCH_SIZES),
                 backend: Optional[str] = None):
        self.mp, self.k = mtprofiler, k
        self.space = space or PowerModeSpace()
        self.seed = seed
        self.batch_sizes = list(batch_sizes)
        self.backend = backend
        self._fitted = False

    def fit(self):
        rng = random.Random(self.seed)
        n_modes = max(1, self.k // len(self.batch_sizes))
        for pm in rng.sample(self.space.all_modes(), n_modes):
            for bs in self.batch_sizes:
                self.mp.profile(pm, [bs] * self.mp.n_streams)
        self._fitted = True

    def solve(self, prob: P.MultiTenantProblem) -> Optional[P.MultiTenantSolution]:
        return self.solve_batch([prob])[0]

    def solve_batch(self, probs: Sequence[P.MultiTenantProblem],
                    backend: Optional[str] = None) -> list:
        if not self._fitted:
            self.fit()
        tgrid = G.cached_grid(self, "_tgrid", self.mp.train.observed_modes(),
                              "train") if self.mp.train else None
        igrids = [G.cached_grid(self, f"_igrid{j}", prof.observed(), "infer")
                  for j, prof in enumerate(self.mp.streams)]
        return G.solve_multi_tenant_batch(probs, tgrid, igrids,
                                          backend or self.backend)


class RNDConcurrent:
    def __init__(self, cprofiler: ConcurrentProfiler, k: int, space=None,
                 seed: int = 0, batch_sizes=tuple(P.INFER_BATCH_SIZES),
                 backend: Optional[str] = None):
        self.cp, self.k = cprofiler, k
        self.space = space or PowerModeSpace()
        self.seed = seed
        self.batch_sizes = list(batch_sizes)
        self.backend = backend
        self._fitted = False

    def fit(self):
        rng = random.Random(self.seed)
        n_modes = max(1, self.k // len(self.batch_sizes))
        for pm in rng.sample(self.space.all_modes(), n_modes):
            for bs in self.batch_sizes:
                self.cp.profile(pm, bs)
        self._fitted = True

    def solve(self, prob: P.ConcurrentProblem) -> Optional[P.Solution]:
        return self.solve_batch([prob])[0]

    def solve_batch(self, probs: Sequence[P.ConcurrentProblem],
                    backend: Optional[str] = None) -> list[Optional[P.Solution]]:
        if not self._fitted:
            self.fit()
        return G.solve_concurrent_batch(
            probs,
            G.cached_grid(self, "_tgrid", self.cp.train.observed_modes(), "train"),
            G.cached_grid(self, "_igrid", self.cp.infer.observed(), "infer"),
            backend or self.backend)


# ---------------------------------------------------------------------------
# NN-k: prediction-based (the paper's cautionary baseline)
# ---------------------------------------------------------------------------

class NNTrainBaseline:
    def __init__(self, profiler: Profiler, k: int = 250, space=None,
                 seed: int = 0, nn_epochs: int = 1000,
                 backend: Optional[str] = None):
        self.profiler, self.k = profiler, k
        self.space = space or PowerModeSpace()
        self.seed, self.nn_epochs = seed, nn_epochs
        self.backend = backend
        self._pred = None

    def fit(self):
        rng = random.Random(self.seed)
        for pm in rng.sample(self.space.all_modes(), self.k):
            self.profiler.profile(pm)
        obs = self.profiler.observed()
        feats = np.array([mode_features(pm) for (pm, _) in obs])
        nn_t = NNPredictor.fit(feats, np.array([t for t, _ in obs.values()]),
                               epochs=self.nn_epochs, backend=self.backend)
        nn_p = NNPredictor.fit(feats, np.array([p for _, p in obs.values()]),
                               epochs=self.nn_epochs, seed=1,
                               backend=self.backend)
        modes = self.space.all_modes()
        mf = np.array([mode_features(pm) for pm in modes])
        self._pred = {pm: (float(t), float(p))
                      for pm, t, p in zip(modes, nn_t.predict(mf), nn_p.predict(mf))}
        self._grid = None           # refit replaces predictions wholesale

    def solve(self, prob: P.TrainProblem) -> Optional[P.Solution]:
        """Answers from *predicted* values; the returned solution's true
        time/power may violate the budget (evaluated by the benchmark)."""
        return self.solve_batch([prob])[0]

    def solve_batch(self, probs: Sequence[P.TrainProblem],
                    backend: Optional[str] = None) -> list[Optional[P.Solution]]:
        if self._pred is None:
            self.fit()
        return G.solve_train_batch(
            probs, G.cached_grid(self, "_grid", self._pred, "train"),
            backend or self.backend)


class NNInferBaseline:
    def __init__(self, profiler: Profiler, k: int = 250, space=None,
                 seed: int = 0, nn_epochs: int = 1000,
                 batch_sizes=tuple(P.INFER_BATCH_SIZES),
                 backend: Optional[str] = None):
        self.profiler, self.k = profiler, k
        self.space = space or PowerModeSpace()
        self.seed, self.nn_epochs = seed, nn_epochs
        self.batch_sizes = list(batch_sizes)
        self.backend = backend
        self._pred = None

    def fit(self):
        rng = random.Random(self.seed)
        n_modes = max(1, self.k // len(self.batch_sizes))
        for pm in rng.sample(self.space.all_modes(), n_modes):
            for bs in self.batch_sizes:
                self.profiler.profile(pm, bs)
        obs = self.profiler.observed()
        feats = np.array([mode_features(pm, bs) for (pm, bs) in obs])
        nn_t = NNPredictor.fit(feats, np.array([t for t, _ in obs.values()]),
                               epochs=self.nn_epochs, backend=self.backend)
        nn_p = NNPredictor.fit(feats, np.array([p for _, p in obs.values()]),
                               epochs=self.nn_epochs, seed=1,
                               backend=self.backend)
        keys = [(pm, bs) for pm in self.space.all_modes() for bs in self.batch_sizes]
        mf = np.array([mode_features(pm, bs) for pm, bs in keys])
        self._pred = {k: (float(t), float(p))
                      for k, t, p in zip(keys, nn_t.predict(mf), nn_p.predict(mf))}
        self._grid = None           # refit replaces predictions wholesale

    def solve(self, prob: P.InferProblem) -> Optional[P.Solution]:
        return self.solve_batch([prob])[0]

    def solve_batch(self, probs: Sequence[P.InferProblem],
                    backend: Optional[str] = None) -> list[Optional[P.Solution]]:
        if self._pred is None:
            self.fit()
        return G.solve_infer_batch(
            probs, G.cached_grid(self, "_grid", self._pred, "infer"),
            backend or self.backend)


class NNConcurrentBaseline:
    def __init__(self, cprofiler: ConcurrentProfiler, k: int = 250, space=None,
                 seed: int = 0, nn_epochs: int = 1000,
                 batch_sizes=tuple(P.INFER_BATCH_SIZES),
                 backend: Optional[str] = None):
        self.cp, self.k = cprofiler, k
        self.space = space or PowerModeSpace()
        self.seed, self.nn_epochs = seed, nn_epochs
        self.batch_sizes = list(batch_sizes)
        self.backend = backend
        self._pred = None

    def fit(self):
        rng = random.Random(self.seed)
        n_modes = max(1, self.k // len(self.batch_sizes))
        for pm in rng.sample(self.space.all_modes(), n_modes):
            for bs in self.batch_sizes:
                self.cp.profile(pm, bs)
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
        modes = self.space.all_modes()
        keys = [(pm, bs) for pm in modes for bs in self.batch_sizes]
        imf = np.array([mode_features(pm, bs) for pm, bs in keys])
        tmf = np.array([mode_features(pm) for pm in modes])
        self._ipred = {k: (float(t), float(p)) for k, t, p in
                       zip(keys, nn_ti.predict(imf), nn_pi.predict(imf))}
        self._tpred = {pm: (float(t), float(p)) for pm, t, p in
                       zip(modes, nn_tt.predict(tmf), nn_pt.predict(tmf))}
        self._tgrid = self._igrid = None   # refit replaces predictions
        self._pred = True

    def solve(self, prob: P.ConcurrentProblem) -> Optional[P.Solution]:
        return self.solve_batch([prob])[0]

    def solve_batch(self, probs: Sequence[P.ConcurrentProblem],
                    backend: Optional[str] = None) -> list[Optional[P.Solution]]:
        if self._pred is None:
            self.fit()
        return G.solve_concurrent_batch(
            probs, G.cached_grid(self, "_tgrid", self._tpred, "train"),
            G.cached_grid(self, "_igrid", self._ipred, "infer"),
            backend or self.backend)


class NNMultiTenantBaseline:
    """NN-k for N streams: per-stream time/power predictors answer from the
    *predicted* dense grids (so, as in the pair case, the chosen plan can
    violate budgets — the benchmark checks against ground truth)."""

    def __init__(self, mtprofiler, k: int = 250, space=None, seed: int = 0,
                 nn_epochs: int = 1000,
                 batch_sizes=tuple(P.INFER_BATCH_SIZES),
                 backend: Optional[str] = None):
        self.mp, self.k = mtprofiler, k
        self.space = space or PowerModeSpace()
        self.seed, self.nn_epochs = seed, nn_epochs
        self.batch_sizes = list(batch_sizes)
        self.backend = backend
        self._pred = None

    def fit(self):
        rng = random.Random(self.seed)
        n_modes = max(1, self.k // len(self.batch_sizes))
        for pm in rng.sample(self.space.all_modes(), n_modes):
            for bs in self.batch_sizes:
                self.mp.profile(pm, [bs] * self.mp.n_streams)
        modes = self.space.all_modes()
        keys = [(pm, bs) for pm in modes for bs in self.batch_sizes]
        imf = np.array([mode_features(pm, bs) for pm, bs in keys])
        self._ipreds = []
        for j, prof in enumerate(self.mp.streams):
            obs = prof.observed()
            feats = np.array([mode_features(pm, bs) for (pm, bs) in obs])
            nn_t = NNPredictor.fit(feats,
                                   np.array([t for t, _ in obs.values()]),
                                   epochs=self.nn_epochs, seed=2 * j,
                                   backend=self.backend)
            nn_p = NNPredictor.fit(feats,
                                   np.array([p for _, p in obs.values()]),
                                   epochs=self.nn_epochs, seed=2 * j + 1,
                                   backend=self.backend)
            self._ipreds.append(
                {k: (float(t), float(p)) for k, t, p in
                 zip(keys, nn_t.predict(imf), nn_p.predict(imf))})
        self._tpred = None
        if self.mp.train:
            tobs = self.mp.train.observed()
            tfeats = np.array([mode_features(pm) for (pm, _) in tobs])
            nn_tt = NNPredictor.fit(tfeats,
                                    np.array([t for t, _ in tobs.values()]),
                                    epochs=self.nn_epochs, seed=100,
                                    backend=self.backend)
            nn_pt = NNPredictor.fit(tfeats,
                                    np.array([p for _, p in tobs.values()]),
                                    epochs=self.nn_epochs, seed=101,
                                    backend=self.backend)
            tmf = np.array([mode_features(pm) for pm in modes])
            self._tpred = {pm: (float(t), float(p)) for pm, t, p in
                           zip(modes, nn_tt.predict(tmf), nn_pt.predict(tmf))}
        self._tgrid = None                 # refit replaces predictions
        for j in range(self.mp.n_streams):
            setattr(self, f"_igrid{j}", None)
        self._pred = True

    def solve(self, prob: P.MultiTenantProblem) -> Optional[P.MultiTenantSolution]:
        return self.solve_batch([prob])[0]

    def solve_batch(self, probs: Sequence[P.MultiTenantProblem],
                    backend: Optional[str] = None) -> list:
        if self._pred is None:
            self.fit()
        tgrid = G.cached_grid(self, "_tgrid", self._tpred, "train") \
            if self._tpred is not None else None
        igrids = [G.cached_grid(self, f"_igrid{j}", pred, "infer")
                  for j, pred in enumerate(self._ipreds)]
        return G.solve_multi_tenant_batch(probs, tgrid, igrids,
                                          backend or self.backend)
