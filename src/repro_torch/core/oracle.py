"""Ground-truth "optimal" solutions (paper §6): exhaustively evaluate the 441
uniformly spaced power modes (x 5 inference minibatch sizes) on the device
model and solve by observed-Pareto lookup. Profiling cost is not charged to
the oracle — it is the nominal optimum strategies are compared against.

Counterpart of ``repro.core.oracle``. Dense time/power grids are
materialized once per workload on the host (``grid_eval.materialize``) and
every problem configuration — or a whole batch of them via
``solve_*_batch`` — is solved as a masked reduction on the backend's device
(``"cuda"`` by default, or ``"cpu"``), bitwise identical to the scalar
``problem.solve_*`` loops.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core import grid_eval as G
from repro_torch.core import problem as P
from repro_torch.core.device_model import DeviceModel, WorkloadProfile
from repro_torch.core.powermode import PowerModeSpace


class Oracle:
    def __init__(self, device: DeviceModel, space: Optional[PowerModeSpace] = None,
                 batch_sizes=tuple(P.INFER_BATCH_SIZES)):
        self.device = device
        self.space = space or PowerModeSpace()
        self.batch_sizes = batch_sizes
        self._train_grids: dict[str, G.ObservationGrid] = {}
        self._infer_grids: dict[str, G.ObservationGrid] = {}
        self._train_obs: dict[str, dict] = {}
        self._infer_obs: dict[str, dict] = {}

    # -- dense grids (materialized once per workload) -----------------------
    def train_grid(self, w: WorkloadProfile) -> G.ObservationGrid:
        if w.name not in self._train_grids:
            self._train_grids[w.name] = G.materialize(self.device, w, self.space)
        return self._train_grids[w.name]

    def infer_grid(self, w: WorkloadProfile) -> G.ObservationGrid:
        if w.name not in self._infer_grids:
            self._infer_grids[w.name] = G.materialize(
                self.device, w, self.space, self.batch_sizes)
        return self._infer_grids[w.name]

    # -- dict views (same insertion order as the grids) ---------------------
    def train_observations(self, w: WorkloadProfile) -> dict:
        if w.name not in self._train_obs:
            self._train_obs[w.name] = self.train_grid(w).to_dict()
        return self._train_obs[w.name]

    def infer_observations(self, w: WorkloadProfile) -> dict:
        if w.name not in self._infer_obs:
            self._infer_obs[w.name] = self.infer_grid(w).to_dict()
        return self._infer_obs[w.name]

    # -- ground-truth lookups (no hashing in the hot loop) ------------------
    def true_train(self, w: WorkloadProfile, pm) -> tuple[float, float]:
        """Ground-truth (t, p) for a training workload at ``pm``."""
        grid = self.train_grid(w)
        if pm in grid.index:
            return grid.lookup(pm)
        return self.device.time_power(w, pm)

    def true_infer(self, w: WorkloadProfile, pm, bs: int) -> tuple[float, float]:
        """Ground-truth (t, p) for an inference workload at ``(pm, bs)``."""
        grid = self.infer_grid(w)
        if (pm, bs) in grid.index:
            return grid.lookup(pm, bs)
        return self.device.time_power(w, pm, bs)

    # -- single-problem solves (vectorized path, batch of one) --------------
    def solve_train(self, w: WorkloadProfile, prob: P.TrainProblem,
                    backend: Optional[str] = None):
        return self.solve_train_batch(w, [prob], backend)[0]

    def solve_infer(self, w: WorkloadProfile, prob: P.InferProblem,
                    backend: Optional[str] = None):
        return self.solve_infer_batch(w, [prob], backend)[0]

    def solve_concurrent(self, w_tr: WorkloadProfile, w_in: WorkloadProfile,
                         prob: P.ConcurrentProblem,
                         backend: Optional[str] = None):
        return self.solve_concurrent_batch(w_tr, w_in, [prob], backend)[0]

    # -- batched solves: the full problem grid in one array program ---------
    def solve_train_batch(self, w: WorkloadProfile,
                          probs: Sequence[P.TrainProblem],
                          backend: Optional[str] = None
                          ) -> list[Optional[P.Solution]]:
        return G.solve_train_batch(probs, self.train_grid(w), backend)

    def solve_infer_batch(self, w: WorkloadProfile,
                          probs: Sequence[P.InferProblem],
                          backend: Optional[str] = None
                          ) -> list[Optional[P.Solution]]:
        return G.solve_infer_batch(probs, self.infer_grid(w), backend)

    def solve_concurrent_batch(self, w_tr: WorkloadProfile,
                               w_in: WorkloadProfile,
                               probs: Sequence[P.ConcurrentProblem],
                               backend: Optional[str] = None
                               ) -> list[Optional[P.Solution]]:
        return G.solve_concurrent_batch(probs, self.train_grid(w_tr),
                                        self.infer_grid(w_in), backend)

    # -- multi-tenant: stream workloads come from the problem's specs -------
    def solve_multi_tenant(self, w_tr: Optional[WorkloadProfile],
                           prob: P.MultiTenantProblem,
                           backend: Optional[str] = None):
        return self.solve_multi_tenant_batch(w_tr, [prob], backend)[0]

    def solve_multi_tenant_batch(self, w_tr: Optional[WorkloadProfile],
                                 probs: Sequence[P.MultiTenantProblem],
                                 backend: Optional[str] = None
                                 ) -> list[Optional[P.MultiTenantSolution]]:
        """Ground-truth N-stream solves: one dense grid per distinct stream
        workload (shared streams share the materialization)."""
        if not probs:
            return []
        specs = probs[0].streams
        if any(s.workload is None for s in specs):
            raise ValueError("oracle multi-tenant solves need StreamSpec."
                             "workload set on every stream")
        grids = [self.infer_grid(s.workload) for s in specs]
        tg = self.train_grid(w_tr) if probs[0].train else None
        return G.solve_multi_tenant_batch(probs, tg, grids, backend)
