"""Fulcrum's GMD retargeted at the configuration of a multi-card host: the
counterpart of ``repro.core.tpu_adapter``.

The paper's search (a profile-guided, slope-prioritised bisection over a
discrete knob space with a monotone resource constraint) picks, for an
architecture and input shape, how to lay a step out on the cards:

  Jetson knob                  GPU knob
  ---------------------------  ------------------------------------------
  CPU cores / CPU / GPU / mem  tensor-parallel width tp (data-parallel =
  frequencies                  chips // tp), microbatch count, remat
  power budget  p <= p-hat     per-card HBM bytes <= the card's memory
  minibatch time               roofline step time (compute+memory+coll.)
  Profile(pm) on the board     analytic roofline model

HBM per card grows with tp, with fewer microbatches and with remat off, so
GMD's half-line pruning stays sound; time is not monotone (the compute /
collective trade), which the per-dimension line search handles.

The arithmetic is the reference's, term for term; only the hardware
constants are an argument (``launch.mesh.Hardware``, the H100's by
default). With the v5e constants and the reference's knob space passed
in, every time, HBM figure, plan and profile count equals the reference's.
The default space is the four-card host's: chips 4, tp in {1, 2, 4}.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import problem as P
from repro_torch.core.gmd import _GMDBase
from repro_torch.core.powermode import PowerModeSpace
from repro_torch.launch.mesh import H100, Hardware
from repro_torch.models.model import ModelConfig

MAX_ACC = 16
CHIPS = 4                         # one host of four H100s on NVLink
MAX_TRIES = 10                    # GMD's profile budget, as the reference's


@dataclasses.dataclass(frozen=True, order=True)
class GPUMode:
    """One point of the configuration space. Every dimension is ordered so
    that a LARGER value uses MORE per-card HBM:

    tp:    tensor-parallel width (data-parallel = chips // tp);
    acc:   accumulation width; microbatches = MAX_ACC // acc;
    remat: 0 = activation checkpointing ON, 1 = OFF.
    """
    tp: int
    acc: int
    remat: int

    @property
    def microbatches(self) -> int:
        return MAX_ACC // self.acc

    def value(self, dim: str) -> int:
        return getattr(self, dim)

    def replace(self, **kw) -> "GPUMode":
        return dataclasses.replace(self, **kw)

    def __str__(self):
        return (f"tp{self.tp}/mb{self.microbatches}/"
                f"remat{'off' if self.remat else 'on'}")


class GPUKnobSpace(PowerModeSpace):
    MODE_CLS = GPUMode

    def __init__(self, chips: int = CHIPS, tp=(1, 2, 4),
                 acc=(1, 2, 4, 8, 16), remat=(0, 1)):
        self.chips = chips
        self.values = {"tp": sorted(tp), "acc": sorted(acc),
                       "remat": sorted(remat)}

    def make_mode(self, **kw):
        return GPUMode(**kw)


class RooflineGPUModel:
    """Analytic per-step roofline of (arch x shape) under a configuration.

    time  = compute + exposed-memory + collective terms;
    "power" = per-card HBM bytes (params / optimizer / activations / cache).
    """

    def __init__(self, cfg: ModelConfig, seq_len: int, global_batch: int,
                 kind: str = "train", chips: int = CHIPS,
                 hw: Hardware = H100):
        self.cfg, self.seq, self.batch, self.kind = cfg, seq_len, global_batch, kind
        self.chips = chips
        self.hw = hw

    def time_power(self, m: GPUMode) -> tuple[float, float]:
        cfg, hw = self.cfg, self.hw
        tp = m.tp
        dp = max(1, self.chips // tp)
        micro = m.microbatches
        tokens = self.batch * self.seq
        n_active = cfg.active_param_count()
        n_total = cfg.param_count()
        mult = 3.0 if self.kind == "train" else 1.0         # fwd+bwd vs fwd
        remat_mult = (4 / 3 if (self.kind == "train" and m.remat == 0) else 1.0)
        flops_dev = 2.0 * n_active * tokens * mult * remat_mult / self.chips
        compute_s = flops_dev / hw.peak_flops_bf16

        # HBM traffic: weights streamed once per microbatch + activations
        act_bytes = tokens * cfg.d_model * cfg.num_layers * 2 * 4 / self.chips
        weight_bytes = n_active / tp * 2 * micro * mult
        memory_s = (act_bytes + weight_bytes) / hw.hbm_bw

        # collectives: Megatron 2 all-reduce/layer fwd (+2 bwd) of the
        # activation shard + DP gradient reduce-scatter of the param shard
        ar_bytes = (2 * mult * cfg.num_layers
                    * (tokens / dp) * cfg.d_model * 2 * (tp - 1) / max(tp, 1))
        dp_bytes = (2.0 * n_total / tp * 4 * (dp - 1) / max(dp, 1)
                    if self.kind == "train" else 0.0)
        coll_s = (ar_bytes + dp_bytes) / hw.ici_bw

        time_s = compute_s + memory_s + coll_s

        # per-card HBM footprint ("power"); params / optimizer FSDP over
        # all cards (constant in the knobs), activations set the gradient
        opt_mult = (4 + 4 + 4 + 2) if self.kind == "train" else 2
        param_hbm = n_total * opt_mult / self.chips
        act_live = (tokens * tp / self.chips / micro) * cfg.d_model * 2 \
            * (2 if m.remat == 0 else cfg.num_layers) \
            * (1 if self.kind == "train" else 0.25)
        kv_hbm = 0.0
        if self.kind != "train" and cfg.n_kv_heads:
            kv_hbm = (self.batch * tp / self.chips) * cfg.num_layers * 2 \
                * cfg.n_kv_heads * cfg.resolved_head_dim * self.seq * 2
        hbm = param_hbm + act_live + kv_hbm
        return time_s, hbm


class GMDForGPU(_GMDBase):
    """GMD over the knob space: least step time such that per-card HBM
    stays within the card's memory (``model.hw.hbm_bytes``)."""

    def __init__(self, model: RooflineGPUModel,
                 space: Optional[GPUKnobSpace] = None):
        super().__init__(profiler=None, space=space or GPUKnobSpace(model.chips),
                         max_tries=MAX_TRIES)
        self.model = model
        self.hbm_budget = float(model.hw.hbm_bytes)
        self.num_profiles = 0
        self._obs: dict[GPUMode, tuple[float, float]] = {}

    def solve(self) -> Optional[P.Solution]:
        """Slope-prioritised coordinate search, as the reference's: probes
        at the midpoint and both ends of each dimension, then a convex line
        search per dimension in decreasing slope order, with the
        monotone-HBM pruning kept."""
        self._obs = {}
        self.num_profiles = 0
        sp = self.space
        mid = sp.midpoint()
        self._profile(mid)
        current = mid

        # initial probes at both ends of each dim -> time slopes
        slopes = {}
        for dim, vals in sp.values.items():
            if len(vals) < 2:
                continue
            lo = current.replace(**{dim: vals[0]})
            hi = current.replace(**{dim: vals[-1]})
            t_lo, _ = self._profile(lo)
            t_hi, _ = self._profile(hi)
            slopes[dim] = abs(t_hi - t_lo) / (vals[-1] - vals[0])

        # coordinate descent in decreasing slope order; per-dim convex search
        for dim in sorted(slopes, key=slopes.get, reverse=True):
            vals = sp.values[dim]
            lo_i, hi_i = 0, len(vals) - 1
            while hi_i - lo_i > 1 and self.num_profiles < self.max_tries + 8:
                m1 = lo_i + (hi_i - lo_i) // 3
                m2 = hi_i - (hi_i - lo_i) // 3
                if m2 == m1:
                    m2 = m1 + 1
                t1, h1 = self._profile(current.replace(**{dim: vals[m1]}))
                t2, h2 = self._profile(current.replace(**{dim: vals[m2]}))
                # monotone-HBM pruning: an over-budget point rules out
                # everything above it on this line
                if h1 > self.hbm_budget:
                    hi_i = m1 - 1
                    continue
                if h2 > self.hbm_budget:
                    hi_i = m2 - 1
                    continue
                if t1 <= t2:
                    hi_i = m2 - 1 if m2 > m1 else hi_i - 1
                else:
                    lo_i = m1 + 1
            # anchor at the best feasible value seen on this line
            best_v = None
            best_t = float("inf")
            for mode, (t, h) in self._obs.items():
                if h <= self.hbm_budget and t < best_t and all(
                        mode.value(d) == current.value(d)
                        for d in sp.values if d != dim):
                    best_v, best_t = mode.value(dim), t
            if best_v is not None:
                current = current.replace(**{dim: best_v})

        best = None
        for mode, (t, hbm) in self._obs.items():
            if hbm <= self.hbm_budget and (best is None or t < best.time):
                best = P.Solution(pm=mode, time=t, power=hbm,
                                  throughput=1.0 / t)
        return best

    def _profile(self, mode):
        if mode not in self._obs:
            self.num_profiles += 1
            self._obs[mode] = self.model.time_power(mode)
        return self._obs[mode]


def exhaustive_best(model: RooflineGPUModel,
                    space: Optional[GPUKnobSpace] = None):
    """(mode, time, HBM) of the fastest mode within the card's memory over
    the whole knob grid, or None: the oracle GMDForGPU is judged against."""
    space = space or GPUKnobSpace(model.chips)
    budget = float(model.hw.hbm_bytes)
    best = None
    for mode in space.all_modes():
        t, hbm = model.time_power(mode)
        if hbm <= budget and (best is None or t < best[1]):
            best = (mode, t, hbm)
    return best
