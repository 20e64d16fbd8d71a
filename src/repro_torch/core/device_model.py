"""Calibrated analytical performance/power model of a Jetson Orin AGX.

This is the dry-run stand-in for the physical device the paper profiles: GMD,
ALS and all baselines only ever see it through ``Profile(pm, [bs]) ->
(minibatch_time, power)``, exactly as on the real board. The phenomenology
reproduces the paper's measurements:

 * minibatch time is an *additive* GPU/CPU/memory pipeline, so time-vs-GPU-
   frequency drops sharply and then saturates (Fig. 7a) while power rises
   monotonically (Fig. 7b);
 * power grows superlinearly with frequency (~f^1.3, DVFS-less f*V^2 trend)
   and monotonically along every dimension (the property GMD's pruning uses);
 * inference time is sublinear in minibatch size, with a DNN-specific fixed
   overhead (MobileNet 3x from bs 1->32; BERT ~29x: §2);
 * interleaved execution obeys t = sum(t_i), p = max(p_i) (§6 validation);
 * a deterministic per-(workload, dim-value) perturbation (<~2%) keeps the
   Pareto non-trivial without breaking monotonicity (adjacent grid steps
   move power by ~5-15%).

Anchors used for calibration (paper §2): ResNet-18 training 59.5 ms / 51.1 W
at MAXN vs 491 ms / 14.7 W at 4c/422/115/665; MobileNet inference bs=64
102 ms / 39.5 W at MAXN; BERT-L inference bs=1 66 ms / 56 W.

The port's own copy of ``repro.core.device_model``, kept line for line
except ``workload_from_model_config``, which needs the model configs and
arrives with them.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Optional

from repro_torch.core.powermode import MAXN, DIMS, PowerMode

MAX_CPUF, MAX_GPUF, MAX_MEMF, MAX_CORES = 2201.0, 1300.0, 3199.0, 12.0


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    """Descriptor of one DNN workload (training or inference).

    Work terms are seconds-at-MAXN per minibatch, split by the resource that
    bounds them. For inference, each term has a fixed part and a per-sample
    part: t(bs) = fixed + per_sample * bs.
    """
    name: str
    kind: str                      # "train" | "infer"
    gpu_fixed: float               # s at max GPU freq
    gpu_per_sample: float
    cpu_fixed: float               # s at max CPU freq / all cores
    cpu_per_sample: float
    mem_fixed: float               # s at max mem freq
    mem_per_sample: float
    cpu_parallelism: float = 6.0   # cores beyond this don't help (dataloader)
    # power model
    p_gpu: float = 28.0            # W at full GPU utilization, max freq
    p_cpu: float = 8.0
    p_mem: float = 6.0
    p_idle: float = 12.0
    util_half_bs: float = 4.0      # bs at which utilization reaches ~2/3
    train_bs: int = 16


def _pert(workload: str, dim: str, value: int, scale: float = 0.05) -> float:
    """Deterministic per-(workload, dimension, value) multiplier in
    [1-scale, 1+scale]; preserves monotonicity because adjacent grid points
    differ in time/power by far more than 2*scale."""
    h = hashlib.md5(f"{workload}|{dim}|{value}".encode()).digest()
    u = int.from_bytes(h[:4], "little") / 2**32
    return 1.0 + scale * (2.0 * u - 1.0)


class DeviceModel:
    """The simulated Orin. ``minibatch_time_power`` is the ground truth that
    profiling observes; strategies never see the internals."""

    def time_power(self, w: WorkloadProfile, pm: PowerMode,
                   bs: Optional[int] = None) -> tuple[float, float]:
        bs_eff = float(bs if bs is not None else w.train_bs)

        gpu_s = (pm.gpuf / MAX_GPUF) * _pert(w.name, "gpuf", pm.gpuf)
        cores_eff = min(pm.cores, w.cpu_parallelism) / w.cpu_parallelism
        cpu_s = ((pm.cpuf / MAX_CPUF) ** 0.9) * (cores_eff ** 0.7) \
            * _pert(w.name, "cpuf", pm.cpuf) * _pert(w.name, "cores", pm.cores)
        mem_s = (pm.memf / MAX_MEMF) * _pert(w.name, "memf", pm.memf)

        t_gpu = (w.gpu_fixed + w.gpu_per_sample * bs_eff) / gpu_s
        t_cpu = (w.cpu_fixed + w.cpu_per_sample * bs_eff) / cpu_s
        t_mem = (w.mem_fixed + w.mem_per_sample * bs_eff) / mem_s
        t = t_gpu + t_cpu + t_mem

        util = bs_eff / (bs_eff + w.util_half_bs)
        # busy fractions: a resource burns dynamic power while it is the
        # active pipeline stage
        f_gpu, f_cpu, f_mem = t_gpu / t, t_cpu / t, t_mem / t
        p = (w.p_idle
             + w.p_gpu * (0.35 + 0.65 * util) * f_gpu_power(pm) * (0.4 + 0.6 * f_gpu)
             + w.p_cpu * f_cpu_power(pm) * (0.5 + 0.5 * f_cpu)
             + w.p_mem * (pm.memf / MAX_MEMF) ** 1.1 * (0.5 + 0.5 * f_mem))
        p *= _pert(w.name, "power", pm.gpuf * 31 + pm.cpuf * 7 + pm.memf, 0.015)
        return t, p

    # -- interleaving laws validated by the paper (§6) ---------------------
    @staticmethod
    def interleaved_time(times: list[float]) -> float:
        return sum(times)

    @staticmethod
    def interleaved_power(powers: list[float]) -> float:
        return max(powers)


def _device_pert(seed: int, index: int, field: str, scale: float) -> float:
    """Deterministic multiplier in [1-scale, 1+scale] for device ``index`` of
    a fleet sampled with ``seed``.

    The hash key is the *delimited string* ``"fleet|{seed}|{index}|{field}"``,
    never an arithmetic combination of the parts: PR 5's ``_poisson_seed``
    collided streams with windows because ``seed + window*k + stream`` maps
    distinct (window, stream) pairs onto the same integer. A delimited string
    key is injective in (seed, index, field) by construction, so no two
    devices of any fleet can share a perturbation draw (regression-tested at
    K=512 in tests/test_fleet.py)."""
    h = hashlib.md5(f"fleet|{seed}|{index}|{field}".encode()).digest()
    u = int.from_bytes(h[:4], "little") / 2**32
    return 1.0 + scale * (2.0 * u - 1.0)


class PerturbedDeviceModel(DeviceModel):
    """One device of a heterogeneous fleet: the base Orin model with scalar
    time/power multipliers. The scaling is applied to the *output* of
    ``time_power`` rather than to the model internals, so a device's
    observation grid is an elementwise rescale of the base model's grid —
    the property the fleet planner exploits to materialize one dense grid
    and scale it per device, bitwise-identical to profiling each device
    point by point (same IEEE multiply either way)."""

    def __init__(self, time_scale: float = 1.0, power_scale: float = 1.0,
                 index: int = 0):
        self.time_scale = float(time_scale)
        self.power_scale = float(power_scale)
        self.index = int(index)

    def time_power(self, w: WorkloadProfile, pm: PowerMode,
                   bs: Optional[int] = None) -> tuple[float, float]:
        t, p = DeviceModel.time_power(self, w, pm, bs)
        return t * self.time_scale, p * self.power_scale


def fleet_device(index: int, seed: int = 0, time_spread: float = 0.10,
                 power_spread: float = 0.05) -> PerturbedDeviceModel:
    """Device ``index`` of the fleet sampled with ``seed``: deterministic
    heterogeneity from collision-free per-(seed, index, field) draws."""
    return PerturbedDeviceModel(
        time_scale=_device_pert(seed, index, "time", time_spread),
        power_scale=_device_pert(seed, index, "power", power_spread),
        index=index)


def f_gpu_power(pm: PowerMode) -> float:
    return (pm.gpuf / MAX_GPUF) ** 1.3


def f_cpu_power(pm: PowerMode) -> float:
    return (pm.cores / MAX_CORES) ** 0.8 * (pm.cpuf / MAX_CPUF) ** 1.3


# ---------------------------------------------------------------------------
# The paper's DNN workloads (Table 4), calibrated to the §2 anchors.
# ---------------------------------------------------------------------------

TRAIN_WORKLOADS = {
    "resnet18": WorkloadProfile(    # 59.5ms/51.1W MAXN; 491ms/14.7W low
        "resnet18-train", "train",
        gpu_fixed=0.004, gpu_per_sample=0.0020,
        cpu_fixed=0.004, cpu_per_sample=0.0004,
        mem_fixed=0.002, mem_per_sample=0.0004,
        p_gpu=40.0, p_cpu=10.0, p_mem=8.0),
    "mobilenet": WorkloadProfile(
        "mobilenet-train", "train",
        gpu_fixed=0.006, gpu_per_sample=0.0011,
        cpu_fixed=0.006, cpu_per_sample=0.0005,
        mem_fixed=0.003, mem_per_sample=0.0003,
        p_gpu=28.0, p_cpu=11.0, p_mem=7.0),
    "yolov8n": WorkloadProfile(
        "yolov8n-train", "train",
        gpu_fixed=0.010, gpu_per_sample=0.0030,
        cpu_fixed=0.012, cpu_per_sample=0.0006,
        mem_fixed=0.004, mem_per_sample=0.0005,
        cpu_parallelism=2.0,        # single dataloader worker (paper fn. 3)
        p_gpu=34.0, p_cpu=12.0, p_mem=7.0),
    "bert": WorkloadProfile(
        "bert-train", "train",
        gpu_fixed=0.015, gpu_per_sample=0.0110,
        cpu_fixed=0.006, cpu_per_sample=0.0006,
        mem_fixed=0.006, mem_per_sample=0.0020,
        p_gpu=48.0, p_cpu=8.0, p_mem=10.0),
    "lstm": WorkloadProfile(
        "lstm-train", "train",
        gpu_fixed=0.008, gpu_per_sample=0.0009,
        cpu_fixed=0.010, cpu_per_sample=0.0007,
        mem_fixed=0.002, mem_per_sample=0.0002,
        p_gpu=20.0, p_cpu=11.0, p_mem=6.0),
}

INFER_WORKLOADS = {
    "mobilenet": WorkloadProfile(   # bs1 18ms/20.9W, bs32 54ms/38.2W, bs64 102ms/39.5W
        "mobilenet-infer", "infer",
        gpu_fixed=0.0080, gpu_per_sample=0.00075,
        cpu_fixed=0.0045, cpu_per_sample=0.00015,
        mem_fixed=0.0030, mem_per_sample=0.00045,
        p_gpu=26.0, p_cpu=8.0, p_mem=7.0, util_half_bs=3.0),
    "resnet50": WorkloadProfile(
        "resnet50-infer", "infer",
        gpu_fixed=0.0090, gpu_per_sample=0.00300,
        cpu_fixed=0.0040, cpu_per_sample=0.00020,
        mem_fixed=0.0030, mem_per_sample=0.00080,
        p_gpu=35.0, p_cpu=7.0, p_mem=8.0, util_half_bs=2.5),
    "yolov8n": WorkloadProfile(
        "yolov8n-infer", "infer",
        gpu_fixed=0.0110, gpu_per_sample=0.00180,
        cpu_fixed=0.0060, cpu_per_sample=0.00030,
        mem_fixed=0.0030, mem_per_sample=0.00050,
        p_gpu=30.0, p_cpu=9.0, p_mem=7.0, util_half_bs=3.0),
    "bert": WorkloadProfile(        # bs1 66ms/56W, bs32 1.94s/61.8W (BERT-Large)
        "bert-infer", "infer",
        gpu_fixed=0.0080, gpu_per_sample=0.05500,
        cpu_fixed=0.0030, cpu_per_sample=0.00030,
        mem_fixed=0.0030, mem_per_sample=0.00500,
        p_gpu=52.0, p_cpu=6.0, p_mem=10.0, util_half_bs=0.4),
    "lstm": WorkloadProfile(
        "lstm-infer", "infer",
        gpu_fixed=0.0060, gpu_per_sample=0.00060,
        cpu_fixed=0.0050, cpu_per_sample=0.00020,
        mem_fixed=0.0015, mem_per_sample=0.00015,
        p_gpu=16.0, p_cpu=9.0, p_mem=6.0, util_half_bs=4.0),
}


# ---------------------------------------------------------------------------
# Profiler: the only interface strategies may use.
# ---------------------------------------------------------------------------

PROFILE_MINIBATCHES = 40       # paper: ~40 minibatches per profiling run
PROFILE_OVERHEAD_S = 5.0       # mode switch + power stabilization (2-3 s)


class Profiler:
    """Profiles (power mode [, inference bs]) pairs against the device model,
    accounting simulated profiling cost and caching results for reuse
    (paper: profiled modes are reusable across problem configurations)."""

    def __init__(self, device: DeviceModel, workload: WorkloadProfile):
        self.device = device
        self.workload = workload
        self.cache: dict[tuple[PowerMode, Optional[int]], tuple[float, float]] = {}
        self.profile_cost_s = 0.0
        self.num_runs = 0

    def profile(self, pm: PowerMode, bs: Optional[int] = None) -> tuple[float, float]:
        key = (pm, bs)
        if key not in self.cache:
            t, p = self.device.time_power(self.workload, pm, bs)
            self.cache[key] = (t, p)
            self.profile_cost_s += PROFILE_MINIBATCHES * t + PROFILE_OVERHEAD_S
            self.num_runs += 1
        return self.cache[key]

    def observed(self) -> dict:
        return dict(self.cache)

    def observed_modes(self) -> dict:
        """Training-style view: {pm: (t, p)} (bs-less profiles)."""
        return {pm: tp for (pm, _), tp in self.cache.items()}
