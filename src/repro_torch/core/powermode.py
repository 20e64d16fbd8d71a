"""Jetson Orin AGX power-mode space (paper Table 3).

A power mode is (CPU cores, CPU freq, GPU freq, memory freq). The full Orin
space is 12 x 29 x 13 x 4 = 18,096 modes; the paper's ground-truth experiment
grid is the uniformly spaced 3 x 7 x 7 x 3 = 441 subset, which we mirror
exactly (the midpoint mode works out to 8c/1344/727/2133, as in §5.1.2).

The port's own copy of ``repro.core.powermode``, kept line for line: the
port imports nothing from the JAX package, which stays the reference.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

DIMS = ("cores", "cpuf", "gpuf", "memf")

# Full Orin AGX value lists (MHz; cores is a count).
CORES_ALL = list(range(1, 13))                                         # 12
CPUF_ALL = [115, 192, 268, 345, 422, 499, 576, 652, 729, 806, 883,
            960, 1036, 1113, 1190, 1267, 1344, 1420, 1497, 1574, 1651,
            1728, 1804, 1881, 1958, 2035, 2112, 2188, 2201]            # 29
GPUF_ALL = [115, 217, 319, 421, 522, 624, 727, 828, 930, 1032, 1134,
            1236, 1300]                                                # 13
MEMF_ALL = [665, 1600, 2133, 3199]                                     # 4

# Experiment grid (441 modes, paper Table 3c).
CORES_EXP = [4, 8, 12]
CPUF_EXP = [422, 729, 1036, 1344, 1651, 1958, 2201]
GPUF_EXP = [115, 319, 522, 727, 930, 1134, 1300]
MEMF_EXP = [665, 2133, 3199]


@dataclasses.dataclass(frozen=True, order=True)
class PowerMode:
    cores: int
    cpuf: int
    gpuf: int
    memf: int

    def replace(self, **kw) -> "PowerMode":
        return dataclasses.replace(self, **kw)

    def value(self, dim: str) -> int:
        return getattr(self, dim)

    def __str__(self) -> str:
        return f"{self.cores}c/{self.cpuf}/{self.gpuf}/{self.memf}"


MAXN = PowerMode(12, 2201, 1300, 3199)


class PowerModeSpace:
    """A rectangular grid of modes with per-dimension value lists.

    Generic over the mode dataclass: subclasses may redefine MODE_CLS and the
    dimension dict (the GMD machinery only relies on .values, .index and the
    mode's .value()/.replace() protocol) — see core.tpu_adapter for the
    TPU-knob reuse."""

    MODE_CLS = PowerMode

    def __init__(self, cores: Sequence[int] = CORES_EXP,
                 cpuf: Sequence[int] = CPUF_EXP,
                 gpuf: Sequence[int] = GPUF_EXP,
                 memf: Sequence[int] = MEMF_EXP):
        self.values = {"cores": sorted(cores), "cpuf": sorted(cpuf),
                       "gpuf": sorted(gpuf), "memf": sorted(memf)}

    def make_mode(self, **kw):
        return self.MODE_CLS(**kw)

    @classmethod
    def full_orin(cls) -> "PowerModeSpace":
        return cls(CORES_ALL, CPUF_ALL, GPUF_ALL, MEMF_ALL)

    def __len__(self) -> int:
        n = 1
        for v in self.values.values():
            n *= len(v)
        return n

    def all_modes(self) -> list:
        names = list(self.values)
        return [self.make_mode(**dict(zip(names, combo)))
                for combo in itertools.product(*self.values.values())]

    def mid(self, dim: str) -> int:
        vals = self.values[dim]
        return vals[len(vals) // 2]

    def midpoint(self):
        return self.make_mode(**{d: self.mid(d) for d in self.values})

    def lowest(self, dim: str) -> int:
        return self.values[dim][0]

    def highest(self, dim: str) -> int:
        return self.values[dim][-1]

    def maxn(self):
        return self.make_mode(**{d: self.highest(d) for d in self.values})

    def minn(self):
        return self.make_mode(**{d: self.lowest(d) for d in self.values})

    def index(self, dim: str, value: int) -> int:
        return self.values[dim].index(value)

    def contains(self, pm) -> bool:
        return all(pm.value(d) in self.values[d] for d in self.values)
