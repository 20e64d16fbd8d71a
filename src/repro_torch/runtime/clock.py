"""Injectable clocks for the runtime layer (``repro.runtime.clock``,
copied: the port imports nothing from the reference).

Every wall-time read in ``repro_torch.runtime`` goes through a ``Clock`` so the
same control flow runs against real time (``WallClock``) or deterministic
simulated time (``FakeClock``). That is what makes sim-vs-real drift
measurable: the managed interleave runtime under a ``FakeClock`` with
fixed step times replays the *identical* float operations as the engine's
scalar reference loop — ``sleep_until`` is a ``max`` (not an add of a
computed remainder, which would round differently), and ``advance`` is the
same repeated addition the engine's slack-fill uses — so the port's
runtime reproduces the reference runtime's latencies bitwise
(``tests/test_torch_serving.py``), and runtime tests run seeded and fast
instead of sleeping through wall seconds.
"""
from __future__ import annotations

import time


class Clock:
    """Interface: ``now()`` in seconds since the clock's epoch, and
    ``sleep_until(t)`` which never moves time backwards."""

    def now(self) -> float:
        raise NotImplementedError

    def sleep_until(self, t: float) -> None:
        raise NotImplementedError


class WallClock(Clock):
    """Real time, relative to construction (epoch 0 at creation)."""

    def __init__(self):
        self._t0 = time.time()

    def now(self) -> float:
        return time.time() - self._t0

    def sleep_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)


class FakeClock(Clock):
    """Deterministic manual time. ``sleep_until`` jumps exactly to the
    target (a float ``max`` — no drift from adding a computed remainder);
    ``advance`` charges simulated work, e.g. a stub inference step adding
    its modeled duration."""

    def __init__(self, t: float = 0.0):
        self._t = float(t)

    def now(self) -> float:
        return self._t

    def sleep_until(self, t: float) -> None:
        self._t = max(self._t, float(t))

    def advance(self, dt: float) -> None:
        self._t += float(dt)
