"""Real-mode managed interleaving: Fulcrum's executor over real PyTorch
steps on the card (``repro.runtime.interleave_runtime`` on PyTorch).

This is the wall-clock counterpart of the engine's managed kernel
(``core.simulate``): one program owns the device, alternating training
minibatches with inference minibatches, switching only at minibatch
boundaries. A training step is launched only if it is predicted (from its
measured step time) to finish before the next inference batch is ready, so
inference never queues behind training.

The runtime consumes an ``ArrivalTrace`` through an injectable ``Clock``
and emits the engine's ``ExecutionReport``. Under a ``FakeClock`` with
fixed-duration step stubs its control flow replays the reference runtime's
float operations, so both give bitwise-equal latencies on one trace.

This slice serves one stream: a merged multi-tenant trace raises
``NotImplementedError`` until the multi-tenant engine is ported (ROADMAP
queue 1 item 2), and so does the reference's admission gate, which waits
for the closed loop (queue 1 item 1).

Duck-typed dependencies (so tests stub them without building models):
``trainer`` needs ``train_minibatch_time()`` and ``step_minibatch()``; the
server needs ``infer()``, whose result is waited for when it is a CUDA
tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.simulate import (ArrivalTrace, ExecutionReport,
                                       batch_ready_events)
from repro_torch.runtime.clock import Clock, WallClock
from repro_torch.runtime.serving import sync


@dataclasses.dataclass
class InterleaveConfig:
    arrival_rate: float            # requests / s (default uniform trace)
    infer_bs: int
    latency_budget: float          # s
    duration: float = 20.0         # horizon of the default uniform trace


class ManagedInterleaveRuntime:
    def __init__(self, trainer, server, cfg: InterleaveConfig,
                 trace: Optional[ArrivalTrace] = None,
                 clock: Optional[Clock] = None):
        """``trace`` defaults to the config's uniform-rate arrivals."""
        self.trainer = trainer
        self.server = server
        self.cfg = cfg
        # None => a fresh WallClock anchored at run() entry, so setup work
        # (model building, the trainer's timing measurement) does not count
        # as elapsed serving time
        self.clock = clock
        self.trace = trace if trace is not None else \
            ArrivalTrace.uniform(cfg.arrival_rate, cfg.duration)
        if self.trace.stream_ids is not None:
            raise NotImplementedError(
                "the port's runtime serves one stream; merged multi-tenant "
                "traces wait for the multi-tenant engine (ROADMAP queue 1 "
                "item 2)")
        self.t_tr = trainer.train_minibatch_time() if trainer else float("inf")

    def run(self) -> ExecutionReport:
        """Serve the trace: minibatch-ready events in time order, training
        filling the slack before each event."""
        clock = self.clock if self.clock is not None else WallClock()
        bs = self.cfg.infer_bs
        arrivals = self.trace.times.tolist()
        latencies: list[float] = []
        trained = 0
        for ready, _, start in batch_ready_events([arrivals], [bs]):
            # fill slack with training minibatches predicted to finish
            # before the batch is ready (inference never queues)
            while self.trainer and clock.now() + self.t_tr <= ready:
                self.trainer.step_minibatch()
                trained += 1
            clock.sleep_until(ready)           # wait for the batch to form
            sync(self.server.infer())
            done = clock.now()
            latencies.extend(done - arrivals[i] for i in range(start, start + bs))
        return ExecutionReport("managed-real", latencies, trained,
                               max(self.trace.duration, 1e-9), power=0.0,
                               trace=self.trace)

