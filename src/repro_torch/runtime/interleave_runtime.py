"""Real-mode managed interleaving: Fulcrum's executor over real PyTorch
steps on the card (``repro.runtime.interleave_runtime`` on PyTorch).

This is the wall-clock counterpart of the engine's managed kernel
(``core.simulate``): one program owns the device, alternating training
minibatches with inference minibatches, switching only at minibatch
boundaries. A training step is launched only if it is predicted (from its
measured step time) to finish before the next inference batch is ready, so
inference never queues behind training.

The runtime consumes an ``ArrivalTrace`` — including a merged
multi-tenant trace, served in the (ready time, stream) event order of
``core.simulate.simulate_multi_tenant`` — through an injectable ``Clock``,
and emits the engine's ``ExecutionReport`` (a ``MultiTenantReport`` for a
merged trace). Under a ``FakeClock`` with fixed-duration step stubs its
control flow replays the reference runtime's float operations, so both
give bitwise-equal latencies on one trace. An optional admission gate
(``core.controller.AdmissionPolicy.gate``) trims a single-stream trace
before serving, shedding the requests the engine-side mask would shed.
``attach_drift`` records the sim-vs-real drift against an engine report
for the same trace and plan.

Duck-typed dependencies (so tests stub them without building models):
``trainer`` needs ``train_minibatch_time()`` and ``step_minibatch()``;
each server needs ``infer()``, whose result is waited for when it is a
CUDA tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.simulate import (ArrivalTrace, ExecutionReport,
                                       MultiTenantReport, batch_ready_events)
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
                 clock: Optional[Clock] = None,
                 servers: Optional[Sequence] = None,
                 bss: Optional[Sequence[int]] = None,
                 admission=None):
        """``trace`` defaults to the config's uniform-rate arrivals. For a
        merged multi-tenant trace pass ``servers`` (one per stream, in
        stream-id order) and optionally per-stream ``bss``; ``run`` then
        returns one report per tenant. ``admission`` is an optional
        trace-trimming gate (``AdmissionPolicy.gate(...)``) applied to a
        single-stream trace before serving: ``gate(trace) ->
        (admitted_trace, n_shed)``, the shed count landing on the report's
        ``shed_requests``."""
        self.trainer = trainer
        self.servers = list(servers) if servers is not None else [server]
        self.cfg = cfg
        # None => a fresh WallClock anchored at run() entry, so setup work
        # (model building, the trainer's timing measurement) does not count
        # as elapsed serving time
        self.clock = clock
        self.trace = trace if trace is not None else \
            ArrivalTrace.uniform(cfg.arrival_rate, cfg.duration)
        self.bss = [int(b) for b in bss] if bss is not None \
            else [cfg.infer_bs] * len(self.servers)
        self.t_tr = trainer.train_minibatch_time() if trainer else float("inf")
        self.admission = admission
        self.shed_requests = 0
        if admission is not None:
            if self.trace.stream_ids is not None:
                raise ValueError("runtime admission gates single-stream "
                                 "traces only")
            self.trace, self.shed_requests = admission(self.trace)

    def _stream_traces(self) -> list[ArrivalTrace]:
        if self.trace.stream_ids is not None:
            return self.trace.split()
        return [self.trace]

    def run(self):
        """Serve the trace: per-stream minibatch-ready events in
        (time, stream) order — the engine's merge order — training filling
        the slack before each event. Returns an ``ExecutionReport`` for a
        single-stream trace, a ``MultiTenantReport`` for a merged one."""
        traces = self._stream_traces()
        if len(traces) != len(self.servers):
            raise ValueError(f"{len(traces)} trace streams need "
                             f"{len(traces)} servers, got "
                             f"{len(self.servers)}")
        clock = self.clock if self.clock is not None else WallClock()
        arrivals = [tr.times.tolist() for tr in traces]
        events = batch_ready_events(arrivals, self.bss)
        latencies: list[list[float]] = [[] for _ in traces]
        trained = 0
        for ready, j, start in events:
            # fill slack with training minibatches predicted to finish
            # before the batch is ready (inference never queues)
            while self.trainer and clock.now() + self.t_tr <= ready:
                self.trainer.step_minibatch()
                trained += 1
            clock.sleep_until(ready)           # wait for the batch to form
            sync(self.servers[j].infer())
            done = clock.now()
            latencies[j].extend(done - arrivals[j][i]
                                for i in range(start, start + self.bss[j]))
        duration = max(self.trace.duration, 1e-9)
        reports = [ExecutionReport("managed-real", lat, 0, duration,
                                   power=0.0, trace=tr)
                   for lat, tr in zip(latencies, traces)]
        if len(reports) == 1:
            reports[0].train_minibatches = trained
            reports[0].shed_requests = self.shed_requests
            return reports[0]
        return MultiTenantReport(reports, trained, duration, power=0.0,
                                 trace=self.trace)


def attach_drift(report: ExecutionReport,
                 reference: ExecutionReport) -> float:
    """Record sim-vs-real drift: the max |Δlatency| between a runtime report
    and the engine's report for the same trace and plan, stored on the
    runtime report (``drift_s``) and returned. The reports must cover the
    same requests."""
    a = np.asarray(report.latencies, np.float64)
    b = np.asarray(reference.latencies, np.float64)
    if a.size != b.size:
        raise ValueError(f"reports serve different request counts "
                         f"({a.size} vs {b.size}); drift needs a shared "
                         f"trace and plan")
    report.drift_s = float(np.max(np.abs(a - b))) if a.size else 0.0
    return report.drift_s
