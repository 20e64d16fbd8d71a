"""The port's serving path against the JAX package: greedy generation,
the real-mode managed interleave runtime, and the serving CLI.

``GenerationServer.generate`` on the reduced Zamba2 with the reference's
converted params gives the reference's tokens over 8 steps in float32
compute. ``ManagedInterleaveRuntime`` under a ``FakeClock`` with
fixed-duration stubs gives the reference runtime's latencies and training
counts bitwise on the same trace (the same float operations in the same
order), for one stream and for a merged multi-tenant trace;
``attach_drift`` records the same drift as the reference's. The CLI runs
with ``--reduced`` on ``cpu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import simulate as JS
from repro.runtime import serving as JSV
from repro.runtime.clock import FakeClock as JFakeClock
from repro.runtime.interleave_runtime import InterleaveConfig as JICfg
from repro.runtime.interleave_runtime import \
    ManagedInterleaveRuntime as JRuntime
from repro.runtime.interleave_runtime import attach_drift as j_attach_drift
from repro_torch.configs import base as TC
from repro_torch.convert import arrival_trace, model_params
from repro_torch.core import simulate as TS
from repro_torch.launch import serve as tserve
from repro_torch.runtime import serving as TSV
from repro_torch.runtime.clock import FakeClock, WallClock
from repro_torch.runtime.interleave_runtime import (InterleaveConfig,
                                                    ManagedInterleaveRuntime,
                                                    attach_drift)


def test_generate_gives_the_reference_tokens_in_f32():
    jcfg = dataclasses.replace(j_reduced(j_get_config("zamba2-1.2b")),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(TC.reduced(TC.get_config("zamba2-1.2b")),
                               compute_dtype=torch.float32)
    bs, plen, steps = 2, 24, 8
    jsrv = JSV.GenerationServer(jcfg, max_seq=plen + steps, bs=bs, seed=0)
    tsrv = TSV.GenerationServer(
        tcfg, max_seq=plen + steps, bs=bs, backend="cpu",
        params=model_params(jax.tree.map(np.asarray, jsrv.params), tcfg))
    toks = np.random.default_rng(0).integers(0, 512, (bs, plen)).astype(np.int32)
    want = jsrv.generate({"tokens": jnp.asarray(toks)}, steps, plen)
    timings = {}
    got = tsrv.generate({"tokens": torch.from_numpy(toks)}, steps, plen,
                        timings=timings)
    assert got.shape == (bs, steps)
    np.testing.assert_array_equal(got, want)
    assert len(timings["decode_s"]) == steps and timings["prefill_s"] > 0


class _Trainer:
    def __init__(self, clock, t_tr):
        self.clock, self.t_tr = clock, t_tr

    def train_minibatch_time(self):
        return self.t_tr

    def step_minibatch(self):
        self.clock.advance(self.t_tr)


class _Server:
    def __init__(self, clock, t_in):
        self.clock, self.t_in = clock, t_in

    def infer(self):
        self.clock.advance(self.t_in)


@pytest.mark.parametrize("seed", range(4))
def test_runtime_matches_the_reference_runtime_bitwise(seed):
    rng = np.random.default_rng(seed)
    bs = int(rng.choice([1, 4, 8]))
    t_in = float(rng.uniform(0.005, 0.08))
    t_tr = None if seed == 1 else float(rng.uniform(0.01, 0.2))
    rate = float(rng.uniform(10, 80))
    jtrace = JS.ArrivalTrace.poisson(rate, 15.0, seed=seed)
    ttrace = arrival_trace(jtrace.times, jtrace.duration, jtrace.kind)

    def run(Runtime, Cfg, Clock, trace):
        clock = Clock()
        rt = Runtime(_Trainer(clock, t_tr) if t_tr else None,
                     _Server(clock, t_in),
                     Cfg(arrival_rate=rate, infer_bs=bs, latency_budget=0.2),
                     trace=trace, clock=clock)
        return rt.run()

    want = run(JRuntime, JICfg, JFakeClock, jtrace)
    got = run(ManagedInterleaveRuntime, InterleaveConfig, FakeClock, ttrace)
    assert got.latencies == want.latencies
    assert got.train_minibatches == want.train_minibatches
    assert got.duration == want.duration


def test_runtime_default_trace_and_merged_traces():
    clock = FakeClock()
    cfg = InterleaveConfig(arrival_rate=20.0, infer_bs=4, latency_budget=0.1,
                           duration=2.0)
    rep = ManagedInterleaveRuntime(None, _Server(clock, 0.01), cfg,
                                   clock=clock).run()
    assert len(rep.latencies) == 40 and rep.trace.kind == "uniform"
    assert rep.latencies[3] == pytest.approx(0.01) and rep.train_minibatches == 0
    merged = TS.ArrivalTrace.merge([TS.ArrivalTrace.uniform(10.0, 1.0)] * 2)
    clock = FakeClock()
    rep = ManagedInterleaveRuntime(None, None, cfg, trace=merged, clock=clock,
                                   servers=[_Server(clock, 0.01)] * 2).run()
    assert isinstance(rep, TS.MultiTenantReport) and len(rep.streams) == 2
    assert [len(r.latencies) for r in rep.streams] == [8, 8]
    with pytest.raises(ValueError, match="servers"):
        ManagedInterleaveRuntime(None, _Server(clock, 0.01), cfg,
                                 trace=merged, clock=clock).run()


def test_runtime_merged_trace_matches_the_reference_runtime_bitwise():
    """A merged 2-tenant trace with per-stream minibatch sizes and a
    trainer, under each package's FakeClock with the same fixed step
    times: the same latencies per tenant and the same training count."""
    t_ins, t_tr, bss = [0.013, 0.041], 0.07, [4, 16]
    jtraces = [JS.ArrivalTrace.poisson(30.0, 15.0, seed=1),
               JS.ArrivalTrace.uniform(50.0, 15.0)]
    jmerged = JS.ArrivalTrace.merge(jtraces)
    tmerged = arrival_trace(jmerged.times, jmerged.duration, jmerged.kind,
                            jmerged.stream_ids, jmerged.n_streams)

    def run(Runtime, Cfg, Clock, trace):
        clock = Clock()
        return Runtime(_Trainer(clock, t_tr), None,
                       Cfg(arrival_rate=0.0, infer_bs=4, latency_budget=0.5),
                       trace=trace, clock=clock,
                       servers=[_Server(clock, t) for t in t_ins],
                       bss=bss).run()

    want = run(JRuntime, JICfg, JFakeClock, jmerged)
    got = run(ManagedInterleaveRuntime, InterleaveConfig, FakeClock, tmerged)
    assert len(got.streams) == len(want.streams) == 2
    for a, b in zip(got.streams, want.streams):
        assert a.latencies == b.latencies and len(a.latencies) > 0
    assert got.train_minibatches == want.train_minibatches > 0
    assert got.duration == want.duration


def test_attach_drift_records_the_largest_latency_gap():
    """``attach_drift`` against the reference's on the same reports, and
    the runtime under a FakeClock against the port's engine: zero drift on
    an uncongested trace."""
    a = TS.ExecutionReport("managed-real", [0.1, 0.25, 0.3], 0, 1.0, 0.0)
    b = TS.ExecutionReport("managed", [0.1, 0.2, 0.35], 0, 1.0, 0.0)
    ja = JS.ExecutionReport("managed-real", [0.1, 0.25, 0.3], 0, 1.0, 0.0)
    jb = JS.ExecutionReport("managed", [0.1, 0.2, 0.35], 0, 1.0, 0.0)
    assert attach_drift(a, b) == j_attach_drift(ja, jb) == a.drift_s
    assert a.drift_s == pytest.approx(0.05)
    with pytest.raises(ValueError, match="shared"):
        attach_drift(a, TS.ExecutionReport("managed", [0.1], 0, 1.0, 0.0))
    from repro_torch.core.device_model import DeviceModel, INFER_WORKLOADS
    from repro_torch.core.powermode import PowerModeSpace
    dev, pm, w = DeviceModel(), PowerModeSpace().maxn(), \
        INFER_WORKLOADS["resnet50"]
    t_in = dev.time_power(w, pm, 8)[0]
    trace = TS.ArrivalTrace.uniform(40.0, 10.0)
    clock = FakeClock()
    rep = ManagedInterleaveRuntime(
        None, _Server(clock, t_in),
        InterleaveConfig(arrival_rate=40.0, infer_bs=8, latency_budget=0.5),
        trace=trace, clock=clock).run()
    eng = TS.simulate(dev, None, w, pm, 8, trace, backend="cpu")
    assert attach_drift(rep, eng) <= 1e-8 and rep.drift_s <= 1e-8


def test_batch_inference_server_serves_a_trace_on_the_cpu():
    cfg = TC.reduced(TC.get_config("zamba2-1.2b"))
    srv = TSV.BatchInferenceServer(cfg, seq_len=32, bs=2, backend="cpu")
    out = srv.infer()
    assert out.shape == (2, 32, cfg.padded_vocab)
    assert out.dtype == cfg.compute_dtype and bool(torch.isfinite(out.float()).all())
    t_mb = srv.minibatch_time(iters=1)
    assert t_mb > 0
    trace = TS.ArrivalTrace.uniform(4.0, 1.0)
    rep = ManagedInterleaveRuntime(
        None, srv, InterleaveConfig(4.0, 2, 1.0), trace=trace,
        clock=WallClock()).run()
    assert len(rep.latencies) == 4 and min(rep.latencies) > 0
    if not torch.cuda.is_available():          # the default never degrades
        with pytest.raises(RuntimeError, match="CUDA"):
            TSV.BatchInferenceServer(cfg, seq_len=32, bs=2)


def test_serve_cli_runs_reduced_on_the_cpu(capsys):
    tserve.main(["--arch", "zamba2-1.2b", "--reduced", "--backend", "cpu",
                 "--requests", "2", "--bs", "2", "--prompt-len", "16",
                 "--gen", "3"])
    out = capsys.readouterr().out
    assert "serving zamba2-1.2b (2 layers, d_model 256) on cpu" in out
    assert "batch 0: 2x3 tokens" in out
