"""The pod layer's arithmetic in the port against the JAX package: the
knob adapter (``core.gpu_adapter`` against ``repro.core.tpu_adapter``), the
assigned input shapes and ``input_specs`` (``configs.base``), and the dry
run's analytic model (``launch.dryrun``), for every registered
configuration at full size.

The adapter is held with the reference's v5e constants and knob space
passed in: every mode's time and HBM within 1e-12 relative, GMD's plan,
time, HBM and profile count, and the exhaustive best, equal. Then the
port's own defaults (the H100's constants, a four-card host) keep the
properties the reference's tests ask of its own (HBM monotone in every
knob, the plan within the budget and near the oracle).
"""
import jax
import pytest

from repro.configs import base as RC
from repro.core import tpu_adapter as RA
from repro.launch import dryrun as RD
from repro.launch import mesh as RMESH
from repro_torch.configs import base as TC
from repro_torch.core import gpu_adapter as GA
from repro_torch.launch import dryrun as TD
from repro_torch.launch import mesh as TMESH

V5E = TMESH.Hardware(RMESH.PEAK_FLOPS_BF16, RMESH.HBM_BW, RMESH.ICI_BW,
                     float(RMESH.HBM_BYTES))
SHAPES = list(RC.INPUT_SHAPES)


def pair(arch: str, shape: str, chips: int = 256):
    """The reference's model and space, the port's with the v5e numbers."""
    s = RC.INPUT_SHAPES[shape]
    ref = RA.RooflineTPUModel(RC.get_config(arch), s.seq_len, s.global_batch,
                              s.kind, chips)
    port = GA.RooflineGPUModel(TC.get_config(arch), s.seq_len,
                               s.global_batch, s.kind, chips, hw=V5E)
    rs = RA.TPUKnobSpace(chips)
    ps = GA.GPUKnobSpace(chips, **rs.values)
    return ref, port, rs, ps


def knobs(mode) -> tuple:
    return (mode.tp, mode.acc, mode.remat)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_time_and_hbm_match_at_every_mode(arch, shape):
    ref, port, rs, ps = pair(arch, shape)
    modes = rs.all_modes()
    assert [knobs(m) for m in ps.all_modes()] == [knobs(m) for m in modes]
    for rm, pm in zip(modes, ps.all_modes()):
        want, got = ref.time_power(rm), port.time_power(pm)
        for g, w in zip(got, want):
            assert abs(g - w) <= 1e-12 * abs(w), (str(rm), got, want)
        assert str(pm) == str(rm)


@pytest.mark.parametrize("chips", [256, 512])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_gmd_plan_and_exhaustive_best_match(arch, shape, chips):
    ref, port, rs, ps = pair(arch, shape, chips)
    rg, pg = RA.GMDForTPU(ref, rs), GA.GMDForGPU(port, ps)
    want, got = rg.solve(), pg.solve()
    assert pg.num_profiles == rg.num_profiles
    assert pg.hbm_budget == float(RMESH.HBM_BYTES)
    if want is None:
        assert got is None
    else:
        assert knobs(got.pm) == knobs(want.pm)
        assert (got.time, got.power, got.throughput) == \
            (want.time, want.power, want.throughput)
    want_best, got_best = RA.exhaustive_best(ref, rs), \
        GA.exhaustive_best(port, ps)
    if want_best is None:
        assert got_best is None
    else:
        assert knobs(got_best[0]) == knobs(want_best[0])
        assert got_best[1:] == want_best[1:]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_input_specs_match(arch, shape):
    rs, ts = RC.INPUT_SHAPES[shape], TC.INPUT_SHAPES[shape]
    assert (ts.name, ts.seq_len, ts.global_batch, ts.kind) == \
        (rs.name, rs.seq_len, rs.global_batch, rs.kind)
    want = RC.input_specs(RC.get_config(arch), rs)
    got = TC.input_specs(TC.get_config(arch), ts)
    flat_want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
                 for k, v in jax.tree_util.tree_leaves_with_path(want)}
    flat_got = {}

    def walk(tree, key):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{key}[{k!r}]")
        else:
            shape_, dtype = tree
            flat_got[key] = (tuple(shape_), str(dtype).split(".")[-1])
    walk(got, "")
    assert flat_got == flat_want


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_dryrun_analytics_match(arch):
    jcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    for name in SHAPES:
        assert TD.analytic_model_flops(tcfg, TC.INPUT_SHAPES[name]) == \
            RD.analytic_model_flops(jcfg, RC.INPUT_SHAPES[name])
    l1, l2 = TD._probe_depths(tcfg)
    assert (l1, l2) == RD._probe_depths(jcfg)
    for v1, v2 in ((1.5e12, 2.75e12), (3.0, 2.0), (0.0, 7.25e9)):
        assert TD._lin_extrapolate(v1, v2, l1, l2, tcfg.num_layers) == \
            RD._lin_extrapolate(v1, v2, l1, l2, jcfg.num_layers)


def test_h100_defaults():
    assert TMESH.H100 == TMESH.Hardware(989e12, 3.35e12, 450e9, 80e9)
    sp = GA.GPUKnobSpace()
    assert sp.chips == GA.CHIPS == 4
    assert sp.values == {"tp": [1, 2, 4], "acc": [1, 2, 4, 8, 16],
                         "remat": [0, 1]}
    m = GA.RooflineGPUModel(TC.get_config("mixtral-8x22b"), 4096, 256)
    assert m.hw is TMESH.H100 and m.chips == 4
    assert GA.GMDForGPU(m).hbm_budget == 80e9


# (arch, shape) where a mode fits the card but GMD's search returns no plan:
# its probes and line searches never reach the one fitting mode (remat on,
# one microbatch). Pinned so that a change in the misses shows.
H100_GMD_MISSES = {("musicgen-medium", "prefill_32k")}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_h100_plan_within_budget_and_near_the_oracle(arch, shape):
    """On the four-card host: HBM monotone along every knob, and where a
    mode fits, GMD's plan fits and is within 25% of the oracle's time, as
    the reference's tests ask of its own space; except at the pinned
    misses, where GMD returns no plan although the oracle finds one."""
    s = TC.INPUT_SHAPES[shape]
    m = GA.RooflineGPUModel(TC.get_config(arch), s.seq_len, s.global_batch,
                            s.kind)
    sp = GA.GPUKnobSpace()
    for dim, vals in sp.values.items():
        hbm = [m.time_power(sp.midpoint().replace(**{dim: v}))[1]
               for v in vals]
        assert hbm == sorted(hbm), dim
    g = GA.GMDForGPU(m)
    sol, opt = g.solve(), GA.exhaustive_best(m)
    assert g.num_profiles <= 18
    if (arch, shape) in H100_GMD_MISSES:
        assert sol is None and opt is not None
    elif opt is None:
        assert sol is None
    else:
        assert sol is not None and sol.power <= TMESH.HBM_BYTES
        assert sol.time <= opt[1] * 1.25


@pytest.mark.parametrize("tokens", [512, 4096])
@pytest.mark.parametrize("kind", ["train", "infer"])
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_workload_from_model_config_is_the_references(arch, kind, tokens):
    """The scheduler's profile of a registered configuration, field for
    field and bitwise (the default ``tokens_per_sample`` is 512)."""
    import dataclasses

    from repro.core.device_model import workload_from_model_config as ref
    from repro_torch.core.device_model import workload_from_model_config
    kw = {} if tokens == 512 else {"tokens_per_sample": tokens}
    want = ref(RC.get_config(arch), kind, **kw)
    got = workload_from_model_config(TC.get_config(arch), kind, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
