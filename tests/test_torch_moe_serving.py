"""The serving side of the port's MoE family against the JAX package:
``prefill`` and ``decode_step`` with their caches, ``GenerationServer``,
the load-time cast and the launchers, on the reduced ``mixtral-8x22b``
(sliding window 64) and ``arctic-480b`` (128 experts cut to 4, the dense
residual branch) in float32 compute.

Parameters are ``test_torch_families.numpy_params`` (every leaf drawn from
a seed). A prompt of 100 tokens runs past Mixtral's reduced window: K3's
window masks its prefill and the 64-slot ring buffer wraps. Prefill logits
and every cache entry, then 4 decode steps' logits and caches, within 1e-4
of the largest |value|; greedy tokens equal. Each case prints the smallest
top-k margin of its routing (``test_torch_moe.near_ties``): where it fell
within 1e-6 of a tie the two packages could route apart (none did).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.runtime import serving as JSV
from repro_torch import tree as T
from repro_torch.convert import model_params
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.runtime import serving as TSV
from test_torch_families import cfgs, numpy_batch, numpy_params, to_jax, \
    to_torch, within
from test_torch_families_serving import _caches_within
from test_torch_moe import MOE_ARCHS, margins  # noqa: F401 (a fixture)

TOL = 1e-4
T_PROMPT, DECODE_STEPS = 100, 4


@pytest.fixture(scope="module", params=MOE_ARCHS)
def served(request):
    """The reduced float32 pair of one MoE configuration, a NumPy parameter
    tree on both sides, and the reference's prefill of a T_PROMPT-token
    prompt into a cache for T_PROMPT + DECODE_STEPS, then its decode steps
    (tokens, logits and caches)."""
    arch = request.param
    jcfg, tcfg = cfgs(arch)
    ptree = numpy_params(jcfg, 70 + MOE_ARCHS.index(arch))
    jp = jax.tree.map(jnp.asarray, ptree)
    prompt = numpy_batch(tcfg, 71, s=T_PROMPT, kind="prefill")
    max_seq = T_PROMPT + DECODE_STEPS
    jlog, jc = jax.jit(JM.prefill, static_argnums=(2, 3, 4))(
        jp, to_jax(prompt), jcfg, max_seq, jnp.float32)
    rng = np.random.default_rng(72)
    jdec = jax.jit(JM.decode_step, static_argnums=4)
    steps = [(np.asarray(jlog), jax.tree.map(np.asarray, jc))]
    toks = []
    for step in range(DECODE_STEPS):
        tok = rng.integers(0, tcfg.vocab_size, (2, 1)).astype(np.int32)
        pos = np.full((2,), T_PROMPT + step, np.int32)
        jd, jc = jdec(jp, jc, {"tokens": jnp.asarray(tok)}, jnp.asarray(pos),
                      jcfg)
        toks.append((tok, pos))
        steps.append((np.asarray(jd), jax.tree.map(np.asarray, jc)))
    return {"arch": arch, "jcfg": jcfg, "tcfg": tcfg, "ptree": ptree,
            "tp": model_params(ptree, tcfg), "prompt": prompt,
            "max_seq": max_seq, "steps": steps, "toks": toks}


def test_moe_prefill_and_decode_match_the_reference_in_f32(served, margins):
    f = served
    tcfg = f["tcfg"]
    tlog, tc = TM.prefill(f["tp"], to_torch(f["prompt"]), tcfg,
                          f["max_seq"], cache_dtype=torch.float32)
    what = f"{f['arch']} (smallest top-k margin {min(margins):.3g})"
    print(what)
    jlog, jc = f["steps"][0]
    assert tuple(tlog.shape) == jlog.shape
    within(tlog.numpy(), jlog, TOL, f"{what} prefill logits")
    _caches_within(tc, jc, f"{what} prefill cache")
    clen = TM.cache_len_for(tcfg, f["max_seq"])
    assert tc["kv"]["k"].shape[2] == clen
    if tcfg.sliding_window:                     # the ring buffer wrapped
        assert clen == tcfg.sliding_window < T_PROMPT
    for step, (tok, pos) in enumerate(f["toks"]):
        td, tc = TM.decode_step(f["tp"], tc, {"tokens": torch.from_numpy(tok)},
                                torch.from_numpy(pos), tcfg)
        jd, jc = f["steps"][step + 1]
        within(td.numpy(), jd, TOL, f"{what} decode {step}")
        _caches_within(tc, jc, f"{what} decode {step} cache")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_generate_gives_the_reference_tokens_in_f32(arch, margins):
    """Greedy tokens of the reference's ``GenerationServer`` (its jitted
    prefill / decode loop) from the same parameters."""
    jcfg, tcfg = cfgs(arch)
    ptree = numpy_params(jcfg, 80 + MOE_ARCHS.index(arch))
    bs, plen, steps = 2, 24, 8
    jsrv = JSV.GenerationServer(jcfg, max_seq=plen + steps, bs=bs, seed=0)
    jsrv.params = jax.tree.map(jnp.asarray, ptree)
    tsrv = TSV.GenerationServer(tcfg, max_seq=plen + steps, bs=bs,
                                backend="cpu",
                                params=model_params(ptree, tcfg))
    prompt = numpy_batch(tcfg, 81, b=bs, s=plen, kind="prefill")
    want = jsrv.generate(to_jax(prompt), steps, plen)
    got = tsrv.generate(to_torch(prompt), steps, plen)
    assert got.shape == (bs, steps)
    np.testing.assert_array_equal(
        got, want, err_msg=f"smallest top-k margin {min(margins):.3g}")


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_load_params_keeps_the_router_float32(arch, given):
    """The server's weights, drawn (cast one expert matrix at a time) or
    given: every matrix in the compute dtype but the router, which stays
    float32, and drawn weights bitwise the cast of the float32 draw."""
    _, tcfg = cfgs(arch, f32=False)
    drawn = TM.init_params(tcfg, torch.Generator().manual_seed(3))
    got = TSV._load_params(tcfg, 3, drawn if given else None,
                           torch.device("cpu"))
    want = TM.cast_params(drawn, tcfg.compute_dtype)
    for a, b in zip(T.leaves(got), T.leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for layer in got["layers"]:
        assert layer["moe"]["router"].dtype == torch.float32
        assert layer["moe"]["w1"].dtype == torch.bfloat16
        assert layer["attn"]["wq"]["w"].dtype == torch.bfloat16


def test_a_bf16_router_would_move_the_routing():
    """Why the router stays float32: rounding it to bf16 routes some of
    these tokens to other experts."""
    _, tcfg = cfgs("mixtral-8x22b", f32=False)
    p = TM.init_params(tcfg, torch.Generator().manual_seed(4))
    router = p["layers"][0]["moe"]["router"]
    x = torch.randn((8, 128, tcfg.d_model),
                    generator=torch.Generator().manual_seed(5))
    spec = tcfg.moe_spec
    f32 = TL.moe_route(router, x, spec).expert
    bf16 = TL.moe_route(router.to(torch.bfloat16).float(), x, spec).expert
    assert (f32 != bf16).any()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_runs_the_reduced_moe(arch, capsys):
    tserve.main(["--arch", arch, "--reduced", "--backend", "cpu",
                 "--requests", "2", "--bs", "2", "--gen", "3"])
    out = capsys.readouterr().out
    assert "batch 0: 2x3 tokens" in out and arch in out


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_cli_trains_the_reduced_moe(arch, capsys):
    ttrain.main(["--arch", arch, "--reduced", "--backend", "cpu", "--steps",
                 "3", "--batch", "2", "--seq", "24"])
    out = capsys.readouterr().out
    assert "done: loss" in out and "nan" not in out and "(moe)" in out


def test_prefill_drops_choices_and_decode_does_not(monkeypatch):
    """At capacity factor 0.5 a 100-token prefill drops choices in every
    layer, the logits still the reference's (which drops the same ones);
    decode's one-token groups never drop (capacity is at least top_k)."""
    jcfg, tcfg = cfgs("arctic-480b", capacity_factor=0.5)
    ptree = numpy_params(jcfg, 90)
    prompt = numpy_batch(tcfg, 91, s=T_PROMPT, kind="prefill")
    max_seq = T_PROMPT + 1
    jlog, _ = JM.prefill(jax.tree.map(jnp.asarray, ptree), to_jax(prompt),
                         jcfg, max_seq, jnp.float32)
    dropped = []
    route = TL.moe_route

    def counting(router, xg, spec):
        r = route(router, xg, spec)
        dropped.append(int((~r.keep).sum()))
        return r
    monkeypatch.setattr(TL, "moe_route", counting)
    tp = model_params(ptree, tcfg)
    tlog, tc = TM.prefill(tp, to_torch(prompt), tcfg, max_seq,
                          cache_dtype=torch.float32)
    TM.decode_step(tp, tc, {"tokens": torch.zeros((2, 1), dtype=torch.int32)},
                   torch.full((2,), T_PROMPT, dtype=torch.int32), tcfg)
    n = tcfg.num_layers
    assert len(dropped) == 2 * n
    assert all(d > 0 for d in dropped[:n]) and dropped[n:] == [0] * n
    within(tlog.numpy(), jlog, TOL, "prefill logits at capacity factor 0.5")
