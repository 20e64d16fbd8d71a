"""The serving side of the port's dense, ssm, vlm and audio families against
the JAX package: ``prefill`` and ``decode_step`` with their caches, the int8
KV cache, the data pipeline's vlm and audio batches, ``GenerationServer``
and the launchers.

Parameters are ``test_torch_families.numpy_params`` (every leaf drawn from
a seed) at the reduced sizes in float32 compute. Tolerances: prefill logits
and every float32 cache entry, then 4 decode steps' logits and caches,
within 1e-4 of the largest |value| (``within``); the data pipeline's
batches, ``quantize_kv`` and the composition of the int8 prefill cache
bitwise; greedy tokens equal.

The int8 cache across the packages: the two float32 computations of a key
agree to ~1e-6, so where the reference's float32 quotient ``x / scale``
lies within that of a rounding boundary the two packages may round to
neighbouring int8 values. Cross-package int8 entries are held equal
wherever the reference's quotient is farther than ``QUOTIENT_SLACK`` (127 x
the 1e-4 float tolerance) from a half-integer, and within one step
elsewhere; decode logits within 1e-4 of the largest while both caches hold
the same bits, and within ``INT8_LOGIT_TOL`` (1e-3, about ten times what
one flipped entry moved them in these runs) after a step whose new entries
rounded apart. Both packages decode each step from the same cache.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticTokenSource as JSource
from repro.models import layers as JL
from repro.models import model as JM
from repro.runtime import serving as JSV
from repro_torch import tree as T
from repro_torch.convert import model_params
from repro_torch.data.pipeline import SyntheticTokenSource
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.runtime import serving as TSV
from test_torch_families import (FAMILIES, HEAD_DIM_NAMES, cfgs,
                                 head_dim_cfgs, numpy_batch, numpy_params,
                                 to_jax, to_torch, within)

TOL = 1e-4
QUOTIENT_SLACK = 127 * TOL
INT8_LOGIT_TOL = 1e-3
T_PROMPT, DECODE_STEPS = 40, 4


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    jcfg, tcfg = cfgs(request.param)
    ptree = numpy_params(jcfg, 20 + FAMILIES.index(request.param))
    return (request.param, jcfg, tcfg, jax.tree.map(jnp.asarray, ptree),
            model_params(ptree, tcfg), ptree)


def _keyed(tree) -> dict:
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _caches_within(got: dict, want, what: str) -> None:
    g, w = _keyed(got), _keyed(want)
    assert set(g) == set(w), what
    for k, v in w.items():
        assert tuple(g[k].shape) == v.shape, (what, k)
        within(g[k].float().numpy(), np.asarray(v, np.float32), TOL,
               f"{what} {k}")


def _decode_batch(cfg, rng) -> np.ndarray:
    cb = (cfg.n_codebooks,) if cfg.arch_type == "audio" else ()
    return rng.integers(0, cfg.vocab_size, (2, 1) + cb).astype(np.int32)


# ---------------------------------------------------------------------------
# prefill and decode, float32 caches
# ---------------------------------------------------------------------------

def test_prefill_and_decode_match_the_reference_in_f32(family):
    """A prompt of T_PROMPT positions into a cache for T_PROMPT +
    DECODE_STEPS, then DECODE_STEPS tokens; the ssm stack has no KV cache
    (``cache_len_for`` is 0)."""
    _prefill_and_decode(*family[:5])


def _prefill_and_decode(arch, jcfg, tcfg, jp, tp):
    """Prefill and DECODE_STEPS decode steps of both packages from the same
    parameters: logits and caches within TOL."""
    prompt = numpy_batch(tcfg, 3, s=T_PROMPT, kind="prefill")
    max_seq = T_PROMPT + DECODE_STEPS
    jlog, jc = jax.jit(JM.prefill, static_argnums=(2, 3, 4))(
        jp, to_jax(prompt), jcfg, max_seq, jnp.float32)
    tlog, tc = TM.prefill(tp, to_torch(prompt), tcfg, max_seq,
                          cache_dtype=torch.float32)
    assert tuple(tlog.shape) == jlog.shape
    within(tlog.numpy(), jlog, TOL, f"{arch} prefill logits")
    _caches_within(tc, jc, f"{arch} prefill cache")
    assert ("kv" in tc) == (TM.cache_len_for(tcfg, max_seq) > 0)

    rng = np.random.default_rng(4)
    jdec = jax.jit(JM.decode_step, static_argnums=4)
    for step in range(DECODE_STEPS):
        tok = _decode_batch(tcfg, rng)
        pos = np.full((2,), T_PROMPT + step, np.int32)
        jd, jc = jdec(jp, jc, {"tokens": jnp.asarray(tok)}, jnp.asarray(pos),
                      jcfg)
        td, tc = TM.decode_step(tp, tc, {"tokens": torch.from_numpy(tok)},
                                torch.from_numpy(pos), tcfg)
        within(td.numpy(), jd, TOL, f"{arch} decode {step}")
        _caches_within(tc, jc, f"{arch} decode {step} cache")


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mamba2-780m",
                                  "musicgen-medium"])
def test_decode_from_an_empty_cache_matches_the_reference(arch):
    jcfg, tcfg = cfgs(arch)
    ptree = numpy_params(jcfg, 30)
    jc, tc = JM.init_cache(jcfg, 2, 16), TM.init_cache(tcfg, 2, 16)
    assert {k: tuple(v.shape) for k, v in _keyed(tc).items()} == \
        {k: v.shape for k, v in _keyed(jc).items()}
    tok = _decode_batch(tcfg, np.random.default_rng(5))
    jd, _ = JM.decode_step(jax.tree.map(jnp.asarray, ptree), jc,
                           {"tokens": jnp.asarray(tok)},
                           jnp.zeros((2,), jnp.int32), jcfg)
    td, _ = TM.decode_step(model_params(ptree, tcfg), tc,
                           {"tokens": torch.from_numpy(tok)},
                           torch.zeros(2, dtype=torch.int32), tcfg)
    within(td.numpy(), jd, TOL, arch)


# ---------------------------------------------------------------------------
# the int8 KV cache
# ---------------------------------------------------------------------------

def test_quantize_kv_is_bitwise_the_references():
    """Random rows, rows whose quotients land exactly on halves (round half
    to even), an all-zero row (the 1e-6 floor), bf16 and float32 inputs."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 4, 64)).astype(np.float32)
    x[0, 0, 0] = np.arange(64) - 31.5          # amax 31.5: q = 127 x / 31.5
    x[0, 0, 1] = 0.0                           # scale 1: the halves tie
    x[0, 0, 1, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5]
    x[0, 1, 0] = 0.0                           # all zero: the 1e-6 floor
    for arr in (x, x.astype(jnp.bfloat16)):
        jq, js = JL.quantize_kv(jnp.asarray(arr))
        src = torch.from_numpy(np.asarray(arr, np.float32))
        if arr.dtype != np.float32:
            src = src.to(torch.bfloat16)
        tq, ts = TL.quantize_kv(src)
        assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.float().numpy(),
                                      np.asarray(js, np.float32))
    assert tq[0, 0, 1, :8].tolist() == [127, 0, 2, 2, 0, -2, 126, -126]


def _int8_pair(arch: str):
    jcfg, tcfg = cfgs(arch, kv_cache_quant=True)
    ptree = numpy_params(jcfg, 40)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, ptree),
            model_params(ptree, tcfg))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "internvl2-1b"])
def test_int8_prefill_cache_is_the_references_rounding(arch):
    """The port's int8 prefill cache is, bit for bit, the reference's own
    ``quantize_kv`` then ``_ring_fill`` of the port's float32 keys and
    values; and ``init_kv_cache`` gives the reference's int8 layout."""
    jcfg, tcfg, _, tp = _int8_pair(arch)
    prompt = to_torch(numpy_batch(tcfg, 7, s=T_PROMPT, kind="prefill"))
    max_seq = T_PROMPT + DECODE_STEPS
    _, cache = TM.prefill(tp, prompt, tcfg, max_seq)
    plain = dataclasses.replace(tcfg, kv_cache_quant=False)
    _, full = TM.prefill(tp, prompt, plain, T_PROMPT,
                         cache_dtype=torch.float32)      # every slot valid
    clen = TM.cache_len_for(tcfg, max_seq)
    for name in ("k", "v"):
        q, s = JL.quantize_kv(jnp.asarray(full["kv"][name].numpy()))
        wq, _, wpos = JM._ring_fill(q, q, clen)
        ws, _, _ = JM._ring_fill(s, s, clen)
        assert cache["kv"][name].dtype == torch.int8
        np.testing.assert_array_equal(cache["kv"][name].numpy(),
                                      np.asarray(wq))
        np.testing.assert_array_equal(
            cache["kv"][f"{name}_scale"].float().numpy(),
            np.asarray(ws, np.float32))
    np.testing.assert_array_equal(cache["kv_pos"][0, 0].numpy(),
                                  np.asarray(wpos))
    jinit = JM.init_cache(jcfg, 2, max_seq)
    tinit = TM.init_cache(tcfg, 2, max_seq)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in _keyed(tinit).items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in _keyed(jinit).items()}


def _quotient_margin(x: np.ndarray) -> np.ndarray:
    """Distance of ``x / scale`` (the reference's float32 quotient) from
    the nearest half-integer, per element of (..., D)."""
    x = np.asarray(x, np.float32)
    amax = np.abs(x).max(axis=-1, keepdims=True)
    u = x / (np.maximum(amax, np.float32(1e-6)) / np.float32(127.0))
    return np.abs(np.abs(u - np.floor(u)) - 0.5)


def _int8_close(got: np.ndarray, want: np.ndarray, margin: np.ndarray,
                what: str) -> int:
    """Equal where the reference's quotient is decided (margin >
    QUOTIENT_SLACK), within one step elsewhere; returns how many differ."""
    got, want = got.astype(np.int32), want.astype(np.int32)
    decided = margin > QUOTIENT_SLACK
    np.testing.assert_array_equal(got[decided], want[decided], err_msg=what)
    assert np.abs(got - want).max(initial=0) <= 1, what
    return int((got != want).sum())


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "internvl2-1b"])
def test_int8_cache_and_decode_match_the_reference(arch):
    """Prefill int8 caches of the two packages, then DECODE_STEPS steps,
    each from the same cache in both packages (the reference's)."""
    jcfg, tcfg, jp, tp = _int8_pair(arch)
    prompt = numpy_batch(tcfg, 8, s=T_PROMPT, kind="prefill")
    max_seq = T_PROMPT + DECODE_STEPS
    jlog, jc = JM.prefill(jp, to_jax(prompt), jcfg, max_seq)
    tlog, tc = TM.prefill(tp, to_torch(prompt), tcfg, max_seq)
    within(tlog.numpy(), jlog, TOL, "prefill logits")
    _, jfull = JM.prefill(jp, to_jax(prompt), dataclasses.replace(
        jcfg, kv_cache_quant=False), max_seq, jnp.float32)
    for name in ("k", "v"):
        _int8_close(tc["kv"][name].numpy(), np.asarray(jc["kv"][name]),
                    _quotient_margin(jfull["kv"][name]), f"prefill {name}")
        np.testing.assert_allclose(
            tc["kv"][f"{name}_scale"].float().numpy(),
            np.asarray(jc["kv"][f"{name}_scale"], np.float32), rtol=2 ** -8)
    np.testing.assert_array_equal(tc["kv_pos"].numpy(),
                                  np.asarray(jc["kv_pos"]))

    rng = np.random.default_rng(9)
    plain = dataclasses.replace(jcfg, kv_cache_quant=False)
    jdec = jax.jit(JM.decode_step, static_argnums=4)
    for step in range(DECODE_STEPS):
        same = jax.tree.map(np.asarray, jc)
        tcache = {"kv": {k: torch.from_numpy(np.array(v, np.float32)
                                             ).to(torch.bfloat16)
                         if "scale" in k else torch.from_numpy(np.array(v))
                         for k, v in same["kv"].items()},
                  "kv_pos": torch.from_numpy(np.array(same["kv_pos"]))}
        tok = rng.integers(0, tcfg.vocab_size, (2, 1)).astype(np.int32)
        pos = np.full((2,), T_PROMPT + step, np.int32)
        jd, jc = jdec(jp, jc, {"tokens": jnp.asarray(tok)}, jnp.asarray(pos),
                      jcfg)
        td, tcache = TM.decode_step(tp, tcache,
                                    {"tokens": torch.from_numpy(tok)},
                                    torch.from_numpy(pos), tcfg)
        # the reference's float32 new keys and values, for the margins
        jf = {"kv_pos": same["kv_pos"], "kv": {
            k: np.asarray(same["kv"][k], np.float32)
            * np.asarray(same["kv"][f"{k}_scale"], np.float32)
            for k in ("k", "v")}}
        _, jfc = jdec(jp, jf, {"tokens": jnp.asarray(tok)}, jnp.asarray(pos),
                      plain)
        slot = (T_PROMPT + step) % TM.cache_len_for(tcfg, max_seq)
        flips = 0
        for name in ("k", "v"):
            flips += _int8_close(
                tcache["kv"][name][:, :, slot].numpy(),
                np.asarray(jc["kv"][name][:, :, slot]),
                _quotient_margin(jfc["kv"][name][:, :, slot]),
                f"decode {step} {name}")
        within(td.numpy(), jd, TOL if flips == 0 else INT8_LOGIT_TOL,
               f"decode {step} logits ({flips} entries rounded apart)")


def test_int8_scales_part_only_where_float32_keys_straddle_a_bf16_midpoint(
        capsys):
    """Where the two packages' int8 prefill scales differ (stablelm-1.6b's
    prompt of ``test_int8_cache_and_decode_match_the_reference``), each
    package stored the bf16 rounding of its own float32 ``amax / 127``,
    and the two float32 values lie within 1e-5 of each other on either
    side of a bf16 rounding midpoint: the parting enters with the float32
    keys and values, not in ``quantize_kv``. ``-s`` prints, for a parting
    at layer 0, the float64 value of that scale (the layer's norm and
    projection in float64) and the midpoint."""
    jcfg, tcfg, jp, tp = _int8_pair("stablelm-1.6b")
    prompt = numpy_batch(tcfg, 8, s=T_PROMPT, kind="prefill")
    max_seq = T_PROMPT + DECODE_STEPS
    _, jc = JM.prefill(jp, to_jax(prompt), jcfg, max_seq)
    _, tc = TM.prefill(tp, to_torch(prompt), tcfg, max_seq)
    plain = dataclasses.replace(jcfg, kv_cache_quant=False)
    _, jfull = JM.prefill(jp, to_jax(prompt), plain, max_seq, jnp.float32)
    _, tfull = TM.prefill(tp, to_torch(prompt),
                          dataclasses.replace(tcfg, kv_cache_quant=False),
                          max_seq, cache_dtype=torch.float32)

    def bf16(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(
            torch.bfloat16).float().numpy()

    parted = 0
    for name in ("k", "v"):
        jf = np.asarray(jfull["kv"][name], np.float32)
        tf = tfull["kv"][name].numpy()
        js32 = np.maximum(np.abs(jf).max(-1), np.float32(1e-6)) / np.float32(127)
        ts32 = np.maximum(np.abs(tf).max(-1), np.float32(1e-6)) / np.float32(127)
        js = np.asarray(jc["kv"][f"{name}_scale"], np.float32)[..., 0]
        ts = tc["kv"][f"{name}_scale"].float().numpy()[..., 0]
        filled = np.broadcast_to(
            (np.asarray(jc["kv_pos"]) >= 0)[..., None], js.shape)
        np.testing.assert_array_equal(js[filled], bf16(js32)[filled])
        np.testing.assert_array_equal(ts[filled], bf16(ts32)[filled])
        for idx in np.argwhere(js != ts):
            idx = tuple(int(i) for i in idx)
            parted += 1
            lo, hi = sorted((js[idx], ts[idx]))
            mid = (np.float64(lo) + np.float64(hi)) / 2
            a, b = sorted((np.float64(js32[idx]), np.float64(ts32[idx])))
            assert a < mid <= b and b - a <= 1e-5 * b, (name, idx)
            layer, row, slot, head = idx
            if layer != 0:
                continue
            x = np.asarray(JM.embed_inputs(jp, to_jax(prompt), jcfg),
                           np.float64)[row, slot]
            lp = jax.tree.map(lambda t: np.asarray(t[0], np.float64),
                              jp["layers"])
            xn = (x - x.mean()) / np.sqrt(x.var() + 1e-5) \
                * lp["ln1"]["scale"] + lp["ln1"]["bias"]
            hd = jcfg.resolved_head_dim
            w = lp["attn"][f"w{name}"]["w"][:, head * hd:(head + 1) * hd]
            exact = np.abs(xn @ w).max() / 127       # V: no rotary
            with capsys.disabled():
                print(f"\n{name} at {idx}: max |{name}| reference "
                      f"{np.abs(jf[idx]).max()!r}, port "
                      f"{np.abs(tf[idx]).max()!r}, float64 "
                      f"{np.abs(xn @ w).max()!r}; scale reference float32 "
                      f"{js32[idx]!r} -> {js[idx]!r}, port {ts32[idx]!r} -> "
                      f"{ts[idx]!r}, bf16 midpoint {mid!r}, float64 "
                      f"{exact!r}")
    with capsys.disabled():
        print(f"\n{parted} of {js.size * 2} scales parted")


def test_hybrid_int8_cache_is_refused_naming_r4():
    """The reference's hybrid prefill casts K/V straight to int8 with no
    scales (ROADMAP queue 3, R4), so its decode raises KeyError; the port
    refuses ``kv_cache_quant`` on the hybrid stack."""
    jcfg, tcfg = cfgs("zamba2-1.2b", kv_cache_quant=True)
    jp = JM.init_params(jax.random.key(0), jcfg)
    toks = np.random.default_rng(0).integers(0, 512, (2, 20)).astype(np.int32)
    _, jc = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, 24)
    assert sorted(jc["kv"]) == ["k", "v"]
    assert jc["kv"]["k"].dtype == jnp.int8
    with pytest.raises(KeyError, match="k_scale"):
        JM.decode_step(jp, jc, {"tokens": jnp.asarray(toks[:, :1])},
                       jnp.full((2,), 20, jnp.int32), jcfg)
    tp = model_params(jax.tree.map(np.asarray, jp), tcfg)
    for fn in (lambda: TM.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                  tcfg, 24),
               lambda: TM.init_cache(tcfg, 2, 24),
               lambda: TSV.GenerationServer(tcfg, 24, 2, backend="cpu",
                                            params=tp).prefill(
                   {"tokens": toks})):
        with pytest.raises(NotImplementedError, match="R4"):
            fn()


# ---------------------------------------------------------------------------
# data pipeline, server, launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-medium"])
def test_synthetic_batches_are_bitwise_the_references(arch):
    jcfg, tcfg = cfgs(arch)
    ref = iter(JSource(jcfg, 3, 30, seed=5))
    got = iter(SyntheticTokenSource(tcfg, 3, 30, seed=5))
    for _ in range(3):
        a, b = next(ref), next(got)
        assert list(a) == list(b)
        for k in a:
            assert b[k].dtype == a[k].dtype and b[k].shape == a[k].shape
            np.testing.assert_array_equal(b[k], a[k])
    if arch == "internvl2-1b":
        with pytest.raises(ValueError, match="no text"):
            SyntheticTokenSource(tcfg, 1, 16)


@pytest.mark.parametrize("arch", FAMILIES)
def test_generate_gives_the_reference_tokens_in_f32(arch):
    """Greedy tokens of the reference's ``GenerationServer`` (its jitted
    prefill / decode loop; audio decodes codebook 0's argmax on every
    codebook) from the same parameters."""
    jcfg, tcfg = cfgs(arch)
    _generate_tokens(jcfg, tcfg, numpy_params(jcfg, 50))


def _generate_tokens(jcfg, tcfg, ptree):
    """Both packages' ``GenerationServer`` from the same parameters: equal
    greedy tokens."""
    bs, plen, steps = 2, 24, 8
    jsrv = JSV.GenerationServer(jcfg, max_seq=plen + steps, bs=bs, seed=0)
    jsrv.params = jax.tree.map(jnp.asarray, ptree)
    tsrv = TSV.GenerationServer(tcfg, max_seq=plen + steps, bs=bs,
                                backend="cpu",
                                params=model_params(ptree, tcfg))
    prompt = numpy_batch(tcfg, 51, b=bs, s=plen, kind="prefill")
    want = jsrv.generate(to_jax(prompt), steps, plen)
    got = tsrv.generate(to_torch(prompt), steps, plen)
    assert got.shape == (bs, steps)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(HEAD_DIM_NAMES))
def test_head_dim_models_serve_as_the_reference(name):
    """The dense block at head dims 96 and 256 (``head_dim_cfgs``):
    prefill logits and caches, DECODE_STEPS decode steps within TOL, and
    the greedy tokens of both packages' servers equal."""
    jcfg, tcfg = head_dim_cfgs(name)
    ptree = numpy_params(jcfg, 70 + HEAD_DIM_NAMES[name])
    _prefill_and_decode(name, jcfg, tcfg, jax.tree.map(jnp.asarray, ptree),
                        model_params(ptree, tcfg))
    _generate_tokens(jcfg, tcfg, ptree)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "musicgen-medium",
                                  "internvl2-1b", "qwen2.5-14b"])
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
def test_load_params_casts_each_piece_as_the_whole_tree_cast(arch,
                                                             param_dtype):
    _, tcfg = cfgs(arch, f32=False)
    tcfg = dataclasses.replace(tcfg, param_dtype=param_dtype)
    got = TSV._load_params(tcfg, 3, None, torch.device("cpu"))
    want = TM.cast_params(TM.init_params(
        tcfg, torch.Generator().manual_seed(3)), tcfg.compute_dtype)
    assert T.tree_map(lambda t: (tuple(t.shape), t.dtype), got) == \
        T.tree_map(lambda t: (tuple(t.shape), t.dtype), want)
    for a, b in zip(T.leaves(got), T.leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,extra", [
    ("internvl2-1b", ["--prompt-len", "24"]),
    ("musicgen-medium", []), ("mamba2-780m", []), ("minitron-4b", [])])
def test_serve_cli_runs_the_reduced_families(arch, extra, capsys):
    tserve.main(["--arch", arch, "--reduced", "--backend", "cpu",
                 "--requests", "2", "--bs", "2", "--gen", "3"] + extra)
    out = capsys.readouterr().out
    assert "batch 0: 2x3 tokens" in out and arch in out


def test_serve_cli_refuses_a_vlm_prompt_without_text(capsys):
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "internvl2-1b", "--reduced", "--backend",
                     "cpu", "--prompt-len", "16"])
    assert "16 vision patches" in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-medium"])
def test_train_cli_trains_the_reduced_vlm_and_audio(arch, capsys):
    ttrain.main(["--arch", arch, "--reduced", "--backend", "cpu", "--steps",
                 "3", "--batch", "2", "--seq", "24"])
    out = capsys.readouterr().out
    assert "done: loss" in out and "nan" not in out
