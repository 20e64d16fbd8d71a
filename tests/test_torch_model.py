"""The port's hybrid (Zamba2) model against the JAX package, on the reduced
configuration with the reference's parameters converted leaf by leaf
(``repro_torch.convert.model_params``).

In float32 compute (``dataclasses.replace(cfg, compute_dtype=float32)``, as
``tests/test_models.py`` does) ``forward``, ``prefill`` (logits and every
cache entry) and ``decode_step`` agree within 1e-4. In the default bf16
compute the two round at other places on purpose — the reference casts the
attention probabilities to bf16 before the PV product, the port's kernel
keeps them in float32 — so ``forward`` is held to 2e-2 of the largest
|logit|. The cache bookkeeping (``cache_len_for``, ``_ring_fill``) is equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import model as JM
from repro_torch.configs import base as TC
from repro_torch.convert import model_params
from repro_torch.models import model as TM

TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(f32: bool = True, **over):
    jcfg = j_reduced(j_get_config("zamba2-1.2b"))
    tcfg = TC.reduced(TC.get_config("zamba2-1.2b"))
    if f32:
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, compute_dtype=torch.float32)
    if over:
        jcfg = dataclasses.replace(jcfg, **over)
        tcfg = dataclasses.replace(tcfg, **over)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    """Reduced Zamba2 with 3 layers (two attention sites at attn_every=2),
    the reference's params and their conversion."""
    jcfg, tcfg = _cfgs(num_layers=3)
    jp = JM.init_params(jax.random.key(0), jcfg)
    tp = model_params(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def test_config_matches_the_reference():
    """Every registered configuration holds the reference's fields."""
    for arch in TC.ARCH_IDS:
        jcfg, tcfg = j_get_config(arch), TC.get_config(arch)
        for f in dataclasses.fields(jcfg):
            if f.name not in ("param_dtype", "compute_dtype"):
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), \
                    (arch, f.name)
        assert (tcfg.param_dtype, tcfg.compute_dtype) == (torch.float32,
                                                          torch.bfloat16)
        assert tcfg.padded_vocab == jcfg.padded_vocab, arch
        assert tcfg.n_attn_sites == jcfg.n_attn_sites, arch
        assert tcfg.param_count() == jcfg.param_count(), arch
    tcfg = TC.get_config("zamba2-1.2b")
    assert tcfg.padded_vocab == 32768 and tcfg.n_attn_sites == 7


def test_init_params_has_the_reference_tree(models):
    jcfg, tcfg, jp, tp = models
    own = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    ref = jax.tree.map(np.asarray, jp)
    assert len(own["layers"]) == tcfg.num_layers
    flat_own = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                jax.tree_util.tree_leaves_with_path(
                    {**own, "layers": own["layers"][0]})}
    flat_ref = {jax.tree_util.keystr(k): v.shape[1:] if "layers" in
                jax.tree_util.keystr(k) else v.shape for k, v in
                jax.tree_util.tree_leaves_with_path(ref)}
    assert flat_own == flat_ref
    a = own["layers"][0]["ssm"]
    assert bool((-torch.exp(a["A_log"]) < 0).all())
    assert bool(torch.isfinite(a["dt_bias"]).all())


def test_make_batch_draws_tokens_in_the_vocab():
    _, tcfg = _cfgs()
    gen = torch.Generator().manual_seed(3)
    batch = TC.make_batch(tcfg, 12, 3, "train", gen)
    assert set(batch) == {"tokens", "labels"}
    assert batch["tokens"].shape == (3, 12)
    assert int(batch["tokens"].max()) < tcfg.vocab_size
    assert TC.make_batch(tcfg, 12, 3, "decode", gen)["tokens"].shape == (3, 1)


def test_forward_matches_the_reference_in_f32(models):
    jcfg, tcfg, jp, tp = models
    toks = _tokens(0, 2, 45, jcfg.vocab_size)
    jl, _ = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert tl.shape == (2, 45, tcfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_forward_in_bf16_is_within_two_percent_of_the_largest_logit():
    jcfg, tcfg = _cfgs(f32=False)
    jp = JM.init_params(jax.random.key(1), jcfg)
    tp = TM.cast_params(model_params(jax.tree.map(np.asarray, jp), tcfg),
                        tcfg.compute_dtype)
    toks = _tokens(1, 2, 40, jcfg.vocab_size)
    jl = np.asarray(JM.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)[0],
                    np.float32)
    tl = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)[0]
    assert tl.dtype == torch.bfloat16
    np.testing.assert_allclose(tl.float().numpy(), jl, rtol=0,
                               atol=2e-2 * np.abs(jl).max())


def test_prefill_and_decode_match_the_reference_in_f32(models):
    jcfg, tcfg, jp, tp = models
    T = 50
    toks = _tokens(2, 2, T, jcfg.vocab_size)
    pre = toks[:, :T - 1]
    jlog, jcache = JM.prefill(jp, {"tokens": jnp.asarray(pre)}, jcfg, T,
                              cache_dtype=jnp.float32)
    tlog, tcache = TM.prefill(tp, {"tokens": torch.from_numpy(pre)}, tcfg, T,
                              cache_dtype=torch.float32)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    tleaves = dict((jax.tree_util.keystr(k), v) for k, v in
                   jax.tree_util.tree_leaves_with_path(tcache))
    assert set(tleaves) == {jax.tree_util.keystr(k) for k, _ in jleaves}
    for k, v in jleaves:
        got = tleaves[jax.tree_util.keystr(k)]
        assert tuple(got.shape) == v.shape, k
        np.testing.assert_allclose(got.numpy(), np.asarray(v), **TOL)

    pos = np.full((2,), T - 1, np.int32)
    last = toks[:, T - 1:T]
    jd, jcache2 = JM.decode_step(jp, jcache, {"tokens": jnp.asarray(last)},
                                 jnp.asarray(pos), jcfg)
    td, tcache2 = TM.decode_step(tp, tcache, {"tokens": torch.from_numpy(last)},
                                 torch.from_numpy(pos), tcfg)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    for k, v in jax.tree_util.tree_leaves_with_path(jcache2):
        got = dict((jax.tree_util.keystr(a), b) for a, b in
                   jax.tree_util.tree_leaves_with_path(tcache2))[
                       jax.tree_util.keystr(k)]
        np.testing.assert_allclose(got.numpy(), np.asarray(v), **TOL)
    # prefill(T-1) + decode(1) reproduces forward(T)'s last logits
    full, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(td[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_decode_from_an_empty_cache_matches_the_reference(models):
    jcfg, tcfg, jp, tp = models
    jc = JM.init_cache(jcfg, 2, 16)
    tc = TM.init_cache(tcfg, 2, 16)
    assert [tuple(t.shape) for t in jax.tree.leaves(tc)] == \
        [t.shape for t in jax.tree.leaves(jc)]
    tok = _tokens(3, 2, 1, jcfg.vocab_size)
    jd, _ = JM.decode_step(jp, jc, {"tokens": jnp.asarray(tok)},
                           jnp.zeros((2,), jnp.int32), jcfg)
    td, _ = TM.decode_step(tp, tc, {"tokens": torch.from_numpy(tok)},
                           torch.zeros(2, dtype=torch.int32), tcfg)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)


@pytest.mark.parametrize("seq", [1, 64, 65536, 70000])
def test_cache_len_for_matches_the_reference(seq):
    jcfg, tcfg = _cfgs()
    full_j, full_t = j_get_config("zamba2-1.2b"), TC.get_config("zamba2-1.2b")
    assert TM.cache_len_for(tcfg, seq) == JM.cache_len_for(jcfg, seq)
    assert TM.cache_len_for(full_t, seq) == JM.cache_len_for(full_j, seq)


@pytest.mark.parametrize("s,clen", [(5, 8), (8, 8), (13, 8), (1, 4)])
def test_ring_fill_matches_the_reference(s, clen):
    rng = np.random.default_rng(s)
    k = rng.standard_normal((2, 1, s, 2, 4)).astype(np.float32)
    v = rng.standard_normal((2, 1, s, 2, 4)).astype(np.float32)
    want = JM._ring_fill(jnp.asarray(k), jnp.asarray(v), clen)
    got = TM._ring_fill(torch.from_numpy(k), torch.from_numpy(v), clen)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[2].dtype == torch.int32
