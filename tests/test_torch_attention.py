"""The port's attention (K3 and the attention layer) against the JAX package.

On the CPU the ``flash_attention`` wrapper runs its plain PyTorch version,
which is held to the Pallas kernel run in interpret mode and to the
reference oracle (``ref.py::attention_ref``) in float32 within 1e-4 — the
tolerance ``tests/test_kernels.py`` sets for the kernel. The attention
layer (prefill through the kernel, decode through the ring buffer) is held
to ``repro.models.layers.attention_apply`` in float32 within 1e-4. Inputs
are made with NumPy from a seed and handed to both packages.

The plain backward (``flash_attention_bwd_plain``) is held to ``jax.vjp``
of ``attention_ref`` element by element, within 1e-4 (float32) and 2e-2
(bf16) of |value| plus the gradient's RMS, windowed and ragged included; on
CPU tensors the differentiable ``flash_attention`` runs it. Each holds at
the head dims the CUDA kernels take, 64, 128 and 160 (stablelm-12b's).

The CUDA kernels themselves are held to the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention as pallas_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import layers as JL
from repro_torch.models import layers as TL
from repro_torch.kernels.flash_attention import flash_attention as K3

TOL = dict(rtol=1e-4, atol=1e-4)


def _qkv(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("window", [None, 64])
def test_plain_matches_pallas_kernel_in_interpret_mode(window):
    q, k, v = _qkv(0, (1, 2, 256, 64))
    want = np.asarray(pallas_flash(*map(jnp.asarray, (q, k, v)),
                                   window=window, interpret=True))
    got = K3.flash_attention(*map(torch.from_numpy, (q, k, v)), window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("window", [None, 64])
def test_plain_matches_pallas_kernel_in_interpret_mode_at_head_dim_160(
        window):
    """stablelm-12b's head dim: the Pallas kernel's blocks span all of D,
    so it takes 160 as it takes 64."""
    q, k, v = _qkv(13, (1, 2, 256, 160))
    want = np.asarray(pallas_flash(*map(jnp.asarray, (q, k, v)),
                                   window=window, interpret=True))
    got = K3.flash_attention(*map(torch.from_numpy, (q, k, v)), window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("S,D,window", [(200, 64, None), (200, 128, 48),
                                        (1, 64, None), (77, 64, 1),
                                        (300, 160, None), (200, 160, 64),
                                        (65, 160, 1)])
def test_ragged_lengths_match_the_reference_oracle(S, D, window):
    """The TPU kernel needs S % 128 == 0; the port takes any S."""
    q, k, v = _qkv(1, (2, 2, S, D))
    want = np.asarray(attention_ref(*map(jnp.asarray, (q, k, v)),
                                    window=window))
    got = K3.flash_attention(*map(torch.from_numpy, (q, k, v)), window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bf16_inputs_give_bf16_output_near_the_oracle():
    q, k, v = _qkv(2, (1, 2, 128, 64))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = K3.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    want = np.asarray(attention_ref(*(jnp.asarray(t.float().numpy())
                                      for t in (tq, tk, tv))))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    q, k, v = map(torch.from_numpy, _qkv(3, (1, 1, 64, 64)))
    before = K3.flash_attention.launches
    got = K3.flash_attention(q, k, v)
    assert K3.flash_attention.launches == before
    assert torch.equal(got, K3.flash_attention_plain(q, k, v))


def test_inputs_the_kernel_refuses_raise():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="one shape"):
        K3.flash_attention(q, q, torch.zeros(1, 2, 9, 64))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K3.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        K3.flash_attention(q.transpose(2, 3), q.transpose(2, 3),
                           q.transpose(2, 3))
    with pytest.raises(ValueError, match="window"):
        K3.flash_attention(q, q, q, window=0)


def test_the_kernel_takes_head_dims_64_128_160_and_names_them():
    """``HEAD_DIMS`` is what the CUDA kernels are built for; the kernel's
    wrapper refuses any other D before it loads a library, naming them
    (so on CPU tensors too: no fallback to the plain version)."""
    assert K3.HEAD_DIMS == (64, 128, 160)
    before = K3.flash_attention.launches
    for d in (32, 96, 192, 256):
        q = torch.zeros(1, 2, 8, d)
        with pytest.raises(ValueError,
                           match=r"head dims \(64, 128, 160\), got %d" % d):
            K3.flash_attention_fwd(q, q, q)
    assert K3.flash_attention.launches == before


# ---------------------------------------------------------------------------
# the attention layer
# ---------------------------------------------------------------------------

def _layer(seed, d=128, heads=2, kv_heads=2, hd=64, window=None):
    spec_args = dict(d_model=d, n_heads=heads, n_kv_heads=kv_heads,
                     head_dim=hd, sliding_window=window)
    jspec, tspec = JL.AttnSpec(**spec_args), TL.AttnSpec(**spec_args)
    jp = JL.attention_init(jax.random.key(seed), jspec)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jspec, tspec, jp, tp


@pytest.mark.parametrize("kv_heads,window", [(2, None), (1, 16)])
def test_attention_prefill_matches_the_reference_layer(kv_heads, window):
    jspec, tspec, jp, tp = _layer(0, kv_heads=kv_heads, window=window)
    b, s = 2, 40
    x = np.random.default_rng(4).standard_normal((b, s, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    jy, (jk, jv) = JL.attention_apply(jp, jnp.asarray(x), jnp.asarray(pos),
                                      jspec, return_kv=True)
    ty, (tk, tv) = TL.attention_apply(tp, torch.from_numpy(x),
                                      torch.from_numpy(pos.copy()), tspec,
                                      return_kv=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_attention_decode_against_the_ring_buffer_matches_the_reference():
    jspec, tspec, jp, tp = _layer(1, kv_heads=1)
    rng = np.random.default_rng(5)
    b, clen = 2, 8
    kc = rng.standard_normal((b, clen, 1, 64)).astype(np.float32)
    vc = rng.standard_normal((b, clen, 1, 64)).astype(np.float32)
    cpos = np.array([[0, 1, 2, -1, -1, -1, -1, -1],
                     [8, 9, 10, 3, 4, 5, 6, 7]], np.int32)
    pos = np.array([[3], [11]], np.int32)          # row 1 wraps the ring
    x = rng.standard_normal((b, 1, 128)).astype(np.float32)
    jy, (jcache, jcpos) = JL.attention_apply(
        jp, jnp.asarray(x), jnp.asarray(pos), jspec,
        {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}, jnp.asarray(cpos))
    tcache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    ty, (tcache, tcpos) = TL.attention_apply(
        tp, torch.from_numpy(x), torch.from_numpy(pos), tspec, tcache,
        torch.from_numpy(cpos.copy()))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(tcpos.numpy(), np.asarray(jcpos))
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)


def test_rope_and_norms_match_the_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32) * 3
    pos = rng.integers(0, 5000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos))), **TOL)
    h = rng.standard_normal((4, 32)).astype(np.float32)
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for kind in ("rmsnorm", "layernorm"):
        np.testing.assert_allclose(
            TL.norm_apply(kind, tp, torch.from_numpy(h)).numpy(),
            np.asarray(JL.norm_apply(kind, jp, jnp.asarray(h))), **TOL)


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_mlp_matches_the_reference(activation):
    jp = JL.mlp_init(jax.random.key(7), 64, 96, activation=activation)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(7).standard_normal((2, 5, 64)).astype(np.float32)
    np.testing.assert_allclose(
        TL.mlp_apply(tp, torch.from_numpy(x), activation).numpy(),
        np.asarray(JL.mlp_apply(jp, jnp.asarray(x), activation)), **TOL)


def _near(got, want, tol):
    """Element by element, |got - want| <= tol (|want| + scale), the scale
    being want's RMS or 0.1, whichever is larger (a gradient that is
    exactly 0, as with a window of 1, has no scale of its own)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.sqrt(np.mean(want ** 2)), 0.1)
    share = (np.abs(got - want) / (tol * (np.abs(want) + scale))).max()
    assert share <= 1.0, (share, scale)


@pytest.mark.parametrize("S,D,window,dtype", [
    (128, 64, None, np.float32), (200, 64, 48, np.float32),
    (77, 128, None, np.float32), (65, 64, 1, np.float32),
    (128, 64, None, "bfloat16"), (100, 64, 30, "bfloat16"),
    (300, 160, None, np.float32), (200, 160, 64, np.float32),
    (130, 160, None, "bfloat16"), (100, 160, 30, "bfloat16")])
def test_plain_backward_matches_jax_vjp_of_the_oracle(S, D, window, dtype):
    q, k, v, do = _qkv(7, (1, 2, S, D)) + _qkv(8, (1, 2, S, D))[:1]
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
                else (jnp.float32, torch.float32))
    jin = [jnp.asarray(a).astype(jdt) for a in (q, k, v, do)]
    tin = [torch.from_numpy(a).to(tdt) for a in (q, k, v, do)]
    want = jax.jit(lambda ins, cot: jax.vjp(
        lambda a, b, c: attention_ref(a, b, c, window=window), *ins)[1](cot))(
            tuple(jin[:3]), jin[3])
    out = K3.flash_attention_plain(*tin[:3], window=window)
    got = K3.flash_attention_bwd_plain(*tin[:3], out, tin[3], window=window)
    tol = 1e-4 if dtype == np.float32 else 2e-2
    for g, w in zip(got, want):
        assert g.dtype == tdt
        _near(g.float().numpy(), np.asarray(w, np.float32), tol)


def test_cpu_gradients_take_the_plain_backward_and_count_no_launch():
    q, k, v, do = (torch.from_numpy(a) for a in
                   _qkv(9, (2, 2, 70, 64)) + _qkv(10, (2, 2, 70, 64))[:1])
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (K3.flash_attention.launches, K3.flash_attention_bwd.launches)
    out = K3.flash_attention(*leaves, window=20)
    assert out.grad_fn is not None
    out.backward(do)
    assert (K3.flash_attention.launches,
            K3.flash_attention_bwd.launches) == before
    want = K3.flash_attention_bwd_plain(
        q, k, v, K3.flash_attention_plain(q, k, v, window=20), do, window=20)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


# ---------------------------------------------------------------------------
# the rule that holds the bf16 kernels to their plain versions on the card
# ---------------------------------------------------------------------------

def _row_share(got, want):
    """The largest share of K3's bf16 limit (``tests/test_torch_cuda.py``,
    ``chip_smoke.py``): |got - want| <= 2e-2 (|want| + scale), the scale per
    row, max(RMS of the row over D, 0.05 x want's RMS, 1e-3)."""
    g, w = got.float(), want.float()
    rms = float(w.square().mean().sqrt())
    scale = w.square().mean(dim=-1, keepdim=True).sqrt().clamp_min(
        max(0.05 * rms, 1e-3))
    return float(((g - w).abs() / (2e-2 * (w.abs() + scale))).max())


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tensor_core_roundings(q, k, v, do, window):
    """K3's bf16 arithmetic on the tensor cores, in torch ops: the online
    softmax in float32 with P rounded to bf16 for P V (the normaliser summed
    unrounded), and in the backward P rounded for dV and dS for dQ and dK;
    products accumulate in float32. Returns (out, dq, dk, dv) in bf16."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = qf.shape[2]
    scale = 1.0 / np.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    qpos, kpos = torch.arange(s)[:, None], torch.arange(s)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    scores = scores.masked_fill(~mask, -np.inf)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True)
    out = (torch.einsum("bhqk,bhkd->bhqd", _bf16(p), vf) / l).to(q.dtype)
    probs = torch.exp(scores - (m + torch.log(l)))
    dv = torch.einsum("bhqk,bhqd->bhkd", _bf16(probs), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = _bf16(probs * (dp - (dof * out.float()).sum(-1, keepdim=True)))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return out, dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


_RULE_SHAPES = [((1, 4, 2048, 64), None), ((1, 2, 1000, 128), 256),
                ((1, 2, 600, 160), 128)]


def _rule_case(shape, window):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(11, shape))
    do = torch.from_numpy(_qkv(12, shape)[0]).to(torch.bfloat16)
    got = _tensor_core_roundings(q, k, v, do, window)
    want = (K3.flash_attention_plain(q, k, v, window=window),
            *K3.flash_attention_bwd_plain(q, k, v, got[0], do, window=window))
    return got, want


@pytest.mark.parametrize("shape,window", _RULE_SHAPES)
def test_tensor_core_roundings_take_under_half_the_row_limit(shape, window):
    got, want = _rule_case(shape, window)
    for name, g, w in zip(("O", "dQ", "dK", "dV"), got, want):
        assert _row_share(g, w) < 0.5, name


@pytest.mark.parametrize("fault", ["late_half_5pct", "last_tile_zeroed"])
@pytest.mark.parametrize("shape,window", _RULE_SHAPES)
def test_row_limit_fails_late_errors(shape, window, fault):
    """Rows are queries for O and dQ, keys for dK and dV: a 5% error over
    the late half of the rows, or the last 64 rows zeroed, fails every
    output."""
    _, want = _rule_case(shape, window)
    s = shape[2]
    for name, w in zip(("O", "dQ", "dK", "dV"), want):
        bad = w.float().clone()
        if fault == "late_half_5pct":
            bad[..., s // 2:, :] *= 0.95
        else:
            bad[..., s - 64:, :] = 0.0
        assert _row_share(bad.to(w.dtype), w) > 1.0, name


def test_old_forward_limit_passed_a_late_five_percent_error():
    """The forward's limit before the per-row rule, allclose at rtol = atol
    = 2e-2, is 60% of a typical late output at S = 2048 and lets a 5% error
    over the late half through."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(11, (1, 4, 2048, 64)))
    want = K3.flash_attention_plain(q, k, v)
    bad = want.float().clone()
    bad[..., 1024:, :] *= 0.95
    bad = bad.to(want.dtype)
    assert torch.allclose(bad.float(), want.float(), rtol=2e-2, atol=2e-2)
    assert _row_share(bad, want) > 1.0


def test_library_digest_covers_the_included_header(tmp_path, monkeypatch):
    """The tensor-core sources (attention both ways, the tiled matmul, the
    SSD chunk both ways) include ``csrc/hopper.cuh``: an edit to it must
    name a new library for each, or a stale one in ``build/kernels`` would
    load; the others keep theirs."""
    from repro_torch.kernels import build
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build.library_path(n) for n in build.SOURCES}
    (tmp_path / "hopper.cuh").write_bytes(
        (tmp_path / "hopper.cuh").read_bytes() + b"\n// edited\n")
    after = {n: build.library_path(n) for n in build.SOURCES}
    changed = {n for n in build.SOURCES if before[n] != after[n]}
    assert changed == {"flash_attention", "flash_attention_bwd",
                       "tiled_matmul", "ssd_chunk", "ssd_chunk_bwd"}
