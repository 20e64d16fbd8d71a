"""The port's SSD scan (K4, ``ops.ssd_scan``) and Mamba2 layer against the
JAX package.

On the CPU the ``ssd_chunk`` wrapper runs its plain PyTorch version, held
to the Pallas kernel in interpret mode within rtol 2e-4, atol 1e-4 (the
tolerance ``tests/test_kernels.py`` sets for the kernel); the full scan is
held to ``repro.kernels.ops.ssd_scan`` and ``layers.ssd_chunked``, and the
Mamba2 block (prefill at a length that is not a chunk multiple, and the
one-step decode, with one B/C group and with two) to ``layers.ssm_apply``,
all in float32. The plain
backward (``ssd_chunk_bwd_plain``) is held to ``jax.vjp`` of
``ssd_chunk_ref``, and the gradient of ``ops.ssd_scan`` to ``jax.grad`` of
``layers.ssd_chunked``, element by element within 2e-4 of |value| plus
the gradient's RMS. The CUDA kernels' arithmetic (every product in
split TF32 on the tensor cores) is emulated in torch: the forward's held
to the plain forward by the kernel's ``allclose`` tolerance, the
backward's to the plain backward by the card tests' element-wise rule;
plain TF32 fails both.
Inputs are made with NumPy from a seed and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ssd_scan.ref import ssd_chunk_ref
from repro.kernels.ssd_scan.ssd_scan import ssd_chunk as pallas_ssd_chunk
from repro.models import layers as JL
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ssd_scan import ssd_scan as K4
from repro_torch.models import layers as TL

TOL = dict(rtol=2e-4, atol=1e-4)


def _ssd_case(seed, b=1, nc=2, l=32, h=2, p=16, n=8):
    """Model-like SSD inputs: dt = softplus of a normal, A in -[1, 16)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, nc, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, nc, l, h)) - 2.0)
                  ).astype(np.float32)
    A = -rng.uniform(1.0, 16.0, h).astype(np.float32)
    B = rng.standard_normal((b, nc, l, n)).astype(np.float32)
    C = rng.standard_normal((b, nc, l, n)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("shape", [dict(), dict(l=64, h=3, p=8, n=16)])
def test_plain_matches_pallas_kernel_in_interpret_mode(shape):
    x, dt, A, B, C = _ssd_case(0, **shape)
    dA = (dt * A).astype(np.float32)
    jy, jst = pallas_ssd_chunk(*map(jnp.asarray, (x, dA, dt, B, C)),
                               interpret=True)
    ty, tst = K4.ssd_chunk(*map(torch.from_numpy, (x, dA, dt, B, C)))
    assert tst.shape == jst.shape           # (b, nc, h, n, p)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **TOL)


def test_plain_takes_exp_only_below_the_diagonal():
    """Large negative dA makes the segment sums above the diagonal large
    and positive: exp of them would overflow to inf and poison y."""
    x, dt, A, B, C = _ssd_case(1, l=64)
    dA = (dt * A * 400.0).astype(np.float32)
    y, st = K4.ssd_chunk(*map(torch.from_numpy, (x, dA, dt, B, C)))
    assert torch.isfinite(y).all() and torch.isfinite(st).all()


def test_ssd_scan_matches_the_reference_scans():
    x, dt, A, B, C = _ssd_case(2, nc=3)
    jy, jfinal = jops.ssd_scan(*map(jnp.asarray, (x, dt, A, B, C)))
    ty, tfinal = tops.ssd_scan(*map(torch.from_numpy, (x, dt, A, B, C)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    # the reference wrapper keeps the kernel's (b, h, n, p); the port
    # transposes once to the cache's (b, h, p, n)
    np.testing.assert_allclose(tfinal.numpy(),
                               np.asarray(jfinal).transpose(0, 1, 3, 2), **TOL)
    b, nc, l, h, p = x.shape
    cy, cfinal = JL.ssd_chunked(jnp.asarray(x.reshape(b, nc * l, h, p)),
                                jnp.asarray(dt.reshape(b, nc * l, h)),
                                jnp.asarray(A),
                                jnp.asarray(B.reshape(b, nc * l, 1, -1)),
                                jnp.asarray(C.reshape(b, nc * l, 1, -1)), l)
    np.testing.assert_allclose(ty.numpy().reshape(b, nc * l, h, p),
                               np.asarray(cy), **TOL)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(cfinal), **TOL)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    args = [torch.from_numpy(a) for a in _ssd_case(3)]
    x, dt, A, B, C = args
    dA = dt * A
    before = K4.ssd_chunk.launches
    got = K4.ssd_chunk(x, dA, dt, B, C)
    assert K4.ssd_chunk.launches == before
    want = K4.ssd_chunk_plain(x, dA, dt, B, C)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_inputs_the_kernel_refuses_raise():
    x, dt, A, B, C = (torch.from_numpy(a) for a in _ssd_case(4))
    dA = dt * A
    with pytest.raises(ValueError, match="dA must be"):
        K4.ssd_chunk(x, dA[:, :1], dt, B, C)
    with pytest.raises(TypeError, match="float32"):
        K4.ssd_chunk(x.double(), dA, dt, B, C)
    with pytest.raises(ValueError, match="contiguous"):
        K4.ssd_chunk(x, dA, dt, B.transpose(2, 3).contiguous()
                     .transpose(2, 3), C)


def _near(got, want, tol=2e-4):
    """Element by element, |got - want| <= tol (|want| + scale), the scale
    being want's RMS or 0.1, whichever is larger."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.sqrt(np.mean(want ** 2)), 0.1)
    share = (np.abs(got - want) / (tol * (np.abs(want) + scale))).max()
    assert share <= 1.0, (share, scale)


@pytest.mark.parametrize("shape,scale", [(dict(), 1.0),
                                         (dict(l=64, h=3, p=8, n=16), 1.0),
                                         (dict(l=64, nc=1), 6.0)])
def test_plain_backward_matches_jax_vjp_of_the_oracle(shape, scale):
    """``scale`` 6 takes |cs| at the end of the chunk into the hundreds."""
    x, dt, A, B, C = _ssd_case(11, **shape)
    dA = (dt * A * scale).astype(np.float32)
    rng = np.random.default_rng(12)
    b, nc, l, h, p = x.shape
    dy = rng.standard_normal(x.shape).astype(np.float32)
    dst = rng.standard_normal((b, nc, h, B.shape[-1], p)).astype(np.float32)
    want = jax.jit(lambda ins, cot: jax.vjp(ssd_chunk_ref, *ins)[1](cot))(
        tuple(map(jnp.asarray, (x, dA, dt, B, C))),
        (jnp.asarray(dy), jnp.asarray(dst)))
    got = K4.ssd_chunk_bwd_plain(*map(torch.from_numpy,
                                      (x, dA, dt, B, C, dy, dst)))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        _near(g.numpy(), w)


def test_cpu_gradients_take_the_plain_backward_and_count_no_launch():
    x, dt, A, B, C = (torch.from_numpy(a) for a in _ssd_case(13))
    dA = dt * A
    leaves = [t.clone().requires_grad_() for t in (x, dA, dt, B, C)]
    before = (K4.ssd_chunk.launches, K4.ssd_chunk_bwd.launches)
    y, st = K4.ssd_chunk(*leaves)
    assert y.grad_fn is not None
    dy, dst = torch.ones_like(y), torch.full_like(st, 0.5)
    torch.autograd.backward((y, st), (dy, dst))
    assert (K4.ssd_chunk.launches, K4.ssd_chunk_bwd.launches) == before
    want = K4.ssd_chunk_bwd_plain(x, dA, dt, B, C, dy, dst)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


def test_ssd_scan_gradient_matches_the_reference_chunked_scan():
    x, dt, A, B, C = _ssd_case(14, nc=3)
    b, nc, l, h, p = x.shape
    n = B.shape[-1]
    rng = np.random.default_rng(15)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    dfin = rng.standard_normal((b, h, p, n)).astype(np.float32)

    def jloss(x, dt, A, B, C):
        y, fin = JL.ssd_chunked(x.reshape(b, nc * l, h, p),
                                dt.reshape(b, nc * l, h), A,
                                B.reshape(b, nc * l, 1, n),
                                C.reshape(b, nc * l, 1, n), l)
        return (jnp.sum(y.reshape(x.shape) * dy)
                + jnp.sum(fin * dfin))

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, (x, dt, A, B, C)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, B, C)]
    y, fin = tops.ssd_scan(*leaves)
    ((y * torch.from_numpy(dy)).sum()
     + (fin * torch.from_numpy(dfin)).sum()).backward()
    for leaf, w in zip(leaves, want):
        _near(leaf.grad.numpy(), w)


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

SPEC = dict(d_model=64, d_state=16, expand=2, head_dim=16, chunk=16)


def _block(seed):
    jp = JL.ssm_init(jax.random.key(seed), JL.SSMSpec(**SPEC))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jp, tp


@pytest.mark.parametrize("s", [37, 32])
def test_ssm_prefill_matches_the_reference_block(s):
    jp, tp = _block(0)
    x = np.random.default_rng(5).standard_normal((2, s, 64)).astype(np.float32)
    jy, jst = JL.ssm_apply(jp, jnp.asarray(x), JL.SSMSpec(**SPEC),
                           return_state=True)
    ty, tst = TL.ssm_apply(tp, torch.from_numpy(x), TL.SSMSpec(**SPEC),
                           return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tst["conv"].numpy(), np.asarray(jst["conv"]),
                               **TOL)
    np.testing.assert_allclose(tst["ssm"].numpy(), np.asarray(jst["ssm"]),
                               **TOL)


def test_ssm_decode_step_matches_the_reference_block():
    jp, tp = _block(1)
    rng = np.random.default_rng(6)
    spec = JL.SSMSpec(**SPEC)
    conv = rng.standard_normal((2, 3, spec.d_inner + 32)).astype(np.float32)
    ssm = rng.standard_normal((2, spec.n_heads, 16, 16)).astype(np.float32)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    jy, jc = JL.ssm_apply(jp, jnp.asarray(x), spec,
                          {"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)})
    tc = {"conv": torch.from_numpy(conv.copy()),
          "ssm": torch.from_numpy(ssm.copy())}
    ty, tc2 = TL.ssm_apply(tp, torch.from_numpy(x), TL.SSMSpec(**SPEC), tc)
    assert tc2 is tc                                  # updated in place
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


GROUPED = dict(SPEC, n_groups=2)          # 8 heads: 0-3 read group 0


@pytest.mark.parametrize("s", [37, 32])
def test_grouped_ssm_prefill_matches_the_reference_block(s):
    """Two B/C groups: one SSD scan per group of heads, y and the final
    state as the reference's ``repeat`` of B and C gives them."""
    spec = JL.SSMSpec(**GROUPED)
    jp = JL.ssm_init(jax.random.key(2), spec)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(7).standard_normal((2, s, 64)).astype(np.float32)
    jy, jst = JL.ssm_apply(jp, jnp.asarray(x), spec, return_state=True)
    ty, tst = TL.ssm_apply(tp, torch.from_numpy(x), TL.SSMSpec(**GROUPED),
                           return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]),
                                   **TOL)


def test_grouped_ssm_decode_step_matches_the_reference_block():
    spec = JL.SSMSpec(**GROUPED)
    jp = JL.ssm_init(jax.random.key(3), spec)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    rng = np.random.default_rng(8)
    conv = rng.standard_normal((2, 3, spec.d_inner + 2 * 2 * 16)).astype(
        np.float32)
    ssm = rng.standard_normal((2, spec.n_heads, 16, 16)).astype(np.float32)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    jy, jc = JL.ssm_apply(jp, jnp.asarray(x), spec,
                          {"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)})
    tc = {"conv": torch.from_numpy(conv.copy()),
          "ssm": torch.from_numpy(ssm.copy())}
    ty, _ = TL.ssm_apply(tp, torch.from_numpy(x), TL.SSMSpec(**GROUPED), tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


def _tf32(t):
    """``t`` rounded to nearest, ties away from zero, at TF32's 10 mantissa
    bits, as ``cvt.rna.tf32.f32`` rounds it."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
        torch.float32)


def _tensor_core_bwd(x, dA, dt, B, C, dy, dst, split):
    """``ssd_chunk_bwd_plain`` with every matrix product taken as the CUDA
    backward takes it on the tensor cores: operands rounded to TF32 (plain)
    or split into hi = tf32(v) and lo = tf32(v - hi) with hi.hi + hi.lo +
    lo.hi summed (``split``); the heads' dG summed before its products with
    B and C; the element-wise terms in float32."""
    def mm(spec, a, b):
        ah, bh = _tf32(a), _tf32(b)
        terms = [(ah, bh)]
        if split:
            terms += [(ah, _tf32(b - bh)), (_tf32(a - ah), bh)]
        return sum(torch.einsum(spec, u.double(), v.double())
                   for u, v in terms).float()

    l = x.shape[2]
    cs = K4.chunk_cumsum(dA)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]
    causal = torch.ones(l, l, dtype=torch.bool).tril()[None, None, :, :, None]
    L = torch.exp(seg.masked_fill(~causal, 0.0)).masked_fill(~causal, 0.0)
    G = mm("bcin,bcjn->bcij", C, B)[..., None]
    dtj = dt[:, :, None, :, :]
    M = G * L * dtj
    dM = mm("bcihp,bcjhp->bcijh", dy, x) * causal
    dGs = (dM * L * dtj).sum(dim=-1)
    E = dM * M
    dx = mm("bcijh,bcihp->bcjhp", M, dy)
    dC = mm("bcij,bcjn->bcin", dGs, B)
    dB = mm("bcij,bcin->bcjn", dGs, C)
    ddt = (dM * G * L).sum(dim=2)
    dcs = E.sum(dim=3) - E.sum(dim=2)
    decay = torch.exp(cs[:, :, -1:, :] - cs)
    w = decay * dt
    xd = mm("bcjhp,bchnp->bcjhn", x, dst)
    bd = mm("bcjn,bchnp->bcjhp", B, dst)
    dw = torch.einsum("bcjn,bcjhn->bcjh", B, xd)
    dx = dx + w[..., None] * bd
    dB = dB + torch.einsum("bcjh,bcjhn->bcjn", w, xd)
    ddt = ddt + decay * dw
    dcs = dcs - w * dw
    dcs[:, :, -1] += (w * dw).sum(dim=2)
    ddA = torch.flip(torch.cumsum(torch.flip(dcs.double(), [2]), dim=2),
                     [2]).float()
    return dx, ddA, ddt, dB, dC


@pytest.mark.parametrize("split,lo,hi", [(True, 0.0, 0.1),
                                         (False, 1.0, float("inf"))])
def test_split_tf32_products_meet_the_backward_rule(split, lo, hi):
    """The CUDA backward runs its products on the tensor cores in split
    TF32 and is held to 2e-4 (|want| + max(RMS, 0.1)) element by element
    (``tests/test_torch_cuda.py``). At a full-width chunk with |cs| in the
    hundreds (``scale`` 3), the split's roundings take under 0.1 of that
    limit; plain TF32's take more than all of it, which is why the kernel
    splits."""
    x, dt, A, B, C = _ssd_case(5, b=1, nc=2, l=256, h=4, p=64, n=64)
    rng = np.random.default_rng(6)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    dst = rng.standard_normal((1, 2, 4, 64, 64)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, (dt * A * 3.0).astype(np.float32),
                                          dt, B, C, dy, dst)]
    got = _tensor_core_bwd(*args, split=split)
    want = K4.ssd_chunk_bwd_plain(*args)
    share = 0.0
    for g, w in zip(got, want):
        scale = max(float(w.square().mean().sqrt()), 0.1)
        share = max(share, float(((g - w).abs()
                                  / (2e-4 * (w.abs() + scale))).max()))
    assert lo < share < hi, share


def _tensor_core_fwd(x, dA, dt, B, C, split):
    """``ssd_chunk_plain`` with every matrix product taken as the CUDA
    forward takes it on the tensor cores (``C B^T``, ``M x`` and the
    state's ``(B o w)^T x``): operands rounded to TF32 (plain) or split
    into hi and lo with hi.hi + hi.lo + lo.hi summed (``split``); the mask,
    ``exp`` and ``dt`` applied to ``G`` in float32."""
    def mm(spec, a, b):
        ah, bh = _tf32(a), _tf32(b)
        terms = [(ah, bh)]
        if split:
            terms += [(ah, _tf32(b - bh)), (_tf32(a - ah), bh)]
        return sum(torch.einsum(spec, u.double(), v.double())
                   for u, v in terms).float()

    l = x.shape[2]
    cs = K4.chunk_cumsum(dA)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]
    causal = torch.ones(l, l, dtype=torch.bool).tril()[None, None, :, :, None]
    L = torch.exp(seg.masked_fill(~causal, 0.0)).masked_fill(~causal, 0.0)
    G = mm("bcin,bcjn->bcij", C, B)[..., None]
    M = G * L * dt[:, :, None, :, :]
    y = mm("bcijh,bcjhp->bcihp", M, x)
    w = torch.exp(cs[:, :, -1:, :] - cs) * dt
    states = mm("bcjhn,bcjhp->bchnp", B[:, :, :, None, :] * w[..., None], x)
    return y, states


@pytest.mark.parametrize("split,lo,hi", [(True, 0.0, 0.1),
                                         (False, 1.0, float("inf"))])
def test_split_tf32_products_meet_the_forward_tolerance(split, lo, hi):
    """The CUDA forward runs ``C B^T``, ``M x`` and the state product on
    the tensor cores in split TF32 and is held to the plain version by
    ``allclose`` within rtol 2e-4, atol 1e-4 (``tests/test_torch_cuda.py``,
    ``chip_smoke.py``). At a full-width chunk (l = 256, p = n = 64) with
    |cs| in the hundreds (``scale`` 3), the operands' split roundings take
    under a tenth of that limit, |got - want| / (atol + rtol |want|);
    plain TF32's take more than all of it, which is why the kernel splits.
    The emulation sums the products in float64, so it leaves out the
    tensor cores' float32 accumulation, which is what sets the kernel's
    own share (0.14-0.38 of the limit at the serving shape, PERF.md)."""
    x, dt, A, B, C = _ssd_case(7, b=1, nc=2, l=256, h=4, p=64, n=64)
    args = [torch.from_numpy(a) for a in (x, (dt * A * 3.0).astype(np.float32),
                                          dt, B, C)]
    got = _tensor_core_fwd(*args, split=split)
    want = K4.ssd_chunk_plain(*args)
    share = max(float(((g - w).abs() / (TOL["atol"] + TOL["rtol"] * w.abs())
                       ).max()) for g, w in zip(got, want))
    assert lo < share < hi, share
