"""The port's SSD scan (K4, ``ops.ssd_scan``) and Mamba2 layer against the
JAX package.

On the CPU the ``ssd_chunk`` wrapper runs its plain PyTorch version, held
to the Pallas kernel in interpret mode within rtol 2e-4, atol 1e-4 (the
tolerance ``tests/test_kernels.py`` sets for the kernel); the full scan is
held to ``repro.kernels.ops.ssd_scan`` and ``layers.ssd_chunked``, and the
Mamba2 block (prefill at a length that is not a chunk multiple, and the
one-step decode) to ``layers.ssm_apply``, all in float32. Inputs are made
with NumPy from a seed and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
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
