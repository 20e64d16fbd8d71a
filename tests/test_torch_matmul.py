"""The port's tiled matmul (K5) against the JAX package.

On the CPU the ``tiled_matmul`` wrapper (and its entry point
``kernels.ops.tiled_matmul``) runs its plain version, held to the Pallas
kernel in interpret mode at ``tests/test_kernels.py``'s shapes and
tolerances (1e-3 in float32, 3e-2 in bf16), and to the reference oracle
(``ref.py::matmul_ref``) at shapes the TPU kernel's 128 blocks do not
divide, which the port takes. Inputs are made with NumPy from a seed. The
rule by which the wrapper picks a CUDA route (TMA + wgmma, mma.sync or
float32) is a function of the inputs alone and is pinned here. The CUDA
kernel is held to the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tiled_matmul.ref import matmul_ref
from repro.kernels.tiled_matmul.tiled_matmul import tiled_matmul as pallas_mm
from repro_torch.kernels import ops
from repro_torch.kernels.tiled_matmul import tiled_matmul as K5

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _ab(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128),
                                   (128, 256, 512)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_pallas_kernel_in_interpret_mode(m, k, n, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    a, b = _ab(m, k, n, m + k + n)
    want = pallas_mm(jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt),
                     interpret=True)
    got = ops.tiled_matmul(torch.from_numpy(a).to(tdt),
                           torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("m,k,n", [(100, 37, 53), (1, 1, 1), (257, 300, 129)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_any_shape_matches_the_reference_oracle(m, k, n, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    a, b = _ab(m, k, n, m * n)
    want = matmul_ref(jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt))
    got = K5.tiled_matmul(torch.from_numpy(a).to(tdt),
                          torch.from_numpy(b).to(tdt))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    a, b = (torch.from_numpy(x) for x in _ab(64, 32, 16, 0))
    before = K5.tiled_matmul.launches
    assert torch.equal(ops.tiled_matmul(a, b), K5.tiled_matmul_plain(a, b))
    assert K5.tiled_matmul.launches == before


def test_inputs_the_kernel_refuses_raise():
    a, b = (torch.from_numpy(x) for x in _ab(8, 4, 6, 1))
    with pytest.raises(ValueError, match="need a"):
        K5.tiled_matmul(a, b.T.contiguous())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K5.tiled_matmul(a.double(), b.double())
    with pytest.raises(TypeError, match="b is"):
        K5.tiled_matmul(a, b.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        K5.tiled_matmul(a, b.T.contiguous().T)



@pytest.mark.parametrize("m,k,n,offset,dtype,want", [
    (16384, 2048, 8192, 0, torch.bfloat16, "tma"),   # the up-projection
    (1000, 776, 1528, 0, torch.bfloat16, "tma"),     # no tile multiples
    (64, 8, 8, 0, torch.bfloat16, "tma"),
    (1000, 777, 1531, 0, torch.bfloat16, "mma_sync"),  # rows not 16 B
    (16, 8, 12, 0, torch.bfloat16, "mma_sync"),      # b's rows: 24 bytes
    (16, 12, 8, 0, torch.bfloat16, "mma_sync"),      # a's rows: 24 bytes
    (16, 8, 8, 1, torch.bfloat16, "mma_sync"),       # a's base off 16 B
    (1000, 776, 1528, 0, torch.float32, "float32"),
    (1000, 777, 1531, 0, torch.float32, "float32"),
    # one row of 7 sliced from a (2, 8) buffer: stride (8, 1), contiguous
    (1, (7, 8), 16, 0, torch.bfloat16, "mma_sync")])
def test_route_is_a_rule_of_dtype_shape_and_alignment(m, k, n, offset, dtype,
                                                      want):
    """The wrapper picks the kernel's route before the launch, from the
    inputs alone: TMA needs every row of a and b to start on 16 bytes.
    ``offset`` starts ``a`` that many values into its storage; a ``k`` of
    (k, row) slices ``a`` from a buffer of rows ``row`` values long."""
    k, row = k if isinstance(k, tuple) else (k, k)
    a = torch.empty((m + 1) * row + offset, dtype=dtype)[offset:]
    a = a.view(m + 1, row)[:m, :k]
    assert a.is_contiguous()
    b = torch.empty((k, n), dtype=dtype)
    assert K5.route(a, b) == want
