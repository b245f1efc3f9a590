"""The port's DIA SpMV (``cpkrylov_tpu_torch/ops``) against the JAX package.

The same packed arrays (made with numpy from a seed and packed by the JAX
package) go through JAX ``ops/dia.py::dia_matvec``, the Pallas kernel
``pallas_dia_matvec`` in interpret mode, and the port's plain version.  Both
plain versions sum the diagonals in ascending order with separately rounded
multiplies and adds, so they agree to the last bit; the stated tolerances
are f64 1e-14 and f32 1e-6 relative to the largest output entry.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cpkrylov_tpu.ops.dia import dia_matvec as jax_dia_matvec
from cpkrylov_tpu.ops.dia import dia_rmatvec as jax_dia_rmatvec
from cpkrylov_tpu.ops.dia import pack_dia as jax_pack_dia
from cpkrylov_tpu.ops.pallas_dia import pack_pallas_dia, pallas_dia_matvec
from cpkrylov_tpu_torch.ops import cuda_dia, spmv
from cpkrylov_tpu_torch.ops.dia import dia_matvec, dia_rmatvec, pack_dia
from cpkrylov_tpu_torch.utils.convert import dia_from_numpy

torch.set_num_threads(1)

TOL = {np.float32: 1e-6, np.float64: 1e-14}
TORCH = {np.float32: torch.float32, np.float64: torch.float64}


def _near(rng):
    """7-diagonal square band (the main path's A)."""
    n = 3000
    offs = [-3, -2, -1, 0, 1, 2, 3]
    return sp.diags([rng.standard_normal(n - abs(o)) for o in offs], offs,
                    format="csr")


def _kp_far(rng):
    """Natural-order K_P: diagonal plus B/B' at offsets ~ +-n (the case of
    tests/test_sparse.py::test_pallas_dia_far_offset_groups)."""
    n, m = 1500, 400
    N = n + m
    K = sp.lil_matrix((N, N))
    K.setdiag(rng.standard_normal(N))
    for g in range(m):
        K[n + g, g] = rng.standard_normal()
        K[g, n + g] = K[n + g, g]
    return K.tocsr()


def _rect(rng):
    """Rectangular B (m x n) with offsets {0, 1}."""
    m, n = 700, 2000
    return sp.diags([np.ones(m), 0.25 * rng.standard_normal(m)], [0, 1],
                    shape=(m, n), format="csr")


CASES = {"near": _near, "kp_far": _kp_far, "rect": _rect}


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return (np.max(np.abs(np.asarray(got, np.float64) - ref))
            / max(np.max(np.abs(ref)), 1e-300))


def _pair(case, dtype, seed=3):
    rng = np.random.default_rng(seed)
    mat = CASES[case](rng)
    jd = jax_pack_dia(mat, dtype=dtype, max_bytes_ratio=0)
    td = dia_from_numpy(np.asarray(jd.data), jd.offsets, jd.shape,
                        dtype=TORCH[dtype], nnz=jd.nnz)
    return rng, mat, jd, td


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dia_matvec_matches_jax(case, dtype):
    rng, mat, jd, td = _pair(case, dtype)
    x = rng.standard_normal(mat.shape[1]).astype(dtype)
    y_ref = np.asarray(jax_dia_matvec(jd, jnp.asarray(x)))
    y = dia_matvec(td, torch.as_tensor(x))
    assert y.dtype == TORCH[dtype]
    assert _rel(y.numpy(), y_ref) <= TOL[dtype]
    # the CPU tensor goes to the plain version through the wrapper and the
    # dispatcher, and launches nothing
    before = cuda_dia.LAUNCHES
    np.testing.assert_array_equal(
        cuda_dia.dia_spmv(td, torch.as_tensor(x)).numpy(), y.numpy())
    np.testing.assert_array_equal(
        spmv.matvec(td, torch.as_tensor(x)).numpy(), y.numpy())
    assert cuda_dia.LAUNCHES == before


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dia_rmatvec_matches_jax(case, dtype):
    rng, mat, jd, td = _pair(case, dtype, seed=4)
    y = rng.standard_normal(mat.shape[0]).astype(dtype)
    x_ref = np.asarray(jax_dia_rmatvec(jd, jnp.asarray(y)))
    x = dia_rmatvec(td, torch.as_tensor(y))
    assert _rel(x.numpy(), x_ref) <= TOL[dtype]
    assert _rel(x.numpy(), mat.T @ y.astype(np.float64)) <= 1e3 * TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["near", "kp_far"])
def test_dia_matvec_matches_pallas_interpret(case, dtype):
    """The Pallas kernel the port replaces, run in interpret mode on the
    same packed operand (square matrices: the kernel served A and K_P)."""
    rng, mat, jd, td = _pair(case, dtype, seed=5)
    pd = pack_pallas_dia(jd, chunk=256)
    assert pd is not None
    x = rng.standard_normal(mat.shape[1]).astype(dtype)
    y_ref = np.asarray(pallas_dia_matvec(pd, jnp.asarray(x), interpret=True))
    y = dia_matvec(td, torch.as_tensor(x)).numpy()
    assert _rel(y, y_ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pack_dia_matches_jax_pack(dtype):
    """The port's own packer stores the JAX packer's diagonals, and its fill
    gate decides the same way in f32 and f64."""
    rng = np.random.default_rng(8)
    for case in sorted(CASES):
        mat = CASES[case](rng)
        jd = jax_pack_dia(mat, dtype=np.float64, max_bytes_ratio=0)
        td = pack_dia(mat, dtype=dtype, device="cpu")
        assert td is not None and td.offsets == jd.offsets
        np.testing.assert_array_equal(
            td.data.numpy(), np.asarray(jd.data).astype(td.data.numpy().dtype))
        assert td.offsets_t.tolist() == list(jd.offsets)
    # scattered entries: far more padded slots than entries -> rejected
    scattered = sp.random(2000, 2000, density=0.002, random_state=rng,
                          format="csr")
    assert pack_dia(scattered, dtype=dtype, device="cpu") is None
    assert pack_dia(scattered, dtype=dtype, device="cpu",
                    max_fill_ratio=0) is not None


def test_dia_from_numpy_validates():
    with pytest.raises(ValueError):
        dia_from_numpy(np.zeros((2, 5)), (1, 0), (5, 5))
    with pytest.raises(ValueError):
        dia_from_numpy(np.zeros((2, 4)), (0, 1), (5, 5))
