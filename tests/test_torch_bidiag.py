"""The port's bidiagonal solve (``precond/cuda_bidiag.py``) against the JAX
package's Pallas kernel and scipy.

On a CPU tensor the port runs its plain version (a Hillis-Steele scan of the
affine maps).  It is held against ``bidiag_tri_solve(..., interpret=True)``
in f32 (n = 8192, chunk = 1024; relative 2-norm error <= 1e-5, the f32
scan's rounding) and against scipy's sequential substitution in f64
(<= 1e-12), for the lower solve, the right-to-left upper solve and the
upper solve with D folded in.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from cpkrylov_tpu.precond.pallas_bidiag import bidiag_tri_solve as jax_solve
from cpkrylov_tpu.precond.pallas_bidiag import build_bidiag_tri as jax_build
from cpkrylov_tpu.precond.pallas_bidiag import \
    build_bidiag_tri_upper as jax_build_upper
from cpkrylov_tpu_torch.precond import cuda_bidiag
from cpkrylov_tpu_torch.precond.cuda_bidiag import (BidiagTriFactor,
                                                     bidiag_scan,
                                                     bidiag_tri_solve,
                                                     build_bidiag_tri,
                                                     build_bidiag_tri_upper)
from cpkrylov_tpu_torch.precond.trisolve import tri_solve

torch.set_num_threads(1)

N = 8192


def _system(kind, n, seed):
    """(matrix to factor, lower?, scipy reference solve, rhs) for one kind."""
    rng = np.random.default_rng(seed)
    diag = 1.0 + rng.random(n)
    d = np.where(rng.random(n) < 0.5, -1.0, 1.0) * (0.5 + rng.random(n))
    off = rng.standard_normal(n - 1) * 0.4
    b = rng.standard_normal(n)
    if kind == "lower":
        T = sp.diags([diag, off], [0, -1], format="csr")
        return T, True, lambda v: spla.spsolve_triangular(T, v, lower=True), b
    if kind == "upper":
        U = sp.diags([diag, off], [0, 1], format="csr")
        return U, False, \
            lambda v: spla.spsolve_triangular(U, v, lower=False), b
    # "upper_folded": the factor solves D U, which must equal U^-1 (D^-1 v)
    U = sp.diags([np.ones(n), off], [0, 1], format="csr")
    DU = (sp.diags(d) @ U).tocsr()
    return DU, False, \
        lambda v: spla.spsolve_triangular(U, v / d, lower=False), b


def _build(kind, T, dtype):
    if kind == "lower":
        return build_bidiag_tri(T, dtype=dtype, device="cpu")
    return build_bidiag_tri_upper(T, dtype=dtype, device="cpu")


def _relnorm(x, ref):
    x = np.asarray(x, np.float64)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("kind", ["lower", "upper", "upper_folded"])
def test_plain_matches_pallas_interpret_f32(kind):
    T, lower, ref, b = _system(kind, N, seed=11)
    jtf = (jax_build(T, chunk=1024) if lower
           else jax_build_upper(T, chunk=1024))
    assert jtf is not None
    b32 = b.astype(np.float32)
    x_pallas = np.asarray(jax_solve(jtf, jnp.asarray(b32), interpret=True),
                          np.float64)
    tf = _build(kind, T, torch.float32)
    x = bidiag_tri_solve(tf, torch.as_tensor(b32))
    assert x.dtype == torch.float32
    assert _relnorm(x.numpy(), x_pallas) <= 1e-5
    assert _relnorm(x.numpy(), ref(b32.astype(np.float64))) <= 1e-5


@pytest.mark.parametrize("n", [N, 1000, 1])
@pytest.mark.parametrize("kind", ["lower", "upper", "upper_folded"])
def test_plain_matches_scipy_f64(kind, n):
    T, lower, ref, b = _system(kind, n, seed=13)
    tf = _build(kind, T, torch.float64)
    assert tf is not None and tf.reverse == (not lower)
    x = bidiag_tri_solve(tf, torch.as_tensor(b))
    assert x.dtype == torch.float64
    assert _relnorm(x.numpy(), ref(b)) <= 1e-12


def test_build_gates():
    """Mirror of tests/test_pallas_tri.py::test_bidiag_build_gates: reach 2
    and a zero diagonal are rejected.  The Pallas build's f32-only and
    n >= 8*chunk gates are TPU layout and are dropped: small systems and
    f64 build."""
    rng = np.random.default_rng(1)
    n = 4000
    d = 1.0 + rng.random(n)
    reach2 = sp.diags([d, rng.standard_normal(n - 2)], [0, -2])
    assert build_bidiag_tri(reach2, torch.float32, "cpu") is None
    assert build_bidiag_tri_upper(reach2.T, torch.float32, "cpu") is None
    d0 = d.copy()
    d0[7] = 0.0
    assert build_bidiag_tri(sp.diags([d0], [0]), torch.float32, "cpu") is None
    assert build_bidiag_tri_upper(sp.diags([d0], [0]), torch.float64,
                                  "cpu") is None
    # wrong triangle
    assert build_bidiag_tri(sp.diags([d, d[1:]], [0, 1]), torch.float64,
                            "cpu") is None
    assert build_bidiag_tri(sp.diags([d], [0]), torch.float16, "cpu") is None
    for dtype in (torch.float32, torch.float64):
        small = build_bidiag_tri(sp.diags([d[:100]], [0]), dtype, "cpu")
        assert isinstance(small, BidiagTriFactor)
        assert small.a.dtype == dtype and small.invd.dtype == dtype


def test_dispatch_and_cpu_counts_no_launch():
    T, _, _, b = _system("lower", 500, seed=2)
    tf = build_bidiag_tri(T, torch.float64, "cpu")
    before = cuda_bidiag.LAUNCHES
    x1 = tri_solve(tf, torch.as_tensor(b))
    x2 = bidiag_scan(tf.a, tf.invd, torch.as_tensor(b), False)
    np.testing.assert_array_equal(x1.numpy(), x2.numpy())
    assert cuda_bidiag.LAUNCHES == before
    with pytest.raises(ValueError):
        bidiag_tri_solve(tf, torch.zeros(499, dtype=torch.float64))
