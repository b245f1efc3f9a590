"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (decided inside the fixture, never at import).  Run them on a machine
with a card; this file needs no JAX, so ``--noconftest`` lets it run where
JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances: the DIA kernel rounds every multiply and add in the plain
version's order, so it must agree bit for bit (f32 1e-6, f64 1e-14 stated
relative bounds); the bidiagonal scan is held against scipy's sequential
f64 substitution (f32 1e-5, f64 1e-12 relative 2-norm).  The df64 DIA
kernel rounds every step of its error-free chain explicitly, so it must
equal its plain version exactly (hi and lo), and hi + lo must agree with
scipy's f64 product to 1e-12 relative.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.float64]
DIA_TOL = {torch.float32: 1e-6, torch.float64: 1e-14}
SCAN_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _dia_cases(rng):
    n, m = 20_000, 5_000
    offs = [-3, -2, -1, 0, 1, 2, 3]
    A = sp.diags([rng.standard_normal(n - abs(o)) for o in offs], offs,
                 format="csr")
    B = sp.diags([np.ones(m), rng.standard_normal(m)], [0, 1], shape=(m, n),
                 format="csr")
    G = sp.diags(A.diagonal())
    K = sp.bmat([[G, B.T], [B, -1e-4 * sp.identity(m)]], format="csr")
    return {"A": A, "K_P": K, "B": B}


@pytest.mark.parametrize("dtype", DTYPES)
def test_dia_kernel_matches_plain(cuda, dtype):
    from cpkrylov_tpu_torch.ops import cuda_dia
    from cpkrylov_tpu_torch.ops.dia import dia_matvec, pack_dia

    rng = np.random.default_rng(0)
    for name, mat in _dia_cases(rng).items():
        d = pack_dia(mat, dtype=dtype, device=cuda)
        assert d is not None, name
        x = torch.as_tensor(rng.standard_normal(mat.shape[1])).to(
            device=cuda, dtype=dtype)
        before = cuda_dia.LAUNCHES
        y = cuda_dia.dia_spmv(d, x)
        assert cuda_dia.LAUNCHES == before + 1
        ref = dia_matvec(d, x)
        torch.cuda.synchronize()
        err = float(torch.max(torch.abs(y - ref)) / torch.max(torch.abs(ref)))
        assert err <= DIA_TOL[dtype], (name, err)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 2047, 2048, 100_003])
def test_bidiag_kernel_matches_scipy(cuda, dtype, reverse, n):
    from cpkrylov_tpu_torch.precond import cuda_bidiag

    rng = np.random.default_rng(n)
    dd = 1.0 + rng.random(n)
    off = 0.4 * rng.standard_normal(n - 1)
    b = rng.standard_normal(n)
    if reverse:
        T = sp.diags([dd, off], [0, 1], format="csr")
        tf = cuda_bidiag.build_bidiag_tri_upper(T, dtype, cuda)
    else:
        T = sp.diags([dd, off], [0, -1], format="csr")
        tf = cuda_bidiag.build_bidiag_tri(T, dtype, cuda)
    before = cuda_bidiag.LAUNCHES
    x = cuda_bidiag.bidiag_tri_solve(
        tf, torch.as_tensor(b).to(device=cuda, dtype=dtype))
    assert cuda_bidiag.LAUNCHES == before + 1
    x_ref = spla.spsolve_triangular(T, b, lower=not reverse)
    err = (np.linalg.norm(x.double().cpu().numpy() - x_ref)
           / np.linalg.norm(x_ref))
    assert err <= SCAN_TOL[dtype], err


def test_wrappers_raise_on_bad_operands(cuda):
    from cpkrylov_tpu_torch.ops.cuda_dia import dia_spmv
    from cpkrylov_tpu_torch.ops.dia import pack_dia
    from cpkrylov_tpu_torch.precond.cuda_bidiag import bidiag_scan

    A = sp.diags([np.ones(100), np.ones(99)], [0, 1], format="csr")
    d = pack_dia(A, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        dia_spmv(d, torch.ones(100, dtype=torch.float32, device=cuda))
    with pytest.raises(ValueError):
        dia_spmv(d, torch.ones(99, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        dia_spmv(d, torch.ones(200, dtype=torch.float64, device=cuda)[::2])
    one = torch.ones(10, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        bidiag_scan(one.float(), one, one, False)
    with pytest.raises(ValueError):
        bidiag_scan(one[:9], one, one, False)


def test_golden_cvxqp1_on_card(cuda):
    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.utils import fixtures

    s = fixtures.load_fixture("cvxqp1_m")
    out = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, device=cuda,
                    dtype=torch.float64,
                    opts=cpt.SolverOptions(atol=1e-6, rtol=1e-6, itmax=500),
                    precond_opts=cpt.PrecondOptions(
                        residual_update=True, nitref=1, force_itref=True))
    x_ref = spla.spsolve(s.K.tocsc(), s.b)
    rel = (np.linalg.norm(out.x.cpu().numpy() - x_ref)
           / np.linalg.norm(x_ref))
    assert out.solved and abs(out.niters - 53) <= 2 and rel < 5e-6


def test_banded_main_path_goes_through_kernels(cuda):
    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.ops import cuda_dia
    from cpkrylov_tpu_torch.precond import cuda_bidiag
    from cpkrylov_tpu_torch.utils import fixtures

    s = fixtures.banded_saddle_system(20_000, 5_000)
    dia0, scan0 = cuda_dia.LAUNCHES, cuda_bidiag.LAUNCHES
    out = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, device=cuda,
                    dtype=torch.float64,
                    opts=cpt.SolverOptions(atol=0.0, rtol=1e-6, itmax=200),
                    precond_opts=cpt.PrecondOptions(
                        residual_update=True, nitref=1, force_itref=True))
    assert out.solved
    assert cuda_dia.LAUNCHES - dia0 >= 4 * out.niters
    assert cuda_bidiag.LAUNCHES - scan0 >= 4 * out.niters
    r = s.K @ out.x.cpu().numpy() - s.b
    assert np.linalg.norm(r) <= 1e-6 * np.linalg.norm(s.b)


def _df_cases(rng):
    """Square and rectangular df64 DIA operands whose offsets reach past
    both ends, with row counts that are not a multiple of the block."""
    n, m = 20_011, 5_003
    offs = [-7, -3, -1, 0, 2, 5]
    A = sp.diags([rng.standard_normal(n - abs(o)) for o in offs], offs,
                 format="csr")
    B = sp.diags([1.0 + rng.random(m), rng.standard_normal(m)], [0, 1],
                 shape=(m, n), format="csr")
    far = sp.diags([rng.standard_normal(n - 12_000), rng.standard_normal(n)],
                   [-12_000, 0], shape=(n, n), format="csr")
    return {"A": A, "B": B, "Bt": B.T.tocsr(), "far": far}


def test_df_dia_kernel_matches_plain_bitwise(cuda):
    from cpkrylov_tpu_torch.ops import cuda_df_dia
    from cpkrylov_tpu_torch.ops.df64 import (df_dia_matvec, df_from_f64,
                                             pack_df_dia)

    rng = np.random.default_rng(3)
    for name, mat in _df_cases(rng).items():
        d = pack_df_dia(mat, device=cuda)
        assert d is not None, name
        x = rng.standard_normal(mat.shape[1]) * 1e3
        xh, xl = (torch.as_tensor(v).to(cuda) for v in df_from_f64(x))
        before = cuda_df_dia.LAUNCHES
        yh, yl = cuda_df_dia.df_dia_spmv(d, xh, xl)
        assert cuda_df_dia.LAUNCHES == before + 1
        ph, pl = df_dia_matvec(d, (xh, xl))
        torch.cuda.synchronize()
        assert torch.equal(yh, ph) and torch.equal(yl, pl), name
        y = yh.double().cpu().numpy() + yl.double().cpu().numpy()
        exact = mat @ x
        assert (np.linalg.norm(y - exact) / np.linalg.norm(exact)
                <= 1e-12), name


def test_df_dia_wrapper_raises_on_bad_operands(cuda):
    from cpkrylov_tpu_torch.ops.cuda_df_dia import df_dia_spmv
    from cpkrylov_tpu_torch.ops.df64 import pack_df_dia

    A = sp.diags([np.ones(100), np.ones(99)], [0, 1], format="csr")
    d = pack_df_dia(A, device=cuda)
    one = torch.ones(100, dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        df_dia_spmv(d, one.double(), one)
    with pytest.raises(ValueError):
        df_dia_spmv(d, one[:99], one[:99])
    with pytest.raises(ValueError):
        df_dia_spmv(d, torch.ones(200, device=cuda)[::2], one)
    with pytest.raises(ValueError):
        df_dia_spmv(d, one, one.cpu())
    d_cpu = pack_df_dia(A, device="cpu")
    with pytest.raises(ValueError):
        df_dia_spmv(d_cpu, one, one)


def test_mixed_device_loop_goes_through_kernels(cuda):
    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.ops import cuda_df_dia, cuda_dia
    from cpkrylov_tpu_torch.precond import cuda_bidiag
    from cpkrylov_tpu_torch.utils import fixtures

    s = fixtures.banded_saddle_system(20_000, 5_000)
    M = cpt.make_preconditioner(s.G, s.B, s.C, dtype=torch.float32,
                                device=cuda)
    c0 = (cuda_df_dia.LAUNCHES, cuda_dia.LAUNCHES, cuda_bidiag.LAUNCHES)
    out = cpt.solve_mixed(
        "cpminres", s.b, s.A, s.B, s.C, s.G, M=M, device=cuda,
        device_resident=True, inner_stagwin=25,
        opts=cpt.SolverOptions(atol=0.0, rtol=1e-8, itmax=200, stagwin=25))
    assert out.solved and out.inner_outputs == ()
    assert cuda_df_dia.LAUNCHES - c0[0] >= 3 * out.nouter
    assert cuda_dia.LAUNCHES - c0[1] >= out.niters
    assert cuda_bidiag.LAUNCHES - c0[2] >= 2 * out.niters
    r = s.K @ out.x - s.b
    assert np.linalg.norm(r) <= 1e-8 * np.linalg.norm(s.b)
