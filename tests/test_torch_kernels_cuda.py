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
scipy's f64 product to 1e-12 relative.  The banded solve (B4) and its
scan (B6) sum their dot products in another order than their plain
versions: both are held against the plain versions and, for B4, scipy's
f64 ``spsolve_triangular`` on diagonally dominant bands (relative 2-norm,
f32 1e-4 and f64 1e-12; the CPU plain version measures 5e-8 and 2.2e-16
there).  The CSR kernel (B5) sums each row in stored order, every step
rounded, so it must equal its plain version exactly.
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


BAND_TOL = {torch.float32: 1e-4, torch.float64: 1e-12}


def _banded_lower(n, reach, seed):
    """Diagonally dominant lower band: diagonal 4, reach subdiagonals of
    N(0, (0.3 / reach)^2)."""
    rng = np.random.default_rng(seed)
    diags = [np.full(n, 4.0)] + [rng.standard_normal(n - k - 1) * 0.3 / reach
                                 for k in range(reach)]
    return sp.diags(diags, [0] + [-(k + 1) for k in range(reach)],
                    format="csr")


def _rel2(x, ref):
    x = np.asarray(x.double().cpu().numpy() if torch.is_tensor(x) else x)
    ref = np.asarray(ref.double().cpu().numpy() if torch.is_tensor(ref)
                     else ref)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,reach,panel", [(2048, 5, 16), (2000, 7, 24),
                                           (30_011, 79, 80),
                                           (20_000, 631, 632),
                                           (6_000, 1024, 1024)])
def test_band_tri_kernel_matches_plain_and_scipy(cuda, dtype, n, reach,
                                                 panel):
    from cpkrylov_tpu_torch.precond import cuda_tri
    from cpkrylov_tpu_torch.precond.trisolve import build_reduced_scan_tri

    T = _banded_lower(n, reach, seed=reach)
    tf = build_reduced_scan_tri(T, dtype, cuda, panel=panel)
    assert tf is not None and tf.r == reach
    b64 = np.random.default_rng(n).standard_normal(n)
    b = torch.as_tensor(b64).to(device=cuda, dtype=dtype)
    before = (cuda_tri.LAUNCHES, cuda_tri.SCAN_LAUNCHES)
    x = cuda_tri.band_tri_solve(tf, b)
    assert (cuda_tri.LAUNCHES, cuda_tri.SCAN_LAUNCHES) == (before[0] + 1,
                                                           before[1] + 1)
    xp = cuda_tri.band_tri_solve_plain(tf, b)
    torch.cuda.synchronize()
    x_ref = spla.spsolve_triangular(T, b.double().cpu().numpy(), lower=True)
    assert _rel2(x, x_ref) <= BAND_TOL[dtype]
    assert _rel2(x, xp) <= BAND_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r,nb", [(1, 5), (8, 1000), (100, 77), (1024, 9)])
def test_affine_scan_kernel_matches_plain(cuda, dtype, r, nb):
    from cpkrylov_tpu_torch.precond import cuda_tri

    rng = np.random.default_rng(r * nb)
    mr = torch.as_tensor(rng.standard_normal((r, r, nb)) * 0.5 / np.sqrt(r))
    cr = torch.as_tensor(rng.standard_normal((r, nb)))
    mr, cr = mr.to(device=cuda, dtype=dtype), cr.to(device=cuda, dtype=dtype)
    ref = cuda_tri.affine_scan_plain(mr, cr)
    # the lane-major tensor and a step-major one viewed as (r, r, nb)
    for m in (mr, mr.permute(2, 0, 1).contiguous().permute(1, 2, 0)):
        before = cuda_tri.SCAN_LAUNCHES
        s = cuda_tri.affine_scan(m, cr)
        assert cuda_tri.SCAN_LAUNCHES == before + 1
        torch.cuda.synchronize()
        assert s.shape == (r, nb)
        assert _rel2(s, ref) <= BAND_TOL[dtype]


def _csr_cases():
    from cpkrylov_tpu_torch.precond.cp import assemble_kp
    from cpkrylov_tpu_torch.utils.mm import aug_kkt, cvxqp_kkt

    q = cvxqp_kkt("cvxqp3", 2000)
    a = aug_kkt("2d", 40)
    return {"cvxqp3_A": q.A, "cvxqp3_B": q.B,
            "aug2d_K_P": assemble_kp(a.G, a.B, a.C), "aug2d_B": a.B}


@pytest.mark.parametrize("dtype", DTYPES)
def test_csr_kernel_matches_plain_bitwise(cuda, dtype):
    from cpkrylov_tpu_torch.ops import cuda_spmv
    from cpkrylov_tpu_torch.ops.formats import csr_from_scipy

    rng = np.random.default_rng(9)
    for name, mat in _csr_cases().items():
        c = csr_from_scipy(mat, dtype, cuda)
        x = torch.as_tensor(rng.standard_normal(mat.shape[1])).to(
            device=cuda, dtype=dtype)
        v = torch.as_tensor(rng.standard_normal(mat.shape[0])).to(
            device=cuda, dtype=dtype)
        before = cuda_spmv.LAUNCHES
        y = cuda_spmv.csr_spmv(c, x)
        z = cuda_spmv.csr_rmatvec(c, v)
        assert cuda_spmv.LAUNCHES == before + 2
        yp = cuda_spmv.csr_matvec_plain(c, x)
        zp = cuda_spmv.csr_matvec_plain(c.t, v)
        torch.cuda.synchronize()
        assert torch.equal(y, yp) and torch.equal(z, zp), name
        assert torch.equal(cuda_spmv.csr_spmv(c, x), y), name   # repeats
        xr = x.double().cpu().numpy()
        assert _rel2(y, mat @ xr) <= (1e-6 if dtype == torch.float32
                                      else 1e-14), name


def test_new_wrappers_raise_on_bad_operands(cuda):
    from cpkrylov_tpu_torch.ops.cuda_spmv import csr_spmv
    from cpkrylov_tpu_torch.ops.formats import csr_from_scipy
    from cpkrylov_tpu_torch.precond.cuda_tri import (affine_scan,
                                                     band_tri_solve)
    from cpkrylov_tpu_torch.precond.trisolve import build_reduced_scan_tri

    A = sp.diags([np.ones(100), np.ones(99)], [0, 1], format="csr")
    c = csr_from_scipy(A, torch.float64, cuda)
    with pytest.raises(TypeError):
        csr_spmv(c, torch.ones(100, dtype=torch.float32, device=cuda))
    with pytest.raises(ValueError):
        csr_spmv(c, torch.ones(99, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        csr_spmv(csr_from_scipy(A, torch.float64, "cpu"),
                 torch.ones(100, dtype=torch.float64, device=cuda))
    tf = build_reduced_scan_tri(_banded_lower(500, 3, 0), torch.float64,
                                cuda, panel=8)
    with pytest.raises(TypeError):
        band_tri_solve(tf, torch.ones(500, dtype=torch.float32, device=cuda))
    with pytest.raises(ValueError):
        band_tri_solve(tf, torch.ones(499, dtype=torch.float64, device=cuda))
    one = torch.ones(4, 6, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        affine_scan(torch.ones(4, 5, 6, dtype=torch.float64, device=cuda),
                    one)
    with pytest.raises(ValueError):
        affine_scan(torch.ones(1025, 1025, 1, dtype=torch.float64,
                               device=cuda),
                    torch.ones(1025, 1, dtype=torch.float64, device=cuda))


@pytest.mark.parametrize("system", ["aug2d_40", "cvxqp3_2000"])
def test_mm_path_goes_through_kernels(cuda, system):
    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.precond.trisolve import (BlockTriFactor,
                                                     ReducedScanTriFactor)
    from cpkrylov_tpu_torch.utils.mm import aug_kkt, cvxqp_kkt
    from cpkrylov_tpu_torch.utils.profiling import (launch_counts,
                                                    reset_launches)

    s = aug_kkt("2d", 40) if system == "aug2d_40" else \
        cvxqp_kkt("cvxqp3", 2000)
    opts = cpt.SolverOptions(atol=1e-6, rtol=1e-6, itmax=1000)
    M = cpt.make_preconditioner(s.G, s.B, s.C)           # the card: default
    form = ReducedScanTriFactor if system == "aug2d_40" else BlockTriFactor
    assert isinstance(M.factor.tf1, form) and isinstance(M.factor.tf2, form)
    reset_launches()
    out = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, opts=opts, M=M,
                    dtype=torch.float64)
    counts = launch_counts()
    assert out.x.device.type == "cuda" and out.solved
    # the CPU counts of both packages: 5 and 43 (tests/test_torch_mm.py)
    assert abs(out.niters - (5 if system == "aug2d_40" else 43)) <= 2
    assert counts["csr_spmv"] > 0
    if system == "aug2d_40":
        assert counts["band_tri"] >= 2 * out.niters
        assert counts["affine_scan"] >= 2 * out.niters
    # CPMINRES stops on the preconditioned residual: both packages end at
    # 0.1115 and 1.2872 times atol + rtol |b| on the CPU
    # (tests/test_torch_mm.py); the card may sum its dot products in
    # another order, so 5 % more
    x = out.x.cpu().numpy()
    contract = 1e-6 + 1e-6 * np.linalg.norm(s.b)
    limit = 0.12 if system == "aug2d_40" else 1.35
    assert np.linalg.norm(s.b - s.K @ x) <= limit * contract
