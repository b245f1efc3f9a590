"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (decided inside the fixture, never at import).  Run them on a machine
with a card; this file needs no JAX, so ``--noconftest`` lets it run where
JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances: the DIA kernel rounds every multiply and add in the plain
version's order, so it must agree bit for bit (f32 1e-6, f64 1e-14 stated
relative bounds); the bidiagonal scan rounds every multiply and add in its
plain version's order, so it must equal it bit for bit (also across
repeated calls, streams and CUDA-graph replays), and it is held against
scipy's sequential f64 substitution (f32 1e-5, f64 1e-12 relative 2-norm).  The df64 DIA
kernel rounds every step of its error-free chain explicitly, so it must
equal its plain version exactly (hi and lo), and hi + lo must agree with
scipy's f64 product to 1e-12 relative.  The banded solve (B4) and its
scan (B6) sum their dot products in another order than their plain
versions: both are held against the plain versions and, for B4, scipy's
f64 ``spsolve_triangular`` on diagonally dominant bands (relative 2-norm,
f32 1e-4 and f64 1e-12; the CPU plain version measures 5e-8 and 2.2e-16
there).  The CSR kernel (B5) sums each row in stored order, every step
rounded, so it must equal its plain version exactly.  The interleave riffle
(B7) and its inverse (B8) move entries without arithmetic: exact.
Blocked substitution (B9) sums each row and each panel product in a fixed
order of its own: held to BAND_TOL against its plain version and scipy on
the factor of ``cvxqp_kkt("cvxqp3", 2000)``, and bit for bit against a
second call; at panels of 1536 and 2048 on cvxqp1_m's factor, whose
element growth amplifies rounding, to BLOCK_TOL (``chip_smoke.py``'s).
The df64 triangle product (B10) rounds every step of its chain
explicitly: hi and lo equal its plain version's exactly, also with the
special values of x[0] that its padding slots read.  The DIA placement on
the card moves and rounds each value as on the CPU and as the host pack it
replaced: exact, and the main system's solves keep their bits.  So does
the blocked factor's placement on the card (its ELL arrays against the CPU
pack); its panel inverses, a batched triangular solve on the card against
LAPACK's trtri on the CPU, to CARD_INV_TOL.
"""
import functools

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.float64]
DIA_TOL = {torch.float32: 1e-6, torch.float64: 1e-14}
SCAN_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _launches(kernel: str) -> int:
    """``kernel``'s launches in the counter registry."""
    from cpkrylov_tpu_torch.utils.profiling import launch_counts

    return launch_counts()[kernel]


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
        before = _launches("dia_spmv")
        y = cuda_dia.dia_spmv(d, x)
        assert _launches("dia_spmv") == before + 1
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
    before = _launches("bidiag_scan")
    x = cuda_bidiag.bidiag_tri_solve(
        tf, torch.as_tensor(b).to(device=cuda, dtype=dtype))
    assert _launches("bidiag_scan") == before + 1
    x_ref = spla.spsolve_triangular(T, b, lower=not reverse)
    err = (np.linalg.norm(x.double().cpu().numpy() - x_ref)
           / np.linalg.norm(x_ref))
    assert err <= SCAN_TOL[dtype], err


def _scan_operands(n, seed, dtype, device):
    rng = np.random.default_rng(seed)
    dd = 1.0 + rng.random(n)
    return tuple(torch.as_tensor(v).to(device=device, dtype=dtype) for v in (
        0.4 * rng.standard_normal(n) / dd, 1.0 / dd, rng.standard_normal(n)))


# the ragged sizes of tests/test_torch_bidiag.py (TILE = 2048): one partial
# tile, exact tiles, above 32 and above 256 tiles; and the main path's n
SCAN_SIZES = [1, 2, 2047, 2048, 2049, 3 * 2048 + 5, 33 * 2048 + 1,
              257 * 2048 + 3, 1_000_003, 1_250_000]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", SCAN_SIZES)
def test_bidiag_kernel_equals_plain_bitwise(cuda, dtype, reverse, n):
    """The kernel rounds every multiply and add in the plain version's
    order: exact."""
    from cpkrylov_tpu_torch.precond import cuda_bidiag

    a, invd, b = _scan_operands(n, n, dtype, cuda)
    x = cuda_bidiag.bidiag_scan(a, invd, b, reverse)
    ref = cuda_bidiag.bidiag_scan_plain(a, invd, b, reverse)
    torch.cuda.synchronize()
    assert torch.equal(x, ref)


def test_bidiag_tile_is_the_python_constant(cuda):
    from cpkrylov_tpu_torch.precond import cuda_bidiag

    assert cuda_bidiag._TILE() == cuda_bidiag.TILE


@pytest.mark.parametrize("dtype", DTYPES)
def test_bidiag_kernel_repeats_its_bits(cuda, dtype):
    """20 back-to-back calls on one stream give identical bits."""
    from cpkrylov_tpu_torch.precond import cuda_bidiag

    a, invd, b = _scan_operands(1_250_000, 3, dtype, cuda)
    xs = [cuda_bidiag.bidiag_scan(a, invd, b, False) for _ in range(20)]
    torch.cuda.synchronize()
    assert all(torch.equal(x, xs[0]) for x in xs[1:])


def test_bidiag_kernel_bits_across_sizes_and_streams(cuda):
    """Calls alternating in n and direction on one stream, and the same
    calls on two streams at once, all give the plain version's bits."""
    from cpkrylov_tpu_torch.precond import cuda_bidiag

    cases = [(n, rev) for n in (1_250_000, 4099, 600_001, 1)
             for rev in (False, True)]
    ops = {n: _scan_operands(n, n, torch.float64, cuda)
           for n, _ in cases}
    ref = {(n, rev): cuda_bidiag.bidiag_scan_plain(*ops[n], rev)
           for n, rev in cases}
    for _ in range(3):
        for n, rev in cases:
            assert torch.equal(cuda_bidiag.bidiag_scan(*ops[n], rev),
                               ref[(n, rev)])
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(3):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                for n, rev in cases[i::2] + cases[1 - i::2]:
                    outs[i].append(((n, rev),
                                    cuda_bidiag.bidiag_scan(*ops[n], rev)))
    torch.cuda.synchronize()
    for out in outs:
        for key, x in out:
            assert torch.equal(x, ref[key]), key


@pytest.mark.parametrize("dtype", DTYPES)
def test_bidiag_kernel_replays_in_a_cuda_graph(cuda, dtype):
    """A call captured in a CUDA graph and replayed 5 times gives the plain
    version's bits each replay: the kernel's state resets itself."""
    from cpkrylov_tpu_torch.precond import cuda_bidiag

    a, invd, b = _scan_operands(1_000_003, 5, dtype, cuda)
    ref = cuda_bidiag.bidiag_scan_plain(a, invd, b, True)
    stream = torch.cuda.Stream(cuda)
    with torch.cuda.stream(stream):    # the state for this stream, first
        cuda_bidiag.bidiag_scan(a, invd, b, True)
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        x = cuda_bidiag.bidiag_scan(a, invd, b, True)
    for _ in range(5):
        x.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(x, ref)


def test_bidiag_state_survives_the_tag_wrap(cuda):
    """Calls across the wrap of the 32-bit tag (the epoch pushed to just
    below it) give the plain version's bits: the wrapping call clears the
    records, so none left from an earlier call is taken as ready."""
    from cpkrylov_tpu_torch.precond import cuda_bidiag

    a, invd, b = _scan_operands(600_001, 4, torch.float64, cuda)
    ref = cuda_bidiag.bidiag_scan_plain(a, invd, b, False)
    stream = torch.cuda.Stream(cuda)
    with torch.cuda.stream(stream):
        cuda_bidiag.bidiag_scan(a, invd, b, False)
        state = cuda_bidiag._STATES[(cuda.index, stream.cuda_stream)]
        state[0] = 2**32 - 4
        for _ in range(6):
            x = cuda_bidiag.bidiag_scan(a, invd, b, False)
            stream.synchronize()
            assert torch.equal(x, ref)
    assert int(state[0]) == 2**32 + 3      # one tag skipped at the wrap


def test_bidiag_call_is_one_kernel_and_no_memset(cuda):
    """One call shows in a profiler trace as one kernel launch, with no
    memset and no copy."""
    from torch.profiler import ProfilerActivity, profile

    from cpkrylov_tpu_torch.precond import cuda_bidiag

    a, invd, b = _scan_operands(1_250_000, 9, torch.float64, cuda)
    cuda_bidiag.bidiag_scan(a, invd, b, False)       # state made, built
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cuda_bidiag.bidiag_scan(a, invd, b, False)
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if str(e.device_type).endswith("CUDA")]
    names = [e.name for e in ops]
    assert len(ops) == 1 and "bidiag_scan_kernel" in names[0], names


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
    dia0, scan0 = _launches("dia_spmv"), _launches("bidiag_scan")
    out = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, device=cuda,
                    dtype=torch.float64,
                    opts=cpt.SolverOptions(atol=0.0, rtol=1e-6, itmax=200),
                    precond_opts=cpt.PrecondOptions(
                        residual_update=True, nitref=1, force_itref=True))
    assert out.solved
    assert _launches("dia_spmv") - dia0 >= 4 * out.niters
    assert _launches("bidiag_scan") - scan0 >= 4 * out.niters
    r = s.K @ out.x.cpu().numpy() - s.b
    assert np.linalg.norm(r) <= 1e-6 * np.linalg.norm(s.b)


@pytest.mark.parametrize("name", ["cpcg", "cpcglanczos", "cpsymmlq",
                                  "cpgmres", "cpdqgmres"])
def test_banded_solvers_go_through_riffle(cuda, name):
    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.utils import fixtures
    from cpkrylov_tpu_torch.utils.profiling import (launch_counts,
                                                    reset_launches)

    s = fixtures.banded_saddle_system(20_000, 5_000)
    reset_launches()
    out = cpt.solve(name, s.b, s.A, s.B, s.C, s.G, device=cuda,
                    dtype=torch.float64,
                    opts=cpt.SolverOptions(atol=0.0, rtol=1e-6, itmax=200),
                    precond_opts=cpt.PrecondOptions(
                        residual_update=True, nitref=1, force_itref=True))
    counts = launch_counts()
    assert out.solved, out.result.status
    for kernel in ("dia_spmv", "bidiag_scan", "interleave", "uninterleave"):
        assert counts[kernel] >= out.niters, (kernel, counts)
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
        before = _launches("df_dia_spmv")
        yh, yl = cuda_df_dia.df_dia_spmv(d, xh, xl)
        assert _launches("df_dia_spmv") == before + 1
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
    c0 = (_launches("df_dia_spmv"), _launches("dia_spmv"),
          _launches("bidiag_scan"))
    out = cpt.solve_mixed(
        "cpminres", s.b, s.A, s.B, s.C, s.G, M=M, device=cuda,
        device_resident=True, inner_stagwin=25,
        opts=cpt.SolverOptions(atol=0.0, rtol=1e-8, itmax=200, stagwin=25))
    assert out.solved and out.inner_outputs == ()
    assert _launches("df_dia_spmv") - c0[0] >= 3 * out.nouter
    assert _launches("dia_spmv") - c0[1] >= out.niters
    assert _launches("bidiag_scan") - c0[2] >= 2 * out.niters
    r = s.K @ out.x - s.b
    assert np.linalg.norm(r) <= 1e-8 * np.linalg.norm(s.b)


BAND_TOL = {torch.float32: 1e-4, torch.float64: 1e-12}
# blocked substitution on factors with element growth (chip_smoke.py's
# BLOCK_TOL: about 10x the largest card reading at cvxqp1_m)
BLOCK_TOL = {torch.float32: 4e-4, torch.float64: 1e-12}


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
# the scan forms every row of x_i (head rows too) and writes it into x in
# place: more than 32 head rows (88), p = r, one panel (n <= p), n not a
# multiple of p, and r below the cluster's 16 blocks
@pytest.mark.parametrize("n,reach,panel", [(2048, 5, 16), (2000, 7, 24),
                                           (30_011, 79, 80),
                                           (20_000, 631, 632),
                                           (6_000, 1024, 1024),
                                           (4096, 40, 128), (1500, 16, 16),
                                           (500, 7, 512), (10_001, 100, 104),
                                           (3000, 3, 8), (5000, 7, 512),
                                           (20_000, 64, 256)])
def test_band_tri_kernel_matches_plain_and_scipy(cuda, dtype, n, reach,
                                                 panel):
    from cpkrylov_tpu_torch.precond import cuda_tri
    from cpkrylov_tpu_torch.precond.trisolve import build_reduced_scan_tri

    T = _banded_lower(n, reach, seed=reach)
    tf = build_reduced_scan_tri(T, dtype, cuda, panel=panel)
    assert tf is not None and tf.r == reach
    b64 = np.random.default_rng(n).standard_normal(n)
    b = torch.as_tensor(b64).to(device=cuda, dtype=dtype)
    before = (_launches("band_tri"), _launches("affine_scan"))
    x = cuda_tri.band_tri_solve(tf, b)
    assert (_launches("band_tri"), _launches("affine_scan")) == (before[0] + 1,
                                                           before[1] + 1)
    xp = cuda_tri.band_tri_solve_plain(tf, b)
    torch.cuda.synchronize()
    x_ref = spla.spsolve_triangular(T, b.double().cpu().numpy(), lower=True)
    assert _rel2(x, x_ref) <= BAND_TOL[dtype]
    assert _rel2(x, xp) <= BAND_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r,nb", [(1, 5), (8, 1000), (100, 77), (1024, 9),
                                  (37, 50), (631, 40), (17, 300)])
def test_affine_scan_kernel_matches_plain(cuda, dtype, r, nb):
    from cpkrylov_tpu_torch.precond import cuda_tri

    rng = np.random.default_rng(r * nb)
    mr = torch.as_tensor(rng.standard_normal((r, r, nb)) * 0.5 / np.sqrt(r))
    cr = torch.as_tensor(rng.standard_normal((r, nb)))
    mr, cr = mr.to(device=cuda, dtype=dtype), cr.to(device=cuda, dtype=dtype)
    ref = cuda_tri.affine_scan_plain(mr, cr)
    # the lane-major tensor and a step-major one viewed as (r, r, nb)
    for m in (mr, mr.permute(2, 0, 1).contiguous().permute(1, 2, 0)):
        before = _launches("affine_scan")
        s = cuda_tri.affine_scan(m, cr)
        assert _launches("affine_scan") == before + 1
        torch.cuda.synchronize()
        assert s.shape == (r, nb)
        assert _rel2(s, ref) <= BAND_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_scan_read_floor_reads_the_scan_slices(cuda, dtype):
    """The chain-free read of B6's slices (the floor chip_smoke.py times)
    leaves the state zero, so it returns c exactly, and counts no launch."""
    from cpkrylov_tpu_torch.precond import cuda_tri

    rng = np.random.default_rng(12)
    q, r, nb = 40, 37, 60
    m = torch.as_tensor(rng.standard_normal((nb, q, r))).to(
        device=cuda, dtype=dtype).permute(1, 2, 0)
    c = torch.as_tensor(rng.standard_normal((q, nb))).to(device=cuda,
                                                          dtype=dtype)
    before = _launches("affine_scan")
    y = cuda_tri.scan_read_floor(m, c, r)
    torch.cuda.synchronize()
    assert _launches("affine_scan") == before
    assert torch.equal(y, c)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q,r", [(632, 631), (1024, 1024), (8, 3)])
def test_scan_layout_fits_one_block_per_sm(cuda, dtype, q, r):
    """The layout covers every row with at most 32 warps, each warp's ring
    holds at least two rows, and the rings and the double-buffered state
    fit the 227 KB a block may use."""
    from cpkrylov_tpu_torch.precond import cuda_tri

    lay = cuda_tri.scan_layout(q, r, dtype)
    item = torch.empty((), dtype=dtype).element_size()
    assert lay["cluster"] == 16
    assert lay["rows_per_block"] * lay["cluster"] >= q
    assert lay["warps"] * lay["rows_per_warp"] >= lay["rows_per_block"]
    assert 1 <= lay["warps"] <= 32
    assert lay["ring_bytes"] >= lay["warps"] * 2 * r * item
    assert lay["ring_bytes"] + 2 * 1024 * item <= 232_448 - 2048


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q,r", [(632, 631), (1024, 1024), (96, 92),
                                 (8, 3), (512, 7), (256, 64), (512, 1),
                                 (1024, 1)])
def test_scan_grid_layout_fits_one_block_per_sm(cuda, dtype, q, r):
    """The grid scan's layout gives every row a block (one block a SM for
    every 8 rows, at most the resident blocks and r, the head and the state
    rows each shared out), covers a block's rows with at most 16 warps of
    at most 32 rows, holds two steps of a warp's rows in its ring (or its
    16 slots), and the rings with the state, the mbarriers and the tag fit
    the 227 KB a block may use; ``scan_path`` takes it where a warp holds
    one row.  A shape whose block would need warps of more than 32 rows is
    refused."""
    from cpkrylov_tpu_torch.precond import cuda_tri

    blocks = cuda_tri.resident_blocks(cuda)
    g = cuda_tri.grid_blocks(q, r, blocks)
    assert g == min(blocks, r, -(-q // 8))
    rows = -(-(q - r) // g) + -(-r // g)
    if rows > 16 * 32:
        with pytest.raises(RuntimeError):
            cuda_tri.scan_grid_layout(q, r, dtype, blocks)
        assert cuda_tri.scan_path(q, r, blocks) == "cluster"
        return
    lay = cuda_tri.scan_grid_layout(q, r, dtype, blocks)
    item = torch.empty((), dtype=dtype).element_size()
    assert lay["blocks"] == g
    assert lay["rows_per_block"] == rows
    assert lay["rows_per_block"] * g >= q
    assert lay["warps"] * lay["rows_per_warp"] >= lay["rows_per_block"]
    assert 1 <= lay["warps"] <= 16
    assert 1 <= lay["rows_per_warp"] <= 32
    assert lay["slots"] >= min(2 * lay["rows_per_warp"], 16)
    assert lay["ring_bytes"] >= lay["warps"] * lay["slots"] * r * item
    assert lay["ring_bytes"] + lay["static_bytes"] <= 232_448
    one_row = lay["rows_per_warp"] == 1
    assert (cuda_tri.scan_path(q, r, blocks) == "grid") == one_row


# (n, reach, panel): AUG2D-L's p and r, f32 shapes, panels of many head
# rows and the Schur path's p 8, r 2
@pytest.mark.parametrize("dtype,n,reach,panel", [
    (torch.float64, 20_000, 631, 632), (torch.float32, 20_000, 631, 632),
    (torch.float32, 20_000, 400, 408), (torch.float64, 6_000, 1024, 1024),
    (torch.float64, 5000, 7, 512), (torch.float32, 20_000, 64, 256),
    (torch.float64, 3000, 3, 8)])
def test_grid_scan_gives_the_cluster_scans_bits(cuda, dtype, n, reach,
                                                panel):
    """B4 through the grid scan gives x bit for bit as through the
    single-cluster scan, and as the layout the shape takes, and repeats
    its bits."""
    from cpkrylov_tpu_torch.precond import cuda_tri
    from cpkrylov_tpu_torch.precond.trisolve import build_reduced_scan_tri

    T = _banded_lower(n, reach, seed=reach)
    tf = build_reduced_scan_tri(T, dtype, cuda, panel=panel)
    b = torch.as_tensor(np.random.default_rng(n).standard_normal(n)).to(
        device=cuda, dtype=dtype)
    x = cuda_tri.band_tri_solve(tf, b)
    x2 = cuda_tri.band_tri_solve(tf, b)
    xc = cuda_tri.band_tri_solve_on("cluster", tf, b)
    xg = cuda_tri.band_tri_solve_on("grid", tf, b)
    torch.cuda.synchronize()
    assert torch.equal(x, xc)
    assert torch.equal(x, x2)
    assert torch.equal(x, xg)


# (n, reach, panel, resident blocks the solve sees, layout): the card's
# own at AUG2D-L's shape, the Schur path's p 8, r 2 and a panel of many
# more rows than its reach; AUG2D-L's shape on a card of 16 blocks
@pytest.mark.parametrize("n,reach,panel,blocks,path", [
    (20_000, 631, 632, None, "grid"), (3000, 3, 8, None, "grid"),
    (5000, 7, 512, None, "cluster"), (20_000, 631, 632, 16, "cluster")])
def test_scan_path_counters_count_each_layout(cuda, monkeypatch, n, reach,
                                              panel, blocks, path):
    """A B4 solve adds one to the counter of the layout its shape takes,
    and none to the other; ``affine_scan`` counts it either way."""
    from cpkrylov_tpu_torch.precond import cuda_tri
    from cpkrylov_tpu_torch.precond.trisolve import build_reduced_scan_tri
    from cpkrylov_tpu_torch.utils import profiling

    T = _banded_lower(n, reach, seed=3)
    tf = build_reduced_scan_tri(T, torch.float64, cuda, panel=panel)
    b64 = np.random.default_rng(n).standard_normal(n)
    b = torch.as_tensor(b64).to(device=cuda)
    if blocks is not None:
        monkeypatch.setattr(cuda_tri, "resident_blocks", lambda _: blocks)
    before = profiling.path_counts()
    scans = _launches("affine_scan")
    x = cuda_tri.band_tri_solve(tf, b)
    after = profiling.path_counts()
    grid = after["scan_grid_launches"] - before["scan_grid_launches"]
    cluster = (after["scan_cluster_launches"]
               - before["scan_cluster_launches"])
    assert (grid, cluster) == ((1, 0) if path == "grid" else (0, 1))
    assert _launches("affine_scan") == scans + 1
    x_ref = spla.spsolve_triangular(T, b64, lower=True)
    assert _rel2(x, x_ref) <= BAND_TOL[torch.float64]


@functools.lru_cache(maxsize=1)
def _csr_cases():
    """B5's operands: small MM systems; CVXQP3-L's A, K_P and B (its B'
    through rmatvec: rows of 0-8 entries); and the row split's edge cases:
    a row of 5,000 entries beside short and empty rows (its tail past the
    tile read from device memory), fewer rows than a block, entries that
    fill their tiles exactly with empty rows after them, and a matrix with
    no entries."""
    from cpkrylov_tpu_torch.precond.cp import assemble_kp
    from cpkrylov_tpu_torch.utils.mm import aug_kkt, cvxqp_kkt

    q = cvxqp_kkt("cvxqp3", 2000)
    a = aug_kkt("2d", 40)
    ql = cvxqp_kkt("cvxqp3", "l")
    long_row = sp.random(200, 6000, density=4e-4, random_state=5,
                         format="lil")
    long_row[37, 500:5500] = np.random.default_rng(4).standard_normal(5000)
    full_tiles = sp.lil_matrix((40, 30))     # 2 tiles of 256, 8 empty rows
    full_tiles[:32, :16] = np.random.default_rng(5).standard_normal((32, 16))
    return {"cvxqp3_A": q.A, "cvxqp3_B": q.B,
            "aug2d_K_P": assemble_kp(a.G, a.B, a.C), "aug2d_B": a.B,
            "cvxqp3_l_A": ql.A, "cvxqp3_l_K_P": assemble_kp(ql.G, ql.B,
                                                            ql.C),
            "cvxqp3_l_B": ql.B, "long_row": long_row.tocsr(),
            "few_rows": sp.random(5, 40, density=0.3, random_state=6,
                                  format="csr"),
            "full_tiles": full_tiles.tocsr(),
            "no_entries": sp.csr_matrix((70, 30))}


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
        before = _launches("csr_spmv")
        y = cuda_spmv.csr_spmv(c, x)
        z = cuda_spmv.csr_rmatvec(c, v)
        assert _launches("csr_spmv") == before + 2
        yp = cuda_spmv.csr_matvec_plain(c, x)
        zp = cuda_spmv.csr_matvec_plain(c.t, v)
        torch.cuda.synchronize()
        assert torch.equal(y, yp) and torch.equal(z, zp), name
        assert torch.equal(cuda_spmv.csr_spmv(c, x), y), name   # repeats
        xr = x.double().cpu().numpy()
        tol = 1e-6 if dtype == torch.float32 else 1e-14
        if name == "long_row":  # a sum of k products: within ~k eps
            tol = max(tol, 5000 * torch.finfo(dtype).eps)
        if mat.nnz:
            assert _rel2(y, mat @ xr) <= tol, name
        else:
            assert not torch.any(y) and not torch.any(z), name


def test_csr_kernel_refuses_a_row_split_it_was_not_packed_with(cuda):
    """B5 takes the row split ``csr_from_scipy`` packs: a tile that is not
    a multiple of its block, or too few tiles, is refused at launch (the
    wrapper raises; nothing falls back to the plain version)."""
    import dataclasses

    from cpkrylov_tpu_torch.ops.cuda_spmv import csr_spmv
    from cpkrylov_tpu_torch.ops.formats import csr_from_scipy

    mat = sp.random(3000, 3000, density=0.01, random_state=3, format="csr")
    c = csr_from_scipy(mat, torch.float64, cuda, transpose=False)
    x = torch.ones(3000, dtype=torch.float64, device=cuda)
    for bad in (dataclasses.replace(c, tile=300),
                dataclasses.replace(c, tiles=c.tiles[:-1])):
        with pytest.raises(RuntimeError, match="csr_spmv: CUDA error"):
            csr_spmv(bad, x)


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


# (n, m, c): c = 1 and c = n // m, a ragged last block of any power-of-two
# size, an empty tail (n = c m), and the main path's shape
RIFFLE_CASES = [(20, 5, 4), (20, 5, 1), (37, 16, 2), (16389 * 4, 16389, 4),
                (65_541, 16_389, 3), (1_000_000, 250_000, 1)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,m,c", RIFFLE_CASES)
def test_interleave_kernels_match_plain_bitwise(cuda, dtype, n, m, c):
    from cpkrylov_tpu_torch.precond import cuda_interleave as ci

    z = torch.as_tensor(np.random.default_rng(n + c).standard_normal(
        n + m)).to(device=cuda, dtype=dtype)
    before = (_launches("interleave"), _launches("uninterleave"))
    w = ci.interleave(z, n, m, c)
    back = ci.uninterleave(w, n, m, c)
    assert (_launches("interleave"), _launches("uninterleave")) == (
        before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    assert torch.equal(w, ci.interleave_plain(z, n, m, c))
    assert torch.equal(back, ci.uninterleave_plain(w, n, m, c))
    assert torch.equal(back, z)


def test_interleave_wrappers_raise_on_bad_operands(cuda):
    from cpkrylov_tpu_torch.precond.cuda_interleave import (interleave,
                                                            uninterleave)

    z = torch.ones(25, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        interleave(z.half(), 20, 5, 4)
    with pytest.raises(ValueError):
        interleave(z[:24], 20, 5, 4)
    with pytest.raises(ValueError):
        uninterleave(torch.ones(50, dtype=torch.float64, device=cuda)[::2],
                     20, 5, 4)
    with pytest.raises(ValueError):
        interleave(z, 20, 5, 5)
    with pytest.raises(ValueError, match=r"2\*\*31"):       # 32-bit indices
        interleave(z, 2**31 - 5, 5, 4)


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
    else:
        assert counts["block_tri"] >= 2 * out.niters
    # CPMINRES stops on the preconditioned residual: both packages end at
    # 0.1115 and 1.2872 times atol + rtol |b| on the CPU
    # (tests/test_torch_mm.py); the card may sum its dot products in
    # another order, so 5 % more
    x = out.x.cpu().numpy()
    contract = 1e-6 + 1e-6 * np.linalg.norm(s.b)
    limit = 0.12 if system == "aug2d_40" else 1.35
    assert np.linalg.norm(s.b - s.K @ x) <= limit * contract


# ---------------------------------------------------------------------------
# Blocked substitution (B9) and the df64 triangle product (B10)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _cvxqp3_2000_triangles():
    """(L + I, J U J) of the host LDL^T of ``cvxqp_kkt("cvxqp3", 2000)``:
    14 panels of 256 rows, ELL widths 229 and 118, solutions up to ~6e8
    for a unit right-hand side."""
    from cpkrylov_tpu_torch.precond.cp import factorize_kp
    from cpkrylov_tpu_torch.utils.mm import cvxqp_kkt

    s = cvxqp_kkt("cvxqp3", 2000)
    hf = factorize_kp(s.G, s.B, s.C)
    N = hf.n + hf.m
    L1 = (hf.fac.L + sp.identity(N, format="csc")).tocsr()
    rev = np.arange(N - 1, -1, -1)
    return {"L": L1, "U": L1.T.tocsr()[rev][:, rev].tocsr()}


@pytest.mark.parametrize("dtype", DTYPES)
def test_block_tri_kernel_matches_plain_and_scipy(cuda, dtype):
    """B9 sums in its own fixed order: to BAND_TOL of its plain version and
    of scipy (the CPU plain version measures 3.8e-14 / 2.4e-6 against
    scipy here), and bit for bit against a second call."""
    from cpkrylov_tpu_torch.precond import cuda_block_tri
    from cpkrylov_tpu_torch.precond.cuda_block_tri import \
        block_tri_solve_plain
    from cpkrylov_tpu_torch.precond.trisolve import build_block_tri

    rng = np.random.default_rng(21)
    for label, T in _cvxqp3_2000_triangles().items():
        tf = build_block_tri(T, dtype, cuda)
        b64 = rng.standard_normal(T.shape[0])
        b = torch.as_tensor(b64).to(device=cuda, dtype=dtype)
        before = _launches("block_tri")
        x = cuda_block_tri.block_tri(tf, b)
        x2 = cuda_block_tri.block_tri(tf, b)
        assert _launches("block_tri") == before + 2
        xp = block_tri_solve_plain(tf, b)
        torch.cuda.synchronize()
        assert x.dtype == dtype and torch.equal(x, x2), label
        assert _rel2(x, xp) <= BAND_TOL[dtype], label
        ref = spla.spsolve_triangular(
            T, b.double().cpu().numpy(), lower=True)
        assert _rel2(x, ref) <= BAND_TOL[dtype], label


def test_block_tri_kernel_small_panels_and_ragged_n(cuda):
    """Panels below a row a block (p = 4: blocks of the cluster without a
    row), p = 16 and n not a multiple of p, p = 1024 (two rows a warp)."""
    from cpkrylov_tpu_torch.precond import cuda_block_tri
    from cpkrylov_tpu_torch.precond.cuda_block_tri import \
        block_tri_solve_plain
    from cpkrylov_tpu_torch.precond.trisolve import build_block_tri

    rng = np.random.default_rng(22)
    for n, panel in ((50, 4), (997, 16), (3000, 1024)):
        low = sp.tril(sp.random(n, n, density=0.02, random_state=rng),
                      k=-1) * 0.3
        T = (low + sp.diags(rng.uniform(2.0, 4.0, n))).tocsr()
        tf = build_block_tri(T, torch.float64, cuda, panel=panel)
        b = torch.as_tensor(rng.standard_normal(n), device=cuda)
        x = cuda_block_tri.block_tri(tf, b)
        xp = block_tri_solve_plain(tf, b)
        torch.cuda.synchronize()
        assert _rel2(x, xp) <= BAND_TOL[torch.float64], (n, panel)


@functools.lru_cache(maxsize=1)
def _cvxqp1_m_triangles():
    """(L + I, J U J) of cvxqp1_m's host LDL^T, as scipy CSR."""
    from cpkrylov_tpu_torch.precond.cp import factorize_kp
    from cpkrylov_tpu_torch.utils.fixtures import load_fixture

    f = load_fixture("cvxqp1_m")
    hf = factorize_kp(f.G, f.B, f.C)
    N = hf.n + hf.m
    L1 = (hf.fac.L + sp.identity(N, format="csc")).tocsr()
    rev = np.arange(N - 1, -1, -1)
    return {"L": L1, "U": L1.T.tocsr()[rev][:, rev].tocsr()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("panel", [2048, 1536])
def test_block_tri_kernel_takes_panels_above_1024(cuda, panel, dtype):
    """Any panel (ROADMAP C.1, repaired): cvxqp1_m's triangles (n = 5,500)
    at panels of 2048 (3 panels) and 1536 (4 panels), rhs in dynamic shared
    memory sized from the panel, to BLOCK_TOL of the plain version and of
    scipy, and bit for bit against a second call."""
    from cpkrylov_tpu_torch.precond import cuda_block_tri
    from cpkrylov_tpu_torch.precond.cuda_block_tri import \
        block_tri_solve_plain
    from cpkrylov_tpu_torch.precond.trisolve import build_block_tri

    rng = np.random.default_rng(24)
    for label, T in _cvxqp1_m_triangles().items():
        tf = build_block_tri(T, dtype, cuda, panel=panel)
        b64 = rng.standard_normal(T.shape[0]).astype(np.float32)
        b = torch.as_tensor(b64).to(device=cuda, dtype=dtype)
        before = _launches("block_tri")
        x = cuda_block_tri.block_tri(tf, b)
        x2 = cuda_block_tri.block_tri(tf, b)
        assert _launches("block_tri") == before + 2
        xp = block_tri_solve_plain(tf, b)
        torch.cuda.synchronize()
        assert torch.equal(x, x2), label
        ref = spla.spsolve_triangular(T, b64.astype(np.float64), lower=True)
        assert _rel2(x, xp) <= BLOCK_TOL[dtype], label
        assert _rel2(x, ref) <= BLOCK_TOL[dtype], label


def test_block_tri_kernel_keeps_rhs_off_chip_past_shared_memory(
        cuda, monkeypatch):
    """A panel whose rhs does not fit in a block's shared memory (here made
    so by the wrapper's test of it) keeps rhs in the scratch buffer: the
    same solve at panel 2048 on cvxqp1_m, to BLOCK_TOL of the plain
    version and scipy, bits repeating."""
    from cpkrylov_tpu_torch.precond import cuda_block_tri
    from cpkrylov_tpu_torch.precond.trisolve import build_block_tri

    monkeypatch.setattr(cuda_block_tri, "on_chip_fits", lambda *a: False)
    rng = np.random.default_rng(27)
    for label, T in _cvxqp1_m_triangles().items():
        tf = build_block_tri(T, torch.float64, cuda, panel=2048)
        b64 = rng.standard_normal(T.shape[0])
        b = torch.as_tensor(b64, device=cuda)
        x = cuda_block_tri.block_tri(tf, b)
        x2 = cuda_block_tri.block_tri(tf, b)
        xp = cuda_block_tri.block_tri_solve_plain(tf, b)
        torch.cuda.synchronize()
        assert torch.equal(x, x2), label
        ref = spla.spsolve_triangular(T, b64, lower=True)
        assert _rel2(x, xp) <= BLOCK_TOL[torch.float64], label
        assert _rel2(x, ref) <= BLOCK_TOL[torch.float64], label


# the card's panel inverses (a batched triangular solve) against LAPACK's
# trtri of the CPU pack: relative Frobenius norm of each panel's difference
# (the same solve on the CPU reads at most 9.3e-16 on these factors)
CARD_INV_TOL = 1e-13


@pytest.mark.parametrize("panel", [256, 1536, 2048])
@pytest.mark.parametrize("system", ["cvxqp3_2000", "cvxqp1_m"])
def test_card_pack_matches_the_cpu_pack(cuda, system, panel):
    """The blocked factor placed on the card: the ELL arrays bit for bit
    against the CPU pack (f64 and f32), the panel inverses to
    CARD_INV_TOL, and B9 on it to BLOCK_TOL of the plain solve of the CPU
    pack; each pack counts one ``block_card_packs``."""
    from cpkrylov_tpu_torch.precond import cuda_block_tri
    from cpkrylov_tpu_torch.precond.cuda_block_tri import \
        block_tri_solve_plain
    from cpkrylov_tpu_torch.precond.trisolve import build_block_tri
    from cpkrylov_tpu_torch.utils.profiling import path_counts

    tris = (_cvxqp3_2000_triangles() if system == "cvxqp3_2000"
            else _cvxqp1_m_triangles())
    rng = np.random.default_rng(29)
    for label, T in tris.items():
        for dtype in DTYPES:
            before = path_counts()["block_card_packs"]
            card = build_block_tri(T, dtype, cuda, panel=panel)
            assert path_counts()["block_card_packs"] == before + 1
            host = build_block_tri(T, dtype, "cpu", panel=panel)
            for name in ("off_data", "off_cols", "off_counts"):
                got, want = getattr(card, name), getattr(host, name)
                assert got.device.type == "cuda" and got.is_contiguous()
                assert torch.equal(got.cpu(), want), (label, name, dtype)
            assert card.inv_diag.dtype == dtype
            assert (card.n, card.panel) == (host.n, host.panel)
        # the last pair is f64
        diff = torch.linalg.norm(card.inv_diag.cpu() - host.inv_diag,
                                 dim=(1, 2))
        assert torch.all(diff <= CARD_INV_TOL * torch.linalg.norm(
            host.inv_diag, dim=(1, 2))), label
        b64 = rng.standard_normal(T.shape[0])
        x = cuda_block_tri.block_tri(card, torch.as_tensor(b64, device=cuda))
        xp = block_tri_solve_plain(host, torch.as_tensor(b64))
        assert _rel2(x, xp) <= BLOCK_TOL[torch.float64], label


def test_card_pack_raises_on_a_zero_pivot(cuda):
    """A stored zero on the diagonal of panel 2 (p 16): the card pack names
    the panel, as the CPU pack does, and counts no card pack."""
    from cpkrylov_tpu_torch.precond.trisolve import build_block_tri
    from cpkrylov_tpu_torch.utils.profiling import path_counts

    rng = np.random.default_rng(31)
    low = sp.tril(sp.random(97, 97, density=0.05, random_state=rng), k=-1)
    T = (low + sp.diags(rng.uniform(2.0, 4.0, 97))).tocsr()
    lo, hi = T.indptr[33], T.indptr[34]
    T.data[lo + np.flatnonzero(T.indices[lo:hi] == 33)] = 0.0
    before = path_counts()["block_card_packs"]
    for device in (cuda, "cpu"):
        with pytest.raises(ZeroDivisionError,
                           match="singular diagonal panel 2"):
            build_block_tri(T, torch.float64, device, panel=16)
    assert path_counts()["block_card_packs"] == before


def test_factor_apply_packs_both_triangles_on_the_card(cuda):
    """``build_factor_apply`` on the card places both blocked triangles
    there: ``block_card_packs`` grows by two, as ``tri_block_builds``."""
    from cpkrylov_tpu_torch.precond.cp import (build_factor_apply,
                                               factorize_kp)
    from cpkrylov_tpu_torch.precond.trisolve import BlockTriFactor
    from cpkrylov_tpu_torch.utils.mm import cvxqp_kkt
    from cpkrylov_tpu_torch.utils.profiling import path_counts

    s = cvxqp_kkt("cvxqp3", 2000)
    hf = factorize_kp(s.G, s.B, s.C)
    before = path_counts()
    fa = build_factor_apply(hf.fac, hf.n + hf.m, 256, torch.float64, cuda)
    after = path_counts()
    assert isinstance(fa.tf1, BlockTriFactor)
    assert isinstance(fa.tf2, BlockTriFactor)
    for key in ("block_card_packs", "tri_block_builds"):
        assert after[key] == before[key] + 2, key


def test_df_tri_kernel_walk_keeps_special_x0_bits(cuda):
    """B10 walks a row's stored slots and one padding slot: with x[0], the
    column of every padding slot, at -0, 1e35, inf, -inf and NaN, hi and lo
    still equal the plain K-slot loop's bits (NaNs by their bits)."""
    from cpkrylov_tpu_torch.precond import cuda_df_tri
    from cpkrylov_tpu_torch.precond.df_factor import _pack_df_tri

    for T in _cvxqp1_m_triangles().values():
        t = _pack_df_tri(T, cuda)
        v = np.random.default_rng(26).standard_normal(t.n) * 10.0
        for x0 in (-0.0, 1e35, np.inf, -np.inf, np.nan):
            xh = torch.as_tensor(v.astype(np.float32), device=cuda)
            xl = torch.as_tensor((v - v.astype(np.float32)).astype(
                np.float32), device=cuda)
            xh[0] = x0
            xl[0] = x0 if x0 == 0 else 0.0
            yh, yl = cuda_df_tri.df_tri_matvec(t, (xh, xl))
            ph, pl = cuda_df_tri.df_tri_matvec_plain(t, (xh, xl))
            torch.cuda.synchronize()
            assert torch.equal(yh.view(torch.int32), ph.view(torch.int32))
            assert torch.equal(yl.view(torch.int32), pl.view(torch.int32))


def test_df_tri_kernel_equals_plain_bitwise(cuda):
    """B10 on both df64 triangles of cvxqp1_m's f32 factor: every step of
    the chain rounded explicitly, so hi and lo equal the plain version's
    bit for bit, and a second call's."""
    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.precond import cuda_df_tri
    from cpkrylov_tpu_torch.precond.cuda_df_tri import df_tri_matvec_plain
    from cpkrylov_tpu_torch.precond.df_factor import DFFactorApply
    from cpkrylov_tpu_torch.utils.fixtures import load_fixture

    fix = load_fixture("cvxqp1_m")
    M32 = cpt.make_preconditioner(
        fix.G, fix.B, fix.C, dtype=torch.float32, device=cuda,
        options=cpt.PrecondOptions(residual_update=True, nitref=1,
                                   force_itref=True))
    assert isinstance(M32.factor, DFFactorApply)
    rng = np.random.default_rng(23)
    for t in (M32.factor.t1, M32.factor.t2):
        v = rng.standard_normal(t.n) * 10.0
        xh = torch.as_tensor(v.astype(np.float32), device=cuda)
        xl = torch.as_tensor((v - v.astype(np.float32)).astype(np.float32),
                             device=cuda)
        before = _launches("df_tri_matvec")
        yh, yl = cuda_df_tri.df_tri_matvec(t, (xh, xl))
        yh2, yl2 = cuda_df_tri.df_tri_matvec(t, (xh, xl))
        assert _launches("df_tri_matvec") == before + 2
        ph, pl = df_tri_matvec_plain(t, (xh, xl))
        torch.cuda.synchronize()
        assert torch.equal(yh, ph) and torch.equal(yl, pl)
        assert torch.equal(yh, yh2) and torch.equal(yl, yl2)


def test_card_solves_launch_one_kernel_per_solve_and_product(cuda,
                                                             monkeypatch):
    """On the card the panel loop and the slot loop never run: every
    blocked triangular solve is one B9 launch and every df64 triangle
    product one B10 launch (the f64 and the mixed f32 solve of
    cvxqp1_m)."""
    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.precond import (cuda_block_tri, cuda_df_tri,
                                            df_factor)
    from cpkrylov_tpu_torch.utils.fixtures import load_fixture
    from cpkrylov_tpu_torch.utils.profiling import (launch_counts,
                                                    reset_launches)

    calls = {"tri": 0, "df": 0}
    solve, product = cuda_block_tri.block_tri, df_factor.DFTriMat.matvec_df

    def count_solve(tf, b):
        calls["tri"] += 1
        return solve(tf, b)

    def count_product(self, x):
        calls["df"] += 1
        return product(self, x)

    def refuse(*args):
        raise AssertionError("a plain loop ran on card tensors")

    monkeypatch.setattr(cuda_block_tri, "block_tri", count_solve)
    monkeypatch.setattr(df_factor.DFTriMat, "matvec_df", count_product)
    monkeypatch.setattr(cuda_block_tri, "block_tri_solve_plain", refuse)
    monkeypatch.setattr(cuda_df_tri, "df_tri_matvec_plain", refuse)
    fix = load_fixture("cvxqp1_m")
    popts = cpt.PrecondOptions(residual_update=True, nitref=1,
                               force_itref=True)
    for dtype in (torch.float64, torch.float32):
        M = cpt.make_preconditioner(fix.G, fix.B, fix.C, options=popts,
                                    dtype=dtype, device=cuda)
        reset_launches()
        calls.update(tri=0, df=0)
        if dtype == torch.float64:
            out = cpt.solve("cpminres", fix.b, fix.A, fix.B, fix.C, fix.G,
                            M=M, dtype=dtype, precond_opts=popts,
                            opts=cpt.SolverOptions(itmax=500))
        else:
            out = cpt.solve_mixed(
                "cpminres", fix.b, fix.A, fix.B, fix.C, fix.G, M=M,
                opts=cpt.SolverOptions(atol=1e-8, rtol=1e-8, itmax=500),
                precond_opts=popts)
        counts = launch_counts()
        assert out.solved
        assert counts["block_tri"] == calls["tri"] >= 2 * out.niters
        if dtype == torch.float32:
            assert counts["df_tri_matvec"] == calls["df"] >= 2 * out.niters
        else:
            assert counts["df_tri_matvec"] == calls["df"] == 0


def test_block_and_df_wrappers_raise_on_bad_operands(cuda):
    from cpkrylov_tpu_torch.precond.cuda_block_tri import block_tri
    from cpkrylov_tpu_torch.precond.cuda_df_tri import df_tri_matvec
    from cpkrylov_tpu_torch.precond.df_factor import _pack_df_tri
    from cpkrylov_tpu_torch.precond.trisolve import build_block_tri

    T = (sp.tril(sp.random(300, 300, density=0.05, random_state=1), k=-1)
         + sp.identity(300)).tocsr()
    tf = build_block_tri(T, torch.float64, cuda, panel=32)
    with pytest.raises(TypeError):                 # factor f64, rhs f32
        block_tri(tf, torch.ones(300, dtype=torch.float32, device=cuda))
    with pytest.raises(ValueError):                # rhs on another device
        block_tri(build_block_tri(T, torch.float64, "cpu", panel=32),
                  torch.ones(300, dtype=torch.float64, device=cuda))
    t = _pack_df_tri(T, cuda)
    x = torch.ones(300, device=cuda)
    with pytest.raises(TypeError):
        df_tri_matvec(t, (x.double(), x.double()))
    with pytest.raises(ValueError):
        df_tri_matvec(t, (x, x[::1].cpu()))


# ---------------------------------------------------------------------------
# The distributed solve (cpkrylov_tpu_torch.parallel) on the card
# ---------------------------------------------------------------------------

def _nccl_collectives(comm):
    """All three collectives of ``Comm`` on CUDA tensors (one NCCL rank)."""
    x = torch.arange(6, dtype=torch.float64, device=comm.device)
    total = comm.allreduce_sum(x)
    full = comm.all_gather_vec(x, 5)
    left, right = comm.neighbor_exchange(x[:2], x[-2:])
    return {"devices": {t.device.type for t in (total, full, left, right)},
            "total": total.cpu().tolist(), "full": full.cpu().tolist(),
            "edges": (left.cpu().tolist(), right.cpu().tolist()),
            "calls": dict(comm.calls)}


def test_comm_collectives_on_one_nccl_rank(cuda):
    from cpkrylov_tpu_torch.parallel.dryrun import run_ranks

    out = run_ranks(_nccl_collectives, 1, backend="nccl",
                    device="cuda:0")[0]
    assert out["devices"] == {"cuda"}
    assert out["total"] == list(range(6))
    assert out["full"] == list(range(5))
    assert out["edges"] == ([0.0, 0.0], [0.0, 0.0])   # no neighbours
    assert out["calls"]["allreduce"] == 1 and out["calls"]["all_gather"] == 1


def test_dist_dryrun_on_two_gloo_ranks_sharing_the_card(cuda):
    """dist_cpminres and dist_solve (CPMINRES, CPGMRES, and the Schur
    factor on the slices of a plan with s > 0) as two gloo ranks on one
    card: each solved, within +-1 of the serial card count and within 1e-6
    of its x, and the sharded Schur solve's A_dS products in B5 (the
    ranks check all of it)."""
    from cpkrylov_tpu_torch.parallel.dryrun import run_dryrun

    counts = run_dryrun(2, device="cuda:0")
    assert set(counts) == {"dist_cpminres", "dist_solve_cpminres",
                           "dist_solve_cpgmres", "dist_solve_schur_sharded"}
    for dist_k, serial_k in counts.values():
        assert abs(dist_k - serial_k) <= 1


# ---------------------------------------------------------------------------
# The JAX package's other operand containers and spmv_format="csr" on the
# main system
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_ell_and_bsr_products_repeat_their_bits(cuda, dtype):
    """ELL and BSR products are plain PyTorch (the JAX package computes
    them in XLA): on the card each sums a row in stored order by one
    multiply-add a slot, no atomics, so a second call gives the same bits,
    and so does B5 on the matrix's CSR; they agree with scipy's f64
    product."""
    from cpkrylov_tpu_torch.ops import cuda_spmv, spmv
    from cpkrylov_tpu_torch.ops.formats import (bsr_from_scipy,
                                                csr_from_scipy,
                                                ell_from_scipy)

    rng = np.random.default_rng(17)
    A = sp.random(10_000, 9_000, density=0.002, random_state=rng,
                  format="lil")
    A[7, :2000] = rng.standard_normal(2000)      # one long row
    A[8, :] = 0                                  # an empty row
    A = A.tocsr()
    # a sum of k products: within ~k eps (the CSR test's long-row rule)
    tol = 5000 * torch.finfo(dtype).eps
    for mat in (ell_from_scipy(A, dtype, cuda, lane_pad=8),
                bsr_from_scipy(A, 8, dtype, cuda)):
        x = torch.as_tensor(rng.standard_normal(mat.shape[1])).to(
            device=cuda, dtype=dtype)
        X = torch.as_tensor(rng.standard_normal((mat.shape[1], 3))).to(
            device=cuda, dtype=dtype)
        y, Y = spmv.matvec(mat, x), spmv.matmat(mat, X)
        assert torch.equal(spmv.matvec(mat, x), y)
        assert torch.equal(spmv.matmat(mat, X), Y)
        c = csr_from_scipy(A, dtype, cuda, transpose=False)
        assert torch.equal(y[:A.shape[0]],
                           cuda_spmv.csr_spmv(c, x[:A.shape[1]].contiguous()))
        xr = x.double().cpu().numpy()[:A.shape[1]]
        Xr = X.double().cpu().numpy()[:A.shape[1]]
        assert _rel2(y[:A.shape[0]], A @ xr) <= tol
        assert _rel2(Y[:A.shape[0]], A @ Xr) <= tol


@pytest.mark.parametrize("dtype", DTYPES)
def test_csr_kernel_equals_plain_on_the_main_system(cuda, dtype):
    """Under ``spmv_format="csr"`` the main system's A (1M rows, ~7M
    entries) and K_P (1.25M rows) go through B5: bit for bit its plain
    version, and a second call."""
    from cpkrylov_tpu_torch.ops import cuda_spmv
    from cpkrylov_tpu_torch.ops.formats import csr_from_scipy
    from cpkrylov_tpu_torch.precond.cp import assemble_kp
    from cpkrylov_tpu_torch.utils import fixtures

    s = fixtures.banded_saddle_system(1_000_000, 250_000, bandwidth=3,
                                      with_oracle=False)
    rng = np.random.default_rng(19)
    for mat in (s.A, assemble_kp(s.G, s.B, s.C)):
        c = csr_from_scipy(mat, dtype, cuda, transpose=False)
        x = torch.as_tensor(rng.standard_normal(mat.shape[1])).to(
            device=cuda, dtype=dtype)
        y = cuda_spmv.csr_spmv(c, x)
        assert torch.equal(y, cuda_spmv.csr_matvec_plain(c, x))
        assert torch.equal(cuda_spmv.csr_spmv(c, x), y)
        del c, x, y
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# DIA placement on the card (ops/dia.py::place_dia)
# ---------------------------------------------------------------------------

_WORD = {torch.float32: torch.int32, torch.float64: torch.int64}


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    return torch.equal(a.cpu().view(_WORD[a.dtype]),
                       b.cpu().view(_WORD[b.dtype]))


def test_the_main_system_packs_on_card_as_on_cpu_and_host(cuda):
    """A (1M rows, ~7M entries), B, B' and K_P of the main system, placed
    on the card: bit for bit the placement of CPU tensors and the host
    pack it replaced (tests/_host_dia.py), in f64, f32 and df64."""
    from _host_dia import host_df_dia, host_dia

    from cpkrylov_tpu_torch.ops import df64
    from cpkrylov_tpu_torch.ops.dia import pack_dia
    from cpkrylov_tpu_torch.precond.cp import assemble_kp
    from cpkrylov_tpu_torch.utils import fixtures

    s = fixtures.banded_saddle_system(1_000_000, 250_000, bandwidth=3,
                                      with_oracle=False)
    for mat in (s.A, s.B, assemble_kp(s.G, s.B, s.C)):
        data, offsets, shape, nnz = host_dia(mat)
        for dtype in DTYPES:
            card = pack_dia(mat, dtype, cuda)
            cpu = pack_dia(mat, dtype, "cpu")
            assert card.offsets == cpu.offsets == offsets
            assert card.shape == shape and card.nnz == nnz
            assert card.offsets_t.tolist() == list(offsets)
            assert _same_bits(card.data, cpu.data)
            host = torch.as_tensor(data).to(dtype)
            assert _same_bits(card.data, host)
        del card, cpu, host
    card = df64.pack_df_saddle(s.A, s.B, s.C, device=cuda)
    cpu = df64.pack_df_saddle(s.A, s.B, s.C, device="cpu")
    for blk, mat in (("a", s.A), ("b", s.B), ("bt", s.B.T.tocsr())):
        hi, lo, offsets, shape = host_df_dia(mat)
        c, p = getattr(card, blk), getattr(cpu, blk)
        assert c.offsets == p.offsets == offsets and c.shape == shape
        for part, want in ((c.hi, torch.as_tensor(hi)),
                           (c.lo, torch.as_tensor(lo))):
            assert _same_bits(part, want)
        assert _same_bits(c.hi, p.hi) and _same_bits(c.lo, p.lo)


def test_the_main_solves_are_unchanged_by_the_card_pack(cuda, monkeypatch):
    """The benchmark's f64 and mixed solves of the main system give the
    same x, bit for bit, and the same iterations with the operands packed
    on the card as with the host packs they replaced."""
    from _host_dia import host_df_saddle, host_dia

    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch import driver
    from cpkrylov_tpu_torch.ops import df64
    from cpkrylov_tpu_torch.utils import fixtures
    from cpkrylov_tpu_torch.utils.convert import dia_from_numpy

    def host_pack_dia(mat, dtype, device, max_fill_ratio=4.5):
        ref = host_dia(mat, max_fill_ratio)
        if ref is None:
            return None
        data, offsets, shape, nnz = ref
        return dia_from_numpy(data, offsets, shape, dtype=dtype,
                              device=device, nnz=nnz)

    s = fixtures.banded_saddle_system(1_000_000, 250_000, bandwidth=3,
                                      with_oracle=False)
    popts = cpt.PrecondOptions(nitref=1, itref_tol=1e-8, force_itref=True,
                               residual_update=True, apply_df64="auto")
    for dtype, refine, stagwin in ((torch.float64, False, 0),
                                   (torch.float32, True, 25)):
        opts = cpt.SolverOptions(atol=0.0, rtol=1e-6, itmax=200,
                                 stagwin=stagwin)
        M = cpt.make_preconditioner(s.G, s.B, s.C, options=popts, panel=256,
                                    dtype=dtype, device=cuda)

        def call():
            return cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, opts=opts,
                             precond_opts=popts, panel=256, dtype=dtype,
                             device=cuda, M=M, refine=refine)

        new = call()
        with monkeypatch.context() as mp:
            mp.setattr(driver, "pack_dia", host_pack_dia)
            mp.setattr(df64, "pack_df_saddle",
                       lambda A, B, C, device=None:
                       host_df_saddle(A, B, C, device))
            old = call()
        assert new.solved and old.solved, dtype
        assert new.niters == old.niters, dtype
        assert _same_bits(new.x, old.x), dtype
        del M, new, old
        torch.cuda.empty_cache()


def test_card_packs_and_gate_refusals_are_counted(cuda):
    """A banded solve packs A, B and K_P on the card; each block of
    cvxqp1_m fails the gate on the card and keeps CSR."""
    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.utils import fixtures
    from cpkrylov_tpu_torch.utils.profiling import path_counts, reset_launches

    popts = cpt.PrecondOptions(residual_update=True, nitref=1,
                               force_itref=True)
    s = fixtures.banded_saddle_system(20_000, 5_000)
    reset_launches()
    out = cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G, device=cuda,
                    dtype=torch.float64, precond_opts=popts,
                    opts=cpt.SolverOptions(atol=0.0, rtol=1e-6, itmax=200))
    c = path_counts()
    assert out.solved
    assert (c["dia_card_packs"], c["dia_gate_refusals"]) == (3, 0)
    f = fixtures.load_fixture("cvxqp1_m")
    reset_launches()
    out = cpt.solve("cpminres", f.b, f.A, f.B, f.C, f.G, device=cuda,
                    dtype=torch.float64, precond_opts=popts,
                    opts=cpt.SolverOptions(atol=1e-6, rtol=1e-6, itmax=500))
    c = path_counts()
    assert out.solved
    assert (c["dia_card_packs"], c["dia_gate_refusals"]) == (0, 3)
