"""The Maros–Mészáros path through the port, against the JAX package.

* generators: ``cpkrylov_tpu_torch.utils.mm`` builds exactly the JAX
  package's systems (A, B, C, G, b, K) for every family;
* factor form: on ``aug_kkt("2d", 40)`` and ``aug_kkt("2d", 100)`` (the
  catalogue's AUG2D-M) in f64 both packages take the reduced-state scan
  form (p = 80, r = 79 and p = 200, r = 199) for both triangles, on
  ``cvxqp_kkt("cvxqp3", 2000)`` blocked substitution (reach 553: n = 3500
  is below 16 p for every panel that covers it), with K_P in CSR;
* the slice: ``solve("cpminres", ...)`` in f64 with ``device="cpu"`` at the
  JAX Maros–Mészáros sweep's settings (atol = rtol = 1e-6, itmax 1000,
  default ``PrecondOptions()``): iteration counts within +-2 of the JAX
  package's (both measure 5, 5 and 43), solutions within 1e-10 relative
  (measured 5e-17 and 1.9e-12: the same factor, summed in other orders),
  and the same true residual and error against scipy's ``spsolve`` in both
  packages.  CPMINRES stops on its preconditioned residual, so the true
  residual ``|b - K x|`` is not bounded by atol + rtol |b|: both packages
  end at 0.1115, 0.2262 and 1.2872 times it (printed under ``-s``);
* the df64-applied factor at f32 on ``aug_kkt("2d", 40)`` (the B4 form
  under ``precond/df_factor.py``) and a mixed solve through it;
* the default device is the card: without CUDA the entry points raise.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import cpkrylov_tpu as cpk
import cpkrylov_tpu_torch as cpt
from cpkrylov_tpu.precond.trisolve import BlockTriFactor as JaxBlock
from cpkrylov_tpu.precond.trisolve import ReducedScanTriFactor as JaxReduced
from cpkrylov_tpu.utils import mm as jmm
from cpkrylov_tpu_torch.ops.formats import CSR
from cpkrylov_tpu_torch.precond.df_factor import DFFactorApply
from cpkrylov_tpu_torch.precond.trisolve import (BlockTriFactor,
                                                 ReducedScanTriFactor)
from cpkrylov_tpu_torch.utils import mm

torch.set_num_threads(1)

SWEEP = dict(atol=1e-6, rtol=1e-6, itmax=1000)
SYSTEMS = {"aug2d_40": (("2d", 40), "aug"), "aug2d_100": (("2d", 100), "aug"),
           "cvxqp3_2000": (("cvxqp3", 2000), "cvxqp")}
# the reduced-scan panel and reach of both packages' factors
REDUCED_FORM = {"aug2d_40": (80, 79), "aug2d_100": (200, 199)}
# |b - K x| / (atol + rtol |b|) at the end of both packages' solves, as
# measured, rounded up in the third digit
TRUE_RESID = {"aug2d_40": 0.112, "aug2d_100": 0.227, "cvxqp3_2000": 1.288}
# the JAX sweep's record of its CPMINRES's error against spsolve
# (benchmarks/MM_SWEEP_M.json, aug2d_100 = AUG2D-M)
SWEEP_M_ORACLE = {"aug2d_100": 4.085640902689036e-09}


def _make(pkg, name):
    args, kind = SYSTEMS[name]
    return (pkg.aug_kkt if kind == "aug" else pkg.cvxqp_kkt)(*args)


def _same_sparse(a, b):
    return a.shape == b.shape and (sp.csr_matrix(a) != sp.csr_matrix(b)).nnz \
        == 0


@pytest.mark.parametrize("make", [
    lambda p: p.cvxqp_kkt("cvxqp1", 300),
    lambda p: p.cvxqp_kkt("cvxqp2", "s", mu=1e-2, seed=3),
    lambda p: p.cvxqp_kkt("cvxqp3", 2000, g_mode="identity"),
    lambda p: p.aug_kkt("2d", 40),
    lambda p: p.aug_kkt("3d", "s", g_mode="diag"),
])
def test_generators_match_jax_exactly(make):
    ours, ref = make(mm), make(jmm)
    assert ours.name == ref.name
    for block in ("A", "B", "C", "G", "K"):
        assert _same_sparse(getattr(ours, block), getattr(ref, block)), block
    np.testing.assert_array_equal(ours.b, ref.b)


def test_suite_and_problem_match_jax():
    assert [s.name for s in mm.mm_suite("s")] == \
        [s.name for s in jmm.mm_suite("s")]
    for a, b in zip(mm.cvxqp_problem("cvxqp3", 120),
                    jmm.cvxqp_problem("cvxqp3", 120)):
        if sp.issparse(a):
            assert _same_sparse(a, b)
        else:
            np.testing.assert_array_equal(a, b)
    assert _same_sparse(mm.grid_incidence((4, 5, 3)),
                        jmm.grid_incidence((4, 5, 3)))


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_factor_form_matches_jax(name):
    s = _make(mm, name)
    Mj = cpk.make_preconditioner(s.G, s.B, s.C, dtype=np.float64)
    Mp = cpt.make_preconditioner(s.G, s.B, s.C, dtype=torch.float64,
                                 device="cpu")
    for tj, tp in ((Mj.factor.tf1, Mp.factor.tf1),
                   (Mj.factor.tf2, Mp.factor.tf2)):
        if name in REDUCED_FORM:
            assert isinstance(tj, JaxReduced) and isinstance(
                tp, ReducedScanTriFactor)
            assert (tp.panel, tp.r) == (tj.panel, tj.r) == REDUCED_FORM[name]
            assert tp.nblocks == tj.nblocks
        else:
            assert isinstance(tj, JaxBlock) and isinstance(tp,
                                                           BlockTriFactor)
            assert tp.panel == tj.panel == 256
    assert isinstance(Mp.kp, CSR) and Mp.kp.t is None
    assert Mp.factor_nitref == Mj.factor_nitref


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_cpminres_matches_jax(name):
    sj, sp_ = _make(jmm, name), _make(mm, name)
    ref = cpk.solve("cpminres", sj.b, sj.A, sj.B, sj.C, sj.G,
                    opts=cpk.SolverOptions(**SWEEP))
    out = cpt.solve("cpminres", sp_.b, sp_.A, sp_.B, sp_.C, sp_.G,
                    opts=cpt.SolverOptions(**SWEEP), dtype=torch.float64,
                    device="cpu")
    assert out.solved and ref.solved
    assert abs(out.niters - ref.niters) <= 2, (out.niters, ref.niters)
    x_ref = np.asarray(ref.x)
    x = out.x.numpy()
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) <= 1e-10
    # the solver's own stopping test, on its recorded history
    h = out.resid_history
    assert h[-1] <= SWEEP["atol"] + SWEEP["rtol"] * h[0]
    # the true residual and the error against a direct solve: the same in
    # both packages (measured 2.4e-8 relative apart at most), and each
    # true residual at its measured multiple of atol + rtol |b|
    contract = SWEEP["atol"] + SWEEP["rtol"] * np.linalg.norm(sp_.b)
    x_direct = spla.spsolve(sp_.K.tocsc(), sp_.b)
    r, r_ref = (np.linalg.norm(sp_.b - sp_.K @ v) for v in (x, x_ref))
    e, e_ref = (np.linalg.norm(v - x_direct) / np.linalg.norm(x_direct)
                for v in (x, x_ref))
    print(f"{name}: iterations {out.niters} / {ref.niters} (port / JAX), "
          f"true residual / (atol + rtol |b|) {r / contract:.4f} / "
          f"{r_ref / contract:.4f}, error against spsolve {e:.4e} / "
          f"{e_ref:.4e}")
    assert abs(r - r_ref) <= 1e-6 * r_ref
    assert abs(e - e_ref) <= 1e-6 * e_ref
    assert r <= TRUE_RESID[name] * contract
    if name in SWEEP_M_ORACLE:
        assert abs(e_ref - SWEEP_M_ORACLE[name]) <= 1e-2 * e_ref


def test_df64_factor_with_band_triangles_f32():
    """At f32 the plain factor of aug2d_40 is unusable (probe > 1e-2), so
    the df64-applied factor wraps the f32 B4-form triangles.  Its probe
    measures 3.45e-2 here; the JAX package's, whose f32 reduced scan
    composes the (r x r) maps by an associative scan, measures 15.6 on the
    same input (ROADMAP C)."""
    s = mm.aug_kkt("2d", 40)
    M = cpt.make_preconditioner(s.G, s.B, s.C, dtype=torch.float32,
                                device="cpu")
    assert isinstance(M.factor, DFFactorApply)
    for tf in (M.factor.tf1, M.factor.tf2):
        assert isinstance(tf, ReducedScanTriFactor)
        assert tf.inv_diag.dtype == torch.float32 and (tf.panel, tf.r) == \
            (80, 79)
    assert M.probe_rel <= 0.1
    Mj = cpk.make_preconditioner(s.G, s.B, s.C, dtype=np.float32)
    assert Mj.probe_rel > 1.0
    z = np.random.default_rng(3).standard_normal(s.n + s.m)
    kp = sp.bmat([[s.G, s.B.T], [s.B, -s.C]]).tocsr()
    y = M.factor.solve(torch.as_tensor(z, dtype=torch.float32)).numpy()
    assert np.linalg.norm(kp @ y.astype(np.float64) - z) <= \
        0.1 * np.linalg.norm(z)
    out = cpt.solve_mixed("cpminres", s.b, s.A, s.B, s.C, s.G, M=M,
                          opts=cpt.SolverOptions(atol=0.0, rtol=1e-8,
                                                 itmax=300),
                          device="cpu")
    assert out.solved
    assert np.linalg.norm(s.b - s.K @ out.x) <= 1e-8 * np.linalg.norm(s.b)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    s = mm.aug_kkt("2d", 6)
    for call in (
            lambda: cpt.solve("cpminres", s.b, s.A, s.B, s.C, s.G),
            lambda: cpt.make_preconditioner(s.G, s.B, s.C),
            lambda: cpt.solve_mixed("cpminres", s.b, s.A, s.B, s.C, s.G),
            lambda: cpt.aslinearoperator(s.A)):
        with pytest.raises(RuntimeError, match="default device"):
            call()
    # a callable or a device tensor needs no device
    op = cpt.aslinearoperator(lambda v: v, shape=(3, 3))
    assert op.shape == (3, 3)
    t = cpt.aslinearoperator(torch.eye(3, dtype=torch.float64))
    assert t.mat.device.type == "cpu"
