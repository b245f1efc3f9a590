"""The port's five further Krylov kernels (CPCG, CP-CG-Lanczos, CPSYMMLQ,
CPGMRES(l), CPDQGMRES) against the JAX package on the CPU in f64, on the
same systems made from a numpy seed.

* Parity: the same istatus, iterations within +-1 and x within 1e-8
  relative (2-norm) on ``random_sqd_system(70, 25, seed=21)``, on the
  nonsymmetric ``(60, 20, seed=33)`` for the Arnoldi pair, and on
  ``banded_saddle_system(8192, 2048)`` (the main path's interleave /
  bidiagonal / DIA layout, the JAX side with ``spmv_format="dia"``);
  CPSYMMLQ's CG, LQ and QR histories within 1e-8 relative (2-norm) over
  their common prefix.
* The behaviours of ``tests/test_solvers.py``: the exact preconditioner
  (with CPSYMMLQ's reference defect at k = 1), ``itmax``, the ``btol`` stop,
  an unattainable tolerance reported honestly, ``reorth`` on and off, the
  restart and memory sweeps, and cross-solver agreement.
* ``solve_mixed`` with CPCG and CPDQGMRES to 1e-8 in both packages: the
  true-residual contract and the solutions, not the f32 inner counts
  (ROADMAP C).
"""
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import cpkrylov_tpu as cpk
import cpkrylov_tpu_torch as cpt
from cpkrylov_tpu.mixed import solve_mixed as jax_solve_mixed
from cpkrylov_tpu_torch.solvers import SOLVERS
from cpkrylov_tpu_torch.solvers.common import (STATUS_BACKWARD,
                                               STATUS_BREAKDOWN, STATUS_ITMAX,
                                               STATUS_SOLVED)
from cpkrylov_tpu_torch.utils import fixtures

torch.set_num_threads(1)

NEW = ["cpcg", "cpcglanczos", "cpsymmlq", "cpgmres", "cpdqgmres"]
SYM = ["cpcg", "cpcglanczos", "cpminres", "cpsymmlq"]
ALL = SYM + ["cpgmres", "cpdqgmres"]
POPTS = dict(residual_update=True, nitref=1, force_itref=True)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _relerr(out, s):
    x = out.x.numpy() if torch.is_tensor(out.x) else np.asarray(out.x)
    return _rel(x, spla.spsolve(s.K.tocsc(), s.b))


def _both(name, s, sopts, popts=None, **kw):
    """The same solve in the port (f64, CPU) and in the JAX package."""
    own = cpt.solve(name, s.b, s.A, s.B, s.C, s.G,
                    opts=cpt.SolverOptions(**sopts),
                    precond_opts=cpt.PrecondOptions(**(popts or {})),
                    dtype=torch.float64, device="cpu", **kw)
    ref = cpk.solve(name, s.b, s.A, s.B, s.C, s.G,
                    opts=cpk.SolverOptions(**sopts),
                    precond_opts=cpk.PrecondOptions(**(popts or {})), **kw)
    return own, ref


def _assert_parity(own, ref):
    assert own.istatus == ref.istatus, (own.result.status, ref.result.status)
    assert own.solved == bool(ref.solved)
    assert abs(own.niters - ref.niters) <= 1, (own.niters, ref.niters)
    assert own.x.dtype == torch.float64
    assert _rel(own.x.numpy(), np.asarray(ref.x)) <= 1e-8


def _common_prefix_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    k = min(int(np.sum(np.isfinite(a))), int(np.sum(np.isfinite(b))))
    assert k > 0 and np.all(np.isfinite(a[:k])) and np.all(np.isfinite(b[:k]))
    return _rel(a[:k], b[:k])


def test_registry_names_all_six():
    assert sorted(SOLVERS) == sorted(ALL)
    for name in ALL:
        assert getattr(cpt, name) is SOLVERS[name]


# --- parity with the JAX package -------------------------------------------

@pytest.mark.parametrize("name", NEW)
def test_sqd_matches_jax(name):
    s = fixtures.random_sqd_system(70, 25, seed=21, delta=1e-2)
    own, ref = _both(name, s, dict(atol=1e-6, rtol=1e-6, itmax=300),
                     panel=32)
    assert own.solved, own.result.status
    _assert_parity(own, ref)
    assert _relerr(own, s) < 1e-4
    if name == "cpsymmlq":
        for h in ("cg", "lq", "qr"):
            key = f"{h}_resid_history"
            assert _common_prefix_rel(getattr(own.result, key),
                                      getattr(ref.result, key)) <= 1e-8, h


@pytest.mark.parametrize("name", ["cpgmres", "cpdqgmres"])
def test_nonsymmetric_matches_jax(name):
    s = fixtures.random_sqd_system(60, 20, seed=33, nonsymmetric=True,
                                   delta=1e-2)
    own, ref = _both(name, s, dict(atol=1e-6, rtol=1e-6, itmax=300),
                     panel=32)
    assert own.solved, own.result.status
    _assert_parity(own, ref)
    assert _relerr(own, s) < 1e-4


@pytest.mark.parametrize("name", NEW)
def test_banded_matches_jax_dia(name):
    s = fixtures.banded_saddle_system(8192, 2048)
    sopts = dict(atol=0.0, rtol=1e-6, itmax=200)
    own = cpt.solve(name, s.b, s.A, s.B, s.C, s.G,
                    opts=cpt.SolverOptions(**sopts),
                    precond_opts=cpt.PrecondOptions(**POPTS),
                    dtype=torch.float64, device="cpu")
    ref = cpk.solve(name, s.b, s.A, s.B, s.C, s.G,
                    opts=cpk.SolverOptions(**sopts),
                    precond_opts=cpk.PrecondOptions(**POPTS),
                    spmv_format="dia")
    assert own.solved, own.result.status
    _assert_parity(own, ref)
    r = s.K @ own.x.numpy() - s.b
    assert np.linalg.norm(r) <= 1e-6 * np.linalg.norm(s.b)
    if name == "cpsymmlq":
        for h in ("cg", "lq", "qr"):
            key = f"{h}_resid_history"
            assert _common_prefix_rel(getattr(own.result, key),
                                      getattr(ref.result, key)) <= 1e-8, h


# --- tests/test_solvers.py behaviours ---------------------------------------

@pytest.mark.parametrize("name", ALL)
def test_exact_preconditioner_fast_convergence(name):
    s = fixtures.random_sqd_system(50, 20, seed=4, g_exact=True)
    own, ref = _both(name, s, {}, panel=32)
    assert own.istatus == ref.istatus and own.niters == ref.niters
    if name == "cpsymmlq":
        # the reference's end-game degenerates when the solve ends at k = 1;
        # the manifold veto reports it instead of a false convergence
        assert own.solved or own.istatus == STATUS_BREAKDOWN
        return
    assert own.solved and own.niters <= 3


@pytest.mark.parametrize("name", ALL)
def test_itmax_respected(name):
    s = fixtures.random_sqd_system(60, 25, seed=77)
    own, ref = _both(name, s, dict(atol=1e-14, rtol=1e-14, itmax=3),
                     panel=32)
    if not own.solved:
        assert own.istatus == STATUS_ITMAX
    if name == "cpgmres":
        # GMRES rounds itmax up to a full restart cycle (cpgmres.m:148) and
        # so runs past the attainable floor (1e-14 is below it): where its
        # breakdown falls there depends on last-bit rounding of the
        # preconditioner (the port 21 iterations, the JAX package 45, both
        # with x at 8e-16 of spsolve's)
        assert own.niters <= 50
        return
    assert own.niters == ref.niters == 3
    assert own.istatus == ref.istatus


def test_cglanczos_btol_stops_early():
    s = fixtures.random_sqd_system(70, 25, seed=91)
    tight = dict(atol=1e-12, rtol=1e-12, itmax=300)
    base, _ = _both("cpcglanczos", s, tight, panel=32)
    loose, ref = _both("cpcglanczos", s, dict(tight, btol=1e-4), panel=32)
    assert loose.solved and loose.istatus == STATUS_BACKWARD
    assert loose.niters <= base.niters
    _assert_parity(loose, ref)


@pytest.mark.parametrize("name", ALL)
def test_unattainable_tolerance_is_honest(name):
    s = fixtures.random_sqd_system(70, 25, seed=21, delta=1e-2)
    own = cpt.solve(name, s.b, s.A, s.B, s.C, s.G, panel=32,
                    opts=cpt.SolverOptions(atol=1e-13, rtol=1e-13, itmax=300),
                    dtype=torch.float64, device="cpu")
    rel = _relerr(own, s)
    if own.solved:
        assert rel < 1e-6, (name, rel)
    else:
        assert own.istatus != STATUS_SOLVED
        # the minimization-property methods also hand back a usable iterate
        if name not in ("cpcg", "cpgmres"):
            assert rel < 1e-3, (name, rel, own.result.status)


@pytest.mark.parametrize("reorth", [False, True])
@pytest.mark.parametrize("restart", [5, 60])
def test_gmres_reorth_and_restart_match_jax(reorth, restart):
    s = fixtures.random_sqd_system(60, 20, seed=8, nonsymmetric=True)
    own, ref = _both("cpgmres", s, dict(restart=restart, itmax=400,
                                        reorth=reorth), panel=32)
    assert own.solved, own.result.status
    _assert_parity(own, ref)


@pytest.mark.parametrize("mem", [2, 60])
def test_dqgmres_memory_sweep_matches_jax(mem):
    s = fixtures.random_sqd_system(60, 20, seed=8, nonsymmetric=True)
    own, ref = _both("cpdqgmres", s, dict(mem=mem, itmax=400), panel=32)
    assert own.solved, own.result.status
    _assert_parity(own, ref)


def test_gmres_restart_sweep_fewer_iterations_with_more_memory():
    s = fixtures.random_sqd_system(60, 20, seed=8, nonsymmetric=True)
    iters = {}
    for restart in (5, 60):
        out = cpt.solve("cpgmres", s.b, s.A, s.B, s.C, s.G, panel=32,
                        opts=cpt.SolverOptions(restart=restart, itmax=400),
                        device="cpu")
        assert out.solved, restart
        iters[restart] = out.niters
    assert iters[60] <= iters[5]


def test_symmlq_histories():
    s = fixtures.random_sqd_system(50, 20, seed=12)
    out = cpt.solve("cpsymmlq", s.b, s.A, s.B, s.C, s.G, panel=32,
                    opts=cpt.SolverOptions(itmax=200), device="cpu")
    res, k = out.result, out.niters
    lq, qr, cg = (np.asarray(h) for h in (res.lq_resid_history,
                                          res.qr_resid_history,
                                          res.cg_resid_history))
    # k loop entries and one wrap-up entry for lq and qr; cg has beta1 at 0
    assert np.isfinite(lq[: k + 1]).all() and np.isnan(lq[k + 1:]).all()
    assert np.isfinite(qr[: k + 1]).all()
    assert np.isfinite(cg[: k + 1]).all()
    # the QR (MINRES) residuals do not increase
    assert (np.diff(qr[: k + 1]) <= 1e-12).all()
    np.testing.assert_array_equal(out.resid_history, cg[: k + 1])
    # the other kernels return no such histories
    other = cpt.solve("cpcg", s.b, s.A, s.B, s.C, s.G, panel=32,
                      device="cpu").result
    assert other.lq_resid_history is None and other.cg_resid_history is None


def test_solver_consistency():
    """Every kernel reaches the same solution of one system."""
    s = fixtures.random_sqd_system(80, 30, seed=55, delta=1e-2)
    xs = {}
    for name in ALL:
        out = cpt.solve(name, s.b, s.A, s.B, s.C, s.G, panel=32,
                        opts=cpt.SolverOptions(atol=1e-6, rtol=1e-6,
                                               itmax=300), device="cpu")
        assert out.solved, name
        xs[name] = out.x.numpy()
    for name, x in xs.items():
        np.testing.assert_allclose(x, xs["cpminres"], rtol=1e-4, atol=1e-6,
                                   err_msg=name)


# --- the mixed refinement through the registry ------------------------------

@pytest.mark.parametrize("name", ["cpcg", "cpdqgmres"])
def test_solve_mixed_reaches_1e8_like_jax(name):
    s = fixtures.banded_saddle_system(8192, 2048)
    sopts = dict(atol=0.0, rtol=1e-8, itmax=200)
    own = cpt.solve_mixed(name, s.b, s.A, s.B, s.C, s.G,
                          opts=cpt.SolverOptions(**sopts),
                          precond_opts=cpt.PrecondOptions(**POPTS),
                          device="cpu")
    ref = jax_solve_mixed(name, s.b, s.A, s.B, s.C, s.G,
                          opts=cpk.SolverOptions(**sopts),
                          precond_opts=cpk.PrecondOptions(**POPTS))
    bnorm = np.linalg.norm(s.b)
    for out in (own, ref):
        x = np.asarray(out.x)
        assert out.solved and x.dtype == np.float64
        assert np.linalg.norm(s.b - s.K @ x) <= 1e-8 * bnorm
    assert own.inner_outputs and own.niters == sum(own.inner_niters)
    assert _rel(own.x, np.asarray(ref.x)) < 1e-7
