"""The golden baselines of ``tests/test_golden.py`` and
``tests/test_history_golden.py`` for the port's five further kernels, on the
CPU in f64 with the example programs' settings (cpk_exprog1.m:79-92 /
cpk_exprog2.m:77-92).

* cvxqp1_m (symmetric 5500^2): CPCG 55, CP-CG-Lanczos 54, CPSYMMLQ 54 and
  CPDQGMRES 54 at mem 2 and mem 50, each +-2, rel-err < 5e-6 against scipy
  ``spsolve``;
* cvxqp2_s (nonsymmetric 725^2): CPGMRES(100) 127 +-3 with the first
  residual 1.19e2 within 5 %, CPGMRES(20) 380 +-15, CPDQGMRES(100) 120 +-3,
  rel-err < 5e-4;
* the CPGMRES(100) and CPGMRES(20) residual histories overlap
  ``data/golden_histories.npz`` (an independent scipy oracle): lengths
  within +-2 and every aligned residual within a factor 2;
* each golden solve also against the JAX package on the same inputs: the
  same istatus, iterations within +-1 and x within 1e-8 relative (2-norm).
  CPDQGMRES(100) on cvxqp2_s is held instead to 4 times the distance the
  JAX package's own solution moves when b is perturbed by 1e-15 relative:
  its truncated recurrence amplifies rounding to ~4e-8 there, so any
  other order of rounding lands that far away.

One preconditioner per fixture serves its solves, as ``M=`` lets a caller
do; the JAX package builds the same one for each solve.
"""
import pathlib

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import cpkrylov_tpu as cpk
import cpkrylov_tpu_torch as cpt
from cpkrylov_tpu_torch.utils import fixtures

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
EX_POPTS = dict(residual_update=True, nitref=1, force_itref=True,
                itref_tol=1e-8)


def _fixture(name):
    if not fixtures.fixture_available(name):
        pytest.skip(f"{name} fixture unavailable")
    s = fixtures.load_fixture(name)
    popts = cpt.PrecondOptions(**EX_POPTS)
    M = cpt.make_preconditioner(s.G, s.B, s.C, options=popts,
                                dtype=torch.float64, device="cpu")
    return s, M, spla.spsolve(s.K.tocsc(), s.b)


@pytest.fixture(scope="module")
def cvxqp1_m():
    return _fixture("cvxqp1_m")


@pytest.fixture(scope="module")
def cvxqp2_s():
    return _fixture("cvxqp2_s")


def _run(fix, name, **extra):
    s, M, x_ref = fix
    out = cpt.solve(name, s.b, s.A, s.B, s.C, s.G, M=M, device="cpu",
                    dtype=torch.float64,
                    precond_opts=cpt.PrecondOptions(**EX_POPTS),
                    opts=cpt.SolverOptions(atol=1e-6, rtol=1e-6, itmax=500,
                                           **extra))
    x = out.x.numpy()
    assert x.shape == (s.n + s.m,) and np.all(np.isfinite(x))
    return out, np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)


def _jax(fix, name, b=None, **extra):
    s = fix[0]
    return cpk.solve(name, s.b if b is None else b, s.A, s.B, s.C, s.G,
                     precond_opts=cpk.PrecondOptions(**EX_POPTS),
                     opts=cpk.SolverOptions(atol=1e-6, rtol=1e-6, itmax=500,
                                            **extra))


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _assert_jax_parity(out, ref, xtol=1e-8):
    assert out.istatus == int(ref.istatus), (out.istatus, ref.istatus)
    assert abs(out.niters - int(ref.niters)) <= 1, (out.niters, ref.niters)
    assert _rel(out.x.numpy(), np.asarray(ref.x)) <= xtol


@pytest.mark.parametrize("name,extra,iters", [
    ("cpcg", {}, 55),
    ("cpcglanczos", {}, 54),
    ("cpsymmlq", {}, 54),
    ("cpdqgmres", {"mem": 2}, 54),
    ("cpdqgmres", {"mem": 50}, 54),
])
def test_cvxqp1_golden(cvxqp1_m, name, extra, iters):
    out, rel = _run(cvxqp1_m, name, **extra)
    assert out.solved, out.result.status
    assert abs(out.niters - iters) <= 2, (name, extra, out.niters)
    assert rel < 5e-6, (name, rel)
    _assert_jax_parity(out, _jax(cvxqp1_m, name, **extra))


@pytest.mark.parametrize("name,extra,iters,slack", [
    ("cpgmres", {"restart": 100}, 127, 3),
    ("cpgmres", {"restart": 20}, 380, 15),
    ("cpdqgmres", {"mem": 100}, 120, 3),
])
def test_cvxqp2_golden(cvxqp2_s, name, extra, iters, slack):
    out, rel = _run(cvxqp2_s, name, **extra)
    assert out.solved, out.result.status
    assert abs(out.niters - iters) <= slack, (name, extra, out.niters)
    assert rel < 5e-4, rel
    assert abs(out.resid_history[0] - 1.19e2) / 1.19e2 < 0.05
    ref = _jax(cvxqp2_s, name, **extra)
    xtol = 1e-8
    if name == "cpdqgmres":
        b = cvxqp2_s[0].b
        b = b * (1.0 + 1e-15 * np.random.default_rng(0).standard_normal(
            b.shape))
        moved = _rel(np.asarray(_jax(cvxqp2_s, name, b=b, **extra).x),
                     np.asarray(ref.x))
        assert moved <= 1e-6, moved
        xtol = 4 * moved
    _assert_jax_parity(out, ref, xtol)


@pytest.mark.parametrize("restart", [100, 20])
def test_cvxqp2_cpgmres_history_overlaps_golden(cvxqp2_s, restart):
    out, _ = _run(cvxqp2_s, "cpgmres", restart=restart)
    assert out.solved
    golden = np.load(ROOT / "data" / "golden_histories.npz")
    ours = out.resid_history
    ref = golden[f"cvxqp2_cpgmres{restart}"]
    assert len(ours) == out.niters + 1
    assert abs(len(ours) - len(ref)) <= 2, (len(ours), len(ref))
    k = min(len(ours), len(ref))
    worst = np.max(np.abs(np.log10(ours[:k] / ref[:k])))
    assert worst <= np.log10(2.0), worst
