"""The port's constraint preconditioner (``precond/cp.py``) against the JAX
package's: three successive ``CPPrecond.apply`` calls with the opLDL2
options of the examples, outputs and GHN state compared at f64 <= 1e-12
relative (max-norm, relative to the largest reference entry).

Both sides use the identical host factor: the JAX package factorizes K_P and
the port receives that factor through ``utils/convert.py``.

* banded(8192, 2048) with the interleave ordering (JAX side:
  ``spmv_format="dia"``).  The port solves the bidiagonal factor by its scan
  with D^-1 folded in; the JAX package on the CPU uses its reduced panel
  scan.  Rounding differs, the algebra does not.
* cvxqp1_m with RCM: both sides use blocked substitution (the JAX factor is
  built with ``scan_ok=False``) and CSR for K_P.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpkrylov_tpu as cpk
from cpkrylov_tpu.ops.formats import csr_from_scipy as jax_csr
from cpkrylov_tpu.precond import ldl_host as jax_ldl
from cpkrylov_tpu.precond.cp import CPPrecond as JaxCPPrecond
from cpkrylov_tpu.precond.cp import build_factor_apply as jax_build_factor
from cpkrylov_tpu_torch import PrecondOptions, make_preconditioner
from cpkrylov_tpu_torch.ops.dia import DIA
from cpkrylov_tpu_torch.ops.formats import CSR
from cpkrylov_tpu_torch.precond.cp import assemble_kp, choose_ordering
from cpkrylov_tpu_torch.precond.cuda_bidiag import BidiagTriFactor
from cpkrylov_tpu_torch.precond.permute import InterleavePermute
from cpkrylov_tpu_torch.precond.trisolve import BlockTriFactor
from cpkrylov_tpu_torch.utils import fixtures
from cpkrylov_tpu_torch.utils.convert import precond_from_host

torch.set_num_threads(1)

POPTS = dict(residual_update=True, nitref=1, force_itref=True)
TOL = 1e-12


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300)


def _three_applies(M_jax, M_port, N, seed):
    rng = np.random.default_rng(seed)
    sj = M_jax.init_state(jnp.float64)
    st = M_port.init_state(torch.float64)
    for _ in range(3):
        z = rng.standard_normal(N)
        sj, yj, _ = M_jax.apply(sj, jnp.asarray(z))
        st, yt, _ = M_port.apply(st, torch.as_tensor(z))
        assert yt.dtype == torch.float64
        assert _rel(yt.numpy(), yj) <= TOL
        assert _rel(st.aty.numpy(), sj.aty) <= TOL
        assert _rel(st.cy.numpy(), sj.cy) <= TOL


def _factor(s, ksp, ordering):
    signs = np.concatenate([np.ones(s.n), -np.ones(s.m)])
    return jax_ldl.factorize(ksp, method="auto", ordering=ordering,
                             pivot_signs=signs, reg_value=1e-10)


def test_apply_banded_interleave_matches_jax():
    s = fixtures.banded_saddle_system(8192, 2048)
    ksp = assemble_kp(s.G, s.B, s.C)
    perm, base = choose_ordering(ksp, s.n, s.m)
    M_jax = cpk.make_preconditioner(s.G, s.B, s.C,
                                    options=cpk.PrecondOptions(**POPTS),
                                    spmv_format="dia")
    fac = _factor(s, ksp, perm)
    M_port = precond_from_host(fac, ksp, s.n, s.m, PrecondOptions(**POPTS),
                               dtype=torch.float64, device="cpu")
    f = M_port.factor
    assert isinstance(f.pin, InterleavePermute) and f.pin.c == 1
    assert isinstance(f.tf1, BidiagTriFactor) and not f.tf1.reverse
    assert isinstance(f.tf2, BidiagTriFactor) and f.tf2.reverse
    assert f.dinv_folded and isinstance(M_port.kp, DIA)
    assert M_port.factor_nitref == M_jax.factor_nitref
    _three_applies(M_jax, M_port, s.n + s.m, seed=0)

    # the port's own entry point picks the same ordering and layout
    M_own = make_preconditioner(s.G, s.B, s.C,
                                options=PrecondOptions(**POPTS))
    np.testing.assert_array_equal(
        M_own.factor.tf1.a.numpy(), M_port.factor.tf1.a.numpy())
    np.testing.assert_array_equal(
        M_own.factor.tf2.invd.numpy(), M_port.factor.tf2.invd.numpy())


def test_apply_cvxqp1_rcm_matches_jax():
    if not fixtures.fixture_available("cvxqp1_m"):
        pytest.skip("cvxqp1_m fixture unavailable")
    s = fixtures.load_fixture("cvxqp1_m")
    N = s.n + s.m
    ksp = assemble_kp(s.G, s.B, s.C)
    assert choose_ordering(ksp, s.n, s.m)[1] is None      # RCM here
    fac = _factor(s, ksp, "rcm")
    M_port = precond_from_host(fac, ksp, s.n, s.m, PrecondOptions(**POPTS),
                               dtype=torch.float64, device="cpu")
    assert isinstance(M_port.factor.tf1, BlockTriFactor)
    assert isinstance(M_port.kp, CSR)
    M_ref = cpk.make_preconditioner(s.G, s.B, s.C,
                                    options=cpk.PrecondOptions(**POPTS))
    assert M_port.factor_nitref == M_ref.factor_nitref
    M_jax = JaxCPPrecond(
        factor=jax_build_factor(fac, N, 256, np.float64, scan_ok=False),
        kp=jax_csr(ksp.tocsr(), dtype=np.float64), n=s.n, m=s.m,
        options=cpk.PrecondOptions(**POPTS),
        factor_nitref=M_port.factor_nitref)
    _three_applies(M_jax, M_port, N, seed=1)


def test_apply_without_ghn_and_conditional_refinement():
    """Options off the main path: no GHN update, refinement by trigger."""
    s = fixtures.random_sqd_system(120, 40, seed=5)
    N = s.n + s.m
    for opts in (dict(nitref=2, itref_tol=1e-8),
                 dict(nitref=0, residual_update=True)):
        ksp = assemble_kp(s.G, s.B, s.C)
        fac = _factor(s, ksp, "rcm")
        M_port = precond_from_host(fac, ksp, s.n, s.m,
                                   PrecondOptions(**opts))
        M_jax = JaxCPPrecond(
            factor=jax_build_factor(fac, N, 256, np.float64, scan_ok=False),
            kp=jax_csr(ksp.tocsr(), dtype=np.float64), n=s.n, m=s.m,
            options=cpk.PrecondOptions(**opts),
            factor_nitref=M_port.factor_nitref)
        _three_applies(M_jax, M_port, N, seed=2)
