"""The port's host LDL^T (its own copy of the native kernel, built by g++
into the port's build directory) against the JAX package's.

Both packages get the same K_P and the same explicit ordering; the factors
must be identical: ``perm``, ``L`` (pattern and values), ``d`` and ``e``.
"""
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cpkrylov_tpu.precond import ldl_host as jax_ldl
from cpkrylov_tpu.precond.cp import assemble_kp as jax_assemble_kp
from cpkrylov_tpu_torch import _build
from cpkrylov_tpu_torch.precond import ldl_host
from cpkrylov_tpu_torch.precond.cp import (assemble_kp, choose_ordering,
                                           make_preconditioner)
from cpkrylov_tpu_torch.utils import fixtures

torch.set_num_threads(1)


def _kp_and_ordering(name):
    if name == "cvxqp1_m":
        if not fixtures.fixture_available("cvxqp1_m"):
            pytest.skip("cvxqp1_m fixture unavailable")
        s = fixtures.load_fixture("cvxqp1_m")
        return s, "rcm"
    s = fixtures.banded_saddle_system(8192, 2048)
    ksp = assemble_kp(s.G, s.B, s.C)
    perm, base = choose_ordering(ksp, s.n, s.m)
    assert base is not None and base.c == 1        # the interleave ordering
    return s, perm


def _assert_same_factor(a, b):
    np.testing.assert_array_equal(np.asarray(a.perm), np.asarray(b.perm))
    La, Lb = sp.csc_matrix(a.L), sp.csc_matrix(b.L)
    np.testing.assert_array_equal(La.indptr, Lb.indptr)
    np.testing.assert_array_equal(La.indices, Lb.indices)
    np.testing.assert_array_equal(La.data, Lb.data)
    np.testing.assert_array_equal(a.d, b.d)
    assert (a.e is None) == (b.e is None)
    if a.e is not None:
        np.testing.assert_array_equal(a.e, b.e)
    assert a.nperturbed == b.nperturbed and a.n2x2 == b.n2x2


@pytest.mark.parametrize("name", ["cvxqp1_m", "banded"])
def test_ldl_factor_identical_to_jax(name):
    s, ordering = _kp_and_ordering(name)
    ksp = assemble_kp(s.G, s.B, s.C)
    assert abs(ksp - jax_assemble_kp(s.G, s.B, s.C)).nnz == 0
    signs = np.concatenate([np.ones(s.n), -np.ones(s.m)])
    kw = dict(method="ldl", ordering=ordering, pivot_signs=signs,
              reg_value=1e-10)
    ours = ldl_host.factorize(ksp, **kw)
    ref = jax_ldl.factorize(ksp, **kw)
    assert isinstance(ours, ldl_host.HostLDL)
    _assert_same_factor(ours, ref)
    z = np.random.default_rng(0).standard_normal(s.n + s.m)
    for dt in (np.float64, np.float32):
        np.testing.assert_array_equal(ldl_host.solve_host(ours, z, dtype=dt),
                                      jax_ldl.solve_host(ref, z, dtype=dt))


def test_lu_backend_and_natural_ordering():
    s = fixtures.random_sqd_system(60, 20, seed=3)
    ksp = assemble_kp(s.G, s.B, s.C)
    lu = ldl_host.factorize(ksp, method="lu")
    assert isinstance(lu, ldl_host.HostLU)
    z = np.random.default_rng(1).standard_normal(80)
    y = ldl_host.solve_host(lu, z)
    assert np.linalg.norm(ksp @ y - z) <= 1e-10 * np.linalg.norm(z)
    nat = ldl_host.factorize(ksp, method="ldl", ordering="natural")
    np.testing.assert_array_equal(nat.perm, np.arange(80))
    with pytest.raises(ValueError):
        ldl_host.factorize(ksp, method="ldl", ordering=np.arange(5))


def _code_lines(path):
    with open(path) as fh:
        return [ln for ln in fh.read().splitlines()
                if not ln.lstrip().startswith("//")]


def test_native_source_is_the_reference_code():
    """The port carries its own copy of the LDL^T kernel; apart from its
    comments it must stay the reference's code."""
    import cpkrylov_tpu
    import cpkrylov_tpu_torch

    name = os.path.join("native", "ldl_kernel.cpp")
    ref = os.path.join(os.path.dirname(cpkrylov_tpu.__file__), name)
    ours = os.path.join(os.path.dirname(cpkrylov_tpu_torch.__file__), name)
    assert _code_lines(ours) == _code_lines(ref)


def test_failed_compile_raises_build_error(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(_build.BuildError, match="building libfail.so"):
        _build._build("libfail.so", ["false"], [], [])
    assert list(tmp_path.iterdir()) == []          # no half-written library


@pytest.mark.parametrize("entry", ["factorize_auto", "factorize_ldl",
                                   "make_preconditioner"])
def test_native_build_failure_is_not_swallowed(entry, monkeypatch):
    """A failed build of the LDL^T library must raise, not fall back to
    splu (whose factors would take the plain blocked solves)."""
    def broken():
        raise _build.BuildError("g++ failed")

    monkeypatch.setattr(_build, "native_library", broken)
    s = fixtures.random_sqd_system(60, 20, seed=3)
    with pytest.raises(_build.BuildError):
        if entry == "make_preconditioner":
            make_preconditioner(s.G, s.B, s.C)
        else:
            ldl_host.factorize(assemble_kp(s.G, s.B, s.C),
                               method=entry.split("_")[1])


def test_auto_falls_back_to_lu_on_breakdown(monkeypatch):
    def breakdown(*args, **kwargs):
        raise ZeroDivisionError("LDL breakdown at pivot 0")

    monkeypatch.setattr(ldl_host, "ldl_factor", breakdown)
    s = fixtures.random_sqd_system(60, 20, seed=3)
    ksp = assemble_kp(s.G, s.B, s.C)
    assert isinstance(ldl_host.factorize(ksp), ldl_host.HostLU)
    with pytest.raises(ZeroDivisionError):
        ldl_host.factorize(ksp, method="ldl")
