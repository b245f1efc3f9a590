"""The port's df64 arithmetic (``ops/df64.py``, the plain version of kernel
B3) and its df64-applied factor (``precond/df_factor.py``) against the JAX
package on the same inputs, and the repairs that come with them.

Tolerances:

* error-free transforms: exact (bit for bit against f64 arithmetic, and
  equal to the JAX package's results);
* df64 DIA products: hi + lo within 1e-12 relative of scipy's f64 product
  (df64 carries ~2^-48), within 1e-13 of the JAX package's XLA chain and of
  its Pallas kernel run with ``interpret=True`` (same chain, same rounding);
* the df64 residual b - K x of an exact x: below 5e-13 relative, where a
  plain f32 evaluation floors at ~1e-7 (tests/test_df64.py).

Repairs held here: the f32 preconditioner swaps in the df64-applied factor
exactly when the JAX package does; the df64 factor around a right-to-left
upper scan (fault C1 of the JAX package, held against scipy); and an
in-place update of A between two mixed solves (fault C2).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cpkrylov_tpu as cpk
import cpkrylov_tpu_torch as cpt
from cpkrylov_tpu.ops import df64 as jdf
from cpkrylov_tpu.ops.pallas_dia import pallas_df_dia_matvec
from cpkrylov_tpu_torch.ops import df64
from cpkrylov_tpu_torch.ops.cuda_df_dia import df_dia_spmv
from cpkrylov_tpu_torch.precond.cp import (FactorApply, assemble_kp,
                                           build_factor_apply)
from cpkrylov_tpu_torch.precond.cuda_bidiag import BidiagTriFactor
from cpkrylov_tpu_torch.precond.df_factor import (DFFactorApply,
                                                  build_df_factor_apply)
from cpkrylov_tpu_torch.solvers import common, cpminres
from cpkrylov_tpu_torch.utils import fixtures
from cpkrylov_tpu_torch.utils.convert import df_saddle_from

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(a):
    return np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)


def test_two_sum_exact_and_equal_to_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(1000).astype(np.float32)
    b = (rng.standard_normal(1000) * 1e-6).astype(np.float32)
    s, e = df64.two_sum(_t(a), _t(b))
    exact = a.astype(np.float64) + b.astype(np.float64)
    np.testing.assert_array_equal(_np(s).astype(np.float64)
                                  + _np(e).astype(np.float64), exact)
    js, je = jdf.two_sum(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(_np(s), np.asarray(js))
    np.testing.assert_array_equal(_np(e), np.asarray(je))
    s1, e1 = df64.two_sum(torch.tensor(1.0), torch.tensor(1e-8))
    assert float(s1) + float(e1) == float(np.float32(1.0)) + float(
        np.float32(1e-8))


def test_two_prod_exact_and_equal_to_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(1000).astype(np.float32)
    b = rng.standard_normal(1000).astype(np.float32)
    p, e = df64.two_prod(_t(a), _t(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_array_equal(
        _np(p).astype(np.float64) + _np(e).astype(np.float64), exact)
    jp, je = jdf.two_prod(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(_np(p), np.asarray(jp))
    np.testing.assert_array_equal(_np(e), np.asarray(je))


def test_split_roundtrip_and_vector_ops_equal_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(1000) * 1e3
    hi, lo = df64.df_from_f64(x)
    jhi, jlo = jdf.df_from_f64(x)
    np.testing.assert_array_equal(hi, jhi)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_allclose(df64.df_to_f64(_t(hi), _t(lo)), x,
                               rtol=1e-14)
    yh, yl = df64.df_from_f64(rng.standard_normal(1000))
    d = rng.standard_normal(1000).astype(np.float32)
    alpha = np.float32(3.7)
    ours = {
        "add": df64.df_add((_t(hi), _t(lo)), (_t(yh), _t(yl))),
        "axpy": df64.df_axpy(torch.tensor(alpha), _t(d), (_t(hi), _t(lo))),
        "scale": df64.df_scale_f32((_t(hi), _t(lo)), torch.tensor(alpha)),
    }
    ref = {
        "add": jdf.df_add((jnp.asarray(hi), jnp.asarray(lo)),
                          (jnp.asarray(yh), jnp.asarray(yl))),
        "axpy": jdf.df_axpy(jnp.float32(alpha), jnp.asarray(d),
                            (jnp.asarray(hi), jnp.asarray(lo))),
        "scale": jdf.df_scale_f32((jnp.asarray(hi), jnp.asarray(lo)),
                                  jnp.float32(alpha)),
    }
    for k in ours:
        for got, want in zip(ours[k], ref[k]):
            np.testing.assert_array_equal(_np(got), np.asarray(want), k)


def _rect_block(nr, nc):
    """The rectangular B / B' pattern of tests/test_df64.py:104-113."""
    k = min(nr, nc)
    rows = np.concatenate([np.arange(k), np.arange(k - 1)])
    if nc >= nr:
        cols = np.concatenate([np.arange(k), np.arange(1, k)])
    else:
        cols = np.concatenate([np.arange(k), np.arange(k - 1)])
        rows = np.concatenate([np.arange(k), np.arange(1, k)])
    vals = np.concatenate([np.ones(k), 0.3 * np.ones(k - 1)])
    return sp.csr_matrix((vals, (rows, cols)), shape=(nr, nc))


def _df_case(name, rng):
    if name == "square5000":
        n = 5000
        return sp.diags([rng.standard_normal(n) for _ in range(5)],
                        [-2, -1, 0, 1, 2], shape=(n, n), format="csr")
    return _rect_block(*{"rect400x1600": (400, 1600),
                         "rect1600x400": (1600, 400)}[name])


@pytest.mark.parametrize("name", ["square5000", "rect400x1600",
                                  "rect1600x400"])
def test_df_dia_matvec_against_scipy_and_jax(name):
    rng = np.random.default_rng(2)
    mat = _df_case(name, rng)
    x = rng.standard_normal(mat.shape[1])
    xh, xl = df64.df_from_f64(x)
    d = df64.pack_df_dia(mat, device="cpu")
    jd = jdf.pack_df_dia(mat)
    assert d.offsets == jd.offsets and d.shape == jd.shape
    np.testing.assert_array_equal(d.hi.numpy(), np.asarray(jd.hi))
    np.testing.assert_array_equal(d.lo.numpy(), np.asarray(jd.lo))
    yh, yl = df64.df_dia_matvec(d, (_t(xh), _t(xl)))
    # the wrapper takes the plain version for CPU tensors
    wh, wl = df_dia_spmv(d, _t(xh), _t(xl))
    assert torch.equal(wh, yh) and torch.equal(wl, yl)
    y = df64.df_to_f64(yh, yl)
    exact = mat @ x
    scale = np.linalg.norm(exact)
    assert np.linalg.norm(y - exact) / scale <= 1e-12
    refs = {
        "xla": jdf.df_dia_matvec(jd, (jnp.asarray(xh), jnp.asarray(xl))),
        "pallas": pallas_df_dia_matvec(jd, jnp.asarray(xh), jnp.asarray(xl),
                                       chunk=256, interpret=True),
    }
    for what, (rh, rl) in refs.items():
        r = jdf.df_to_f64(np.asarray(rh), np.asarray(rl))
        assert np.linalg.norm(y - r) / scale <= 1e-13, what


def _gate_cases(rng):
    n = 3000
    banded = sp.diags([rng.standard_normal(n - abs(o)) for o in (-3, 0, 3)],
                      [-3, 0, 3], format="csr")
    scattered = sp.random(n, n, density=2e-3, random_state=rng,
                          format="csr") + sp.identity(n)
    wide = sp.diags([np.ones(n)] * 40, list(range(-20, 20)), shape=(n, n),
                    format="csr")
    holes = sp.diags([rng.standard_normal(n - 900), np.ones(n)], [-900, 0],
                     format="csr")
    return {"banded": banded, "scattered": scattered, "wide": wide,
            "holes": holes, "rect": _rect_block(500, 2000),
            "empty": sp.csr_matrix((40, 60))}


def test_pack_df_dia_gate_matches_jax():
    for name, mat in _gate_cases(np.random.default_rng(4)).items():
        ours = df64.pack_df_dia(mat, device="cpu")
        ref = jdf.pack_df_dia(mat)
        assert (ours is None) == (ref is None), name
        if ours is not None:
            assert ours.offsets == ref.offsets, name
            np.testing.assert_array_equal(ours.hi.numpy(), np.asarray(ref.hi))
    assert df64.pack_df_dia(_gate_cases(np.random.default_rng(4))[
        "scattered"], device="cpu") is None


def test_df_saddle_residual_cancellation():
    sysm = fixtures.banded_saddle_system(2000, 500, bandwidth=3,
                                         with_oracle=False)
    K = sp.bmat([[sysm.A, sysm.B.T], [sysm.B, -sysm.C]]).tocsr()
    x = np.random.default_rng(3).standard_normal(K.shape[0])
    b = K @ x          # the residual of x is exactly 0 in f64
    Kdf = df64.pack_df_saddle(sysm.A, sysm.B, sysm.C, device="cpu")
    assert Kdf is not None
    xh, xl = df64.df_from_f64(x)
    kx = Kdf.matvec((_t(xh), _t(xl)))
    bh, bl = df64.df_from_f64(b)
    rh, _ = df64.df_add((_t(bh), _t(bl)), df64.df_neg(kx))
    assert float(torch.linalg.vector_norm(rh)) / np.linalg.norm(b) < 5e-13
    # the JAX package's packed operator, carried across, gives the same
    # product as the port's own pack
    jK = jdf.pack_df_saddle(sysm.A, sysm.B, sysm.C)
    kx2 = df_saddle_from(jK, device="cpu").matvec((_t(xh), _t(xl)))
    for got, want in zip(kx2, kx):
        assert torch.equal(got, want)
    jkx = jK.matvec((jnp.asarray(xh), jnp.asarray(xl)))
    assert (np.linalg.norm(df64.df_to_f64(*kx) - jdf.df_to_f64(*jkx))
            <= 1e-13 * np.linalg.norm(b + 1.0))
    assert df64.pack_df_saddle(sysm.A, sysm.B,
                               sysm.C + sp.eye(500, k=1), device="cpu") is None


# ---------------------------------------------------------------------------
# Repair 1: the f32 preconditioner swaps in the df64-applied factor
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cvxqp1_sys():
    if not fixtures.fixture_available("cvxqp1_m"):
        pytest.skip("cvxqp1_m fixture unavailable")
    return fixtures.load_fixture("cvxqp1_m")


@pytest.mark.parametrize("apply_df64", ["auto", False])
def test_f32_precond_factor_choice_matches_jax(cvxqp1_sys, apply_df64):
    s = cvxqp1_sys
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        M = cpt.make_preconditioner(
            s.G, s.B, s.C, dtype=torch.float32,
            options=cpt.PrecondOptions(apply_df64=apply_df64), device="cpu")
    assert any("coarsely factorable" in str(w.message) for w in caught)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        Mj = cpk.make_preconditioner(
            s.G, s.B, s.C, dtype=np.float32,
            options=cpk.PrecondOptions(apply_df64=apply_df64))
    want = "DFFactorApply" if apply_df64 == "auto" else "FactorApply"
    assert type(Mj.factor).__name__ == want
    assert type(M.factor).__name__ == want
    assert M.factor_nitref == Mj.factor_nitref
    assert M.factor_exact == Mj.factor_exact
    assert 0.5 <= M.probe_rel / Mj.probe_rel <= 2.0, (M.probe_rel,
                                                      Mj.probe_rel)
    if apply_df64 == "auto":
        assert M.probe_rel < 5e-2        # the raw f32 probe is ~1.33
        y = M.factor.solve(torch.ones(s.n + s.m))
        assert y.dtype == torch.float32 and torch.isfinite(y).all()


def test_df_factor_from_jax_host_factor_matches_jax(cvxqp1_sys):
    """The JAX package's host LDL^T of K_P, carried across
    (``utils/convert.py``), gives a df64-applied factor whose solves agree
    with the JAX package's df64-applied factor of the same factorization
    (both on blocked substitution; their f32 panel products round
    differently, the df64 refinement removes that)."""
    from cpkrylov_tpu.precond import ldl_host as jax_ldl
    from cpkrylov_tpu.precond.cp import build_factor_apply as jax_bfa
    from cpkrylov_tpu.precond.df_factor import build_df_factor_apply as jbdf
    from cpkrylov_tpu_torch.utils.convert import df_factor_from_host

    s = cvxqp1_sys
    N = s.n + s.m
    ksp = assemble_kp(s.G, s.B, s.C)
    fac = jax_ldl.factorize(
        ksp, method="auto", ordering="rcm",
        pivot_signs=np.concatenate([np.ones(s.n), -np.ones(s.m)]),
        reg_value=1e-10)
    ours = df_factor_from_host(fac, s.n, s.m, device="cpu")
    ref = jbdf(jax_bfa(fac, N, 256, np.float32, scan_ok=False,
                       fold_dinv=False), fac, N, nref=1)
    z = np.random.default_rng(6).standard_normal(N).astype(np.float32)
    y = ours.solve(torch.as_tensor(z)).numpy()
    yj = np.asarray(ref.solve(jnp.asarray(z)))
    assert np.linalg.norm(y - yj) / np.linalg.norm(yj) <= 1e-9
    res = np.linalg.norm(ksp @ y.astype(np.float64) - z) / np.linalg.norm(z)
    assert res <= 5e-2                     # the probe's 2.5e-2 class


def _xla_dot(a, b):
    """The JAX package's f32 dot, for runs that share its reduction order."""
    if a.dtype != torch.float32:
        return torch.dot(a, b)
    return torch.tensor(float(jnp.dot(jnp.asarray(a.numpy()),
                                      jnp.asarray(b.numpy()))),
                        dtype=torch.float32)


def test_f32_cpminres_trajectory_matches_jax(cvxqp1_sys, monkeypatch):
    """The f32 solve of the probe table (rtol 1e-12, stagwin 25, default
    preconditioner options).  The f32 trajectory is set by the dot
    products' reduction order (XLA's and torch's f32 dots differ in the
    last bits, and the Lanczos recurrences amplify that, ROADMAP C): with
    the JAX package's dot the port follows the JAX package's trajectory."""
    s = cvxqp1_sys
    b32 = (s.b / np.linalg.norm(s.b)).astype(np.float32)
    sopts = dict(atol=0.0, rtol=1e-12, itmax=500, stagwin=25)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = cpk.solve("cpminres", b32, s.A, s.B, s.C, s.G,
                        opts=cpk.SolverOptions(**sopts), dtype=np.float32)
        own = cpt.solve("cpminres", b32, s.A, s.B, s.C, s.G,
                        opts=cpt.SolverOptions(**sopts), dtype=torch.float32,
                        device="cpu")
        monkeypatch.setattr(common, "vdot", _xla_dot)
        monkeypatch.setattr(cpminres, "vdot", _xla_dot)
        same = cpt.solve("cpminres", b32, s.A, s.B, s.C, s.G,
                         opts=cpt.SolverOptions(**sopts),
                         dtype=torch.float32, device="cpu")
    assert same.istatus == int(ref.istatus)
    assert abs(same.niters - int(ref.niters)) <= 3, (same.niters, ref.niters)
    # with its own dot the port stops just as honestly, within the window
    assert not own.solved and own.istatus in (common.STATUS_STAGNATED,
                                              common.STATUS_INDEFINITE)
    assert own.niters < 200


# ---------------------------------------------------------------------------
# Repair 2 (C1): the df64 factor around the right-to-left upper scan
# ---------------------------------------------------------------------------

def test_df_factor_with_reverse_upper_scan_against_scipy():
    s = fixtures.banded_saddle_system(8192, 2048)
    M = cpt.make_preconditioner(s.G, s.B, s.C, dtype=torch.float32,
                                options=cpt.PrecondOptions(apply_df64=True),
                                device="cpu")
    f = M.factor
    assert isinstance(f, DFFactorApply)
    assert isinstance(f.tf2, BidiagTriFactor) and f.tf2.reverse
    assert M.factor_nitref == 0 and M.factor_exact
    ksp = assemble_kp(s.G, s.B, s.C)
    z = np.random.default_rng(5).standard_normal(s.n + s.m)
    y = f.solve(torch.as_tensor(z, dtype=torch.float32)).numpy()
    rel = (np.linalg.norm(ksp @ y.astype(np.float64) - z)
           / np.linalg.norm(z))
    assert rel <= 1e-7, rel


def test_df_factor_needs_an_unfolded_factor():
    s = fixtures.banded_saddle_system(2048, 512)
    M = cpt.make_preconditioner(s.G, s.B, s.C, dtype=torch.float32,
                                options=cpt.PrecondOptions(apply_df64=False),
                                device="cpu")
    assert isinstance(M.factor, FactorApply) and M.factor.dinv_folded
    from cpkrylov_tpu_torch.precond import ldl_host
    from cpkrylov_tpu_torch.precond.cp import choose_ordering

    ksp = assemble_kp(s.G, s.B, s.C)
    perm, base = choose_ordering(ksp, s.n, s.m)
    fac = ldl_host.factorize(
        ksp, ordering=perm,
        pivot_signs=np.concatenate([np.ones(s.n), -np.ones(s.m)]),
        reg_value=1e-10)
    folded = build_factor_apply(fac, s.n + s.m, 256, torch.float32, "cpu",
                                base_order=base)
    with pytest.raises(ValueError, match="unfolded"):
        build_df_factor_apply(folded, fac, s.n + s.m)


# ---------------------------------------------------------------------------
# Repair 3 (C2): no stale operator after an in-place update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device_resident", [True, False])
def test_mixed_sees_inplace_updates(device_resident):
    """tests/test_mixed.py:125-150 on the port: an in-place change of A's
    values between two solves must give the new system's solution."""
    sysm = fixtures.banded_saddle_system(1024, 256, bandwidth=3,
                                         with_oracle=False)
    opts = cpt.SolverOptions(atol=0.0, rtol=1e-10, itmax=300)
    out1 = cpt.solve_mixed("cpminres", sysm.b, sysm.A, sysm.B, sysm.C,
                           sysm.G, opts=opts, device_resident=device_resident,
                           device="cpu")
    assert out1.solved
    sysm.A.data *= 1.5
    sysm.G = sp.diags(sysm.A.diagonal()).tocsr()
    out2 = cpt.solve_mixed("cpminres", sysm.b, sysm.A, sysm.B, sysm.C,
                           sysm.G, opts=opts, device_resident=device_resident,
                           device="cpu")
    assert out2.solved
    K2 = sp.bmat([[sysm.A, sysm.B.T], [sysm.B, -sysm.C]]).tocsr()
    r2 = sysm.b - K2 @ out2.x
    assert np.linalg.norm(r2) <= 1e-10 * np.linalg.norm(sysm.b), (
        "stale operator: residual checked against the old A")
