"""The port's df64 triangle product (``precond/df_factor.py``'s ``DFTriMat``,
``precond/cuda_df_tri.py``: kernel B10 and its plain version) against the
JAX package and an independent replica of its arithmetic.

On a CPU tensor the port runs the plain version, the slot loop of the JAX
package's ``DFTriMat.matvec_df``.  Inputs: both df64 triangles of the host
LDL^T of the shipped ``cvxqp1_m`` fixture as ``_pack_df_tri`` packs them
for the df64-applied factor (L + I: 69 slots, and J U J: 44 slots, n =
5,500), and a small random triangle; x is a df64 pair made with numpy.

* packing: hi, lo and the int32 columns equal the JAX package's bit for
  bit, and the columns and values reproduce the matrix row by row;
* order: the plain version equals bit for bit (hi and lo) a numpy replica
  of the chain, every operation rounded on its own in float32, as kernel
  B10 rounds it;
* against the JAX package on the same packed operands: XLA's CPU compiler
  contracts the chain's ``e + dh * vl`` steps into fused multiply-adds
  (checked here: its ``c + a * b`` on float32 equals the fused result
  everywhere and differs from the separately rounded one in about a
  quarter of the entries), so the lo parts, and through them a hi part
  now and then, differ.  The two products are held to 1e-13 of
  sum_j |T_ij| |x_j| per row: measured 2.5e-14 apart on cvxqp1_m, and
  each 4.8e-14 from the f64 product there, df64's accuracy for rows of
  up to 69 terms;
* the df64-applied direct solve of the whole factor at two refinement
  steps (f32 triangles through blocked substitution, the df64 residuals
  through this product) on cvxqp1_m, port against JAX;
* the walk of kernel B10 (``df_tri_matvec_walk``: a row's ``counts``
  stored slots, then one padding slot) equals the plain K-slot loop bit
  for bit (hi and lo, NaNs by their bits), with x[0], the column every
  padding slot reads, set to +0, -0, -2.25, 1e-40, 1e35, inf, -inf and
  NaN, on a triangle with rows of 0, K - 1 and K entries and on cvxqp1_m's;
* ``counts`` equals the CSR row counts, and a ``DFTriMat`` survives a
  ``utils/checkpoint.py`` save and reload with it;
* the wrapper: a CPU tensor goes to the plain version and leaves the launch
  counter at 0; operands the kernel does not take (another device or dtype,
  n >= 2**31, a wrong length) raise, checked on ``meta`` tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cpkrylov_tpu.ops import df64 as jdf64
from cpkrylov_tpu.precond import df_factor as jdf
from cpkrylov_tpu_torch.precond.cp import assemble_kp, factorize_kp
from cpkrylov_tpu_torch.precond.cuda_df_tri import (df_tri_matvec,
                                                    df_tri_matvec_plain,
                                                    df_tri_matvec_walk)
from cpkrylov_tpu_torch.precond.df_factor import DFTriMat, _pack_df_tri
from cpkrylov_tpu_torch.utils.convert import df_factor_from_host
from cpkrylov_tpu_torch.utils.fixtures import load_fixture
from cpkrylov_tpu_torch.utils.profiling import launch_counts

torch.set_num_threads(1)

ROW_TOL = 1e-13
_CACHE = {}


def _host_factor():
    if "hf" not in _CACHE:
        f = load_fixture("cvxqp1_m")
        _CACHE["hf"] = factorize_kp(f.G, f.B, f.C)
    return _CACHE["hf"]


def _matrix(case):
    if case == "random":
        rng = np.random.default_rng(4)
        low = sp.tril(sp.random(300, 300, density=0.05, random_state=rng),
                      k=-1)
        return (low * 1e3 + sp.diags(rng.uniform(1.0, 2.0, 300))).tocsr()
    hf = _host_factor()
    N = hf.n + hf.m
    L1 = (hf.fac.L + sp.identity(N, format="csc")).tocsr()
    if case == "L":
        return L1
    rev = np.arange(N - 1, -1, -1)
    return L1.T.tocsr()[rev][:, rev].tocsr()


CASES = ["L", "U", "random"]


def _x(n, seed=0):
    x = np.random.default_rng(seed).standard_normal(n) * 10.0
    return jdf64.df_from_f64(x)


def _chain_numpy(hi, lo, cols, xh, xl):
    """The compensated chain in numpy float32, one rounding per operation
    (numpy's elementwise float32 arithmetic never fuses)."""
    f = np.float32
    split = f(4097.0)

    def two_prod(a, b):
        p = a * b
        c = a * split
        ah = c - (c - a)
        al = a - ah
        c = b * split
        bh = c - (c - b)
        bl = b - bh
        return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl

    acc_h = np.zeros(hi.shape[1], f)
    acc_l = np.zeros(hi.shape[1], f)
    for k in range(hi.shape[0]):
        vh, vl = xh[cols[k]], xl[cols[k]]
        p, e = two_prod(hi[k], vh)
        e = e + hi[k] * vl + lo[k] * vh
        s = acc_h + p
        bb = s - acc_h
        e2 = (acc_h - (s - bb)) + (p - bb)
        acc_h = s
        acc_l = acc_l + (e + e2)
    s = acc_h + acc_l
    return s, acc_l - (s - acc_h)


@pytest.mark.parametrize("case", CASES)
def test_pack_matches_jax_and_reproduces_the_matrix(case):
    T = _matrix(case)
    pt = _pack_df_tri(T, "cpu")
    jt = jdf._pack_df_tri(T)
    assert pt.cols.dtype == torch.int32
    for name in ("hi", "lo", "cols"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(jt, name)))
    K, n = pt.hi.shape
    assert n == T.shape[0] == pt.n and K == np.diff(T.indptr).max()
    rows = np.broadcast_to(np.arange(n), (K, n))
    vals = pt.hi.numpy().astype(np.float64) + pt.lo.numpy()
    used = vals != 0
    rebuilt = sp.csr_matrix((vals[used], (rows[used],
                                          pt.cols.numpy()[used])),
                            shape=T.shape)
    want = sp.csr_matrix(T, copy=True)
    want.eliminate_zeros()
    for mat in (rebuilt, want):
        mat.sort_indices()
    np.testing.assert_array_equal(rebuilt.indptr, want.indptr)
    np.testing.assert_array_equal(rebuilt.indices, want.indices)
    # hi + lo carries each f64 entry to 2^-48 of itself
    assert np.all(np.abs(rebuilt.data - want.data)
                  <= 2.0**-46 * np.abs(want.data))


@pytest.mark.parametrize("case", CASES)
def test_plain_equals_the_rounded_chain_bitwise(case):
    pt = _pack_df_tri(_matrix(case), "cpu")
    xh, xl = _x(pt.n)
    yh, yl = df_tri_matvec_plain(pt, (torch.as_tensor(xh),
                                      torch.as_tensor(xl)))
    rh, rl = _chain_numpy(pt.hi.numpy(), pt.lo.numpy(),
                          pt.cols.numpy(), xh, xl)
    assert np.array_equal(yh.numpy(), rh) and np.array_equal(yl.numpy(), rl)


def test_xla_fuses_multiply_adds_on_the_cpu():
    """The reason the JAX package's lo parts differ: XLA's CPU build turns
    ``c + a * b`` into one fused multiply-add."""
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal(4096).astype(np.float32) for _ in range(2))
    c = (rng.standard_normal(4096) * 1e-7).astype(np.float32)
    got = np.asarray(jax.jit(lambda c, a, b: c + a * b)(c, a, b))
    fused = (c.astype(np.float64) + a.astype(np.float64) * b).astype(
        np.float32)                  # a*b is exact in f64: one rounding
    assert np.array_equal(got, fused)
    assert not np.array_equal(got, c + a * b)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax(case):
    T = _matrix(case)
    pt, jt = _pack_df_tri(T, "cpu"), jdf._pack_df_tri(T)
    xh, xl = _x(pt.n, seed=2)
    yh, yl = pt.matvec_df((torch.as_tensor(xh), torch.as_tensor(xl)))
    jh, jl = jt.matvec_df((jnp.asarray(xh), jnp.asarray(xl)))
    y = yh.double().numpy() + yl.numpy()
    yj = np.asarray(jh, np.float64) + np.asarray(jl)
    x = xh.astype(np.float64) + xl
    scale = abs(T) @ np.abs(x)
    scale[scale == 0] = 1.0
    assert np.max(np.abs(y - yj) / scale) <= ROW_TOL
    assert np.max(np.abs(y - T @ x) / scale) <= ROW_TOL


def test_df_direct_solve_matches_jax_at_two_refinement_steps():
    """Both packages' df64-applied factors of one JAX host LDL^T
    (``tests/test_torch_df64.py`` holds them at one step): at nref = 2 each
    triangle takes two df64 products, and the solves agree to 1e-9 as
    there (the df64 refinement removes the f32 substitutions' different
    rounding)."""
    from cpkrylov_tpu.precond import ldl_host as jax_ldl
    from cpkrylov_tpu.precond.cp import build_factor_apply as jax_bfa
    from cpkrylov_tpu.precond.df_factor import build_df_factor_apply as jbdf

    f = load_fixture("cvxqp1_m")
    N = f.n + f.m
    ksp = assemble_kp(f.G, f.B, f.C)
    fac = jax_ldl.factorize(
        ksp, method="auto", ordering="rcm",
        pivot_signs=np.concatenate([np.ones(f.n), -np.ones(f.m)]),
        reg_value=1e-10)
    ours = df_factor_from_host(fac, f.n, f.m, device="cpu", nref=2)
    ref = jbdf(jax_bfa(fac, N, 256, np.float32, scan_ok=False,
                       fold_dinv=False), fac, N, nref=2)
    z = np.random.default_rng(5).standard_normal(N).astype(np.float32)
    before = launch_counts()
    y = ours.solve(torch.as_tensor(z)).numpy()
    assert launch_counts() == before
    yj = np.asarray(ref.solve(jnp.asarray(z)))
    assert np.linalg.norm(y - yj) / np.linalg.norm(yj) <= 1e-9


def test_cpu_dispatch_runs_the_plain_version_and_no_kernel():
    pt = _pack_df_tri(_matrix("random"), "cpu")
    xh, xl = (torch.as_tensor(v) for v in _x(pt.n))
    before = launch_counts()
    yh, yl = df_tri_matvec(pt, (xh, xl))
    ph, pl = df_tri_matvec_plain(pt, (xh, xl))
    assert torch.equal(yh, ph) and torch.equal(yl, pl)
    mh, ml = pt.matvec_df((xh, xl))
    assert torch.equal(mh, ph) and torch.equal(ml, pl)
    assert launch_counts() == before
    with pytest.raises(ValueError, match="x has shape"):
        df_tri_matvec(pt, (xh[:-1], xl[:-1]))


def _meta_mat(K, n):
    meta = torch.device("meta")
    return DFTriMat(hi=torch.empty((K, n), device=meta),
                    lo=torch.empty((K, n), device=meta),
                    cols=torch.empty((K, n), dtype=torch.int32, device=meta),
                    counts=torch.empty(n, dtype=torch.int32, device=meta),
                    n=n)


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    meta = torch.device("meta")
    t = _meta_mat(3, 40)
    x = torch.empty(40, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        df_tri_matvec(t, (x, x))
    x64 = torch.empty(40, dtype=torch.float64, device=meta)
    with pytest.raises(TypeError, match="unsupported dtype"):
        df_tri_matvec(t, (x64, x64))
    big = _meta_mat(1, 2**31)
    xb = torch.empty(2**31, device=meta)
    with pytest.raises(ValueError, match=r"2\*\*31"):
        df_tri_matvec(big, (xb, xb))


def _ragged_triangle():
    """A lower triangle of 64 rows with rows of 0, K - 1 and K entries,
    entries at column 0 among them, and K = 9."""
    rng = np.random.default_rng(11)
    n, K = 64, 9
    rows, cols = [], []
    for i in range(n):
        c = {0: 0, 1: 0, 20: K - 1, 21: K, 40: K, 41: K - 1}.get(
            i, int(rng.integers(0, min(i, K) + 1)))
        c = min(c, i + 1)
        chosen = np.sort(rng.choice(i + 1, size=c, replace=False))
        rows += [i] * c
        cols += list(chosen)
    vals = rng.standard_normal(len(rows)) * 10.0 ** rng.integers(-3, 4,
                                                                 len(rows))
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n))


def _bits(v):
    return v.view(torch.int32)


@pytest.mark.parametrize("x0", [0.0, -0.0, -2.25, 1e-40, 1e35, np.inf,
                                -np.inf, np.nan])
@pytest.mark.parametrize("case", ["ragged", "L"])
def test_walk_equals_the_plain_slot_loop_bitwise(case, x0):
    T = _ragged_triangle() if case == "ragged" else _matrix("L")
    t = _pack_df_tri(T, "cpu")
    K = t.hi.shape[0]
    counts = t.counts.numpy()
    if case == "ragged":
        assert {0, K - 1, K} <= set(counts.tolist())
    xh, xl = _x(t.n, seed=6)
    xh[0] = np.float32(x0)
    xl[0] = np.float32(x0 if x0 == 0 else 0.0)
    x = (torch.as_tensor(xh), torch.as_tensor(xl))
    yh, yl = df_tri_matvec_plain(t, x)
    wh, wl = df_tri_matvec_walk(t, x)
    assert torch.equal(_bits(yh), _bits(wh))
    assert torch.equal(_bits(yl), _bits(wl))


@pytest.mark.parametrize("case", CASES)
def test_counts_are_the_csr_row_counts(case):
    T = _matrix(case)
    t = _pack_df_tri(T, "cpu")
    csr = sp.csr_matrix(T)
    csr.sum_duplicates()
    assert t.counts.dtype == torch.int32 and tuple(t.counts.shape) == (t.n,)
    np.testing.assert_array_equal(t.counts.numpy(), np.diff(csr.indptr))
    # a row's entries fill its first counts[i] slots, the rest is (0, 0, 0)
    K = t.hi.shape[0]
    empty = np.arange(K)[:, None] >= t.counts.numpy()[None, :]
    for arr in (t.hi, t.lo, t.cols):
        assert np.all(arr.numpy()[empty] == 0)


def test_df_tri_mat_survives_a_checkpoint(tmp_path):
    from cpkrylov_tpu_torch.utils.checkpoint import load_pytree, save_pytree

    t = _pack_df_tri(_ragged_triangle(), "cpu")
    path = str(tmp_path / "t.npz")
    save_pytree(t, path)
    for got in (load_pytree(t, path), load_pytree(None, path,
                                                  device="cpu")):
        assert isinstance(got, DFTriMat) and got.n == t.n
        for name in ("hi", "lo", "cols", "counts"):
            assert torch.equal(getattr(got, name), getattr(t, name))
    xh, xl = (torch.as_tensor(v) for v in _x(t.n, seed=8))
    a, b = df_tri_matvec_plain(got, (xh, xl)), df_tri_matvec_plain(t,
                                                                   (xh, xl))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
