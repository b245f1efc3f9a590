"""The port's blocked substitution (``precond/trisolve.py``'s
``BlockTriFactor``, ``precond/cuda_block_tri.py``: kernel B9 and its plain
version) against the JAX package and scipy.

On a CPU tensor the port runs the plain version, the panel loop of the JAX
package's ``block_tri_solve``.  Inputs: both triangles of the host LDL^T of
the shipped ``cvxqp1_m`` fixture (L + I, and the index reversal J U J that
the upper solve runs: 22 panels of 256 rows, ELL widths 46 and 37; the
factor carries element growth, solutions up to ~1e8 for a unit right-hand
side), and random sparse lower triangles at small panels with an n that is
not a multiple of the panel.

* packing: the port's ``off_data`` / ``off_cols`` equal the JAX package's
  (both int32 columns) and ``inv_diag`` equals it; ``off_counts`` holds each
  row's off-panel entries, which sit in the row's first slots, with zeros
  (column 0) after them, as kernel B9 reads them; also at ragged n, with
  rows and panels that hold no off-panel entry (a block-diagonal triangle:
  K = 1) and as a float32 factor.  A stored zero on the diagonal raises
  ZeroDivisionError naming its panel, an entry right of its diagonal panel
  ValueError, and a CPU build counts no card pack (``block_card_packs``);
* solve: the plain version against the JAX package's ``block_tri_solve``
  on factors packed from the same matrix, and against scipy's f64
  ``spsolve_triangular``: relative 2-norm <= 1e-12 (f64) and 4e-4 (f32).
  Both packages sum each ELL row and each panel product in their own
  library's order, so they agree to rounding: measured at most 5.3e-14
  (f64) and 3.6e-5 (f32) apart on cvxqp1_m, where the element growth
  amplifies rounding; each bound is about 10x the reading; also at a
  panel of 2048 (cvxqp1_m's L in 3 panels), above the 1024 that kernel B9
  once refused;
* the plain version in kernel B9's order (``block_tri_solve_lanes``)
  against both, to the same bounds;
* the direct solve of the whole preconditioner factor (both triangles,
  D^-1 and the permutations) on cvxqp1_m in f64, port against JAX;
* the wrapper: a CPU tensor goes to the plain version and leaves the launch
  counter at 0; operands the kernel does not take (another device or dtype,
  nblocks * panel >= 2**31, a wrong length) raise, checked on ``meta``
  tensors, which need no memory and no card; a panel above 1024 is taken.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import cpkrylov_tpu as cpk
import jax.numpy as jnp
from cpkrylov_tpu.precond import trisolve as jtri
from cpkrylov_tpu_torch import make_preconditioner
from cpkrylov_tpu_torch.precond.cp import factorize_kp
from cpkrylov_tpu_torch.precond.cuda_block_tri import (
    block_tri, block_tri_solve_lanes, block_tri_solve_plain)
from cpkrylov_tpu_torch.precond.trisolve import (BlockTriFactor,
                                                 build_block_tri, tri_solve)
from cpkrylov_tpu_torch.utils.fixtures import load_fixture
from cpkrylov_tpu_torch.utils.profiling import launch_counts

torch.set_num_threads(1)

TOL = {np.float32: 4e-4, np.float64: 1e-12}
TORCH = {np.float32: torch.float32, np.float64: torch.float64}

_CACHE = {}


def _cvxqp1_m_triangles():
    """(L + I, J U J) of cvxqp1_m's host LDL^T, as scipy CSR."""
    if "tri" not in _CACHE:
        f = load_fixture("cvxqp1_m")
        hf = factorize_kp(f.G, f.B, f.C)
        N = hf.n + hf.m
        L1 = (hf.fac.L + sp.identity(N, format="csc")).tocsr()
        rev = np.arange(N - 1, -1, -1)
        _CACHE["tri"] = {"L": L1, "U": L1.T.tocsr()[rev][:, rev].tocsr()}
    return _CACHE["tri"]


def _random_lower(n, density, seed):
    rng = np.random.default_rng(seed)
    low = sp.random(n, n, density=density, random_state=rng, format="csr")
    low = sp.tril(low, k=-1) * 0.3
    return (low + sp.diags(rng.uniform(2.0, 4.0, n))).tocsr()


def _no_off_rows(n, panel, seed, some=True):
    """A random lower triangle whose odd panels hold no entry left of
    themselves, and whose even panels hold one only in every third row;
    with ``some`` false, no row holds one."""
    T = _random_lower(n, 0.05, seed).tocoo()
    blk = T.row // panel
    keep = (T.col >= blk * panel) | (
        some & (blk % 2 == 0) & (T.row % 3 == 0))
    return sp.csr_matrix((T.data[keep], (T.row[keep], T.col[keep])),
                         shape=T.shape)


def _matrix(case):
    if case in ("L", "U"):
        return _cvxqp1_m_triangles()[case], 256
    if case == "L_p2048":
        return _cvxqp1_m_triangles()["L"], 2048
    if case == "no_off_rows":
        return _no_off_rows(300, 16, seed=5), 16
    if case == "block_diagonal":
        return _no_off_rows(70, 8, seed=6, some=False), 8   # K = 1
    n, density, panel = {"rand_500_p64": (500, 0.02, 64),
                         "rand_97_p16": (97, 0.1, 16),
                         "rand_997_p16": (997, 0.01, 16),
                         "rand_50_p4": (50, 0.1, 4),
                         "rand_1030_p4": (1030, 0.005, 4)}[case]
    return _random_lower(n, density, seed=n), panel


CASES = ["L", "U", "rand_500_p64", "rand_97_p16", "L_p2048"]
# the layout also at ragged n (rand_1030_p4: more than 256 panels of at
# most 64 rows, which LAPACK inverts in one batched call), with rows and
# whole panels that hold no off-panel entry, and as a float32 factor
LAYOUT_CASES = CASES + ["rand_997_p16", "rand_50_p4", "rand_1030_p4",
                        "no_off_rows", "block_diagonal", "L_f32"]


def _rel(x, ref):
    x = np.asarray(x, np.float64)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("case", LAYOUT_CASES)
def test_layout_reproduces_the_ell(case):
    dtype = np.float32 if case.endswith("_f32") else np.float64
    T, panel = _matrix(case.removesuffix("_f32"))
    pt = build_block_tri(T, TORCH[dtype], "cpu", panel=panel)
    jt = jtri.build_block_tri(T, panel=panel, dtype=dtype)
    assert pt.off_cols.dtype == torch.int32
    assert pt.off_counts.dtype == torch.int32
    np.testing.assert_array_equal(pt.off_cols.numpy(),
                                  np.asarray(jt.off_cols))
    np.testing.assert_array_equal(pt.off_data.numpy(),
                                  np.asarray(jt.off_data))
    np.testing.assert_array_equal(pt.inv_diag.numpy(),
                                  np.asarray(jt.inv_diag))
    # the counts and the row-leading slots hold exactly T's entries left of
    # each row's panel, in column order; the rest of a row is empty
    n, n_pad = T.shape[0], pt.nblocks * panel
    coo = sp.coo_matrix(T)
    off = coo.col < (coo.row // panel) * panel
    want = np.bincount(coo.row[off], minlength=n_pad)
    counts = pt.off_counts.numpy()
    np.testing.assert_array_equal(counts, want)
    K = pt.off_data.shape[1]
    used = np.arange(K)[None, :] < counts[:, None]
    data, cols = pt.off_data.numpy(), pt.off_cols.numpy()
    assert np.all(data[~used] == 0) and np.all(cols[~used] == 0)
    rebuilt = sp.csr_matrix((data[used], cols[used],
                             np.concatenate([[0], np.cumsum(counts)])),
                            shape=(n_pad, n))
    ref = sp.csr_matrix((coo.data[off].astype(dtype),
                         (coo.row[off], coo.col[off])), shape=(n_pad, n))
    assert (rebuilt != ref).nnz == 0
    assert np.array_equal(rebuilt.indices, ref.indices)   # column order


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_and_scipy(case, dtype):
    T, panel = _matrix(case)
    rng = np.random.default_rng(7)
    b = rng.standard_normal(T.shape[0]).astype(dtype)
    ref = spla.spsolve_triangular(T, b.astype(np.float64), lower=True)
    pt = build_block_tri(T, TORCH[dtype], "cpu", panel=panel)
    jt = jtri.build_block_tri(T, panel=panel, dtype=dtype)
    x = block_tri_solve_plain(pt, torch.as_tensor(b)).numpy()
    xj = np.asarray(jtri.block_tri_solve(jt, jnp.asarray(b)))
    assert x.dtype == dtype
    assert _rel(x, xj.astype(np.float64)) <= TOL[dtype]
    assert _rel(x, ref) <= TOL[dtype]
    assert _rel(xj, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", CASES)
def test_lanes_order_matches_jax_and_scipy(case, dtype):
    """The plain version in kernel B9's order (32 lane sums and a
    butterfly a row, padding and the inverse's upper triangle never read)
    against the JAX package and scipy, to the same bounds."""
    T, panel = _matrix(case)
    rng = np.random.default_rng(7)
    b = rng.standard_normal(T.shape[0]).astype(dtype)
    ref = spla.spsolve_triangular(T, b.astype(np.float64), lower=True)
    pt = build_block_tri(T, TORCH[dtype], "cpu", panel=panel)
    jt = jtri.build_block_tri(T, panel=panel, dtype=dtype)
    x = block_tri_solve_lanes(pt, torch.as_tensor(b)).numpy()
    xj = np.asarray(jtri.block_tri_solve(jt, jnp.asarray(b)))
    assert x.dtype == dtype
    assert _rel(x, xj.astype(np.float64)) <= TOL[dtype]
    assert _rel(x, ref) <= TOL[dtype]


def test_direct_solve_matches_jax_f64():
    f = load_fixture("cvxqp1_m")
    Mp = make_preconditioner(f.G, f.B, f.C, dtype=torch.float64,
                             device="cpu")
    Mj = cpk.make_preconditioner(f.G, f.B, f.C, dtype=np.float64)
    assert isinstance(Mp.factor.tf1, BlockTriFactor)
    assert isinstance(Mp.factor.tf2, BlockTriFactor)
    assert isinstance(Mj.factor.tf1, jtri.BlockTriFactor)
    z = np.random.default_rng(3).standard_normal(f.n + f.m)
    y = Mp.factor.solve(torch.as_tensor(z)).numpy()
    yj = np.asarray(Mj.factor.solve(jnp.asarray(z)))
    assert _rel(y, yj) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cpu_dispatch_runs_the_plain_version_and_no_kernel(dtype):
    T, panel = _matrix("rand_500_p64")
    tf = build_block_tri(T, dtype, "cpu", panel=panel)
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(500)).to(
        dtype)
    before = launch_counts()
    x = block_tri(tf, b)
    assert torch.equal(x, block_tri_solve_plain(tf, b))
    assert torch.equal(tri_solve(tf, b), x)
    assert launch_counts() == before
    with pytest.raises(ValueError, match="rhs has shape"):
        block_tri(tf, b[:-1])


def _meta_factor(nb, p, K, dtype=torch.float64):
    meta = torch.device("meta")
    return BlockTriFactor(
        inv_diag=torch.empty((nb, p, p), dtype=dtype, device=meta),
        off_data=torch.empty((nb * p, K), dtype=dtype, device=meta),
        off_cols=torch.empty((nb * p, K), dtype=torch.int32, device=meta),
        off_counts=torch.empty(nb * p, dtype=torch.int32, device=meta),
        n=nb * p, panel=p)


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    meta = torch.device("meta")
    tf = _meta_factor(4, 16, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        block_tri(tf, torch.empty(64, dtype=torch.float64, device=meta))
    with pytest.raises(TypeError, match="unsupported dtype"):
        block_tri(tf, torch.empty(64, dtype=torch.float16, device=meta))
    big = _meta_factor(2**23, 256, 1)            # nblocks * panel = 2**31
    with pytest.raises(ValueError, match=r"2\*\*31"):
        block_tri(big, torch.empty(2**31, dtype=torch.float64, device=meta))
    with pytest.raises(ValueError, match="rhs has shape"):
        block_tri(tf, torch.empty(63, dtype=torch.float64, device=meta))
    # no bound on the panel: a panel of 2048 fails only for its device
    wide = _meta_factor(3, 2048, 47)
    with pytest.raises(ValueError, match="unsupported device"):
        block_tri(wide, torch.empty(3 * 2048, dtype=torch.float64,
                                    device=meta))


@pytest.mark.parametrize("n,panel", [(97, 16), (1030, 4)])
def test_a_zero_pivot_raises(n, panel):
    """A stored zero on the diagonal makes its panel singular: the pack
    names the first such panel (a diagonal entry that is not stored reads
    1, as in the JAX package's pack)."""
    T = _random_lower(n, 0.05, seed=n)
    for r in (2 * panel + 1, 3 * panel):        # stored zeros, kept as such
        lo, hi = T.indptr[r], T.indptr[r + 1]
        T.data[lo + np.flatnonzero(T.indices[lo:hi] == r)] = 0.0
    with pytest.raises(ZeroDivisionError, match="singular diagonal panel 2"):
        build_block_tri(T, torch.float64, "cpu", panel=panel)


def test_an_entry_right_of_its_panel_raises():
    T = _random_lower(97, 0.05, seed=3).tolil()
    T[5, 40] = 1.0
    with pytest.raises(ValueError, match="right of their diagonal panel"):
        build_block_tri(T.tocsr(), torch.float64, "cpu", panel=16)


def test_a_cpu_build_counts_no_card_pack():
    """``block_card_packs`` counts placements on a CUDA device only: the
    CPU build of cvxqp1_m's factor counts its two blocked triangles and no
    card pack."""
    from cpkrylov_tpu_torch.precond.cp import build_factor_apply
    from cpkrylov_tpu_torch.utils.profiling import path_counts

    f = load_fixture("cvxqp1_m")
    hf = factorize_kp(f.G, f.B, f.C)
    before = path_counts()
    fa = build_factor_apply(hf.fac, hf.n + hf.m, 256, torch.float64, "cpu")
    after = path_counts()
    assert isinstance(fa.tf1, BlockTriFactor)
    assert isinstance(fa.tf2, BlockTriFactor)
    assert after["tri_block_builds"] == before["tri_block_builds"] + 2
    assert after["block_card_packs"] == before["block_card_packs"]
