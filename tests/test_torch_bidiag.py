"""The port's bidiagonal solve (``precond/cuda_bidiag.py``) against the JAX
package's Pallas kernel and scipy.

On a CPU tensor the port runs its plain version, which performs the CUDA
kernel's multiplies and adds in the kernel's order (tiles, per-thread
folds, warp scans, the fixed look-back over earlier tiles' aggregates, the
apply).  It is held against ``bidiag_tri_solve(..., interpret=True)`` in
f32 (n = 8192, chunk = 1024; relative 2-norm error <= 1e-5, the f32 scan's
rounding), against scipy's sequential substitution in f64 (<= 1e-12), for
the lower solve, the right-to-left upper solve and the upper solve with D
folded in, and against a Hillis-Steele scan of all n maps (another
association: <= 1e-12 f64, 1e-5 f32).  A scalar transcription of the
kernel, thread by thread, must equal it bit for bit.  Ragged sizes cover
one partial tile, exact tiles, and more than 256 tiles, where each look-back
thread folds more than one aggregate.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from cpkrylov_tpu.precond.pallas_bidiag import bidiag_tri_solve as jax_solve
from cpkrylov_tpu.precond.pallas_bidiag import build_bidiag_tri as jax_build
from cpkrylov_tpu.precond.pallas_bidiag import \
    build_bidiag_tri_upper as jax_build_upper
from cpkrylov_tpu_torch.precond import cuda_bidiag
from cpkrylov_tpu_torch.precond.cuda_bidiag import (BidiagTriFactor,
                                                     bidiag_scan,
                                                     bidiag_scan_plain,
                                                     bidiag_tri_solve,
                                                     build_bidiag_tri,
                                                     build_bidiag_tri_upper)
from cpkrylov_tpu_torch.precond.trisolve import tri_solve
from cpkrylov_tpu_torch.utils.profiling import launch_counts

torch.set_num_threads(1)

N = 8192
TILE = cuda_bidiag.TILE
# n: one entry, two, a tile less one, a tile, a tile and one, three tiles
# and a partial one, above 32 tiles, and above 256 tiles (each of the
# look-back's 256 threads folds two aggregates for the last tiles)
RAGGED = [1, 2, TILE - 1, TILE, TILE + 1, 3 * TILE + 5, 33 * TILE + 1,
          257 * TILE + 3]
REL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _system(kind, n, seed):
    """(matrix to factor, lower?, scipy reference solve, rhs) for one kind."""
    rng = np.random.default_rng(seed)
    diag = 1.0 + rng.random(n)
    d = np.where(rng.random(n) < 0.5, -1.0, 1.0) * (0.5 + rng.random(n))
    off = rng.standard_normal(n - 1) * 0.4
    b = rng.standard_normal(n)
    if kind == "lower":
        T = sp.diags([diag, off], [0, -1], format="csr")
        return T, True, lambda v: spla.spsolve_triangular(T, v, lower=True), b
    if kind == "upper":
        U = sp.diags([diag, off], [0, 1], format="csr")
        return U, False, \
            lambda v: spla.spsolve_triangular(U, v, lower=False), b
    # "upper_folded": the factor solves D U, which must equal U^-1 (D^-1 v)
    U = sp.diags([np.ones(n), off], [0, 1], format="csr")
    DU = (sp.diags(d) @ U).tocsr()
    return DU, False, \
        lambda v: spla.spsolve_triangular(U, v / d, lower=False), b


def _build(kind, T, dtype):
    if kind == "lower":
        return build_bidiag_tri(T, dtype=dtype, device="cpu")
    return build_bidiag_tri_upper(T, dtype=dtype, device="cpu")


def _relnorm(x, ref):
    x = np.asarray(x, np.float64)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("kind", ["lower", "upper", "upper_folded"])
def test_plain_matches_pallas_interpret_f32(kind):
    T, lower, ref, b = _system(kind, N, seed=11)
    jtf = (jax_build(T, chunk=1024) if lower
           else jax_build_upper(T, chunk=1024))
    assert jtf is not None
    b32 = b.astype(np.float32)
    x_pallas = np.asarray(jax_solve(jtf, jnp.asarray(b32), interpret=True),
                          np.float64)
    tf = _build(kind, T, torch.float32)
    x = bidiag_tri_solve(tf, torch.as_tensor(b32))
    assert x.dtype == torch.float32
    assert _relnorm(x.numpy(), x_pallas) <= 1e-5
    assert _relnorm(x.numpy(), ref(b32.astype(np.float64))) <= 1e-5


@pytest.mark.parametrize("n", [N, 1000, 1])
@pytest.mark.parametrize("kind", ["lower", "upper", "upper_folded"])
def test_plain_matches_scipy_f64(kind, n):
    T, lower, ref, b = _system(kind, n, seed=13)
    tf = _build(kind, T, torch.float64)
    assert tf is not None and tf.reverse == (not lower)
    x = bidiag_tri_solve(tf, torch.as_tensor(b))
    assert x.dtype == torch.float64
    assert _relnorm(x.numpy(), ref(b)) <= 1e-12


def test_build_gates():
    """Mirror of tests/test_pallas_tri.py::test_bidiag_build_gates: reach 2
    and a zero diagonal are rejected.  The Pallas build's f32-only and
    n >= 8*chunk gates are TPU layout and are dropped: small systems and
    f64 build."""
    rng = np.random.default_rng(1)
    n = 4000
    d = 1.0 + rng.random(n)
    reach2 = sp.diags([d, rng.standard_normal(n - 2)], [0, -2])
    assert build_bidiag_tri(reach2, torch.float32, "cpu") is None
    assert build_bidiag_tri_upper(reach2.T, torch.float32, "cpu") is None
    d0 = d.copy()
    d0[7] = 0.0
    assert build_bidiag_tri(sp.diags([d0], [0]), torch.float32, "cpu") is None
    assert build_bidiag_tri_upper(sp.diags([d0], [0]), torch.float64,
                                  "cpu") is None
    # wrong triangle
    assert build_bidiag_tri(sp.diags([d, d[1:]], [0, 1]), torch.float64,
                            "cpu") is None
    assert build_bidiag_tri(sp.diags([d], [0]), torch.float16, "cpu") is None
    for dtype in (torch.float32, torch.float64):
        small = build_bidiag_tri(sp.diags([d[:100]], [0]), dtype, "cpu")
        assert isinstance(small, BidiagTriFactor)
        assert small.a.dtype == dtype and small.invd.dtype == dtype


def test_dispatch_and_cpu_counts_no_launch():
    T, _, _, b = _system("lower", 500, seed=2)
    tf = build_bidiag_tri(T, torch.float64, "cpu")
    before = launch_counts()
    x1 = tri_solve(tf, torch.as_tensor(b))
    x2 = bidiag_scan(tf.a, tf.invd, torch.as_tensor(b), False)
    np.testing.assert_array_equal(x1.numpy(), x2.numpy())
    assert launch_counts() == before
    with pytest.raises(ValueError):
        bidiag_tri_solve(tf, torch.zeros(499, dtype=torch.float64))


def _maps(n, seed, dtype, reverse):
    """(a, invd, b) of a random contractive recurrence, and scipy's f64
    solution of its bidiagonal system."""
    rng = np.random.default_rng(seed)
    dd = 1.0 + rng.random(n)
    off = 0.4 * rng.standard_normal(n - 1)
    b = rng.standard_normal(n)
    if reverse:
        T = sp.diags([dd, off], [0, 1], format="csr")
        a = np.append(-off / dd[:-1], 0.0)
    else:
        T = sp.diags([dd, off], [0, -1], format="csr")
        a = np.concatenate([[0.0], -off / dd[1:]])
    ref = spla.spsolve_triangular(T, b, lower=not reverse)
    return (torch.as_tensor(a).to(dtype), torch.as_tensor(1.0 / dd).to(dtype),
            torch.as_tensor(b).to(dtype), ref)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", RAGGED)
def test_plain_ragged_sizes_match_scipy(n, reverse):
    a, invd, b, ref = _maps(n, n, torch.float64, reverse)
    x = bidiag_scan(a, invd, b, reverse)
    assert x.dtype == torch.float64 and x.shape == (n,)
    assert _relnorm(x.numpy(), ref) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", RAGGED)
def test_plain_matches_hillis_steele(n, reverse, dtype):
    a, invd, b, _ = _maps(n, n + 1, dtype, reverse)
    x = bidiag_scan_plain(a, invd, b, reverse)
    h = cuda_bidiag._bidiag_scan_hillis_steele(a, invd, b, reverse)
    assert x.dtype == dtype
    assert _relnorm(x.numpy(), h.double().numpy()) <= REL_TOL[dtype]


def _kernel_transcript(a, invd, b, reverse, ftype):
    """``bidiag_scan.cu`` read as a sequential program: each tile, warp and
    thread in turn, every multiply and add rounded to ``ftype`` (Python's
    float for f64, numpy.float32 for f32).  An independent check that the
    vectorised plain version keeps the kernel's order."""
    n = len(b)
    threads, items, lanes = 256, TILE // 256, 32
    warps = threads // lanes
    one, zero = ftype(1.0), ftype(0.0)

    def compose(e, l):
        return (ftype(l[0] * e[0]), ftype(ftype(l[0] * e[1]) + l[1]))

    def apply(f, s):
        return ftype(ftype(f[0] * s) + f[1])

    ntiles = -(-n // TILE)
    x = [None] * n
    aggs = []
    for t in range(ntiles):
        def item(j):
            jj = t * TILE + j
            if jj >= n:
                return (one, zero)
            p = n - 1 - jj if reverse else jj
            return (ftype(a[p]), ftype(ftype(invd[p]) * ftype(b[p])))

        v = []
        for th in range(threads):
            f = item(th * items)
            for k in range(1, items):
                f = compose(f, item(th * items + k))
            v.append(f)
        for d in (1, 2, 4, 8, 16):        # per warp, all lanes at once
            v = [compose(v[i - d], v[i]) if i % lanes >= d else v[i]
                 for i in range(threads)]
        tot = [v[w * lanes + lanes - 1] for w in range(warps)]
        for d in (1, 2, 4):
            tot = [compose(tot[i - d], tot[i]) if i >= d else tot[i]
                   for i in range(warps)]
        aggs.append(tot[-1])
        start = zero
        if t > 0:
            ch = -(-t // threads)
            f, ne = [], []
            for th in range(threads):
                q0, q1 = th * ch, min(th * ch + ch, t)
                g = (one, zero)
                for q in range(q0, q1):
                    g = aggs[q] if q == q0 else compose(g, aggs[q])
                f.append(g)
                ne.append(q0 < t)
            off = 1
            while off < lanes:
                f = [compose(f[i], f[i + off])
                     if i % lanes + off < lanes and ne[i + off] else f[i]
                     for i in range(threads)]
                off *= 2
            r = f[0]
            for w in range(1, warps):
                if ne[w * lanes]:
                    r = compose(r, f[w * lanes])
            start = r[1]
        for th in range(threads):
            w, lane = divmod(th, lanes)
            s = start if w == 0 else apply(tot[w - 1], start)
            if lane > 0:
                s = apply(v[th - 1], s)
            for k in range(items):
                j = t * TILE + th * items + k
                s = apply(item(th * items + k), s)
                if j < n:
                    x[n - 1 - j if reverse else j] = s
    return np.array(x, dtype=np.float64)


@pytest.mark.parametrize("dtype,reverse,n", [
    (torch.float64, False, 3 * TILE + 5), (torch.float64, True, 3 * TILE + 5),
    (torch.float32, False, 3 * TILE + 5), (torch.float32, True, TILE - 1),
    (torch.float64, True, 257 * TILE + 3)])
def test_plain_equals_kernel_transcript(dtype, reverse, n):
    a, invd, b, _ = _maps(n, 7 * n, dtype, reverse)
    ftype = float if dtype == torch.float64 else np.float32
    x = bidiag_scan_plain(a, invd, b, reverse)
    ref = _kernel_transcript(a.numpy(), invd.numpy(), b.numpy(), reverse,
                             ftype)
    np.testing.assert_array_equal(x.double().numpy(), ref)


def test_tile_count_refuses_overflow():
    """n past the kernel's 32-bit grid of tiles raises before any launch."""
    assert cuda_bidiag._tiles(cuda_bidiag.MAX_TILES * TILE) == \
        cuda_bidiag.MAX_TILES
    with pytest.raises(ValueError):
        cuda_bidiag._tiles(cuda_bidiag.MAX_TILES * TILE + 1)
