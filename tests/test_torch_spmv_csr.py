"""The port's CSR SpMV (``ops/cuda_spmv.py``: kernel B5's plain version and
its dispatch) against the JAX package's PGELL kernel and scipy.

On a CPU tensor the port runs the plain version, which sums each row's
products in stored column order.

* ``cvxqp_kkt("cvxqp3", 2000).A`` (2000 x 2000, 13,968 entries; it fails
  the DIA gate): f32 against ``pgell_matvec(pack_sym_pgell(A), x,
  interpret=True)`` (the RCM-permuted paged-gather kernel; relative 2-norm
  <= 1e-6, f32 rounding of sums of at most 9 products in two orders) and
  f32 / f64 against scipy's product (<= 1e-6 / 1e-15: scipy also sums each
  row in stored order);
* ``rmatvec`` of the rectangular B (1500 x 2000) through the stored
  transpose against scipy's ``B.T @ y``;
* the layout: int32 columns, int64 row pointers, the transpose packed once
  (and left out for K_P), ``utils/convert.csr_from_numpy``;
* kernel B5's row split (``formats.csr_tiles``, ``cuda_spmv.csr_walk``),
  for a matrix and its stored transpose: each row is summed once, by the
  tile it starts in, over its entries in stored order, for empty rows, a
  row of 5,000 entries beside short ones (its tail past the held entries
  read from device memory), fewer rows than a block, a ragged last tile,
  entries that fill their tiles exactly with empty rows after them, and a
  matrix with no entries; the tile size by entry count.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cpkrylov_tpu.ops.pallas_spmv import pgell_matvec
from cpkrylov_tpu.ops.pgell import pack_sym_pgell
from cpkrylov_tpu_torch.ops import cuda_spmv, spmv
from cpkrylov_tpu_torch.ops.cuda_spmv import (csr_matvec_plain, csr_rmatvec,
                                              csr_walk)
from cpkrylov_tpu_torch.ops.formats import (CSR, MAX_TILE, TILE_BLOCKS,
                                            TILE_HALO, TILE_THREADS,
                                            csr_from_scipy, csr_tile)
from cpkrylov_tpu_torch.precond.cp import assemble_kp, pack_device_format
from cpkrylov_tpu_torch.utils.convert import csr_from_numpy
from cpkrylov_tpu_torch.utils.mm import cvxqp_kkt

torch.set_num_threads(1)

SCIPY_TOL = {torch.float32: 1e-6, torch.float64: 1e-15}


@pytest.fixture(scope="module")
def cvxqp3():
    return cvxqp_kkt("cvxqp3", 2000)


def _rel(y, ref):
    y = np.asarray(y, np.float64)
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


def test_plain_matches_pgell_interpret_f32(cvxqp3):
    A = cvxqp3.A
    packed = pack_sym_pgell(A)
    assert packed is not None
    x = np.random.default_rng(0).standard_normal(A.shape[0]).astype(
        np.float32)
    y_jax = np.asarray(pgell_matvec(packed.inner, jnp.asarray(x)[packed.perm],
                                    interpret=True)[packed.iperm])
    y = csr_matvec_plain(csr_from_scipy(A, torch.float32, "cpu"),
                         torch.as_tensor(x))
    assert y.dtype == torch.float32
    assert _rel(y.numpy(), y_jax) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_matvec_and_rmatvec_match_scipy(cvxqp3, dtype):
    rng = np.random.default_rng(1)
    for mat in (cvxqp3.A, cvxqp3.B, assemble_kp(cvxqp3.G, cvxqp3.B,
                                                cvxqp3.C)):
        c = csr_from_scipy(mat, dtype, "cpu")
        x = rng.standard_normal(mat.shape[1])
        y = spmv.matvec(c, torch.as_tensor(x, dtype=dtype))
        assert y.dtype == dtype and y.shape == (mat.shape[0],)
        xr = np.asarray(torch.as_tensor(x, dtype=dtype), np.float64)
        assert _rel(y.numpy(), mat @ xr) <= SCIPY_TOL[dtype]
        v = rng.standard_normal(mat.shape[0])
        vr = np.asarray(torch.as_tensor(v, dtype=dtype), np.float64)
        z = spmv.rmatvec(c, torch.as_tensor(v, dtype=dtype))
        assert z.shape == (mat.shape[1],)
        assert _rel(z.numpy(), mat.T @ vr) <= SCIPY_TOL[dtype]


def test_plain_sums_rows_in_stored_order():
    """Each row is the left-to-right sum of its products: a row whose
    entries cancel in one order and not in another tells them apart."""
    big = 2.0 ** 53
    mat = sp.csr_matrix(np.array([[big, 1.0, -big, 1.0],
                                  [0.0, 3.0, 0.0, 0.0]]))
    y = csr_matvec_plain(csr_from_scipy(mat, torch.float64, "cpu"),
                         torch.ones(4, dtype=torch.float64))
    # ((big + 1) - big) + 1 = 0 + 1 in f64, where the exact sum is 2
    assert y.tolist() == [1.0, 3.0]


def test_layout_and_transpose(cvxqp3):
    B = cvxqp3.B
    c = csr_from_scipy(B, torch.float64, "cpu")
    assert c.indices.dtype == torch.int32 and c.indptr.dtype == torch.int64
    assert c.shape == B.shape and c.nnz == B.nnz
    assert isinstance(c.t, CSR) and c.t.shape == (B.shape[1], B.shape[0])
    assert c.t.t is None
    np.testing.assert_array_equal(c.indptr.numpy(), B.tocsr().indptr)
    kp = pack_device_format(assemble_kp(cvxqp3.G, cvxqp3.B, cvxqp3.C),
                            torch.float64, "cpu")
    assert isinstance(kp, CSR) and kp.t is None
    with pytest.raises(ValueError, match="without its transpose"):
        csr_rmatvec(kp, torch.zeros(kp.shape[0], dtype=torch.float64))
    B = B.tocsr()
    d = csr_from_numpy(B.data, B.indices, B.indptr, B.shape, device="cpu")
    for name in ("data", "indices", "indptr"):
        assert torch.equal(getattr(d, name), getattr(c, name)), name


def test_cpu_products_count_no_launch(cvxqp3):
    c = csr_from_scipy(cvxqp3.A, torch.float64, "cpu")
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(2000))
    before = cuda_spmv.LAUNCHES
    assert torch.equal(spmv.matvec(c, x), csr_matvec_plain(c, x))
    assert cuda_spmv.LAUNCHES == before
    empty = csr_from_scipy(sp.csr_matrix((3, 4)), torch.float64, "cpu")
    assert torch.equal(csr_matvec_plain(empty, torch.ones(4,
                                                          dtype=torch.float64)),
                       torch.zeros(3, dtype=torch.float64))


def _walk_case(name):
    rng = np.random.default_rng(4)
    if name == "empty_rows":          # 300 of CVXQP3's 2000 B' rows
        return cvxqp_kkt("cvxqp3", 2000).B.T.tocsr()
    if name == "long_row":
        m = sp.random(200, 6000, density=4e-4, random_state=5, format="lil")
        m[37, 500:5500] = rng.standard_normal(5000)
        return m.tocsr()
    if name == "few_rows":
        return sp.random(5, 40, density=0.3, random_state=6, format="csr")
    if name == "ragged":
        return sp.random(97, 120, density=0.05, random_state=7, format="csr")
    if name == "full_tiles":          # 2 tiles of 256, then 8 empty rows
        m = sp.lil_matrix((40, 30))
        m[:32, :16] = rng.standard_normal((32, 16))
        return m.tocsr()
    return sp.csr_matrix((70, 30))    # no entries


WALK_CASES = ["empty_rows", "long_row", "few_rows", "ragged", "full_tiles",
              "no_entries"]


@pytest.mark.parametrize("side", ["matrix", "transpose"])
@pytest.mark.parametrize("name", WALK_CASES)
def test_walk_sums_each_row_once_from_its_tile(name, side):
    mat = _walk_case(name)
    c = csr_from_scipy(mat, torch.float64, "cpu")
    if side == "transpose":
        mat, c = mat.T.tocsr(), c.t
    tiles, tile, n = c.tiles.tolist(), c.tile, mat.shape[0]
    assert tile == TILE_THREADS     # these matrices have few entries
    assert len(tiles) - 1 == max(1, -(-mat.nnz // tile))
    assert tiles[0] == 0 and tiles[-1] == n
    assert all(a <= b for a, b in zip(tiles, tiles[1:]))
    rows = []
    for t, r, rs, held, re in csr_walk(c):
        assert (rs, re) == (mat.indptr[r], mat.indptr[r + 1])
        # the row starts in tile t (trailing empty rows in the last)
        assert t * tile <= rs
        assert rs < (t + 1) * tile or (t == len(tiles) - 2 and rs == re)
        assert held == min(re, (t + 1) * tile + TILE_HALO)
        rows.append(r)
    assert rows == list(range(n))
    if name == "long_row" and side == "matrix":   # its tail from memory
        _, _, rs, held, re = [s for s in csr_walk(c) if s[1] == 37][0]
        assert re - rs == 5000 and held - rs <= tile + TILE_HALO
    if name == "full_tiles" and side == "matrix":
        assert tiles == [0, 16, 40]


def test_tile_size():
    assert csr_tile(0) == csr_tile(TILE_THREADS * TILE_BLOCKS) == 256
    assert csr_tile(TILE_THREADS * TILE_BLOCKS + 1) == 512
    assert csr_tile(1_095_251) == 768               # AUG2D-L's K_P
    assert csr_tile(10 ** 9) == MAX_TILE
