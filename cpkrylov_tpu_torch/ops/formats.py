"""Sparse matrix containers as frozen dataclasses of tensors.

Port of ``cpkrylov_tpu/ops/formats.py``.  ``CSR`` is the
operand of kernel B5 (``ops/cuda_spmv.py``), which serves every matrix that
fails the DIA gate: int64 row pointers, int32 column indices and the values,
each row in stored column order; the row split of B5's tiles (``tiles``:
the first row that starts in each tile of ``tile`` stored entries,
``csr_tiles``); and, for ``rmatvec``, the CSR of the transpose, packed once,
so that ``M^T y`` is the same kernel with no atomics.  ``Diagonal`` is
C = delta*I.  ``ELL`` (rows padded to a common width) and ``BSR`` (dense
blocks at sparse block positions) are the JAX package's other two operand
containers, which a caller may build and pass as ``A``; their products are
plain PyTorch (``ops/spmv.py``), as the JAX package computes them in XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..utils.device import resolve_device, torch_dtype, upload


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix (rows ascending, duplicates summed)."""

    data: torch.Tensor        # (nnz,) values
    indices: torch.Tensor     # (nnz,) int32 column indices
    indptr: torch.Tensor      # (nrows + 1,) int64 row pointers
    shape: Tuple[int, int]
    tiles: torch.Tensor       # (ntiles + 1,) int64: B5's row split
    tile: int                 # stored entries a tile of B5
    t: "CSR | None" = None    # the transpose (rmatvec), or None

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype


@dataclasses.dataclass(frozen=True)
class ELL:
    """ELLPACK layout: each row padded to a common ``K`` entries, the row
    count padded to a multiple of ``lane_pad``.  Padding slots have
    ``data == 0`` and ``cols == 0``."""

    data: torch.Tensor        # (nrows_pad, K)
    cols: torch.Tensor        # (nrows_pad, K) int64 column indices
    shape: Tuple[int, int]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def row_width(self) -> int:
        return int(self.data.shape[1])


@dataclasses.dataclass(frozen=True)
class BSR:
    """Block sparse row: dense (bs, bs) blocks at sparse block positions,
    sorted by block row; the shape is padded to whole blocks.  An empty
    matrix keeps one zero block at (0, 0).

    ``slots[r, j]`` is the index of block row r's j-th stored block, or
    ``nblocks`` (a zero block) past the row's last: the products sum a
    block row along the padded axis of ``slots``, in stored order, with
    no atomics."""

    data: torch.Tensor        # (nblocks, bs, bs)
    block_cols: torch.Tensor  # (nblocks,) int64 block-column ids
    block_rows: torch.Tensor  # (nblocks,) int64 block-row ids, ascending
    shape: Tuple[int, int]    # padded element shape (multiples of bs)
    blocksize: int
    slots: torch.Tensor       # (block rows, most blocks in a row) int64

    @property
    def nnz(self) -> int:
        return int(self.data.numel())

    @property
    def dtype(self):
        return self.data.dtype


@dataclasses.dataclass(frozen=True)
class Diagonal:
    """Diagonal matrix; matvec is a single elementwise multiply."""

    diag: torch.Tensor  # (n,)

    @property
    def shape(self):
        n = int(self.diag.shape[0])
        return (n, n)

    @property
    def dtype(self):
        return self.diag.dtype


# Kernel B5's tiles (csrc/csr_spmv.cu): a block of TILE_THREADS threads
# takes TILE_THREADS * k stored entries (k = 1..4), TILE_HALO entries past
# them, and the rows that start in them.
TILE_THREADS = 256
MAX_TILE = 1024
TILE_HALO = 32
# Tiles grow past TILE_THREADS entries only beyond this many tiles: on the
# H100 an empty kernel of 256 threads lasts 3.4 us on 4279 blocks, 1.7 on
# 1427 and 0.8-1.0 on up to 274 (``tools/b5_quick.py --tiles``), so past
# ~2048 blocks their dispatch costs more than the small tiles hide.
TILE_BLOCKS = 2048


def csr_tile(nnz: int) -> int:
    """Stored entries a tile: the smallest multiple of TILE_THREADS (at most
    MAX_TILE) that makes at most TILE_BLOCKS tiles."""
    k = -(-int(nnz) // (TILE_THREADS * TILE_BLOCKS))
    return min(MAX_TILE, TILE_THREADS * max(1, k))


def csr_tiles(indptr, tile: int) -> np.ndarray:
    """B5's row split: for tile t (entries t*tile ..), the first row that
    starts at or after entry t*tile, then the row count.  Tile t sums rows
    tiles[t] .. tiles[t+1]-1; a row starts in the tile that sums it (an
    empty row at its place; trailing empty rows in the last tile).  There
    is one tile for every ``tile`` entries, and one if there are none."""
    indptr = np.asarray(indptr, np.int64)
    nrows, nnz = len(indptr) - 1, int(indptr[-1])
    ntiles = max(1, -(-nnz // tile))
    starts = np.searchsorted(indptr[:nrows], np.arange(ntiles) * tile,
                             side="left")
    return np.append(starts, nrows).astype(np.int64)


def _csr_parts(sm, dtype: torch.dtype, device):
    """The CSR fields of a canonical scipy CSR matrix (no transpose)."""
    nrows, ncols = sm.shape
    if sm.nnz >= 2 ** 31 or ncols >= 2 ** 31:
        raise ValueError(f"CSR of shape {sm.shape} with {sm.nnz} entries "
                         "exceeds int32 column indices")
    return dict(
        data=upload(np.asarray(sm.data, np.float64), device, dtype),
        indices=upload(np.asarray(sm.indices, np.int32), device),
        indptr=upload(np.asarray(sm.indptr, np.int64), device),
        shape=(int(nrows), int(ncols)),
        tiles=upload(csr_tiles(sm.indptr, csr_tile(sm.nnz)), device),
        tile=csr_tile(sm.nnz))


def _to_scipy_csr(mat, dtype, device):
    """A canonical copy of a scipy sparse or 2-D dense matrix as CSR, and
    the torch dtype (default: the matrix's own, f64 unless it is f32) and
    device (default: the CUDA card) to build on."""
    import scipy.sparse as sp

    if sp.issparse(mat):
        sm = mat.tocsr(copy=True)
    else:
        arr = np.asarray(mat)
        if arr.ndim != 2:
            raise ValueError(f"expected 2-D matrix, got shape {arr.shape}")
        sm = sp.csr_matrix(arr)
    sm.sum_duplicates()
    sm.sort_indices()
    if dtype is None:
        dtype = (np.float32 if sm.dtype == np.float32 else np.float64)
    return sm, torch_dtype(dtype), resolve_device(device)


def csr_from_scipy(mat, dtype=None, device=None, transpose: bool = True,
                   pad_to: int | None = None) -> CSR:
    """Build a ``CSR`` on ``device`` (default the CUDA card) in ``dtype``
    (default the matrix's own) from a scipy sparse or dense matrix;
    ``transpose=False`` leaves out the transpose (a matrix only ever
    multiplied from the left, such as the symmetric K_P).  ``pad_to``
    appends inert entries (value 0, column 0) to the last row up to that
    many stored entries, as the JAX package pads to a static size; the
    transpose is not padded."""
    import scipy.sparse as sp

    sm, dtype, device = _to_scipy_csr(mat, dtype, device)
    t = None
    if transpose:
        st = sm.T.tocsr()
        st.sum_duplicates()
        st.sort_indices()
        t = CSR(**_csr_parts(st, dtype, device))
    pad = (pad_to or 0) - sm.nnz
    if pad > 0 and sm.shape[0]:
        indptr = sm.indptr.astype(np.int64)
        indptr[-1] += pad
        sm = sp.csr_matrix(
            (np.concatenate([sm.data, np.zeros(pad, sm.data.dtype)]),
             np.concatenate([sm.indices, np.zeros(pad, sm.indices.dtype)]),
             indptr), shape=sm.shape)
    return CSR(**_csr_parts(sm, dtype, device), t=t)


def csr_to_scipy(mat: CSR):
    """The scipy CSR matrix of a ``CSR``, its zero (padding) entries
    dropped."""
    import scipy.sparse as sp

    data = mat.data.detach().cpu().numpy()
    cols = mat.indices.cpu().numpy()
    indptr = mat.indptr.cpu().numpy()
    rows = np.repeat(np.arange(mat.shape[0]), np.diff(indptr))
    keep = data != 0
    return sp.csr_matrix((data[keep], (rows[keep], cols[keep])),
                         shape=mat.shape)


def ell_from_scipy(mat, dtype=None, device=None,
                   row_width: int | None = None, lane_pad: int = 1) -> ELL:
    """Build an ``ELL`` on ``device`` (default the CUDA card) in ``dtype``
    (default the matrix's own) from a scipy sparse or dense matrix.

    ``row_width`` pads rows to at least that many slots; ``lane_pad``
    rounds the row count up to a multiple of it (the padded rows are
    empty; a product returns only the matrix's own rows)."""
    sm, dtype, device = _to_scipy_csr(mat, dtype, device)
    nrows, ncols = sm.shape
    counts = np.diff(sm.indptr)
    k = max(int(counts.max()) if counts.size else 0, row_width or 0, 1)
    nrows_pad = -(-max(nrows, 1) // lane_pad) * lane_pad
    data = np.zeros((nrows_pad, k), dtype=np.float64)
    cols = np.zeros((nrows_pad, k), dtype=np.int64)
    if sm.nnz:
        rows = np.repeat(np.arange(nrows), counts)
        offs = np.arange(sm.nnz) - np.repeat(sm.indptr[:-1], counts)
        data[rows, offs] = sm.data
        cols[rows, offs] = sm.indices
    return ELL(data=upload(data, device, dtype),
               cols=upload(cols, device),
               shape=(int(nrows), int(ncols)))


def bsr_slots(block_rows, nbrows: int) -> np.ndarray:
    """The (block rows, most blocks in a row) index of ``BSR.slots`` for
    blocks sorted by block row: each row's blocks in stored order, then
    the pad index (the block count)."""
    block_rows = np.asarray(block_rows, np.int64)
    nb = block_rows.shape[0]
    counts = np.bincount(block_rows, minlength=nbrows)
    width = max(int(counts.max()) if counts.size else 0, 1)
    slots = np.full((nbrows, width), nb, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slots[block_rows, np.arange(nb) - starts[block_rows]] = np.arange(nb)
    return slots


def bsr_parts(data, block_cols, block_rows, shape, blocksize: int,
              dtype: torch.dtype, device) -> BSR:
    """A ``BSR`` on ``device`` from its numpy fields (blocks sorted by
    block row)."""
    block_rows = np.asarray(block_rows, np.int64)
    if np.any(np.diff(block_rows) < 0):
        raise ValueError("BSR blocks must be sorted by block row")
    bs = int(blocksize)
    return BSR(
        data=upload(np.array(data, np.float64), device, dtype),
        block_cols=upload(np.asarray(block_cols, np.int64), device),
        block_rows=upload(block_rows, device),
        shape=(int(shape[0]), int(shape[1])), blocksize=bs,
        slots=upload(bsr_slots(block_rows, int(shape[0]) // bs), device))


def bsr_from_scipy(mat, blocksize: int = 8, dtype=None,
                   device=None) -> BSR:
    """Build a ``BSR`` on ``device`` (default the CUDA card) in ``dtype``
    (default the matrix's own) from a scipy sparse or dense matrix.

    The element shape is padded up to multiples of ``blocksize``; scipy's
    own BSR conversion finds the occupied blocks."""
    sm, dtype, device = _to_scipy_csr(mat, dtype, device)
    nrows, ncols = sm.shape
    bs = int(blocksize)
    rpad = -(-nrows // bs) * bs
    cpad = -(-ncols // bs) * bs
    if (rpad, cpad) != (nrows, ncols):
        sm.resize((rpad, cpad))
    sb = sm.tobsr(blocksize=(bs, bs))
    sb.sum_duplicates()
    data = np.asarray(sb.data)
    block_rows = np.repeat(np.arange(rpad // bs, dtype=np.int64),
                           np.diff(sb.indptr))
    block_cols = np.asarray(sb.indices, np.int64)
    if data.shape[0] == 0:          # one explicit zero block
        data = np.zeros((1, bs, bs))
        block_rows = np.zeros(1, np.int64)
        block_cols = np.zeros(1, np.int64)
    return bsr_parts(data, block_cols, block_rows, (rpad, cpad), bs,
                     dtype, device)
