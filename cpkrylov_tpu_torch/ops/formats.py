"""Sparse matrix containers as frozen dataclasses of tensors.

Port of ``cpkrylov_tpu/ops/formats.py`` (CSR and Diagonal).  ``CSR`` is the
operand of kernel B5 (``ops/cuda_spmv.py``), which serves every matrix that
fails the DIA gate: int64 row pointers, int32 column indices and the values,
each row in stored column order; the row split of B5's tiles (``tiles``:
the first row that starts in each tile of ``tile`` stored entries,
``csr_tiles``); and, for ``rmatvec``, the CSR of the transpose, packed once,
so that ``M^T y`` is the same kernel with no atomics.  ``Diagonal`` is
C = delta*I.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


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
        data=torch.as_tensor(np.asarray(sm.data, np.float64)).to(
            device=device, dtype=dtype),
        indices=torch.as_tensor(np.asarray(sm.indices, np.int32),
                                device=device),
        indptr=torch.as_tensor(np.asarray(sm.indptr, np.int64),
                               device=device),
        shape=(int(nrows), int(ncols)),
        tiles=torch.as_tensor(csr_tiles(sm.indptr, csr_tile(sm.nnz)),
                              device=device),
        tile=csr_tile(sm.nnz))


def csr_from_scipy(mat, dtype: torch.dtype, device,
                   transpose: bool = True) -> CSR:
    """Build a ``CSR`` on ``device`` from a scipy sparse or dense matrix;
    ``transpose=False`` leaves out the transpose (a matrix only ever
    multiplied from the left, such as the symmetric K_P)."""
    import scipy.sparse as sp

    sm = (mat.tocsr() if sp.issparse(mat)
          else sp.csr_matrix(np.asarray(mat)))
    sm = sm.copy()
    sm.sum_duplicates()
    sm.sort_indices()
    t = None
    if transpose:
        st = sm.T.tocsr()
        st.sum_duplicates()
        st.sort_indices()
        t = CSR(**_csr_parts(st, dtype, device))
    return CSR(**_csr_parts(sm, dtype, device), t=t)
