"""Sparse matrix containers as frozen dataclasses of tensors.

Port of ``cpkrylov_tpu/ops/formats.py`` (CSR and Diagonal).  ``CSR`` is the
operand of kernel B5 (``ops/cuda_spmv.py``), which serves every matrix that
fails the DIA gate: int64 row pointers, int32 column indices and the values,
each row in stored column order, and, for ``rmatvec``, the CSR of the
transpose, packed once, so that ``M^T y`` is the same kernel with no
atomics.  ``Diagonal`` is C = delta*I.
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
        shape=(int(nrows), int(ncols)))


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
