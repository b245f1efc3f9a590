"""Sparse matrix containers as frozen dataclasses of tensors.

Port of ``cpkrylov_tpu/ops/formats.py`` (CSR and Diagonal).  ``CSR`` keeps
the JAX package's row-sorted COO + indptr layout, so a matvec is a gather, a
multiply and a row-wise sum; the main path does not use it (it serves
matrices that do not pack as DIA).  ``Diagonal`` is C = delta*I.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix (row-sorted COO + indptr)."""

    data: torch.Tensor      # (nnz,) values
    indices: torch.Tensor   # (nnz,) int64 column indices
    row_ids: torch.Tensor   # (nnz,) int64 row indices, ascending
    indptr: torch.Tensor    # (nrows + 1,) int64
    shape: Tuple[int, int]

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


def csr_from_scipy(mat, dtype: torch.dtype, device) -> CSR:
    """Build a ``CSR`` on ``device`` from a scipy sparse or dense matrix."""
    import scipy.sparse as sp

    sm = (mat.tocsr() if sp.issparse(mat)
          else sp.csr_matrix(np.asarray(mat)))
    sm = sm.copy()
    sm.sum_duplicates()
    nrows, ncols = sm.shape
    indptr = np.asarray(sm.indptr, dtype=np.int64)
    row_ids = np.repeat(np.arange(nrows, dtype=np.int64), np.diff(indptr))
    return CSR(
        data=torch.as_tensor(np.asarray(sm.data, np.float64)).to(
            device=device, dtype=dtype),
        indices=torch.as_tensor(np.asarray(sm.indices, np.int64),
                                device=device),
        row_ids=torch.as_tensor(row_ids, device=device),
        indptr=torch.as_tensor(indptr, device=device),
        shape=(int(nrows), int(ncols)),
    )
