"""Host-side matrix IO: MATLAB .mat and MatrixMarket loaders and writer.

Port of ``cpkrylov_tpu/ops/io.py``, with the same return types: scipy CSR
matrices ready for the device containers of ``formats.py`` / ``dia.py``.
The reference ships .mat fixtures and loads them with MATLAB ``load``
(examples/cpk_exprog1.m:45-46).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def load_mat(path: str):
    """Load a MATLAB .mat file: a dict of its variables, sparse matrices as
    ``csr_matrix``, 1-element arrays as Python scalars, others as arrays."""
    import scipy.io as sio

    raw = sio.loadmat(path)
    out = {}
    for k, v in raw.items():
        if k.startswith("__"):
            continue
        if sp.issparse(v):
            out[k] = v.tocsr()
        else:
            arr = np.asarray(v)
            out[k] = arr.item() if arr.size == 1 else arr
    return out


def load_matrix_market(path: str) -> sp.csr_matrix:
    """Load a MatrixMarket .mtx file (symmetric storage expanded)."""
    from scipy.io import mmread

    return sp.csr_matrix(mmread(path))


def save_matrix_market(path: str, mat) -> None:
    """Write a sparse or dense matrix as a MatrixMarket coordinate file."""
    from scipy.io import mmwrite

    mmwrite(path, sp.coo_matrix(mat))
