"""This rank's row blocks of the saddle-point system.

Counterpart of ``cpkrylov_tpu/parallel/partition.py``.  The blocks A
(n x n), B (m x n), B' (n x m) and C (m x m) are 1-D row-partitioned over
the ranks, the paired vectors (n-part, m-part) are sliced the same way, and
scalar recurrence state is replicated.  Row counts are padded as in the JAX
package (``n_loc = ceil(n / ndev)``; padding rows are all zero), but each
rank builds only its own blocks, with global column indices, in the port's
own formats chosen by its structural rule (``ops/spmv.py``): DIA (kernel
B1) where the padded diagonals pass the fill gate, else CSR (kernel B5).
The JAX package's stacked ELL exists for ``shard_map`` and is not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.dia import pack_dia
from ..ops.formats import csr_from_scipy
from ..utils.device import torch_dtype


def loc_size(size: int, ndev: int) -> int:
    """Padded slice length of a vector of ``size`` entries over ``ndev``."""
    return -(-size // ndev)


def pack_block(mat, dtype, device):
    """A host block on the device, left-multiplied only: DIA when its
    diagonals pass the fill gate, else CSR without the transpose."""
    packed = pack_dia(mat, dtype=dtype, device=device)
    if packed is None:
        packed = csr_from_scipy(mat, dtype=dtype, device=device,
                                transpose=False)
    return packed


def row_slice(mat, rank: int, rows_loc: int) -> sp.csr_matrix:
    """Rows [rank * rows_loc, (rank + 1) * rows_loc) of ``mat``, padded with
    zero rows to ``rows_loc``, columns as they are."""
    csr = sp.csr_matrix(mat)
    r0 = min(csr.shape[0], rank * rows_loc)
    blk = csr[r0: min(csr.shape[0], r0 + rows_loc)].tocsr()
    blk.resize((rows_loc, csr.shape[1]))
    blk.sum_duplicates()
    return blk


@dataclasses.dataclass(frozen=True)
class PartitionedBlocks:
    """This rank's row blocks of (A, B, B', C) with global column indices.

    Shapes: ``a`` (n_loc, n), ``b`` (m_loc, n), ``bt`` (n_loc, m), ``c``
    (m_loc, m), each a DIA or CSR on the rank's device."""

    a: object
    b: object
    bt: object
    c: object
    n: int
    m: int
    n_loc: int
    m_loc: int
    rank: int
    ndev: int


def partition_blocks(A, B, C, comm, dtype=torch.float64) -> PartitionedBlocks:
    """This rank's row blocks of A, B, B' and C on ``comm.device``."""
    dtype = torch_dtype(dtype)
    n, m = A.shape[0], C.shape[0]
    ndev, rank = comm.size, comm.rank
    n_loc, m_loc = loc_size(n, ndev), loc_size(m, ndev)
    B = sp.csr_matrix(B)

    def blk(mat, rows_loc):
        return pack_block(row_slice(mat, rank, rows_loc), dtype,
                          comm.device)

    return PartitionedBlocks(
        a=blk(A, n_loc), b=blk(B, m_loc), bt=blk(B.T.tocsr(), n_loc),
        c=blk(C, m_loc), n=int(n), m=int(m), n_loc=int(n_loc),
        m_loc=int(m_loc), rank=int(rank), ndev=int(ndev))


def shard_vector(v, comm, loc: int, dtype=None) -> torch.Tensor:
    """This rank's slice of the host vector ``v``, zero-padded to ``loc``,
    on ``comm.device``."""
    v = np.asarray(v).reshape(-1)
    out = np.zeros(loc, dtype=v.dtype)
    r0 = min(v.shape[0], comm.rank * loc)
    piece = v[r0: min(v.shape[0], r0 + loc)]
    out[: piece.shape[0]] = piece
    t = torch.as_tensor(out)
    return t.to(device=comm.device,
                dtype=torch_dtype(dtype) if dtype is not None else t.dtype)


def unshard_vector(v_loc: torch.Tensor, size: int, comm) -> torch.Tensor:
    """The full vector of ``size`` entries from every rank's slice (an
    all-gather; every rank gets it)."""
    return comm.all_gather_vec(v_loc, size)
