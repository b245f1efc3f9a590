"""Halo-exchange SpMV for row-partitioned blocks.

Counterpart of ``cpkrylov_tpu/parallel/halo.py``.  Instead of all-gathering
the whole operand vector for a product, each rank exchanges only the edge
regions its neighbours' rows reference.  The plan is the JAX package's,
computed on the host:

* the operand x of length ``cols`` is cut into ``ndev`` chunks of
  ``cols_loc``;
* the halo width H is the largest reach of any row outside its rank's
  chunk, over all ranks (so neighbours agree on it); a reach wider than
  ``max_halo`` (default the chunk) raises ValueError, and the caller falls
  back to the all-gather;
* column indices are rewritten into extended-vector coordinates
  ``H + (c - d * cols_loc)``;
* at run time the left and right edges travel by one neighbour exchange
  (``Comm.neighbor_exchange``), and the product reads
  ``x_ext = [left halo | x_loc | right halo]`` through the port's SpMV
  kernel (B1 on DIA, B5 on CSR).

For banded systems the edges are tens of entries against megabytes of
local SpMV traffic, so the exchange is small whether or not it overlaps.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..ops import spmv
from ..utils.device import torch_dtype
from .partition import pack_block


@dataclasses.dataclass(frozen=True)
class HaloBlock:
    """This rank's row block with halo-relative column indices.

    ``local`` is the host block (``rows_loc`` x ``halo + cols_loc +
    halo``, padding rows zero) and ``mat`` its device form (DIA or CSR),
    which multiplies the extended operand."""

    local: sp.csr_matrix
    mat: object
    halo: int
    rows_loc: int
    cols_loc: int
    shape: Tuple[int, int]


def halo_width(csr: sp.csr_matrix, rows_loc: int, cols_loc: int) -> int:
    """The largest off-chunk reach of any row, over all ranks."""
    if not csr.nnz:
        return 0
    coo = csr.tocoo()
    dev = coo.row.astype(np.int64) // rows_loc
    lo_reach = dev * cols_loc - coo.col
    hi_reach = coo.col - ((dev + 1) * cols_loc - 1)
    return int(max(0, lo_reach.max(), hi_reach.max()))


def plan_halo_block(mat, comm, rows_loc: int, cols_loc: int,
                    dtype=torch.float64, max_halo: int | None = None
                    ) -> HaloBlock:
    """This rank's ``HaloBlock``; raises ValueError if the needed halo
    exceeds ``max_halo`` (default: the chunk size, beyond which one
    neighbour's chunk cannot cover it)."""
    csr = sp.csr_matrix(mat)
    csr.sum_duplicates()
    nrows, ncols = csr.shape
    if max_halo is None:
        max_halo = cols_loc
    halo = halo_width(csr, rows_loc, cols_loc)
    if halo > min(max_halo, cols_loc):
        raise ValueError(
            f"halo width {halo} exceeds max {min(max_halo, cols_loc)}; "
            "use all-gather")
    d = comm.rank
    r0 = min(nrows, d * rows_loc)
    blk = csr[r0: min(nrows, r0 + rows_loc)].tocoo()
    local = sp.csr_matrix(
        (blk.data, (blk.row, halo + (blk.col.astype(np.int64)
                                     - d * cols_loc))),
        shape=(rows_loc, 2 * halo + cols_loc))
    local.sum_duplicates()
    return HaloBlock(local=local,
                     mat=pack_block(local, torch_dtype(dtype), comm.device),
                     halo=int(halo), rows_loc=int(rows_loc),
                     cols_loc=int(cols_loc), shape=(int(nrows), int(ncols)))


def halo_extend(x_loc: torch.Tensor, halo: int, comm) -> torch.Tensor:
    """``[left halo | x_loc | right halo]`` by one neighbour exchange; the
    ends of the row of ranks receive zeros (a valid plan never reads
    them)."""
    if halo == 0:
        return x_loc
    left, right = comm.neighbor_exchange(x_loc[:halo], x_loc[-halo:])
    return torch.cat([left, x_loc, right])


def halo_matvec(blk: HaloBlock, x_ext: torch.Tensor) -> torch.Tensor:
    """The local product against the extended operand (B1 or B5)."""
    return spmv.matvec(blk.mat, x_ext)


def halo_fold(x_ext: torch.Tensor, halo: int, comm) -> torch.Tensor:
    """Adjoint of :func:`halo_extend`: add the extended vector's edge
    regions onto the neighbours that own them.  Rank d's left margin
    belongs to the tail of rank d - 1, its right margin to the head of rank
    d + 1; the ends of the row of ranks send nothing across."""
    if halo == 0:
        return x_ext
    center = x_ext[halo:-halo].clone()
    from_left, from_right = comm.neighbor_exchange(x_ext[:halo],
                                                   x_ext[-halo:])
    center[:halo] += from_left
    center[-halo:] += from_right
    return center
