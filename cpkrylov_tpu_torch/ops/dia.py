"""DIA — diagonal sparse storage for banded matrices, and its plain products.

Port of ``cpkrylov_tpu/ops/dia.py`` (natural order only).  Stored by
diagonal, SpMV is ``y = sum_k data[k] * shift(x, offset_k)``: no index
metadata, ``ndiag * nrows`` values read per product.  On a CUDA tensor the
product runs in the hand-written kernel (``ops/cuda_dia.py``); the functions
here are its plain PyTorch version, which CPU tensors use and which the
kernel is checked against.

Whether a matrix is stored as DIA is decided by its structure alone: the
padded diagonals may hold at most ``max_fill_ratio`` slots per stored entry.
The default 4.5 is the JAX package's f32 gate (padded bytes <= 1.5x the
12 bytes per entry of its CSR) counted in slots, so f32 and f64 get the same
layout on every device.

Packing is done where the operand will live: the host only makes the matrix
a canonical CSR (:func:`upload_csr`) and uploads its three arrays, and
:func:`place_dia` finds the diagonals and places the values with tensor
operations on their device.  It serves every DIA pack of the port: the f64
and f32 ``DIA`` here, and the df64 pairs of ``ops/df64.py`` (also of a
transpose, from the same uploaded arrays).  The blocked triangular factor
(``precond/trisolve.py::build_block_tri``) is placed the same way, from
:func:`upload_csr` and :func:`csr_rows`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import scipy.sparse as sp
import torch
import torch.nn.functional as F

from ..utils.device import upload
from ..utils.profiling import count

MAX_FILL_RATIO = 4.5


@dataclasses.dataclass(frozen=True)
class DIA:
    """Sparse matrix stored by diagonals (square or rectangular).

    ``data[k, i] = M[i, i + offsets[k]]`` (zero where out of range or not
    stored); offsets are column minus row, ascending.  ``offsets_t`` holds
    the same offsets as an int64 tensor on the data's device (the kernel's
    operand).
    """

    data: torch.Tensor          # (ndiag, nrows), contiguous
    offsets: Tuple[int, ...]
    offsets_t: torch.Tensor     # (ndiag,) int64
    shape: Tuple[int, int]
    nnz: int = 0

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def ndiag(self) -> int:
        return len(self.offsets)


@dataclasses.dataclass(frozen=True)
class CSRArrays:
    """A canonical CSR's arrays on a device: ``indptr`` and ``indices`` in
    the host's own integer dtype, ``data`` as f64."""

    indptr: torch.Tensor      # (nrows + 1,)
    indices: torch.Tensor     # (nnz,) column indices, ascending in a row
    data: torch.Tensor        # (nnz,) f64 values
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])


def upload_csr(mat, device) -> CSRArrays:
    """``mat`` as a canonical CSR (rows sorted, duplicates summed by
    scipy) with its arrays on ``device``.  A ``csr_matrix`` is taken as it
    is when scipy's flag on it says it is canonical (the flag is checked
    once and kept on the matrix); anything else is canonicalized on a
    copy."""
    csr = mat if isinstance(mat, sp.csr_matrix) else sp.csr_matrix(mat)
    if not csr.has_canonical_format:
        csr = csr.copy()
        csr.sum_duplicates()
    return CSRArrays(indptr=upload(csr.indptr, device),
                     indices=upload(csr.indices, device),
                     data=upload(csr.data, device, torch.float64),
                     shape=(int(csr.shape[0]), int(csr.shape[1])))


def csr_rows(csr: CSRArrays) -> torch.Tensor:
    """Each stored entry's row, int64, on the arrays' device (no value is
    read back)."""
    return torch.repeat_interleave(
        torch.arange(csr.shape[0], device=csr.data.device),
        csr.indptr.diff(), output_size=csr.nnz)


def place_dia(csr: CSRArrays, max_slots: float,
              forms: Callable[[torch.Tensor], Tuple[torch.Tensor, ...]],
              transpose: bool = False):
    """Place the entries of ``csr`` (of its transpose if ``transpose``) by
    diagonals, on ``csr``'s device.

    Returns ``(offsets, offsets_t, stacks)``: the distinct offsets col - row
    ascending, as a tuple and as an int64 tensor, and for each tensor of
    ``forms(csr.data)`` a zeroed ``(ndiag, nrows)`` stack holding each
    entry's form at ``[k, row]``.  Explicit zeros count as entries; a matrix
    with none gets the single offset 0.  None when ``ndiag * nrows`` would
    exceed ``max_slots``.  The offsets are the one value read back.  On a
    CUDA device it counts ``dia_card_packs`` or ``dia_gate_refusals``
    (``utils/profiling.py``)."""
    nrows, ncols = csr.shape[::-1] if transpose else csr.shape
    dev = csr.data.device
    if csr.nnz:
        rows = csr_rows(csr)
        cols = csr.indices.long()
        if transpose:
            rows, cols = cols, rows
        shifted = cols - rows + (nrows - 1)     # in [0, nrows + ncols - 1)
        present = torch.zeros(nrows + ncols - 1, dtype=torch.bool,
                              device=dev)
        present[shifted] = True
        offsets_t = torch.nonzero(present).squeeze(1) - (nrows - 1)
        offsets = tuple(offsets_t.tolist())
        if len(offsets) * nrows > max_slots:
            if dev.type == "cuda":
                count("dia_gate_refusals")
            return None
        slot = torch.cumsum(present, 0) - 1
        flat = slot[shifted] * nrows + rows
    else:
        offsets = (0,)
        offsets_t = torch.zeros(1, dtype=torch.int64, device=dev)
    stacks = []
    for vals in forms(csr.data):
        out = torch.zeros((len(offsets), nrows), dtype=vals.dtype,
                          device=dev)
        if csr.nnz:
            out.view(-1)[flat] = vals
        stacks.append(out)
    if dev.type == "cuda":
        count("dia_card_packs")
    return offsets, offsets_t, tuple(stacks)


def pack_dia(mat, dtype: torch.dtype, device,
             max_fill_ratio: float = MAX_FILL_RATIO) -> DIA | None:
    """Pack a scipy matrix by diagonals on ``device``; None when the padded
    diagonals would hold more than ``max_fill_ratio`` slots per stored entry
    (0 = no limit).  f32 rounds each value to nearest."""
    csr = upload_csr(mat, device)
    max_slots = max_fill_ratio * csr.nnz if max_fill_ratio > 0 else math.inf
    placed = place_dia(csr, max_slots, lambda v: (v.to(dtype),))
    if placed is None:
        return None
    offsets, offsets_t, (data,) = placed
    return DIA(data=data, offsets=offsets, offsets_t=offsets_t,
               shape=csr.shape, nnz=csr.nnz)


def pack_sym_dia(mat, dtype: torch.dtype, device,
                 max_fill_ratio: float = MAX_FILL_RATIO) -> DIA | None:
    """Pack a square scipy matrix by diagonals in natural order.

    A saddle-point K_P = [G B'; B -C] with banded blocks is diagonal-sparse
    in natural order (the B/B' blocks sit on offsets near +-n).  None when
    the matrix is not square or fails the fill gate; the JAX package's RCM
    and spill fallbacks are not ported, so the caller then keeps CSR.
    """
    csr = sp.csr_matrix(mat)
    if csr.shape[0] != csr.shape[1]:
        return None
    return pack_dia(csr, dtype=dtype, device=device,
                    max_fill_ratio=max_fill_ratio)


def _pads(mat: DIA):
    """Left/right padding of the operand so every shifted slice is valid."""
    nrows, ncols = mat.shape
    neg = max(0, -min(mat.offsets))
    pos = max(0, max(mat.offsets) + nrows - ncols)
    return neg, pos


def dia_matvec(mat: DIA, x: torch.Tensor) -> torch.Tensor:
    """y = mat @ x as a chain of shifted multiply-adds, ascending k."""
    nrows = mat.shape[0]
    neg, pos = _pads(mat)
    xp = F.pad(x, (neg, pos))
    d = mat.data.to(x.dtype)
    acc = torch.zeros(nrows, dtype=x.dtype, device=x.device)
    for k, off in enumerate(mat.offsets):
        s = neg + off
        acc = acc + d[k] * xp[s: s + nrows]
    return acc


def dia_rmatvec(mat: DIA, y: torch.Tensor) -> torch.Tensor:
    """x = mat.T @ y.  M.T's diagonal at offset -o holds ``data[k]`` shifted
    by o, so each term is a shifted add of the elementwise product."""
    nrows, ncols = mat.shape
    neg, pos = _pads(mat)
    d = mat.data.to(y.dtype)
    acc = torch.zeros(ncols + neg + pos, dtype=y.dtype, device=y.device)
    for k, off in enumerate(mat.offsets):
        s = neg + off
        acc[s: s + nrows] = acc[s: s + nrows] + d[k] * y
    return acc[neg: neg + ncols]
