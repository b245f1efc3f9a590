"""Sparse triangular solves by blocked forward substitution (plain PyTorch).

Port of the ``BlockTriFactor`` path of ``cpkrylov_tpu/precond/trisolve.py``.
It serves factors whose subdiagonal reach exceeds 1 (RCM-ordered general KKT
factors such as ``cvxqp1_m``); reach-1 factors take the bidiagonal scan
kernel (``cuda_bidiag.py``).  The factor is blocked into ``panel``-row panels
whose dense inverses are computed once on the host; the solve is the
sequential loop

    x[blk] = inv_diag[blk] @ (b[blk] - L_off[blk, :] @ x)

over ``n / panel`` panels.  An upper-triangular solve is the same loop on
the index-reversed matrix (J U J is lower triangular for the reversal J).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BlockTriFactor:
    """Lower-triangular factor prepared for blocked substitution."""

    inv_diag: torch.Tensor  # (nblocks, panel, panel) dense inverses
    off_data: torch.Tensor  # (n_pad, K) entries strictly left of the panel
    off_cols: torch.Tensor  # (n_pad, K) int64
    n: int
    panel: int

    @property
    def nblocks(self) -> int:
        return int(self.inv_diag.shape[0])


def _invert_panels_f(diag_f: np.ndarray) -> np.ndarray:
    """Invert a stack of lower-triangular panels stored as an F-ordered
    (panel, panel, nblocks) array, slice by slice (LAPACK trtri wants
    Fortran-contiguous slices); small panels take one batched ``inv``."""
    from scipy.linalg import get_lapack_funcs

    p, nb = diag_f.shape[0], diag_f.shape[2]
    if p <= 64 and nb > 256:
        stack = np.ascontiguousarray(diag_f.transpose(2, 0, 1))
        try:
            inv = np.linalg.inv(stack)
        except np.linalg.LinAlgError as exc:
            raise ZeroDivisionError(f"singular diagonal panel ({exc})")
        diag_f[:] = inv.transpose(1, 2, 0)
        return diag_f
    trtri, = get_lapack_funcs(("trtri",), (diag_f[:, :, 0],))
    for b in range(nb):
        out, info = trtri(diag_f[:, :, b], lower=1, overwrite_c=1)
        if info != 0:
            raise ZeroDivisionError(
                f"singular diagonal panel {b} (trtri info={info})")
        if not np.shares_memory(out, diag_f):
            diag_f[:, :, b] = out
    return diag_f


def build_block_tri(T, dtype: torch.dtype, device,
                    panel: int = 256) -> BlockTriFactor:
    """Prepare a scipy lower-triangular matrix (explicit nonzero diagonal;
    pass ``L + I`` for unit-diagonal factors).  Vectorized numpy packing."""
    import scipy.sparse as sp

    T = sp.csr_matrix(T)
    T.sum_duplicates()
    coo = T.tocoo()
    er, ec, ev = (coo.row.astype(np.int64), coo.col.astype(np.int64),
                  coo.data)
    n = T.shape[0]
    nblocks = max(1, -(-n // panel))
    n_pad = nblocks * panel

    blk = er // panel
    r_loc = er - blk * panel
    in_blk = ec >= blk * panel

    # Dense diagonal panels (padding rows solve to identity).
    diag_f = np.zeros((panel, panel, nblocks), dtype=np.float64, order="F")
    idx = np.arange(panel)
    diag_f[idx, idx, :] = 1.0
    d = in_blk
    diag_f[r_loc[d], ec[d] - blk[d] * panel, blk[d]] = ev[d]
    inv_diag = np.ascontiguousarray(_invert_panels_f(diag_f).transpose(2, 0, 1))
    del diag_f

    # Off-panel entries in ELL layout: position within row via cumcount.
    o = ~in_blk
    orow, ocol, oval = er[o], ec[o], ev[o]
    counts = np.bincount(orow, minlength=n_pad)
    max_off = max(1, int(counts.max()) if counts.size else 1)
    order = np.argsort(orow, kind="stable")
    starts = np.zeros(n_pad + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(orow.size) - starts[orow[order]]
    off_data = np.zeros((n_pad, max_off), dtype=np.float64)
    off_cols = np.zeros((n_pad, max_off), dtype=np.int64)
    off_data[orow[order], pos] = oval[order]
    off_cols[orow[order], pos] = ocol[order]

    def dev(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    return BlockTriFactor(
        inv_diag=dev(inv_diag), off_data=dev(off_data),
        off_cols=torch.as_tensor(off_cols, device=device),
        n=int(n), panel=int(panel))


def build_block_tri_upper(U, dtype: torch.dtype, device,
                          panel: int = 256) -> BlockTriFactor:
    """Prepare an upper-triangular matrix by building its reversal; the
    caller flips the vector around the solve (``FactorApply.solve``)."""
    import scipy.sparse as sp

    U = sp.csr_matrix(U)
    rev = np.arange(U.shape[0] - 1, -1, -1)
    return build_block_tri(U[rev][:, rev].tocsr(), dtype=dtype,
                           device=device, panel=panel)


def block_tri_solve(tf: BlockTriFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve T x = b for the prepared lower-triangular factor."""
    panel = tf.panel
    n_pad = tf.nblocks * panel
    x = torch.zeros(n_pad, dtype=b.dtype, device=b.device)
    b_pad = torch.zeros(n_pad, dtype=b.dtype, device=b.device)
    b_pad[: tf.n] = b
    od_all = tf.off_data.to(b.dtype)
    inv_all = tf.inv_diag.to(b.dtype)
    for i in range(tf.nblocks):
        r0 = i * panel
        od = od_all[r0: r0 + panel]
        oc = tf.off_cols[r0: r0 + panel]
        contrib = (od * x[oc]).sum(dim=1)
        rhs = b_pad[r0: r0 + panel] - contrib
        x[r0: r0 + panel] = inv_all[i] @ rhs
    return x[: tf.n]


def tri_solve(tf, b: torch.Tensor) -> torch.Tensor:
    """Dispatch on the prepared factor kind."""
    from .cuda_bidiag import BidiagTriFactor, bidiag_tri_solve

    if isinstance(tf, BidiagTriFactor):
        return bidiag_tri_solve(tf, b)
    return block_tri_solve(tf, b)
