"""Sparse triangular solves: blocked forward substitution and the banded
reduced-state scan form.

Port of the ``BlockTriFactor`` and ``ReducedScanTriFactor`` paths of
``cpkrylov_tpu/precond/trisolve.py``.  Reach-1 factors take the bidiagonal
scan kernel (``cuda_bidiag.py``); ``precond/cp.py`` chooses between the two
forms here by the factor's structure.

*Blocked substitution* (``BlockTriFactor``) blocks the factor into
``panel``-row panels whose dense inverses are computed once on the host; the
solve is the sequential loop

    x[blk] = inv_diag[blk] @ (b[blk] - L_off[blk, :] @ x)

over ``n / panel`` panels.  On a CUDA tensor it runs as one launch of the
hand-written kernel B9 (``cuda_block_tri.py``), which walks the panels
itself; ``cuda_block_tri.block_tri_solve_plain`` is the plain PyTorch
loop.

*Reduced-state scan* (``ReducedScanTriFactor``) serves a factor whose
subdiagonal reach r is at most the panel p.  Panel i only reads the last r
entries s_{i-1} of panel i-1, so with c_i = inv_i b_i and W_i = inv_i S_i

    s_i = -W_i[p-r:] s_{i-1} + c_i[p-r:],      x_i = c_i - W_i s_{i-1}.

On a CUDA tensor it runs in the hand-written kernel B4 (``cuda_tri.py``),
whose scan is kernel B6; ``reduced_scan_tri_solve_plain`` is the plain
PyTorch version of the same math.

An upper-triangular solve is either form on the index-reversed matrix
(J U J is lower triangular for the reversal J).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import upload


@dataclasses.dataclass(frozen=True)
class BlockTriFactor:
    """Lower-triangular factor prepared for blocked substitution."""

    inv_diag: torch.Tensor  # (nblocks, panel, panel) dense inverses
    off_data: torch.Tensor  # (n_pad, K) entries strictly left of the panel
    off_cols: torch.Tensor  # (n_pad, K) int32 (n_pad < 2**31); 0 when empty
    off_counts: torch.Tensor  # (n_pad,) int32: a row's entries, in its
    #                           first off_counts[r] slots
    n: int
    panel: int

    @property
    def nblocks(self) -> int:
        return int(self.inv_diag.shape[0])

    @property
    def work_nnz(self) -> int:
        """Arithmetic volume of one solve (``utils.profiling.work_model``):
        the stored off-panel entries plus the dense panel inverses, as the
        JAX package counts it (trisolve.py:53)."""
        return (int(torch.count_nonzero(self.off_data))
                + self.nblocks * self.panel * self.panel)


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


def _coo_canonical(T):
    """Canonical (row, col, data) triplets of a scipy matrix, int64
    indices."""
    import scipy.sparse as sp

    T = sp.csr_matrix(T)
    T.sum_duplicates()
    coo = T.tocoo()
    return T, coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data


def build_block_tri(T, dtype: torch.dtype, device,
                    panel: int = 256) -> BlockTriFactor:
    """Prepare a scipy lower-triangular matrix (explicit nonzero diagonal;
    pass ``L + I`` for unit-diagonal factors).  Vectorized numpy packing."""
    T, er, ec, ev = _coo_canonical(T)
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
    if n_pad >= 1 << 31:
        raise ValueError(f"blocked substitution indexes with int32: n_pad "
                         f"= {n_pad} >= 2**31")
    off_data = np.zeros((n_pad, max_off), dtype=np.float64)
    off_cols = np.zeros((n_pad, max_off), dtype=np.int32)
    off_data[orow[order], pos] = oval[order]
    off_cols[orow[order], pos] = ocol[order]

    return BlockTriFactor(
        inv_diag=upload(inv_diag, device, dtype),
        off_data=upload(off_data, device, dtype),
        off_cols=upload(off_cols, device),
        off_counts=upload(counts.astype(np.int32), device),
        n=int(n), panel=int(panel))


@dataclasses.dataclass(frozen=True)
class ReducedScanTriFactor:
    """Banded lower factor for the reduced-state scan (kernel B4).

    Panel-major and row-major on the device, contiguous:
    ``inv_diag[i, j, k] = (T_ii^-1)[j, k]`` and ``w_blocks[i, j, k] =
    (T_ii^-1 S_i)[j, k]``, with S_i the last r columns of T's block (i, i-1)
    (``w_blocks[0] = 0``).  Every row the kernel reads is contiguous, so a
    warp streams it with coalesced loads.
    """

    inv_diag: torch.Tensor   # (nb, p, p)
    w_blocks: torch.Tensor   # (nb, p, r)
    n: int
    panel: int
    r: int

    @property
    def nblocks(self) -> int:
        return int(self.inv_diag.shape[0])

    @property
    def work_nnz(self) -> int:
        """Arithmetic volume of one solve, the JAX package's count for this
        form (trisolve.py:317): c = inv b and x = c - W s (nb (p^2 + p r))
        plus its scan's r^2 maps over log2(nb) levels.  Kernel B4 carries
        the scan sequentially (nb r^2); the count stays the reference's so
        that the two work models compare."""
        nb, p, r = self.nblocks, self.panel, self.r
        levels = max(1, int(np.ceil(np.log2(max(nb, 2)))))
        return nb * (p * p + p * r) + nb * r * r * levels


def pack_reduced_scan_np(T, panel: int = 128, r: int | None = None,
                         dtype=None):
    """Host packing of the reduced-state scan form (trisolve.py:346-389 of
    the JAX package, the same numbers): numpy ``(inv (nb, p, p), w (nb, p,
    r), n, panel, r)``, or None when the reach exceeds ``panel``.  Linear in
    nnz plus O(nb p^3) batched LAPACK/BLAS work."""
    T, er, ec, ev = _coo_canonical(T)
    n = T.shape[0]
    dtype = dtype or T.dtype
    reach = int((er - ec).max()) if ev.size else 0
    if reach > panel:
        return None
    if r is None:
        r = max(1, reach)
    r = min(r, panel)

    nblocks = max(1, -(-n // panel))
    blk = er // panel
    r_loc = er - blk * panel
    on_diag = (ec // panel) == blk

    diag_f = np.zeros((panel, panel, nblocks), dtype=np.float64, order="F")
    idx = np.arange(panel)
    diag_f[idx, idx, :] = 1.0
    d = on_diag
    diag_f[r_loc[d], ec[d] - blk[d] * panel, blk[d]] = ev[d]
    s = ~on_diag
    sub_c = np.zeros((nblocks, reach if reach else 1, r), dtype=np.float64)
    if s.any():
        sub_c[blk[s], r_loc[s], ec[s] - (blk[s] - 1) * panel - (panel - r)] \
            = ev[s]

    inv64 = _invert_panels_f(diag_f).transpose(2, 0, 1)   # (nb, p, p) view
    w = np.zeros((nblocks, panel, r), dtype=dtype)
    if nblocks > 1 and reach:
        prod = np.matmul(np.ascontiguousarray(inv64[1:, :, :reach]),
                         sub_c[1:])
        w[1:] = prod.astype(dtype)
    # row-major panels (the device layout) straight from the F-ordered stack
    return inv64.astype(dtype, order="C"), w, int(n), int(panel), int(r)


def reduced_scan_tri(inv, w, n: int, panel: int, r: int, dtype: torch.dtype,
                     device) -> ReducedScanTriFactor:
    """The factor on ``device`` from packed (nb, p, p) / (nb, p, r) arrays."""
    inv = torch.as_tensor(np.require(inv, requirements=["C", "W"]))
    w = torch.as_tensor(np.require(w, requirements=["C", "W"]))
    nb = int(inv.shape[0])
    if tuple(inv.shape) != (nb, panel, panel) or tuple(w.shape) != (
            nb, panel, r) or not 1 <= r <= panel:
        raise ValueError(f"inconsistent reduced-scan operands: inv "
                         f"{tuple(inv.shape)}, w {tuple(w.shape)}, panel "
                         f"{panel}, r {r}")
    if nb * panel < n:
        raise ValueError(f"{nb} panels of {panel} rows do not cover n={n}")
    return ReducedScanTriFactor(
        inv_diag=upload(inv, device, dtype).contiguous(),
        w_blocks=upload(w, device, dtype).contiguous(),
        n=int(n), panel=int(panel), r=int(r))


def build_reduced_scan_tri(T, dtype: torch.dtype, device, panel: int = 128,
                           r: int | None = None
                           ) -> ReducedScanTriFactor | None:
    """Prepare a banded scipy lower-triangular matrix for the reduced-state
    scan; None when its reach exceeds ``panel``."""
    npd = np.float32 if dtype == torch.float32 else np.float64
    packed = pack_reduced_scan_np(T, panel=panel, r=r, dtype=npd)
    if packed is None:
        return None
    inv, w, n, p, r = packed
    return reduced_scan_tri(inv, w, n, p, r, dtype, device)


def reduced_scan_tri_solve_plain(tf: ReducedScanTriFactor,
                                 b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the reduced-state scan solve
    (trisolve.py:324-343 of the JAX package): c = inv b, the inclusive
    scan s_i = -W_i[p-r:] s_{i-1} + c_i[p-r:] (``affine_scan_plain``, the
    plain version of kernel B6), then x = c - W s_prev."""
    from .cuda_tri import affine_scan_plain

    p, r, nb = tf.panel, tf.r, tf.nblocks
    b_pad = torch.zeros(nb * p, dtype=b.dtype, device=b.device)
    b_pad[: tf.n] = b
    c = torch.bmm(tf.inv_diag.to(b.dtype), b_pad.view(nb, p, 1)).view(nb, p)
    w = tf.w_blocks.to(b.dtype)
    s = affine_scan_plain((-w[:, p - r:, :]).permute(1, 2, 0),
                          c[:, p - r:].T)                     # (r, nb)
    s_prev = torch.cat([torch.zeros(r, 1, dtype=b.dtype, device=b.device),
                        s[:, :-1]], dim=1)
    x = c - torch.bmm(w, s_prev.T.unsqueeze(-1)).view(nb, p)
    return x.reshape(-1)[: tf.n]


def tri_solve(tf, b: torch.Tensor) -> torch.Tensor:
    """Dispatch on the prepared factor kind."""
    from .cuda_bidiag import BidiagTriFactor, bidiag_tri_solve
    from .cuda_block_tri import block_tri
    from .cuda_tri import band_tri_solve

    if isinstance(tf, BidiagTriFactor):
        return bidiag_tri_solve(tf, b)
    if isinstance(tf, ReducedScanTriFactor):
        return band_tri_solve(tf, b)
    return block_tri(tf, b)
