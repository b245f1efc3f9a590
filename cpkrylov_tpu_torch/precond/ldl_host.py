"""Host-side sparse factorization of the constraint preconditioner matrix.

Port of ``cpkrylov_tpu/precond/ldl_host.py``, numpy/scipy/ctypes only, so the
port never imports the JAX package.  K_P = [G B'; B -C] is factorized once on
the host by the native up-looking LDL^T (``native/ldl_kernel.cpp``, the same
source as the JAX package's, built by g++ into the port's build directory)
and the factors are then moved to the device as triangular-solve operands.

The native kernel pivots 1x1 and, through a restart scheme, adjacent 2x2
blocks (MA57-class, like the reference's MATLAB ``ldl``); pivots that still
fail are sign-regularized and counted in ``nperturbed``.

Backends:
  * ``"ldl"``  — native C++ LDL^T with 1x1 + adjacent 2x2 block pivots.
  * ``"lu"``   — scipy ``splu`` (robust fallback).
  * ``"auto"`` — try ``ldl``; fall back to ``lu`` on a numeric breakdown
    only.  A failed build of the native library raises.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class HostLDL:
    """K[perm][:, perm] = (I + L) B (I + L)^T, L strictly lower, B block
    diagonal: ``d`` the diagonal, ``e[p] != 0`` the off-diagonal of a 2x2
    pivot block at columns (p, p+1) (then L[p+1, p] = 0)."""

    perm: np.ndarray        # (n,) row/col permutation
    L: sp.csc_matrix        # strictly lower triangular (no unit diagonal)
    d: np.ndarray           # (n,) diagonal of B
    e: np.ndarray | None = None   # (n,) subdiagonal of B (None: all 1x1)
    nperturbed: int = 0
    n2x2: int = 0           # number of 2x2 pivot blocks used


@dataclasses.dataclass
class HostLU:
    """K[row_perm][:, col_scatter] = L U from scipy splu.

    Solve K y = z via  v = U^{-1} L^{-1} z[row_perm];  y[col_scatter] = v.
    (scipy convention: K[argsort(perm_r)][:, argsort(perm_c)] = L U.)
    """

    row_perm: np.ndarray     # argsort(splu.perm_r)
    col_scatter: np.ndarray  # argsort(splu.perm_c)
    L: sp.csc_matrix         # unit lower triangular
    U: sp.csc_matrix         # upper triangular


def _ordering(K: sp.spmatrix, kind) -> np.ndarray:
    n = K.shape[0]
    if isinstance(kind, np.ndarray):          # caller-supplied permutation
        if kind.shape[0] != n:
            raise ValueError(
                f"ordering array has length {kind.shape[0]}, expected {n}")
        return np.asarray(kind, dtype=np.int32)
    if kind == "natural":
        return np.arange(n, dtype=np.int32)
    if kind == "rcm":
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        pattern = sp.csr_matrix(
            (np.ones_like(K.tocsr().data), K.tocsr().indices, K.tocsr().indptr),
            shape=K.shape,
        )
        return np.asarray(reverse_cuthill_mckee(pattern, symmetric_mode=True),
                          dtype=np.int32)
    raise ValueError(f"unknown ordering {kind!r}")


def _groups_from_pairs(paired: np.ndarray, n: int):
    """grp / gstart / gsize arrays from the pair mask."""
    gstart_list = []
    gsize_list = []
    k = 0
    while k < n:
        if paired[k]:
            gstart_list.append(k)
            gsize_list.append(2)
            k += 2
        else:
            gstart_list.append(k)
            gsize_list.append(1)
            k += 1
    gstart = np.asarray(gstart_list, np.int32)
    gsize = np.asarray(gsize_list, np.int32)
    grp = np.empty(n, np.int32)
    for g, (s, z) in enumerate(zip(gstart_list, gsize_list)):
        grp[s:s + z] = g
    return grp, gstart, gsize


def ldl_factor(K: sp.spmatrix, *, ordering: str = "rcm",
               pivot_signs: np.ndarray | None = None,
               pivtol: float = 1e-9, reg_value: float = 1e-8,
               max_rounds: int = 5, reg_tol: float = 0.0) -> HostLDL:
    """Native up-looking LDL^T with 1x1 + adjacent 2x2 block pivots.

    ``pivot_signs`` gives the expected sign of each pivot in the *unpermuted*
    order (+1 for the G block rows, -1 for the -C block rows); pass None for
    no sign expectation.  ``pivtol`` is the relative stability threshold
    (|d| >= pivtol * max|A(:,k)|); failed pivots trigger 2x2 amalgamation
    rounds, and whatever still fails after ``max_rounds`` is regularized
    (surfaced in ``HostLDL.nperturbed``).
    """
    from .._build import native_library

    lib = native_library()
    pivtol = max(pivtol, reg_tol)

    K = sp.csc_matrix(K)
    n = K.shape[0]
    perm = _ordering(K, ordering)

    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.cpk_ldl_symbolic_g.restype = ctypes.c_int64
    lib.cpk_ldl_numeric_g.restype = ctypes.c_int64

    def _prepare(order):
        """Permuted upper CSC + per-column scales + signs for one round."""
        Kp = K[order][:, order]
        upper = sp.triu(Kp, format="csc")
        upper.sort_indices()
        Ap = np.asarray(upper.indptr, dtype=np.int32)
        Ai = np.asarray(upper.indices, dtype=np.int32)
        Ax = np.asarray(upper.data, dtype=np.float64)
        # Per-column magnitude for the relative pivot test (symmetric
        # matrix: accumulate over the stored upper triangle both ways).
        scale = np.zeros(n, np.float64)
        absx = np.abs(Ax)
        np.maximum.at(scale, Ai, absx)
        col_of = np.repeat(np.arange(n), np.diff(Ap))
        np.maximum.at(scale, col_of, absx)
        scale[scale == 0.0] = 1.0
        signs_perm = None
        if pivot_signs is not None:
            signs_perm = np.ascontiguousarray(
                np.asarray(pivot_signs, dtype=np.float64)[order])
        return Ap, Ai, Ax, scale, signs_perm

    order = perm
    Ap, Ai, Ax, scale, signs_perm = _prepare(order)
    paired = np.zeros(n, bool)
    pair_ids: list[tuple[int, int]] = []   # (first, second) original indices
    rnd = 0
    force_final = False
    while True:
        final = force_final or rnd >= max(1, max_rounds) - 1
        signs_arg = (None if signs_perm is None
                     else signs_perm.ctypes.data_as(f64p))
        grp, gstart, gsize = _groups_from_pairs(paired, n)
        ng = gstart.shape[0]
        gparent = np.empty(ng, np.int32)
        colcount = np.empty(n, np.int32)
        lnz = lib.cpk_ldl_symbolic_g(
            ctypes.c_int32(n), ctypes.c_int32(ng),
            Ap.ctypes.data_as(i32p), Ai.ctypes.data_as(i32p),
            grp.ctypes.data_as(i32p), gstart.ctypes.data_as(i32p),
            gsize.ctypes.data_as(i32p), gparent.ctypes.data_as(i32p),
            colcount.ctypes.data_as(i32p),
        )
        Lp = np.zeros(n + 1, dtype=np.int32)
        np.cumsum(colcount, out=Lp[1:])
        Li = np.empty(max(int(lnz), 1), dtype=np.int32)
        Lx = np.empty(max(int(lnz), 1), dtype=np.float64)
        d = np.empty(n, dtype=np.float64)
        e = np.zeros(n, dtype=np.float64)
        fail_cols = np.empty(n, dtype=np.int32)
        status = lib.cpk_ldl_numeric_g(
            ctypes.c_int32(n), ctypes.c_int32(ng),
            Ap.ctypes.data_as(i32p), Ai.ctypes.data_as(i32p),
            Ax.ctypes.data_as(f64p),
            Lp.ctypes.data_as(i32p), gparent.ctypes.data_as(i32p),
            grp.ctypes.data_as(i32p), gstart.ctypes.data_as(i32p),
            gsize.ctypes.data_as(i32p),
            Li.ctypes.data_as(i32p), Lx.ctypes.data_as(f64p),
            d.ctypes.data_as(f64p), e.ctypes.data_as(f64p),
            signs_arg, scale.ctypes.data_as(f64p),
            ctypes.c_double(pivtol), ctypes.c_double(reg_value),
            ctypes.c_int32(0 if not final else 1),
            fail_cols.ctypes.data_as(i32p),
        )
        if status < 0:
            raise ZeroDivisionError(f"LDL breakdown at pivot {-int(status) - 1}")
        nfail = int(status >> 32)
        nperturbed = int(status & 0xFFFFFFFF)
        if final or nfail == 0:
            L = sp.csc_matrix((Lx[: int(lnz)], Li[: int(lnz)], Lp),
                              shape=(n, n))
            return HostLDL(perm=order, L=L, d=d,
                           e=e if int(paired.sum()) else None,
                           nperturbed=nperturbed,
                           n2x2=int(paired.sum()))
        # Partner selection for failed pivots, two-level (MA57-flavoured):
        # 1. an ADJACENT free neighbour with nonzero coupling K(k, j) —
        #    contiguous failing runs (indefinite sub-blocks) pair with each
        #    other, preserving the fill-reducing order;
        # 2. otherwise the strongest-coupled free column anywhere in K's
        #    column is spliced next to the failed one (handles failures
        #    sandwiched between existing blocks).
        fails_ids = [int(order[k]) for k in fail_cols[:nfail]]
        in_pair = {i for ab in pair_ids for i in ab}
        order_list = list(order)
        pos_of = {int(c): i for i, c in enumerate(order_list)}
        progressed = False
        for k_id in fails_ids:
            if k_id in in_pair or len(pair_ids) >= 10000:
                continue
            col = K[:, k_id]
            coupling = {int(r): abs(v) for r, v in zip(col.indices, col.data)
                        if r != k_id and v != 0.0}
            pk = pos_of[k_id]
            adj = []
            for dp in (1, -1):
                if 0 <= pk + dp < n:
                    j = order_list[pk + dp]
                    if j not in in_pair and coupling.get(j, 0.0) > 0.0:
                        adj.append((coupling[j], dp, j))
            if adj:
                _, dp, j_id = max(adj)
                pair = (k_id, j_id) if dp == 1 else (j_id, k_id)
                pair_ids.append(pair)
                in_pair.update(pair)
                progressed = True
                continue
            best, j_id = 0.0, -1
            for r, v in coupling.items():
                if r not in in_pair and v > best:
                    best, j_id = v, r
            if j_id < 0:
                continue                 # no coupling: final round regularizes
            order_list.remove(j_id)
            order_list.insert(order_list.index(k_id) + 1, j_id)
            pos_of = {int(c): i for i, c in enumerate(order_list)}
            pair_ids.append((k_id, j_id))
            in_pair.update((k_id, j_id))
            progressed = True
        if progressed:
            order = np.asarray(order_list, dtype=order.dtype)
            pos = {int(c): i for i, c in enumerate(order_list)}
            paired = np.zeros(n, bool)
            for a, b in pair_ids:
                assert pos[b] == pos[a] + 1, "pair adjacency lost"
                paired[pos[a]] = True
            Ap, Ai, Ax, scale, signs_perm = _prepare(order)
        else:
            force_final = True
        rnd += 1


def lu_factor(K: sp.spmatrix) -> HostLU:
    """scipy splu factorization exported as explicit triangular factors."""
    from scipy.sparse.linalg import splu

    f = splu(sp.csc_matrix(K))
    return HostLU(
        row_perm=np.argsort(f.perm_r).astype(np.int32),
        col_scatter=np.argsort(f.perm_c).astype(np.int32),
        L=f.L.tocsc(),
        U=f.U.tocsc(),
    )


def solve_host(fac, z: np.ndarray, dtype=np.float64) -> np.ndarray:
    """Host-side reference solve with the computed factors (scipy).

    Used to *measure* factor quality at build time: one solve + residual
    decides whether the device path needs an internal refinement step (see
    make_preconditioner's data-driven ``factor_nitref``).  ``dtype`` sets
    the precision of the factor values AND the substitution arithmetic, so
    the probe can emulate the *device* precision (round-2 verdict: probing
    at f64 while the device factors are f32 concluded refinement-free for a
    factor whose f32 solves were orders of magnitude less accurate).
    """
    from scipy.sparse.linalg import spsolve_triangular

    dtype = np.dtype(dtype)
    z = np.asarray(z, dtype=dtype)
    if isinstance(fac, HostLU):
        w = spsolve_triangular(fac.L.astype(dtype), z[fac.row_perm],
                               lower=True)
        w = spsolve_triangular(fac.U.astype(dtype), w, lower=False)
        y = np.empty_like(w)
        y[fac.col_scatter] = w
        return y
    n = fac.d.shape[0]
    L1 = (fac.L + sp.identity(n, format="csc")).tocsr().astype(dtype)
    d = fac.d.astype(dtype)
    w = spsolve_triangular(L1, z[fac.perm], lower=True, unit_diagonal=True)
    # Block-diagonal solve: 1x1 pivots plus (p, p+1) blocks flagged by e.
    if fac.e is None or not np.any(fac.e):
        w = w / d
    else:
        e = fac.e.astype(dtype)
        out = w / np.where(d == 0.0, dtype.type(1.0), d)   # block rows
        starts = np.nonzero(e)[0]                          # overwritten below
        for p in starts:
            det = d[p] * d[p + 1] - e[p] * e[p]
            w1, w2 = w[p], w[p + 1]
            out[p] = (w1 * d[p + 1] - w2 * e[p]) / det
            out[p + 1] = (w2 * d[p] - w1 * e[p]) / det
        w = out
    w = spsolve_triangular(L1.T.tocsr(), w, lower=False, unit_diagonal=True)
    y = np.empty_like(w)
    y[fac.perm] = w
    return y


def factorize(K: sp.spmatrix, *, method: str = "auto", ordering: str = "rcm",
              pivot_signs: np.ndarray | None = None,
              reg_tol: float = 0.0, reg_value: float = 1e-8,
              pivtol: float = 1e-9):
    if method in ("ldl", "auto"):
        try:
            return ldl_factor(K, ordering=ordering, pivot_signs=pivot_signs,
                              reg_tol=reg_tol, reg_value=reg_value,
                              pivtol=pivtol)
        except ZeroDivisionError:
            if method == "ldl":
                raise
    return lu_factor(K)
