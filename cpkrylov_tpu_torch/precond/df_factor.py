"""df64-applied preconditioner factor for coarsely factorable K_P.

Port of ``cpkrylov_tpu/precond/df_factor.py``.  At interior-point
conditioning the LDL^T of K_P can carry enormous element growth; stored in
f32 such a factor is unusable (the plain f32 apply's probe residual is
O(1), and f32 refinement against K_P does not contract).  The fix keeps the
factor ENTRIES in df64, (hi, lo) f32 pairs (``ops/df64.py``), and applies
each triangular factor by f32 substitution plus df64-residual refinement:

    x_0     = trisolve_f32(T_hi, b_hi)
    x_{k+1} = x_k + trisolve_f32(T_hi, hi(b - T x_k))     # residual in df64

Forward substitution is componentwise backward-stable, so each step
contracts by about cond_skeel(T, x) * eps_f32.  D^-1 and the permutations
apply in df64 exactly.  ``make_preconditioner`` swaps this factor in when
its build probe finds the plain f32 apply unusable (``precond/cp.py``).

Upper solve (repairs fault C1 of the JAX package): when tf2 is the
right-to-left bidiagonal scan it solves U itself in natural order, so
``solve_df`` applies it without flips and models the residual matrix as U;
any other tf2 solves the index reversal J U J between two flips, as in the
JAX package (df_factor.py:128, 166-173, 195-198), which always flips.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ..ops import df64
from .trisolve import tri_solve


@dataclasses.dataclass(frozen=True)
class DFTriMat:
    """Triangular matrix in (K, n) transposed-ELL form with df64 values.

    The df64 matvec walks the K ELL slots with a compensated (two_sum
    chained) accumulator, so each row's sum errs by O(eps^2) whatever K.
    On a CUDA tensor it is one launch of the hand-written kernel B10
    (``cuda_df_tri.py``), which walks a row's ``counts`` stored slots and
    one padding slot, else the plain slot loop
    (``cuda_df_tri.df_tri_matvec_plain``); the two agree bit for bit."""

    hi: torch.Tensor     # (K, n) f32
    lo: torch.Tensor     # (K, n) f32
    cols: torch.Tensor   # (K, n) int32 column index into x; 0 where empty
    counts: torch.Tensor  # (n,) int32: a row's entries, in its first
    #                       counts[i] slots (later slots are (0, 0, 0))
    n: int

    def matvec_df(self, x: df64.DF) -> df64.DF:
        from .cuda_df_tri import df_tri_matvec

        return df_tri_matvec(self, x)


def _pack_df_tri(T, device) -> DFTriMat:
    """Host-side transposed-ELL pack of a scipy triangular matrix with
    df64-split values."""
    T = sp.csr_matrix(T).astype(np.float64)
    T.sum_duplicates()
    n = T.shape[0]
    counts = np.diff(T.indptr)
    K = max(1, int(counts.max()) if counts.size and T.nnz else 1)
    if n >= 1 << 31:
        raise ValueError(f"the df64 product indexes with int32: n = {n} >= "
                         "2**31")
    data = np.zeros((n, K), np.float64)
    cols = np.zeros((n, K), np.int32)
    if T.nnz:
        offs = np.arange(T.nnz) - np.repeat(T.indptr[:-1], counts)
        rr = np.repeat(np.arange(n), counts)
        data[rr, offs] = T.data
        cols[rr, offs] = T.indices
    hi, lo = df64.df_from_f64(data.T)
    return DFTriMat(
        hi=torch.as_tensor(np.ascontiguousarray(hi)).to(device),
        lo=torch.as_tensor(np.ascontiguousarray(lo)).to(device),
        cols=torch.as_tensor(np.ascontiguousarray(cols.T)).to(device),
        counts=torch.as_tensor(counts.astype(np.int32)).to(device),
        n=int(n))


@dataclasses.dataclass(frozen=True)
class DFFactorApply:
    """Drop-in for ``FactorApply`` with df64-accurate application.

    pin/tf1/dinv/tf2/pout/dinv_sub mirror ``FactorApply`` (the f32
    solves); ``t1``/``t2`` hold the df64 triangular matrices (t2 is the
    matrix tf2 solves: U for the right-to-left scan, else J U J), and
    ``dinv``/``dinv_lo`` the df64 block-diagonal inverse."""

    pin: object
    tf1: object              # f32 lower factor (any trisolve form)
    dinv: torch.Tensor       # (N,) hi part of the inverse-pivot diagonal
    tf2: object              # f32 upper factor
    pout: object
    dinv_sub: torch.Tensor | None
    t1: DFTriMat             # L + I (factor order)
    t2: DFTriMat             # U, or J U J
    dinv_lo: torch.Tensor
    dinv_sub_lo: torch.Tensor | None
    nref: int = 2

    def _tri_df(self, tf, tmat: DFTriMat, b: df64.DF) -> df64.DF:
        x0 = tri_solve(tf, b[0])
        x = (x0, torch.zeros_like(x0))
        for _ in range(self.nref):
            r = df64.df_add(b, df64.df_neg(tmat.matvec_df(x)))
            d = tri_solve(tf, r[0])
            x = df64.df_add(x, (d, torch.zeros_like(d)))
        return x

    def _apply_dinv_df(self, w: df64.DF) -> df64.DF:
        wh, wl = w
        p, e = df64.two_prod(self.dinv, wh)
        e = e + self.dinv * wl + self.dinv_lo * wh
        if self.dinv_sub is not None:
            # tridiagonal 2x2-block coupling: y[p] += s[p] w[p+1],
            # y[p+1] += s[p] w[p] (cp.py FactorApply._apply_dinv)
            z1 = torch.zeros(1, dtype=wh.dtype, device=wh.device)
            sh, sl = self.dinv_sub, self.dinv_sub_lo
            up_h, up_l = torch.cat([wh[1:], z1]), torch.cat([wl[1:], z1])
            dn_h, dn_l = torch.cat([z1, wh[:-1]]), torch.cat([z1, wl[:-1]])
            sh_dn, sl_dn = torch.cat([z1, sh[:-1]]), torch.cat([z1, sl[:-1]])
            p1, e1 = df64.two_prod(sh, up_h)
            e1 = e1 + sh * up_l + sl * up_h
            p2, e2 = df64.two_prod(sh_dn, dn_h)
            e2 = e2 + sh_dn * dn_l + sl_dn * dn_h
            s_, c_ = df64.two_sum(p, p1)
            p, c2_ = df64.two_sum(s_, p2)
            e = e + e1 + e2 + c_ + c2_
        return df64.quick_two_sum(p, e)

    def solve_df(self, z: df64.DF) -> df64.DF:
        w = (self.pin.apply(z[0]), self.pin.apply(z[1]))
        w = self._tri_df(self.tf1, self.t1, w)
        w = self._apply_dinv_df(w)
        if getattr(self.tf2, "reverse", False):
            w = self._tri_df(self.tf2, self.t2, w)
        else:
            w = self._tri_df(self.tf2, self.t2, (w[0].flip(0), w[1].flip(0)))
            w = (w[0].flip(0), w[1].flip(0))
        return (self.pout.apply_inv(w[0]), self.pout.apply_inv(w[1]))

    def solve(self, z: torch.Tensor) -> torch.Tensor:
        return self.solve_df((z, torch.zeros_like(z)))[0]


def build_df_factor_apply(factor, fac, N: int, nref: int = 2
                          ) -> DFFactorApply:
    """Wrap an unfolded f32 ``FactorApply`` with df64 factor data from the
    host LDL^T ``fac`` (L, d, e in f64)."""
    from .cp import _block_dinv

    if factor.dinv_folded:
        # a folded tf2 solves D U, not U: the df64 residual matrix would
        # model the wrong system (make_preconditioner rebuilds unfolded)
        raise ValueError("build_df_factor_apply needs an unfolded "
                         "FactorApply (dinv_folded=False)")
    device = factor.dinv.device
    L1 = (fac.L + sp.identity(N, format="csc")).tocsr()
    U = L1.T.tocsr()
    if not getattr(factor.tf2, "reverse", False):
        rev = np.arange(N - 1, -1, -1)
        U = U[rev][:, rev].tocsr()
    main, sub = _block_dinv(fac.d, fac.e)          # f64
    mh, ml = df64.df_from_f64(main)

    def dev(a):
        return torch.as_tensor(a).to(device)

    sub_hi = sub_lo = None
    if sub is not None:
        sh, sl = df64.df_from_f64(sub)
        sub_hi, sub_lo = dev(sh), dev(sl)
    return DFFactorApply(
        pin=factor.pin, tf1=factor.tf1, tf2=factor.tf2, pout=factor.pout,
        dinv=dev(mh), dinv_lo=dev(ml), dinv_sub=sub_hi, dinv_sub_lo=sub_lo,
        t1=_pack_df_tri(L1, device), t2=_pack_df_tri(U, device),
        nref=int(nref))
