"""The constraint preconditioner P = [G B'; B -C] as a device operator.

Port of ``cpkrylov_tpu/precond/cp.py`` (the reference's ``opLDL2``).  K_P is
factorized once on the host (``ldl_host.py``); the factors live on the
device as triangular-solve operands.  The Gould-Hribar-Nocedal caches
(opLDL2.m:41-42, 164-171) are an explicit ``CPState`` passed through every
application, and iterative refinement (opLDL2.m:173-187) keeps the trigger
``rNorm >= itref_tol * xNorm or force_itref``.

Layouts are chosen from the structure of the matrices, on every device and
in f32 and f64 alike:

* ordering: the interleave riffle when K_P's bandwidth under it is <= 128,
  else RCM;
* factor solves (the JAX rule of cp.py:256-358, by structure only): the
  bidiagonal scan (``cuda_bidiag.py``, kernel B2) for a factor of reach
  <= 1, with D^-1 folded into the upper solve when every pivot is 1x1;
  otherwise the reduced-state scan form (``trisolve.ReducedScanTriFactor``,
  kernels B4 and B6 in ``cuda_tri.py``) at the first panel p of (p0, 128,
  256, 512, 1024), p0 the reach rounded up to a multiple of 8 (at least 8),
  with reach <= p, n >= max(16 p, 2048) and the dense panel inverses within
  2 GiB; else blocked substitution (``trisolve.BlockTriFactor``).  An upper
  factor other than the bidiagonal scan solves its index reversal between
  two flips;
* K_P: DIA when the natural-order pack passes the fill gate (``ops/dia.py``),
  else CSR (kernel B5, ``ops/cuda_spmv.py``);
* at f32, the df64-applied factor (``df_factor.py``) when the build probe
  finds the plain f32 apply unusable (or ``apply_df64=True``).

The device decides only kernel (CUDA tensor) or plain version (CPU tensor).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from ..config import PrecondOptions
from ..ops import spmv
from ..ops.dia import MAX_FILL_RATIO, pack_sym_dia
from ..ops.formats import csr_from_scipy
from ..utils.device import (host_read, numpy_dtype, resolve_device,
                            torch_dtype, upload)
from ..utils.profiling import (APPLY_SPAN, BUILD_LDL_SPAN, BUILD_ORDER_SPAN,
                               BUILD_PACK_SPAN, BUILD_PROBE_SPAN, BUILD_SPAN,
                               span)
from . import ldl_host
from .cuda_bidiag import build_bidiag_tri, build_bidiag_tri_upper
from .df_factor import build_df_factor_apply
from .permute import interleave_candidates, plan_permute
from .trisolve import build_block_tri, build_reduced_scan_tri, tri_solve

# Largest device footprint of one triangle's dense panel inverses in the
# reduced-scan form (cp.py:256 of the JAX package).
MAX_SCAN_BYTES = 2 << 30


@dataclasses.dataclass(frozen=True)
class FactorApply:
    """Device-side direct solve  y = K_P^{-1} z  from host factors.

    permute by ``pin`` -> lower solve -> block-diagonal scale -> upper solve
    -> inverse-permute by ``pout``.  ``dinv``/``dinv_sub`` hold the inverse
    of the block-diagonal D of the 2x2-pivoting LDL^T (``dinv_sub[p]``
    couples rows p and p+1 of a 2x2 pivot; None when every pivot is 1x1).
    ``dinv_folded``: D^-1 is folded into tf2 (tf2 solves D U) and the scale
    pass is skipped.
    """

    pin: object
    tf1: object
    dinv: torch.Tensor
    tf2: object
    pout: object
    dinv_sub: torch.Tensor | None = None
    dinv_folded: bool = False

    def _apply_dinv(self, w: torch.Tensor) -> torch.Tensor:
        if self.dinv_folded:
            return w
        y = w * self.dinv.to(w.dtype)
        if self.dinv_sub is not None:
            s = self.dinv_sub.to(w.dtype)
            y[:-1] = y[:-1] + s[:-1] * w[1:]
            y[1:] = y[1:] + s[:-1] * w[:-1]
        return y

    def solve(self, z: torch.Tensor) -> torch.Tensor:
        w = self.pin.apply(z)
        w = tri_solve(self.tf1, w)
        w = self._apply_dinv(w)
        if getattr(self.tf2, "reverse", False):
            # the right-to-left scan consumes natural order directly
            w = tri_solve(self.tf2, w)
        else:
            w = tri_solve(self.tf2, w.flip(0)).flip(0)
        return self.pout.apply_inv(w)


class CPState(NamedTuple):
    """GHN residual-update caches (aty = B'y2, cy = (-C)y2)."""

    aty: torch.Tensor  # (n,)
    cy: torch.Tensor   # (m,)


@dataclasses.dataclass(frozen=True)
class CPPrecond:
    """Constraint preconditioner: factors + K_P + behavioural options.

    ``factor_nitref`` internal refinement steps follow every direct solve;
    the build probe sets it (0 for a factor exact at the device dtype, else
    1).  ``probe_rel`` is the probe's relative residual, a diagnostic.
    """

    factor: FactorApply
    kp: object            # exact K_P: DIA or CSR (None on a sharded
                          # Schur factor: parallel/schur.py)
    n: int
    m: int
    options: PrecondOptions
    factor_nitref: int = 1
    nperturbed: int = 0
    factor_exact: bool = False
    probe_rel: float = 1.0

    def _direct_solve(self, z: torch.Tensor) -> torch.Tensor:
        y = self.factor.solve(z)
        for _ in range(self.factor_nitref):
            r = z - spmv.matvec(self.kp, y)
            y = y + self.factor.solve(r)
        return y

    def init_state(self, dtype: torch.dtype | None = None) -> CPState:
        dtype = dtype or self.kp.dtype
        dev = self.kp.data.device
        return CPState(aty=torch.zeros(self.n, dtype=dtype, device=dev),
                       cy=torch.zeros(self.m, dtype=dtype, device=dev))

    def apply(self, state: CPState, z: torch.Tensor):
        """y = M * z with the reference's side-effect order (opLDL2.m:161-188):
        (1) optional GHN input correction, (2) direct solve, (3) GHN cache
        refresh from the unrefined solution, (4) optional refinement.
        Returns ``(new_state, y, rnorm)``."""
        with span(APPLY_SPAN):
            opts = self.options
            n = self.n
            if opts.residual_update:
                zz = z - torch.cat([state.aty, state.cy])
            else:
                zz = z
            y = self._direct_solve(zz)

            if opts.residual_update:
                gv = spmv.matvec(self.kp,
                                 torch.cat([torch.zeros_like(y[:n]), y[n:]]))
                state = CPState(aty=gv[:n], cy=gv[n:])

            rnorm = torch.zeros((), dtype=z.dtype, device=z.device)
            if opts.nitref > 0:
                r = z - spmv.matvec(self.kp, y)
                rnorm = torch.linalg.vector_norm(r)
                if opts.force_itref:
                    # the trigger is always true (opLDL2.m:176): exactly nitref
                    for _ in range(opts.nitref):
                        y = y + self._direct_solve(r)
                        r = z - spmv.matvec(self.kp, y)
                        rnorm = torch.linalg.vector_norm(r)
                    return state, y, rnorm
                xnorm = torch.linalg.vector_norm(z)
                nit = 0
                while (nit < opts.nitref
                       and host_read(rnorm >= opts.itref_tol * xnorm)):
                    y = y + self._direct_solve(r)
                    r = z - spmv.matvec(self.kp, y)
                    rnorm = torch.linalg.vector_norm(r)
                    nit += 1
            return state, y, rnorm

    def apply_nm(self, state: CPState, zn: torch.Tensor, zm: torch.Tensor):
        """Apply on an (n, m) pair; returns (state, yn, ym, rnorm)."""
        state, y, rnorm = self.apply(state, torch.cat([zn, zm]))
        return state, y[: self.n], y[self.n:], rnorm

    def mul_kp(self, z: torch.Tensor) -> torch.Tensor:
        """Multiply by K_P itself: the reference's ``divide`` mode, undoing a
        preconditioner application (opLDL2.m:193-195)."""
        return spmv.matvec(self.kp, z)

    def to_dense_inverse(self) -> torch.Tensor:
        """K_P^-1 as a dense (N, N) tensor on the preconditioner's device,
        one ``_direct_solve`` a column: the reference's ``double()``
        (opLDL2.m:138-149), a diagnostic for small systems."""
        N = self.n + self.m
        eye = torch.eye(N, dtype=self.kp.dtype, device=self.kp.data.device)
        return torch.stack([self._direct_solve(eye[:, j].contiguous())
                            for j in range(N)], dim=1)


# ---------------------------------------------------------------------------
# Host-side construction
# ---------------------------------------------------------------------------

def assemble_kp(G, B, C):
    """K_P = [G B'; B -C] as a scipy CSC matrix."""
    G = sp.csr_matrix(G) if not sp.issparse(G) else G.tocsr()
    B = sp.csr_matrix(B) if not sp.issparse(B) else B.tocsr()
    C = sp.csr_matrix(C) if not sp.issparse(C) else C.tocsr()
    return sp.bmat([[G, B.T], [B, -C]], format="csc")


def _reach(T, upper: bool) -> int:
    coo = sp.csr_matrix(T).tocoo()
    if not coo.nnz:
        return 0
    return int(((coo.col - coo.row) if upper else (coo.row - coo.col)).max())


def _build_tri(T, panel: int, dtype, device):
    """Lower factor: the bidiagonal scan for reach <= 1, else the
    reduced-state scan form at the first panel that passes the size and
    memory gates, else blocked substitution at ``panel``."""
    reach = _reach(T, upper=False)
    if reach <= 1:
        tf = build_bidiag_tri(T, dtype=dtype, device=device)
        if tf is not None:
            return tf
    n = T.shape[0]
    itemsize = torch.empty((), dtype=dtype).element_size()
    p0 = max(8, -(-max(reach, 1) // 8) * 8)
    for p in (p0, 128, 256, 512, 1024):
        # the JAX package's gates, so that both pick the same form: small
        # systems stay on blocked substitution
        if reach <= p and n >= max(16 * p, 2048):
            if -(-n // p) * p * p * itemsize > MAX_SCAN_BYTES:
                break
            tf = build_reduced_scan_tri(T, dtype=dtype, device=device,
                                        panel=p)
            if tf is not None:
                return tf
    return build_block_tri(T, dtype=dtype, device=device, panel=panel)


def _build_tri_upper(U, panel: int, dtype, device):
    """Upper factor: the right-to-left bidiagonal scan for reach <= 1 (no
    flips), else the lower rule on the index reversal J U J (the caller
    flips the vector around the solve)."""
    if _reach(U, upper=True) <= 1:
        tf = build_bidiag_tri_upper(U, dtype=dtype, device=device)
        if tf is not None:
            return tf
    U = sp.csr_matrix(U)
    rev = np.arange(U.shape[0] - 1, -1, -1)
    return _build_tri(U[rev][:, rev].tocsr(), panel, dtype, device)


def _block_dinv(d: np.ndarray, e: np.ndarray | None):
    """Inverse of the block-diagonal D as (main, sub) tridiagonal vectors.

    ``e[p] != 0`` marks a 2x2 pivot block at (p, p+1); its inverse is
    [[d2, -e], [-e, d1]] / det, stored at main[p], main[p+1], sub[p]."""
    if e is None or not np.any(e):
        return 1.0 / d, None
    main = 1.0 / np.where(d == 0.0, 1.0, d)
    sub = np.zeros_like(d)
    starts = np.nonzero(e)[0]
    det = d[starts] * d[starts + 1] - e[starts] ** 2
    main[starts] = d[starts + 1] / det
    main[starts + 1] = d[starts] / det
    sub[starts] = -e[starts] / det
    return main, sub


def build_factor_apply(fac, N: int, panel: int, dtype, device,
                       base_order=None, fold_dinv: bool = True
                       ) -> FactorApply:
    """Pack a host factorization (HostLDL or HostLU) into a ``FactorApply``.
    ``base_order`` is the interleave the ordering was seeded with, applied
    by reshapes when the final ordering equals it.  ``fold_dinv=False``
    keeps D^-1 out of tf2 (the df64 factor models tf2 as plain U)."""
    if isinstance(fac, ldl_host.HostLDL):
        L1 = (fac.L + sp.identity(N, format="csc")).tocsr()
        tf1 = _build_tri(L1, panel, dtype, device)
        main, sub = _block_dinv(fac.d, fac.e)
        U = (fac.L + sp.identity(N)).T.tocsr()
        tf2 = None
        folded = False
        if sub is None and fold_dinv and _reach(U, upper=True) <= 1:
            # U w = D^-1 v is (D U) w = v, and D U keeps the bidiagonal
            # structure: one fewer vector pass per solve on the scan path.
            # (The fold only pays on that flip-free path, so a wider factor
            # is not packed twice.)
            DU = (sp.diags(fac.d) @ U).tocsr()
            tf2 = _build_tri_upper(DU, panel, dtype, device)
            if getattr(tf2, "reverse", False):
                folded = True
            else:
                tf2 = None
        if tf2 is None:
            tf2 = _build_tri_upper(U, panel, dtype, device)
        p = plan_permute(fac.perm, device, base=base_order)
        return FactorApply(pin=p, tf1=tf1, dinv=upload(main, device, dtype),
                           tf2=tf2, pout=p,
                           dinv_sub=(None if sub is None
                                     else upload(sub, device, dtype)),
                           dinv_folded=folded)
    # HostLU from splu
    tf1 = _build_tri(fac.L.tocsr(), panel, dtype, device)
    tf2 = _build_tri_upper(fac.U.tocsr(), panel, dtype, device)
    return FactorApply(pin=plan_permute(fac.row_perm, device),
                       tf1=tf1, dinv=upload(np.ones(N), device, dtype),
                       tf2=tf2,
                       pout=plan_permute(fac.col_scatter, device))


SPMV_FORMATS = ("auto", "dia", "csr", "pgell")


def check_spmv_format(spmv_format: str) -> str:
    """``spmv_format`` if the port knows it, else ValueError (the JAX
    package's message)."""
    if spmv_format not in SPMV_FORMATS:
        raise ValueError(f"unknown spmv_format {spmv_format!r}")
    return spmv_format


def pack_device_format(mat, dtype, device, spmv_format: str = "auto",
                       tile_rows: int = 2048):
    """K_P on the device, by ``spmv_format``:

    * "auto": natural-order DIA when it passes the fill gate, else CSR;
    * "dia": natural-order DIA without the fill gate (the JAX package lifts
      its gate for "dia" too), CSR only where no DIA can be formed;
    * "csr" and "pgell": CSR, kernel B5 (the port of the PGELL kernel).

    CSR is packed without the transpose: K_P is symmetric and only
    multiplied from the left.  ``tile_rows`` sets the height of PGELL
    pages, which exist only on a TPU: it is accepted and has no effect, as
    on every other backend of the JAX package."""
    check_spmv_format(spmv_format)
    packed = None
    if spmv_format in ("auto", "dia"):
        packed = pack_sym_dia(
            mat, dtype=dtype, device=device,
            max_fill_ratio=0.0 if spmv_format == "dia" else MAX_FILL_RATIO)
    if packed is None:
        packed = csr_from_scipy(mat, dtype=dtype, device=device,
                                transpose=False)
    return packed


def _perm_bandwidth(ksp, perm: np.ndarray) -> int:
    """Max |i - j| of the pattern under the given symmetric permutation."""
    coo = ksp.tocoo()
    ipos = np.empty(perm.shape[0], dtype=np.int64)
    ipos[perm] = np.arange(perm.shape[0])
    if coo.nnz == 0:
        return 0
    return int(np.abs(ipos[coo.row] - ipos[coo.col]).max())


def choose_ordering(ksp, n: int, m: int):
    """The interleave of least bandwidth when that bandwidth is <= 128
    (returned as ``(perm, base)``), else ``("rcm", None)``."""
    best_bw, base = None, None
    for cand in interleave_candidates(n, m):
        bw = _perm_bandwidth(ksp, cand.perm)
        if bw <= 128 and (best_bw is None or bw < best_bw):
            best_bw, base = bw, cand
    if base is None:
        return "rcm", None
    return base.perm, base


def build_precond(fac, ksp, n: int, m: int, *, options: PrecondOptions,
                  panel: int, dtype, device, base_order=None,
                  factor_nitref: int | None = None,
                  spmv_format: str = "auto") -> CPPrecond:
    """Device preconditioner from a host factorization of ``ksp``, with the
    build probe that sets ``factor_nitref`` and, at f32, swaps in the
    df64-applied factor (cp.py:595-685 of the JAX package)."""
    with span(BUILD_PACK_SPAN):
        factor = build_factor_apply(fac, n + m, panel, dtype, device,
                                    base_order=base_order)
    nperturbed = int(getattr(fac, "nperturbed", 0))
    if nperturbed:
        warnings.warn(
            f"constraint preconditioner: {nperturbed} pivot(s) of K_P were "
            "regularized; the preconditioner is inexact and iterative "
            "refinement is enabled to compensate", RuntimeWarning,
            stacklevel=3)
    factor_exact = False
    probe_rel = 1.0
    if factor_nitref is None:
        if not isinstance(fac, ldl_host.HostLDL):
            factor_nitref = 0
        elif nperturbed:
            factor_nitref = 1
        else:
            with span(BUILD_PROBE_SPAN):
                # One host solve at the device precision measures the factor's
                # residual relative to the right-hand side.
                npd = numpy_dtype(dtype)
                rng = np.random.default_rng(0)
                z = rng.standard_normal(n + m)
                yh = ldl_host.solve_host(fac, z, dtype=npd)
                rel = (np.linalg.norm(ksp @ np.asarray(yh, np.float64) - z)
                       / max(np.linalg.norm(z), 1e-300))
                thresh = (1e-12 if npd == np.float64
                          else 40 * np.finfo(npd).eps)
                factor_exact = rel <= thresh
                factor_nitref = 0 if factor_exact else 1
                probe_rel = float(rel)
                want_df = options.apply_df64
                if npd == np.float32 and (want_df is True or (
                        want_df == "auto" and rel > 1e-2)):
                    # The stored f32 factor is unusable as it is (or df64 was
                    # asked for): apply its entries in df64 instead, re-probed
                    # on the device.  The df64 form models tf2 as plain U, so a
                    # folded factor is rebuilt unfolded first.
                    with span(BUILD_PACK_SPAN):
                        base = factor
                        if factor.dinv_folded:
                            base = build_factor_apply(
                                fac, n + m, panel, dtype, device,
                                base_order=base_order, fold_dinv=False)
                        factor = build_df_factor_apply(base, fac, n + m,
                                                       nref=1)
                    factor_nitref = 0
                    z = rng.standard_normal(n + m)
                    yd = factor.solve(upload(z, device, dtype))
                    rel = (np.linalg.norm(
                        ksp @ yd.cpu().numpy().astype(np.float64) - z)
                        / max(np.linalg.norm(z), 1e-300))
                    probe_rel = float(rel)
                if rel > 1e-2:
                    warnings.warn(
                        f"constraint preconditioner: K_P is only coarsely "
                        f"factorable at {npd.name} (probe solve relative "
                        f"residual {rel:.1e}); f32 solves will need many "
                        "iterations (mixed refinement escalates its inner "
                        "budget automatically) and the f64 path is the fast "
                        "route for this system", RuntimeWarning, stacklevel=3)
    with span(BUILD_PACK_SPAN):
        kp = pack_device_format(ksp, dtype, device, spmv_format)
    return CPPrecond(factor=factor, kp=kp, n=int(n), m=int(m), options=options,
                     factor_nitref=int(factor_nitref),
                     nperturbed=nperturbed, factor_exact=bool(factor_exact),
                     probe_rel=float(probe_rel))


class HostFactor(NamedTuple):
    """The host half of ``make_preconditioner``: K_P, its factorization and
    the ordering's structured base (for the permutes)."""

    fac: object           # ldl_host.HostLDL or HostLU
    ksp: sp.csc_matrix    # K_P
    n: int
    m: int
    base_order: object    # the interleave candidate, or None


def factorize_kp(G, B, C, *, backend: str = "auto", ordering="auto",
                 reg_value: float = 1e-10) -> HostFactor:
    """Assemble K_P = [G B'; B -C], choose its ordering and factorize it on
    the host (``ordering`` as in ``make_preconditioner``)."""
    n = G.shape[0]
    m = C.shape[0]
    with span(BUILD_ORDER_SPAN):
        ksp = assemble_kp(G, B, C)
        base_order = None
        if isinstance(ordering, str) and ordering == "auto":
            ordering, base_order = choose_ordering(ksp, n, m)
    signs = np.concatenate([np.ones(n), -np.ones(m)])
    with span(BUILD_LDL_SPAN):
        fac = ldl_host.factorize(ksp, method=backend, ordering=ordering,
                                 pivot_signs=signs, reg_value=reg_value)
    return HostFactor(fac=fac, ksp=ksp, n=int(n), m=int(m),
                      base_order=base_order)


def make_preconditioner(G, B, C, *, options: PrecondOptions | None = None,
                        backend: str = "auto", ordering="auto",
                        panel: int = 256, reg_value: float = 1e-10,
                        factor_nitref: int | None = None,
                        spmv_format: str = "auto", tile_rows: int = 2048,
                        dtype=torch.float64, device=None) -> CPPrecond:
    """Build the constraint preconditioner (the driver's
    ``M = opLDL2(G, B, -C)``, reg_cpkrylov.m:131) on ``device`` (default
    the CUDA card; pass "cpu" for the CPU).

    ``ordering``: "auto" (interleave when K_P stays banded under it, else
    RCM), "rcm", "natural", or an explicit permutation array.
    ``spmv_format`` sets the layout of K_P for the GHN and refinement
    products ("auto", "dia", "csr" or "pgell"; ``pack_device_format``);
    it does not change the ordering.  ``tile_rows`` has no effect off a
    TPU (see ``pack_device_format``).
    """
    with span(BUILD_SPAN):
        options = options or PrecondOptions()
        check_spmv_format(spmv_format)
        dtype = torch_dtype(dtype)
        device = resolve_device(device)
        hf = factorize_kp(G, B, C, backend=backend, ordering=ordering,
                          reg_value=reg_value)
        return build_precond(hf.fac, hf.ksp, hf.n, hf.m, options=options,
                             panel=panel, dtype=dtype, device=device,
                             base_order=hf.base_order,
                             factor_nitref=factor_nitref,
                             spmv_format=spmv_format)
