"""Mixed-precision solves: f32 inner Krylov + f64-accurate outer refinement.

Port of ``cpkrylov_tpu/mixed.py``.  A plain f32 solve of an ill-conditioned
KKT system stagnates near the f32 floor, short of the reference tolerance.
Krylov-accelerated iterative refinement (GMRES-IR, Carson & Higham, SISC
2018, applied to the constraint-preconditioned family) recovers f64
accuracy from f32 work:

    x = 0;  r = b
    repeat:
        d ~ K^-1 (r / ||r||)   by a CP-Krylov solve in f32
        x += ||r|| * d
        r  = b - K x           in f64 (host loop) or df64 (device loop)
    until ||r|| <= atol + rtol * ||b||

The convergence test is on the TRUE residual, stronger than the kernels'
preconditioned-residual criterion (e.g. cpminres.m:234-236).

Two outer loops, with the JAX package's semantics:

* the host loop: f64 vectors and the f64 residual on the host (scipy), each
  inner solve through ``driver.solve`` on ``device``, with an adaptive
  per-pass target and an escalating stagnation window;
* the device loop (``DeviceMixedSolver``): x, r and b stay on the device as
  (hi, lo) f32 pairs (``ops/df64.py``) and the residual is the df64 product
  of K (kernel B3 on CUDA tensors).  It needs blocks that pack into df64
  DIA form.  ``device_resident="auto"`` takes it for a CUDA device (where
  the JAX package took it on a TPU); an unforced device loop that does not
  converge falls through to the host loop.

Neither loop caches anything across calls: every call converts and packs its
host operands anew, so an in-place update of a block between two calls is
always seen (the JAX package's content-fingerprinted caches can miss such
updates, fault C2).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import scipy.sparse as sp
import torch

from .config import PrecondOptions, SolverOptions
from .driver import _device_operand, _solve_core, solve
from .operators.linop import aslinearoperator
from .ops import df64
from .precond.cp import check_spmv_format, make_preconditioner
from .utils.device import host_read, resolve_device, upload
from .utils.profiling import (MIXED_HOST_LOOP_SPAN, MIXED_LOOP_SPAN,
                              MIXED_PACK_SPAN, MIXED_READBACK_SPAN,
                              MIXED_SPAN, span)
from .utils.timing import sync

_TINY32 = float(np.finfo(np.float32).tiny)
# The default relative reduction asked of each f32 inner solve: about the
# f32 stagnation floor (the JAX package's default).
INNER_RTOL = 1.0e-4

# Path counters (``utils/profiling.py::path_counts``): unforced device loops
# that reached ``dispatch()``, and those of them that returned no answer and
# sent the solve to the host loop.
DEVICE_LOOPS = 0
FALLBACKS = 0


def _as_host_matrix(X, name: str):
    """X as an f64 CSR (or dense) host matrix; no copy when it is one."""
    if sp.issparse(X):
        return X.tocsr().astype(np.float64, copy=False)
    if isinstance(X, np.ndarray):
        return np.asarray(X, dtype=np.float64)
    raise TypeError(
        f"mixed-precision refinement needs an explicit matrix for {name} "
        "(the f64 true-residual SpMV r = b - K x runs on the host); got "
        f"{type(X).__name__}. Use solve(..., dtype=torch.float64) for "
        "operator-only blocks.")


@dataclasses.dataclass(frozen=True)
class MixedSolveOutput:
    """Result of a mixed-precision solve."""

    x: np.ndarray              # (n+m,) combined solution, f64
    x1: np.ndarray             # (n,)
    x2: np.ndarray             # (m,)
    niters: int                # total inner Krylov iterations
    nouter: int                # outer refinement passes
    resid_history: np.ndarray  # true-residual 2-norm, start and each pass
    inner_niters: tuple        # per-pass inner iteration counts
    solved: bool
    ptime: float               # f32 preconditioner build seconds
    stime: float               # whole solve wall clock (incl. setup, refine)
    inner_outputs: tuple       # per-pass SolveOutput (host loop only)


def _lean_inner_options(M32, lean_inner: bool):
    """With ``lean_inner``, strip per-application refinement AND the GHN
    update from the inner preconditioner when the f32 build probe
    certified the factor exact at f32 (``factor_nitref == 0``):
    refinement's accuracy target is subsumed by the outer loop, and GHN fed
    unrefined f32 applications turns their ~1e-7 error into indefiniteness
    (the JAX package measured a breakdown at iteration 1 on the 1.25M-row
    bench system).  Without it, the caller's options stand (literal
    per-application parity).  Shared by the host and device loops and the
    distributed solve."""
    if (lean_inner and M32.factor_nitref == 0
            and (M32.options.nitref > 0 or M32.options.force_itref
                 or M32.options.residual_update)):
        return dataclasses.replace(
            M32, options=dataclasses.replace(M32.options, nitref=0,
                                             force_itref=False,
                                             residual_update=False))
    return M32


def solve_mixed(method, b, A, B, C, G, *,
                opts: SolverOptions | None = None,
                precond_opts: PrecondOptions | None = None,
                inner_rtol: float = INNER_RTOL,
                inner_stagwin: int = 30,
                max_outer: int = 40,
                lean_inner: bool = True,
                backend: str = "auto", ordering="auto", panel: int = 256,
                spmv_format: str = "auto", tile_rows: int = 2048,
                M=None, device=None,
                device_resident: bool | str = "auto") -> MixedSolveOutput:
    """Solve [A B'; B -C][x1;x2] = b to f64 accuracy with f32 work on
    ``device`` (default the CUDA card; "cpu" on request).

    ``opts.atol``/``opts.rtol`` set the OUTER (true-residual) tolerance:
    converged when ``||b - K x|| <= atol + rtol ||b||``, in at most
    ``max_outer`` passes.  Each f32 inner solve is asked for a relative
    reduction of ``inner_rtol`` (the loose default is about the f32 floor;
    with a factor exact at f32 a pass aims lower, at the remaining
    reduction, capped by ``inner_rtol``); ``inner_stagwin`` bounds its
    stagnation.  ``lean_inner`` (default) runs the inner preconditioner
    without per-application refinement and the GHN update when the factor
    is exact at f32; ``lean_inner=False`` keeps the caller's options (the
    JAX package's literal per-application parity mode).  ``spmv_format``
    and ``tile_rows`` lay out A, B and K_P as in ``driver.solve``.
    ``M``: a prebuilt f32 preconditioner on ``device``.
    ``device_resident``: "auto" (the device loop on a CUDA device), True
    (the device loop or ValueError) or False (the host loop).

    All blocks must be explicit host matrices (scipy or numpy).
    """
    opts = opts or SolverOptions()
    check_spmv_format(spmv_format)
    device = resolve_device(device)
    t_all = time.perf_counter()
    with span(MIXED_SPAN):
        A_h = _as_host_matrix(A, "A")
        B_h = _as_host_matrix(B, "B")
        C_h = _as_host_matrix(C, "C")
        n, m = A_h.shape[0], C_h.shape[0]
        b = np.asarray(b, dtype=np.float64).reshape(-1)
        if b.shape[0] != n + m:
            raise ValueError(f"rhs has length {b.shape[0]}, expected {n + m}")

        t0 = time.perf_counter()
        M32 = M if M is not None else make_preconditioner(
            G, B, C, options=precond_opts, backend=backend,
            ordering=ordering, panel=panel, spmv_format=spmv_format,
            tile_rows=tile_rows, dtype=torch.float32, device=device)
        ptime = time.perf_counter() - t0
        M32 = _lean_inner_options(M32, lean_inner)
        loop = dict(inner_rtol=inner_rtol, inner_stagwin=inner_stagwin,
                    max_outer=max_outer, spmv_format=spmv_format,
                    tile_rows=tile_rows, device=device, ptime=ptime,
                    t_all=t_all)

        if device_resident is True or (device_resident == "auto"
                                       and device.type == "cuda"):
            devout = _try_solve_mixed_device(
                method, b, A_h, B_h, C_h, M32, opts,
                forced=device_resident is True, **loop)
            if devout is not None:
                return devout
        with span(MIXED_HOST_LOOP_SPAN):
            return _solve_mixed_host(method, b, A, B, C, G, A_h, B_h, C_h,
                                     M32, opts, **loop)


def _solve_mixed_host(method, b, A, B, C, G, A_h, B_h, C_h, M32, opts, *,
                      inner_rtol, inner_stagwin, max_outer, spmv_format,
                      tile_rows, device, ptime, t_all) -> MixedSolveOutput:
    """The host outer loop (mixed.py:173-253 of the JAX package)."""
    n = A_h.shape[0]

    def kmatvec(x):
        x1, x2 = x[:n], x[n:]
        return np.concatenate([A_h @ x1 + B_h.T @ x2, B_h @ x1 - C_h @ x2])

    # The stagnation window bounds each inner pass near the f32 floor; its
    # STATUS_STAGNATED exit still returns the best iterate, which is the
    # correction the outer loop wants.  ``reorth`` (read by cpgmres only)
    # pays exactly at the f32 floor, as in the JAX package.
    inner_opts = dataclasses.replace(opts, atol=0.0, rtol=inner_rtol,
                                     stagwin=inner_stagwin, reorth=True)
    bnorm = float(np.linalg.norm(b))
    stop = opts.atol + opts.rtol * bnorm

    x = np.zeros(b.shape[0])
    r = b.copy()
    rnorm = bnorm
    history = [rnorm]
    inner_outputs = []
    inner_iters = []
    solved = rnorm <= stop
    stagnant = 0
    stagwin_cur = inner_stagwin
    for _ in range(max_outer):
        if solved:
            break
        # Adaptive per-pass target, for a factor exact at f32 only: aim at
        # the remaining reduction (0.3 safety for the recurrence-vs-true
        # residual gap), capped by inner_rtol, floored at 1e-7 and rounded
        # down to a power of ten.
        if M32.factor_exact and stop > 0:
            t_pass = min(inner_rtol, max(0.3 * stop / rnorm, 1e-7))
            t_pass = 10.0 ** np.floor(np.log10(max(t_pass, 1e-7)))
            inner_opts = dataclasses.replace(inner_opts, rtol=float(t_pass))
        out = solve(method, (r / rnorm).astype(np.float32), A, B, C, G,
                    opts=inner_opts, M=M32, dtype=torch.float32,
                    spmv_format=spmv_format, tile_rows=tile_rows,
                    device=device, refine=False)
        inner_outputs.append(out)
        inner_iters.append(out.niters)
        x = x + rnorm * out.x.cpu().numpy().astype(np.float64)
        r = b - kmatvec(x)
        new_norm = float(np.linalg.norm(r))
        history.append(new_norm)
        solved = new_norm <= stop
        # Stall: two consecutive passes with less than a 2x reduction.
        stagnant = stagnant + 1 if new_norm > 0.5 * rnorm else 0
        rnorm = max(new_norm, np.finfo(np.float64).tiny)
        if stagnant >= 2:
            # A coarsely factorable K_P converges slowly; widen the inner
            # stagnation window (x4, up to 512) before giving up.
            if stagwin_cur and stagwin_cur < 512:
                stagwin_cur *= 4
                inner_opts = dataclasses.replace(inner_opts,
                                                 stagwin=stagwin_cur)
                stagnant = 0
                continue
            break

    return MixedSolveOutput(
        x=x, x1=x[:n], x2=x[n:],
        niters=int(sum(inner_iters)), nouter=len(inner_iters),
        resid_history=np.asarray(history), inner_niters=tuple(inner_iters),
        solved=bool(solved), ptime=ptime,
        stime=time.perf_counter() - t_all,
        inner_outputs=tuple(inner_outputs))


# ---------------------------------------------------------------------------
# Device-resident outer loop
# ---------------------------------------------------------------------------

def _norm32(v: torch.Tensor) -> torch.Tensor:
    """Scaled f32 2-norm: a plain f32 norm square-underflows entries below
    ~1e-19, so a badly scaled system could report solved early; factoring
    out max|v| keeps the largest square at 1."""
    mx = torch.max(torch.abs(v))
    return mx * torch.linalg.vector_norm(v / torch.clamp(mx, min=_TINY32))


def _mixed_device_core(method, b_hi, b_lo, Kdf, A_op, C_op, B_op, M, opts,
                       stop, max_outer):
    """The outer loop of mixed.py:269-323 on device tensors: inner f32
    solve (with the RHS shift), df64 accumulation of x, df64 true residual,
    f32 stopping control.  The host reads three scalars per pass.
    Returns (xh, xl, hist, iters, nouter, solved) with host hist/iters."""
    bnorm = _norm32(b_hi)
    hist = np.full(max_outer + 1, np.nan, np.float32)
    iters = np.zeros(max_outer, np.int32)
    xh = torch.zeros_like(b_hi)
    xl = torch.zeros_like(b_hi)
    rh = b_hi
    rnorm = torch.clamp(bnorm, min=_TINY32)
    bn, solved = host_read(torch.stack([bnorm,
                                        (bnorm <= stop).to(bnorm.dtype)]))
    hist[0] = bn
    solved = bool(solved)
    stag = 0
    k = 0
    while not solved and k < max_outer and stag < 2:
        res, x1c, x2c = _solve_core(method, rh / rnorm, A_op, C_op, B_op, M,
                                    opts, True)
        xh, xl = df64.df_axpy(rnorm, torch.cat([x1c, x2c]), (xh, xl))
        kx = Kdf.matvec((xh, xl))
        rh, _ = df64.df_add((b_hi, b_lo), df64.df_neg(kx))
        new_norm = _norm32(rh)
        nn, ok, grew = host_read(torch.stack([
            new_norm, (new_norm <= stop).to(new_norm.dtype),
            (new_norm > 0.5 * rnorm).to(new_norm.dtype)]))
        hist[k + 1] = nn
        iters[k] = res.niters
        solved = bool(ok)
        stag = stag + 1 if grew else 0
        rnorm = torch.clamp(new_norm, min=_TINY32)
        k += 1
    return xh, xl, hist, iters, k, solved


@dataclasses.dataclass
class DeviceMixedSolver:
    """A prepared device-resident mixed solve: every operand on the device.
    ``dispatch()`` runs one full solve and returns the device (xh, xl) pair
    with the host history, per-pass iterations, pass count and status;
    benchmarks time it apart from the packing."""

    method: str
    b_hi: torch.Tensor
    b_lo: torch.Tensor
    Kdf: df64.DFSaddle
    A_op: object
    C_op: object
    B_op: object
    M: object
    inner_opts: SolverOptions
    stop: float                # f32 value of atol + rtol ||b||
    max_outer: int
    n: int
    m: int

    def dispatch(self):
        with span(MIXED_LOOP_SPAN):
            return _mixed_device_core(self.method, self.b_hi, self.b_lo,
                                      self.Kdf, self.A_op, self.C_op,
                                      self.B_op, self.M, self.inner_opts,
                                      self.stop, self.max_outer)


def prepare_mixed_device(method, b, A, B, C, M32, opts, *,
                         inner_rtol: float = INNER_RTOL,
                         inner_stagwin: int = 30, max_outer: int = 40,
                         spmv_format: str = "auto", tile_rows: int = 2048,
                         device=None) -> DeviceMixedSolver | None:
    """Pack the operands of the device-resident loop on ``device`` (default
    the CUDA card); None
    when a block cannot take df64 DIA form (non-diagonal C, or a block that
    fails the DIA gate).  Under ``spmv_format`` "auto" and "dia" the f32
    inner solves read A and B through the hi parts of their df64 packs, so
    each block is packed once; under "csr" and "pgell" they read f32 CSR
    copies (kernel B5).  ``inner_rtol`` caps each pass's target, as in
    ``solve_mixed``; ``tile_rows`` has no effect off a TPU."""
    check_spmv_format(spmv_format)
    device = resolve_device(device)
    with span(MIXED_PACK_SPAN):
        A_h = _as_host_matrix(A, "A")
        B_h = _as_host_matrix(B, "B")
        C_h = _as_host_matrix(C, "C")
        Kdf = df64.pack_df_saddle(A_h, B_h, C_h, device=device)
        if Kdf is None:
            return None
        if spmv_format in ("csr", "pgell"):
            A_op = _device_operand(A_h, torch.float32, device, spmv_format)
            B_op = _device_operand(B_h, torch.float32, device, spmv_format)
        else:
            A_op = aslinearoperator(Kdf.a.hi_dia())
            B_op = aslinearoperator(Kdf.b.hi_dia())
        C_op = aslinearoperator(C_h, dtype=torch.float32, device=device)

        n, m = A_h.shape[0], C_h.shape[0]
        b = np.asarray(b, dtype=np.float64).reshape(-1)
        bh, bl = df64.df_from_f64(b)
        bnorm = float(np.linalg.norm(b))
        stop = np.float32(opts.atol + opts.rtol * bnorm)
        # Aim pass 1 directly at the final target (0.3 safety for the
        # recurrence-vs-true residual gap, floored at 1e-7) when the factor
        # is exact at f32; later passes keep the same relative target and
        # the stagnation window bounds unreachable ones.
        if M32.factor_exact and float(stop) > 0.0 and bnorm > 0.0:
            inner_rtol = min(inner_rtol,
                             max(0.3 * float(stop) / bnorm, 1e-7))
        inner_opts = dataclasses.replace(
            opts, atol=0.0, rtol=float(inner_rtol), stagwin=inner_stagwin,
            reorth=True)
        solver = DeviceMixedSolver(
            method=method, b_hi=upload(bh, device),
            b_lo=upload(bl, device), Kdf=Kdf, A_op=A_op, C_op=C_op,
            B_op=B_op, M=M32, inner_opts=inner_opts, stop=float(stop),
            max_outer=int(max_outer), n=int(n), m=int(m))
        sync(device)
    return solver


def _try_solve_mixed_device(method, b, A, B, C, M32, opts, *,
                            inner_rtol, inner_stagwin, max_outer,
                            spmv_format, tile_rows, device, ptime, t_all,
                            forced):
    global DEVICE_LOOPS, FALLBACKS
    solver = prepare_mixed_device(
        method, b, A, B, C, M32, opts, inner_rtol=inner_rtol,
        inner_stagwin=inner_stagwin, max_outer=max_outer,
        spmv_format=spmv_format, tile_rows=tile_rows, device=device)
    if solver is None:
        if forced:
            raise ValueError(
                "device_resident=True requires blocks that pack into df64 "
                "DIA form (diagonal C, banded A and B)")
        return None
    if not forced:
        DEVICE_LOOPS += 1
    xh, xl, hist, iters, nouter, solved = solver.dispatch()
    with span(MIXED_READBACK_SPAN):
        x = df64.df_to_f64(xh, xl)
    stime = time.perf_counter() - t_all
    if not solved and not forced:
        # The device loop has a fixed inner stagnation window; a coarsely
        # factorable K_P needs the escalating host loop.
        FALLBACKS += 1
        return None
    n = solver.n
    inner_iters = tuple(int(v) for v in iters[:nouter])
    hist = hist.astype(np.float64)
    return MixedSolveOutput(
        x=x, x1=x[:n], x2=x[n:],
        niters=int(sum(inner_iters)), nouter=int(nouter),
        resid_history=hist[~np.isnan(hist)], inner_niters=inner_iters,
        solved=bool(solved), ptime=ptime, stime=stime, inner_outputs=())
