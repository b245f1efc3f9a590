"""Shared machinery for the constraint-preconditioned Krylov kernels.

Port of ``cpkrylov_tpu/solvers/common.py``.  The JAX kernels are
``lax.while_loop`` pure functions; here they are eager Python loops on
device tensors.  Scalars of the recurrences stay 0-d tensors in the solve's
dtype (so f32 solves round like the JAX package's), and the loop reads the
stopping quantities to the host once per iteration.
"""
from __future__ import annotations

import contextvars
import dataclasses

import numpy as np
import torch

from ..config import SolverOptions
from ..operators.linop import aslinearoperator
from ..utils.device import host_read, numpy_dtype, upload

STATUS_SOLVED = 0          # residual small compared to initial residual
STATUS_ITMAX = 1           # maximum number of iterations attained
STATUS_INDEFINITE = 2      # beta^2 < -100*eps: preconditioner not SPD-like
STATUS_BACKWARD = 3        # backward error small (cpcglanczos btol)
STATUS_BREAKDOWN = 4       # coupled inner product lost positivity
STATUS_STAGNATED = 5       # no meaningful progress for opts.stagwin iters

STATUS_STRINGS = {
    STATUS_SOLVED: "residual small compared to initial residual",
    STATUS_ITMAX: "maximum number of iterations attained",
    STATUS_INDEFINITE: "preconditioner not second-order sufficient",
    STATUS_BACKWARD: "backward error small",
    STATUS_BREAKDOWN: "basis breakdown (coupled inner product nonpositive)",
    STATUS_STAGNATED: "residual stagnated (opts.stagwin exceeded)",
}


@dataclasses.dataclass(frozen=True)
class KrylovResult:
    """Solver output: solution pair + stats (the reference's x/y/stats/flag).

    ``resid_history`` is a host array of ``itmax + 1`` slots padded with NaN
    past ``niters``, as in the JAX package.  CPSYMMLQ also returns its CG,
    LQ and QR histories (cpsymmlq.m:363-366); they are None elsewhere.
    """

    x: torch.Tensor
    y: torch.Tensor
    niters: int
    resid_history: np.ndarray
    solved: bool
    istatus: int
    cg_resid_history: np.ndarray | None = None
    lq_resid_history: np.ndarray | None = None
    qr_resid_history: np.ndarray | None = None

    @property
    def status(self) -> str:
        return STATUS_STRINGS.get(int(self.istatus), "unknown")

    def trimmed_history(self) -> np.ndarray:
        """Residual history with the NaN padding stripped."""
        h = np.asarray(self.resid_history)
        return h[~np.isnan(h)]


def sym_givens(a: torch.Tensor, b: torch.Tensor):
    """Symmetric (reflector-form) Givens rotation, branch for branch the
    reference's SymGivens.m (Saunders & Choi) as a ``torch.where`` lattice
    on 0-d tensors, so it stays on the device.

    Returns (c, s, d) with [c s; s -c] [a; b] = [d; 0]; ``torch.sign``
    follows MATLAB's sign(0) = 0.
    """
    abs_a, abs_b = torch.abs(a), torch.abs(b)
    b_zero = b == 0
    a_zero = a == 0
    b_dominant = abs_b > abs_a
    one = torch.ones_like(a)
    zero = torch.zeros_like(a)
    a_safe = torch.where(a_zero, one, a)
    b_safe = torch.where(b_zero, one, b)

    # branch: |b| > |a|
    t3 = a / b_safe
    s3 = torch.sign(b) / torch.sqrt(1 + t3 * t3)
    c3 = s3 * t3
    d3 = b / torch.where(s3 == 0, one, s3)
    # branch: |a| >= |b| (both nonzero)
    t4 = b / a_safe
    c4 = torch.sign(a) / torch.sqrt(1 + t4 * t4)
    s4 = c4 * t4
    d4 = a / torch.where(c4 == 0, one, c4)

    c = torch.where(b_zero, torch.where(a_zero, one, torch.sign(a)),
                    torch.where(a_zero, zero,
                                torch.where(b_dominant, c3, c4)))
    s = torch.where(b_zero, zero,
                    torch.where(a_zero, torch.sign(b),
                                torch.where(b_dominant, s3, s4)))
    d = torch.where(b_zero, abs_a,
                    torch.where(a_zero, abs_b,
                                torch.where(b_dominant, d3, d4)))
    return c, s, d


# ---------------------------------------------------------------------------
# Vector reductions, pluggable for the row-partitioned solve.
#
# Every kernel reduction goes through ``vdot``/``vnorm``/``coupled_dot``.
# Without a group they are plain local dots; inside ``reduce_group(comm)``
# each is a local dot all-reduced over the ranks of ``comm``
# (``parallel/comm.py``), which lets all six kernels run unchanged on
# row-sharded vectors (the JAX package's ``reduce_axis``).
# ---------------------------------------------------------------------------

_REDUCE_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "cpkrylov_reduce_group", default=None)


class reduce_group:
    """Context manager: reductions inside become all-reduced local dots
    over ``comm`` (a ``parallel.comm.Comm``; None leaves them local)."""

    def __init__(self, comm):
        self.comm = comm
        self._token = None

    def __enter__(self):
        self._token = _REDUCE_GROUP.set(self.comm)
        return self

    def __exit__(self, *exc):
        _REDUCE_GROUP.reset(self._token)
        return False


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """dot(a, b), all-reduced over the active group (if any)."""
    d = torch.dot(a, b)
    comm = _REDUCE_GROUP.get()
    return d if comm is None else comm.allreduce_sum(d)


def vnorm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(vdot(a, a))


def coupled_dot(u, v, t, q) -> torch.Tensor:
    """dot(u, v) + dot(t, q), the coupled inner product of every kernel
    (cpminres.m:189).  Under a group both local dots are added first and
    all-reduced once."""
    comm = _REDUCE_GROUP.get()
    if comm is None:
        return vdot(u, v) + vdot(t, q)
    return comm.allreduce_sum(torch.dot(u, v) + torch.dot(t, q))


def eps100(dtype: torch.dtype) -> float:
    """The reference's ``100*eps`` indefiniteness threshold
    (cpminres.m:135)."""
    return 100.0 * float(torch.finfo(dtype).eps)


def safe_normalize_pair(v, q, beta):
    """Divide (v, q) by beta when beta > 0 (cpminres.m:202-205)."""
    pos = beta > 0
    denom = torch.where(pos, beta, torch.ones_like(beta))
    return torch.where(pos, v / denom, v), torch.where(pos, q / denom, q)


def resolve_operators(A, C, device=None):
    return (aslinearoperator(A, device=device),
            aslinearoperator(C, device=device))


def resolve_itmax(opts: SolverOptions, default: int) -> int:
    return int(opts.itmax) if opts.itmax is not None else int(default)


def history_init(itmax: int, first: float, dtype: torch.dtype) -> np.ndarray:
    """NaN-padded host history of ``itmax + 1`` slots, slot 0 = ``first``."""
    h = np.full(itmax + 1, np.nan, dtype=numpy_dtype(dtype))
    h[0] = first
    return h


def lanczos_step(A, C, M, mstate, vk, qk, vkm1, qkm1, beta, e100):
    """One coupled Lanczos step (cpminres.m:187-206).

    Computes u = A v_k, t = C q_k, the coupled alpha, one preconditioner
    application, and the three-term recurrences for (v_{k+1}, q_{k+1}).
    Returns (mstate, u, t, alpha, v_{k+1}, q_{k+1}, beta_{k+1}, indefinite)
    with ``indefinite`` a 0-d bool tensor.
    """
    u = A.matvec(vk)
    t = C.matvec(qk)
    alpha = coupled_dot(u, vk, t, qk)
    mstate, w1, w2, _ = M.apply_nm(mstate, u, -t)
    vkp1 = w1 - alpha * vk - beta * vkm1
    qkp1 = (qk - w2) - alpha * qk - beta * qkm1
    beta2 = coupled_dot(u, vkp1, t, qkp1)
    # Relative threshold (same units as |alpha|), as in the JAX package.
    indefinite = beta2 < -e100 * (1 + torch.abs(alpha))
    beta_new = torch.sqrt(torch.abs(beta2))
    vkp1, qkp1 = safe_normalize_pair(vkp1, qkp1, beta_new)
    return mstate, u, t, alpha, vkp1, qkp1, beta_new, indefinite


def initial_lanczos_pair(b, m: int, M, mstate, e100: float):
    """Initial Lanczos pair (v1, q1) and beta1 (cpminres.m:130-147 et al.).
    Returns (mstate, v1, q1, beta1, indefinite) with ``indefinite`` a 0-d
    bool tensor."""
    zerom = torch.zeros(m, dtype=b.dtype, device=b.device)
    mstate, w1, w2, _ = M.apply_nm(mstate, b, zerom)
    vkp1 = w1
    qkp1 = -w2
    beta0 = vdot(b, vkp1)
    indefinite = beta0 < -e100 * (1 + torch.abs(beta0))
    beta = torch.sqrt(torch.abs(beta0))
    vkp1, qkp1 = safe_normalize_pair(vkp1, qkp1, beta)
    return mstate, vkp1, qkp1, beta, indefinite


def stag_init(resid0: float):
    """(best residual seen, iterations since the last >=10% improvement)
    for the opt-in stagnation window ``opts.stagwin`` (host values)."""
    return float(resid0), 0


def stag_update(best: float, since: int, resid: float):
    better = resid < 0.9 * best
    return min(resid, best), (0 if better else since + 1)


def stag_stop(since: int, stagwin: int) -> bool:
    return stagwin > 0 and since >= stagwin


def manifold_ok(B_op, C_op, x, y, stop_tol) -> bool:
    """Constraint-preservation check: healthy CP iterates keep
    ``B x - C y`` near rounding level; a gross violation vetoes `solved`."""
    bx = B_op.matvec(x)
    cy = C_op.matvec(y)
    viol = vnorm(bx - cy)
    scale = 1.0 + vnorm(bx) + vnorm(cy)
    feps = float(torch.finfo(x.dtype).eps)
    bound = torch.maximum((feps ** 0.5) * scale,
                          upload(torch.as_tensor(10.0 * stop_tol,
                                                 dtype=x.dtype), x.device))
    return host_read(viol <= bound)


def apply_manifold_veto(solved: bool, istatus: int, B, C_op, x, y,
                        stop_tol):
    """AND the manifold check into `solved`; flag a veto as breakdown."""
    if B is None or not solved:
        return solved, istatus
    if not manifold_ok(aslinearoperator(B, device=x.device), C_op, x, y,
                       stop_tol):
        return False, STATUS_BREAKDOWN
    return solved, istatus


def true_resid(b, A, C_op, M, mstate, x, y):
    """The true preconditioned residual of (x, y), computed the way the
    GMRES restart reseeds its basis (cpgmres.m:167-171): one A matvec, one
    C matvec, one preconditioner application, one coupled norm, clamped at
    0 where the reference would go complex.  Returns ``(mstate, v, q,
    resid)``: (v, q) is the unnormalized basis pair of the reseed and
    ``resid`` a 0-d tensor."""
    u = b - A.matvec(x)
    t = C_op.matvec(y)
    mstate, w1, w2, _ = M.apply_nm(mstate, u, -t)
    q1 = y - w2
    resid = torch.sqrt(torch.clamp(coupled_dot(u, w1, t, q1), min=0.0))
    return mstate, w1, q1, resid


def breakdown_resid_recheck(solved: bool, istatus: int, resid_est: float,
                            stop_tol: float, b, A, C_op, M, mstate, x, y):
    """Re-judge ``solved`` from a freshly computed residual
    (:func:`true_resid`) on breakdown-class exits.  Returns
    ``(solved, resid)``."""
    if istatus not in (STATUS_INDEFINITE, STATUS_BREAKDOWN):
        return solved, resid_est
    resid_true = host_read(true_resid(b, A, C_op, M, mstate, x, y)[3])
    return resid_true <= stop_tol, resid_true
