"""Shared machinery for the constraint-preconditioned Krylov kernels.

Port of ``cpkrylov_tpu/solvers/common.py``.  The JAX kernels are
``lax.while_loop`` pure functions; here they are eager Python loops on
device tensors.  Scalars of the recurrences stay 0-d tensors in the solve's
dtype (so f32 solves round like the JAX package's), and the loop reads the
stopping quantities to the host once per iteration.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SolverOptions
from ..operators.linop import aslinearoperator
from ..utils.device import numpy_dtype

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
    past ``niters``, as in the JAX package.
    """

    x: torch.Tensor
    y: torch.Tensor
    niters: int
    resid_history: np.ndarray
    solved: bool
    istatus: int

    @property
    def status(self) -> str:
        return STATUS_STRINGS.get(int(self.istatus), "unknown")

    def trimmed_history(self) -> np.ndarray:
        """Residual history with the NaN padding stripped."""
        h = np.asarray(self.resid_history)
        return h[~np.isnan(h)]


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a, b)


def vnorm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(vdot(a, a))


def coupled_dot(u, v, t, q) -> torch.Tensor:
    """dot(u, v) + dot(t, q), the coupled inner product of every kernel
    (cpminres.m:189)."""
    return vdot(u, v) + vdot(t, q)


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
                          torch.as_tensor(10.0 * stop_tol, dtype=x.dtype,
                                          device=x.device))
    return bool(viol <= bound)


def apply_manifold_veto(solved: bool, istatus: int, B, C_op, x, y,
                        stop_tol):
    """AND the manifold check into `solved`; flag a veto as breakdown."""
    if B is None or not solved:
        return solved, istatus
    if not manifold_ok(aslinearoperator(B, device=x.device), C_op, x, y,
                       stop_tol):
        return False, STATUS_BREAKDOWN
    return solved, istatus


def breakdown_resid_recheck(solved: bool, istatus: int, resid_est: float,
                            stop_tol: float, b, A, C_op, M, mstate, x, y):
    """Re-judge ``solved`` from a freshly computed residual on
    breakdown-class exits (cpgmres.m:167-171 style: one A matvec, one C
    matvec, one preconditioner application, one coupled norm).  Returns
    ``(solved, resid)``."""
    if istatus not in (STATUS_INDEFINITE, STATUS_BREAKDOWN):
        return solved, resid_est
    u = b - A.matvec(x)
    t = C_op.matvec(y)
    _, w1, w2, _ = M.apply_nm(mstate, u, -t)
    q1 = y - w2
    dot = coupled_dot(u, w1, t, q1)
    resid_true = float(torch.sqrt(torch.clamp(dot, min=0.0)))
    return resid_true <= stop_tol, resid_true
