"""Distributed CP-MINRES, hand-fused, on row shards.

Counterpart of ``cpkrylov_tpu/parallel/cpminres.py``: the CPMINRES
recurrence written out for the b2 = 0 system [A B'; B -C][x; y] = [b1; 0],
with its vectors as this rank's slices.  A and C products run by halo
exchange when a ``HaloBlock`` is given, else on the all-gathered operand;
each coupled dot ``dot(u, v) + dot(t, q)`` is one local sum and one
all-reduce; the scalar recurrence state is replicated; the preconditioner
runs on the slices when its Schur factor allows it with lean options, else
on gathered vectors (``solve.ShardedPrecond``).  The host reads the
stopping quantities once per iteration, as the serial kernels do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import SolverOptions
from ..precond.cp import CPPrecond
from ..solvers.common import eps100, safe_normalize_pair
from .halo import HaloBlock
from .partition import PartitionedBlocks
from .solve import GatherBlock, ShardedPrecond, block_matvec


def dist_cpminres(comm, blocks: PartitionedBlocks, M: CPPrecond,
                  b_loc: torch.Tensor, opts: SolverOptions | None = None,
                  halo_a: HaloBlock | None = None,
                  halo_c: HaloBlock | None = None):
    """Solve on ``comm``'s ranks; returns ``(x_loc, y_loc, niters, resid,
    hist)``: this rank's slices of x and y, the iteration count, the last
    residual estimate and the host history (NaN-padded to itmax + 1).

    ``b_loc`` is this rank's (n_loc,) slice of b1 (``partition.
    shard_vector``).  ``itmax`` defaults to the global n."""
    opts = opts or SolverOptions()
    n_loc, m_loc = blocks.n_loc, blocks.m_loc
    itmax = int(opts.itmax) if opts.itmax is not None else blocks.n
    dtype = b_loc.dtype
    e100 = eps100(dtype)
    amv = block_matvec(halo_a if halo_a is not None
                       else GatherBlock(blocks.a, blocks.n), comm)
    cmv = block_matvec(halo_c if halo_c is not None
                       else GatherBlock(blocks.c, blocks.m), comm)
    Msh = ShardedPrecond(M, comm, n_loc, m_loc)

    def pdot(u, v, t=None, q=None):
        """dot(u, v) (+ dot(t, q)), summed locally and all-reduced once."""
        d = torch.dot(u, v)
        return comm.allreduce_sum(d if t is None else d + torch.dot(t, q))

    zeron = torch.zeros(n_loc, dtype=dtype, device=b_loc.device)
    zerom = torch.zeros(m_loc, dtype=dtype, device=b_loc.device)

    mstate = Msh.init_state(dtype)
    mstate, w1, w2, _ = Msh.apply_nm(mstate, b_loc, zerom)
    beta0 = pdot(b_loc, w1)
    # relative threshold, as the serial kernels' initial_lanczos_pair
    indefinite = beta0 < -e100 * (1 + torch.abs(beta0))
    beta = torch.sqrt(torch.abs(beta0))
    vkp1, qkp1 = safe_normalize_pair(w1, -w2, beta)

    resid0, indef0 = torch.stack([beta, indefinite.to(dtype)]).tolist()
    stop_tol = opts.atol + opts.rtol * resid0
    hist = np.full(itmax + 1, np.nan)
    hist[0] = resid0
    k, resid, indef = 0, resid0, bool(indef0)
    x, y, vk, qk = zeron, zerom, zeron, zerom
    zero = torch.zeros((), dtype=dtype, device=b_loc.device)
    deltabar, epsln, taubar = zero, zero, beta
    cs, sn = torch.full_like(zero, -1.0), zero
    wv, wq, wv2, wq2 = vkp1, qkp1, zeron, zerom

    # the JAX package's while_loop: the body runs whole, then the test
    while resid > stop_tol and k < itmax and not indef:
        k += 1
        vkm1, qkm1 = vk, qk
        vk, qk = vkp1, qkp1
        u = amv(vk)
        t = cmv(qk)
        alpha = pdot(u, vk, t, qk)
        mstate, w1, w2, _ = Msh.apply_nm(mstate, u, -t)
        vkp1 = w1 - alpha * vk - beta * vkm1
        qkp1 = (qk - w2) - alpha * qk - beta * qkm1
        beta2 = pdot(u, vkp1, t, qkp1)
        indefinite = beta2 < -e100 * (1 + torch.abs(alpha))
        beta = torch.sqrt(torch.abs(beta2))
        vkp1, qkp1 = safe_normalize_pair(vkp1, qkp1, beta)

        oldeps = epsln
        delta = cs * deltabar + sn * alpha
        gammabar = sn * deltabar - cs * alpha
        epsln = sn * beta
        deltabar = -cs * beta
        gamma = torch.hypot(gammabar, beta)
        cs = gammabar / gamma
        sn = beta / gamma
        tau = cs * taubar
        taubar = sn * taubar

        wv1, wq1 = wv2, wq2
        wv2, wq2 = wv, wq
        wv = (vk - oldeps * wv1 - delta * wv2) / gamma
        wq = (qk - oldeps * wq1 - delta * wq2) / gamma
        x = x + tau * wv
        y = y - tau * wq
        resid, indef = torch.stack([taubar, indefinite.to(dtype)]).tolist()
        indef = bool(indef)
        hist[k] = resid
    return x, y, k, resid, hist
