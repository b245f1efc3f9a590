"""Permutation application for the preconditioner's direct solve.

Port of ``cpkrylov_tpu/precond/permute.py``.  The factorization ordering is
applied as ``z -> z[perm]`` before the triangular solves and inverted after:

* ``IdentityPermute`` — no-op.
* ``InterleavePermute`` — the structured riffle of the n-part and m-part
  (c x-entries then one y-entry per group, then an x-tail), applied by the
  CUDA kernels B7/B8 (``cuda_interleave.py``) for a CUDA tensor and by their
  plain reshape/concatenation versions on the CPU.  ``make_preconditioner``
  seeds the factorization with it when K_P stays banded under it.
* ``GatherPermute`` — any other permutation (RCM and friends), as an index
  gather.

The JAX package's matmul and masked-shift forms (``MatmulInterleavePermute``,
``DiaPermute``) exist to avoid slow gathers and sub-128-lane relayouts on the
TPU and are not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import upload
from .cuda_interleave import interleave, uninterleave


@dataclasses.dataclass(frozen=True)
class IdentityPermute:
    n: int

    def apply(self, z: torch.Tensor) -> torch.Tensor:        # z[perm] = z
        return z

    def apply_inv(self, z: torch.Tensor) -> torch.Tensor:
        return z


@dataclasses.dataclass(frozen=True)
class InterleavePermute:
    """Proportional riffle of the n-part and m-part, with an x-tail.

        perm[g*(c+1) + j] = g*c + j   (j < c, g < m)
        perm[g*(c+1) + c] = n + g
        perm[m*(c+1) + t] = c*m + t   (tail)
    """

    n: int
    m: int
    c: int

    @property
    def perm(self) -> np.ndarray:
        """The explicit permutation array (host-side, for factorization)."""
        out = np.empty(self.n + self.m, dtype=np.int64)
        grid = np.arange(self.m)
        for j in range(self.c):
            out[grid * (self.c + 1) + j] = grid * self.c + j
        out[grid * (self.c + 1) + self.c] = self.n + grid
        cm = self.c * self.m
        out[self.m * (self.c + 1):] = np.arange(cm, self.n)
        return out

    def apply(self, z: torch.Tensor) -> torch.Tensor:        # z[perm]
        return interleave(z.contiguous(), self.n, self.m, self.c)

    def apply_inv(self, z: torch.Tensor) -> torch.Tensor:    # out[perm] = z
        return uninterleave(z.contiguous(), self.n, self.m, self.c)


@dataclasses.dataclass(frozen=True)
class GatherPermute:
    idx: torch.Tensor       # (n,) int64: apply(z) = z[idx]
    inv_idx: torch.Tensor   # (n,) int64: argsort(idx)

    def apply(self, z: torch.Tensor) -> torch.Tensor:
        return z[self.idx]

    def apply_inv(self, z: torch.Tensor) -> torch.Tensor:
        return z[self.inv_idx]


def interleave_ordering(n: int, m: int,
                        c: int | None = None) -> InterleavePermute | None:
    """The proportional interleave with group size ``c`` (default n // m)."""
    if m <= 0 or n < m:
        return None
    if c is None:
        c = max(1, n // m)
    if c * m > n:
        return None
    return InterleavePermute(n=int(n), m=int(m), c=int(c))


def interleave_candidates(n: int, m: int) -> list:
    """Candidate structured orderings: c = 1 (y_g beside x_g, unit-diagonal
    B blocks) and c = n // m (slope-matched couplings)."""
    cands = []
    for c in sorted({1, max(1, n // m if m else 1)}):
        op = interleave_ordering(n, m, c)
        if op is not None:
            cands.append(op)
    return cands


def plan_permute(perm: np.ndarray, device,
                 base: InterleavePermute | None = None):
    """Cheapest representation of ``z -> z[perm]`` on ``device``."""
    perm = np.asarray(perm)
    n = perm.shape[0]
    if np.array_equal(perm, np.arange(n)):
        return IdentityPermute(n=int(n))
    if (base is not None and base.n + base.m == n
            and np.array_equal(perm, base.perm)):
        return base
    return GatherPermute(
        idx=upload(perm.astype(np.int64), device),
        inv_idx=upload(np.argsort(perm).astype(np.int64), device))
