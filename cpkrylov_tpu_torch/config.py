"""Typed solver and preconditioner options.

Port of ``cpkrylov_tpu/config.py``: the same frozen dataclasses with the
same defaults, holding only the fields the ported code reads.  Options of
parts not ported yet (the GMRES and CG-Lanczos solvers) come with those
parts, so setting them cannot be silently ignored.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PrecondOptions:
    """Options of the constraint-preconditioner operator (opLDL2 defaults)."""

    nitref: int = 3                 # max iterative-refinement steps
    itref_tol: float = 1.0e-8       # refinement trigger: rNorm >= tol * xNorm
    force_itref: bool = False       # always run nitref steps
    residual_update: bool = False   # Gould-Hribar-Nocedal residual update
    apply_df64: bool | str = "auto"  # df64-applied factor at f32
    #                                  (precond/df_factor.py): "auto" when the
    #                                  build probe finds the plain f32 apply
    #                                  unusable, True always, False never

    def __post_init__(self):
        object.__setattr__(self, "nitref", max(0, int(round(self.nitref))))
        object.__setattr__(self, "itref_tol", max(0.0, self.itref_tol))


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Options of the Krylov kernels (reference defaults: atol and rtol
    1e-6; ``itmax`` None resolves per kernel, n for CPMINRES)."""

    atol: float = 1.0e-6
    rtol: float = 1.0e-6
    itmax: int | None = None
    verbose: bool = False    # per-iteration printing
    stagwin: int = 0         # stop after this many iterations without a
    #                          10% improvement of the best residual (0 = off)
