"""Typed solver and preconditioner options.

Port of ``cpkrylov_tpu/config.py``: the same frozen dataclasses with the
same defaults, holding the fields the ported code reads.
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
    """Options of the Krylov kernels.

    Defaults mirror the reference kernels (atol/rtol 1e-6 everywhere,
    e.g. kernels/cpminres.m:93-96; restart=50 kernels/cpgmres.m:103;
    mem=50 kernels/cpdqgmres.m:103; btol=0 kernels/cpcglanczos.m:112).
    ``itmax`` defaults are kernel-specific (n for the Lanczos family, n+m for
    the Arnoldi family) and resolved by each kernel when left as None.
    """

    atol: float = 1.0e-6
    rtol: float = 1.0e-6
    itmax: int | None = None
    btol: float = 0.0        # cpcglanczos backward-error tolerance
    restart: int = 50        # cpgmres restart length
    mem: int = 50            # cpdqgmres memory
    reorth: bool = False     # cpgmres second orthogonalization pass
    #                          (documented but unimplemented in the
    #                          reference, cpgmres.m:81-82)
    verbose: bool = False    # per-iteration printing
    stagwin: int = 0         # stop after this many iterations without a
    #                          10% improvement of the best residual (0 = off)
