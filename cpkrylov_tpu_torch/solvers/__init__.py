"""Constraint-preconditioned Krylov kernels: the Lanczos family (CPCG,
CP-CG-Lanczos, CPMINRES, CPSYMMLQ) and the Arnoldi family (CPGMRES(l),
CPDQGMRES), one module each, named after its kernel function."""
from . import cpcg, cpcglanczos, cpdqgmres, cpgmres, cpminres, cpsymmlq

# kernel name -> kernel function: the driver's registry
SOLVERS = {"cpcg": cpcg.cpcg, "cpcglanczos": cpcglanczos.cpcglanczos,
           "cpminres": cpminres.cpminres, "cpsymmlq": cpsymmlq.cpsymmlq,
           "cpgmres": cpgmres.cpgmres, "cpdqgmres": cpdqgmres.cpdqgmres}
