"""Constraint-preconditioned Krylov kernels."""
