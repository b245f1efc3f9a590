"""The true residual of a saddle-point answer, in float64 on the host.

The plain reference of every cell: given the blocks that the benchmark
made and handed to the program, and the program's answer x = [x1; x2], it
works out

    r = b - [A B'; B -C] x

with scipy's sparse products in float64, and judges the answer by the
ratio of ||r|| to the solver's stopping contract ``atol + rtol * ||b||``.
It imports nothing of the program: what the program derived from the
blocks (device layouts, orderings, factors) plays no part.
"""
from __future__ import annotations

import numpy as np


def residual_ratio(A, B, C, b, x, atol: float, rtol: float) -> float:
    """||b - K x|| / (atol + rtol ||b||), or inf for a non-finite x."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    if not np.all(np.isfinite(x)):
        return float("inf")
    n = A.shape[0]
    x1, x2 = x[:n], x[n:]
    r1 = b[:n] - (A @ x1 + B.T @ x2)
    r2 = b[n:] - (B @ x1 - C @ x2)
    rnorm = float(np.sqrt(r1 @ r1 + r2 @ r2))
    return rnorm / (atol + rtol * float(np.linalg.norm(b)))
