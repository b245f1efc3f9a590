"""Example 1 on the PyTorch port: symmetric 2x2-block CVXQP saddle-point
system, CP-MINRES.

The port's counterpart of ``examples/exprog1.py`` (the reference example
program cpk_exprog1.m): solves the interior-point KKT system of the CUTEst
QP ``cvxqp1-m`` (iteration 10; 5500x5500, n=3000, m=2500) with the
constraint-preconditioned MINRES kernel in f64, validates against a sparse
direct solve, and plots the residual history where matplotlib is installed.

Run:  python examples/exprog1_torch.py              (on the CUDA card)
      python examples/exprog1_torch.py --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import scipy.sparse.linalg as spla
import torch

import cpkrylov_tpu_torch as cpt
from cpkrylov_tpu_torch.utils.fixtures import load_fixture

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
ap.add_argument("--plot", default="exprog1_torch_resid.png",
                help="where to write the residual plot")
args = ap.parse_args()

# -- load the fixture and slice the blocks (cpk_exprog1.m:45-64) ------------
sys_ = load_fixture("cvxqp1_m")
print(f"system {sys_.name}: n={sys_.n} m={sys_.m} "
      f"nnz(K)={sys_.K.nnz}")

# G = diag(diag(Q)): the Jacobi approximation of the leading block
# (cpk_exprog1.m:59-64) is already attached by load_fixture as sys_.G.

# -- solver selection (cpk_exprog1.m:67-74) ---------------------------------
method = "cpminres"
# method = "cpcg"
# method = "cpcglanczos"
# method = "cpdqgmres"        # with opts.mem = 2

# -- options (cpk_exprog1.m:79-92) ------------------------------------------
opts = cpt.SolverOptions(atol=1.0e-6, rtol=1.0e-6, itmax=500, mem=2)
precond_opts = cpt.PrecondOptions(residual_update=True, nitref=1,
                                  force_itref=True)

# -- solve (cpk_exprog1.m:97) -----------------------------------------------
out = cpt.solve(method, sys_.b, sys_.A, sys_.B, sys_.C, sys_.G,
                opts=opts, precond_opts=precond_opts, dtype=torch.float64,
                device=args.device)

# -- validate against the sparse direct solve (cpk_exprog1.m:100-104) -------
x_direct = spla.spsolve(sys_.K.tocsc(), sys_.b)
x = out.x.cpu().numpy()
relerr = np.linalg.norm(x - x_direct) / np.linalg.norm(x_direct)

print(f"device     : {out.x.device}")
print(f"solver     : {method}")
print(f"solved     : {out.solved}  (status: {out.result.status})")
print(f"iterations : {out.niters}")
print(f"rel. error : {relerr:.2e}")
print(f"ptime      : {out.ptime:.3f} s   (preconditioner build)")
print(f"stime      : {out.stime:.3f} s   (solve)")

# -- residual-history plot (cpk_exprog1.m:110-117) --------------------------
try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
except ImportError:  # machines without matplotlib: no plot
    plt = None
if plt is not None:
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.semilogy(out.resid_history, lw=1.5)
    ax.set_xlabel("iteration")
    ax.set_ylabel("residual norm")
    ax.set_title(f"{method} on {sys_.name}")
    ax.grid(True, which="both", alpha=0.3)
    fig.tight_layout()
    fig.savefig(args.plot, dpi=120)
    print(f"plot       : {args.plot}")
