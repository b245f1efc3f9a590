"""Example 2 on the PyTorch port: nonsymmetric 3x3-block permuted CVXQP
system, CP-GMRES.

The port's counterpart of ``examples/exprog2.py`` (the reference example
program cpk_exprog2.m): solves the nonsymmetric permuted interior-point KKT
system of ``cvxqp2-s`` (725x725, n=500, m=225) with the restarted
constraint-preconditioned GMRES kernel (restart=100) in f64, validates
against a sparse direct solve, and plots the residual history where
matplotlib is installed.

Run:  python examples/exprog2_torch.py              (on the CUDA card)
      python examples/exprog2_torch.py --device cpu
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
ap.add_argument("--plot", default="exprog2_torch_resid.png",
                help="where to write the residual plot")
args = ap.parse_args()

# -- load the fixture and slice the blocks (cpk_exprog2.m:47-66) ------------
sys_ = load_fixture("cvxqp2_s")
asym = abs(sys_.A - sys_.A.T).max()
print(f"system {sys_.name}: n={sys_.n} m={sys_.m} "
      f"nnz(K)={sys_.K.nnz}  max|A-A'|={asym:.3g}")

# -- solver selection (cpk_exprog2.m:69-74): nonsymmetric A -> Arnoldi family
method = "cpgmres"            # with opts.restart = 100
# method = "cpdqgmres"        # with opts.mem = 100

# -- options (cpk_exprog2.m:79-92) ------------------------------------------
opts = cpt.SolverOptions(atol=1.0e-6, rtol=1.0e-6, itmax=500,
                         restart=100, mem=100)
precond_opts = cpt.PrecondOptions(residual_update=True, nitref=1,
                                  force_itref=True)

# -- solve (cpk_exprog2.m:96) -----------------------------------------------
out = cpt.solve(method, sys_.b, sys_.A, sys_.B, sys_.C, sys_.G,
                opts=opts, precond_opts=precond_opts, dtype=torch.float64,
                device=args.device)

# -- validate against the sparse direct solve (cpk_exprog2.m:99-103) --------
x_direct = spla.spsolve(sys_.K.tocsc(), sys_.b)
x = out.x.cpu().numpy()
relerr = np.linalg.norm(x - x_direct) / np.linalg.norm(x_direct)

print(f"device     : {out.x.device}")
print(f"solver     : {method}(restart={opts.restart})")
print(f"solved     : {out.solved}  (status: {out.result.status})")
print(f"iterations : {out.niters}")
print(f"rel. error : {relerr:.2e}")
print(f"ptime      : {out.ptime:.3f} s   (preconditioner build)")
print(f"stime      : {out.stime:.3f} s   (solve)")

# -- residual-history plot (cpk_exprog2.m:106-116) --------------------------
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
    ax.set_title(f"{method}({opts.restart}) on {sys_.name}")
    ax.grid(True, which="both", alpha=0.3)
    fig.tight_layout()
    fig.savefig(args.plot, dpi=120)
    print(f"plot       : {args.plot}")
