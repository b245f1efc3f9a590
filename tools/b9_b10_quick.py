"""A short check of kernels B9 and B10 on the card, for a change to either.

Runs ``chip_smoke.py``'s own holds, without its other phases: blocked
substitution (B9, ``chip_smoke.hold_block_tri``) on cvxqp1_m's triangles
at panels 256 and ``chip_smoke.WIDE_PANEL`` and, timed, on CVXQP3-L's;
the df64 triangle product (B10, ``chip_smoke.hold_df_tri``) bit for bit on
both df64 triangles of each, CVXQP3-L's timed and its t1 also with the
special x[0].  About a minute on the card:

    python3 tools/b9_b10_quick.py
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("b9_b10_quick: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from cpkrylov_tpu_torch.precond.cp import factorize_kp
    from cpkrylov_tpu_torch.precond.df_factor import _pack_df_tri
    from cpkrylov_tpu_torch.precond.trisolve import build_block_tri
    from cpkrylov_tpu_torch.utils.fixtures import load_fixture
    from cpkrylov_tpu_torch.utils.mm import cvxqp_kkt

    f = load_fixture("cvxqp1_m")
    s = cvxqp_kkt("cvxqp3", "l")
    for name, sysm, timing in (("cvxqp1_m", f, False),
                               ("cvxqp3_l", s, True)):
        hf = factorize_kp(sysm.G, sysm.B, sysm.C)
        L1, U = chip_smoke.triangles(hf.fac, hf.n + hf.m)
        panels = (256,) if timing else (256, chip_smoke.WIDE_PANEL)
        for label, T in (("L", L1), ("U", U)):
            for panel in panels:
                tf = build_block_tri(T, torch.float64, "cuda", panel=panel)
                chip_smoke.hold_block_tri(f"{name} {label} panel={panel}",
                                          tf, "cuda", T=T, timing=timing)
        for tag, T in (("t1", L1), ("t2", U)):
            chip_smoke.hold_df_tri(f"{name} {tag}", _pack_df_tri(T, "cuda"),
                                   "cuda", timing=timing,
                                   special=timing and tag == "t1")
    print("card " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
