"""Where one panel of blocked substitution (B9) spends its time on the card.

Builds CVXQP3-L's factor with the port (``utils/mm.py``, the JAX sweep's
system, RCM ordering, panels of 256) and solves with L and U in f64 and
f32 through ``tools/b9_breakdown.cu``, compiled with nvcc into
``build/b9_breakdown/``: the panel walk of ``csrc/block_tri.cu`` as first
ported (an 8-block cluster, rows in consecutive runs over the blocks, a
warp a row, two cluster barriers a panel), with clock stamps.  Per panel,
from the stamps of every warp: ``gathers`` (the slowest warp's off-panel
gathers), ``barrier1`` and ``barrier2`` (the shortest wait at each
barrier: the wait of the warp that arrived last, the barrier's own cost),
``inverse`` (the slowest warp's row of inv_i against rhs), and ``panel``
(the median warp's time from the panel's top to its last barrier), each
summed over the heavy panels (the fewest that hold 95 % of the off
entries) and the light ones.  The SM clock's rate comes from
%globaltimer over the launch.  One stamped solve after three warm ones;
the stamped walk and the package's kernel (``kernel_ms``) are timed
beside each other by CUDA events, operands warm.

Run on the card from the repository's root:

    python3 tools/b9_panel_breakdown.py [--json b9_breakdown.json]
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = os.path.join(ROOT, "tools", "b9_breakdown.cu")
BUILD = os.path.join(ROOT, "build", "b9_breakdown")
WARPS = 32
CLUSTER = 8


def build_library():
    """The stamped walk, compiled with the package's nvcc flags."""
    from cpkrylov_tpu_torch import _build

    os.makedirs(BUILD, exist_ok=True)
    out = os.path.join(BUILD, "libb9_breakdown.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
                    "-o", out, SOURCE], check=True)
    dll = ctypes.CDLL(out)
    P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name in ("b9_stamped_f32", "b9_stamped_f64"):
        f = getattr(dll, name)
        f.argtypes = [P, P, P, P, P, P, I64, I32, I64, I32, P, P, P]
        f.restype = ctypes.c_int
    return dll


def heavy_panels(tf) -> tuple:
    """(entries a panel, mask of the fewest panels holding 95 % of them)."""
    p, nb = tf.panel, tf.nblocks
    ent = tf.off_counts.cpu().numpy().reshape(nb, p).sum(axis=1)
    order = np.argsort(-ent, kind="stable")
    cum = np.cumsum(ent[order])
    nheavy = int(np.searchsorted(cum, 0.95 * cum[-1]) + 1)
    heavy = np.zeros(nb, bool)
    heavy[order[:nheavy]] = True
    return ent, heavy


def summarize(out, ent, heavy, parts: dict) -> dict:
    """Sums of each per-panel part over the heavy and the light panels."""
    for name, sel in (("heavy", heavy), ("light", ~heavy)):
        out[name] = {"panels": int(sel.sum()),
                     "entries": int(ent[sel].sum()),
                     **{f"{k}_us": round(float(v[sel].sum()), 3)
                        for k, v in parts.items()}}
        out[name]["per_panel_us"] = round(
            out[name]["panel_us"] / max(1, int(sel.sum())), 3)
    keys = list(parts)
    out["per_panel_columns"] = ["panel", "entries", *keys]
    out["per_panel"] = [[int(i), int(ent[i]),
                         *(round(float(parts[k][i]), 3) for k in keys)]
                        for i in range(len(ent))]
    return out


def breakdown(dll, tf, dtype, label: str) -> dict:
    """The stamped walk on one triangle, beside the package's kernel."""
    import torch

    from cpkrylov_tpu_torch.precond.cuda_block_tri import block_tri
    from cpkrylov_tpu_torch.utils.timing import cuda_time_ms

    dev = tf.inv_diag.device
    tfd = tf if dtype == tf.inv_diag.dtype else dataclasses.replace(
        tf, inv_diag=tf.inv_diag.to(dtype), off_data=tf.off_data.to(dtype))
    inv, od = tfd.inv_diag, tfd.off_data
    p, nb, K = tf.panel, tf.nblocks, int(od.shape[1])
    rng = np.random.default_rng(17)
    b = torch.as_tensor(rng.standard_normal(tf.n), dtype=dtype, device=dev)
    x = torch.empty(nb * p, dtype=dtype, device=dev)
    stamps = torch.zeros(nb * CLUSTER * WARPS * 5, dtype=torch.int64,
                         device=dev)
    clock = torch.zeros(4, dtype=torch.int64, device=dev)
    fn = getattr(dll, "b9_stamped_f64" if dtype == torch.float64
                 else "b9_stamped_f32")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        st = fn(inv.data_ptr(), od.data_ptr(), tf.off_cols.data_ptr(),
                tf.off_counts.data_ptr(), b.data_ptr(), x.data_ptr(), tf.n,
                p, nb, K, stamps.data_ptr(), clock.data_ptr(), stream)
        if st != 0:
            raise RuntimeError(f"stamped kernel: CUDA error {st}")

    for _ in range(4):
        run()
    torch.cuda.synchronize()
    stamped_ms = cuda_time_ms(run, iters=20, warmup=2)
    kernel_ms = cuda_time_ms(lambda: block_tri(tfd, b), iters=20, warmup=2)
    run()
    torch.cuda.synchronize()
    c = clock.cpu().numpy().astype(np.float64)
    ghz = (c[3] - c[1]) / (c[2] - c[0])          # cycles per ns
    s = stamps.cpu().numpy().reshape(nb, CLUSTER, WARPS, 5)
    warps = min(-(-p // CLUSTER), WARPS)
    s = s[:, :, :warps, :].astype(np.float64)
    d = np.diff(s, axis=3) / ghz / 1e3             # microseconds
    parts = {"panel": np.median((s[..., 4] - s[..., 0]) / ghz / 1e3,
                                axis=(1, 2)),
             "gathers": d[..., 0].max(axis=(1, 2)),
             "barrier1": d[..., 1].min(axis=(1, 2)),
             "inverse": d[..., 2].max(axis=(1, 2)),
             "barrier2": d[..., 3].min(axis=(1, 2))}
    ent, heavy = heavy_panels(tf)
    out = {"what": label, "dtype": str(dtype).split(".")[1], "panels": nb,
           "panel_rows": p, "off_entries": int(ent.sum()),
           "sm_ghz": round(float(ghz), 4),
           "stamped_kernel_ms": round(stamped_ms, 4),
           "kernel_ms": round(kernel_ms, 4)}
    return summarize(out, ent, heavy, parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None,
                    help="write the per-panel tables here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("b9_panel_breakdown: no CUDA device", file=sys.stderr)
        return 2
    import cpkrylov_tpu_torch as cpt
    from cpkrylov_tpu_torch.precond.cp import build_precond, factorize_kp
    from cpkrylov_tpu_torch.utils.mm import cvxqp_kkt

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    dll = build_library()
    s = cvxqp_kkt("cvxqp3", "l")
    hf = factorize_kp(s.G, s.B, s.C)
    M = build_precond(hf.fac, hf.ksp, hf.n, hf.m,
                      options=cpt.PrecondOptions(), panel=256,
                      dtype=torch.float64, device="cuda",
                      base_order=hf.base_order)
    results = []
    for label, tf in (("cvxqp3_l L", M.factor.tf1),
                      ("cvxqp3_l U", M.factor.tf2)):
        for dtype in (torch.float64, torch.float32):
            r = breakdown(dll, tf, dtype, label)
            r["card"] = card
            results.append(r)
            print("b9_breakdown " + json.dumps(
                {k: v for k, v in r.items()
                 if not k.startswith("per_panel")}), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(results, fh)
    print(f"card {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
