"""A short check of kernel B5 (the CSR SpMV) on the card, for a change to
it, and the readings behind its tile size.

Runs ``chip_smoke.py``'s own B5 hold (``chip_smoke.hold_csr_spmv``),
without its other phases, at the four operands that phase times: CVXQP3-L's
A, K_P and B' and AUG2D-L's K_P (``utils/mm.py``, K_P assembled in natural
order), f64 and f32 bit for bit against the plain version, a second call
and the thread-a-row kernel (``tools/csr_spmv_rowthread.cu``), and timed in
f64: rotated and warm device ms in turns with the thread-a-row kernel, the
library call, and the launch floor.  With ``--tiles`` it then reads, at
each operand, B5 packed with tiles of 256, 512, 768 and 1024 entries
(``ops/formats.py`` picks one by ``csr_tile``) in turns with the
thread-a-row kernel (each once forward, once back), rotated and warm, and
the device time of an empty kernel on each tiling's grid.  About a minute
on the card, two with ``--tiles``:

    python3 tools/b5_quick.py [--tiles]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TILES = (256, 512, 768, 1024)


def tile_turns(label, mat, device):
    """B5 at each of TILES and the thread-a-row kernel, read in turns."""
    import torch

    import chip_smoke as cs
    from cpkrylov_tpu_torch.ops.cuda_spmv import csr_matvec_plain, csr_spmv
    from cpkrylov_tpu_torch.ops.formats import (TILE_THREADS,
                                                csr_from_scipy, csr_tiles)

    def retile(c, tile):
        return dataclasses.replace(c, tile=tile, tiles=torch.as_tensor(
            csr_tiles(c.indptr.cpu().numpy(), tile), device=device))

    f64 = torch.float64
    nrows, ncols = mat.shape
    base = csr_from_scipy(mat, f64, device, transpose=False)
    x = torch.randn(ncols, dtype=f64, device=device)
    plain = csr_matvec_plain(base, x)
    sets = cs._operand_sets(
        12 * base.nnz + 8 * nrows + 8 * ncols,
        lambda: (csr_from_scipy(mat, f64, device, transpose=False),
                 torch.randn_like(x)), (base, x))
    calls = [("rowthread", sets, cs.csr_rowthread)]
    for tile in TILES:
        tiled = [(retile(c, tile), v) for c, v in sets]
        if not torch.equal(csr_spmv(retile(base, tile), x), plain):
            raise RuntimeError(f"csr_spmv {label} tile={tile}: differs from "
                               "its plain version")
        calls.append((f"tile{tile}", tiled, csr_spmv))
    read = {}
    for name, ops, fn in calls + calls[::-1]:
        read.setdefault(name, []).append(cs.device_ms(fn, ops))
        read.setdefault(name + "_warm", []).append(cs.device_ms(fn, ops[:1]))
    for name, ops, _ in calls[1:]:
        blocks = ops[0][0].tiles.shape[0] - 1
        read[name + "_floor"] = [cs.device_ms(
            lambda c, v, blocks=blocks: cs.empty_launch(blocks, TILE_THREADS),
            ops[:1])]
        read[name + "_blocks"] = [blocks]
    print(f"b5_tiles float64 {label} nnz={base.nnz} packed_tile={base.tile} "
          + " ".join(f"{k}={[v if isinstance(v, int) else cs._fmt(v) for v in vs]}"
                     for k, vs in read.items()), flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", action="store_true",
                    help="also read B5 at tiles of 256-1024 entries")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b5_quick: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from cpkrylov_tpu_torch import _build
    from cpkrylov_tpu_torch.precond.cp import assemble_kp
    from cpkrylov_tpu_torch.utils.mm import aug_kkt, cvxqp_kkt

    chip_smoke.start_rowthread_build()
    _build.build_kernels()
    q = cvxqp_kkt("cvxqp3", "l")
    a = aug_kkt("2d", "l")
    operands = (("A cvxqp3_l", q.A),
                ("K_P cvxqp3_l", assemble_kp(q.G, q.B, q.C)),
                ("Bt cvxqp3_l", q.B.T.tocsr()),
                ("K_P aug2d_l", assemble_kp(a.G, a.B, a.C)))
    for label, mat in operands:
        chip_smoke.hold_csr_spmv(label, mat, "cuda")
    if args.tiles:
        for label, mat in operands:
            tile_turns(label, mat, torch.device("cuda", 0))
    print("card " + chip_smoke.nvidia_smi_card())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
