"""Banded triangular solves: the hand-written CUDA kernels B4 (reduced-state
scan solve) and B6 (affine scan of the tail states) in
``csrc/band_tri.cu``, their wrappers, and their plain PyTorch versions.

Counterpart of the JAX package's ``precond/pallas_tri.py``: B4 replaces
``_fused_tri_kernel`` (``pallas_tri_solve``), B6 ``_affine_scan_kernel``
(``affine_lane_scan``).  A factor of reach 2..1024 (an RCM-ordered KKT
factor) is packed as ``trisolve.ReducedScanTriFactor``; ``band_tri_solve``
computes x = T^-1 b for it as

    c_i = inv_i b_i,   s_i = -W_i[p-r:] s_{i-1} + c_i[p-r:],
    x_i = c_i - W_i s_{i-1}.

``band_tri_solve`` launches B4's c kernel, then B6 on W's tail rows and
c's tail entries in place (through the same launcher as ``affine_scan``,
which counts it), then B4's x kernel, and counts one B4 solve: ``LAUNCHES``
for B4 and ``SCAN_LAUNCHES`` for B6 are each added to where their kernels
are launched.  ``affine_scan(mr, cr)`` is B6 under the JAX contract: ``mr
(r, r, nb)``, ``cr (r, nb)`` -> the inclusive ``s (r, nb)`` from a zero
state; it takes any strides.

On a CUDA tensor each wrapper launches its kernel and raises on anything it
does not take; a CPU tensor goes to the plain version
(``band_tri_solve_plain``, ``affine_scan_plain``).  The plain scan is the
sequential recurrence; the kernel sums each dot product in another order,
so the two agree to rounding, not bit for bit.
"""
from __future__ import annotations

import torch

from .. import _build
from .trisolve import ReducedScanTriFactor, reduced_scan_tri_solve_plain

LAUNCHES = 0        # B4 solves
SCAN_LAUNCHES = 0   # B6 scans (alone, or inside a B4 solve)

MAX_PANEL = 1024    # csrc/band_tri.cu kMaxPanel: largest p and r

_C_ENTRY = {torch.float32: "cpkt_band_c_f32",
            torch.float64: "cpkt_band_c_f64"}
_X_ENTRY = {torch.float32: "cpkt_band_x_f32",
            torch.float64: "cpkt_band_x_f64"}
_SCAN_ENTRY = {torch.float32: "cpkt_affine_scan_f32",
               torch.float64: "cpkt_affine_scan_f64"}

# The plain version of B4 is the reduced-scan math of trisolve.py.
band_tri_solve_plain = reduced_scan_tri_solve_plain


def affine_scan_plain(mr: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """Plain version of B6: s_i = mr[:, :, i] s_{i-1} + cr[:, i] from
    s_{-1} = 0, sequentially; returns (r, nb)."""
    r, nb = cr.shape
    s = torch.empty((r, nb), dtype=cr.dtype, device=cr.device)
    state = torch.zeros(r, dtype=cr.dtype, device=cr.device)
    m = mr.to(cr.dtype)
    for i in range(nb):
        state = m[:, :, i] @ state + cr[:, i]
        s[:, i] = state
    return s


def _check_cuda(name: str, ref: torch.Tensor, entry: dict, **tensors):
    if ref.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {ref.device}")
    if ref.dtype not in entry:
        raise TypeError(f"{name}: unsupported dtype {ref.dtype}")
    for label, t in tensors.items():
        if t.dtype != ref.dtype:
            raise TypeError(f"{name}: {label} dtype {t.dtype} != {ref.dtype}")
        if t.device != ref.device:
            raise ValueError(f"{name}: {label} on {t.device}, not "
                             f"{ref.device}")


def _launch_scan(mr: torch.Tensor, cr: torch.Tensor, s: torch.Tensor,
                 alpha: float) -> None:
    """Launch B6 into ``s`` (r, nb): s_i = alpha mr_i s_{i-1} + cr_i, every
    operand read and written through its strides."""
    global SCAN_LAUNCHES
    r, nb = int(cr.shape[0]), int(cr.shape[1])
    lib = _build.kernel_library()
    stream = torch.cuda.current_stream(cr.device).cuda_stream
    msj, msk, msi = mr.stride()
    csj, csi = cr.stride()
    ssj, ssi = s.stride()
    status = getattr(lib, _SCAN_ENTRY[cr.dtype])(
        mr.data_ptr(), msj, msk, msi, alpha, cr.data_ptr(), csj, csi,
        s.data_ptr(), ssj, ssi, r, nb, stream)
    _build.check(status, "affine_scan")
    SCAN_LAUNCHES += 1


def affine_scan(mr: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """B6: the inclusive prefix of s_i = mr[:, :, i] s_{i-1} + cr[:, i];
    the CUDA kernel for a CUDA tensor, else the plain version."""
    if cr.device.type == "cpu":
        return affine_scan_plain(mr, cr)
    _check_cuda("affine_scan", cr, _SCAN_ENTRY, mr=mr)
    if cr.dim() != 2 or mr.dim() != 3:
        raise ValueError("affine_scan: expected mr (r, r, nb) and cr (r, nb)")
    r, nb = int(cr.shape[0]), int(cr.shape[1])
    if tuple(mr.shape) != (r, r, nb):
        raise ValueError(f"affine_scan: mr has shape {tuple(mr.shape)}, "
                         f"expected ({r}, {r}, {nb})")
    if not 1 <= r <= MAX_PANEL:
        raise ValueError(f"affine_scan: r = {r} outside 1..{MAX_PANEL}")
    s = torch.empty((r, nb), dtype=cr.dtype, device=cr.device)
    _launch_scan(mr, cr, s, 1.0)
    return s


def band_tri_solve(tf: ReducedScanTriFactor, b: torch.Tensor) -> torch.Tensor:
    """B4: solve T x = b for a reduced-scan factor; the CUDA kernels for a
    CUDA tensor, else the plain version."""
    global LAUNCHES
    if b.dim() != 1 or b.shape[0] != tf.n:
        raise ValueError(f"rhs has shape {tuple(b.shape)}, expected "
                         f"({tf.n},)")
    if b.device.type == "cpu":
        return band_tri_solve_plain(tf, b)
    _check_cuda("band_tri_solve", b, _C_ENTRY, inv_diag=tf.inv_diag,
                w_blocks=tf.w_blocks)
    p, r, nb = tf.panel, tf.r, tf.nblocks
    if not (1 <= r <= p <= MAX_PANEL):
        raise ValueError(f"band_tri_solve: panel {p}, r {r} outside "
                         f"1 <= r <= p <= {MAX_PANEL}")
    if (tuple(tf.inv_diag.shape) != (nb, p, p)
            or tuple(tf.w_blocks.shape) != (nb, p, r)
            or not tf.inv_diag.is_contiguous()
            or not tf.w_blocks.is_contiguous()):
        raise ValueError("band_tri_solve: inv_diag and w_blocks must be "
                         f"contiguous ({nb}, {p}, {p}) and ({nb}, {p}, {r})")
    b = b.contiguous()
    lib = _build.kernel_library()
    x = torch.empty(tf.n, dtype=b.dtype, device=b.device)
    c = torch.empty(nb * p, dtype=b.dtype, device=b.device)
    s = torch.empty(nb * r, dtype=b.dtype, device=b.device)
    stream = torch.cuda.current_stream(b.device).cuda_stream
    status = getattr(lib, _C_ENTRY[b.dtype])(
        tf.inv_diag.data_ptr(), b.data_ptr(), c.data_ptr(), tf.n, p, nb,
        stream)
    _build.check(status, "band_tri_solve (c = inv b)")
    # the scan on W's tail rows and c's tail entries, read in place; s is
    # written (nb, r) row-major for the x kernel
    _launch_scan(tf.w_blocks[:, p - r:, :].permute(1, 2, 0),
                 c.view(nb, p)[:, p - r:].T, s.view(nb, r).T, -1.0)
    status = getattr(lib, _X_ENTRY[b.dtype])(
        tf.w_blocks.data_ptr(), c.data_ptr(), s.data_ptr(), x.data_ptr(),
        tf.n, p, r, nb, stream)
    _build.check(status, "band_tri_solve (x = c - W s)")
    LAUNCHES += 1
    return x
