"""Blocked substitution: the hand-written CUDA kernel B9
(``csrc/block_tri.cu``), its wrapper, and its plain PyTorch version.

Counterpart of the JAX package's ``precond/trisolve.py::block_tri_solve``,
an XLA ``fori_loop`` over the panels (no Pallas kernel).  For a factor
packed by ``trisolve.build_block_tri`` (panel inverses ``inv_diag``, the
off-panel entries in ELL rows ``off_data`` / ``off_cols`` with each row's
``off_counts``), ``block_tri`` solves T x = b as

    x_i = inv_i (b_i - off_i x),    i = 0 .. nb-1 in order,

in one launch on a CUDA tensor: one thread block cluster walks the panels,
reading each row's counted entries and the lower triangle of each inverse
(the kernel's source says how).  A CPU tensor goes to the plain version,
``block_tri_solve_plain``, the panel loop of the JAX package.  The
kernel sums in a fixed order of its own, so it repeats its bits from call
to call and agrees with the plain version to rounding.  ``LAUNCHES`` counts
the kernel's launches, one a solve.
"""
from __future__ import annotations

import torch

from .. import _build
from .trisolve import BlockTriFactor

LAUNCHES = 0

MAX_PANEL = 1024         # csrc/block_tri.cu kMaxPanel
MAX_ENTRIES = 1 << 31    # the kernel indexes x with int32 columns

_ENTRY = {torch.float32: "cpkt_block_tri_f32",
          torch.float64: "cpkt_block_tri_f64"}


def block_tri_solve_plain(tf: BlockTriFactor,
                          b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of blocked substitution (trisolve.py:156-175
    of the JAX package): one panel after another, each a gather of x over
    the whole ELL row (padding included) and a dense panel product."""
    panel = tf.panel
    n_pad = tf.nblocks * panel
    x = torch.zeros(n_pad, dtype=b.dtype, device=b.device)
    b_pad = torch.zeros(n_pad, dtype=b.dtype, device=b.device)
    b_pad[: tf.n] = b
    od_all = tf.off_data.to(b.dtype)
    inv_all = tf.inv_diag.to(b.dtype)
    for i in range(tf.nblocks):
        r0 = i * panel
        od = od_all[r0: r0 + panel]
        oc = tf.off_cols[r0: r0 + panel].long()
        contrib = (od * x[oc]).sum(dim=1)
        rhs = b_pad[r0: r0 + panel] - contrib
        x[r0: r0 + panel] = inv_all[i] @ rhs
    return x[: tf.n]


def _check(tf: BlockTriFactor, b: torch.Tensor) -> None:
    """Raise on anything the kernel does not take (a CUDA ``b``)."""
    p, nb = tf.panel, tf.nblocks
    n_pad = nb * p
    if n_pad >= MAX_ENTRIES:
        raise ValueError(f"block_tri: needs nblocks * panel < 2**31, got "
                         f"{n_pad}")
    if b.dtype not in _ENTRY:
        raise TypeError(f"block_tri: unsupported dtype {b.dtype}")
    if b.device.type != "cuda":
        raise ValueError(f"block_tri: unsupported device {b.device}")
    if not 1 <= p <= MAX_PANEL:
        raise ValueError(f"block_tri: panel {p} outside 1..{MAX_PANEL}")
    K = int(tf.off_data.shape[1])
    for label, t, dtype, shape in (
            ("inv_diag", tf.inv_diag, b.dtype, (nb, p, p)),
            ("off_data", tf.off_data, b.dtype, (n_pad, K)),
            ("off_cols", tf.off_cols, torch.int32, (n_pad, K)),
            ("off_counts", tf.off_counts, torch.int32, (n_pad,))):
        if t.dtype != dtype:
            raise TypeError(f"block_tri: {label} dtype {t.dtype} != {dtype}")
        if t.device != b.device:
            raise ValueError(f"block_tri: {label} on {t.device}, not "
                             f"{b.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"block_tri: {label} must be a contiguous "
                             f"{shape} tensor, got {tuple(t.shape)}")


def block_tri(tf: BlockTriFactor, b: torch.Tensor) -> torch.Tensor:
    """B9: solve T x = b for a blocked-substitution factor; the CUDA kernel
    for a CUDA tensor, else the plain version."""
    global LAUNCHES
    if b.dim() != 1 or b.shape[0] != tf.n:
        raise ValueError(f"rhs has shape {tuple(b.shape)}, expected "
                         f"({tf.n},)")
    if b.device.type == "cpu":
        return block_tri_solve_plain(tf, b)
    _check(tf, b)
    b = b.contiguous()
    p, nb = tf.panel, tf.nblocks
    x = torch.empty(nb * p, dtype=b.dtype, device=b.device)
    stream = torch.cuda.current_stream(b.device).cuda_stream
    status = getattr(_build.kernel_library(), _ENTRY[b.dtype])(
        tf.inv_diag.data_ptr(), tf.off_data.data_ptr(),
        tf.off_cols.data_ptr(), tf.off_counts.data_ptr(), b.data_ptr(),
        x.data_ptr(), tf.n, p, nb, int(tf.off_data.shape[1]), stream)
    _build.check(status, "block_tri")
    LAUNCHES += 1
    return x[: tf.n]
