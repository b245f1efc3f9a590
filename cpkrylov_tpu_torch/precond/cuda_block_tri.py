"""Blocked substitution: the hand-written CUDA kernel B9
(``csrc/block_tri.cu``), its wrapper, and its plain PyTorch version.

Counterpart of the JAX package's ``precond/trisolve.py::block_tri_solve``,
an XLA ``fori_loop`` over the panels (no Pallas kernel).  For a factor
packed by ``trisolve.build_block_tri`` (panel inverses ``inv_diag``, the
off-panel entries in ELL rows ``off_data`` / ``off_cols`` with each row's
``off_counts``), ``block_tri`` solves T x = b as

    x_i = inv_i (b_i - off_i x),    i = 0 .. nb-1 in order,

in one launch on a CUDA tensor, at any panel: one thread block cluster
(16 blocks where the card places one, else 8) walks the panels, each
block owning every 16th (8th) row, reading each row's counted entries and
the lower triangle of each inverse, each block holding the panel's rhs in
shared memory sized from the panel (the kernel's source says how).  A
panel whose rhs does not fit in a block's shared memory keeps it in a
scratch buffer.  A CPU tensor goes to the plain version,
``block_tri_solve_plain``, the panel loop of the JAX package.  The kernel
sums in a fixed order of its own, so it repeats its bits from call to
call and agrees with the plain version to rounding;
``block_tri_solve_lanes`` is a plain version that sums in that order.  Each
launch (one a solve) counts ``block_tri`` (``utils/profiling.py``).
"""
from __future__ import annotations

import functools

import torch

from .._build import I32, I64, P, Entry
from .trisolve import BlockTriFactor

MAX_ENTRIES = 1 << 31    # the kernel indexes x with int32 columns

# inv, off_data, off_cols, off_counts (int32), b, x (nb*p), scratch (p, when
# rhs is not on chip), n, p, nb, K, on_chip
_BLOCK_TRI = Entry("cpkt_block_tri", (P, P, P, P, P, P, P, I64, I32, I64,
                                      I32, I32),
                   dtypes=(torch.float32, torch.float64),
                   counters=("block_tri",))
# the most shared memory a block may take on a device
_SMEM_OPTIN = Entry("cpkt_smem_optin", (I32,), launch=False, restype=I64)


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


def _lane_sums(terms: torch.Tensor) -> torch.Tensor:
    """Row sums of ``terms`` (rows, width) in the kernel's order: lane k
    adds columns k, k + 32, ... in turn, then a butterfly over the 32
    lanes (xor 16, 8, 4, 2, 1)."""
    rows, width = terms.shape
    pad = -width % 32
    lanes = torch.nn.functional.pad(terms, (0, pad)).view(rows, -1, 32)
    acc = torch.zeros(rows, 32, dtype=terms.dtype, device=terms.device)
    for r in range(lanes.shape[1]):
        acc = acc + lanes[:, r]
    idx = torch.arange(32, device=terms.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, idx ^ o]
    return acc[:, 0]


def block_tri_solve_lanes(tf: BlockTriFactor,
                          b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of blocked substitution in kernel B9's order:
    a row's counted entries (never its padding) and its row of the panel
    inverse (never above the diagonal) each summed as ``_lane_sums``.  The
    kernel may fuse a product with its sum, so the two agree to rounding."""
    panel = tf.panel
    n_pad = tf.nblocks * panel
    x = torch.zeros(n_pad, dtype=b.dtype, device=b.device)
    b_pad = torch.zeros(n_pad, dtype=b.dtype, device=b.device)
    b_pad[: tf.n] = b
    K = int(tf.off_data.shape[1])
    used = torch.arange(K) < tf.off_counts.long()[:, None].cpu()
    lower = torch.ones(panel, panel).tril().bool()
    for i in range(tf.nblocks):
        r0 = i * panel
        od = tf.off_data[r0: r0 + panel].to(b.dtype)
        oc = tf.off_cols[r0: r0 + panel].long()
        terms = torch.where(used[r0: r0 + panel].to(b.device),
                            od * x[oc], torch.zeros((), dtype=b.dtype))
        rhs = b_pad[r0: r0 + panel] - _lane_sums(terms)
        terms = torch.where(lower.to(b.device),
                            tf.inv_diag[i].to(b.dtype) * rhs[None, :],
                            torch.zeros((), dtype=b.dtype))
        x[r0: r0 + panel] = _lane_sums(terms)
    return x[: tf.n]


@functools.lru_cache(maxsize=None)
def _smem_limit(index: int) -> int:
    """The most shared memory (bytes) a block may take on CUDA device
    ``index``, asked of the card once."""
    limit = int(_SMEM_OPTIN(index))
    if limit < 0:
        raise RuntimeError(f"block_tri: cannot read the shared memory "
                           f"limit of CUDA device {index}")
    return limit


def on_chip_fits(tf: BlockTriFactor, dtype: torch.dtype, device) -> bool:
    """Whether a panel's rhs fits in a block's shared memory (else the
    kernel keeps it in a scratch buffer)."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    return tf.panel * torch.finfo(dtype).bits // 8 <= _smem_limit(index)


def _check(tf: BlockTriFactor, b: torch.Tensor) -> None:
    """Raise on anything the kernel does not take (a CUDA ``b``)."""
    p, nb = tf.panel, tf.nblocks
    n_pad = nb * p
    if n_pad >= MAX_ENTRIES:
        raise ValueError(f"block_tri: needs nblocks * panel < 2**31, got "
                         f"{n_pad}")
    if b.dtype not in _BLOCK_TRI.dtypes:
        raise TypeError(f"block_tri: unsupported dtype {b.dtype}")
    if b.device.type != "cuda":
        raise ValueError(f"block_tri: unsupported device {b.device}")
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
    if b.dim() != 1 or b.shape[0] != tf.n:
        raise ValueError(f"rhs has shape {tuple(b.shape)}, expected "
                         f"({tf.n},)")
    if b.device.type == "cpu":
        return block_tri_solve_plain(tf, b)
    _check(tf, b)
    b = b.contiguous()
    p, nb = tf.panel, tf.nblocks
    on_chip = on_chip_fits(tf, b.dtype, b.device)
    scratch = None if on_chip else torch.empty(p, dtype=b.dtype,
                                               device=b.device)
    x = torch.empty(nb * p, dtype=b.dtype, device=b.device)
    _BLOCK_TRI.launch(
        b, tf.inv_diag.data_ptr(), tf.off_data.data_ptr(),
        tf.off_cols.data_ptr(), tf.off_counts.data_ptr(), b.data_ptr(),
        x.data_ptr(), 0 if scratch is None else scratch.data_ptr(), tf.n, p,
        nb, int(tf.off_data.shape[1]), int(on_chip))
    return x[: tf.n]
