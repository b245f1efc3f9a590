"""The df64 triangle product: the hand-written CUDA kernel B10
(``csrc/df_tri_matvec.cu``), its wrapper, and its plain PyTorch version.

Counterpart of the JAX package's ``precond/df_factor.py::DFTriMat.
matvec_df``, an XLA ``lax.scan`` over the ELL slots (no Pallas kernel).
For a (K, n) transposed-ELL matrix with df64 values (``df_factor.DFTriMat``:
hi and lo f32, int32 columns, each row's ``counts``) and a df64 vector
x = (xh, xl), ``df_tri_matvec`` returns the compensated product (yh, yl):
one thread per row walks the row's stored slots and then one padding slot
with the plain version's chain, every operation rounded explicitly.  A
padding slot maps the sums to a fixed point, so further padding slots
change no bit, and kernel and plain version (``df_tri_matvec_plain``, every
slot of every row) agree bit for bit; ``df_tri_matvec_walk`` is the plain
version in the kernel's order.  A CPU tensor goes to the plain version; on
a CUDA tensor the wrapper launches the kernel or raises.  Each launch (one
a product) counts ``df_tri_matvec`` (``utils/profiling.py``).
"""
from __future__ import annotations

import torch

from .._build import I32, I64, P, Entry
from ..ops import df64
from .df_factor import DFTriMat

# hi, lo, cols (int32), counts (int32), K, n, xh, xl, yh, yl
_DF_TRI = Entry("cpkt_df_tri_matvec", (P, P, P, P, I32, I64, P, P, P, P),
                dtypes=(torch.float32,), counters=("df_tri_matvec",))

MAX_ENTRIES = 1 << 31    # the kernel indexes x with int32 columns


def df_tri_matvec_plain(t: DFTriMat, x: df64.DF) -> df64.DF:
    """Plain version of the df64 product (df_factor.py:67-84 of the JAX
    package): one gather of x and one step of the compensated chain per
    ELL slot, every slot of every row, each operation rounded on its own."""
    xh, xl = x
    acc_h = torch.zeros(t.n, dtype=xh.dtype, device=xh.device)
    acc_l = torch.zeros(t.n, dtype=xh.dtype, device=xh.device)
    for k in range(t.hi.shape[0]):
        c = t.cols[k].long()
        vh, vl = xh[c], xl[c]
        dh, dl = t.hi[k], t.lo[k]
        p, e = df64.two_prod(dh, vh)
        e = e + dh * vl + dl * vh
        acc_h, e2 = df64.two_sum(acc_h, p)
        acc_l = acc_l + (e + e2)
    return df64.quick_two_sum(acc_h, acc_l)


def df_tri_matvec_walk(t: DFTriMat, x: df64.DF) -> df64.DF:
    """The plain version in kernel B10's order: each row takes the chain
    step of its ``counts[i]`` stored slots, then, when ``counts[i] < K``,
    one padding step (dh = dl = 0, column 0), and stops."""
    xh, xl = x
    K = t.hi.shape[0]
    steps = torch.clamp(t.counts.long() + 1, max=K)
    zero = torch.zeros((), dtype=xh.dtype, device=xh.device)
    acc_h = torch.zeros(t.n, dtype=xh.dtype, device=xh.device)
    acc_l = torch.zeros(t.n, dtype=xh.dtype, device=xh.device)
    for k in range(K):
        stored = k < t.counts
        c = torch.where(stored, t.cols[k], 0).long()
        dh = torch.where(stored, t.hi[k], zero)
        dl = torch.where(stored, t.lo[k], zero)
        vh, vl = xh[c], xl[c]
        p, e = df64.two_prod(dh, vh)
        e = e + dh * vl + dl * vh
        s, e2 = df64.two_sum(acc_h, p)
        step = k < steps
        acc_h = torch.where(step, s, acc_h)
        acc_l = torch.where(step, acc_l + (e + e2), acc_l)
    return df64.quick_two_sum(acc_h, acc_l)


def _check(t: DFTriMat, xh: torch.Tensor, xl: torch.Tensor) -> None:
    """Raise on anything the kernel does not take (CUDA operands)."""
    if t.n >= MAX_ENTRIES:
        raise ValueError(f"df_tri_matvec: needs n < 2**31, got {t.n}")
    if xh.dtype != torch.float32:
        raise TypeError(f"df_tri_matvec: unsupported dtype {xh.dtype}")
    if xh.device.type != "cuda":
        raise ValueError(f"df_tri_matvec: unsupported device {xh.device}")
    K = int(t.hi.shape[0])
    for label, v, dtype, shape in (
            ("xl", xl, torch.float32, (t.n,)),
            ("hi", t.hi, torch.float32, (K, t.n)),
            ("lo", t.lo, torch.float32, (K, t.n)),
            ("cols", t.cols, torch.int32, (K, t.n)),
            ("counts", t.counts, torch.int32, (t.n,))):
        if v.dtype != dtype:
            raise TypeError(f"df_tri_matvec: {label} dtype {v.dtype} != "
                            f"{dtype}")
        if v.device != xh.device:
            raise ValueError(f"df_tri_matvec: {label} on {v.device}, not "
                             f"{xh.device}")
        if tuple(v.shape) != shape or not v.is_contiguous():
            raise ValueError(f"df_tri_matvec: {label} must be a contiguous "
                             f"{shape} tensor, got {tuple(v.shape)}")
    if K < 1:
        raise ValueError("df_tri_matvec: the matrix has no ELL slot")


def df_tri_matvec(t: DFTriMat, x: df64.DF) -> df64.DF:
    """B10: the df64 product T x; the CUDA kernel for CUDA tensors, else
    the plain version."""
    xh, xl = x
    if xh.dim() != 1 or xh.shape[0] != t.n:
        raise ValueError(f"x has shape {tuple(xh.shape)}, expected "
                         f"({t.n},)")
    if xh.device.type == "cpu":
        return df_tri_matvec_plain(t, x)
    xh, xl = xh.contiguous(), xl.contiguous()
    _check(t, xh, xl)
    yh = torch.empty_like(xh)
    yl = torch.empty_like(xh)
    _DF_TRI.launch(xh, t.hi.data_ptr(), t.lo.data_ptr(), t.cols.data_ptr(),
                   t.counts.data_ptr(), int(t.hi.shape[0]), t.n,
                   xh.data_ptr(), xl.data_ptr(), yh.data_ptr(), yl.data_ptr())
    return yh, yl
