"""Banded triangular solves: the hand-written CUDA kernels B4 (reduced-state
scan solve) and B6 (affine scan of the panel states) in
``csrc/band_tri.cu``, their wrappers, and their plain PyTorch versions.

Counterpart of the JAX package's ``precond/pallas_tri.py``: B4 replaces
``_fused_tri_kernel`` (``pallas_tri_solve``), B6 ``_affine_scan_kernel``
(``affine_lane_scan``).  A factor of reach 2..1024 (an RCM-ordered KKT
factor) is packed as ``trisolve.ReducedScanTriFactor``; ``band_tri_solve``
computes x = T^-1 b for it as

    c_i = inv_i b_i,   x_i = c_i - W_i s_{i-1},   s_i = x_i[p-r:].

``band_tri_solve`` launches B4's c kernel, which writes c into x (padded to
nb p entries), then B6 on all p rows of W in place (through the same
launcher as ``affine_scan``, which counts it): each scan step forms the
whole of x_i from W_i and the state, and its last r entries are the next
state, so W is read once.  It counts one ``band_tri`` solve, and its
scan one ``affine_scan`` (``utils/profiling.py``).  ``affine_scan(mr,
cr)`` is B6 under the JAX contract: ``mr (r, r, nb)``, ``cr (r, nb)`` ->
the inclusive ``s (r, nb)`` from a zero state; it takes any strides (a
map whose columns are not contiguous is copied step-major first: the
kernel streams rows).

B6 runs on a persistent grid (one block a SM for every 8 rows of M, at
most r) that hands the state from step to step through the L2, one row of
M a warp: laid out so, on the H100 it was as fast as the 16-block cluster
that hands the state through distributed shared memory, or faster, at
every shape measured (AUG2D-L's p 632, r 631: 2.1x).  :func:`scan_path`
keeps the cluster for the shapes the grid cannot lay out one row a warp:
panels of many more rows than the reach, which the port's panel rule never
makes.  Both sum every dot product in the same order, so they give the
same bits.  ``scan_grid_launches`` and ``scan_cluster_launches`` count the
scans each took (``affine_scan`` counts both).  ``scan_on``,
``band_tri_solve_on`` and ``scan_read_floor`` run a named layout for
measurements, uncounted.

On a CUDA tensor each wrapper launches its kernel and raises on anything it
does not take; a CPU tensor goes to the plain version
(``band_tri_solve_plain``, ``affine_scan_plain``).  The plain scan is the
sequential recurrence; the kernel sums each dot product in another order,
so the two agree to rounding, not bit for bit.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .._build import F64, I32, I64, P, Entry
from ..utils.profiling import count
from .trisolve import ReducedScanTriFactor, reduced_scan_tri_solve_plain

MAX_PANEL = 1024    # csrc/band_tri.cu kMaxPanel: largest p and r
MAX_GRID_BLOCKS = 256   # csrc/band_tri.cu kMaxGridBlocks
GRID_ROWS = 8           # ... kGridRows: rows of M a grid block takes
GRID_WARPS = 16         # ... kGridMaxWarps: warps a grid block runs
# csrc/band_tri.cu kGridHeader + kGridStateWords: the grid scan's state
# buffer in 64-bit words (a header, then two tagged copies of the state)
_GRID_STATE_WORDS = 2 + 2 * MAX_PANEL * 2

_DTYPES = (torch.float32, torch.float64)
# B4's first phase: inv, b, c (nb*p), n, p, nb
_BAND_C = Entry("cpkt_band_c", (P, P, P, I64, I32, I64), dtypes=_DTYPES,
                what="band_tri_solve (c = inv b)")
# B6 and its read floor on one cluster: m (unit column stride) and its (row,
# step) strides, alpha, c and its (row, step) strides, y and its (row, step)
# strides, q, r, nb; on the persistent grid also the resident blocks and the
# stream's scan state
_SCAN_ARGS = (P, I64, I64, F64, P, I64, I64, P, I64, I64, I32, I32, I64)
_GRID_ARGS = _SCAN_ARGS + (I32, P)
_CLUSTER_SCAN = Entry("cpkt_affine_scan", _SCAN_ARGS, dtypes=_DTYPES,
                      counters=("affine_scan", "scan_cluster_launches"),
                      what="affine_scan")
_CLUSTER_FLOOR = Entry("cpkt_scan_read_floor", _SCAN_ARGS, dtypes=_DTYPES,
                       what="affine_scan")
_GRID_SCAN = Entry("cpkt_affine_scan_grid", _GRID_ARGS, dtypes=_DTYPES,
                   counters=("affine_scan", "scan_grid_launches"),
                   what="affine_scan")
_GRID_FLOOR = Entry("cpkt_scan_grid_read_floor", _GRID_ARGS,
                    dtypes=_DTYPES, what="affine_scan")
# q, r, out (5 ints: cluster, rows a block, rows a warp, warps, bytes)
_LAYOUT = Entry("cpkt_scan_layout", (I32, I32, P), dtypes=_DTYPES,
                launch=False)
# q, r, blocks, out (7 ints: blocks, rows a block, rows a warp, warps, ring
# slots a warp, ring bytes, static shared-memory bytes)
_GRID_LAYOUT = Entry("cpkt_scan_grid_layout", (I32, I32, I32, P),
                     dtypes=_DTYPES, launch=False)
# layout -> (its chained scan, its read floor)
_ON = {"grid": (_GRID_SCAN, _GRID_FLOOR),
       "cluster": (_CLUSTER_SCAN, _CLUSTER_FLOOR)}

# (device index, stream handle) -> the grid scan's state on that stream
_STATES: dict = {}
_STATES_LOCK = threading.Lock()

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


def _check_cuda(name: str, ref: torch.Tensor, **tensors):
    if ref.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {ref.device}")
    if ref.dtype not in _DTYPES:
        raise TypeError(f"{name}: unsupported dtype {ref.dtype}")
    for label, t in tensors.items():
        if t.dtype != ref.dtype:
            raise TypeError(f"{name}: {label} dtype {t.dtype} != {ref.dtype}")
        if t.device != ref.device:
            raise ValueError(f"{name}: {label} on {t.device}, not "
                             f"{ref.device}")


def grid_blocks(q: int, r: int, resident_blocks: int) -> int:
    """Blocks of the grid scan for q rows of reach r on a card that keeps
    ``resident_blocks`` resident (csrc/band_tri.cu ``grid_layout``): one
    for every 8 rows, at most r, so that every block forms part of every
    state."""
    return min(resident_blocks, MAX_GRID_BLOCKS, r, -(-q // GRID_ROWS))


def scan_path(q: int, r: int, resident_blocks: int) -> str:
    """The layout B6 takes for q rows of reach r on a card that keeps
    ``resident_blocks`` blocks of the grid scan resident (one a SM):
    "grid" where each of its blocks' rows (the q - r head rows and the r
    state rows shared out) fit its 16 warps one row a warp, else
    "cluster".  On the H100 the grid laid out so was as fast as the
    cluster or faster at every shape measured, and with 3 rows a warp
    slower (``PERF.md`` §6: p 512, r 7 2.91 against 2.53 us a step)."""
    g = grid_blocks(q, r, resident_blocks)
    if -(-(q - r) // g) + -(-r // g) <= GRID_WARPS:
        return "grid"
    return "cluster"


def resident_blocks(device: torch.device) -> int:
    """Blocks of the grid scan the card keeps resident: one a SM (the
    kernel takes :func:`grid_blocks` of them)."""
    return min(torch.cuda.get_device_properties(device).multi_processor_count,
               MAX_GRID_BLOCKS)


def _state(device: torch.device, stream: int) -> torch.Tensor:
    """The grid scan's self-resetting state for calls on ``stream`` (the
    last tag, a counter and the tagged state): zeroed once when made, by
    no call.  Never shared between streams."""
    key = (device.index, stream)
    with _STATES_LOCK:
        buf = _STATES.get(key)
        if buf is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "affine_scan: no grid scan state for this stream yet; "
                    "make one call on the capture stream before capturing "
                    "a graph")
            buf = torch.zeros(_GRID_STATE_WORDS, dtype=torch.int64,
                              device=device)
            _STATES[key] = buf
    return buf


def _scan_call(path: str, entry: Entry, m: torch.Tensor, c: torch.Tensor,
               y: torch.Tensor, r: int, alpha: float,
               counted: bool = True) -> None:
    """Launch a scan entry of the layout ``path``: y_i = alpha m_i s_{i-1} +
    c_i over the q rows of ``m`` (q, r, nb) (unit column stride), s_i =
    y_i[q-r:]."""
    q, nb = int(m.shape[0]), int(m.shape[2])
    msj, msk, msi = m.stride()
    if msk != 1 and r > 1:
        raise ValueError("scan: the maps' columns must be contiguous")
    csj, csi = c.stride()
    ysj, ysi = y.stride()
    stream = torch.cuda.current_stream(c.device).cuda_stream
    args = (m.data_ptr(), msj, msi, alpha, c.data_ptr(), csj, csi,
            y.data_ptr(), ysj, ysi, q, r, nb)
    if path == "grid":
        args += (resident_blocks(c.device),
                 _state(c.device, stream).data_ptr())
    entry.launch(c, *args, stream=stream, counted=counted)


def _launch_scan(m: torch.Tensor, c: torch.Tensor, y: torch.Tensor, r: int,
                 alpha: float) -> None:
    """Launch B6 on the layout its shape takes (counted)."""
    path = scan_path(int(m.shape[0]), r, resident_blocks(c.device))
    _scan_call(path, _ON[path][0], m, c, y, r, alpha)


def scan_on(path: str, m: torch.Tensor, c: torch.Tensor, r: int,
            alpha: float = 1.0) -> torch.Tensor:
    """B6 on the named layout ("grid" or "cluster"), whatever the shape
    would take: a measurement, never a solve's path; not counted.  ``m``
    (q, r, nb), ``c`` (q, nb); returns y (q, nb)."""
    _check_cuda("scan_on", c, m=m)
    y = torch.empty(c.shape, dtype=c.dtype, device=c.device)
    _scan_call(path, _ON[path][0], m, c, y, r, alpha, counted=False)
    return y


def scan_read_floor(m: torch.Tensor, c: torch.Tensor, r: int,
                    path: str = "cluster") -> torch.Tensor:
    """B6's reads without its chain, on the same layout and slices: the
    time of the scan's loads alone (a measurement, never a solve; not
    counted as a B6 launch).  ``m`` (q, r, nb), ``c`` (q, nb); the state
    stays zero, so the result equals ``c``."""
    _check_cuda("scan_read_floor", c, m=m)
    y = torch.empty(c.shape, dtype=c.dtype, device=c.device)
    _scan_call(path, _ON[path][1], m, c, y, r, 1.0)
    return y


def scan_layout(q: int, r: int, dtype: torch.dtype) -> dict:
    """The cluster scan's launch layout on this card for q rows of reach
    r: cluster blocks, rows of M a block and a warp own, warps a block,
    shared-memory ring bytes."""
    out = (ctypes.c_int * 5)()
    _LAYOUT(q, r, ctypes.addressof(out), dtype=dtype)
    return dict(zip(("cluster", "rows_per_block", "rows_per_warp", "warps",
                     "ring_bytes"), list(out)))


def scan_grid_layout(q: int, r: int, dtype: torch.dtype,
                     blocks: int) -> dict:
    """The grid scan's launch layout for q rows of reach r over ``blocks``
    resident blocks: blocks, rows of M a block (at most) and a warp own,
    warps a block, ring slots a warp, ring bytes (dynamic shared memory)
    and the kernel's static shared-memory bytes."""
    out = (ctypes.c_int * 7)()
    _GRID_LAYOUT(q, r, blocks, ctypes.addressof(out), dtype=dtype)
    return dict(zip(("blocks", "rows_per_block", "rows_per_warp", "warps",
                     "slots", "ring_bytes", "static_bytes"), list(out)))


def affine_scan(mr: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """B6: the inclusive prefix of s_i = mr[:, :, i] s_{i-1} + cr[:, i];
    the CUDA kernel for a CUDA tensor, else the plain version."""
    if cr.device.type == "cpu":
        return affine_scan_plain(mr, cr)
    _check_cuda("affine_scan", cr, mr=mr)
    if cr.dim() != 2 or mr.dim() != 3:
        raise ValueError("affine_scan: expected mr (r, r, nb) and cr (r, nb)")
    r, nb = int(cr.shape[0]), int(cr.shape[1])
    if tuple(mr.shape) != (r, r, nb):
        raise ValueError(f"affine_scan: mr has shape {tuple(mr.shape)}, "
                         f"expected ({r}, {r}, {nb})")
    if not 1 <= r <= MAX_PANEL:
        raise ValueError(f"affine_scan: r = {r} outside 1..{MAX_PANEL}")
    if mr.stride(1) != 1 and r > 1:     # lane-major: rows made contiguous
        mr = mr.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    s = torch.empty((r, nb), dtype=cr.dtype, device=cr.device)
    _launch_scan(mr, cr, s, r, 1.0)
    return s


def band_tri_solve(tf: ReducedScanTriFactor, b: torch.Tensor) -> torch.Tensor:
    """B4: solve T x = b for a reduced-scan factor; the CUDA kernels for a
    CUDA tensor, else the plain version."""
    _check_rhs(tf, b)
    if b.device.type == "cpu":
        return band_tri_solve_plain(tf, b)
    x = _band_tri(tf, b, _launch_scan)
    count("band_tri")
    return x


def band_tri_solve_on(path: str, tf: ReducedScanTriFactor,
                      b: torch.Tensor) -> torch.Tensor:
    """B4 with its scan on the named layout ("grid" or "cluster"): a
    measurement, never a solve's path; counts no launch."""
    def scan(m, c, y, r, alpha):
        _scan_call(path, _ON[path][0], m, c, y, r, alpha, counted=False)
    _check_rhs(tf, b)
    return _band_tri(tf, b, scan)


def _check_rhs(tf: ReducedScanTriFactor, b: torch.Tensor) -> None:
    if b.dim() != 1 or b.shape[0] != tf.n:
        raise ValueError(f"rhs has shape {tuple(b.shape)}, expected "
                         f"({tf.n},)")


def _band_tri(tf: ReducedScanTriFactor, b: torch.Tensor, scan
              ) -> torch.Tensor:
    """B4 on the card: the c kernel, then ``scan`` in place in x."""
    _check_cuda("band_tri_solve", b, inv_diag=tf.inv_diag,
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
    # x padded to whole panels: c = inv b lands in it, then the scan turns
    # each panel's c_i into x_i in place; the padding is sliced off
    x = torch.empty(nb * p, dtype=b.dtype, device=b.device)
    _BAND_C.launch(b, tf.inv_diag.data_ptr(), b.data_ptr(), x.data_ptr(),
                   tf.n, p, nb)
    xt = x.view(nb, p).T                                    # (p, nb)
    scan(tf.w_blocks.permute(1, 2, 0), xt, xt, r, -1.0)
    return x[: tf.n]
