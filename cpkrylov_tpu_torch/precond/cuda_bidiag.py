"""Bidiagonal triangular solves: the hand-written CUDA scan kernel
(``csrc/bidiag_scan.cu``), its wrapper, and its plain PyTorch version.

Replaces the JAX package's Pallas kernel
``precond/pallas_bidiag.py::_bidiag_kernel``.  A reach-1 factor (the
interleave-ordered main-path factor) is the first-order recurrence

    x_i = a_i x_{i-1} + invd_i b_i      (lower, ``reverse=False``)
    x_i = a_i x_{i+1} + invd_i b_i      (upper, ``reverse=True``)

with ``a_i = -l_i / d_i`` and ``invd_i = 1 / d_i``, held in natural order.
The upper form solves U directly (no flips), and with D folded in (D U) it
also absorbs the block-diagonal scale of the LDL^T solve.

``bidiag_tri_solve`` launches the kernel for a CUDA tensor and raises on
anything it does not take; a CPU tensor goes to ``bidiag_scan_plain``,
which performs the kernel's multiplies and adds in the kernel's order
(tiles, per-thread folds, warp scans, the fixed look-back, the apply), so
the two agree bit for bit.  The kernel is one launch a call: a single-pass
scan whose tiles find their start states by a deterministic look-back over
their predecessors' aggregates, with a small self-resetting state buffer
per (device, stream) (``_state``), so a call can be captured in a CUDA
graph.  Each launch (one a call) counts ``bidiag_scan``
(``utils/profiling.py``).
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from .._build import I32, I64, P, Entry
from ..utils.device import upload

_DTYPES = (torch.float32, torch.float64)
# a, invd, b, x, state (the stream's self-resetting words), n, reverse
_SCAN = Entry("cpkt_bidiag_scan", (P, P, P, P, P, I64, I32), dtypes=_DTYPES,
              counters=("bidiag_scan",))
# its loads and stores without the look-back: a, invd, b, x, n, reverse
_FLOOR = Entry("cpkt_bidiag_read_floor", (P, P, P, P, I64, I32),
               dtypes=_DTYPES)
# scan positions a tile
_TILE = Entry("cpkt_bidiag_tile", (), launch=False, restype=I32)

# The kernel's shape (``bidiag_scan.cu``): scan positions a tile
# (``cpkt_bidiag_tile()``), threads a block, positions a thread, warps and
# lanes; the state buffer's header and per-tile record in 64-bit words.
TILE = 2048
_THREADS = 256
_ITEMS = TILE // _THREADS
_LANES = 32
_WARPS = _THREADS // _LANES
_HEADER_WORDS = 4
_RECORD_WORDS = 4
MAX_TILES = 2**31 - 1

# (device index, stream handle) -> the kernel's state buffer on that stream
_STATES: dict = {}
_STATES_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class BidiagTriFactor:
    """Bidiagonal factor as recurrence coefficients in natural order."""

    a: torch.Tensor      # (n,) coupling coefficient; 0 at the chain start
    invd: torch.Tensor   # (n,) 1 / d_i
    n: int
    reverse: bool = False

    @property
    def work_nnz(self) -> int:
        """Arithmetic volume of one solve (a, invd and b read once), as the
        JAX package counts it (pallas_bidiag.py:91)."""
        return 3 * self.n


def _bidiag_parts(T, upper: bool, dtype: torch.dtype):
    """(d, off) of a scipy bidiagonal matrix, off[i] the coupling entry of
    row i; None when T has entries off the two diagonals, a zero diagonal,
    or ``dtype`` is neither float32 nor float64."""
    import scipy.sparse as sp

    if dtype not in _DTYPES:
        return None
    coo = sp.csr_matrix(T).tocoo()
    n = T.shape[0]
    off = (coo.col - coo.row) if upper else (coo.row - coo.col)
    if coo.nnz and (off.min() < 0 or off.max() > 1):
        return None
    d = np.zeros(n)
    cpl = np.zeros(n)
    np.add.at(d, coo.row[off == 0], coo.data[off == 0])
    np.add.at(cpl, coo.row[off == 1], coo.data[off == 1])
    if np.any(d == 0.0):
        return None
    return d, cpl


def build_bidiag_tri(T, dtype: torch.dtype, device) -> BidiagTriFactor | None:
    """Prepare a scipy lower-BIDIAGONAL matrix (diagonal + first
    subdiagonal); None on any other structure or a zero diagonal."""
    parts = _bidiag_parts(T, upper=False, dtype=dtype)
    if parts is None:
        return None
    d, lo = parts
    n = d.shape[0]
    a = np.zeros(n)
    a[1:] = -lo[1:] / d[1:]
    return BidiagTriFactor(
        a=upload(a, device, dtype), invd=upload(1.0 / d, device, dtype),
        n=int(n), reverse=False)


def build_bidiag_tri_upper(U, dtype: torch.dtype,
                           device) -> BidiagTriFactor | None:
    """Prepare a scipy UPPER-bidiagonal matrix (diagonal + first
    superdiagonal) for the right-to-left scan; None on the same gates."""
    parts = _bidiag_parts(U, upper=True, dtype=dtype)
    if parts is None:
        return None
    d, up = parts
    n = d.shape[0]
    a = np.zeros(n)
    a[: n - 1] = -up[: n - 1] / d[: n - 1]
    return BidiagTriFactor(
        a=upload(a, device, dtype), invd=upload(1.0 / d, device, dtype),
        n=int(n), reverse=True)


def _compose(ea, ec, la, lc):
    """The map "earlier (ea, ec), then later (la, lc)": (la ea, la ec + lc),
    one rounding per multiply and add, as the kernel's ``compose``."""
    return la * ea, la * ec + lc


def _look_back(agg_a: torch.Tensor, agg_c: torch.Tensor) -> torch.Tensor:
    """Each tile's start state from the aggregates of the tiles before it,
    in the kernel's fixed order (``look_back`` in ``bidiag_scan.cu``):
    thread l folds tiles [l ch, (l + 1) ch), ch = ceil(t / 256), in order;
    a shuffle tree combines each warp's lanes; the eight warp results are
    folded in order.  Vectorised over the tiles."""
    ntiles = agg_a.shape[0]
    s = agg_c.new_zeros(ntiles)
    if ntiles == 1:
        return s
    dev = agg_a.device
    t = torch.arange(1, ntiles, device=dev)[:, None]       # (tiles, 1)
    ch = (t + _THREADS - 1) // _THREADS
    q0 = torch.arange(_THREADS, device=dev)[None, :] * ch   # (tiles, threads)
    q1 = torch.minimum(q0 + ch, t)
    ne = q0 < t
    fa = agg_a.new_ones(q0.shape)
    fc = agg_c.new_zeros(q0.shape)
    for step in range(int(ch.max())):
        q = q0 + step
        on = q < q1
        ga = agg_a[q.clamp(max=ntiles - 1)]
        gc = agg_c[q.clamp(max=ntiles - 1)]
        if step > 0:
            ga, gc = _compose(fa, fc, ga, gc)
        fa, fc = torch.where(on, ga, fa), torch.where(on, gc, fc)
    fa = fa.view(-1, _WARPS, _LANES)
    fc = fc.view(-1, _WARPS, _LANES)
    ne = ne.view(-1, _WARPS, _LANES)
    off = 1
    while off < _LANES:
        na, nc = _compose(fa[..., :-off], fc[..., :-off], fa[..., off:],
                          fc[..., off:])
        on = ne[..., off:]
        fa = torch.cat([torch.where(on, na, fa[..., :-off]),
                        fa[..., -off:]], -1)
        fc = torch.cat([torch.where(on, nc, fc[..., :-off]),
                        fc[..., -off:]], -1)
        off *= 2
    ra, rc = fa[:, 0, 0], fc[:, 0, 0]
    for w in range(1, _WARPS):
        na, nc = _compose(ra, rc, fa[:, w, 0], fc[:, w, 0])
        on = ne[:, w, 0]
        ra, rc = torch.where(on, na, ra), torch.where(on, nc, rc)
    s[1:] = rc
    return s


def _hillis_steele(pa: torch.Tensor, pc: torch.Tensor):
    """Inclusive Hillis-Steele scan along the last axis: at each distance d,
    position i >= d takes compose(value at i - d, value at i)."""
    d = 1
    while d < pa.shape[-1]:
        na, nc = _compose(pa[..., :-d], pc[..., :-d], pa[..., d:],
                          pc[..., d:])
        pa = torch.cat([pa[..., :d], na], -1)
        pc = torch.cat([pc[..., :d], nc], -1)
        d *= 2
    return pa, pc


def bidiag_scan_plain(a: torch.Tensor, invd: torch.Tensor, b: torch.Tensor,
                      reverse: bool) -> torch.Tensor:
    """Plain version, in the kernel's operations and order: tiles of
    ``TILE`` scan positions (identity maps past n), each thread's sequential
    fold of its ``_ITEMS`` maps, the warp's Hillis-Steele scan, the scan of
    the warp totals, the fixed look-back fold (``_look_back``), then each
    thread's sequential apply from its start state.  So it equals the kernel
    bit for bit."""
    n = b.shape[0]
    A = a.to(b.dtype)
    C = invd.to(b.dtype) * b
    if n == 0:
        return C
    if reverse:
        A, C = A.flip(0), C.flip(0)
    ntiles = -(-n // TILE)
    tail = ntiles * TILE - n
    A = torch.cat([A, A.new_ones(tail)]).view(ntiles, _THREADS, _ITEMS)
    C = torch.cat([C, C.new_zeros(tail)]).view(ntiles, _THREADS, _ITEMS)
    va, vc = A[..., 0], C[..., 0]
    for k in range(1, _ITEMS):
        va, vc = _compose(va, vc, A[..., k], C[..., k])
    qa, qc = _hillis_steele(va.view(ntiles, _WARPS, _LANES),
                            vc.view(ntiles, _WARPS, _LANES))
    pa, pc = _hillis_steele(qa[..., -1], qc[..., -1])     # (tiles, warps)
    s_tile = _look_back(pa[:, -1], pc[:, -1])[:, None]
    s_warp = torch.cat([s_tile, pa[:, :-1] * s_tile + pc[:, :-1]], 1)
    s_warp = s_warp[..., None]
    s = torch.cat([s_warp, qa[..., :-1] * s_warp + qc[..., :-1]], -1)
    s = s.reshape(ntiles, _THREADS)
    xs = []
    for k in range(_ITEMS):
        s = A[..., k] * s + C[..., k]
        xs.append(s)
    x = torch.stack(xs, -1).reshape(-1)[:n]
    return x.flip(0) if reverse else x


def _bidiag_scan_hillis_steele(a: torch.Tensor, invd: torch.Tensor,
                               b: torch.Tensor, reverse: bool
                               ) -> torch.Tensor:
    """A second, independent reference: one Hillis-Steele scan of all n
    maps in log2(n) vectorised passes (another association than the
    kernel's)."""
    A = a.to(b.dtype)
    C = invd.to(b.dtype) * b
    if reverse:
        A, C = A.flip(0), C.flip(0)
    _, C = _hillis_steele(A, C)
    return C.flip(0) if reverse else C


def _state(device: torch.device, stream: int, ntiles: int) -> torch.Tensor:
    """The kernel's self-resetting state for calls on ``stream``: zeroed
    once when made, regrown (and zeroed) only when a call needs more tiles
    than it holds.  Never shared between streams."""
    key = (device.index, stream)
    words = _HEADER_WORDS + _RECORD_WORDS * ntiles
    with _STATES_LOCK:
        buf = _STATES.get(key)
        if buf is None or buf.numel() < words:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "bidiag_scan: no scan state for this stream yet; make "
                    "one call on the capture stream before capturing a "
                    "graph")
            buf = torch.zeros(words, dtype=torch.int64, device=device)
            buf[3] = ntiles                 # the records it holds
            _STATES[key] = buf
    return buf


def _tiles(n: int) -> int:
    """Tiles of a call on n positions; ValueError past the kernel's tile
    index (a 32-bit grid)."""
    ntiles = -(-n // TILE)
    if ntiles > MAX_TILES:
        raise ValueError(f"bidiag_scan: n = {n} needs {ntiles} tiles, more "
                         f"than the kernel's {MAX_TILES}")
    return ntiles


def bidiag_read_floor(a: torch.Tensor, invd: torch.Tensor, b: torch.Tensor,
                      reverse: bool) -> torch.Tensor:
    """The kernel's loads and stores without the look-back: every tile
    starts from state 0, so only the first tile of the result is the
    solution.  A measurement, never a solve; not counted."""
    _check_cuda(a, invd, b)
    x = torch.empty_like(b)
    _FLOOR.launch(b, a.data_ptr(), invd.data_ptr(), b.data_ptr(),
                  x.data_ptr(), int(b.shape[0]), int(reverse))
    return x


def _check_cuda(a, invd, b) -> int:
    """Check a call's operands for the kernel; returns its tiles."""
    if b.device.type != "cuda":
        raise ValueError(f"bidiag_scan: unsupported device {b.device}")
    if b.dtype not in _DTYPES:
        raise TypeError(f"bidiag_scan: unsupported dtype {b.dtype}")
    n = int(b.shape[0])
    for name, t in (("a", a), ("invd", invd), ("b", b)):
        if t.dtype != b.dtype:
            raise TypeError(f"bidiag_scan: {name} dtype {t.dtype} != "
                            f"{b.dtype}")
        if t.device != b.device:
            raise ValueError(f"bidiag_scan: {name} on {t.device}, "
                             f"b on {b.device}")
        if t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"bidiag_scan: {name} must be a contiguous "
                             f"({n},) tensor")
    return _tiles(n)


def bidiag_scan(a: torch.Tensor, invd: torch.Tensor, b: torch.Tensor,
                reverse: bool) -> torch.Tensor:
    """Solve the recurrence: the CUDA kernel for a CUDA tensor, else the
    plain version."""
    if b.device.type == "cpu":
        return bidiag_scan_plain(a, invd, b, reverse)
    ntiles = _check_cuda(a, invd, b)
    n = int(b.shape[0])
    stream = torch.cuda.current_stream(b.device).cuda_stream
    state = _state(b.device, stream, ntiles)
    x = torch.empty(n, dtype=b.dtype, device=b.device)
    _SCAN.launch(b, a.data_ptr(), invd.data_ptr(), b.data_ptr(),
                 x.data_ptr(), state.data_ptr(), n, int(reverse),
                 stream=stream)
    return x


def bidiag_tri_solve(tf: BidiagTriFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve T x = b for a prepared bidiagonal factor."""
    if b.shape[0] != tf.n:
        raise ValueError(f"rhs has length {b.shape[0]}, expected {tf.n}")
    return bidiag_scan(tf.a, tf.invd, b.contiguous(), tf.reverse)
