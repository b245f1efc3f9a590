"""The interleave riffle: the hand-written CUDA kernels
(``csrc/interleave.cu``), their wrappers, and their plain PyTorch versions.

Replaces the JAX package's Pallas kernels
``precond/pallas_interleave.py::_interleave_kernel`` and
``::_uninterleave_kernel``.  For a vector of ``n + m`` entries and a group
size ``c`` (``c * m <= n``), the riffle lays out c x-entries and then one
y-entry per group, then the contiguous x-tail:

    perm[g*(c+1) + j] = g*c + j   (j < c, g < m)
    perm[g*(c+1) + c] = n + g
    perm[m*(c+1) + t] = c*m + t   (tail)

``interleave`` computes ``z[perm]`` and ``uninterleave`` its inverse, each
as one launch over the whole vector (head and tail) for a CUDA tensor; a CPU
tensor goes to the plain versions, the reshape and concatenation chains.
Both move entries without arithmetic, so kernel and plain version agree bit
for bit.  Their launches count ``interleave`` and ``uninterleave``
(``utils/profiling.py``).
"""
from __future__ import annotations

import torch

from .._build import I32, I64, P, Entry

# src, dst, n, m, c, itemsize (4 or 8)
_INTERLEAVE = Entry("cpkt_interleave", (P, P, I64, I64, I64, I32),
                    counters=("interleave",))
_UNINTERLEAVE = Entry("cpkt_uninterleave", (P, P, I64, I64, I64, I32),
                      counters=("uninterleave",))
# the kernels index with 32-bit integers
MAX_ENTRIES = 1 << 31


def interleave_plain(z: torch.Tensor, n: int, m: int, c: int) -> torch.Tensor:
    """Plain version of ``z[perm]``."""
    cm = c * m
    a = z[:cm].reshape(m, c)
    b = z[n: n + m].reshape(m, 1)
    head = torch.cat([a, b], dim=1).reshape(-1)
    return torch.cat([head, z[cm: n]])


def uninterleave_plain(w: torch.Tensor, n: int, m: int,
                       c: int) -> torch.Tensor:
    """Plain version of the inverse: ``out[perm] = w``."""
    g = w[: m * (c + 1)].reshape(m, c + 1)
    return torch.cat([g[:, :c].reshape(-1), w[m * (c + 1):], g[:, c]])


def _launch(entry: Entry, src: torch.Tensor, n: int, m: int,
            c: int) -> torch.Tensor:
    what = entry.what
    if src.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {src.device}")
    if src.element_size() not in (4, 8):
        raise TypeError(f"{what}: unsupported dtype {src.dtype}")
    if m < 1 or c < 1 or c * m > n or n + m >= MAX_ENTRIES:
        raise ValueError(f"{what}: needs m >= 1, c >= 1, c*m <= n and "
                         f"n + m < 2**31 (n={n}, m={m}, c={c})")
    if src.dim() != 1 or src.shape[0] != n + m or not src.is_contiguous():
        raise ValueError(f"{what}: input must be a contiguous ({n + m},) "
                         f"tensor, got {tuple(src.shape)}")
    out = torch.empty_like(src)
    entry.launch(src, src.data_ptr(), out.data_ptr(), n, m, c,
                 src.element_size())
    return out


def interleave(z: torch.Tensor, n: int, m: int, c: int) -> torch.Tensor:
    """``z[perm]``: the CUDA kernel for a CUDA tensor, else the plain
    version."""
    if z.device.type == "cpu":
        return interleave_plain(z, n, m, c)
    return _launch(_INTERLEAVE, z, n, m, c)


def uninterleave(w: torch.Tensor, n: int, m: int, c: int) -> torch.Tensor:
    """The inverse riffle: the CUDA kernel for a CUDA tensor, else the plain
    version."""
    if w.device.type == "cpu":
        return uninterleave_plain(w, n, m, c)
    return _launch(_UNINTERLEAVE, w, n, m, c)
