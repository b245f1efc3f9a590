"""CSR SpMV: the hand-written CUDA kernel B5 (``csrc/csr_spmv.cu``), its
wrapper and its plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas_spmv.py``: B5 replaces its
``_kernel`` (``pgell_matvec`` over ``ops/pgell.py``'s paged-gather ELL).  It
serves every matrix that fails the DIA gate, in the port's own layout
(``ops/formats.py::CSR``): the TPU format's pages, lane lookup tables and
int8 bucket maps only work around the TPU's lack of a fast gather.  Nor
does the port renumber these matrices by RCM as ``pack_sym_pgell`` does:
RCM changes only which x entries a row gathers, not the product.

The kernel splits the work by stored entries: block t takes the tile of
``mat.tile`` entries from entry t * tile, and the rows that start in it
(``mat.tiles``, the row split ``ops/formats.py`` computes when it packs the
CSR).  Its threads load the tile's values and columns (and a few entries
past it) and all their gathers of x at once, and write the products to
shared memory; then one thread a row adds its row's products, in stored
order, reading any past the held entries from device memory
(``csr_walk`` lists those sums, for the CPU tests of the split).  So each row is still one sum from 0
over its entries in stored order, every multiply and add rounded once, as
``csr_matvec_plain`` forms it: the two agree bit for bit and repeat from
run to run.

``csr_spmv`` launches the kernel for a CUDA tensor and raises on anything
it does not take; a CPU tensor goes to ``csr_matvec_plain``.  ``rmatvec``
is the same function on the stored transpose.  ``LAUNCHES`` counts kernel
launches (one per product).
"""
from __future__ import annotations

import torch

from .. import _build
from .formats import CSR, TILE_HALO

LAUNCHES = 0

_ENTRY = {torch.float32: "cpkt_csr_spmv_f32",
          torch.float64: "cpkt_csr_spmv_f64"}


def csr_matvec_plain(mat: CSR, x: torch.Tensor) -> torch.Tensor:
    """Plain version: y = mat @ x, each row summed in stored order: one
    vectorized add per position k within the rows, over the rows that have
    more than k entries (taken longest first from the row pointers)."""
    prod = mat.data.to(x.dtype) * x[mat.indices]
    y = torch.zeros(mat.shape[0], dtype=x.dtype, device=x.device)
    counts = mat.indptr[1:] - mat.indptr[:-1]
    if mat.nnz == 0:
        return y
    rows = torch.argsort(counts, descending=True)
    start = mat.indptr[:-1][rows]
    # longer[k]: the number of rows with more than k entries
    longer = (counts.numel() - torch.cumsum(torch.bincount(counts), 0)).tolist()
    for k, m in enumerate(longer):
        if m == 0:
            break
        y[rows[:m]] = y[rows[:m]] + prod[start[:m] + k]
    return y


def csr_walk(mat: CSR) -> list:
    """The kernel's sums over ``mat``, as (t, row, rs, held, re) in tile
    order: tile t sums row ``row``, entries rs..held-1 from the products
    it holds in shared memory (its tile and TILE_HALO entries past it) and
    held..re-1 from device memory."""
    indptr = mat.indptr.tolist()
    tiles = mat.tiles.tolist()
    sums = []
    for t in range(len(tiles) - 1):
        end = t * mat.tile + mat.tile + TILE_HALO
        for r in range(tiles[t], tiles[t + 1]):
            rs, re = indptr[r], indptr[r + 1]
            sums.append((t, r, rs, min(re, end), re))
    return sums


def layout() -> tuple:
    """(threads a block, largest tile, halo) of the built kernel."""
    import ctypes

    out = (ctypes.c_int * 3)()
    _build.kernel_library().cpkt_csr_spmv_layout(out)
    return tuple(out)


def csr_spmv(mat: CSR, x: torch.Tensor) -> torch.Tensor:
    """y = mat @ x: the CUDA kernel for a CUDA tensor, else the plain
    version."""
    global LAUNCHES
    if x.device.type == "cpu":
        return csr_matvec_plain(mat, x)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmv: unsupported device {x.device}")
    nrows, ncols = mat.shape
    if x.dtype not in _ENTRY:
        raise TypeError(f"csr_spmv: unsupported dtype {x.dtype}")
    if mat.data.dtype != x.dtype:
        raise TypeError(f"csr_spmv: matrix dtype {mat.data.dtype} != vector "
                        f"dtype {x.dtype}")
    for name, t in (("data", mat.data), ("indices", mat.indices),
                    ("indptr", mat.indptr), ("tiles", mat.tiles)):
        if t.device != x.device:
            raise ValueError(f"csr_spmv: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"csr_spmv: {name} must be a contiguous vector")
    if mat.indices.dtype != torch.int32 or mat.indptr.dtype != torch.int64 \
            or mat.tiles.dtype != torch.int64:
        raise ValueError("csr_spmv: indices must be int32, indptr and tiles "
                         "int64")
    if mat.indptr.shape[0] != nrows + 1 or mat.indices.shape != \
            mat.data.shape:
        raise ValueError("csr_spmv: inconsistent CSR arrays")
    if x.dim() != 1 or x.shape[0] != ncols:
        raise ValueError(f"csr_spmv: x has shape {tuple(x.shape)}, "
                         f"expected ({ncols},)")
    x = x.contiguous()
    lib = _build.kernel_library()
    y = torch.empty(nrows, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = getattr(lib, _ENTRY[x.dtype])(
        mat.indptr.data_ptr(), mat.indices.data_ptr(), mat.data.data_ptr(),
        mat.tiles.data_ptr(), mat.tiles.shape[0] - 1, mat.tile, nrows,
        mat.nnz, x.data_ptr(), y.data_ptr(), stream)
    _build.check(status, "csr_spmv")
    LAUNCHES += 1
    return y


def csr_rmatvec(mat: CSR, y: torch.Tensor) -> torch.Tensor:
    """x = mat.T @ y through the stored transpose (kernel or plain, as
    ``csr_spmv``)."""
    if mat.t is None:
        raise ValueError("this CSR was packed without its transpose "
                         "(csr_from_scipy(..., transpose=False))")
    return csr_spmv(mat.t, y)
