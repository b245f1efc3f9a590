"""The host DIA packs of the port before it placed diagonals on the device,
kept as the oracle that ``ops/dia.py::place_dia`` is held to bit for bit.

numpy and scipy only (no JAX), so the tests marked ``cuda`` can use them
too.  Each takes a scipy matrix and returns host arrays, or None where the
padded diagonals fail the gate that pack used.
"""
import numpy as np
import scipy.sparse as sp


def _offsets_and_slots(csr):
    coo = csr.tocoo()
    off = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    return coo, off


def host_dia(mat, max_fill_ratio=4.5):
    """``pack_dia``'s host placement: (f64 data (ndiag, nrows), offsets,
    shape, nnz); None past the fill gate (0 = no gate)."""
    csr = sp.csr_matrix(mat, copy=True)
    csr.sum_duplicates()
    nrows, ncols = csr.shape
    coo, off = _offsets_and_slots(csr)
    uniq = np.unique(off)
    ndiag = int(uniq.size) if uniq.size else 1
    if (max_fill_ratio > 0 and csr.nnz
            and ndiag * nrows > max_fill_ratio * csr.nnz):
        return None
    data = np.zeros((ndiag, nrows), dtype=np.float64)
    if csr.nnz:
        k = np.searchsorted(uniq, off)
        data[k, coo.row] = coo.data
    offsets = tuple(int(o) for o in (uniq if uniq.size else [0]))
    return data, offsets, (int(nrows), int(ncols)), int(csr.nnz)


def host_df_dia(mat, max_bytes_ratio=3.0):
    """``pack_df_dia``'s host placement and split: (hi, lo, offsets,
    shape); None past the bytes gate."""
    csr = sp.csr_matrix(mat).astype(np.float64)
    csr.sum_duplicates()
    nrows, ncols = csr.shape
    coo, off = _offsets_and_slots(csr)
    uniq = np.unique(off) if coo.nnz else np.array([0], np.int64)
    if csr.nnz and uniq.size * nrows * 8 > max_bytes_ratio * csr.nnz * 12.0:
        return None
    data = np.zeros((uniq.size, nrows), np.float64)
    if coo.nnz:
        k = np.searchsorted(uniq, off)
        data[k, coo.row] = coo.data
    hi = data.astype(np.float32)
    lo = (data - hi.astype(np.float64)).astype(np.float32)
    return hi, lo, tuple(int(o) for o in uniq), (int(nrows), int(ncols))


def host_df_saddle(A, B, C, device):
    """``pack_df_saddle`` with the host placements above (B' from a host
    ``B.T.tocsr()``), built into the port's ``DFSaddle`` on ``device``."""
    import torch

    from cpkrylov_tpu_torch.ops.df64 import DFSaddle, df_dia

    C = sp.csr_matrix(C)
    if (C - sp.diags(C.diagonal())).nnz:
        return None
    B = sp.csr_matrix(B)
    packs = [host_df_dia(X) for X in (A, B, B.T.tocsr())]
    if any(p is None for p in packs):
        return None
    a, b, bt = (df_dia(*p, device=device) for p in packs)
    diag = C.diagonal().astype(np.float64)
    ch = diag.astype(np.float32)
    cl = (diag - ch.astype(np.float64)).astype(np.float32)
    return DFSaddle(a=a, bt=bt, b=b,
                    c_diag=(torch.as_tensor(ch).to(device),
                            torch.as_tensor(cl).to(device)),
                    n=int(A.shape[0]), m=int(C.shape[0]))


def _entries(nrows, ncols, rows, cols, vals, index_dtype=np.int32):
    """A CSR of the given entries, stored in the order given (unsorted and
    duplicated entries kept as they are), with ``index_dtype`` indices."""
    rows = np.asarray(rows, np.int64)
    order = np.argsort(rows, kind="stable")
    indptr = np.zeros(nrows + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    m = sp.csr_matrix((nrows, ncols))
    m.data = np.asarray(vals, np.float64)[order]
    m.indices = np.asarray(cols, index_dtype)[order]
    m.indptr = np.cumsum(indptr).astype(index_dtype)
    m.has_sorted_indices = False
    m.has_canonical_format = False
    return m


def at_gate(n, extra, index_dtype=np.int32):
    """An n x n matrix on the offsets -1, 0, 1 with 2n/3 + ``extra`` stored
    entries: 3 n padded slots, so at ``extra`` = 0 exactly 4.5 slots an
    entry (the gate of both packs, which passes) and at -1 just past it."""
    assert (2 * n) % 3 == 0
    nmain = 2 * n // 3 - 2 + extra
    rows = [0, 1] + list(range(nmain))
    cols = [1, 0] + list(range(nmain))
    vals = np.linspace(1.0, 2.0, len(rows))
    return _entries(n, n, rows, cols, vals, index_dtype)


def gate_cases():
    """name -> (matrix, passes the gate): matrices at and past the gate."""
    return {"at_gate": (at_gate(90, 0), True),
            "past_gate": (at_gate(90, -1), False),
            "at_gate_int64": (at_gate(900, 0, np.int64), True),
            "past_gate_int64": (at_gate(900, -1, np.int64), False)}


def placement_cases(rng):
    """name -> matrix: the placement's shapes, layouts and index dtypes."""
    n, m = 1500, 400
    offs = [-3, -2, -1, 0, 1, 2, 3]
    square = sp.diags([rng.standard_normal(n - abs(o)) for o in offs], offs,
                      format="csr")
    rect = sp.diags([1.0 + rng.random(m), rng.standard_normal(m)], [0, 1],
                    shape=(m, n), format="csr")
    tall = rect.T.tocsr()
    zeros = square.copy()
    zeros.data[::5] = 0.0           # explicit stored zeros, -0.0 among them
    zeros.data[1::10] = -0.0
    far = sp.csr_matrix(sp.diags([rng.standard_normal(n - 1000),
                                  rng.standard_normal(n)], [-1000, 0]))
    far.data[far.data > 1.5] = 1e-40       # subnormal in f32
    far.data[far.data < -1.5] = -1e-310    # subnormal in f64, 0 in f32
    # each row stored in descending column order, its diagonal entry twice
    dup_r, dup_c, dup_v = [], [], []
    for i in range(200):
        for j in sorted({max(i - 2, 0), i, min(i + 3, 249)}, reverse=True):
            v = rng.standard_normal()
            if j == i:
                dup_r += [i, i]
                dup_c += [j, j]
                dup_v += [v, 0.5 * v + 1e-9]
            else:
                dup_r.append(i)
                dup_c.append(j)
                dup_v.append(v)
    dups = _entries(200, 250, dup_r, dup_c, dup_v)
    wide64 = rect.copy()
    wide64.indices = wide64.indices.astype(np.int64)
    wide64.indptr = wide64.indptr.astype(np.int64)
    return {"square": square, "rect": rect, "tall": tall, "zeros": zeros,
            "far_subnormal": far, "dups_unsorted": dups, "int64": wide64,
            "empty": sp.csr_matrix((40, 60))}
