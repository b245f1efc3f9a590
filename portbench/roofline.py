"""Least times of kernels from the operations and bytes their inputs need,
against the peaks in ``peaks.json``."""
from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def peaks() -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


def triangle_work(nnz: int, nrows: int, value_bytes: int):
    """(bytes, flops) of one triangular solve with a sparse triangle of
    ``nnz`` stored entries (off the diagonal) and ``nrows`` rows, counted
    from the triangle and not from any device layout: each stored entry
    read once (its value and an int32 column), the row pointers (int32,
    nrows + 1), b read and x written; a multiply and an add an entry and a
    scale a row."""
    nbytes = (nnz * (value_bytes + 4) + 4 * (nrows + 1)
              + 2 * value_bytes * nrows)
    return nbytes, 2 * nnz + nrows


def least_s(nbytes: float, flops: float, dtype: str, pk: dict) -> float:
    """max(bytes / HBM bandwidth, flops / peak rate), seconds."""
    return max(nbytes / pk["hbm_bytes_per_s"],
               flops / pk["flops_per_s"][dtype])
