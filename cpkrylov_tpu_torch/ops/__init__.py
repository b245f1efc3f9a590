"""Sparse containers, the DIA SpMV kernel and SpMV dispatch."""
