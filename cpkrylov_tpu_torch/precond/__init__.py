"""The constraint preconditioner: host factorization, permutes, triangular
solves (including the bidiagonal scan kernel) and the device operator."""
