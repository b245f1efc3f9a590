// Sparse LDL^T factorization for symmetric indefinite matrices with
// 1x1 and adjacent 2x2 block pivots.
//
// Host-side replacement for the factorization the MATLAB reference obtains
// from the built-in `ldl` (MA57-class) call in its ops/opLDL2.m:82.  This is
// the PyTorch port's own copy of cpkrylov_tpu/native/ldl_kernel.cpp; the
// numeric code is identical, so both packages compute the same factor.
// The constraint preconditioner K_P = [G B'; B -C] is symmetric quasi-definite
// when G is SPD (Vanderbei) — then every pivot is a stable 1x1.  When G is
// merely symmetric (indefinite leading block, zero diagonal entries), MATLAB's
// MA57 switches to Bunch-Kaufman 2x2 pivots; the equivalent here is a
// restart-based scheme driven from Python (precond/ldl_host.py):
//
//   1. factor with 1x1 pivots, *recording* columns whose pivot fails the
//      stability test (|d| < pivtol * scale, or an expected-sign violation),
//   2. amalgamate each failed column with an adjacent one into a 2-column
//      group and re-run symbolic + numeric with block pivots at the groups,
//   3. after a bounded number of rounds, regularize anything still unstable
//      (counted and surfaced as `nperturbed`).
//
// The factorization is K[perm][:,perm] = (I+L) B (I+L)^T with L strictly
// lower (L(p+1,p) = 0 inside a block) and B block diagonal: D[] holds the
// diagonal, E[p] != 0 the off-diagonal of a 2x2 block at columns (p, p+1).
//
// Groups: column c belongs to group grp[c]; group g spans columns
// [gstart[g], gstart[g] + gsize[g]) with gsize in {1, 2}.  Both columns of a
// 2-group share one elimination-tree node and the union sparsity pattern
// (standard supernode amalgamation), which is exactly what makes the block
// back-substitution [l1 l2] = [z1 z2] inv(B_g) well defined structurally.
//
// Input:  upper triangular part (incl. diagonal) of the permuted matrix in
//         compressed-sparse-column form (Ap, Ai, Ax), column-sorted.
// Output: strictly-lower factor L in CSC form (Lp, Li, Lx), block diagonal
//         (D, E).  Up-looking, O(nnz(L)) beyond the dense 2x2 solves.

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Symbolic analysis over the group quotient graph: computes the group
// elimination tree `gparent` (ng entries) and per-COLUMN strictly-lower
// nonzero counts of L in `colcount` (n entries).  Rows within a group are
// walked with per-row epochs, so each row contributes its own entries;
// whenever a row reaches a 2-column group it contributes one entry to BOTH
// of that group's columns.  Returns total nnz(L).
int64_t cpk_ldl_symbolic_g(int32_t n, int32_t ng, const int32_t *Ap,
                           const int32_t *Ai, const int32_t *grp,
                           const int32_t *gstart, const int32_t *gsize,
                           int32_t *gparent, int32_t *colcount) {
  std::vector<int32_t> flag(ng, -1);
  for (int32_t c = 0; c < n; ++c) colcount[c] = 0;
  for (int32_t g = 0; g < ng; ++g) gparent[g] = -1;

  for (int32_t g = 0; g < ng; ++g) {
    const int32_t g0 = gstart[g];
    for (int32_t k = g0; k < g0 + gsize[g]; ++k) {
      flag[g] = k;  // stop walks at the current group
      for (int32_t p = Ap[k]; p < Ap[k + 1]; ++p) {
        int32_t i = Ai[p];
        if (i >= g0) continue;  // diagonal-block entries drive no pattern
        int32_t gi = grp[i];
        while (flag[gi] != k) {
          if (gparent[gi] == -1) gparent[gi] = g;
          // Row k lands in every column of group gi (union pattern).
          colcount[gstart[gi]] += 1;
          if (gsize[gi] == 2) colcount[gstart[gi] + 1] += 1;
          flag[gi] = k;
          gi = gparent[gi];
        }
      }
    }
  }
  int64_t total = 0;
  for (int32_t c = 0; c < n; ++c) total += colcount[c];
  return total;
}

// Numeric factorization with block pivots.
//
// `Lp`: column pointers (exclusive prefix sum of colcount, length n+1);
// `gparent`: group etree from the symbolic pass.  `scale[k]` is a per-column
// magnitude (max |A(:,k)|) for the relative pivot test.  `pivot_signs` may
// be null (no sign expectation).
//
// mode 0 (record): a failed 1x1 pivot is appended to `fail_cols` (capacity
//   n) and regularized so the pass can continue scouting further failures;
//   it is NOT counted as perturbed (the caller will re-pair and re-run).
// mode 1 (final): failures are regularized and counted.
// Failed 2x2 blocks are always regularized and counted (no further pairing).
//
// Returns (nfail << 32) | nperturbed, or a negative value -(k+1) on a
// structurally fatal zero pivot with no regularization configured.
int64_t cpk_ldl_numeric_g(int32_t n, int32_t ng, const int32_t *Ap,
                          const int32_t *Ai, const double *Ax,
                          const int32_t *Lp, const int32_t *gparent,
                          const int32_t *grp, const int32_t *gstart,
                          const int32_t *gsize, int32_t *Li, double *Lx,
                          double *D, double *E, const double *pivot_signs,
                          const double *scale, double pivtol,
                          double reg_value, int32_t mode,
                          int32_t *fail_cols) {
  std::vector<int32_t> flag(ng, -1), pattern(n), head(n);
  std::vector<double> y(n, 0.0);
  for (int32_t j = 0; j < n; ++j) head[j] = Lp[j];
  for (int32_t j = 0; j < n; ++j) E[j] = 0.0;
  int64_t nperturbed = 0;
  int64_t nfail = 0;

  for (int32_t g = 0; g < ng; ++g) {
    const int32_t g0 = gstart[g];
    const int32_t gs = gsize[g];
    double dk[2] = {0.0, 0.0};
    double b_off = 0.0;  // A-accumulated + eliminated off-diagonal (2-groups)

    for (int32_t r = 0; r < gs; ++r) {
      const int32_t k = g0 + r;
      int32_t top = n;
      flag[g] = k;
      for (int32_t p = Ap[k]; p < Ap[k + 1]; ++p) {
        int32_t i = Ai[p];
        if (i > k) continue;
        if (i == k) {
          dk[r] += Ax[p];
          continue;
        }
        y[i] += Ax[p];  // includes the within-group entry (i == g0, r == 1)
        if (i >= g0) continue;  // block off-diagonal: no pattern walk
        int32_t gi = grp[i];
        int32_t len = 0;
        while (flag[gi] != k) {
          pattern[len++] = gi;
          flag[gi] = k;
          gi = gparent[gi];
        }
        while (len > 0) pattern[--top] = pattern[--len];
      }

      // Up-looking elimination along reached groups (ascending etree order).
      for (int32_t s = top; s < n; ++s) {
        const int32_t j = pattern[s];
        const int32_t j0 = gstart[j];
        if (gsize[j] == 1) {
          const double yj = y[j0];
          y[j0] = 0.0;
          const double ljk = yj / D[j0];
          for (int32_t q = Lp[j0]; q < head[j0]; ++q)
            y[Li[q]] -= Lx[q] * yj;
          dk[r] -= ljk * yj;
          Li[head[j0]] = k;
          Lx[head[j0]] = ljk;
          ++head[j0];
        } else {
          const int32_t j1 = j0 + 1;
          const double z1 = y[j0], z2 = y[j1];
          y[j0] = 0.0;
          y[j1] = 0.0;
          // Scatter with the raw solve values (uses only L, not B).
          for (int32_t q = Lp[j0]; q < head[j0]; ++q)
            y[Li[q]] -= Lx[q] * z1;
          for (int32_t q = Lp[j1]; q < head[j1]; ++q)
            y[Li[q]] -= Lx[q] * z2;
          // [l1 l2] = [z1 z2] inv([[d1, e], [e, d2]]).
          const double d1 = D[j0], d2 = D[j1], e = E[j0];
          const double det = d1 * d2 - e * e;
          const double l1 = (z1 * d2 - z2 * e) / det;
          const double l2 = (z2 * d1 - z1 * e) / det;
          dk[r] -= l1 * z1 + l2 * z2;
          Li[head[j0]] = k;
          Lx[head[j0]] = l1;
          ++head[j0];
          Li[head[j1]] = k;
          Lx[head[j1]] = l2;
          ++head[j1];
        }
      }
      if (r == 1) {
        // Off-diagonal of this group's pivot block: the raw solve value at
        // the first column, b = A(k2,k1) - sum_j L(k1,j) z_j  (see header).
        b_off = y[g0];
        y[g0] = 0.0;
      }
    }

    if (gs == 1) {
      double d = dk[0];
      const double sc = scale ? scale[g0] : 1.0;
      const double sign = pivot_signs ? pivot_signs[g0] : 0.0;
      // A pivot fails only on MAGNITUDE (like MATLAB's ldl, which has no
      // sign expectations): an indefinite matrix legitimately produces
      // wrong-sign pivots, and a healthy-magnitude one is stable as-is.
      // The expected sign is used only to orient the regularization of a
      // pivot that stays unstable after the 2x2 pairing rounds.
      if (std::fabs(d) < pivtol * sc) {
        if (mode == 0 && fail_cols != nullptr) {
          fail_cols[nfail++] = g0;
          // Regularize to keep scouting; not counted (will be re-run).
          d = (sign >= 0.0 ? 1.0 : -1.0) *
              ((std::fabs(d) > reg_value) ? std::fabs(d) : reg_value);
        } else if (pivot_signs != nullptr || pivtol > 0.0) {
          d = (sign >= 0.0 ? 1.0 : -1.0) *
              ((std::fabs(d) > reg_value) ? std::fabs(d) : reg_value);
          ++nperturbed;
        } else if (d == 0.0) {
          return -(int64_t)(g0 + 1);
        }
      }
      D[g0] = d;
    } else {
      // 2x2 block stability: determinant large enough relative to scales.
      double d1 = dk[0], d2 = dk[1];
      const double sc1 = scale ? scale[g0] : 1.0;
      const double sc2 = scale ? scale[g0 + 1] : 1.0;
      const double det = d1 * d2 - b_off * b_off;
      const double floor2 = pivtol * pivtol * sc1 * sc2;
      if (std::fabs(det) < floor2 || det == 0.0) {
        // Regularize: push the diagonal apart along the expected signs so
        // the block determinant is bounded away from zero.
        const double s1 = (pivot_signs && pivot_signs[g0] < 0.0) ? -1.0 : 1.0;
        const double s2 =
            (pivot_signs && pivot_signs[g0 + 1] < 0.0) ? -1.0 : 1.0;
        const double r1 = std::fabs(b_off) + (reg_value > pivtol * sc1
                                                  ? reg_value
                                                  : pivtol * sc1);
        const double r2 = std::fabs(b_off) + (reg_value > pivtol * sc2
                                                  ? reg_value
                                                  : pivtol * sc2);
        d1 = s1 * ((std::fabs(d1) > r1) ? std::fabs(d1) : r1);
        d2 = s2 * ((std::fabs(d2) > r2) ? std::fabs(d2) : r2);
        if (std::fabs(d1 * d2 - b_off * b_off) < floor2) {
          // Same-sign diagonals can still cancel against b^2; lift again.
          d1 = s1 * (std::fabs(b_off) + r1);
          d2 = s2 * (std::fabs(b_off) + r2) * 2.0;
        }
        ++nperturbed;
      }
      D[g0] = d1;
      D[g0 + 1] = d2;
      E[g0] = b_off;
    }
  }
  return (nfail << 32) | (int64_t)nperturbed;
}

// ---------------------------------------------------------------------------
// Backward-compatible 1x1-only entry points (all-singleton groups).
// ---------------------------------------------------------------------------

int64_t cpk_ldl_symbolic(int32_t n, const int32_t *Ap, const int32_t *Ai,
                         int32_t *parent, int32_t *colcount) {
  std::vector<int32_t> grp(n), gstart(n), gsize(n, 1);
  for (int32_t i = 0; i < n; ++i) grp[i] = gstart[i] = i;
  return cpk_ldl_symbolic_g(n, n, Ap, Ai, grp.data(), gstart.data(),
                            gsize.data(), parent, colcount);
}

int64_t cpk_ldl_numeric(int32_t n, const int32_t *Ap, const int32_t *Ai,
                        const double *Ax, const int32_t *Lp,
                        const int32_t *parent, int32_t *Li, double *Lx,
                        double *D, const double *pivot_signs, double reg_tol,
                        double reg_value) {
  std::vector<int32_t> grp(n), gstart(n), gsize(n, 1);
  for (int32_t i = 0; i < n; ++i) grp[i] = gstart[i] = i;
  std::vector<double> E(n);
  int64_t st = cpk_ldl_numeric_g(
      n, n, Ap, Ai, Ax, Lp, parent, grp.data(), gstart.data(), gsize.data(),
      Li, Lx, D, E.data(), pivot_signs, /*scale=*/nullptr,
      /*pivtol=*/reg_tol, reg_value, /*mode=*/1, /*fail_cols=*/nullptr);
  return st < 0 ? st : (st & 0xffffffffLL);
}

}  // extern "C"
