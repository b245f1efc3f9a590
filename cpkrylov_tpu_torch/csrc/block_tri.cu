// Blocked forward substitution (B9) for Hopper (sm_90a): one launch per
// lower triangular solve.
//
// Replaces the XLA loop of the JAX package's
// cpkrylov_tpu/precond/trisolve.py::block_tri_solve (one lax.fori_loop over
// the panels; it reaches no pallas_call).  The factor is packed by
// precond/trisolve.py::build_block_tri in panels of p rows: inv[i] = T_ii^-1
// (p x p, row-major, lower triangular), and the entries of T left of a
// row's panel in ELL rows of K slots (off_data, off_cols int32), a row's
// entries in its first count[r] slots.  For i = 0 .. nb-1 in order:
//
//     rhs_i = b_i - off_i x            (row r: sum over its count[r] slots)
//     x_i   = inv_i rhs_i
//
// What bounds it on the H100: the sequential depth, not the bytes.  One f64
// solve of CVXQP3-L's factor must read the lower triangles of inv (18.2 MB)
// and the off entries (6.8 MB at 12 bytes each), about 7.6 us at
// 3.35 TB/s, but the 69 panels are 138 dependent stages (the off entries of
// panel i reach up to 2213 rows back), each a gather or a dot product at the
// latency of L2 plus a barrier.
//
// Design: one thread block cluster of kCluster blocks walks the panels.
// Block `rank` owns ceil(p / kCluster) consecutive rows of every panel, a
// warp per row (more rows a warp when a block would need more than 32
// warps).
//   (a) For each of its rows a warp walks the row's count[r] slots
//       (contiguous: lane k takes slots k, k + 32, ...; the padding of the
//       ELL, 96 % of CVXQP3-L's slots, is never read), gathers x from L2,
//       reduces in a fixed butterfly, and stores b_r - sum into rhs[r] of
//       every block of the cluster through distributed shared memory.
//   (b) After a cluster barrier, each warp forms its rows of inv_i rhs over
//       the lower triangle (row j reads j + 1 entries) and stores them in x.
// A second cluster barrier (release / acquire at cluster scope) makes x_i
// visible to the next panel's gathers, which read x with ld.global.cg (L2,
// never a stale L1 line).  Both barriers are split: between the arrive and
// the wait each warp loads what the next stage reads and what does not
// depend on the other blocks: its row of inv_i before (b), the count and the
// first 32 slots of its next row before (a).
// Determinism: no atomics; every sum is taken in the same order on every
// call (per lane in slot order, then the butterfly), so a second call on the
// same inputs gives the same bits.  The plain version (trisolve.py::
// block_tri_solve_plain) sums in torch's order, so the two agree to
// rounding, not bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;        // blocks of the cluster (portable size)
constexpr int kMaxPanel = 1024;    // largest p the kernel takes
constexpr int kMaxWarps = 32;
constexpr int kPre = 8;            // inv entries a lane loads ahead (p <= 256)
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// release / acquire at cluster scope (the instructions' default semantics)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
block_tri_kernel(const T* __restrict__ inv, const T* __restrict__ od,
                 const int* __restrict__ oc, const int* __restrict__ cnt,
                 const T* __restrict__ b, T* x, int64_t n, int p, int64_t nb,
                 int K, int rows_b) {
  __shared__ T rhs[kMaxPanel];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warps = static_cast<int>(blockDim.x) >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_end = min(p, (rank + 1) * rows_b);
  const int j0 = rank * rows_b + warp;     // this warp's first row
  const bool has_row = j0 < row_end;

  // what stage (a) of the next panel reads first, independent of x:
  // the first row's count and first slot of this lane
  int pc = 0;
  T pd = T(0);
  int pcol = 0;
  auto prefetch_a = [&](int64_t base) {
    if (!has_row) return;
    const int64_t g = base + j0;
    pc = cnt[g];
    if (lane < pc) {
      pd = od[g * K + lane];
      pcol = oc[g * K + lane];
    }
  };
  // every block of the cluster runs before any writes into its rhs
  cluster_arrive();
  prefetch_a(0);
  cluster_wait();

  for (int64_t i = 0; i < nb; ++i) {
    const int64_t base = i * p;
    // (a) rhs of this block's rows, into every block's rhs
    for (int j = j0; j < row_end; j += warps) {
      const int64_t g = base + j;
      const T* d = od + g * K;
      const int* cols = oc + g * K;
      T acc = T(0);
      int c, k;
      if (j == j0) {
        c = pc;
        if (lane < c) acc += pd * __ldcg(x + pcol);
        k = lane + 32;
      } else {
        c = cnt[g];
        k = lane;
      }
#pragma unroll 4
      for (; k < c; k += 32) acc += d[k] * __ldcg(x + cols[k]);
      acc = warp_sum(acc);
      const T v = (g < n ? b[g] : T(0)) - acc;
      if (lane < kCluster) {
        T* dst = cluster.map_shared_rank(&rhs[0], lane);
        dst[j] = v;
      }
    }
    cluster_arrive();
    // this warp's first row of inv_i, ahead of the barrier
    T pre[kPre];
    const T* row0 = inv + (base + j0) * p;
#pragma unroll
    for (int t = 0; t < kPre; ++t) {
      const int k = lane + 32 * t;
      pre[t] = (has_row && k <= j0) ? row0[k] : T(0);
    }
    cluster_wait();
    // (b) x_i = inv_i rhs over the lower triangle
    for (int j = j0; j < row_end; j += warps) {
      const T* row = inv + (base + j) * p;
      T acc = T(0);
      int k = lane;
      if (j == j0) {
#pragma unroll
        for (int t = 0; t < kPre; ++t, k += 32) {
          if (k <= j) acc += pre[t] * rhs[k];
        }
      }
      for (; k <= j; k += 32) acc += row[k] * rhs[k];
      acc = warp_sum(acc);
      if (lane == 0) __stcg(x + base + j, acc);
    }
    cluster_arrive();
    if (i + 1 < nb) prefetch_a(base + p);
    cluster_wait();
  }
}

template <typename T>
int launch_block_tri(const void* inv, const void* od, const void* oc,
                     const void* cnt, const void* b, void* x, int64_t n,
                     int p, int64_t nb, int K, void* stream) {
  if (p < 1 || p > kMaxPanel || K < 1 || nb * p < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb <= 0) return static_cast<int>(cudaGetLastError());
  const int rows_b = (p + kCluster - 1) / kCluster;
  const int warps = rows_b < kMaxWarps ? rows_b : kMaxWarps;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(32 * warps, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, block_tri_kernel<T>, static_cast<const T*>(inv),
      static_cast<const T*>(od), static_cast<const int*>(oc),
      static_cast<const int*>(cnt), static_cast<const T*>(b),
      static_cast<T*>(x), n, p, nb, K, rows_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cpkt_block_tri_f32(const void* inv, const void* od, const void* oc,
                       const void* cnt, const void* b, void* x, int64_t n,
                       int p, int64_t nb, int K, void* stream) {
  return launch_block_tri<float>(inv, od, oc, cnt, b, x, n, p, nb, K, stream);
}

int cpkt_block_tri_f64(const void* inv, const void* od, const void* oc,
                       const void* cnt, const void* b, void* x, int64_t n,
                       int p, int64_t nb, int K, void* stream) {
  return launch_block_tri<double>(inv, od, oc, cnt, b, x, n, p, nb, K,
                                  stream);
}

}  // extern "C"
