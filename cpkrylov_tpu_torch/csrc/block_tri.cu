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
// latency of L2 plus a cluster barrier (~0.63 us each by clock stamps,
// tools/b9_panel_breakdown.py).
//
// Design: one thread block cluster of kCluster blocks walks the panels, 16
// blocks where the card schedules a cluster that large (non-portable), else
// 8.  Row j of every panel belongs to block j % kCluster, a warp a row (more
// rows a warp past kCluster * kMaxWarps rows), so each block holds an equal
// share of every panel's inverse triangle and of its entries.
//   (a) For each of its rows a warp sums the row's entries (lane k takes
//       slots k, k + 32, ...; the padding of the ELL, 96 % of CVXQP3-L's
//       slots, is never read), gathers x from L2, reduces in a fixed
//       butterfly, and stores b_r - sum into rhs[r] of every block of the
//       cluster through distributed shared memory.
//   (b) After a cluster barrier, each warp forms its rows of inv_i rhs over
//       the lower triangle (row j reads j + 1 entries) and stores them in x.
// A second cluster barrier (release / acquire at cluster scope) makes x_i
// visible to the next panel's gathers, which read x with ld.global.cg (L2,
// never a stale L1 line).  What does not depend on x is loaded a stage or
// more ahead, for each warp's first row of the next panel: its count at the
// panel's top; its slots, columns and row of inv as L2 prefetches after
// the first barrier's arrive; its row of inv (kPre entries a lane) into
// registers, its first kFirst * 32 slots and columns and b_r between the
// second barrier's arrive and wait.  rhs lies in dynamic shared memory
// sized from p; a panel whose rhs does not fit there (kOnChip false) keeps
// it in a scratch buffer in device memory, written once by its owner and
// read through L2 after the barrier.
// Determinism: no atomics; every sum is taken in the same order on every
// call (per lane in slot order, then the butterfly), so a second call on
// the same inputs gives the same bits, whatever the cluster's size.  The
// plain version (cuda_block_tri.py::block_tri_solve_plain) sums in torch's
// order, so the two agree to rounding, not bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kPre = 8;            // inv entries a lane loads ahead (p <= 256)
constexpr int kFirst = 2;          // slot rounds of a row loaded ahead
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

// the 128-byte lines of [p, p + bytes) into L2, spread over the warp
__device__ __forceinline__ void prefetch_l2(const void* p, int64_t bytes,
                                            int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (uintptr_t l = (a & ~uintptr_t(127)) + 128 * lane; l < a + bytes;
       l += 32 * 128) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(l));
  }
}

// warps of a block: kCluster * kMaxWarps = 256 rows of a panel a warp each
template <int kCluster>
constexpr int max_warps() {
  return 256 / kCluster;
}

template <typename T, int kCluster, bool kOnChip>
__global__ void __launch_bounds__(max_warps<kCluster>() * 32, 1)
block_tri_kernel(const T* __restrict__ inv, const T* __restrict__ od,
                 const int* __restrict__ oc, const int* __restrict__ cnt,
                 const T* __restrict__ b, T* x, T* scratch, int64_t n, int p,
                 int64_t nb, int K) {
  // rhs: in dynamic shared memory (addressed as such, so its loads are
  // LDS), or in the scratch buffer of a panel that does not fit
  extern __shared__ __align__(16) unsigned char smem[];
  T* const rhs_s = reinterpret_cast<T*>(smem);
  T* const rhs_g = scratch;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warps = static_cast<int>(blockDim.x) >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j0 = rank + kCluster * warp;   // this warp's first row
  const int jstep = kCluster * warps;
  const bool has_row = j0 < p;

  // what the next panel reads first of the warp's row j0, independent of x
  int pc = 0;            // its count
  T pd[kFirst];          // its first kFirst * 32 slots and columns
  int pcol[kFirst];
  T pb = T(0);           // b_r
  T pre[kPre];           // its row of inv
  auto load_a = [&](int64_t base, int c) {
    if (!has_row) return;
    const int64_t g = base + j0;
    pc = c;
#pragma unroll
    for (int r = 0; r < kFirst; ++r) {
      const int k = lane + 32 * r;
      if (k < pc) {
        pd[r] = od[g * K + k];
        pcol[r] = oc[g * K + k];
      }
    }
    pb = g < n ? b[g] : T(0);
  };
  auto load_inv = [&](int64_t base) {
    const T* row0 = inv + (base + j0) * p;
#pragma unroll
    for (int t = 0; t < kPre; ++t) {
      const int k = lane + 32 * t;
      pre[t] = (has_row && k <= j0) ? row0[k] : T(0);
    }
  };
  // every block of the cluster runs before any writes into its rhs
  cluster_arrive();
  load_a(0, has_row ? cnt[j0] : 0);
  load_inv(0);
  cluster_wait();

  for (int64_t i = 0; i < nb; ++i) {
    const int64_t base = i * p;
    const bool next = i + 1 < nb;
    const int ncnt = (has_row && next) ? cnt[base + p + j0] : 0;
    // (a) rhs of this block's rows, into every block's rhs
    for (int j = j0; j < p; j += jstep) {
      const int64_t g = base + j;
      const T* d = od + g * K;
      const int* cols = oc + g * K;
      T acc = T(0);
      T bg;
      int c, k;
      if (j == j0) {
        c = pc;
#pragma unroll
        for (int r = 0; r < kFirst; ++r) {
          if (lane + 32 * r < c) acc += pd[r] * __ldcg(x + pcol[r]);
        }
        k = lane + 32 * kFirst;
        bg = pb;
      } else {
        c = cnt[g];
        k = lane;
        bg = g < n ? b[g] : T(0);
      }
#pragma unroll 4
      for (; k < c; k += 32) acc += d[k] * __ldcg(x + cols[k]);
      acc = warp_sum(acc);
      const T v = bg - acc;
      if constexpr (kOnChip) {
        if (lane < kCluster) *cluster.map_shared_rank(rhs_s + j, lane) = v;
      } else {
        if (lane == 0) __stcg(rhs_g + j, v);
      }
    }
    cluster_arrive();
    if (next && has_row) {
      const int64_t g = base + p + j0;
      prefetch_l2(od + g * K, int64_t(ncnt) * sizeof(T), lane);
      prefetch_l2(oc + g * K, int64_t(ncnt) * sizeof(int), lane);
      prefetch_l2(inv + g * p, int64_t(j0 + 1) * sizeof(T), lane);
    }
    cluster_wait();
    // (b) x_i = inv_i rhs over the lower triangle
    for (int j = j0; j < p; j += jstep) {
      const T* row = inv + (base + j) * p;
      T acc = T(0);
      int k = lane;
      if (j == j0) {
#pragma unroll
        for (int t = 0; t < kPre; ++t, k += 32) {
          if (k <= j) {
            if constexpr (kOnChip) {
              acc += pre[t] * rhs_s[k];
            } else {
              acc += pre[t] * __ldcg(rhs_g + k);
            }
          }
        }
      }
      if constexpr (kOnChip) {
        for (; k <= j; k += 32) acc += row[k] * rhs_s[k];
      } else {
        for (; k <= j; k += 32) acc += row[k] * __ldcg(rhs_g + k);
      }
      acc = warp_sum(acc);
      if (lane == 0) __stcg(x + base + j, acc);
    }
    cluster_arrive();
    if (next) {
      load_inv(base + p);
      load_a(base + p, ncnt);
    }
    cluster_wait();
  }
}

constexpr int kMaxDevices = 64;

// With `clusters` set, only writes how many clusters of this size the card
// places at once (0: none), and launches nothing.
template <typename T, int kCluster, bool kOnChip>
cudaError_t launch_mode(int device, int* clusters, size_t smem,
                        cudaStream_t stream, const void* inv, const void* od,
                        const void* oc, const void* cnt, const void* b,
                        void* x, void* scratch, int64_t n, int p, int64_t nb,
                        int K) {
  auto kernel = block_tri_kernel<T, kCluster, kOnChip>;
  static bool attr_set[kMaxDevices] = {};
  cudaError_t err = cudaSuccess;
  if (kCluster > 8 && !attr_set[device]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess && clusters != nullptr) {
      cudaGetLastError();   // a card without non-portable clusters
      *clusters = 0;
      return cudaSuccess;
    }
    if (err != cudaSuccess) return err;
    attr_set[device] = true;
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int rows_b = (p + kCluster - 1) / kCluster;
  const int warps = rows_b < max_warps<kCluster>() ? rows_b
                                                   : max_warps<kCluster>();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(32 * warps, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters != nullptr) {
    *clusters = 0;
    if (cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg) !=
        cudaSuccess) {
      *clusters = 0;
      cudaGetLastError();
    }
    return cudaSuccess;
  }
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(inv), static_cast<const T*>(od),
      static_cast<const int*>(oc), static_cast<const int*>(cnt),
      static_cast<const T*>(b), static_cast<T*>(x), static_cast<T*>(scratch),
      n, p, nb, K);
}

template <typename T, int kCluster>
cudaError_t launch_cluster(int device, int* clusters, int on_chip,
                           cudaStream_t st, const void* inv, const void* od,
                           const void* oc, const void* cnt, const void* b,
                           void* x, void* scratch, int64_t n, int p,
                           int64_t nb, int K) {
  return on_chip
             ? launch_mode<T, kCluster, true>(device, clusters,
                                              sizeof(T) * p, st, inv, od, oc,
                                              cnt, b, x, scratch, n, p, nb, K)
             : launch_mode<T, kCluster, false>(device, clusters, 0, st, inv,
                                               od, oc, cnt, b, x, scratch, n,
                                               p, nb, K);
}

// the cluster size a device takes: 0 not yet probed, then 16 or 8
int g_cluster[kMaxDevices] = {};

template <typename T>
int launch_block_tri(const void* inv, const void* od, const void* oc,
                     const void* cnt, const void* b, void* x, void* scratch,
                     int64_t n, int p, int64_t nb, int K, int on_chip,
                     void* stream) {
  if (p < 1 || K < 1 || nb * p < n || (!on_chip && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb <= 0) return static_cast<int>(cudaGetLastError());
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_cluster[device] == 0) {
    // whether the card places a 16-block cluster of the kernel at all
    int clusters = 0;
    err = launch_cluster<T, 16>(device, &clusters, on_chip, st, inv, od, oc,
                                cnt, b, x, scratch, n, p, nb, K);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_cluster[device] = clusters > 0 ? 16 : 8;
  }
  err = g_cluster[device] == 16
            ? launch_cluster<T, 16>(device, nullptr, on_chip, st, inv, od, oc,
                                    cnt, b, x, scratch, n, p, nb, K)
            : launch_cluster<T, 8>(device, nullptr, on_chip, st, inv, od, oc,
                                   cnt, b, x, scratch, n, p, nb, K);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// the most shared memory a block of `device` may take (bytes)
int64_t cpkt_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return v;
}

int cpkt_block_tri_f32(const void* inv, const void* od, const void* oc,
                       const void* cnt, const void* b, void* x,
                       void* scratch, int64_t n, int p, int64_t nb, int K,
                       int on_chip, void* stream) {
  return launch_block_tri<float>(inv, od, oc, cnt, b, x, scratch, n, p, nb,
                                 K, on_chip, stream);
}

int cpkt_block_tri_f64(const void* inv, const void* od, const void* oc,
                       const void* cnt, const void* b, void* x,
                       void* scratch, int64_t n, int p, int64_t nb, int K,
                       int on_chip, void* stream) {
  return launch_block_tri<double>(inv, od, oc, cnt, b, x, scratch, n, p, nb,
                                  K, on_chip, stream);
}

}  // extern "C"
