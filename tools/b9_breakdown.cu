// Blocked substitution (B9) with clock stamps: where one panel's time goes.
//
// A copy of the panel walk of cpkrylov_tpu_torch/csrc/block_tri.cu as first
// ported (rhs a static array of at most 1024 rows; one 8-block cluster, a
// warp a row: (a) the row's off-panel gathers into every block's rhs, a
// cluster barrier, (b) the row of inv_i against rhs, a second cluster
// barrier), with lane 0 of every warp writing clock64() at five points of
// every panel:
//
//   s0 the panel's top, s1 after (a), s2 after the first barrier's wait,
//   s3 after (b), s4 after the second barrier's wait,
//
// into stamps[((panel * 8 + rank) * 32 + warp) * 5 + k], and thread 0 of
// rank 0 writing %globaltimer and clock64() at the walk's start and end
// (the SM clock's rate).  Built and driven by tools/b9_panel_breakdown.py;
// not part of the package.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kMaxPanel = 1024;
constexpr int kMaxWarps = 32;
constexpr int kPre = 8;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t gtimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
stamped_kernel(const T* __restrict__ inv, const T* __restrict__ od,
               const int* __restrict__ oc, const int* __restrict__ cnt,
               const T* __restrict__ b, T* x, int64_t n, int p, int64_t nb,
               int K, int rows_b, long long* stamps,
               unsigned long long* clock) {
  __shared__ T rhs[kMaxPanel];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warps = static_cast<int>(blockDim.x) >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_end = min(p, (rank + 1) * rows_b);
  const int j0 = rank * rows_b + warp;
  const bool has_row = j0 < row_end;
  auto stamp = [&](int64_t i, int k) {
    if (lane == 0) {
      stamps[((i * kCluster + rank) * kMaxWarps + warp) * 5 + k] =
          clock64();
    }
  };
  if (rank == 0 && threadIdx.x == 0) {
    clock[0] = gtimer();
    clock[1] = clock64();
  }

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
  cluster_arrive();
  prefetch_a(0);
  cluster_wait();

  for (int64_t i = 0; i < nb; ++i) {
    const int64_t base = i * p;
    stamp(i, 0);
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
    __syncwarp();
    stamp(i, 1);
    cluster_arrive();
    T pre[kPre];
    const T* row0 = inv + (base + j0) * p;
#pragma unroll
    for (int t = 0; t < kPre; ++t) {
      const int k = lane + 32 * t;
      pre[t] = (has_row && k <= j0) ? row0[k] : T(0);
    }
    cluster_wait();
    stamp(i, 2);
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
    __syncwarp();
    stamp(i, 3);
    cluster_arrive();
    if (i + 1 < nb) prefetch_a(base + p);
    cluster_wait();
    stamp(i, 4);
  }
  if (rank == 0 && threadIdx.x == 0) {
    clock[2] = gtimer();
    clock[3] = clock64();
  }
}

template <typename T>
int launch(const void* inv, const void* od, const void* oc, const void* cnt,
           const void* b, void* x, int64_t n, int p, int64_t nb, int K,
           void* stamps, void* clock, void* stream) {
  if (p < 1 || p > kMaxPanel || K < 1 || nb * p < n || nb <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows_b = (p + kCluster - 1) / kCluster;
  const int warps = rows_b < kMaxWarps ? rows_b : kMaxWarps;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(32 * warps, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, stamped_kernel<T>, static_cast<const T*>(inv),
      static_cast<const T*>(od), static_cast<const int*>(oc),
      static_cast<const int*>(cnt), static_cast<const T*>(b),
      static_cast<T*>(x), n, p, nb, K, rows_b,
      static_cast<long long*>(stamps),
      static_cast<unsigned long long*>(clock));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int b9_stamped_f32(const void* inv, const void* od, const void* oc,
                   const void* cnt, const void* b, void* x, int64_t n, int p,
                   int64_t nb, int K, void* stamps, void* clock,
                   void* stream) {
  return launch<float>(inv, od, oc, cnt, b, x, n, p, nb, K, stamps, clock,
                       stream);
}

int b9_stamped_f64(const void* inv, const void* od, const void* oc,
                   const void* cnt, const void* b, void* x, int64_t n, int p,
                   int64_t nb, int K, void* stamps, void* clock,
                   void* stream) {
  return launch<double>(inv, od, oc, cnt, b, x, n, p, nb, K, stamps, clock,
                        stream);
}

}  // extern "C"
