// Banded lower triangular solve in the reduced-state scan form (B4) and the
// affine scan of its panel tail states (B6), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   cpkrylov_tpu/precond/pallas_tri.py::_fused_tri_kernel   (B4, launched by
//     pallas_tri_solve) and
//   cpkrylov_tpu/precond/pallas_tri.py::_affine_scan_kernel (B6, launched by
//     affine_lane_scan).
//
// B4 solves T x = b for a lower triangular T of subdiagonal reach r <= p,
// packed in panels of p rows (precond/trisolve.py::ReducedScanTriFactor):
// inv[i] = T_ii^-1 (p x p) and W[i] = T_ii^-1 S_i (p x r), both row-major and
// panel-major.  With c_i = inv_i b_i and s_i the last r entries of x_i,
//
//     s_i = -W_i[p-r:] s_{i-1} + c_i[p-r:]      (the scan, B6)
//     x_i = c_i - W_i s_{i-1}.
//
// B6 is the inclusive prefix of s_i = alpha M_i s_{i-1} + c_i from s_{-1} = 0,
// for (r x r) maps M_i given by strides, so one kernel serves both its own
// lane-major contract (M (r, r, nb), c (r, nb), s (r, nb)) and B4's scan
// phase, which reads W's tail rows and c's tail entries in place.
//
// What bounds it on the H100: memory bandwidth.  One f64 solve at the
// AUG2D-L factor shape (p = 632, r = 631, nb = 473) must read inv and W,
// 3.0 GB, for 7.5e8 flops: about 0.25 flop per byte.  The design:
//   1. c kernel: a warp per panel row streams the row of inv_i (coalesced)
//      against b_i staged in shared memory.  All panels in parallel.
//   2. scan kernel: the recurrence is sequential over panels, and the TPU
//      kernel's Hillis-Steele doubling over lanes composes (r x r) maps at
//      every level (nb log2(nb) r^3 multiply-adds, ~1e12 at AUG2D-L) to get
//      parallelism.  Here the work stays r^2 per panel: a sequential carry,
//      run by one thread block cluster of 16 blocks on as many SMs (a
//      non-portable cluster size: a card that cannot schedule it gets an
//      error, not another kernel).  Each block owns r / 16 rows of M_i; its
//      warps form those
//      rows' dot products with the state held in shared memory, write the
//      new entries into every block's shared state through distributed
//      shared memory, and the cluster barrier ends the step.  The state
//      never leaves the SMs; M is read once.  A step is bound by the
//      latency of its loads on 16 SMs, not by the card's bandwidth: the
//      scan is most of B4's time at AUG2D-L's shape.
//   3. x kernel: like 1, streaming the rows of W_i against s_{i-1} staged in
//      shared memory.
// The caller (precond/cuda_tri.py) launches the three in order on one
// stream: c and x through cpkt_band_c / cpkt_band_x, the scan through B6's
// own entry, so that B6's launches are counted where B6 is launched.
// Total traffic: inv once, W twice (its tail rows in 2, all of it in 3),
// plus vectors.  A fused kernel that forms x_i inside the scan step would
// read W once; that is later work.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;        // c and x kernels
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;            // panel rows per block in c and x
constexpr int kMaxPanel = 1024;      // p (and so r) the kernels take
constexpr int kScanThreads = 1024;   // a block of the scan's cluster
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kCluster = 16;         // blocks of the scan's cluster
// the rows of M_i a warp owns at most (r <= kMaxPanel), and the k-values a
// lane loads before it multiplies (chosen on the H100 so that no register
// spills)
constexpr int kR = kMaxPanel / kCluster / kScanWarps;  // 2
constexpr int kU = 8;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// c[i, j] = sum_k inv[i, j, k] * b[i * p + k]  (b zero past n).
// grid (nb, ceil(p / kRows)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
band_c_kernel(const T* __restrict__ inv, const T* __restrict__ b,
              T* __restrict__ c, int64_t n, int p) {
  __shared__ T bs[kMaxPanel];
  const int64_t i = blockIdx.x;
  const int64_t base = i * p;
  for (int k = threadIdx.x; k < p; k += kThreads) {
    const int64_t g = base + k;
    bs[k] = g < n ? b[g] : T(0);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j_end = min(p, static_cast<int>(blockIdx.y + 1) * kRows);
  for (int j = static_cast<int>(blockIdx.y) * kRows + warp; j < j_end;
       j += kWarps) {
    const T* row = inv + (base + j) * p;
    T acc = T(0);
#pragma unroll 4
    for (int k = lane; k < p; k += 32) acc += __ldg(row + k) * bs[k];
    acc = warp_sum(acc);
    if (lane == 0) c[base + j] = acc;
  }
}

// x[i * p + j] = c[i, j] - sum_k W[i, j, k] * s[i - 1, k]  (s_{-1} = 0),
// for i * p + j < n.  s is (nb, r) row-major.  grid (nb, ceil(p / kRows)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
band_x_kernel(const T* __restrict__ w, const T* __restrict__ c,
              const T* __restrict__ s, T* __restrict__ x, int64_t n, int p,
              int r) {
  __shared__ T sp[kMaxPanel];
  const int64_t i = blockIdx.x;
  const int64_t base = i * p;
  for (int k = threadIdx.x; k < r; k += kThreads) {
    sp[k] = i > 0 ? s[(i - 1) * r + k] : T(0);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j_end = min(p, static_cast<int>(blockIdx.y + 1) * kRows);
  for (int j = static_cast<int>(blockIdx.y) * kRows + warp; j < j_end;
       j += kWarps) {
    if (base + j >= n) break;  // rows ascend: the rest are padding too
    const T* row = w + (base + j) * r;
    T acc = T(0);
#pragma unroll 4
    for (int k = lane; k < r; k += 32) acc += __ldg(row + k) * sp[k];
    acc = warp_sum(acc);
    if (lane == 0) x[base + j] = c[base + j] - acc;
  }
}

// B6: s[:, i] = alpha * M_i s[:, i-1] + c[:, i], s[:, -1] = 0, with
// M_i[j, k] = m[j * msj + k * msk + i * msi], c_i[j] = c[j * csj + i * csi]
// and s_i[j] written to s[j * ssj + i * ssi].  One cluster of kCluster
// blocks; block `rank` owns rows [rank * rows, (rank + 1) * rows), and warp
// w of it the rows j0 + w + q * kScanWarps, q < kR.  A step is bound by the latency
// of M_i's loads on the cluster's SMs, so a lane first loads kU entries of
// each of its rows, then multiplies them: kU * kR loads in flight a lane.
// The sum over k runs in ascending k within each lane, then across lanes.
// The state is double-buffered in every block's shared memory: step i reads
// buffer cur and writes buffer cur ^ 1 of all blocks, and the cluster
// barrier orders the two.
template <typename T>
__global__ void __launch_bounds__(kScanThreads)
affine_scan_kernel(const T* __restrict__ m, int64_t msj, int64_t msk,
                   int64_t msi, T alpha, const T* __restrict__ c, int64_t csj,
                   int64_t csi, T* __restrict__ s, int64_t ssj, int64_t ssi,
                   int r, int64_t nb) {
  __shared__ T state[2][kMaxPanel];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = kCluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rows = (r + cs - 1) / cs;
  const int j0 = rank * rows;
  const int j1 = min(r, j0 + rows);
  int nrows = 0;  // rows of this warp (<= kR as r <= kMaxPanel)
  for (int j = j0 + warp; j < j1; j += kScanWarps) ++nrows;
  for (int k = threadIdx.x; k < r; k += kScanThreads) state[0][k] = T(0);
  cluster.sync();
  int cur = 0;
  for (int64_t i = 0; i < nb; ++i) {
    const T* mi = m + i * msi + static_cast<int64_t>(j0 + warp) * msj;
    const T* st = state[cur];
    T acc[kR];
#pragma unroll
    for (int q = 0; q < kR; ++q) acc[q] = T(0);
    int k = lane;
    for (; k + 32 * (kU - 1) < r; k += 32 * kU) {
      T v[kU][kR];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
#pragma unroll
        for (int q = 0; q < kR; ++q) {
          v[u][q] = q < nrows
                        ? __ldg(mi + static_cast<int64_t>(k + 32 * u) * msk +
                                static_cast<int64_t>(q) * kScanWarps * msj)
                        : T(0);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const T sk = st[k + 32 * u];
#pragma unroll
        for (int q = 0; q < kR; ++q) acc[q] += v[u][q] * sk;
      }
    }
    for (; k < r; k += 32) {
      const T sk = st[k];
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        if (q < nrows) {
          acc[q] += __ldg(mi + static_cast<int64_t>(k) * msk +
                          static_cast<int64_t>(q) * kScanWarps * msj) * sk;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      if (q < nrows) {
        const int j = j0 + warp + q * kScanWarps;
        const T v = alpha * warp_sum(acc[q]) + c[j * csj + i * csi];
        if (lane == 0) s[j * ssj + i * ssi] = v;
        if (lane < cs) {
          T* dst = cluster.map_shared_rank(&state[cur ^ 1][0],
                                           static_cast<unsigned>(lane));
          dst[j] = v;
        }
      }
    }
    cluster.sync();
    cur ^= 1;
  }
}

// B6 on one cluster of kCluster blocks, a size beyond the portable 8 that
// the kernel must be allowed once per element type.
template <typename T>
int launch_affine_scan(const void* m, int64_t msj, int64_t msk, int64_t msi,
                       T alpha, const void* c, int64_t csj, int64_t csi,
                       void* s, int64_t ssj, int64_t ssi, int r, int64_t nb,
                       cudaStream_t st) {
  if (r < 1 || r > kMaxPanel) return static_cast<int>(cudaErrorInvalidValue);
  if (nb <= 0) return static_cast<int>(cudaGetLastError());
  static const cudaError_t allowed = cudaFuncSetAttribute(
      affine_scan_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed,
      1);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kScanThreads, 1, 1);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, affine_scan_kernel<T>, static_cast<const T*>(m), msj, msk, msi,
      alpha, static_cast<const T*>(c), csj, csi, static_cast<T*>(s), ssj, ssi,
      r, nb);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool band_shape_ok(int64_t n, int p, int r, int64_t nb) {
  return p >= 1 && p <= kMaxPanel && r >= 1 && r <= p && nb * p >= n;
}

dim3 band_grid(int64_t nb, int p) {
  return dim3(static_cast<unsigned>(nb),
              static_cast<unsigned>((p + kRows - 1) / kRows));
}

// B4's first phase: c = inv b, c (nb * p) scratch.
template <typename T>
int launch_band_c(const void* inv, const void* b, void* c, int64_t n, int p,
                  int64_t nb, void* stream) {
  if (!band_shape_ok(n, p, 1, nb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  band_c_kernel<T><<<band_grid(nb, p), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(inv), static_cast<const T*>(b),
      static_cast<T*>(c), n, p);
  return static_cast<int>(cudaGetLastError());
}

// B4's last phase: x = c - W s_prev, s (nb, r) row-major from the scan.
template <typename T>
int launch_band_x(const void* w, const void* c, const void* s, void* x,
                  int64_t n, int p, int r, int64_t nb, void* stream) {
  if (!band_shape_ok(n, p, r, nb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  band_x_kernel<T><<<band_grid(nb, p), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), static_cast<const T*>(c),
      static_cast<const T*>(s), static_cast<T*>(x), n, p, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cpkt_band_c_f32(const void* inv, const void* b, void* c, int64_t n, int p,
                    int64_t nb, void* stream) {
  return launch_band_c<float>(inv, b, c, n, p, nb, stream);
}

int cpkt_band_c_f64(const void* inv, const void* b, void* c, int64_t n, int p,
                    int64_t nb, void* stream) {
  return launch_band_c<double>(inv, b, c, n, p, nb, stream);
}

int cpkt_band_x_f32(const void* w, const void* c, const void* s, void* x,
                    int64_t n, int p, int r, int64_t nb, void* stream) {
  return launch_band_x<float>(w, c, s, x, n, p, r, nb, stream);
}

int cpkt_band_x_f64(const void* w, const void* c, const void* s, void* x,
                    int64_t n, int p, int r, int64_t nb, void* stream) {
  return launch_band_x<double>(w, c, s, x, n, p, r, nb, stream);
}

int cpkt_affine_scan_f32(const void* m, int64_t msj, int64_t msk, int64_t msi,
                         double alpha, const void* c, int64_t csj,
                         int64_t csi, void* s, int64_t ssj, int64_t ssi, int r,
                         int64_t nb, void* stream) {
  return launch_affine_scan<float>(m, msj, msk, msi, static_cast<float>(alpha),
                                   c, csj, csi, s, ssj, ssi, r, nb,
                                   static_cast<cudaStream_t>(stream));
}

int cpkt_affine_scan_f64(const void* m, int64_t msj, int64_t msk, int64_t msi,
                         double alpha, const void* c, int64_t csj,
                         int64_t csi, void* s, int64_t ssj, int64_t ssi, int r,
                         int64_t nb, void* stream) {
  return launch_affine_scan<double>(m, msj, msk, msi, alpha, c, csj, csi, s,
                                    ssj, ssi, r, nb,
                                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
