// Banded lower triangular solve in the reduced-state scan form (B4) and the
// affine scan of its panel states (B6), for Hopper (sm_90a).
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
//     x_i = c_i - W_i s_{i-1},      s_i = x_i[p-r:].
//
// B6 is the scan y_i = alpha M_i s_{i-1} + c_i over steps i, with s_{-1} = 0
// and s_i the last r of the q entries of y_i, for (q x r) maps M_i given by
// their row and step strides.  Under B6's own contract q = r (y_i = s_i);
// inside B4 it runs with q = p on W itself, so that every row of x_i comes
// out of the scan step and W is read once.
//
// What bounds it on the H100: memory bandwidth.  One f64 solve at the
// AUG2D-L factor shape (p = 632, r = 631, nb = 473) must read inv and W,
// 3.0 GB, for 7.5e8 flops: about 0.25 flop per byte.  Two launches:
//   1. c kernel: a warp per panel row streams the row of inv_i (coalesced)
//      against b_i staged in shared memory, all panels in parallel, and
//      writes c into x itself (padded to nb p entries).
//   2. scan kernel (B6): the recurrence is sequential over panels, and the
//      TPU kernel's Hillis-Steele doubling over lanes composes (r x r) maps
//      at every level (nb log2(nb) r^3 multiply-adds, ~1e12 at AUG2D-L).
//      Here the work stays q r per step: a sequential carry on one thread
//      block cluster of 16 blocks, one block per SM (a non-portable cluster
//      size: a card that cannot schedule it gets an error, not another
//      kernel).  Block `rank` owns
//      ceil(q / cluster) consecutive rows of every M_i, and each of its warps
//      a run of consecutive rows.  A warp streams its rows, step after step,
//      through a ring of row slots in shared memory (two in f64, four in
//      f32: a whole step's rows at AUG2D-L's shape): one TMA bulk copy
//      (cp.async.bulk) per row completing on the slot's mbarrier, the ragged
//      ends of a row that is not 16-byte aligned (at most 3 entries each) by
//      per-lane cp.async.  The loads do not depend on the state, only the
//      multiply does, so they are issued before the step that reads them:
//      the cluster barrier is split (barrier.cluster.arrive, then wait), and
//      between the two every warp refills the slots it has just read with
//      the next step's rows, stores its entries of y_i and loads those of
//      c_{i+2}.  Stores and loads before the arrive would hold up its
//      release; copies issued before it would put the data ahead of the
//      state's exchange on the cluster's links.  The state s_i is
//      double-buffered in every block's shared memory: the rows that form
//      it are written into all blocks' next buffer through distributed
//      shared memory, and the barrier orders those writes before the next
//      step's reads.
// x_i's head rows (p - r of them: at most 7 under the port's panel rule,
// 1 at AUG2D-L) are formed in the scan step like the rest, read from W once.
// The caller (precond/cuda_tri.py) launches the two in order on one stream:
// c through cpkt_band_c, the scan through B6's own entry, so that B6's
// launches are counted where B6 is launched.  Total traffic: inv and W once
// each, plus c written and read once in x.
// The scan's floor is its cluster's streaming rate, not the card's: the 16
// blocks of a cluster share one GPC's links to L2, which carry well under
// the card's 3.35 TB/s.  The same kernel without the chain
// (kChain = false: no barrier, no state exchange) reads the same slices on
// the same blocks, and chip_smoke.py reports its time beside B6's.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;        // c kernel
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;            // panel rows per block in the c kernel
constexpr int kMaxPanel = 1024;      // p (and so r) the kernels take
constexpr int kMaxScanWarps = 32;
constexpr int kCluster = 16;         // blocks of the scan's cluster
constexpr int kBlockSmem = 232448;   // shared memory a block may use
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Row slots of a scan warp's ring: two in f64, four in f32.  At AUG2D-L's
// shape a warp owns two rows of a step, so its ring holds one step's rows
// in f64 and two steps' in f32, and the 20 warps' rings fill ~200 KB.
template <typename T>
__host__ __device__ constexpr int stages() {
  return 16 / static_cast<int>(sizeof(T));
}

// Bytes of a slot: a row of r entries at any offset modulo 16.
template <typename T>
__host__ __device__ constexpr int slot_bytes(int r) {
  return (r * static_cast<int>(sizeof(T)) + 31) & ~15;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the mbarrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
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

// B6: y[:, i] = alpha * M_i s_{i-1} + c[:, i] for q rows, s_i = y[q-r:, i],
// s_{-1} = 0, with M_i[j, k] = m[j * msj + k + i * msi] (unit column
// stride), c_i[j] = c[j * csj + i * csi], y_i[j] written to y[j * ysj +
// i * ysi].  c and y may be the same memory (B4 scans in place in x).  One
// cluster; block `rank` owns rows [rank * rows_b, ...), its warp w the rw
// rows from rank * rows_b + w * rw; blockDim.x = 32 * ceil(rows_b / rw).
// Each warp streams its rows, step after step, through a ring of
// stages<T>() row slots in dynamic shared memory: a row's 16-byte-aligned
// interior by one bulk copy (TMA) completing on the slot's mbarrier, its
// ragged ends (at most 3 entries each) by per-lane cp.async.  A row sits in
// its slot at the offset its address has modulo 16.  The sum over k runs in
// four interleaved partial sums a lane, then across lanes.  With kChain
// false the state stays zero and no barrier separates the steps: the same
// reads, the read floor of the chained scan.
template <typename T, bool kChain>
__global__ void __launch_bounds__(kMaxScanWarps * 32)
affine_scan_kernel(const T* __restrict__ m, int64_t msj, int64_t msi, T alpha,
                   const T* c, int64_t csj, int64_t csi, T* y, int64_t ysj,
                   int64_t ysi, int q, int r, int64_t nb, int rows_b,
                   int rw) {
  constexpr int S = stages<T>();
  extern __shared__ __align__(128) unsigned char ring_raw[];
  __shared__ T state[2][kMaxPanel];
  __shared__ uint64_t bars[kMaxScanWarps][S];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int head = q - r;                 // rows of y_i outside the state
  const int jb0 = rank * rows_b;
  const int jb1 = min(q, jb0 + rows_b);
  const int jw0 = jb0 + warp * rw;
  const int nrows = max(0, min(jb1, jw0 + rw) - jw0);   // this warp's rows
  const int sbytes = slot_bytes<T>(r);
  unsigned char* ring = ring_raw + static_cast<int64_t>(warp) * S * sbytes;
  const int64_t rbytes = static_cast<int64_t>(r) * sizeof(T);

  if (lane == 0) {
    for (int sl = 0; sl < S; ++sl) mbar_init(smem_u32(&bars[warp][sl]), 1);
    fence_mbarrier_init();
  }
  __syncwarp();

  // row t of step i is the warp's g-th row, g = i nrows + t, in slot g % S
  auto row_src = [&](int64_t i, int t) {
    return m + i * msi + static_cast<int64_t>(jw0 + t) * msj;
  };
  auto slot_row = [&](int64_t g, const T* src) {
    return ring + (g % S) * sbytes +
           (reinterpret_cast<uintptr_t>(src) & 15);
  };
  // the copies of row t of step i (the warp's g-th); one cp.async commit
  // group per row, empty past the end
  auto issue = [&](int64_t i, int t, int64_t g) {
    if (i < nb) {
      const T* src = row_src(i, t);
      unsigned char* dst = slot_row(g, src);
      const uintptr_t a = reinterpret_cast<uintptr_t>(src);
      const uintptr_t lo = (a + 15) & ~uintptr_t(15);
      uintptr_t hi = (a + rbytes) & ~uintptr_t(15);
      if (hi < lo) hi = lo;
      const int nh = min(r, static_cast<int>((lo - a) / sizeof(T)));
      const int nt = r - nh - static_cast<int>((hi - lo) / sizeof(T));
      if (lane == 0) {
        const uint32_t bar = smem_u32(&bars[warp][g % S]);
        if (hi > lo) {
          const uint32_t n = static_cast<uint32_t>(hi - lo);
          mbar_expect_tx(bar, n);
          bulk_copy(smem_u32(dst + (lo - a)), reinterpret_cast<const void*>(lo),
                    n, bar);
        } else {
          mbar_arrive(bar);
        }
      }
      T* drow = reinterpret_cast<T*>(dst);
      if (lane < nh) cp_async(drow + lane, src + lane);
      if (lane < nt) cp_async(drow + (r - nt + lane), src + (r - nt + lane));
    }
    cp_async_commit();
  };
  // row g (row t of step i) in its slot, once its bulk copy has landed
  // (its ends: see the pair loop)
  auto wait_row = [&](int64_t i, int t, int64_t g) {
    mbar_wait(smem_u32(&bars[warp][g % S]),
              static_cast<uint32_t>((g / S) & 1));
    return reinterpret_cast<const T*>(slot_row(g, row_src(i, t)));
  };

  for (int k = threadIdx.x; k < r; k += blockDim.x) state[0][k] = T(0);
  if (nrows > 0) {
    for (int g = 0; g < S; ++g) issue(g / nrows, g % nrows, g);
  }
  // lane t holds c of the warp's row t for this step (c0) and the next
  // (c1), and y of it once formed (yv); rw <= 32
  auto load_c = [&](int64_t i) {
    return i < nb && lane < nrows
               ? c[static_cast<int64_t>(jw0 + lane) * csj + i * csi]
               : T(0);
  };
  T c0 = load_c(0), c1 = load_c(1), yv = T(0);
  cluster.sync();     // every block resident, every state zeroed

  // Refills wait for the step's end (after the arrive) when the ring holds a
  // whole step, as at AUG2D-L's shape: the data then streams while the
  // barrier completes, and the state's exchange does not queue behind it
  // on the cluster's links.  Else they follow each pair of rows.
  const bool defer = nrows <= S;
  int cur = 0;
  for (int64_t i = 0; i < nb; ++i) {
    if (kChain && i > 0) cluster_wait();    // s_{i-1} in state[cur]
    const T* st = state[cur];
    const int64_t g0 = i * nrows;
    // two rows at a time: one pass over the state, two sums in flight
    for (int t = 0; t < nrows; t += 2) {
      const bool two = t + 1 < nrows;
      const T* ra = wait_row(i, t, g0 + t);
      const T* rb = two ? wait_row(i, t + 1, g0 + t + 1) : ra;
      // the ends' copies of rows g0 + t and g0 + t + 1: one commit group
      // per row, S of them ahead of the rows read (refilled) so far
      if (defer && t > 0) {
        cp_async_wait<0>();
      } else {
        cp_async_wait<S - 2>();
      }
      __syncwarp();                         // the ends other lanes copied
      T a0 = T(0), a1 = T(0), b0 = T(0), b1 = T(0);
      int k = lane;
      for (; k + 32 < r; k += 64) {
        const T s0 = st[k], s1 = st[k + 32];
        a0 += ra[k] * s0;
        a1 += ra[k + 32] * s1;
        b0 += rb[k] * s0;
        b1 += rb[k + 32] * s1;
      }
      if (k < r) {
        a0 += ra[k] * st[k];
        b0 += rb[k] * st[k];
      }
      T va = a0 + a1, vb = b0 + b1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        va += __shfl_xor_sync(kFull, va, o);
        vb += __shfl_xor_sync(kFull, vb, o);
      }
      for (int u = 0; u < (two ? 2 : 1); ++u) {
        const int j = jw0 + t + u;
        const T v = alpha * (u ? vb : va) + __shfl_sync(kFull, c0, t + u);
        if (kChain && j >= head && lane < kCluster) {
          T* dst = cluster.map_shared_rank(&state[cur ^ 1][0],
                                           static_cast<unsigned>(lane));
          dst[j - head] = v;
        }
        if (lane == t + u) yv = v;
      }
      if (!defer) {               // the ring holds less than a step's rows
        __syncwarp();
        for (int u = t; u < min(nrows, t + 2); ++u) {
          const int f = u + S;
          issue(i + f / nrows, f % nrows, g0 + f);
        }
      }
    }
    if (kChain) cluster_arrive();
    // work the barrier need not wait for, while the other blocks finish
    // step i (its release covers the thread's earlier loads and stores, so
    // y's stores and c's loads come after it): y_i out, c_{i+2} in, and the
    // slots just read take the next step's rows
    if (lane < nrows) y[static_cast<int64_t>(jw0 + lane) * ysj + i * ysi] = yv;
    c0 = c1;
    c1 = load_c(i + 2);
    if (defer) {
      __syncwarp();
      for (int t = 0; t < nrows; ++t) {
        const int f = t + S;
        issue(i + f / nrows, f % nrows, g0 + f);
      }
    }
    if (kChain) cur ^= 1;
  }
  // no block leaves while another may still write into its state
  if (kChain) cluster_wait();
  cp_async_wait<0>();
}

struct ScanLayout {
  int rows_b;    // rows of M_i a block owns
  int rw;        // rows a warp owns
  int warps;     // warps a block runs
  int smem;      // dynamic shared memory bytes (the warps' rings)
};

// dynamic shared memory the rings may take: what a block may use less the
// state and the mbarriers (static) and a margin
template <typename T>
constexpr int ring_budget() {
  return kBlockSmem - static_cast<int>(2 * kMaxPanel * sizeof(T)) - 2048;
}

template <typename T>
ScanLayout scan_layout(int q, int r) {
  ScanLayout l;
  l.rows_b = (q + kCluster - 1) / kCluster;
  l.rw = (l.rows_b + kMaxScanWarps - 1) / kMaxScanWarps;
  for (;; ++l.rw) {
    l.warps = (l.rows_b + l.rw - 1) / l.rw;
    l.smem = l.warps * stages<T>() * slot_bytes<T>(r);
    if (l.smem <= ring_budget<T>() || l.warps == 1) break;
  }
  return l;
}

// A cluster of 16, beyond the portable 8, and the rings' dynamic shared
// memory must be allowed once per instantiation.
template <typename T, bool kChain>
cudaError_t allow_scan() {
  auto* fn = affine_scan_kernel<T, kChain>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              ring_budget<T>());
}

template <typename T, bool kChain>
int launch_scan(const void* m, int64_t msj, int64_t msi, T alpha,
                const void* c, int64_t csj, int64_t csi, void* y, int64_t ysj,
                int64_t ysi, int q, int r, int64_t nb, cudaStream_t st) {
  if (r < 1 || q < r || q > kMaxPanel) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb <= 0) return static_cast<int>(cudaGetLastError());
  static const cudaError_t allowed = allow_scan<T, kChain>();
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const ScanLayout l = scan_layout<T>(q, r);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(32 * l.warps, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(l.smem);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, affine_scan_kernel<T, kChain>, static_cast<const T*>(m), msj, msi,
      alpha, static_cast<const T*>(c), csj, csi, static_cast<T*>(y), ysj, ysi,
      q, r, nb, l.rows_b, l.rw);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// B4's first phase: c = inv b into c (nb * p entries: B4 passes x itself,
// padded past n, which its scan then overwrites in place).
template <typename T>
int launch_band_c(const void* inv, const void* b, void* c, int64_t n, int p,
                  int64_t nb, void* stream) {
  if (p < 1 || p > kMaxPanel || nb * p < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  band_c_kernel<T><<<dim3(static_cast<unsigned>(nb),
                          static_cast<unsigned>((p + kRows - 1) / kRows)),
                     kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(inv), static_cast<const T*>(b),
      static_cast<T*>(c), n, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int scan_layout_of(int q, int r, int* out) {
  if (r < 1 || q < r || q > kMaxPanel) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ScanLayout l = scan_layout<T>(q, r);
  out[0] = kCluster;
  out[1] = l.rows_b;
  out[2] = l.rw;
  out[3] = l.warps;
  out[4] = l.smem;
  return 0;
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

int cpkt_affine_scan_f32(const void* m, int64_t msj, int64_t msi,
                         double alpha, const void* c, int64_t csj,
                         int64_t csi, void* y, int64_t ysj, int64_t ysi, int q,
                         int r, int64_t nb, void* stream) {
  return launch_scan<float, true>(m, msj, msi, static_cast<float>(alpha), c,
                                  csj, csi, y, ysj, ysi, q, r, nb,
                                  static_cast<cudaStream_t>(stream));
}

int cpkt_affine_scan_f64(const void* m, int64_t msj, int64_t msi,
                         double alpha, const void* c, int64_t csj,
                         int64_t csi, void* y, int64_t ysj, int64_t ysi, int q,
                         int r, int64_t nb, void* stream) {
  return launch_scan<double, true>(m, msj, msi, alpha, c, csj, csi, y, ysj,
                                   ysi, q, r, nb,
                                   static_cast<cudaStream_t>(stream));
}

// The scan's reads without its chain (a measurement: see the header).
int cpkt_scan_read_floor_f32(const void* m, int64_t msj, int64_t msi,
                             double alpha, const void* c, int64_t csj,
                             int64_t csi, void* y, int64_t ysj, int64_t ysi,
                             int q, int r, int64_t nb, void* stream) {
  return launch_scan<float, false>(m, msj, msi, static_cast<float>(alpha), c,
                                   csj, csi, y, ysj, ysi, q, r, nb,
                                   static_cast<cudaStream_t>(stream));
}

int cpkt_scan_read_floor_f64(const void* m, int64_t msj, int64_t msi,
                             double alpha, const void* c, int64_t csj,
                             int64_t csi, void* y, int64_t ysj, int64_t ysi,
                             int q, int r, int64_t nb, void* stream) {
  return launch_scan<double, false>(m, msj, msi, alpha, c, csj, csi, y, ysj,
                                    ysi, q, r, nb,
                                    static_cast<cudaStream_t>(stream));
}

// The chained scan's layout for q rows of reach r: cluster blocks, rows per
// block, rows per warp, warps per block, ring bytes (out[0..4]).
int cpkt_scan_layout_f32(int q, int r, int* out) {
  return scan_layout_of<float>(q, r, out);
}

int cpkt_scan_layout_f64(int q, int r, int* out) {
  return scan_layout_of<double>(q, r, out);
}

}  // extern "C"
