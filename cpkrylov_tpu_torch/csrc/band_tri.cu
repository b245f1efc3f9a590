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
//      Here the work stays q r per step, a sequential carry, on one of two
//      layouts of the card (both sum every dot product in one order, so they
//      give the same bits):
//      a. grid (affine_scan_kernel_grid): a persistent grid of one block a
//         SM for every 8 rows of M, at most r (79 of the 132 SMs at
//         AUG2D-L), all
//         resident (a cooperative launch: a card that cannot hold them
//         gets an error, not a hang).  A block owns 8 or so rows of every
//         M_i, a warp each, and streams them through a ring of up to 16
//         steps ahead, so the maps stream at the card's bandwidth and not
//         one GPC's: without the chain the same reads take 0.70 ms at
//         AUG2D-L (2.2 TB/s) against the cluster's 1.59.  The state goes
//         from step to step through the L2: each state value is stored
//         beside its step's tag (a tag in every 64-bit word), and every
//         block reloads the whole state until each value carries the tag.
//         No fence and no flag: a flag with a release and an acquire costs
//         two L2 round trips more a step, and that design (flags a block,
//         the state read from y) took 2.53 ms at AUG2D-L, no faster than
//         the cluster.  Its bound: the hand-off, ~1.3 us a step with the
//         card idle and 2.5 us with the maps streaming through the same
//         L2, over a 1.5 us a step read floor.  Where each warp owns one
//         row (a block's rows fit its 16 warps) it was as fast as the
//         cluster or faster at every shape measured on the H100, from p 8,
//         r 2 (1.25 us a step on either) to 1024 (4.3 against 12.0 us);
//         where a warp owns several rows in turn it was slower (p 512,
//         r 7 over 16 blocks of 3 rows a warp: 2.91 against 2.53).
//      b. cluster (affine_scan_kernel): one cluster of 16 blocks, one
//         block per SM (a non-portable cluster size: a card that cannot
//         schedule it gets an error, not another kernel), the state handed
//         on through distributed shared memory under a split cluster
//         barrier.  Its bound: a step's maps at one GPC's bandwidth (the 16
//         blocks share one GPC's links to L2, which carry well under the
//         card's 3.35 TB/s), plus the barrier.  It takes the shapes the
//         grid cannot lay out one row a warp (precond/cuda_tri.py::
//         scan_path): panels of many more rows than the reach, which the
//         port's own panel rule never makes (p - r <= 7).
//      In the cluster, block `rank` owns ceil(q / cluster) consecutive rows
//      of every M_i, and each of its warps a run of consecutive rows.  A
//      warp streams its rows, step after step, through a ring of row
//      slots in shared memory (two in f64, four in
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
// Each layout also runs without its chain (kChain = false: no barrier, no
// state exchange): the same slices on the same blocks, the read floor that
// chip_smoke.py reports beside B6's time.
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

// The ragged ends' cp.async copies of the executing thread arrive on the
// mbarrier when they have landed (the pending count is raised now, so the
// phase cannot complete before them).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
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

// The persistent grid's scan state: one buffer per device and stream,
// zeroed once by the wrapper, never by a call.  Word 0 is the tag of the
// last step of the last call that finished, word 1 the blocks of the
// running call that have finished, then two buffers of the state s_i
// (steps of even and odd i), kMaxPanel tagged values each.
constexpr int kGridHeader = 2;
constexpr int kGridStateWords = 2 * kMaxPanel * 2;
constexpr int kGridMaxWarps = 16;     // warps a grid block may run
constexpr int kMaxSlots = 16;         // ring slots a grid warp may hold
constexpr int kMaxGridBlocks = 256;   // blocks of the grid (one a SM)
constexpr int kGridRows = 8;          // rows of M a grid block takes
constexpr int kPoll = 8;              // state values a thread reads at once

__device__ __forceinline__ void st_relaxed_v2(unsigned long long* p,
                                             unsigned long long x,
                                             unsigned long long y) {
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};\n" ::"l"(p),
               "l"(x), "l"(y)
               : "memory");
}

__device__ __forceinline__ void ld_relaxed_v2(const unsigned long long* p,
                                              unsigned long long& x,
                                              unsigned long long& y) {
  asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];\n"
               : "=l"(x), "=l"(y)
               : "l"(p)
               : "memory");
}

// A value of the state beside its step's 32-bit tag: each 32-bit piece of
// the value in one 64-bit word with the tag (one word in f32, two in f64),
// and a 64-bit word is read and written whole, so a reader that sees the
// tag in every word holds the value.  No fence orders the data before a
// flag: the tag is the flag.
template <typename T>
struct Tagged;

template <>
struct Tagged<float> {
  static constexpr int kWords = 1;
  unsigned long long w;
  __device__ __forceinline__ void load(const unsigned long long* p) {
    w = ld_relaxed(p);
  }
  __device__ __forceinline__ bool ready(unsigned tag) const {
    return static_cast<unsigned>(w >> 32) == tag;
  }
  __device__ __forceinline__ float value() const {
    return __uint_as_float(static_cast<unsigned>(w));
  }
  __device__ static __forceinline__ void store(unsigned long long* p,
                                               float v, unsigned tag) {
    st_relaxed(p, static_cast<unsigned long long>(tag) << 32 |
                      __float_as_uint(v));
  }
};

template <>
struct Tagged<double> {
  static constexpr int kWords = 2;
  unsigned long long w0, w1;
  __device__ __forceinline__ void load(const unsigned long long* p) {
    ld_relaxed_v2(p, w0, w1);
  }
  __device__ __forceinline__ bool ready(unsigned tag) const {
    return static_cast<unsigned>(w0 >> 32) == tag &&
           static_cast<unsigned>(w1 >> 32) == tag;
  }
  __device__ __forceinline__ double value() const {
    return __longlong_as_double(
        static_cast<long long>((w0 & 0xffffffffull) | (w1 << 32)));
  }
  __device__ static __forceinline__ void store(unsigned long long* p,
                                               double v, unsigned tag) {
    const unsigned long long t = static_cast<unsigned long long>(tag) << 32;
    const unsigned long long a =
        static_cast<unsigned long long>(__double_as_longlong(v));
    st_relaxed_v2(p, t | (a & 0xffffffffull), t | (a >> 32));
  }
};

// B6 on a persistent grid of `gridDim.x` blocks, all resident at once (a
// cooperative launch), for the same contract as affine_scan_kernel.  Block
// b of G owns the contiguous state rows [head + b r / G, head + (b + 1) r /
// G) of every M_i and the head rows [ceil(b head / G), ceil((b + 1) head /
// G)), so every block forms part of every state, and its warp w the rw
// rows from the block's w rw-th (head rows first).  Each warp streams its
// rows step after step through a ring of `slots` row slots (up to
// kMaxSlots steps ahead: the loads never wait on the state), a row's
// 16-byte-aligned interior by one bulk copy and its ragged ends by per-lane
// cp.async, all completing on the slot's mbarrier.
// Each row's dot product stays on one warp in the cluster kernel's order
// (lane k, k + 64, ... into one sum and lane k + 32, ... into the other,
// their sum, then the same shuffle tree), so y has the cluster kernel's
// bits.  The state goes from step to step through the L2: the lane that
// forms a state row of y_i stores it into y and, tagged with the step,
// into the state buffer of i's parity; before step i + 1 every thread of
// every block reloads its share of s_i until each value carries step i's
// tag, into the block's shared copy (double-buffered, so one block barrier
// a step).  Two buffers suffice: no block can form s_{i+1} before every
// block has formed its rows of s_i, which each does only after reading
// s_{i-1}.  The call's tags run from the last call's last tag + 1, so a
// value of an earlier call never carries one of this call's tags; the
// block that finishes last records the last tag, and clears the buffers
// and restarts the tags at 0 before they could wrap.  No memset, no host
// value between calls.  With kChain false the state stays zero and
// nothing is tagged or read back: the same reads, the grid's read floor.
// rw <= 32: lane t holds c of the warp's row t.
template <typename T, bool kChain>
__global__ void __launch_bounds__(kGridMaxWarps * 32)
affine_scan_kernel_grid(const T* __restrict__ m, int64_t msj, int64_t msi,
                        T alpha, const T* c, int64_t csj, int64_t csi, T* y,
                        int64_t ysj, int64_t ysi, int q, int r, int64_t nb,
                        int rw, int slots, unsigned long long* sync) {
  constexpr int W = Tagged<T>::kWords;
  extern __shared__ __align__(128) unsigned char ring_raw[];
  __shared__ T state[2][kMaxPanel];
  __shared__ uint64_t bars[kGridMaxWarps][kMaxSlots];
  __shared__ unsigned base_s;
  const int64_t nblk = gridDim.x;
  const int64_t blk = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int head = q - r;
  const int h0 = static_cast<int>((blk * head + nblk - 1) / nblk);
  const int nh =
      static_cast<int>(((blk + 1) * head + nblk - 1) / nblk) - h0;
  const int s0 = head + static_cast<int>(blk * r / nblk);
  const int s1 = head + static_cast<int>((blk + 1) * r / nblk);
  const int lw0 = warp * rw;         // the warp's first row of the block's
  const int nrows = max(0, min(nh + s1 - s0, lw0 + rw) - lw0);
  // the warp's row t as a row of M_i
  auto row_of = [&](int t) {
    const int l = lw0 + t;
    return l < nh ? h0 + l : s0 + (l - nh);
  };
  const int sbytes = slot_bytes<T>(r);
  unsigned char* ring =
      ring_raw + static_cast<int64_t>(warp) * slots * sbytes;
  const int64_t rbytes = static_cast<int64_t>(r) * sizeof(T);
  unsigned long long* tagged = sync + kGridHeader;

  if (lane == 0) {
    for (int sl = 0; sl < slots; ++sl) {
      mbar_init(smem_u32(&bars[warp][sl]), 1);
    }
    fence_mbarrier_init();
  }
  __syncwarp();

  // the warp's g-th row (row t of step i, g = i nrows + t) goes to slot
  // g % slots: the slot of a row read is refilled with the row `slots`
  // later, and the reads walk the slots in order (no division a row)
  auto row_src = [&](int64_t i, int t) {
    return m + i * msi + static_cast<int64_t>(row_of(t)) * msj;
  };
  auto slot_row = [&](int sl, const T* src) {
    return ring + sl * sbytes + (reinterpret_cast<uintptr_t>(src) & 15);
  };
  // the copies of row t of step i into slot sl: the ends' cp.async arrive
  // on the slot's mbarrier before lane 0 arrives with the bulk copy's
  // bytes, so one wait on the slot covers the whole row
  auto issue = [&](int64_t i, int t, int sl) {
    if (i >= nb) return;
    const T* src = row_src(i, t);
    unsigned char* dst = slot_row(sl, src);
    const uintptr_t a = reinterpret_cast<uintptr_t>(src);
    const uintptr_t lo = (a + 15) & ~uintptr_t(15);
    uintptr_t hi = (a + rbytes) & ~uintptr_t(15);
    if (hi < lo) hi = lo;
    const int nh = min(r, static_cast<int>((lo - a) / sizeof(T)));
    const int nt = r - nh - static_cast<int>((hi - lo) / sizeof(T));
    const uint32_t bar = smem_u32(&bars[warp][sl]);
    T* drow = reinterpret_cast<T*>(dst);
    if (lane < nh) cp_async(drow + lane, src + lane);
    if (lane < nt) cp_async(drow + (r - nt + lane), src + (r - nt + lane));
    if (lane < nh || lane < nt) cp_async_mbar_arrive(bar);
    __syncwarp();
    if (lane == 0) {
      if (hi > lo) {
        const uint32_t n = static_cast<uint32_t>(hi - lo);
        mbar_expect_tx(bar, n);
        bulk_copy(smem_u32(dst + (lo - a)),
                  reinterpret_cast<const void*>(lo), n, bar);
      } else {
        mbar_arrive(bar);
      }
    }
  };
  // lane t holds c of the warp's row t for this step (c0) and the next
  // (c1)
  auto load_c = [&](int64_t i) {
    return i < nb && lane < nrows
               ? c[static_cast<int64_t>(row_of(lane)) * csj + i * csi]
               : T(0);
  };

  for (int k = threadIdx.x; k < r; k += blockDim.x) {
    state[0][k] = T(0);
    state[1][k] = T(0);
  }
  if (nrows > 0) {
    for (int g = 0; g < slots; ++g) issue(g / nrows, g % nrows, g);
  }
  int sl = 0;              // the slot of the next row to read ...
  uint32_t phase = 0;      // ... and the parity of its fill
  T c0 = load_c(0), c1 = load_c(1);
  if (kChain && threadIdx.x == 0) {
    base_s = static_cast<unsigned>(ld_relaxed(sync));
  }
  __syncthreads();
  const unsigned base = kChain ? base_s : 0u;   // step i's tag: base + i + 1

  for (int64_t i = 0; i < nb; ++i) {
    const int cur = static_cast<int>(i & 1);
    if (kChain && i > 0) {
      // s_{i-1}: each thread reloads its values, kPoll in flight at once,
      // until every one carries step i-1's tag
      const unsigned want = base + static_cast<unsigned>(i);
      const unsigned long long* src =
          tagged + static_cast<int64_t>(cur ^ 1) * kMaxPanel * W;
      const int nthr = static_cast<int>(blockDim.x);
      for (int k0 = threadIdx.x; k0 < r; k0 += kPoll * nthr) {
        Tagged<T> w[kPoll];
        bool got[kPoll];
#pragma unroll
        for (int u = 0; u < kPoll; ++u) {
          got[u] = k0 + u * nthr >= r;
          if (!got[u]) w[u].load(src + (k0 + u * nthr) * W);
        }
        for (;;) {
          bool all = true;
#pragma unroll
          for (int u = 0; u < kPoll; ++u) {
            if (got[u]) continue;
            if (w[u].ready(want)) {
              state[cur][k0 + u * nthr] = w[u].value();
              got[u] = true;
            } else {
              all = false;
            }
          }
          if (all) break;
#pragma unroll
          for (int u = 0; u < kPoll; ++u) {
            if (!got[u]) w[u].load(src + (k0 + u * nthr) * W);
          }
        }
      }
      __syncthreads();                      // s_{i-1} in state[cur]
    }
    const T* st = state[cur];
    for (int t = 0; t < nrows; ++t) {
      mbar_wait(smem_u32(&bars[warp][sl]), phase);
      const T* ra = reinterpret_cast<const T*>(slot_row(sl, row_src(i, t)));
      T a0 = T(0), a1 = T(0);
      int k = lane;
      for (; k + 32 < r; k += 64) {
        const T s0 = st[k], s1 = st[k + 32];
        a0 += ra[k] * s0;
        a1 += ra[k + 32] * s1;
      }
      if (k < r) a0 += ra[k] * st[k];
      T v = a0 + a1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
      v = alpha * v + __shfl_sync(kFull, c0, t);
      const int j = row_of(t);
      if (lane == t) {
        if (kChain && j >= head) {
          Tagged<T>::store(
              tagged + (static_cast<int64_t>(cur) * kMaxPanel + j - head) * W,
              v, base + static_cast<unsigned>(i) + 1u);
        }
        y[static_cast<int64_t>(j) * ysj + i * ysi] = v;
      }
      __syncwarp();                         // every lane is done with the slot
      const int f = t + slots;
      issue(i + f / nrows, f % nrows, sl);
      if (++sl == slots) {
        sl = 0;
        phase ^= 1u;
      }
    }
    c0 = c1;
    c1 = load_c(i + 2);
  }
  if (kChain && threadIdx.x == 0) {
    // the last block to finish (every block has read its last state)
    // records the call's last tag; before the tags could wrap it clears
    // both buffers and restarts them at 0
    const unsigned long long last = nblk - 1;
    if (atomicAdd(sync + 1, 1ull) == last) {
      unsigned long long next = base + static_cast<unsigned long long>(nb);
      if (next >= (1ull << 31)) {
        for (int w = 0; w < kGridStateWords; ++w) tagged[w] = 0;
        next = 0;
      }
      sync[1] = 0;
      sync[0] = next;
    }
  }
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

struct GridLayout {
  int blocks;    // blocks of the grid, one a SM
  int rows_b;    // rows of M_i a block owns, at most
  int rw;        // rows a warp owns
  int warps;     // warps a block runs
  int slots;     // ring slots a warp holds
  int smem;      // dynamic shared memory bytes (the warps' rings)
};

// what a block may use less the double-buffered state, the mbarriers and
// a margin
template <typename T>
constexpr int grid_ring_budget() {
  return kBlockSmem - static_cast<int>(2 * kMaxPanel * sizeof(T)) -
         kGridMaxWarps * kMaxSlots * 8 - 2048;
}

// One block a SM for every kGridRows rows of M, up to the blocks the card
// keeps resident and at most r, so that every block forms part of every
// state (the two state buffers rely on it: a block that formed none could
// fall two steps behind and wait for a tag already overwritten); a block's
// rows (at most ceil(head / G) + ceil(r / G)) on the fewest warps of at
// most 32 rows for which the ring holds two steps.  At AUG2D-L's r 631
// that is 79 of the H100's 132 SMs: every block polls the whole state
// each step, and on the H100 a scan over 66-91 blocks of 7-10 rows took
// 2.50-2.52 us a step against 2.65 over all 132 (f64; f32 2.00-2.05
// against 2.39), while 44 blocks of 15 rows took 2.92.  Where a block
// would own more than kGridMaxWarps warps of 32 rows (rw > 32) the grid
// cannot take the shape.
template <typename T>
GridLayout grid_layout(int q, int r, int blocks) {
  GridLayout l;
  l.blocks = min(min(min(blocks, kMaxGridBlocks), r),
                 (q + kGridRows - 1) / kGridRows);
  l.rows_b = (q - r + l.blocks - 1) / l.blocks + (r + l.blocks - 1) / l.blocks;
  const int sb = slot_bytes<T>(r);
  for (l.rw = (l.rows_b + kGridMaxWarps - 1) / kGridMaxWarps;; ++l.rw) {
    l.warps = (l.rows_b + l.rw - 1) / l.rw;
    l.slots = min(kMaxSlots, grid_ring_budget<T>() / (l.warps * sb));
    if (l.slots >= 2 * l.rw || l.rw >= 32 || l.warps == 1) break;
  }
  l.smem = l.warps * l.slots * sb;
  return l;
}

template <typename T, bool kChain>
cudaError_t allow_grid() {
  return cudaFuncSetAttribute(affine_scan_kernel_grid<T, kChain>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              grid_ring_budget<T>());
}

// A cooperative launch: it fails, and never hangs, where the card cannot
// hold every block at once; a shape the grid cannot lay out over `blocks`
// (rw > 32) is refused.  `sync` holds kGridHeader + kGridStateWords words.
template <typename T, bool kChain>
int launch_scan_grid(const void* m, int64_t msj, int64_t msi, T alpha,
                     const void* c, int64_t csj, int64_t csi, void* y,
                     int64_t ysj, int64_t ysi, int q, int r, int64_t nb,
                     int blocks, void* sync, cudaStream_t st) {
  if (r < 1 || q < r || q > kMaxPanel || blocks < 1 || nb >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb <= 0) return static_cast<int>(cudaGetLastError());
  static const cudaError_t allowed = allow_grid<T, kChain>();
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const GridLayout l = grid_layout<T>(q, r, blocks);
  if (l.rw > 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(l.blocks), 1, 1);
  cfg.blockDim = dim3(32 * l.warps, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(l.smem);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, affine_scan_kernel_grid<T, kChain>, static_cast<const T*>(m), msj,
      msi, alpha, static_cast<const T*>(c), csj, csi, static_cast<T*>(y), ysj,
      ysi, q, r, nb, l.rw, l.slots, static_cast<unsigned long long*>(sync));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int grid_layout_of(int q, int r, int blocks, int* out) {
  if (r < 1 || q < r || q > kMaxPanel || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes fa;
  const cudaError_t e =
      cudaFuncGetAttributes(&fa, affine_scan_kernel_grid<T, true>);
  if (e != cudaSuccess) return static_cast<int>(e);
  const GridLayout l = grid_layout<T>(q, r, blocks);
  if (l.rw > 32) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = l.blocks;
  out[1] = l.rows_b;
  out[2] = l.rw;
  out[3] = l.warps;
  out[4] = l.slots;
  out[5] = l.smem;
  out[6] = static_cast<int>(fa.sharedSizeBytes);
  return 0;
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

// B6 on the persistent grid (blocks: the blocks the card keeps resident,
// one a SM; sync: the stream's scan state, kGridHeader + kGridStateWords
// words).
int cpkt_affine_scan_grid_f32(const void* m, int64_t msj, int64_t msi,
                              double alpha, const void* c, int64_t csj,
                              int64_t csi, void* y, int64_t ysj, int64_t ysi,
                              int q, int r, int64_t nb, int blocks,
                              void* sync, void* stream) {
  return launch_scan_grid<float, true>(
      m, msj, msi, static_cast<float>(alpha), c, csj, csi, y, ysj, ysi, q, r,
      nb, blocks, sync, static_cast<cudaStream_t>(stream));
}

int cpkt_affine_scan_grid_f64(const void* m, int64_t msj, int64_t msi,
                              double alpha, const void* c, int64_t csj,
                              int64_t csi, void* y, int64_t ysj, int64_t ysi,
                              int q, int r, int64_t nb, int blocks,
                              void* sync, void* stream) {
  return launch_scan_grid<double, true>(m, msj, msi, alpha, c, csj, csi, y,
                                        ysj, ysi, q, r, nb, blocks, sync,
                                        static_cast<cudaStream_t>(stream));
}

// The grid scan's reads without its chain (a measurement; sync unused).
int cpkt_scan_grid_read_floor_f32(const void* m, int64_t msj, int64_t msi,
                                  double alpha, const void* c, int64_t csj,
                                  int64_t csi, void* y, int64_t ysj,
                                  int64_t ysi, int q, int r, int64_t nb,
                                  int blocks, void* sync, void* stream) {
  return launch_scan_grid<float, false>(
      m, msj, msi, static_cast<float>(alpha), c, csj, csi, y, ysj, ysi, q, r,
      nb, blocks, sync, static_cast<cudaStream_t>(stream));
}

int cpkt_scan_grid_read_floor_f64(const void* m, int64_t msj, int64_t msi,
                                  double alpha, const void* c, int64_t csj,
                                  int64_t csi, void* y, int64_t ysj,
                                  int64_t ysi, int q, int r, int64_t nb,
                                  int blocks, void* sync, void* stream) {
  return launch_scan_grid<double, false>(m, msj, msi, alpha, c, csj, csi, y,
                                         ysj, ysi, q, r, nb, blocks, sync,
                                         static_cast<cudaStream_t>(stream));
}

// The grid scan's layout for q rows of reach r over `blocks` resident
// blocks: blocks, rows a block (at most), rows a warp, warps a block, ring
// slots a warp, ring bytes, static shared-memory bytes (out[0..6]).
int cpkt_scan_grid_layout_f32(int q, int r, int blocks, int* out) {
  return grid_layout_of<float>(q, r, blocks, out);
}

int cpkt_scan_grid_layout_f64(int q, int r, int blocks, int* out) {
  return grid_layout_of<double>(q, r, blocks, out);
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
