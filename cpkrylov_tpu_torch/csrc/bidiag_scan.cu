// Bidiagonal triangular solve as a parallel affine scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// cpkrylov_tpu/precond/pallas_bidiag.py::_bidiag_kernel (launched by
// bidiag_tri_solve).  Solves the first-order recurrence
//
//     forward (lower bidiagonal L):      x_i = a_i * x_{i-1} + invd_i * b_i
//     reverse (upper bidiagonal D*U):    x_i = a_i * x_{i+1} + invd_i * b_i
//
// with a_i = -l_i / d_i (or -u_i / d_i) and invd_i = 1 / d_i, on arrays of
// length n in natural order.  Each element is the affine map
// f_i(s) = a_i s + c_i with c_i = invd_i b_i, and the solution is the prefix
// composition applied to the zero start state.  Composing an earlier map
// (a1, c1) with a later one (a2, c2) gives (a2 a1, a2 c1 + c2), which is
// associative, so the chain is a parallel scan.
//
// What bounds it on the H100: memory bandwidth.  Per element the scan does a
// handful of flops on three loaded words and one stored word.  The design is
// a reduce-then-scan in three launches on one stream:
//   1. aggregate: each block folds kTile consecutive maps (kItems per thread,
//      sequentially in registers, then a warp-shuffle scan and a scan over
//      the warp totals in shared memory) and writes the tile's map to agg;
//   2. carry: one block scans the tile maps, chunk by chunk, and writes the
//      state at the end of every tile to carry;
//   3. apply: each block scans its tile again, starts from the carry of the
//      tile before it, and runs the exact recurrence sequentially over each
//      thread's kItems, writing x.
// Traffic is 6n words read, n written, plus three words per tile of scratch.
// The TPU kernel's 8 sub-chains, lane rolls, row-head trick and in-kernel
// stitch served a sequential grid with a VMEM carry; Hopper runs blocks in no
// order, so the carry between tiles goes through launch 2 instead.  Reverse
// mode maps scan position j to element n - 1 - j.  A one-pass scan with
// decoupled look-back would read the inputs once; that is later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Aff {
  T a;
  T c;
};

// The map "earlier, then later".
template <typename T>
__device__ __forceinline__ Aff<T> compose(Aff<T> earlier, Aff<T> later) {
  return Aff<T>{later.a * earlier.a, later.a * earlier.c + later.c};
}

// Inclusive scan of one map per thread across the block.  warp_tot holds
// kWarps entries of shared memory; the function ends with a barrier so the
// caller may scan again.
template <typename T>
__device__ Aff<T> block_inclusive_scan(Aff<T> v, Aff<T>* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T a = __shfl_up_sync(0xffffffffu, v.a, d);
    const T c = __shfl_up_sync(0xffffffffu, v.c, d);
    if (lane >= d) v = compose(Aff<T>{a, c}, v);
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    Aff<T> w = lane < kWarps ? warp_tot[lane] : Aff<T>{T(1), T(0)};
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const T a = __shfl_up_sync(0xffffffffu, w.a, d);
      const T c = __shfl_up_sync(0xffffffffu, w.c, d);
      if (lane >= d) w = compose(Aff<T>{a, c}, w);
    }
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = compose(warp_tot[warp - 1], v);
  __syncthreads();
  return v;
}

// Launches 1 (kApply = false: write the tile's map to agg) and 3
// (kApply = true: write x, starting from carry[tile - 1]).
template <typename T, bool kApply>
__global__ void __launch_bounds__(kThreads)
bidiag_tile_kernel(const T* __restrict__ a, const T* __restrict__ invd,
                   const T* __restrict__ b, T* __restrict__ x,
                   T* __restrict__ agg, const T* __restrict__ carry,
                   int64_t n, int reverse) {
  __shared__ Aff<T> warp_tot[kWarps];
  __shared__ Aff<T> thread_incl[kThreads];
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kTile +
                     static_cast<int64_t>(threadIdx.x) * kItems;
  T ra[kItems];
  T rc[kItems];
  Aff<T> v{T(1), T(0)};
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t j = j0 + k;
    if (j < n) {
      const int64_t p = reverse ? n - 1 - j : j;
      ra[k] = a[p];
      rc[k] = invd[p] * b[p];
    } else {
      ra[k] = T(1);
      rc[k] = T(0);
    }
    v = compose(v, Aff<T>{ra[k], rc[k]});
  }
  const Aff<T> incl = block_inclusive_scan(v, warp_tot);
  if constexpr (!kApply) {
    if (threadIdx.x == kThreads - 1) {
      agg[2 * static_cast<int64_t>(blockIdx.x)] = incl.a;
      agg[2 * static_cast<int64_t>(blockIdx.x) + 1] = incl.c;
    }
  } else {
    thread_incl[threadIdx.x] = incl;
    __syncthreads();
    const T s_tile = blockIdx.x == 0 ? T(0) : carry[blockIdx.x - 1];
    T s = s_tile;
    if (threadIdx.x > 0) {
      const Aff<T> p = thread_incl[threadIdx.x - 1];
      s = p.a * s_tile + p.c;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t j = j0 + k;
      if (j < n) {
        s = ra[k] * s + rc[k];
        x[reverse ? n - 1 - j : j] = s;
      }
    }
  }
}

// Launch 2: one block turns the tile maps into the state at each tile's end.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bidiag_carry_kernel(const T* __restrict__ agg, T* __restrict__ carry,
                    int64_t ntiles) {
  __shared__ Aff<T> warp_tot[kWarps];
  __shared__ Aff<T> thread_incl[kThreads];
  T s_run = T(0);  // state at the end of the previous chunk
  for (int64_t base = 0; base < ntiles; base += kTile) {
    const int64_t j0 = base + static_cast<int64_t>(threadIdx.x) * kItems;
    Aff<T> r[kItems];
    Aff<T> v{T(1), T(0)};
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t j = j0 + k;
      r[k] = j < ntiles ? Aff<T>{agg[2 * j], agg[2 * j + 1]}
                        : Aff<T>{T(1), T(0)};
      v = compose(v, r[k]);
    }
    const Aff<T> incl = block_inclusive_scan(v, warp_tot);
    thread_incl[threadIdx.x] = incl;
    __syncthreads();
    T s = s_run;
    if (threadIdx.x > 0) {
      const Aff<T> p = thread_incl[threadIdx.x - 1];
      s = p.a * s_run + p.c;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t j = j0 + k;
      if (j < ntiles) {
        s = r[k].a * s + r[k].c;
        carry[j] = s;
      }
    }
    const Aff<T> total = thread_incl[kThreads - 1];
    __syncthreads();
    s_run = total.a * s_run + total.c;
  }
}

template <typename T>
int launch_bidiag_scan(const void* a, const void* invd, const void* b,
                       void* x, void* agg, void* carry, int64_t n,
                       int reverse, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t ntiles = (n + kTile - 1) / kTile;
  const T* pa = static_cast<const T*>(a);
  const T* pd = static_cast<const T*>(invd);
  const T* pb = static_cast<const T*>(b);
  bidiag_tile_kernel<T, false><<<static_cast<unsigned>(ntiles), kThreads, 0,
                                 st>>>(pa, pd, pb, nullptr,
                                       static_cast<T*>(agg), nullptr, n,
                                       reverse);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bidiag_carry_kernel<T><<<1, kThreads, 0, st>>>(
      static_cast<const T*>(agg), static_cast<T*>(carry), ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bidiag_tile_kernel<T, true><<<static_cast<unsigned>(ntiles), kThreads, 0,
                                st>>>(pa, pd, pb, static_cast<T*>(x), nullptr,
                                      static_cast<const T*>(carry), n,
                                      reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Elements per tile: the wrapper sizes agg (2 per tile) and carry (1 per
// tile) from it.
int cpkt_bidiag_tile() { return kTile; }

int cpkt_bidiag_scan_f32(const void* a, const void* invd, const void* b,
                         void* x, void* agg, void* carry, int64_t n,
                         int reverse, void* stream) {
  return launch_bidiag_scan<float>(a, invd, b, x, agg, carry, n, reverse,
                                   stream);
}

int cpkt_bidiag_scan_f64(const void* a, const void* invd, const void* b,
                         void* x, void* agg, void* carry, int64_t n,
                         int reverse, void* stream) {
  return launch_bidiag_scan<double>(a, invd, b, x, agg, carry, n, reverse,
                                    stream);
}

}  // extern "C"
