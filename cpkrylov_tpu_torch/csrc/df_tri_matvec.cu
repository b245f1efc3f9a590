// df64 (double-f32) product of a triangular factor in transposed ELL form
// (B10) for Hopper (sm_90a): one launch per product.
//
// Replaces the XLA loop of the JAX package's
// cpkrylov_tpu/precond/df_factor.py::DFTriMat.matvec_df (one lax.scan over
// the ELL slots; it reaches no pallas_call).  The matrix is packed by
// precond/df_factor.py::_pack_df_tri as (K, n) arrays hi, lo (the f32 pair
// of each f64 entry) and cols (int32), a row's count[i] entries in its
// first count[i] slots in column order, every later slot (0, 0, column 0).
// The plain version (cuda_df_tri.py::df_tri_matvec_plain) walks all K
// slots of every row with the compensated chain
//
//     vh, vl     = xh[c], xl[c]
//     p, e       = two_prod(dh, vh)                 (Dekker, splitter 4097)
//     e          = (e + dh*vl) + dl*vh
//     acc_h, e2  = two_sum(acc_h, p);   acc_l = acc_l + (e + e2)
//     (yh, yl)   = quick_two_sum(acc_h, acc_l)
//
// A padding slot is one fixed map f of (acc_h, acc_l) (dh = dl = 0, the
// pair x[0]), and f(f(s)) = f(s) bit for bit, signed zeros, infinities and
// NaNs included: after one padding step the state is a fixed point.  So the
// kernel walks a row's count[i] stored slots and then, when count[i] < K,
// one padding step, and equals the plain version bit for bit
// (cuda_df_tri.py::df_tri_matvec_walk is the plain version in this order).
// Rounding: nvcc would contract a*b +- c into a fused multiply-add, which
// breaks Dekker's split and the error terms, so every operation is an
// explicitly rounded intrinsic (__fmul_rn / __fadd_rn / __fsub_rn), which
// the compiler never contracts.
//
// What bounds it on the H100: at AUG2D-L's t1 (94.7M entries) memory
// bandwidth, 12 bytes an entry; at CVXQP3-L's t1 (17,500 rows, 765,542
// entries, rows of up to 718) the latency of the longest row's chain, one
// thread walking it slot after slot.  Design: one thread a row, a warp 32
// consecutive rows, so slot k of the warp's rows is one 128-byte line of
// the (K, n) layout and every load coalesces.  Each lane streams its row's
// slots through a lane-private ring of kStages x kChunk slots in shared
// memory by cp.async (4 bytes each; slots past the row's entries are
// zero-filled, which is exactly the padding slot), kStages - 1 chunks
// ahead of the chain, and gathers x for the next chunk into registers
// while the chain runs on this one: the chain waits on neither.  A warp
// walks max over its lanes of min(count + 1, K) slots, a lane updating its
// sums only on its own steps.  Warps take row groups round robin over the
// blocks (group = warp * gridDim.x + block), so the few warps of long rows
// land on different SMs.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;              // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 16;             // slots a stage
constexpr int kStages = 3;             // ring depth: loads 2 chunks ahead
constexpr unsigned kFull = 0xffffffffu;
constexpr float kSplitter = 4097.0f;   // 2^12 + 1 for binary32
// shared memory a warp: hi, lo and cols of kStages x kChunk slots per lane
constexpr int kWarpSlots = kStages * kChunk * 32;
constexpr int kSmemBytes = kWarps * kWarpSlots * 12;

__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  const float c = __fmul_rn(a, kSplitter);
  hi = __fsub_rn(c, __fsub_rn(c, a));
  lo = __fsub_rn(a, hi);
}

// p + e == a * b exactly.
__device__ __forceinline__ void two_prod(float a, float b, float& p,
                                         float& e) {
  p = __fmul_rn(a, b);
  float ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  e = __fadd_rn(__fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ah, bh), p),
                                    __fmul_rn(ah, bl)),
                          __fmul_rn(al, bh)),
                __fmul_rn(al, bl));
}

// 4 bytes global -> shared, or 4 zero bytes when !valid (nothing is read).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(kThreads)
df_tri_matvec_kernel(const float* __restrict__ hi,
                     const float* __restrict__ lo,
                     const int* __restrict__ cols,
                     const int* __restrict__ counts, int K, int64_t n,
                     const float* __restrict__ xh,
                     const float* __restrict__ xl, float* __restrict__ yh,
                     float* __restrict__ yl) {
  extern __shared__ float ring[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t group = static_cast<int64_t>(warp) * gridDim.x + blockIdx.x;
  if (group * 32 >= n) return;                       // the whole warp
  const int64_t i = group * 32 + lane;
  const bool live = i < n;
  const int c = live ? counts[i] : 0;
  const int steps = live ? min(c + 1, K) : 0;
  const int wsteps = __reduce_max_sync(kFull, steps);
  const int chunks = (wsteps + kChunk - 1) / kChunk;

  // lane-private ring: slot (stage, d) of this lane at ((stage * kChunk +
  // d) * 32 + lane), consecutive lanes in consecutive words
  float* s_hi = ring + warp * kWarpSlots * 3;
  float* s_lo = s_hi + kWarpSlots;
  int* s_col = reinterpret_cast<int*>(s_lo + kWarpSlots);

  auto issue = [&](int ch) {
    if (ch < chunks) {
      const int stage = ch % kStages;
#pragma unroll
      for (int d = 0; d < kChunk; ++d) {
        const int k = ch * kChunk + d;
        const bool ok = k < c;
        const int64_t o = ok ? static_cast<int64_t>(k) * n + i : 0;
        const int s = (stage * kChunk + d) * 32 + lane;
        cp_async4(s_hi + s, hi + o, ok);
        cp_async4(s_lo + s, lo + o, ok);
        cp_async4(s_col + s, cols + o, ok);
      }
    }
    cp_async_commit();               // an empty group past the last chunk
  };

  float vh[kChunk], vl[kChunk];
  auto gather = [&](int ch, float* gh, float* gl) {
    const int stage = ch % kStages;
#pragma unroll
    for (int d = 0; d < kChunk; ++d) {
      const int col = s_col[(stage * kChunk + d) * 32 + lane];
      gh[d] = __ldg(xh + col);
      gl[d] = __ldg(xl + col);
    }
  };

#pragma unroll
  for (int ch = 0; ch < kStages - 1; ++ch) issue(ch);
  cp_async_wait<kStages - 2>();
  if (chunks > 0) gather(0, vh, vl);

  float acc_h = 0.0f;
  float acc_l = 0.0f;
  for (int ch = 0; ch < chunks; ++ch) {
    issue(ch + kStages - 1);         // into the stage chunk ch - 1 left
    cp_async_wait<kStages - 2>();    // chunk ch + 1 has landed
    float nh[kChunk], nl[kChunk];
    if (ch + 1 < chunks) gather(ch + 1, nh, nl);
    const int stage = ch % kStages;
#pragma unroll
    for (int d = 0; d < kChunk; ++d) {
      const int k = ch * kChunk + d;
      const int s = (stage * kChunk + d) * 32 + lane;
      const float dh = s_hi[s];
      const float dl = s_lo[s];
      float p, e;
      two_prod(dh, vh[d], p, e);
      e = __fadd_rn(__fadd_rn(e, __fmul_rn(dh, vl[d])), __fmul_rn(dl, vh[d]));
      // two_sum(acc_h, p)
      const float sum = __fadd_rn(acc_h, p);
      const float bb = __fsub_rn(sum, acc_h);
      const float e2 = __fadd_rn(__fsub_rn(acc_h, __fsub_rn(sum, bb)),
                                 __fsub_rn(p, bb));
      if (k < steps) {
        acc_h = sum;
        acc_l = __fadd_rn(acc_l, __fadd_rn(e, e2));
      }
    }
    if (ch + 1 < chunks) {
#pragma unroll
      for (int d = 0; d < kChunk; ++d) {
        vh[d] = nh[d];
        vl[d] = nl[d];
      }
    }
  }
  cp_async_wait<0>();
  if (live) {
    // quick_two_sum(acc_h, acc_l)
    const float s = __fadd_rn(acc_h, acc_l);
    yl[i] = __fsub_rn(acc_l, __fsub_rn(s, acc_h));
    yh[i] = s;
  }
}

}  // namespace

extern "C" {

int cpkt_df_tri_matvec_f32(const void* hi, const void* lo, const void* cols,
                           const void* counts, int K, int64_t n,
                           const void* xh, const void* xl, void* yh,
                           void* yl, void* stream) {
  if (K < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        df_tri_matvec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t groups = (n + 31) / 32;
    const int64_t blocks = (groups + kWarps - 1) / kWarps;
    df_tri_matvec_kernel<<<static_cast<unsigned>(blocks), kThreads,
                           kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(hi), static_cast<const float*>(lo),
        static_cast<const int*>(cols), static_cast<const int*>(counts), K, n,
        static_cast<const float*>(xh), static_cast<const float*>(xl),
        static_cast<float*>(yh), static_cast<float*>(yl));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
