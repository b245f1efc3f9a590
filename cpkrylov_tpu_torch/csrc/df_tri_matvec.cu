// df64 (double-f32) product of a triangular factor in transposed ELL form
// (B10) for Hopper (sm_90a): one launch per product.
//
// Replaces the XLA loop of the JAX package's
// cpkrylov_tpu/precond/df_factor.py::DFTriMat.matvec_df (one lax.scan over
// the ELL slots; it reaches no pallas_call).  The matrix is packed by
// precond/df_factor.py::_pack_df_tri as (K, n) arrays hi, lo (the f32 pair
// of each f64 entry) and cols (int32, 0 in an empty slot, whose hi and lo
// are 0).  Each row i walks its K slots in order with the compensated
// chain of the plain version (df_factor.py::df_tri_matvec_plain):
//
//     vh, vl     = xh[c], xl[c]
//     p, e       = two_prod(dh, vh)                 (Dekker, splitter 4097)
//     e          = (e + dh*vl) + dl*vh
//     acc_h, e2  = two_sum(acc_h, p);   acc_l = acc_l + (e + e2)
//     (yh, yl)   = quick_two_sum(acc_h, acc_l)
//
// Rounding: nvcc would contract a*b +- c into a fused multiply-add, which
// breaks Dekker's split and the error terms, so every operation is an
// explicitly rounded intrinsic (__fmul_rn / __fadd_rn / __fsub_rn), which
// the compiler never contracts: the kernel equals the plain version bit for
// bit.  Every slot is walked, the empty ones too, as the plain version does:
// stopping at a row's last entry could change the sign of a zero lo part or
// turn 0 * inf into a NaN.
//
// What bounds it on the H100: memory bandwidth at AUG2D-L's factor.  A slot
// reads 12 bytes (hi, lo, an int32 column) for about 25 flops, and the
// (632, 298935) t1 is 2.27 GB a product, 0.68 ms at 3.35 TB/s; x (2.4 MB)
// stays in L2.  One thread per row: slot k of neighbouring rows is
// contiguous in the (K, n) layout, so every load of the matrix coalesces,
// and the loads of the next slots do not depend on the chain, so they are
// in flight while it runs.  At CVXQP3-L's n = 17,500 there are only ~4
// warps an SM, and the chain's latency, not the bytes, sets the time.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kSplitter = 4097.0f;   // 2^12 + 1 for binary32

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

__global__ void __launch_bounds__(kThreads)
df_tri_matvec_kernel(const float* __restrict__ hi,
                     const float* __restrict__ lo,
                     const int* __restrict__ cols, int K, int64_t n,
                     const float* __restrict__ xh,
                     const float* __restrict__ xl, float* __restrict__ yh,
                     float* __restrict__ yl) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float acc_h = 0.0f;
  float acc_l = 0.0f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const int64_t o = k * n + i;
    const float dh = __ldg(hi + o);
    const float dl = __ldg(lo + o);
    const int c = __ldg(cols + o);
    const float vh = __ldg(xh + c);
    const float vl = __ldg(xl + c);
    float p, e;
    two_prod(dh, vh, p, e);
    e = __fadd_rn(__fadd_rn(e, __fmul_rn(dh, vl)), __fmul_rn(dl, vh));
    // two_sum(acc_h, p)
    const float s = __fadd_rn(acc_h, p);
    const float bb = __fsub_rn(s, acc_h);
    const float e2 = __fadd_rn(__fsub_rn(acc_h, __fsub_rn(s, bb)),
                               __fsub_rn(p, bb));
    acc_h = s;
    acc_l = __fadd_rn(acc_l, __fadd_rn(e, e2));
  }
  // quick_two_sum(acc_h, acc_l)
  const float s = __fadd_rn(acc_h, acc_l);
  yl[i] = __fsub_rn(acc_l, __fsub_rn(s, acc_h));
  yh[i] = s;
}

}  // namespace

extern "C" {

int cpkt_df_tri_matvec_f32(const void* hi, const void* lo, const void* cols,
                           int K, int64_t n, const void* xh, const void* xl,
                           void* yh, void* yl, void* stream) {
  if (K < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    df_tri_matvec_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(hi), static_cast<const float*>(lo),
        static_cast<const int*>(cols), K, n, static_cast<const float*>(xh),
        static_cast<const float*>(xl), static_cast<float*>(yh),
        static_cast<float*>(yl));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
