// df64 (double-f32) DIA sparse matrix-vector product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cpkrylov_tpu/ops/pallas_dia.py::_df_dia_kernel
// (launched by pallas_df_dia_matvec).  Matrix and vector are unevaluated
// (hi, lo) pairs of f32 values, hi + lo carrying ~2^-48 relative accuracy.
// For a square or rectangular (nrows x ncols) matrix stored as
// hi/lo[k, i] = M[i, i + offsets[k]], each output row i computes, in
// ascending k (a term is dropped when i + offsets[k] falls outside
// [0, ncols)):
//
//     vh, vl  = xh[i+off_k], xl[i+off_k]
//     p, e    = two_prod(dh[k,i], vh)                  (Dekker, splitter 4097)
//     e       = e + dh[k,i]*vl + dl[k,i]*vh
//     acc_h, e2 = two_sum(acc_h, p);  acc_l = acc_l + e + e2
//     (yh, yl) = quick_two_sum(acc_h, acc_l)
//
// exactly the chain of pallas_dia.py:175-193 and of the plain PyTorch version
// (ops/df64.py::df_dia_matvec).
//
// Rounding: nvcc contracts a*b +- c into a fused multiply-add by default,
// which breaks Dekker's split (c - (c - a) with c = a*4097) and the error
// terms.  Every operation of the chain is therefore written with an
// explicitly rounded intrinsic (__fmul_rn / __fadd_rn / __fsub_rn), which the
// compiler never contracts, so the kernel agrees with the plain version bit
// for bit.
//
// What bounds it on the H100: memory bandwidth.  Per term it reads 8 bytes of
// diagonal (hi, lo) and 8 bytes of x pairs for about 20 flops, well under the
// card's f32 balance point.  As in dia_spmv.cu, one thread per output row in
// a grid-stride loop streams every diagonal and every shifted window of x
// with neighbouring threads on neighbouring addresses; far offsets (B' and B
// of the saddle operator) are read directly with a bounds mask, so the TPU
// kernel's VMEM operand windows have no counterpart here.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 8192;
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
df_dia_spmv_kernel(const float* __restrict__ dh, const float* __restrict__ dl,
                   const int64_t* __restrict__ offsets, int ndiag,
                   int64_t nrows, int64_t ncols,
                   const float* __restrict__ xh, const float* __restrict__ xl,
                   float* __restrict__ yh, float* __restrict__ yl) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nrows; i += stride) {
    float acc_h = 0.0f;
    float acc_l = 0.0f;
    for (int k = 0; k < ndiag; ++k) {
      const int64_t j = i + offsets[k];
      if (j < 0 || j >= ncols) continue;
      const float a_h = __ldg(dh + k * nrows + i);
      const float a_l = __ldg(dl + k * nrows + i);
      const float vh = __ldg(xh + j);
      const float vl = __ldg(xl + j);
      float p, e;
      two_prod(a_h, vh, p, e);
      e = __fadd_rn(__fadd_rn(e, __fmul_rn(a_h, vl)), __fmul_rn(a_l, vh));
      // two_sum(acc_h, p)
      const float s = __fadd_rn(acc_h, p);
      const float bb = __fsub_rn(s, acc_h);
      const float e2 = __fadd_rn(__fsub_rn(acc_h, __fsub_rn(s, bb)),
                                 __fsub_rn(p, bb));
      acc_h = s;
      acc_l = __fadd_rn(__fadd_rn(acc_l, e), e2);
    }
    // quick_two_sum(acc_h, acc_l)
    const float s = __fadd_rn(acc_h, acc_l);
    yl[i] = __fsub_rn(acc_l, __fsub_rn(s, acc_h));
    yh[i] = s;
  }
}

}  // namespace

extern "C" {

int cpkt_df_dia_spmv_f32(const void* dh, const void* dl, const void* offsets,
                         int ndiag, int64_t nrows, int64_t ncols,
                         const void* xh, const void* xl, void* yh, void* yl,
                         void* stream) {
  if (nrows > 0) {
    int64_t blocks = (nrows + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    df_dia_spmv_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(dh), static_cast<const float*>(dl),
        static_cast<const int64_t*>(offsets), ndiag, nrows, ncols,
        static_cast<const float*>(xh), static_cast<const float*>(xl),
        static_cast<float*>(yh), static_cast<float*>(yl));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
