// DIA (diagonal storage) sparse matrix-vector product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cpkrylov_tpu/ops/pallas_dia.py::_dia_kernel
// (launched by pallas_dia_matvec).  Computes, for a square or rectangular
// (nrows x ncols) matrix stored as data[k, i] = M[i, i + offsets[k]],
//
//     y[i] = sum_k data[k, i] * x[i + offsets[k]]        (ascending k)
//
// where a term is dropped when i + offsets[k] falls outside [0, ncols).
//
// What bounds it on the H100: memory bandwidth.  Each term costs one load of
// data and one of x for two flops (1/8 flop per byte in f64), far below the
// card's balance point of about 20 flops per byte.  The design therefore only
// has to stream: one thread per output row in a grid-stride loop, so that
// neighbouring threads read neighbouring addresses of every diagonal and of
// every shifted window of x (coalesced).  The windows of neighbouring
// diagonals overlap, so most reads of x after the first are served by L1/L2.
// The TPU kernel staged far offsets (K_P's +-n blocks) through grouped VMEM
// operand windows; here a thread reads x[i + off] directly, masked at the
// ends.
//
// The sum is formed with explicitly rounded multiplies and adds (no FMA
// contraction) in ascending k, the order of the plain PyTorch version
// (ops/dia.py::dia_matvec), so the two agree bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 8192;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const T* __restrict__ data, const int64_t* __restrict__ offsets,
                int ndiag, int64_t nrows, int64_t ncols,
                const T* __restrict__ x, T* __restrict__ y) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nrows; i += stride) {
    T acc = T(0);
    for (int k = 0; k < ndiag; ++k) {
      const int64_t j = i + offsets[k];
      if (j >= 0 && j < ncols) {
        acc = add_rn(acc, mul_rn(__ldg(data + k * nrows + i), __ldg(x + j)));
      }
    }
    y[i] = acc;
  }
}

template <typename T>
int launch_dia_spmv(const void* data, const void* offsets, int ndiag,
                    int64_t nrows, int64_t ncols, const void* x, void* y,
                    void* stream) {
  if (nrows > 0) {
    int64_t blocks = (nrows + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    dia_spmv_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(data), static_cast<const int64_t*>(offsets),
        ndiag, nrows, ncols, static_cast<const T*>(x), static_cast<T*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cpkt_dia_spmv_f32(const void* data, const void* offsets, int ndiag,
                      int64_t nrows, int64_t ncols, const void* x, void* y,
                      void* stream) {
  return launch_dia_spmv<float>(data, offsets, ndiag, nrows, ncols, x, y,
                                stream);
}

int cpkt_dia_spmv_f64(const void* data, const void* offsets, int ndiag,
                      int64_t nrows, int64_t ncols, const void* x, void* y,
                      void* stream) {
  return launch_dia_spmv<double>(data, offsets, ndiag, nrows, ncols, x, y,
                                 stream);
}

const char* cpkt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
