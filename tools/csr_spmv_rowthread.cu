// The CSR SpMV as first ported (a thread a row), kept beside the package's
// kernel B5 (cpkrylov_tpu_torch/csrc/csr_spmv.cu) so that chip_smoke.py can
// time the two in turns in one run on the card, and an empty kernel whose
// device time is the launch floor that both stand on.  Neither is used by
// the package.
//
// Each thread walks its row's entries in stored order, one dependent chain
// of loads an entry (indices[e], then x[indices[e]]), with explicitly
// rounded multiplies and adds: the same bits as B5 and its plain version.
// Built by chip_smoke.py with the package's nvcc flags:
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//          -Xcompiler -fPIC -o build/csr_rowthread/libcsr_rowthread.so \
//          tools/csr_spmv_rowthread.cu
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 16384;

template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_rowthread_kernel(const int64_t* __restrict__ indptr,
                     const int32_t* __restrict__ indices,
                     const T* __restrict__ data, int64_t nrows,
                     const T* __restrict__ x, T* __restrict__ y) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nrows; i += stride) {
    const int64_t e1 = __ldg(indptr + i + 1);
    T acc = T(0);
    for (int64_t e = __ldg(indptr + i); e < e1; ++e) {
      acc = add_rn(acc, mul_rn(__ldg(data + e), __ldg(x + __ldg(indices + e))));
    }
    y[i] = acc;
  }
}

template <typename T>
int launch(const void* indptr, const void* indices, const void* data,
           int64_t nrows, const void* x, void* y, void* stream) {
  if (nrows > 0) {
    int64_t blocks = (nrows + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    csr_rowthread_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(indptr),
        static_cast<const int32_t*>(indices), static_cast<const T*>(data),
        nrows, static_cast<const T*>(x), static_cast<T*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

int csr_rowthread_f32(const void* indptr, const void* indices,
                      const void* data, int64_t nrows, const void* x, void* y,
                      void* stream) {
  return launch<float>(indptr, indices, data, nrows, x, y, stream);
}

int csr_rowthread_f64(const void* indptr, const void* indices,
                      const void* data, int64_t nrows, const void* x, void* y,
                      void* stream) {
  return launch<double>(indptr, indices, data, nrows, x, y, stream);
}

// an empty kernel on a grid of `blocks` blocks of `threads` threads
int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
