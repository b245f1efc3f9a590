// CSR sparse matrix-vector product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cpkrylov_tpu/ops/pallas_spmv.py::_kernel
// (launched by pgell_matvec): y = M x for a sparse matrix that fails the DIA
// gate (an RCM-ordered KKT K_P, the CVXQP Hessian, a grid incidence B).  The
// TPU kernel reads the paged-gather ELL format of ops/pgell.py, whose pages,
// lane lookup tables and int8 bucket maps exist because the TPU has no fast
// gather.  Hopper gathers x[col] directly, so the port keeps plain CSR:
// int64 row pointers, int32 column indices, values.
//
//     y[i] = sum_{e = indptr[i]}^{indptr[i+1]-1} data[e] * x[indices[e]]
//
// summed in stored order, one thread per row, with explicitly rounded
// multiplies and adds (no FMA contraction): the order of the plain PyTorch
// version (ops/cuda_spmv.py::csr_matvec_plain), so the two agree bit for bit and
// a result repeats from run to run (no atomics).  rmatvec is the same
// kernel on the transpose, packed once (ops/formats.py).
//
// What bounds it on the H100: memory bandwidth.  Each stored entry costs 12
// bytes (f64 value, int32 column) plus a gather of x for two flops.  The
// KKT rows here hold 3 to 10 entries, so a thread per row keeps neighbouring
// threads on neighbouring row segments (near-coalesced reads of data and
// indices) and needs no reduction across lanes; long rows would want a warp
// per row, which is later work.
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
csr_spmv_kernel(const int64_t* __restrict__ indptr,
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
int launch_csr_spmv(const void* indptr, const void* indices, const void* data,
                    int64_t nrows, const void* x, void* y, void* stream) {
  if (nrows > 0) {
    int64_t blocks = (nrows + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    csr_spmv_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(indptr),
        static_cast<const int32_t*>(indices), static_cast<const T*>(data),
        nrows, static_cast<const T*>(x), static_cast<T*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cpkt_csr_spmv_f32(const void* indptr, const void* indices,
                      const void* data, int64_t nrows, const void* x, void* y,
                      void* stream) {
  return launch_csr_spmv<float>(indptr, indices, data, nrows, x, y, stream);
}

int cpkt_csr_spmv_f64(const void* indptr, const void* indices,
                      const void* data, int64_t nrows, const void* x, void* y,
                      void* stream) {
  return launch_csr_spmv<double>(indptr, indices, data, nrows, x, y, stream);
}

}  // extern "C"
