// CSR sparse matrix-vector product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cpkrylov_tpu/ops/pallas_spmv.py::_kernel
// (launched by pgell_matvec): y = M x for a sparse matrix that fails the DIA
// gate (an RCM-ordered KKT K_P, the CVXQP Hessian, a grid incidence B).  The
// TPU kernel reads the paged-gather ELL format of ops/pgell.py, whose pages,
// lane lookup tables and int8 bucket maps exist because the TPU has no fast
// gather.  Hopper gathers x[col] directly, so the port keeps plain CSR:
// int64 row pointers, int32 column indices, values, and the row split of
// its tiles (below).
//
//     y[i] = sum_{e = indptr[i]}^{indptr[i+1]-1} data[e] * x[indices[e]]
//
// What bounds it on the H100.  At AUG2D-L's K_P (300k rows, 1.1M entries,
// 20 MB) memory bandwidth: 12 bytes an entry (f64 value, int32 column) plus
// a gather of x for two flops.  At the CVXQP operands the paths launch it
// on most (10k-17.5k rows of 0-9 entries, 0.3-1 MB, in the L2 inside a
// solve) the byte bound is a fraction of a microsecond, and what is left is
// latency: the chain of dependent loads from the launch to the last store.
// A thread a row walks its row as a chain an entry (indices[e], then
// x[indices[e]]); a row split needs indptr before it can load an entry.
//
// The walk: a split by entries.  Block t takes the tile of `tile` stored
// entries that starts at entry t * tile (a multiple of 256, at most
// kMaxTile; ops/formats.py chooses it when it packs the CSR) and the rows
// that start in it: tiles[t] .. tiles[t+1]-1, the row split that
// ops/formats.py computes once by a search of indptr.  So no load waits on
// indptr before the entries: each thread loads its entries of the tile and
// of kHalo entries past it (values and columns, coalesced) beside the
// tile's two row bounds; then it issues all its gathers of x beside the
// loads of its rows' pointers, and writes the products to shared memory at
// their places in the tile.  After one barrier, thread j sums rows
// tiles[t] + j, + 256, ...: two dependent loads and a barrier before the
// sums, and every SM has work at 10,000 rows (274 blocks at CVXQP3-L's A).
// A row that runs past the tile's end takes its next kHalo products from
// shared memory too, and any beyond from device memory (a long row's tail:
// right, not fast); it holds up its own block only.
//
// Why it keeps the plain version's bits.  Each row is summed by one thread,
// starting from 0, over its entries in stored order, every multiply and add
// rounded once (__dmul_rn / __dadd_rn, __fmul_rn / __fadd_rn: no FMA
// contraction): the order and the roundings of the plain PyTorch version
// (ops/cuda_spmv.py::csr_matvec_plain), whether a product comes from shared
// memory or from a tail.  An empty row writes 0.  No atomics, so a result
// repeats from run to run.  rmatvec is the same kernel on the transpose,
// packed once with its own row split (ops/formats.py).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

constexpr int kThreads = 256;            // threads a block; a tile is a multiple
constexpr int kMaxPerThread = 4;         // entries a thread loads, halo aside
constexpr int kMaxTile = kThreads * kMaxPerThread;
constexpr int kHalo = 32;                // entries past the tile, loaded with it
constexpr int kSlots = kMaxPerThread + 1;

template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_spmv_kernel(const int64_t* __restrict__ indptr,
                const int32_t* __restrict__ indices,
                const T* __restrict__ data,
                const int64_t* __restrict__ tiles, int tile, int64_t nnz,
                const T* __restrict__ x, T* __restrict__ y) {
  __shared__ T prod[kMaxTile + kHalo];
  const int tid = threadIdx.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int span = tile + kHalo;         // entries held in prod
  // the tile's entries and halo (place i = k * kThreads + tid), beside the
  // bounds of the rows that start in the tile
  int32_t col[kSlots];
  T val[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int i = k * kThreads + tid;
    col[k] = 0;
    val[k] = T(0);
    if (i < span && t0 + i < nnz) {
      col[k] = __ldg(indices + t0 + i);
      val[k] = __ldg(data + t0 + i);
    }
  }
  const int64_t r_begin = __ldg(tiles + blockIdx.x);
  const int64_t r_end = __ldg(tiles + blockIdx.x + 1);
  // the gathers of x, beside the pointers of this thread's first row
  T xv[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int i = k * kThreads + tid;
    xv[k] = (i < span && t0 + i < nnz) ? __ldg(x + col[k]) : T(0);
  }
  int64_t r = r_begin + tid;
  int64_t rs = 0, re = 0;
  if (r < r_end) {
    rs = __ldg(indptr + r);
    re = __ldg(indptr + r + 1);
  }
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int i = k * kThreads + tid;
    if (i < span && t0 + i < nnz) prod[i] = mul_rn(val[k], xv[k]);
  }
  __syncthreads();
  for (; r < r_end; r += kThreads) {
    if (r != r_begin + tid) {
      rs = __ldg(indptr + r);
      re = __ldg(indptr + r + 1);
    }
    // rs >= t0: the row starts in this tile
    const int64_t held = re < t0 + span ? re : t0 + span;
    T acc = T(0);
    int64_t e = rs;
    for (; e < held; ++e) acc = add_rn(acc, prod[e - t0]);
    for (; e < re; ++e) {
      acc = add_rn(acc, mul_rn(__ldg(data + e), __ldg(x + __ldg(indices + e))));
    }
    y[r] = acc;
  }
}

template <typename T>
int launch_csr_spmv(const void* indptr, const void* indices, const void* data,
                    const void* tiles, int64_t ntiles, int tile, int64_t nrows,
                    int64_t nnz, const void* x, void* y, void* stream) {
  // a tile is a multiple of the block, and the split has a tile for every
  // `tile` entries (one when there are none)
  if (tile < kThreads || tile > kMaxTile || tile % kThreads != 0 ||
      ntiles != (nnz > 0 ? (nnz + tile - 1) / tile : 1) ||
      ntiles > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nrows > 0) {
    csr_spmv_kernel<T><<<static_cast<unsigned>(ntiles), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(indptr),
        static_cast<const int32_t*>(indices), static_cast<const T*>(data),
        static_cast<const int64_t*>(tiles), tile, nnz,
        static_cast<const T*>(x), static_cast<T*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cpkt_csr_spmv_f32(const void* indptr, const void* indices,
                      const void* data, const void* tiles, int64_t ntiles,
                      int tile, int64_t nrows, int64_t nnz, const void* x,
                      void* y, void* stream) {
  return launch_csr_spmv<float>(indptr, indices, data, tiles, ntiles, tile,
                                nrows, nnz, x, y, stream);
}

int cpkt_csr_spmv_f64(const void* indptr, const void* indices,
                      const void* data, const void* tiles, int64_t ntiles,
                      int tile, int64_t nrows, int64_t nnz, const void* x,
                      void* y, void* stream) {
  return launch_csr_spmv<double>(indptr, indices, data, tiles, ntiles, tile,
                                 nrows, nnz, x, y, stream);
}

// The walk's layout, checked against ops/formats.py's: threads a block
// (a tile is a multiple), the largest tile, entries past a tile it holds.
void cpkt_csr_spmv_layout(int* out) {
  out[0] = kThreads;
  out[1] = kMaxTile;
  out[2] = kHalo;
}

}  // extern "C"
