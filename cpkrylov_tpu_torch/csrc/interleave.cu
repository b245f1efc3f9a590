// The interleave riffle of the preconditioner's direct solve, both ways, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of cpkrylov_tpu/precond/pallas_interleave.py:
// _interleave_kernel (launched by interleave_head) and _uninterleave_kernel
// (launched by uninterleave_head).  For a vector of n + m entries and a group
// size c with c * m <= n, the riffle is the permutation
//
//     perm[g*(c+1) + j] = g*c + j      (j < c, g < m)
//     perm[g*(c+1) + c] = n + g
//     perm[m*(c+1) + t] = c*m + t      (the x-tail, t < n - c*m)
//
// and the two kernels compute
//
//     interleave:    w[i] = z[perm[i]]      (InterleavePermute.apply)
//     uninterleave:  z[perm[i]] = w[i]      (InterleavePermute.apply_inv)
//
// on the whole vector: the TPU kernels wrote the (c+1)*m-entry head and left
// the contiguous tail to XLA; here one launch also copies the tail.
//
// What bounds it on the H100: memory bandwidth.  It is a pure copy, one read
// and one write of each entry and no arithmetic on the values.  The TPU kernel
// staged blocks of G = 8192 groups through VMEM to avoid padded (m, c)
// relayouts in HBM; a GPU has no such padding, so there is no staging: one
// thread per OUTPUT entry in a grid-stride loop, so that the writes of a warp
// are contiguous, and each thread reads its one source entry (contiguous runs
// of c, or a stride of c + 1, in the source).  Entries are moved as 4- or
// 8-byte words, so the result equals the plain version bit for bit in any
// float type of those sizes.  Indices are 32-bit, so the vector must have
// fewer than 2^31 entries (the wrapper checks it; 2^31 f64 entries are
// 16 GiB, far above the banded systems this ordering is chosen for).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 8192;
constexpr int64_t kMaxEntries = int64_t{1} << 31;

using I = uint32_t;

template <typename W>
__global__ void __launch_bounds__(kThreads)
interleave_kernel(const W* __restrict__ z, W* __restrict__ w, I n, I m, I c) {
  const I total = n + m;
  const I head = m * (c + 1);
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  for (I i = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    I src;
    if (i < head) {
      const I g = i / (c + 1);
      const I j = i - g * (c + 1);
      src = (j < c) ? g * c + j : n + g;
    } else {
      src = i - m;                       // c*m + (i - m*(c+1))
    }
    w[i] = z[src];
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
uninterleave_kernel(const W* __restrict__ w, W* __restrict__ z, I n, I m,
                    I c) {
  const I total = n + m;
  const I cm = c * m;
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  for (I k = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x; k < total;
       k += stride) {
    I src;
    if (k < cm) {
      const I g = k / c;
      src = k + g;                       // g*(c+1) + (k - g*c)
    } else if (k < n) {
      src = k + m;                       // m*(c+1) + (k - c*m)
    } else {
      src = (k - n) * (c + 1) + c;
    }
    z[k] = w[src];
  }
}

template <typename W>
void launch(bool inverse, const void* src, void* dst, int64_t n, int64_t m,
            int64_t c, cudaStream_t stream) {
  const int64_t total = n + m;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (inverse) {
    uninterleave_kernel<W><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(
        static_cast<const W*>(src), static_cast<W*>(dst), static_cast<I>(n),
        static_cast<I>(m), static_cast<I>(c));
  } else {
    interleave_kernel<W><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(
        static_cast<const W*>(src), static_cast<W*>(dst), static_cast<I>(n),
        static_cast<I>(m), static_cast<I>(c));
  }
}

int riffle(bool inverse, const void* src, void* dst, int64_t n, int64_t m,
           int64_t c, int itemsize, void* stream) {
  if (m < 1 || c < 1 || c * m > n || n + m >= kMaxEntries) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (itemsize == 4) {
    launch<unsigned int>(inverse, src, dst, n, m, c, s);
  } else if (itemsize == 8) {
    launch<unsigned long long>(inverse, src, dst, n, m, c, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// z (n + m entries) -> w = z[perm]
int cpkt_interleave(const void* z, void* w, int64_t n, int64_t m, int64_t c,
                    int itemsize, void* stream) {
  return riffle(false, z, w, n, m, c, itemsize, stream);
}

// w (n + m entries) -> z with z[perm] = w
int cpkt_uninterleave(const void* w, void* z, int64_t n, int64_t m, int64_t c,
                      int itemsize, void* stream) {
  return riffle(true, w, z, n, m, c, itemsize, stream);
}

}  // extern "C"
