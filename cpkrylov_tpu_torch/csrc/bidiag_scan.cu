// Bidiagonal triangular solve as a one-pass affine scan, for Hopper (sm_90a).
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
// associative, so the chain is a parallel scan.  Reverse mode maps scan
// position j to element n - 1 - j.
//
// What bounds it on the H100: memory bandwidth.  a, invd and b are read once
// and x is written once: 4n words, 40 MB for n = 1.25M in f64, 0.0119 ms at
// 3.35 TB/s; per element it does a few flops.  One launch a call: each block
// scans one tile of kTile = 2048 scan positions, kItems = 8 consecutive
// positions a thread, and a tile learns its start state from the aggregates
// of the tiles before it (a single-pass scan with a look-back).  How the
// design meets each hazard of such a scan:
//
// 1. Forward progress.  A block takes its tile from a ticket, an atomicAdd on
//    a counter in device memory, never from blockIdx.  A tile waits only on
//    tiles with smaller tickets, whose blocks took them earlier and so are
//    running, and a running tile publishes its aggregate without waiting on
//    anything.  This holds whatever order the blocks are dispatched in and
//    however many are resident (611 tiles at n = 1.25M); no grid-wide sync
//    or cooperative launch, so n is not capped by residency.
// 2. Loads.  The block stages its tile in shared memory: neighbouring lanes
//    read neighbouring addresses, 16 bytes a lane where the tile is whole
//    and aligned (one element a lane otherwise), and c = invd * b is formed
//    on load.  Reverse mode loads the forward-addressed chunk and reads it
//    backwards from shared memory.  Each thread then takes its run of
//    kItems from shared memory (one pad slot every 8 entries keeps the
//    strided reads free of bank conflicts), and x goes back through shared
//    memory to the same coalesced stores.  The maps stay on chip from the
//    aggregate to the apply.
// 3. Publishing.  Thread 0 writes the tile's aggregate map (A_t, C_t) into
//    the tile's 32-byte record of the state buffer, each 32-bit piece of it
//    beside the call's 32-bit tag in one 64-bit word (two 16-byte
//    st.relaxed.gpu stores in f64, one in f32).  A 64-bit word is read and
//    written whole (single-copy atomic), so a reader that sees the tag in
//    every word of a record holds that tile's aggregate: the tag is the
//    status word, and no fence orders the data before it.  (A separate
//    status word stored with st.release.gpu and waited on with
//    ld.acquire.gpu was slower in development: every acquire, and every
//    fence, is a round trip to L2 that the loads behind it wait for.)
// 4. A fixed combine order.  A tile's start state is built only from the
//    aggregates of tiles 0..t-1, never from an inclusive prefix that happens
//    to be ready: thread l of the block folds the contiguous chunk
//    [l ch, (l + 1) ch) of them, ch = ceil(t / 256), in order; a fixed
//    shuffle tree combines the lanes of each warp, and thread 0 folds the
//    eight warp results in order.  So the bits depend on n alone, never on
//    timing.  Thread 0 first waits on tile t - 1 alone (tiles publish in
//    about ticket order), then every thread loads its chunk's records, up
//    to four in flight, and reloads one until it carries the tag, with
//    __nanosleep back-off.  All 256 threads take part, so the look-back is
//    one round trip of at most ceil(t / 256) = 3 records a thread at
//    n = 1.25M (one warp would fold 20 a lane, and was slower in
//    development).  The L2 traffic is O(ntiles^2): one 32-byte record per
//    earlier tile, about 6 MB at 611 tiles.
// 5. State that resets itself.  One device buffer per (device, stream),
//    zeroed once when the wrapper creates it, holds the epoch, the ticket
//    counter, a finished-tiles counter and the number of records it holds,
//    then the records.  Each tile reads the epoch before it takes its
//    ticket; the call's tag is epoch + 1 (mod 2^32, never 0, so a zeroed
//    record is never ready).  The tile that finishes last (by the
//    finished-tiles counter, taken after its look-back, so no tile still
//    reads records) resets both counters and advances the epoch; when the
//    next tag would wrap to 0 it skips to 1 and clears every record, so a
//    record left from an earlier call never carries the current tag.
//    Nothing comes from the host between calls, so a call captured in a
//    CUDA graph replays correctly; no memset and no allocation besides x
//    on the path.
// 6. Rounding is explicit.  Every multiply and add is __dmul_rn / __dadd_rn
//    (__fmul_rn / __fadd_rn in f32), so nvcc cannot contract them into FMAs
//    and the plain version (cuda_bidiag.bidiag_scan_plain) repeats them in
//    this order bit for bit.
//
// The read floor (cpkt_bidiag_read_floor_*) is the same kernel without the
// ticket, the publish and the look-back: each tile starts from state 0.  It
// times the streaming alone.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = kTile + kTile / 8;
// State buffer, 64-bit words: epoch, ticket, finished, records held; then
// one 4-word record a tile (Record<T>).  The wrapper (cuda_bidiag.py) sizes
// it from the same two numbers and writes the records held.
constexpr int kHeaderWords = 4;
constexpr int kRecordWords = 4;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Aff {
  T a;
  T c;
};

__device__ __forceinline__ float mul_rn(float x, float y) {
  return __fmul_rn(x, y);
}
__device__ __forceinline__ double mul_rn(double x, double y) {
  return __dmul_rn(x, y);
}
__device__ __forceinline__ float add_rn(float x, float y) {
  return __fadd_rn(x, y);
}
__device__ __forceinline__ double add_rn(double x, double y) {
  return __dadd_rn(x, y);
}

// The map "earlier, then later".
template <typename T>
__device__ __forceinline__ Aff<T> compose(Aff<T> earlier, Aff<T> later) {
  return Aff<T>{mul_rn(later.a, earlier.a),
                add_rn(mul_rn(later.a, earlier.c), later.c)};
}

template <typename T>
__device__ __forceinline__ T apply(Aff<T> f, T s) {
  return add_rn(mul_rn(f.a, s), f.c);
}

template <typename T>
__device__ __forceinline__ Aff<T> shfl_up(Aff<T> v, int d) {
  return Aff<T>{__shfl_up_sync(kFull, v.a, d), __shfl_up_sync(kFull, v.c, d)};
}

template <typename T>
__device__ __forceinline__ Aff<T> shfl_down(Aff<T> v, int d) {
  return Aff<T>{__shfl_down_sync(kFull, v.a, d),
                __shfl_down_sync(kFull, v.c, d)};
}

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

// A tile's published aggregate: each 32-bit piece of (a, c) beside the
// call's 32-bit tag in one 64-bit word, so a single-copy-atomic 64-bit load
// sees a piece and its tag together.  The record is ready when every word
// carries the reader's tag.
template <typename T>
struct Record;

template <>
struct Record<float> {
  unsigned long long w[2];
  __device__ __forceinline__ void pack(Aff<float> v, unsigned tag) {
    const unsigned long long t = static_cast<unsigned long long>(tag) << 32;
    w[0] = t | __float_as_uint(v.a);
    w[1] = t | __float_as_uint(v.c);
  }
  __device__ __forceinline__ void store(unsigned long long* p) const {
    st_relaxed_v2(p, w[0], w[1]);
  }
  __device__ __forceinline__ void load(const unsigned long long* p) {
    ld_relaxed_v2(p, w[0], w[1]);
  }
  __device__ __forceinline__ bool ready(unsigned tag) const {
    return (w[0] >> 32) == tag && (w[1] >> 32) == tag;
  }
  __device__ __forceinline__ Aff<float> value() const {
    return Aff<float>{__uint_as_float(static_cast<unsigned>(w[0])),
                      __uint_as_float(static_cast<unsigned>(w[1]))};
  }
};

template <>
struct Record<double> {
  unsigned long long w[4];
  __device__ __forceinline__ void pack(Aff<double> v, unsigned tag) {
    const unsigned long long t = static_cast<unsigned long long>(tag) << 32;
    const unsigned long long a = __double_as_longlong(v.a);
    const unsigned long long c = __double_as_longlong(v.c);
    w[0] = t | (a & 0xffffffffull);
    w[1] = t | (a >> 32);
    w[2] = t | (c & 0xffffffffull);
    w[3] = t | (c >> 32);
  }
  __device__ __forceinline__ void store(unsigned long long* p) const {
    st_relaxed_v2(p, w[0], w[1]);
    st_relaxed_v2(p + 2, w[2], w[3]);
  }
  __device__ __forceinline__ void load(const unsigned long long* p) {
    ld_relaxed_v2(p, w[0], w[1]);
    ld_relaxed_v2(p + 2, w[2], w[3]);
  }
  __device__ __forceinline__ bool ready(unsigned tag) const {
    return (w[0] >> 32) == tag && (w[1] >> 32) == tag &&
           (w[2] >> 32) == tag && (w[3] >> 32) == tag;
  }
  __device__ __forceinline__ Aff<double> value() const {
    return Aff<double>{
        __longlong_as_double((w[0] & 0xffffffffull) | (w[1] << 32)),
        __longlong_as_double((w[2] & 0xffffffffull) | (w[3] << 32))};
  }
};

// Reload a record until it carries the tag, with __nanosleep back-off.
template <typename T>
__device__ __forceinline__ void wait_ready(Record<T>& r,
                                           const unsigned long long* p,
                                           unsigned tag) {
  unsigned ns = 32;
  while (!r.ready(tag)) {
    __nanosleep(ns);
    if (ns < 512) ns *= 2;
    r.load(p);
  }
}

// Shared slot of local offset o: one pad slot after every 8 entries.
__device__ __forceinline__ int pad(int o) { return o + (o >> 3); }

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

// The tile's window: local offset o is element base + o, valid for
// lo <= o < hi; whole = the window is all valid and every pointer at base is
// 16-byte aligned.
struct Window {
  int64_t base;
  int lo;
  int hi;
  bool whole;
};

template <typename T>
__device__ __forceinline__ Window tile_window(int64_t tile, int64_t n,
                                              int reverse, const T* a,
                                              const T* invd, const T* b,
                                              const T* x) {
  Window w;
  if (reverse) {
    w.base = n - (tile + 1) * kTile;
    w.lo = w.base < 0 ? static_cast<int>(-w.base) : 0;
    w.hi = kTile;
  } else {
    w.base = tile * kTile;
    w.lo = 0;
    w.hi = n - w.base < kTile ? static_cast<int>(n - w.base) : kTile;
  }
  w.whole = false;
  if (w.lo == 0 && w.hi == kTile) {
    const uintptr_t off = static_cast<uintptr_t>(w.base) * sizeof(T);
    const uintptr_t any = (reinterpret_cast<uintptr_t>(a) + off) |
                          (reinterpret_cast<uintptr_t>(invd) + off) |
                          (reinterpret_cast<uintptr_t>(b) + off) |
                          (reinterpret_cast<uintptr_t>(x) + off);
    w.whole = (any & 15u) == 0;
  }
  return w;
}

// a and c = invd * b of the window into shared memory; the identity map
// (1, 0) in the slots outside [lo, hi).
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ a,
                                          const T* __restrict__ invd,
                                          const T* __restrict__ b,
                                          const Window& w, T* sA, T* sC) {
  if (w.whole) {
    using V = typename Vec16<T>::type;
    constexpr int kV = 16 / sizeof(T);
    const V* va = reinterpret_cast<const V*>(a + w.base);
    const V* vd = reinterpret_cast<const V*>(invd + w.base);
    const V* vb = reinterpret_cast<const V*>(b + w.base);
#pragma unroll
    for (int i = 0; i < kTile / kV / kThreads; ++i) {
      const int u = i * kThreads + threadIdx.x;
      const V xa = va[u];
      const V xd = vd[u];
      const V xb = vb[u];
      const T* pa = reinterpret_cast<const T*>(&xa);
      const T* pd = reinterpret_cast<const T*>(&xd);
      const T* pb = reinterpret_cast<const T*>(&xb);
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        sA[pad(u * kV + e)] = pa[e];
        sC[pad(u * kV + e)] = mul_rn(pd[e], pb[e]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int o = i * kThreads + threadIdx.x;
      T va = T(1);
      T vc = T(0);
      if (o >= w.lo && o < w.hi) {
        const int64_t p = w.base + o;
        va = a[p];
        vc = mul_rn(invd[p], b[p]);
      }
      sA[pad(o)] = va;
      sC[pad(o)] = vc;
    }
  }
}

// x of the window from shared memory, by the same coalesced pattern.
template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ x, const Window& w,
                                           const T* sX) {
  if (w.whole) {
    using V = typename Vec16<T>::type;
    constexpr int kV = 16 / sizeof(T);
    V* vx = reinterpret_cast<V*>(x + w.base);
#pragma unroll
    for (int i = 0; i < kTile / kV / kThreads; ++i) {
      const int u = i * kThreads + threadIdx.x;
      V out;
      T* po = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int e = 0; e < kV; ++e) po[e] = sX[pad(u * kV + e)];
      vx[u] = out;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int o = i * kThreads + threadIdx.x;
      if (o >= w.lo && o < w.hi) x[w.base + o] = sX[pad(o)];
    }
  }
}

// The start state of tile t > 0 from the aggregates of tiles 0..t-1, in the
// fixed order of point 4 of the note.  Every thread of the block calls it;
// the result is valid in thread 0.
template <typename T>
__device__ __forceinline__ T look_back(const unsigned long long* records,
                                       int64_t t, unsigned tag,
                                       Aff<T>* s_part, int* s_part_ne) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // Tiles publish in about ticket order: wait on tile t - 1 alone first, so
  // that one thread polls instead of the whole block.
  if (threadIdx.x == 0) {
    Record<T> r;
    r.load(records + (t - 1) * kRecordWords);
    wait_ready(r, records + (t - 1) * kRecordWords, tag);
  }
  __syncthreads();
  const int64_t ch = (t + kThreads - 1) / kThreads;
  const int64_t q0 = static_cast<int64_t>(threadIdx.x) * ch;
  const int64_t q1 = q0 + ch < t ? q0 + ch : t;
  const int ne = q0 < t;
  Aff<T> f{T(1), T(0)};
  // Up to four records of the chunk in flight at once, folded in order.
  for (int64_t qs = q0; qs < q1; qs += 4) {
    Record<T> r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (qs + k < q1) r[k].load(records + (qs + k) * kRecordWords);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (qs + k < q1) {
        wait_ready(r[k], records + (qs + k) * kRecordWords, tag);
        f = qs + k == q0 ? r[k].value() : compose(f, r[k].value());
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Aff<T> o = shfl_down(f, off);
    const int one = __shfl_down_sync(kFull, ne, off);
    if (lane + off < 32 && one) f = compose(f, o);
  }
  if (lane == 0) {
    s_part[warp] = f;
    s_part_ne[warp] = ne;
  }
  __syncthreads();
  Aff<T> r = s_part[0];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      if (s_part_ne[w]) r = compose(r, s_part[w]);
    }
  }
  return r.c;
}

// The tag of a call whose state holds epoch e: never 0, so a zeroed record
// is never ready.
__device__ __forceinline__ unsigned tag_of(unsigned long long e) {
  return static_cast<unsigned>(e + 1);
}

template <typename T, bool kChain>
__global__ void __launch_bounds__(kThreads)
bidiag_scan_kernel(const T* __restrict__ a, const T* __restrict__ invd,
                   const T* __restrict__ b, T* __restrict__ x,
                   unsigned long long* __restrict__ state, int64_t n,
                   int reverse) {
  __shared__ T sA[kSlots];
  __shared__ T sC[kSlots];
  __shared__ Aff<T> s_warp[kWarps];
  __shared__ Aff<T> s_part[kWarps];
  __shared__ int s_part_ne[kWarps];
  __shared__ int64_t s_tile;
  __shared__ unsigned long long s_epoch;
  __shared__ T s_start;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if constexpr (kChain) {
    if (threadIdx.x == 0) {
      s_epoch = *reinterpret_cast<volatile unsigned long long*>(state);
      s_tile = static_cast<int64_t>(atomicAdd(state + 1, 1ull));
    }
    __syncthreads();
  }
  const int64_t tile = kChain ? s_tile : static_cast<int64_t>(blockIdx.x);
  const Window w = tile_window(tile, n, reverse, a, invd, b, x);
  load_tile(a, invd, b, w, sA, sC);
  __syncthreads();

  // Scan position j of the tile sits at local offset j (forward) or
  // kTile - 1 - j (reverse).
  const int j0 = threadIdx.x * kItems;
  auto slot = [&](int j) { return pad(reverse ? kTile - 1 - j : j); };
  Aff<T> v{sA[slot(j0)], sC[slot(j0)]};
#pragma unroll
  for (int k = 1; k < kItems; ++k) {
    v = compose(v, Aff<T>{sA[slot(j0 + k)], sC[slot(j0 + k)]});
  }
  // Inclusive scan over the warp's lanes (Hillis-Steele), then over the
  // warp totals.
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Aff<T> up = shfl_up(v, d);
    if (lane >= d) v = compose(up, v);
  }
  const Aff<T> lane_before = shfl_up(v, 1);
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    Aff<T> t = lane < kWarps ? s_warp[lane] : Aff<T>{T(1), T(0)};
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const Aff<T> up = shfl_up(t, d);
      if (lane >= d) t = compose(up, t);
    }
    if (lane < kWarps) s_warp[lane] = t;
  }
  __syncthreads();

  if constexpr (kChain) {
    const unsigned long long* records = state + kHeaderWords;
    const unsigned tag = tag_of(s_epoch);
    if (threadIdx.x == 0) {
      Record<T> r;
      r.pack(s_warp[kWarps - 1], tag);
      r.store(state + kHeaderWords + tile * kRecordWords);
    }
    if (tile > 0) {
      const T s = look_back<T>(records, tile, tag, s_part, s_part_ne);
      if (threadIdx.x == 0) s_start = s;
    } else if (threadIdx.x == 0) {
      s_start = T(0);
    }
    __syncthreads();
  }

  const T s_tile_start = kChain ? s_start : T(0);
  T s = warp == 0 ? s_tile_start : apply(s_warp[warp - 1], s_tile_start);
  if (lane > 0) s = apply(lane_before, s);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int sl = slot(j0 + k);
    s = apply(Aff<T>{sA[sl], sC[sl]}, s);
    sC[sl] = s;
  }
  __syncthreads();
  store_tile(x, w, sC);
  if constexpr (kChain) {
    if (threadIdx.x == 0) {
      // Counted after the look-back: when the last tile counts itself, no
      // tile reads records any more.  It resets the counters and advances
      // the epoch; on the rare call whose next tag would wrap to 0 it skips
      // to tag 1 and clears every record, so no stale record can match.
      const unsigned long long done = atomicAdd(state + 2, 1ull);
      if (done == static_cast<unsigned long long>(gridDim.x) - 1) {
        unsigned long long next = s_epoch + 1;
        if (tag_of(next) == 0) {
          ++next;
          for (unsigned long long i = kHeaderWords;
               i < kHeaderWords + kRecordWords * state[3]; ++i) {
            state[i] = 0;
          }
        }
        state[1] = 0;
        state[2] = 0;
        state[0] = next;
      }
    }
  }
}

template <typename T, bool kChain>
int launch_bidiag_scan(const void* a, const void* invd, const void* b,
                       void* x, void* state, int64_t n, int reverse,
                       void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t ntiles = (n + kTile - 1) / kTile;
  if (ntiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  bidiag_scan_kernel<T, kChain>
      <<<static_cast<unsigned>(ntiles), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(a), static_cast<const T*>(invd),
          static_cast<const T*>(b), static_cast<T*>(x),
          static_cast<unsigned long long*>(state), n, reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Scan positions per tile.
int cpkt_bidiag_tile() { return kTile; }

int cpkt_bidiag_scan_f32(const void* a, const void* invd, const void* b,
                         void* x, void* state, int64_t n, int reverse,
                         void* stream) {
  return launch_bidiag_scan<float, true>(a, invd, b, x, state, n, reverse,
                                         stream);
}

int cpkt_bidiag_scan_f64(const void* a, const void* invd, const void* b,
                         void* x, void* state, int64_t n, int reverse,
                         void* stream) {
  return launch_bidiag_scan<double, true>(a, invd, b, x, state, n, reverse,
                                          stream);
}

int cpkt_bidiag_read_floor_f32(const void* a, const void* invd,
                               const void* b, void* x, int64_t n, int reverse,
                               void* stream) {
  return launch_bidiag_scan<float, false>(a, invd, b, x, nullptr, n, reverse,
                                          stream);
}

int cpkt_bidiag_read_floor_f64(const void* a, const void* invd,
                               const void* b, void* x, int64_t n, int reverse,
                               void* stream) {
  return launch_bidiag_scan<double, false>(a, invd, b, x, nullptr, n,
                                           reverse, stream);
}

}  // extern "C"
