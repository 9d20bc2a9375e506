// Row softmax over the last axis of a row-major [rows, h] tensor.
//
// Replaces paddle1_tpu/ops/pallas/softmax.py::_softmax_kernel. Same
// numerics contract: in f32, m = max(x), e = exp(x - m), y = e / sum(e),
// stored in the input's dtype (f32, bf16 or f16). A -inf entry gives 0,
// an all -inf row NaN, a +inf entry a NaN row (exp(inf - inf)), as the
// plain version does. No atomics and a fixed reduction order: repeats are
// bit-identical.
//
// Bound on an H100: memory. x is read once and y written once,
// 2 * rows * h * itemsize bytes at 3.35 TB/s, against ~5 f32 operations
// and one exp an element; in bf16 the instructions an element come close
// enough to the bytes' time that the design spends as few as it can
// (one exp an element, one reciprocal a row). Every path below the
// on-chip limit reads x from HBM once. Three paths (ops/softmax.py plan):
//   * narrow, h <= NARROW_MAX (1024): a group of G lanes a row, G the
//     smallest power of two >= the row's whole 16-byte vectors (h / V,
//     V = 16 / itemsize), at most 32, so a warp holds 32 / G rows; a lane
//     holds C = ceil((h / V) / G) vectors of its row (C > 1 only at
//     G = 32: C = 1 .. 8 in f32, 1 .. 4 in bf16 / f16), all loaded
//     before any is reduced; max and sum are xor shuffles over the G
//     lanes only. 256-thread blocks walk tiles of 8 * (32 / G) rows,
//     grid-stride, at most NARROW_BLOCKS_PER_SM (64) blocks an SM.
//     When rows * G < FILL_LANES (32768), G doubles (up to 32); a row
//     of at most SCALAR_MAX (64) elements that still
//     falls short goes an element a lane over a warp (LeNet's [64, 10]:
//     a launch that short is all latency).
//   * wide, NARROW_MAX < h <= WIDE_MAX (32768): persistent blocks, at
//     most WIDE_BLOCKS_PER_SM (2) an SM, walk the rows. Each block keeps
//     a ring of nbuf row buffers in shared memory (2 where two rows fit
//     in its 227 KB, else 1: f32 rows above 28,928 elements), filled by
//     the TMA's 1-D bulk copy (cp.async.bulk, completion on an mbarrier,
//     16 KB a copy). A thread holds CH vectors of the row in registers
//     (CH * V <= 32, so 1024 threads hold 32768 elements: the on-chip
//     limit), read from shared memory once; as soon as every thread has
//     them (the max's barrier), thread 0 refills the buffer with the row
//     nbuf rows ahead, so the next rows' bytes are in flight while this
//     row is reduced, divided and stored.
//   * two-pass, h > WIDE_MAX: persistent 512-thread blocks, a row at a
//     time: an online (max, sum) pass over 16-byte vectors, the pairs
//     merged by shuffles, then a pass that reads x again (from L2 while
//     the rows in flight fit it) and writes exp(x - max) / sum.
// Every row is cut at 16-byte boundaries: a scalar head up to the first
// boundary, a body of whole 16-byte vectors (or bulk copies), a scalar
// tail; y is allocated at x's address modulo 16 (ops/softmax.py
// out_like), so its vectors fall on the same elements. An odd width or an
// unaligned view leaves every row's body in vectors.
// Reduction order, a lane's or thread's sum: its head element(s), its
// body vectors in order, its tail element(s); then xor shuffles (o =
// G/2 .. 1 or 16 .. 1), and on the block paths the warps' partials read
// by every warp (lane l takes warp l's) and shuffled again.
// ops/softmax.py (plan, softmax_emulation) models this on the CPU.
// Settings, from tools/torch_softmax_bench.py --sweep (graph replays,
// median of 3; NVIDIA H100 80GB HBM3, 700 W; PERF.md), ms at
// BERT-base's attention rows [196608, 128] bf16 | f32 (bound 0.03005 |
// 0.06010): one row a lane group, 0.0372 | 0.0705 at 64 blocks an SM,
// against R = 2 rows a lane loaded before either is reduced
// 0.0409-0.0430 | 0.0697-0.0727 and R = 4 0.0513-0.0537 | 0.0710-0.0777
// (more rows a lane hold more registers and fewer warps); 64 blocks an
// SM against 8 / 16 / 32 / 256: 0.0395 / 0.0381 / 0.0372 / 0.0380 |
// 0.0811 / 0.0762 / 0.0718 / 0.0695. LeNet's [64, 10]: 0.0019-0.0021
// with an element a lane, 0.0024 | 0.0021 with 16-byte pieces. NARROW_MAX
// 512 against 1024 at [1000, 1003]: 0.0068 against 0.0035 (bf16).
// Two-pass [2048, 32769] with 1 block an SM against 2: 0.214 | 0.323
// against 0.149 | 0.263. ptxas: 24-64 registers across the 50
// instantiations (the wide path's 1024-thread bound caps it at 64), no
// spills.
//
// Built by paddle1_tpu_torch/ops/cuda/build.py with nvcc for sm_90a into
// a shared library with a plain C interface, loaded through ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kNarrowThreads = 256;
constexpr int kTwoPassThreads = 512;
constexpr int kMaxBufs = 2;
constexpr uint32_t kBulkPiece = 16384;  // bytes of one bulk copy

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void put(float& d, float v) { d = v; }
__device__ __forceinline__ void put(__nv_bfloat16& d, float v) {
  d = __float2bfloat16(v);
}
__device__ __forceinline__ void put(__half& d, float v) {
  d = __float2half(v);
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw,
                                       float (&out)[16 / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i)
    out[i] = to_f32(e[i]);
}

// 16 bytes of x (global, streaming: read once) as f32
template <typename T>
__device__ __forceinline__ void load_global(const T* p,
                                            float (&out)[16 / sizeof(T)]) {
  unpack<T>(__ldcs(reinterpret_cast<const uint4*>(p)), out);
}

template <typename T>
__device__ __forceinline__ void store_global(T* p,
                                             const float (&v)[16 / sizeof(T)]) {
  alignas(16) T e[16 / sizeof(T)];
#pragma unroll
  for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i) put(e[i], v[i]);
  __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(e));
}

template <typename T>
__device__ __forceinline__ void store_scalar(T* p, float v) {
  T e;
  put(e, v);
  *p = e;
}

// The row's split at 16-byte boundaries: scalar head, body vectors, tail.
template <typename T>
__device__ __forceinline__ void split_row(const T* xr, int h, int& head,
                                          int& body, int& tail) {
  constexpr int V = 16 / sizeof(T);
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(xr) & 15u);
  head = min(h, ((16 - mis) & 15) / static_cast<int>(sizeof(T)));
  body = (h - head) / V;
  tail = h - head - body * V;
}

// A narrow row's pieces: 16-byte vectors (V = 16 / sizeof(T)) after a
// scalar head, or single elements (V = 1: no head or tail).
template <typename T, int V>
__device__ __forceinline__ void split_pieces(const T* xr, int h, int& head,
                                             int& body, int& tail) {
  if constexpr (V == 1) {
    head = tail = 0;
    body = h;
  } else {
    split_row(xr, h, head, body, tail);
  }
}

template <typename T, int V>
__device__ __forceinline__ void load_piece(const T* p, float (&out)[V]) {
  if constexpr (V == 1)
    out[0] = to_f32(*p);
  else
    load_global<T>(p, out);
}

template <typename T, int V>
__device__ __forceinline__ void store_piece(T* p, const float (&v)[V]) {
  if constexpr (V == 1)
    store_scalar(p, v[0]);
  else
    store_global<T>(p, v);
}

template <int W>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int W>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// e / s, correctly rounded, from r = 1 / s rounded once a row: q = e * r
// and one correction by the exact remainder e - s * q (Markstein's
// theorem; CUDA's own division takes the same step after refining an
// approximate reciprocal). Three operations an element against the
// IEEE division's nine. Here, where 1 <= s and 0 <= e <= 1, it is the
// plain version's e / s bit for bit, but for a subnormal quotient (below
// 2^-126), which may differ by one subnormal step, 2^-149
// (tests/test_torch_ops.py checks both in exact arithmetic).
__device__ __forceinline__ float quotient(float e, float s, float r) {
  const float q = __fmul_rn(e, r);
  return __fmaf_rn(__fmaf_rn(-s, q, e), r, q);
}

// ---------------------------------------------------------------------------
// narrow: a group of G lanes a row

template <typename T, int V, int G, int C>
__global__ void __launch_bounds__(kNarrowThreads)
softmax_narrow(const T* __restrict__ x, T* __restrict__ y, int rows, int h) {
  constexpr int HS = (V - 1 + G - 1) / G;     // head (tail) elements a lane
  constexpr int HA = HS > 0 ? HS : 1;         // (their arrays' length)
  constexpr int SLOT = kNarrowThreads / G;    // rows a block takes at once
  const int gl = threadIdx.x & (G - 1);
  const int in_slot = threadIdx.x / G;
  const long long tiles = (static_cast<long long>(rows) + SLOT - 1) / SLOT;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float v[C][V], hd[HA], tl[HA];
    const long long row = tile * SLOT + in_slot;
    int head = 0, body = 0, tail = 0;
    const T* xr = x + row * h;
    if (row < rows) split_pieces<T, V>(xr, h, head, body, tail);
    const int t0 = head + body * V;
#pragma unroll
    for (int s = 0; s < HS; ++s) {
      const int e = gl + s * G;
      hd[s] = e < head ? to_f32(xr[e]) : -INFINITY;
      tl[s] = e < tail ? to_f32(xr[t0 + e]) : -INFINITY;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = gl + c * G;
      if (j < body) {
        load_piece<T, V>(xr + head + j * V, v[c]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[c][i] = -INFINITY;
      }
    }
    float m = -INFINITY;
#pragma unroll
    for (int s = 0; s < HS; ++s) m = fmaxf(m, fmaxf(hd[s], tl[s]));
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int i = 0; i < V; ++i) m = fmaxf(m, v[c][i]);
    m = group_max<G>(m);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < HS; ++k)
      if (gl + k * G < head) {
        hd[k] = expf(hd[k] - m);
        s += hd[k];
      }
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (gl + c * G < body) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          v[c][i] = expf(v[c][i] - m);
          s += v[c][i];
        }
      }
#pragma unroll
    for (int k = 0; k < HS; ++k)
      if (gl + k * G < tail) {
        tl[k] = expf(tl[k] - m);
        s += tl[k];
      }
    s = group_sum<G>(s);
    T* yr = y + row * h;
    const float inv = __frcp_rn(s);
#pragma unroll
    for (int k = 0; k < HS; ++k) {
      const int e = gl + k * G;
      if (e < head) store_scalar(yr + e, quotient(hd[k], s, inv));
      if (e < tail) store_scalar(yr + t0 + e, quotient(tl[k], s, inv));
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = gl + c * G;
      if (j < body) {
#pragma unroll
        for (int i = 0; i < V; ++i) v[c][i] = quotient(v[c][i], s, inv);
        store_piece<T, V>(yr + head + j * V, v[c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// shared-memory barriers and the TMA's 1-D bulk copy

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Thread 0: copy the body of row `row` into `dst`, completing on `bar`.
template <typename T>
__device__ __forceinline__ void fetch_row(const T* x, long long row, int h,
                                          unsigned char* dst,
                                          uint64_t* bar) {
  const T* xr = x + row * h;
  int head, body, tail;
  split_row(xr, h, head, body, tail);
  const uint32_t bytes = static_cast<uint32_t>(body) * 16u;
  mbar_expect_tx(bar, bytes);
  const char* src = reinterpret_cast<const char*>(xr + head);
  for (uint32_t off = 0; off < bytes; off += kBulkPiece)
    bulk_copy(dst + off, src + off, min(kBulkPiece, bytes - off), bar);
}

// Block-wide max / sum: each warp's shuffle tree, the warps' partials in
// red[], then every warp reads them (lane l: warp l's) and shuffles again,
// so every thread ends with the same value in the same order.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = group_max<32>(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : -INFINITY;
  return group_max<32>(v);
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = group_sum<32>(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
  return group_sum<32>(v);
}

// ---------------------------------------------------------------------------
// wide: persistent blocks, a row at a time from a ring of shared buffers

template <typename T, int CH>
__global__ void __launch_bounds__(1024, 1)
softmax_wide(const T* __restrict__ x, T* __restrict__ y, int rows, int h,
             int nbuf, int buf_bytes) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kMaxBufs];
  __shared__ float red[2][32];
  const int t = threadIdx.x, nthr = blockDim.x;
  if (t == 0) {
    for (int b = 0; b < nbuf; ++b) mbar_init(&full[b], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int b = 0; b < nbuf; ++b) {
      const long long row = blockIdx.x + static_cast<long long>(b) * gridDim.x;
      if (row < rows) fetch_row(x, row, h, ring + b * buf_bytes, &full[b]);
    }
  }
  __syncthreads();
  int it = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x, ++it) {
    const int b = it % nbuf;
    const T* xr = x + row * h;
    T* yr = y + row * h;
    int head, body, tail;
    split_row(xr, h, head, body, tail);
    const int t0 = head + body * V;
    float hv = t < head ? to_f32(xr[t]) : -INFINITY;
    float tv = t < tail ? to_f32(xr[t0 + t]) : -INFINITY;
    mbar_wait(&full[b], static_cast<uint32_t>(it / nbuf) & 1u);
    const uint4* buf = reinterpret_cast<const uint4*>(ring + b * buf_bytes);
    float v[CH][V];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int j = t + c * nthr;
      if (j < body) {
        unpack<T>(buf[j], v[c]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[c][i] = -INFINITY;
      }
    }
    float m = fmaxf(hv, tv);
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int i = 0; i < V; ++i) m = fmaxf(m, v[c][i]);
    m = block_max(m, red[0]);
    // every thread has read buffer b: refill it nbuf rows ahead
    if (t == 0) {
      const long long next = row + static_cast<long long>(nbuf) * gridDim.x;
      if (next < rows) fetch_row(x, next, h, ring + b * buf_bytes, &full[b]);
    }
    float s = 0.f;
    if (t < head) {
      hv = expf(hv - m);
      s += hv;
    }
#pragma unroll
    for (int c = 0; c < CH; ++c)
      if (t + c * nthr < body) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          v[c][i] = expf(v[c][i] - m);
          s += v[c][i];
        }
      }
    if (t < tail) {
      tv = expf(tv - m);
      s += tv;
    }
    s = block_sum(s, red[1]);
    const float inv = __frcp_rn(s);
    if (t < head) store_scalar(yr + t, quotient(hv, s, inv));
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int j = t + c * nthr;
      if (j < body) {
#pragma unroll
        for (int i = 0; i < V; ++i) v[c][i] = quotient(v[c][i], s, inv);
        store_global<T>(yr + head + j * V, v[c]);
      }
    }
    if (t < tail) store_scalar(yr + t0 + t, quotient(tv, s, inv));
  }
}

// ---------------------------------------------------------------------------
// two-pass: rows wider than the on-chip limit

// Fold n values into a running (max m, sum s of exp(. - m)). A -inf value
// adds exp(-inf) = 0 and is skipped, so a leading -inf cannot make the sum
// exp(-inf - -inf) = NaN; a NaN value makes s NaN, a +inf one too
// (exp(inf - inf)).
template <int N>
__device__ __forceinline__ void online(float& m, float& s,
                                       const float (&v)[N]) {
  float vm = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i) vm = fmaxf(vm, v[i]);
  if (vm > m) {
    s *= expf(m - vm);
    m = vm;
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (v[i] != -INFINITY) s += expf(v[i] - m);
}

// Merge two (max, sum) pairs; a zero sum adds nothing.
__device__ __forceinline__ void combine(float& m, float& s, float m2,
                                        float s2) {
  const float mm = fmaxf(m, m2);
  const float a = (s == 0.f) ? 0.f : s * expf(m - mm);
  const float b = (s2 == 0.f) ? 0.f : s2 * expf(m2 - mm);
  m = mm;
  s = a + b;
}

__device__ __forceinline__ void warp_combine(float& m, float& s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    combine(m, s, __shfl_xor_sync(0xffffffffu, m, o),
            __shfl_xor_sync(0xffffffffu, s, o));
}

template <typename T>
__global__ void __launch_bounds__(kTwoPassThreads, 2)
softmax_two_pass(const T* __restrict__ x, T* __restrict__ y, int rows,
                 int h) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red_m[2][32], red_s[2][32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  int it = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x, ++it) {
    const T* xr = x + row * h;
    T* yr = y + row * h;
    int head, body, tail;
    split_row(xr, h, head, body, tail);
    const int t0 = head + body * V;
    float m = -INFINITY, s = 0.f;
    if (t < head) {
      const float one[1] = {to_f32(xr[t])};
      online<1>(m, s, one);
    }
    for (int j = t; j < body; j += blockDim.x) {
      float v[V];
      unpack<T>(*reinterpret_cast<const uint4*>(xr + head + j * V), v);
      online<V>(m, s, v);
    }
    if (t < tail) {
      const float one[1] = {to_f32(xr[t0 + t])};
      online<1>(m, s, one);
    }
    warp_combine(m, s);
    const int p = it & 1;
    if (lane == 0) {
      red_m[p][warp] = m;
      red_s[p][warp] = s;
    }
    __syncthreads();
    m = lane < nwarps ? red_m[p][lane] : -INFINITY;
    s = lane < nwarps ? red_s[p][lane] : 0.f;
    warp_combine(m, s);
    const float inv = __frcp_rn(s);
    if (t < head)
      store_scalar(yr + t, quotient(expf(to_f32(xr[t]) - m), s, inv));
    for (int j = t; j < body; j += blockDim.x) {
      float v[V];
      load_global<T>(xr + head + j * V, v);
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = quotient(expf(v[i] - m), s, inv);
      store_global<T>(yr + head + j * V, v);
    }
    if (t < tail)
      store_scalar(yr + t0 + t,
                   quotient(expf(to_f32(xr[t0 + t]) - m), s, inv));
  }
}

// ---------------------------------------------------------------------------
// launch

template <typename T>
using RowFn = void (*)(const T*, T*, int, int);

// Narrow kernels: pieces of 16 bytes at G = 1 .. 32 lanes, C > 1 (any C
// up to 32 values a lane) only at 32; single elements at 32 lanes, C <= 2
// (a launch too small to fill the card). tests/test_torch_ops.py holds
// ops/softmax.py's plan to this rule at every narrow width.
template <typename T, int V, int G, int C>
RowFn<T> narrow_fn() {
  if constexpr (V == 1 ? (G == 32 && C <= 2)
                       : ((G == 32 || C == 1) && C * V <= 32))
    return softmax_narrow<T, V, G, C>;
  else
    return nullptr;
}

template <typename T, int V, int G>
RowFn<T> narrow_by_c(int c) {
  switch (c) {
    case 1: return narrow_fn<T, V, G, 1>();
    case 2: return narrow_fn<T, V, G, 2>();
    case 3: return narrow_fn<T, V, G, 3>();
    case 4: return narrow_fn<T, V, G, 4>();
    case 5: return narrow_fn<T, V, G, 5>();
    case 6: return narrow_fn<T, V, G, 6>();
    case 7: return narrow_fn<T, V, G, 7>();
    case 8: return narrow_fn<T, V, G, 8>();
  }
  return nullptr;
}

template <typename T, int V>
RowFn<T> narrow_by_g(int g, int c) {
  switch (g) {
    case 1: return narrow_by_c<T, V, 1>(c);
    case 2: return narrow_by_c<T, V, 2>(c);
    case 4: return narrow_by_c<T, V, 4>(c);
    case 8: return narrow_by_c<T, V, 8>(c);
    case 16: return narrow_by_c<T, V, 16>(c);
    case 32: return narrow_by_c<T, V, 32>(c);
  }
  return nullptr;
}

template <typename T>
RowFn<T> narrow_kernel(int vec, int g, int c) {
  if (vec == 1) return narrow_by_g<T, 1>(g, c);
  if (vec == 16 / static_cast<int>(sizeof(T)))
    return narrow_by_g<T, 16 / sizeof(T)>(g, c);
  return nullptr;
}

template <typename T>
using WideFn = void (*)(const T*, T*, int, int, int, int);

template <typename T, int CH>
WideFn<T> wide_fn() {
  if constexpr (CH * (16 / sizeof(T)) <= 32)
    return softmax_wide<T, CH>;
  else
    return nullptr;
}

template <typename T>
WideFn<T> wide_kernel(int ch) {
  switch (ch) {
    case 1: return wide_fn<T, 1>();
    case 2: return wide_fn<T, 2>();
    case 4: return wide_fn<T, 4>();
    case 8: return wide_fn<T, 8>();
  }
  return nullptr;
}

// A CUDA error, cleared from the runtime's last error so that the next
// launch's check does not report it again.
int fail(cudaError_t rc) {
  cudaGetLastError();
  return static_cast<int>(rc);
}

struct Fit {
  const void* fn;
  int dev, threads, smem, blocks;
};
std::mutex g_fits_mu;
Fit g_fits[256];
int g_n_fits = 0;

// The current device's SMs, and how many blocks of `fn` (null: none asked)
// at `threads` and `smem` bytes of dynamic shared memory fit an SM (0:
// none). The runtime is asked once per kernel, device and size, after the
// kernel's opt-in to the device's largest dynamic shared memory, and the
// answer kept: a later call, inside a CUDA-graph capture too, asks it
// nothing new.
cudaError_t device_fit(const void* fn, int threads, int smem, int* sms,
                       int* blocks) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess || fn == nullptr) return rc;
  std::lock_guard<std::mutex> lock(g_fits_mu);
  for (int i = 0; i < g_n_fits; ++i) {
    const Fit& f = g_fits[i];
    if (f.fn == fn && f.dev == dev && f.threads == threads &&
        f.smem == smem) {
      *blocks = f.blocks;
      return cudaSuccess;
    }
  }
  int optin = 0;
  cudaFuncAttributes attr;
  rc = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                              dev);
  if (rc == cudaSuccess) rc = cudaFuncGetAttributes(&attr, fn);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        optin - static_cast<int>(attr.sharedSizeBytes));
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, threads,
                                                       smem);
  if (rc == cudaSuccess && g_n_fits < 256)
    g_fits[g_n_fits++] = Fit{fn, dev, threads, smem, *blocks};
  return rc;
}

// Blocks of a grid that walks `work` items: at most `cap` an SM, and for a
// persistent kernel (fn not null) as many as fit at once.
int grid_size(const void* fn, int threads, int smem, int cap,
              long long work, int* grid) {
  int sms = 0, fit = cap;
  const cudaError_t rc = device_fit(fn, threads, smem, &sms, &fit);
  if (rc != cudaSuccess) return fail(rc);
  if (fit <= 0) return fail(cudaErrorInvalidConfiguration);
  const long long most = static_cast<long long>(sms) * min(cap, fit);
  *grid = static_cast<int>(work < most ? work : most);
  return 0;
}

template <typename T>
int launch(const void* xv, void* yv, int rows, int h, int path, int vec,
           int group, int chunks, int threads, int nbuf, int buf_bytes,
           int blocks_per_sm, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  int grid = 0, err = 0;
  if (path == 0) {  // narrow
    RowFn<T> fn = narrow_kernel<T>(vec, group, chunks);
    if (fn == nullptr || threads != kNarrowThreads)
      return static_cast<int>(cudaErrorInvalidValue);
    const long long per_tile = kNarrowThreads / group;
    err = grid_size(nullptr, threads, 0, blocks_per_sm,
                    (rows + per_tile - 1) / per_tile, &grid);
    if (err != 0) return err;
    fn<<<grid, kNarrowThreads, 0, st>>>(x, y, rows, h);
  } else if (path == 1) {  // wide
    WideFn<T> fn = wide_kernel<T>(chunks);
    if (fn == nullptr || vec != V || nbuf < 1 || nbuf > kMaxBufs || threads < 32 ||
        threads > 1024 || threads % 32 != 0 ||
        static_cast<long long>(threads) * chunks < h / V ||
        buf_bytes % 128 != 0 ||
        static_cast<long long>(buf_bytes) <
            static_cast<long long>(h) * static_cast<int>(sizeof(T)))
      return static_cast<int>(cudaErrorInvalidValue);
    const int smem = nbuf * buf_bytes;
    err = grid_size(reinterpret_cast<const void*>(fn), threads, smem,
                    blocks_per_sm, rows, &grid);
    if (err != 0) return err;
    fn<<<grid, threads, smem, st>>>(x, y, rows, h, nbuf, buf_bytes);
  } else if (path == 2) {  // two-pass
    if (threads != kTwoPassThreads || vec != V)
      return static_cast<int>(cudaErrorInvalidValue);
    err = grid_size(reinterpret_cast<const void*>(softmax_two_pass<T>),
                    threads, 0, blocks_per_sm, rows, &grid);
    if (err != 0) return err;
    softmax_two_pass<T><<<grid, threads, 0, st>>>(x, y, rows, h);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. path: 0 narrow, 1 wide,
// 2 two-pass, with the plan of ops/softmax.py (elements a piece, group,
// chunks, threads, nbuf, buf_bytes) and the blocks an SM
// at most. Returns a cudaError_t (0 = success); a plan the kernel lacks is
// cudaErrorInvalidValue, a refused launch its own error.
int p1t_softmax_fwd(const void* x, void* y, int rows, int h, int dtype,
                    int path, int vec, int group, int chunks, int threads,
                    int nbuf, int buf_bytes, int blocks_per_sm,
                    void* stream) {
  if (rows <= 0 || h <= 0 || blocks_per_sm <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, y, rows, h, path, vec, group, chunks,
                         threads, nbuf, buf_bytes, blocks_per_sm, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, rows, h, path, vec, group, chunks,
                                 threads, nbuf, buf_bytes, blocks_per_sm, st);
  if (dtype == 2)
    return launch<__half>(x, y, rows, h, path, vec, group, chunks,
                          threads, nbuf, buf_bytes, blocks_per_sm, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* p1t_softmax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
