// Shared pieces of the fused batch-norm kernels (fused_bn.cu and
// fused_bn_bwd.cu): 8-channel vector loads and stores, the block layout
// and the deterministic two-stage reduction over rows.
//
// Layout: x is channels-last [rows, C], C % 8 == 0. A thread owns one
// vector of 8 channels (16 B of bf16 or f16, 32 B of f32) and walks rows with a
// stride; a block is TX vectors wide (blockDim.x) and TY rows tall
// (blockDim.y), TX * TY <= 256. A reduction over rows runs in two stages
// with no float atomics, so repeats are bit-identical:
//   1. blockIdx.y is a chunk of consecutive rows; each block sums its
//      chunk per channel (thread loops, then a fixed-order column sum in
//      shared memory) and writes one f32 partial row [chunk, C];
//   2. in the same launch, the partial rows are summed per channel in a
//      fixed lane order and shuffle tree by the last blocks to arrive
//      (int32 tickets; finish_tile below).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace p1t_bn {

constexpr int kThreads = 256;      // TX * TY <= kThreads
constexpr int kVec = 8;            // channels per thread
constexpr int kTileMax = 32 * kVec;  // channels of the widest tile (TX = 32)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// The storage types of the family's C interface, by dtype code: 0 =
// float32, 1 = bfloat16, 2 = float16. with_dtype(code, f) calls f with a
// Type<T> of the code's type, or returns cudaErrorInvalidValue.
template <typename T>
struct Type {
  using type = T;
};

template <typename F>
int with_dtype(int code, F&& f) {
  if (code == 0) return f(Type<float>{});
  if (code == 1) return f(Type<__nv_bfloat16>{});
  if (code == 2) return f(Type<__half>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const __half* p, float (&v)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// f16 rounds once, here: every sum and product before it is f32
__device__ __forceinline__ void store8(__half* p, const float (&v)[kVec]) {
  uint4 u;
  __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Eight channels as they lie in memory (16 B of bf16 or f16, 32 B of f32), for
// loads issued ahead of their use: a thread keeps several rows in flight
// as raw vectors and widens each to f32 only when it computes it.
template <typename T>
struct Raw8 {
  static constexpr int kWords = kVec * sizeof(T) / 16;   // 16-byte words
  uint4 w[kWords];
};

template <typename T>
__device__ __forceinline__ void load_raw(const T* p, Raw8<T>& r) {
#pragma unroll
  for (int k = 0; k < Raw8<T>::kWords; ++k)
    r.w[k] = reinterpret_cast<const uint4*>(p)[k];
}

template <typename T>
__device__ __forceinline__ void store_raw(T* p, const Raw8<T>& r) {
#pragma unroll
  for (int k = 0; k < Raw8<T>::kWords; ++k)
    reinterpret_cast<uint4*>(p)[k] = r.w[k];
}

// one 8-channel vector, global -> shared, as 16-byte cp.async copies
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
#pragma unroll
  for (int k = 0; k < Raw8<T>::kWords; ++k)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     s + 16 * k),
                 "l"(reinterpret_cast<const char*>(src) + 16 * k));
}

__device__ __forceinline__ void widen(const Raw8<float>& r, float (&v)[kVec]) {
  const float* f = reinterpret_cast<const float*>(r.w);
#pragma unroll
  for (int i = 0; i < kVec; ++i) v[i] = f[i];
}

__device__ __forceinline__ void widen(const Raw8<__nv_bfloat16>& r,
                                      float (&v)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(r.w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void widen(const Raw8<__half>& r,
                                      float (&v)[kVec]) {
  const __half2* h = reinterpret_cast<const __half2*>(r.w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Stage 1 tail: every thread holds its own sums a[8] for channels
// [v * 8, v * 8 + 8); the block writes their column sums over threadIdx.y
// (in order 0..TY-1) to partial row `row` (default: blockIdx.y),
// pa[row * C + channel]. buf: kThreads * 8 floats of shared memory, free
// again when this returns.
__device__ __forceinline__ void column_sums(float* buf,
                                            const float (&a)[kVec],
                                            float* __restrict__ pa, int c,
                                            long long row = -1) {
  if (row < 0) row = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int w = blockDim.x * kVec;          // channels of this block's tile
#pragma unroll
  for (int i = 0; i < kVec; ++i) buf[ty * w + tx * kVec + i] = a[i];
  __syncthreads();
  const int c0 = blockIdx.x * w;
  const int nt = blockDim.x * blockDim.y;
  for (int col = ty * blockDim.x + tx; col < w; col += nt) {
    if (c0 + col >= c) continue;
    float s = 0.f;
    for (int k = 0; k < static_cast<int>(blockDim.y); ++k) s += buf[k * w + col];
    pa[row * c + c0 + col] = s;
  }
  __syncthreads();
}

// Rows a thread keeps in flight where it streams from global memory: 64
// bytes of each tensor (four bf16 or f16 vectors, or two f32 vectors), loaded before any
// is used.
template <typename T>
struct RowsInFlight {
  static constexpr int value = sizeof(T) == 2 ? 4 : 2;
};

// Stage 2 runs in the same launch, in one fixed order per channel (that
// of one warp per channel): lane l adds the partial rows l, l + 32,
// l + 64, ... in turn from 0 (its "lane sum" S_l), then an xor tree 16,
// 8, 4, 2, 1 over the 32 lane sums. The training forward's handoff
// (fused_bn.cu) repeats that order bit for bit. The lane sums are spread
// over the SMs: the partial rows of one class l (rows k = l mod 32) are
// summed by the last CTA of that class to arrive, which writes S_l over
// partial row l; the last of the classes to arrive then runs the xor
// tree. So no CTA reads more than its class's rows and 32 rows of lane
// sums. Arrivals are counted on int32 tickets (no float
// atomics: repeats are bit-identical), kCountersPerTile a channel tile:
// one per class, then one for the tile.
constexpr int kLanes = 32;
constexpr int kCountersPerTile = kLanes + 1;

// fence.acq_rel at GPU scope (CUTLASS's inter-CTA barrier uses it): the
// release of the stores the CTA barrier ordered before it, and the acquire
// of those the other CTAs released.
__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// The ticket: the block's threads meet, then one thread fences and counts
// the block in on *counter. True, in every thread, in the last of
// `expected` blocks to arrive, which sets the counter back to 0 for the
// next launch or graph replay and fences again before its threads read
// what the others wrote. Call it from all threads.
__device__ __forceinline__ bool arrive_last(int* counter, int expected) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    fence_acq_rel_gpu();
    last = atomicAdd(counter, 1) == expected - 1;
    if (last) {
      *counter = 0;
      fence_acq_rel_gpu();
    }
  }
  __syncthreads();
  return last;
}

// The lane sum of class `cls` for the tile's channels, written over
// partial row cls: one thread per 4 channels of one of the two tensors,
// kFoldInFlight rows' 16-byte loads (through L2) in flight.
__device__ __forceinline__ void class_fold(float* pa, float* pb, int cls,
                                           int chunks, int c) {
  constexpr int kFoldInFlight = 8;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int quads = blockDim.x * 2;                 // 4-channel groups
  const int c0 = blockIdx.x * blockDim.x * kVec;
  const int q = tid % quads;
  if (tid >= 2 * quads || c0 + 4 * q >= c) return;
  float* p = (tid < quads ? pa : pb) + c0 + 4 * q;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = cls; k0 < chunks; k0 += kFoldInFlight * kLanes) {
    float4 r[kFoldInFlight];
#pragma unroll
    for (int u = 0; u < kFoldInFlight; ++u) {
      const long long k = k0 + kLanes * u;
      if (k < chunks) r[u] = __ldcg(reinterpret_cast<const float4*>(p + k * c));
    }
#pragma unroll
    for (int u = 0; u < kFoldInFlight; ++u) {
      if (k0 + kLanes * u < chunks) {
        acc.x += r[u].x;
        acc.y += r[u].y;
        acc.z += r[u].z;
        acc.w += r[u].w;
      }
    }
  }
  *reinterpret_cast<float4*>(p + static_cast<long long>(cls) * c) = acc;
}

// The xor tree over the lane sums S_0..S_(lanes - 1) held in partial rows
// 0..lanes - 1 (S_l = 0 for l >= lanes), for one 4-channel column of one
// tensor per group of 8 threads: the tree adds S_l + S_(l+16), then pairs
// 8 apart, 4, 2, 1 (a + b == b + a in IEEE arithmetic, so only the pairing
// matters). Thread j of the group loads S_j, S_(j+8), S_(j+16), S_(j+24)
// and forms the first two levels, (S_j + S_(j+16)) + (S_(j+8) + S_(j+24));
// xor shuffles 4, 2, 1 inside the group finish it, and thread 0 of the
// group writes it. Two columns' loads in flight a thread.
__device__ __forceinline__ void lane_tree(const float* pa, const float* pb,
                                          int lanes, int c,
                                          float* __restrict__ out1,
                                          float* __restrict__ out2) {
  constexpr int kGroup = 8, kCols = 2;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y / 32 * 32;   // whole warps only
  if (tid >= nt) return;
  const int j = tid % kGroup, groups = nt / kGroup;
  const int quads = blockDim.x * 2;                   // per tensor
  const int c0 = blockIdx.x * blockDim.x * kVec;
  const int cols = 2 * quads;
  // every thread runs the same rounds: the shuffles need whole warps
  for (int base = 0; base < cols; base += kCols * groups) {
    float4 v[kCols][4];
#pragma unroll
    for (int h = 0; h < kCols; ++h) {
      const int col = base + h * groups + tid / kGroup, q = col % quads;
      const bool live = col < cols && c0 + 4 * q < c;
      const float* p = (col < quads ? pa : pb) + c0 + 4 * q;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int l = j + kGroup * e;
        v[h][e] = live && l < lanes
                      ? __ldcg(reinterpret_cast<const float4*>(
                            p + static_cast<long long>(l) * c))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int h = 0; h < kCols; ++h) {
      const int col = base + h * groups + tid / kGroup, q = col % quads;
      float t[4] = {(v[h][0].x + v[h][2].x) + (v[h][1].x + v[h][3].x),
                    (v[h][0].y + v[h][2].y) + (v[h][1].y + v[h][3].y),
                    (v[h][0].z + v[h][2].z) + (v[h][1].z + v[h][3].z),
                    (v[h][0].w + v[h][2].w) + (v[h][1].w + v[h][3].w)};
#pragma unroll
      for (int o = 4; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < 4; ++i) t[i] += __shfl_xor_sync(0xffffffffu, t[i], o);
      if (j == 0 && col < cols && c0 + 4 * q < c)
        *reinterpret_cast<float4*>((col < quads ? out1 : out2) + c0 + 4 * q) =
            make_float4(t[0], t[1], t[2], t[3]);
    }
  }
}

// Stage 2 of the block of chunk blockIdx.y, after its partial rows are
// written (column_sums): the fold of its class if it is the class's last,
// then the xor tree if that makes it the tile's last. counters:
// kCountersPerTile ints a channel tile, 0 before the launch and left 0.
__device__ __forceinline__ void finish_tile(float* pa, float* pb, int c,
                                            int* counters,
                                            float* __restrict__ out1,
                                            float* __restrict__ out2) {
  const int chunks = gridDim.y;
  const int cls = blockIdx.y % kLanes;
  int* ct = counters + blockIdx.x * kCountersPerTile;
  if (!arrive_last(ct + cls, (chunks - 1 - cls) / kLanes + 1)) return;
  class_fold(pa, pb, cls, chunks, c);
  const int lanes = min(chunks, kLanes);
  if (!arrive_last(ct + kLanes, lanes)) return;
  lane_tree(pa, pb, lanes, c, out1, out2);
}

// The block shape every kernel of the family uses: TX = min(C / 8, 32)
// vectors wide, as many rows tall as fit 256 threads.
inline bool block_shape(int c, int tx, dim3* block, int* tiles) {
  const int cv = c / kVec;
  if (c <= 0 || c % kVec != 0 || tx < 1 || tx > 32 || tx > cv) return false;
  *block = dim3(tx, kThreads / tx);
  *tiles = (cv + tx - 1) / tx;
  return true;
}

}  // namespace p1t_bn
