// Shared pieces of the fused batch-norm kernels (fused_bn.cu and
// fused_bn_bwd.cu): 8-channel vector loads and stores, the block layout
// and the deterministic two-stage reduction over rows.
//
// Layout: x is channels-last [rows, C], C % 8 == 0. A thread owns one
// vector of 8 channels (16 B of bf16, 32 B of f32) and walks rows with a
// stride; a block is TX vectors wide (blockDim.x) and TY rows tall
// (blockDim.y), TX * TY <= 256. A reduction over rows runs in two stages
// with no atomics, so repeats are bit-identical:
//   1. blockIdx.y is a chunk of consecutive rows; each block sums its
//      chunk per channel (thread loops, then a fixed-order column sum in
//      shared memory) and writes one f32 partial row [chunk, C];
//   2. finalize_kernel: one warp per channel sums the partial rows in a
//      fixed lane order and shuffle tree.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace p1t_bn {

constexpr int kThreads = 256;      // TX * TY <= kThreads
constexpr int kVec = 8;            // channels per thread
constexpr int kTileMax = 32 * kVec;  // channels of the widest tile (TX = 32)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

// Eight channels as they lie in memory (16 B of bf16, 32 B of f32), for
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

// Stage 2: one warp per channel sums pa/pb[0..chunks) in a fixed order.
// mode 0: out1 = mean = s * inv_count,
//         out2 = var = max(ss * inv_count - mean^2, 0)  (the exact count
//         enters once, as a host constant);
// mode 1: out1, out2 = the raw sums.
__global__ void finalize_kernel(const float* __restrict__ pa,
                                const float* __restrict__ pb, int chunks,
                                int c, float inv_count, int mode,
                                float* __restrict__ out1,
                                float* __restrict__ out2) {
  const int lane = threadIdx.x & 31;
  const int ch = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (ch >= c) return;
  float s = 0.f, t = 0.f;
  for (int k = lane; k < chunks; k += 32) {
    s += pa[static_cast<long long>(k) * c + ch];
    t += pb[static_cast<long long>(k) * c + ch];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    t += __shfl_xor_sync(0xffffffffu, t, o);
  }
  if (lane != 0) return;
  if (mode == 0) {
    const float m = s * inv_count;
    out1[ch] = m;
    out2[ch] = fmaxf(t * inv_count - m * m, 0.f);
  } else {
    out1[ch] = s;
    out2[ch] = t;
  }
}

inline int launch_finalize(const float* pa, const float* pb, int chunks,
                           int c, float inv_count, int mode, float* out1,
                           float* out2, cudaStream_t stream) {
  const int warps = kThreads / 32;
  finalize_kernel<<<(c + warps - 1) / warps, kThreads, 0, stream>>>(
      pa, pb, chunks, c, inv_count, mode, out1, out2);
  return static_cast<int>(cudaGetLastError());
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
