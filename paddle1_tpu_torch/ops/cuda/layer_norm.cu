// LayerNorm forward over the last axis of a row-major [rows, H] tensor.
//
// Replaces paddle1_tpu/ops/pallas/layer_norm.py::_ln_fwd_kernel.
// Same numerics contract: f32 mean, then the two-pass variance
// var = mean((x - mean)^2) (not E[x^2] - E[x]^2), y = (x - mean) * rstd,
// then y * w + b, cast to the storage type (f32, bf16 or f16) at the edge.
//
// Bound on an H100: memory. Each row is read and written once
// (2 * rows * H * itemsize bytes) against ~8 flops per element, far below
// the card's ~20 flops/byte f32 balance point; at BERT-base's bf16
// [16384, 768], 50 MB: 0.015 ms at 3.35 TB/s.
//
// Rows up to kWarpRow = 1024 wide (every width the serving and training
// paths run): one warp per row, the row held in registers (at most 32
// values a lane), read once and written once, with 16-byte loads and
// stores where the pointers and H allow (H % 8 in bf16 and f16, H % 4 in
// f32),
// else with scalar ones. Mean and variance come from the registers by
// warp shuffles: no shared memory, no barrier. A CTA holds 4 warps, and
// a grid of at most as many CTAs as the card holds at once walks the
// rows, so each warp loads the weight and bias once, and loads its next
// row before it reduces the current one.
//
// Wider rows: one CTA per row, three passes over the row (the second and
// third from L1/L2), block reductions through shared memory, the same
// 16-byte loads where allowed. Any H works, which replaces the TPU gate
// H % 128 == 0.
//
// Built by paddle1_tpu_torch/ops/cuda/build.py with nvcc for sm_90a into
// a shared library with a plain C interface, loaded through ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kWarps = 4;        // rows in flight per CTA, one a warp
constexpr int kWarpRow = 1024;   // widest row a warp holds in registers

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(f16 v) { return __half2float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ f16 from_f32<f16>(float v) {
  return __float2half_rn(v);
}

// VEC values moved by one load or store (16 bytes at VEC = 16 / sizeof(T))
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// the pack at p, or zeros when !ok
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p, bool ok) {
  Pack<T, VEC> r;
  if (!ok) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) r.v[e] = from_f32<T>(0.f);
  } else if constexpr (VEC == 1) {
    r.v[0] = *p;
  } else {
    static_assert(sizeof(r) == 16, "a vector is 16 bytes");
    *reinterpret_cast<uint4*>(r.v) = *reinterpret_cast<const uint4*>(p);
  }
  return r;
}

template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, VEC>& r) {
  if constexpr (VEC == 1)
    *p = r.v[0];
  else
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(r.v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp per row of up to 32 * VPL values. Chunk c of lane l holds
// columns [(32 c + l) VEC, + VEC): wholly inside the row or wholly past
// its end (H % VEC == 0), so a chunk past the end is neither loaded nor
// stored and adds nothing to the sums.
template <typename T, int VEC, int VPL>
__global__ void __launch_bounds__(32 * kWarps) layer_norm_warp_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ b, T* __restrict__ y, int rows, int h,
    float eps) {
  constexpr int NC = VPL / VEC;
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & 31;
  const long stride = static_cast<long>(gridDim.x) * kWarps;
  long row = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;

  bool in[NC];
  float wv[VPL], bv[VPL];
  P cur[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = (32 * c + lane) * VEC;
    in[c] = col < h;
    const P pw = load_pack<T, VEC>(w + col, in[c]);
    const P pb = load_pack<T, VEC>(b + col, in[c]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      wv[c * VEC + e] = to_f32(pw.v[e]);
      bv[c * VEC + e] = to_f32(pb.v[e]);
    }
    cur[c] = load_pack<T, VEC>(x + row * h + col, in[c]);
  }
  const float inv_h = 1.f / static_cast<float>(h);

  for (; row < rows; row += stride) {
    // the next row's loads are in flight while this one is reduced
    const long next = row + stride;
    P nxt[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      nxt[c] = load_pack<T, VEC>(x + next * h + (32 * c + lane) * VEC,
                                 in[c] && next < rows);

    float v[VPL];
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        v[c * VEC + e] = to_f32(cur[c].v[e]);
        s += v[c * VEC + e];
      }
    const float mean = warp_sum(s) * inv_h;
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        v[c * VEC + e] -= mean;
        if (in[c]) ss += v[c * VEC + e] * v[c * VEC + e];
      }
    const float rstd = rsqrtf(warp_sum(ss) * inv_h + eps);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (!in[c]) continue;
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int i = c * VEC + e;
        o.v[e] = from_f32<T>(v[i] * rstd * wv[i] + bv[i]);
      }
      store_pack<T, VEC>(y + row * h + (32 * c + lane) * VEC, o);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) cur[c] = nxt[c];
  }
}

// Sum over the block; every thread gets the result. `red` holds one
// float per warp (blockDim.x <= 1024 -> at most 32 warps).
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = (threadIdx.x < nwarps) ? red[threadIdx.x] : 0.f;
  if (warp == 0) {
    t = warp_sum(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  const float out = red[0];
  __syncthreads();  // red is reused by the next reduction
  return out;
}

// One CTA per row wider than kWarpRow, VEC values a load.
template <typename T, int VEC>
__global__ void layer_norm_block_kernel(const T* __restrict__ x,
                                        const T* __restrict__ w,
                                        const T* __restrict__ b,
                                        T* __restrict__ y, int h,
                                        float eps) {
  using P = Pack<T, VEC>;
  __shared__ float red[32];
  const int n = h / VEC;
  const T* xr = x + static_cast<long>(blockIdx.x) * h;
  T* yr = y + static_cast<long>(blockIdx.x) * h;

  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const P p = load_pack<T, VEC>(xr + i * VEC, true);
#pragma unroll
    for (int e = 0; e < VEC; ++e) s += to_f32(p.v[e]);
  }
  const float mean = block_sum(s, red) / static_cast<float>(h);

  float ss = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const P p = load_pack<T, VEC>(xr + i * VEC, true);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float c = to_f32(p.v[e]) - mean;
      ss += c * c;
    }
  }
  const float rstd =
      rsqrtf(block_sum(ss, red) / static_cast<float>(h) + eps);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const P p = load_pack<T, VEC>(xr + i * VEC, true);
    const P pw = load_pack<T, VEC>(w + i * VEC, true);
    const P pb = load_pack<T, VEC>(b + i * VEC, true);
    P o;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      o.v[e] = from_f32<T>((to_f32(p.v[e]) - mean) * rstd * to_f32(pw.v[e]) +
                           to_f32(pb.v[e]));
    store_pack<T, VEC>(yr + i * VEC, o);
  }
}

struct Resident {
  cudaError_t err;
  int ctas;
};

// CTAs of `kern` (32 * kWarps threads, no dynamic shared memory) the card
// holds at once
template <typename Kern>
Resident resident(Kern kern) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      32 * kWarps, 0);
  return {e, sms * (per_sm > 0 ? per_sm : 1)};
}

template <typename T, int VEC, int VPL>
int launch_warp(const void* x, const void* w, const void* b, void* y,
                int rows, int h, float eps, cudaStream_t s) {
  auto kern = layer_norm_warp_kernel<T, VEC, VPL>;
  // found once per instantiation, outside any graph capture
  static const Resident res = resident(kern);
  if (res.err != cudaSuccess) return static_cast<int>(res.err);
  const int blocks = min((rows + kWarps - 1) / kWarps, res.ctas);
  kern<<<blocks, 32 * kWarps, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), rows, h, eps);
  return static_cast<int>(cudaGetLastError());
}

// the values a lane holds: 8, 16, 24 or 32
template <typename T, int VEC>
int dispatch_warp(const void* x, const void* w, const void* b, void* y,
                  int rows, int h, float eps, cudaStream_t s) {
  if (h <= 256) return launch_warp<T, VEC, 8>(x, w, b, y, rows, h, eps, s);
  if (h <= 512) return launch_warp<T, VEC, 16>(x, w, b, y, rows, h, eps, s);
  if (h <= 768) return launch_warp<T, VEC, 24>(x, w, b, y, rows, h, eps, s);
  return launch_warp<T, VEC, 32>(x, w, b, y, rows, h, eps, s);
}

template <typename T, int VEC>
int launch_block(const void* x, const void* w, const void* b, void* y,
                 int rows, int h, float eps, cudaStream_t s) {
  // ~4 loads a thread, whole warps, at most 1024 threads
  const int quarter = (h / VEC + 3) / 4;
  const int threads = min(1024, max(32, (quarter + 31) / 32 * 32));
  layer_norm_block_kernel<T, VEC><<<rows, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), h, eps);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int rows,
           int h, float eps, void* stream) {
  if (rows <= 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int VEC = 16 / sizeof(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = h % VEC == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(b) && aligned16(y);
  if (h <= kWarpRow)
    return vec ? dispatch_warp<T, VEC>(x, w, b, y, rows, h, eps, s)
               : dispatch_warp<T, 1>(x, w, b, y, rows, h, eps, s);
  return vec ? launch_block<T, VEC>(x, w, b, y, rows, h, eps, s)
             : launch_block<T, 1>(x, w, b, y, rows, h, eps, s);
}

}  // namespace

extern "C" {

// x, y: [rows, h] row-major, w, b: [h], all contiguous in `dtype`
// (0 = float32, 1 = bfloat16, 2 = float16). Returns a cudaError_t (0 = success).
int p1t_layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                       int rows, int h, float eps, int dtype, void* stream) {
  if (dtype == 0) return launch<float>(x, w, b, y, rows, h, eps, stream);
  if (dtype == 1) return launch<bf16>(x, w, b, y, rows, h, eps, stream);
  if (dtype == 2) return launch<f16>(x, w, b, y, rows, h, eps, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* p1t_layer_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
