// LayerNorm forward over the last axis of a row-major [rows, H] tensor.
//
// Replaces paddle1_tpu/ops/pallas/layer_norm.py::_ln_fwd_kernel.
// Same numerics contract: f32 mean, then the two-pass variance
// var = mean((x - mean)^2) (not E[x^2] - E[x]^2), y = (x - mean) * rstd,
// then y * w + b, cast to the storage type at the edge.
//
// Bound on an H100: memory. Each row is read and written once
// (2 * rows * H * itemsize bytes) against ~8 flops per element, far below
// the card's ~20 flops/byte f32 balance point. Design: one CTA per row,
// so no reduction crosses blocks; the row is read through L1/L2 on the
// second and third pass (a 512-float row is 2 KB), so DRAM sees it once.
// Any H works: a row of any width fits one block's strided loop, which
// replaces the TPU gate H % 128 == 0.
//
// Built by paddle1_tpu_torch/ops/cuda/build.py with nvcc for sm_90a into
// a shared library with a plain C interface, loaded through ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Sum over the block; every thread gets the result. `red` holds one
// float per warp (blockDim.x <= 1024 -> at most 32 warps).
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = (threadIdx.x < nwarps) ? red[threadIdx.x] : 0.f;
  if (warp == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  const float out = red[0];
  __syncthreads();  // red is reused by the next reduction
  return out;
}

template <typename T>
__global__ void layer_norm_fwd_kernel(const T* __restrict__ x,
                                      const T* __restrict__ w,
                                      const T* __restrict__ b,
                                      T* __restrict__ y, int h, float eps) {
  __shared__ float red[32];
  const long row = blockIdx.x;
  const T* xr = x + row * h;
  T* yr = y + row * h;

  float s = 0.f;
  for (int i = threadIdx.x; i < h; i += blockDim.x) s += to_f32(xr[i]);
  const float mean = block_sum(s, red) / static_cast<float>(h);

  float ss = 0.f;
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    const float c = to_f32(xr[i]) - mean;
    ss += c * c;
  }
  const float var = block_sum(ss, red) / static_cast<float>(h);
  const float rstd = 1.f / sqrtf(var + eps);

  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    const float yn = (to_f32(xr[i]) - mean) * rstd;
    store(yr + i, yn * to_f32(w[i]) + to_f32(b[i]));
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int rows,
           int h, float eps, int threads, void* stream) {
  if (rows <= 0 || h <= 0 || threads < 32 || threads > 1024 ||
      threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  layer_norm_fwd_kernel<T><<<rows, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), h, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
int p1t_layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                       int rows, int h, float eps, int threads, int dtype,
                       void* stream) {
  if (dtype == 0)
    return launch<float>(x, w, b, y, rows, h, eps, threads, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, b, y, rows, h, eps, threads, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* p1t_layer_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
