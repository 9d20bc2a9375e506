// Row softmax over the last axis of a row-major [rows, h] tensor.
//
// Replaces paddle1_tpu/ops/pallas/softmax.py::_softmax_kernel. Same
// numerics contract: in f32, m = max(x), e = exp(x - m), y = e / sum(e),
// stored in the input's dtype (f32, bf16 or f16).
//
// Bound on an H100: memory. x is read once and y written once,
// 2 * rows * h * itemsize bytes at 3.35 TB/s, against ~4 flops and one
// exp per element. Design, simple first:
//   * h <= 1024: one warp per row, the row held in registers (at most 32
//     floats a lane): shuffle max, exp, shuffle sum, divide, store. Four
//     rows per 128-thread block.
//   * h > 1024: one block per row, two passes over the row: an online
//     (max, sum) pass whose per-thread pairs are combined across the block,
//     then a pass that re-reads x (from L2: a 32000-wide f32 row is 125 KB,
//     and the few hundred rows in flight fit the 50 MB cache) and writes
//     exp(x - max) / sum. No shared-memory row, so no width cap but the
//     32-bit grid and index range.
// Loads and stores are 16 bytes a thread when h is a multiple of the
// vector width (4 f32, 8 bf16 or f16) and both pointers are 16-byte
// aligned, else one element; the ragged tail of a row is masked. No
// atomics and a fixed reduction order: repeats are bit-identical. The TPU
// kernel's layout gates (h % 128, a VMEM row-block ladder) have no
// counterpart.
//
// Built by paddle1_tpu_torch/ops/cuda/build.py with nvcc for sm_90a into
// a shared library with a plain C interface, loaded through ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpRows = 4;    // rows (warps) per block on the warp path
constexpr int kWarpMaxH = 1024; // widest row the warp path holds

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half(v);
}
__device__ __forceinline__ void put(float& d, float v) { d = v; }
__device__ __forceinline__ void put(__nv_bfloat16& d, float v) {
  d = __float2bfloat16(v);
}
__device__ __forceinline__ void put(__half& d, float v) {
  d = __float2half(v);
}

// VEC consecutive elements at p (16 bytes when VEC > 1) as f32.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = to_f32(*p);
  } else {
    static_assert(VEC * sizeof(T) == 16, "a vector is 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f32(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    store(p, v[0]);
  } else {
    alignas(16) T e[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) put(e[i], v[i]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(e);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp per row; lane l holds vectors l, l + 32, ... (CHUNKS of them).
template <typename T, int VEC, int CHUNKS>
__global__ void softmax_warp_kernel(const T* __restrict__ x,
                                    T* __restrict__ y, int rows, int h) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + static_cast<long long>(row) * h;
  T* yr = y + static_cast<long long>(row) * h;

  float v[CHUNKS][VEC];
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (col < h) {  // VEC > 1 only when h % VEC == 0: whole vectors
      load_vec<T, VEC>(xr + col, v[c]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) m = fmaxf(m, v[c][i]);
    }
  }
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    if ((c * 32 + lane) * VEC < h) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        v[c][i] = expf(v[c][i] - m);
        s += v[c][i];
      }
    }
  }
  s = warp_sum(s);
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (col < h) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[c][i] = v[c][i] / s;
      store_vec<T, VEC>(yr + col, v[c]);
    }
  }
}

// Fold x into a running (max m, sum s of exp(. - m)). A -inf element adds
// exp(-inf) = 0 and is skipped, so a leading -inf cannot turn the sum into
// exp(-inf - -inf) = NaN; a NaN element fails `x > m` and makes s NaN.
__device__ __forceinline__ void online_add(float& m, float& s, float x) {
  if (x == -INFINITY) return;
  if (x > m) {
    s = s * expf(m - x) + 1.f;
    m = x;
  } else {
    s += expf(x - m);
  }
}

// Combine two (max, sum) pairs; an empty pair (s == 0) adds nothing.
__device__ __forceinline__ void combine(float& m, float& s, float m2,
                                        float s2) {
  const float mm = fmaxf(m, m2);
  const float a = (s == 0.f) ? 0.f : s * expf(m - mm);
  const float b = (s2 == 0.f) ? 0.f : s2 * expf(m2 - mm);
  m = mm;
  s = a + b;
}

// One block per row: online (max, sum), a block-wide combine, then
// y = exp(x - max) / sum from a second read of the row.
template <typename T, int VEC>
__global__ void softmax_block_kernel(const T* __restrict__ x,
                                     T* __restrict__ y, int h) {
  __shared__ float red_m[32];
  __shared__ float red_s[32];
  const T* xr = x + static_cast<long long>(blockIdx.x) * h;
  T* yr = y + static_cast<long long>(blockIdx.x) * h;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int step = blockDim.x * VEC;

  float m = -INFINITY, s = 0.f;
  for (int col = threadIdx.x * VEC; col < h; col += step) {
    float v[VEC];
    load_vec<T, VEC>(xr + col, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) online_add(m, s, v[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    combine(m, s, __shfl_xor_sync(0xffffffffu, m, o),
            __shfl_xor_sync(0xffffffffu, s, o));
  if (lane == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < nwarps ? red_m[lane] : -INFINITY;
    s = lane < nwarps ? red_s[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      combine(m, s, __shfl_xor_sync(0xffffffffu, m, o),
              __shfl_xor_sync(0xffffffffu, s, o));
    if (lane == 0) {
      red_m[0] = m;
      // a +inf element makes the reference's sum exp(inf - inf) = NaN
      red_s[0] = (m == INFINITY) ? NAN : s;
    }
  }
  __syncthreads();
  const float mx = red_m[0];
  const float sum = red_s[0];

  for (int col = threadIdx.x * VEC; col < h; col += step) {
    float v[VEC];
    load_vec<T, VEC>(xr + col, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = expf(v[i] - mx) / sum;
    store_vec<T, VEC>(yr + col, v);
  }
}

// The warp kernel with the fewest CHUNKS that covers per_lane vectors.
template <typename T, int VEC, int CHUNKS>
void warp_dispatch(const T* x, T* y, int rows, int h, int per_lane,
                   cudaStream_t st) {
  if constexpr (CHUNKS * VEC < 32) {
    if (per_lane > CHUNKS) {
      warp_dispatch<T, VEC, CHUNKS * 2>(x, y, rows, h, per_lane, st);
      return;
    }
  }
  const int blocks = (rows + kWarpRows - 1) / kWarpRows;
  softmax_warp_kernel<T, VEC, CHUNKS><<<blocks, 32 * kWarpRows, 0, st>>>(
      x, y, rows, h);
}

template <typename T, int VEC>
void run(const T* x, T* y, int rows, int h, cudaStream_t st) {
  const int vecs = (h + VEC - 1) / VEC;  // vectors in a row
  if (h <= kWarpMaxH) {
    warp_dispatch<T, VEC, 1>(x, y, rows, h, (vecs + 31) / 32, st);
    return;
  }
  // about four vectors a thread, whole warps, at most 1024 threads
  const int quarter = (vecs + 3) / 4;
  int threads = ((quarter + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  softmax_block_kernel<T, VEC><<<rows, threads, 0, st>>>(x, y, h);
}

template <typename T>
int launch(const void* xv, void* yv, int rows, int h, void* stream) {
  if (rows <= 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = h % V == 0 &&
                   reinterpret_cast<uintptr_t>(xv) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(yv) % 16 == 0;
  if (vec)
    run<T, V>(x, y, rows, h, st);
  else
    run<T, 1>(x, y, rows, h, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns a cudaError_t
// (0 = success).
int p1t_softmax_fwd(const void* x, void* y, int rows, int h, int dtype,
                    void* stream) {
  if (dtype == 0) return launch<float>(x, y, rows, h, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, rows, h, stream);
  if (dtype == 2) return launch<__half>(x, y, rows, h, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* p1t_softmax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
