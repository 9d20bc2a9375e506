// Fused Adam/AdamW update over a whole list of parameters, one launch.
//
// Replaces paddle1_tpu/ops/pallas/fused_adam.py::_adam_kernel. Same
// math, per element, in f32:
//   m1 = beta1 * m1 + (1 - beta1) * g
//   m2 = beta2 * m2 + (1 - beta2) * g * g
//   lr_t = lr * scale
//   p  = p * (1 - lr_t * decay) - lr_t * (m1 / bc1) / (sqrt(m2 / bc2) + eps)
// p (and g) keep their storage type, m1/m2 are f32, all updated in place.
// lr, bc1 = 1 - beta1^step and bc2 are read from a device array, so the
// step count is never baked into a launch; decay and the learning-rate
// scale (Paddle's ParamAttr(learning_rate=...)) are per tensor, one
// (decay, scale) pair of f32 each in one table. A scale of 1 leaves lr
// as it is (lr * 1 rounds to lr), so the update is then bit for bit the
// one without scales.
//
// Bound on an H100: memory. Each element reads p, g, m1, m2 and writes
// p, m1, m2: 28 bytes in f32 for ~12 flops. Design: the wrapper passes a
// device table with one row per tensor (p, g, m1, m2 pointers, element
// count, first chunk); the grid has one CTA per chunk of CHUNK elements
// of any tensor, each CTA finds its tensor by a binary search of the
// table and walks its chunk with coalesced grid-stride loads. So the
// whole parameter list (BERT-base: ~200 tensors, 110M elements) is one
// launch, where the Pallas kernel ran once per tensor.
//
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn):
// no FMA contraction, so the kernel repeats the plain PyTorch version's
// roundings (one op per kernel) bit for bit; division and sqrt are the
// IEEE ones nvcc emits by default.
//
// Built by paddle1_tpu_torch/ops/cuda/build.py with nvcc for sm_90a into
// a shared library with a plain C interface, loaded through ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRow = 6;  // table row: p, g, m1, m2, numel, first chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) adam_kernel(
    const long long* __restrict__ table, const float* __restrict__ coef,
    const float* __restrict__ scalars, int n_tensors, long long chunk,
    float beta1, float beta2, float omb1, float omb2, float eps) {
  const long long blk = blockIdx.x;
  int lo = 0, hi = n_tensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid * kRow + 5] <= blk) lo = mid; else hi = mid - 1;
  }
  const long long* row = table + lo * kRow;
  T* p = reinterpret_cast<T*>(row[0]);
  const T* g = reinterpret_cast<const T*>(row[1]);
  float* m1 = reinterpret_cast<float*>(row[2]);
  float* m2 = reinterpret_cast<float*>(row[3]);
  const long long start = (blk - row[5]) * chunk;
  const long long end = min(start + chunk, row[4]);
  const float lr = __fmul_rn(scalars[0], coef[2 * lo + 1]);
  const float bc1 = scalars[1];
  const float bc2 = scalars[2];
  const float shrink = __fadd_rn(1.f, -__fmul_rn(lr, coef[2 * lo]));
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const float gf = to_f32(g[i]);
    const float a = __fadd_rn(__fmul_rn(beta1, m1[i]), __fmul_rn(omb1, gf));
    const float b = __fadd_rn(__fmul_rn(beta2, m2[i]),
                              __fmul_rn(__fmul_rn(omb2, gf), gf));
    const float upd = (a / bc1) / __fadd_rn(sqrtf(b / bc2), eps);
    const float pf = __fadd_rn(__fmul_rn(to_f32(p[i]), shrink),
                               -__fmul_rn(lr, upd));
    store(p + i, pf);
    m1[i] = a;
    m2[i] = b;
  }
}

}  // namespace

extern "C" {

// table: [n_tensors, 6] int64 on the card (see kRow); coef: [n_tensors, 2]
// f32 = (decay, learning-rate scale) per tensor; scalars: [3] f32 = lr,
// bc1, bc2; n_chunks = the last row's first
// chunk plus its chunk count. dtype of p and g: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t (0 = success).
int p1t_fused_adam(const void* table, const void* coef, const void* scalars,
                   int n_tensors, long long n_chunks, long long chunk,
                   float beta1, float beta2, float omb1, float omb2,
                   float eps, int dtype, void* stream) {
  if (n_tensors <= 0 || n_chunks <= 0 || n_chunks > 2147483647LL ||
      chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_chunks));
  const long long* t = static_cast<const long long*>(table);
  const float* d = static_cast<const float*>(coef);
  const float* sc = static_cast<const float*>(scalars);
  if (dtype == 0)
    adam_kernel<float><<<grid, kThreads, 0, s>>>(
        t, d, sc, n_tensors, chunk, beta1, beta2, omb1, omb2, eps);
  else if (dtype == 1)
    adam_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        t, d, sc, n_tensors, chunk, beta1, beta2, omb1, omb2, eps);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* p1t_fused_adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
