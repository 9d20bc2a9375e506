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
// p, m1, m2: 28 bytes in f32 (22 in bf16 and f16) for ~12 flops, so the
// kernel is worth what it keeps in flight and how little it spends between
// bytes. Design:
// * Every stream moves as 16-byte vectors: in f32 a float4 of p, g, m1
//   and m2; in bf16 and f16 8 elements, one 16-byte load of p and of g
//   against two float4 each of m1 and m2. Each thread loads kUnroll such
//   vectors of every stream (16 elements) before it computes any, so
//   4 x 16 x 4 bytes are in flight a thread in f32.
// * A persistent grid of ctas_per_sm CTAs an SM walks the chunks of
//   `chunk` elements in table order, CTA b taking chunks b, b + grid,
//   ...; the chunks' tensor indices only grow, so each CTA finds a
//   chunk's tensor by stepping forward from the last one (each chunk is
//   looked up once, no search from the start).
// * The wrapper's table gives each tensor a head of scalar elements up to
//   the first element where all four streams are 16-byte aligned, a body
//   of whole vectors, and a scalar tail. A tensor whose streams cannot be
//   aligned together (views at different odd offsets) has no body and
//   runs all scalar. Chunks start at head + k * chunk, so every vector of
//   the body is aligned; chunk 0 also holds the head, the last chunk the
//   tail.
// * Streaming (evict-first) loads and stores: no stream is read twice.
// The launch settings were chosen by tools/torch_adam_bench.py --sweep
// (graph replays, median of 3; NVIDIA H100 80GB HBM3, 700 W; PERF.md,
// PR 17). f32 BERT-base (110 M elements, bound 0.920 ms) / ERNIE-1.5B
// (1.64 B, bound 13.68 ms), ms: streaming loads and stores 1.057 /
// 15.69 at 8192-element chunks and 4 CTAs an SM, against 1.061 / 15.67
// with L2 256-byte prefetching loads and 1.104 / 15.82 with no hints;
// chunks of 16384 / 32768 / 65536 1.063 / 1.068 / 1.089 at BERT-base;
// 2 / 8 CTAs an SM 1.057 / 1.070 at BERT-base and 15.81 / 15.59 at
// ERNIE. bf16 BERT-base 0.859 ms (bound 0.723). The wrapper passes them
// (ops/fused_adam.py: CHUNK, CTAS_PER_SM). ptxas: 122 registers a thread
// in f32, 86 in bf16, no spills, so 2 CTAs of 256 threads are resident
// an SM (the grid's others start as they finish).
//
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn):
// no FMA contraction, so the kernel repeats the plain PyTorch version's
// roundings (one op per kernel) bit for bit, in the vector and the scalar
// paths alike (one function does both); division and sqrt are the IEEE
// ones nvcc emits by default.
//
// Built by paddle1_tpu_torch/ops/cuda/build.py with nvcc for sm_90a into
// a shared library with a plain C interface, loaded through ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kRow = 8;  // p, g, m1, m2, numel, first chunk, head, body
constexpr int kMaxDevices = 64;

struct Coef {
  float lr, shrink, bc1, bc2, beta1, beta2, omb1, omb2, eps;
};

__device__ __forceinline__ float update(const Coef& c, float p, float g,
                                        float& m1, float& m2) {
  const float a = __fadd_rn(__fmul_rn(c.beta1, m1), __fmul_rn(c.omb1, g));
  const float b = __fadd_rn(__fmul_rn(c.beta2, m2),
                            __fmul_rn(__fmul_rn(c.omb2, g), g));
  const float upd = (a / c.bc1) / __fadd_rn(sqrtf(b / c.bc2), c.eps);
  m1 = a;
  m2 = b;
  return __fadd_rn(__fmul_rn(p, c.shrink), -__fmul_rn(c.lr, upd));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store1(__half* p, float v) {
  *p = __float2half_rn(v);
}

__device__ __forceinline__ float4 load4(const void* ptr) {
  return __ldcs(reinterpret_cast<const float4*>(ptr));
}

__device__ __forceinline__ void store4(void* ptr, float4 v) {
  __stcs(reinterpret_cast<float4*>(ptr), v);
}

// One vector of V = 16 / sizeof(T) elements of each stream.
template <typename T>
struct Vec {
  static constexpr int V = 16 / sizeof(T);
  float4 p, g, m1[V / 4], m2[V / 4];
};

template <typename T>
__device__ __forceinline__ void unpack(const float4& raw, float* out) {
  if constexpr (sizeof(T) == 4) {
    out[0] = raw.x; out[1] = raw.y; out[2] = raw.z; out[3] = raw.w;
  } else if constexpr (std::is_same<T, __half>::value) {
    const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __half22float2(h[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ float4 pack(const float* in) {
  float4 raw;
  if constexpr (sizeof(T) == 4) {
    raw = make_float4(in[0], in[1], in[2], in[3]);
  } else if constexpr (std::is_same<T, __half>::value) {
    __half2* h = reinterpret_cast<__half2*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2half2_rn(in[2 * j], in[2 * j + 1]);
  } else {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(in[2 * j], in[2 * j + 1]);
  }
  return raw;
}

template <typename T, int kUnroll>
__global__ void __launch_bounds__(kThreads) adam_kernel(
    const long long* __restrict__ table, const float* __restrict__ coef,
    const float* __restrict__ scalars, int n_tensors, long long n_chunks,
    long long chunk, float beta1, float beta2, float omb1, float omb2,
    float eps) {
  constexpr int V = Vec<T>::V;
  Coef c;
  c.bc1 = scalars[1];
  c.bc2 = scalars[2];
  c.beta1 = beta1;
  c.beta2 = beta2;
  c.omb1 = omb1;
  c.omb2 = omb2;
  c.eps = eps;
  const float lr0 = scalars[0];
  int t = 0;
  for (long long k = blockIdx.x; k < n_chunks; k += gridDim.x) {
    while (t + 1 < n_tensors && table[(t + 1) * kRow + 5] <= k) ++t;
    const long long* row = table + static_cast<long long>(t) * kRow;
    T* p = reinterpret_cast<T*>(row[0]);
    const T* g = reinterpret_cast<const T*>(row[1]);
    float* m1 = reinterpret_cast<float*>(row[2]);
    float* m2 = reinterpret_cast<float*>(row[3]);
    const long long n = row[4], local = k - row[5];
    const long long head = row[6], body = row[7];
    const bool last = t + 1 == n_tensors ? k + 1 == n_chunks
                                         : table[(t + 1) * kRow + 5] == k + 1;
    const long long cs = local == 0 ? 0 : head + local * chunk;
    const long long ce = last ? n : head + (local + 1) * chunk;
    const long long vs = max(cs, head);
    const long long ve = max(vs, min(ce, head + body));
    c.lr = __fmul_rn(lr0, coef[2 * t + 1]);
    c.shrink = __fadd_rn(1.f, -__fmul_rn(c.lr, coef[2 * t]));
    // the scalar head and tail of this chunk
    for (long long i = cs + threadIdx.x; i < vs; i += kThreads) {
      float a = m1[i], b = m2[i];
      store1(p + i, update(c, to_f32(p[i]), to_f32(g[i]), a, b));
      m1[i] = a;
      m2[i] = b;
    }
    for (long long i = ve + threadIdx.x; i < ce; i += kThreads) {
      float a = m1[i], b = m2[i];
      store1(p + i, update(c, to_f32(p[i]), to_f32(g[i]), a, b));
      m1[i] = a;
      m2[i] = b;
    }
    // the body: kUnroll vectors a thread, all loaded before any is used
    const long long nv = (ve - vs) / V;
    T* pv = p + vs;
    const T* gv = g + vs;
    float* m1v = m1 + vs;
    float* m2v = m2 + vs;
    for (long long base = threadIdx.x; base < nv;
         base += static_cast<long long>(kThreads) * kUnroll) {
      Vec<T> x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = base + static_cast<long long>(u) * kThreads;
        if (j < nv) {
          x[u].p = load4(pv + j * V);
          x[u].g = load4(gv + j * V);
#pragma unroll
          for (int q = 0; q < V / 4; ++q) {
            x[u].m1[q] = load4(m1v + j * V + 4 * q);
            x[u].m2[q] = load4(m2v + j * V + 4 * q);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = base + static_cast<long long>(u) * kThreads;
        if (j < nv) {
          float pf[V], gf[V];
          unpack<T>(x[u].p, pf);
          unpack<T>(x[u].g, gf);
          float* a = reinterpret_cast<float*>(x[u].m1);
          float* b = reinterpret_cast<float*>(x[u].m2);
#pragma unroll
          for (int e = 0; e < V; ++e)
            pf[e] = update(c, pf[e], gf[e], a[e], b[e]);
          store4(pv + j * V, pack<T>(pf));
#pragma unroll
          for (int q = 0; q < V / 4; ++q) {
            store4(m1v + j * V + 4 * q, x[u].m1[q]);
            store4(m2v + j * V + 4 * q, x[u].m2[q]);
          }
        }
      }
    }
  }
}

int sm_count() {
  static int counts[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    counts[dev] = 0;
  return counts[dev];
}

}  // namespace

extern "C" {

// table: [n_tensors, 8] int64 on the card (see kRow); coef: [n_tensors, 2]
// f32 = (decay, learning-rate scale) per tensor; scalars: [3] f32 = lr,
// bc1, bc2; n_chunks = the last row's first chunk plus its chunk count;
// chunk: elements a chunk, a multiple of 8. dtype of p and g:
// 0 = float32, 1 = bfloat16, 2 = float16. ctas_per_sm: the persistent
// grid's CTAs an SM. Returns a cudaError_t (0 = success).
int p1t_fused_adam(const void* table, const void* coef, const void* scalars,
                   int n_tensors, long long n_chunks, long long chunk,
                   float beta1, float beta2, float omb1, float omb2,
                   float eps, int dtype, int ctas_per_sm, void* stream) {
  if (n_tensors <= 0 || n_chunks <= 0 || chunk <= 0 || chunk % 8 != 0 ||
      ctas_per_sm <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const long long cap = static_cast<long long>(sms) * ctas_per_sm;
  const dim3 grid(static_cast<unsigned>(n_chunks < cap ? n_chunks : cap));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* t = static_cast<const long long*>(table);
  const float* d = static_cast<const float*>(coef);
  const float* sc = static_cast<const float*>(scalars);
  if (dtype == 0)
    adam_kernel<float, 4><<<grid, kThreads, 0, s>>>(
        t, d, sc, n_tensors, n_chunks, chunk, beta1, beta2, omb1, omb2, eps);
  else if (dtype == 1)
    adam_kernel<__nv_bfloat16, 2><<<grid, kThreads, 0, s>>>(
        t, d, sc, n_tensors, n_chunks, chunk, beta1, beta2, omb1, omb2, eps);
  else if (dtype == 2)
    adam_kernel<__half, 2><<<grid, kThreads, 0, s>>>(
        t, d, sc, n_tensors, n_chunks, chunk, beta1, beta2, omb1, omb2, eps);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* p1t_fused_adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
