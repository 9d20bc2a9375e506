// Decode attention over a block-paged K/V pool.
//
// Replaces paddle1_tpu/ops/pallas/paged_attention.py::_kernel.
// Shapes: q [S, W, H, D]; k/v pools [P, ps, H, D]; table [S, mpps] int32
// (page ids; parked rows point at page 0); base [S] int32 (slot length
// before this window). Query row i of slot s sees key positions
// <= base[s] + i. Output [S, W, H, D] in q's type; a row that sees no key
// gives 0. The pools may have another type than q (a bf16 cache under an
// f32 model): q, K and V are each converted to f32, as in the Pallas body,
// which also applies the scale to q before the dot product.
//
// Bound on an H100: memory. A decode step reads each live K/V page once
// (2 * live_tokens * D * itemsize bytes per (slot, head)) and does ~4
// flops per K/V element, far below the f32 balance point.
//
// Design: one CTA per (slot, head) walks only that slot's
// ceil((base + W) / ps) live pages through the page table. Pages past the
// cursor are never loaded: the Pallas grid visits all mpps pages and masks
// them, because a TPU grid has a fixed extent, which a CUDA loop does not
// need. The TPU kernel carries one online softmax across its sequential
// page axis; here each of the CTA's kWarps warps walks its own stride of
// pages (warp w takes pages w, w + kWarps, ...) with its own f32 online
// softmax (m, l, acc) in shared memory, so kWarps pages are in flight at
// once, and the warps' partial softmaxes are merged at the end. A warp
// stages its page's K and V rows in shared memory (16-byte loads of 4 f32
// or 8 bf16 when the rows allow it; row stride D + 1 so lanes reading different keys hit
// different banks), computes scores with one lane per (row, key), the
// softmax update with warp shuffles, and P.V with one lane per dim.
// Simple first version: no cp.async/TMA double buffering and no tensor
// cores yet.
//
// Built by paddle1_tpu_torch/ops/cuda/build.py with nvcc for sm_90a into
// a shared library with a plain C interface, loaded through ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 8;  // loads each lane keeps in flight per array

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
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

// 16 bytes of pool elements (4 f32 or 8 bf16), widened to f32 in dst.
__device__ __forceinline__ void unpack16(const uint4& r, const float*,
                                         float* dst) {
  const float* f = reinterpret_cast<const float*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) dst[j] = f[j];
}
__device__ __forceinline__ void unpack16(const uint4& r,
                                         const __nv_bfloat16*, float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    dst[2 * j] = f.x;
    dst[2 * j + 1] = f.y;
  }
}

// One warp copies one page's K and V rows for its head into shared memory
// (row stride d + 1), converting to f32: 16-byte loads when every row
// start is 16-byte aligned, else one element per load. All of a lane's
// loads of a round are issued before any store, so they overlap in flight.
template <typename T>
__device__ __forceinline__ void load_page(const T* __restrict__ kp,
                                          const T* __restrict__ vp,
                                          long page_off, long pos_stride,
                                          float* ks, float* vs, int ps,
                                          int d, int lane) {
  const int ld = d + 1;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const bool aligned = ((reinterpret_cast<std::uintptr_t>(kp) |
                         reinterpret_cast<std::uintptr_t>(vp)) & 15) == 0;
  if (aligned && d % kVec == 0) {
    const int nv = ps * d / kVec;
    for (int i0 = lane; i0 < nv; i0 += 32 * kUnroll) {
      uint4 kr[kUnroll], vr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * 32;
        if (i < nv) {
          const int t = (kVec * i) / d, c = kVec * i - t * d;
          const long g = page_off + t * pos_stride + c;
          kr[u] = *reinterpret_cast<const uint4*>(kp + g);
          vr[u] = *reinterpret_cast<const uint4*>(vp + g);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * 32;
        if (i < nv) {
          const int t = (kVec * i) / d, c = kVec * i - t * d;
          unpack16(kr[u], kp, ks + t * ld + c);
          unpack16(vr[u], vp, vs + t * ld + c);
        }
      }
    }
    return;
  }
  const int n = ps * d;
  for (int i0 = lane; i0 < n; i0 += 32 * kUnroll) {
    float kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * 32;
      if (i < n) {
        const int t = i / d, c = i - t * d;
        const long g = page_off + t * pos_stride + c;
        kr[u] = to_f32(kp[g]);
        vr[u] = to_f32(vp[g]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * 32;
      if (i < n) {
        const int t = i / d, c = i - t * d;
        ks[t * ld + c] = kr[u];
        vs[t * ld + c] = vr[u];
      }
    }
  }
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ kp,
    const TKV* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ base, TQ* __restrict__ out, int w_rows, int heads,
    int d, int ps, int mpps, int pages, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  // per-warp region: K [ps, ld], V [ps, ld], scores [W, ps],
  // acc [W, D], m [W], l [W]
  const int warp_floats = 2 * ps * ld + w_rows * ps + w_rows * d + 2 * w_rows;
  float* qs = smem;  // [W, D] scaled query, shared by the warps
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* mine = qs + w_rows * d + warp * warp_floats;
  float* ks = mine;
  float* vs = ks + ps * ld;
  float* sc = vs + ps * ld;
  float* acc = sc + w_rows * ps;
  float* m = acc + w_rows * d;
  float* l = m + w_rows;

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const long pos_stride = static_cast<long>(heads) * d;  // one position
  const long head_off = static_cast<long>(h) * d;

  for (int i = tid; i < w_rows * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    qs[i] = to_f32(q[(static_cast<long>(s) * w_rows + r) * pos_stride +
                     head_off + c]) * scale;
  }
  for (int i = lane; i < w_rows * d; i += 32) acc[i] = 0.f;
  for (int r = lane; r < w_rows; r += 32) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
  }

  const int b = base[s];
  const int live = b + w_rows;  // positions 0 .. b + W - 1 may be visible
  const int n_pages = live <= 0 ? 0 : min((live + ps - 1) / ps, mpps);
  __syncthreads();

  for (int j = warp; j < n_pages; j += kWarps) {
    int page = table[static_cast<long>(s) * mpps + j];
    // an out-of-range id (never produced by the engine) reads the
    // parking page instead of memory outside the pool
    if (page < 0 || page >= pages) page = 0;
    load_page<TKV>(kp, vp, static_cast<long>(page) * ps * pos_stride + head_off,
                 pos_stride, ks, vs, ps, d, lane);
    __syncwarp();

    for (int i = lane; i < w_rows * ps; i += 32) {  // one lane per score
      const int r = i / ps, t = i - r * ps;
      float dot = -CUDART_INF_F;
      if (j * ps + t <= b + r) {
        const float* qr = qs + r * d;
        const float* kr = ks + t * ld;
        dot = 0.f;
        for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
      }
      sc[i] = dot;
    }
    __syncwarp();

    for (int r = 0; r < w_rows; ++r) {
      float* row = sc + r * ps;
      float mx = -CUDART_INF_F;
      for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, row[t]);
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      // m_new == -inf: nothing visible to this row yet; keep it empty
      const float a = (m_new == -CUDART_INF_F) ? 1.f : expf(m_old - m_new);
      float sum = 0.f;
      for (int t = lane; t < ps; t += 32) {
        const float p =
            (row[t] == -CUDART_INF_F) ? 0.f : expf(row[t] - m_new);
        row[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      __syncwarp();
      for (int c = lane; c < d; c += 32) {  // one lane per output dim
        float pv = 0.f;
        for (int t = 0; t < ps; ++t) pv = fmaf(row[t], vs[t * ld + c], pv);
        acc[r * d + c] = acc[r * d + c] * a + pv;
      }
      __syncwarp();
      if (lane == 0) {
        m[r] = m_new;
        l[r] = l[r] * a + sum;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // merge the warps' partial softmaxes
  const float* first = qs + w_rows * d;
  for (int i = tid; i < w_rows * d; i += blockDim.x) {
    const int r = i / d;
    float mx = -CUDART_INF_F;
    for (int w = 0; w < kWarps; ++w) {
      const float* wm = first + w * warp_floats + 2 * ps * ld + w_rows * ps +
                        w_rows * d;
      mx = fmaxf(mx, wm[r]);
    }
    float num = 0.f, den = 0.f;
    if (mx != -CUDART_INF_F) {
      for (int w = 0; w < kWarps; ++w) {
        const float* wacc = first + w * warp_floats + 2 * ps * ld +
                            w_rows * ps;
        const float* wm = wacc + w_rows * d;
        const float* wl = wm + w_rows;
        if (wm[r] == -CUDART_INF_F) continue;
        const float e = expf(wm[r] - mx);
        num = fmaf(wacc[i], e, num);
        den = fmaf(wl[r], e, den);
      }
    }
    const int c = i - r * d;
    store(out + (static_cast<long>(s) * w_rows + r) * pos_stride + head_off + c,
          den > 0.f ? num / den : 0.f);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* base, void* out, int slots, int w_rows, int heads,
           int d, int ps, int mpps, int pages, float scale, int smem_bytes,
           void* stream) {
  if (slots <= 0 || w_rows <= 0 || heads <= 0 || d <= 0 || ps <= 0 ||
      mpps <= 0 || pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<TQ, TKV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(slots, heads);
  paged_attention_kernel<TQ, TKV><<<grid, kThreads, smem_bytes,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), table, base, static_cast<TQ*>(out),
      w_rows, heads, d, ps, mpps, pages, scale);
  return static_cast<int>(cudaGetLastError());
}

// Picks the pools' type for a given query type (0 = float32, 1 = bf16).
template <typename TQ>
int launch_kv(int kv_dtype, const void* q, const void* kp, const void* vp,
              const int* table, const int* base, void* out, int slots,
              int w_rows, int heads, int d, int ps, int mpps, int pages,
              float scale, int smem_bytes, void* stream) {
  if (kv_dtype == 0)
    return launch<TQ, float>(q, kp, vp, table, base, out, slots, w_rows,
                             heads, d, ps, mpps, pages, scale, smem_bytes,
                             stream);
  if (kv_dtype == 1)
    return launch<TQ, __nv_bfloat16>(q, kp, vp, table, base, out, slots,
                                     w_rows, heads, d, ps, mpps, pages, scale,
                                     smem_bytes, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Shared memory the kernel needs, in bytes (the wrapper gates on it).
int p1t_paged_attention_smem_bytes(int w_rows, int d, int ps) {
  const int per_warp = 2 * ps * (d + 1) + w_rows * ps + w_rows * d +
                       2 * w_rows;
  return static_cast<int>(sizeof(float)) * (w_rows * d + kWarps * per_warp);
}

// q_dtype (q and out) and kv_dtype (both pools): 0 = float32,
// 1 = bfloat16. Returns a cudaError_t (0 = success).
int p1t_paged_attention(const void* q, const void* kp, const void* vp,
                        const int* table, const int* base, void* out,
                        int slots, int w_rows, int heads, int d, int ps,
                        int mpps, int pages, float scale, int q_dtype,
                        int kv_dtype, void* stream) {
  const int smem = p1t_paged_attention_smem_bytes(w_rows, d, ps);
  if (q_dtype == 0)
    return launch_kv<float>(kv_dtype, q, kp, vp, table, base, out, slots,
                            w_rows, heads, d, ps, mpps, pages, scale, smem,
                            stream);
  if (q_dtype == 1)
    return launch_kv<__nv_bfloat16>(kv_dtype, q, kp, vp, table, base, out,
                                    slots, w_rows, heads, d, ps, mpps, pages,
                                    scale, smem, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* p1t_paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
