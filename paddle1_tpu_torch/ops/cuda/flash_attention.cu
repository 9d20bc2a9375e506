// Flash-attention forward over the [B, N, H, D] layout.
//
// Replaces paddle1_tpu/ops/pallas/flash_attention.py::_fwd_kernel.
// Same contract: online softmax over key tiles, the scores never reach
// device memory; out = softmax(q k^T * scale) v computed in f32 and cast
// to the storage type at the edge, plus the per-row log-sum-exp (f32,
// [B, H, Nq]). Causal masking is bottom-right aligned (query i sees keys
// j <= i + Nk - Nq); an optional [B, Nk] keep-mask (1 byte per key, 0 =
// padding) drops keys. A row that sees no key gives out = 0 and
// LSE = -1e30, the sentinel the backward remaps to +inf.
//
// Bound on an H100: at the BERT shape ([128, 128, 12, 64] bf16) the
// 4*B*N*H*D bytes of q/k/v/out and 2*B*H*N*N*D*2 flops sit close to the
// card's balance point (~8 us either way). This first version computes
// on the CUDA cores in f32 (no mma/wgmma), so it is bound by its FMAs,
// far above that bound; tensor cores and TMA are later work.
//
// Design: one CTA of 256 threads (16 x 16) per (batch*head, q tile of BM
// rows). The q tile stays in shared memory; the CTA walks the key tiles
// (BM keys each), staging K and V as f32 rows padded to D + 1 floats so
// that the 16 threads of a half-warp, which own key columns
// tx, tx + 16, ..., read 16 different banks. Each thread owns BM/16 rows
// and BM/16 key columns of the score tile (rows ty + 16 i, columns
// tx + 16 j) and DMAX/16 output columns; row max and row sum reduce over
// the 16 lanes of a half-warp with shuffles. Under causal masking the
// walk stops at the last tile that holds a visible key.
//
// Built by paddle1_tpu_torch/ops/cuda/build.py with nvcc for sm_90a into
// a shared library with a plain C interface, loaded through ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr float kSentinel = -1e30f;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// rows [0, BM) of one head, starting at `src` (row stride `rs` elements),
// into dst[BM][ld] as f32, each value multiplied by `mul`
template <typename T, int BM>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long rs, int d, float mul) {
  for (int i = threadIdx.x; i < BM * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    dst[r * ld + c] = to_f32(src[r * rs + c]) * mul;
  }
}

template <typename T, int BM, int DC>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const unsigned char* __restrict__ keep,
    T* __restrict__ out, float* __restrict__ lse, int H, int Nq, int Nk,
    int D, float scale, int causal) {
  constexpr int R = BM / 16;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;                // [BM][ld], pre-scaled
  float* Ks = Qs + BM * ld;        // [BM][ld]
  float* Vs = Ks + BM * ld;        // [BM][ld]
  float* Ps = Vs + BM * ld;        // [BM][BM + 1]
  float* km = Ps + BM * (BM + 1);  // [BM] keep flags of the key tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * BM;
  const long rs = static_cast<long>(H) * D;
  const T* qb = q + (static_cast<long>(b) * Nq * H + h) * D;
  const T* kb = k + (static_cast<long>(b) * Nk * H + h) * D;
  const T* vb = v + (static_cast<long>(b) * Nk * H + h) * D;
  const int off = Nk - Nq;

  load_tile<T, BM>(Qs, ld, qb + q0 * rs, rs, D, scale);

  float m[R], l[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = Nk / BM;
  if (causal) n_tiles = min(n_tiles, (q0 + BM + off + BM - 1) / BM);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BM;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, BM>(Ks, ld, kb + k0 * rs, rs, D, 1.f);
    load_tile<T, BM>(Vs, ld, vb + k0 * rs, rs, D, 1.f);
    for (int i = tid; i < BM; i += kThreads)
      km[i] = keep ? (keep[static_cast<long>(b) * Nk + k0 + i] ? 1.f : 0.f)
                   : 1.f;
    __syncthreads();

    float s[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[R], kv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) qv[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < R; ++j) kv[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qg = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kc = tx + 16 * j;
        const bool ok = km[kc] > 0.5f && (!causal || k0 + kc <= qg + off);
        if (!ok) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mnew = fmaxf(m[i], mx);
      float alpha = 1.f;
      float rsum = 0.f;
      if (mnew == -INFINITY) {
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = 0.f;
      } else {
        alpha = expf(m[i] - mnew);  // m = -inf -> 0
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = expf(s[i][j] - mnew);  // masked (-inf) -> 0
          rsum += s[i][j];
        }
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
      m[i] = mnew;
      l[i] = l[i] * alpha + rsum;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < R; ++j)
        Ps[(ty + 16 * i) * (BM + 1) + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    for (int kk = 0; kk < BM; ++kk) {
      float pv[R], vv[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) pv[i] = Ps[(ty + 16 * i) * (BM + 1) + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int dc = tx + 16 * c;
        vv[c] = dc < D ? Vs[kk * ld + dc] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qg = q0 + ty + 16 * i;
    const bool vis = l[i] > 0.f;
    T* orow = out + ((static_cast<long>(b) * Nq + qg) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int dc = tx + 16 * c;
      if (dc < D) store(orow + dc, vis ? acc[i][c] / l[i] : 0.f);
    }
    if (tx == 0)
      lse[static_cast<long>(bh) * Nq + qg] =
          vis ? m[i] + logf(l[i]) : kSentinel;
  }
}

// dynamic shared memory of one CTA: Q, K, V tiles [BM][D + 1], the
// probability tile [BM][BM + 1] and the key tile's keep flags
template <int BM>
constexpr size_t smem_bytes(int d) {
  return sizeof(float) *
         (static_cast<size_t>(3 * BM) * (d + 1) + BM * (BM + 1) + BM);
}

template <typename T, int BM, int DC>
int launch(const void* q, const void* k, const void* v, const void* keep,
           void* out, void* lse, int B, int H, int Nq, int Nk, int D,
           float scale, int causal, cudaStream_t stream) {
  if (Nq % BM || Nk % BM || D > DC * 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_fwd_kernel<T, BM, DC>;
  // allow the bucket's largest footprint once, outside any graph capture
  static cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<BM>(DC * 16)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t smem = smem_bytes<BM>(D);
  dim3 grid(B * H, Nq / BM);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(keep),
      static_cast<T*>(out), static_cast<float*>(lse), H, Nq, Nk, D, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* keep,
             void* out, void* lse, int B, int H, int Nq, int Nk, int D,
             float scale, int causal, cudaStream_t s) {
  if (D <= 64)
    return launch<T, 64, 4>(q, k, v, keep, out, lse, B, H, Nq, Nk, D, scale,
                            causal, s);
  if (D <= 128)
    return launch<T, 64, 8>(q, k, v, keep, out, lse, B, H, Nq, Nk, D, scale,
                            causal, s);
  return launch<T, 32, 16>(q, k, v, keep, out, lse, B, H, Nq, Nk, D, scale,
                           causal, s);
}

}  // namespace

extern "C" {

// q: [B, Nq, H, D], k/v: [B, Nk, H, D], out like q, all contiguous in
// `dtype` (0 = float32, 1 = bfloat16); lse: [B, H, Nq] f32; keep: [B, Nk]
// bytes or NULL. Returns a cudaError_t (0 = success).
int p1t_flash_fwd(const void* q, const void* k, const void* v,
                  const void* keep, void* out, void* lse, int B, int H,
                  int Nq, int Nk, int D, float scale, int causal, int dtype,
                  void* stream) {
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || D <= 0 || D > 256 ||
      D % 8 || (causal && Nq > Nk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, keep, out, lse, B, H, Nq, Nk, D, scale,
                           causal, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, keep, out, lse, B, H, Nq, Nk, D,
                                   scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* p1t_flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
