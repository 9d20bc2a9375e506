// Flash-attention backward, the FlashAttention-2 split, over [B, N, H, D].
//
// Replaces paddle1_tpu/ops/pallas/flash_attention_bwd.py::_dkv_kernel and
// ::_dq_kernel. Same contract: probabilities are recomputed from the
// forward's LSE, p = exp(q.k * scale - lse), and never reach device
// memory; delta = rowsum(dout * out) comes in precomputed ([B, H, Nq] f32,
// as the JAX package computes it outside Pallas). An LSE at or below
// -1e29 (the forward's sentinel for a row that saw no key) is remapped to
// +inf, so such rows get an exact zero gradient. Masks as in the forward:
// bottom-right causal and an optional [B, Nk] keep-mask.
//
//   dkv pass: one CTA per (batch*head, key tile); K and V stay resident
//     while the CTA walks the query tiles (under causal masking from the
//     first tile that can see the key tile): dV += P^T dO,
//     dS = P * (dO V^T - delta) * scale, dK += dS^T Q.
//   dq pass:  one CTA per (batch*head, query tile); Q, dO, LSE and delta
//     stay resident while the CTA walks the key tiles (under causal
//     masking up to the last visible one): dQ += dS K.
//
// Bound on an H100: like the forward, ~2.5x its bytes and flops; this
// first version computes in f32 on the CUDA cores (no mma/wgmma), so it
// is bound by its FMAs. The layout of the tiles is the forward's: f32
// rows padded to D + 1 floats, 256 threads as 16 x 16, each thread owning
// BM/16 rows (ty + 16 i) and BM/16 columns (tx + 16 j) of a score tile
// and DMAX/16 of the D output columns (tx + 16 c).
//
// Built by paddle1_tpu_torch/ops/cuda/build.py with nvcc for sm_90a into
// a shared library with a plain C interface, loaded through ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int BM>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long rs, int d) {
  for (int i = threadIdx.x; i < BM * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    dst[r * ld + c] = to_f32(src[r * rs + c]);
  }
}

// per-row lse (sentinel -> +inf) and delta of rows [q0, q0 + BM)
template <int BM>
__device__ __forceinline__ void load_rows(float* ls, float* dl,
                                          const float* lse,
                                          const float* delta) {
  for (int i = threadIdx.x; i < BM; i += kThreads) {
    const float v = lse[i];
    ls[i] = v <= -1e29f ? INFINITY : v;
    dl[i] = delta[i];
  }
}

template <int BM>
__device__ __forceinline__ void load_keep(float* km, const unsigned char* keep,
                                          long at) {
  for (int i = threadIdx.x; i < BM; i += kThreads)
    km[i] = keep ? (keep[at + i] ? 1.f : 0.f) : 1.f;
}

template <typename T, int BM, int DC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const unsigned char* __restrict__ keep, T* __restrict__ dk,
    T* __restrict__ dv, int H, int Nq, int Nk, int D, float scale,
    int causal) {
  constexpr int R = BM / 16;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Ks = smem;                // [BM][ld] resident
  float* Vs = Ks + BM * ld;        // [BM][ld] resident
  float* Qs = Vs + BM * ld;        // [BM][ld]
  float* Ds = Qs + BM * ld;        // [BM][ld] dout
  float* Pt = Ds + BM * ld;        // [BM keys][BM + 1]
  float* St = Pt + BM * (BM + 1);  // [BM keys][BM + 1] dS^T
  float* ls = St + BM * (BM + 1);  // [BM]
  float* dl = ls + BM;             // [BM]
  float* km = dl + BM;             // [BM]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * BM;
  const long rs = static_cast<long>(H) * D;
  const long qoff = (static_cast<long>(b) * Nq * H + h) * D;
  const long koff = (static_cast<long>(b) * Nk * H + h) * D;
  const int off = Nk - Nq;

  load_tile<T, BM>(Ks, ld, k + koff + k0 * rs, rs, D);
  load_tile<T, BM>(Vs, ld, v + koff + k0 * rs, rs, D);
  load_keep<BM>(km, keep, static_cast<long>(b) * Nk + k0);

  float gk[R][DC], gv[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) gk[i][c] = gv[i][c] = 0.f;

  int lo = 0;
  if (causal) lo = max((k0 - off) / BM, 0);
  for (int t = lo; t < Nq / BM; ++t) {
    const int q0 = t * BM;
    __syncthreads();
    load_tile<T, BM>(Qs, ld, q + qoff + q0 * rs, rs, D);
    load_tile<T, BM>(Ds, ld, dout + qoff + q0 * rs, rs, D);
    load_rows<BM>(ls, dl, lse + static_cast<long>(bh) * Nq + q0,
                  delta + static_cast<long>(bh) * Nq + q0);
    __syncthreads();

    // key rows ty + 16 i, query columns tx + 16 j
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kv[R], vv[R], qv[R], ov[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        kv[i] = Ks[(ty + 16 * i) * ld + d];
        vv[i] = Vs[(ty + 16 * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        qv[j] = Qs[(tx + 16 * j) * ld + d];
        ov[j] = Ds[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int kr = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int qc = tx + 16 * j;
        const bool ok =
            km[kr] > 0.5f && (!causal || k0 + kr <= q0 + qc + off);
        const float p = ok ? expf(s[i][j] * scale - ls[qc]) : 0.f;
        Pt[kr * (BM + 1) + qc] = p;
        St[kr * (BM + 1) + qc] = p * (dp[i][j] - dl[qc]) * scale;
      }
    }
    __syncthreads();

    for (int qq = 0; qq < BM; ++qq) {
      float pv[R], sv[R], ov[DC], qv[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pv[i] = Pt[(ty + 16 * i) * (BM + 1) + qq];
        sv[i] = St[(ty + 16 * i) * (BM + 1) + qq];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int dc = tx + 16 * c;
        ov[c] = dc < D ? Ds[qq * ld + dc] : 0.f;
        qv[c] = dc < D ? Qs[qq * ld + dc] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          gv[i][c] = fmaf(pv[i], ov[c], gv[i][c]);
          gk[i][c] = fmaf(sv[i], qv[c], gk[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long row = koff + (k0 + ty + 16 * i) * rs;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int dc = tx + 16 * c;
      if (dc < D) {
        store(dk + row + dc, gk[i][c]);
        store(dv + row + dc, gv[i][c]);
      }
    }
  }
}

template <typename T, int BM, int DC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const unsigned char* __restrict__ keep, T* __restrict__ dq, int H,
    int Nq, int Nk, int D, float scale, int causal) {
  constexpr int R = BM / 16;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;                // [BM][ld] resident
  float* Ds = Qs + BM * ld;        // [BM][ld] resident dout
  float* Ks = Ds + BM * ld;        // [BM][ld]
  float* Vs = Ks + BM * ld;        // [BM][ld]
  float* Ss = Vs + BM * ld;        // [BM queries][BM + 1] dS
  float* ls = Ss + BM * (BM + 1);  // [BM]
  float* dl = ls + BM;             // [BM]
  float* km = dl + BM;             // [BM]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * BM;
  const long rs = static_cast<long>(H) * D;
  const long qoff = (static_cast<long>(b) * Nq * H + h) * D;
  const long koff = (static_cast<long>(b) * Nk * H + h) * D;
  const int off = Nk - Nq;

  load_tile<T, BM>(Qs, ld, q + qoff + q0 * rs, rs, D);
  load_tile<T, BM>(Ds, ld, dout + qoff + q0 * rs, rs, D);
  load_rows<BM>(ls, dl, lse + static_cast<long>(bh) * Nq + q0,
                delta + static_cast<long>(bh) * Nq + q0);

  float gq[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) gq[i][c] = 0.f;

  int hi = Nk / BM;
  if (causal) hi = min(hi, (q0 + BM + off + BM - 1) / BM);
  for (int t = 0; t < hi; ++t) {
    const int k0 = t * BM;
    __syncthreads();
    load_tile<T, BM>(Ks, ld, k + koff + k0 * rs, rs, D);
    load_tile<T, BM>(Vs, ld, v + koff + k0 * rs, rs, D);
    load_keep<BM>(km, keep, static_cast<long>(b) * Nk + k0);
    __syncthreads();

    // query rows ty + 16 i, key columns tx + 16 j
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[R], ov[R], kv[R], vv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = Qs[(ty + 16 * i) * ld + d];
        ov[i] = Ds[(ty + 16 * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        kv[j] = Ks[(tx + 16 * j) * ld + d];
        vv[j] = Vs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qr = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kc = tx + 16 * j;
        const bool ok =
            km[kc] > 0.5f && (!causal || k0 + kc <= q0 + qr + off);
        const float p = ok ? expf(s[i][j] * scale - ls[qr]) : 0.f;
        Ss[qr * (BM + 1) + kc] = p * (dp[i][j] - dl[qr]) * scale;
      }
    }
    __syncthreads();

    for (int kk = 0; kk < BM; ++kk) {
      float sv[R], kv[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) sv[i] = Ss[(ty + 16 * i) * (BM + 1) + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int dc = tx + 16 * c;
        kv[c] = dc < D ? Ks[kk * ld + dc] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) gq[i][c] = fmaf(sv[i], kv[c], gq[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long row = qoff + (q0 + ty + 16 * i) * rs;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int dc = tx + 16 * c;
      if (dc < D) store(dq + row + dc, gq[i][c]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *keep;
  void *dq, *dk, *dv;
  int B, H, Nq, Nk, D;
  float scale;
  int causal;
};

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// dynamic shared memory of one CTA: four [BM][D + 1] tiles, `n_prob`
// [BM][BM + 1] tiles (P^T and dS^T in the dK/dV pass, dS in the dQ pass)
// and three [BM] row vectors
template <int BM>
constexpr size_t smem_bytes(int d, int n_prob) {
  return sizeof(float) * (static_cast<size_t>(4 * BM) * (d + 1) +
                          n_prob * BM * (BM + 1) + 3 * BM);
}

template <typename T, int BM, int DC>
int launch_dkv(const Args& a, cudaStream_t s) {
  if (a.Nq % BM || a.Nk % BM) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_bwd_dkv_kernel<T, BM, DC>;
  // allow the bucket's largest footprint once, outside any graph capture
  static cudaError_t attr = allow_smem(kern, smem_bytes<BM>(DC * 16, 2));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t smem = smem_bytes<BM>(a.D, 2);
  kern<<<dim3(a.B * a.H, a.Nk / BM), kThreads, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const unsigned char*>(a.keep), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.H, a.Nq, a.Nk, a.D, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BM, int DC>
int launch_dq(const Args& a, cudaStream_t s) {
  if (a.Nq % BM || a.Nk % BM) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_bwd_dq_kernel<T, BM, DC>;
  // allow the bucket's largest footprint once, outside any graph capture
  static cudaError_t attr = allow_smem(kern, smem_bytes<BM>(DC * 16, 1));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t smem = smem_bytes<BM>(a.D, 1);
  kern<<<dim3(a.B * a.H, a.Nq / BM), kThreads, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const unsigned char*>(a.keep), static_cast<T*>(a.dq), a.H,
      a.Nq, a.Nk, a.D, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

// which: 0 = the dK/dV pass, 1 = the dQ pass
template <typename T>
int dispatch(const Args& a, int which, cudaStream_t s) {
  if (a.D <= 64)
    return which == 0 ? launch_dkv<T, 64, 4>(a, s) : launch_dq<T, 64, 4>(a, s);
  if (a.D <= 128)
    return which == 0 ? launch_dkv<T, 64, 8>(a, s) : launch_dq<T, 64, 8>(a, s);
  return which == 0 ? launch_dkv<T, 32, 16>(a, s) : launch_dq<T, 32, 16>(a, s);
}

int run(const Args& a, int which, int dtype, void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.Nq <= 0 || a.Nk <= 0 || a.D <= 0 ||
      a.D > 256 || a.D % 8 || (a.causal && a.Nq > a.Nk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, which, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, which, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q/dout: [B, Nq, H, D], k/v: [B, Nk, H, D], contiguous in `dtype`
// (0 = float32, 1 = bfloat16); lse/delta: [B, H, Nq] f32; keep: [B, Nk]
// bytes or NULL; dk/dv like k. Returns a cudaError_t (0 = success).
int p1t_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* keep, void* dk, void* dv, int B, int H,
                      int Nq, int Nk, int D, float scale, int causal,
                      int dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, keep, nullptr, dk, dv,
         B, H, Nq, Nk, D, scale, causal};
  return run(a, 0, dtype, stream);
}

// the dQ pass; dq like q
int p1t_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* keep, void* dq, int B, int H, int Nq,
                     int Nk, int D, float scale, int causal, int dtype,
                     void* stream) {
  Args a{q, k, v, dout, lse, delta, keep, dq, nullptr, nullptr,
         B, H, Nq, Nk, D, scale, causal};
  return run(a, 1, dtype, stream);
}

const char* p1t_flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
