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
// Bound on an H100: at the BERT shape the dkv pass moves q, k, v, dout
// in and dk, dv out (6 x 25 MB, 0.046 ms at 3.35 TB/s) for 8*D flops per
// visible (query, key) pair (0.013 ms at 989 TFLOP/s): bytes.
//
// dkv pass in bf16 (the training path): flash_bwd_dkv_tc_kernel, on the
// tensor cores. One CTA per (batch*head, key tile); each warp owns 16 keys
// (8 warps and 128 keys at D = 64, so that at N = 128 each Q/dO tile is
// fetched once per head; 4 warps and 64 keys above), its K and V rows
// resident in shared memory and read as m16n8k16 A fragments by ldmatrix
// (held in registers instead, they cost the occupancy that hides the
// loads). Q and dO tiles of 64 queries arrive in bf16, double-buffered by
// cp.async, rows padded by 8 bf16 for conflict-free ldmatrix, columns past
// D zero. Per 32-query sub-tile, all in registers, nothing written to
// shared memory: S^T = K Q^T and dP^T = V dO^T by mma.sync bf16 -> f32
// (exact products); P^T = exp(S^T scale - lse) masked; dS^T / scale =
// P^T (dP^T - delta); dV += P^T dO and dK += dS^T Q (the scale applied
// once at the end), the f32 left operands taken
// from the accumulators as A fragments split into bf16 hi + lo (both
// products issued, ~2^-17 relative), Q and dO as B fragments through
// ldmatrix.trans. At D = 256 two warps share a key row block, each
// accumulating half of the columns (S^T and dP^T computed by both).
// dK and dV are staged in bf16 through shared memory for 16-byte stores.
//
// dq pass in bf16: flash_bwd_dq_tc_kernel, the mirror of the dkv pass with
// queries in place of keys. One CTA per (batch*head, query tile); each warp
// owns 16 queries (8 warps and 128 queries at D = 64, so that at N = 128
// each K/V tile is fetched once per head; 4 warps and 64 queries above),
// its Q and dO rows resident in shared memory and read as A fragments by
// ldmatrix. K and V tiles of 64 keys (and their keep flags) arrive in bf16,
// double-buffered by cp.async, padded as above. A lane's two queries (rows
// g and g + 8 of its warp's block) keep their exp2 LSE offset and delta in
// registers. Per 64-key tile, all in registers (walked in 32-key halves,
// as the dkv pass walks its queries, it timed 3-10 % slower): S = Q K^T
// and dP = dO V^T by mma.sync, K and V as B fragments through ldmatrix;
// P = exp(S scale - lse) masked; dS / scale = P (dP - delta); dQ += dS K
// with dS split into bf16 hi + lo A fragments and K as B fragments
// through ldmatrix.trans; dQ times scale once at the end, staged in bf16
// through shared memory for 16-byte stores. At D = 256 two warps share a
// query row block, each accumulating half of dQ's columns. Bound at the
// BERT shape: q, k, v, dout in, dq out (5 x 25 MB, 0.038 ms at 3.35 TB/s)
// against 6*D flops per visible pair: bytes.
//
// f16 (the training path under auto_cast(dtype="float16")): both passes
// with T = __half, the m16n8k16 f16 -> f32 form of the product and P and
// dS split into f16 hi + lo. dS is not clamped: where it, or a dK/dV/dQ
// at the store, passes f16's 65504 it becomes inf, which GradScaler sees
// (an unscaled loss keeps dS far inside the range).
//
// f32 (the reference checks, not the training path): the first port's
// kernels on the CUDA cores. The layout of their tiles is the forward's
// f32 one: rows padded to D + 1 floats, 256 threads as 16 x 16, each
// thread owning BM/16 rows (ty + 16 i) and BM/16 columns (tx + 16 j) of a
// score tile and DMAX/16 of the D output columns (tx + 16 c).
//
// Built by paddle1_tpu_torch/ops/cuda/build.py with nvcc for sm_90a into
// a shared library with a plain C interface, loaded through ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

template <int BM>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src, long rs, int d) {
  for (int i = threadIdx.x; i < BM * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    dst[r * ld + c] = src[r * rs + c];
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

template <int BM, int DC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const unsigned char* __restrict__ keep, float* __restrict__ dk,
    float* __restrict__ dv, int H, int Nq, int Nk, int D, float scale,
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

  load_tile<BM>(Ks, ld, k + koff + k0 * rs, rs, D);
  load_tile<BM>(Vs, ld, v + koff + k0 * rs, rs, D);
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
    load_tile<BM>(Qs, ld, q + qoff + q0 * rs, rs, D);
    load_tile<BM>(Ds, ld, dout + qoff + q0 * rs, rs, D);
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
        dk[row + dc] = gk[i][c];
        dv[row + dc] = gv[i][c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the dkv pass in bf16 and f16 on the tensor cores

constexpr int kTcQueries = 64;  // queries of a tile
constexpr int kTcSub = 32;      // queries of a sub-tile, in registers
constexpr float kLog2e = 1.4426950408889634f;

// KEYS keys per CTA, in 16-key row blocks
template <int DP, int KEYS>
constexpr size_t dkv_tc_smem_bytes() {
  // K, V [KEYS][DP + 8] resident; Q and dO x 2 stages [64][DP + 8] bf16;
  // lse, delta x 2
  return sizeof(bf16) * (2 * KEYS + 4 * kTcQueries) * (DP + 8) +
         sizeof(float) * 4 * kTcQueries;
}

// DSPLIT: warps that share one 16-key row block, each accumulating
// DP / DSPLIT columns of dK and dV; MINB: CTAs an SM should hold, a floor
// on occupancy that caps registers; CAUSAL: compiled in, so the unmasked
// main path pays no compare
template <typename T, int DP, int KEYS, int DSPLIT, int MINB, bool CAUSAL>
__global__ void __launch_bounds__(2 * KEYS * DSPLIT, MINB)
    flash_bwd_dkv_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const unsigned char* __restrict__ keep, T* __restrict__ dk,
    T* __restrict__ dv, int H, int Nq, int Nk, int D, float scale) {
  using namespace p1t_mma;
  constexpr int NKB = KEYS / 16;    // key row blocks
  constexpr int LD = DP + 8;        // row pitch, elements
  constexpr int KT = DP / 16;       // k16 steps over D
  constexpr int DC = DP / DSPLIT;   // this warp's dK/dV columns
  constexpr int CT = DC / 8;        // n8 tiles of them
  constexpr int ST = kTcSub / 8;    // n8 tiles of a sub-tile's queries
  constexpr int NT = 32 * NKB * DSPLIT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [KEYS][LD] resident
  T* Vs = Ks + KEYS * LD;                     // [KEYS][LD] resident
  T* Qs = Vs + KEYS * LD;                     // [2][64][LD]
  T* Os = Qs + 2 * kTcQueries * LD;           // [2][64][LD] dout
  float* ls = reinterpret_cast<float*>(Os + 2 * kTcQueries * LD);  // [2][64]
  float* dl = ls + 2 * kTcQueries;                                 // [2][64]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
  const int kw = (warp % NKB) * 16;         // the warp's first key row
  const int dc0 = (warp / NKB) * DC;        // its first dK/dV column
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * KEYS;
  const long rs = static_cast<long>(H) * D;
  const long qoff = (static_cast<long>(b) * Nq * H + h) * D;
  const long koff = (static_cast<long>(b) * Nk * H + h) * D;
  const int off = Nk - Nq;
  const int cpr = D >> 3;  // 16-byte chunks of a row

  // columns [D, DP) of all six tiles stay zero
  if (D < DP) {
    const int pc = (DP - D) >> 3;
    for (int i = tid; i < (2 * KEYS + 4 * kTcQueries) * pc; i += NT) {
      const int r = i / pc;
      *reinterpret_cast<uint4*>(Ks + r * LD + (cpr + i - r * pc) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  auto load_rows = [&](T* dst, const T* src, int rows) {
    for (int i = tid; i < rows * cpr; i += NT) {
      const int r = i / cpr;
      const int c = i - r * cpr;
      cp_async16(dst + r * LD + c * 8, src + r * rs + c * 8);
    }
  };
  auto load_q = [&](int tile, int stage) {
    const long at = static_cast<long>(tile) * kTcQueries * rs;
    load_rows(Qs + stage * kTcQueries * LD, q + qoff + at, kTcQueries);
    load_rows(Os + stage * kTcQueries * LD, dout + qoff + at, kTcQueries);
    const long row = static_cast<long>(bh) * Nq + tile * kTcQueries;
    if (tid < kTcQueries / 4)
      cp_async16(ls + stage * kTcQueries + tid * 4, lse + row + tid * 4);
    else if (tid < kTcQueries / 2)
      cp_async16(dl + stage * kTcQueries + (tid - 16) * 4,
                 delta + row + (tid - 16) * 4);
  };

  int lo = 0;
  if (CAUSAL) lo = max((k0 - off) / kTcQueries, 0);
  const int hi = Nq / kTcQueries;
  load_rows(Ks, k + koff + k0 * rs, KEYS);
  load_rows(Vs, v + koff + k0 * rs, KEYS);
  if (lo < hi) load_q(lo, 0);
  cp_async_commit();

  // this lane's two keys (rows g and g + 8 of the warp's block)
  const int kr[2] = {k0 + kw + g, k0 + kw + g + 8};
  bool kept[2] = {true, true};
  if (keep) {
    kept[0] = keep[static_cast<long>(b) * Nk + kr[0]] != 0;
    kept[1] = keep[static_cast<long>(b) * Nk + kr[1]] != 0;
  }
  const float sl = scale * kLog2e;
  float gk[CT][4], gv[CT][4];
#pragma unroll
  for (int j = 0; j < CT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[j][e] = gv[j][e] = 0.f;

  for (int t = lo; t < hi; ++t) {
    const int st = (t - lo) & 1;
    if (t + 1 < hi) {
      load_q(t + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qt = Qs + st * kTcQueries * LD;
    const T* Ot = Os + st * kTcQueries * LD;
    float* lt = ls + st * kTcQueries;
    const float* dt = dl + st * kTcQueries;
    const int q0 = t * kTcQueries;
    // the tile's LSE as the exp2 offset -lse log2(e), the sentinel as -inf
    // (p = 0: a row that saw no key gets no gradient)
    if (tid < kTcQueries) {
      const float l = lt[tid];
      lt[tid] = l <= -1e29f ? -INFINITY : -l * kLog2e;
    }
    __syncthreads();

#pragma unroll 1
    for (int qs0 = 0; qs0 < kTcQueries; qs0 += kTcSub) {
      // under causal masking a sub-tile whose last query sees none of the
      // warp's keys adds nothing
      if (CAUSAL && k0 + kw > q0 + qs0 + kTcSub - 1 + off) continue;
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries
      float s[ST][4], dp[ST][4];
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t ak[4], av[4];
        const int at = (kw + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
        ldsm_x4(ak, Ks + at);
        ldsm_x4(av, Vs + at);
#pragma unroll
        for (int np = 0; np < ST / 2; ++np) {
          const int at = (qs0 + np * 16 + mr + ((mi >> 1) << 3)) * LD +
                         kk * 16 + ((mi & 1) << 3);
          uint32_t bq[4], bo[4];
          ldsm_x4(bq, Qt + at);
          ldsm_x4(bo, Ot + at);
          mma<T>(s[2 * np], ak, bq[0], bq[1]);
          mma<T>(s[2 * np + 1], ak, bq[2], bq[3]);
          mma<T>(dp[2 * np], av, bo[0], bo[1]);
          mma<T>(dp[2 * np + 1], av, bo[2], bo[3]);
        }
      }
      // P^T and dS^T / scale at (key kr[e / 2], query qs0 + 8 j + 2 t4 +
      // e % 2); the scale is applied to dK once, in the epilogue
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = qs0 + j * 8 + 2 * t4 + (e & 1);
          bool ok = kept[e >> 1];
          if (CAUSAL) ok = ok && kr[e >> 1] <= q0 + qc + off;
          const float p = ok ? exp2f(fmaf(s[j][e], sl, lt[qc])) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dt[qc]);
        }
      // dV += P^T dO, dK += dS^T Q over the sub-tile's queries
#pragma unroll
      for (int kb2 = 0; kb2 < ST / 2; ++kb2) {
        uint32_t ph[4], pl[4], sh[4], sm[4];
        c_to_a<T>(s[2 * kb2], s[2 * kb2 + 1], ph, pl);
        c_to_a<T>(dp[2 * kb2], dp[2 * kb2 + 1], sh, sm);
        // the hi products of every tile, then the lo ones, so that no
        // product waits on the one before it
#pragma unroll
        for (int cp = 0; cp < CT / 2; ++cp) {
          const int at = (qs0 + kb2 * 16 + mr + ((mi & 1) << 3)) * LD + dc0 +
                         cp * 16 + ((mi >> 1) << 3);
          uint32_t bo[4], bq[4];
          ldsm_x4_t(bo, Ot + at);
          ldsm_x4_t(bq, Qt + at);
          mma<T>(gv[2 * cp], ph, bo[0], bo[1]);
          mma<T>(gv[2 * cp + 1], ph, bo[2], bo[3]);
          mma<T>(gk[2 * cp], sh, bq[0], bq[1]);
          mma<T>(gk[2 * cp + 1], sh, bq[2], bq[3]);
          mma<T>(gv[2 * cp], pl, bo[0], bo[1]);
          mma<T>(gv[2 * cp + 1], pl, bo[2], bo[3]);
          mma<T>(gk[2 * cp], sm, bq[0], bq[1]);
          mma<T>(gk[2 * cp + 1], sm, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before its refill
  }

  // epilogue: dK and dV staged in T through the Q and dO tiles
  cp_async_wait<0>();
  __syncthreads();
  T* dKs = Qs;
  T* dVs = Os;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kw + g + 8 * r;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int c = dc0 + j * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(dKs + row * LD + c) =
          pack2<T>(gk[j][2 * r] * scale, gk[j][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dVs + row * LD + c) =
          pack2<T>(gv[j][2 * r], gv[j][2 * r + 1]);
    }
  }
  __syncthreads();
  for (int i = tid; i < KEYS * cpr; i += NT) {
    const int r = i / cpr;
    const int c = i - r * cpr;
    const long at = koff + (k0 + r) * rs + c * 8;
    *reinterpret_cast<uint4*>(dk + at) =
        *reinterpret_cast<const uint4*>(dKs + r * LD + c * 8);
    *reinterpret_cast<uint4*>(dv + at) =
        *reinterpret_cast<const uint4*>(dVs + r * LD + c * 8);
  }
}

// ---------------------------------------------------------------------------
// the dq pass in bf16 and f16 on the tensor cores

constexpr int kTcKeys = 64;  // keys of a K/V tile, in registers

// ROWS queries per CTA, in 16-query row blocks
template <int DP, int ROWS>
constexpr size_t dq_tc_smem_bytes() {
  // Q, dO [ROWS][DP + 8] resident; K and V x 2 stages [64][DP + 8] bf16;
  // keep flags x 2
  return sizeof(bf16) * (2 * ROWS + 4 * kTcKeys) * (DP + 8) + 2 * kTcKeys;
}

// DSPLIT: warps that share one 16-query row block, each accumulating
// DP / DSPLIT columns of dQ; MINB and CAUSAL as in the dkv pass
template <typename T, int DP, int ROWS, int DSPLIT, int MINB, bool CAUSAL>
__global__ void __launch_bounds__(2 * ROWS * DSPLIT, MINB)
    flash_bwd_dq_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const unsigned char* __restrict__ keep, T* __restrict__ dq, int H,
    int Nq, int Nk, int D, float scale) {
  using namespace p1t_mma;
  constexpr int NRB = ROWS / 16;    // query row blocks
  constexpr int LD = DP + 8;        // row pitch, elements
  constexpr int KT = DP / 16;       // k16 steps over D
  constexpr int DC = DP / DSPLIT;   // this warp's dQ columns
  constexpr int CT = DC / 8;        // n8 tiles of them
  constexpr int HT = kTcKeys / 8;   // n8 tiles of a tile's keys
  constexpr int NT = 32 * NRB * DSPLIT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [ROWS][LD] resident
  T* Os = Qs + ROWS * LD;                     // [ROWS][LD] resident dout
  T* Ks = Os + ROWS * LD;                     // [2][64][LD]
  T* Vs = Ks + 2 * kTcKeys * LD;              // [2][64][LD]
  unsigned char* km =
      reinterpret_cast<unsigned char*>(Vs + 2 * kTcKeys * LD);  // [2][64]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
  const int wr = (warp % NRB) * 16;         // the warp's first query row
  const int dc0 = (warp / NRB) * DC;        // its first dQ column
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * ROWS;
  const long rs = static_cast<long>(H) * D;
  const long qoff = (static_cast<long>(b) * Nq * H + h) * D;
  const long koff = (static_cast<long>(b) * Nk * H + h) * D;
  const unsigned char* keepb = keep ? keep + static_cast<long>(b) * Nk
                                    : nullptr;
  const int off = Nk - Nq;
  const int cpr = D >> 3;  // 16-byte chunks of a row

  // columns [D, DP) of all six tiles stay zero
  if (D < DP) {
    const int pc = (DP - D) >> 3;
    for (int i = tid; i < (2 * ROWS + 4 * kTcKeys) * pc; i += NT) {
      const int r = i / pc;
      *reinterpret_cast<uint4*>(Qs + r * LD + (cpr + i - r * pc) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  auto load_rows = [&](T* dst, const T* src, int rows) {
    for (int i = tid; i < rows * cpr; i += NT) {
      const int r = i / cpr;
      const int c = i - r * cpr;
      cp_async16(dst + r * LD + c * 8, src + r * rs + c * 8);
    }
  };
  auto load_kv = [&](int tile, int stage) {
    const long at = static_cast<long>(tile) * kTcKeys * rs;
    load_rows(Ks + stage * kTcKeys * LD, k + koff + at, kTcKeys);
    load_rows(Vs + stage * kTcKeys * LD, v + koff + at, kTcKeys);
    if (keepb && tid < kTcKeys / 16)
      cp_async16(km + stage * kTcKeys + tid * 16,
                 keepb + tile * kTcKeys + tid * 16);
  };

  int n_tiles = Nk / kTcKeys;
  if (CAUSAL)
    n_tiles = min(n_tiles, (q0 + ROWS + off + kTcKeys - 1) / kTcKeys);
  load_rows(Qs, q + qoff + q0 * rs, ROWS);
  load_rows(Os, dout + qoff + q0 * rs, ROWS);
  load_kv(0, 0);
  cp_async_commit();

  // this lane's two queries (rows g and g + 8 of the warp's block): the
  // exp2 offset -lse log2(e), the sentinel as -inf (p = 0: a row that saw
  // no key gets no gradient), and delta
  const float sl = scale * kLog2e;
  const int qr[2] = {q0 + wr + g, q0 + wr + g + 8};
  float lo2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long at = static_cast<long>(bh) * Nq + qr[r];
    const float l = lse[at];
    lo2[r] = l <= -1e29f ? -INFINITY : -l * kLog2e;
    dl[r] = delta[at];
  }
  float acc[CT][4];
#pragma unroll
  for (int j = 0; j < CT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      load_kv(t + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + st * kTcKeys * LD;
    const T* Vt = Vs + st * kTcKeys * LD;
    const unsigned char* kmt = km + st * kTcKeys;
    const int k0 = t * kTcKeys;

    // under causal masking a tile whose first key none of the warp's
    // queries sees adds nothing
    if (!CAUSAL || k0 <= q0 + wr + 15 + off) {
      // S = Q K^T and dP = dO V^T: 16 queries x 64 keys
      float s[HT][4], dp[HT][4];
#pragma unroll
      for (int j = 0; j < HT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t aq[4], ao[4];
        const int at = (wr + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
        ldsm_x4(aq, Qs + at);
        ldsm_x4(ao, Os + at);
#pragma unroll
        for (int np = 0; np < HT / 2; ++np) {
          const int bt = (np * 16 + mr + ((mi >> 1) << 3)) * LD +
                         kk * 16 + ((mi & 1) << 3);
          uint32_t bk[4], bv[4];
          ldsm_x4(bk, Kt + bt);
          ldsm_x4(bv, Vt + bt);
          mma<T>(s[2 * np], aq, bk[0], bk[1]);
          mma<T>(s[2 * np + 1], aq, bk[2], bk[3]);
          mma<T>(dp[2 * np], ao, bv[0], bv[1]);
          mma<T>(dp[2 * np + 1], ao, bv[2], bv[3]);
        }
      }
      // dS / scale = P (dP - delta) at (query qr[e / 2], key k0 + 8 j +
      // 2 t4 + e % 2); a lane's two keys of an n8 tile are adjacent: one
      // 2-byte flag load
#pragma unroll
      for (int j = 0; j < HT; ++j) {
        const int kc = j * 8 + 2 * t4;
        const unsigned short kept =
            keepb ? *reinterpret_cast<const unsigned short*>(kmt + kc)
                  : static_cast<unsigned short>(0x0101);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool ok = (kept >> (8 * (e & 1))) & 0xff;
          if (CAUSAL) ok = ok && k0 + kc + (e & 1) <= qr[e >> 1] + off;
          const float p =
              ok ? exp2f(fmaf(s[j][e], sl, lo2[e >> 1])) : 0.f;
          dp[j][e] = p * (dp[j][e] - dl[e >> 1]);
        }
      }
      // dQ += dS K over the tile's keys: the hi products of every
      // column tile, then the lo ones, so that no product waits on the one
      // before it
#pragma unroll
      for (int kb2 = 0; kb2 < HT / 2; ++kb2) {
        uint32_t sh[4], sm[4], bk[CT / 2][4];
        c_to_a<T>(dp[2 * kb2], dp[2 * kb2 + 1], sh, sm);
#pragma unroll
        for (int cp = 0; cp < CT / 2; ++cp)
          ldsm_x4_t(bk[cp], Kt + (kb2 * 16 + mr + ((mi & 1) << 3)) * LD +
                                dc0 + cp * 16 + ((mi >> 1) << 3));
#pragma unroll
        for (int cp = 0; cp < CT / 2; ++cp) {
          mma<T>(acc[2 * cp], sh, bk[cp][0], bk[cp][1]);
          mma<T>(acc[2 * cp + 1], sh, bk[cp][2], bk[cp][3]);
        }
#pragma unroll
        for (int cp = 0; cp < CT / 2; ++cp) {
          mma<T>(acc[2 * cp], sm, bk[cp][0], bk[cp][1]);
          mma<T>(acc[2 * cp + 1], sm, bk[cp][2], bk[cp][3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before its refill
  }

  // epilogue: dQ times scale, staged in T through the Q tile
  cp_async_wait<0>();
  __syncthreads();
  T* dQs = Qs;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr + g + 8 * r;
#pragma unroll
    for (int j = 0; j < CT; ++j)
      *reinterpret_cast<uint32_t*>(dQs + row * LD + dc0 + j * 8 + 2 * t4) =
          pack2<T>(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
  }
  __syncthreads();
  for (int i = tid; i < ROWS * cpr; i += NT) {
    const int r = i / cpr;
    const int c = i - r * cpr;
    *reinterpret_cast<uint4*>(dq + qoff + (q0 + r) * rs + c * 8) =
        *reinterpret_cast<const uint4*>(dQs + r * LD + c * 8);
  }
}

// ---------------------------------------------------------------------------
// f32: the dkv and dq passes on the CUDA cores

template <int BM, int DC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const unsigned char* __restrict__ keep, float* __restrict__ dq, int H,
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

  load_tile<BM>(Qs, ld, q + qoff + q0 * rs, rs, D);
  load_tile<BM>(Ds, ld, dout + qoff + q0 * rs, rs, D);
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
    load_tile<BM>(Ks, ld, k + koff + k0 * rs, rs, D);
    load_tile<BM>(Vs, ld, v + koff + k0 * rs, rs, D);
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
      if (dc < D) dq[row + dc] = gq[i][c];
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

template <int BM, int DC>
int launch_dkv(const Args& a, cudaStream_t s) {
  if (a.Nq % BM || a.Nk % BM) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_bwd_dkv_kernel<BM, DC>;
  // allow the bucket's largest footprint once, outside any graph capture
  static cudaError_t attr = allow_smem(kern, smem_bytes<BM>(DC * 16, 2));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t smem = smem_bytes<BM>(a.D, 2);
  kern<<<dim3(a.B * a.H, a.Nk / BM), kThreads, smem, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const unsigned char*>(a.keep), static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.H, a.Nq, a.Nk, a.D, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int DC>
int launch_dq(const Args& a, cudaStream_t s) {
  if (a.Nq % BM || a.Nk % BM) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_bwd_dq_kernel<BM, DC>;
  // allow the bucket's largest footprint once, outside any graph capture
  static cudaError_t attr = allow_smem(kern, smem_bytes<BM>(DC * 16, 1));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t smem = smem_bytes<BM>(a.D, 1);
  kern<<<dim3(a.B * a.H, a.Nq / BM), kThreads, smem, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const unsigned char*>(a.keep), static_cast<float*>(a.dq),
      a.H, a.Nq, a.Nk, a.D, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP, int KEYS, int DSPLIT, int MINB, bool CAUSAL>
int launch_dkv_tc(const Args& a, cudaStream_t s) {
  if (a.Nq % kTcQueries || a.Nk % KEYS || a.D > DP)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_bwd_dkv_tc_kernel<T, DP, KEYS, DSPLIT, MINB, CAUSAL>;
  constexpr size_t smem = dkv_tc_smem_bytes<DP, KEYS>();
  // allow the bucket's footprint once, outside any graph capture
  static cudaError_t attr = allow_smem(kern, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kern<<<dim3(a.B * a.H, a.Nk / KEYS), 2 * KEYS * DSPLIT, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const unsigned char*>(a.keep), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.H, a.Nq, a.Nk, a.D, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP, int ROWS, int DSPLIT, int MINB, bool CAUSAL>
int launch_dq_tc(const Args& a, cudaStream_t s) {
  if (a.Nq % ROWS || a.Nk % kTcKeys || a.D > DP)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_bwd_dq_tc_kernel<T, DP, ROWS, DSPLIT, MINB, CAUSAL>;
  constexpr size_t smem = dq_tc_smem_bytes<DP, ROWS>();
  // allow the bucket's footprint once, outside any graph capture
  static cudaError_t attr = allow_smem(kern, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kern<<<dim3(a.B * a.H, a.Nq / ROWS), 2 * ROWS * DSPLIT, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const unsigned char*>(a.keep), static_cast<T*>(a.dq),
      a.H, a.Nq, a.Nk, a.D, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// the buckets: at D = 64, 8 warps (128 keys, so each Q/dO tile is fetched
// once per head at N = 128) with registers capped at 128 for 2 CTAs an SM;
// at 128, 4 warps; at 256, two warps share a key row block
template <typename T, bool CAUSAL>
int dispatch_dkv_tc(const Args& a, cudaStream_t s) {
  if (a.D <= 64) return launch_dkv_tc<T, 64, 128, 1, 2, CAUSAL>(a, s);
  if (a.D <= 128) return launch_dkv_tc<T, 128, 64, 1, 1, CAUSAL>(a, s);
  return launch_dkv_tc<T, 256, 64, 2, 1, CAUSAL>(a, s);
}

// the same buckets over queries
template <typename T, bool CAUSAL>
int dispatch_dq_tc(const Args& a, cudaStream_t s) {
  if (a.D <= 64) return launch_dq_tc<T, 64, 128, 1, 2, CAUSAL>(a, s);
  if (a.D <= 128) return launch_dq_tc<T, 128, 64, 1, 2, CAUSAL>(a, s);
  return launch_dq_tc<T, 256, 64, 2, 1, CAUSAL>(a, s);
}

template <typename T>
int run_tc(const Args& a, int which, cudaStream_t s) {
  if (which == 0)
    return a.causal ? dispatch_dkv_tc<T, true>(a, s)
                    : dispatch_dkv_tc<T, false>(a, s);
  return a.causal ? dispatch_dq_tc<T, true>(a, s)
                  : dispatch_dq_tc<T, false>(a, s);
}

int dispatch_dkv_f32(const Args& a, cudaStream_t s) {
  if (a.D <= 64) return launch_dkv<64, 4>(a, s);
  if (a.D <= 128) return launch_dkv<64, 8>(a, s);
  return launch_dkv<32, 16>(a, s);
}

int dispatch_dq_f32(const Args& a, cudaStream_t s) {
  if (a.D <= 64) return launch_dq<64, 4>(a, s);
  if (a.D <= 128) return launch_dq<64, 8>(a, s);
  return launch_dq<32, 16>(a, s);
}

// which: 0 = the dK/dV pass, 1 = the dQ pass
int run(const Args& a, int which, int dtype, void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.Nq <= 0 || a.Nk <= 0 || a.D <= 0 ||
      a.D > 256 || a.D % 8 || (a.causal && a.Nq > a.Nk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return which == 0 ? dispatch_dkv_f32(a, s) : dispatch_dq_f32(a, s);
  if (dtype == 1) return run_tc<bf16>(a, which, s);
  if (dtype == 2) return run_tc<__half>(a, which, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q/dout: [B, Nq, H, D], k/v: [B, Nk, H, D], contiguous in `dtype`
// (0 = float32, 1 = bfloat16, 2 = float16); lse/delta: [B, H, Nq] f32;
// keep: [B, Nk] bytes or NULL; lse and delta 16-byte aligned for the 16-bit
// types; dk/dv like k.
// Returns a cudaError_t (0 = success).
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
