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
// 4*B*N*H*D*2 bytes of q/k/v/out (100 MB, 0.030 ms at 3.35 TB/s) outweigh
// the 4*B*H*N*N*D flops (6.4 GFLOP, 0.0065 ms at 989 TFLOP/s): bytes.
//
// bf16 (the training path): flash_fwd_tc_kernel, on the tensor cores. One
// CTA per (batch*head, query tile) of 8 warps (128 rows, so that at N = 128
// each K/V tile is fetched once per head) at D = 64, 4 warps above; each
// warp owns 16 query rows, whose Q stays in registers as m16n8k16 A
// fragments (loaded once by ldmatrix; from shared memory per use at
// D = 256, where registers run out). K and V tiles of 64 keys arrive in
// bf16, double-buffered in shared memory by cp.async 16-byte copies, rows
// padded by 8 bf16 so that ldmatrix is free of bank conflicts; columns
// past D are zero (D buckets 64, 128, 256). S = Q K^T by mma.sync bf16 ->
// f32 (bf16 products are exact in f32); masks and the online softmax run
// in registers at fragment coordinates, row max and sum over the 4 lanes
// of a quad. O += P V takes P straight from the S accumulators as A
// fragments, V through ldmatrix.trans; P is split into bf16 hi + lo and
// both products issued, so P V stays within ~2^-17 of the f32 product
// (one bf16 rounding of P, as FlashAttention-2 does, would cost 2^-9). O
// is staged through shared memory for 16-byte coalesced stores. Per key
// tile and warp: D/16 x 8 MMAs for S, D/8 x 8 for P V, against 16 KB of
// tile loads: the kernel stays a bytes kernel.
//
// f16 (the training path under auto_cast(dtype="float16")): the same
// kernel with T = __half, the m16n8k16 f16 -> f32 form of the product
// (f16 products are exact in f32 too) and P split into f16 hi + lo (~2^-22
// relative); only the edges round, O to f16 at the store, where a value
// past 65504 becomes inf as in the plain version's cast: nothing is
// clamped, so an overflow reaches GradScaler.
//
// f32 (the reference checks, not the training path): flash_fwd_kernel
// on the CUDA cores. One CTA of 256 threads (16 x 16) per (batch*head, q
// tile of BM rows); f32 tiles in shared memory padded to D + 1 floats;
// each thread owns BM/16 rows and BM/16 key columns of the score tile
// (rows ty + 16 i, columns tx + 16 j) and DMAX/16 output columns; row max
// and row sum reduce over the 16 lanes of a half-warp with shuffles.
// Under causal masking either kernel stops at the last key tile that
// holds a visible key.
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

constexpr float kSentinel = -1e30f;
constexpr int kThreads = 256;


// rows [0, BM) of one head, starting at `src` (row stride `rs` elements),
// into dst[BM][ld] as f32, each value multiplied by `mul`
template <typename T, int BM>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long rs, int d, float mul) {
  for (int i = threadIdx.x; i < BM * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    dst[r * ld + c] = src[r * rs + c] * mul;
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
      if (dc < D) orow[dc] = vis ? acc[i][c] / l[i] : 0.f;
    }
    if (tx == 0)
      lse[static_cast<long>(bh) * Nq + qg] =
          vis ? m[i] + logf(l[i]) : kSentinel;
  }
}

// ---------------------------------------------------------------------------
// bf16 and f16 on the tensor cores

constexpr int kTcKeys = 64;  // keys of a tile
constexpr float kLog2e = 1.4426950408889634f;

// NW warps of 16 query rows each per CTA
template <int DP, int NW>
constexpr size_t tc_smem_bytes() {
  // Q tile [16 NW][DP + 8], K and V tiles x 2 stages [64][DP + 8] bf16;
  // keep flags x 2
  return sizeof(bf16) * (16 * NW + 4 * kTcKeys) * (DP + 8) + 2 * kTcKeys;
}

// MINB: CTAs an SM should hold, a floor on occupancy that caps registers;
// CAUSAL: compiled in, so the unmasked main path pays no compare
template <typename T, int DP, bool kQRegs, int NW, int MINB, bool CAUSAL>
__global__ void __launch_bounds__(32 * NW, MINB) flash_fwd_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const unsigned char* __restrict__ keep,
    T* __restrict__ out, float* __restrict__ lse, int H, int Nq, int Nk,
    int D, float scale) {
  using namespace p1t_mma;
  constexpr int ROWS = 16 * NW;  // query rows of the CTA
  constexpr int LD = DP + 8;     // row pitch, elements
  constexpr int KT = DP / 16;    // k16 steps over D
  constexpr int DT = DP / 8;     // n8 tiles over D
  constexpr int NT = 32 * NW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [ROWS][LD]
  T* Ks = Qs + ROWS * LD;                     // [2][64][LD]
  T* Vs = Ks + 2 * kTcKeys * LD;              // [2][64][LD]
  unsigned char* km =
      reinterpret_cast<unsigned char*>(Vs + 2 * kTcKeys * LD);  // [2][64]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * ROWS;
  const long rs = static_cast<long>(H) * D;
  const T* qb = q + (static_cast<long>(b) * Nq * H + h) * D;
  const T* kb = k + (static_cast<long>(b) * Nk * H + h) * D;
  const T* vb = v + (static_cast<long>(b) * Nk * H + h) * D;
  T* ob = out + (static_cast<long>(b) * Nq * H + h) * D;
  const unsigned char* keepb = keep ? keep + static_cast<long>(b) * Nk
                                    : nullptr;
  const int off = Nk - Nq;
  const int cpr = D >> 3;  // 16-byte chunks of a row

  // columns [D, DP) of all five tiles stay zero: the copies never write
  // there, and zero Q and K columns add nothing to S
  if (D < DP) {
    const int pc = (DP - D) >> 3;
    for (int i = tid; i < (ROWS + 4 * kTcKeys) * pc; i += NT) {
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
    load_rows(Ks + stage * kTcKeys * LD, kb + at, kTcKeys);
    load_rows(Vs + stage * kTcKeys * LD, vb + at, kTcKeys);
    if (keepb && tid < kTcKeys / 16)
      cp_async16(km + stage * kTcKeys + tid * 16,
                 keepb + tile * kTcKeys + tid * 16);
  };

  int n_tiles = Nk / kTcKeys;
  if (CAUSAL)
    n_tiles = min(n_tiles, (q0 + ROWS + off + kTcKeys - 1) / kTcKeys);
  load_rows(Qs, qb + q0 * rs, ROWS);
  load_kv(0, 0);
  cp_async_commit();

  const float sl = scale * kLog2e;
  const int wr = warp * 16;  // the warp's first row in the tile
  const int qr[2] = {q0 + wr + g, q0 + wr + g + 8};
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
  float lrow[2] = {0.f, 0.f};              // this lane's part of the row sum
  uint32_t qf[kQRegs ? KT : 1][4];

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
    if constexpr (kQRegs) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KT; ++kk)
          ldsm_x4(qf[kk], Qs + (wr + (lane & 15)) * LD + kk * 16 +
                              (lane >> 4) * 8);
      }
    }
    const T* Kt = Ks + st * kTcKeys * LD;
    const T* Vt = Vs + st * kTcKeys * LD;
    const unsigned char* kmt = km + st * kTcKeys;
    const int k0 = t * kTcKeys;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n8 tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t a[4];
      if constexpr (kQRegs) {
        a[0] = qf[kk][0];
        a[1] = qf[kk][1];
        a[2] = qf[kk][2];
        a[3] = qf[kk][3];
      } else {
        ldsm_x4(a, Qs + (wr + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        ldsm_x4(bb, Kt + (np * 16 + mr + ((mi >> 1) << 3)) * LD + kk * 16 +
                        ((mi & 1) << 3));
        mma<T>(s[2 * np], a, bb[0], bb[1]);
        mma<T>(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }

    // masks, then the online softmax of rows g (r = 0) and g + 8 (r = 1);
    // a lane's two keys of an n8 tile are adjacent: one 2-byte flag load
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kc = j * 8 + 2 * t4;
      const unsigned short kept =
          keepb ? *reinterpret_cast<const unsigned short*>(kmt + kc)
                : static_cast<unsigned short>(0x0101);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = (kept >> (8 * (e & 1))) & 0xff;
        if (CAUSAL) ok = ok && k0 + kc + (e & 1) <= qr[e >> 1] + off;
        if (!ok) s[j][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mnew = fmaxf(mrow[r], mx[r]);
      // a row with no visible key so far keeps p = 0 and alpha = 1
      mu[r] = mnew == -INFINITY ? 0.f : mnew * sl;
      const float alpha =
          mnew == -INFINITY ? 1.f : exp2f(mrow[r] * sl - mu[r]);
      mrow[r] = mnew;
      lrow[r] *= alpha;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(fmaf(s[j][e], sl, -mu[e >> 1]));  // -inf -> 0
        lrow[e >> 1] += s[j][e];
      }

    // O += P V: P as A fragments (hi + lo), V as B through ldmatrix.trans;
    // the hi products of all D tiles, then the lo ones, so that no product
    // waits on the one before it
#pragma unroll
    for (int kb2 = 0; kb2 < 4; ++kb2) {
      uint32_t ph[4], pl[4], bb[DP / 16][4];
      c_to_a<T>(s[2 * kb2], s[2 * kb2 + 1], ph, pl);
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp)
        ldsm_x4_t(bb[dp], Vt + (kb2 * 16 + mr + ((mi & 1) << 3)) * LD +
                              dp * 16 + ((mi >> 1) << 3));
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        mma<T>(acc[2 * dp], ph, bb[dp][0], bb[dp][1]);
        mma<T>(acc[2 * dp + 1], ph, bb[dp][2], bb[dp][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        mma<T>(acc[2 * dp], pl, bb[dp][0], bb[dp][1]);
        mma<T>(acc[2 * dp + 1], pl, bb[dp][2], bb[dp][3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before its refill
  }

  // epilogue: row sums over the quad, O / l staged in T through the Q
  // tile (free since the loop's last barrier), 16-byte coalesced stores
  T* Os = Qs;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
    const bool vis = lrow[r] > 0.f;
    const float inv = vis ? 1.f / lrow[r] : 0.f;
    const int row = wr + g + 8 * r;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<uint32_t*>(Os + row * LD + j * 8 + 2 * t4) =
          pack2<T>(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    if (t4 == 0)
      lse[static_cast<long>(bh) * Nq + qr[r]] =
          vis ? mrow[r] * scale + logf(lrow[r]) : kSentinel;
  }
  __syncthreads();
  for (int i = tid; i < ROWS * cpr; i += NT) {
    const int r = i / cpr;
    const int c = i - r * cpr;
    *reinterpret_cast<uint4*>(ob + (q0 + r) * rs + c * 8) =
        *reinterpret_cast<const uint4*>(Os + r * LD + c * 8);
  }
}

template <typename T, int DP, bool kQRegs, int NW, int MINB, bool CAUSAL>
int launch_tc(const void* q, const void* k, const void* v, const void* keep,
              void* out, void* lse, int B, int H, int Nq, int Nk, int D,
              float scale, cudaStream_t stream) {
  if (Nq % (16 * NW) || Nk % kTcKeys || D > DP)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_fwd_tc_kernel<T, DP, kQRegs, NW, MINB, CAUSAL>;
  constexpr size_t smem = tc_smem_bytes<DP, NW>();
  // allow the bucket's footprint once, outside any graph capture
  static cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(B * H, Nq / (16 * NW));
  kern<<<grid, 32 * NW, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(keep),
      static_cast<T*>(out), static_cast<float*>(lse), H, Nq, Nk, D,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool CAUSAL>
int dispatch_tc(const void* q, const void* k, const void* v,
                const void* keep, void* out, void* lse, int B, int H,
                int Nq, int Nk, int D, float scale, cudaStream_t s) {
  if (D <= 64)
    return launch_tc<T, 64, true, 8, 2, CAUSAL>(q, k, v, keep, out, lse, B, H,
                                             Nq, Nk, D, scale, s);
  if (D <= 128)
    return launch_tc<T, 128, true, 4, 2, CAUSAL>(q, k, v, keep, out, lse, B, H,
                                              Nq, Nk, D, scale, s);
  return launch_tc<T, 256, false, 4, 1, CAUSAL>(q, k, v, keep, out, lse, B, H,
                                             Nq, Nk, D, scale, s);
}

// the buckets (dispatch_tc): at D = 64, 8 warps (128 query rows, so each
// K/V tile is fetched once per head at N = 128) with registers capped at
// 128 for 2 CTAs an SM; at 128 and 256, 4 warps

// ---------------------------------------------------------------------------
// f32 on the CUDA cores

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
// `dtype` (0 = float32, 1 = bfloat16, 2 = float16); lse: [B, H, Nq] f32;
// keep: [B, Nk] bytes or NULL (16-byte aligned for the 16-bit types).
// Returns a cudaError_t (0 = success).
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
    return causal ? dispatch_tc<bf16, true>(q, k, v, keep, out, lse, B, H,
                                            Nq, Nk, D, scale, s)
                  : dispatch_tc<bf16, false>(q, k, v, keep, out, lse, B, H,
                                             Nq, Nk, D, scale, s);
  if (dtype == 2)
    return causal ? dispatch_tc<__half, true>(q, k, v, keep, out, lse, B, H,
                                              Nq, Nk, D, scale, s)
                  : dispatch_tc<__half, false>(q, k, v, keep, out, lse, B, H,
                                               Nq, Nk, D, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* p1t_flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
