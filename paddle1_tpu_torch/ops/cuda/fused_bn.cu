// Fused batch norm, forward: batch statistics + normalize + affine
// (+ residual) + activation over a channels-last [rows, C] tensor.
//
// Replaces paddle1_tpu/ops/pallas/fused_bn.py::_bn_train_kernel (training
// mode: statistics from the batch) and ::_bn_norm_kernel (given
// statistics: eval, use_global_stats). Same numerics contract: f32 sums
// of x and x^2, mean = s / rows and var = max(ss / rows - mean^2, 0) with
// the exact count as a host constant, f32 statistics out, then
// y = act((x - mean) * rsqrt(var + eps) * gamma + beta [+ res]) cast to
// the storage type at the edge. act is identity or relu.
//
// Bound on an H100: memory. Per element the work is a handful of flops
// against 2-4 bytes moved in bf16, far below the card's balance point.
// The compulsory traffic is x read once and y written once (plus the
// residual); this design reads x twice in training mode:
//   1. stats pass: per-chunk f32 partial sums [chunks, C]
//      (fused_bn_common.cuh, no atomics, so repeats are bit-identical);
//   2. finalize: one warp per channel reduces the partials -> mean, var;
//   3. normalize pass: y from x (and res).
// The Pallas kernel's single sequential (2, row_blocks) grid keeps the
// running sums in VMEM; on the GPU the blocks run in no order, so the
// sum across blocks is the second stage above. Given-statistics mode is
// pass 3 alone. At ResNet-50's layer 4 ([1568, 2048] at 32 images) that
// pass has about 1.5 rows a thread, so it is latency and set-up, not
// bytes: the grid is one wave of resident CTAs (the launch plan sizes it
// from the occupancy API), the CTA loads its tile's statistics and affine
// once into shared memory, coalesced, with one rsqrt per channel, and each
// thread has its first rows' 16-byte loads in flight before that set-up
// and several rows in flight after it.
//
// Local moments (replaces ::_moments_kernel, SyncBatchNorm's per-rank
// statistics pass): passes 1 and 2 alone, the finalize writing the raw
// f32 sums of x and x^2 per channel, which the caller all-reduces across
// ranks before it normalizes. One read of x: the compulsory traffic.
//
// Loads are 16 B (8 bf16) or 32 B (8 f32) per thread, neighbouring
// threads on neighbouring channels; rows are strided across the block's
// warps. Built by paddle1_tpu_torch/ops/cuda/build.py with nvcc for
// sm_90a into a shared library with a plain C interface (ctypes).

#include "fused_bn_common.cuh"

namespace {

using namespace p1t_bn;

template <typename T>
__global__ void stats_partial_kernel(const T* __restrict__ x,
                                     long long rows, int c,
                                     long long rows_per_chunk,
                                     float* __restrict__ ps,
                                     float* __restrict__ pss) {
  const int cv = c / kVec;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_chunk;
  long long r1 = r0 + rows_per_chunk;
  if (r1 > rows) r1 = rows;
  float s[kVec] = {}, ss[kVec] = {};
  if (v < cv) {
    for (long long r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      float xv[kVec];
      load8(x + r * c + static_cast<long long>(v) * kVec, xv);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        s[i] += xv[i];
        ss[i] += xv[i] * xv[i];
      }
    }
  }
  __shared__ float buf[kThreads * kVec];
  column_sums(buf, s, ps, c);
  column_sums(buf, ss, pss, c);
}

// Rows a thread keeps in flight in the normalize pass: 64 bytes of x
// (four bf16 or two f32 vectors), loaded before any is computed.
template <typename T>
struct NormRowsInFlight {
  static constexpr int value = sizeof(T) == 2 ? 4 : 2;
};

// Given-statistics normalize, one wave of resident CTAs (the grid from
// the occupancy API). A CTA is one channel tile of blockDim.x vectors
// and walks rows with a stride of gridDim.y * blockDim.y. Each thread
// first puts its first rows' loads in flight; meanwhile the CTA loads the
// tile's mean, rstd = rsqrt(var + eps), gamma and beta ONCE, coalesced,
// into shared memory, from which each thread takes its 8 channels with
// 16-byte loads.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
normalize_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                 const float* __restrict__ var, const P* __restrict__ gamma,
                 const P* __restrict__ beta, const T* __restrict__ res,
                 T* __restrict__ y, long long rows, int c, float eps,
                 int relu) {
  constexpr int U = NormRowsInFlight<T>::value;
  __shared__ __align__(16) float coef[4][kTileMax];   // mean, rstd, g, b
  const int tile_w = blockDim.x * kVec;
  const int c0 = blockIdx.x * tile_w;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = v < c / kVec;
  const long long col = static_cast<long long>(v) * kVec;
  const long long step = static_cast<long long>(gridDim.y) * blockDim.y;
  long long r = static_cast<long long>(blockIdx.y) * blockDim.y +
                threadIdx.y;
  Raw8<T> xr[U], rr[U];
  auto issue = [&](long long first) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long ru = first + u * step;
      if (live && ru < rows) {
        load_raw(x + ru * c + col, xr[u]);
        if (res != nullptr) load_raw(res + ru * c + col, rr[u]);
      }
    }
  };
  issue(r);
  const int nt = blockDim.x * blockDim.y;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < tile_w; i += nt) {
    const int ch = c0 + i;
    if (ch < c) {
      coef[0][i] = mean[ch];
      coef[1][i] = rsqrtf(var[ch] + eps);
      coef[2][i] = to_f32(gamma[ch]);
      coef[3][i] = to_f32(beta[ch]);
    }
  }
  __syncthreads();
  if (!live) return;
  float mu[kVec], rs[kVec], g[kVec], b[kVec];
  load8(&coef[0][threadIdx.x * kVec], mu);
  load8(&coef[1][threadIdx.x * kVec], rs);
  load8(&coef[2][threadIdx.x * kVec], g);
  load8(&coef[3][threadIdx.x * kVec], b);
  while (r < rows) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long ru = r + u * step;
      if (ru < rows) {
        float xv[kVec], rv[kVec], out[kVec];
        widen(xr[u], xv);
        if (res != nullptr) widen(rr[u], rv);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          float t = (xv[i] - mu[i]) * rs[i];
          t = t * g[i] + b[i];
          if (res != nullptr) t += rv[i];
          out[i] = relu ? fmaxf(t, 0.f) : t;
        }
        store8(y + ru * c + col, out);
      }
    }
    r += U * step;
    issue(r);
  }
}

template <typename T, typename P>
int train_fwd(const void* x, const void* g, const void* b, const void* res,
              void* y, float* mean, float* var, float* ps, float* pss,
              long long rows, int c, int tx, int chunks,
              long long rows_per_chunk, int grid_y, float eps, int relu,
              cudaStream_t stream) {
  dim3 block;
  int tiles;
  if (rows <= 0 || chunks < 1 || grid_y < 1 || grid_y > 65535 ||
      chunks > 65535 || !block_shape(c, tx, &block, &tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  stats_partial_kernel<T><<<dim3(tiles, chunks), block, 0, stream>>>(
      static_cast<const T*>(x), rows, c, rows_per_chunk, ps, pss);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  rc = launch_finalize(ps, pss, chunks, c,
                       static_cast<float>(1.0 / static_cast<double>(rows)),
                       0, mean, var, stream);
  if (rc != 0) return rc;
  normalize_kernel<T, P><<<dim3(tiles, grid_y), block, 0, stream>>>(
      static_cast<const T*>(x), mean, var, static_cast<const P*>(g),
      static_cast<const P*>(b), static_cast<const T*>(res),
      static_cast<T*>(y), rows, c, eps, relu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int norm_fwd(const void* x, const float* mean, const float* var,
             const void* g, const void* b, const void* res, void* y,
             long long rows, int c, int tx, int grid_y, float eps, int relu,
             cudaStream_t stream) {
  dim3 block;
  int tiles;
  if (rows <= 0 || grid_y < 1 || grid_y > 65535 ||
      !block_shape(c, tx, &block, &tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  normalize_kernel<T, P><<<dim3(tiles, grid_y), block, 0, stream>>>(
      static_cast<const T*>(x), mean, var, static_cast<const P*>(g),
      static_cast<const P*>(b), static_cast<const T*>(res),
      static_cast<T*>(y), rows, c, eps, relu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int moments(const void* x, float* s, float* ss, float* ps, float* pss,
            long long rows, int c, int tx, int chunks,
            long long rows_per_chunk, cudaStream_t stream) {
  dim3 block;
  int tiles;
  if (rows <= 0 || chunks < 1 || chunks > 65535 ||
      !block_shape(c, tx, &block, &tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  stats_partial_kernel<T><<<dim3(tiles, chunks), block, 0, stream>>>(
      static_cast<const T*>(x), rows, c, rows_per_chunk, ps, pss);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return launch_finalize(ps, pss, chunks, c, 1.f, 1, s, ss, stream);
}

}  // namespace

extern "C" {

// dtype (x, res, y) and pdtype (gamma, beta): 0 = float32, 1 = bfloat16.
// res may be null. mean/var: f32 [C] outputs; ps/pss: f32 [chunks, C]
// scratch. Returns a cudaError_t (0 = success).
int p1t_fused_bn_train_fwd(const void* x, const void* g, const void* b,
                           const void* res, void* y, void* mean, void* var,
                           void* ps, void* pss, long long rows, int c,
                           int tx, int chunks, long long rows_per_chunk,
                           int grid_y, float eps, int relu, int dtype,
                           int pdtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto m = static_cast<float*>(mean);
  auto v = static_cast<float*>(var);
  auto a = static_cast<float*>(ps);
  auto q = static_cast<float*>(pss);
#define P1T_TRAIN(T, P)                                                    \
  return train_fwd<T, P>(x, g, b, res, y, m, v, a, q, rows, c, tx, chunks, \
                         rows_per_chunk, grid_y, eps, relu, s)
  if (dtype == 0 && pdtype == 0) P1T_TRAIN(float, float);
  if (dtype == 0 && pdtype == 1) P1T_TRAIN(float, __nv_bfloat16);
  if (dtype == 1 && pdtype == 0) P1T_TRAIN(__nv_bfloat16, float);
  if (dtype == 1 && pdtype == 1) P1T_TRAIN(__nv_bfloat16, __nv_bfloat16);
#undef P1T_TRAIN
  return static_cast<int>(cudaErrorInvalidValue);
}

// Given statistics: mean/var f32 [C]; otherwise as above.
int p1t_fused_bn_norm_fwd(const void* x, const void* mean, const void* var,
                          const void* g, const void* b, const void* res,
                          void* y, long long rows, int c, int tx, int grid_y,
                          float eps, int relu, int dtype, int pdtype,
                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto m = static_cast<const float*>(mean);
  auto v = static_cast<const float*>(var);
#define P1T_NORM(T, P) \
  return norm_fwd<T, P>(x, m, v, g, b, res, y, rows, c, tx, grid_y, eps, relu, s)
  if (dtype == 0 && pdtype == 0) P1T_NORM(float, float);
  if (dtype == 0 && pdtype == 1) P1T_NORM(float, __nv_bfloat16);
  if (dtype == 1 && pdtype == 0) P1T_NORM(__nv_bfloat16, float);
  if (dtype == 1 && pdtype == 1) P1T_NORM(__nv_bfloat16, __nv_bfloat16);
#undef P1T_NORM
  return static_cast<int>(cudaErrorInvalidValue);
}

// Per-channel f32 sum and sum of squares of x [rows, C]: s/ss f32 [C]
// outputs; ps/pss f32 [chunks, C] scratch.
int p1t_fused_bn_moments(const void* x, void* s, void* ss, void* ps,
                         void* pss, long long rows, int c, int tx,
                         int chunks, long long rows_per_chunk, int dtype,
                         void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto a = static_cast<float*>(s);
  auto b = static_cast<float*>(ss);
  auto pa = static_cast<float*>(ps);
  auto pb = static_cast<float*>(pss);
  if (dtype == 0)
    return moments<float>(x, a, b, pa, pb, rows, c, tx, chunks,
                          rows_per_chunk, st);
  if (dtype == 1)
    return moments<__nv_bfloat16>(x, a, b, pa, pb, rows, c, tx, chunks,
                                  rows_per_chunk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// CTAs of the normalize kernel (256 threads) that one SM holds at once,
// for the launch plan's one-wave grid. Returns a cudaError_t.
int p1t_fused_bn_norm_occupancy(int dtype, int pdtype, int* blocks) {
#define P1T_OCC(T, P)                                                  \
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor( \
      blocks, normalize_kernel<T, P>, kThreads, 0))
  if (dtype == 0 && pdtype == 0) P1T_OCC(float, float);
  if (dtype == 0 && pdtype == 1) P1T_OCC(float, __nv_bfloat16);
  if (dtype == 1 && pdtype == 0) P1T_OCC(__nv_bfloat16, float);
  if (dtype == 1 && pdtype == 1) P1T_OCC(__nv_bfloat16, __nv_bfloat16);
#undef P1T_OCC
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* p1t_fused_bn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
