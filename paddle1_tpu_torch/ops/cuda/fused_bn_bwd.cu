// Fused batch norm, backward: dx, dgamma, dbeta (and dresidual) over a
// channels-last [rows, C] tensor.
//
// Replaces paddle1_tpu/ops/pallas/fused_bn_bwd.py::_train_bwd_kernel
// (batch statistics) and ::_norm_bwd_kernel (given statistics). Same
// numerics contract: the relu mask from the forward output (dy where
// y > 0), f32 per-channel sums dbeta = sum(dy) and
// dgamma = sum(dy * xhat) with xhat = (x - mean) * rsqrt(var + eps), then
//   training: dx = gamma * rstd * (dy - dbeta / n - xhat * dgamma / n)
//   given:    dx = dy * gamma * rstd
// and dresidual = the masked dy, each cast to the storage type at the
// edge. With act == identity y is never read.
//
// Bound on an H100: memory (a few flops per element against 6-10 bytes
// moved in bf16). Compulsory traffic: x and dy read once, dx written
// once (plus y for relu and dres for a residual). Design:
//   training: pass 1 reads x, dy and writes f32 per-chunk partials of
//             the two sums; a finalize kernel (one warp per channel)
//             reduces them in a fixed order (no atomics: repeats are
//             bit-identical); pass 2 reads x and dy again and writes dx.
//             The Pallas kernel's sequential (2, row_blocks) grid holds
//             the sums in VMEM between its phases; here the phases are
//             kernels.
//   given:    dx is row-local, so one pass writes dx and the partials,
//             and the finalize kernel reduces the partials.
// Built by paddle1_tpu_torch/ops/cuda/build.py with nvcc for sm_90a into
// a shared library with a plain C interface (ctypes).

#include "fused_bn_common.cuh"

namespace {

using namespace p1t_bn;

// dy masked by the relu of the forward output
template <typename T>
__device__ __forceinline__ void masked_dy(const T* __restrict__ dy,
                                          const T* __restrict__ y,
                                          long long off, int relu,
                                          float (&d)[kVec]) {
  load8(dy + off, d);
  if (relu) {
    float yv[kVec];
    load8(y + off, yv);
#pragma unroll
    for (int i = 0; i < kVec; ++i) d[i] = yv[i] > 0.f ? d[i] : 0.f;
  }
}

__device__ __forceinline__ void channel_stats(const float* __restrict__ mean,
                                              const float* __restrict__ var,
                                              int v, float eps,
                                              float (&mu)[kVec],
                                              float (&rs)[kVec]) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    mu[i] = mean[v * kVec + i];
    rs[i] = rsqrtf(var[v * kVec + i] + eps);
  }
}

// training pass 1: partial sums of dy * xhat (-> dgamma) and dy (-> dbeta)
template <typename T>
__global__ void train_partial_kernel(const T* __restrict__ x,
                                     const T* __restrict__ dy,
                                     const T* __restrict__ y,
                                     const float* __restrict__ mean,
                                     const float* __restrict__ var,
                                     long long rows, int c,
                                     long long rows_per_chunk, float eps,
                                     int relu, float* __restrict__ psg,
                                     float* __restrict__ psb) {
  const int cv = c / kVec;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_chunk;
  long long r1 = r0 + rows_per_chunk;
  if (r1 > rows) r1 = rows;
  float sg[kVec] = {}, sb[kVec] = {};
  if (v < cv) {
    float mu[kVec], rs[kVec];
    channel_stats(mean, var, v, eps, mu, rs);
    for (long long r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      const long long off = r * c + static_cast<long long>(v) * kVec;
      float xv[kVec], d[kVec];
      load8(x + off, xv);
      masked_dy(dy, y, off, relu, d);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float xhat = (xv[i] - mu[i]) * rs[i];
        sg[i] += d[i] * xhat;
        sb[i] += d[i];
      }
    }
  }
  block_column_sums(sg, sb, psg, psb, c);
}

// training pass 2: dx (and dres) from the finished sums
template <typename T, typename P>
__global__ void train_dx_kernel(const T* __restrict__ x,
                                const T* __restrict__ dy,
                                const T* __restrict__ y,
                                const P* __restrict__ gamma,
                                const float* __restrict__ mean,
                                const float* __restrict__ var,
                                const float* __restrict__ dg,
                                const float* __restrict__ db, long long rows,
                                int c, float eps, int relu,
                                T* __restrict__ dx, T* __restrict__ dres) {
  const int cv = c / kVec;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= cv) return;
  const float n = static_cast<float>(rows);
  float mu[kVec], rs[kVec], gr[kVec], c1[kVec], dgc[kVec];
  channel_stats(mean, var, v, eps, mu, rs);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int ch = v * kVec + i;
    gr[i] = to_f32(gamma[ch]) * rs[i];
    c1[i] = db[ch] / n;
    dgc[i] = dg[ch];
  }
  const long long step = static_cast<long long>(gridDim.y) * blockDim.y;
  for (long long r = static_cast<long long>(blockIdx.y) * blockDim.y +
                     threadIdx.y;
       r < rows; r += step) {
    const long long off = r * c + static_cast<long long>(v) * kVec;
    float xv[kVec], d[kVec], out[kVec];
    load8(x + off, xv);
    masked_dy(dy, y, off, relu, d);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float xhat = (xv[i] - mu[i]) * rs[i];
      out[i] = gr[i] * ((d[i] - c1[i]) - (xhat * dgc[i]) / n);
    }
    store8(dx + off, out);
    if (dres != nullptr) store8(dres + off, d);
  }
}

// given statistics: dx, dres and the partial sums in one pass
template <typename T, typename P>
__global__ void norm_bwd_kernel(const T* __restrict__ x,
                                const T* __restrict__ dy,
                                const T* __restrict__ y,
                                const P* __restrict__ gamma,
                                const float* __restrict__ mean,
                                const float* __restrict__ var,
                                long long rows, int c,
                                long long rows_per_chunk, float eps,
                                int relu, T* __restrict__ dx,
                                T* __restrict__ dres,
                                float* __restrict__ psg,
                                float* __restrict__ psb) {
  const int cv = c / kVec;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_chunk;
  long long r1 = r0 + rows_per_chunk;
  if (r1 > rows) r1 = rows;
  float sg[kVec] = {}, sb[kVec] = {};
  if (v < cv) {
    float mu[kVec], rs[kVec], gr[kVec];
    channel_stats(mean, var, v, eps, mu, rs);
#pragma unroll
    for (int i = 0; i < kVec; ++i) gr[i] = to_f32(gamma[v * kVec + i]) * rs[i];
    for (long long r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      const long long off = r * c + static_cast<long long>(v) * kVec;
      float xv[kVec], d[kVec], out[kVec];
      load8(x + off, xv);
      masked_dy(dy, y, off, relu, d);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float xhat = (xv[i] - mu[i]) * rs[i];
        sg[i] += d[i] * xhat;
        sb[i] += d[i];
        out[i] = d[i] * gr[i];
      }
      store8(dx + off, out);
      if (dres != nullptr) store8(dres + off, d);
    }
  }
  block_column_sums(sg, sb, psg, psb, c);
}

template <typename T, typename P>
int train_bwd(const void* x, const void* g, const float* mean,
              const float* var, const void* y, const void* dy, void* dx,
              void* dres, float* dg, float* db, float* psg, float* psb,
              long long rows, int c, int tx, int chunks,
              long long rows_per_chunk, int grid_y, float eps, int relu,
              cudaStream_t stream) {
  dim3 block;
  int tiles;
  if (rows <= 0 || chunks < 1 || chunks > 65535 || grid_y < 1 ||
      grid_y > 65535 || !block_shape(c, tx, &block, &tiles) ||
      (relu && y == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  train_partial_kernel<T><<<dim3(tiles, chunks), block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(y), mean, var, rows, c, rows_per_chunk, eps,
      relu, psg, psb);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  rc = launch_finalize(psg, psb, chunks, c, 1.f, 1, dg, db, stream);
  if (rc != 0) return rc;
  train_dx_kernel<T, P><<<dim3(tiles, grid_y), block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(y), static_cast<const P*>(g), mean, var, dg, db,
      rows, c, eps, relu, static_cast<T*>(dx), static_cast<T*>(dres));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int norm_bwd(const void* x, const void* g, const float* mean,
             const float* var, const void* y, const void* dy, void* dx,
             void* dres, float* dg, float* db, float* psg, float* psb,
             long long rows, int c, int tx, int chunks,
             long long rows_per_chunk, float eps, int relu,
             cudaStream_t stream) {
  dim3 block;
  int tiles;
  if (rows <= 0 || chunks < 1 || chunks > 65535 ||
      !block_shape(c, tx, &block, &tiles) || (relu && y == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  norm_bwd_kernel<T, P><<<dim3(tiles, chunks), block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(y), static_cast<const P*>(g), mean, var, rows, c,
      rows_per_chunk, eps, relu, static_cast<T*>(dx), static_cast<T*>(dres),
      psg, psb);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return launch_finalize(psg, psb, chunks, c, 1.f, 1, dg, db, stream);
}

}  // namespace

extern "C" {

// dtype (x, y, dy, dx, dres) and pdtype (gamma): 0 = float32,
// 1 = bfloat16. mean/var: f32 [C]; dg/db: f32 [C] outputs; psg/psb: f32
// [chunks, C] scratch. y may be null when relu == 0, dres when no
// residual gradient is wanted. Returns a cudaError_t (0 = success).
int p1t_fused_bn_bwd_train(const void* x, const void* g, const void* mean,
                           const void* var, const void* y, const void* dy,
                           void* dx, void* dres, void* dg, void* db,
                           void* psg, void* psb, long long rows, int c,
                           int tx, int chunks, long long rows_per_chunk,
                           int grid_y, float eps, int relu, int dtype,
                           int pdtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto m = static_cast<const float*>(mean);
  auto v = static_cast<const float*>(var);
  auto a = static_cast<float*>(dg);
  auto b = static_cast<float*>(db);
  auto pa = static_cast<float*>(psg);
  auto pb = static_cast<float*>(psb);
#define P1T_TRAIN(T, P)                                                     \
  return train_bwd<T, P>(x, g, m, v, y, dy, dx, dres, a, b, pa, pb, rows, c, \
                         tx, chunks, rows_per_chunk, grid_y, eps, relu, s)
  if (dtype == 0 && pdtype == 0) P1T_TRAIN(float, float);
  if (dtype == 0 && pdtype == 1) P1T_TRAIN(float, __nv_bfloat16);
  if (dtype == 1 && pdtype == 0) P1T_TRAIN(__nv_bfloat16, float);
  if (dtype == 1 && pdtype == 1) P1T_TRAIN(__nv_bfloat16, __nv_bfloat16);
#undef P1T_TRAIN
  return static_cast<int>(cudaErrorInvalidValue);
}

int p1t_fused_bn_bwd_norm(const void* x, const void* g, const void* mean,
                          const void* var, const void* y, const void* dy,
                          void* dx, void* dres, void* dg, void* db,
                          void* psg, void* psb, long long rows, int c, int tx,
                          int chunks, long long rows_per_chunk, float eps,
                          int relu, int dtype, int pdtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto m = static_cast<const float*>(mean);
  auto v = static_cast<const float*>(var);
  auto a = static_cast<float*>(dg);
  auto b = static_cast<float*>(db);
  auto pa = static_cast<float*>(psg);
  auto pb = static_cast<float*>(psb);
#define P1T_NORM(T, P)                                                     \
  return norm_bwd<T, P>(x, g, m, v, y, dy, dx, dres, a, b, pa, pb, rows, c, \
                        tx, chunks, rows_per_chunk, eps, relu, s)
  if (dtype == 0 && pdtype == 0) P1T_NORM(float, float);
  if (dtype == 0 && pdtype == 1) P1T_NORM(float, __nv_bfloat16);
  if (dtype == 1 && pdtype == 0) P1T_NORM(__nv_bfloat16, float);
  if (dtype == 1 && pdtype == 1) P1T_NORM(__nv_bfloat16, __nv_bfloat16);
#undef P1T_NORM
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* p1t_fused_bn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
