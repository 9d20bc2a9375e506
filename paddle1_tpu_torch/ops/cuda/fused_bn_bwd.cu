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
//   training: ONE cooperative launch of a persistent grid (as many CTAs
//             as the card holds at once, from the occupancy API). A CTA
//             owns a channel tile and a chunk of consecutive rows.
//             Phase A: it copies the first `resident` rows of x and dy
//             into shared memory with cp.async, streams the rest through
//             registers (several rows' 16-byte loads in flight), masks dy
//             once (the masked dy is written back over the resident
//             copy), and sums dy * xhat and dy per channel in f32 into
//             one partial row [chunk, C]. Handoff: a grid barrier; one
//             warp per channel sums the partial rows in a fixed order (no
//             atomics: repeats are bit-identical) into dgamma, dbeta; a
//             second grid barrier. Phase C: dx from the resident rows in
//             shared memory, and from the rows that did not fit re-read
//             in the reverse of phase A's order, so the last streamed come
//             from L2. Where the whole chunk fits (ResNet-50 at 32 images
//             from layer 3 on), x and dy cross HBM once. The per-channel
//             coefficients are computed once per CTA into shared memory.
//             The Pallas kernel's sequential (2, row_blocks) grid holds
//             the sums in VMEM between its phases; here the grid barrier
//             does, with the rows held in shared memory.
//   given:    dx is row-local, so ONE launch: each CTA streams its chunk
//             of rows (several rows' 16-byte loads in flight a thread),
//             writes dx row by row and one partial row of the sums, and
//             the last CTAs to arrive (int32 tickets, no grid barrier:
//             finish_tile, fused_bn_common.cuh) sum the partial rows in a
//             fixed order (no float atomics). Its grid is one wave of
//             resident CTAs (norm_bwd_plan).
// Built by paddle1_tpu_torch/ops/cuda/build.py with nvcc for sm_90a into
// a shared library with a plain C interface (ctypes).

#include <cooperative_groups.h>

#include "fused_bn_common.cuh"

namespace {

using namespace p1t_bn;

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

// Shared memory ahead of the resident rows: the column-sum scratch
// (kThreads x 8 floats) and five per-channel coefficient rows (mean,
// rstd, gamma * rstd, dbeta / n, dgamma) of the widest tile. The launch
// plan (ops/fused_bn_bwd.py, train_bwd_plan) mirrors this constant.
constexpr int kBwdFixedSmem = kThreads * kVec * 4 + 5 * kTileMax * 4;

template <typename T>
__device__ __forceinline__ void mask_relu(const Raw8<T>& yr,
                                          float (&d)[kVec]) {
  float yv[kVec];
  widen(yr, yv);
#pragma unroll
  for (int i = 0; i < kVec; ++i) d[i] = yv[i] > 0.f ? d[i] : 0.f;
}

// training mode, the whole backward in one cooperative launch (see the
// note at the top). Grid (tiles, chunks), block (TX, TY); CTA (t, k) owns
// channels [t * TX * 8, ...) of rows [k * rows_per_chunk, ...). A thread
// owns one 8-channel vector of local rows ty, ty + TY, ...: its k-th row
// is resident when k < kr.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads, 2)
train_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 const T* __restrict__ y, const P* __restrict__ gamma,
                 const float* __restrict__ mean,
                 const float* __restrict__ var, long long rows, int c,
                 long long rows_per_chunk, int resident, float eps, int relu,
                 float* psg, float* psb, float* dg, float* db,
                 T* __restrict__ dx, T* __restrict__ dres) {
  constexpr int U = RowsInFlight<T>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  float* scratch = reinterpret_cast<float*>(smem);
  float* coef = scratch + kThreads * kVec;     // [5][kTileMax]
  const int tile_w = blockDim.x * kVec;
  T* xs = reinterpret_cast<T*>(smem + kBwdFixedSmem);   // [resident][tile_w]
  T* ds = xs + static_cast<long long>(resident) * tile_w;
  const int c0 = blockIdx.x * tile_w;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = v < c / kVec;
  const long long col = static_cast<long long>(v) * kVec;
  const int lo = threadIdx.x * kVec;
  const int ty = threadIdx.y, nty = blockDim.y;
  const int tid = ty * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * nty;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_chunk;
  long long left = rows - r0;
  const int n_local = static_cast<int>(
      left < 0 ? 0 : (left < rows_per_chunk ? left : rows_per_chunk));
  const int n_res = resident < n_local ? resident : n_local;
  // this thread's rows: local ty + k * nty for k < kn; resident for k < kr
  const int kn = live && ty < n_local ? (n_local - ty + nty - 1) / nty : 0;
  const int kr = live && ty < n_res ? (n_res - ty + nty - 1) / nty : 0;
  auto row_of = [&](int k) { return r0 + ty + static_cast<long long>(k) * nty; };
  auto local_of = [&](int k) { return ty + k * nty; };

  // phase A.1: the resident rows' copies go out first
  for (int k = 0; k < kr; ++k) {
    const long long off = row_of(k) * c + col;
    copy_async(xs + static_cast<long long>(local_of(k)) * tile_w + lo, x + off);
    copy_async(ds + static_cast<long long>(local_of(k)) * tile_w + lo, dy + off);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // the tile's mean, rstd and gamma * rstd, once per CTA
  for (int i = tid; i < tile_w; i += nt) {
    if (c0 + i < c) {
      const float r = rsqrtf(var[c0 + i] + eps);
      coef[i] = mean[c0 + i];
      coef[kTileMax + i] = r;
      coef[2 * kTileMax + i] = to_f32(gamma[c0 + i]) * r;
    }
  }
  __syncthreads();
  float mu[kVec], rs[kVec], sg[kVec] = {}, sb[kVec] = {};
  if (live) {
    load8(coef + lo, mu);
    load8(coef + kTileMax + lo, rs);
  }
  auto accumulate = [&](const float (&xv)[kVec], const float (&d)[kVec]) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float xhat = (xv[i] - mu[i]) * rs[i];
      sg[i] += d[i] * xhat;
      sb[i] += d[i];
    }
  };
  // phase A.2: the rows that do not fit, streamed through registers
  for (int k = kr; k < kn; k += U) {
    Raw8<T> xr[U], dr[U], yr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k + u < kn) {
        const long long off = row_of(k + u) * c + col;
        load_raw(x + off, xr[u]);
        load_raw(dy + off, dr[u]);
        if (relu) load_raw(y + off, yr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k + u < kn) {
        float xv[kVec], d[kVec];
        widen(xr[u], xv);
        widen(dr[u], d);
        if (relu) mask_relu(yr[u], d);
        accumulate(xv, d);
      }
    }
  }
  // phase A.3: the resident rows, from shared memory (each thread reads
  // only the vectors it copied); relu masks dy once, in place
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  for (int k = 0; k < kr; k += U) {
    Raw8<T> yr[U];
    if (relu) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k + u < kr) load_raw(y + row_of(k + u) * c + col, yr[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k + u < kr) {
        const long long so = static_cast<long long>(local_of(k + u)) * tile_w + lo;
        Raw8<T> xr, dr;
        load_raw(xs + so, xr);
        load_raw(ds + so, dr);
        float xv[kVec], d[kVec];
        widen(xr, xv);
        widen(dr, d);
        if (relu) {
          mask_relu(yr[u], d);
          store8(ds + so, d);
        }
        accumulate(xv, d);
      }
    }
  }
  column_sums(scratch, sg, psg, c);
  column_sums(scratch, sb, psb, c);

  // handoff: every partial row is out; one warp per channel sums them in
  // chunk order, lanes strided then a fixed shuffle tree
  cooperative_groups::this_grid().sync();
  const int chunks = gridDim.y;
  const int warps = nt / 32;     // whole warps only (TX * TY may be < 256)
  const int lane = tid & 31;
  if (tid / 32 < warps) {
    const int cta = blockIdx.y * gridDim.x + blockIdx.x;
    const int stride = gridDim.x * gridDim.y * warps;
    for (int ch = cta * warps + tid / 32; ch < c; ch += stride) {
      float a = 0.f, b = 0.f;
      for (int k = lane; k < chunks; k += 32) {
        a += __ldcg(psg + static_cast<long long>(k) * c + ch);
        b += __ldcg(psb + static_cast<long long>(k) * c + ch);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        b += __shfl_xor_sync(0xffffffffu, b, o);
      }
      if (lane == 0) {
        dg[ch] = a;
        db[ch] = b;
      }
    }
  }
  cooperative_groups::this_grid().sync();

  // phase C: the tile's dx coefficients, once per CTA
  const float n = static_cast<float>(rows);
  for (int i = tid; i < tile_w; i += nt) {
    const int ch = c0 + i;
    if (ch < c) {
      coef[3 * kTileMax + i] = __ldcg(db + ch) / n;
      coef[4 * kTileMax + i] = __ldcg(dg + ch);
    }
  }
  __syncthreads();
  if (!live) return;
  float gr[kVec], c1[kVec], dgc[kVec];
  load8(coef + 2 * kTileMax + lo, gr);
  load8(coef + 3 * kTileMax + lo, c1);
  load8(coef + 4 * kTileMax + lo, dgc);
  auto emit = [&](long long off, const float (&xv)[kVec],
                  const float (&d)[kVec]) {
    float out[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float xhat = (xv[i] - mu[i]) * rs[i];
      out[i] = gr[i] * ((d[i] - c1[i]) - (xhat * dgc[i]) / n);
    }
    store8(dx + off, out);
    if (dres != nullptr) store8(dres + off, d);
  };
  // the rows that did not fit, in the reverse of phase A's order
  for (int k = kn - 1; k >= kr; k -= U) {
    Raw8<T> xr[U], dr[U], yr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k - u >= kr) {
        const long long off = row_of(k - u) * c + col;
        load_raw(x + off, xr[u]);
        load_raw(dy + off, dr[u]);
        if (relu) load_raw(y + off, yr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k - u >= kr) {
        float xv[kVec], d[kVec];
        widen(xr[u], xv);
        widen(dr[u], d);
        if (relu) mask_relu(yr[u], d);
        emit(row_of(k - u) * c + col, xv, d);
      }
    }
  }
  // the resident rows (dy already masked)
  for (int k = 0; k < kr; ++k) {
    const long long so = static_cast<long long>(local_of(k)) * tile_w + lo;
    Raw8<T> xr, dr;
    load_raw(xs + so, xr);
    load_raw(ds + so, dr);
    float xv[kVec], d[kVec];
    widen(xr, xv);
    widen(dr, d);
    emit(row_of(k) * c + col, xv, d);
  }
}

// given statistics, ONE launch: grid (tiles, chunks) of norm_bwd_plan
// (ops/fused_bn_bwd.py: stats_plan's chunks cut to one wave of resident
// CTAs), block (TX, TY). Each thread walks its chunk's rows
// r0 + ty, r0 + ty + TY, ... with the loads of RowsInFlight of them (x,
// dy, and y for relu) issued before any is used, writes dx (and dres) row
// by row and sums dy * xhat and dy; the block writes one partial row of
// each sum, and the last blocks to arrive sum the partial rows into
// dgamma, dbeta (finish_tile).
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                const T* __restrict__ y, const P* __restrict__ gamma,
                const float* __restrict__ mean,
                const float* __restrict__ var, long long rows, int c,
                long long rows_per_chunk, float eps, int relu,
                T* __restrict__ dx, T* __restrict__ dres, float* psg,
                float* psb, int* counters, float* __restrict__ dg,
                float* __restrict__ db) {
  constexpr int U = RowsInFlight<T>::value;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_chunk;
  long long r1 = r0 + rows_per_chunk;
  if (r1 > rows) r1 = rows;
  const long long step = blockDim.y;
  float sg[kVec] = {}, sb[kVec] = {};
  if (v < c / kVec) {
    const long long col = static_cast<long long>(v) * kVec;
    float mu[kVec], rs[kVec], gr[kVec];
    channel_stats(mean, var, v, eps, mu, rs);
#pragma unroll
    for (int i = 0; i < kVec; ++i) gr[i] = to_f32(gamma[v * kVec + i]) * rs[i];
    for (long long r = r0 + threadIdx.y; r < r1; r += U * step) {
      Raw8<T> xr[U], dr[U], yr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u * step < r1) {
          const long long off = (r + u * step) * c + col;
          load_raw(x + off, xr[u]);
          load_raw(dy + off, dr[u]);
          if (relu) load_raw(y + off, yr[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u * step < r1) {
          const long long off = (r + u * step) * c + col;
          float xv[kVec], d[kVec], out[kVec];
          widen(xr[u], xv);
          widen(dr[u], d);
          if (relu) mask_relu(yr[u], d);
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
    }
  }
  __shared__ float buf[kThreads * kVec];
  column_sums(buf, sg, psg, c);
  column_sums(buf, sb, psb, c);
  finish_tile(psg, psb, c, counters, dg, db);
}

template <typename T, typename P>
int train_bwd(const void* x, const void* g, const float* mean,
              const float* var, const void* y, const void* dy, void* dx,
              void* dres, float* dg, float* db, float* psg, float* psb,
              long long rows, int c, int tx, int chunks,
              long long rows_per_chunk, int resident, int smem_bytes,
              float eps, int relu, cudaStream_t stream) {
  dim3 block;
  int tiles;
  const long long row_bytes = 2LL * tx * kVec * sizeof(T);
  if (rows <= 0 || chunks < 1 || chunks > 65535 || rows_per_chunk < 1 ||
      static_cast<long long>(chunks) * rows_per_chunk < rows ||
      resident < 0 || resident > rows_per_chunk ||
      !block_shape(c, tx, &block, &tiles) || (relu && y == nullptr) ||
      smem_bytes < kBwdFixedSmem + resident * row_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  // A refused launch (more CTAs than the card holds at once, too much
  // shared memory) returns its error; nothing falls back.
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const T* yt = static_cast<const T*>(y);
  const P* gt = static_cast<const P*>(g);
  T* dxt = static_cast<T*>(dx);
  T* drt = static_cast<T*>(dres);
  void* args[] = {&xt, &dyt, &yt, &gt, &mean, &var, &rows, &c,
                  &rows_per_chunk, &resident, &eps, &relu, &psg, &psb,
                  &dg, &db, &dxt, &drt};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&train_bwd_kernel<T, P>),
      dim3(tiles, chunks), block, args, static_cast<size_t>(smem_bytes),
      stream);
  if (e != cudaSuccess) cudaGetLastError();   // not left for the next check
  return static_cast<int>(e);
}

// Lift the kernel's dynamic shared-memory limit to the card's opt-in
// maximum (once, outside any graph capture), then report how many of its
// 256-thread CTAs with smem_bytes of shared memory one SM holds at once.
template <typename T, typename P>
int train_bwd_occupancy(int smem_bytes, int* blocks) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(&train_bwd_kernel<T, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, &train_bwd_kernel<T, P>, kThreads,
        static_cast<size_t>(smem_bytes));
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

template <typename T, typename P>
int norm_bwd(const void* x, const void* g, const float* mean,
             const float* var, const void* y, const void* dy, void* dx,
             void* dres, float* dg, float* db, float* psg, float* psb,
             int* counters, long long rows, int c, int tx, int chunks,
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
      psg, psb, counters, dg, db);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype (x, y, dy, dx, dres) and pdtype (gamma): 0 = float32,
// 1 = bfloat16, 2 = float16 (with_dtype), in any pairing. mean/var: f32 [C]; dg/db: f32 [C] outputs; psg/psb: f32
// [chunks, C] scratch. y may be null when relu == 0, dres when no
// residual gradient is wanted. The training call is one cooperative
// launch of tiles x chunks CTAs, each keeping its first `resident` rows
// in smem_bytes of dynamic shared memory (the plan of
// ops/fused_bn_bwd.py). Returns a cudaError_t (0 = success).
int p1t_fused_bn_bwd_train(const void* x, const void* g, const void* mean,
                           const void* var, const void* y, const void* dy,
                           void* dx, void* dres, void* dg, void* db,
                           void* psg, void* psb, long long rows, int c,
                           int tx, int chunks, long long rows_per_chunk,
                           int resident, int smem_bytes, float eps, int relu,
                           int dtype, int pdtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto m = static_cast<const float*>(mean);
  auto v = static_cast<const float*>(var);
  auto a = static_cast<float*>(dg);
  auto b = static_cast<float*>(db);
  auto pa = static_cast<float*>(psg);
  auto pb = static_cast<float*>(psb);
  return with_dtype(dtype, [&](auto t) {
    return with_dtype(pdtype, [&](auto p) {
      return train_bwd<typename decltype(t)::type, typename decltype(p)::type>(
          x, g, m, v, y, dy, dx, dres, a, b, pa, pb, rows, c, tx, chunks,
          rows_per_chunk, resident, smem_bytes, eps, relu, s);
    });
  });
}

// CTAs of the training kernel with smem_bytes of dynamic shared memory
// that one SM holds at once (see train_bwd_occupancy).
int p1t_fused_bn_bwd_train_occupancy(int dtype, int pdtype, int smem_bytes,
                                     int* blocks) {
  return with_dtype(dtype, [&](auto t) {
    return with_dtype(pdtype, [&](auto p) {
      return train_bwd_occupancy<typename decltype(t)::type,
                                 typename decltype(p)::type>(smem_bytes,
                                                             blocks);
    });
  });
}

// Given statistics, one launch: as above, with counters: int32
// [tiles * kCountersPerTile], 0 before the launch and left 0 by it.
int p1t_fused_bn_bwd_norm(const void* x, const void* g, const void* mean,
                          const void* var, const void* y, const void* dy,
                          void* dx, void* dres, void* dg, void* db,
                          void* psg, void* psb, void* counters,
                          long long rows, int c, int tx, int chunks,
                          long long rows_per_chunk, float eps, int relu,
                          int dtype, int pdtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto m = static_cast<const float*>(mean);
  auto v = static_cast<const float*>(var);
  auto a = static_cast<float*>(dg);
  auto b = static_cast<float*>(db);
  auto pa = static_cast<float*>(psg);
  auto pb = static_cast<float*>(psb);
  auto ct = static_cast<int*>(counters);
  return with_dtype(dtype, [&](auto t) {
    return with_dtype(pdtype, [&](auto p) {
      return norm_bwd<typename decltype(t)::type, typename decltype(p)::type>(
          x, g, m, v, y, dy, dx, dres, a, b, pa, pb, ct, rows, c, tx, chunks,
          rows_per_chunk, eps, relu, s);
    });
  });
}

// CTAs of the given-statistics kernel (256 threads) that one SM holds at
// once, for the launch plan's one-wave grid. Returns a cudaError_t.
int p1t_fused_bn_bwd_norm_occupancy(int dtype, int pdtype, int* blocks) {
  return with_dtype(dtype, [&](auto t) {
    return with_dtype(pdtype, [&](auto p) {
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks,
          norm_bwd_kernel<typename decltype(t)::type,
                          typename decltype(p)::type>,
          kThreads, 0));
    });
  });
}

const char* p1t_fused_bn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
