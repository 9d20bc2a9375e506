// Fused batch norm, forward: batch statistics + normalize + affine
// (+ residual) + activation over a channels-last [rows, C] tensor.
//
// Replaces paddle1_tpu/ops/pallas/fused_bn.py::_bn_train_kernel (training
// mode: statistics from the batch) and ::_bn_norm_kernel (given
// statistics: eval, use_global_stats). Same numerics contract: f32 sums
// of x and x^2, mean = s / rows and var = max(ss / rows - mean^2, 0) with
// the exact count as a host constant, f32 statistics out, then
// y = act((x - mean) * rsqrt(var + eps) * gamma + beta [+ res]) cast to
// the storage type at the edge (not folded into one scale and shift; no
// Welford, no two-pass variance). act is identity or relu.
//
// Bound on an H100: memory. Per element the work is a handful of flops
// against 2-4 bytes moved in bf16, far below the card's balance point.
// The compulsory traffic is x read once and y written once (plus the
// residual).
//
// Training mode is ONE cooperative launch of a persistent grid (as many
// CTAs as the card holds at once, two 256-thread CTAs an SM, from the
// occupancy API), the structure of the training backward in
// fused_bn_bwd.cu. A CTA owns a channel tile and a chunk of consecutive
// rows:
//   A. it copies its chunk's last `resident` rows of x into shared memory
//      with cp.async, streams the rest through registers (several rows'
//      16-byte loads in flight, while the copies land), sums x and x^2
//      per channel in f32 and writes one partial row of each per
//      sub-chunk: the chunks of the local-moments pass (moments_kernel's)
//      summed in its order, so the statistics are that pass's bit for
//      bit (a ResNet-50's f32 gradients turn on their
//      last bits: tools/torch_resnet_grad_gap.py);
//   B. grid barrier; one warp per channel sums the partial rows in chunk
//      order (no atomics: repeats are bit-identical) into mean and var;
//      grid barrier;
//   C. y from the resident rows in shared memory, and from the rows that
//      did not fit re-read in the reverse of phase A's order, so the last
//      streamed come from L2.
// Where the whole chunk fits (ResNet-50 at 32 images from layer 2 on, in
// bf16) x crosses device memory once. The Pallas kernel's sequential
// (2, row_blocks) grid keeps the running sums in VMEM between its phases;
// here the grid barrier hands them over, with the rows held on chip.
//
// Given-statistics mode is phase C alone (normalize_kernel). At
// ResNet-50's layer 4 ([1568, 2048] at 32 images) that pass has about
// 1.5 rows a thread, so it is latency and set-up, not bytes: the grid is
// one wave of resident CTAs (the launch plan sizes it from the occupancy
// API), the CTA loads its tile's statistics and affine once into shared
// memory, coalesced, with one rsqrt per channel, and each thread has its
// first rows' 16-byte loads in flight before that set-up and several rows
// in flight after it.
//
// Local moments (replaces ::_moments_kernel, SyncBatchNorm's per-rank
// statistics pass): ONE launch writing the raw f32 sums of x and x^2 per
// channel, which the caller all-reduces across ranks before it
// normalizes. Each CTA sums its chunk of rows into a partial row
// ([chunks, C], fused_bn_common.cuh), several rows' loads in flight a
// thread; the last CTAs to arrive (int32 tickets, no grid barrier:
// finish_tile) sum the partial rows in the fixed order, so no second
// launch. One read of x: the compulsory traffic.
//
// Loads are 16 B (8 bf16 or f16) or 32 B (8 f32) per thread, neighbouring
// threads on neighbouring channels; rows are strided across the block's
// warps. Built by paddle1_tpu_torch/ops/cuda/build.py with nvcc for
// sm_90a into a shared library with a plain C interface (ctypes).

#include <cooperative_groups.h>

#include <climits>

#include "fused_bn_common.cuh"

namespace {

using namespace p1t_bn;

// Local moments: grid (tiles, chunks) of stats_plan (ops/fused_bn.py),
// block (TX, TY). Each thread sums its vector over its chunk's rows
// r0 + ty, r0 + ty + TY, ... in order, with the loads of RowsInFlight of
// them issued before any is added; the block writes one partial row of
// each sum (column_sums), and the last blocks to arrive sum the partial
// rows into s/ss (finish_tile). The training forward's statistics repeat
// this order bit for bit. At 64 registers a thread, four CTAs fit an SM,
// so stats_plan's grid of about four CTAs an SM is one wave.
template <typename T>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const T* __restrict__ x, long long rows, int c,
               long long rows_per_chunk, float* ps, float* pss,
               int* counters, float* __restrict__ s_out,
               float* __restrict__ ss_out) {
  constexpr int U = RowsInFlight<T>::value;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_chunk;
  long long r1 = r0 + rows_per_chunk;
  if (r1 > rows) r1 = rows;
  const long long step = blockDim.y;
  float s[kVec] = {}, ss[kVec] = {};
  if (v < c / kVec) {
    const long long col = static_cast<long long>(v) * kVec;
    for (long long r = r0 + threadIdx.y; r < r1; r += U * step) {
      Raw8<T> xr[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r + u * step < r1) load_raw(x + (r + u * step) * c + col, xr[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u * step < r1) {
          float xv[kVec];
          widen(xr[u], xv);
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            s[i] += xv[i];
            ss[i] += xv[i] * xv[i];
          }
        }
      }
    }
  }
  __shared__ float buf[kThreads * kVec];
  column_sums(buf, s, ps, c);
  column_sums(buf, ss, pss, c);
  finish_tile(ps, pss, c, counters, s_out, ss_out);
}

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
  constexpr int U = RowsInFlight<T>::value;
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

// Shared memory ahead of the resident rows of the training forward: the
// column-sum scratch (kThreads x 8 floats) and four per-channel
// coefficient rows (mean, rstd, gamma, beta) of the widest tile. The
// launch plan (ops/fused_bn.py, train_fwd_plan) mirrors this constant.
constexpr int kFwdFixedSmem = kThreads * kVec * 4 + 4 * kTileMax * 4;

// training mode, the whole forward in one cooperative launch (see the
// note at the top). Grid (tiles, chunks), block (TX, TY); CTA (t, k) owns
// channels [t * TX * 8, ...) of rows [k * rows_per_chunk, ...), which it
// sums as `subs` sub-chunks of sub_rows consecutive rows: the chunks of
// the local-moments pass (moments_kernel, ops/fused_bn.py stats_plan),
// each a partial row of its own, with each thread on local rows
// sub_start + ty, + TY, ... in order, so the statistics are the ones that
// pass computes, bit for bit. The chunk's last `resident` rows
// are held in shared memory: the rows streamed come first in that order,
// so their loads overlap the copies.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads, 2)
train_fwd_kernel(const T* __restrict__ x, const P* __restrict__ gamma,
                 const P* __restrict__ beta, const T* __restrict__ res,
                 long long rows, int c, long long rows_per_chunk,
                 long long sub_rows, int subs, int sub_chunks, int resident,
                 float inv_count, float eps, int relu, float* ps, float* pss,
                 float* mean, float* var, T* __restrict__ y) {
  constexpr int U = RowsInFlight<T>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  float* scratch = reinterpret_cast<float*>(smem);
  float* coef = scratch + kThreads * kVec;     // [4][kTileMax]
  const int tile_w = blockDim.x * kVec;
  T* xs = reinterpret_cast<T*>(smem + kFwdFixedSmem);  // [resident][tile_w]
  const int c0 = blockIdx.x * tile_w;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = v < c / kVec;
  const long long col = static_cast<long long>(v) * kVec;
  const int lo = threadIdx.x * kVec;
  const int ty = threadIdx.y, nty = blockDim.y;
  const int tid = ty * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * nty;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_chunk;
  const long long left = rows - r0;
  const int n_local = static_cast<int>(
      left < 0 ? 0 : (left < rows_per_chunk ? left : rows_per_chunk));
  const int n_res = resident < n_local ? resident : n_local;
  const int first_res = n_local - n_res;  // the chunk's last rows are held
  const int sr = static_cast<int>(sub_rows);
  // this thread's rows, sub-chunk by sub-chunk: local j * sr + ty + k * TY
  // for k < rows_in(j), the first str_in(j) of them streamed, the rest
  // resident (at slot local - first_res of shared memory)
  auto rows_in = [&](int j) {
    const int end = min((j + 1) * sr, n_local), first = j * sr + ty;
    return live && first < end ? (end - first + nty - 1) / nty : 0;
  };
  auto local_of = [&](int j, int k) { return j * sr + ty + k * nty; };
  auto str_in = [&](int j) {
    const int first = j * sr + ty;
    return first < first_res
               ? min(rows_in(j), (first_res - first + nty - 1) / nty)
               : 0;
  };
  auto smem_of = [&](int local) {
    return static_cast<long long>(local - first_res) * tile_w + lo;
  };

  // phase A.1: the resident rows' copies go out first
  for (int j = 0; j < subs; ++j)
    for (int k = str_in(j), n = rows_in(j); k < n; ++k)
      copy_async(xs + smem_of(local_of(j, k)),
                 x + (r0 + local_of(j, k)) * c + col);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // phase A.2: each sub-chunk's sums in row order: the streamed rows
  // through registers (several in flight, while the copies land), then
  // the resident ones from shared memory (each thread reads only the
  // vectors it copied); then its partial row
  for (int j = 0; j < subs; ++j) {
    float s[kVec] = {}, ss[kVec] = {};
    auto accumulate = [&](const float (&xv)[kVec]) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        s[i] += xv[i];
        ss[i] += xv[i] * xv[i];
      }
    };
    const int n = rows_in(j), ks = str_in(j);
    for (int k = 0; k < ks; k += U) {
      Raw8<T> xr[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k + u < ks)
          load_raw(x + (r0 + local_of(j, k + u)) * c + col, xr[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k + u < ks) {
          float xv[kVec];
          widen(xr[u], xv);
          accumulate(xv);
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    for (int k = ks; k < n; ++k) {
      Raw8<T> xr;
      load_raw(xs + smem_of(local_of(j, k)), xr);
      float xv[kVec];
      widen(xr, xv);
      accumulate(xv);
    }
    const long long row = static_cast<long long>(blockIdx.y) * subs + j;
    if (row < sub_chunks) {   // uniform across the CTA
      column_sums(scratch, s, ps, c, row);
      column_sums(scratch, ss, pss, c, row);
    }
  }

  // handoff: every partial row is out; one warp per channel sums them as
  // finish_tile does, bit for bit: lane l over the rows k = l, l + 32,
  // ... in order (four of its loads in flight), then the shuffle tree
  cooperative_groups::this_grid().sync();
  const int warps = nt / 32;     // whole warps only (TX * TY may be < 256)
  const int lane = tid & 31;
  if (tid / 32 < warps) {
    const int cta = blockIdx.y * gridDim.x + blockIdx.x;
    const int stride = gridDim.x * gridDim.y * warps;
    for (int ch = cta * warps + tid / 32; ch < c; ch += stride) {
      float a = 0.f, b = 0.f;
      for (int k0 = lane; k0 < sub_chunks; k0 += 4 * 32) {
        float pa[4], pb[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const long long k = k0 + 32 * u;
          if (k < sub_chunks) {
            pa[u] = __ldcg(ps + k * c + ch);
            pb[u] = __ldcg(pss + k * c + ch);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (k0 + 32 * u < sub_chunks) {
            a += pa[u];
            b += pb[u];
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        b += __shfl_xor_sync(0xffffffffu, b, o);
      }
      if (lane == 0) {
        const float m = a * inv_count;
        mean[ch] = m;
        var[ch] = fmaxf(b * inv_count - m * m, 0.f);
      }
    }
  }
  cooperative_groups::this_grid().sync();

  // phase C: the tile's mean, rstd, gamma and beta, once per CTA
  for (int i = tid; i < tile_w; i += nt) {
    const int ch = c0 + i;
    if (ch < c) {
      coef[i] = __ldcg(mean + ch);
      coef[kTileMax + i] = rsqrtf(__ldcg(var + ch) + eps);
      coef[2 * kTileMax + i] = to_f32(gamma[ch]);
      coef[3 * kTileMax + i] = to_f32(beta[ch]);
    }
  }
  __syncthreads();
  if (!live) return;
  float mu[kVec], rs[kVec], g[kVec], bt[kVec];
  load8(coef + lo, mu);
  load8(coef + kTileMax + lo, rs);
  load8(coef + 2 * kTileMax + lo, g);
  load8(coef + 3 * kTileMax + lo, bt);
  auto emit = [&](long long off, const Raw8<T>& xr, const Raw8<T>& rr) {
    float xv[kVec], rv[kVec], out[kVec];
    widen(xr, xv);
    if (res != nullptr) widen(rr, rv);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      float t = (xv[i] - mu[i]) * rs[i];
      t = t * g[i] + bt[i];
      if (res != nullptr) t += rv[i];
      out[i] = relu ? fmaxf(t, 0.f) : t;
    }
    store8(y + off, out);
  };
  // the rows that did not fit, in the reverse of phase A's order
  for (int j = subs - 1; j >= 0; --j) {
    for (int k = str_in(j) - 1; k >= 0; k -= U) {
      Raw8<T> xr[U], rr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k - u >= 0) {
          const long long off = (r0 + local_of(j, k - u)) * c + col;
          load_raw(x + off, xr[u]);
          if (res != nullptr) load_raw(res + off, rr[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k - u >= 0)
          emit((r0 + local_of(j, k - u)) * c + col, xr[u], rr[u]);
    }
  }
  // the resident rows (the residual's loads in flight ahead)
  for (int j = 0; j < subs; ++j) {
    const int n = rows_in(j);
    for (int k = str_in(j); k < n; k += U) {
      Raw8<T> rr[U];
      if (res != nullptr) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (k + u < n)
            load_raw(res + (r0 + local_of(j, k + u)) * c + col, rr[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k + u < n) {
          Raw8<T> xr;
          load_raw(xs + smem_of(local_of(j, k + u)), xr);
          emit((r0 + local_of(j, k + u)) * c + col, xr, rr[u]);
        }
      }
    }
  }
}

template <typename T, typename P>
int train_fwd(const void* x, const void* g, const void* b, const void* res,
              void* y, float* mean, float* var, float* ps, float* pss,
              long long rows, int c, int tx, int chunks,
              long long rows_per_chunk, long long sub_rows, int sub_chunks,
              int resident, int smem_bytes, float eps, int relu,
              cudaStream_t stream) {
  dim3 block;
  int tiles;
  const long long row_bytes = static_cast<long long>(tx) * kVec * sizeof(T);
  int subs = sub_rows < 1 ? 0 : static_cast<int>(rows_per_chunk / sub_rows);
  if (rows <= 0 || chunks < 1 || chunks > 65535 || sub_rows < 1 ||
      sub_rows > INT_MAX || subs < 1 || subs * sub_rows != rows_per_chunk ||
      static_cast<long long>(chunks) * rows_per_chunk < rows ||
      (sub_chunks - 1) * sub_rows >= rows || sub_chunks * sub_rows < rows ||
      resident < 0 || resident > rows_per_chunk ||
      !block_shape(c, tx, &block, &tiles) ||
      smem_bytes < kFwdFixedSmem + resident * row_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  // A refused launch (more CTAs than the card holds at once, too much
  // shared memory) returns its error; nothing falls back.
  const T* xt = static_cast<const T*>(x);
  const P* gt = static_cast<const P*>(g);
  const P* bt = static_cast<const P*>(b);
  const T* rt = static_cast<const T*>(res);
  T* yt = static_cast<T*>(y);
  float inv = static_cast<float>(1.0 / static_cast<double>(rows));
  void* args[] = {&xt, &gt, &bt, &rt, &rows, &c, &rows_per_chunk,
                  &sub_rows, &subs, &sub_chunks, &resident, &inv, &eps,
                  &relu, &ps, &pss, &mean, &var, &yt};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&train_fwd_kernel<T, P>),
      dim3(tiles, chunks), block, args, static_cast<size_t>(smem_bytes),
      stream);
  if (e != cudaSuccess) cudaGetLastError();   // not left for the next check
  return static_cast<int>(e);
}

// Lift the training kernel's dynamic shared-memory limit to the card's
// opt-in maximum (once, outside any graph capture), then report how many
// of its 256-thread CTAs with smem_bytes of shared memory one SM holds at
// once.
template <typename T, typename P>
int train_fwd_occupancy(int smem_bytes, int* blocks) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(&train_fwd_kernel<T, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, &train_fwd_kernel<T, P>, kThreads,
        static_cast<size_t>(smem_bytes));
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
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
            int* counters, long long rows, int c, int tx, int chunks,
            long long rows_per_chunk, cudaStream_t stream) {
  dim3 block;
  int tiles;
  if (rows <= 0 || chunks < 1 || chunks > 65535 ||
      !block_shape(c, tx, &block, &tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  moments_kernel<T><<<dim3(tiles, chunks), block, 0, stream>>>(
      static_cast<const T*>(x), rows, c, rows_per_chunk, ps, pss, counters,
      s, ss);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype (x, res, y) and pdtype (gamma, beta): 0 = float32, 1 = bfloat16,
// 2 = float16 (with_dtype), in any pairing. res may be null. mean/var: f32 [C] outputs; ps/pss: f32
// [sub_chunks, C] scratch. The training call is one cooperative launch of
// tiles x chunks CTAs, each summing its rows_per_chunk rows as sub-chunks
// of sub_rows rows and keeping its last `resident` rows of x in
// smem_bytes of dynamic shared memory (the plan of ops/fused_bn.py,
// train_fwd_plan).
// Returns a cudaError_t (0 = success).
int p1t_fused_bn_train_fwd(const void* x, const void* g, const void* b,
                           const void* res, void* y, void* mean, void* var,
                           void* ps, void* pss, long long rows, int c,
                           int tx, int chunks, long long rows_per_chunk,
                           long long sub_rows, int sub_chunks, int resident,
                           int smem_bytes, float eps, int relu, int dtype,
                           int pdtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto m = static_cast<float*>(mean);
  auto v = static_cast<float*>(var);
  auto a = static_cast<float*>(ps);
  auto q = static_cast<float*>(pss);
  return with_dtype(dtype, [&](auto t) {
    return with_dtype(pdtype, [&](auto p) {
      using T = typename decltype(t)::type;
      using P = typename decltype(p)::type;
      return train_fwd<T, P>(x, g, b, res, y, m, v, a, q, rows, c, tx, chunks,
                             rows_per_chunk, sub_rows, sub_chunks, resident,
                             smem_bytes, eps, relu, s);
    });
  });
}

// CTAs of the training kernel with smem_bytes of dynamic shared memory
// that one SM holds at once (see train_fwd_occupancy).
int p1t_fused_bn_train_fwd_occupancy(int dtype, int pdtype, int smem_bytes,
                                     int* blocks) {
  return with_dtype(dtype, [&](auto t) {
    return with_dtype(pdtype, [&](auto p) {
      return train_fwd_occupancy<typename decltype(t)::type,
                                 typename decltype(p)::type>(smem_bytes,
                                                             blocks);
    });
  });
}

// The current card's SM count, shared memory per SM, the opt-in maximum
// of one CTA and what the card reserves per CTA, in bytes (the
// cooperative launches' plans, forward and backward, size from these).
int p1t_fused_bn_device(int* sms, int* smem_per_sm, int* smem_optin,
                        int* reserved) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_per_sm,
                               cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(reserved,
                               cudaDevAttrReservedSharedMemoryPerBlock, dev);
  return static_cast<int>(e);
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
  return with_dtype(dtype, [&](auto t) {
    return with_dtype(pdtype, [&](auto p) {
      return norm_fwd<typename decltype(t)::type, typename decltype(p)::type>(
          x, m, v, g, b, res, y, rows, c, tx, grid_y, eps, relu, s);
    });
  });
}

// Per-channel f32 sum and sum of squares of x [rows, C]: s/ss f32 [C]
// outputs; ps/pss f32 [chunks, C] scratch; counters: int32
// [tiles * kCountersPerTile], 0 before the launch and left 0 by it. One
// launch.
int p1t_fused_bn_moments(const void* x, void* s, void* ss, void* ps,
                         void* pss, void* counters, long long rows, int c,
                         int tx, int chunks, long long rows_per_chunk,
                         int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto a = static_cast<float*>(s);
  auto b = static_cast<float*>(ss);
  auto pa = static_cast<float*>(ps);
  auto pb = static_cast<float*>(pss);
  auto ct = static_cast<int*>(counters);
  return with_dtype(dtype, [&](auto t) {
    return moments<typename decltype(t)::type>(x, a, b, pa, pb, ct, rows, c,
                                               tx, chunks, rows_per_chunk, st);
  });
}

// CTAs of the normalize kernel (256 threads) that one SM holds at once,
// for the launch plan's one-wave grid. Returns a cudaError_t.
int p1t_fused_bn_norm_occupancy(int dtype, int pdtype, int* blocks) {
  return with_dtype(dtype, [&](auto t) {
    return with_dtype(pdtype, [&](auto p) {
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks,
          normalize_kernel<typename decltype(t)::type,
                           typename decltype(p)::type>,
          kThreads, 0));
    });
  });
}

const char* p1t_fused_bn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
