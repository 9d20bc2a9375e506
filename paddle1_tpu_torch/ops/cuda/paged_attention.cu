// Decode attention over a block-paged K/V pool, split across the cache
// (flash-decoding).
//
// Replaces paddle1_tpu/ops/pallas/paged_attention.py::_kernel.
// Shapes: q [S, W, H, D]; k/v pools [P, ps, H, D]; table [S, mpps] int32
// (page ids; parked rows point at page 0); base [S] int32 (slot length
// before this window). Query row i of slot s sees key positions
// <= base[s] + i. Output [S, W, H, D] in q's type; a row that sees no key
// gives 0. q and the pools are each f32, bf16 or f16, in any pairing (a
// bf16 or f16 cache under an f32 model, an f16 model over an f16 pool):
// q, K and V are each widened to f32, and the scores, the softmax and the
// merge stay in f32 with one cast at the output, as in the Pallas body,
// which also applies the scale to q before the dot product. A page id
// outside [0, P) reads page 0 (the engine never writes one).
//
// Bound on an H100: memory. A decode step reads each live K/V row once
// (2 * live_tokens * D * itemsize bytes per (slot, head)) and does ~4
// flops per K/V element, far below the f32 balance point. At the serving
// shape (16 slots, 8 heads, D = 64, pages of 16) that is ~13 MB: ~4 us.
//
// Design. The TPU kernel carries one online softmax along a sequential
// page axis; its time follows the longest slot. Here each (slot, head)'s
// live pages are cut into splits of kSplitPages pages, and each split is
// one CTA of 4 warps: grid = slots x heads x ceil(mpps / kSplitPages),
// from host-known shapes only (base stays on the device, so the launch
// never waits for it and a CUDA graph can capture it). A CTA
//   1. loads its table entries, the slot's base and the query rows
//      together; a split past the slot's live pages exits at once, so
//      pages past the cursor are never read;
//   2. copies its pages' K and V rows of its head (256 B each in f32, a
//      head's row strided by H * D) into shared memory with cp.async,
//      16 B a thread, every copy of the split in flight at once; bf16
//      and f16 stay 16-bit there and are widened in registers;
//   3. scores: a group of lanes per (row, key) splits D, 4 dims a
//      shared-memory load, and reduces with shuffles, the group as wide
//      as keeps all 128 threads busy (2 lanes a key at W = 1 and 64 keys,
//      so no lane idles);
//   4. softmax over the split: a warp per query row (m, p = exp(s - m),
//      l), then P.V with a group of lanes per (row, 4 dims) splitting the
//      keys;
//   5. writes its f32 partial (acc [W, D], m [W], l [W]); a slot whose
//      live keys fit one split writes the output directly instead.
// The merge runs in the same launch: after __threadfence() each CTA
// counts itself in on its (slot, head)'s counter, and the last to arrive
// merges the partials in split order (no float atomics, so repeats are
// bit-identical whichever CTA merges), its loads issued 8 splits at a
// time, and sets the counter back to 0 for the next launch or graph
// replay. The wrapper allocates the partials and counters once per shape;
// the kernel allocates nothing.
//
// Built by paddle1_tpu_torch/ops/cuda/build.py with nvcc for sm_90a into
// a shared library with a plain C interface, loaded through ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplitPages = 4;  // pages a CTA walks (ops/paged_attention.py)
constexpr int kMergeBatch = 8;  // splits whose partials a merge loads at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
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

// sum over the g adjacent lanes of a group (g a power of two <= 32)
__device__ __forceinline__ float group_sum(float v, int g) {
  for (int o = g >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// lanes a group needs so that `items` groups fill the CTA: the largest
// power of two g <= 32 with items * g <= kThreads (1 when items is large)
__device__ __forceinline__ int group_width(int items) {
  int g = 32;
  while (g > 1 && items * g > kThreads) g >>= 1;
  return g;
}

// Bytes of dynamic shared memory: K and V of one split [keys, D] in the
// pools' type, then the scaled query [W, D], the scores [W, keys] and the
// softmax's m and l [W], all f32 (ops/paged_attention.py, smem_bytes,
// mirrors it).
__host__ __device__ inline long long smem_bytes(int w, int d, int ps,
                                               int kv_size) {
  const long long keys = static_cast<long long>(kSplitPages) * ps;
  return 2 * keys * d * kv_size +
         4 * (static_cast<long long>(w) * d + w * keys + 2LL * w);
}

// Copy the split's np pages of K and V rows of one head into ks / vs
// ([np * ps, d]): 16-byte cp.async copies when every row start is
// 16-byte aligned, else element by element through registers. Where a
// row's 16-byte pieces divide the CTA, each thread keeps one piece and
// steps over rows, so an issue costs an address and two copies.
template <typename T>
__device__ __forceinline__ void copy_split(const T* __restrict__ kp,
                                           const T* __restrict__ vp,
                                           const int (&page)[kSplitPages],
                                           int np, int ps, int d,
                                           long long pos_stride,
                                           long long head_off, T* ks, T* vs,
                                           int tid) {
  constexpr int kVec = 16 / sizeof(T);
  const int nk = np * ps;
  const bool aligned = ((reinterpret_cast<std::uintptr_t>(kp) |
                         reinterpret_cast<std::uintptr_t>(vp)) & 15) == 0 &&
                       d % kVec == 0;
  auto src_of = [&](int t, int c) {   // key t of the split, dim c
    int pg = page[0];
#pragma unroll
    for (int j = 1; j < kSplitPages; ++j)
      if (t >= j * ps) pg = page[j];
    return (static_cast<long long>(pg) * ps + t % ps) * pos_stride +
           head_off + c;
  };
  auto copy16 = [](T* dst, const T* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  };
  const int per_row = aligned ? d / kVec : d;
  if (aligned && kThreads % per_row == 0) {
    const int c = (tid % per_row) * kVec;
    for (int t = tid / per_row; t < nk; t += kThreads / per_row) {
      const long long g = src_of(t, c);
      copy16(ks + t * d + c, kp + g);
      copy16(vs + t * d + c, vp + g);
    }
  } else {
    const int n = nk * per_row;
    for (int i = tid; i < 2 * n; i += kThreads) {
      const bool is_v = i >= n;
      const int idx = is_v ? i - n : i;
      const int t = idx / per_row, piece = idx - t * per_row;
      const int c = aligned ? piece * kVec : piece;
      T* dst = (is_v ? vs : ks) + static_cast<long long>(t) * d + c;
      const T* src = (is_v ? vp : kp) + src_of(t, c);
      if (aligned) copy16(dst, src);
      else *dst = *src;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// V consecutive elements of shared memory widened to f32: one 16-byte
// (f32) or 8-byte (bf16, f16) load when V == 4
__device__ __forceinline__ void loadv(const float* p, float (&o)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  o[0] = f.x; o[1] = f.y; o[2] = f.z; o[3] = f.w;
}
__device__ __forceinline__ void loadv(const __nv_bfloat16* p,
                                      float (&o)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 c = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  o[0] = a.x; o[1] = a.y; o[2] = c.x; o[3] = c.y;
}
__device__ __forceinline__ void loadv(const __half* p, float (&o)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 c = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  o[0] = a.x; o[1] = a.y; o[2] = c.x; o[3] = c.y;
}
template <typename T>
__device__ __forceinline__ void loadv(const T* p, float (&o)[1]) {
  o[0] = to_f32(*p);
}

// Scores of the split into pr [W, nk]: a group of g adjacent lanes per
// (row, key) splits D in vectors of V and reduces with shuffles; where g
// divides D / V, key t starts g * t vectors further on (wrapping), so the
// groups of a warp read K rows from different banks. Keys past row r's
// position (k0 + t > b + r) score -inf.
template <int V, typename TKV>
__device__ __forceinline__ void scores_phase(const float* qs, const TKV* ks,
                                             float* pr, int w_rows, int nk,
                                             int d, int k0, int b, int tid) {
  const int nv = d / V, items = w_rows * nk;
  const int g = group_width(items), gl = tid & (g - 1);
  for (int first = 0; first < items; first += kThreads / g) {
    const int item = first + tid / g;
    float dot = 0.f;
    if (item < items) {
      const int r = item / nk, t = item - r * nk;
      const float* qr = qs + r * d;
      const TKV* kr = ks + t * d;
      int v = gl + (nv % g == 0 ? (g * t) % nv : 0);
      for (int n = gl; n < nv; n += g) {
        float qv[V], kv[V];
        loadv(qr + v * V, qv);
        loadv(kr + v * V, kv);
#pragma unroll
        for (int u = 0; u < V; ++u) dot = fmaf(qv[u], kv[u], dot);
        v += g;
        if (v >= nv) v -= nv;
      }
    }
    dot = group_sum(dot, g);
    if (item < items && gl == 0) {
      const int r = item / nk, t = item - r * nk;
      pr[item] = k0 + t <= b + r ? dot : -CUDART_INF_F;
    }
  }
}

// P.V of the split: g lanes per (row, V dims) split the keys; a group's
// lanes are 32 / g apart, so neighbouring lanes read neighbouring dims of
// one V row. emit(r, c, value) takes each of the W x D sums.
template <int V, typename TKV, typename Emit>
__device__ __forceinline__ void pv_phase(const float* pr, const TKV* vs,
                                         int w_rows, int nk, int d, int tid,
                                         Emit emit) {
  const int nv = d / V, items = w_rows * nv;
  const int g = group_width(items), span = 32 / g;
  const int lane = tid & 31, gl = lane / span;
  for (int first = 0; first < items; first += kThreads / g) {
    const int item = first + (tid >> 5) * span + lane % span;
    float acc[V] = {};
    if (item < items) {
      const int r = item / nv, c = (item - r * nv) * V;
      const float* p = pr + r * nk;
      for (int t = gl; t < nk; t += g) {
        float vv[V];
        loadv(vs + t * d + c, vv);
        const float pt = p[t];
#pragma unroll
        for (int u = 0; u < V; ++u) acc[u] = fmaf(pt, vv[u], acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < V; ++u)
      for (int o = 16; o >= span; o >>= 1)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
    if (item < items && gl == 0) {
      const int r = item / nv, c = (item - r * nv) * V;
#pragma unroll
      for (int u = 0; u < V; ++u) emit(r, c + u, acc[u]);
    }
  }
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_attention_split_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ kp,
    const TKV* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ base, TQ* __restrict__ out, float* part_acc,
    float* part_ml, int* counters, int w_rows, int heads, int d, int ps,
    int mpps, int pages, int n_splits, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int keys = kSplitPages * ps;
  TKV* ks = reinterpret_cast<TKV*>(smem);
  TKV* vs = ks + keys * d;
  float* qs = reinterpret_cast<float*>(vs + keys * d);   // [W, D] scaled
  float* pr = qs + w_rows * d;                           // [W, keys]
  float* ml = pr + w_rows * keys;                        // m [W], l [W]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x % n_splits;
  const int sh = blockIdx.x / n_splits;                  // s * heads + h
  const int h = sh % heads, s = sh / heads;
  const int j0 = split * kSplitPages;
  // the table entries and the base go out together
  int page[kSplitPages];
#pragma unroll
  for (int j = 0; j < kSplitPages; ++j)
    page[j] = j0 + j < mpps ? table[static_cast<long long>(s) * mpps + j0 + j]
                            : 0;
  const int b = base[s];
  const int live = b + w_rows;   // positions 0 .. b + W - 1 may be visible
  const int n_pages = live <= 0 ? 0 : min((live + ps - 1) / ps, mpps);
  const int n_live = (n_pages + kSplitPages - 1) / kSplitPages;
  const long long pos_stride = static_cast<long long>(heads) * d;
  TQ* o = out + static_cast<long long>(s) * w_rows * pos_stride +
          static_cast<long long>(h) * d;
  if (split >= (n_live > 0 ? n_live : 1)) return;   // past the cursor
  if (n_live == 0) {   // no row of the slot sees a key
    for (int i = tid; i < w_rows * d; i += kThreads)
      store(o + (i / d) * pos_stride + i % d, 0.f);
    return;
  }
#pragma unroll
  for (int j = 0; j < kSplitPages; ++j)
    if (page[j] < 0 || page[j] >= pages) page[j] = 0;
  const int np = min(kSplitPages, n_pages - j0);
  const int nk = np * ps;
  copy_split<TKV>(kp, vp, page, np, ps, d, pos_stride,
                  static_cast<long long>(h) * d, ks, vs, tid);
  const TQ* qh = q + static_cast<long long>(s) * w_rows * pos_stride +
                 static_cast<long long>(h) * d;
  for (int i = tid; i < w_rows * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    qs[i] = to_f32(qh[r * pos_stride + c]) * scale;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // scores, 4 dims a load where D allows
  if (d % 4 == 0)
    scores_phase<4>(qs, ks, pr, w_rows, nk, d, j0 * ps, b, tid);
  else
    scores_phase<1>(qs, ks, pr, w_rows, nk, d, j0 * ps, b, tid);
  __syncthreads();

  // the split's softmax, a warp per query row
  for (int r = warp; r < w_rows; r += kWarps) {
    float* row = pr + r * nk;
    float mx = -CUDART_INF_F;
    for (int t = lane; t < nk; t += 32) mx = fmaxf(mx, row[t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < nk; t += 32) {
      const float p = row[t] == -CUDART_INF_F ? 0.f : expf(row[t] - mx);
      row[t] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ml[r] = mx;
      ml[w_rows + r] = sum;
    }
  }
  __syncthreads();

  // P.V, then the output (one split) or the partial
  float* pacc = part_acc + static_cast<long long>(sh) * n_splits * w_rows * d;
  float* pml = part_ml + static_cast<long long>(sh) * n_splits * 2 * w_rows;
  auto emit = [&](int r, int c, float acc) {
    if (n_live == 1) {
      const float l = ml[w_rows + r];
      store(o + r * pos_stride + c, l > 0.f ? acc / l : 0.f);
    } else {
      pacc[(static_cast<long long>(split) * w_rows + r) * d + c] = acc;
    }
  };
  if (d % 4 == 0)
    pv_phase<4>(pr, vs, w_rows, nk, d, tid, emit);
  else
    pv_phase<1>(pr, vs, w_rows, nk, d, tid, emit);
  if (n_live == 1) return;
  for (int i = tid; i < 2 * w_rows; i += kThreads)
    pml[static_cast<long long>(split) * 2 * w_rows + i] = ml[i];

  // count in; the last CTA of the (slot, head) merges
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int arrived = atomicAdd(counters + sh, 1);
    last = arrived == n_live - 1;
    if (last) counters[sh] = 0;   // ready for the next launch or replay
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the partials' loads go out kMergeBatch splits at a time, so a merge
  // costs two round trips to L2 per batch, not two per split
  for (int i = tid; i < w_rows * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    float mx = -CUDART_INF_F;
    for (int k0 = 0; k0 < n_live; k0 += kMergeBatch) {
      float m[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u)
        m[u] = k0 + u < n_live
                   ? __ldcg(pml + static_cast<long long>(k0 + u) * 2 * w_rows +
                            r)
                   : -CUDART_INF_F;
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) mx = fmaxf(mx, m[u]);
    }
    float num = 0.f, den = 0.f;
    for (int k0 = 0; mx != -CUDART_INF_F && k0 < n_live; k0 += kMergeBatch) {
      float m[kMergeBatch], l[kMergeBatch], a[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        const long long k = k0 + u;
        m[u] = -CUDART_INF_F;
        if (k < n_live) {
          m[u] = __ldcg(pml + k * 2 * w_rows + r);
          l[u] = __ldcg(pml + k * 2 * w_rows + w_rows + r);
          a[u] = __ldcg(pacc + (k * w_rows + r) * d + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        if (m[u] == -CUDART_INF_F) continue;
        const float e = expf(m[u] - mx);
        num = fmaf(a[u], e, num);
        den = fmaf(l[u], e, den);
      }
    }
    store(o + r * pos_stride + c, den > 0.f ? num / den : 0.f);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* base, void* out, float* part_acc, float* part_ml,
           int* counters, int slots, int w_rows, int heads, int d, int ps,
           int mpps, int pages, float scale, void* stream) {
  if (slots <= 0 || w_rows <= 0 || heads <= 0 || d <= 0 || ps <= 0 ||
      mpps <= 0 || pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_splits = (mpps + kSplitPages - 1) / kSplitPages;
  const long long grid = static_cast<long long>(slots) * heads * n_splits;
  const long long smem = smem_bytes(w_rows, d, ps, sizeof(TKV));
  if (grid > INT_MAX || smem > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_split_kernel<TQ, TKV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  paged_attention_split_kernel<TQ, TKV><<<static_cast<int>(grid), kThreads,
                                static_cast<size_t>(smem),
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), table, base, static_cast<TQ*>(out),
      part_acc, part_ml, counters, w_rows, heads, d, ps, mpps, pages,
      n_splits, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q_dtype (q and out) and kv_dtype (both pools): 0 = float32,
// 1 = bfloat16, 2 = float16, in any pairing. part_acc: f32 [S * H, ceil(mpps / split), W, D];
// part_ml: f32 [S * H, ceil(mpps / split), 2, W]; counters: int32
// [S * H], all 0 before the first launch (the kernel leaves them 0).
// Returns a cudaError_t (0 = success).
int p1t_paged_attention(const void* q, const void* kp, const void* vp,
                        const int* table, const int* base, void* out,
                        void* part_acc, void* part_ml, void* counters,
                        int slots, int w_rows, int heads, int d, int ps,
                        int mpps, int pages, float scale, int q_dtype,
                        int kv_dtype, void* stream) {
  auto pa = static_cast<float*>(part_acc);
  auto pm = static_cast<float*>(part_ml);
  auto ct = static_cast<int*>(counters);
#define P1T_PAGED(TQ, TKV)                                                 \
  return launch<TQ, TKV>(q, kp, vp, table, base, out, pa, pm, ct, slots,  \
                         w_rows, heads, d, ps, mpps, pages, scale, stream)
  if (q_dtype == 0 && kv_dtype == 0) P1T_PAGED(float, float);
  if (q_dtype == 0 && kv_dtype == 1) P1T_PAGED(float, __nv_bfloat16);
  if (q_dtype == 0 && kv_dtype == 2) P1T_PAGED(float, __half);
  if (q_dtype == 1 && kv_dtype == 0) P1T_PAGED(__nv_bfloat16, float);
  if (q_dtype == 1 && kv_dtype == 1) P1T_PAGED(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == 1 && kv_dtype == 2) P1T_PAGED(__nv_bfloat16, __half);
  if (q_dtype == 2 && kv_dtype == 0) P1T_PAGED(__half, float);
  if (q_dtype == 2 && kv_dtype == 1) P1T_PAGED(__half, __nv_bfloat16);
  if (q_dtype == 2 && kv_dtype == 2) P1T_PAGED(__half, __half);
#undef P1T_PAGED
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* p1t_paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
