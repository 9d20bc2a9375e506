// Tensor-core building blocks for the 16-bit flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): cp.async 16-byte copies
// into shared memory, ldmatrix (plain and transposed) and the
// mma.sync.m16n8k16 bf16 -> f32 and f16 -> f32 products, in inline PTX for
// sm_80 and later. The 16-bit type T (__nv_bfloat16 or __half) picks the
// product's form and the packing of f32 pairs into T pairs; the fragment
// layouts below are the same for both.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), 4 registers of 2 bf16: (g, 2t..2t+1),
//     (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..);
//   B (16 x 8, k x n), 2 registers: (k = 2t..2t+1, n = g), (k = 2t + 8.., g);
//   C (16 x 8, f32), 4 floats: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
// So the C fragments of two adjacent n8 tiles are, packed to bf16 pairs, the
// A fragment of the next k16 product: softmax probabilities never leave
// the registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace p1t_mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8, and r[j] holds matrix j at (row g, columns 2t, 2t + 1)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// the same, transposed: r[j] holds matrix j at (rows 2t, 2t + 1, column g)
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

template <typename T>
__host__ __device__ constexpr bool is_half() {
  return std::is_same<T, __half>::value;
}

// c += a b, T operands, f32 accumulator; a pure function of its
// registers (not volatile), so the compiler may interleave independent
// products
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (is_half<T>()) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// (x, y) rounded to a T pair, as the 32 bits a fragment register holds
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  if constexpr (is_half<T>()) {
    __half2 v = __floats2half2_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// the pair pack2 made, back in f32
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t v) {
  if constexpr (is_half<T>())
    return __half22float2(*reinterpret_cast<const __half2*>(&v));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// (x, y) = hi + lo with hi = T(x, y) and lo = T of the remainder: two
// products then carry x and y to about 2^-17 (bf16) or 2^-22 (f16) of
// their value, where one rounding would lose 2^-9 or 2^-12
template <typename T>
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack2<T>(x, y);
  const float2 hf = unpack2<T>(hi);
  lo = pack2<T>(x - hf.x, y - hf.y);
}

// the A fragments (hi and lo) of the k16 block made of C fragments c0
// (columns 0-7) and c1 (columns 8-15)
template <typename T>
__device__ __forceinline__ void c_to_a(const float (&c0)[4],
                                       const float (&c1)[4],
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split2<T>(c0[0], c0[1], hi[0], lo[0]);
  split2<T>(c0[2], c0[3], hi[1], lo[1]);
  split2<T>(c1[0], c1[1], hi[2], lo[2]);
  split2<T>(c1[2], c1[3], hi[3], lo[3]);
}

}  // namespace p1t_mma
