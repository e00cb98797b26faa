// Tensor-core and asynchronous-copy building blocks for sm_80+ (used on
// sm_90a): cp.async copies into shared memory with zero fill, ldmatrix
// fragment loads, the bf16 m16n8k16 mma with fp32 accumulators, and bf16
// packing.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 g + t, g in [0, 8),
// t in [0, 4)); each register holds two bf16, the lower column in the low
// half:
//   A (16 x 16, row-major): a0 (row g, cols 2t..2t+1), a1 (row g + 8),
//     a2 (row g, cols 8 + 2t..), a3 (row g + 8, cols 8 + 2t..);
//   B (16 x 8, k x n): b0 (k 2t..2t+1, col g), b1 (k 8 + 2t.., col g);
//   C (16 x 8 fp32): c0, c1 (row g, cols 2t, 2t + 1), c2, c3 (row g + 8).
// So the C tiles of two neighbouring 8-column blocks, packed to bf16, are
// the A fragment of a 16-deep product: a result in registers feeds the
// next product without a trip through shared memory (pack_a).
//
// Shared-memory tiles are row-major bf16 with rows of D + 8 elements
// (a 16-byte pad): the 8 row addresses of one ldmatrix matrix then fall in
// 8 different 16-byte bank groups, so the loads are conflict-free.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zeros when !pred (the copy's
// source size is then 0 and nothing is read).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0));
}

// 4 bytes global -> shared (rows of fp32 or int32 that need not be
// 16-byte aligned); zero when !pred.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and each lane receives (row g, cols 2t..2t+1) of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, transposed: each lane receives (rows 2t..2t+1, col g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b (bf16 operands, fp32 accumulators).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of k-chunk kc from C tiles c[2 kc] and c[2 kc + 1],
// rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ldmatrix row addresses (element offsets into a tile of row stride ld)
// for one lane:
// - a_off: the A fragment of rows [r0, r0 + 16), cols [c0, c0 + 16);
// - b_off: two B fragments (n-blocks n0 and n0 + 8, k [c0, c0 + 16)) from
//   a tile stored n-major ([n][k]: the non-transposed load);
// - bt_off: two B fragments (n-blocks n0 and n0 + 8, k [r0, r0 + 16))
//   from a tile stored k-major ([k][n]: the transposed load).
// In both B cases r[0], r[1] are (b0, b1) of block n0 and r[2], r[3] of
// block n0 + 8.
__device__ __forceinline__ int a_off(int lane, int r0, int c0, int ld) {
  return (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}
__device__ __forceinline__ int b_off(int lane, int n0, int c0, int ld) {
  return (n0 + (lane >> 4) * 8 + (lane & 7)) * ld + c0 + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int bt_off(int lane, int r0, int n0, int ld) {
  return (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8;
}

}  // namespace tc
