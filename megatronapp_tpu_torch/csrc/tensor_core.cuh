// Tensor-core and asynchronous-copy building blocks for sm_80+ (used on
// sm_90a): programmatic dependent launch (sm_90), cp.async copies into
// shared memory with zero fill, ldmatrix
// fragment loads, the bf16 m16n8k16 mma with fp32 accumulators, bf16
// packing, fp32 values as bf16 terms, one-byte codes widened to bf16, and
// the warp-level products and the online-softmax step that the flash and
// paged-attention kernels build from them.
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
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
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

// Programmatic dependent launch (sm_90): a kernel launched with the
// programmatic stream serialization attribute may start while the kernel
// before it on the stream runs, once that one's blocks have all called
// pdl_trigger (or exited); pdl_wait then blocks until the kernel before has
// completed and its writes are visible. Without the attribute both are
// no-ops. The rule for such a dependent: before pdl_wait it writes no global
// memory but buffers allocated before the kernel before it was launched.
// PyTorch's caching allocator assumes the kernels of a stream run one after
// another, so a buffer allocated later may be memory that kernel still uses
// (a workspace its wrapper freed on return).
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Launches kernel<<<grid, block, smem, stream>>>(args...) with programmatic
// stream serialization allowed (pdl_wait / pdl_trigger above); returns the
// launch's error code.
template <typename... Params, typename... Args>
inline cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                              cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
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

// The largest / the sum of the four lanes of a quad (lanes 4g..4g+3: the
// lanes that hold one row of a C tile).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// dst = bf16(src * scale) in fp32 over a [ROWS][D + 8] bf16 tile, by NT
// threads (dst may be src).
template <int ROWS, int D, int NT>
__device__ __forceinline__ void scale_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           float scale) {
  constexpr int kChunks = D / 8, LD = D + 8;
  static_assert(ROWS * kChunks % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int off = (i / kChunks) * LD + (i % kChunks) * 8;
    uint4 raw = *reinterpret_cast<const uint4*>(src + off);
    uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      w[j] = pack_bf16(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(dst + off) = raw;
  }
}

// One warp's 16 rows [r0, r0 + 16) of a [*][D + 8] tile as the D / 16 A
// fragments of a product over D, kept in registers.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const __nv_bfloat16* tile,
                                       int r0, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(a[kk], tile + a_off(lane, r0, kk * 16, D + 8));
}

// C[16 x N] = A[16 x D] . B[N, D]^T for one warp: A as fragments in
// registers (load_a), B a [N][D + 8] tile (c[j]: columns 8j..8j+7).
template <int D, int N>
__device__ __forceinline__ void dot_16xN(float (&c)[N / 8][4], const uint32_t (&a)[D / 16][4],
                                         const __nv_bfloat16* b, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + b_off(lane, n0, kk * 16, LD));
      mma_bf16(c[n0 / 8], a[kk], bf[0], bf[1]);
      mma_bf16(c[n0 / 8 + 1], a[kk], bf[2], bf[3]);
    }
}

// acc[16 x D] += X[16 x 16 KC] . B[16 KC, D] for one warp: X as KC A
// fragments in registers (pack_a), B a [16 KC][D + 8] tile read transposed.
template <int D, int KC>
__device__ __forceinline__ void acc_16xD(float (&acc)[D / 8][4], const uint32_t (&x)[KC][4],
                                         const __nv_bfloat16* b, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int n0 = 0; n0 < D; n0 += 16) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b + bt_off(lane, kc * 16, n0, LD));
      mma_bf16(acc[n0 / 8], x[kc], bf[0], bf[1]);
      mma_bf16(acc[n0 / 8 + 1], x[kc], bf[2], bf[3]);
    }
}

constexpr float kNegInf = -1e30f;   // the masked score (the TPU kernels' sentinel)
constexpr float kLog2e = 1.4426950408889634f;

// One kv tile of the online softmax for a warp's 16 rows, on the C tiles
// of s = scores [16 x N] (entries masked out at kNegInf when `masked`):
// m, l are the running max and sum of this lane's rows g and g + 8 (l is
// this lane's share: sum it over the quad at the end), acc [16 x D] the
// running P . V, rescaled here by the step's correction; s becomes P. The
// TPU kernels' numerics: m_safe = max(m_new, -5e29), corr = 0 while
// m_prev <= -5e29, P = exp(s - m_safe) (0 where masked) summed into l
// unrounded; the exponentials run as exp2 with log2(e) folded in, m stays
// in natural units.
template <int D, int N>
__device__ __forceinline__ void online_softmax(float (&s)[N / 8][4], bool masked,
                                               float (&m)[2], float (&l)[2],
                                               float (&acc)[D / 8][4]) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
  float corr[2], ms2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], quad_max(mx[i]));
    ms2[i] = fmaxf(m_new, kNegInf / 2) * kLog2e;   // m_safe, in log2 units
    corr[i] = m[i] <= kNegInf / 2 ? 0.f : exp2_approx(fminf(m[i] - m_new, 0.f) * kLog2e);
    m[i] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float pr = exp2_approx(fmaf(s[j][e], kLog2e, -ms2[i]));
      if (masked && s[j][e] <= kNegInf / 2) pr = 0.f;
      sum[i] += pr;
      s[j][e] = pr;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] *= corr[0];
    acc[j][1] *= corr[0];
    acc[j][2] *= corr[1];
    acc[j][3] *= corr[1];
  }
}

// online_softmax, then acc += bf16(P) . V: P rounded to bf16 as the A
// fragments of the product (the bf16 kernels' rounding point). v is the
// [N][D + 8] V tile.
template <int D, int N>
__device__ __forceinline__ void online_softmax_pv(float (&s)[N / 8][4], bool masked,
                                                  float (&m)[2], float (&l)[2],
                                                  float (&acc)[D / 8][4],
                                                  const __nv_bfloat16* v, int lane) {
  online_softmax<D, N>(s, masked, m, l, acc);
  uint32_t pa[N / 16][4];   // bf16(P) as A fragments
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) pack_a(pa[kc], s[2 * kc], s[2 * kc + 1]);
  acc_16xD<D>(acc, pa, v, lane);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// An fp32 A fragment x (a0..a3's values in order: row g cols 2t, 2t + 1;
// row g + 8; row g cols 8 + 2t, 9 + 2t; row g + 8) as TERMS bf16 terms,
// t1 = bf16(x), t2 = bf16(x - t1), t3 = bf16(x - t1 - t2): each
// difference is exact in fp32, and each term adds 8 significant bits, so
// three terms hold all 24 of fp32 (two: ~2^-16 of x). A product of a term
// and a bf16 B value is exact in the mma's fp32 sum.
template <int TERMS>
__device__ __forceinline__ void split_a(uint32_t (&a)[TERMS][4], const float (&x)[8]) {
  float r[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) r[e] = x[e];
#pragma unroll
  for (int t = 0; t < TERMS; ++t) {
    float h[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      h[e] = round_bf16(r[e]);
      r[e] -= h[e];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) a[t][j] = pack_bf16(h[2 * j], h[2 * j + 1]);
  }
}

// acc[16 x D] += X[16 x N] . B[N, D] for one warp with X unrounded: X is
// fp32 C tiles (x[j]: columns 8j..8j+7), carried into the product as
// TERMS bf16 terms (split_a). Each term runs one mma against the same B
// fragments (a [N][D + 8] tile read transposed), smallest term first.
template <int D, int N, int TERMS>
__device__ __forceinline__ void acc_16xD_split(float (&acc)[D / 8][4], const float (&x)[N / 8][4],
                                               const __nv_bfloat16* b, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = x[2 * kc][e];
      v[4 + e] = x[2 * kc + 1][e];
    }
    uint32_t a[TERMS][4];
    split_a<TERMS>(a, v);
#pragma unroll
    for (int n0 = 0; n0 < D; n0 += 16) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b + bt_off(lane, kc * 16, n0, LD));
#pragma unroll
      for (int t = TERMS - 1; t >= 0; --t) {
        mma_bf16(acc[n0 / 8], a[t], bf[0], bf[1]);
        mma_bf16(acc[n0 / 8 + 1], a[t], bf[2], bf[3]);
      }
    }
  }
}

// 16 one-byte codes (int8 or fp8 e4m3) widened to 16 bf16 values, exactly:
// every int8 value and every finite e4m3 value is a bf16 value.
__device__ __forceinline__ void widen16(const uint4& raw, int8_t, uint4& lo, uint4& hi) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
  uint32_t* w = reinterpret_cast<uint32_t*>(&lo);
  uint32_t* x = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = pack_bf16((float)c[2 * i], (float)c[2 * i + 1]);
    x[i] = pack_bf16((float)c[8 + 2 * i], (float)c[8 + 2 * i + 1]);
  }
}
__device__ __forceinline__ void widen16(const uint4& raw, __nv_fp8_e4m3, uint4& lo, uint4& hi) {
  const __nv_fp8x2_storage_t* c = reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
  uint32_t* w = reinterpret_cast<uint32_t*>(&lo);
  uint32_t* x = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(c[i], __NV_E4M3);
    const float2 f = __half22float2(__half2(h));
    (i < 4 ? w[i] : x[i - 4]) = pack_bf16(f.x, f.y);
  }
}

}  // namespace tc
