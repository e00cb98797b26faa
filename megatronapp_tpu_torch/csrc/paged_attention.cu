// Ragged paged attention for Hopper (sm_90a), decode and ragged modes.
//
// Replaces the TPU kernel megatronapp_tpu/ops/pallas/kernel_gen.py
// emit_paged_kernel (driven by kernel_gen.paged_attention) for bf16 pools and
// for quantized pools: int8 or fp8 (e4m3) pages with per-(row, kv-head) fp32
// scale pools read through the same page table (kernel_gen.py:856-860).
// It computes the same function: each query row attends the K/V rows of its
// slot, read through the slot's page table, with an online softmax over
// [0, kv_len); ragged rows add the causal limit kv_len - q_len + s on the
// new tail, and query head h reads kv head h / group (GQA).
//
// Design. The TPU kernel walks the pages as a sequential grid axis and
// carries acc/m/l in VMEM from page 0 to the last. Here one thread block
// owns (slot b, kv head hk, a tile of up to kRows query rows (s, g)) and
// loops over the slot's pages itself: it reads page_table[b, j] from device
// memory, stops at ceil(kv_len / bs) (the TPU kernel's pl.when(j*bs <
// kv_len)), and copies the page's [bs, D] K and V rows for its kv head into
// shared memory with 16-byte loads. Scores, the softmax statistics and the
// P tile live in shared memory; the [rows, D] fp32 accumulator lives in
// registers, one column per thread. Score, softmax and PV work covers only
// the tile's real rows: a decode tile holds `group` of its 32 row slots.
//
// Numerics kept from the TPU kernel. bf16 pools: q is scaled in fp32 and
// rounded to bf16 before QK; P is rounded to bf16 before PV. Quantized
// pools: each element dequantizes as float(page) * scale[row, head] as the
// page is staged (_dequant_block, kernel_gen.py:77-80), and the body is fp32
// throughout: the TPU kernel casts q and P to the dequantized block's dtype
// (kernel_gen.py:272, :313), which is fp32 there, so q and P are not rounded.
// Both: m, l and acc are fp32; the -1e30 sentinel, m_safe, the corr = 0
// guard when m_prev <= -5e29 and l >= 1e-20 are the same, so padding rows
// of a ragged chunk give finite garbage, never NaN. V rows past kv_len are
// zeroed on load, so stale pool bytes can never reach the output through a
// zero probability.
//
// Bound: the bytes of K and V read (each valid page once per q-row tile; one
// byte an element and 4 bytes a row of scales for quantized pools, so half
// the bf16 bytes); the arithmetic is two [rows, D] x [D, bs] products per
// page, far below the card's ridge point. The fp32 staging of quantized
// pools costs no time: their kernels ran at 0.78x (decode) and 0.86x
// (ragged) the bf16 kernel's time (chip_smoke.py's times phase, NVIDIA H100
// 80GB HBM3 at 700.00 W), which converts bf16 in its inner loops. This
// first version is simple, not
// fast: it does not use wgmma, TMA or cp.async double buffering, and it does
// not split the KV range across blocks, so decode at B=8 on llama3-8b (8 kv
// heads) launches only 64 blocks on 132 SMs, and a chunked-prefill launch
// (one request, S_q=32) only 32, each walking the slot's pages serially.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kRows = 32;       // query rows (s, g) per block
constexpr int kMaxBlockSize = 64;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Page element types: bf16 pools, and the two quantized formats.
typedef __nv_bfloat16 bf16;
typedef __nv_fp8_e4m3 fp8;

template <typename TP>
struct Page {
  // bf16 pools stage K/V as bf16 rows of D + 8 elements; quantized pools
  // stage them dequantized, as fp32 rows of D + 4 (16-byte rows either way).
  static constexpr bool kQuant = !std::is_same<TP, bf16>::value;
  typedef typename std::conditional<kQuant, float, bf16>::type Staged;
  static constexpr int kPad = kQuant ? 4 : 8;   // row length D + kPad
};

__device__ __forceinline__ float dequant(int8_t v, float s) { return (float)v * s; }
__device__ __forceinline__ float dequant(fp8 v, float s) { return (float)v * s; }

template <int D, typename TP>
size_t smem_bytes(int bs) {
  typedef typename Page<TP>::Staged S;
  return (size_t)(kRows + 2 * bs) * (D + Page<TP>::kPad) * sizeof(S) +
         (size_t)(kRows * bs + 3 * kRows) * sizeof(float);
}

template <int D, typename TP>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const bf16* __restrict__ q,
                       const TP* __restrict__ k_pages,
                       const TP* __restrict__ v_pages,
                       const float* __restrict__ k_scales,   // quantized only
                       const float* __restrict__ v_scales,
                       const int* __restrict__ page_table,
                       const int* __restrict__ kv_lens,
                       const int* __restrict__ q_lens,   // nullptr: decode
                       bf16* __restrict__ out,
                       int s_q, int hq, int hkv, int bs, int mb, float scale) {
  static_assert(kThreads % D == 0 && kRows % (kThreads / D) == 0, "tile");
  constexpr bool kQuant = Page<TP>::kQuant;
  typedef typename Page<TP>::Staged S;
  constexpr int LD = D + Page<TP>::kPad;
  constexpr int kVec = 16 / (int)sizeof(TP);     // elements a 16-byte load
  constexpr int kChunks = D / kVec;              // 16-byte chunks per row
  constexpr int kRowGroups = kThreads / D;       // threads per column
  constexpr int kAccRows = kRows / kRowGroups;   // acc rows per thread

  const int b = blockIdx.x;
  const int hk = blockIdx.y;
  const int group = hq / hkv;
  const int r0 = blockIdx.z * kRows;
  const int rows = min(kRows, s_q * group - r0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* q_s = reinterpret_cast<S*>(smem_raw);                // [kRows][LD]
  S* k_s = q_s + kRows * LD;                              // [bs][LD]
  S* v_s = k_s + bs * LD;                                 // [bs][LD]
  float* p_s = reinterpret_cast<float*>(v_s + bs * LD);   // [kRows][bs]
  float* m_s = p_s + kRows * bs;                          // [kRows]
  float* l_s = m_s + kRows;                               // [kRows]
  float* c_s = l_s + kRows;                               // [kRows]

  const int kv_len = kv_lens[b];
  const int q_len = q_lens != nullptr ? q_lens[b] : 1;
  const int q_start = kv_len - q_len;   // absolute position of local query 0

  // q tile: scaled in fp32 (kernel_gen.py:252); rounded to bf16 for bf16
  // pools only (:272).
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float val = 0.f;
    if (r < rows) {
      const int s = (r0 + r) / group, h = hk * group + (r0 + r) % group;
      val = __bfloat162float(q[(((size_t)b * s_q + s) * hq + h) * D + d]) * scale;
    }
    if constexpr (kQuant) q_s[r * LD + d] = val;
    else q_s[r * LD + d] = __float2bfloat16(val);
  }
  for (int r = tid; r < kRows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  float acc[kAccRows];
#pragma unroll
  for (int i = 0; i < kAccRows; ++i) acc[i] = 0.f;
  const int dcol = tid % D;
  const int rgrp = tid / D;   // this thread's rows: rgrp + i * kRowGroups

  const int num_pages = min((kv_len + bs - 1) / bs, mb);
  __syncthreads();

  for (int j = 0; j < num_pages; ++j) {
    const int blk = page_table[(size_t)b * mb + j];
    for (int i = tid; i < bs * kChunks; i += kThreads) {
      const int c = i / kChunks, chunk = i % kChunks;
      const size_t row = ((size_t)blk * bs + c) * hkv + hk;
      const size_t off = row * D + chunk * kVec;
      const bool live = j * bs + c < kv_len;
      const uint4 kk = *reinterpret_cast<const uint4*>(k_pages + off);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (live) vv = *reinterpret_cast<const uint4*>(v_pages + off);
      if constexpr (kQuant) {
        // Dequantize as staged: float(page) * scale[row, head].
        const float ks = k_scales[row];
        const float vs = live ? v_scales[row] : 0.f;
        const TP* ke = reinterpret_cast<const TP*>(&kk);
        const TP* ve = reinterpret_cast<const TP*>(&vv);
        float* kd = k_s + c * LD + chunk * kVec;
        float* vd = v_s + c * LD + chunk * kVec;
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          *reinterpret_cast<float4*>(kd + e) = make_float4(
              dequant(ke[e], ks), dequant(ke[e + 1], ks),
              dequant(ke[e + 2], ks), dequant(ke[e + 3], ks));
          *reinterpret_cast<float4*>(vd + e) = make_float4(
              dequant(ve[e], vs), dequant(ve[e + 1], vs),
              dequant(ve[e + 2], vs), dequant(ve[e + 3], vs));
        }
      } else {
        *reinterpret_cast<uint4*>(k_s + c * LD + chunk * kVec) = kk;
        *reinterpret_cast<uint4*>(v_s + c * LD + chunk * kVec) = vv;
      }
    }
    __syncthreads();

    // Scores of the tile's real rows, with the ragged causal mask
    // (decode is q_len 1, s 0).
    for (int i = tid; i < rows * bs; i += kThreads) {
      const int r = i / bs, c = i % bs;
      float sc = kNegInf;
      const int pos = j * bs + c;
      if (pos < kv_len && pos <= q_start + (r0 + r) / group) {
        float dot = 0.f;
        if constexpr (kQuant) {
          const float4* qp = reinterpret_cast<const float4*>(q_s + r * LD);
          const float4* kp = reinterpret_cast<const float4*>(k_s + c * LD);
#pragma unroll 8
          for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 a = qp[d4], k4 = kp[d4];
            dot = fmaf(a.x, k4.x, dot);
            dot = fmaf(a.y, k4.y, dot);
            dot = fmaf(a.z, k4.z, dot);
            dot = fmaf(a.w, k4.w, dot);
          }
        } else {
          const __nv_bfloat162* qp = reinterpret_cast<const __nv_bfloat162*>(q_s + r * LD);
          const __nv_bfloat162* kp = reinterpret_cast<const __nv_bfloat162*>(k_s + c * LD);
#pragma unroll 8
          for (int d2 = 0; d2 < D / 2; ++d2) {
            const float2 a = __bfloat1622float2(qp[d2]);
            const float2 k2 = __bfloat1622float2(kp[d2]);
            dot = fmaf(a.x, k2.x, dot);
            dot = fmaf(a.y, k2.y, dot);
          }
        }
        sc = dot;
      }
      p_s[r * bs + c] = sc;
    }
    __syncthreads();

    // Online softmax, one warp per real row (kernel_gen.py:298-305).
    for (int r = warp; r < rows; r += kThreads / 32) {
      float mx = kNegInf;
      for (int c = lane; c < bs; c += 32) mx = fmaxf(mx, p_s[r * bs + c]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = fmaxf(m_new, kNegInf / 2);
      float sum = 0.f;
      for (int c = lane; c < bs; c += 32) {
        const float sc = p_s[r * bs + c];
        const float p = sc > kNegInf / 2 ? expf(sc - m_safe) : 0.f;
        sum += p;
        // P is cast to the V block's dtype before PV (kernel_gen.py:313):
        // bf16 for bf16 pools, fp32 (no rounding) for quantized ones.
        p_s[r * bs + c] = kQuant ? p : __bfloat162float(__float2bfloat16(p));
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = m_prev <= kNegInf / 2 ? 0.f : expf(fminf(m_prev - m_new, 0.f));
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P @ V, one output column per thread; rows past
    // the tile's real rows (a decode tile holds `group` of them) are
    // skipped, uniformly across the block.
#pragma unroll
    for (int i = 0; i < kAccRows; ++i) {
      const int r = rgrp + i * kRowGroups;
      if (r >= rows) break;
      float pv = 0.f;
      for (int c = 0; c < bs; ++c) {
        float vval;
        if constexpr (kQuant) vval = v_s[c * LD + dcol];
        else vval = __bfloat162float(v_s[c * LD + dcol]);
        pv = fmaf(p_s[r * bs + c], vval, pv);
      }
      acc[i] = acc[i] * c_s[r] + pv;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kAccRows; ++i) {
    const int r = rgrp + i * kRowGroups;
    if (r < rows) {
      const int s = (r0 + r) / group, h = hk * group + (r0 + r) % group;
      const float l = fmaxf(l_s[r], 1e-20f);
      out[(((size_t)b * s_q + s) * hq + h) * D + dcol] = __float2bfloat16(acc[i] / l);
    }
  }
}

template <int D, typename TP>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales,
           const void* page_table, const void* kv_lens, const void* q_lens,
           void* out, int batch, int s_q, int hq, int hkv, int bs, int mb,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D, TP>(bs);
  auto kernel = paged_attention_kernel<D, TP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch, hkv, (s_q * (hq / hkv) + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const TP*>(k_pages),
      static_cast<const TP*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales),
      static_cast<const int*>(page_table), static_cast<const int*>(kv_lens),
      static_cast<const int*>(q_lens), static_cast<bf16*>(out),
      s_q, hq, hkv, bs, mb, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_kind(int page_kind, const void* q, const void* k_pages,
                const void* v_pages, const void* k_scales,
                const void* v_scales, const void* page_table,
                const void* kv_lens, const void* q_lens, void* out, int batch,
                int s_q, int hq, int hkv, int bs, int mb, float scale,
                cudaStream_t st) {
  if (page_kind == 0)
    return launch<D, bf16>(q, k_pages, v_pages, k_scales, v_scales, page_table,
                           kv_lens, q_lens, out, batch, s_q, hq, hkv, bs, mb,
                           scale, st);
  if (page_kind == 1)
    return launch<D, int8_t>(q, k_pages, v_pages, k_scales, v_scales,
                             page_table, kv_lens, q_lens, out, batch, s_q, hq,
                             hkv, bs, mb, scale, st);
  return launch<D, fp8>(q, k_pages, v_pages, k_scales, v_scales, page_table,
                        kv_lens, q_lens, out, batch, s_q, hq, hkv, bs, mb,
                        scale, st);
}

}  // namespace

// q [batch, s_q, hq, D] bf16 (decode: s_q == 1 and q_lens == nullptr),
// pools [NB, bs, hkv, D] of page_kind 0 (bf16), 1 (int8) or 2 (fp8 e4m3),
// k_scales / v_scales [NB, bs, hkv] fp32 for page kinds 1 and 2 (else
// unused), page_table [batch, mb] int32, kv_lens / q_lens [batch] int32, out
// like q. Returns a cudaError_t code (0 = launched).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* page_table,
    const void* kv_lens, const void* q_lens, void* out, int batch, int s_q,
    int hq, int hkv, int head_dim, int block_size, int max_blocks,
    int page_kind, float scale, void* stream) {
  if (batch < 1 || s_q < 1 || hkv < 1 || hq % hkv != 0 || block_size < 1 ||
      block_size > kMaxBlockSize || max_blocks < 1 || page_kind < 0 ||
      page_kind > 2 || (page_kind > 0 && (k_scales == nullptr || v_scales == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 128)
    return launch_kind<128>(page_kind, q, k_pages, v_pages, k_scales, v_scales,
                            page_table, kv_lens, q_lens, out, batch, s_q, hq,
                            hkv, block_size, max_blocks, scale, st);
  if (head_dim == 64)
    return launch_kind<64>(page_kind, q, k_pages, v_pages, k_scales, v_scales,
                           page_table, kv_lens, q_lens, out, batch, s_q, hq,
                           hkv, block_size, max_blocks, scale, st);
  return (int)cudaErrorInvalidValue;
}
