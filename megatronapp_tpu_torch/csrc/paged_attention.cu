// Ragged paged attention for Hopper (sm_90a), decode and ragged modes.
//
// Replaces the TPU kernel megatronapp_tpu/ops/pallas/kernel_gen.py
// emit_paged_kernel (driven by kernel_gen.paged_attention) for bf16 pools.
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
// Numerics kept from the TPU kernel: q is scaled in fp32 and rounded to
// bf16 before QK; P is rounded to bf16 before PV; m, l and acc are fp32;
// the -1e30 sentinel, m_safe, the corr = 0 guard when m_prev <= -5e29 and
// l >= 1e-20 are the same, so padding rows of a ragged chunk give finite
// garbage, never NaN. V rows past kv_len are zeroed on load, so stale pool
// bytes can never reach the output through a zero probability.
//
// Bound: the bytes of K and V read (each valid page once per q-row tile);
// the arithmetic is two [rows, D] x [D, bs] products per page, far below
// the card's ridge point. This first version is simple, not fast: it does
// not use wgmma, TMA or cp.async double buffering, and it does not split
// the KV range across blocks, so decode at B=8 on llama3-8b (8 kv heads)
// launches only 64 blocks on 132 SMs, and a chunked-prefill launch (one
// request, S_q=32) only 32, each walking the slot's pages serially.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <int D>
__host__ __device__ constexpr int padded_row() { return D + 8; }  // bf16 elements

template <int D>
size_t smem_bytes(int bs) {
  return (size_t)(kRows + 2 * bs) * padded_row<D>() * sizeof(__nv_bfloat16) +
         (size_t)(kRows * bs + 3 * kRows) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_pages,
                       const __nv_bfloat16* __restrict__ v_pages,
                       const int* __restrict__ page_table,
                       const int* __restrict__ kv_lens,
                       const int* __restrict__ q_lens,   // nullptr: decode
                       __nv_bfloat16* __restrict__ out,
                       int s_q, int hq, int hkv, int bs, int mb, float scale) {
  static_assert(kThreads % D == 0 && kRows % (kThreads / D) == 0, "tile");
  constexpr int LD = padded_row<D>();
  constexpr int kChunks = D / 8;                 // 16-byte chunks per row
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
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRows][LD]
  __nv_bfloat16* k_s = q_s + kRows * LD;                             // [bs][LD]
  __nv_bfloat16* v_s = k_s + bs * LD;                                // [bs][LD]
  float* p_s = reinterpret_cast<float*>(v_s + bs * LD);              // [kRows][bs]
  float* m_s = p_s + kRows * bs;                                     // [kRows]
  float* l_s = m_s + kRows;                                          // [kRows]
  float* c_s = l_s + kRows;                                          // [kRows]

  const int kv_len = kv_lens[b];
  const int q_len = q_lens != nullptr ? q_lens[b] : 1;
  const int q_start = kv_len - q_len;   // absolute position of local query 0

  // q tile: scaled in fp32, rounded to bf16 (kernel_gen.py:252, :272).
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float val = 0.f;
    if (r < rows) {
      const int s = (r0 + r) / group, h = hk * group + (r0 + r) % group;
      val = __bfloat162float(q[(((size_t)b * s_q + s) * hq + h) * D + d]) * scale;
    }
    q_s[r * LD + d] = __float2bfloat16(val);
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
      const size_t off = (((size_t)blk * bs + c) * hkv + hk) * D + chunk * 8;
      const uint4 kk = *reinterpret_cast<const uint4*>(k_pages + off);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (j * bs + c < kv_len) vv = *reinterpret_cast<const uint4*>(v_pages + off);
      *reinterpret_cast<uint4*>(k_s + c * LD + chunk * 8) = kk;
      *reinterpret_cast<uint4*>(v_s + c * LD + chunk * 8) = vv;
    }
    __syncthreads();

    // Scores of the tile's real rows, with the ragged causal mask
    // (decode is q_len 1, s 0).
    for (int i = tid; i < rows * bs; i += kThreads) {
      const int r = i / bs, c = i % bs;
      float sc = kNegInf;
      const int pos = j * bs + c;
      if (pos < kv_len && pos <= q_start + (r0 + r) / group) {
        const __nv_bfloat162* qp = reinterpret_cast<const __nv_bfloat162*>(q_s + r * LD);
        const __nv_bfloat162* kp = reinterpret_cast<const __nv_bfloat162*>(k_s + c * LD);
        float dot = 0.f;
#pragma unroll 8
        for (int d2 = 0; d2 < D / 2; ++d2) {
          const float2 a = __bfloat1622float2(qp[d2]);
          const float2 k2 = __bfloat1622float2(kp[d2]);
          dot = fmaf(a.x, k2.x, dot);
          dot = fmaf(a.y, k2.y, dot);
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
        // P is rounded to the V dtype before PV (kernel_gen.py:313).
        p_s[r * bs + c] = __bfloat162float(__float2bfloat16(p));
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
      for (int c = 0; c < bs; ++c)
        pv = fmaf(p_s[r * bs + c], __bfloat162float(v_s[c * LD + dcol]), pv);
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

template <int D>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* page_table, const void* kv_lens, const void* q_lens,
           void* out, int batch, int s_q, int hq, int hkv, int bs, int mb,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(bs);
  auto kernel = paged_attention_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch, hkv, (s_q * (hq / hkv) + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages),
      static_cast<const int*>(page_table), static_cast<const int*>(kv_lens),
      static_cast<const int*>(q_lens), static_cast<__nv_bfloat16*>(out),
      s_q, hq, hkv, bs, mb, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [batch, s_q, hq, D] (decode: s_q == 1 and q_lens == nullptr), pools
// [NB, bs, hkv, D], page_table [batch, mb] int32, kv_lens / q_lens [batch]
// int32, out like q. Returns a cudaError_t code (0 = launched).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* kv_lens, const void* q_lens,
    void* out, int batch, int s_q, int hq, int hkv, int head_dim,
    int block_size, int max_blocks, float scale, void* stream) {
  if (batch < 1 || s_q < 1 || hkv < 1 || hq % hkv != 0 || block_size < 1 ||
      block_size > kMaxBlockSize || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 128)
    return launch<128>(q, k_pages, v_pages, page_table, kv_lens, q_lens, out,
                       batch, s_q, hq, hkv, block_size, max_blocks, scale, st);
  if (head_dim == 64)
    return launch<64>(q, k_pages, v_pages, page_table, kv_lens, q_lens, out,
                      batch, s_q, hq, hkv, block_size, max_blocks, scale, st);
  return (int)cudaErrorInvalidValue;
}
