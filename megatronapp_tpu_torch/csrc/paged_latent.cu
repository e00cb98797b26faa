// MLA latent-space ragged paged attention for Hopper (sm_90a), decode and
// ragged modes.
//
// Replaces the TPU kernel megatronapp_tpu/ops/pallas/kernel_gen.py
// paged_attention_latent (def :456, pallas_call :557; body
// emit_latent_kernel :338) for bf16 pools and for quantized pools: int8 or
// fp8 (e4m3) pages with one fp32 scale per row ([NB, bs], read through the
// same page table).
//
// What it computes. Query row (s, h) of slot b holds the absorbed query
// q_lat [klat] (q_nope through kv_up's k_nope columns) and the roped q_pe
// [dpe]. The pool has no head axis: token t of the slot is one latent row
// [klat] and one roped key row [dpe], shared by every head. Scores are
// q_lat . latent + q_pe . k_pe, scaled by softmax_scale; an online softmax
// runs over [0, kv_len) with the causal limit kv_len - q_len + s in ragged
// mode; the value of token t for head h is latent_t . w_v[:, h, :], with
// w_v [klat, nq, dv] kv_up's v columns (a strided view: the launcher takes
// its k and h strides, so the wrapper never copies it).
//
// Design. The TPU body re-expands the values of every block through w_v
// (v_t = latent_tile x w_v, kernel_gen.py:428-442): at decode B 8, kv 1024
// that is 17.2 G multiply-adds a layer. This kernel accumulates in latent
// space instead, acc[row] += p_t * latent_t (fp32, with the same online
// softmax correction), and expands once at the end, out[row] = (acc[row] /
// l[row]) . w_v[:, h, :]: the same function up to the order of the fp32
// sums, about 57x fewer operations at decode and 2.4x fewer at a 32-row
// chunk.
// - One block owns the rows (s, h) of RS query positions x RH heads of one
//   slot and walks the slot's tokens in tiles of TK (a loop inside the
//   block replaces the TPU's sequential page axis; it stops at kv_len).
//   Decode: RS 1, RH 4, TK 64 (B 8 x 32 heads -> 64 blocks); ragged: RS 8,
//   RH 1, TK 32 (a 32-row chunk of 32 heads -> 128 blocks, and each block
//   reads one head's w_v in its expansion).
// - A tile's latent and k_pe rows are staged in shared memory as fp32,
//   transposed ([k][token], rows padded to an odd length so neighbouring
//   threads hit different banks), dequantized as staged for int8/fp8 pools
//   (float(page) * scale[row], kernel_gen.py:406-408). The next tile's rows
//   are loaded into registers (16-byte loads) while the current one is
//   computed.
// - Each thread computes one score (row, token) over klat + dpe, and
//   accumulates 2-3 latent columns of every row of the block; one warp a
//   row runs the softmax statistics.
// Numerics kept from the TPU body: q scaled in fp32 and rounded to the page
// dtype (bf16) before the dot on bf16 pools only (kernel_gen.py:390-402); P
// stays fp32 (the TPU casts it to the fp32 re-expanded values); m, l, acc
// fp32; the -1e30 sentinel, m_safe, the corr = 0 guard and l >= 1e-20 as
// in the TPU body. Rows past kv_len are staged as zeros, so stale pool
// bytes never reach the output.
//
// Bound. Decode B 8, kv 1024: 8 x 1024 x 576 x 2 B of pool plus w_v's 4.2
// MB, 13.6 MB, ~4.1 us at 3.35 TB/s (0.60 GFLOP: bytes bound). A ragged B 1,
// S_q 32, kv 1008 chunk does ~2.4 GFLOP, ~2.4 us at 989 TFLOP/s
// (operations bound). This first version runs its products on CUDA cores in
// fp32 (no mma/wgmma, no TMA) with one block of 8 warps a SM (~160 KB of
// shared memory at decode), and every block re-reads its slot's latent rows
// from L2. On an NVIDIA H100 80GB HBM3 at 700.00 W it takes 0.23-0.24 ms at
// decode and 0.37-0.39 ms for the chunk (chip_smoke.py's times phase), ~57x
// and ~160x the bounds. Cycle counts of its phases placed a decode block's
// time about equally in issuing the tile loads, the scores and the
// expansion; staging the page-table row in shared memory, coalesced
// [token][k] tiles with float4 score reads, and a shared-memory-staged
// expansion each measured no faster (PERF.md, PR 6): the next step is
// tensor-core products (mma) over more blocks a slot (a KV split).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_fp8_e4m3 fp8;

constexpr int kThreads = 256;
constexpr int kMaxWidth = 640;            // klat + dpe
constexpr int kMaxCols = 3;               // latent columns a thread: klat <= 768
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

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f(fp8 v) { return (float)v; }

template <int TK>
size_t smem_floats(int kd, int rows) {
  return (size_t)kd * (TK + 1) + (size_t)rows * kd + (size_t)TK * rows + 3 * rows;
}

template <int RS, int RH, int TK, typename TP>
__global__ void __launch_bounds__(kThreads)
paged_latent_kernel(const bf16* __restrict__ q_lat, const bf16* __restrict__ q_pe,
                    const TP* __restrict__ lat_pages, const TP* __restrict__ pe_pages,
                    const float* __restrict__ lat_scales,   // quantized only
                    const float* __restrict__ pe_scales,
                    const int* __restrict__ page_table, const int* __restrict__ kv_lens,
                    const int* __restrict__ q_lens,         // nullptr: decode
                    const bf16* __restrict__ w_v, bf16* __restrict__ out,
                    int s_q, int nq, int klat, int dpe, int dv, int bs, int mb,
                    long long w_stride_k, long long w_stride_h, float scale) {
  constexpr int R = RS * RH;
  static_assert(R * TK == kThreads, "one score a thread");
  static_assert(TK % 32 == 0 && R <= kThreads / 32, "a warp a row");
  constexpr bool kQuant = !std::is_same<TP, bf16>::value;
  constexpr int kVec = 16 / (int)sizeof(TP);              // elements a 16-byte load
  constexpr int LDT = TK + 1;                             // odd: no bank conflicts
  constexpr int kLoads = (TK * (kMaxWidth / kVec) + kThreads - 1) / kThreads;

  const int kd = klat + dpe;
  const int b = blockIdx.x;
  const int h0 = blockIdx.y * RH;
  const int s0 = blockIdx.z * RS;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) float smem[];
  float* lt = smem;                               // [kd][LDT] the tile, transposed
  float* q_s = lt + (size_t)kd * LDT;             // [R][kd]
  float* p_s = q_s + (size_t)R * kd;              // [TK][R] scores, then P
  float* m_s = p_s + TK * R;                      // [R]
  float* l_s = m_s + R;                           // [R]
  float* c_s = l_s + R;                           // [R]

  const int kv_len = kv_lens[b];
  const int q_len = q_lens != nullptr ? q_lens[b] : 1;
  const int q_start = kv_len - q_len;   // absolute position of local query 0

  // The block's query rows: [q_lat | q_pe] scaled in fp32, rounded to bf16
  // for bf16 pools only.
  for (int i = tid; i < R * kd; i += kThreads) {
    const int r = i / kd, k = i % kd;
    const int s = s0 + r / RH, h = h0 + r % RH;
    float v = 0.f;
    if (s < s_q && h < nq) {
      const size_t row = ((size_t)b * s_q + s) * nq + h;
      v = (k < klat ? __bfloat162float(q_lat[row * klat + k])
                    : __bfloat162float(q_pe[row * dpe + (k - klat)])) * scale;
      if constexpr (!kQuant) v = __bfloat162float(__float2bfloat16(v));
    }
    q_s[i] = v;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // Tile loads: chunk i = (token c = i % TK, 16-byte piece q = i / TK) of the
  // token's [latent | k_pe] row; a warp reads one piece of 32 tokens.
  const int lat_pieces = klat / kVec;
  const int pieces = kd / kVec;
  const int nchunks = TK * pieces;
  uint4 buf[kLoads];
  float scl[kLoads];
  auto load_tile = [&](int tile) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      buf[j] = make_uint4(0u, 0u, 0u, 0u);
      scl[j] = 0.f;
      if (i < nchunks) {
        const int c = i % TK, q = i / TK;
        const int pos = tile * TK + c;
        if (pos < kv_len) {
          const size_t row = (size_t)page_table[(size_t)b * mb + pos / bs] * bs + pos % bs;
          if (q < lat_pieces) {
            buf[j] = __ldg(reinterpret_cast<const uint4*>(lat_pages + row * klat) + q);
            if constexpr (kQuant) scl[j] = lat_scales[row];
          } else {
            buf[j] = __ldg(reinterpret_cast<const uint4*>(pe_pages + row * dpe) + (q - lat_pieces));
            if constexpr (kQuant) scl[j] = pe_scales[row];
          }
        }
      }
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      if (i < nchunks) {
        const int c = i % TK, q = i / TK;
        const TP* e = reinterpret_cast<const TP*>(&buf[j]);
        float* dst = lt + (size_t)q * kVec * LDT + c;
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          if constexpr (kQuant) dst[v * LDT] = to_f(e[v]) * scl[j];
          else dst[v * LDT] = to_f(e[v]);
        }
      }
    }
  };

  float acc[R][kMaxCols];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) acc[r][j] = 0.f;

  const int my_r = tid / TK, my_c = tid % TK;
  const int my_limit = q_start + (s0 + my_r / RH);   // causal limit of my row
  const int ntiles = (kv_len + TK - 1) / TK;
  if (ntiles > 0) load_tile(0);

  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();   // the previous tile's readers are done with lt
    store_tile();
    __syncthreads();
    if (t + 1 < ntiles) load_tile(t + 1);   // in flight during this tile

    // One score a thread, with the kv_len and causal masks.
    {
      const int pos = t * TK + my_c;
      float sc = kNegInf;
      if (pos < kv_len && pos <= my_limit) {
        const float* qr = q_s + (size_t)my_r * kd;
        const float* kc = lt + my_c;
        float dot = 0.f;
#pragma unroll 4
        for (int k = 0; k < kd; k += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + k);
          dot = fmaf(qv.x, kc[(size_t)k * LDT], dot);
          dot = fmaf(qv.y, kc[(size_t)(k + 1) * LDT], dot);
          dot = fmaf(qv.z, kc[(size_t)(k + 2) * LDT], dot);
          dot = fmaf(qv.w, kc[(size_t)(k + 3) * LDT], dot);
        }
        sc = dot;
      }
      p_s[my_c * R + my_r] = sc;
    }
    __syncthreads();

    // Online softmax, one warp a row (kernel_gen.py:410-425).
    if (warp < R) {
      const int r = warp;
      float mx = kNegInf;
      for (int c = lane; c < TK; c += 32) mx = fmaxf(mx, p_s[c * R + r]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = fmaxf(m_new, kNegInf / 2);
      float sum = 0.f;
      for (int c = lane; c < TK; c += 32) {
        const float sc = p_s[c * R + r];
        const float p = sc > kNegInf / 2 ? expf(sc - m_safe) : 0.f;
        p_s[c * R + r] = p;
        sum += p;
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

    // acc = acc * corr + P @ latent, in latent space (columns tid + 256 j).
    float corr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) corr[r] = c_s[r];
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r][j] *= corr[r];
    const int tok = min(TK, kv_len - t * TK);
    for (int c = 0; c < tok; ++c) {
      float pr[R];
#pragma unroll
      for (int r = 0; r < R; r += 4) {
        const float4 v = *reinterpret_cast<const float4*>(p_s + c * R + r);
        pr[r] = v.x;
        pr[r + 1] = v.y;
        pr[r + 2] = v.z;
        pr[r + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        const int k = tid + j * kThreads;
        if (k < klat) {
          const float v = lt[(size_t)k * LDT + c];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][j] = fmaf(pr[r], v, acc[r][j]);
        }
      }
    }
  }
  __syncthreads();

  // Expansion: out[r] = (acc[r] / l[r]) . w_v[:, h(r), :], once.
  float* acc_s = lt;   // [R][klat]
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    const int k = tid + j * kThreads;
    if (k < klat) {
#pragma unroll
      for (int r = 0; r < R; ++r) acc_s[(size_t)r * klat + k] = acc[r][j] / fmaxf(l_s[r], 1e-20f);
    }
  }
  __syncthreads();
  const int d = tid % dv, rg = tid / dv, ng = kThreads / dv;
  if (rg < R) {
    float o[R];
#pragma unroll
    for (int i = 0; i < R; ++i) o[i] = 0.f;
    const bf16* wd = w_v + d;
#pragma unroll 4
    for (int k = 0; k < klat; ++k) {
      const bf16* wk = wd + (long long)k * w_stride_k;
      if constexpr (RH == 1) {
        const float w = h0 < nq ? __bfloat162float(wk[(long long)h0 * w_stride_h]) : 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i)
          if (rg + i * ng < R) o[i] = fmaf(acc_s[(size_t)(rg + i * ng) * klat + k], w, o[i]);
      } else {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int r = rg + i * ng;
          const int h = h0 + r % RH;
          if (r < R && h < nq)
            o[i] = fmaf(acc_s[(size_t)r * klat + k],
                        __bfloat162float(wk[(long long)h * w_stride_h]), o[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = rg + i * ng;
      if (r >= R) break;
      const int s = s0 + r / RH, h = h0 + r % RH;
      if (s < s_q && h < nq)
        out[(((size_t)b * s_q + s) * nq + h) * dv + d] = __float2bfloat16(o[i]);
    }
  }
}

template <int RS, int RH, int TK, typename TP>
int launch(const void* q_lat, const void* q_pe, const void* lat_pages,
           const void* pe_pages, const void* lat_scales, const void* pe_scales,
           const void* page_table, const void* kv_lens, const void* q_lens,
           const void* w_v, void* out, int batch, int s_q, int nq, int klat,
           int dpe, int dv, int bs, int mb, long long wsk, long long wsh,
           float scale, cudaStream_t stream) {
  constexpr int R = RS * RH;
  const size_t smem = smem_floats<TK>(klat + dpe, R) * sizeof(float);
  auto kernel = paged_latent_kernel<RS, RH, TK, TP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch, (nq + RH - 1) / RH, (s_q + RS - 1) / RS);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q_lat), static_cast<const bf16*>(q_pe),
      static_cast<const TP*>(lat_pages), static_cast<const TP*>(pe_pages),
      static_cast<const float*>(lat_scales), static_cast<const float*>(pe_scales),
      static_cast<const int*>(page_table), static_cast<const int*>(kv_lens),
      static_cast<const int*>(q_lens), static_cast<const bf16*>(w_v),
      static_cast<bf16*>(out), s_q, nq, klat, dpe, dv, bs, mb, wsk, wsh, scale);
  return (int)cudaGetLastError();
}

template <typename TP>
int launch_mode(bool ragged, const void* q_lat, const void* q_pe,
                const void* lat_pages, const void* pe_pages,
                const void* lat_scales, const void* pe_scales,
                const void* page_table, const void* kv_lens, const void* q_lens,
                const void* w_v, void* out, int batch, int s_q, int nq,
                int klat, int dpe, int dv, int bs, int mb, long long wsk,
                long long wsh, float scale, cudaStream_t st) {
  if (ragged)
    return launch<8, 1, 32, TP>(q_lat, q_pe, lat_pages, pe_pages, lat_scales,
                                pe_scales, page_table, kv_lens, q_lens, w_v, out,
                                batch, s_q, nq, klat, dpe, dv, bs, mb, wsk, wsh,
                                scale, st);
  return launch<1, 4, 64, TP>(q_lat, q_pe, lat_pages, pe_pages, lat_scales,
                              pe_scales, page_table, kv_lens, q_lens, w_v, out,
                              batch, s_q, nq, klat, dpe, dv, bs, mb, wsk, wsh,
                              scale, st);
}

}  // namespace

// q_lat [batch, s_q, nq, klat] and q_pe [batch, s_q, nq, dpe] bf16 (decode:
// s_q == 1 and q_lens == nullptr); pools [NB, bs, klat] and [NB, bs, dpe] of
// page_kind 0 (bf16), 1 (int8) or 2 (fp8 e4m3); lat_scales / pe_scales [NB,
// bs] fp32 for page kinds 1 and 2; page_table [batch, mb] int32; kv_lens /
// q_lens [batch] int32; w_v bf16 element (k, h, d) at k * w_stride_k + h *
// w_stride_h + d; out [batch, s_q, nq, dv] bf16. Returns a cudaError_t code
// (0 = launched).
extern "C" int paged_latent_launch(
    const void* q_lat, const void* q_pe, const void* lat_pages,
    const void* pe_pages, const void* lat_scales, const void* pe_scales,
    const void* page_table, const void* kv_lens, const void* q_lens,
    const void* w_v, void* out, int batch, int s_q, int nq, int klat, int dpe,
    int dv, int block_size, int max_blocks, long long w_stride_k,
    long long w_stride_h, int page_kind, float scale, void* stream) {
  if (batch < 1 || s_q < 1 || nq < 1 || klat < 16 || klat % 16 || dpe < 16 ||
      dpe % 16 || klat + dpe > kMaxWidth || klat > kMaxCols * kThreads ||
      dv < 1 || dv > kThreads || kThreads % dv || block_size < 1 ||
      max_blocks < 1 || page_kind < 0 || page_kind > 2 ||
      (page_kind > 0 && (lat_scales == nullptr || pe_scales == nullptr)))
    return (int)cudaErrorInvalidValue;
  const bool ragged = q_lens != nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (page_kind == 0)
    return launch_mode<bf16>(ragged, q_lat, q_pe, lat_pages, pe_pages,
                             lat_scales, pe_scales, page_table, kv_lens, q_lens,
                             w_v, out, batch, s_q, nq, klat, dpe, dv,
                             block_size, max_blocks, w_stride_k, w_stride_h,
                             scale, st);
  if (page_kind == 1)
    return launch_mode<int8_t>(ragged, q_lat, q_pe, lat_pages, pe_pages,
                               lat_scales, pe_scales, page_table, kv_lens,
                               q_lens, w_v, out, batch, s_q, nq, klat, dpe, dv,
                               block_size, max_blocks, w_stride_k, w_stride_h,
                               scale, st);
  return launch_mode<fp8>(ragged, q_lat, q_pe, lat_pages, pe_pages, lat_scales,
                          pe_scales, page_table, kv_lens, q_lens, w_v, out,
                          batch, s_q, nq, klat, dpe, dv, block_size, max_blocks,
                          w_stride_k, w_stride_h, scale, st);
}
