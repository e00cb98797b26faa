// The two phases of tensor-parallel MLA attention for Hopper (sm_90a): all
// block scores of a latent-column shard, and its probability-weighted value
// sum. bf16 pools and quantized pools (int8 or fp8 e4m3 pages with one fp32
// scale per row, [NB, bs], read through the same page table).
//
// Replaces the TPU kernels of megatronapp_tpu/ops/pallas/kernel_gen.py:
// - _latent_block_scores (def :564, pallas_call :617): phase 1, q . pages^T
//   over the page table, [B, rows, MB*bs] fp32, no softmax;
// - _latent_block_wsum (def :624, pallas_call :697): phase 2, p . (latent
//   tile x w_v), [B, rows, dv] fp32 partials.
// The caller (ops/paged_attention.py:paged_attention_latent_tp, the body of
// kernel_gen.py:_tp_place_latent) sums phase 1 over the shards, adds the
// replicated pe scores (phase 1 on the pe pool), masks, takes an fp32
// softmax, runs phase 2 and sums it over the shards.
//
// What they compute.
// - Scores: out[b, r, t] = q[b, r, :] . page_row(b, t)[:] for every token t
//   of a block j = t / bs with j * bs < kv_len[b], and 0 for every token of
//   the other blocks (so the cross-shard sum stays finite). The rows of the
//   last, partial block past kv_len are computed from whatever the pool
//   holds, as the TPU body does; the caller masks them. Numerics: bf16
//   pages take q rounded to bf16 (q_ref[0].astype(kv.dtype)), products in
//   fp32; quantized pages are dequantized to fp32 (float(page) * scale) and
//   take q in fp32.
// - Weighted sum: out[b, r, :] = sum over the tokens of the valid blocks of
//   p[b, r, t] * (latent_t . w_v[:, n, :]), n = r mod nq. The TPU body
//   re-expands every tile's latent through w_v before it weighs it. These
//   kernels sum in latent space instead, u[r] = sum_t p[r, t] * latent_t
//   (fp32), and expand once, out[r] = u[r] . w_v[:, n, :]: the same
//   function up to the order of the fp32 sums, and per launch at decode
//   (B 8, 32 heads, kv 1024, 256 latent columns) 8.4 M multiply-adds of
//   expansion against the TPU body's 8.6 G.
//
// Design (first version: right and simple).
// - Pages are read through strides (block, row; unit column stride), so a
//   column shard of a whole pool is a view and needs no copy; w_v is the
//   strided view of kv_up's v columns ([k, h] strides, unit d).
// - Scores: one block per (slot, 32 tokens, 32 rows). The token tile is
//   staged in shared memory as fp32, transposed ([k][token], an odd row
//   length so neighbouring threads hit different banks), from 16-byte
//   loads; the rows' q are staged beside it. A warp computes 32 tokens of 4
//   rows (each lane one token), q read as a broadcast. Tiles wholly past
//   the valid blocks only write zeros.
// - Weighted sum: one block per (slot, 8 rows). It walks the slot's valid
//   tokens in tiles of 32 staged as fp32 [token][k]; each thread owns up to
//   3 latent columns of the 8 rows. Then u goes to shared memory and each
//   thread forms (row, d) outputs against w_v read from global memory.
// Both products run on the CUDA cores in fp32: no mma, no TMA.
//
// Bound (llama3-8b MLA widths at tp 2: 256 latent columns a rank, dpe 64,
// 32 heads, dv 128, bs 16, MB*bs 2048). Scores at decode (B 8, kv ~1024):
// 4.2 MB of latent pages read, 2.1 MB of scores written: bytes bound. The
// weighted sum at decode reads 2.1 MB of p, 4.2 MB of pages and 2.1 MB of
// w_v: bytes bound. chip_smoke.py computes each launch's exact bound from
// its inputs and times both kernels (PERF.md lists the times).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_fp8_e4m3 fp8;

constexpr int kThreads = 256;
constexpr int kMaxWidth = 768;       // latent columns a shard (or dpe)
constexpr int kMaxCols = kMaxWidth / kThreads;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f(fp8 v) { return (float)v; }

// Number of tokens of slot b whose blocks are computed: every row of each
// block j with j * bs < kv_len.
__device__ __forceinline__ int valid_tokens(int kv_len, int bs, int mb) {
  const int nblk = min((max(kv_len, 0) + bs - 1) / bs, mb);
  return nblk * bs;
}

// Phase 1. Grid (token tiles, row tiles, B); TK tokens x R rows a block.
template <int TK, int R, typename TP>
__global__ void __launch_bounds__(kThreads)
latent_scores_kernel(const float* __restrict__ q, const TP* __restrict__ pages,
                     const float* __restrict__ scales,  // quantized only
                     const int* __restrict__ page_table,
                     const int* __restrict__ kv_lens, float* __restrict__ out,
                     int rows, int d, int bs, int mb, long long s_blk,
                     long long s_row) {
  static_assert(TK == 32, "a lane a token");
  constexpr int kGroups = kThreads / 32;
  static_assert(R % kGroups == 0, "rows split over the warps");
  constexpr int kRows = R / kGroups;
  constexpr bool kQuant = !std::is_same<TP, bf16>::value;
  constexpr int kVec = 16 / (int)sizeof(TP);
  constexpr int LDT = TK + 1;

  const int b = blockIdx.z;
  const int t0 = blockIdx.x * TK;
  const int r0 = blockIdx.y * R;
  const int tid = threadIdx.x, lane = tid % 32, grp = tid / 32;
  const int T = mb * bs;
  const int tv = valid_tokens(kv_lens[b], bs, mb);

  if (t0 >= tv) {   // every block of the tile is past kv_len: zeros
    for (int i = tid; i < R * TK; i += kThreads) {
      const int r = r0 + i / TK, t = t0 + i % TK;
      if (r < rows && t < T) out[((size_t)b * rows + r) * T + t] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) float smem[];
  float* lt = smem;                        // [d][LDT] tokens, transposed
  float* q_s = lt + (size_t)d * LDT;       // [R][d]

  // Stage the token tile: chunk i = (token i % TK, 16-byte piece i / TK).
  const int pieces = d / kVec;
  for (int i = tid; i < TK * pieces; i += kThreads) {
    const int c = i % TK, piece = i / TK;
    const int t = t0 + c;
    float* dst = lt + (size_t)piece * kVec * LDT + c;
    if (t < tv) {
      const long long blk = page_table[(size_t)b * mb + t / bs];
      const long long off = blk * s_blk + (long long)(t % bs) * s_row;
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(pages + off) + piece);
      const TP* e = reinterpret_cast<const TP*>(&raw);
      float sc = 1.f;
      if constexpr (kQuant) sc = scales[blk * bs + t % bs];
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        if constexpr (kQuant) dst[v * LDT] = to_f(e[v]) * sc;
        else dst[v * LDT] = to_f(e[v]);
      }
    } else {
#pragma unroll
      for (int v = 0; v < kVec; ++v) dst[v * LDT] = 0.f;
    }
  }
  // The rows' q, rounded to bf16 for bf16 pages.
  for (int i = tid; i < R * d; i += kThreads) {
    const int r = r0 + i / d;
    float v = 0.f;
    if (r < rows) {
      v = q[((size_t)b * rows + r) * d + i % d];
      if constexpr (!kQuant) v = __bfloat162float(__float2bfloat16(v));
    }
    q_s[i] = v;
  }
  __syncthreads();

  float acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
  const float* kc = lt + lane;
#pragma unroll 4
  for (int k = 0; k < d; ++k) {
    const float v = kc[(size_t)k * LDT];
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      acc[j] = fmaf(q_s[(size_t)(grp + j * kGroups) * d + k], v, acc[j]);
  }
  const int t = t0 + lane;
  if (t < T) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = r0 + grp + j * kGroups;
      if (r < rows) out[((size_t)b * rows + r) * T + t] = t < tv ? acc[j] : 0.f;
    }
  }
}

// Phase 2. Grid (row tiles, B); R rows a block, tiles of TK tokens.
template <int TK, int R, typename TP>
__global__ void __launch_bounds__(kThreads)
latent_wsum_kernel(const float* __restrict__ p, const TP* __restrict__ pages,
                   const float* __restrict__ scales,  // quantized only
                   const int* __restrict__ page_table,
                   const int* __restrict__ kv_lens,
                   const bf16* __restrict__ w_v, float* __restrict__ out,
                   int rows, int nq, int dl, int dv, int bs, int mb,
                   long long s_blk, long long s_row, long long w_stride_k,
                   long long w_stride_h) {
  constexpr bool kQuant = !std::is_same<TP, bf16>::value;
  constexpr int kVec = 16 / (int)sizeof(TP);

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int T = mb * bs;
  const int tv = valid_tokens(kv_lens[b], bs, mb);

  extern __shared__ __align__(16) float smem[];
  float* lt = smem;                        // [TK][dl]; later u [R][dl]
  float* p_s = lt + (size_t)TK * dl;       // [R][TK]

  float acc[R][kMaxCols];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[r][c] = 0.f;

  const int pieces = dl / kVec;
  for (int t0 = 0; t0 < tv; t0 += TK) {
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < TK * pieces; i += kThreads) {
      const int c = i / pieces, piece = i % pieces;
      const int t = t0 + c;
      float* dst = lt + (size_t)c * dl + piece * kVec;
      if (t < tv) {
        const long long blk = page_table[(size_t)b * mb + t / bs];
        const long long off = blk * s_blk + (long long)(t % bs) * s_row;
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(pages + off) + piece);
        const TP* e = reinterpret_cast<const TP*>(&raw);
        float sc = 1.f;
        if constexpr (kQuant) sc = scales[blk * bs + t % bs];
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          if constexpr (kQuant) dst[v] = to_f(e[v]) * sc;
          else dst[v] = to_f(e[v]);
        }
      } else {
#pragma unroll
        for (int v = 0; v < kVec; ++v) dst[v] = 0.f;
      }
    }
    for (int i = tid; i < R * TK; i += kThreads) {
      const int r = r0 + i / TK, t = t0 + i % TK;
      p_s[i] = (r < rows && t < tv) ? p[((size_t)b * rows + r) * T + t] : 0.f;
    }
    __syncthreads();
    const int tok = min(TK, tv - t0);
    for (int c = 0; c < tok; ++c) {
      float pr[R];
#pragma unroll
      for (int r = 0; r < R; ++r) pr[r] = p_s[r * TK + c];
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        const int k = tid + j * kThreads;
        if (k < dl) {
          const float v = lt[(size_t)c * dl + k];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][j] = fmaf(pr[r], v, acc[r][j]);
        }
      }
    }
  }
  __syncthreads();

  // Expansion: out[r] = u[r] . w_v[:, n(r), :], once.
  float* u_s = lt;   // [R][dl]
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    const int k = tid + j * kThreads;
    if (k < dl) {
#pragma unroll
      for (int r = 0; r < R; ++r) u_s[(size_t)r * dl + k] = acc[r][j];
    }
  }
  __syncthreads();
  for (int o = tid; o < R * dv; o += kThreads) {
    const int r = o / dv, d = o % dv;
    const int row = r0 + r;
    if (row >= rows) continue;
    const bf16* wd = w_v + (long long)(row % nq) * w_stride_h + d;
    const float* ur = u_s + (size_t)r * dl;
    float sum = 0.f;
#pragma unroll 4
    for (int k = 0; k < dl; ++k)
      sum = fmaf(ur[k], __bfloat162float(wd[(long long)k * w_stride_k]), sum);
    out[((size_t)b * rows + row) * dv + d] = sum;
  }
}

constexpr int kScoreTK = 32, kScoreR = 32;
constexpr int kWsumTK = 32, kWsumR = 8;

template <typename TP>
int launch_scores(const void* q, const void* pages, const void* scales,
                  const void* table, const void* lens, void* out, int batch,
                  int rows, int d, int bs, int mb, long long s_blk,
                  long long s_row, cudaStream_t st) {
  const size_t smem = ((size_t)d * (kScoreTK + 1) + (size_t)kScoreR * d) * sizeof(float);
  auto kernel = latent_scores_kernel<kScoreTK, kScoreR, TP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((mb * bs + kScoreTK - 1) / kScoreTK,
                  (rows + kScoreR - 1) / kScoreR, batch);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const TP*>(pages),
      static_cast<const float*>(scales), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<float*>(out), rows, d, bs, mb,
      s_blk, s_row);
  return (int)cudaGetLastError();
}

template <typename TP>
int launch_wsum(const void* p, const void* pages, const void* scales,
                const void* table, const void* lens, const void* w_v, void* out,
                int batch, int rows, int nq, int dl, int dv, int bs, int mb,
                long long s_blk, long long s_row, long long wsk, long long wsh,
                cudaStream_t st) {
  const size_t smem = ((size_t)kWsumTK * dl + (size_t)kWsumR * kWsumTK) * sizeof(float);
  auto kernel = latent_wsum_kernel<kWsumTK, kWsumR, TP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((rows + kWsumR - 1) / kWsumR, batch);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(p), static_cast<const TP*>(pages),
      static_cast<const float*>(scales), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<const bf16*>(w_v),
      static_cast<float*>(out), rows, nq, dl, dv, bs, mb, s_blk, s_row, wsk, wsh);
  return (int)cudaGetLastError();
}

bool bad_pages(int d, int page_kind, const void* scales, int bs, int mb) {
  return d < 16 || d % 16 || d > kMaxWidth || bs < 1 || mb < 1 ||
         page_kind < 0 || page_kind > 2 || (page_kind > 0 && scales == nullptr);
}

}  // namespace

// q [batch, rows, d] fp32; pages of page_kind 0 (bf16), 1 (int8) or 2 (fp8
// e4m3), element (blk, row, k) at blk * s_blk + row * s_row + k (16-byte
// aligned rows); scales [NB, bs] fp32 for page kinds 1 and 2; page_table
// [batch, mb] int32; kv_lens [batch] int32; out [batch, rows, mb * bs] fp32.
// Returns a cudaError_t code (0 = launched).
extern "C" int latent_scores_launch(const void* q, const void* pages,
                                    const void* scales, const void* page_table,
                                    const void* kv_lens, void* out, int batch,
                                    int rows, int d, int block_size,
                                    int max_blocks, long long s_blk,
                                    long long s_row, int page_kind,
                                    void* stream) {
  if (batch < 1 || rows < 1 || bad_pages(d, page_kind, scales, block_size, max_blocks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (page_kind == 0)
    return launch_scores<bf16>(q, pages, scales, page_table, kv_lens, out, batch,
                               rows, d, block_size, max_blocks, s_blk, s_row, st);
  if (page_kind == 1)
    return launch_scores<int8_t>(q, pages, scales, page_table, kv_lens, out,
                                 batch, rows, d, block_size, max_blocks, s_blk,
                                 s_row, st);
  return launch_scores<fp8>(q, pages, scales, page_table, kv_lens, out, batch,
                            rows, d, block_size, max_blocks, s_blk, s_row, st);
}

// p [batch, rows, mb * bs] fp32; pages, scales, page_table, kv_lens as for
// latent_scores_launch, with dl latent columns; w_v bf16 element (k, h, d) at
// k * w_stride_k + h * w_stride_h + d, nq heads, dv values; out [batch, rows,
// dv] fp32, row r of head r mod nq. Returns a cudaError_t code.
extern "C" int latent_wsum_launch(const void* p, const void* pages,
                                  const void* scales, const void* page_table,
                                  const void* kv_lens, const void* w_v,
                                  void* out, int batch, int rows, int nq,
                                  int dl, int dv, int block_size,
                                  int max_blocks, long long s_blk,
                                  long long s_row, long long w_stride_k,
                                  long long w_stride_h, int page_kind,
                                  void* stream) {
  if (batch < 1 || rows < 1 || nq < 1 || dv < 1 ||
      bad_pages(dl, page_kind, scales, block_size, max_blocks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (page_kind == 0)
    return launch_wsum<bf16>(p, pages, scales, page_table, kv_lens, w_v, out,
                             batch, rows, nq, dl, dv, block_size, max_blocks,
                             s_blk, s_row, w_stride_k, w_stride_h, st);
  if (page_kind == 1)
    return launch_wsum<int8_t>(p, pages, scales, page_table, kv_lens, w_v, out,
                               batch, rows, nq, dl, dv, block_size, max_blocks,
                               s_blk, s_row, w_stride_k, w_stride_h, st);
  return launch_wsum<fp8>(p, pages, scales, page_table, kv_lens, w_v, out,
                          batch, rows, nq, dl, dv, block_size, max_blocks,
                          s_blk, s_row, w_stride_k, w_stride_h, st);
}
