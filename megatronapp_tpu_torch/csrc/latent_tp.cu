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
//   re-expands every tile's latent through w_v before it weighs it. This
//   kernel sums in latent space instead, u[r] = sum_t p[r, t] * latent_t
//   (fp32), and expands once, out[r] = u[r] . w_v[:, n, :]: the same
//   function up to the order of the fp32 sums.
//
// Bound (llama3-8b MLA widths at tp 2: 256 latent columns a rank, dpe 64,
// 32 heads, dv 128, bs 16). Both phases move a few MB (scores: the valid
// page rows and the [B, rows, MB*bs] fp32 scores; weighted sum: p, the page
// rows and w_v's 2 MB) and do a few hundred M multiply-adds, so their bound
// is 1-2 us, below the ~2.3 us a queued one-element kernel takes on an H100
// (flash_probe.py latent-splits): they are latency-bound, and the design is
// about filling the card at once, keeping loads in flight and shortening
// the chain kv_len -> page table -> pages. chip_smoke.py computes each
// launch's exact bound from its inputs.
//
// Design: both products run on the tensor cores (mma.sync m16n8k16, bf16
// operands, fp32 sums; tensor_core.cuh) from tiles staged by cp.async.
// Pages are read through strides (block, row; unit column stride), so a
// column shard of a whole pool is a view and needs no copy; one-byte codes
// land in a ring of their own and are widened to bf16 exactly
// (tc::widen16) before the ldmatrix loads read them. An fp32 operand (q on
// quantized pages, p, u) enters as three bf16 terms (tc::split_a), each
// one mma against the same exact bf16 values, smallest term first: fp32
// grade, where rounding it to bf16 would cost ~2^-9 of an output.
//
// Scores (latent_scores_kernel): a block takes (token tile, row tile,
// slot): 32 rows x 64 tokens at decode (a slot's 32 rows in one tile) or
// 64 x 128 for chunks (kScoreTiles), so q is staged once per 64-128
// tokens. d is walked in stages of 128 columns (d 256: two), the next
// stage's loads in flight during this one's products: q's fp32 rows go
// first (they need no table), then kv_len and the tile's table entries are
// read together, then the page rows. Each
// stage's q is turned into bf16 terms once in shared memory (bf16 pages:
// q rounded to bf16, one mma a k-step, the products exact; quantized
// pages: three terms, the row scale applied per token in the epilogue).
// The stage's k-steps are dealt to warp groups of 2 x 2 warps (4 groups
// at decode, 2 for chunks: more warps an SM to hide the latencies), whose
// sums are added in group order. A tile wholly past the valid blocks only
// writes zeros.
//
// Weighted sum, two launches.
// - latent_wsum_split_kernel: a block takes (token split, row tile x
//   256-column block, slot), warps of 16 rows x 64 columns, and sums
//   u_part[r, :] = sum over its tokens of p[r, t] latent_t as mma: rows
//   are M, tokens K (16 a step), the latent tile [token][column] is B
//   (ldmatrix .trans). Page rows come through the table by 16-byte
//   cp.async into a ring of four 32-token stages (the first stages' table
//   entries read beside kv_len), p's fp32 rows beside them; on quantized
//   pools the row scale is folded into p before the split (u = sum (p
//   s_t) code_t). The split plan comes from the host (ops/cuda/latent_tp.py
//   wsum_split_plan: from shapes alone, about one wave of blocks); a split
//   wholly past kv_len does nothing. Each block writes its fp32 partial to
//   the workspace [split][B][rows][dl].
// - latent_wsum_expand_kernel: a block takes (head n, 64 value columns, 16
//   of head n's rows across slots and query positions). It stages
//   w_v[:, n, cols] by cp.async before waiting for the first launch
//   (programmatic dependent launch), sums each row's live splits in split
//   order into u (fp32, shared memory; 16 loads a thread in flight), and
//   runs out = u . w_v[:, n, :] with u in three terms, the dl/16 k-steps
//   dealt to 8 warps and their sums added in warp order. So w_v is read
//   once a (head, value tile): 2 MB in all at tp_times' shapes.
// Every sum runs in a fixed order and there are no float atomics, so a
// rerun repeats every bit.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_fp8_e4m3 fp8;

constexpr int kMaxWidth = 768;   // latent columns a shard (or dpe)
constexpr int kTerms = 3;        // bf16 terms of an fp32 operand

// Number of tokens of slot b whose blocks are computed: every row of each
// block j with j * bs < kv_len.
__device__ __forceinline__ int valid_tokens(int kv_len, int bs, int mb) {
  const int nblk = min((max(kv_len, 0) + bs - 1) / bs, mb);
  return nblk * bs;
}

// ---------------------------------------------------------------------------
// Phase 1: scores.

struct Tile {
  int rows, tokens, ksplit;
};
// Row 8's block tiles (rows, tokens, warp groups splitting each stage's
// k-steps): [0] for launches of at most 32 rows (decode), [1] for more
// (chunks).
constexpr Tile kScoreTiles[2] = {{32, 64, 4}, {64, 128, 2}};

constexpr int kScoreKC = 128;        // columns of d a stage
constexpr int kScoreRing = 2;        // ring stages
constexpr int kLdK = kScoreKC + 8;   // bf16 row stride of the q-term and page tiles
constexpr int kLdQ = kScoreKC + 8;   // fp32 row stride of a q stage

struct ScoreParams {
  const float* q;          // [B, rows, d]
  const void* pages;       // (blk, row, k) at blk * s_blk + row * s_row + k
  const float* scales;     // [NB, bs] (quantized pages)
  const int* page_table;   // [B, mb]
  const int* kv_lens;      // [B]
  float* out;              // [B, rows, mb * bs]
  int rows, d, bs, mb;
  long long s_blk, s_row;
};

template <int TM, int TN, typename TP>
size_t scores_smem() {
  constexpr bool kQuant = !std::is_same<TP, bf16>::value;
  const size_t q = (size_t)kScoreRing * TM * kLdQ * sizeof(float) +
                   (size_t)(kQuant ? kTerms : 1) * TM * kLdK * sizeof(bf16);
  const size_t pages = kQuant ? (size_t)TN * kLdK * sizeof(bf16) + kScoreRing * TN * kScoreKC
                              : (size_t)kScoreRing * TN * kLdK * sizeof(bf16);
  return q + pages + TN * (sizeof(long long) + sizeof(float));
}

// grid (token tiles, row tiles, B); KS groups of 2 x 2 warps, group kg
// taking k-steps kg, kg + KS, ... of every stage.
template <int TM, int TN, int KS, typename TP>
__global__ void __launch_bounds__(128 * KS) latent_scores_kernel(const ScoreParams p) {
  constexpr int kThr = 128 * KS;
  constexpr bool kQuant = !std::is_same<TP, bf16>::value;
  constexpr int TERMS = kQuant ? kTerms : 1;
  constexpr int MF = TM / 32, NF = TN / 16;   // a warp's 16-row m-tiles, 8-token n-tiles
  constexpr int EPP = 16 / (int)sizeof(TP), PPR = kScoreKC / EPP;   // a stage's 16-byte pieces a row
  constexpr int LDR = TN + 8;   // fp32 row stride of a group's sums
  static_assert(TM % 32 == 0 && TN % 32 == 0, "whole warp tiles");
  static_assert((KS - 1) * TM * LDR <= kScoreRing * TM * kLdQ, "group sums fit the q ring");
  static_assert(TN <= kThr, "a thread a token of the tile");

  const int b = blockIdx.z, t0 = blockIdx.x * TN, r0 = blockIdx.y * TM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int T = p.mb * p.bs;
  float* out = p.out + (size_t)b * p.rows * T;

  extern __shared__ uint4 smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);   // [ring][TM][kLdQ]; then the group sums
  bf16* qt_s = reinterpret_cast<bf16*>(q_s + kScoreRing * TM * kLdQ);   // [TERMS][TM][kLdK]
  bf16* k_s = qt_s + TERMS * TM * kLdK;   // bf16: [ring][TN][kLdK]; else widened [TN][kLdK]
  uint8_t* c_s = reinterpret_cast<uint8_t*>(k_s + (kQuant ? 1 : kScoreRing) * TN * kLdK);   // [ring][TN][kScoreKC]
  long long* off_s = reinterpret_cast<long long*>(c_s + (kQuant ? kScoreRing * TN * kScoreKC : 0));
  float* sc_s = reinterpret_cast<float*>(off_s + TN);   // the tokens' row scales

  const int nch = (p.d + kScoreKC - 1) / kScoreKC;
  const float* qb = p.q + ((size_t)b * p.rows + r0) * p.d;
  auto load_q = [&](int c) {   // q's fp32 rows of stage c
    const int k0 = c * kScoreKC;
    float* dst = q_s + (c % kScoreRing) * TM * kLdQ;
    for (int i = tid; i < TM * (kScoreKC / 4); i += kThr) {
      const int r = i / (kScoreKC / 4), col = (i % (kScoreKC / 4)) * 4;
      const bool live = r0 + r < p.rows && k0 + col < p.d;
      tc::cp_async_16(dst + r * kLdQ + col, live ? qb + (size_t)r * p.d + k0 + col : qb, live);
    }
  };
  // q needs neither kv_len nor the page table: its first stages go first
  // (commit group 0), and kv_len and the tile's table entries are read
  // together (thread i: token t0 + i).
  for (int c = 0; c < kScoreRing - 1 && c < nch; ++c) load_q(c);
  tc::cp_async_commit();
  const int t = t0 + tid;
  const int blk = tid < TN && t < T ? p.page_table[(size_t)b * p.mb + t / p.bs] : 0;
  const int tv = valid_tokens(p.kv_lens[b], p.bs, p.mb);

  if (t0 >= tv) {   // every block of the tile is past kv_len: zeros
    tc::cp_async_wait<0>();
    for (int i = tid; i < TM * TN; i += kThr) {
      const int r = r0 + i / TN, tt = t0 + i % TN;
      if (r < p.rows && tt < T) out[(size_t)r * T + tt] = 0.f;
    }
    return;
  }

  // Each token's page row (-1 past the valid blocks) and row scale.
  const TP* pages = static_cast<const TP*>(p.pages);
  if (tid < TN) {
    const bool live = t < tv;
    off_s[tid] = live ? (long long)blk * p.s_blk + (long long)(t % p.bs) * p.s_row : -1;
    if constexpr (kQuant)
      tc::cp_async_4(sc_s + tid, live ? p.scales + (long long)blk * p.bs + t % p.bs : p.scales,
                     live);
  }
  __syncthreads();

  auto load_pages = [&](int c) {
    const int k0 = c * kScoreKC, st = c % kScoreRing;
    for (int i = tid; i < TN * PPR; i += kThr) {
      const int r = i / PPR, pc = i % PPR, col = k0 + pc * EPP;
      const long long off = off_s[r];
      const bool live = off >= 0 && col < p.d;
      const TP* src = live ? pages + off + col : pages;
      if constexpr (kQuant)
        tc::cp_async_16(c_s + (st * TN + r) * kScoreKC + pc * 16, src, live);
      else
        tc::cp_async_16(k_s + (st * TN + r) * kLdK + pc * 8, src, live);
    }
  };
  // Stage c's pages are commit group c + 1 (stage 0's with the scales).
#pragma unroll
  for (int c = 0; c < kScoreRing - 1; ++c) {
    if (c < nch) load_pages(c);
    tc::cp_async_commit();
  }

  // This warp's group and its rows [wm TM/2, +TM/2), tokens [wn TN/2, +TN/2).
  const int kg = warp / 4, wm = warp & 1, wn = (warp >> 1) & 1;
  float acc[MF][NF][4];
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mf][nf][e] = 0.f;

  for (int c = 0; c < nch; ++c) {
    const int st = c % kScoreRing;
    tc::cp_async_wait<kScoreRing - 2>();   // groups 0 .. c + 1
    __syncthreads();   // stage c has landed; every warp is done with stage c - 1
    if (c + kScoreRing - 1 < nch) {
      load_q(c + kScoreRing - 1);
      load_pages(c + kScoreRing - 1);
    }
    tc::cp_async_commit();
    // q of the stage as TERMS bf16 terms (bf16 pages: q rounded to bf16).
    const float* qs = q_s + st * TM * kLdQ;
    for (int i = tid; i < TM * (kScoreKC / 4); i += kThr) {
      const int r = i / (kScoreKC / 4), col = (i % (kScoreKC / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(qs + r * kLdQ + col);
      float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int tt = 0; tt < TERMS; ++tt) {
        float h[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          h[e] = tc::round_bf16(x[e]);
          x[e] -= h[e];
        }
        *reinterpret_cast<uint2*>(qt_s + (tt * TM + r) * kLdK + col) =
            make_uint2(tc::pack_bf16(h[0], h[1]), tc::pack_bf16(h[2], h[3]));
      }
    }
    const bf16* kt = k_s + st * TN * kLdK;
    if constexpr (kQuant) {
      // Widen the stage's codes into the bf16 tile (exact).
      for (int i = tid; i < TN * (kScoreKC / 16); i += kThr) {
        const int r = i / (kScoreKC / 16), cc = (i % (kScoreKC / 16)) * 16;
        uint4 lo, hi;
        tc::widen16(*reinterpret_cast<const uint4*>(c_s + (st * TN + r) * kScoreKC + cc), TP(),
                    lo, hi);
        *reinterpret_cast<uint4*>(k_s + r * kLdK + cc) = lo;
        *reinterpret_cast<uint4*>(k_s + r * kLdK + cc + 8) = hi;
      }
      kt = k_s;
    }
    __syncthreads();
    const int ksteps = min(kScoreKC, p.d - c * kScoreKC) / 16;
    for (int kk = kg; kk < ksteps; kk += KS) {
      uint32_t a[MF][TERMS][4];
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int tt = 0; tt < TERMS; ++tt)
          tc::ldmatrix_x4(a[mf][tt], qt_s + tt * TM * kLdK +
                                         tc::a_off(lane, wm * (TM / 2) + mf * 16, kk * 16, kLdK));
      uint32_t bf[NF / 2][4];
#pragma unroll
      for (int np = 0; np < NF / 2; ++np)
        tc::ldmatrix_x4(bf[np], kt + tc::b_off(lane, wn * (TN / 2) + np * 16, kk * 16, kLdK));
#pragma unroll
      for (int tt = TERMS - 1; tt >= 0; --tt)   // smallest term first
#pragma unroll
        for (int mf = 0; mf < MF; ++mf)
#pragma unroll
          for (int np = 0; np < NF / 2; ++np) {
            tc::mma_bf16(acc[mf][2 * np], a[mf][tt], bf[np][0], bf[np][1]);
            tc::mma_bf16(acc[mf][2 * np + 1], a[mf][tt], bf[np][2], bf[np][3]);
          }
    }
  }

  // The groups' sums added in group order (through the free q ring).
  if constexpr (KS > 1) {
    tc::cp_async_wait<0>();
    __syncthreads();
    float* red = q_s;   // [KS - 1][TM][LDR]
    if (kg > 0) {
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            *reinterpret_cast<float2*>(
                red + ((kg - 1) * TM + wm * (TM / 2) + mf * 16 + g + 8 * i) * LDR +
                wn * (TN / 2) + nf * 8 + 2 * t4) = make_float2(acc[mf][nf][2 * i], acc[mf][nf][2 * i + 1]);
    }
    __syncthreads();
    if (kg > 0) return;
    for (int k = 0; k < KS - 1; ++k)
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float2 v = *reinterpret_cast<const float2*>(
                red + (k * TM + wm * (TM / 2) + mf * 16 + g + 8 * i) * LDR + wn * (TN / 2) +
                nf * 8 + 2 * t4);
            acc[mf][nf][2 * i] += v.x;
            acc[mf][nf][2 * i + 1] += v.y;
          }
  }

  // The row scales per token (quantized), zeros past the valid blocks.
  const bool pairs = (T & 1) == 0;
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + wm * (TM / 2) + mf * 16 + g + 8 * i;
      if (r >= p.rows) continue;
      float* o = out + (size_t)r * T;
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) {
        const int j = wn * (TN / 2) + nf * 8 + 2 * t4, t = t0 + j;
        float v0 = acc[mf][nf][2 * i], v1 = acc[mf][nf][2 * i + 1];
        if constexpr (kQuant) {
          v0 *= sc_s[j];
          v1 *= sc_s[j + 1];
        }
        if (t >= tv) v0 = 0.f;
        if (t + 1 >= tv) v1 = 0.f;
        if (pairs && t + 1 < T) {
          *reinterpret_cast<float2*>(o + t) = make_float2(v0, v1);
        } else {
          if (t < T) o[t] = v0;
          if (t + 1 < T) o[t + 1] = v1;
        }
      }
    }
}

template <int I, typename TP>
int launch_scores(const ScoreParams& p, int batch, cudaStream_t st) {
  constexpr Tile tile = kScoreTiles[I];
  auto kernel = latent_scores_kernel<tile.rows, tile.tokens, tile.ksplit, TP>;
  const size_t smem = scores_smem<tile.rows, tile.tokens, TP>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles_t = ((long long)p.mb * p.bs + tile.tokens - 1) / tile.tokens;
  const long long tiles_r = (p.rows + tile.rows - 1) / tile.rows;
  if (tiles_r > 65535 || batch > 65535 || tiles_t > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)tiles_t, (unsigned)tiles_r, batch), 128 * tile.ksplit, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename TP>
int launch_scores_kind(const ScoreParams& p, int batch, cudaStream_t st) {
  return p.rows <= 32 ? launch_scores<0, TP>(p, batch, st) : launch_scores<1, TP>(p, batch, st);
}

// ---------------------------------------------------------------------------
// Phase 2: weighted sum.

constexpr int kWsumTK = 32;       // tokens a ring stage (two mma k-steps)
constexpr int kWsumRing = 4;      // ring stages
constexpr int kWsumCols = 256;    // latent columns a block (four warps of 64)
constexpr int kLdL = kWsumCols + 8;   // bf16 row stride of a latent stage
constexpr int kLdP = kWsumTK + 8;     // fp32 row stride of a p stage (conflict-free pairs)
constexpr int kExpThreads = 256;      // 8 warps
constexpr int kExpWarps = kExpThreads / 32;
constexpr int kExpRows = 16, kExpCols = 64;
constexpr int kLdW = kExpCols + 8;    // bf16 row stride of the w_v tile
constexpr int kLdR = kExpCols + 8;    // fp32 row stride of a warp's sums

struct WsumParams {
  const float* p;          // [B, rows, mb * bs]
  const void* pages;
  const float* scales;
  const int* page_table;
  const int* kv_lens;
  const bf16* w_v;         // (k, h, d) at k * w_sk + h * w_sh + d
  float* out;              // [B, rows, dv]
  float* ws;               // [splits][B][rows][dl]
  int batch, rows, nq, dl, dv, bs, mb, split_tokens, splits, col_blocks;
  long long s_blk, s_row, w_sk, w_sh;
};

// Splits of a slot that hold valid tokens: 0 .. live - 1.
__device__ __forceinline__ int live_splits(int tv, const WsumParams& p) {
  return min(p.splits, (tv + p.split_tokens - 1) / p.split_tokens);
}

template <int TM, typename TP>
size_t split_smem() {
  constexpr bool kQuant = !std::is_same<TP, bf16>::value;
  const size_t lat = kQuant ? (size_t)kWsumTK * kLdL * sizeof(bf16) + kWsumRing * kWsumTK * kWsumCols
                            : (size_t)kWsumRing * kWsumTK * kLdL * sizeof(bf16);
  return lat + (size_t)kWsumRing * TM * kLdP * sizeof(float) + kWsumRing * kWsumTK * sizeof(float);
}

// grid (splits, row tiles x column blocks, B); TM / 16 x 4 warps, warp
// (wm, wn) owning rows [16 wm, +16) and columns [64 wn, +64) of the
// block's 256.
template <int TM, typename TP>
__global__ void __launch_bounds__(TM * 8) latent_wsum_split_kernel(const WsumParams p) {
  constexpr int kThr = TM * 8;
  constexpr int kWarpCols = kWsumCols / 4;
  constexpr bool kQuant = !std::is_same<TP, bf16>::value;
  constexpr int EPP = 16 / (int)sizeof(TP), PPR = kWsumCols / EPP;
  constexpr int kFirst = (kWsumRing - 1) * kWsumTK;   // tokens of the first ring stages
  static_assert(kFirst <= kThr, "a thread a token of the first stages");
  __shared__ int blk_s[kFirst];

  const int b = blockIdx.z, split = blockIdx.x;
  const int rt = blockIdx.y / p.col_blocks, cb = blockIdx.y % p.col_blocks;
  const int r0 = rt * TM, c0 = cb * kWsumCols, ncols = min(kWsumCols, p.dl - c0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int T = p.mb * p.bs;
  const int s0 = split * p.split_tokens;
  // kv_len and the page-table entries of the first stages, read together.
  const int* table = p.page_table + (size_t)b * p.mb;
  const int blk0 = tid < kFirst && s0 + tid < T ? table[(s0 + tid) / p.bs] : 0;
  const int tv = valid_tokens(p.kv_lens[b], p.bs, p.mb);
  const int s1 = min(s0 + p.split_tokens, tv);
  tc::pdl_trigger();   // the expansion may start staging w_v
  // A split wholly past the valid blocks does nothing; the combine reads
  // nothing of it.
  if (s0 >= s1) return;
  if (tid < kFirst) blk_s[tid] = blk0;
  __syncthreads();

  extern __shared__ uint4 smem_raw[];
  bf16* l_s = reinterpret_cast<bf16*>(smem_raw);   // bf16: [ring][TK][kLdL]; else widened [TK][kLdL]
  uint8_t* c_s = reinterpret_cast<uint8_t*>(l_s + (kQuant ? 1 : kWsumRing) * kWsumTK * kLdL);
  float* p_s = reinterpret_cast<float*>(c_s + (kQuant ? kWsumRing * kWsumTK * kWsumCols : 0));
  float* sc_s = p_s + kWsumRing * TM * kLdP;   // [ring][TK] row scales

  const TP* pages = static_cast<const TP*>(p.pages);
  const float* pb = p.p + ((size_t)b * p.rows + r0) * T;
  auto block_of = [&](int j, int r) {   // the page of stage j's token r
    return j < kWsumRing - 1 ? blk_s[j * kWsumTK + r] : table[(s0 + j * kWsumTK + r) / p.bs];
  };
  // p in 16-byte pieces when no piece straddles the end of the valid
  // blocks or a row (bs % 4 == 0), else 4-byte copies.
  const bool vec_p = p.bs % 4 == 0;
  auto load = [&](int j, int slot) {
    const int tb = s0 + j * kWsumTK;
    for (int i = tid; i < kWsumTK * PPR; i += kThr) {
      const int r = i / PPR, pc = i % PPR, t = tb + r;
      const bool live = t < s1 && pc * EPP < ncols;
      const TP* src = pages;
      if (live)
        src += (long long)block_of(j, r) * p.s_blk + (long long)(t % p.bs) * p.s_row + c0 +
               pc * EPP;
      if constexpr (kQuant)
        tc::cp_async_16(c_s + (slot * kWsumTK + r) * kWsumCols + pc * 16, src, live);
      else
        tc::cp_async_16(l_s + (slot * kWsumTK + r) * kLdL + pc * 8, src, live);
    }
    float* ps = p_s + slot * TM * kLdP;
    if (vec_p) {
      for (int i = tid; i < TM * (kWsumTK / 4); i += kThr) {
        const int r = i / (kWsumTK / 4), c = (i % (kWsumTK / 4)) * 4, t = tb + c;
        const bool live = r0 + r < p.rows && t < s1;
        tc::cp_async_16(ps + r * kLdP + c, live ? pb + (size_t)r * T + t : pb, live);
      }
    } else {
      for (int i = tid; i < TM * kWsumTK; i += kThr) {
        const int r = i / kWsumTK, c = i % kWsumTK, t = tb + c;
        const bool live = r0 + r < p.rows && t < s1;
        tc::cp_async_4(ps + r * kLdP + c, live ? pb + (size_t)r * T + t : pb, live);
      }
    }
    if constexpr (kQuant) {
      for (int i = tid; i < kWsumTK; i += kThr) {
        const int t = tb + i;
        const bool live = t < s1;
        const float* src =
            live ? p.scales + (long long)block_of(j, i) * p.bs + t % p.bs : p.scales;
        tc::cp_async_4(sc_s + slot * kWsumTK + i, src, live);
      }
    }
  };

  const int nst = s1 > s0 ? (s1 - s0 + kWsumTK - 1) / kWsumTK : 0;
#pragma unroll
  for (int j = 0; j < kWsumRing - 1; ++j) {
    if (j < nst) load(j, j);
    tc::cp_async_commit();
  }

  const int wm = warp % (TM / 16), wn = warp / (TM / 16);
  const int wc = wn * kWarpCols, wcols = min(kWarpCols, ncols - wc);   // the warp's columns
  float acc[kWarpCols / 8][4];
#pragma unroll
  for (int j = 0; j < kWarpCols / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int j = 0; j < nst; ++j) {
    const int slot = j % kWsumRing;
    tc::cp_async_wait<kWsumRing - 2>();
    __syncthreads();   // stage j has landed; every warp is done with stage j - 1
    if (j + kWsumRing - 1 < nst) load(j + kWsumRing - 1, (j + kWsumRing - 1) % kWsumRing);
    tc::cp_async_commit();
    const bf16* lt = l_s + slot * kWsumTK * kLdL;
    if constexpr (kQuant) {
      for (int i = tid; i < kWsumTK * (kWsumCols / 16); i += kThr) {
        const int r = i / (kWsumCols / 16), cc = (i % (kWsumCols / 16)) * 16;
        uint4 lo, hi;
        tc::widen16(*reinterpret_cast<const uint4*>(c_s + (slot * kWsumTK + r) * kWsumCols + cc),
                    TP(), lo, hi);
        *reinterpret_cast<uint4*>(l_s + r * kLdL + cc) = lo;
        *reinterpret_cast<uint4*>(l_s + r * kLdL + cc + 8) = hi;
      }
      __syncthreads();
      lt = l_s;
    }
    if (wcols <= 0) continue;
    const float* ps = p_s + (slot * TM + wm * 16) * kLdP;
    const float* scs = sc_s + slot * kWsumTK;
    const int tb = s0 + j * kWsumTK;
#pragma unroll
    for (int kk = 0; kk < kWsumTK / 16; ++kk) {
      if (tb + kk * 16 >= s1) break;
      const int c = kk * 16 + 2 * t4;
      float2 v[4] = {*reinterpret_cast<const float2*>(ps + g * kLdP + c),
                     *reinterpret_cast<const float2*>(ps + (g + 8) * kLdP + c),
                     *reinterpret_cast<const float2*>(ps + g * kLdP + c + 8),
                     *reinterpret_cast<const float2*>(ps + (g + 8) * kLdP + c + 8)};
      if constexpr (kQuant) {   // p s_t: the row scale folded into p
        const float2 lo = *reinterpret_cast<const float2*>(scs + c);
        const float2 hi = *reinterpret_cast<const float2*>(scs + c + 8);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 s = e < 2 ? lo : hi;
          v[e].x *= s.x;
          v[e].y *= s.y;
        }
      }
      const float x[8] = {v[0].x, v[0].y, v[1].x, v[1].y, v[2].x, v[2].y, v[3].x, v[3].y};
      uint32_t a[kTerms][4];
      tc::split_a<kTerms>(a, x);
      uint32_t bf[kWarpCols / 16][4];
#pragma unroll
      for (int np = 0; np < kWarpCols / 16; ++np)
        if (np * 16 < wcols)
          tc::ldmatrix_x4_trans(bf[np], lt + tc::bt_off(lane, kk * 16, wc + np * 16, kLdL));
      // Smallest term first; consecutive mmas on other accumulators.
#pragma unroll
      for (int tt = kTerms - 1; tt >= 0; --tt)
#pragma unroll
        for (int np = 0; np < kWarpCols / 16; ++np)
          if (np * 16 < wcols) {
            tc::mma_bf16(acc[2 * np], a[tt], bf[np][0], bf[np][1]);
            tc::mma_bf16(acc[2 * np + 1], a[tt], bf[np][2], bf[np][3]);
          }
    }
  }

  // The fp32 partial of this split.
  const size_t sstride = (size_t)p.batch * p.rows * p.dl;
  float* ws = p.ws + (size_t)split * sstride + (size_t)b * p.rows * p.dl + c0;
  if (wcols > 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + wm * 16 + g + 8 * i;
      if (r >= p.rows) continue;
#pragma unroll
      for (int nt = 0; nt < kWarpCols / 8; ++nt)
        if (nt * 8 < wcols)
          *reinterpret_cast<float2*>(ws + (size_t)r * p.dl + wc + nt * 8 + 2 * t4) =
              make_float2(acc[nt][2 * i], acc[nt][2 * i + 1]);
    }
  }
}

size_t expand_smem(int dl) {
  return (size_t)dl * kLdW * sizeof(bf16) + (size_t)kExpRows * (dl + 8) * sizeof(float) +
         kExpWarps * kExpRows * kLdR * sizeof(float);
}

// grid (nq, value tiles, head-row tiles), kExpThreads threads; launched as a
// programmatic dependent of the split kernel.
__global__ void __launch_bounds__(kExpThreads) latent_wsum_expand_kernel(const WsumParams p) {
  const int n = blockIdx.x, d0 = blockIdx.y * kExpCols, h0 = blockIdx.z * kExpRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int s_q = p.rows / p.nq, rn = p.batch * s_q;   // head n's rows: (slot, position)
  const int ldu = p.dl + 8;
  __shared__ int row_s[kExpRows], live_s[kExpRows];
  extern __shared__ uint4 smem_raw[];
  bf16* w_s = reinterpret_cast<bf16*>(smem_raw);                   // [dl][kLdW]
  float* u_s = reinterpret_cast<float*>(w_s + (size_t)p.dl * kLdW);   // [kExpRows][ldu]
  float* red = u_s + kExpRows * ldu;                                   // [warps][kExpRows][kLdR]

  // w_v[:, n, d0 : d0 + 64] (an input: no wait for the split kernel).
  for (int i = tid; i < p.dl * (kExpCols / 8); i += kExpThreads) {
    const int k = i / (kExpCols / 8), c = (i % (kExpCols / 8)) * 8;
    const bool live = d0 + c < p.dv;
    tc::cp_async_16(w_s + k * kLdW + c,
                    live ? p.w_v + k * p.w_sk + n * p.w_sh + d0 + c : p.w_v, live);
  }
  tc::cp_async_commit();
  if (tid < kExpRows) {
    const int h = h0 + tid;
    int row = -1, live = 0;
    if (h < rn) {
      const int bb = h / s_q;
      row = bb * p.rows + (h % s_q) * p.nq + n;
      const int tv = valid_tokens(p.kv_lens[bb], p.bs, p.mb);
      live = live_splits(tv, p);
    }
    row_s[tid] = row;
    live_s[tid] = live;
  }
  __syncthreads();
  tc::pdl_wait();   // the split kernel's partials are complete and visible

  // u: each row's live splits added in split order. A thread takes kElems
  // float4s of the live rows and loads kSplitBatch splits of each at once.
  constexpr int kElems = 4, kSplitBatch = 4;
  const size_t sstride = (size_t)p.batch * p.rows * p.dl;
  const int c4 = p.dl / 4, nr = min(kExpRows, rn - h0), total = nr * c4;
  for (int i0 = tid; i0 < total; i0 += kExpThreads * kElems) {
    const float* w[kElems];
    int live[kElems], most = 0;
    float4 v[kElems];
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      const int i = i0 + e * kExpThreads, r = i / c4;
      live[e] = i < total ? live_s[r] : 0;
      w[e] = p.ws + (size_t)max(row_s[min(r, kExpRows - 1)], 0) * p.dl + (i % c4) * 4;
      v[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      most = max(most, live[e]);
    }
    for (int s0 = 0; s0 < most; s0 += kSplitBatch) {
      float4 x[kElems][kSplitBatch];
#pragma unroll
      for (int e = 0; e < kElems; ++e)
#pragma unroll
        for (int k = 0; k < kSplitBatch; ++k)
          if (s0 + k < live[e])
            x[e][k] = __ldcg(reinterpret_cast<const float4*>(w[e] + (s0 + k) * sstride));
#pragma unroll
      for (int e = 0; e < kElems; ++e)
#pragma unroll
        for (int k = 0; k < kSplitBatch; ++k) {
          if (s0 + k >= live[e]) break;
          if (s0 + k == 0) {
            v[e] = x[e][k];
          } else {
            v[e].x += x[e][k].x;
            v[e].y += x[e][k].y;
            v[e].z += x[e][k].z;
            v[e].w += x[e][k].w;
          }
        }
    }
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      const int i = i0 + e * kExpThreads;
      if (i < total) *reinterpret_cast<float4*>(u_s + (i / c4) * ldu + (i % c4) * 4) = v[e];
    }
  }
  // The tile's rows past head n's last one: zeros.
  for (int i = nr * c4 + tid; i < kExpRows * c4; i += kExpThreads)
    *reinterpret_cast<float4*>(u_s + (i / c4) * ldu + (i % c4) * 4) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  tc::cp_async_wait<0>();
  __syncthreads();

  // out tile = u . w_v tile, warp w taking k-steps w, w + kExpWarps, ...
  float acc[kExpCols / 8][4];
#pragma unroll
  for (int j = 0; j < kExpCols / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int kk = warp; kk < p.dl / 16; kk += kExpWarps) {
    const int c = kk * 16 + 2 * t4;
    const float2 v0 = *reinterpret_cast<const float2*>(u_s + g * ldu + c);
    const float2 v1 = *reinterpret_cast<const float2*>(u_s + (g + 8) * ldu + c);
    const float2 v2 = *reinterpret_cast<const float2*>(u_s + g * ldu + c + 8);
    const float2 v3 = *reinterpret_cast<const float2*>(u_s + (g + 8) * ldu + c + 8);
    const float x[8] = {v0.x, v0.y, v1.x, v1.y, v2.x, v2.y, v3.x, v3.y};
    uint32_t a[kTerms][4];
    tc::split_a<kTerms>(a, x);
    uint32_t bf[kExpCols / 16][4];
#pragma unroll
    for (int np = 0; np < kExpCols / 16; ++np)
      tc::ldmatrix_x4_trans(bf[np], w_s + tc::bt_off(lane, kk * 16, np * 16, kLdW));
#pragma unroll
    for (int tt = kTerms - 1; tt >= 0; --tt)
#pragma unroll
      for (int np = 0; np < kExpCols / 16; ++np) {
        tc::mma_bf16(acc[2 * np], a[tt], bf[np][0], bf[np][1]);
        tc::mma_bf16(acc[2 * np + 1], a[tt], bf[np][2], bf[np][3]);
      }
  }
  float* rw = red + warp * kExpRows * kLdR;
#pragma unroll
  for (int j = 0; j < kExpCols / 8; ++j) {
    *reinterpret_cast<float2*>(rw + g * kLdR + 8 * j + 2 * t4) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(rw + (g + 8) * kLdR + 8 * j + 2 * t4) =
        make_float2(acc[j][2], acc[j][3]);
  }
  __syncthreads();
  for (int i = tid; i < kExpRows * kExpCols; i += kExpThreads) {
    const int r = i / kExpCols, col = i % kExpCols, row = row_s[r];
    if (row < 0 || d0 + col >= p.dv) continue;
    const int o = r * kLdR + col;
    float v = red[o];
#pragma unroll
    for (int w = 1; w < kExpWarps; ++w) v += red[w * kExpRows * kLdR + o];
    p.out[(size_t)row * p.dv + d0 + col] = v;
  }
}

template <int TM, typename TP>
int launch_split(const WsumParams& p, cudaStream_t st) {
  auto kernel = latent_wsum_split_kernel<TM, TP>;
  const size_t smem = split_smem<TM, TP>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long y = (long long)(p.rows + TM - 1) / TM * p.col_blocks;
  if (y > 65535 || p.batch > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<dim3(p.splits, (unsigned)y, p.batch), TM * 8, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// Row 9's row tiles a split block (ops/cuda/latent_tp.py WSUM_ROW_TILES).
#define LATENT_WSUM_ROW_TILES(X) X(32) X(64)

template <typename TP>
int launch_wsum(const WsumParams& p, int row_tile, cudaStream_t st) {
  int err = (int)cudaErrorInvalidValue;
#define LATENT_WSUM_CASE(TM) \
  if (row_tile == TM) err = launch_split<TM, TP>(p, st);
  LATENT_WSUM_ROW_TILES(LATENT_WSUM_CASE)
#undef LATENT_WSUM_CASE
  if (err != 0) return err;
  const size_t smem = expand_smem(p.dl);
  cudaError_t e = cudaFuncSetAttribute(latent_wsum_expand_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long rn = (long long)p.batch * (p.rows / p.nq);
  const long long z = (rn + kExpRows - 1) / kExpRows;
  if (z > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(p.nq, (p.dv + kExpCols - 1) / kExpCols, (unsigned)z);
  return (int)tc::launch_pdl(latent_wsum_expand_kernel, grid, dim3(kExpThreads), smem, st, p);
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
  ScoreParams p = {static_cast<const float*>(q), pages, static_cast<const float*>(scales),
                   static_cast<const int*>(page_table), static_cast<const int*>(kv_lens),
                   static_cast<float*>(out), rows, d, block_size, max_blocks, s_blk, s_row};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (page_kind == 0) return launch_scores_kind<bf16>(p, batch, st);
  if (page_kind == 1) return launch_scores_kind<int8_t>(p, batch, st);
  return launch_scores_kind<fp8>(p, batch, st);
}

// p [batch, rows, mb * bs] fp32; pages, scales, page_table, kv_lens as for
// latent_scores_launch, with dl latent columns; w_v bf16 element (k, h, d) at
// k * w_stride_k + h * w_stride_h + d (16-byte aligned rows, dv % 8 == 0),
// nq heads, dv values; out [batch, rows, dv] fp32, row r of head r mod nq.
// The split plan: row_tile rows a split block (32 or 64), split_tokens (a
// multiple of 32) tokens a split, splits covering mb * bs; workspace
// [splits, batch, rows, dl] fp32. Two launches, the second a programmatic
// dependent of the first. Returns a cudaError_t code.
extern "C" int latent_wsum_launch(const void* p, const void* pages,
                                  const void* scales, const void* page_table,
                                  const void* kv_lens, const void* w_v,
                                  void* out, void* workspace,
                                  int batch, int rows, int nq, int dl, int dv,
                                  int block_size, int max_blocks,
                                  long long s_blk, long long s_row,
                                  long long w_stride_k, long long w_stride_h,
                                  int page_kind, int row_tile,
                                  int split_tokens, int splits,
                                  void* stream) {
  if (batch < 1 || rows < 1 || nq < 1 || rows % nq || dv < 8 || dv % 8 ||
      bad_pages(dl, page_kind, scales, block_size, max_blocks) || split_tokens < kWsumTK ||
      split_tokens % kWsumTK || splits < 1 ||
      (long long)splits * split_tokens < (long long)block_size * max_blocks ||
      (long long)(splits - 1) * split_tokens >= (long long)block_size * max_blocks ||
      workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  WsumParams a = {static_cast<const float*>(p), pages, static_cast<const float*>(scales),
                  static_cast<const int*>(page_table), static_cast<const int*>(kv_lens),
                  static_cast<const __nv_bfloat16*>(w_v), static_cast<float*>(out),
                  static_cast<float*>(workspace),
                  batch, rows, nq, dl, dv, block_size, max_blocks, split_tokens, splits,
                  (dl + kWsumCols - 1) / kWsumCols,
                  s_blk, s_row, w_stride_k, w_stride_h};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (page_kind == 0) return launch_wsum<bf16>(a, row_tile, st);
  if (page_kind == 1) return launch_wsum<int8_t>(a, row_tile, st);
  return launch_wsum<fp8>(a, row_tile, st);
}
