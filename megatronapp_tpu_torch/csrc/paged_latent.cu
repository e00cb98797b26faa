// MLA latent-space ragged paged attention for Hopper (sm_90a), decode and
// ragged modes.
//
// Replaces the TPU kernel megatronapp_tpu/ops/pallas/kernel_gen.py
// paged_attention_latent (def :456, pallas_call :557; body
// emit_latent_kernel :338) for bf16 pools and for quantized pools: int8 or
// fp8 (e4m3) pages with one fp32 scale per row ([NB, bs], read through the
// same page table).
//
// What it computes. Query row r = s * nq + h of slot b holds the absorbed
// query q_lat [klat] (q_nope through kv_up's k_nope columns) and the roped
// q_pe [dpe]. The pool has no head axis: token t of the slot is one latent
// row [klat] and one roped key row [dpe], shared by every head. Scores are
// q_lat . latent + q_pe . k_pe, scaled by softmax_scale; an online softmax
// runs over [0, kv_len) with the causal limit kv_len - q_len + s in ragged
// mode; the value of token t for head h is latent_t . w_v[:, h, :], with
// w_v [klat, nq, dv] kv_up's v columns (a strided view: the launcher takes
// its k and h strides, so the wrapper never copies it). The TPU body
// re-expands every block's values through w_v; this kernel sums P . latent
// in latent space and expands once a row: the same function up to the
// order of the fp32 sums, ~57x fewer operations at decode.
//
// Bound. Decode B 8, kv 1024: 8 x 1024 x 576 x 2 B of pool plus w_v's 4.2
// MB, 13.6 MB, ~4.1 us at 3.35 TB/s (0.60 GFLOP: bytes bound). A ragged B 1,
// S_q 32, kv 1024 chunk does ~2.4 GFLOP, ~2.4 us at 989 TFLOP/s
// (operations bound).
//
// Design: two launches, every product on the tensor cores (mma.sync
// m16n8k16, bf16 operands, fp32 sums; tensor_core.cuh).
// - paged_latent_split_kernel: a block takes (token split, row tile,
//   slot). The row tile is 32 rows at decode (a slot's 32 heads) or 64 for
//   chunks (2 positions x 32 heads); a split is a run of whole ring stages
//   of the slot's table positions, from a plan that reads shapes alone
//   (ops/cuda/paged_latent.py latent_split_plan: about one wave of
//   blocks, at most kMaxSplits splits). A split wholly past kv_len or past
//   the tile's largest causal limit exits at once. kv_len and the first
//   stages' page-table rows are read together (the rows then sit in shared
//   memory, each later stage's read one stage ahead), so a stage's 16-byte
//   cp.async copies of [latent | k_pe] rows wait on no load of their own.
//   Q [rows, klat + dpe] stays in shared memory for the split (bf16 pools:
//   bf16(q x scale), the TPU body's rounding; quantized pools: q as given,
//   exact); one-byte codes land in a ring of their own and are widened to
//   bf16 exactly (tc::widen16). Ring (kTiles): two 64-token stages at 32
//   rows, three 32-token stages at 64 rows. Scores S = Q . K^T as 16 x 32
//   (16 x 16 at 64 rows: registers) warp tiles, the k-steps dealt to warp
//   groups whose sums are added in group order; on quantized pools the
//   latent and k_pe parts accumulate apart and take softmax_scale x their
//   own row scale in fp32. Masks (kv_len, the causal limit) and the online
//   softmax run in fp32 with the TPU body's conventions (-1e30, m_safe,
//   corr = 0 while m_prev <= -5e29), 8 lanes a row; P (x the token's latent
//   row scale on quantized pools) is written once as kPTerms bf16 terms
//   (fp32 grade: 2^-17 of an element; one term costs 2^-9, see PERF.md).
//   acc[rows, klat] += P . latent_stage with the accumulator spread over
//   the warps by latent columns (8 warps of 64 at klat 512; two row groups
//   at 64 rows), P's terms read by ldmatrix against the exact bf16 latent.
//   Each block writes its unnormalised acc and (m, l) a row to the
//   workspace (allocated before the launch).
// - paged_latent_combine_kernel, launched as a programmatic dependent of
//   the split kernel: a block takes (head h, a quarter of the latent
//   columns, 128 value columns, 16 of head h's rows across slots and
//   positions). It stages w_v's rows of its quarter before waiting for the
//   split kernel (an input), then loads its partials of every live split
//   at once beside the splits' (m, l), adds them in split order with
//   weights e^{m_i - m} (ops/cuda/paged_attention.py merge_split_partials),
//   divides by max(l, 1e-20) and expands its quarter, u in three bf16
//   terms, into an fp32 partial tile; the last of a tile's four blocks to
//   finish (a counter that it resets) adds the four partials in quarter
//   order and writes the bf16 output. So each partial of the workspace is
//   read once, by about one wave of blocks.
// Every sum runs in a fixed order and there are no float atomics (the
// counter picks which block adds, not the order), so a rerun repeats every
// bit.
//
// Time on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's times phase,
// kernel and SDPA yardstick queued in turns behind a sleep; PERF.md row 7):
// decode B 8, kv 1024 0.024-0.025 ms, the chunk 0.041-0.047 ms, 6x and 17x
// the bounds. What holds it from half its bound, measured (flash_probe.py
// paged-latent-timeline / -splits): at
// decode the kv_len -> table -> pages chain (~1.9 us) and the page bytes
// (~3-4 us), the partials' 8.4 MB written and read back with the combine's
// dependent round trips (~9 us of 24); at the chunk the mma.sync issue of
// the scores and the two-term P . latent (~67 % of a split block) and the
// 16.8 MB of partials.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_fp8_e4m3 fp8;

constexpr int kMaxWidth = 640;   // klat + dpe
constexpr int kMaxSplits = 16;   // splits of a slot's table positions
constexpr int kPTerms = 2;       // bf16 terms of P (x the row scale) in P . latent
constexpr int kColWarps = 8;     // warps sharing a row group's latent columns
constexpr int kUTerms = 3;       // bf16 terms of u in the expansion
constexpr float kNegInf = tc::kNegInf;
constexpr float kLog2e = tc::kLog2e;

// Split-kernel tiles: rows, tokens a ring stage, warps, the most latent
// columns a warp, ring stages. [0] 32-row tiles with klat <= 512, [1]
// 32-row tiles with klat <= 640 (shared memory: shorter stages), [2]
// 64-row tiles (klat <= 512).
struct Tile {
  int rows, tokens, warps, warp_cols, ring;
};
constexpr Tile kTiles[3] = {{32, 64, 8, 64, 2}, {32, 32, 8, 80, 3}, {64, 32, 16, 64, 3}};

struct Params {
  const bf16* q_lat;        // [B, rows, klat], row = s * nq + h
  const bf16* q_pe;         // [B, rows, dpe]
  const void* lat_pages;    // [NB, bs, klat]
  const void* pe_pages;     // [NB, bs, dpe]
  const float* lat_scales;  // [NB, bs] (quantized pools)
  const float* pe_scales;
  const int* page_table;    // [B, mb]
  const int* kv_lens;       // [B]
  const int* q_lens;        // [B]; nullptr at decode
  const bf16* w_v;          // (k, h, d) at k * w_sk + h * w_sh + d
  bf16* out;                // [B, rows, dv]
  float* ws;                // acc [splits][B][rows][klat], (m, l) [splits][B][rows][2],
                            // then from part_off the combine's quarter partials
  int* counters;            // the combine's units, zero between calls
  size_t part_off;
  int batch, nq, rows, klat, dpe, dv, bs, mb, split_tokens, splits, w_vec;
  long long w_sk, w_sh;
  float scale;
};

// The end of the positions query position s of slot b sees: [0, end).
__device__ __forceinline__ int visible_end(const Params& p, int b, int s) {
  const int kv_len = p.kv_lens[b];
  const int q_start = kv_len - (p.q_lens != nullptr ? p.q_lens[b] : 1);
  return max(min(min(kv_len, p.mb * p.bs), q_start + s + 1), 0);
}

// ---------------------------------------------------------------------------
// The split kernel.

// Tokens of a score warp tile: 32, or 16 at 64-row tiles (registers).
template <int TM>
__host__ __device__ constexpr int score_cols() {
  return TM == 64 ? 16 : 32;
}

template <int TM, int TK, int NW, int RING, typename TP>
size_t split_smem(int kd) {
  constexpr bool kQuant = !std::is_same<TP, bf16>::value;
  constexpr int KS = NW / ((TM / 16) * (TK / score_cols<TM>()));
  const size_t ldk = kd + 8;
  size_t bytes = (size_t)TM * ldk * sizeof(bf16);   // Q
  bytes += kQuant ? (size_t)TK * ldk * sizeof(bf16) + (size_t)RING * TK * kd
                  : (size_t)RING * TK * ldk * sizeof(bf16);
  bytes += (size_t)KS * TM * (TK + 8) * sizeof(float);          // score sums
  bytes += (size_t)kPTerms * TM * (TK + 8) * sizeof(bf16);      // P terms
  bytes += (size_t)RING * TK * sizeof(long long);              // page rows
  bytes += (kQuant ? (size_t)RING * 2 * TK * sizeof(float) : 0) + 3 * TM * sizeof(float);
  return bytes;
}

// grid (splits, row tiles, B), NW warps. Score warp w: the 16 x SN tile
// w % tiles of the stage's [TM, TK] scores over k-steps w / tiles, + KS,
// ...; softmax: 8 lanes a row, 4 rows a warp; P . latent warp w: rows
// [RW (w / 8), + RW), latent columns [cpw (w % 8), + cpw).
template <int TM, int TK, int NW, int NCW, int RING, typename TP>
__global__ void __launch_bounds__(NW * 32, 1) paged_latent_split_kernel(const Params p) {
  constexpr int kThr = NW * 32;
  constexpr bool kQuant = !std::is_same<TP, bf16>::value;
  constexpr int SN = score_cols<TM>(), NF = SN / 8;
  constexpr int kTilesS = (TM / 16) * (TK / SN);   // 16 x SN score tiles a stage
  constexpr int KS = NW / kTilesS;                 // warp groups splitting their k-steps
  constexpr int LPR = 8, TPL = TK / LPR;   // softmax: lanes a row, tokens a lane
  constexpr int RW = TM / (NW / kColWarps);         // rows of a P . latent warp
  constexpr int MT = RW / 16, NT = NCW / 8, NP = NCW / 16;
  constexpr int EPP = 16 / (int)sizeof(TP);         // elements a 16-byte piece
  constexpr int LDS = TK + 8;                       // fp32 row stride of the score sums
  constexpr int LDP = TK + 8;                       // bf16 row stride of the P terms
  static_assert(KS >= 1 && KS * kTilesS == NW, "whole score tiles");
  static_assert(NW % kColWarps == 0 && RW % 16 == 0 && NCW % 16 == 0, "whole warp tiles");
  static_assert(TPL % 4 == 0 && TM % (32 / LPR) == 0, "whole softmax rows");
  static_assert(RING * TK <= kThr, "a thread a page row");

  const int b = blockIdx.z, r0 = blockIdx.y * TM, split = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int kd = p.klat + p.dpe, ldk = kd + 8;
  const int s0 = split * p.split_tokens, table_end = p.mb * p.bs;

  extern __shared__ uint4 smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [TM][ldk]
  bf16* k_s = q_s + TM * ldk;                      // bf16: [ring][TK][ldk]; else widened [TK][ldk]
  uint8_t* c_s = reinterpret_cast<uint8_t*>(k_s + (kQuant ? 1 : RING) * TK * ldk);   // [ring][TK][kd]
  float* s_s = reinterpret_cast<float*>(c_s + (kQuant ? RING * TK * kd : 0));   // [KS][TM][LDS]
  bf16* pt_s = reinterpret_cast<bf16*>(s_s + KS * TM * LDS);   // [kPTerms][TM][LDP]
  long long* row_s = reinterpret_cast<long long*>(pt_s + kPTerms * TM * LDP);   // [ring][TK]
  float* sc_s = reinterpret_cast<float*>(row_s + RING * TK);   // [ring][lat, pe][TK] row scales
  float* m_s = sc_s + (kQuant ? RING * 2 * TK : 0);
  float* l_s = m_s + TM;
  float* corr_s = l_s + TM;

  // kv_len and the page rows of the first RING stages, read together;
  // Q, which needs neither, is copied meanwhile (commit group 0).
  const int* table = p.page_table + (size_t)b * p.mb;
  auto page_row = [&](int t) -> long long {
    return t < table_end ? (long long)__ldg(table + t / p.bs) * p.bs + t % p.bs : -1;
  };
  const long long first_row = tid < RING * TK ? page_row(s0 + tid) : -1;
  const int kv_len = p.kv_lens[b];
  const int q_start = kv_len - (p.q_lens != nullptr ? p.q_lens[b] : 1);
  const int qpl = p.klat / 8, qpr = kd / 8;   // 16-byte pieces of a q_lat row, of a Q row
  for (int i = tid; i < TM * qpr; i += kThr) {
    const int r = i / qpr, pc = i - r * qpr;
    const bool live = r0 + r < p.rows;
    const size_t row = (size_t)b * p.rows + r0 + r;
    const bf16* src = !live      ? p.q_lat
                      : pc < qpl ? p.q_lat + row * p.klat + pc * 8
                                 : p.q_pe + row * p.dpe + (pc - qpl) * 8;
    tc::cp_async_16(q_s + r * ldk + pc * 8, src, live);
  }
  tc::cp_async_commit();
  const int s1 = min(s0 + p.split_tokens, visible_end(p, b, (min(r0 + TM, p.rows) - 1) / p.nq));
  tc::pdl_trigger();   // the combine may start staging w_v
  if (s0 >= s1) {      // nothing of the split is visible to the tile
    tc::cp_async_wait<0>();
    return;
  }
  if (tid < RING * TK) row_s[tid] = first_row;
  for (int r = tid; r < TM; r += kThr) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const TP* lat = static_cast<const TP*>(p.lat_pages);
  const TP* pe = static_cast<const TP*>(p.pe_pages);
  const int lpc = p.klat / EPP, ppr = kd / EPP;   // 16-byte pieces of a latent row, of a token
  auto load_stage = [&](int j, int slot) {
    const int tb = s0 + j * TK;
    const long long* rows = row_s + slot * TK;
    for (int i = tid; i < TK * ppr; i += kThr) {
      const int r = i / ppr, pc = i - r * ppr;
      const bool live = tb + r < s1;
      const long long row = rows[r];
      const TP* src = !live     ? lat
                      : pc < lpc ? lat + row * p.klat + pc * EPP
                                 : pe + row * p.dpe + (pc - lpc) * EPP;
      if constexpr (kQuant)
        tc::cp_async_16(c_s + (slot * TK + r) * kd + pc * 16, src, live);
      else
        tc::cp_async_16(k_s + (slot * TK + r) * ldk + pc * 8, src, live);
    }
    if constexpr (kQuant) {
      for (int i = tid; i < 2 * TK; i += kThr) {
        const int r = i % TK;
        const bool live = tb + r < s1;
        const float* sc = i < TK ? p.lat_scales : p.pe_scales;
        tc::cp_async_4(sc_s + slot * 2 * TK + i, live ? sc + rows[r] : sc, live);
      }
    }
  };
  const int nst = (s1 - s0 + TK - 1) / TK;
#pragma unroll
  for (int c = 0; c < RING - 1; ++c) {
    if (c < nst) load_stage(c, c);
    tc::cp_async_commit();
  }

  const int ti = warp % kTilesS, kg = warp / kTilesS;
  const int sm = ti / (TK / SN) * 16, sn = ti % (TK / SN) * SN;
  const int sr = warp * (32 / LPR) + lane / LPR, sc0 = lane % LPR * TPL;   // softmax row, first token
  const int wr = warp / kColWarps * RW;
  const int cpw = (p.klat / 16 + kColWarps - 1) / kColWarps * 16;
  const int wc0 = warp % kColWarps * cpw, wcols = min(cpw, p.klat - wc0);
  const int lat_steps = p.klat / 16, all_steps = kd / 16;
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

  for (int j = 0; j < nst; ++j) {
    const int slot = j % RING, tb = s0 + j * TK;
    tc::cp_async_wait<RING - 2>();
    __syncthreads();   // stage j has landed; every warp is done with stage j - 1
    if (j + RING - 1 < nst) load_stage(j + RING - 1, (j + RING - 1) % RING);
    tc::cp_async_commit();
    // The page rows of stage j + RING, into stage j's free slot at the end
    // of the stage (the table read in flight meanwhile).
    const bool next_rows = tid < TK && j + RING < nst;
    const long long next_row = next_rows ? page_row(tb + RING * TK + tid) : -1;
    const bf16* kt = k_s + slot * TK * ldk;
    if constexpr (kQuant) {   // widen the stage's codes into the bf16 tile (exact)
      for (int i = tid; i < TK * (kd / 16); i += kThr) {
        const int r = i / (kd / 16), cc = i % (kd / 16) * 16;
        uint4 lo, hi;
        tc::widen16(*reinterpret_cast<const uint4*>(c_s + (slot * TK + r) * kd + cc), TP(), lo,
                    hi);
        *reinterpret_cast<uint4*>(k_s + r * ldk + cc) = lo;
        *reinterpret_cast<uint4*>(k_s + r * ldk + cc + 8) = hi;
      }
      kt = k_s;
    } else if (j == 0) {   // Q = bf16(q x scale), once
      for (int i = tid; i < TM * qpr; i += kThr) {
        const int r = i / qpr, c = i % qpr * 8;
        uint4 raw = *reinterpret_cast<const uint4*>(q_s + r * ldk + c);
        uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
          w[e] = tc::pack_bf16(f.x * p.scale, f.y * p.scale);
        }
        *reinterpret_cast<uint4*>(q_s + r * ldk + c) = raw;
      }
    }
    if (kQuant || j == 0) __syncthreads();

    // Scores of this warp's 16 x SN tile over its k-steps (quantized pools:
    // the latent and k_pe parts apart).
    {
      float sa[NF][4] = {}, sp[NF][4] = {};
      auto step = [&](int kk, float(&c)[NF][4]) {
        uint32_t a[4];
        tc::ldmatrix_x4(a, q_s + tc::a_off(lane, sm, kk * 16, ldk));
#pragma unroll
        for (int n = 0; n < NF; n += 2) {
          uint32_t bk[4];
          tc::ldmatrix_x4(bk, kt + tc::b_off(lane, sn + n * 8, kk * 16, ldk));
          tc::mma_bf16(c[n], a, bk[0], bk[1]);
          tc::mma_bf16(c[n + 1], a, bk[2], bk[3]);
        }
      };
      int kk = kg;
#pragma unroll 2
      for (; kk < (kQuant ? lat_steps : all_steps); kk += KS) step(kk, sa);
      for (; kk < all_steps; kk += KS) step(kk, sp);
      float* so = s_s + kg * TM * LDS;
      const float* scl = sc_s + slot * 2 * TK;
#pragma unroll
      for (int nt = 0; nt < NF; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = sm + g + 8 * i, col = sn + nt * 8 + 2 * t4;
          float v0 = sa[nt][2 * i], v1 = sa[nt][2 * i + 1];
          if constexpr (kQuant) {
            v0 = (v0 * scl[col] + sp[nt][2 * i] * scl[TK + col]) * p.scale;
            v1 = (v1 * scl[col + 1] + sp[nt][2 * i + 1] * scl[TK + col + 1]) * p.scale;
          }
          *reinterpret_cast<float2*>(so + row * LDS + col) = make_float2(v0, v1);
        }
    }
    __syncthreads();

    // Masks and the online softmax, LPR lanes a row (warps past the rows
    // wait); P (x the token's latent row scale on quantized pools) goes to
    // shared memory as kPTerms bf16 terms.
    if (sr < TM) {
      const int lim = min(s1, q_start + (r0 + sr) / p.nq + 1);
      float x[TPL];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < TPL; c += 4) {
        float4 v = *reinterpret_cast<const float4*>(s_s + sr * LDS + sc0 + c);
#pragma unroll
        for (int k = 1; k < KS; ++k) {
          const float4 w = *reinterpret_cast<const float4*>(s_s + (k * TM + sr) * LDS + sc0 + c);
          v.x += w.x;
          v.y += w.y;
          v.z += w.z;
          v.w += w.w;
        }
        const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[c + e] = tb + sc0 + c + e < lim ? vv[e] : kNegInf;
          mx = fmaxf(mx, x[c + e]);
        }
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[sr], m_new = fmaxf(m_prev, mx);
      const float ms2 = fmaxf(m_new, kNegInf / 2) * kLog2e;   // m_safe, in log2 units
      const float* scl = sc_s + slot * 2 * TK;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < TPL; c += 4) {
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = sc0 + c + e;
          const float pr = tb + col < lim ? tc::exp2_approx(fmaf(x[c + e], kLog2e, -ms2)) : 0.f;
          sum += pr;
          w[e] = kQuant ? pr * scl[col] : pr;
        }
#pragma unroll
        for (int t = 0; t < kPTerms; ++t) {
          float h[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            h[e] = tc::round_bf16(w[e]);
            w[e] -= h[e];
          }
          *reinterpret_cast<uint2*>(pt_s + (t * TM + sr) * LDP + sc0 + c) =
              make_uint2(tc::pack_bf16(h[0], h[1]), tc::pack_bf16(h[2], h[3]));
        }
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane % LPR == 0) {
        const float corr =
            m_prev <= kNegInf / 2 ? 0.f : tc::exp2_approx(fminf(m_prev - m_new, 0.f) * kLog2e);
        l_s[sr] = l_s[sr] * corr + sum;
        m_s[sr] = m_new;
        corr_s[sr] = corr;
      }
    }
    __syncthreads();

    // acc = acc x corr + P . latent (P's terms smallest first).
    float cr[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) cr[mt][i] = corr_s[wr + mt * 16 + g + 8 * i];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[mt][n][0] *= cr[mt][0];
        acc[mt][n][1] *= cr[mt][0];
        acc[mt][n][2] *= cr[mt][1];
        acc[mt][n][3] *= cr[mt][1];
      }
    if (wcols > 0) {
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        if (tb + kk * 16 >= s1) break;   // P is 0 from here on
        uint32_t bl[NP][4];
#pragma unroll
        for (int np = 0; np < NP; ++np)
          if (np * 16 < wcols)
            tc::ldmatrix_x4_trans(bl[np], kt + tc::bt_off(lane, kk * 16, wc0 + np * 16, ldk));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[kPTerms][4];
#pragma unroll
          for (int t = 0; t < kPTerms; ++t)
            tc::ldmatrix_x4(a[t], pt_s + t * TM * LDP + tc::a_off(lane, wr + mt * 16, kk * 16, LDP));
#pragma unroll
          for (int t = kPTerms - 1; t >= 0; --t)
#pragma unroll
            for (int np = 0; np < NP; ++np)
              if (np * 16 < wcols) {
                tc::mma_bf16(acc[mt][2 * np], a[t], bl[np][0], bl[np][1]);
                tc::mma_bf16(acc[mt][2 * np + 1], a[t], bl[np][2], bl[np][3]);
              }
        }
      }
    }
    if (next_rows) row_s[slot * TK + tid] = next_row;
  }

  // This split's unnormalised acc and (m, l) a row.
  const size_t unit = ((size_t)split * p.batch + b) * p.rows + r0;
  if (wcols > 0) {
    float* wa = p.ws + unit * p.klat;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wr + mt * 16 + g + 8 * i;
        if (r0 + row >= p.rows) continue;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          if (n * 8 < wcols)
            *reinterpret_cast<float2*>(wa + (size_t)row * p.klat + wc0 + n * 8 + 2 * t4) =
                make_float2(acc[mt][n][2 * i], acc[mt][n][2 * i + 1]);
      }
  }
  float* ml = p.ws + (size_t)p.splits * p.batch * p.rows * p.klat + unit * 2;
  for (int r = tid; r < TM; r += kThr)
    if (r0 + r < p.rows) *reinterpret_cast<float2*>(ml + 2 * r) = make_float2(m_s[r], l_s[r]);
}

// ---------------------------------------------------------------------------
// The combine-and-expand kernel.

constexpr int kCombThreads = 256;   // 8 warps
constexpr int kCombWarps = kCombThreads / 32;
constexpr int kCombRows = 16;       // rows of head h a block (slots x positions)
constexpr int kCombK = 4;           // blocks splitting klat (k-quarters)
constexpr int kCombCols = 128;      // value columns a block
constexpr int kLdW = kCombCols + 8;   // bf16 row stride of the w_v rows
static_assert(kCombRows * kMaxSplits == kCombThreads, "a thread a (row, split)");
static_assert(kCombCols == kCombWarps * 16, "a warp 16 value columns");

// Latent columns of k-quarter q: whole k-steps [q KT / 4, (q + 1) KT / 4).
__host__ __device__ inline int comb_k0(int klat, int q) { return klat / 16 * q / kCombK * 16; }

size_t combine_smem(int klat) {
  const int nc = comb_k0(klat, kCombK) - comb_k0(klat, kCombK - 1);   // the widest quarter
  return (size_t)nc * kLdW * sizeof(bf16) + (size_t)kUTerms * kCombRows * (nc + 8) * sizeof(bf16);
}

// grid (nq x kCombK, value tiles, head-row tiles), kCombThreads threads;
// launched as a programmatic dependent of the split kernel. A thread keeps
// POS float4s of partials in flight at once: 2 where the grid is one wave
// (one block an SM), else 1 (two blocks an SM, 128 registers). Block (h, q)
// gathers u's latent columns of k-quarter q and expands them through w_v's
// matching rows into a partial [kCombRows, kCombCols] of the tile (fp32,
// to the workspace); the last of the unit's kCombK blocks to finish (a
// counter, reset by it) adds the partials in quarter order and writes the
// tile.
template <int POS>
__global__ void __launch_bounds__(kCombThreads, 3 - POS) paged_latent_combine_kernel(const Params p) {
  const int h = blockIdx.x / kCombK, q = blockIdx.x % kCombK;
  const int d0 = blockIdx.y * kCombCols, h0 = blockIdx.z * kCombRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int s_q = p.rows / p.nq, rn = p.batch * s_q;   // head h's rows: (slot, position)
  const int c0 = comb_k0(p.klat, q), nc = comb_k0(p.klat, q + 1) - c0, ldt = nc + 8;
  const int unit = (h * gridDim.z + blockIdx.z) * gridDim.y + blockIdx.y;
  __shared__ int row_s[kCombRows], live_s[kCombRows], last_s;
  __shared__ float wt_s[kCombRows][kMaxSplits], lw_s[kCombRows][kMaxSplits], den_s[kCombRows];
  extern __shared__ uint4 smem_raw[];
  bf16* w_s = reinterpret_cast<bf16*>(smem_raw);   // [nc][kLdW]
  bf16* ut_s = w_s + (size_t)nc * kLdW;            // [kUTerms][kCombRows][ldt]

  // w_v[c0 : c0 + nc, h, d0 : d0 + 128], zeros past dv (an input: no wait
  // for the split kernel).
  const bf16* wh = p.w_v + (long long)c0 * p.w_sk + h * p.w_sh + d0;
  if (p.w_vec) {
    for (int i = tid; i < nc * (kCombCols / 8); i += kCombThreads) {
      const int k = i / (kCombCols / 8), c = i % (kCombCols / 8) * 8;
      const bool live = d0 + c < p.dv;
      tc::cp_async_16(w_s + k * kLdW + c, live ? wh + k * p.w_sk + c : p.w_v, live);
    }
  } else {
    for (int i = tid; i < nc * kCombCols; i += kCombThreads) {
      const int k = i / kCombCols, c = i % kCombCols;
      w_s[k * kLdW + c] = d0 + c < p.dv ? wh[k * p.w_sk + c] : __float2bfloat16(0.f);
    }
  }
  tc::cp_async_commit();
  if (tid < kCombRows) {
    const int hr = h0 + tid;
    int row = -1, live = 0;
    if (hr < rn) {
      const int bb = hr / s_q, s = hr % s_q;
      row = bb * p.rows + s * p.nq + h;
      live = min(p.splits, (visible_end(p, bb, s) + p.split_tokens - 1) / p.split_tokens);
    }
    row_s[tid] = row;
    live_s[tid] = live;
  }
  __syncthreads();
  tc::pdl_wait();   // the split kernel's partials are complete and visible

  // The partials of this thread's first POS float4s of u's columns [c0,
  // c0 + nc), every live split, loaded at once beside the splits' (m, l):
  // one round trip.
  constexpr int kPos = POS;
  const size_t sstride = (size_t)p.batch * p.rows * p.klat;
  const int c4 = nc / 4, npos = kCombRows * c4;
  auto load = [&](int i, float4(&x)[kMaxSplits]) {
    const int r = i / c4, live = live_s[r];
    const float* src = p.ws + (size_t)max(row_s[r], 0) * p.klat + c0 + i % c4 * 4;
#pragma unroll
    for (int k = 0; k < kMaxSplits; ++k)
      if (k < live) x[k] = __ldcg(reinterpret_cast<const float4*>(src + k * sstride));
  };
  float4 x[kPos][kMaxSplits];
#pragma unroll
  for (int e = 0; e < kPos; ++e)
    if (tid + e * kCombThreads < npos) load(tid + e * kCombThreads, x[e]);

  // The splits' weights e^{m_i - m}, m the largest m_i of a live split
  // with l_i > 0 (thread: row tid / 16, split tid % 16; a half-warp a row).
  {
    const int r = tid / kMaxSplits, k = tid % kMaxSplits;
    float m = kNegInf, l = 0.f;
    if (k < live_s[r]) {
      const float* ml = p.ws + (size_t)p.splits * p.batch * p.rows * p.klat;
      const float2 v = __ldcg(reinterpret_cast<const float2*>(
          ml + ((size_t)k * p.batch * p.rows + row_s[r]) * 2));
      if (v.y > 0.f) {
        m = v.x;
        l = v.y;
      }
    }
    float mall = m;
#pragma unroll
    for (int o = kMaxSplits / 2; o > 0; o >>= 1)
      mall = fmaxf(mall, __shfl_xor_sync(0xffffffffu, mall, o));
    const float w = l > 0.f ? tc::exp2_approx((m - mall) * kLog2e) : 0.f;
    wt_s[r][k] = w;
    lw_s[r][k] = l * w;
  }
  __syncthreads();
  if (tid < kCombRows) {
    float l = 0.f;
    for (int k = 0; k < live_s[tid]; ++k) l += lw_s[tid][k];
    den_s[tid] = fmaxf(l, 1e-20f);
  }
  __syncthreads();

  // u: each row's live splits weighed and added in split order, / max(l,
  // 1e-20), stored as kUTerms bf16 terms (rows past head h's last one:
  // zeros).
  auto finish = [&](int i, const float4(&x)[kMaxSplits]) {
    const int r = i / c4, c = i % c4 * 4, live = live_s[r];
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kMaxSplits; ++k) {
      if (k >= live) break;
      const float w = wt_s[r][k];
      v.x = fmaf(x[k].x, w, v.x);
      v.y = fmaf(x[k].y, w, v.y);
      v.z = fmaf(x[k].z, w, v.z);
      v.w = fmaf(x[k].w, w, v.w);
    }
    const float d = den_s[r];
    float u[4] = {v.x / d, v.y / d, v.z / d, v.w / d};
#pragma unroll
    for (int t = 0; t < kUTerms; ++t) {
      float hh[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        hh[j] = tc::round_bf16(u[j]);
        u[j] -= hh[j];
      }
      *reinterpret_cast<uint2*>(ut_s + (t * kCombRows + r) * ldt + c) =
          make_uint2(tc::pack_bf16(hh[0], hh[1]), tc::pack_bf16(hh[2], hh[3]));
    }
  };
#pragma unroll
  for (int e = 0; e < kPos; ++e)
    if (tid + e * kCombThreads < npos) finish(tid + e * kCombThreads, x[e]);
  for (int i = tid + kPos * kCombThreads; i < npos; i += kCombThreads) {
    load(i, x[0]);
    finish(i, x[0]);
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // This quarter's partial tile = u[:, c0 : c0 + nc] . w_v rows, warp w
  // taking value columns [16 w, 16 w + 16).
  float acc[2][4] = {};
  for (int kk = 0; kk < nc / 16; ++kk) {
    uint32_t a[kUTerms][4], bw[4];
#pragma unroll
    for (int t = 0; t < kUTerms; ++t)
      tc::ldmatrix_x4(a[t], ut_s + t * kCombRows * ldt + tc::a_off(lane, 0, kk * 16, ldt));
    tc::ldmatrix_x4_trans(bw, w_s + tc::bt_off(lane, kk * 16, warp * 16, kLdW));
#pragma unroll
    for (int t = kUTerms - 1; t >= 0; --t) {
      tc::mma_bf16(acc[0], a[t], bw[0], bw[1]);
      tc::mma_bf16(acc[1], a[t], bw[2], bw[3]);
    }
  }
  float* part = p.ws + p.part_off + (size_t)unit * kCombK * kCombRows * kCombCols;
  float* mine = part + (size_t)q * kCombRows * kCombCols;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = warp * 16 + j * 8 + 2 * t4;
    __stcg(reinterpret_cast<float2*>(mine + g * kCombCols + col), make_float2(acc[j][0], acc[j][1]));
    __stcg(reinterpret_cast<float2*>(mine + (g + 8) * kCombCols + col),
           make_float2(acc[j][2], acc[j][3]));
  }
  __threadfence();   // the partial is visible before the count says so
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(p.counters + unit, 1);
    last_s = done == kCombK - 1;
    if (last_s) p.counters[unit] = 0;   // ready for the next call
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // The last block: the quarters' partials added in quarter order.
  for (int i = tid; i < kCombRows * kCombCols / 4; i += kCombThreads) {
    const int r = i / (kCombCols / 4), c = i % (kCombCols / 4) * 4, row = row_s[r];
    float4 v = __ldcg(reinterpret_cast<const float4*>(part + r * kCombCols + c));
#pragma unroll
    for (int k = 1; k < kCombK; ++k) {
      const float4 x = __ldcg(
          reinterpret_cast<const float4*>(part + ((size_t)k * kCombRows + r) * kCombCols + c));
      v.x += x.x;
      v.y += x.y;
      v.z += x.z;
      v.w += x.w;
    }
    if (row < 0) continue;
    const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (d0 + c + j < p.dv) p.out[(size_t)row * p.dv + d0 + c + j] = __float2bfloat16(vv[j]);
  }
}

// ---------------------------------------------------------------------------
// Launchers.

constexpr size_t kMaxSmem = 232448;   // bytes a block may take on sm_90

template <int I, typename TP>
int launch_split(const Params& p, cudaStream_t st) {
  constexpr Tile t = kTiles[I];
  auto kernel = paged_latent_split_kernel<t.rows, t.tokens, t.warps, t.warp_cols, t.ring, TP>;
  const size_t smem = split_smem<t.rows, t.tokens, t.warps, t.ring, TP>(p.klat + p.dpe);
  if (smem > kMaxSmem || p.klat > t.warp_cols * kColWarps ||
      p.split_tokens % t.tokens)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((long long)p.rows + t.rows - 1) / t.rows;
  if (tiles > 65535 || p.batch > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<dim3(p.splits, (unsigned)tiles, p.batch), t.warps * 32, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename TP>
int launch_kind(const Params& p, int row_tile, cudaStream_t st) {
  int err = (int)cudaErrorInvalidValue;
  if (row_tile == kTiles[2].rows)
    err = launch_split<2, TP>(p, st);
  else if (row_tile == kTiles[0].rows)
    err = p.klat <= kTiles[0].warp_cols * kColWarps ? launch_split<0, TP>(p, st)
                                                     : launch_split<1, TP>(p, st);
  if (err != 0) return err;
  const long long z = ((long long)p.batch * (p.rows / p.nq) + kCombRows - 1) / kCombRows;
  if (z > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(p.nq * kCombK, (p.dv + kCombCols - 1) / kCombCols, (unsigned)z);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  auto kernel = (long long)grid.x * grid.y * grid.z <= sms ? paged_latent_combine_kernel<2>
                                                             : paged_latent_combine_kernel<1>;
  const size_t smem = combine_smem(p.klat);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  return (int)tc::launch_pdl(kernel, grid, dim3(kCombThreads), smem, st, p);
}

}  // namespace

// q_lat [batch, s_q, nq, klat] and q_pe [batch, s_q, nq, dpe] bf16 (decode:
// s_q == 1 and q_lens == nullptr); pools [NB, bs, klat] and [NB, bs, dpe] of
// page_kind 0 (bf16), 1 (int8) or 2 (fp8 e4m3); lat_scales / pe_scales [NB,
// bs] fp32 for page kinds 1 and 2; page_table [batch, mb] int32; kv_lens /
// q_lens [batch] int32; w_v bf16 element (k, h, d) at k * w_stride_k + h *
// w_stride_h + d; out [batch, s_q, nq, dv] bf16. The split plan: row_tile
// rows a split block (32 or 64), split_tokens tokens a split (whole ring
// stages), splits (at most kMaxSplits) covering max_blocks * block_size;
// workspace: splits * batch * s_q * nq * (klat + 2) fp32, then the
// combine's partials, units * kCombK * kCombRows * kCombCols fp32; counters:
// units int32, zero (the combine leaves them zero); units = nq *
// ceil(batch * s_q / kCombRows) * ceil(dv / kCombCols). Two launches, the
// second a programmatic dependent of the first. Returns a cudaError_t code
// (0 = launched).
extern "C" int paged_latent_launch(
    const void* q_lat, const void* q_pe, const void* lat_pages,
    const void* pe_pages, const void* lat_scales, const void* pe_scales,
    const void* page_table, const void* kv_lens, const void* q_lens,
    const void* w_v, void* out, void* workspace, void* counters, int batch,
    int s_q, int nq, int klat, int dpe, int dv, int block_size, int max_blocks,
    long long w_stride_k, long long w_stride_h, int page_kind, float scale,
    int row_tile, int split_tokens, int splits, void* stream) {
  const long long table_tokens = (long long)block_size * max_blocks;
  if (batch < 1 || s_q < 1 || nq < 1 || klat < 16 || klat % 16 || dpe < 16 ||
      dpe % 16 || klat + dpe > kMaxWidth || dv < 1 || block_size < 1 ||
      max_blocks < 1 || page_kind < 0 || page_kind > 2 ||
      (page_kind > 0 && (lat_scales == nullptr || pe_scales == nullptr)) ||
      workspace == nullptr || counters == nullptr || splits < 1 || splits > kMaxSplits ||
      split_tokens < 1 ||
      (long long)splits * split_tokens < table_tokens ||
      (long long)(splits - 1) * split_tokens >= table_tokens ||
      (long long)s_q * nq > 0x7fffffff / 2)
    return (int)cudaErrorInvalidValue;
  const int w_vec = dv % 8 == 0 && w_stride_k % 8 == 0 && w_stride_h % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(w_v) % 16 == 0;
  Params p = {static_cast<const bf16*>(q_lat), static_cast<const bf16*>(q_pe),
              lat_pages, pe_pages,
              static_cast<const float*>(lat_scales), static_cast<const float*>(pe_scales),
              static_cast<const int*>(page_table), static_cast<const int*>(kv_lens),
              static_cast<const int*>(q_lens), static_cast<const bf16*>(w_v),
              static_cast<bf16*>(out), static_cast<float*>(workspace),
              static_cast<int*>(counters), (size_t)splits * batch * s_q * nq * (klat + 2),
              batch, nq, s_q * nq, klat, dpe, dv, block_size, max_blocks, split_tokens, splits,
              w_vec, w_stride_k, w_stride_h, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (page_kind == 0) return launch_kind<bf16>(p, row_tile, st);
  if (page_kind == 1) return launch_kind<int8_t>(p, row_tile, st);
  return launch_kind<fp8>(p, row_tile, st);
}
