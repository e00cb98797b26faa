// The fused MLA prologue for Hopper (sm_90a): two launches that together
// compute what one no-grid TPU kernel computes.
//
// Replaces megatronapp_tpu/ops/pallas/kernel_gen.py _fused_mla_qkv (def
// :1393, pallas_call :1495). For R rows of the residual stream (decode
// slots, or B*S flattened chunk rows) it computes, in the JAX body's
// rounding points (kernel_gen.py:1468-1493):
//   xn     = bf16(norm(x))                       (RMSNorm or LayerNorm)
//   q      = bf16(xn @ q_proj)  or  bf16(bf16(rms(bf16(xn @ q_down))) @ q_up)
//   q_pe   = bf16(rope(q[:, h, dqk:]))           (half rotation in fp32)
//   q_lat  = bf16(bf16(q[:, h, :dqk] * m2) @ kv_up[:, h, :dqk]^T)  (absorbed)
//   kv     = bf16(xn @ kv_down)
//   latent = bf16(rms(kv[:, :klat]) * kv_ln_scale)
//   k_pe   = bf16(rope(kv[:, klat:]))
// with m2 YaRN's mscale squared (1 without YaRN).
//
// Design. At 8 rows the prologue reads ~59 MB of weights a layer (q_proj
// 25.2 M, kv_down 2.4 M and kv_up's k_nope half 2.1 M bf16 values): bound
// by those bytes (~17.7 us at 3.35 TB/s); at 32 rows its 1.9 GFLOP of
// products would take ~30 us as fp32 FMAs on the CUDA cores, so they run
// on the tensor cores (mma.sync m16n8k16, bf16 operands, fp32
// accumulators, tensor_core.cuh). The JAX body takes bf16 operands into
// every product and accumulates in fp32 (kernel_gen.py:1468-1493), so the
// tensor cores keep its rounding points exactly; only the order of the
// sums differs. No block of one CUDA kernel can wait for another, and
// three things couple columns across blocks: the rms over all klat latent
// columns, the rope pairs inside each head's dpe q_pe columns, and the
// absorption, which needs a head's whole dqk q_nope values. So the work
// splits in two launches:
// - mla_down: one block a 64-column tile of [q_proj | kv_down] (or
//   [q_down | kv_down] on the q_lora path): 32 x 3 + 9 = 105 blocks at
//   llama3-8b widths; a q_pe tile and the k_pe tile are whole 64-column
//   tiles, since the rope pairs columns c and c + dpe / 2. Each block
//   starts its first stages' copies, computes its rows' norm statistics
//   while they land, then walks k in stages of kKc = 128: a cp.async
//   ring of kStages stages holds the weight slab's rows (k-major, read with
//   ldmatrix .trans), the raw rows of x and the norm's scale and bias
//   over the stage's k's, so that kStages - 1 stages (48 KB of weights)
//   are in flight; each landed stage of x becomes bf16(norm(x)) in a tile
//   of 16-row A fragments (8 rows fill one tile, 32 rows two). Warp w
//   takes the k16 steps w % 4, w % 4 + 4, ... of each stage and half the
//   tile's columns; the four k groups' fp32 sums add in a fixed order at
//   the end (reruns repeat every bit). Every block normalises all of x,
//   so fewer, wider tiles cost less than more blocks: 32-column tiles
//   (177 blocks) and 64-k stages ran slower (flash_probe.py
//   prologue-variants, PERF.md). q_pe and k_pe rope in their tiles;
//   q_nope tiles, the pre-norm latent (and q_down's output) go to a bf16
//   workspace.
// - mla_up: on the q_proj path one block a (head, 64 latent columns):
//   256 blocks absorb bf16(q_nope * m2) [rows, dqk] through the head's
//   kv_up k_nope rows [64, dqk] (both gathered whole with cp.async) on
//   mma.sync. On the q_lora path one block a head first forms the head's
//   dqk + dpe columns of q = rms(q0) @ q_up with mla_down's tile product
//   (roping its q_pe tile), then absorbs its q_nope through all klat
//   latent columns, 64 at a time (a third launch would let more blocks
//   share the q_up product; the q_lora path is not the main path). R more
//   blocks normalise one latent row each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Columns of a q_nope / latent tile and of a rope tile (q_pe, k_pe: whole,
// for the rope's pairs). Equal; kept apart so that flash_probe.py
// prologue-variants can build narrower q_nope / latent tiles.
constexpr int kNarrow = 64;
constexpr int kWide = 64;
constexpr int kKc = 128;                  // k's a ring stage
constexpr int kStages = 4;                // ring stages (kStages - 1 in flight)
constexpr int kWld = kWide + 8;           // ring row stride (bf16): 16-byte pad
constexpr int kAld = kKc + 8;             // A tile row stride
constexpr int kAbs = 64;                  // latent columns an absorption pass
enum Norm { kNormRms = 1, kNormLayer = 2 };

using tc::round_bf16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Norm statistics of rows [0, rows) of a bf16 [rows, k] matrix (row
// stride ld, both multiples of 8), one warp a row, 16-byte loads: mean
// (LayerNorm only) and 1 / sqrt(mean((x - mean)^2) + eps), as
// ops/normalization.py computes them.
__device__ void row_stats(const bf16* x, int ld, int k, int rows, int norm,
                          float eps, float* mean_s, float* rstd_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    const bf16* xr = x + (size_t)r * ld;
    float mean = 0.f;
    if (norm == kNormLayer) {
      float s = 0.f;
#pragma unroll 8
      for (int c = lane * 8; c < k; c += 32 * 8) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(xr + c));
        const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += __bfloat162float(v[e]);
      }
      mean = warp_sum(s) / (float)k;
    }
    float ss = 0.f;
#pragma unroll 8
    for (int c = lane * 8; c < k; c += 32 * 8) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(xr + c));
      const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = __fsub_rn(__bfloat162float(v[e]), mean);
        ss = __fadd_rn(ss, __fmul_rn(d, d));
      }
    }
    ss = warp_sum(ss);
    if (lane == 0) {
      mean_s[r] = mean;
      rstd_s[r] = 1.f / sqrtf(ss / (float)k + eps);
    }
  }
}

// bf16(norm(v)) of one element: ((v - mean) * rstd) * scale.
__device__ __forceinline__ float normed(float v, float mean, float rstd, float scale) {
  return round_bf16(__fmul_rn(__fmul_rn(__fsub_rn(v, mean), rstd), scale));
}

// The A operand of a tile product: rows [0, rows) of a bf16 [rows, k]
// matrix (row stride ld), normalised with per-row statistics and a scale
// (and bias) vector over k.
struct NormSrc {
  const bf16* x;
  int ld, k, rows;
  const float* mean_s;
  const float* rstd_s;
  const bf16* scale;
  const bf16* bias;
};

// Shared memory of tile_gemm: the weight ring, the x ring, the ring of
// the norm's scale and bias vectors, the A tile.
template <int ROWS>
__host__ __device__ constexpr size_t gemm_smem() {
  return ((size_t)kStages * kKc * kWld + (size_t)kStages * (ROWS + 2) * kKc +
          (size_t)16 * ((ROWS + 15) / 16) * kAld) * sizeof(bf16);
}

// out_s[r][c] (fp32 [ROWS][W]) = sum_k bf16(norm(A))[r][k] w[k][c] over a
// W-column slab of a k-major weight (w: its first column, row stride ldw;
// A.k rows), on mma.sync. The k's go through the ring kKc at a time; warp
// (kg, nh) = (w % 4, w / 4) sums the k16 steps kg, kg + 4, ... of each
// stage over the slab's columns [nh W / 2, (nh + 1) W / 2); the four kg
// partials add in order. prep() runs once the first stages are in flight
// (it writes A's statistics). smem: gemm_smem<ROWS>() bytes, whose first
// 4 x 16 MT x W floats hold the partials at the end; out_s must lie past
// them.
template <int ROWS, int W, typename Prep>
__device__ void tile_gemm(const bf16* __restrict__ w, long long ldw, const NormSrc& A,
                          bf16* smem, float* out_s, Prep prep) {
  constexpr int MT = (ROWS + 15) / 16;   // 16-row A tiles
  constexpr int WN = W / 2, NB = WN / 8;  // a warp's columns, its n8 blocks
  constexpr int WP = W / 8;              // 16-byte pieces of a weight row
  static_assert(NB % 2 == 0, "ldmatrix .x4 gives two n8 blocks");
  bf16* w_ring = smem;                                  // [kStages][kKc][kWld]
  bf16* x_ring = w_ring + kStages * kKc * kWld;         // [kStages][ROWS][kKc]
  bf16* v_ring = x_ring + kStages * ROWS * kKc;         // [kStages][scale, bias][kKc]
  bf16* a_s = v_ring + kStages * 2 * kKc;               // [16 MT][kAld]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kg = warp & 3, nh = warp >> 2;
  const int chunks = (A.k + kKc - 1) / kKc;

  auto load = [&](int c) {
    const int st = c % kStages, k0 = c * kKc;
    for (int i = tid; i < kKc * WP; i += kThreads) {
      const int r = i / WP, c8 = (i % WP) * 8, k = k0 + r;
      const bool live = k < A.k;
      tc::cp_async_16(w_ring + (st * kKc + r) * kWld + c8,
                      w + (live ? (long long)k * ldw + c8 : 0), live);
    }
    for (int i = tid; i < ROWS * (kKc / 8); i += kThreads) {
      const int r = i / (kKc / 8), c8 = (i % (kKc / 8)) * 8, k = k0 + c8;
      const bool live = r < A.rows && k < A.k;   // A.k is a multiple of 8
      tc::cp_async_16(x_ring + (st * ROWS + r) * kKc + c8,
                      A.x + (live ? (size_t)r * A.ld + k : 0), live);
    }
    // The norm's scale (and bias) over the stage's k's: read here, ahead,
    // and not from device memory in the normalisation below, whose loads
    // would wait on the L2 behind the weights' stream every stage.
    if (tid < 2 * (kKc / 8)) {
      const int v = tid / (kKc / 8), c8 = (tid % (kKc / 8)) * 8, k = k0 + c8;
      const bf16* src = v == 0 ? A.scale : A.bias;
      const bool live = src != nullptr && k < A.k;
      tc::cp_async_16(v_ring + (st * 2 + v) * kKc + c8, live ? src + k : A.scale, live);
    }
  };
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) load(c);
    tc::cp_async_commit();   // empty groups keep the count uniform
  }
  prep();   // A's norm statistics, while the first stages load

  float acc[MT][NB][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    const int st = c % kStages, k0 = c * kKc;
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();   // stage c has landed; every warp is done with stage c - 1
    if (c + kStages - 1 < chunks) load(c + kStages - 1);
    tc::cp_async_commit();
    // bf16(norm(x)) of this stage into the A tile (rows past `rows` zero):
    // ((x - mean) * rstd) * scale (+ bias) in fp32, rounded once, two at a
    // time (A.k is a multiple of 8: a 16-byte piece is live or not).
    const bf16* vs = v_ring + st * 2 * kKc;
    for (int i = tid; i < 16 * MT * (kKc / 8); i += kThreads) {
      const int r = i / (kKc / 8), c8 = (i % (kKc / 8)) * 8;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (r < A.rows && k0 + c8 < A.k) {
        const uint4 raw = *reinterpret_cast<const uint4*>(x_ring + (st * ROWS + r) * kKc + c8);
        const uint4 scr = *reinterpret_cast<const uint4*>(vs + c8);
        const uint4 bir = *reinterpret_cast<const uint4*>(vs + kKc + c8);
        const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const __nv_bfloat162* sv = reinterpret_cast<const __nv_bfloat162*>(&scr);
        const __nv_bfloat162* bv = reinterpret_cast<const __nv_bfloat162*>(&bir);
        uint32_t* o = reinterpret_cast<uint32_t*>(&out);
        const float mean = A.mean_s[r], rstd = A.rstd_s[r];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(xv[e]), sc = __bfloat1622float2(sv[e]);
          float y0 = __fmul_rn(__fmul_rn(__fsub_rn(f.x, mean), rstd), sc.x);
          float y1 = __fmul_rn(__fmul_rn(__fsub_rn(f.y, mean), rstd), sc.y);
          if (A.bias != nullptr) {
            const float2 bi = __bfloat1622float2(bv[e]);
            y0 = __fadd_rn(y0, bi.x);
            y1 = __fadd_rn(y1, bi.y);
          }
          o[e] = tc::pack_bf16(y0, y1);
        }
      }
      *reinterpret_cast<uint4*>(a_s + r * kAld + c8) = out;
    }
    __syncthreads();
    const bf16* ws = w_ring + st * kKc * kWld;
#pragma unroll
    for (int kk = 16 * kg; kk < kKc; kk += 64) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) tc::ldmatrix_x4(af[mt], a_s + tc::a_off(lane, 16 * mt, kk, kAld));
#pragma unroll
      for (int j = 0; j < NB; j += 2) {
        uint32_t bf[4];
        tc::ldmatrix_x4_trans(bf, ws + tc::bt_off(lane, kk, nh * WN + 8 * j, kWld));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          tc::mma_bf16(acc[mt][j], af[mt], bf[0], bf[1]);
          tc::mma_bf16(acc[mt][j + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  // The four k groups' partials, then their sum in order.
  float* red = reinterpret_cast<float*>(smem);   // [4][16 MT][W] (inside the ring)
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int col = nh * WN + 8 * j + 2 * t;
      float* r0 = red + (kg * 16 * MT + 16 * mt + g) * W + col;
      *reinterpret_cast<float2*>(r0) = make_float2(acc[mt][j][0], acc[mt][j][1]);
      *reinterpret_cast<float2*>(r0 + 8 * W) = make_float2(acc[mt][j][2], acc[mt][j][3]);
    }
  __syncthreads();
  for (int i = tid; i < ROWS * W; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) s += red[q * 16 * MT * W + i];
    out_s[i] = s;
  }
  __syncthreads();
}

// Writes a finished W-column tile (fp32 sums out_s [ROWS][W]) rounded to
// bf16, roped first when `rope` (columns c < half pair with c + half;
// columns past 2 half pass through): dst[r * ld + c].
template <int W>
__device__ void write_tile(const float* out_s, int rows, bool rope,
                           const float* cos, const float* sin, int half,
                           bf16* dst, long long ld) {
  for (int i = threadIdx.x; i < rows * W; i += kThreads) {
    const int r = i / W, c = i % W;
    float v = round_bf16(out_s[r * W + c]);
    if (rope && c < 2 * half) {
      const int j = c < half ? c : c - half;
      const float cs = cos[(size_t)r * half + j], sn = sin[(size_t)r * half + j];
      const float x1 = round_bf16(out_s[r * W + j]);
      const float x2 = round_bf16(out_s[r * W + j + half]);
      v = c < half ? __fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn))
                   : __fadd_rn(__fmul_rn(x2, cs), __fmul_rn(x1, sn));
    }
    dst[(size_t)r * ld + c] = __float2bfloat16(v);
  }
}

struct MlaArgs {
  const bf16* x;            // [rows, hidden]
  const bf16* ln_scale;     // [hidden]
  const bf16* ln_bias;      // [hidden] or null
  const bf16* q_proj;       // [hidden, nq * (dqk + dpe)] or null
  const bf16* q_down;       // [hidden, qlr] or null
  const bf16* q_ln_scale;   // [qlr]
  const bf16* q_up;         // [qlr, nq * (dqk + dpe)]
  const bf16* kv_down;      // [hidden, klat + dpe]
  const bf16* kv_ln_scale;  // [klat]
  const bf16* kv_up;        // [klat, nq * (dqk + dv)]
  const float* cos;         // [rows, half] or null
  const float* sin;
  bf16* q_lat;              // [rows, nq, klat]
  bf16* q_pe;               // [rows, nq, dpe]
  bf16* latent;             // [rows, klat]
  bf16* k_pe;               // [rows, dpe]
  bf16* ws_q;               // q_proj: q_nope [rows, nq, dqk]; q_lora: q0 [rows, qlr]
  bf16* ws_lat;             // pre-norm latent [rows, klat]
  int rows, hidden, nq, dqk, dpe, dv, klat, qlr, half, norm;
  float eps, m2;
};

// mla_down's tiles: on the q_proj path dqk / 32 narrow tiles then one wide
// q_pe tile a head; on the q_lora path qlr / 32 narrow tiles; then klat /
// 32 narrow latent tiles and the wide k_pe tile.
__host__ __device__ inline int q_tiles(const MlaArgs& a) {
  return a.q_down != nullptr ? a.qlr / kNarrow : a.nq * (a.dqk / kNarrow + 1);
}
__host__ __device__ inline int down_tiles(const MlaArgs& a) {
  return q_tiles(a) + a.klat / kNarrow + 1;
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads, 2) mla_down_kernel(MlaArgs a) {
  static_assert(gemm_smem<ROWS>() >= (size_t)(4 * 16 + 16) * ((ROWS + 15) / 16) * kWide * 4,
                "the partials and out_s fit in tile_gemm's region");
  extern __shared__ __align__(16) uint4 smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  float* out_s = reinterpret_cast<float*>(ring) + 4 * 16 * ((ROWS + 15) / 16) * kWide;
  float* mean_s = reinterpret_cast<float*>(reinterpret_cast<char*>(ring) + gemm_smem<ROWS>());
  float* rstd_s = mean_s + ROWS;
  const NormSrc A = {a.x, a.hidden, a.hidden, a.rows, mean_s, rstd_s, a.ln_scale, a.ln_bias};
  auto stats = [&] { row_stats(a.x, a.hidden, a.hidden, a.rows, a.norm, a.eps, mean_s, rstd_s); };

  const bool lora = a.q_down != nullptr, rope = a.cos != nullptr;
  const int dq = a.dqk + a.dpe, per_head = a.dqk / kNarrow + 1;
  const int tile = blockIdx.x, nqt = q_tiles(a);
  if (tile < nqt && lora) {
    const int col0 = tile * kNarrow;
    tile_gemm<ROWS, kNarrow>(a.q_down + col0, a.qlr, A, ring, out_s, stats);
    write_tile<kNarrow>(out_s, a.rows, false, nullptr, nullptr, 0, a.ws_q + col0, a.qlr);
  } else if (tile < nqt) {
    const int h = tile / per_head, j = tile % per_head;
    const bf16* w = a.q_proj + (size_t)h * dq + j * kNarrow;
    if (j < per_head - 1) {
      tile_gemm<ROWS, kNarrow>(w, (long long)a.nq * dq, A, ring, out_s, stats);
      write_tile<kNarrow>(out_s, a.rows, false, nullptr, nullptr, 0,
                          a.ws_q + (size_t)h * a.dqk + j * kNarrow, (long long)a.nq * a.dqk);
    } else {
      tile_gemm<ROWS, kWide>(w, (long long)a.nq * dq, A, ring, out_s, stats);
      write_tile<kWide>(out_s, a.rows, rope, a.cos, a.sin, a.half,
                        a.q_pe + (size_t)h * a.dpe, (long long)a.nq * a.dpe);
    }
  } else {
    const int c = (tile - nqt) * kNarrow;
    const long long ldw = a.klat + a.dpe;
    if (c < a.klat) {
      tile_gemm<ROWS, kNarrow>(a.kv_down + c, ldw, A, ring, out_s, stats);
      write_tile<kNarrow>(out_s, a.rows, false, nullptr, nullptr, 0, a.ws_lat + c, a.klat);
    } else {
      tile_gemm<ROWS, kWide>(a.kv_down + a.klat, ldw, A, ring, out_s, stats);
      write_tile<kWide>(out_s, a.rows, rope, a.cos, a.sin, a.half, a.k_pe, a.dpe);
    }
  }
}

// q_lat[r, h, k0 + c] = bf16(sum_d qa[r][d] kv_up[k0 + c, h (dqk + dv) + d])
// for c < kAbs: the head's kv_up k_nope rows gathered into b_s [kAbs][dqk
// + 8] with cp.async, then warp w (< 4 MT) takes 16-row tile w / 4 and
// latent columns 16 (w % 4) .. + 16 on mma.sync over dqk.
template <int MT>
__device__ void absorb(const MlaArgs& a, int h, int k0, const bf16* qa_s, bf16* b_s) {
  const int ld = a.dqk + 8, pieces = a.dqk / 8;
  const size_t ldkv = (size_t)a.nq * (a.dqk + a.dv);
  __syncthreads();   // b_s is free
  for (int i = threadIdx.x; i < kAbs * pieces; i += kThreads) {
    const int r = i / pieces, d0 = (i % pieces) * 8;
    const bool live = k0 + r < a.klat;
    tc::cp_async_16(b_s + r * ld + d0,
                    a.kv_up + (live ? (size_t)(k0 + r) * ldkv + (size_t)h * (a.dqk + a.dv) + d0 : 0),
                    live);
  }
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int mt = warp >> 2, n0 = 16 * (warp & 3);
  if (mt >= MT) return;
  float c[2][4] = {};
  for (int kk = 0; kk < a.dqk; kk += 16) {
    uint32_t af[4], bf[4];
    tc::ldmatrix_x4(af, qa_s + tc::a_off(lane, 16 * mt, kk, ld));
    tc::ldmatrix_x4(bf, b_s + tc::b_off(lane, n0, kk, ld));
    tc::mma_bf16(c[0], af, bf[0], bf[1]);
    tc::mma_bf16(c[1], af, bf[2], bf[3]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * mt + g + 8 * i, k = k0 + n0 + 8 * j + 2 * t;
      if (r < a.rows && k < a.klat)
        *reinterpret_cast<uint32_t*>(a.q_lat + ((size_t)r * a.nq + h) * a.klat + k) =
            tc::pack_bf16(c[j][2 * i], c[j][2 * i + 1]);
    }
}

// mla_up's shared memory: the head's absorbed q (bf16 [16 MT][dqk + 8]),
// then on the q_lora path tile_gemm's region (b_s inside it), else b_s.
template <int ROWS>
__host__ __device__ size_t up_smem(int dqk, bool lora) {
  const size_t qa = (size_t)16 * ((ROWS + 15) / 16) * (dqk + 8) * sizeof(bf16);
  const size_t b = (size_t)kAbs * (dqk + 8) * sizeof(bf16);
  const size_t gemm = gemm_smem<ROWS>() + (size_t)ROWS * kWide * sizeof(float);
  return qa + (lora ? (gemm > b ? gemm : b) : b) + 2 * ROWS * sizeof(float);
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads) mla_up_kernel(MlaArgs a) {
  constexpr int MT = (ROWS + 15) / 16;
  extern __shared__ __align__(16) uint4 smem_raw[];
  const int tid = threadIdx.x;
  const bool lora = a.q_down != nullptr;
  const int absorbers = lora ? a.nq : a.nq * (a.klat / kAbs);
  bf16* qa_s = reinterpret_cast<bf16*>(smem_raw);           // [16 MT][dqk + 8]
  const int ldq = a.dqk + 8;
  bf16* region = qa_s + 16 * MT * ldq;                      // tile_gemm's, or b_s
  float* stats = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem_raw) + up_smem<ROWS>(a.dqk, lora)) - 2 * ROWS;

  if ((int)blockIdx.x >= absorbers) {
    // One latent row: bf16(x * rstd * kv_ln_scale) over klat columns.
    const int r = blockIdx.x - absorbers;
    const bf16* xr = a.ws_lat + (size_t)r * a.klat;
    float ss = 0.f;
    for (int c = tid; c < a.klat; c += kThreads) {
      const float v = __bfloat162float(xr[c]);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
    ss = warp_sum(ss);
    if (tid % 32 == 0) stats[tid / 32] = ss;
    __syncthreads();
    float tot = 0.f;
    for (int wg = 0; wg < kWarps; ++wg) tot += stats[wg];
    const float rstd = 1.f / sqrtf(tot / (float)a.klat + a.eps);
    for (int c = tid; c < a.klat; c += kThreads)
      a.latent[(size_t)r * a.klat + c] = __float2bfloat16(
          normed(__bfloat162float(xr[c]), 0.f, rstd, __bfloat162float(a.kv_ln_scale[c])));
    return;
  }

  const int dq = a.dqk + a.dpe;
  const int h = lora ? blockIdx.x : blockIdx.x / (a.klat / kAbs);
  if (lora) {
    // This head's q = bf16(rms(q0) @ q_up[:, head columns]): narrow tiles of
    // q_nope into qa_s, the wide q_pe tile roped and written out.
    float* mean_s = stats;
    float* rstd_s = stats + ROWS;
    float* out_s = reinterpret_cast<float*>(reinterpret_cast<char*>(region) + gemm_smem<ROWS>());
    const NormSrc A = {a.ws_q, a.qlr, a.qlr, a.rows, mean_s, rstd_s, a.q_ln_scale, nullptr};
    auto stats = [&] { row_stats(a.ws_q, a.qlr, a.qlr, a.rows, kNormRms, a.eps, mean_s, rstd_s); };
    auto none = [] {};
    const bf16* w = a.q_up + (size_t)h * dq;
    const long long ldw = (long long)a.nq * dq;
    for (int j = 0; j < a.dqk; j += kNarrow) {
      if (j == 0)
        tile_gemm<ROWS, kNarrow>(w + j, ldw, A, region, out_s, stats);
      else
        tile_gemm<ROWS, kNarrow>(w + j, ldw, A, region, out_s, none);
      for (int i = tid; i < 16 * MT * kNarrow; i += kThreads) {
        const int r = i / kNarrow, c = i % kNarrow;
        qa_s[r * ldq + j + c] = __float2bfloat16(r < a.rows ? out_s[r * kNarrow + c] : 0.f);
      }
    }
    tile_gemm<ROWS, kWide>(w + a.dqk, ldw, A, region, out_s, none);
    write_tile<kWide>(out_s, a.rows, a.cos != nullptr, a.cos, a.sin, a.half,
                      a.q_pe + (size_t)h * a.dpe, (long long)a.nq * a.dpe);
  } else {
    // This head's q_nope rows (zeros past rows).
    const int pieces = a.dqk / 8;
    for (int i = tid; i < 16 * MT * pieces; i += kThreads) {
      const int r = i / pieces, d0 = (i % pieces) * 8;
      const bool live = r < a.rows;
      tc::cp_async_16(qa_s + r * ldq + d0,
                      a.ws_q + (live ? ((size_t)r * a.nq + h) * a.dqk + d0 : 0), live);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
  }
  __syncthreads();
  if (a.m2 != 1.f) {   // the absorbed query: bf16(q_nope * m2)
    for (int i = tid; i < 16 * MT * a.dqk; i += kThreads) {
      bf16* e = qa_s + (i / a.dqk) * ldq + i % a.dqk;
      *e = __float2bfloat16(__fmul_rn(__bfloat162float(*e), a.m2));
    }
  }
  if (lora) {
    for (int k0 = 0; k0 < a.klat; k0 += kAbs) absorb<MT>(a, h, k0, qa_s, region);
  } else {
    absorb<MT>(a, h, (blockIdx.x % (a.klat / kAbs)) * kAbs, qa_s, region);
  }
}

template <int ROWS>
size_t down_smem() {
  return gemm_smem<ROWS>() + 2 * ROWS * sizeof(float);
}

template <int ROWS>
int launch_rows(int stage, const MlaArgs& a, cudaStream_t st) {
  cudaError_t err;
  if (stage == 0) {
    const size_t smem = down_smem<ROWS>();
    err = cudaFuncSetAttribute(mla_down_kernel<ROWS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    mla_down_kernel<ROWS><<<down_tiles(a), kThreads, smem, st>>>(a);
  } else {
    const bool lora = a.q_down != nullptr;
    const size_t smem = up_smem<ROWS>(a.dqk, lora);
    err = cudaFuncSetAttribute(mla_up_kernel<ROWS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int absorbers = lora ? a.nq : a.nq * (a.klat / kAbs);
    mla_up_kernel<ROWS><<<absorbers + a.rows, kThreads, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// stage 0 launches mla_down, stage 1 mla_up (after it, on the same
// stream). Pointers as MlaArgs describes (q_proj null on the q_lora path;
// q_down, q_ln_scale, q_up null on the q_proj path; ln_bias null for
// RMSNorm; cos/sin null without rope). Returns a cudaError_t code (0 =
// launched).
extern "C" int fused_mla_launch(
    int stage, const void* x, const void* ln_scale, const void* ln_bias,
    const void* q_proj, const void* q_down, const void* q_ln_scale,
    const void* q_up, const void* kv_down, const void* kv_ln_scale,
    const void* kv_up, const void* cos, const void* sin, void* q_lat,
    void* q_pe, void* latent, void* k_pe, void* ws_q, void* ws_lat, int rows,
    int hidden, int nq, int dqk, int dpe, int dv, int klat, int qlr, int half,
    int norm, float eps, float m2, void* stream) {
  const bool lora = q_down != nullptr;
  if (rows < 1 || rows > 32 || hidden < 8 || hidden % 8 || nq < 1 ||
      dqk < kWide || dqk % kWide || dqk > 256 || dpe != kWide ||
      klat < kWide || klat % kWide || dv < 8 || dv % 8 || half < 0 ||
      2 * half > dpe ||
      (half > 0 && (cos == nullptr || sin == nullptr)) ||
      (norm != kNormRms && norm != kNormLayer) ||
      (lora ? (qlr < kWide || qlr % kWide || q_up == nullptr || q_ln_scale == nullptr)
            : q_proj == nullptr) ||
      stage < 0 || stage > 1)
    return (int)cudaErrorInvalidValue;
  MlaArgs a;
  a.x = static_cast<const bf16*>(x);
  a.ln_scale = static_cast<const bf16*>(ln_scale);
  a.ln_bias = static_cast<const bf16*>(ln_bias);
  a.q_proj = static_cast<const bf16*>(q_proj);
  a.q_down = static_cast<const bf16*>(q_down);
  a.q_ln_scale = static_cast<const bf16*>(q_ln_scale);
  a.q_up = static_cast<const bf16*>(q_up);
  a.kv_down = static_cast<const bf16*>(kv_down);
  a.kv_ln_scale = static_cast<const bf16*>(kv_ln_scale);
  a.kv_up = static_cast<const bf16*>(kv_up);
  a.cos = half > 0 ? static_cast<const float*>(cos) : nullptr;
  a.sin = half > 0 ? static_cast<const float*>(sin) : nullptr;
  a.q_lat = static_cast<bf16*>(q_lat);
  a.q_pe = static_cast<bf16*>(q_pe);
  a.latent = static_cast<bf16*>(latent);
  a.k_pe = static_cast<bf16*>(k_pe);
  a.ws_q = static_cast<bf16*>(ws_q);
  a.ws_lat = static_cast<bf16*>(ws_lat);
  a.rows = rows;
  a.hidden = hidden;
  a.nq = nq;
  a.dqk = dqk;
  a.dpe = dpe;
  a.dv = dv;
  a.klat = klat;
  a.qlr = lora ? qlr : 0;
  a.half = half;
  a.norm = norm;
  a.eps = eps;
  a.m2 = m2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rows <= 8 ? launch_rows<8>(stage, a, st) : launch_rows<32>(stage, a, st);
}
