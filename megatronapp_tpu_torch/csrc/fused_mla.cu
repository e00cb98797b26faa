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
// by those bytes (~17.7 us at 3.35 TB/s). No block of one CUDA kernel can
// wait for another, and three things couple columns across blocks: the rms
// over all klat latent columns, the rope pairs inside each head's dpe q_pe
// columns, and the absorption, which needs a head's whole dqk q_nope values.
// So the work splits in two launches:
// - mla_down: one block a 64-column tile of [q_proj | kv_down] (or
//   [q_down | kv_down] on the q_lora path): 96 + 9 tiles at llama3-8b
//   widths. Each block recomputes its rows' norm statistics, stages
//   bf16(norm(x)) in chunks of 256 k's (every load of a chunk in flight at
//   once), streams its weight slab once (a chunk's 32 loads a thread in
//   flight while the chunk before is summed) and sums in fp32; the 8
//   warps' partial sums add in a fixed order (reruns repeat every bit). A
//   q_pe tile and the k_pe tile (dpe == 64: one tile) rope in the block;
//   q_nope tiles, the pre-norm latent (and q_down's output) go to a bf16
//   workspace.
// - mla_up: one block a head: on the q_lora path it first forms the head's
//   dqk + dpe columns of q = rms(q0) @ q_up the same way (ropes its q_pe
//   tile); then it absorbs the head's q_nope through kv_up's k_nope block,
//   staged 128 latent columns at a time with 16-byte loads. R more blocks
//   normalise one latent row each.
// Products run on CUDA cores in fp32 (no mma/wgmma, no TMA): at 32 rows the
// q_proj product's FMAs (0.8 G a layer) outweigh its bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                 // output columns a GEMM tile
constexpr int kChunk = 256;               // k's staged at once
constexpr int kKw = kChunk / kWarps;      // k's of a chunk a warp sums
constexpr int kAbs = 128;                 // latent columns an absorption pass
enum Norm { kNormRms = 1, kNormLayer = 2 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

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
#pragma unroll 4
      for (int c = lane * 8; c < k; c += 32 * 8) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(xr + c));
        const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += __bfloat162float(v[e]);
      }
      mean = warp_sum(s) / (float)k;
    }
    float ss = 0.f;
#pragma unroll 4
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

// bf16(norm(v)) of one element: ((v - mean) * rstd) * scale (+ bias).
__device__ __forceinline__ float normed(float v, float mean, float rstd,
                                        const bf16* scale, const bf16* bias,
                                        int c) {
  float y = __fmul_rn(__fmul_rn(__fsub_rn(v, mean), rstd),
                      __bfloat162float(scale[c]));
  if (bias != nullptr) y = __fadd_rn(y, __bfloat162float(bias[c]));
  return round_bf16(y);
}

// Stages a_s[kk][r] = bf16(norm(x[r][kc + kk])) for kk < kChunk, r < ROWS
// (zero past `rows` and past k): every load of the chunk in flight before
// the first store.
template <int ROWS>
__device__ void stage_normed(float* a_s, const bf16* x, int ld, int k,
                             int rows, int kc, const float* mean_s,
                             const float* rstd_s, const bf16* scale,
                             const bf16* bias) {
  for (int i = threadIdx.x; i < kChunk * ROWS; i += kThreads) {
    const int kk = i / ROWS, r = i % ROWS, c = kc + kk;
    float v = 0.f;
    if (r < rows && c < k)
      v = normed(__bfloat162float(x[(size_t)r * ld + c]), mean_s[r],
                 rstd_s[r], scale, bias, c);
    a_s[i] = v;
  }
}

// out_s[r][c] = sum_k A[r][k] W[k][c] over a 64-column slab of W (w: its
// first column, row stride ldw, k rows), A staged chunk by chunk into a_s
// by stage(kc). Thread (warp, lane) sums columns 2 lane, 2 lane + 1 over the
// k's warp, warp + 8, ... of each chunk; the warps' partials add in order.
// a_s and red share `region`.
template <int ROWS, typename Stage>
__device__ void tile_gemm(const bf16* __restrict__ w, long long ldw, int k,
                          Stage stage, float* region, float* out_s) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float acc[ROWS][2];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r][0] = acc[r][1] = 0.f;
  const bf16* wp = w + 2 * lane;
  for (int kc = 0; kc < k; kc += kChunk) {
    __syncthreads();
    stage(kc, region);
    __syncthreads();
    uint32_t wv[kKw];
#pragma unroll
    for (int i = 0; i < kKw; ++i) {
      const int kr = kc + warp + i * kWarps;
      wv[i] = kr < k ? __ldg(reinterpret_cast<const unsigned int*>(
                           wp + (long long)kr * ldw))
                     : 0u;
    }
#pragma unroll
    for (int i = 0; i < kKw; ++i) {
      const float w0 = __uint_as_float(wv[i] << 16);
      const float w1 = __uint_as_float(wv[i] & 0xffff0000u);
      const float* ar = region + (warp + i * kWarps) * ROWS;
#pragma unroll
      for (int r = 0; r < ROWS; r += 4) {
        const float4 a = *reinterpret_cast<const float4*>(ar + r);
        acc[r][0] = fmaf(a.x, w0, acc[r][0]);
        acc[r][1] = fmaf(a.x, w1, acc[r][1]);
        acc[r + 1][0] = fmaf(a.y, w0, acc[r + 1][0]);
        acc[r + 1][1] = fmaf(a.y, w1, acc[r + 1][1]);
        acc[r + 2][0] = fmaf(a.z, w0, acc[r + 2][0]);
        acc[r + 2][1] = fmaf(a.z, w1, acc[r + 2][1]);
        acc[r + 3][0] = fmaf(a.w, w0, acc[r + 3][0]);
        acc[r + 3][1] = fmaf(a.w, w1, acc[r + 3][1]);
      }
    }
  }
  __syncthreads();
  float* red = region;   // [kWarps][ROWS][kTile]
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    *reinterpret_cast<float2*>(red + (warp * ROWS + r) * kTile + 2 * lane) =
        make_float2(acc[r][0], acc[r][1]);
  __syncthreads();
  for (int i = tid; i < ROWS * kTile; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int wg = 0; wg < kWarps; ++wg) s += red[wg * ROWS * kTile + i];
    out_s[i] = s;
  }
  __syncthreads();
}

// Writes a finished 64-column tile (fp32 sums out_s [ROWS][64]) rounded to
// bf16, roped first when `rope` (columns c < half pair with c + half;
// columns past 2 half pass through): dst[r * ld + c].
template <int ROWS>
__device__ void write_tile(const float* out_s, int rows, bool rope,
                           const float* cos, const float* sin, int half,
                           bf16* dst, long long ld) {
  for (int i = threadIdx.x; i < rows * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    float v = round_bf16(out_s[r * kTile + c]);
    if (rope && c < 2 * half) {
      const int j = c < half ? c : c - half;
      const float cs = cos[(size_t)r * half + j], sn = sin[(size_t)r * half + j];
      const float x1 = round_bf16(out_s[r * kTile + j]);
      const float x2 = round_bf16(out_s[r * kTile + j + half]);
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

template <int ROWS>
__global__ void __launch_bounds__(kThreads) mla_down_kernel(MlaArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* region = smem;                                  // max(a_s, red)
  float* out_s = region + kWarps * ROWS * kTile;         // [ROWS][kTile]
  float* mean_s = out_s + ROWS * kTile;
  float* rstd_s = mean_s + ROWS;
  row_stats(a.x, a.hidden, a.hidden, a.rows, a.norm, a.eps, mean_s, rstd_s);

  const bool lora = a.q_down != nullptr;
  const int dq = a.dqk + a.dpe;
  const int nq_cols = lora ? a.qlr : a.nq * dq;
  const int col0 = blockIdx.x * kTile;      // in [q columns | kv_down columns]
  const bool q_tile = col0 < nq_cols;
  const bf16* w = q_tile ? (lora ? a.q_down : a.q_proj) + col0
                         : a.kv_down + (col0 - nq_cols);
  const long long ldw = q_tile ? nq_cols : a.klat + a.dpe;
  auto stage = [&](int kc, float* a_s) {
    stage_normed<ROWS>(a_s, a.x, a.hidden, a.hidden, a.rows, kc, mean_s,
                       rstd_s, a.ln_scale, a.ln_bias);
  };
  tile_gemm<ROWS>(w, ldw, a.hidden, stage, region, out_s);

  const bool rope = a.cos != nullptr;
  if (q_tile && lora) {
    write_tile<ROWS>(out_s, a.rows, false, nullptr, nullptr, 0,
                     a.ws_q + col0, a.qlr);
  } else if (q_tile) {
    const int h = col0 / dq, j = col0 % dq;
    if (j < a.dqk)
      write_tile<ROWS>(out_s, a.rows, false, nullptr, nullptr, 0,
                       a.ws_q + (size_t)h * a.dqk + j, (long long)a.nq * a.dqk);
    else
      write_tile<ROWS>(out_s, a.rows, rope, a.cos, a.sin, a.half,
                       a.q_pe + (size_t)h * a.dpe, (long long)a.nq * a.dpe);
  } else {
    const int c = col0 - nq_cols;
    if (c < a.klat)
      write_tile<ROWS>(out_s, a.rows, false, nullptr, nullptr, 0,
                       a.ws_lat + c, a.klat);
    else
      write_tile<ROWS>(out_s, a.rows, rope, a.cos, a.sin, a.half, a.k_pe,
                       a.dpe);
  }
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads) mla_up_kernel(MlaArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  float* region = smem;                                  // max(a_s, red)
  float* out_s = region + kWarps * ROWS * kTile;         // [ROWS][kTile]
  float* mean_s = out_s + ROWS * kTile;
  float* rstd_s = mean_s + ROWS;
  float* qn_s = rstd_s + ROWS;                           // [dqk][ROWS]
  float* wk_s = qn_s + a.dqk * ROWS;                     // [kAbs][dqk + 1]

  if ((int)blockIdx.x >= a.nq) {
    // One latent row: bf16(x * rstd * kv_ln_scale) over klat columns.
    const int r = blockIdx.x - a.nq;
    const bf16* xr = a.ws_lat + (size_t)r * a.klat;
    float ss = 0.f;
    for (int c = tid; c < a.klat; c += kThreads) {
      const float v = __bfloat162float(xr[c]);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
    ss = warp_sum(ss);
    if (tid % 32 == 0) region[tid / 32] = ss;
    __syncthreads();
    float tot = 0.f;
    for (int wg = 0; wg < kWarps; ++wg) tot += region[wg];
    const float rstd = 1.f / sqrtf(tot / (float)a.klat + a.eps);
    for (int c = tid; c < a.klat; c += kThreads)
      a.latent[(size_t)r * a.klat + c] = __float2bfloat16(
          normed(__bfloat162float(xr[c]), 0.f, rstd, a.kv_ln_scale, nullptr, c));
    return;
  }

  const int h = blockIdx.x;
  const int dq = a.dqk + a.dpe;
  if (a.q_down != nullptr) {
    // This head's q = bf16(rms(q0) @ q_up[:, head columns]), 64 columns at a
    // time; the q_pe tile ropes and goes out, q_nope stays in qn_s.
    row_stats(a.ws_q, a.qlr, a.qlr, a.rows, kNormRms, a.eps, mean_s, rstd_s);
    auto stage = [&](int kc, float* a_s) {
      stage_normed<ROWS>(a_s, a.ws_q, a.qlr, a.qlr, a.rows, kc, mean_s,
                         rstd_s, a.q_ln_scale, nullptr);
    };
    for (int j = 0; j < dq; j += kTile) {
      tile_gemm<ROWS>(a.q_up + (size_t)h * dq + j, (long long)a.nq * dq,
                      a.qlr, stage, region, out_s);
      if (j < a.dqk) {
        for (int i = tid; i < ROWS * kTile; i += kThreads) {
          const int r = i % ROWS, c = i / ROWS;
          qn_s[(j + c) * ROWS + r] = r < a.rows ? round_bf16(out_s[r * kTile + c]) : 0.f;
        }
      } else {
        write_tile<ROWS>(out_s, a.rows, a.cos != nullptr, a.cos, a.sin, a.half,
                         a.q_pe + (size_t)h * a.dpe, (long long)a.nq * a.dpe);
      }
      __syncthreads();
    }
  } else {
    // This head's q_nope rows, 16-byte loads along d.
    for (int i = tid; i < a.rows * (a.dqk / 8); i += kThreads) {
      const int r = i / (a.dqk / 8), d0 = (i % (a.dqk / 8)) * 8;
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          a.ws_q + ((size_t)r * a.nq + h) * a.dqk + d0));
      const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) qn_s[(d0 + e) * ROWS + r] = __bfloat162float(v[e]);
    }
    for (int i = tid; i < a.dqk * ROWS; i += kThreads)
      if (i % ROWS >= a.rows) qn_s[i] = 0.f;
  }
  __syncthreads();
  if (a.m2 != 1.f)
    for (int i = tid; i < a.dqk * ROWS; i += kThreads)
      qn_s[i] = round_bf16(__fmul_rn(qn_s[i], a.m2));

  // q_lat[r, h, k] = sum_d q_abs[r, d] kv_up[k, h (dqk + dv) + d], 128 latent
  // columns a pass: thread (k, half of the rows).
  constexpr int kHalfRows = ROWS / 2;
  const int ldw = a.dqk + 1;
  const size_t ldkv = (size_t)a.nq * (a.dqk + a.dv);
  const int kk = tid % kAbs, rh = tid / kAbs;
  const int pieces = a.dqk / 8;                 // 16-byte pieces of a row
  for (int kc = 0; kc < a.klat; kc += kAbs) {
    __syncthreads();
    // kv_up's k_nope block of this head, 128 latent rows: 16-byte loads,
    // eight in flight a thread before their stores.
    for (int i0 = tid; i0 < kAbs * pieces; i0 += 8 * kThreads) {
      uint4 raw[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kThreads, r = i / pieces, d0 = (i % pieces) * 8;
        raw[u] = i < kAbs * pieces && kc + r < a.klat
            ? __ldg(reinterpret_cast<const uint4*>(
                  a.kv_up + (size_t)(kc + r) * ldkv + (size_t)h * (a.dqk + a.dv) + d0))
            : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kThreads, r = i / pieces, d0 = (i % pieces) * 8;
        if (i < kAbs * pieces) {
          const bf16* v = reinterpret_cast<const bf16*>(&raw[u]);
#pragma unroll
          for (int e = 0; e < 8; ++e) wk_s[r * ldw + d0 + e] = __bfloat162float(v[e]);
        }
      }
    }
    __syncthreads();
    float acc[kHalfRows];
#pragma unroll
    for (int i = 0; i < kHalfRows; ++i) acc[i] = 0.f;
    const float* wr = wk_s + kk * ldw;
    for (int d = 0; d < a.dqk; ++d) {
      const float wv = wr[d];
      const float* qr = qn_s + d * ROWS + rh * kHalfRows;
#pragma unroll
      for (int i = 0; i < kHalfRows; i += 4) {
        const float4 q = *reinterpret_cast<const float4*>(qr + i);
        acc[i] = fmaf(q.x, wv, acc[i]);
        acc[i + 1] = fmaf(q.y, wv, acc[i + 1]);
        acc[i + 2] = fmaf(q.z, wv, acc[i + 2]);
        acc[i + 3] = fmaf(q.w, wv, acc[i + 3]);
      }
    }
    const int k = kc + kk;
#pragma unroll
    for (int i = 0; i < kHalfRows; ++i) {
      const int r = rh * kHalfRows + i;
      if (r < a.rows && k < a.klat)
        a.q_lat[((size_t)r * a.nq + h) * a.klat + k] = __float2bfloat16(acc[i]);
    }
  }
}

template <int ROWS>
size_t down_smem() {
  return (size_t)(kWarps * ROWS * kTile + ROWS * kTile + 2 * ROWS) * sizeof(float);
}

template <int ROWS>
size_t up_smem(int dqk) {
  return down_smem<ROWS>() + (size_t)(dqk * ROWS + kAbs * (dqk + 1)) * sizeof(float);
}

template <int ROWS>
int launch_rows(int stage, const MlaArgs& a, cudaStream_t st) {
  cudaError_t err;
  if (stage == 0) {
    const size_t smem = down_smem<ROWS>();
    err = cudaFuncSetAttribute(mla_down_kernel<ROWS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int cols = (a.q_down != nullptr ? a.qlr : a.nq * (a.dqk + a.dpe)) + a.klat + a.dpe;
    mla_down_kernel<ROWS><<<cols / kTile, kThreads, smem, st>>>(a);
  } else {
    const size_t smem = up_smem<ROWS>(a.dqk);
    err = cudaFuncSetAttribute(mla_up_kernel<ROWS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    mla_up_kernel<ROWS><<<a.nq + a.rows, kThreads, smem, st>>>(a);
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
      dqk < kTile || dqk % kTile || dqk > 256 || dpe != kTile ||
      klat < kTile || klat % kTile || dv < 8 || dv % 8 || half < 0 ||
      2 * half > dpe ||
      (half > 0 && (cos == nullptr || sin == nullptr)) ||
      (norm != kNormRms && norm != kNormLayer) ||
      (lora ? (qlr < kTile || qlr % kTile || q_up == nullptr || q_ln_scale == nullptr)
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
