// Fused (megakernel) decode-layer kernels for Hopper (sm_90a): the QKV
// prologue, the out-projection epilogue and the two halves of the MLP that
// run around the paged-attention kernel (paged_attention.cu) in one fused
// decode or chunked-prefill layer.
//
// Replace the TPU kernels of megatronapp_tpu/ops/pallas/kernel_gen.py:
//   fused_qkv_kernel       _fused_qkv (def :1143; no grid :1261, grid over
//                          kv-head groups :1357)
//   fused_out_proj_kernel  _fused_out_proj (def :1505; :1567, :1581)
//   fused_mlp_fc1_kernel   _fused_mlp_fc1 (def :1696; :1783) and the fc1 half
//                          of the one-kernel _fused_mlp (def :1591; :1689)
//   fused_mlp_fc2_kernel   _fused_mlp_fc2 (def :1793; :1834) and the fc2 half
//                          of _fused_mlp
// _fused_mlp becomes the fc1/fc2 pair: fc2 contracts every ffn column that
// fc1 writes, and blocks of one CUDA kernel cannot wait for each other. The
// split is exact: y [R, ffn] is stored in bf16, the compute dtype in which
// the one-kernel body holds it too (kernel_gen.py _mlp_tiles docstring).
//
// What they compute (R rows: B decode slots, or B*S flattened ragged rows):
//   qkv:      xn = bf16(norm(x)); q|k|v = bf16(xn @ W) (+ bf16 bias, rounded);
//             q, k: optional QK-RMSnorm per head (fp32, rounded), then rope
//             (half rotation in fp32 from per-row cos/sin [R, half], rounded;
//             columns past 2*half pass through)
//   out_proj: out = bf16(residual + bf16(attn_flat @ W_o (+ bias)))
//   fc1:      y = act(bf16(xn @ W1) (+ bias)); gated kinds read the gate
//             column j and the value column ffn + j of the packed
//             [gate | value] weight, y = bf16(bf16(gate_act(gate)) * value)
//   fc2:      out = bf16(residual + bf16(y @ W2 (+ bias)))
// The rounding points are the JAX bodies' and the port's plain versions'
// (ops/cuda/fused_decode.py). Weights are bf16, fp32 rounded to bf16 as they
// load (kernel_gen.py _dequant_weight's plain branch), or resident int8 with
// one fp32 scale per output column, dequantized as they load exactly as
// _dequant_weight (kernel_gen.py:1020-1029) and resolve_param do:
// bf16(float(q) * scale[col]), then used as a float (the bf16 rounding of the
// dequantized weight is part of the reference's arithmetic). Norm scales and
// biases are bf16 or fp32 (the params dtype); activations, residual and
// outputs are bf16; sums are fp32.
//
// Bound. At decode (R = 8) each kernel reads its weight matrix once and does
// 2 R FLOPs per weight: 16 FLOPs per 2-byte weight, far below the card's
// ~295 FLOPs per byte, so every one is bound by the bytes of its weights
// (llama3-8b: 50.3 MB QKV, 33.6 MB out-projection, 234.9 MB fc1, 117.4 MB
// fc2 a layer). Design, for that bound:
// - A block owns a tile of 128 output columns (QKV: one or two whole heads,
//   so QK-norm and rope stay in the block; gated fc1: 64 gate and the 64
//   matching value columns) and streams that weight slab from device memory
//   exactly once, with 16-byte loads at R <= 8 (8 bf16 columns a thread) and
//   4-byte loads at R <= 32 (2 columns a thread, so that the R x columns
//   fp32 sums of a thread stay at 64 registers); each thread keeps 32 words
//   of weights in flight before it uses them.
// - The R x K activations never fit a block's 227 KB (x at R = 32 is 256 KB,
//   y 917 KB), so they are staged through shared memory in chunks of 256 k's,
//   normalised (QKV, fc1) as they are staged, as fp32 [k][row] so that a
//   thread reads four rows with one 16-byte load.
// - Too few tiles for 132 SMs (out-projection and fc2: 32 tiles of 128
//   columns; QKV: 48) are split along K across blocks: grid.y = ksplit
//   blocks per tile, each writing its fp32 partial tile to a workspace. The
//   last block of a tile to finish (an atomic count on a per-tile counter,
//   not on any sum) adds the partials in split order 0..ksplit-1, runs the
//   epilogue and resets the counter. Inside a block the k rows in flight are
//   summed through shared memory in a fixed order too, so a rerun repeats
//   every bit: no atomics in the sums.
// - Every block of a normalised kernel recomputes its rows' norm statistics
//   from the whole x row (L2-resident), as the TPU tiled kernel recomputes
//   its norm per grid step.
// At R = 32 (a prefill chunk) the FMAs outweigh the bytes on CUDA cores (fc1:
// 7.5 GFLOP a layer, ~1.6x its byte time at the fp32 FMA rate); tensor-core
// products (mma/wgmma) and TMA are the next step, not this version's.
// Resident int8 weights halve the bytes (llama3-8b fc1: 117.4 MB a layer and
// 115 KB of scales) but keep the FMAs and add a multiply and a rounding per
// weight, so at R = 8 the int8 kernels are bound by the instructions a
// weight costs rather than by its bytes: chip_smoke.py's times phase on an
// NVIDIA H100 80GB HBM3 at 700.00 W measured them at 1.05-1.19x the bf16
// kernels, 3.9-6.7x their halved byte bound. Each thread loads its
// columns' scales once, before the k loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;               // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;                  // virtual output columns a block
constexpr int kHalfTile = kTile / 2;        // one weight segment
constexpr int kChunk = 256;                 // k's of activations staged at once
constexpr int kSums = 64;                   // fp32 sums a thread keeps
constexpr int kRegion = kThreads * kSums;   // floats: staged x, then the sums

enum Norm { kNormNone = 0, kNormRms = 1, kNormLayer = 2 };
enum Act { kSwiglu = 0, kGeglu = 1, kGelu = 2, kRelu = 3, kSquaredRelu = 4 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float load_f(const bf16* p, size_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 32-bit words holding `bytes` bytes (a 2-byte load takes one word).
constexpr int words_of(int bytes) { return bytes < 4 ? 1 : bytes / 4; }

// The tile of one thread: RB rows x kCpl columns; the kGroups k rows that a
// block has in flight at once, kUnroll of them per thread.
template <int RB, typename TW>
struct Plan {
  static constexpr int kCpl = kSums / RB;               // 8 (RB 8) or 2 (RB 32)
  static constexpr int kLanes = kTile / kCpl;           // threads per k row
  static constexpr int kGroups = kThreads / kLanes;     // k rows in flight
  static constexpr int kWords = words_of(kCpl * (int)sizeof(TW));
  static constexpr int kUnroll = 32 / kWords;           // 32 words in flight
  static constexpr int kStep = kGroups * kUnroll;       // k rows a step
  static_assert(kChunk % kStep == 0, "a chunk holds whole steps");
  static_assert(kHalfTile % kCpl == 0, "a thread's columns lie in one segment");
};

// kCpl consecutive weights of one k row, as raw 32-bit words.
template <typename TW, int CPL>
struct WeightVec {
  static constexpr int kBytes = CPL * (int)sizeof(TW);
  static constexpr int kWords = words_of(kBytes);
  uint32_t w[kWords];

  __device__ __forceinline__ void load(const TW* p) {
    if constexpr (kBytes == 2) {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    } else if constexpr (kWords == 1) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else if constexpr (kWords == 2) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = t.x;
      w[1] = t.y;
    } else {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 t = __ldg(reinterpret_cast<const uint4*>(p) + i);
        w[4 * i] = t.x;
        w[4 * i + 1] = t.y;
        w[4 * i + 2] = t.z;
        w[4 * i + 3] = t.w;
      }
    }
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
  }

  // The weights in the compute dtype (bf16), as floats; int8 weights
  // dequantize with their columns' scales sc: bf16(float(q) * sc).
  __device__ __forceinline__ void unpack(float (&f)[CPL], const float (&sc)[CPL]) const {
    if constexpr (std::is_same<TW, int8_t>::value) {
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int8_t q = (int8_t)((w[i / 4] >> (8 * (i % 4))) & 0xffu);
        f[i] = round_bf16(__fmul_rn((float)q, sc[i]));
      }
    } else if constexpr (sizeof(TW) == 2) {
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int i = 0; i < CPL; ++i) f[i] = round_bf16(__uint_as_float(w[i]));
    }
  }
};

template <typename TV>
struct GemmArgs {
  const bf16* x;          // [rows, k] activations
  const TV* norm_scale;   // [k] (kNormNone: unused)
  const TV* norm_bias;    // [k] or null (layernorm bias)
  int norm;
  float eps;
  int rows, k;
  float* ws;              // [tiles * row chunks, ksplit, RB, kTile] partials
  int* counters;          // [tiles * row chunks], zero between launches
  int ksplit;
};

size_t smem_bytes(int rb) {
  return (size_t)(kRegion + rb * kTile + 2 * rb + 4) * sizeof(float);
}

// Sums this block's [RB, kTile] tile of bf16(norm(x)) @ W over its k split.
// Virtual columns 0..63 read weight segment w0, 64..127 segment w1, both
// with row stride ldw; int8 weights take their columns' scales from s0 and
// s1 (null otherwise). Returns true in the block that then holds the
// finished fp32 sums in `tile` (every block when ksplit == 1, else the last
// of the tile's blocks to finish) and false in the others, which exit.
template <int RB, typename TW, typename TV>
__device__ bool accumulate_tile(const GemmArgs<TV>& a, const TW* w0,
                                const TW* w1, const float* s0,
                                const float* s1, size_t ldw, float* smem) {
  using P = Plan<RB, TW>;
  float* xs = smem;                  // [kChunk][RB] staged activations
  float* red = smem;                 // [kGroups][RB][kTile], after the k loop
  float* tile = smem + kRegion;      // [RB][kTile]
  float* mean_s = tile + RB * kTile;
  float* rstd_s = mean_s + RB;
  int* flag_s = reinterpret_cast<int*>(rstd_s + RB);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.z * RB;
  const int rows = min(RB, a.rows - row0);
  const int kper = ((a.k + a.ksplit - 1) / a.ksplit + 7) / 8 * 8;
  const int k_begin = min(a.k, (int)blockIdx.y * kper);
  const int k_end = min(a.k, k_begin + kper);

  // Norm statistics over the whole row: mean (layernorm) and
  // 1 / sqrt(mean((x - mean)^2) + eps), as ops/normalization.py.
  if (a.norm != kNormNone) {
    for (int r = warp; r < rows; r += kWarps) {
      const bf16* xr = a.x + (size_t)(row0 + r) * a.k;
      float mean = 0.f;
      if (a.norm == kNormLayer) {
        float s = 0.f;
        for (int c = lane * 8; c < a.k; c += 32 * 8) {
          const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
          const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) s += __bfloat162float(v[e]);
        }
        mean = warp_sum(s) / (float)a.k;
      }
      float ss = 0.f;
      for (int c = lane * 8; c < a.k; c += 32 * 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
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
        rstd_s[r] = 1.f / sqrtf(ss / (float)a.k + a.eps);
      }
    }
  }

  float acc[RB][P::kCpl];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < P::kCpl; ++c) acc[r][c] = 0.f;
  const int kg = tid / P::kLanes;
  const int vc = (tid % P::kLanes) * P::kCpl;
  const TW* wp = vc < kHalfTile ? w0 + vc : w1 + (vc - kHalfTile);
  float sc[P::kCpl];
#pragma unroll
  for (int c = 0; c < P::kCpl; ++c) sc[c] = 1.f;
  if constexpr (std::is_same<TW, int8_t>::value) {
    const float* sp = vc < kHalfTile ? s0 + vc : s1 + (vc - kHalfTile);
#pragma unroll
    for (int c = 0; c < P::kCpl; ++c) sc[c] = sp[c];
  }

  for (int c0 = k_begin; c0 < k_end; c0 += kChunk) {
    const int kc = min(kChunk, k_end - c0);
    __syncthreads();   // statistics written; the previous chunk consumed
    for (int i = tid; i < RB * (kChunk / 8); i += kThreads) {
      const int r = i % RB, k8 = (i / RB) * 8;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
      if (r < rows && k8 < kc) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            a.x + (size_t)(row0 + r) * a.k + c0 + k8);
        const bf16* xv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[e] = __bfloat162float(xv[e]);
          if (a.norm != kNormNone) {
            const int kk = c0 + k8 + e;
            float t = __fmul_rn(__fsub_rn(v[e], mean_s[r]), rstd_s[r]);
            t = __fmul_rn(t, load_f(a.norm_scale, kk));
            if (a.norm_bias != nullptr) t = __fadd_rn(t, load_f(a.norm_bias, kk));
            v[e] = round_bf16(t);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) xs[(k8 + e) * RB + r] = v[e];
    }
    __syncthreads();

    for (int kb = 0; kb < kc; kb += P::kStep) {
      WeightVec<TW, P::kCpl> wv[P::kUnroll];
#pragma unroll
      for (int u = 0; u < P::kUnroll; ++u) {
        const int kk = kb + kg + u * P::kGroups;
        if (kk < kc)
          wv[u].load(wp + (size_t)(c0 + kk) * ldw);
        else
          wv[u].zero();
      }
#pragma unroll
      for (int u = 0; u < P::kUnroll; ++u) {
        // Rows past kc hold zeros in xs and zero weights: they add +0.
        const int kk = kb + kg + u * P::kGroups;
        float wf[P::kCpl];
        wv[u].unpack(wf, sc);
        const float4* xp = reinterpret_cast<const float4*>(xs + kk * RB);
#pragma unroll
        for (int r4 = 0; r4 < RB / 4; ++r4) {
          const float4 xv = xp[r4];
#pragma unroll
          for (int c = 0; c < P::kCpl; ++c) {
            acc[4 * r4][c] = fmaf(xv.x, wf[c], acc[4 * r4][c]);
            acc[4 * r4 + 1][c] = fmaf(xv.y, wf[c], acc[4 * r4 + 1][c]);
            acc[4 * r4 + 2][c] = fmaf(xv.z, wf[c], acc[4 * r4 + 2][c]);
            acc[4 * r4 + 3][c] = fmaf(xv.w, wf[c], acc[4 * r4 + 3][c]);
          }
        }
      }
    }
  }

  // The kGroups partial sums of each output, added in group order.
  __syncthreads();   // xs is dead; red takes its place
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < P::kCpl; ++c)
      red[(kg * RB + r) * kTile + vc + c] = acc[r][c];
  __syncthreads();
  for (int i = tid; i < RB * kTile; i += kThreads) {
    float s = red[i];
    for (int g = 1; g < P::kGroups; ++g) s += red[g * RB * kTile + i];
    tile[i] = s;
  }

  if (a.ksplit > 1) {
    const int unit = blockIdx.z * gridDim.x + blockIdx.x;
    float* part = a.ws + (size_t)unit * a.ksplit * RB * kTile;
    for (int i = tid; i < RB * kTile; i += kThreads)
      part[(size_t)blockIdx.y * RB * kTile + i] = tile[i];
    __threadfence();
    __syncthreads();
    if (tid == 0) *flag_s = atomicAdd(a.counters + unit, 1) == a.ksplit - 1;
    __syncthreads();
    if (!*flag_s) return false;
    __threadfence();
    for (int i = tid; i < RB * kTile; i += kThreads) {
      float s = __ldcg(part + i);
      for (int sp = 1; sp < a.ksplit; ++sp)
        s += __ldcg(part + (size_t)sp * RB * kTile + i);
      tile[i] = s;
    }
    if (tid == 0) a.counters[unit] = 0;
  }
  __syncthreads();
  return true;
}

// ---------------------------------------------------------------------------
// fused_qkv_kernel: replaces kernel_gen.py _fused_qkv (:1143), both its
// no-grid (:1261) and kv-head-group (:1357) emissions. Bound by the bytes of
// Wq and the packed [K | V] weight (50.3 MB a llama3-8b layer). A block owns
// 128 columns of [Wq | Wkv], the weights as they are stored (kv_kernel keeps
// its [K | V] packing): one head at D 128, two at D 64, so that QK-norm and
// rope run in the block on the finished sums; the tile's K split (6 blocks a
// tile at R 8 on llama3-8b) fills the card.
// ---------------------------------------------------------------------------
template <int RB, typename TW, typename TV>
__global__ void __launch_bounds__(kThreads, 2)
fused_qkv_kernel(GemmArgs<TV> a, const TW* wq, const TW* wkv,
                 const float* q_scale, const float* kv_scale,
                 const TV* q_bias, const TV* kv_bias, const TV* q_ln,
                 const TV* k_ln, const float* cos, const float* sin,
                 bf16* q_out, bf16* k_out, bf16* v_out, int nq_cols,
                 int nkv_cols, int head_dim, int rope_half) {
  extern __shared__ __align__(16) float smem[];
  const int col0 = blockIdx.x * kTile;
  const bool is_q = col0 < nq_cols;
  const TW* base = is_q ? wq + col0 : wkv + (col0 - nq_cols);
  // The scales of the tile's columns: q's, or [K | V]'s by the same column.
  const float* sbase = q_scale == nullptr ? nullptr
      : is_q ? q_scale + col0 : kv_scale + (col0 - nq_cols);
  const size_t ldw = is_q ? nq_cols : 2 * nkv_cols;
  if (!accumulate_tile<RB, TW, TV>(a, base, base + kHalfTile, sbase,
                                   sbase == nullptr ? nullptr : sbase + kHalfTile,
                                   ldw, smem))
    return;

  float* tile = smem + kRegion;
  const int row0 = blockIdx.z * RB;
  const int rows = min(RB, a.rows - row0);
  // 0: q, 1: k, 2: v; bias0 indexes q_bias or the packed kv_bias.
  const int region = is_q ? 0 : (col0 - nq_cols < nkv_cols ? 1 : 2);
  const int bias0 = is_q ? col0 : col0 - nq_cols;
  const int out0 = region == 2 ? col0 - nq_cols - nkv_cols : bias0;
  const TV* bias = is_q ? q_bias : kv_bias;

  for (int i = threadIdx.x; i < rows * kTile; i += kThreads) {
    float v = round_bf16(tile[i]);
    if (bias != nullptr)
      v = round_bf16(__fadd_rn(v, round_bf16(load_f(bias, bias0 + i % kTile))));
    tile[i] = v;
  }
  __syncthreads();

  if (region < 2 && q_ln != nullptr) {   // QK-RMSnorm, one warp a (row, head)
    const TV* scale = region == 0 ? q_ln : k_ln;
    const int heads = kTile / head_dim;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int t = warp; t < rows * heads; t += kWarps) {
      float* h = tile + (t / heads) * kTile + (t % heads) * head_dim;
      float ss = 0.f;
      for (int d = lane; d < head_dim; d += 32) ss = __fadd_rn(ss, __fmul_rn(h[d], h[d]));
      ss = warp_sum(ss);
      const float rstd = 1.f / sqrtf(ss / (float)head_dim + a.eps);
      for (int d = lane; d < head_dim; d += 32)
        h[d] = round_bf16(__fmul_rn(__fmul_rn(h[d], rstd), load_f(scale, d)));
    }
    __syncthreads();
  }

  bf16* out = region == 0 ? q_out : region == 1 ? k_out : v_out;
  const int ocols = region == 0 ? nq_cols : nkv_cols;
  const bool rope = region < 2 && cos != nullptr;
  for (int i = threadIdx.x; i < rows * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile, d = c % head_dim;
    float v = tile[i];
    if (rope && d < 2 * rope_half) {
      const size_t t0 = (size_t)(row0 + r) * rope_half;
      if (d < rope_half) {
        v = __fsub_rn(__fmul_rn(v, cos[t0 + d]),
                      __fmul_rn(tile[i + rope_half], sin[t0 + d]));
      } else {
        const int j = d - rope_half;
        v = __fadd_rn(__fmul_rn(v, cos[t0 + j]),
                      __fmul_rn(tile[i - rope_half], sin[t0 + j]));
      }
    }
    out[(size_t)(row0 + r) * ocols + out0 + c] = __float2bfloat16(v);
  }
}

// out = bf16(residual + bf16(bf16(sums) + bf16(bias))), the out-projection's
// and fc2's epilogue (kernel_gen.py :1556-1558, :1829-1832).
template <int RB, typename TV>
__device__ void residual_epilogue(const GemmArgs<TV>& a, const float* tile,
                                  const TV* bias, const bf16* residual,
                                  bf16* out, int n_cols) {
  const int col0 = blockIdx.x * kTile;
  const int row0 = blockIdx.z * RB;
  const int rows = min(RB, a.rows - row0);
  for (int i = threadIdx.x; i < rows * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    float v = round_bf16(tile[i]);
    if (bias != nullptr) v = round_bf16(__fadd_rn(v, round_bf16(load_f(bias, col0 + c))));
    const size_t o = (size_t)(row0 + r) * n_cols + col0 + c;
    out[o] = __float2bfloat16(__fadd_rn(__bfloat162float(residual[o]), v));
  }
}

// ---------------------------------------------------------------------------
// fused_out_proj_kernel: replaces kernel_gen.py _fused_out_proj (:1505),
// both emissions (:1567, :1581). Bound by the bytes of W_o (33.6 MB a
// llama3-8b layer). attn_flat [R, nq*D] @ W_o over 128-column tiles of H,
// each tile split along the nq*D contraction (8 blocks a tile at R 8 on
// llama3-8b: 32 tiles alone would leave 100 of 132 SMs idle).
// ---------------------------------------------------------------------------
template <int RB, typename TW, typename TV>
__global__ void __launch_bounds__(kThreads, 2)
fused_out_proj_kernel(GemmArgs<TV> a, const TW* w, const float* w_scale,
                      const TV* bias, const bf16* residual, bf16* out,
                      int n_cols) {
  extern __shared__ __align__(16) float smem[];
  const TW* base = w + blockIdx.x * kTile;
  const float* sbase = w_scale == nullptr ? nullptr : w_scale + blockIdx.x * kTile;
  if (!accumulate_tile<RB, TW, TV>(a, base, base + kHalfTile, sbase,
                                   sbase == nullptr ? nullptr : sbase + kHalfTile,
                                   n_cols, smem))
    return;
  residual_epilogue<RB, TV>(a, smem + kRegion, bias, residual, out, n_cols);
}

__device__ __forceinline__ float gelu_tanh(float x) {
  // ops/activations.py gelu (tanh approximation), in fp32.
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}

// ---------------------------------------------------------------------------
// fused_mlp_fc1_kernel: replaces kernel_gen.py _fused_mlp_fc1 (:1696, call
// :1783) and the fc1 half of _fused_mlp (:1591, call :1689). Bound by the
// bytes of W1 (234.9 MB a llama3-8b layer, gated). Gated kinds: a block owns
// 64 output columns j and reads the gate column j and the value column
// ffn + j of the packed [gate | value] weight as its two 64-column segments,
// as the TPU kernel passes the weight twice (:1742-1746); plain kinds own
// 128 columns. 224 tiles at llama3-8b already fill the card at R 8.
// ---------------------------------------------------------------------------
template <int RB, typename TW, typename TV>
__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_fc1_kernel(GemmArgs<TV> a, const TW* w1, const float* w1_scale,
                     const TV* b1, bf16* y, int ffn, int act) {
  extern __shared__ __align__(16) float smem[];
  const bool gated = act == kSwiglu || act == kGeglu;
  const int width = gated ? kHalfTile : kTile;
  const int j0 = blockIdx.x * width;
  const TW* seg0 = w1 + j0;
  const TW* seg1 = gated ? w1 + ffn + j0 : seg0 + kHalfTile;
  // The scales of the two segments' columns, indexed as the weights are.
  const float* sc0 = w1_scale == nullptr ? nullptr : w1_scale + j0;
  const float* sc1 = w1_scale == nullptr ? nullptr
      : gated ? w1_scale + ffn + j0 : sc0 + kHalfTile;
  const size_t ldw = gated ? 2 * (size_t)ffn : (size_t)ffn;
  if (!accumulate_tile<RB, TW, TV>(a, seg0, seg1, sc0, sc1, ldw, smem)) return;

  const float* tile = smem + kRegion;
  const int row0 = blockIdx.z * RB;
  const int rows = min(RB, a.rows - row0);
  for (int i = threadIdx.x; i < rows * width; i += kThreads) {
    const int r = i / width, c = i % width, j = j0 + c;
    float out;
    if (gated) {
      float g = round_bf16(tile[r * kTile + c]);
      float v = round_bf16(tile[r * kTile + kHalfTile + c]);
      if (b1 != nullptr) {
        g = round_bf16(__fadd_rn(g, round_bf16(load_f(b1, j))));
        v = round_bf16(__fadd_rn(v, round_bf16(load_f(b1, (size_t)ffn + j))));
      }
      const float ga = act == kSwiglu
          ? __fdiv_rn(g, __fadd_rn(1.f, expf(-g)))     // silu
          : gelu_tanh(g);
      out = __fmul_rn(round_bf16(ga), v);
    } else {
      float v = round_bf16(tile[r * kTile + c]);
      if (b1 != nullptr) v = round_bf16(__fadd_rn(v, round_bf16(load_f(b1, j))));
      if (act == kGelu) {
        out = gelu_tanh(v);
      } else {
        const float rl = fmaxf(v, 0.f);
        out = act == kRelu ? rl : __fmul_rn(rl, rl);
      }
    }
    y[(size_t)(row0 + r) * ffn + j] = __float2bfloat16(out);
  }
}

// ---------------------------------------------------------------------------
// fused_mlp_fc2_kernel: replaces kernel_gen.py _fused_mlp_fc2 (:1793, call
// :1834) and the fc2 half of _fused_mlp. Bound by the bytes of W2 (117.4 MB
// a llama3-8b layer). y [R, ffn] @ W2 over 128-column tiles of H, each tile
// split along the ffn contraction (9 blocks a tile at R 8 on llama3-8b).
// ---------------------------------------------------------------------------
template <int RB, typename TW, typename TV>
__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_fc2_kernel(GemmArgs<TV> a, const TW* w2, const float* w2_scale,
                     const TV* b2, const bf16* residual, bf16* out,
                     int n_cols) {
  extern __shared__ __align__(16) float smem[];
  const TW* base = w2 + blockIdx.x * kTile;
  const float* sbase = w2_scale == nullptr ? nullptr : w2_scale + blockIdx.x * kTile;
  if (!accumulate_tile<RB, TW, TV>(a, base, base + kHalfTile, sbase,
                                   sbase == nullptr ? nullptr : sbase + kHalfTile,
                                   n_cols, smem))
    return;
  residual_epilogue<RB, TV>(a, smem + kRegion, b2, residual, out, n_cols);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// Everything a launch needs, as the C launchers receive it.
struct Launch {
  const void *x, *norm_scale, *norm_bias;   // activations; norm parameters
  int norm;
  float eps;
  const void *w, *wkv, *bias, *kv_bias;     // weights and biases
  const void *w_scale, *kv_scale;           // int8 weights' column scales
  const void *q_ln, *k_ln, *cos, *sin;      // QKV only
  const void* residual;                     // out-projection and fc2
  void *out, *k_out, *v_out;                // outputs
  void* ws;
  void* counters;
  int rows, k, n;                           // n: output columns
  int nkv_cols, head_dim, rope_half, act;
  int ksplit;
  void* stream;
};

template <typename TV>
GemmArgs<TV> gemm_args(const Launch& l) {
  GemmArgs<TV> a;
  a.x = static_cast<const bf16*>(l.x);
  a.norm_scale = static_cast<const TV*>(l.norm_scale);
  a.norm_bias = static_cast<const TV*>(l.norm_bias);
  a.norm = l.norm;
  a.eps = l.eps;
  a.rows = l.rows;
  a.k = l.k;
  a.ws = static_cast<float*>(l.ws);
  a.counters = static_cast<int*>(l.counters);
  a.ksplit = l.ksplit;
  return a;
}

template <int RB, typename Kernel, typename... Args>
int launch(Kernel kernel, int tiles, const Launch& l, Args... args) {
  const size_t smem = smem_bytes(RB);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles, l.ksplit, (l.rows + RB - 1) / RB);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(l.stream)>>>(
      args...);
  return (int)cudaGetLastError();
}

template <int RB, typename TW, typename TV>
int launch_qkv(const Launch& l) {
  const int nq_cols = l.n - 2 * l.nkv_cols;
  return launch<RB>(
      fused_qkv_kernel<RB, TW, TV>, l.n / kTile, l, gemm_args<TV>(l),
      static_cast<const TW*>(l.w), static_cast<const TW*>(l.wkv),
      static_cast<const float*>(l.w_scale),
      static_cast<const float*>(l.kv_scale),
      static_cast<const TV*>(l.bias), static_cast<const TV*>(l.kv_bias),
      static_cast<const TV*>(l.q_ln), static_cast<const TV*>(l.k_ln),
      static_cast<const float*>(l.cos), static_cast<const float*>(l.sin),
      static_cast<bf16*>(l.out), static_cast<bf16*>(l.k_out),
      static_cast<bf16*>(l.v_out), nq_cols, l.nkv_cols, l.head_dim,
      l.rope_half);
}

template <int RB, typename TW, typename TV>
int launch_out_proj(const Launch& l) {
  return launch<RB>(fused_out_proj_kernel<RB, TW, TV>, l.n / kTile, l,
                    gemm_args<TV>(l), static_cast<const TW*>(l.w),
                    static_cast<const float*>(l.w_scale),
                    static_cast<const TV*>(l.bias),
                    static_cast<const bf16*>(l.residual),
                    static_cast<bf16*>(l.out), l.n);
}

template <int RB, typename TW, typename TV>
int launch_fc2(const Launch& l) {
  return launch<RB>(fused_mlp_fc2_kernel<RB, TW, TV>, l.n / kTile, l,
                    gemm_args<TV>(l), static_cast<const TW*>(l.w),
                    static_cast<const float*>(l.w_scale),
                    static_cast<const TV*>(l.bias),
                    static_cast<const bf16*>(l.residual),
                    static_cast<bf16*>(l.out), l.n);
}

template <int RB, typename TW, typename TV>
int launch_fc1(const Launch& l) {
  const bool gated = l.act == kSwiglu || l.act == kGeglu;
  return launch<RB>(fused_mlp_fc1_kernel<RB, TW, TV>,
                    l.n / (gated ? kHalfTile : kTile), l, gemm_args<TV>(l),
                    static_cast<const TW*>(l.w),
                    static_cast<const float*>(l.w_scale),
                    static_cast<const TV*>(l.bias), static_cast<bf16*>(l.out),
                    l.n, l.act);
}

bool bad_split(const Launch& l) {
  return l.rows < 1 || l.k < 8 || l.k % 8 != 0 || l.ksplit < 1 ||
         (l.ksplit > 1 && (l.ws == nullptr || l.counters == nullptr));
}

// Weight kinds: bf16 weights with bf16 norm scales and biases, fp32 with
// fp32, and resident int8 weights (with their fp32 column scales) beside
// bf16 or fp32 vectors.
enum WeightKind { kWeightBf16 = 0, kWeightF32 = 1, kWeightInt8 = 2 };

bool bad_kind(int weight_kind, int vector_f32, const void* w_scale) {
  if (weight_kind == kWeightInt8) return w_scale == nullptr;
  return weight_kind != (vector_f32 ? kWeightF32 : kWeightBf16) || w_scale != nullptr;
}

// One launcher template at the row block for the rows, over the four
// (weight, vector) type pairs.
template <template <int, typename, typename> class L>
int dispatch(const Launch& l, int weight_kind, int vector_f32) {
  const bool small = l.rows <= 8;
  if (weight_kind == kWeightBf16)
    return small ? L<8, bf16, bf16>::run(l) : L<32, bf16, bf16>::run(l);
  if (weight_kind == kWeightF32)
    return small ? L<8, float, float>::run(l) : L<32, float, float>::run(l);
  if (vector_f32)
    return small ? L<8, int8_t, float>::run(l) : L<32, int8_t, float>::run(l);
  return small ? L<8, int8_t, bf16>::run(l) : L<32, int8_t, bf16>::run(l);
}

template <int RB, typename TW, typename TV>
struct QkvL { static int run(const Launch& l) { return launch_qkv<RB, TW, TV>(l); } };
template <int RB, typename TW, typename TV>
struct OutProjL { static int run(const Launch& l) { return launch_out_proj<RB, TW, TV>(l); } };
template <int RB, typename TW, typename TV>
struct Fc1L { static int run(const Launch& l) { return launch_fc1<RB, TW, TV>(l); } };
template <int RB, typename TW, typename TV>
struct Fc2L { static int run(const Launch& l) { return launch_fc2<RB, TW, TV>(l); } };

}  // namespace

// Each launcher returns a cudaError_t code (0 = launched). Row blocks hold 8
// rows when rows <= 8, else 32 (more rows: one grid.z chunk per 32). Every
// pointer is a device pointer (biases, norm parameters and rope tables may be
// null). weight_kind: 0 bf16 weights, 1 fp32, 2 resident int8 with fp32
// per-output-column scales (w_scale [n], kv_scale [2 nkv_cols]; null for the
// other kinds); vector_f32: the norm parameters and biases are fp32 (else
// bf16; kinds 0 and 1 take vectors of their own dtype). Activations and
// outputs bf16; cos/sin fp32 [rows, rope_half]. ws holds tiles * row chunks
// * ksplit * RB * 128 floats and counters tiles * row chunks zeroed ints
// when ksplit > 1 (the kernels leave them zero).

// x [rows, hidden]; wq [hidden, nq_cols]; wkv [hidden, 2 nkv_cols] ([K | V]);
// q [rows, nq_cols], k and v [rows, nkv_cols].
extern "C" int fused_qkv_launch(
    const void* x, const void* ln_scale, const void* ln_bias, int norm,
    float eps, const void* wq, const void* wkv, const void* q_scale,
    const void* kv_scale, const void* q_bias, const void* kv_bias,
    const void* q_ln, const void* k_ln, const void* cos, const void* sin,
    void* q, void* k, void* v, void* ws, void* counters, int rows, int hidden,
    int nq_cols, int nkv_cols, int head_dim, int rope_half, int weight_kind,
    int vector_f32, int ksplit, void* stream) {
  Launch l = {};
  l.x = x; l.norm_scale = ln_scale; l.norm_bias = ln_bias; l.norm = norm;
  l.eps = eps; l.w = wq; l.wkv = wkv; l.bias = q_bias; l.kv_bias = kv_bias;
  l.w_scale = q_scale; l.kv_scale = kv_scale;
  l.q_ln = q_ln; l.k_ln = k_ln; l.cos = cos; l.sin = sin;
  l.out = q; l.k_out = k; l.v_out = v; l.ws = ws; l.counters = counters;
  l.rows = rows; l.k = hidden; l.n = nq_cols + 2 * nkv_cols;
  l.nkv_cols = nkv_cols; l.head_dim = head_dim; l.rope_half = rope_half;
  l.ksplit = ksplit; l.stream = stream;
  if (bad_split(l) || norm < kNormRms || norm > kNormLayer ||
      (head_dim != 64 && head_dim != 128) || nq_cols % kTile != 0 ||
      nkv_cols % kTile != 0 || rope_half < 0 || 2 * rope_half > head_dim ||
      (cos != nullptr && rope_half == 0) || (q_ln == nullptr) != (k_ln == nullptr) ||
      bad_kind(weight_kind, vector_f32, q_scale) ||
      (q_scale == nullptr) != (kv_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  return dispatch<QkvL>(l, weight_kind, vector_f32);
}

// fc2 == 0: the out-projection (x = attn_flat [rows, k], w = W_o [k, n]);
// fc2 == 1: the MLP's second half (x = y [rows, k = ffn], w = W2 [k, n]).
// residual and out [rows, n].
extern "C" int fused_residual_gemm_launch(
    int fc2, const void* x, const void* w, const void* w_scale,
    const void* bias, const void* residual, void* out, void* ws,
    void* counters, int rows, int k, int n, int weight_kind, int vector_f32,
    int ksplit, void* stream) {
  Launch l = {};
  l.x = x; l.w = w; l.w_scale = w_scale; l.bias = bias; l.residual = residual;
  l.out = out; l.ws = ws; l.counters = counters; l.rows = rows; l.k = k;
  l.n = n; l.ksplit = ksplit; l.stream = stream; l.norm = kNormNone;
  if (bad_split(l) || n % kTile != 0 || n < kTile ||
      bad_kind(weight_kind, vector_f32, w_scale))
    return (int)cudaErrorInvalidValue;
  if (fc2) return dispatch<Fc2L>(l, weight_kind, vector_f32);
  return dispatch<OutProjL>(l, weight_kind, vector_f32);
}

// x [rows, hidden]; w1 [hidden, ffn] or, gated, [hidden, 2 ffn] ([gate |
// value]), w1_scale its column scales; y [rows, ffn].
extern "C" int fused_mlp_fc1_launch(
    const void* x, const void* ln_scale, const void* ln_bias, int norm,
    float eps, const void* w1, const void* w1_scale, const void* b1, void* y,
    void* ws, void* counters, int rows, int hidden, int ffn, int act,
    int weight_kind, int vector_f32, int ksplit, void* stream) {
  Launch l = {};
  l.x = x; l.norm_scale = ln_scale; l.norm_bias = ln_bias; l.norm = norm;
  l.eps = eps; l.w = w1; l.w_scale = w1_scale; l.bias = b1; l.out = y;
  l.ws = ws; l.counters = counters; l.rows = rows; l.k = hidden; l.n = ffn;
  l.act = act; l.ksplit = ksplit; l.stream = stream;
  const bool gated = act == kSwiglu || act == kGeglu;
  if (bad_split(l) || norm < kNormRms || norm > kNormLayer || act < kSwiglu ||
      act > kSquaredRelu || ffn < kTile || ffn % (gated ? kHalfTile : kTile) != 0 ||
      bad_kind(weight_kind, vector_f32, w1_scale))
    return (int)cudaErrorInvalidValue;
  return dispatch<Fc1L>(l, weight_kind, vector_f32);
}
