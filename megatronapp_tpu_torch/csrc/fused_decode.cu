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
// fc2 a layer; resident int8 halves them); at R = 32 too (64 FLOPs per
// weight), since the products run on the tensor cores. Every kernel's
// block owns a tile of 128 output columns (QKV: one or two whole heads, so
// QK-norm and rope stay in the block; gated fc1: 64 gate and the 64
// matching value columns), read as two 64-column weight segments. Tiles
// too few for the card (out-projection and fc2: 32; QKV: 48) are split
// along K across blocks: grid.y = ksplit blocks per tile, each writing
// its fp32 partial tile to a workspace. The last block of a tile to
// finish (an atomic count on a per-tile counter, not on any sum) adds the
// partials in split order 0..ksplit-1, runs the epilogue and resets the
// counter. Inside a block every sum runs in a fixed order too, so a rerun
// repeats every bit and a row's bits never depend on the other rows: no
// atomics in the sums.
//
// One core sums every kernel's tile: the tensor-core tile core (mma_tile).
// - Products: mma.sync m16n8k16 on bf16 operands with fp32 accumulators
//   (tensor_core.cuh). The operands are the bf16 values the fp32 bodies
//   multiply (bf16(norm(x)), attn_flat or y; bf16 weights, int8 and fp32
//   ones made bf16 as _dequant_weight does), so only the order of the fp32
//   sums differs. Warp w owns columns 16w..16w+15 of the tile over all of
//   the split's k's, so each output is summed in k order by one warp with
//   no cross-warp reduction (gated fc1: warps 0-3 sum gate columns, 4-7
//   value columns). The weight columns are the mma's M side and the rows
//   its N side (8 rows fill an n8 block, 32 rows four).
// - Weights: a ring of kStages stages of kStageK k-major weight rows
//   (16-byte cp.async, rows padded by 16 bytes), kStages - 1 stages in
//   flight while one is multiplied. bf16 stages are read in place with
//   ldmatrix .trans; int8 and fp32 stages first become a bf16 tile (int8:
//   bf16(float(q) * scale[col]) two values at a time, float(q) formed
//   exactly from q's bits at full rate, the thread's 16 column scales held
//   in registers; fp32: rounded to bf16). At 32-row blocks the int8
//   normalising kernels (QKV, fc1) spill a few words at the 128-register
//   limit; scales moved to shared memory to free registers ran slower.
// - Activations ride in the same ring, raw bf16 [row][k]. QKV and fc1
//   normalise a landed stage in place through row_norm.cuh's arithmetic
//   (the bits the LoRA shrink reads), with the norm's scale and bias
//   staged in the ring beside it. At 32-row blocks the rows' norm
//   statistics are computed once a launch by its first blocks and shared
//   through the workspace (shared_row_stats); at 8-row blocks each block
//   computes its own from the whole x row (L2-resident).
// - Each split owns a whole number of ring stages: one split plan for
//   every kernel (ops/cuda/fused_decode.py tile_split_plan), as many
//   splits as fill two blocks an SM in one wave.
// The y [R, ffn] that fc1 writes and fc2 reads is never staged whole
// (917 KB at R = 32): fc2 streams it through the ring beside W2, 128 k's
// a stage, like any other input.

// LoRA epilogue (template flag LORA; the off path compiles as before).
// Replaces the epilogue of the same TPU kernels with lora= (kernel_gen.py
// _lora_epilogue :1130 in the bodies at :1242-1245, :1552-1554,
// :1672-1683): each row r adds delta = bf16(t_r @ B[s_r]) to its base sum
// after the sum's bf16 rounding and before the bias, where t_r = x_r @
// A[s_r] is formed from the same input the base product reads (the normed
// xn of QKV and fc1, attn_flat of the out-projection, the activated y of
// fc2), with A [slots, K, rank] and B [slots, rank, N] one layer's fp32
// banks (inference/lora.py) indexed by each row's slot id s_r (0: the NULL
// adapter, a delta of exactly +0.0, no bank read). JAX gathers per-row
// factors outside its kernels (_lora_gathered :1928); at a 32-row prefill
// chunk the gathered fc1 B factors alone are 32 x 8 x 28672 x 4 B = 29 MB
// a layer, so these kernels read the banks in place through the slot ids.
// t is not formed here: the shrink kernel (lora.cu lora_shrink_kernel)
// forms it once a layer, spread over the card, launched by the wrapper on
// the same stream just before this kernel (its bf16(norm(x)) is this
// kernel's, row_norm.cuh). Only the block that finishes a tile reads it:
// its rows' t [RB, rank] and, for each distinct adapter among its rows,
// the tile's 128 columns of B[s], copied into shared memory with 16-byte
// cp.async (the front region, free once the tile is summed), then
// delta = t_r . B[s_r][:, column] in rank order. The extra bytes are
// 128 x rank floats of B per distinct adapter and a tile, beside the
// weights' 32-128 KB of a tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "row_norm.cuh"
#include "tensor_core.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;               // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;                  // virtual output columns a block
constexpr int kHalfTile = kTile / 2;        // one weight segment
constexpr int kRegion = 16384;              // floats: the front region (LoRA epilogue)

using rn::kNormLayer;
using rn::kNormNone;
using rn::kNormRms;
using rn::load_f;
using rn::round_bf16;
using rn::warp_sum;
enum Act { kSwiglu = 0, kGeglu = 1, kGelu = 2, kRelu = 3, kSquaredRelu = 4 };

template <typename TV>
struct GemmArgs {
  const bf16* x;          // [rows, k] activations
  const TV* norm_scale;   // [k] (kNormNone: unused)
  const TV* norm_bias;    // [k] or null (layernorm bias)
  int norm;
  float eps;
  int rows, k;
  float* ws;              // [tiles * row chunks, ksplit, RB, kTile] partials,
                          // then [row chunks][2 RB] shared norm statistics
  int* counters;          // [tiles * row chunks], then 2 a row chunk; zero
                          // between launches
  int ksplit;
};

constexpr int kMaxRank = 32;                // LoRA rank limit

// The LoRA epilogue's operands for one target (ids == nullptr: none).
struct LoraArgs {
  const float* t;     // [rows, rank] t = x @ A[slot] of each row (lora_shrink)
  const float* b;     // B bank [slots, rank, ldb]
  const int* ids;     // [rows] bank slot of each row (0: the NULL adapter)
  int rank, ldb;
  int b0, b1;         // B columns of virtual columns 0 and kHalfTile
};

// The finishing block's LoRA deltas dl [RB][kTile] (row r, virtual column
// vc: t_r . B[s_r][:, column of vc], fp32 in rank order; exactly 0 for the
// NULL adapter and for rows past `rows`), built in the front region of
// shared memory, which is free once the tile is summed: the rows' t, the
// distinct adapters among the rows in first-occurrence order (one warp,
// lane r on row r: __match_any_sync groups the rows of one slot, the
// group's lowest lane leads it), then the tile's 128 columns of B for as
// many distinct adapters at once as the region holds (16-byte cp.async;
// one pass at rank 8), each row's deltas from its adapter's copy. The
// kernel is launched with programmatic stream serialization after the
// shrink, which lets it start while the shrink runs: only here, in the
// finishing block, does it wait for the shrink's t (tc::pdl_wait). Before
// that wait a block writes only the split workspace and counters, which
// the wrappers allocate before they launch the shrink (tensor_core.cuh's
// rule); the outputs are written after it. Returns dl.
template <int RB>
__device__ const float* lora_tile_delta(const LoraArgs& la, float* smem,
                                        int row0, int rows) {
  static_assert(RB <= 32, "one lane a row");
  constexpr int kC4 = kTile / 4;                  // 16-byte pieces of a B row
  float* dl = smem;                               // [RB][kTile]
  float* ts = dl + RB * kTile;                    // [RB][rank]
  int* pos_s = reinterpret_cast<int*>(ts + RB * kMaxRank);   // [RB] index in dslot, -1: NULL
  int* dslot = pos_s + RB;                        // [RB] distinct adapters
  int* nd_s = dslot + RB;                         // 2 RB ints: bs 16-byte aligned
  float* bs = reinterpret_cast<float*>(nd_s + 2 * RB);  // [cap][rank][kTile]
  const int tid = threadIdx.x;
  const int rank = la.rank;
  const int cap = (kRegion - (int)(bs - smem)) / (rank * kTile);
  tc::pdl_wait();   // t comes from the shrink launched just before
  if (tid < 32) {
    const int slot = tid < rows ? la.ids[row0 + tid] : 0;
    const unsigned same = __match_any_sync(0xffffffffu, slot);
    const int leader = __ffs(same) - 1;
    const unsigned leaders = __ballot_sync(0xffffffffu, slot != 0 && leader == tid);
    if (slot != 0 && leader == tid) dslot[__popc(leaders & ((1u << tid) - 1))] = slot;
    if (tid < RB) pos_s[tid] = slot == 0 ? -1 : __popc(leaders & ((1u << leader) - 1));
    if (tid == 0) *nd_s = __popc(leaders);
  }
  for (int i = tid; i < RB * rank; i += kThreads)
    ts[i] = i / rank < rows ? la.t[(size_t)row0 * rank + i] : 0.f;
  for (int i = tid; i < RB * kTile; i += kThreads) dl[i] = 0.f;
  __syncthreads();
  const int nd = *nd_s;
  for (int d0 = 0; d0 < nd; d0 += cap) {
    const int dn = min(cap, nd - d0);
    for (int i = tid; i < dn * rank * kC4; i += kThreads) {
      const int vc = (i % kC4) * 4, j = (i / kC4) % rank, e = i / (kC4 * rank);
      const int col = vc < kHalfTile ? la.b0 + vc : la.b1 + (vc - kHalfTile);
      tc::cp_async_16(bs + (e * rank + j) * kTile + vc,
                      la.b + ((size_t)dslot[d0 + e] * rank + j) * la.ldb + col, true);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    for (int i = tid; i < rows * kTile; i += kThreads) {
      const int r = i / kTile, e = pos_s[r] - d0;
      if (e < 0 || e >= dn) continue;   // NULL rows and other passes' adapters
      const float* b = bs + e * rank * kTile + i % kTile;
      const float* t = ts + r * rank;
      float d = 0.f;
#pragma unroll 8
      for (int j = 0; j < rank; ++j) d = fmaf(t[j], b[j * kTile], d);
      dl[i] = d;
    }
    __syncthreads();
  }
  return dl;
}

// v (a rounded base sum) + bf16(delta), rounded: q + d.astype(cdt).
__device__ __forceinline__ float add_delta(float v, float d) {
  return round_bf16(__fadd_rn(v, round_bf16(d)));
}

// ---------------------------------------------------------------------------
// The tensor-core tile core of every kernel here.
// ---------------------------------------------------------------------------

constexpr int kStageK = 128;      // k's a ring stage
constexpr int kStages = 2;        // ring stages (kStages - 1 in flight)
constexpr int kSharedStatsRb = 32;  // row blocks from which QKV and fc1 share their norm statistics
constexpr int kXld = kStageK + 8;  // x ring row stride (bf16): a 16-byte pad
constexpr int kWld = kTile + 8;    // bf16 weight tile row stride
static_assert(kStageK % 32 == 0, "a stage holds whole pairs of k16 steps");

// Shared memory of mma_tile (bytes): the ring (weights as stored, x, the
// norm's scale and bias), the bf16 tile of a converted weight stage; after
// the loop the same front region is the LoRA epilogue's (at least kRegion
// floats), then the finished tile and the rows' statistics.
template <int RB, typename TW, typename TV>
struct Ring {
  static constexpr int kWRow = kTile * (int)sizeof(TW) + 16;       // a weight row
  static constexpr int kW = kStages * kStageK * kWRow;
  static constexpr int kX = kStages * RB * kXld * 2;
  static constexpr int kV = kStages * 2 * kStageK * (int)sizeof(TV);
  static constexpr int kT = std::is_same<TW, bf16>::value ? 0 : kStageK * kWld * 2;
  static constexpr int kUsed = kW + kX + kV + kT;
  static constexpr int kFront = kUsed > kRegion * 4 ? kUsed : kRegion * 4;
  static constexpr size_t kSmem = kFront + (size_t)(RB * kTile + 2 * RB + 4) * sizeof(float);
};

// The norm statistics of a row of x, as every normalising kernel here
// forms them: one warp, row_norm.cuh's sums (8 pieces a lane loaded at
// once: the same bits); mean (layernorm) and 1 / sqrt(mean((x - mean)^2)
// + eps).
template <typename TV>
__device__ __forceinline__ void row_stats(const GemmArgs<TV>& a, int row, int lane,
                                          float& mean, float& rstd) {
  float ss;
  rn::row_moments<8>(a.x + (size_t)row * a.k, a.k, a.norm, lane, mean, ss);
  rstd = rn::row_rstd(ss, a.k, a.eps);
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

constexpr long long kStatsWait = 1ll << 16;   // cycles a block waits for shared statistics

// Shared statistics, once a launch (row blocks of kSharedStatsRb rows or
// more, given the workspace and counters: a K split brings them, and the
// wrappers pass them to a normalising kernel without one too): the
// blocks of split 0 whose tile index x is below the chunk's row count
// compute rows x, x + tiles, ... (a warp a row) into the workspace past
// the partial tiles (if any) and count them on the chunk's ready counter
// (counters past the tiles'). These writers are the launch's first
// blocks, so they run ahead of the blocks that wait.
template <int RB, typename TV>
__device__ __forceinline__ bool stats_writer(const GemmArgs<TV>& a, int rows) {
  return RB >= kSharedStatsRb && a.ws != nullptr && blockIdx.y == 0 && (int)blockIdx.x < rows;
}

template <int RB, typename TV>
__device__ float* stats_slots(const GemmArgs<TV>& a) {
  const size_t parts = a.ksplit > 1 ? (size_t)gridDim.x * gridDim.z * a.ksplit * RB * kTile : 0;
  return a.ws + parts + (size_t)blockIdx.z * 2 * RB;
}

template <int RB, typename TV>
__device__ void write_row_stats(const GemmArgs<TV>& a, int row0, int rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* st = stats_slots<RB>(a);
  int* ready = a.counters + gridDim.x * gridDim.z + blockIdx.z;
  for (int r = blockIdx.x + warp * gridDim.x; r < rows; r += kWarps * gridDim.x) {
    float mean, rstd;
    row_stats(a, row0 + r, lane, mean, rstd);
    if (lane == 0) {
      st[r] = mean;
      st[RB + r] = rstd;
      __threadfence();
      atomicAdd(ready, 1);
    }
  }
}

// The rows' statistics into mean_s / rstd_s. Below kSharedStatsRb rows or
// without a workspace each block computes them. With one, a block takes
// the shared ones once the chunk's ready count reaches its rows, waiting
// at most kStatsWait cycles; past that (writers not yet running) it
// computes them itself: the same bits, so nothing waits on a block that
// cannot run. The chunk's last block to take them resets both of the
// chunk's counters.
template <int RB, typename TV>
__device__ void shared_row_stats(const GemmArgs<TV>& a, int row0, int rows,
                                 float* mean_s, float* rstd_s, int* flag_s) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  auto own = [&] {
    for (int r = warp; r < rows; r += kWarps) {
      float mean, rstd;
      row_stats(a, row0 + r, lane, mean, rstd);
      if (lane == 0) {
        mean_s[r] = mean;
        rstd_s[r] = rstd;
      }
    }
  };
  if (RB < kSharedStatsRb || a.ws == nullptr) {
    own();
    __syncthreads();
    return;
  }
  int* ready = a.counters + gridDim.x * gridDim.z + blockIdx.z;
  int* readers = ready + gridDim.z;
  if (tid == 0) {
    const long long t0 = clock64();
    int n = load_acquire(ready);
    while (n < rows && clock64() - t0 < kStatsWait) {
      __nanosleep(64);
      n = load_acquire(ready);
    }
    *flag_s = n >= rows;
  }
  __syncthreads();
  if (*flag_s) {
    const float* st = stats_slots<RB>(a);
    if (tid < rows) {
      mean_s[tid] = __ldcg(st + tid);
      rstd_s[tid] = __ldcg(st + RB + tid);
    }
  } else {
    own();
  }
  __syncthreads();
  if (tid == 0 && atomicAdd(readers, 1) == (int)(gridDim.x * gridDim.y) - 1) {
    atomicExch(ready, 0);
    atomicExch(readers, 0);
  }
}

// mma_tile's K-split finish, once the block's partial sums [RB][kTile]
// are whole in `tile`: with ksplit > 1 the block writes its partial to the
// workspace, and the last of the tile's blocks to finish (an atomic count
// on the tile's counter) adds the partials in split order 0..ksplit-1
// into `tile` and resets the counter. A thread owns whole float4s and
// issues the loads of several splits before it adds them in order.
// Returns true in the block that then holds the finished sums (every block
// when ksplit == 1) and false in the others, which exit.
template <int RB, typename TV>
__device__ bool finish_tile(const GemmArgs<TV>& a, float* tile, int* flag_s) {
  constexpr int kPart = RB * kTile / 4;        // float4s of a partial tile
  constexpr int kV = kPart / kThreads;         // a thread's: 1 (RB 8) or 4 (RB 32)
  constexpr int kBatch = 8 / kV;               // splits whose loads fly together
  static_assert(kPart % kThreads == 0, "whole float4s a thread");
  const int tid = threadIdx.x;
  const int unit = blockIdx.z * gridDim.x + blockIdx.x;
  if (a.ksplit > 1) {
    float4* part = reinterpret_cast<float4*>(a.ws + (size_t)unit * a.ksplit * RB * kTile);
    float4* t4 = reinterpret_cast<float4*>(tile);
#pragma unroll
    for (int j = 0; j < kV; ++j)
      part[(size_t)blockIdx.y * kPart + j * kThreads + tid] = t4[j * kThreads + tid];
    __threadfence();
    __syncthreads();
    if (tid == 0) *flag_s = atomicAdd(a.counters + unit, 1) == a.ksplit - 1;
    __syncthreads();
    if (!*flag_s) return false;
    __threadfence();
    float4 s[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) s[j] = __ldcg(part + j * kThreads + tid);
    for (int sp0 = 1; sp0 < a.ksplit; sp0 += kBatch) {
      float4 v[kBatch][kV];
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
#pragma unroll
        for (int j = 0; j < kV; ++j)
          if (sp0 + b < a.ksplit) v[b][j] = __ldcg(part + (size_t)(sp0 + b) * kPart + j * kThreads + tid);
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (sp0 + b < a.ksplit) {
#pragma unroll
          for (int j = 0; j < kV; ++j) {
            s[j].x += v[b][j].x;
            s[j].y += v[b][j].y;
            s[j].z += v[b][j].z;
            s[j].w += v[b][j].w;
          }
        }
    }
#pragma unroll
    for (int j = 0; j < kV; ++j) t4[j * kThreads + tid] = s[j];
    if (tid == 0) a.counters[unit] = 0;
  }
  __syncthreads();
  return true;
}

// Sums this block's [RB, kTile] tile of A @ W over its k split on the
// tensor cores, A = bf16(norm(x)) (NORM: QKV and fc1) or x itself (the
// out-projection and fc2):
// virtual columns 0..63 read weight segment w0, 64..127 segment w1, both
// with row stride ldw; int8 weights take their columns' scales from s0
// and s1 (null otherwise). The split owns whole ring stages: ceil(stages /
// ksplit) of the k's ceil(k / kStageK) stages. Returns finish_tile's
// verdict, the finished fp32 sums in the tile past Ring::kFront.
template <int RB, typename TW, typename TV, bool NORM>
__device__ bool mma_tile(const GemmArgs<TV>& a, const TW* w0, const TW* w1,
                         const float* s0, const float* s1, size_t ldw, char* smem) {
  using R = Ring<RB, TW, TV>;
  constexpr bool kConvert = !std::is_same<TW, bf16>::value;
  constexpr int kSegPieces = kHalfTile * (int)sizeof(TW) / 16;   // 16 bytes a piece
  constexpr int kRowPieces = 2 * kSegPieces;                      // of a weight row
  constexpr int kPer = 16 / (int)sizeof(TW);                      // weights a piece
  constexpr int kVPer = 16 / (int)sizeof(TV);                     // vector values a piece
  constexpr int kAcc = RB / 8;                                    // n8 blocks of rows
  static_assert(RB % 8 == 0, "whole n8 blocks of rows");
  char* w_ring = smem;                                            // [kStages][kStageK][kWRow]
  bf16* x_ring = reinterpret_cast<bf16*>(smem + R::kW);           // [kStages][RB][kXld]
  TV* v_ring = reinterpret_cast<TV*>(smem + R::kW + R::kX);       // [kStages][scale, bias][kStageK]
  bf16* w_conv = reinterpret_cast<bf16*>(smem + R::kW + R::kX + R::kV);   // [kStageK][kWld]
  float* tile = reinterpret_cast<float*>(smem + R::kFront);       // [RB][kTile]
  float* mean_s = tile + RB * kTile;
  float* rstd_s = mean_s + RB;
  int* flag_s = reinterpret_cast<int*>(rstd_s + RB);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.z * RB;
  const int rows = min(RB, a.rows - row0);
  const int per = ((a.k + kStageK - 1) / kStageK + a.ksplit - 1) / a.ksplit;
  const int k_begin = min(a.k, (int)blockIdx.y * per * kStageK);
  const int k_end = min(a.k, k_begin + per * kStageK);
  const int nst = (k_end - k_begin + kStageK - 1) / kStageK;
  constexpr bool norm = NORM;

  // Stage c's copies: its weight rows (both segments), x's rows and the
  // norm's vectors over its k's; rows past k_end and x rows past `rows`
  // are zero-filled.
  auto load = [&](int c) {
    const int st = c % kStages, k0 = k_begin + c * kStageK;
    char* wd = w_ring + st * kStageK * R::kWRow;
    for (int i = tid; i < kStageK * kRowPieces; i += kThreads) {
      const int r = i / kRowPieces, q = i % kRowPieces, k = k0 + r;
      const bool live = k < k_end;
      const TW* src = (q < kSegPieces ? w0 : w1) + (q % kSegPieces) * kPer;
      tc::cp_async_16(wd + r * R::kWRow + q * 16, live ? src + (size_t)k * ldw : w0, live);
    }
    bf16* xd = x_ring + st * RB * kXld;
    for (int i = tid; i < RB * (kStageK / 8); i += kThreads) {
      const int r = i / (kStageK / 8), c8 = (i % (kStageK / 8)) * 8, k = k0 + c8;
      const bool live = r < rows && k < k_end;
      tc::cp_async_16(xd + r * kXld + c8,
                      live ? a.x + (size_t)(row0 + r) * a.k + k : a.x, live);
    }
    if (norm) {
      for (int i = tid; i < 2 * (kStageK / kVPer); i += kThreads) {
        const int v = i / (kStageK / kVPer), c = (i % (kStageK / kVPer)) * kVPer;
        const TV* src = v == 0 ? a.norm_scale : a.norm_bias;
        const bool live = src != nullptr && k0 + c < k_end;
        tc::cp_async_16(v_ring + (st * 2 + v) * kStageK + c, live ? src + k0 + c : a.norm_scale,
                        live);
      }
    }
  };
  // The rows' norm statistics (shared_row_stats): the blocks that compute
  // them for the launch read x before they ask for their first stages;
  // the others take them while their first stages land.
  if (norm && stats_writer<RB>(a, rows)) write_row_stats<RB>(a, row0, rows);
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nst) load(c);
    tc::cp_async_commit();   // empty groups keep the count uniform
  }
  if (norm) shared_row_stats<RB>(a, row0, rows, mean_s, rstd_s, flag_s);

  // int8: the 16 column scales of this thread's piece of a weight row.
  const int piece = tid % kRowPieces;
  float sc[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) sc[e] = 1.f;
  if constexpr (std::is_same<TW, int8_t>::value) {
    const int vc = piece * kPer;
    const float* sp = vc < kHalfTile ? s0 + vc : s1 + (vc - kHalfTile);
#pragma unroll
    for (int e = 0; e < kPer; ++e) sc[e] = sp[e];
  }

  float acc[kAcc][4];
#pragma unroll
  for (int j = 0; j < kAcc; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int col = 16 * warp;   // this warp's columns of the tile

  for (int c = 0; c < nst; ++c) {
    const int st = c % kStages, k0 = k_begin + c * kStageK;
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();   // stage c has landed; every warp is done with stage c - 1
    if (c + kStages - 1 < nst) load(c + kStages - 1);
    tc::cp_async_commit();
    bf16* xs = x_ring + st * RB * kXld;
    if (norm) {
      // bf16(norm(x)) in place, two values at a time (pieces past k_end and
      // rows past `rows` stay zero).
      const TV* vs = v_ring + st * 2 * kStageK;
      const bool has_bias = a.norm_bias != nullptr;
      for (int i = tid; i < rows * (kStageK / 8); i += kThreads) {
        const int r = i / (kStageK / 8), c8 = (i % (kStageK / 8)) * 8;
        if (k0 + c8 >= k_end) continue;
        uint4* px = reinterpret_cast<uint4*>(xs + r * kXld + c8);
        uint4 raw = *px;
        uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
        const float mean = mean_s[r], rstd = rstd_s[r];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
          const int k = c8 + 2 * e;
          const float y0 = rn::norm_value(f.x, mean, rstd, rn::load_f(vs, k), has_bias,
                                          has_bias ? rn::load_f(vs + kStageK, k) : 0.f);
          const float y1 = rn::norm_value(f.y, mean, rstd, rn::load_f(vs, k + 1), has_bias,
                                          has_bias ? rn::load_f(vs + kStageK, k + 1) : 0.f);
          w[e] = tc::pack_bf16(y0, y1);
        }
        *px = raw;
      }
    }
    const char* wst = w_ring + st * kStageK * R::kWRow;
    const bf16* ws = reinterpret_cast<const bf16*>(wst);
    if constexpr (kConvert) {
      // The landed stage as a bf16 tile, two weights at a time.
      for (int r = tid / kRowPieces; r < kStageK; r += kThreads / kRowPieces) {
        const uint4 raw = *reinterpret_cast<const uint4*>(wst + r * R::kWRow + piece * 16);
        uint32_t o[kPer / 2];
        if constexpr (std::is_same<TW, int8_t>::value) {
          // float(q) exactly, without the quarter-rate int-to-float
          // conversion: with u = q + 128 (the sign bit flipped), the
          // float whose bits are 0x4B000000 | u is 2^23 + u, and
          // subtracting 2^23 + 128 leaves q.
          const uint32_t* wq = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
          for (int e = 0; e < kPer / 2; ++e) {
            const uint32_t u = wq[e / 2] ^ 0x80808080u;
            const int b = 2 * (e % 2);
            const float q0 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + b)),
                                       8388736.f);
            const float q1 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441 + b)),
                                       8388736.f);
            o[e] = tc::pack_bf16(__fmul_rn(q0, sc[2 * e]), __fmul_rn(q1, sc[2 * e + 1]));
          }
        } else {
          const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
          for (int e = 0; e < kPer / 2; ++e) o[e] = tc::pack_bf16(f[2 * e], f[2 * e + 1]);
        }
        uint32_t* dst = reinterpret_cast<uint32_t*>(w_conv + r * kWld + piece * kPer);
#pragma unroll
        for (int e = 0; e < kPer / 2; e += 2)
          *reinterpret_cast<uint2*>(dst + e) = make_uint2(o[e], o[e + 1]);
      }
      ws = w_conv;
    }
    if (norm || kConvert) __syncthreads();   // the stage's operands are whole

#pragma unroll
    for (int kk = 0; kk < kStageK; kk += 32) {
      // B: x^T, k16 steps kk and kk + 16 of each 8-row block.
      uint32_t bx[RB / 8][4];
#pragma unroll
      for (int nb = 0; nb < RB / 8; ++nb)
        tc::ldmatrix_x4(bx[nb], xs + (8 * nb + (lane & 7)) * kXld + kk + (lane >> 3) * 8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // A: the warp's 16 columns x k16 of W (k-major), transposed.
        uint32_t r[4];
        tc::ldmatrix_x4_trans(r, ws + tc::bt_off(lane, kk + 16 * h, col, kWld));
        const uint32_t af[4] = {r[0], r[2], r[1], r[3]};
#pragma unroll
        for (int nb = 0; nb < RB / 8; ++nb)
          tc::mma_bf16(acc[nb], af, bx[nb][2 * h], bx[nb][2 * h + 1]);
      }
    }
  }
  tc::cp_async_wait<0>();   // only empty groups are left

  // The warp's sums into the tile (fragment layouts: tensor_core.cuh).
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {   // acc[j]: columns col + g (+ 8), rows 8j + 2t (+ 1)
    float* o = tile + (8 * j + 2 * t) * kTile + col + g;
    o[0] = acc[j][0];
    o[kTile] = acc[j][1];
    o[8] = acc[j][2];
    o[kTile + 8] = acc[j][3];
  }
  __syncthreads();
  return finish_tile<RB>(a, tile, flag_s);
}

// ---------------------------------------------------------------------------
// fused_qkv_kernel: replaces kernel_gen.py _fused_qkv (:1143), both its
// no-grid (:1261) and kv-head-group (:1357) emissions. Bound by the bytes of
// Wq and the packed [K | V] weight (50.3 MB a llama3-8b layer). A block owns
// 128 columns of [Wq | Wkv], the weights as they are stored (kv_kernel keeps
// its [K | V] packing): one head at D 128, two at D 64, so that QK-norm and
// rope run in the block on the finished sums; the tile's K split
// (tile_split_plan) fills the card. Sums on mma_tile.
// ---------------------------------------------------------------------------
template <int RB, typename TW, typename TV, bool LORA>
__global__ void __launch_bounds__(kThreads, 2)
fused_qkv_kernel(GemmArgs<TV> a, const TW* wq, const TW* wkv,
                 const float* q_scale, const float* kv_scale,
                 const TV* q_bias, const TV* kv_bias, const TV* q_ln,
                 const TV* k_ln, const float* cos, const float* sin,
                 bf16* q_out, bf16* k_out, bf16* v_out, int nq_cols,
                 int nkv_cols, int head_dim, int rope_half, LoraArgs lq,
                 LoraArgs lkv) {
  extern __shared__ __align__(16) float smem[];
  const int col0 = blockIdx.x * kTile;
  const bool is_q = col0 < nq_cols;
  const TW* base = is_q ? wq + col0 : wkv + (col0 - nq_cols);
  // The scales of the tile's columns: q's, or [K | V]'s by the same column.
  const float* sbase = q_scale == nullptr ? nullptr
      : is_q ? q_scale + col0 : kv_scale + (col0 - nq_cols);
  const size_t ldw = is_q ? nq_cols : 2 * nkv_cols;
  if (!mma_tile<RB, TW, TV, true>(a, base, base + kHalfTile, sbase,
                                  sbase == nullptr ? nullptr : sbase + kHalfTile, ldw,
                                  reinterpret_cast<char*>(smem)))
    return;

  float* tile = smem + Ring<RB, TW, TV>::kFront / sizeof(float);
  const int row0 = blockIdx.z * RB;
  const int rows = min(RB, a.rows - row0);
  const float* dl = nullptr;   // LORA: the rows' deltas [RB][kTile]
  if constexpr (LORA) {   // the tile's adapter: q's factors, or [K | V]'s by the same column
    LoraArgs la = is_q ? lq : lkv;
    la.b0 = is_q ? col0 : col0 - nq_cols;
    la.b1 = la.b0 + kHalfTile;
    dl = lora_tile_delta<RB>(la, smem, row0, rows);
  }
  // 0: q, 1: k, 2: v; bias0 indexes q_bias or the packed kv_bias.
  const int region = is_q ? 0 : (col0 - nq_cols < nkv_cols ? 1 : 2);
  const int bias0 = is_q ? col0 : col0 - nq_cols;
  const int out0 = region == 2 ? col0 - nq_cols - nkv_cols : bias0;
  const TV* bias = is_q ? q_bias : kv_bias;

  // Thread t owns columns c..c+3 (c = 4 (t % kG)) of rows t / kG + kRowsPer j;
  // its global loads (bias, rope tables) are issued before they are used.
  constexpr int kG = kTile / 4, kRowsPer = kThreads / kG, kN = RB / kRowsPer;
  const int c = 4 * (threadIdx.x % kG), r0 = threadIdx.x / kG;
  float bv[4] = {0.f, 0.f, 0.f, 0.f};
  if (bias != nullptr)
#pragma unroll
    for (int e = 0; e < 4; ++e) bv[e] = round_bf16(load_f(bias, bias0 + c + e));
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int r = r0 + kRowsPer * j;
    float4* tp = reinterpret_cast<float4*>(tile + r * kTile + c);
    float4 t4 = *tp;
    float* v = reinterpret_cast<float*>(&t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = round_bf16(v[e]);
      if constexpr (LORA) v[e] = add_delta(v[e], dl[r * kTile + c + e]);
      if (bias != nullptr) v[e] = round_bf16(__fadd_rn(v[e], bv[e]));
    }
    *tp = t4;
  }
  __syncthreads();

  if (region < 2 && q_ln != nullptr) {   // QK-RMSnorm, one warp a (row, head)
    const TV* scale = region == 0 ? q_ln : k_ln;
    const int heads = kTile / head_dim;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float sc[kTile / 32];   // the lane's scale values, d = lane + 32 m
#pragma unroll
    for (int m = 0; m < kTile / 32; ++m)
      sc[m] = lane + 32 * m < head_dim ? load_f(scale, lane + 32 * m) : 0.f;
    for (int t = warp; t < rows * heads; t += kWarps) {
      float* h = tile + (t / heads) * kTile + (t % heads) * head_dim;
      float ss = 0.f;
#pragma unroll
      for (int m = 0; m < kTile / 32; ++m) {
        const int d = lane + 32 * m;
        if (d < head_dim) ss = __fadd_rn(ss, __fmul_rn(h[d], h[d]));
      }
      ss = warp_sum(ss);
      const float rstd = 1.f / sqrtf(ss / (float)head_dim + a.eps);
#pragma unroll
      for (int m = 0; m < kTile / 32; ++m) {
        const int d = lane + 32 * m;
        if (d < head_dim) h[d] = round_bf16(__fmul_rn(__fmul_rn(h[d], rstd), sc[m]));
      }
    }
    __syncthreads();
  }

  bf16* out = region == 0 ? q_out : region == 1 ? k_out : v_out;
  const int ocols = region == 0 ? nq_cols : nkv_cols;
  const bool rope = region < 2 && cos != nullptr;
  const int d0 = c % head_dim;   // the group's 4 columns lie in one head
  float cs[kN][4], sn[kN][4];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const size_t t0 = (size_t)(row0 + min(r0 + kRowsPer * j, rows - 1)) * rope_half;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = d0 + e;
      const bool live = rope && d < 2 * rope_half;
      const size_t ti = t0 + (d < rope_half ? d : d - rope_half);
      cs[j][e] = live ? cos[ti] : 0.f;
      sn[j][e] = live ? sin[ti] : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int r = r0 + kRowsPer * j;
    const float* t = tile + r * kTile + c;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = d0 + e;
      v[e] = t[e];
      if (rope && d < 2 * rope_half)
        v[e] = d < rope_half
            ? __fsub_rn(__fmul_rn(t[e], cs[j][e]), __fmul_rn(t[e + rope_half], sn[j][e]))
            : __fadd_rn(__fmul_rn(t[e], cs[j][e]), __fmul_rn(t[e - rope_half], sn[j][e]));
    }
    if (r < rows)
      *reinterpret_cast<uint2*>(out + (size_t)(row0 + r) * ocols + out0 + c) =
          make_uint2(tc::pack_bf16(v[0], v[1]), tc::pack_bf16(v[2], v[3]));
  }
}

// out = bf16(residual + bf16(bf16(sums) + bf16(bias))), the out-projection's
// and fc2's epilogue (kernel_gen.py :1556-1558, :1829-1832). tile: the
// finished sums [RB][kTile]; smem: the front region. Thread t owns columns
// c..c+3 (c = 4 (t % kG)) of rows t / kG + kRowsPer j, and loads its bias
// and residual values before it computes (the stores may alias the loads
// as far as the compiler knows, so a loop of both would wait on each).
template <int RB, typename TV, bool LORA>
__device__ void residual_epilogue(const GemmArgs<TV>& a, float* smem,
                                  const float* tile, const TV* bias,
                                  const bf16* residual, bf16* out, int n_cols,
                                  const LoraArgs& la) {
  constexpr int kG = kTile / 4, kRowsPer = kThreads / kG, kN = RB / kRowsPer;
  const int col0 = blockIdx.x * kTile;
  const int row0 = blockIdx.z * RB;
  const int rows = min(RB, a.rows - row0);
  const float* dl = nullptr;   // LORA: the rows' deltas [RB][kTile]
  if constexpr (LORA) dl = lora_tile_delta<RB>(la, smem, row0, rows);
  const int c = 4 * (threadIdx.x % kG), r0 = threadIdx.x / kG;
  float bv[4] = {0.f, 0.f, 0.f, 0.f};
  if (bias != nullptr)
#pragma unroll
    for (int e = 0; e < 4; ++e) bv[e] = round_bf16(load_f(bias, col0 + c + e));
  uint2 res[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j)
    res[j] = *reinterpret_cast<const uint2*>(
        residual + (size_t)(row0 + min(r0 + kRowsPer * j, rows - 1)) * n_cols + col0 + c);
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int r = r0 + kRowsPer * j;
    if (r >= rows) break;
    const float4 t4 = *reinterpret_cast<const float4*>(tile + r * kTile + c);
    const float t[4] = {t4.x, t4.y, t4.z, t4.w};
    const bf16* rv = reinterpret_cast<const bf16*>(&res[j]);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = round_bf16(t[e]);
      if constexpr (LORA) v[e] = add_delta(v[e], dl[r * kTile + c + e]);
      if (bias != nullptr) v[e] = round_bf16(__fadd_rn(v[e], bv[e]));
      v[e] = __fadd_rn(__bfloat162float(rv[e]), v[e]);
    }
    *reinterpret_cast<uint2*>(out + (size_t)(row0 + r) * n_cols + col0 + c) =
        make_uint2(tc::pack_bf16(v[0], v[1]), tc::pack_bf16(v[2], v[3]));
  }
}

// ---------------------------------------------------------------------------
// fused_out_proj_kernel: replaces kernel_gen.py _fused_out_proj (:1505),
// both emissions (:1567, :1581). Bound by the bytes of W_o (33.6 MB a
// llama3-8b layer). attn_flat [R, nq*D] @ W_o over 128-column tiles of H,
// each tile split along the nq*D contraction (tile_split_plan: 32 tiles
// alone would leave 100 of 132 SMs idle). Sums on mma_tile.
// ---------------------------------------------------------------------------
template <int RB, typename TW, typename TV, bool LORA>
__global__ void __launch_bounds__(kThreads, 2)
fused_out_proj_kernel(GemmArgs<TV> a, const TW* w, const float* w_scale,
                      const TV* bias, const bf16* residual, bf16* out,
                      int n_cols, LoraArgs la) {
  extern __shared__ __align__(16) float smem[];
  const TW* base = w + blockIdx.x * kTile;
  const float* sbase = w_scale == nullptr ? nullptr : w_scale + blockIdx.x * kTile;
  la.b0 = blockIdx.x * kTile;
  la.b1 = la.b0 + kHalfTile;
  if (!mma_tile<RB, TW, TV, false>(a, base, base + kHalfTile, sbase,
                                   sbase == nullptr ? nullptr : sbase + kHalfTile, n_cols,
                                   reinterpret_cast<char*>(smem)))
    return;
  residual_epilogue<RB, TV, LORA>(a, smem, smem + Ring<RB, TW, TV>::kFront / sizeof(float),
                                  bias, residual, out, n_cols, la);
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
// 128 columns. 224 tiles at llama3-8b fill the card's two blocks an SM
// without a K split. Sums on mma_tile, x normalised with ln2.
// ---------------------------------------------------------------------------

// y = act(bf16(sums) (+ bf16(delta)) (+ bias)) of the finished tile, the
// fc1 half of kernel_gen.py :1668-1680 (_fused_mlp_fc1 :1766-1781): gated
// kinds pair tile column c (gate) with kHalfTile + c (value), y =
// bf16(bf16(gate_act(gate)) * value); plain kinds apply the activation to
// the 128 columns. Thread t owns output columns c..c+3 (c = 4 (t %
// groups)) of rows t / groups + step j, and loads its bias values before
// the loop.
template <int RB, typename TV, bool LORA>
__device__ void fc1_epilogue(const GemmArgs<TV>& a, float* smem, const float* tile,
                             const TV* b1, bf16* y, int ffn, int act, int j0,
                             const LoraArgs& la) {
  const bool gated = act == kSwiglu || act == kGeglu;
  const int groups = (gated ? kHalfTile : kTile) / 4;   // 16 or 32
  const int step = kThreads / groups;
  const int row0 = blockIdx.z * RB;
  const int rows = min(RB, a.rows - row0);
  const float* dl = nullptr;   // LORA: the rows' deltas [RB][kTile]
  if constexpr (LORA) dl = lora_tile_delta<RB>(la, smem, row0, rows);
  const int c = 4 * (threadIdx.x % groups);
  float bg[4] = {0.f, 0.f, 0.f, 0.f}, bv[4] = {0.f, 0.f, 0.f, 0.f};
  if (b1 != nullptr) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bg[e] = round_bf16(load_f(b1, (size_t)j0 + c + e));
      if (gated) bv[e] = round_bf16(load_f(b1, (size_t)ffn + j0 + c + e));
    }
  }
  for (int r = threadIdx.x / groups; r < rows; r += step) {
    const float4 g4 = *reinterpret_cast<const float4*>(tile + r * kTile + c);
    const float g0[4] = {g4.x, g4.y, g4.z, g4.w};
    float v0[4] = {0.f, 0.f, 0.f, 0.f};
    if (gated) {
      const float4 v4 = *reinterpret_cast<const float4*>(tile + r * kTile + kHalfTile + c);
      v0[0] = v4.x; v0[1] = v4.y; v0[2] = v4.z; v0[3] = v4.w;
    }
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float g = round_bf16(g0[e]);
      if constexpr (LORA) g = add_delta(g, dl[r * kTile + c + e]);
      if (b1 != nullptr) g = round_bf16(__fadd_rn(g, bg[e]));
      if (gated) {
        float v = round_bf16(v0[e]);
        if constexpr (LORA) v = add_delta(v, dl[r * kTile + kHalfTile + c + e]);
        if (b1 != nullptr) v = round_bf16(__fadd_rn(v, bv[e]));
        const float ga = act == kSwiglu
            ? __fdiv_rn(g, __fadd_rn(1.f, expf(-g)))     // silu
            : gelu_tanh(g);
        o[e] = __fmul_rn(round_bf16(ga), v);
      } else if (act == kGelu) {
        o[e] = gelu_tanh(g);
      } else {
        const float rl = fmaxf(g, 0.f);
        o[e] = act == kRelu ? rl : __fmul_rn(rl, rl);
      }
    }
    *reinterpret_cast<uint2*>(y + (size_t)(row0 + r) * ffn + j0 + c) =
        make_uint2(tc::pack_bf16(o[0], o[1]), tc::pack_bf16(o[2], o[3]));
  }
}

template <int RB, typename TW, typename TV, bool LORA>
__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_fc1_kernel(GemmArgs<TV> a, const TW* w1, const float* w1_scale,
                     const TV* b1, bf16* y, int ffn, int act, LoraArgs la) {
  extern __shared__ __align__(16) float smem[];
  const bool gated = act == kSwiglu || act == kGeglu;
  const int j0 = blockIdx.x * (gated ? kHalfTile : kTile);
  const TW* seg0 = w1 + j0;
  const TW* seg1 = gated ? w1 + ffn + j0 : seg0 + kHalfTile;
  // The scales of the two segments' columns, indexed as the weights are,
  // and the B factor's columns likewise (gated: [gate | value]).
  const float* sc0 = w1_scale == nullptr ? nullptr : w1_scale + j0;
  const float* sc1 = w1_scale == nullptr ? nullptr
      : gated ? w1_scale + ffn + j0 : sc0 + kHalfTile;
  const size_t ldw = gated ? 2 * (size_t)ffn : (size_t)ffn;
  la.b0 = j0;
  la.b1 = gated ? ffn + j0 : j0 + kHalfTile;
  if (!mma_tile<RB, TW, TV, true>(a, seg0, seg1, sc0, sc1, ldw,
                                  reinterpret_cast<char*>(smem)))
    return;
  fc1_epilogue<RB, TV, LORA>(a, smem, smem + Ring<RB, TW, TV>::kFront / sizeof(float),
                             b1, y, ffn, act, j0, la);
}

// ---------------------------------------------------------------------------
// fused_mlp_fc2_kernel: replaces kernel_gen.py _fused_mlp_fc2 (:1793, call
// :1834) and the fc2 half of _fused_mlp. Bound by the bytes of W2 (117.4 MB
// a llama3-8b layer). y [R, ffn] @ W2 over 128-column tiles of H, each tile
// split along the ffn contraction (tile_split_plan: 8 splits of 14 ring
// stages at llama3-8b). The out-projection's kernel with another K: sums
// on mma_tile, residual_epilogue.
// ---------------------------------------------------------------------------
template <int RB, typename TW, typename TV, bool LORA>
__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_fc2_kernel(GemmArgs<TV> a, const TW* w2, const float* w2_scale,
                     const TV* b2, const bf16* residual, bf16* out,
                     int n_cols, LoraArgs la) {
  extern __shared__ __align__(16) float smem[];
  const TW* base = w2 + blockIdx.x * kTile;
  const float* sbase = w2_scale == nullptr ? nullptr : w2_scale + blockIdx.x * kTile;
  la.b0 = blockIdx.x * kTile;
  la.b1 = la.b0 + kHalfTile;
  if (!mma_tile<RB, TW, TV, false>(a, base, base + kHalfTile, sbase,
                                   sbase == nullptr ? nullptr : sbase + kHalfTile, n_cols,
                                   reinterpret_cast<char*>(smem)))
    return;
  residual_epilogue<RB, TV, LORA>(a, smem, smem + Ring<RB, TW, TV>::kFront / sizeof(float),
                                  b2, residual, out, n_cols, la);
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
  // LoRA epilogue (lora_ids == null: none): the target's t (lora_shrink)
  // and B bank (QKV: q's; lora_t2/lora_b2 the kv target's), the rows'
  // slots and the rank.
  const void *lora_t, *lora_b, *lora_t2, *lora_b2, *lora_ids;
  int lora_rank;
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

// One target's LoraArgs (B's row stride ldb); the kernels set b0 and b1.
LoraArgs lora_args(const Launch& l, const void* t, const void* b, int ldb) {
  LoraArgs la = {};
  la.t = static_cast<const float*>(t);
  la.b = static_cast<const float*>(b);
  la.ids = static_cast<const int*>(l.lora_ids);
  la.rank = l.lora_rank;
  la.ldb = ldb;
  return la;
}

template <int RB, bool LORA, typename Kernel, typename... Args>
int launch(Kernel kernel, int tiles, size_t smem, const Launch& l, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles, l.ksplit, (l.rows + RB - 1) / RB);
  const cudaStream_t stream = static_cast<cudaStream_t>(l.stream);
  if constexpr (LORA) {   // may start while the shrink before it runs
    err = tc::launch_pdl(kernel, grid, dim3(kThreads), smem, stream, args...);
    if (err != cudaSuccess) return (int)err;
  } else {
    kernel<<<grid, kThreads, smem, stream>>>(args...);
  }
  return (int)cudaGetLastError();
}

template <int RB, typename TW, typename TV, bool LORA>
int launch_qkv(const Launch& l) {
  const int nq_cols = l.n - 2 * l.nkv_cols;
  return launch<RB, LORA>(
      fused_qkv_kernel<RB, TW, TV, LORA>, l.n / kTile, Ring<RB, TW, TV>::kSmem, l,
      gemm_args<TV>(l),
      static_cast<const TW*>(l.w), static_cast<const TW*>(l.wkv),
      static_cast<const float*>(l.w_scale),
      static_cast<const float*>(l.kv_scale),
      static_cast<const TV*>(l.bias), static_cast<const TV*>(l.kv_bias),
      static_cast<const TV*>(l.q_ln), static_cast<const TV*>(l.k_ln),
      static_cast<const float*>(l.cos), static_cast<const float*>(l.sin),
      static_cast<bf16*>(l.out), static_cast<bf16*>(l.k_out),
      static_cast<bf16*>(l.v_out), nq_cols, l.nkv_cols, l.head_dim,
      l.rope_half, lora_args(l, l.lora_t, l.lora_b, nq_cols),
      lora_args(l, l.lora_t2, l.lora_b2, 2 * l.nkv_cols));
}

template <int RB, typename TW, typename TV, bool LORA>
int launch_out_proj(const Launch& l) {
  return launch<RB, LORA>(
      fused_out_proj_kernel<RB, TW, TV, LORA>, l.n / kTile, Ring<RB, TW, TV>::kSmem,
      l, gemm_args<TV>(l), static_cast<const TW*>(l.w),
      static_cast<const float*>(l.w_scale), static_cast<const TV*>(l.bias),
      static_cast<const bf16*>(l.residual), static_cast<bf16*>(l.out), l.n,
      lora_args(l, l.lora_t, l.lora_b, l.n));
}

template <int RB, typename TW, typename TV, bool LORA>
int launch_fc2(const Launch& l) {
  return launch<RB, LORA>(
      fused_mlp_fc2_kernel<RB, TW, TV, LORA>, l.n / kTile, Ring<RB, TW, TV>::kSmem, l,
      gemm_args<TV>(l), static_cast<const TW*>(l.w),
      static_cast<const float*>(l.w_scale), static_cast<const TV*>(l.bias),
      static_cast<const bf16*>(l.residual), static_cast<bf16*>(l.out), l.n,
      lora_args(l, l.lora_t, l.lora_b, l.n));
}

template <int RB, typename TW, typename TV, bool LORA>
int launch_fc1(const Launch& l) {
  const bool gated = l.act == kSwiglu || l.act == kGeglu;
  return launch<RB, LORA>(
      fused_mlp_fc1_kernel<RB, TW, TV, LORA>,
      l.n / (gated ? kHalfTile : kTile), Ring<RB, TW, TV>::kSmem, l, gemm_args<TV>(l),
      static_cast<const TW*>(l.w), static_cast<const float*>(l.w_scale),
      static_cast<const TV*>(l.bias), static_cast<bf16*>(l.out), l.n, l.act,
      lora_args(l, l.lora_t, l.lora_b, (gated ? 2 : 1) * l.n));
}

bool bad_split(const Launch& l) {
  return l.rows < 1 || l.k < 8 || l.k % 8 != 0 || l.ksplit < 1 ||
         ((l.ksplit > 1 || l.ws != nullptr) && (l.ws == nullptr || l.counters == nullptr));
}

// A LoRA epilogue needs its t and B (both pairs for QKV) and a rank of
// 1..32.
bool bad_lora(const Launch& l, bool two_targets) {
  if (l.lora_ids == nullptr) return false;
  return l.lora_rank < 1 || l.lora_rank > kMaxRank || l.lora_t == nullptr ||
         l.lora_b == nullptr ||
         (two_targets && (l.lora_t2 == nullptr || l.lora_b2 == nullptr));
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
// (weight, vector) type pairs, with or without the LoRA epilogue.
template <template <int, typename, typename, bool> class L, bool LORA>
int dispatch_kind(const Launch& l, int weight_kind, int vector_f32) {
  const bool small = l.rows <= 8;
  if (weight_kind == kWeightBf16)
    return small ? L<8, bf16, bf16, LORA>::run(l) : L<32, bf16, bf16, LORA>::run(l);
  if (weight_kind == kWeightF32)
    return small ? L<8, float, float, LORA>::run(l) : L<32, float, float, LORA>::run(l);
  if (vector_f32)
    return small ? L<8, int8_t, float, LORA>::run(l) : L<32, int8_t, float, LORA>::run(l);
  return small ? L<8, int8_t, bf16, LORA>::run(l) : L<32, int8_t, bf16, LORA>::run(l);
}

template <template <int, typename, typename, bool> class L>
int dispatch(const Launch& l, int weight_kind, int vector_f32) {
  if (l.lora_ids != nullptr) return dispatch_kind<L, true>(l, weight_kind, vector_f32);
  return dispatch_kind<L, false>(l, weight_kind, vector_f32);
}

template <int RB, typename TW, typename TV, bool LORA>
struct QkvL { static int run(const Launch& l) { return launch_qkv<RB, TW, TV, LORA>(l); } };
template <int RB, typename TW, typename TV, bool LORA>
struct OutProjL { static int run(const Launch& l) { return launch_out_proj<RB, TW, TV, LORA>(l); } };
template <int RB, typename TW, typename TV, bool LORA>
struct Fc1L { static int run(const Launch& l) { return launch_fc1<RB, TW, TV, LORA>(l); } };
template <int RB, typename TW, typename TV, bool LORA>
struct Fc2L { static int run(const Launch& l) { return launch_fc2<RB, TW, TV, LORA>(l); } };

}  // namespace

// Each launcher returns a cudaError_t code (0 = launched). Row blocks hold 8
// rows when rows <= 8, else 32 (more rows: one grid.z chunk per 32). Every
// pointer is a device pointer (biases, norm parameters and rope tables may be
// null). weight_kind: 0 bf16 weights, 1 fp32, 2 resident int8 with fp32
// per-output-column scales (w_scale [n], kv_scale [2 nkv_cols]; null for the
// other kinds); vector_f32: the norm parameters and biases are fp32 (else
// bf16; kinds 0 and 1 take vectors of their own dtype). Activations and
// outputs bf16; cos/sin fp32 [rows, rope_half]. When ksplit > 1, ws holds
// tiles * row chunks * ksplit * RB * 128 floats, then row chunks * 2 * RB
// (the normalising kernels' shared statistics), and counters tiles * row
// chunks + 2 * row chunks zeroed ints (the kernels leave them zero); a
// normalising kernel (QKV, fc1) at 32-row blocks takes the statistics and
// counters without a K split too (ws: row chunks * 2 * RB floats).
// LoRA epilogue: lora_ids [rows] int32 bank slots (null: no epilogue), the
// fp32 t [rows, lora_rank] of the launch's input (lora_shrink, on the same
// stream before it) and B bank [slots, lora_rank, n] of one layer (QKV: q's
// pair, then the kv pair over the packed [K | V] columns), 16-byte aligned,
// 1 <= lora_rank <= 32.

// x [rows, hidden]; wq [hidden, nq_cols]; wkv [hidden, 2 nkv_cols] ([K | V]);
// q [rows, nq_cols], k and v [rows, nkv_cols].
extern "C" int fused_qkv_launch(
    const void* x, const void* ln_scale, const void* ln_bias, int norm,
    float eps, const void* wq, const void* wkv, const void* q_scale,
    const void* kv_scale, const void* q_bias, const void* kv_bias,
    const void* q_ln, const void* k_ln, const void* cos, const void* sin,
    void* q, void* k, void* v, void* ws, void* counters, int rows, int hidden,
    int nq_cols, int nkv_cols, int head_dim, int rope_half, int weight_kind,
    int vector_f32, int ksplit, const void* lora_tq, const void* lora_bq,
    const void* lora_tkv, const void* lora_bkv, const void* lora_ids,
    int lora_rank, void* stream) {
  Launch l = {};
  l.x = x; l.norm_scale = ln_scale; l.norm_bias = ln_bias; l.norm = norm;
  l.eps = eps; l.w = wq; l.wkv = wkv; l.bias = q_bias; l.kv_bias = kv_bias;
  l.w_scale = q_scale; l.kv_scale = kv_scale;
  l.q_ln = q_ln; l.k_ln = k_ln; l.cos = cos; l.sin = sin;
  l.out = q; l.k_out = k; l.v_out = v; l.ws = ws; l.counters = counters;
  l.rows = rows; l.k = hidden; l.n = nq_cols + 2 * nkv_cols;
  l.nkv_cols = nkv_cols; l.head_dim = head_dim; l.rope_half = rope_half;
  l.ksplit = ksplit; l.stream = stream;
  l.lora_t = lora_tq; l.lora_b = lora_bq; l.lora_t2 = lora_tkv;
  l.lora_b2 = lora_bkv; l.lora_ids = lora_ids; l.lora_rank = lora_rank;
  if (bad_split(l) || norm < kNormRms || norm > kNormLayer ||
      (head_dim != 64 && head_dim != 128) || nq_cols % kTile != 0 ||
      nkv_cols % kTile != 0 || rope_half < 0 || 2 * rope_half > head_dim ||
      (cos != nullptr && rope_half == 0) || (q_ln == nullptr) != (k_ln == nullptr) ||
      bad_kind(weight_kind, vector_f32, q_scale) ||
      (q_scale == nullptr) != (kv_scale == nullptr) || bad_lora(l, true))
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
    int ksplit, const void* lora_t, const void* lora_b, const void* lora_ids,
    int lora_rank, void* stream) {
  Launch l = {};
  l.x = x; l.w = w; l.w_scale = w_scale; l.bias = bias; l.residual = residual;
  l.out = out; l.ws = ws; l.counters = counters; l.rows = rows; l.k = k;
  l.n = n; l.ksplit = ksplit; l.stream = stream; l.norm = kNormNone;
  l.lora_t = lora_t; l.lora_b = lora_b; l.lora_ids = lora_ids;
  l.lora_rank = lora_rank;
  if (bad_split(l) || n % kTile != 0 || n < kTile ||
      bad_kind(weight_kind, vector_f32, w_scale) || bad_lora(l, false))
    return (int)cudaErrorInvalidValue;
  if (fc2) return dispatch<Fc2L>(l, weight_kind, vector_f32);
  return dispatch<OutProjL>(l, weight_kind, vector_f32);
}

// x [rows, hidden]; w1 [hidden, ffn] or, gated, [hidden, 2 ffn] ([gate |
// value]), w1_scale its column scales; y [rows, ffn]. The LoRA B factor is
// [slots, rank, ffn] or, gated, [slots, rank, 2 ffn] like w1.
extern "C" int fused_mlp_fc1_launch(
    const void* x, const void* ln_scale, const void* ln_bias, int norm,
    float eps, const void* w1, const void* w1_scale, const void* b1, void* y,
    void* ws, void* counters, int rows, int hidden, int ffn, int act,
    int weight_kind, int vector_f32, int ksplit, const void* lora_t,
    const void* lora_b, const void* lora_ids, int lora_rank, void* stream) {
  Launch l = {};
  l.x = x; l.norm_scale = ln_scale; l.norm_bias = ln_bias; l.norm = norm;
  l.eps = eps; l.w = w1; l.w_scale = w1_scale; l.bias = b1; l.out = y;
  l.ws = ws; l.counters = counters; l.rows = rows; l.k = hidden; l.n = ffn;
  l.act = act; l.ksplit = ksplit; l.stream = stream;
  l.lora_t = lora_t; l.lora_b = lora_b; l.lora_ids = lora_ids;
  l.lora_rank = lora_rank;
  const bool gated = act == kSwiglu || act == kGeglu;
  if (bad_split(l) || norm < kNormRms || norm > kNormLayer || act < kSwiglu ||
      act > kSquaredRelu || ffn < kTile || ffn % (gated ? kHalfTile : kTile) != 0 ||
      bad_kind(weight_kind, vector_f32, w1_scale) || bad_lora(l, false))
    return (int)cudaErrorInvalidValue;
  return dispatch<Fc1L>(l, weight_kind, vector_f32);
}
