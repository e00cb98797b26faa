// Segmented batched-LoRA kernels for Hopper (sm_90a): the shrink t = x @ A
// and the expand delta = t @ B.
//
// Together they replace the TPU kernel megatronapp_tpu/ops/pallas/
// kernel_gen.py lora_segmented_delta (def :2328, pallas_call :2379):
//   delta[r] = (x[r] @ A[slot[r]]) @ B[slot[r]]   in fp32,
// x [R, din] bf16, A bank [slots, din, rank] and B bank [slots, rank, dout]
// fp32 (one layer's slices of inference/lora.py's AdapterCache banks),
// delta [R, dout] fp32. Slot 0 is the NULL adapter: its rows get exact
// zeros, written without reading the banks (the TPU kernel's x @ 0). The
// shrink also serves the fused decode kernels (fused_decode.cu), whose LoRA
// epilogue only expands the t it forms: there its input is bf16(norm(x)),
// formed by row_norm.cuh exactly as the fused QKV and fc1 products form it.
//
// Rows arrive grouped into segments, one adapter each, in first-occurrence
// order (ops/lora.py LoraRows, built on the host from the engine's
// row_adapter and copied with the step's metadata): order [R] lists the
// rows segment by segment, seg_off [nseg + 1] bounds each segment in it,
// seg_slot [nseg] names its bank slot. A unit is a group of up to 8 rows
// of one segment (grid dimensions y and z: segment, group; groups past a
// segment's rows exit). The kernels read the banks in place through the
// slot ids; they never gather a per-row copy of the factors.
//
// Bound. At decode (8 rows, 4 adapters, rank 8) a layer's five targets
// must read x, one A and one B per distinct adapter and write the deltas:
// llama3-8b fc2 (14336 -> 4096) moves ~2.1 MB, ~0.6 us at 3.35 TB/s, and
// its 2 * R * rank * (din + dout) FLOPs are negligible, so both kernels are
// bound by bytes, and by the latency of loads more than by either.
// Design:
// - lora_shrink_kernel: grid (k splits, segments, groups). The split count
//   is ceil(din / kper) with kper chosen from din and the rank alone
//   (ops/cuda/lora.py shrink_k_per_split: 2048 floats of A a block, at
//   most 28 splits), so it never depends on the rows, the segments or the
//   adapters present: fc2 at rank 8 runs 28 splits, 112 blocks at 8 rows
//   on 4 adapters. It triggers the launch of the kernel after it (the
//   expand or a fused kernel, launched with programmatic stream
//   serialization) at once; that kernel waits for the shrink before it
//   reads t and before it writes any buffer allocated after the shrink was
//   launched (tensor_core.cuh's rule). Its split workspace and counters
//   persist across launches (ops/cuda/lora.py). A block streams its k range in stages of 128 k's through a 3-deep cp.async ring (A's
//   rows of the unit's adapter for every target, the unit's rows of x),
//   widens (and normalises) each x stage to fp32 [k][row] once, and thread
//   (j, part) sums column j of A against the 8 rows over the stage's k's
//   part, part + parts, ... (parts = 256 / rank), one A value read per k
//   for the 8 rows; the parts are added in a fixed order. Each split block
//   writes its partial t to a workspace; the last block of a unit to finish
//   (an atomic count on a per-unit counter, not on any sum) adds the splits
//   in order 0..S-1 and resets the counter. A row's t is therefore computed
//   by the same sequence of operations whatever other rows the launch
//   carries: each row's t and delta are bitwise the same in a mixed batch
//   and alone, and a rerun repeats every bit. Two targets that share their
//   input (q and kv) ride one launch: each thread keeps both targets' sums,
//   in the same order as a launch of one target.
// - lora_expand_kernel: grid (512-column tiles, segments, groups). Each
//   thread copies its 4 columns of B[slot] (every rank row) into shared
//   memory with 16-byte cp.async (while the shrink may still run), waits
//   for the shrink (NULL units too, before they write their zeros), loads
//   the unit's t rows, then
//   writes 4 columns of each row's delta = t . B in rank order (the fused
//   epilogue's order) with one 16-byte store.
// The FMAs stay fp32 on the CUDA cores: the shrink of fc2 at 32 rows is
// 2 x 32 x 14336 x 8 = 7.3 MFLOP, where TF32 tensor cores would cost
// accuracy and gain nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_norm.cuh"
#include "tensor_core.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;               // shrink block
constexpr int kGroupRows = 8;               // rows of a unit
constexpr int kMaxRank = 32;                // ranks a launch takes, 1..32
constexpr int kMaxTargets = 2;              // A banks a shrink launch takes
constexpr int kStageK = 128;                // k's a ring stage holds
constexpr int kRing = 3;                    // ring stages
constexpr int kExpandThreads = 128;
constexpr int kExpandCols = 4 * kExpandThreads;   // columns an expand block

// The unit (segment, group of 8 rows) of this block: its first index into
// order and its row count (<= 0: no rows, the block exits).
struct Unit {
  int seg, r0, nr, slot;
  __device__ Unit(const int* seg_off, const int* seg_slot) {
    seg = blockIdx.y;
    r0 = seg_off[seg] + (int)blockIdx.z * kGroupRows;
    nr = min(kGroupRows, seg_off[seg + 1] - r0);
    slot = seg_slot[seg];
  }
};

template <typename TV>
struct ShrinkArgs {
  const bf16* x;                 // [rows, din] (the input, or x to normalise)
  const TV* norm_scale;          // [din] (kNormNone: unused)
  const TV* norm_bias;           // [din] or null
  int norm;
  float eps;
  const float* a[kMaxTargets];   // A banks [slots, din, rank]
  int targets;
  const int *order, *seg_off, *seg_slot;
  float* t;                      // [targets, rows, rank]
  float* ws;                     // [units, targets, splits, 8, rank]
  int* counters;                 // [units], zero between launches
  int rows, din, rank, kper, splits;
};

// Copies ring stage s of a shrink block's k range [k_begin, k_end) into
// ring slot s % kRing, zero-filled past k_end and for missing rows: with
// copy_a A's rows of slot `slot` for each of nt targets, with copy_x the
// unit's nr rows of x (rows_s); with commit it then commits one group, an
// empty one past the range, so that the waits count stages. Every argument
// is a value: a pointer to the kernel's parameters would copy them to
// local memory.
__device__ __forceinline__ void issue_stage(const float* a0, const float* a1, int nt,
                                            const bf16* x, const int* rows_s, int nr,
                                            int slot, int din, int rank, int k_begin,
                                            int k_end, int s, int nstage, float* a_s,
                                            bf16* x_s, bool copy_a, bool copy_x,
                                            bool commit) {
  if (s < nstage) {
    const int tid = threadIdx.x;
    const int k0 = k_begin + s * kStageK;
    const int kc = min(kStageK, k_end - k0);
    const int ring = s % kRing;
    const int a16 = kStageK * rank / 4;          // 16-byte pieces of a full A stage
    for (int tg = 0; tg < nt && copy_a; ++tg) {
      const float* src = (tg == 0 ? a0 : a1) + ((size_t)slot * din + k0) * rank;
      float* dst = a_s + (ring * nt + tg) * kStageK * rank;
      for (int i = tid; i < a16; i += kThreads) {
        const bool live = 4 * i < kc * rank;
        tc::cp_async_16(dst + 4 * i, live ? src + 4 * i : src, live);
      }
    }
    bf16* xd = x_s + ring * kGroupRows * kStageK;
    for (int i = tid; i < kGroupRows * kStageK / 8 && copy_x; i += kThreads) {
      const int r = i / (kStageK / 8), k8 = (i % (kStageK / 8)) * 8;
      const bool live = r < nr && k8 < kc;
      tc::cp_async_16(xd + r * kStageK + k8,
                      live ? x + (size_t)rows_s[r] * din + k0 + k8 : x, live);
    }
  }
  if (commit) tc::cp_async_commit();
}

// Shared memory of a shrink launch (floats): the ring's A stages, its x
// stages (bf16), the widened x stage and the per-part sums.
size_t shrink_smem_bytes(int targets, int rank) {
  return (size_t)(kRing * targets * kStageK * rank + kRing * kGroupRows * kStageK / 2 +
                  kStageK * kGroupRows + kMaxTargets * kGroupRows * kThreads) *
         sizeof(float);
}

template <typename TV>
__global__ void __launch_bounds__(kThreads)
lora_shrink_kernel(ShrinkArgs<TV> p) {
  extern __shared__ __align__(16) float smem[];
  tc::pdl_trigger();   // the expand or fused kernel after it may start
  const int rank = p.rank, nt = p.targets;
  float* a_s = smem;                                        // [ring][nt][kStageK][rank]
  bf16* x_s = reinterpret_cast<bf16*>(a_s + kRing * nt * kStageK * rank);  // [ring][8][kStageK]
  float* xf = reinterpret_cast<float*>(x_s + kRing * kGroupRows * kStageK);  // [kStageK][8]
  float* part = xf + kStageK * kGroupRows;                  // [nt][8][rank][parts]
  __shared__ int rows_s[kGroupRows];
  __shared__ float mean_s[kGroupRows], rstd_s[kGroupRows];
  __shared__ int flag_s;

  const Unit u(p.seg_off, p.seg_slot);
  if (u.nr <= 0) return;
  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  if (u.slot == 0) {   // the NULL adapter: t = 0, no bank read
    if (split == 0)
      for (int i = tid; i < nt * u.nr * rank; i += kThreads) {
        const int tg = i / (u.nr * rank), r = (i / rank) % u.nr;
        p.t[((size_t)tg * p.rows + p.order[u.r0 + r]) * rank + i % rank] = 0.f;
      }
    return;
  }
  const int din = p.din;
  const int k_begin = min(din, split * p.kper);
  const int k_end = min(din, k_begin + p.kper);
  const int nstage = (k_end - k_begin + kStageK - 1) / kStageK;
  const float* a0 = p.a[0];
  const float* a1 = p.a[1];
  // The first kRing - 1 stages: A's rows (they need only the slot) go out
  // before the unit's row ids are read, x's after; the first group holds
  // those stages' A and stage 0's x, each later group one stage's x.
  for (int s = 0; s < kRing - 1; ++s)
    issue_stage(a0, a1, nt, p.x, rows_s, u.nr, u.slot, din, rank, k_begin, k_end, s,
                nstage, a_s, x_s, true, false, false);
  if (tid < kGroupRows) rows_s[tid] = tid < u.nr ? p.order[u.r0 + tid] : 0;
  __syncthreads();
  for (int s = 0; s < kRing - 1; ++s)
    issue_stage(a0, a1, nt, p.x, rows_s, u.nr, u.slot, din, rank, k_begin, k_end, s,
                nstage, a_s, x_s, false, true, true);

  // Norm statistics over each row's whole input, one warp a row, while the
  // first stages load.
  if (p.norm != rn::kNormNone) {
    const int warp = tid / 32, lane = tid % 32;
    if (warp < u.nr) {
      float mean, ss;
      rn::row_moments(p.x + (size_t)rows_s[warp] * din, din, p.norm, lane, mean, ss);
      if (lane == 0) {
        mean_s[warp] = mean;
        rstd_s[warp] = rn::row_rstd(ss, din, p.eps);
      }
    }
  }

  const int parts = kThreads / rank;
  const int pj = tid % rank, kp = tid / rank;   // kp < parts: active
  float acc[kMaxTargets][kGroupRows];
#pragma unroll
  for (int tg = 0; tg < kMaxTargets; ++tg)
#pragma unroll
    for (int r = 0; r < kGroupRows; ++r) acc[tg][r] = 0.f;

  for (int s = 0; s < nstage; ++s) {
    tc::cp_async_wait<kRing - 2>();
    __syncthreads();   // stage s landed; stage s - 1 consumed; stats written
    issue_stage(a0, a1, nt, p.x, rows_s, u.nr, u.slot, din, rank, k_begin, k_end,
                s + kRing - 1, nstage, a_s, x_s, true, true, true);
    const int k0 = k_begin + s * kStageK;
    const int kc = min(kStageK, k_end - k0);
    const int ring = s % kRing;
    const bf16* xr = x_s + ring * kGroupRows * kStageK;
    for (int kk = tid; kk < kStageK; kk += kThreads) {   // one k's 8 rows a thread
      float v[kGroupRows];
#pragma unroll
      for (int r = 0; r < kGroupRows; ++r) {
        v[r] = 0.f;   // missing rows and k's past kc add nothing
        if (r < u.nr && kk < kc) {
          v[r] = __bfloat162float(xr[r * kStageK + kk]);
          if (p.norm != rn::kNormNone)
            v[r] = rn::norm_round(v[r], mean_s[r], rstd_s[r], p.norm_scale,
                                  p.norm_bias, k0 + kk);
        }
      }
      float4* dst = reinterpret_cast<float4*>(xf + kk * kGroupRows);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();
    if (kp < parts) {
      for (int kk = kp; kk < kc; kk += parts) {
        const float4 x0 = *reinterpret_cast<const float4*>(xf + kk * kGroupRows);
        const float4 x1 = *reinterpret_cast<const float4*>(xf + kk * kGroupRows + 4);
        const float xv[kGroupRows] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int tg = 0; tg < kMaxTargets; ++tg) {
          if (tg < nt) {
            const float av = a_s[((ring * nt + tg) * kStageK + kk) * rank + pj];
#pragma unroll
            for (int r = 0; r < kGroupRows; ++r) acc[tg][r] = fmaf(xv[r], av, acc[tg][r]);
          }
        }
      }
    }
  }
  tc::cp_async_wait<0>();

  // The block's sums of each (target, row, j): its parts added in order.
  if (kp < parts) {
#pragma unroll
    for (int tg = 0; tg < kMaxTargets; ++tg) {
      if (tg < nt) {
#pragma unroll
        for (int r = 0; r < kGroupRows; ++r)
          part[((tg * kGroupRows + r) * rank + pj) * parts + kp] = acc[tg][r];
      }
    }
  }
  __syncthreads();
  const int npairs = nt * kGroupRows * rank;   // (target, row, j)
  const int unit = blockIdx.y * gridDim.z + blockIdx.z;
  float* ws = p.ws + (size_t)unit * nt * p.splits * kGroupRows * rank;
  for (int q = tid; q < npairs; q += kThreads) {
    float v = part[q * parts];
#pragma unroll 8
    for (int i = 1; i < parts; ++i) v += part[q * parts + i];
    const int tg = q / (kGroupRows * rank), rj = q % (kGroupRows * rank);
    ws[((size_t)tg * p.splits + split) * kGroupRows * rank + rj] = v;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) flag_s = atomicAdd(p.counters + unit, 1) == p.splits - 1;
  __syncthreads();
  if (!flag_s) return;
  __threadfence();
  // The last block of the unit: the splits added in order 0..S-1, their
  // partials loaded kLoadBatch at a time (all in flight at once).
  constexpr int kLoadBatch = 16;
  const size_t stride = (size_t)kGroupRows * rank;
  for (int q = tid; q < nt * u.nr * rank; q += kThreads) {
    const int tg = q / (u.nr * rank), rj = q % (u.nr * rank);
    const float* w = ws + (size_t)tg * p.splits * stride + rj;
    float v = 0.f;
    for (int s0 = 0; s0 < p.splits; s0 += kLoadBatch) {
      float b[kLoadBatch];
#pragma unroll
      for (int i = 0; i < kLoadBatch; ++i)
        b[i] = s0 + i < p.splits ? __ldcg(w + (s0 + i) * stride) : 0.f;
#pragma unroll
      for (int i = 0; i < kLoadBatch; ++i)
        if (s0 + i < p.splits) v = s0 + i == 0 ? b[i] : v + b[i];
    }
    p.t[((size_t)tg * p.rows + rows_s[rj / rank]) * rank + rj % rank] = v;
  }
  if (tid == 0) p.counters[unit] = 0;
}

__global__ void __launch_bounds__(kExpandThreads)
lora_expand_kernel(const float* __restrict__ t, const float* __restrict__ b_bank,
                   const int* __restrict__ order, const int* __restrict__ seg_off,
                   const int* __restrict__ seg_slot, float* __restrict__ out, int dout,
                   int rank) {
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                                // [rank][kExpandCols]
  __shared__ float ts[kGroupRows * kMaxRank];      // [row][rank]
  __shared__ int rows_s[kGroupRows];

  const Unit u(seg_off, seg_slot);
  if (u.nr <= 0) return;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kExpandCols + 4 * tid;
  const bool live = c0 < dout;                     // dout % 4 == 0
  if (u.slot == 0) {   // the NULL adapter: exact zeros, no bank read
    tc::pdl_wait();   // out may lie where the shrink's freed buffers lay
    if (live)
      for (int r = 0; r < u.nr; ++r)
        *reinterpret_cast<float4*>(out + (size_t)order[u.r0 + r] * dout + c0) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const float* B = b_bank + (size_t)u.slot * rank * dout;
  for (int j = 0; j < rank; ++j)
    tc::cp_async_16(bs + j * kExpandCols + 4 * tid, live ? B + (size_t)j * dout + c0 : B,
                    live);
  tc::cp_async_commit();
  if (tid < kGroupRows) rows_s[tid] = tid < u.nr ? order[u.r0 + tid] : 0;
  tc::pdl_wait();   // t comes from the shrink launched just before
  for (int i = tid; i < u.nr * rank; i += kExpandThreads)
    ts[i] = t[(size_t)order[u.r0 + i / rank] * rank + i % rank];
  tc::cp_async_wait<0>();
  __syncthreads();
  if (!live) return;
  for (int r = 0; r < u.nr; ++r) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < rank; ++j) {
      const float tj = ts[r * rank + j];
      const float4 bv = *reinterpret_cast<const float4*>(bs + j * kExpandCols + 4 * tid);
      d[0] = fmaf(tj, bv.x, d[0]);
      d[1] = fmaf(tj, bv.y, d[1]);
      d[2] = fmaf(tj, bv.z, d[2]);
      d[3] = fmaf(tj, bv.w, d[3]);
    }
    *reinterpret_cast<float4*>(out + (size_t)rows_s[r] * dout + c0) =
        make_float4(d[0], d[1], d[2], d[3]);
  }
}

bool bad_rows(int rows, int nseg, int groups, int rank) {
  return rows < 1 || nseg < 1 || nseg > rows || nseg > 65535 || groups < 1 ||
         groups > 65535 || rank < 1 || rank > kMaxRank;
}

template <typename TV>
int launch_shrink(const void* x, const void* norm_scale, const void* norm_bias,
                  int norm, float eps, const void* a0, const void* a1,
                  const void* order, const void* seg_off, const void* seg_slot,
                  void* t, void* ws, void* counters, int rows, int nseg,
                  int groups, int din, int rank, int kper, int splits,
                  void* stream) {
  ShrinkArgs<TV> p;
  p.x = static_cast<const bf16*>(x);
  p.norm_scale = static_cast<const TV*>(norm_scale);
  p.norm_bias = static_cast<const TV*>(norm_bias);
  p.norm = norm;
  p.eps = eps;
  p.a[0] = static_cast<const float*>(a0);
  p.a[1] = static_cast<const float*>(a1);
  p.targets = a1 == nullptr ? 1 : 2;
  p.order = static_cast<const int*>(order);
  p.seg_off = static_cast<const int*>(seg_off);
  p.seg_slot = static_cast<const int*>(seg_slot);
  p.t = static_cast<float*>(t);
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.rows = rows;
  p.din = din;
  p.rank = rank;
  p.kper = kper;
  p.splits = splits;
  const size_t smem = shrink_smem_bytes(p.targets, rank);
  cudaError_t err = cudaFuncSetAttribute(
      lora_shrink_kernel<TV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(splits, nseg, groups);
  lora_shrink_kernel<TV><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Each launcher returns a cudaError_t code (0 = launched). Every pointer is
// a device pointer, 16-byte aligned; order [rows], seg_off [nseg + 1] and
// seg_slot [nseg] int32 (ops/lora.py LoraRows); groups: ceil(the largest
// segment's rows / 8); 1 <= rank <= 32.

// t [targets, rows, rank] fp32 = xin @ A[slot] of each row, for 1 or 2
// targets (a0, a1: A banks [slots, din, rank] fp32; a1 null for one). xin is
// x [rows, din] bf16 itself (norm 0) or bf16(norm(x)) (norm 1 rmsnorm, 2
// layernorm) with norm_scale and norm_bias [din] (bias may be null), fp32
// when vector_f32, else bf16. din % 8 == 0; kper (k's a split block owns)
// a positive multiple of 8; ws holds units * targets * splits * 8 * rank
// floats (units = nseg * groups, splits = ceil(din / kper)) and counters
// units zeroed ints (the kernel leaves them zero).
extern "C" int lora_shrink_launch(const void* x, const void* norm_scale,
                                  const void* norm_bias, int norm, float eps,
                                  int vector_f32, const void* a0, const void* a1,
                                  const void* order, const void* seg_off,
                                  const void* seg_slot, void* t, void* ws,
                                  void* counters, int rows, int nseg, int groups,
                                  int din, int rank, int kper, void* stream) {
  if (bad_rows(rows, nseg, groups, rank) || din < 8 || din % 8 != 0 ||
      kper < 8 || kper % 8 != 0 || a0 == nullptr || norm < rn::kNormNone ||
      norm > rn::kNormLayer || (norm != rn::kNormNone && norm_scale == nullptr) ||
      ws == nullptr || counters == nullptr)
    return (int)cudaErrorInvalidValue;
  const int splits = (din + kper - 1) / kper;
  if (splits > 65535) return (int)cudaErrorInvalidValue;
  if (vector_f32)
    return launch_shrink<float>(x, norm_scale, norm_bias, norm, eps, a0, a1, order,
                                seg_off, seg_slot, t, ws, counters, rows, nseg,
                                groups, din, rank, kper, splits, stream);
  return launch_shrink<bf16>(x, norm_scale, norm_bias, norm, eps, a0, a1, order,
                             seg_off, seg_slot, t, ws, counters, rows, nseg, groups,
                             din, rank, kper, splits, stream);
}

// out [rows, dout] fp32 = t @ B[slot] of each row: t [rows, rank] fp32
// (lora_shrink's, one target), b_bank [slots, rank, dout] fp32; dout % 4
// == 0.
extern "C" int lora_expand_launch(const void* t, const void* b_bank,
                                  const void* order, const void* seg_off,
                                  const void* seg_slot, void* out, int rows,
                                  int nseg, int groups, int dout, int rank,
                                  void* stream) {
  if (bad_rows(rows, nseg, groups, rank) || dout < 4 || dout % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)rank * kExpandCols * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lora_expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((dout + kExpandCols - 1) / kExpandCols, nseg, groups);
  err = tc::launch_pdl(lora_expand_kernel, grid, dim3(kExpandThreads), smem,
                       static_cast<cudaStream_t>(stream), static_cast<const float*>(t),
                       static_cast<const float*>(b_bank), static_cast<const int*>(order),
                       static_cast<const int*>(seg_off), static_cast<const int*>(seg_slot),
                       static_cast<float*>(out), dout, rank);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
