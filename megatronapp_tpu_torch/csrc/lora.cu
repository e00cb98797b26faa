// Segmented batched-LoRA delta for Hopper (sm_90a).
//
// Replaces the TPU kernel megatronapp_tpu/ops/pallas/kernel_gen.py
// lora_segmented_delta (def :2328, pallas_call :2379):
//   delta[r] = (x[r] @ A[slot[r]]) @ B[slot[r]]   in fp32,
// x [R, din] bf16, A bank [slots, din, rank] and B bank [slots, rank, dout]
// fp32 (one layer's slices of inference/lora.py's AdapterCache banks),
// delta [R, dout] fp32. Slot 0 is the NULL adapter: its rows get exact
// zeros, written without reading the banks (the TPU kernel's x @ 0).
//
// Rows arrive grouped into segments, one adapter each, in first-occurrence
// order (ops/lora.py LoraRows, built on the host from the engine's
// row_adapter and copied with the step's metadata): order [R] lists the
// rows segment by segment, seg_off [nseg + 1] bounds each segment in it,
// seg_slot [nseg] names its bank slot. The kernel reads the banks in place
// through the slot ids; it never gathers a per-row copy of the factors.
//
// Bound. At decode (8 rows, 4 adapters, rank 8) the function must read x,
// one A and one B per distinct adapter and write the delta: llama3-8b fc1
// (4096 -> 28672) moves ~5 MB, ~1.5 us at 3.35 TB/s, and its 2 * R * rank *
// (din + dout) FLOPs are negligible, so it is bound by bytes, and by the
// latency of its two dependent products more than by either.
// Design (simple first):
// - Grid (dout tiles of 512 columns, segments). A block owns one segment's
//   rows and 512 output columns (two a thread, 256 apart, so that a warp's
//   loads are coalesced), keeps its columns of B in registers, and walks
//   the segment's rows in groups of 8.
// - For a group it forms t = x_rows @ A (8 x rank, fp32): chunks of A
//   (contiguous, <= 8192 floats) and of the 8 rows of x (bf16 -> fp32) are
//   staged in shared memory with coalesced 16-byte loads, eight in flight a
//   thread (the kernel waits on these loads more than on its FMAs, and a
//   loop that stores each load before issuing the next keeps one in flight
//   a warp); thread (j, part) sums
//   column j of A against all 8 rows over its k's (k = part, part + parts,
//   ..., parts = 256 / rank), one A value read per k for the 8 rows, and
//   the parts are added in a fixed order. A row's t is therefore computed
//   by the same sequence of operations whatever other rows the launch
//   carries: each row's delta is bitwise the same in a mixed batch and
//   alone.
// - Then each thread writes its columns of t @ B for the group's rows.
// Each block of a segment recomputes t for its rows (A is read once per
// column tile, from L2 after the first); one launch per call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kCpt = 2;                     // output columns a thread
constexpr int kCols = kThreads * kCpt;      // output columns a block
constexpr int kRowGroup = 8;                // rows whose t a block forms at once
constexpr int kMaxRank = 32;                // ranks a launch takes, 1..32
constexpr int kStage = 8192;                // floats of A staged at once
constexpr int kMaxChunk = 1024;             // k's staged at once
constexpr int kXStride = kMaxChunk + 1;     // padded: rows on other banks
// Dynamic shared memory: A chunk, x chunk, partial sums, t.
constexpr size_t kSmemBytes =
    (kStage + kRowGroup * kXStride + kRowGroup * kThreads + kRowGroup * kMaxRank) *
    sizeof(float);

static_assert(kMaxRank <= kThreads, "one column j of A a thread at least");
constexpr int kBatch = 8;                   // global loads a thread keeps in flight

// Copies n floats from global src to shared dst with kBatch loads in flight
// a thread (a loop that stores each load before issuing the next keeps one
// load in flight a warp): 16-byte loads when vec (src and dst 16-byte
// aligned), 4-byte loads otherwise.
__device__ __forceinline__ void stage_floats(float* dst, const float* src, int n, bool vec) {
  const int tid = threadIdx.x;
  int done = 0;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    const int n4 = n / 4;
    for (int i0 = tid; i0 < n4; i0 += kThreads * kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (i0 + u * kThreads < n4) v[u] = __ldg(s4 + i0 + u * kThreads);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (i0 + u * kThreads < n4) d4[i0 + u * kThreads] = v[u];
    }
    done = n4 * 4;
  }
  for (int i0 = done + tid; i0 < n; i0 += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + u * kThreads < n) v[u] = __ldg(src + i0 + u * kThreads);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + u * kThreads < n) dst[i0 + u * kThreads] = v[u];
  }
}

__global__ void __launch_bounds__(kThreads)
lora_delta_kernel(const bf16* __restrict__ x, const float* __restrict__ a_bank,
                  const float* __restrict__ b_bank, const int* __restrict__ order,
                  const int* __restrict__ seg_off, const int* __restrict__ seg_slot,
                  float* __restrict__ out, int din, int dout, int rank) {
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                             // [chunk][rank]
  float* x_s = a_s + kStage;                     // [row][kXStride]
  float* part = x_s + kRowGroup * kXStride;      // [row][j][part]
  float* t_s = part + kRowGroup * kThreads;      // [row][rank]
  __shared__ int rows_s[kRowGroup];              // the group's rows of x

  const int tid = threadIdx.x;
  const int seg = blockIdx.y;
  const int slot = seg_slot[seg];
  const int r_begin = seg_off[seg], r_end = seg_off[seg + 1];
  int cols[kCpt];
#pragma unroll
  for (int i = 0; i < kCpt; ++i) cols[i] = blockIdx.x * kCols + i * kThreads + tid;

  if (slot == 0) {   // the NULL adapter: exact zeros, no bank reads
    for (int r = r_begin; r < r_end; ++r) {
      const size_t o = (size_t)order[r] * dout;
#pragma unroll
      for (int i = 0; i < kCpt; ++i)
        if (cols[i] < dout) out[o + cols[i]] = 0.f;
    }
    return;
  }

  const float* A = a_bank + (size_t)slot * din * rank;
  const float* B = b_bank + (size_t)slot * rank * dout;
  float bcol[kCpt][kMaxRank];
#pragma unroll
  for (int i = 0; i < kCpt; ++i)
#pragma unroll
    for (int j = 0; j < kMaxRank; ++j)
      bcol[i][j] = (j < rank && cols[i] < dout) ? B[(size_t)j * dout + cols[i]] : 0.f;

  const int parts = kThreads / rank;
  const int pj = tid % rank, kp = tid / rank;   // kp < parts: every thread
  const int chunk = min(kMaxChunk, kStage / rank / 8 * 8);
  const bool a_vec = (din * rank) % 4 == 0;     // every chunk of A 16-byte aligned
  const bool x_vec = din % 8 == 0;              // every chunk of a row of x too

  for (int g = r_begin; g < r_end; g += kRowGroup) {
    const int nr = min(kRowGroup, r_end - g);
    float acc[kRowGroup];
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) acc[r] = 0.f;
    __syncthreads();     // the previous group is consumed
    if (tid < kRowGroup) rows_s[tid] = tid < nr ? order[g + tid] : 0;
    for (int i = nr * kXStride + tid; i < kRowGroup * kXStride; i += kThreads)
      x_s[i] = 0.f;      // the group's missing rows add nothing
    for (int k0 = 0; k0 < din; k0 += chunk) {
      const int kc = min(chunk, din - k0);
      __syncthreads();   // rows_s written; the previous chunk consumed
      stage_floats(a_s, A + (size_t)k0 * rank, kc * rank, a_vec);
      if (x_vec) {       // 8 bf16 a load, one load of each row in flight
        for (int i = tid; i < kc / 8; i += kThreads) {
          uint4 raw[kRowGroup];
#pragma unroll
          for (int r = 0; r < kRowGroup; ++r)
            if (r < nr)
              raw[r] = __ldg(reinterpret_cast<const uint4*>(
                  x + (size_t)rows_s[r] * din + k0) + i);
#pragma unroll
          for (int r = 0; r < kRowGroup; ++r) {
            if (r >= nr) continue;
            const bf16* v = reinterpret_cast<const bf16*>(&raw[r]);
#pragma unroll
            for (int e = 0; e < 8; ++e) x_s[r * kXStride + 8 * i + e] = __bfloat162float(v[e]);
          }
        }
      } else {
        for (int i = tid; i < kc; i += kThreads) {
          float v[kRowGroup];
#pragma unroll
          for (int r = 0; r < kRowGroup; ++r)
            if (r < nr) v[r] = __bfloat162float(x[(size_t)rows_s[r] * din + k0 + i]);
#pragma unroll
          for (int r = 0; r < kRowGroup; ++r)
            if (r < nr) x_s[r * kXStride + i] = v[r];
        }
      }
      __syncthreads();
      if (kp < parts) {   // rows past nr hold zeros in x_s
        for (int k = kp; k < kc; k += parts) {
          const float av = a_s[k * rank + pj];
#pragma unroll
          for (int r = 0; r < kRowGroup; ++r)
            acc[r] = fmaf(x_s[r * kXStride + k], av, acc[r]);
        }
      }
    }
    if (kp < parts) {
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) part[(r * rank + pj) * parts + kp] = acc[r];
    }
    __syncthreads();
    for (int p = tid; p < kRowGroup * rank; p += kThreads) {
      float s = part[p * parts];
      for (int q = 1; q < parts; ++q) s += part[p * parts + q];
      t_s[p] = s;
    }
    __syncthreads();
    for (int rr = 0; rr < nr; ++rr) {
      const size_t o = (size_t)order[g + rr] * dout;
      const float* t = t_s + rr * rank;
#pragma unroll
      for (int i = 0; i < kCpt; ++i) {
        if (cols[i] >= dout) continue;
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxRank; ++j)
          if (j < rank) d = fmaf(t[j], bcol[i][j], d);
        out[o + cols[i]] = d;
      }
    }
  }
}

}  // namespace

// Returns a cudaError_t code (0 = launched). x [rows, din] bf16; a_bank
// [slots, din, rank], b_bank [slots, rank, dout] fp32; order [rows],
// seg_off [nseg + 1], seg_slot [nseg] int32; out [rows, dout] fp32. Every
// pointer is a device pointer; 1 <= rank <= 32.
extern "C" int lora_delta_launch(const void* x, const void* a_bank,
                                 const void* b_bank, const void* order,
                                 const void* seg_off, const void* seg_slot,
                                 void* out, int rows, int nseg, int din,
                                 int dout, int rank, void* stream) {
  if (rows < 1 || nseg < 1 || nseg > rows || nseg > 65535 || din < 1 ||
      dout < 1 || rank < 1 || rank > kMaxRank)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lora_delta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((dout + kCols - 1) / kCols, nseg);
  lora_delta_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a_bank),
      static_cast<const float*>(b_bank), static_cast<const int*>(order),
      static_cast<const int*>(seg_off), static_cast<const int*>(seg_slot),
      static_cast<float*>(out), din, dout, rank);
  return (int)cudaGetLastError();
}
