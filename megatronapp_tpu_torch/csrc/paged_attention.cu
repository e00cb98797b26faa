// Ragged paged attention for Hopper (sm_90a), decode and ragged modes.
//
// Replaces the TPU kernel megatronapp_tpu/ops/pallas/kernel_gen.py
// emit_paged_kernel (driven by kernel_gen.paged_attention) for bf16 pools and
// for quantized pools: int8 or fp8 (e4m3) pages with per-(row, kv-head) fp32
// scale pools read through the same page table (kernel_gen.py:856-860).
// It computes the same function: each query row attends the K/V rows of its
// slot, read through the slot's page table, with an online softmax over
// [0, kv_len); ragged rows add the causal limit kv_len - q_len + s on the
// new tail, and query head h reads kv head h / group (GQA). The rows of one
// kv head are packed as r = s * group + g, so a kv tile serves the group's
// query heads together.
//
// Bound: the bytes of K and V read (each valid row once; one byte an
// element and 4 bytes a row of scales for quantized pools); the arithmetic
// is two [rows, D] x [D, kv] products, far below the card's ridge point.
// The TPU kernel walks the pages as a sequential grid axis and carries
// acc/m/l in VMEM; here the designs differ by pool type.
//
// bf16 pools: split KV on the tensor cores (paged_attention_mma_kernel and
// paged_attention_combine_kernel). A block owns (slot b, kv head hk, a tile
// of up to 64 rows, one kv split): 4 warps, each owning 16 rows as one
// mma.sync m16n8k16 tile (a decode tile has `group` real rows; decode is
// bound by bytes, so the idle rows of the tile cost nothing that matters).
// The slot's 64-row kv tiles are dealt to the splits in turn (tile i to
// split i mod splits), so the splits share the work whatever kv_len is;
// the split count comes from the host (ops/cuda/paged_attention.py
// kv_split_plan: from B, Hkv, the rows and the table's capacity mb * bs,
// never from kv_lens), so that a ragged B 1 chunk or a decode step fills
// the 132 SMs. Each kv tile is gathered through the page table row by
// row (block page_table[b, pos / bs], offset pos % bs: every block size
// 1-64) with 16-byte cp.async into a ring of two stages, the next tile's
// copies in flight during this tile's products; rows at pos >= kv_len are
// zero-filled by the copy's source size, so stale pool bytes never reach
// the output. A block stops at the last position its rows can see (kv_len
// and the causal limit of its last row); a split wholly past them writes
// zero weight (m = -1e30, l = 0). The q tile is scaled, rounded and held in
// registers as A fragments; S = q . K^T and acc += bf16(P) . V run on
// mma.sync with fp32 accumulators, P reused in registers as the A fragment
// (tensor_core.cuh). With one split the block writes the output; with more,
// each writes its unnormalised acc, m and l in fp32 to the workspace, and
// the combine kernel merges a row's splits in split order: m = max m_i,
// l = sum l_i e^{m_i - m}, acc = sum acc_i e^{m_i - m}, out = acc /
// max(l, 1e-20), skipping splits with l_i = 0. Every element has one writer
// and a fixed order of sums, so a rerun repeats every bit.
//
// Quantized pools keep the first design (paged_attention_kernel): one block
// owns (slot, kv head, 32 rows) and walks the slot's pages itself, one page
// at a time: it reads page_table[b, j], stops at ceil(kv_len / bs), and
// stages the page's K and V rows dequantized to fp32 in shared memory
// (float(page) * scale[row, head], _dequant_block, kernel_gen.py:77-80);
// scores, the softmax statistics and P live in shared memory, the fp32
// accumulator in registers, one column per thread. Its body is fp32
// throughout: the TPU kernel casts q and P to the dequantized block's dtype
// (kernel_gen.py:272, :313), which is fp32 there, so q and P are not
// rounded, and tensor cores (bf16 operands) would move that rounding.
//
// Numerics kept from the TPU kernel. bf16 pools: q is scaled in fp32 and
// rounded to bf16 before QK; scores are fp32; P is rounded to bf16 before
// PV (its fp32 values are summed into l); the exponentials run as exp2
// with log2(e) folded in. Both: m, l and acc are fp32; the -1e30 sentinel,
// m_safe = max(m_new, -5e29), the corr = 0 guard when m_prev <= -5e29 and
// l >= 1e-20 are the same, so padding rows of a ragged chunk give finite
// garbage and rows that see no position give zeros, never NaN.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kMaxBlockSize = 64;
using tc::kNegInf;

typedef __nv_bfloat16 bf16;
typedef __nv_fp8_e4m3 fp8;

// ---------------------------------------------------------------------------
// bf16 pools: split KV on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;   // 4 warps x 16 rows
constexpr int kTcRows = 64;       // query rows (s, g) a block
constexpr int kTcKv = 64;         // kv rows a ring stage; splits are whole stages

struct TcParams {
  const bf16* q;          // [B, s_q, hq, D]
  const bf16* k;          // [NB, bs, hkv, D]
  const bf16* v;
  const int* page_table;  // [B, mb]
  const int* kv_lens;     // [B]
  const int* q_lens;      // [B] or nullptr (decode)
  bf16* out;              // like q
  float* ws_acc;          // [B, hkv, R, splits, D] (splits > 1)
  float2* ws_ml;          // [B, hkv, R, splits]: (m, l)
  int s_q, hq, hkv, bs, mb, splits;
  float scale;
};

template <int D>
size_t tc_smem() {   // the q tile and a ring of two (k, v) tiles
  return (size_t)(kTcRows + 4 * kTcKv) * (D + 8) * sizeof(bf16);
}

// grid (B, hkv, row tiles x splits), kTcThreads threads.
template <int D>
__global__ void __launch_bounds__(kTcThreads) paged_attention_mma_kernel(const TcParams p) {
  constexpr int LD = D + 8, TK = kTcKv * LD, CH = D / 8;
  const int b = blockIdx.x, hk = blockIdx.y;
  const int tile = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int group = p.hq / p.hkv, R = p.s_q * group;
  const int r0 = tile * kTcRows, rows = min(kTcRows, R - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long row0 = ((long long)b * p.hkv + hk) * R + r0;   // workspace row of r0

  const int kv_len = p.kv_lens[b];
  const int q_start = kv_len - (p.q_lens != nullptr ? p.q_lens[b] : 1);
  const int kv_end = min(kv_len, p.mb * p.bs);
  // The kv tiles up to the last position the tile's rows can see; this
  // split takes tiles split, split + splits, split + 2 splits, ...
  const int end = min(kv_end, q_start + (r0 + rows - 1) / group + 1);
  const int tiles = end > 0 ? (end + kTcKv - 1) / kTcKv : 0;
  const int nt = tiles > split ? (tiles - split + p.splits - 1) / p.splits : 0;
  if (nt == 0) {   // zero weight: out = 0 with one split, else (m, l) = (-1e30, 0)
    for (int r = threadIdx.x; r < rows; r += kTcThreads) {
      if (p.splits > 1) {
        p.ws_ml[(row0 + r) * p.splits + split] = make_float2(kNegInf, 0.f);
        continue;
      }
      const int rr = r0 + r, s = rr / group, h = hk * group + rr % group;
      bf16* o = p.out + (((long long)b * p.s_q + s) * p.hq + h) * D;
      for (int d = 0; d < D; ++d) o[d] = __float2bfloat16(0.f);
    }
    return;
  }

  extern __shared__ uint4 tc_smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem_raw);   // [kTcRows][LD]
  bf16* k_s = q_s + kTcRows * LD;                     // [2][kTcKv][LD]
  bf16* v_s = k_s + 2 * TK;                           // [2][kTcKv][LD]

  // The tile's q rows (zeros past R), gathered by (s, h).
  const bf16* qb = p.q + (long long)b * p.s_q * p.hq * D;
  for (int i = threadIdx.x; i < kTcRows * CH; i += kTcThreads) {
    const int r = i / CH, c = (i % CH) * 8, rr = r0 + r;
    const bool in = r < rows;
    const long long off = in ? ((long long)(rr / group) * p.hq + hk * group + rr % group) * D + c : 0;
    tc::cp_async_16(q_s + r * LD + c, qb + off, in);
  }
  const int* table = p.page_table + (long long)b * p.mb;
  auto load_kv = [&](int jt, int st) {
    const int pos0 = (split + jt * p.splits) * kTcKv;
    for (int i = threadIdx.x; i < kTcKv * CH; i += kTcThreads) {
      const int r = i / CH, c = (i % CH) * 8, pos = pos0 + r;
      const bool live = pos < kv_end;   // rows past kv_len are zero-filled
      const long long off =
          live ? (((long long)table[pos / p.bs] * p.bs + pos % p.bs) * p.hkv + hk) * D + c : 0;
      tc::cp_async_16(k_s + st * TK + r * LD + c, p.k + off, live);
      tc::cp_async_16(v_s + st * TK + r * LD + c, p.v + off, live);
    }
  };
  load_kv(0, 0);
  tc::cp_async_commit();

  // This warp's rows [rw0, rw0 + 16) of the tile; the lane's are g and
  // g + 8, whose causal limits (inclusive positions) are lim[0], lim[1].
  const int rw0 = warp * 16;
  const bool active = rw0 < rows;
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) lim[i] = q_start + (r0 + rw0 + g + 8 * i) / group;
  const int lim_lo = q_start + (r0 + rw0) / group, lim_hi = q_start + (r0 + rw0 + 15) / group;

  tc::cp_async_wait<0>();
  __syncthreads();
  // q scaled in fp32 and rounded to bf16 (kernel_gen.py:252, :272), then
  // held in registers as A fragments.
  tc::scale_rows<kTcRows, D, kTcThreads>(q_s, q_s, p.scale);
  __syncthreads();
  uint32_t qf[D / 16][4];
  tc::load_a<D>(qf, q_s, rw0, lane);

  float acc[D / 8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int jt = 0; jt < nt; ++jt) {
    const int st = jt & 1, pos0 = (split + jt * p.splits) * kTcKv;
    tc::cp_async_wait<0>();
    __syncthreads();   // tile jt has landed; every warp is done with tile jt - 1
    if (jt + 1 < nt) {
      load_kv(jt + 1, st ^ 1);   // in flight during this tile's products
      tc::cp_async_commit();
    }
    // No real row, or a tile past every row's limit: m, l, acc unchanged.
    if (!active || pos0 > lim_hi) continue;
    float s[kTcKv / 8][4];
    tc::dot_16xN<D, kTcKv>(s, qf, k_s + st * TK, lane);   // bf16(q scale) . k
    // Tiles at kv_len or at a row's causal limit test each pair.
    const bool mask = pos0 + kTcKv > kv_end || pos0 + kTcKv - 1 > lim_lo;
    if (mask) {
#pragma unroll
      for (int j = 0; j < kTcKv / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = pos0 + 8 * j + 2 * t + (e & 1);
          if (pos >= kv_end || pos > lim[e >> 1]) s[j][e] = kNegInf;
        }
    }
    // Online softmax (kernel_gen.py:298-305), P rounded to bf16 (:313);
    // acc += bf16(p) . v.
    tc::online_softmax_pv<D, kTcKv>(s, mask, m, l, acc, v_s + st * TK, lane);
  }
  if (!active) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = tc::quad_sum(l[i]);
  if (p.splits > 1) {
    // Unnormalised partials, fp32, for the combine.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rw0 + g + 8 * i;
      if (r >= rows) continue;
      const long long w = (row0 + r) * p.splits + split;
      float* a = p.ws_acc + w * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(a + 8 * j + 2 * t) =
            make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
      if (t == 0) p.ws_ml[w] = make_float2(m[i], l[i]);
    }
    return;
  }
  // One split: out = acc / max(l, 1e-20), staged through this warp's own
  // rows of q_s (only it read them) and stored 16 bytes at a time.
  float lmax[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) lmax[i] = fmaxf(l[i], 1e-20f);
  bf16* stage = q_s + rw0 * LD;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(stage + g * LD + 8 * j + 2 * t) =
        tc::pack_bf16(acc[j][0] / lmax[0], acc[j][1] / lmax[0]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + 8 * j + 2 * t) =
        tc::pack_bf16(acc[j][2] / lmax[1], acc[j][3] / lmax[1]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8, rr = r0 + rw0 + r;
    if (rw0 + r >= rows) continue;
    bf16* o = p.out + (((long long)b * p.s_q + rr / group) * p.hq + hk * group + rr % group) * D;
    *reinterpret_cast<uint4*>(o + c) = *reinterpret_cast<const uint4*>(stage + r * LD + c);
  }
}

// Merges each row's splits in split order (see the note); a warp a row,
// D / 32 columns a lane. grid ceil(B * hkv * R / 4), 128 threads.
template <int D>
__global__ void __launch_bounds__(128) paged_attention_combine_kernel(const TcParams p,
                                                                      long long n_rows) {
  constexpr int C = D / 32;
  const long long row = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const float2* ml = p.ws_ml + row * p.splits;
  float m = kNegInf;
  for (int i = 0; i < p.splits; ++i) {
    const float2 v = ml[i];
    if (v.y > 0.f) m = fmaxf(m, v.x);
  }
  float l = 0.f, a[C];
#pragma unroll
  for (int c = 0; c < C; ++c) a[c] = 0.f;
  for (int i = 0; i < p.splits; ++i) {
    const float2 v = ml[i];
    if (!(v.y > 0.f)) continue;   // no weight; its acc was never written
    const float w = expf(v.x - m);
    l += v.y * w;
    const float* src = p.ws_acc + (row * p.splits + i) * D + lane * C;
#pragma unroll
    for (int c = 0; c < C; ++c) a[c] += src[c] * w;
  }
  const float lmax = fmaxf(l, 1e-20f);
  const int group = p.hq / p.hkv, R = p.s_q * group;
  const long long bhk = row / R;
  const int r = (int)(row % R), b = (int)(bhk / p.hkv), hk = (int)(bhk % p.hkv);
  bf16* o = p.out + (((long long)b * p.s_q + r / group) * p.hq + hk * group + r % group) * D +
            lane * C;
#pragma unroll
  for (int c = 0; c < C; c += 2)
    *reinterpret_cast<uint32_t*>(o + c) = tc::pack_bf16(a[c] / lmax, a[c + 1] / lmax);
}

template <int D>
int launch_mma(const TcParams& p, int batch, cudaStream_t stream) {
  const size_t smem = tc_smem<D>();
  auto kernel = paged_attention_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int R = p.s_q * (p.hq / p.hkv);
  const long long z = (long long)((R + kTcRows - 1) / kTcRows) * p.splits;
  if (z > 65535 || p.hkv > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<dim3(batch, p.hkv, (unsigned)z), kTcThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  const long long n_rows = (long long)batch * p.hkv * R;
  paged_attention_combine_kernel<D><<<(unsigned)((n_rows + 3) / 4), 128, 0, stream>>>(p, n_rows);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Quantized pools: the first design, fp32 throughout
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;   // 4 warps
constexpr int kRows = 32;       // query rows (s, g) per block
constexpr int kPad = 4;         // staged fp32 rows of D + 4 (16-byte rows)

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

__device__ __forceinline__ float dequant(int8_t v, float s) { return (float)v * s; }
__device__ __forceinline__ float dequant(fp8 v, float s) { return (float)v * s; }

template <int D>
size_t smem_bytes(int bs) {
  return (size_t)(kRows + 2 * bs) * (D + kPad) * sizeof(float) +
         (size_t)(kRows * bs + 3 * kRows) * sizeof(float);
}

template <int D, typename TP>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const bf16* __restrict__ q,
                       const TP* __restrict__ k_pages,
                       const TP* __restrict__ v_pages,
                       const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       const int* __restrict__ page_table,
                       const int* __restrict__ kv_lens,
                       const int* __restrict__ q_lens,   // nullptr: decode
                       bf16* __restrict__ out,
                       int s_q, int hq, int hkv, int bs, int mb, float scale) {
  static_assert(kThreads % D == 0 && kRows % (kThreads / D) == 0, "tile");
  constexpr int LD = D + kPad;
  constexpr int kVec = 16 / (int)sizeof(TP);     // elements a 16-byte load
  constexpr int kChunks = D / kVec;              // 16-byte chunks per row
  constexpr int kRowGroups = kThreads / D;       // threads per column
  constexpr int kAccRows = kRows / kRowGroups;   // acc rows per thread

  const int b = blockIdx.x;
  const int hk = blockIdx.y;
  const int group = hq / hkv;
  const int r0 = blockIdx.z * kRows;
  const int rows = min(kRows, s_q * group - r0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);        // [kRows][LD]
  float* k_s = q_s + kRows * LD;                          // [bs][LD]
  float* v_s = k_s + bs * LD;                             // [bs][LD]
  float* p_s = v_s + bs * LD;                             // [kRows][bs]
  float* m_s = p_s + kRows * bs;                          // [kRows]
  float* l_s = m_s + kRows;                               // [kRows]
  float* c_s = l_s + kRows;                               // [kRows]

  const int kv_len = kv_lens[b];
  const int q_len = q_lens != nullptr ? q_lens[b] : 1;
  const int q_start = kv_len - q_len;   // absolute position of local query 0

  // q tile: scaled in fp32 (kernel_gen.py:252), not rounded (:272).
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float val = 0.f;
    if (r < rows) {
      const int s = (r0 + r) / group, h = hk * group + (r0 + r) % group;
      val = __bfloat162float(q[(((size_t)b * s_q + s) * hq + h) * D + d]) * scale;
    }
    q_s[r * LD + d] = val;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  float acc[kAccRows];
#pragma unroll
  for (int i = 0; i < kAccRows; ++i) acc[i] = 0.f;
  const int dcol = tid % D;
  const int rgrp = tid / D;   // this thread's rows: rgrp + i * kRowGroups

  const int num_pages = min((kv_len + bs - 1) / bs, mb);
  __syncthreads();

  for (int j = 0; j < num_pages; ++j) {
    const int blk = page_table[(size_t)b * mb + j];
    for (int i = tid; i < bs * kChunks; i += kThreads) {
      const int c = i / kChunks, chunk = i % kChunks;
      const size_t row = ((size_t)blk * bs + c) * hkv + hk;
      const size_t off = row * D + chunk * kVec;
      const bool live = j * bs + c < kv_len;
      const uint4 kk = *reinterpret_cast<const uint4*>(k_pages + off);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (live) vv = *reinterpret_cast<const uint4*>(v_pages + off);
      // Dequantize as staged: float(page) * scale[row, head]; V rows past
      // kv_len are zeroed.
      const float ks = k_scales[row];
      const float vs = live ? v_scales[row] : 0.f;
      const TP* ke = reinterpret_cast<const TP*>(&kk);
      const TP* ve = reinterpret_cast<const TP*>(&vv);
      float* kd = k_s + c * LD + chunk * kVec;
      float* vd = v_s + c * LD + chunk * kVec;
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        *reinterpret_cast<float4*>(kd + e) = make_float4(
            dequant(ke[e], ks), dequant(ke[e + 1], ks),
            dequant(ke[e + 2], ks), dequant(ke[e + 3], ks));
        *reinterpret_cast<float4*>(vd + e) = make_float4(
            dequant(ve[e], vs), dequant(ve[e + 1], vs),
            dequant(ve[e + 2], vs), dequant(ve[e + 3], vs));
      }
    }
    __syncthreads();

    // Scores of the tile's real rows, with the ragged causal mask
    // (decode is q_len 1, s 0).
    for (int i = tid; i < rows * bs; i += kThreads) {
      const int r = i / bs, c = i % bs;
      float sc = kNegInf;
      const int pos = j * bs + c;
      if (pos < kv_len && pos <= q_start + (r0 + r) / group) {
        float dot = 0.f;
        const float4* qp = reinterpret_cast<const float4*>(q_s + r * LD);
        const float4* kp = reinterpret_cast<const float4*>(k_s + c * LD);
#pragma unroll 8
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 a = qp[d4], k4 = kp[d4];
          dot = fmaf(a.x, k4.x, dot);
          dot = fmaf(a.y, k4.y, dot);
          dot = fmaf(a.z, k4.z, dot);
          dot = fmaf(a.w, k4.w, dot);
        }
        sc = dot;
      }
      p_s[r * bs + c] = sc;
    }
    __syncthreads();

    // Online softmax, one warp per real row (kernel_gen.py:298-305).
    for (int r = warp; r < rows; r += kThreads / 32) {
      float mx = kNegInf;
      for (int c = lane; c < bs; c += 32) mx = fmaxf(mx, p_s[r * bs + c]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = fmaxf(m_new, kNegInf / 2);
      float sum = 0.f;
      for (int c = lane; c < bs; c += 32) {
        const float sc = p_s[r * bs + c];
        const float p = sc > kNegInf / 2 ? expf(sc - m_safe) : 0.f;
        sum += p;
        // P is cast to the V block's dtype before PV (kernel_gen.py:313):
        // fp32 here, so it is not rounded.
        p_s[r * bs + c] = p;
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

    // acc = acc * corr + P @ V, one output column per thread; rows past
    // the tile's real rows (a decode tile holds `group` of them) are
    // skipped, uniformly across the block.
#pragma unroll
    for (int i = 0; i < kAccRows; ++i) {
      const int r = rgrp + i * kRowGroups;
      if (r >= rows) break;
      float pv = 0.f;
      for (int c = 0; c < bs; ++c) pv = fmaf(p_s[r * bs + c], v_s[c * LD + dcol], pv);
      acc[i] = acc[i] * c_s[r] + pv;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kAccRows; ++i) {
    const int r = rgrp + i * kRowGroups;
    if (r < rows) {
      const int s = (r0 + r) / group, h = hk * group + (r0 + r) % group;
      const float l = fmaxf(l_s[r], 1e-20f);
      out[(((size_t)b * s_q + s) * hq + h) * D + dcol] = __float2bfloat16(acc[i] / l);
    }
  }
}

template <int D, typename TP>
int launch_quant(const void* q, const void* k_pages, const void* v_pages,
                 const void* k_scales, const void* v_scales,
                 const void* page_table, const void* kv_lens, const void* q_lens,
                 void* out, int batch, int s_q, int hq, int hkv, int bs, int mb,
                 float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(bs);
  auto kernel = paged_attention_kernel<D, TP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch, hkv, (s_q * (hq / hkv) + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const TP*>(k_pages),
      static_cast<const TP*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales),
      static_cast<const int*>(page_table), static_cast<const int*>(kv_lens),
      static_cast<const int*>(q_lens), static_cast<bf16*>(out),
      s_q, hq, hkv, bs, mb, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_kind(int page_kind, const void* q, const void* k_pages,
                const void* v_pages, const void* k_scales,
                const void* v_scales, const void* page_table,
                const void* kv_lens, const void* q_lens, void* out, int batch,
                int s_q, int hq, int hkv, int bs, int mb, float scale,
                void* workspace, int kv_splits, cudaStream_t st) {
  if (page_kind == 0) {
    TcParams p = {};
    p.q = static_cast<const bf16*>(q);
    p.k = static_cast<const bf16*>(k_pages);
    p.v = static_cast<const bf16*>(v_pages);
    p.page_table = static_cast<const int*>(page_table);
    p.kv_lens = static_cast<const int*>(kv_lens);
    p.q_lens = static_cast<const int*>(q_lens);
    p.out = static_cast<bf16*>(out);
    const long long ws_rows = (long long)batch * hkv * s_q * (hq / hkv) * kv_splits;
    p.ws_acc = static_cast<float*>(workspace);
    p.ws_ml = reinterpret_cast<float2*>(p.ws_acc + ws_rows * D);
    p.s_q = s_q; p.hq = hq; p.hkv = hkv; p.bs = bs; p.mb = mb;
    p.splits = kv_splits;
    p.scale = scale;
    return launch_mma<D>(p, batch, st);
  }
  if (page_kind == 1)
    return launch_quant<D, int8_t>(q, k_pages, v_pages, k_scales, v_scales, page_table,
                                   kv_lens, q_lens, out, batch, s_q, hq, hkv, bs, mb,
                                   scale, st);
  return launch_quant<D, fp8>(q, k_pages, v_pages, k_scales, v_scales, page_table,
                              kv_lens, q_lens, out, batch, s_q, hq, hkv, bs, mb, scale,
                              st);
}

}  // namespace

// q [batch, s_q, hq, D] bf16 (decode: s_q == 1 and q_lens == nullptr),
// pools [NB, bs, hkv, D] of page_kind 0 (bf16), 1 (int8) or 2 (fp8 e4m3),
// k_scales / v_scales [NB, bs, hkv] fp32 for page kinds 1 and 2 (else
// unused), page_table [batch, mb] int32, kv_lens / q_lens [batch] int32, out
// like q. bf16 pools only: kv_splits >= 1 splits of the kv range and, when
// it is above 1, the fp32 workspace of batch * hkv * s_q * (hq / hkv) *
// kv_splits * (D + 2) floats (partial acc, then (m, l) pairs); quantized
// pools take neither. Returns a cudaError_t code (0 = launched).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* page_table,
    const void* kv_lens, const void* q_lens, void* out, int batch, int s_q,
    int hq, int hkv, int head_dim, int block_size, int max_blocks,
    int page_kind, float scale, void* workspace, int kv_splits, void* stream) {
  if (batch < 1 || s_q < 1 || hkv < 1 || hq % hkv != 0 || block_size < 1 ||
      block_size > kMaxBlockSize || max_blocks < 1 || page_kind < 0 ||
      page_kind > 2 || (page_kind > 0 && (k_scales == nullptr || v_scales == nullptr)) ||
      (page_kind == 0 && (kv_splits < 1 || (kv_splits > 1 && workspace == nullptr))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 128)
    return launch_kind<128>(page_kind, q, k_pages, v_pages, k_scales, v_scales,
                            page_table, kv_lens, q_lens, out, batch, s_q, hq,
                            hkv, block_size, max_blocks, scale, workspace,
                            kv_splits, st);
  if (head_dim == 64)
    return launch_kind<64>(page_kind, q, k_pages, v_pages, k_scales, v_scales,
                           page_table, kv_lens, q_lens, out, batch, s_q, hq,
                           hkv, block_size, max_blocks, scale, workspace,
                           kv_splits, st);
  return (int)cudaErrorInvalidValue;
}
