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
// acc/m/l in VMEM; here each block walks its share of the kv tiles in a
// loop, and a second launch merges the shares.
//
// Split KV on the tensor cores (paged_attention_mma_kernel and
// paged_attention_combine_kernel), for every pool type. A block owns (slot b, kv head hk, a tile
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
// Quantized pools (int8 or fp8 e4m3 pages, fp32 scales per (row, kv
// head)) run the same kernel and the same split plan, with two changes.
// Staging: each kv tile's one-byte codes are gathered through the page
// table with 16-byte cp.async into a ring of their own (D / 16 copies a
// row), its scales with 4-byte copies beside them, zero-filled past
// kv_len; once landed, the codes are widened into one bf16 K tile and one
// bf16 V tile, which the ldmatrix loads read. The widening is exact:
// every int8 value and every finite e4m3 value is a bf16 value. Numerics:
// the TPU kernel dequantizes each page to fp32 (_dequant_block,
// kernel_gen.py:77-80) and casts q and P to that dtype (:272, :313), so
// it rounds neither; the tensor cores take bf16 operands, so the kernel
// keeps the scales out of them. q, already bf16, is used as it is, and
// S = (softmax scale x s_k[pos]) x (q . codes): the mma's products of two
// bf16 values are exact and summed in fp32, and the scales multiply the
// C tile's columns in fp32 (the TPU kernel's (q scale) . (code s_k) up to
// the order of fp32 operations). The unrounded fp32 x = P s_v[pos] enters
// P . V as three bf16 terms (t1 = bf16(x), t2 = bf16(x - t1), t3 =
// bf16(x - t1 - t2): 24 significant bits, tc::acc_16xD_split), each one
// mma against the same exact V codes; l sums the unrounded P.
//
// Numerics kept from the TPU kernel. bf16 pools: q is scaled in fp32 and
// rounded to bf16 before QK; scores are fp32; P is rounded to bf16 before
// PV (its fp32 values are summed into l); the exponentials run as exp2
// with log2(e) folded in. Both: m, l and acc are fp32; the -1e30 sentinel,
// m_safe = max(m_new, -5e29), the corr = 0 guard when m_prev <= -5e29 and
// l >= 1e-20 are the same, so padding rows of a ragged chunk give finite
// garbage and rows that see no position give zeros, never NaN.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int kMaxBlockSize = 64;
using tc::kNegInf;

typedef __nv_bfloat16 bf16;
typedef __nv_fp8_e4m3 fp8;

constexpr int kTcThreads = 128;   // 4 warps x 16 rows
constexpr int kTcRows = 64;       // query rows (s, g) a block
constexpr int kTcKv = 64;         // kv rows a ring stage; splits are whole stages
constexpr int kTerms = 3;         // bf16 terms of P s_v on quantized pools

struct TcParams {
  const bf16* q;          // [B, s_q, hq, D]
  const void* k;          // [NB, bs, hkv, D] bf16, int8 or fp8
  const void* v;
  const float* k_scales;  // [NB, bs, hkv] (quantized pools)
  const float* v_scales;
  const int* page_table;  // [B, mb]
  const int* kv_lens;     // [B]
  const int* q_lens;      // [B] or nullptr (decode)
  bf16* out;              // like q
  float* ws_acc;          // [B, hkv, R, splits, D] (splits > 1)
  float2* ws_ml;          // [B, hkv, R, splits]: (m, l)
  int s_q, hq, hkv, bs, mb, splits;
  float scale;
};

// The q tile; for bf16 pools a ring of two (k, v) tiles; for quantized
// pools one widened (k, v) pair, a ring of two (k, v) code tiles and their
// scales.
template <int D, typename TP>
size_t tc_smem() {
  constexpr size_t tile = (size_t)kTcKv * (D + 8) * sizeof(bf16);
  if (std::is_same<TP, bf16>::value) return (size_t)kTcRows * (D + 8) * sizeof(bf16) + 4 * tile;
  return (size_t)kTcRows * (D + 8) * sizeof(bf16) + 2 * tile + 4 * (size_t)kTcKv * D +
         4 * kTcKv * sizeof(float);
}

// grid (B, hkv, row tiles x splits), kTcThreads threads; TP the page type.
template <int D, typename TP>
__global__ void __launch_bounds__(kTcThreads) paged_attention_mma_kernel(const TcParams p) {
  constexpr bool kQuant = !std::is_same<TP, bf16>::value;
  constexpr int LD = D + 8, TK = kTcKv * LD, CH = D / 8;
  constexpr int CC = D / 16, TC = kTcKv * D;   // quantized: 16-byte copies a code row; a code tile
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
  bf16* k_s = q_s + kTcRows * LD;                     // bf16: [2][kTcKv][LD]; else [kTcKv][LD]
  bf16* v_s = k_s + (kQuant ? 1 : 2) * TK;
  uint8_t* kc_s = reinterpret_cast<uint8_t*>(v_s + (kQuant ? 1 : 2) * TK);   // [2][kTcKv][D]
  uint8_t* vc_s = kc_s + 2 * TC;
  float* ks_s = reinterpret_cast<float*>(vc_s + 2 * TC);   // [2][kTcKv]
  float* vs_s = ks_s + 2 * kTcKv;

  // The tile's q rows (zeros past R), gathered by (s, h).
  const bf16* qb = p.q + (long long)b * p.s_q * p.hq * D;
  for (int i = threadIdx.x; i < kTcRows * CH; i += kTcThreads) {
    const int r = i / CH, c = (i % CH) * 8, rr = r0 + r;
    const bool in = r < rows;
    const long long off = in ? ((long long)(rr / group) * p.hq + hk * group + rr % group) * D + c : 0;
    tc::cp_async_16(q_s + r * LD + c, qb + off, in);
  }
  const int* table = p.page_table + (long long)b * p.mb;
  // The (row, kv head) index of kv position pos in the pools.
  auto pool_row = [&](int pos) {
    return ((long long)table[pos / p.bs] * p.bs + pos % p.bs) * p.hkv + hk;
  };
  auto load_kv = [&](int jt, int st) {
    const int pos0 = (split + jt * p.splits) * kTcKv;
    if constexpr (!kQuant) {
      const bf16* k = static_cast<const bf16*>(p.k);
      const bf16* v = static_cast<const bf16*>(p.v);
      for (int i = threadIdx.x; i < kTcKv * CH; i += kTcThreads) {
        const int r = i / CH, c = (i % CH) * 8, pos = pos0 + r;
        const bool live = pos < kv_end;   // rows past kv_len are zero-filled
        const long long off = live ? pool_row(pos) * D + c : 0;
        tc::cp_async_16(k_s + st * TK + r * LD + c, k + off, live);
        tc::cp_async_16(v_s + st * TK + r * LD + c, v + off, live);
      }
    } else {
      const uint8_t* k = static_cast<const uint8_t*>(p.k);
      const uint8_t* v = static_cast<const uint8_t*>(p.v);
      for (int i = threadIdx.x; i < kTcKv * CC; i += kTcThreads) {
        const int r = i / CC, c = (i % CC) * 16, pos = pos0 + r;
        const bool live = pos < kv_end;
        const long long off = live ? pool_row(pos) * D + c : 0;
        tc::cp_async_16(kc_s + st * TC + r * D + c, k + off, live);
        tc::cp_async_16(vc_s + st * TC + r * D + c, v + off, live);
      }
      for (int r = threadIdx.x; r < kTcKv; r += kTcThreads) {
        const int pos = pos0 + r;
        const bool live = pos < kv_end;
        const long long row = live ? pool_row(pos) : 0;
        tc::cp_async_4(ks_s + st * kTcKv + r, p.k_scales + row, live);
        tc::cp_async_4(vs_s + st * kTcKv + r, p.v_scales + row, live);
      }
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
  if constexpr (!kQuant) {
    // q scaled in fp32 and rounded to bf16 (kernel_gen.py:252, :272).
    tc::scale_rows<kTcRows, D, kTcThreads>(q_s, q_s, p.scale);
    __syncthreads();
  }
  // q held in registers as A fragments (quantized pools: q as it came).
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
    const bf16* kt = k_s + st * TK;
    const bf16* vt = v_s + st * TK;
    if constexpr (kQuant) {
      // Widen this tile's codes into the bf16 pair (exact).
      for (int i = threadIdx.x; i < kTcKv * CC; i += kTcThreads) {
        const int r = i / CC, c = (i % CC) * 16;
        uint4 lo, hi;
        tc::widen16(*reinterpret_cast<const uint4*>(kc_s + st * TC + r * D + c), TP(), lo, hi);
        *reinterpret_cast<uint4*>(k_s + r * LD + c) = lo;
        *reinterpret_cast<uint4*>(k_s + r * LD + c + 8) = hi;
        tc::widen16(*reinterpret_cast<const uint4*>(vc_s + st * TC + r * D + c), TP(), lo, hi);
        *reinterpret_cast<uint4*>(v_s + r * LD + c) = lo;
        *reinterpret_cast<uint4*>(v_s + r * LD + c + 8) = hi;
      }
      __syncthreads();
      kt = k_s;
      vt = v_s;
    }
    // No real row, or a tile past every row's limit: m, l, acc unchanged.
    if (!active || pos0 > lim_hi) continue;
    float s[kTcKv / 8][4];
    tc::dot_16xN<D, kTcKv>(s, qf, kt, lane);   // bf16(q scale) . k, or q . codes
    if constexpr (kQuant) {
      // The column scales in fp32: softmax scale x s_k[pos].
#pragma unroll
      for (int j = 0; j < kTcKv / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] *= p.scale * ks_s[st * kTcKv + 8 * j + 2 * t + (e & 1)];
    }
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
    // Online softmax (kernel_gen.py:298-305).
    if constexpr (!kQuant) {
      // P rounded to bf16 (:313); acc += bf16(p) . v.
      tc::online_softmax_pv<D, kTcKv>(s, mask, m, l, acc, vt, lane);
    } else {
      // acc += (P s_v) . codes, P s_v unrounded in kTerms bf16 terms.
      tc::online_softmax<D, kTcKv>(s, mask, m, l, acc);
#pragma unroll
      for (int j = 0; j < kTcKv / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= vs_s[st * kTcKv + 8 * j + 2 * t + (e & 1)];
      tc::acc_16xD_split<D, kTcKv, kTerms>(acc, s, vt, lane);
    }
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

template <int D, typename TP>
int launch_mma(const TcParams& p, int batch, cudaStream_t stream) {
  const size_t smem = tc_smem<D, TP>();
  auto kernel = paged_attention_mma_kernel<D, TP>;
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

template <int D>
int launch_kind(int page_kind, const TcParams& p, int batch, cudaStream_t st) {
  if (page_kind == 0) return launch_mma<D, bf16>(p, batch, st);
  if (page_kind == 1) return launch_mma<D, int8_t>(p, batch, st);
  return launch_mma<D, fp8>(p, batch, st);
}

}  // namespace

// q [batch, s_q, hq, D] bf16 (decode: s_q == 1 and q_lens == nullptr),
// pools [NB, bs, hkv, D] of page_kind 0 (bf16), 1 (int8) or 2 (fp8 e4m3),
// k_scales / v_scales [NB, bs, hkv] fp32 for page kinds 1 and 2 (else
// unused), page_table [batch, mb] int32, kv_lens / q_lens [batch] int32, out
// like q; kv_splits >= 1 splits of the kv range and, when it is above 1,
// the fp32 workspace of batch * hkv * s_q * (hq / hkv) * kv_splits * (D +
// 2) floats (partial acc, then (m, l) pairs). Returns a cudaError_t code
// (0 = launched).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* page_table,
    const void* kv_lens, const void* q_lens, void* out, int batch, int s_q,
    int hq, int hkv, int head_dim, int block_size, int max_blocks,
    int page_kind, float scale, void* workspace, int kv_splits, void* stream) {
  if (batch < 1 || s_q < 1 || hkv < 1 || hq % hkv != 0 || block_size < 1 ||
      block_size > kMaxBlockSize || max_blocks < 1 || page_kind < 0 ||
      page_kind > 2 || (page_kind > 0 && (k_scales == nullptr || v_scales == nullptr)) ||
      kv_splits < 1 || (kv_splits > 1 && workspace == nullptr) ||
      (head_dim != 64 && head_dim != 128))
    return (int)cudaErrorInvalidValue;
  TcParams p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = k_pages;
  p.v = v_pages;
  p.k_scales = static_cast<const float*>(k_scales);
  p.v_scales = static_cast<const float*>(v_scales);
  p.page_table = static_cast<const int*>(page_table);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.q_lens = static_cast<const int*>(q_lens);
  p.out = static_cast<bf16*>(out);
  const long long ws_rows = (long long)batch * hkv * s_q * (hq / hkv) * kv_splits;
  p.ws_acc = static_cast<float*>(workspace);
  p.ws_ml = reinterpret_cast<float2*>(p.ws_acc + ws_rows * head_dim);
  p.s_q = s_q; p.hq = hq; p.hkv = hkv; p.bs = block_size; p.mb = max_blocks;
  p.splits = kv_splits;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return head_dim == 128 ? launch_kind<128>(page_kind, p, batch, st)
                         : launch_kind<64>(page_kind, p, batch, st);
}
