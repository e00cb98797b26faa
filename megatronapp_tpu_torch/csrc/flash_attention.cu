// Flash attention for Hopper (sm_90a): the forward and the two backward
// kernels of training.
//
// Replaces the TPU kernels of megatronapp_tpu/ops/pallas/flash_attention.py:
//   flash_fwd      <- _flash_forward (_fwd_kernel) and, for D < 128,
//                     _flash_forward_t (_fwd_kernel_t): out and LSE;
//   flash_bwd_dq   <- _bwd_dq_kernel / _bwd_dq_kernel_t / _bwd_dq_kernel_fold;
//   flash_bwd_dkv  <- _bwd_dkv_kernel / _bwd_dkv_kernel_t / _bwd_dkv_kernel_fold.
// The transposed and head-folded TPU variants are layouts for the TPU's
// 128-lane registers; they compute the same functions, which these kernels
// compute at D = 64 and D = 128.
//
// Layout: q [B, Sq, Hq, D], k and v [B, Skv, Hkv, D], read through their
// batch, sequence and head strides (the head dim is contiguous), so the
// caller never transposes; query head h reads kv head h / (Hq / Hkv).
// out, dq [B, Sq, Hq, D] and dk, dv [B, Skv, Hkv, D] are contiguous; lse and
// delta are [B, Hq, Sq] fp32. Optional segment ids [B, S] int32 (self
// attention, Sq == Skv) restrict attention to equal ids.
//
// Design, shared. The TPU kernels carry their accumulators in VMEM across a
// sequential grid axis. Here a thread block owns its output tile and loops
// itself: flash_fwd and flash_bwd_dq take one (b, q head, q tile) and walk
// the kv tiles up to the causal limit (tiles wholly above the diagonal are
// skipped, as _dispatch_tiles does); flash_bwd_dkv takes one (b, KV head,
// kv tile) and walks every q head of its GQA group and every q tile at or
// below the diagonal. Summing the group inside the block replaces the
// [B, Hq, S, D] temporaries and the reduction outside the TPU kernel
// (flash_attention.py:1074-1078): each dk/dv row has one writer, so there are
// no atomics, and a rerun repeats every bit.
//
// Bound. At the training shapes (S 4096, D 128) attention does 4 S^2 Hq D
// (forward, halved by the causal mask) and 2.5x that (backward) operations
// against O(S Hq D) bytes, far above the card's ridge point: these kernels
// are bound by operations, so what matters is that the products run on the
// tensor cores and that the loads hide behind them.
//
// All three kernels have FlashAttention-2's shape (tensor_core.cuh): every
// product is mma.sync m16n8k16 on bf16 operands with fp32 accumulators, fed
// by ldmatrix from bf16 tiles in shared memory (rows padded to D + 8, so
// ldmatrix is conflict-free). Each warp owns 16 output rows. Tiles arrive by
// 16-byte cp.async into a ring of two stages (rows past Sq or Skv are
// zero-filled by the copy's source size): the next tile's copies are issued
// before this tile's products. Scores stay in registers, and p (and ds),
// rounded to bf16, are reused directly as the A fragments of the next
// product (a C tile pair is an A fragment), so neither touches shared
// memory. Blocks of the longest causal rows launch first, so they do not
// make up the last wave.
// - flash_fwd: FwdTiles<D> q rows a block (a warp per 16) and kv rows a
//   ring stage, chosen on the card (PERF.md). The q tile is scaled and
//   rounded once, then each warp holds its 16 rows as A fragments in
//   registers for the whole walk; the ring holds k, v and the kv segment
//   ids. The online softmax runs on the C tiles: a row's values sit in the
//   four lanes of a quad, so its max is two xor shuffles, and the running
//   sum l is kept per lane and summed over the quad once, at the end. The
//   exponentials run as exp2 with log2(e) folded in (as the backward's);
//   m and the LSE stay in natural-log units, which is what the backward's
//   p = exp(s - lse) reads. A warp skips a kv tile that lies wholly above
//   its rows, so a row's result does not depend on the q tile.
// - flash_bwd_dq: 4 warps, a 64-row q tile; q (scaled, rounded) and do stay
//   resident, the ring holds k, v and the kv segment ids. dq += bf16(ds) . k;
//   the scale is applied once in the epilogue.
// - flash_bwd_dkv: a kv tile of 128 rows at D 128 (8 warps; k, v resident;
//   158 KB of shared memory, one block an SM) and of 64 rows at D 64 (4
//   warps; 66 KB), each measured the faster; the ring holds q, do, lse,
//   delta and the q segment ids over the flattened (head, q tile) walk. It
//   computes the transposed scores S^T = k . bf16(q scale)^T and dP^T =
//   v . do^T, so P^T and dS^T come out as A fragments: dv += bf16(p)^T . do,
//   dk += bf16(ds)^T . q, times the scale in the epilogue. A warp skips the
//   q tiles wholly above its rows.
// Pairs are tested one by one only on diagonal, ragged-edge and segment
// tiles; the rest are whole.
//
// Numerics kept from the TPU kernels: q is scaled in fp32 and rounded to
// bf16 before QK; scores are fp32; the -1e30 sentinel, m_safe =
// max(m_new, -5e29), corr = 0 while m_prev <= -5e29; P is rounded to bf16
// before PV; acc, m and l are fp32; out = acc / max(l, 1e-20); lse =
// max(m, -5e29) + log(max(l, 1e-20)) where l > 0, else -1e30, so fully
// masked and padding rows give finite zeros. Backward: p = exp(s - lse) on
// valid pairs only, dp = do . v, ds = p (dp - delta); dq = bf16(ds) . k
// times the scale. One deliberate departure: the TPU's _bwd_dkv_kernel forms
// dv and dk from fp32 p and ds (flash_attention.py:965-971); tensor cores take
// bf16, so p and ds are rounded to bf16 before dv and dk (fp32 accumulation),
// as every GPU flash backward does, and the plain version rounds the same
// way. q and do enter dk and dv unrounded (they are bf16 inputs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using tc::kLog2e;
using tc::kNegInf;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* seg;                  // [B, S] or nullptr
  const __nv_bfloat16* dout;       // [B, Sq, Hq, D] (strides below)
  const float* lse_in;             // [B, Hq, Sq]
  const float* delta;              // [B, Hq, Sq]
  __nv_bfloat16* out;
  float* lse;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh;
  int sq, skv, hq, hkv, causal;
  float scale;
};

// The forward's tiles at head dim D: q rows a block (one warp per 16) and
// kv rows a ring stage. Of 64 or 128 each, the fastest on the card at its
// train shape (tools/flash_probe.py fwd-tiles): 128 and 128 at D 128 (8
// warps, 171 KB of shared memory, one block an SM), 64 and 64 at D 64.
template <int D>
struct FwdTiles {
  static constexpr int kQ = D == 128 ? 128 : 64, kKV = kQ;
};

// kv rows of a dk/dv block, one warp per 16: 128 at D 128 and 64 at D 64,
// each the faster of the two on the card at its train shape.
template <int D>
__host__ __device__ constexpr int dkv_rows() { return D == 128 ? 128 : 64; }

// Rows [row0, row0 + ROWS) of one head into dst [ROWS][D + 8] bf16 by
// 16-byte cp.async; rows >= limit are filled with zeros by the copy.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void async_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long row_stride, int row0, int limit) {
  constexpr int kChunks = D / 8, LD = D + 8;
  static_assert(ROWS * kChunks % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool in = row0 + r < limit;
    tc::cp_async_16(dst + r * LD + c, src + (long long)(in ? row0 + r : 0) * row_stride + c, in);
  }
}

// N four-byte values [i0, i0 + N) of a row (lse, delta or segment ids)
// into dst; zeros past n.
template <int N, int NT>
__device__ __forceinline__ void async_vec(void* dst, const void* src, int i0, int n) {
  for (int i = threadIdx.x; i < N; i += NT) {
    const bool in = i0 + i < n;
    tc::cp_async_4(static_cast<uint32_t*>(dst) + i,
                   static_cast<const uint32_t*>(src) + (in ? i0 + i : 0), in);
  }
}

// C[16 x 64] = A[rows ar0.., D] . B[64, D]^T for one warp, both operands
// [*][D + 8] bf16 tiles in shared memory (c[j]: columns 8j..8j+7).
template <int D>
__device__ __forceinline__ void dot_16x64(float (&c)[8][4], const __nv_bfloat16* a, int ar0,
                                          const __nv_bfloat16* b, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t af[4];
    tc::ldmatrix_x4(af, a + tc::a_off(lane, ar0, kk, LD));
#pragma unroll
    for (int n0 = 0; n0 < 64; n0 += 16) {
      uint32_t bf[4];
      tc::ldmatrix_x4(bf, b + tc::b_off(lane, n0, kk, LD));
      tc::mma_bf16(c[n0 / 8], af, bf[0], bf[1]);
      tc::mma_bf16(c[n0 / 8 + 1], af, bf[2], bf[3]);
    }
  }
}

// A warp's 16 accumulator rows, times mul and rounded to bf16, through its
// own 16 rows of a staging tile (row stride D + 8) to global rows
// [grow0, grow0 + 16) of stride gstride in 16-byte stores; rows >= limit
// are not written.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul,
                                           __nv_bfloat16* stage, __nv_bfloat16* dst,
                                           long long gstride, int grow0, int limit,
                                           int lane) {
  constexpr int LD = D + 8, kChunks = D / 8;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(stage + g * LD + 8 * j + 2 * t) =
        tc::pack_bf16(acc[j][0] * mul, acc[j][1] * mul);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + 8 * j + 2 * t) =
        tc::pack_bf16(acc[j][2] * mul, acc[j][3] * mul);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    if (grow0 + r < limit)
      *reinterpret_cast<uint4*>(dst + (long long)(grow0 + r) * gstride + c) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c);
  }
}

// ---------------------------------------------------------------------------
// flash_fwd: grid (Hq, q tiles, B), a warp per 16 q rows
// ---------------------------------------------------------------------------

template <int D>
size_t fwd_smem() {   // q, and a ring of two (k, v, kv segment ids)
  constexpr int BQ = FwdTiles<D>::kQ, BK = FwdTiles<D>::kKV;
  return (size_t)(BQ + 4 * BK) * (D + 8) * sizeof(__nv_bfloat16) + 2 * BK * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(2 * FwdTiles<D>::kQ) flash_fwd_kernel(const Params p) {
  constexpr int BQ = FwdTiles<D>::kQ, BK = FwdTiles<D>::kKV, NT = 2 * BQ;
  constexpr int LD = D + 8, TK = BK * LD;
  const int h = blockIdx.x, b = blockIdx.z;
  const int iq = (p.sq + BQ - 1) / BQ - 1 - blockIdx.y;   // the longest causal rows first
  const int hk = h / (p.hq / p.hkv);
  const int q0 = iq * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  extern __shared__ uint4 fwd_smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(fwd_smem_raw);   // [BQ][LD]
  __nv_bfloat16* k_s = q_s + BQ * LD;                                   // [2][BK][LD]
  __nv_bfloat16* v_s = k_s + 2 * TK;                                    // [2][BK][LD]
  int* kseg_s = reinterpret_cast<int*>(v_s + 2 * TK);                   // [2][BK]

  const int* seg = p.seg == nullptr ? nullptr : p.seg + (long long)b * p.skv;
  const __nv_bfloat16* kg = p.k + b * p.ksb + hk * p.ksh;
  const __nv_bfloat16* vg = p.v + b * p.vsb + hk * p.vsh;
  auto load_kv = [&](int jt, int st) {
    async_rows<BK, D, NT>(k_s + st * TK, kg, p.kss, jt * BK, p.skv);
    async_rows<BK, D, NT>(v_s + st * TK, vg, p.vss, jt * BK, p.skv);
    if (seg != nullptr) async_vec<BK, NT>(kseg_s + st * BK, seg, jt * BK, p.skv);
  };
  async_rows<BQ, D, NT>(q_s, p.q + b * p.qsb + h * p.qsh, p.qss, q0, p.sq);
  load_kv(0, 0);
  tc::cp_async_commit();

  const int qw0 = q0 + warp * 16;   // this warp's rows; the lane's are g and g + 8
  int qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qw0 + g + 8 * i;
    qseg[i] = seg != nullptr && r < p.sq ? seg[r] : -1;
  }
  int nk = (p.skv + BK - 1) / BK;
  if (p.causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);   // tiles with k0 <= the last q row

  tc::cp_async_wait<0>();
  __syncthreads();
  // q scaled in fp32 and rounded to bf16 (flash_attention.py:198, :206),
  // then held in registers as A fragments for the whole kv walk.
  tc::scale_rows<BQ, D, NT>(q_s, q_s, p.scale);
  __syncthreads();
  uint32_t qf[D / 16][4];
  tc::load_a<D>(qf, q_s, warp * 16, lane);

  float acc[D / 8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int jt = 0; jt < nk; ++jt) {
    const int st = jt & 1, k0 = jt * BK;
    tc::cp_async_wait<0>();
    __syncthreads();   // tile jt has landed; every warp is done with tile jt - 1
    if (jt + 1 < nk) {
      load_kv(jt + 1, st ^ 1);   // in flight during this tile's products
      tc::cp_async_commit();
    }
    // No row of this warp is valid, or the tile lies wholly above them:
    // the tile would leave m, l and acc as they are.
    if (qw0 >= p.sq || (p.causal && qw0 + 15 < k0)) continue;
    float s[BK / 8][4];
    tc::dot_16xN<D, BK>(s, qf, k_s + st * TK, lane);   // bf16(q scale) . k
    // Diagonal, ragged and segment tiles test each pair; the rest are whole.
    const bool mask = seg != nullptr || k0 + BK > p.skv || (p.causal && qw0 < k0 + BK - 1);
    if (mask) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, cl = 8 * j + 2 * t + (e & 1);
          const int r = qw0 + g + 8 * i, c = k0 + cl;
          bool ok = c < p.skv && (!p.causal || r >= c);
          if (seg != nullptr) ok = ok && qseg[i] == kseg_s[st * BK + cl];
          if (!ok) s[j][e] = kNegInf;
        }
    }
    // P rounded to V's dtype (:224); acc += bf16(p) . v.
    tc::online_softmax_pv<D, BK>(s, mask, m, l, acc, v_s + st * TK, lane);
  }

  float lmax[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = tc::quad_sum(l[i]);
    lmax[i] = fmaxf(l[i], 1e-20f);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] /= lmax[0];
    acc[j][1] /= lmax[0];
    acc[j][2] /= lmax[1];
    acc[j][3] /= lmax[1];
  }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = qw0 + g + 8 * i;
      if (r < p.sq)
        p.lse[((long long)b * p.hq + h) * p.sq + r] =
            l[i] > 0.f ? fmaxf(m[i], kNegInf / 2) + logf(lmax[i]) : kNegInf;
    }
  }
  // Each warp stages its own 16 rows of q_s, which only it read.
  store_rows<D>(acc, 1.f, q_s + warp * 16 * LD,
                p.out + ((long long)b * p.sq * p.hq + h) * D, (long long)p.hq * D, qw0, p.sq,
                lane);
}

// ---------------------------------------------------------------------------
// flash_bwd_dq: grid (Hq, q tiles, B), 4 warps of 16 q rows
// ---------------------------------------------------------------------------

constexpr int kDqThreads = 128;   // 4 warps x 16 q rows of a 64-row q tile

template <int D>
size_t dq_smem() {   // q, do, and a ring of two (k, v, kv segment ids)
  return (size_t)6 * 64 * (D + 8) * sizeof(__nv_bfloat16) + 2 * 64 * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(kDqThreads, 2) flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = D + 8, T = 64 * LD, NT = kDqThreads;
  const int h = blockIdx.x, b = blockIdx.z;
  const int iq = (p.sq + 63) / 64 - 1 - blockIdx.y;   // the longest causal rows first
  const int hk = h / (p.hq / p.hkv);
  const int q0 = iq * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  extern __shared__ uint4 dq_smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(dq_smem_raw);
  __nv_bfloat16* do_s = q_s + T;
  __nv_bfloat16* k_s = do_s + T;     // [2][64][LD]
  __nv_bfloat16* v_s = k_s + 2 * T;  // [2][64][LD]
  int* kseg_s = reinterpret_cast<int*>(v_s + 2 * T);   // [2][64]

  const int* seg = p.seg == nullptr ? nullptr : p.seg + (long long)b * p.skv;
  const __nv_bfloat16* kg = p.k + b * p.ksb + hk * p.ksh;
  const __nv_bfloat16* vg = p.v + b * p.vsb + hk * p.vsh;
  auto load_kv = [&](int jt, int st) {
    async_rows<64, D, NT>(k_s + st * T, kg, p.kss, jt * 64, p.skv);
    async_rows<64, D, NT>(v_s + st * T, vg, p.vss, jt * 64, p.skv);
    if (seg != nullptr) async_vec<64, NT>(kseg_s + st * 64, seg, jt * 64, p.skv);
  };
  async_rows<64, D, NT>(q_s, p.q + b * p.qsb + h * p.qsh, p.qss, q0, p.sq);
  async_rows<64, D, NT>(do_s, p.dout + b * p.dsb + h * p.dsh, p.dss, q0, p.sq);
  load_kv(0, 0);
  tc::cp_async_commit();

  // This lane's rows g and g + 8 of the warp's 16: lse (times log2 e),
  // delta and segment id.
  const int qw0 = q0 + warp * 16;
  float lse2[2], dlt[2];
  int qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qw0 + g + 8 * i;
    const bool in = r < p.sq;
    const long long row = ((long long)b * p.hq + h) * p.sq + r;
    lse2[i] = in ? p.lse_in[row] * kLog2e : 0.f;
    dlt[i] = in ? p.delta[row] : 0.f;
    qseg[i] = seg != nullptr && in ? seg[r] : -1;
  }
  int nk = (p.skv + 63) / 64;
  if (p.causal) nk = min(nk, (q0 + 63) / 64 + 1);   // tiles with k0 <= the last q row

  tc::cp_async_wait<0>();
  __syncthreads();
  // q scaled in fp32 and rounded to bf16 (flash_attention.py:198, :206).
  tc::scale_rows<64, D, NT>(q_s, q_s, p.scale);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int jt = 0; jt < nk; ++jt) {
    const int st = jt & 1, k0 = jt * 64;
    tc::cp_async_wait<0>();
    __syncthreads();   // tile jt has landed; every warp is done with tile jt - 1
    if (jt + 1 < nk) {
      load_kv(jt + 1, st ^ 1);   // in flight during this tile's products
      tc::cp_async_commit();
    }
    const __nv_bfloat16* kt = k_s + st * T;
    float s[8][4], ds[8][4];
    dot_16x64<D>(s, q_s, warp * 16, kt, lane);           // bf16(q scale) . k
    dot_16x64<D>(ds, do_s, warp * 16, v_s + st * T, lane);   // dp = do . v
    // Diagonal, ragged and segment tiles test each pair; the rest are whole.
    const bool mask = seg != nullptr || k0 + 64 > p.skv || (p.causal && qw0 < k0 + 63);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, cl = 8 * j + 2 * t + (e & 1);
        float pr = tc::exp2_approx(fmaf(s[j][e], kLog2e, -lse2[i]));
        if (mask) {
          const int r = qw0 + g + 8 * i, c = k0 + cl;
          bool ok = r < p.sq && c < p.skv && (!p.causal || r >= c);
          if (seg != nullptr) ok = ok && qseg[i] == kseg_s[st * 64 + cl];
          if (!ok) pr = 0.f;
        }
        ds[j][e] = pr * (ds[j][e] - dlt[i]);
      }
    uint32_t da[4][4];   // ds.astype(k.dtype) (:904), as A fragments
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) tc::pack_a(da[kc], ds[2 * kc], ds[2 * kc + 1]);
    tc::acc_16xD<D>(acc, da, kt, lane);                      // dq += bf16(ds) . k
  }

  // Each warp stages its own 16 rows of q_s, which only it reads.
  store_rows<D>(acc, p.scale, q_s + warp * 16 * LD,
                p.dq + ((long long)b * p.sq * p.hq + h) * D, (long long)p.hq * D, qw0, p.sq,
                lane);
}

// ---------------------------------------------------------------------------
// flash_bwd_dkv: grid (Hkv, kv tiles, B), a warp per 16 kv rows; the GQA
// group is summed in-block
// ---------------------------------------------------------------------------

template <int D>
size_t dkv_smem() {   // k, v; a ring of two (q, do, lse, delta, q segment ids); bf16(q scale)
  return (size_t)(2 * dkv_rows<D>() + 5 * 64) * (D + 8) * sizeof(__nv_bfloat16) +
         (size_t)3 * 2 * 64 * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(2 * dkv_rows<D>(), 1) flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = D + 8, T = 64 * LD, ROWS = dkv_rows<D>(), NT = 2 * ROWS;
  const int hk = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * ROWS;   // y = 0 first: the longest causal walk
  const int group = p.hq / p.hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  extern __shared__ uint4 dkv_smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(dkv_smem_raw);   // [ROWS][LD]
  __nv_bfloat16* v_s = k_s + ROWS * LD;                                  // [ROWS][LD]
  __nv_bfloat16* q_s = v_s + ROWS * LD;                                  // [2][64][LD]
  __nv_bfloat16* do_s = q_s + 2 * T;                                     // [2][64][LD]
  __nv_bfloat16* qs_s = do_s + 2 * T;                                    // [64][LD]
  float* lse_s = reinterpret_cast<float*>(qs_s + T);                     // [2][64]
  float* dlt_s = lse_s + 2 * 64;                                         // [2][64]
  int* qseg_s = reinterpret_cast<int*>(dlt_s + 2 * 64);                  // [2][64]

  const int nq = (p.sq + 63) / 64;
  const int iq0 = p.causal ? min(k0 / 64, nq) : 0;   // q tiles with a row >= k0
  const int per_head = nq - iq0, steps = group * per_head;
  const int* seg = p.seg == nullptr ? nullptr : p.seg + (long long)b * p.skv;

  // Step i of the walk: q head hk * group + i / per_head, q tile iq0 + i % per_head.
  auto load_q = [&](int i, int st) {
    const int h = hk * group + i / per_head, q0 = (iq0 + i % per_head) * 64;
    async_rows<64, D, NT>(q_s + st * T, p.q + b * p.qsb + h * p.qsh, p.qss, q0, p.sq);
    async_rows<64, D, NT>(do_s + st * T, p.dout + b * p.dsb + h * p.dsh, p.dss, q0, p.sq);
    const long long row = ((long long)b * p.hq + h) * p.sq;
    async_vec<64, NT>(lse_s + st * 64, p.lse_in + row, q0, p.sq);
    async_vec<64, NT>(dlt_s + st * 64, p.delta + row, q0, p.sq);
    if (seg != nullptr) async_vec<64, NT>(qseg_s + st * 64, seg, q0, p.sq);
  };
  async_rows<ROWS, D, NT>(k_s, p.k + b * p.ksb + hk * p.ksh, p.kss, k0, p.skv);
  async_rows<ROWS, D, NT>(v_s, p.v + b * p.vsb + hk * p.vsh, p.vss, k0, p.skv);
  if (steps > 0) load_q(0, 0);
  tc::cp_async_commit();

  const int kw0 = k0 + warp * 16;   // this warp's kv rows
  int kseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = kw0 + g + 8 * i;
    kseg[i] = seg != nullptr && r < p.skv ? seg[r] : -1;
  }
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int i = 0; i < steps; ++i) {
    const int st = i & 1, q0 = (iq0 + i % per_head) * 64;
    tc::cp_async_wait<0>();
    __syncthreads();   // step i has landed; every warp is done with step i - 1
    if (i + 1 < steps) {
      load_q(i + 1, st ^ 1);   // in flight during this step's products
      tc::cp_async_commit();
    }
    // S^T needs bf16(q scale) (as the forward's scores); dK takes q itself.
    tc::scale_rows<64, D, NT>(qs_s, q_s + st * T, p.scale);
    __syncthreads();
    if (kw0 >= p.skv || (p.causal && kw0 > q0 + 63)) continue;   // no valid pair
    const __nv_bfloat16* dot = do_s + st * T;
    float s[8][4], dp[8][4];   // transposed: rows kv, columns q
    dot_16x64<D>(s, k_s, warp * 16, qs_s, lane);
    dot_16x64<D>(dp, v_s, warp * 16, dot, lane);
    const bool mask = seg != nullptr || q0 + 64 > p.sq || kw0 + 16 > p.skv ||
                      (p.causal && q0 < kw0 + 15);
    const float* lse = lse_s + st * 64;
    const float* dlt = dlt_s + st * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, cl = 8 * j + 2 * t + (e & 1);
        float pr = tc::exp2_approx(fmaf(s[j][e], kLog2e, -lse[cl] * kLog2e));
        if (mask) {
          const int kr = kw0 + g + 8 * r, c = q0 + cl;
          bool ok = c < p.sq && kr < p.skv && (!p.causal || c >= kr);
          if (seg != nullptr) ok = ok && kseg[r] == qseg_s[st * 64 + cl];
          if (!ok) pr = 0.f;
        }
        s[j][e] = pr;
        dp[j][e] = pr * (dp[j][e] - dlt[cl]);
      }
    // P^T and dS^T rounded to bf16 as A fragments: dv += p^T . do and
    // dk += ds^T . q (times the scale at the end).
    uint32_t xa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) tc::pack_a(xa[kc], s[2 * kc], s[2 * kc + 1]);
    tc::acc_16xD<D>(dv, xa, dot, lane);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) tc::pack_a(xa[kc], dp[2 * kc], dp[2 * kc + 1]);
    tc::acc_16xD<D>(dk, xa, q_s + st * T, lane);
  }

  // Each warp stages its own 16 rows of k_s and v_s, which only it reads.
  const long long obase = ((long long)b * p.skv * p.hkv + hk) * D;
  store_rows<D>(dk, p.scale, k_s + warp * 16 * LD, p.dk + obase, (long long)p.hkv * D, kw0,
                p.skv, lane);
  store_rows<D>(dv, 1.f, v_s + warp * 16 * LD, p.dv + obase, (long long)p.hkv * D, kw0,
                p.skv, lane);
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <int D>
int launch(int which, const Params& p, int batch, cudaStream_t stream) {
  void (*kernel)(Params);
  size_t smem;
  dim3 grid;
  int threads;
  if (which == kFwd) {
    kernel = flash_fwd_kernel<D>;
    smem = fwd_smem<D>();
    grid = dim3(p.hq, (p.sq + FwdTiles<D>::kQ - 1) / FwdTiles<D>::kQ, batch);
    threads = 2 * FwdTiles<D>::kQ;
  } else if (which == kDq) {
    kernel = flash_bwd_dq_kernel<D>;
    smem = dq_smem<D>();
    grid = dim3(p.hq, (p.sq + 63) / 64, batch);
    threads = kDqThreads;
  } else {
    kernel = flash_bwd_dkv_kernel<D>;
    smem = dkv_smem<D>();
    grid = dim3(p.hkv, (p.skv + dkv_rows<D>() - 1) / dkv_rows<D>(), batch);
    threads = 2 * dkv_rows<D>();
  }
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int run(int which, const void* q, const void* k, const void* v, const void* seg,
        const void* dout, const void* lse_in, const void* delta, void* out0,
        void* out1, const long long* strides, int batch, int sq, int skv, int hq,
        int hkv, int head_dim, int causal, float scale, void* stream) {
  if (batch < 1 || sq < 1 || skv < 1 || hkv < 1 || hq % hkv != 0 ||
      batch > 65535 || hq > 65535 || (seg != nullptr && sq != skv))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.seg = static_cast<const int*>(seg);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse_in = static_cast<const float*>(lse_in);
  p.delta = static_cast<const float*>(delta);
  if (which == kFwd) {
    p.out = static_cast<__nv_bfloat16*>(out0);
    p.lse = static_cast<float*>(out1);
  } else if (which == kDq) {
    p.dq = static_cast<__nv_bfloat16*>(out0);
  } else {
    p.dk = static_cast<__nv_bfloat16*>(out0);
    p.dv = static_cast<__nv_bfloat16*>(out1);
  }
  p.qsb = strides[0]; p.qss = strides[1]; p.qsh = strides[2];
  p.ksb = strides[3]; p.kss = strides[4]; p.ksh = strides[5];
  p.vsb = strides[6]; p.vss = strides[7]; p.vsh = strides[8];
  p.dsb = strides[9]; p.dss = strides[10]; p.dsh = strides[11];
  p.sq = sq; p.skv = skv; p.hq = hq; p.hkv = hkv; p.causal = causal;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 128) return launch<128>(which, p, batch, st);
  if (head_dim == 64) return launch<64>(which, p, batch, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: 12 element strides (batch, sequence, head) of q, k, v and dout
// (dout's are unused by the forward). seg [B, S] int32 or null. Each returns
// a cudaError_t code (0 = launched).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* seg, void* out, void* lse,
                                const long long* strides, int batch, int sq,
                                int skv, int hq, int hkv, int head_dim,
                                int causal, float scale, void* stream) {
  return run(kFwd, q, k, v, seg, nullptr, nullptr, nullptr, out, lse, strides,
             batch, sq, skv, hq, hkv, head_dim, causal, scale, stream);
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                                   const void* seg, const void* dout,
                                   const void* lse, const void* delta, void* dq,
                                   const long long* strides, int batch, int sq,
                                   int skv, int hq, int hkv, int head_dim,
                                   int causal, float scale, void* stream) {
  return run(kDq, q, k, v, seg, dout, lse, delta, dq, nullptr, strides, batch,
             sq, skv, hq, hkv, head_dim, causal, scale, stream);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* seg, const void* dout,
                                    const void* lse, const void* delta, void* dk,
                                    void* dv, const long long* strides, int batch,
                                    int sq, int skv, int hq, int hkv,
                                    int head_dim, int causal, float scale,
                                    void* stream) {
  return run(kDkv, q, k, v, seg, dout, lse, delta, dk, dv, strides, batch, sq,
             skv, hq, hkv, head_dim, causal, scale, stream);
}
