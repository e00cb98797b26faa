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
// Design. The TPU kernels carry their accumulators in VMEM across a
// sequential grid axis. Here a thread block owns its output tile and loops
// itself: flash_fwd and flash_bwd_dq take one (b, q head, 64-row q tile) and
// walk the kv tiles up to the causal limit (tiles wholly above the diagonal
// are skipped, as _dispatch_tiles does); flash_bwd_dkv takes one (b, KV
// head, 64-row kv tile) and walks every q head of its GQA group and every q
// tile at or below the diagonal. Summing the group inside the block replaces
// the [B, Hq, S, D] temporaries and the reduction outside the TPU kernel
// (flash_attention.py:1074-1078): each dk/dv row has one writer, so there are
// no atomics and the result does not depend on scheduling. Tiles live in
// shared memory as fp32 (rows padded to D + 1 floats, so the 16 threads of a
// row group read 16 different banks); each of the 256 threads computes a
// 4 x 4 block of the 64 x 64 score tile and owns 4 rows x D/16 columns of
// the accumulators, so the softmax statistics of its rows stay in registers
// and row reductions are 16-lane shuffles.
//
// Numerics kept from the TPU kernels: q is scaled in fp32 and rounded to
// bf16 before QK; scores are fp32; the -1e30 sentinel, m_safe =
// max(m_new, -5e29), corr = 0 while m_prev <= -5e29; P is rounded to bf16
// before PV; acc, m and l are fp32; out = acc / max(l, 1e-20); lse =
// max(m, -5e29) + log(max(l, 1e-20)) where l > 0, else -1e30, so fully
// masked and padding rows give finite zeros. Backward: p = exp(s - lse),
// dp = do . v, ds = p (dp - delta); dq += bf16(ds) . k, times the scale; dv
// += p^T . do and dk += ds^T . (q scale) with p, ds, do and the scaled q in
// fp32 (_bwd_dkv_kernel). Rows past Sq and Skv are zero and masked.
//
// Bound. At the training shapes (S 4096, D 128) attention does 4 S^2 Hq D
// (forward, halved by the causal mask) and 2.5x that (backward) operations
// against O(S Hq D) bytes, far above the card's ridge point: these kernels
// are bound by operations. This first version is simple and right, not
// fast: its products run as fp32 FMA on the CUDA cores (about 1/15 of the
// bf16 tensor-core rate), fed from shared memory with synchronous loads. The
// next steps are mma/wgmma for the products, cp.async or TMA double
// buffering, and bf16 tiles in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;            // q rows per tile
constexpr int kBK = 64;            // kv rows per tile
constexpr int kTC = 16;            // threads per row group
constexpr int kRPT = 4;            // rows per thread (64 rows / 16 groups)
constexpr int kCPT = kBK / kTC;    // score columns per thread
constexpr int kLP = kBK + 1;       // padded score row
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float row_max(float v) {  // over the 16-lane row group
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [row0, row0 + 64) of one head into dst [64][D + 1] fp32, each value
// times `scale` (and rounded to bf16 when `round`); rows >= limit are zero.
template <int D>
__device__ void load_tile(float* dst, const __nv_bfloat16* src, long long row_stride,
                          int row0, int limit, float scale, bool round) {
  constexpr int LD = D + 1;
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    float* d = dst + r * LD + c;
    if (row0 + r < limit) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x = __bfloat162float(e[j]) * scale;
        d[j] = round ? bf16_round(x) : x;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j] = 0.f;
    }
  }
}

__device__ void load_segs(int* dst, const int* seg, int b, int s_len, int row0) {
  for (int i = threadIdx.x; i < 64; i += kThreads)
    dst[i] = row0 + i < s_len ? seg[(long long)b * s_len + row0 + i] : -1;
}

__device__ __forceinline__ bool is_valid(const Params& p, int r, int c, const int* qseg_s,
                                         const int* kseg_s, int rl, int cl) {
  bool ok = r < p.sq && c < p.skv && (!p.causal || r >= c);
  if (p.seg != nullptr) ok = ok && qseg_s[rl] == kseg_s[cl];
  return ok;
}

// s[i][jj] = sum_d a[(tr*4+i), d] * b[(tc + 16*jj), d] over [64][D+1] tiles.
template <int D, bool kRoundA>
__device__ __forceinline__ void tile_dot(float (&s)[kRPT][kCPT], const float* a, const float* b,
                                         int tr, int tc) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < kRPT; ++i)
#pragma unroll
    for (int j = 0; j < kCPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[kRPT], y[kCPT];
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      x[i] = a[(tr * kRPT + i) * LD + d];
      if (kRoundA) x[i] = bf16_round(x[i]);
    }
#pragma unroll
    for (int j = 0; j < kCPT; ++j) y[j] = b[(tc + j * kTC) * LD + d];
#pragma unroll
    for (int i = 0; i < kRPT; ++i)
#pragma unroll
      for (int j = 0; j < kCPT; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// ---------------------------------------------------------------------------
// flash_fwd: grid (q tiles, Hq, B)
// ---------------------------------------------------------------------------

template <int D>
size_t fwd_smem() {
  return (size_t)3 * 64 * (D + 1) * sizeof(float) + 2 * 64 * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int LD = D + 1;
  constexpr int kDPT = D / kTC;
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = iq * kBQ;
  const int tid = threadIdx.x, tr = tid / kTC, tc = tid % kTC;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [64][LD]
  float* k_s = q_s + 64 * LD;        // [64][LD]; P [64][kLP] after the scores
  float* v_s = k_s + 64 * LD;        // [64][LD]
  int* qseg_s = reinterpret_cast<int*>(v_s + 64 * LD);
  int* kseg_s = qseg_s + 64;
  float* p_s = k_s;

  // q scaled in fp32, then rounded to bf16 (flash_attention.py:198, :206).
  load_tile<D>(q_s, p.q + b * p.qsb + h * p.qsh, p.qss, q0, p.sq, p.scale, true);
  if (p.seg != nullptr) load_segs(qseg_s, p.seg, b, p.sq, q0);

  float m[kRPT], l[kRPT], acc[kRPT][kDPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDPT; ++j) acc[i][j] = 0.f;
  }
  int nk = (p.skv + kBK - 1) / kBK;
  if (p.causal) nk = min(nk, (q0 + kBQ - 1) / kBK + 1);   // tiles with k0 <= last q row

  for (int jt = 0; jt < nk; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();               // the previous tile's P and V are consumed
    load_tile<D>(k_s, p.k + b * p.ksb + hk * p.ksh, p.kss, k0, p.skv, 1.f, false);
    load_tile<D>(v_s, p.v + b * p.vsb + hk * p.vsh, p.vss, k0, p.skv, 1.f, false);
    if (p.seg != nullptr) load_segs(kseg_s, p.seg, b, p.skv, k0);
    __syncthreads();

    float s[kRPT][kCPT];
    tile_dot<D, false>(s, q_s, k_s, tr, tc);
    __syncthreads();               // K is read; its space takes P

    float corr[kRPT];
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      const int rl = tr * kRPT + i;
      bool valid[kCPT];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCPT; ++j) {
        const int cl = tc + j * kTC;
        valid[j] = is_valid(p, q0 + rl, k0 + cl, qseg_s, kseg_s, rl, cl);
        if (!valid[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = fmaxf(m_new, kNegInf / 2);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCPT; ++j) {
        const float pr = valid[j] ? expf(s[i][j] - m_safe) : 0.f;
        sum += pr;
        // P is rounded to the V dtype before PV (flash_attention.py:224).
        p_s[rl * kLP + tc + j * kTC] = bf16_round(pr);
      }
      sum = row_sum(sum);
      corr[i] = m[i] <= kNegInf / 2 ? 0.f : expf(fminf(m[i] - m_new, 0.f));
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();

    float pv[kRPT][kDPT];
#pragma unroll
    for (int i = 0; i < kRPT; ++i)
#pragma unroll
      for (int j = 0; j < kDPT; ++j) pv[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float x[kRPT], y[kDPT];
#pragma unroll
      for (int i = 0; i < kRPT; ++i) x[i] = p_s[(tr * kRPT + i) * kLP + c];
#pragma unroll
      for (int j = 0; j < kDPT; ++j) y[j] = v_s[c * LD + tc + j * kTC];
#pragma unroll
      for (int i = 0; i < kRPT; ++i)
#pragma unroll
        for (int j = 0; j < kDPT; ++j) pv[i][j] = fmaf(x[i], y[j], pv[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRPT; ++i)
#pragma unroll
      for (int j = 0; j < kDPT; ++j) acc[i][j] = acc[i][j] * corr[i] + pv[i][j];
  }

#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int r = q0 + tr * kRPT + i;
    if (r >= p.sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
    __nv_bfloat16* o = p.out + (((long long)b * p.sq + r) * p.hq + h) * D;
#pragma unroll
    for (int j = 0; j < kDPT; ++j) o[tc + j * kTC] = __float2bfloat16(acc[i][j] * inv);
    if (tc == 0)
      p.lse[((long long)b * p.hq + h) * p.sq + r] =
          l[i] > 0.f ? fmaxf(m[i], kNegInf / 2) + logf(fmaxf(l[i], 1e-20f)) : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// flash_bwd_dq: grid (q tiles, Hq, B)
// ---------------------------------------------------------------------------

template <int D>
size_t dq_smem() {
  return (size_t)4 * 64 * (D + 1) * sizeof(float) + 4 * 64 * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = D + 1;
  constexpr int kDPT = D / kTC;
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = iq * kBQ;
  const int tid = threadIdx.x, tr = tid / kTC, tc = tid % kTC;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // bf16-rounded scaled q
  float* do_s = q_s + 64 * LD;
  float* k_s = do_s + 64 * LD;
  float* v_s = k_s + 64 * LD;        // dS [64][kLP] after dP
  int* qseg_s = reinterpret_cast<int*>(v_s + 64 * LD);
  int* kseg_s = qseg_s + 64;
  float* lse_s = reinterpret_cast<float*>(kseg_s + 64);
  float* delta_s = lse_s + 64;
  float* ds_s = v_s;

  load_tile<D>(q_s, p.q + b * p.qsb + h * p.qsh, p.qss, q0, p.sq, p.scale, true);
  load_tile<D>(do_s, p.dout + b * p.dsb + h * p.dsh, p.dss, q0, p.sq, 1.f, false);
  if (p.seg != nullptr) load_segs(qseg_s, p.seg, b, p.sq, q0);
  for (int i = tid; i < 64; i += kThreads) {
    const bool in = q0 + i < p.sq;
    const long long row = ((long long)b * p.hq + h) * p.sq + q0 + i;
    lse_s[i] = in ? p.lse_in[row] : 0.f;
    delta_s[i] = in ? p.delta[row] : 0.f;
  }

  float acc[kRPT][kDPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i)
#pragma unroll
    for (int j = 0; j < kDPT; ++j) acc[i][j] = 0.f;
  int nk = (p.skv + kBK - 1) / kBK;
  if (p.causal) nk = min(nk, (q0 + kBQ - 1) / kBK + 1);

  for (int jt = 0; jt < nk; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();
    load_tile<D>(k_s, p.k + b * p.ksb + hk * p.ksh, p.kss, k0, p.skv, 1.f, false);
    load_tile<D>(v_s, p.v + b * p.vsb + hk * p.vsh, p.vss, k0, p.skv, 1.f, false);
    if (p.seg != nullptr) load_segs(kseg_s, p.seg, b, p.skv, k0);
    __syncthreads();

    float s[kRPT][kCPT], dp[kRPT][kCPT];
    tile_dot<D, false>(s, q_s, k_s, tr, tc);
    tile_dot<D, false>(dp, do_s, v_s, tr, tc);
    __syncthreads();               // V is read; its space takes dS

#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      const int rl = tr * kRPT + i;
#pragma unroll
      for (int j = 0; j < kCPT; ++j) {
        const int cl = tc + j * kTC;
        float ds = 0.f;
        if (is_valid(p, q0 + rl, k0 + cl, qseg_s, kseg_s, rl, cl)) {
          const float pr = expf(s[i][j] - lse_s[rl]);
          ds = pr * (dp[i][j] - delta_s[rl]);
        }
        ds_s[rl * kLP + cl] = bf16_round(ds);   // ds.astype(k.dtype), :904
      }
    }
    __syncthreads();

    float part[kRPT][kDPT];
#pragma unroll
    for (int i = 0; i < kRPT; ++i)
#pragma unroll
      for (int j = 0; j < kDPT; ++j) part[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float x[kRPT], y[kDPT];
#pragma unroll
      for (int i = 0; i < kRPT; ++i) x[i] = ds_s[(tr * kRPT + i) * kLP + c];
#pragma unroll
      for (int j = 0; j < kDPT; ++j) y[j] = k_s[c * LD + tc + j * kTC];
#pragma unroll
      for (int i = 0; i < kRPT; ++i)
#pragma unroll
        for (int j = 0; j < kDPT; ++j) part[i][j] = fmaf(x[i], y[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRPT; ++i)
#pragma unroll
      for (int j = 0; j < kDPT; ++j) acc[i][j] += part[i][j] * p.scale;
  }

#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int r = q0 + tr * kRPT + i;
    if (r >= p.sq) continue;
    __nv_bfloat16* o = p.dq + (((long long)b * p.sq + r) * p.hq + h) * D;
#pragma unroll
    for (int j = 0; j < kDPT; ++j) o[tc + j * kTC] = __float2bfloat16(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// flash_bwd_dkv: grid (kv tiles, Hkv, B); the GQA group is summed in-block
// ---------------------------------------------------------------------------

template <int D>
size_t dkv_smem() {
  return (size_t)4 * 64 * (D + 1) * sizeof(float) + (size_t)2 * 64 * kLP * sizeof(float) +
         4 * 64 * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = D + 1;
  constexpr int kDPT = D / kTC;
  const int ik = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.hq / p.hkv;
  const int k0 = ik * kBK;
  const int tid = threadIdx.x, tr = tid / kTC, tc = tid % kTC;

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + 64 * LD;
  float* q_s = v_s + 64 * LD;        // scaled q, fp32 (rounded to bf16 for s)
  float* do_s = q_s + 64 * LD;
  float* p_s = do_s + 64 * LD;       // [64 q][kLP]
  float* ds_s = p_s + 64 * kLP;      // [64 q][kLP]
  int* qseg_s = reinterpret_cast<int*>(ds_s + 64 * kLP);
  int* kseg_s = qseg_s + 64;
  float* lse_s = reinterpret_cast<float*>(kseg_s + 64);
  float* delta_s = lse_s + 64;

  load_tile<D>(k_s, p.k + b * p.ksb + hk * p.ksh, p.kss, k0, p.skv, 1.f, false);
  load_tile<D>(v_s, p.v + b * p.vsb + hk * p.vsh, p.vss, k0, p.skv, 1.f, false);
  if (p.seg != nullptr) load_segs(kseg_s, p.seg, b, p.skv, k0);

  float dk[kRPT][kDPT], dv[kRPT][kDPT];   // kv rows tr*4+i, columns tc+16j
#pragma unroll
  for (int i = 0; i < kRPT; ++i)
#pragma unroll
    for (int j = 0; j < kDPT; ++j) dk[i][j] = dv[i][j] = 0.f;
  const int nq = (p.sq + kBQ - 1) / kBQ;
  const int iq0 = p.causal ? k0 / kBQ : 0;   // q tiles with a row >= k0

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int iq = iq0; iq < nq; ++iq) {
      const int q0 = iq * kBQ;
      __syncthreads();
      load_tile<D>(q_s, p.q + b * p.qsb + h * p.qsh, p.qss, q0, p.sq, p.scale, false);
      load_tile<D>(do_s, p.dout + b * p.dsb + h * p.dsh, p.dss, q0, p.sq, 1.f, false);
      if (p.seg != nullptr) load_segs(qseg_s, p.seg, b, p.sq, q0);
      for (int i = tid; i < 64; i += kThreads) {
        const bool in = q0 + i < p.sq;
        const long long row = ((long long)b * p.hq + h) * p.sq + q0 + i;
        lse_s[i] = in ? p.lse_in[row] : 0.f;
        delta_s[i] = in ? p.delta[row] : 0.f;
      }
      __syncthreads();

      float s[kRPT][kCPT], dp[kRPT][kCPT];
      tile_dot<D, true>(s, q_s, k_s, tr, tc);    // q.astype(k.dtype) . k
      tile_dot<D, false>(dp, do_s, v_s, tr, tc);
#pragma unroll
      for (int i = 0; i < kRPT; ++i) {
        const int rl = tr * kRPT + i;
#pragma unroll
        for (int j = 0; j < kCPT; ++j) {
          const int cl = tc + j * kTC;
          float pr = 0.f, ds = 0.f;
          if (is_valid(p, q0 + rl, k0 + cl, qseg_s, kseg_s, rl, cl)) {
            pr = expf(s[i][j] - lse_s[rl]);
            ds = pr * (dp[i][j] - delta_s[rl]);
          }
          p_s[rl * kLP + cl] = pr;
          ds_s[rl * kLP + cl] = ds;
        }
      }
      __syncthreads();

      // dv += p^T . do ; dk += ds^T . (q scale), all fp32 (:965-971).
#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        float pa[kRPT], da[kRPT], x[kDPT], y[kDPT];
#pragma unroll
        for (int i = 0; i < kRPT; ++i) {
          pa[i] = p_s[r * kLP + tr * kRPT + i];
          da[i] = ds_s[r * kLP + tr * kRPT + i];
        }
#pragma unroll
        for (int j = 0; j < kDPT; ++j) {
          x[j] = do_s[r * LD + tc + j * kTC];
          y[j] = q_s[r * LD + tc + j * kTC];
        }
#pragma unroll
        for (int i = 0; i < kRPT; ++i)
#pragma unroll
          for (int j = 0; j < kDPT; ++j) {
            dv[i][j] = fmaf(pa[i], x[j], dv[i][j]);
            dk[i][j] = fmaf(da[i], y[j], dk[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int c = k0 + tr * kRPT + i;
    if (c >= p.skv) continue;
    const long long base = (((long long)b * p.skv + c) * p.hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < kDPT; ++j) {
      p.dk[base + tc + j * kTC] = __float2bfloat16(dk[i][j]);
      p.dv[base + tc + j * kTC] = __float2bfloat16(dv[i][j]);
    }
  }
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <int D>
int launch(int which, const Params& p, int batch, cudaStream_t stream) {
  void (*kernel)(Params);
  size_t smem;
  dim3 grid;
  if (which == kFwd) {
    kernel = flash_fwd_kernel<D>;
    smem = fwd_smem<D>();
    grid = dim3((p.sq + kBQ - 1) / kBQ, p.hq, batch);
  } else if (which == kDq) {
    kernel = flash_bwd_dq_kernel<D>;
    smem = dq_smem<D>();
    grid = dim3((p.sq + kBQ - 1) / kBQ, p.hq, batch);
  } else {
    kernel = flash_bwd_dkv_kernel<D>;
    smem = dkv_smem<D>();
    grid = dim3((p.skv + kBK - 1) / kBK, p.hkv, batch);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
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
