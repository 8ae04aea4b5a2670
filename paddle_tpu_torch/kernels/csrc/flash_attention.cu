// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/flash_attention.py:_fwd_kernel (forward) and
// :_bwd_fused_kernel (the single-kv-block backward the BERT-base path takes
// at S = 512); the backward here is written for any S, so it also covers
// what :_bwd_dq_kernel and :_bwd_dkv_kernel compute.
//
// Bound on the H100: at BERT-base (B=64, H=12, S=512, D=64) the forward does
// 4*B*H*S*S*D = 51.5 GFLOP against ~200 MB of q, k, v, o, so at the
// tensor-core rate it is byte-bound (~61 us).  The reference's backward does
// 5 products, 10*B*H*S*S*D = 129 GFLOP (0.130 ms at 989 TFLOP/s) against
// ~400 MB (0.120 ms): bound by the operations.  The port's backward does 7
// (180 GFLOP): dq is summed inside the one block that owns its q rows,
// never by atomics across kv blocks, so the dq kernel recomputes s and dp.
// That costs 2 of 7 products against an atomic dq (FlashAttention-2's
// schedule) and keeps the port's rule: no atomics, the same bits every run.
//
// Two routes each way, chosen by dtype (kernels/flash_attention.py
// _fwd_route, _bwd_route): bf16 runs flash_fwd_mma_kernel and
// flash_bwd_{dkv,dq}_mma_kernel on the tensor cores; f32 runs
// flash_fwd_kernel and flash_bwd_{dkv,dq}_kernel, f32 FMAs on the CUDA cores
// (f32 on tensor cores would be TF32, another result).
//
// Design:
// - q, k, v, o are [B, S, H*D] row-major ("packed"; a contiguous
//   [B, S, H, D] tensor has the same layout): a block reads its head's D
//   columns in place through row stride H*D and column offset h*D, so no
//   transpose ever touches device memory.
// - Tensor-core forward (FA2-style, mma.sync m16n8k16, bf16 in, f32 sums):
//   one block per (q tile of 16 rows a warp, b*h).  Q is copied once into
//   shared memory and from there into registers (ldmatrix); 64-row K and V
//   tiles stream through a two-stage cp.async ring (16-byte copies, rows past
//   Sk and columns past D zero-filled), swizzled so ldmatrix reads are free
//   of bank conflicts.  S = Q K^T takes K through plain ldmatrix; the online
//   softmax runs in registers in the log2 domain (each row's max and sum over
//   the four lanes that hold it; masks only on the tiles that need them);
//   p is rounded to bf16 straight from the
//   accumulator layout into the A operand of P V (the reference's
//   p.astype(v.dtype)), which takes V through ldmatrix.trans.  o goes out
//   through the warp's own Q rows in shared memory as 16-byte stores.
// - FMA forward: one block per (64-row q tile, b*h), looping over 64-row kv
//   tiles held in shared memory as f32.
// - Both: running max m from -1e30, running sum l, o = acc / max(l, 1e-30),
//   lse = m + log l; p rounded to the input dtype before p.v.
// - Backward (both routes): delta = rowsum(do * o) by one warp per row; then
//   a dk/dv kernel (one block per kv tile, looping over q tiles) and a dq
//   kernel (one block per q tile, looping over kv tiles), each recomputing
//   p = exp(s - lse).  ds = p * (do.v^T - delta) * scale is rounded to the
//   input dtype before ds.k and ds^T.q, p before p^T.do.  Accumulation is
//   f32 throughout; no atomics.
// - Tensor-core backward: 4 warps of 16 rows, 64-row tiles, the forward's
//   helpers.  dk/dv works in the transposed orientation (s^T = K_w q^T), so
//   p^T and ds^T are born in the A-operand layout of p^T.do and ds^T.q; dq
//   is the forward's structure with a second score product.  Both stream
//   the other side's tiles through a two-stage cp.async ring.  lse is
//   scaled by log2(e) as it is read (the softmax runs on ex2); masked
//   positions, and rows past Sq or Sk, get p = 0 directly.
// - FMA kernels: causal masking writes -1e30 and skips tiles entirely in the
//   future; positions past Sk score -inf.

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kBQ = 64;        // q rows per tile
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 256;  // 16 x 16: each thread a 4 x 4 patch of a tile
constexpr float kNegInf = -1e30f;
constexpr int kSP = kBK + 1;   // pitch of the [kBQ][kBK] score tiles

template <int DMAX>
struct Smem {
  static constexpr int P = DMAX + 1;  // pitch of [rows][D] tiles (no conflicts)
};

// rows [r0, r0 + 64) of one head's [S, D] slice into a [64][P] f32 tile;
// rows past S are zero
template <typename T, int P>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int S, long long row_stride, int D) {
  for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    dst[r * P + d] = (r0 + r < S) ? ptt::to_f(src[(long long)(r0 + r) * row_stride + d]) : 0.f;
  }
}

// s[i][j] = A[ty*4+i] . B[tx+16j] over D, for a [64][P] A and B
template <int P>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A,
                                         const float* Bm, int D, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * P + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bm[(tx + 16 * j) * P + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Sk, int D,
                 float scale, int causal) {
  constexpr int P = Smem<DMAX>::P;
  constexpr int NJ = DMAX / 16;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + kBQ * P;
  float* Vs = Ks + kBK * P;
  float* Ps = Vs + kBK * P;  // [kBQ][kSP]
  __shared__ float m_s[kBQ], l_s[kBQ], alpha_s[kBQ];

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const long long rs = (long long)H * D;
  const T* qb = q + (long long)b * Sq * rs + (long long)h * D;
  const T* kb = k + (long long)b * Sk * rs + (long long)h * D;
  const T* vb = v + (long long)b * Sk * rs + (long long)h * D;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile<T, P>(Qs, qb, q0, Sq, rs, D);
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int kv_end = causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, P>(Ks, kb, k0, Sk, rs, D);
    load_tile<T, P>(Vs, vb, k0, Sk, rs, D);
    __syncthreads();

    float s[4][4];
    tile_dot<P>(s, Qs, Ks, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        float val = s[i][j] * scale;
        if (k0 + c >= Sk) val = -INFINITY;  // past the end: exp gives 0
        else if (causal && k0 + c > q0 + r) val = kNegInf;
        Ps[r * kSP + c] = val;
      }
    __syncthreads();

    {  // online softmax: four threads to a row, sixteen columns each
      const int r = tid >> 2, part = tid & 3;
      float* row = Ps + r * kSP + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(row[c] - m_new);
        sum += p;
        row[c] = ptt::round_to<T>(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * kSP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[kk * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  T* ob = o + (long long)b * Sq * rs + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) ob[(long long)(q0 + r) * rs + c] = ptt::from_f<T>(acc[i][j] / l);
    }
  }
  if (tid < kBQ && q0 + tid < Sq)
    lse[(long long)bh * Sq + q0 + tid] = m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

constexpr float kLn2 = 0.69314718055994531f;
constexpr float kLog2e = 1.4426950408889634f;

// bf16 forward on the tensor cores; kMmaWarps warps of 16 q rows each, DP =
// D rounded up to 64 or 128 (columns past D are zero in every tile).  With
// 4 warps, D <= 64 takes about 165 registers, so three blocks share an SM; a
// 128-row tile of 8 warps fits one block an SM and ran slower.  scale2
// is scale * log2(e): the softmax runs in the log2 domain (p = 2^(s - m)
// on the special-function unit), so m, and the masking values, are
// log2-scaled scores.
constexpr int kMmaWarps = 4;

template <int DP>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int H, int Sq, int Sk, int D, float scale2, int causal) {
  constexpr int BQ = kMmaWarps * 16;  // q rows a block
  constexpr int CH = DP / 8;          // 16-byte chunks a row
  constexpr int NT = kMmaWarps * 32;
  constexpr int NS = kBK / 8;   // n8 tiles of a score row
  constexpr int ND = DP / 8;    // n8 tiles of an output row
  using bf16 = __nv_bfloat16;
  constexpr uint32_t kTile = kBK * DP * 2;  // bytes of one K or V tile
  extern __shared__ uint4 fwd_mma_smem[];
  const uint32_t sQ = ptt::smem_addr(fwd_mma_smem);  // [BQ][DP] bf16
  const uint32_t sK = sQ + BQ * DP * 2;              // [2][kBK][DP]
  const uint32_t sV = sK + 2 * kTile;                // [2][kBK][DP]

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const int rs = H * D;  // offsets inside one batch row of q, k, v fit in
                         // 32 bits: S * H * D < 2^31 (checked by the caller)
  const bf16* qb = q + (long long)b * Sq * rs + h * D;
  const bf16* kb = k + (long long)b * Sk * rs + h * D;
  const bf16* vb = v + (long long)b * Sk * rs + h * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;     // the warp's first row in the tile
  const int dch = D / 8;        // chunks that hold data

  for (int idx = tid; idx < BQ * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = q0 + r < Sq && c < dch;
    ptt::cp_async16(sQ + ptt::swz<CH>(r, c), qb + (ok ? (q0 + r) * rs + c * 8 : 0), ok);
  }
  auto load_kv = [&](int stage, int k0) {
    for (int idx = tid; idx < kBK * CH; idx += NT) {
      const int r = idx / CH, c = idx % CH;
      const bool ok = k0 + r < Sk && c < dch;
      const int at = ok ? (k0 + r) * rs + c * 8 : 0;
      const uint32_t dst = stage * kTile + ptt::swz<CH>(r, c);
      ptt::cp_async16(sK + dst, kb + at, ok);
      ptt::cp_async16(sV + dst, vb + at, ok);
    }
  };

  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  ptt::cp_async_commit();  // Q
  load_kv(0, 0);
  ptt::cp_async_commit();  // the first K, V tile

  // Q's fragments into registers once, while the first K, V tile lands
  uint32_t qf[DP / 16][4];
  ptt::cp_async_wait<1>();
  __syncthreads();
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc)
    ptt::ldmatrix_x4(qf[kc], sQ + ptt::swz<CH>(wr + (lane & 15), 2 * kc + (lane >> 4)));
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1, k0 = it * kBK;
    if (it + 1 < n_tiles) {
      load_kv(stage ^ 1, k0 + kBK);
      ptt::cp_async_commit();
      ptt::cp_async_wait<1>();
    } else {
      ptt::cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t Kt = sK + stage * kTile, Vt = sV + stage * kTile;

    // s = q k^T: a 16 x 64 tile a warp, n8 tile n holding keys k0 + 8n..
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc)
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t bk[4];  // keys 16jp..16jp+15, columns 16kc..16kc+15
        ptt::ldmatrix_x4(bk, Kt + ptt::swz<CH>(16 * jp + (lane & 7) + ((lane >> 4) << 3),
                                               2 * kc + ((lane >> 3) & 1)));
        ptt::mma_bf16_16816(s[2 * jp], qf[kc], bk[0], bk[1]);
        ptt::mma_bf16_16816(s[2 * jp + 1], qf[kc], bk[2], bk[3]);
      }

    // scale; mask only the tiles that reach past Sk or, causal, past the
    // warp's first row; e < 2 is row g, e >= 2 row g + 8
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= scale2;
    if (k0 + kBK > Sk || (causal && k0 + kBK - 1 > q0 + wr)) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * n + 2 * t + (e & 1);
          const int row = q0 + wr + g + 8 * (e >> 1);
          if (col >= Sk) s[n][e] = -INFINITY;  // past the end: exp gives 0
          else if (causal && col > row) s[n][e] = kNegInf;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = ptt::exp2_approx(m_r[r] - m_new);
      m_r[r] = m_new;
    }
    // p, rounded to bf16 and packed as soon as it exists (the f32 scores
    // die here): pp[n][0] holds row g's pair of n8 tile n, pp[n][1] row g + 8's
    uint32_t pp[NS][2];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = ptt::exp2_approx(s[n][2 * r] - m_r[r]);
        const float p1 = ptt::exp2_approx(s[n][2 * r + 1] - m_r[r]);
        sum[r] += p0 + p1;
        pp[n][r] = ptt::pack_bf16(p0, p1);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_r[r] = l_r[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // acc += p v: p's accumulator tiles 2kc, 2kc + 1 are the A operand of
    // keys 16kc..16kc+15
#pragma unroll
    for (int kc = 0; kc < NS / 2; ++kc) {
      const uint32_t pa[4] = {pp[2 * kc][0], pp[2 * kc][1], pp[2 * kc + 1][0],
                              pp[2 * kc + 1][1]};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t bv[4];  // keys 16kc.., columns 16dp..16dp+15
        ptt::ldmatrix_x4_trans(bv, Vt + ptt::swz<CH>(16 * kc + (lane & 7) + (((lane >> 3) & 1) << 3),
                                                     2 * dp + (lane >> 4)));
        ptt::mma_bf16_16816(acc[2 * dp], pa, bv[0], bv[1]);
        ptt::mma_bf16_16816(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }

  // o = acc / l in bf16, through the warp's own (already consumed) Q rows
  char* Qs = reinterpret_cast<char*>(fwd_mma_smem);
  float l_c[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l_c[r] = fmaxf(l_r[r], 1e-30f);
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(Qs + ptt::swz<CH>(wr + g + 8 * r, n) + 4 * t) =
          ptt::pack_bf16(acc[n][2 * r] / l_c[r], acc[n][2 * r + 1] / l_c[r]);
  __syncwarp();
  bf16* ob = o + (long long)b * Sq * rs + h * D;
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, c = idx % CH;
    if (q0 + wr + r < Sq && c < dch)
      *reinterpret_cast<uint4*>(ob + (q0 + wr + r) * rs + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + ptt::swz<CH>(wr + r, c));
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wr + g + 8 * r;
      if (row < Sq) lse[(long long)bh * Sq + row] = m_r[r] * kLn2 + logf(l_c[r]);
    }
  }
}

// delta[b, h, s] = sum_d do * o, one warp per (b, s, h) row
template <typename T>
__global__ void __launch_bounds__(256)
flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                   float* __restrict__ delta, int H, int Sq, int D,
                   long long rows) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + row * D;  // row = (b*Sq + s)*H + h in the packed layout
  const T* drow = dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += ptt::to_f(drow[d]) * ptt::to_f(orow[d]);
  acc = ptt::warp_sum(acc);
  if (lane == 0) {
    const long long bs = row / H;
    const int h = (int)(row - bs * H);
    const long long b = bs / Sq, s = bs - b * Sq;
    delta[(b * H + h) * Sq + s] = acc;
  }
}

// p and ds of one (q tile, kv tile) pair into the shared score tiles:
// Ps[r][c] = p rounded to T, dSs[r][c] = ds rounded to T
template <typename T, int P>
__device__ __forceinline__ void bwd_scores(float* Ps, float* dSs,
                                           const float* Qs, const float* Ks,
                                           const float* Vs, const float* dOs,
                                           const float* lse_s, const float* delta_s,
                                           int q0, int k0, int Sq, int Sk, int D,
                                           float scale, int causal, int ty, int tx) {
  float s[4][4], dp[4][4];
  tile_dot<P>(s, Qs, Ks, D, ty, tx);
  tile_dot<P>(dp, dOs, Vs, D, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty * 4 + i, c = tx + 16 * j;
      float sv = s[i][j] * scale;
      if (causal && k0 + c > q0 + r) sv = kNegInf;
      const bool valid = (q0 + r < Sq) && (k0 + c < Sk);
      const float p = valid ? expf(sv - lse_s[r]) : 0.f;
      const float ds = p * (dp[i][j] - delta_s[r]) * scale;
      if (Ps) Ps[r * kSP + c] = ptt::round_to<T>(p);
      dSs[r * kSP + c] = ptt::round_to<T>(ds);
    }
}

__device__ __forceinline__ void load_stats(float* lse_s, float* delta_s,
                                           const float* lse, const float* delta,
                                           long long base, int q0, int Sq) {
  if (threadIdx.x < kBQ) {
    const int r = q0 + threadIdx.x;
    lse_s[threadIdx.x] = r < Sq ? lse[base + r] : 0.f;
    delta_s[threadIdx.x] = r < Sq ? delta[base + r] : 0.f;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int Sq,
                     int Sk, int D, float scale, int causal) {
  constexpr int P = Smem<DMAX>::P;
  constexpr int NJ = DMAX / 16;
  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + kBK * P;
  float* Qs = Vs + kBK * P;
  float* dOs = Qs + kBQ * P;
  float* Ps = dOs + kBQ * P;
  float* dSs = Ps + kBQ * kSP;
  __shared__ float lse_s[kBQ], delta_s[kBQ];

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * kBK;
  const long long rs = (long long)H * D;
  const long long qoff = (long long)b * Sq * rs + (long long)h * D;
  const long long koff = (long long)b * Sk * rs + (long long)h * D;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile<T, P>(Ks, k + koff, k0, Sk, rs, D);
  load_tile<T, P>(Vs, v + koff, k0, Sk, rs, D);
  float adk[4][NJ], adv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  // q tiles whose last row precedes k0 are entirely masked under causal
  const int q_start = causal ? (k0 / kBQ) * kBQ : 0;
  for (int q0 = q_start; q0 < Sq; q0 += kBQ) {
    __syncthreads();
    load_tile<T, P>(Qs, q + qoff, q0, Sq, rs, D);
    load_tile<T, P>(dOs, dout + qoff, q0, Sq, rs, D);
    load_stats(lse_s, delta_s, lse, delta, (long long)bh * Sq, q0, Sq);
    __syncthreads();
    bwd_scores<T, P>(Ps, dSs, Qs, Ks, Vs, dOs, lse_s, delta_s, q0, k0, Sq, Sk,
                     D, scale, causal, ty, tx);
    __syncthreads();
    // dv[c] += sum_r p[r][c] do[r];  dk[c] += sum_r ds[r][c] q[r]
#pragma unroll 4
    for (int r = 0; r < kBQ; ++r) {
      float pc[4], dc[4], dov[NJ], qv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pc[i] = Ps[r * kSP + ty * 4 + i];
        dc[i] = dSs[r * kSP + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dov[j] = dOs[r * P + tx + 16 * j];
        qv[j] = Qs[r * P + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          adv[i][j] = fmaf(pc[i], dov[j], adv[i][j]);
          adk[i][j] = fmaf(dc[i], qv[j], adk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty * 4 + i;
    if (k0 + c >= Sk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        const long long at = koff + (long long)(k0 + c) * rs + d;
        dk[at] = ptt::from_f<T>(adk[i][j]);
        dv[at] = ptt::from_f<T>(adv[i][j]);
      }
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int H, int Sq, int Sk, int D,
                    float scale, int causal) {
  constexpr int P = Smem<DMAX>::P;
  constexpr int NJ = DMAX / 16;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* dOs = Qs + kBQ * P;
  float* Ks = dOs + kBQ * P;
  float* Vs = Ks + kBK * P;
  float* dSs = Vs + kBK * P;
  __shared__ float lse_s[kBQ], delta_s[kBQ];

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const long long rs = (long long)H * D;
  const long long qoff = (long long)b * Sq * rs + (long long)h * D;
  const long long koff = (long long)b * Sk * rs + (long long)h * D;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile<T, P>(Qs, q + qoff, q0, Sq, rs, D);
  load_tile<T, P>(dOs, dout + qoff, q0, Sq, rs, D);
  load_stats(lse_s, delta_s, lse, delta, (long long)bh * Sq, q0, Sq);
  float adq[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) adq[i][j] = 0.f;

  const int kv_end = causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();
    load_tile<T, P>(Ks, k + koff, k0, Sk, rs, D);
    load_tile<T, P>(Vs, v + koff, k0, Sk, rs, D);
    __syncthreads();
    bwd_scores<T, P>(nullptr, dSs, Qs, Ks, Vs, dOs, lse_s, delta_s, q0, k0, Sq,
                     Sk, D, scale, causal, ty, tx);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float dr[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dr[i] = dSs[(ty * 4 + i) * kSP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = Ks[kk * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) adq[i][j] = fmaf(dr[i], kv[j], adq[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) dq[qoff + (long long)(q0 + r) * rs + d] = ptt::from_f<T>(adq[i][j]);
    }
  }
}

// bf16 dk/dv on the tensor cores: one block per (64-row kv tile, b*h),
// kMmaWarps warps of 16 kv rows each, looping over the q tiles.  Every
// product is taken in the transposed orientation, with the warp's own kv
// rows on the left: s^T = K_w q^T and dp^T = V_w do^T come out in the
// accumulator layout of the A operand that p^T and ds^T feed, so
// dv += p^T do and dk += ds^T q take them from registers, rounded to bf16,
// with no trip through shared memory.  The q tiles, with their lse and
// delta, stream through a two-stage cp.async ring.  Each 16-row q chunk
// runs start to end (s^T and dp^T over D, p and ds, then its share of dv
// and dk), so only 16 f32 scores a thread are ever live.  At DP = 64 the
// warp's K and V fragments are held in registers; at DP = 128 the 128 f32
// accumulators leave no room, and they are re-read from shared memory.
template <int DP>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int Sq, int Sk,
                         int D, float scale, int causal) {
  static_assert(kMmaWarps * 16 == kBK, "a block's kv rows are one kv tile");
  constexpr int CH = DP / 8;
  constexpr int NT = kMmaWarps * 32;
  constexpr int KC = DP / 16;  // k16 chunks of a head row
  constexpr int ND = DP / 8;   // n8 tiles of a head row
  constexpr bool kHold = DP <= 64;
  using bf16 = __nv_bfloat16;
  constexpr uint32_t kTile = kBQ * DP * 2;  // bytes of one tile
  extern __shared__ uint4 dkv_mma_smem[];
  char* smem = reinterpret_cast<char*>(dkv_mma_smem);
  const uint32_t sK = ptt::smem_addr(smem);  // [kBK][DP] bf16
  const uint32_t sV = sK + kTile;            // [kBK][DP]
  const uint32_t sQ = sV + kTile;            // [2][kBQ][DP]
  const uint32_t sO = sQ + 2 * kTile;        // [2][kBQ][DP] (do)
  const uint32_t sL = sO + 2 * kTile;        // [2][kBQ] f32 lse
  const uint32_t sD = sL + 2 * kBQ * 4;      // [2][kBQ] f32 delta
  const float* lse_s = reinterpret_cast<const float*>(smem + 6 * kTile);
  const float* delta_s = lse_s + 2 * kBQ;

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * kBK;
  const int rs = H * D;  // S * H * D < 2^31 (checked by the caller)
  const bf16* qb = q + (long long)b * Sq * rs + h * D;
  const bf16* ob = dout + (long long)b * Sq * rs + h * D;
  const bf16* kb = k + (long long)b * Sk * rs + h * D;
  const bf16* vb = v + (long long)b * Sk * rs + h * D;
  const float* lb = lse + (long long)bh * Sq;
  const float* db = delta + (long long)bh * Sq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;  // the warp's first kv row in the tile
  const int dch = D / 8;     // chunks that hold data

  for (int idx = tid; idx < kBK * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = k0 + r < Sk && c < dch;
    const int at = ok ? (k0 + r) * rs + c * 8 : 0;
    ptt::cp_async16(sK + ptt::swz<CH>(r, c), kb + at, ok);
    ptt::cp_async16(sV + ptt::swz<CH>(r, c), vb + at, ok);
  }
  // rows past Sq arrive as zeros: q and do rows, and lse and delta
  auto load_q = [&](int stage, int q0) {
    for (int idx = tid; idx < kBQ * CH; idx += NT) {
      const int r = idx / CH, c = idx % CH;
      const bool ok = q0 + r < Sq && c < dch;
      const int at = ok ? (q0 + r) * rs + c * 8 : 0;
      const uint32_t dst = stage * kTile + ptt::swz<CH>(r, c);
      ptt::cp_async16(sQ + dst, qb + at, ok);
      ptt::cp_async16(sO + dst, ob + at, ok);
    }
    if (tid < kBQ) {
      const bool ok = q0 + tid < Sq;
      const int at = ok ? q0 + tid : 0;
      ptt::cp_async4(sL + (stage * kBQ + tid) * 4, lb + at, ok);
      ptt::cp_async4(sD + (stage * kBQ + tid) * 4, db + at, ok);
    }
  };

  // causal: q tiles that end before k0 are entirely masked (kBQ == kBK)
  const int q_start = causal ? k0 : 0;
  const int n_tiles = q_start < Sq ? (Sq - q_start + kBQ - 1) / kBQ : 0;
  ptt::cp_async_commit();  // K, V
  load_q(0, q_start);
  ptt::cp_async_commit();  // the first q tile
  ptt::cp_async_wait<1>();
  __syncthreads();

  // the warp's K and V rows as A fragments: k16 chunk kc of the head row
  uint32_t kf[kHold ? KC : 1][4], vf[kHold ? KC : 1][4];
  auto frag_addr = [&](uint32_t tile, int kc) {
    return tile + ptt::swz<CH>(wr + (lane & 15), 2 * kc + (lane >> 4));
  };
  if constexpr (kHold) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      ptt::ldmatrix_x4(kf[kc], frag_addr(sK, kc));
      ptt::ldmatrix_x4(vf[kc], frag_addr(sV, kc));
    }
  }
  float adk[ND][4], adv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  const float scale2 = scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1, q0 = q_start + it * kBQ;
    if (it + 1 < n_tiles) {
      load_q(stage ^ 1, q0 + kBQ);
      ptt::cp_async_commit();
      ptt::cp_async_wait<1>();
    } else {
      ptt::cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t Qt = sQ + stage * kTile, Ot = sO + stage * kTile;
    const float* lse_t = lse_s + stage * kBQ;
    const float* delta_t = delta_s + stage * kBQ;
    // masks only where the tile reaches past Sq or, causal, holds a q row
    // before one of the warp's kv rows
    const bool edge = q0 + kBQ > Sq || (causal && k0 + wr + 15 > q0);

    // one chunk at a time (unroll 1): unrolled, ptxas interleaves the four
    // chunks' products and needs 172 registers at DP = 64 and 255 with a
    // spill at DP = 128; the whole backward was no faster
#pragma unroll 1
    for (int jc = 0; jc < kBQ / 16; ++jc) {  // q rows 16jc..16jc+15
      // s^T and dp^T: n8 tile j holds q rows 16jc + 8j..; e < 2 is kv row
      // g, e >= 2 kv row g + 8
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t ka[4], va[4], bq[4], bo[4];
        if constexpr (kHold) {
#pragma unroll
          for (int i = 0; i < 4; ++i) ka[i] = kf[kc][i], va[i] = vf[kc][i];
        } else {
          ptt::ldmatrix_x4(ka, frag_addr(sK, kc));
          ptt::ldmatrix_x4(va, frag_addr(sV, kc));
        }
        const uint32_t at = ptt::swz<CH>(16 * jc + (lane & 7) + ((lane >> 4) << 3),
                                         2 * kc + ((lane >> 3) & 1));
        ptt::ldmatrix_x4(bq, Qt + at);
        ptt::ldmatrix_x4(bo, Ot + at);
        ptt::mma_bf16_16816(s[0], ka, bq[0], bq[1]);
        ptt::mma_bf16_16816(s[1], ka, bq[2], bq[3]);
        ptt::mma_bf16_16816(dp[0], va, bo[0], bo[1]);
        ptt::mma_bf16_16816(dp[1], va, bo[2], bo[3]);
      }
      // p^T = 2^(s^T scale log2e - lse log2e) and ds^T = p^T (dp^T - delta)
      // scale, each rounded to bf16 straight into an A fragment (q rows
      // 16jc.. are the contraction of dv += p^T do and dk += ds^T q)
      uint32_t pa[4], da[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 16 * jc + 8 * j + 2 * t;  // q row in the tile, of e = 0
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_t + c);
        const float nl[2] = {-l2.x * kLog2e, -l2.y * kLog2e}, dl[2] = {d2.x, d2.y};
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = ptt::exp2_approx(fmaf(s[j][e], scale2, nl[e & 1]));
          if (edge) {
            const int col = q0 + c + (e & 1), row = k0 + wr + g + 8 * (e >> 1);
            if (col >= Sq || (causal && row > col)) p[e] = 0.f;
          }
          ds[e] = p[e] * (dp[j][e] - dl[e & 1]) * scale;
        }
        pa[2 * j] = ptt::pack_bf16(p[0], p[1]);
        pa[2 * j + 1] = ptt::pack_bf16(p[2], p[3]);
        da[2 * j] = ptt::pack_bf16(ds[0], ds[1]);
        da[2 * j + 1] = ptt::pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int dc = 0; dc < ND / 2; ++dc) {
        uint32_t bo[4], bq[4];  // q rows 16jc.., head columns 16dc..16dc+15
        const uint32_t at = ptt::swz<CH>(16 * jc + (lane & 7) + (((lane >> 3) & 1) << 3),
                                         2 * dc + (lane >> 4));
        ptt::ldmatrix_x4_trans(bo, Ot + at);
        ptt::ldmatrix_x4_trans(bq, Qt + at);
        ptt::mma_bf16_16816(adv[2 * dc], pa, bo[0], bo[1]);
        ptt::mma_bf16_16816(adv[2 * dc + 1], pa, bo[2], bo[3]);
        ptt::mma_bf16_16816(adk[2 * dc], da, bq[0], bq[1]);
        ptt::mma_bf16_16816(adk[2 * dc + 1], da, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }
  ptt::cp_async_wait<0>();  // no q tiles: the prologue's copies

  // dk, dv in bf16 through the warp's own K, V rows (no other warp reads them)
  char* Ks = smem;
  char* Vs = smem + kTile;
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t at = ptt::swz<CH>(wr + g + 8 * r, n) + 4 * t;
      *reinterpret_cast<uint32_t*>(Ks + at) = ptt::pack_bf16(adk[n][2 * r], adk[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(Vs + at) = ptt::pack_bf16(adv[n][2 * r], adv[n][2 * r + 1]);
    }
  __syncwarp();
  bf16* dkb = dk + (long long)b * Sk * rs + h * D;
  bf16* dvb = dv + (long long)b * Sk * rs + h * D;
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, c = idx % CH;
    if (k0 + wr + r < Sk && c < dch) {
      const uint32_t at = ptt::swz<CH>(wr + r, c);
      const int to = (k0 + wr + r) * rs + c * 8;
      *reinterpret_cast<uint4*>(dkb + to) = *reinterpret_cast<const uint4*>(Ks + at);
      *reinterpret_cast<uint4*>(dvb + to) = *reinterpret_cast<const uint4*>(Vs + at);
    }
  }
}

// bf16 dq on the tensor cores: one block per (64-row q tile, b*h),
// kMmaWarps warps of 16 q rows each, the forward's structure with a second
// score product: q and do fragments in registers, K and V tiles through the
// two-stage cp.async ring; s = q K^T and dp = do V^T both take their tile
// through plain ldmatrix, ds is rounded to bf16 straight into the A operand
// of dq += ds K, which takes K through ldmatrix.trans.  Each 16-column kv
// chunk runs start to end, as in the dk/dv kernel.
template <int DP>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int H, int Sq, int Sk,
                        int D, float scale, int causal) {
  constexpr int BQ = kMmaWarps * 16;  // q rows a block
  constexpr int CH = DP / 8;
  constexpr int NT = kMmaWarps * 32;
  constexpr int KC = DP / 16;
  constexpr int ND = DP / 8;
  using bf16 = __nv_bfloat16;
  constexpr uint32_t kTile = kBK * DP * 2;  // bytes of one K or V tile
  extern __shared__ uint4 dq_mma_smem[];
  char* smem = reinterpret_cast<char*>(dq_mma_smem);
  const uint32_t sQ = ptt::smem_addr(smem);  // [BQ][DP] bf16
  const uint32_t sO = sQ + BQ * DP * 2;      // [BQ][DP] (do)
  const uint32_t sK = sO + BQ * DP * 2;      // [2][kBK][DP]
  const uint32_t sV = sK + 2 * kTile;        // [2][kBK][DP]

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const int rs = H * D;  // S * H * D < 2^31 (checked by the caller)
  const bf16* qb = q + (long long)b * Sq * rs + h * D;
  const bf16* ob = dout + (long long)b * Sq * rs + h * D;
  const bf16* kb = k + (long long)b * Sk * rs + h * D;
  const bf16* vb = v + (long long)b * Sk * rs + h * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int dch = D / 8;

  for (int idx = tid; idx < BQ * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = q0 + r < Sq && c < dch;
    const int at = ok ? (q0 + r) * rs + c * 8 : 0;
    ptt::cp_async16(sQ + ptt::swz<CH>(r, c), qb + at, ok);
    ptt::cp_async16(sO + ptt::swz<CH>(r, c), ob + at, ok);
  }
  auto load_kv = [&](int stage, int k0) {
    for (int idx = tid; idx < kBK * CH; idx += NT) {
      const int r = idx / CH, c = idx % CH;
      const bool ok = k0 + r < Sk && c < dch;
      const int at = ok ? (k0 + r) * rs + c * 8 : 0;
      const uint32_t dst = stage * kTile + ptt::swz<CH>(r, c);
      ptt::cp_async16(sK + dst, kb + at, ok);
      ptt::cp_async16(sV + dst, vb + at, ok);
    }
  };

  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  ptt::cp_async_commit();  // q, do
  load_kv(0, 0);
  ptt::cp_async_commit();  // the first K, V tile

  // each thread's two rows' lse (log2-scaled) and delta, while copies land
  float nl[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    nl[r] = row < Sq ? -lse[(long long)bh * Sq + row] * kLog2e : 0.f;
    dl[r] = row < Sq ? delta[(long long)bh * Sq + row] : 0.f;
  }
  uint32_t qf[KC][4], of[KC][4];
  ptt::cp_async_wait<1>();
  __syncthreads();
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const uint32_t at = ptt::swz<CH>(wr + (lane & 15), 2 * kc + (lane >> 4));
    ptt::ldmatrix_x4(qf[kc], sQ + at);
    ptt::ldmatrix_x4(of[kc], sO + at);
  }
  float adq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[n][e] = 0.f;
  const float scale2 = scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1, k0 = it * kBK;
    if (it + 1 < n_tiles) {
      load_kv(stage ^ 1, k0 + kBK);
      ptt::cp_async_commit();
      ptt::cp_async_wait<1>();
    } else {
      ptt::cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t Kt = sK + stage * kTile, Vt = sV + stage * kTile;
    // masks only where the tile reaches past Sk or, causal, past the
    // warp's first row: kv columns past Sk must give p = 0, not
    // 2^(-lse), which a zero K row would otherwise carry into dq
    const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > q0 + wr);

#pragma unroll 1  // as in the dk/dv kernel: unrolled, it spilled at DP = 64
    for (int jc = 0; jc < kBK / 16; ++jc) {  // kv columns 16jc..16jc+15
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t bk[4], bv[4];  // keys 16jc..16jc+15, columns 16kc..16kc+15
        const uint32_t at = ptt::swz<CH>(16 * jc + (lane & 7) + ((lane >> 4) << 3),
                                         2 * kc + ((lane >> 3) & 1));
        ptt::ldmatrix_x4(bk, Kt + at);
        ptt::ldmatrix_x4(bv, Vt + at);
        ptt::mma_bf16_16816(s[0], qf[kc], bk[0], bk[1]);
        ptt::mma_bf16_16816(s[1], qf[kc], bk[2], bk[3]);
        ptt::mma_bf16_16816(dp[0], of[kc], bv[0], bv[1]);
        ptt::mma_bf16_16816(dp[1], of[kc], bv[2], bv[3]);
      }
      uint32_t da[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = ptt::exp2_approx(fmaf(s[j][e], scale2, nl[r]));
          if (edge) {
            const int col = k0 + 16 * jc + 8 * j + 2 * t + (e & 1);
            const int row = q0 + wr + g + 8 * r;
            if (col >= Sk || (causal && col > row)) p = 0.f;
          }
          ds[e] = p * (dp[j][e] - dl[r]) * scale;
        }
        da[2 * j] = ptt::pack_bf16(ds[0], ds[1]);
        da[2 * j + 1] = ptt::pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int dc = 0; dc < ND / 2; ++dc) {
        uint32_t bk[4];  // keys 16jc.., columns 16dc..16dc+15
        ptt::ldmatrix_x4_trans(bk, Kt + ptt::swz<CH>(16 * jc + (lane & 7) + (((lane >> 3) & 1) << 3),
                                                     2 * dc + (lane >> 4)));
        ptt::mma_bf16_16816(adq[2 * dc], da, bk[0], bk[1]);
        ptt::mma_bf16_16816(adq[2 * dc + 1], da, bk[2], bk[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }

  // dq in bf16 through the warp's own (already consumed) q rows
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(smem + ptt::swz<CH>(wr + g + 8 * r, n) + 4 * t) =
          ptt::pack_bf16(adq[n][2 * r], adq[n][2 * r + 1]);
  __syncwarp();
  bf16* dqb = dq + (long long)b * Sq * rs + h * D;
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, c = idx % CH;
    if (q0 + wr + r < Sq && c < dch)
      *reinterpret_cast<uint4*>(dqb + (q0 + wr + r) * rs + c * 8) =
          *reinterpret_cast<const uint4*>(smem + ptt::swz<CH>(wr + r, c));
  }
}

#ifndef PTT_HOST_EMULATION  // a host build (tests/cuda_emu) takes the kernels alone

template <int DMAX>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kBQ * Smem<DMAX>::P + kBQ * kSP);
}
template <int DMAX>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kBQ * Smem<DMAX>::P + 2 * kBQ * kSP);
}
template <int DMAX>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kBQ * Smem<DMAX>::P + kBQ * kSP);
}

template <typename T, int DMAX>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               int B, int H, int Sq, int Sk, int D, float scale, int causal,
               cudaStream_t s) {
  constexpr size_t smem = fwd_smem<DMAX>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, DMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, DMAX><<<grid, kThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, H, Sq, Sk, D,
      scale, causal);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Sq, int Sk, int D, float scale,
                   int causal, cudaStream_t s) {
  constexpr int BQ = kMmaWarps * 16;
  constexpr size_t smem = sizeof(__nv_bfloat16) * (BQ + 4 * kBK) * DP;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_mma_kernel<DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_mma_kernel<DP><<<grid, kMmaWarps * 32, smem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, (float*)lse, H, Sq, Sk, D, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* delta, void* dq,
               void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
               float scale, int causal, cudaStream_t s) {
  const long long rows = (long long)B * Sq * H;
  flash_delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      (const T*)o, (const T*)dout, (float*)delta, H, Sq, D, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  constexpr size_t smem_kv = dkv_smem<DMAX>();
  e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, DMAX>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkv_kernel<T, DMAX><<<dim3((Sk + kBK - 1) / kBK, B * H), kThreads, smem_kv, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dk, (T*)dv, H, Sq, Sk, D, scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  constexpr size_t smem_q = dq_smem<DMAX>();
  e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DMAX>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<T, DMAX><<<dim3((Sq + kBQ - 1) / kBQ, B * H), kThreads, smem_q, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dq, H, Sq, Sk, D, scale, causal);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bwd_mma(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* delta, void* dq,
                   void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
                   float scale, int causal, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  const long long rows = (long long)B * Sq * H;
  flash_delta_kernel<bf16><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      (const bf16*)o, (const bf16*)dout, (float*)delta, H, Sq, D, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  constexpr size_t tile = sizeof(bf16) * kBQ * DP;
  constexpr size_t smem_kv = 6 * tile + 4 * kBQ * sizeof(float);  // K V, 2x(q do), 2x(lse delta)
  e = cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel<DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkv_mma_kernel<DP><<<dim3((Sk + kBK - 1) / kBK, B * H), kMmaWarps * 32, smem_kv, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, H, Sq, Sk, D, scale,
      causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  constexpr size_t smem_q = 6 * tile;  // q do, 2x(K V)
  e = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_mma_kernel<DP><<<dim3((Sq + kBQ - 1) / kBQ, B * H), kMmaWarps * 32, smem_q, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, H, Sq, Sk, D, scale, causal);
  return (int)cudaGetLastError();
}

#endif  // PTT_HOST_EMULATION

}  // namespace

#ifndef PTT_HOST_EMULATION

// route 0: f32 on the CUDA cores; route 1: bf16 on the tensor cores
// (S * H * D < 2^31)
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int Sq, int Sk,
                             int D, float scale, int causal, int route,
                             void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (D % 8 != 0 || D > 128 || Sk == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 0)
    return D <= 64 ? launch_fwd<float, 64>(q, k, v, o, lse, B, H, Sq, Sk, D, scale, causal, s)
                   : launch_fwd<float, 128>(q, k, v, o, lse, B, H, Sq, Sk, D, scale, causal, s);
  if ((long long)max(Sq, Sk) * H * D >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  return D <= 64 ? launch_fwd_mma<64>(q, k, v, o, lse, B, H, Sq, Sk, D, scale, causal, s)
                 : launch_fwd_mma<128>(q, k, v, o, lse, B, H, Sq, Sk, D, scale, causal, s);
}

// dtype 0 f32, 1 bf16; route 0: f32 on the CUDA cores (f32 only); route 1:
// bf16 on the tensor cores (bf16 only, 16-byte aligned, S * H * D < 2^31)
extern "C" int ptt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* delta, void* dq, void* dk, void* dv, int B,
                             int H, int Sq, int Sk, int D, float scale,
                             int causal, int dtype, int route, void* stream) {
  if (B == 0 || H == 0 || Sq == 0 || Sk == 0) return 0;
  if (D % 8 != 0 || D > 128 || dtype != route) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 0)
    return D <= 64 ? launch_bwd<float, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H,
                                           Sq, Sk, D, scale, causal, s)
                   : launch_bwd<float, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H,
                                            Sq, Sk, D, scale, causal, s);
  if ((long long)max(Sq, Sk) * H * D >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  return D <= 64 ? launch_bwd_mma<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Sq,
                                      Sk, D, scale, causal, s)
                 : launch_bwd_mma<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Sq,
                                       Sk, D, scale, causal, s);
}

#endif  // PTT_HOST_EMULATION
