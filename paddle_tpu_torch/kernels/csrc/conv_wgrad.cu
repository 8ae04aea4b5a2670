// Convolution filter gradient for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/conv.py:_wgrad_kernel (the weight gradient of
// a stride-1 k x k NHWC convolution with pads pl + pr = k - 1):
//
//   dw[i, j, ci, co] = sum_{b,h,w} xp[b, h+i, w+j, ci] * dy[b, h, w, co]
//
// where xp is x padded by pl at the top and left.  x [B, H, W, C] and
// dy [B, H, W, K] are f32 or bf16; dw is f32 [k, k, C, K].
//
// Bound on the H100: at ResNet-50's 3x3 shapes (B = 128) the contraction
// does 2*B*H*W*C*K*k*k = 29.6 GFLOP, which takes 30 us at the bf16
// tensor-core rate, against ~100 MB of x and dy at 56 x 56 (31 us): the two
// bounds are about equal.
//
// Two routes, chosen before the launch (kernels/conv.py _wgrad_route):
// bf16 with C and K multiples of 8 runs wgrad_mma_kernel on the tensor
// cores; f32 (on tensor cores it would be TF32, another result) and bf16 at
// other widths run wgrad_kernel, f32 FMAs on the CUDA cores.
//
// Design (both routes deterministic, no atomics):
// - For each kernel offset (i, j) dw is a product [C, M] x [M, K] over the
//   M = B*H*W output positions.  A block owns one 64 x 64 tile of (C, K) for
//   one offset and a contiguous range of positions (a split of M); the grid
//   covers tiles x offsets on x and splits on y, so the nine offsets of one
//   position range run side by side and read that range of x through L2
//   once, and both 9 tiles at M = 401,408 and 576 tiles at M = 6,272 put a
//   few blocks on every SM.
// - Tensor-core route: 4 warps, each a 32 x 32 f32 accumulator (2 x 4
//   m16n8 tiles of mma.sync m16n8k16).  Each step stages 48 positions of x
//   (the pixel shifted by the offset) and of dy in shared memory as bf16,
//   through a three-stage cp.async ring of 16-byte copies; a row whose
//   shifted pixel falls in the pad, or a position past the split, arrives
//   as zeros (src-size 0), so the pads stay bounds checks with no padded
//   copy of x.  Both tiles sit [position][channel], the contraction on the
//   rows, so A = x^T and B = dy both come from ldmatrix.trans; rows are
//   128 bytes with the 16-byte chunks XOR-swizzled, free of bank conflicts.
// - FMA route: each step stages 32 positions of x and dy in shared memory
//   as f32; 256 threads each accumulate a 4 x 4 patch of the tile.
// - Each block writes its f32 partial tile to partial[split]; a fold kernel
//   sums the splits in a fixed order (with one split the block writes dw).
//   The TPU kernel instead pads and flattens x and dy into copies so that
//   an offset is one row shift of a VMEM tile, and sums over a sequential
//   grid.

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kTC = 64;       // input channels per tile
constexpr int kTK = 64;       // output channels per tile
constexpr int kTM = 32;       // positions staged per step (FMA route)
constexpr int kThreads = 256; // 16 x 16, a 4 x 4 patch each (FMA route)

template <typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
             float* __restrict__ out, int B, int H, int W, int C, int K,
             int k, int pad, long long per_split) {
  __shared__ __align__(16) float As[kTM][kTC];
  __shared__ __align__(16) float Bs[kTM][kTK];

  const int tiles_c = (C + kTC - 1) / kTC, tiles_k = (K + kTK - 1) / kTK;
  int t = blockIdx.x;
  const int kt = t % tiles_k; t /= tiles_k;
  const int ct = t % tiles_c; t /= tiles_c;
  const int off = t;                       // i * k + j
  const int di = off / k - pad, dj = off % k - pad;
  const int c_base = ct * kTC, k_base = kt * kTK;

  const long long M = (long long)B * H * W;
  const long long m_begin = (long long)blockIdx.y * per_split;
  const long long m_end = min(M, m_begin + per_split);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  // loader: a thread fills 4 consecutive channels of rows lr and lr + 16
  const int lc = (tid & 15) * 4, lr = tid >> 4;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (long long m0 = m_begin; m0 < m_end; m0 += kTM) {
#pragma unroll
    for (int rr = 0; rr < kTM; rr += 16) {
      const int row = lr + rr;
      const long long m = m0 + row;
      float av[4] = {0.f, 0.f, 0.f, 0.f}, bv[4] = {0.f, 0.f, 0.f, 0.f};
      if (m < m_end) {
        const int w = (int)(m % W);
        const long long bh = m / W;
        const int h = (int)(bh % H);
        const long long b = bh / H;
        const int xh = h + di, xw = w + dj;
        if (xh >= 0 && xh < H && xw >= 0 && xw < W) {
          const T* px = x + (((b * H + xh) * W + xw) * C) + c_base + lc;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (c_base + lc + q < C) av[q] = ptt::to_f(px[q]);
        }
        const T* pd = dy + m * K + k_base + lc;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (k_base + lc + q < K) bv[q] = ptt::to_f(pd[q]);
      }
      *reinterpret_cast<float4*>(&As[row][lc]) = make_float4(av[0], av[1], av[2], av[3]);
      *reinterpret_cast<float4*>(&Bs[row][lc]) = make_float4(bv[0], bv[1], bv[2], bv[3]);
    }
    __syncthreads();
#pragma unroll 8
    for (int mm = 0; mm < kTM; ++mm) {
      const float4 a = *reinterpret_cast<const float4*>(&As[mm][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[mm][tx * 4]);
      const float ar[4] = {a.x, a.y, a.z, a.w}, br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
    }
    __syncthreads();
  }

  float* dst = out + ((long long)blockIdx.y * k * k + off) * C * K;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int ci = c_base + ty * 4 + r;
    if (ci >= C) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int co = k_base + tx * 4 + c;
      if (co < K) dst[(long long)ci * K + co] = acc[r][c];
    }
  }
}

// 48 positions a step in a three-stage ring: 36 KB of shared memory, so
// five blocks fit on an SM (with at most 102 registers a thread) and
// ResNet-50's 576 tiles at 7 x 7 run in one wave of 660
constexpr int kMT = 48;           // positions staged per step (tensor cores)
constexpr int kStages = 3;        // depth of the cp.async ring
constexpr int kMmaThreads = 128;  // 4 warps, 2 x 2 over the 64 x 64 tile
constexpr int kMmaBlocksPerSM = 5;
constexpr size_t kMmaSmem = sizeof(__nv_bfloat16) * kStages * 2 * kMT * kTC;
constexpr int kRows = kMT / 16;   // staged rows a loader thread fills

// C % 8 == 0 and K % 8 == 0: a 16-byte chunk of 8 channels is wholly inside
// the tile's valid channels or wholly outside
__global__ void __launch_bounds__(kMmaThreads, kMmaBlocksPerSM)
wgrad_mma_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ dy, float* __restrict__ out,
                 int B, int H, int W, int C, int K, int k, int pad,
                 long long per_split) {
  using bf16 = __nv_bfloat16;
  constexpr int CH = kTC / 8;  // 16-byte chunks of a staged row (kTC == kTK)
  constexpr uint32_t kTile = kMT * kTC * 2;  // bytes of one staged x or dy tile
  extern __shared__ uint4 wgrad_mma_smem[];
  const uint32_t sA = ptt::smem_addr(wgrad_mma_smem);  // [kStages][kMT][kTC] x
  const uint32_t sB = sA + kStages * kTile;            // [kStages][kMT][kTK] dy

  const int tiles_c = (C + kTC - 1) / kTC, tiles_k = (K + kTK - 1) / kTK;
  int tt = blockIdx.x;
  const int kt = tt % tiles_k; tt /= tiles_k;
  const int ct = tt % tiles_c; tt /= tiles_c;
  const int off = tt;                      // i * k + j
  const int di = off / k - pad, dj = off % k - pad;
  const int c_base = ct * kTC, k_base = kt * kTK;

  const long long M = (long long)B * H * W;
  const long long m_begin = (long long)blockIdx.y * per_split;
  const long long m_end = min(M, m_begin + per_split);
  const int n_steps = (int)((m_end - m_begin + kMT - 1) / kMT);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wc = (warp & 1) * 32, wk = (warp >> 1) * 32;
  // loader: chunk lch of rows lrow + 16i; (hh[i], ww[i]) is the pixel of
  // the next position that row stages, advanced by kMT a load (no division
  // in the loop)
  const int lch = tid & 7, lrow = tid >> 3;
  const bool c_ok = c_base + lch * 8 < C, k_ok = k_base + lch * 8 < K;
  const int step_w = kMT % W, step_h = (kMT / W) % H;
  const long long shift = (long long)di * W + dj;  // pixel offset of (di, dj)
  int hh[kRows], ww[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long m = m_begin + lrow + 16 * i;
    ww[i] = (int)(m % W);
    hh[i] = (int)((m / W) % H);
  }

  auto load = [&](int stage, long long m0) {
    const uint32_t a = sA + stage * kTile, bb = sB + stage * kTile;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = lrow + 16 * i;
      const long long m = m0 + r;
      const int xh = hh[i] + di, xw = ww[i] + dj;
      const bool in = m < m_end;
      const bool x_ok = in && c_ok && xh >= 0 && xh < H && xw >= 0 && xw < W;
      const bool d_ok = in && k_ok;
      ptt::cp_async16(a + ptt::swz<CH>(r, lch),
                      x_ok ? x + (m + shift) * C + c_base + lch * 8 : x, x_ok);
      ptt::cp_async16(bb + ptt::swz<CH>(r, lch),
                      d_ok ? dy + m * K + k_base + lch * 8 : dy, d_ok);
      ww[i] += step_w;
      hh[i] += step_h;
      if (ww[i] >= W) { ww[i] -= W; ++hh[i]; }
      if (hh[i] >= H) hh[i] -= H;
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // loads run in step order, as the pixel counters require
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_steps) load(st, m_begin + (long long)st * kMT);
    ptt::cp_async_commit();
  }
  for (int it = 0; it < n_steps; ++it) {
    ptt::cp_async_wait<kStages - 2>();
    __syncthreads();  // step it has landed; step it - 1's readers are done
    {
      const int nx = it + kStages - 1;
      if (nx < n_steps) load(nx % kStages, m_begin + (long long)nx * kMT);
      ptt::cp_async_commit();  // possibly empty: keeps the group count
    }
    const uint32_t a = sA + (it % kStages) * kTile, bb = sB + (it % kStages) * kTile;
#pragma unroll
    for (int ks = 0; ks < kMT / 16; ++ks) {
      // A = x^T: matrices (m, c), (m, c + 8), (m + 8, c), (m + 8, c + 8)
      // B = dy:  matrices (m, n), (m + 8, n), (m, n + 8), (m + 8, n + 8)
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ptt::ldmatrix_x4_trans(af[mt], a + ptt::swz<CH>(16 * ks + (lane & 7) + ((lane >> 4) << 3),
                                                        (wc + 16 * mt) / 8 + ((lane >> 3) & 1)));
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ptt::ldmatrix_x4_trans(bf[np], bb + ptt::swz<CH>(16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3),
                                                         (wk + 16 * np) / 8 + (lane >> 4)));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          ptt::mma_bf16_16816(acc[mt][nt], af[mt], bf[nt >> 1][2 * (nt & 1)],
                              bf[nt >> 1][2 * (nt & 1) + 1]);
    }
  }
  ptt::cp_async_wait<0>();  // no copy outlives the block

  float* dst = out + ((long long)blockIdx.y * k * k + off) * C * K;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ci = c_base + wc + 16 * mt + g + 8 * r;
      if (ci >= C) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int co = k_base + wk + 8 * nt + 2 * t;  // K % 8 == 0: co + 1 < K too
        if (co < K)
          *reinterpret_cast<float2*>(dst + (long long)ci * K + co) =
              make_float2(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]);
      }
    }
}

// dw[e] = sum over splits s of partial[s][e], in split order.
__global__ void __launch_bounds__(256)
wgrad_fold_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                  long long n, int splits) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += partial[p * n + e];
    dw[e] = s;
  }
}

int fold(const void* partial, void* dw, int C, int K, int k, int splits,
         cudaStream_t s) {
  const long long n = (long long)k * k * C * K;
  const unsigned blocks = (unsigned)min((n + 255) / 256, 4096LL);
  wgrad_fold_kernel<<<blocks, 256, 0, s>>>((const float*)partial, (float*)dw,
                                           n, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* dy, void* partial, void* dw, int B,
           int H, int W, int C, int K, int k, int pad, int splits,
           long long per_split, cudaStream_t s) {
  const unsigned tiles = (unsigned)(((C + kTC - 1) / kTC) * ((K + kTK - 1) / kTK) * k * k);
  float* target = (float*)(splits > 1 ? partial : dw);
  wgrad_kernel<T><<<dim3(tiles, splits), kThreads, 0, s>>>(
      (const T*)x, (const T*)dy, target, B, H, W, C, K, k, pad, per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return fold(partial, dw, C, K, k, splits, s);
}

int launch_mma(const void* x, const void* dy, void* partial, void* dw, int B,
               int H, int W, int C, int K, int k, int pad, int splits,
               long long per_split, cudaStream_t s) {
  const unsigned tiles = (unsigned)(((C + kTC - 1) / kTC) * ((K + kTK - 1) / kTK) * k * k);
  cudaError_t e = cudaFuncSetAttribute(wgrad_mma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kMmaSmem);
  if (e != cudaSuccess) return (int)e;
  float* target = (float*)(splits > 1 ? partial : dw);
  wgrad_mma_kernel<<<dim3(tiles, splits), kMmaThreads, kMmaSmem, s>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy, target, B, H, W, C, K,
      k, pad, per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return fold(partial, dw, C, K, k, splits, s);
}

}  // namespace

// blocks of the route's kernel (0: FMA, 1: tensor cores) an SM holds at
// once, or minus a CUDA error: the caller sizes the splits to fill the card
// (the f32 and bf16 FMA kernels hold the same registers and shared memory)
extern "C" int ptt_conv_wgrad_blocks_per_sm(int route) {
  int n = 0;
  const cudaError_t e =
      route == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, wgrad_mma_kernel,
                                                                 kMmaThreads, kMmaSmem)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, wgrad_kernel<__nv_bfloat16>, kThreads, 0);
  return e == cudaSuccess ? n : -(int)e;
}

// x [B, H, W, C], dy [B, H, W, K] (dtype 0 f32, 1 bf16) -> dw f32
// [k, k, C, K] for a stride-1 conv padded by `pad` at the top and left
// (k - 1 - pad at the bottom and right).  partial: f32 [splits, k, k, C, K]
// (unused when splits == 1); per_split: positions per split.  route 0: the
// FMA kernel; route 1: the tensor-core kernel (bf16, C and K multiples of 8,
// x and dy 16-byte aligned).
extern "C" int ptt_conv_wgrad(const void* x, const void* dy, void* partial,
                              void* dw, int B, int H, int W, int C, int K,
                              int k, int pad, int splits, long long per_split,
                              int dtype, int route, void* stream) {
  const long long M = (long long)B * H * W;
  if (M == 0 || C == 0 || K == 0) return 0;
  if (splits < 1 || splits > 65535 || per_split <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (dtype != 1 || C % 8 != 0 || K % 8 != 0)
      return (int)cudaErrorInvalidValue;
    return launch_mma(x, dy, partial, dw, B, H, W, C, K, k, pad, splits, per_split, s);
  }
  if (dtype == 0)
    return launch<float>(x, dy, partial, dw, B, H, W, C, K, k, pad, splits, per_split, s);
  return launch<__nv_bfloat16>(x, dy, partial, dw, B, H, W, C, K, k, pad, splits,
                               per_split, s);
}
