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
// bounds are about equal.  This first version multiplies with f32 FMAs on
// the CUDA cores (67 TFLOP/s at most), so it is bound by FMA issue, far
// above both; tensor cores (mma / wgmma) are the next step.
//
// Design (deterministic, no atomics):
// - For each kernel offset (i, j) dw is a product [C, M] x [M, K] over the
//   M = B*H*W output positions.  A block owns one 64 x 64 tile of (C, K) for
//   one offset and a contiguous range of positions (a split of M); the grid
//   covers tiles x offsets x splits, so both 9 tiles at M = 401,408 and 576
//   tiles at M = 6,272 put a few blocks on every SM.
// - Each step stages 32 positions of x (shifted by the offset, zero where
//   the shifted pixel falls in the pad: bounds checks, no padded copy of x)
//   and of dy in shared memory as f32; 256 threads each accumulate a 4 x 4
//   patch of the tile in f32 registers.
// - Each block writes its f32 partial tile to partial[split]; a fold kernel
//   sums the splits in a fixed order (with one split the block writes dw).
//   The TPU kernel instead pads and flattens x and dy into copies so that
//   an offset is one row shift of a VMEM tile, and sums over a sequential
//   grid.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTC = 64;       // input channels per tile
constexpr int kTK = 64;       // output channels per tile
constexpr int kTM = 32;       // positions staged per step
constexpr int kThreads = 256; // 16 x 16, a 4 x 4 patch each

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
  const long long n = (long long)k * k * C * K;
  const unsigned blocks = (unsigned)min((n + 255) / 256, 4096LL);
  wgrad_fold_kernel<<<blocks, 256, 0, s>>>((const float*)partial, (float*)dw,
                                           n, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, H, W, C], dy [B, H, W, K] (dtype 0 f32, 1 bf16) -> dw f32
// [k, k, C, K] for a stride-1 conv padded by `pad` at the top and left
// (k - 1 - pad at the bottom and right).  partial: f32 [splits, k, k, C, K]
// (unused when splits == 1); per_split: positions per split, a multiple of
// 32.
extern "C" int ptt_conv_wgrad(const void* x, const void* dy, void* partial,
                              void* dw, int B, int H, int W, int C, int K,
                              int k, int pad, int splits, long long per_split,
                              int dtype, void* stream) {
  if ((long long)B * H * W == 0 || C == 0 || K == 0) return 0;
  if (splits < 1 || splits > 65535 || per_split <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, dy, partial, dw, B, H, W, C, K, k, pad, splits, per_split, s);
  return launch<__nv_bfloat16>(x, dy, partial, dw, B, H, W, C, K, k, pad, splits,
                               per_split, s);
}
