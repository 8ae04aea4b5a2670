// Fused batch-norm kernels for Hopper (sm_90a), over the channels-last
// [M, C] view of an activation (M = B*H*W rows, C channels contiguous).
//
// Replaces paddle_tpu/kernels/fused_bn.py:
//   _stats_kernel       -> bn_stats_kernel + bn_fold_kernel   (sum x, sum x^2)
//   _scale_shift_kernel -> bn_scale_shift_kernel              (y = x*a + b)
//   _bwd_reduce_kernel  -> bn_bwd_reduce_kernel + bn_fold_kernel (sum dy, sum dy*x)
//   _dx_kernel          -> bn_dx_kernel                       (dy*A + x*B + C)
//
// Bound on the H100: device-memory bytes.  Each kernel reads its [M, C]
// inputs once (stats one, scale_shift and bwd_reduce two counting the
// output, dx three) and does two or three operations an element, far below
// the ~20 f32 operations a byte at which the card's CUDA cores would be the
// limit.
//
// Design: a block of 256 threads is (TX, TY) with TX threads across the
// channels, each owning V consecutive channels (one 16-byte load: 8 bf16 or
// 4 f32; V = 1 where C or an address does not allow it), and TY threads down
// the rows.  The grid splits both rows (blockIdx.x) and channel tiles of
// TX*V channels (blockIdx.y), so both ends of ResNet-50's shape range
// (1.6 M rows x 64 channels, 6 K rows x 2048) put a few blocks on every SM.
// The TPU kernels carry their sums across a sequential grid in one output
// block; that cannot exist across 132 parallel SMs.  Here each block writes
// its own f32 partial row per quantity to partial[2][nblk][C], and
// bn_fold_kernel sums those rows column by column in a fixed order: no
// atomics, so the result is deterministic.  The ragged row edge is masked
// in the kernel, where the TPU wrapper zero-padded (a copy of the
// activation).  The elementwise kernels keep the plain versions' rounding:
// scale_shift rounds to T after the product and after the sum, as two T
// operations do; dx computes in f32 with separately rounded products and
// sums, then rounds once to T.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = ptt::to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = ptt::to_f(p[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&in)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = ptt::from_f<T>(in[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = ptt::from_f<T>(in[i]);
  }
}

// Column sums over this block's rows of two quantities:
//   kTwo == false: s += a, q += a*a      (statistics; b unused)
//   kTwo == true:  s += a, q += a*b      (backward reduce; a = dy, b = x)
// written to partial[0][blockIdx.x][:] and partial[1][blockIdx.x][:].
template <typename T, int V, bool kTwo>
__device__ __forceinline__ void reduce_rows(const T* __restrict__ a,
                                            const T* __restrict__ b,
                                            float* __restrict__ partial,
                                            long long M, int C,
                                            long long rows_per_block) {
  __shared__ float red[2][kThreads * kMaxVec];  // [which][ty][tx*V + i]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y;
  const int width = TX * V;                     // channels in this tile
  const int c0 = blockIdx.y * width + tx * V;
  float s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.f;
  if (c0 < C) {
    const long long r0 = (long long)blockIdx.x * rows_per_block;
    const long long r1 = min(M, r0 + rows_per_block);
#pragma unroll 4
    for (long long r = r0 + ty; r < r1; r += TY) {
      float va[V];
      load_vec<T, V>(a + r * C + c0, va);
      if constexpr (kTwo) {
        float vb[V];
        load_vec<T, V>(b + r * C + c0, vb);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s[i] += va[i];
          q[i] += va[i] * vb[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s[i] += va[i];
          q[i] += va[i] * va[i];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    red[0][ty * width + tx * V + i] = s[i];
    red[1][ty * width + tx * V + i] = q[i];
  }
  __syncthreads();
  const long long nblk = gridDim.x;
  for (int k = ty * TX + tx; k < 2 * width; k += TX * TY) {
    const int which = k / width, col = k % width;
    const int c = blockIdx.y * width + col;
    if (c >= C) continue;
    float t = 0.f;
    for (int y = 0; y < TY; ++y) t += red[which][y * width + col];
    partial[(which * nblk + blockIdx.x) * C + c] = t;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                long long M, int C, long long rows_per_block) {
  reduce_rows<T, V, false>(x, nullptr, partial, M, C, rows_per_block);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_bwd_reduce_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                     float* __restrict__ partial, long long M, int C,
                     long long rows_per_block) {
  reduce_rows<T, V, true>(dy, x, partial, M, C, rows_per_block);
}

// out0[c] / out1[c] = sum over blocks of partial[0 / 1][block][c]; a
// 32-column tile per block, eight threads down the block axis, fixed order.
__global__ void __launch_bounds__(256)
bn_fold_kernel(const float* __restrict__ partial, float* __restrict__ out0,
               float* __restrict__ out1, int nblk, int C) {
  __shared__ float red[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int which = blockIdx.y;
  float s = 0.f;
  if (c < C)
    for (int b = threadIdx.y; b < nblk; b += 8)
      s += partial[((long long)which * nblk + b) * C + c];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += red[i][threadIdx.x];
    (which == 0 ? out0 : out1)[c] = t;
  }
}

// y = x*a + b with a, b in T; rows in a grid-stride loop.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_scale_shift_kernel(const T* __restrict__ x, const T* __restrict__ a,
                      const T* __restrict__ b, T* __restrict__ y,
                      long long M, int C) {
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (c0 >= C) return;
  float av[V], bv[V];
  load_vec<T, V>(a + c0, av);
  load_vec<T, V>(b + c0, bv);
  const long long step = (long long)gridDim.x * blockDim.y;
  for (long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y; r < M;
       r += step) {
    float v[V];
    load_vec<T, V>(x + r * C + c0, v);
#pragma unroll
    for (int i = 0; i < V; ++i)
      v[i] = __fadd_rn(ptt::round_to<T>(__fmul_rn(v[i], av[i])), bv[i]);
    store_vec<T, V>(y + r * C + c0, v);
  }
}

// dx = dy*A + x*B + Cc in f32 (coefs rows 0..2 of [3, C]), rounded to T.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
             const float* __restrict__ coefs, T* __restrict__ dx,
             long long M, int C) {
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (c0 >= C) return;
  float A[V], B[V], Cc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    A[i] = coefs[c0 + i];
    B[i] = coefs[C + c0 + i];
    Cc[i] = coefs[2 * C + c0 + i];
  }
  const long long step = (long long)gridDim.x * blockDim.y;
  for (long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y; r < M;
       r += step) {
    float g[V], v[V];
    load_vec<T, V>(dy + r * C + c0, g);
    load_vec<T, V>(x + r * C + c0, v);
#pragma unroll
    for (int i = 0; i < V; ++i)
      v[i] = __fadd_rn(__fadd_rn(__fmul_rn(g[i], A[i]), __fmul_rn(v[i], B[i])),
                       Cc[i]);
    store_vec<T, V>(dx + r * C + c0, v);
  }
}

// grid of an [M, C] pass: (row blocks, channel tiles of tx*V channels)
template <int V>
dim3 tiles(int C, int tx, int nblk) {
  const int nv = C / V;
  return dim3(nblk, (nv + tx - 1) / tx);
}

template <typename T, int V>
int launch_reduce(bool two, const void* a, const void* b, void* partial,
                  void* out0, void* out1, long long M, int C, int tx,
                  long long rows_per_block, int nblk, cudaStream_t s) {
  const dim3 block(tx, kThreads / tx);
  const dim3 grid = tiles<V>(C, tx, nblk);
  if (two)
    bn_bwd_reduce_kernel<T, V><<<grid, block, 0, s>>>(
        (const T*)a, (const T*)b, (float*)partial, M, C, rows_per_block);
  else
    bn_stats_kernel<T, V><<<grid, block, 0, s>>>(
        (const T*)a, (float*)partial, M, C, rows_per_block);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bn_fold_kernel<<<dim3((C + 31) / 32, 2), dim3(32, 8), 0, s>>>(
      (const float*)partial, (float*)out0, (float*)out1, nblk, C);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_scale_shift(const void* x, const void* a, const void* b, void* y,
                       long long M, int C, int tx, int nblk, cudaStream_t s) {
  bn_scale_shift_kernel<T, V><<<tiles<V>(C, tx, nblk), dim3(tx, kThreads / tx), 0, s>>>(
      (const T*)x, (const T*)a, (const T*)b, (T*)y, M, C);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_dx(const void* dy, const void* x, const void* coefs, void* dx,
              long long M, int C, int tx, int nblk, cudaStream_t s) {
  bn_dx_kernel<T, V><<<tiles<V>(C, tx, nblk), dim3(tx, kThreads / tx), 0, s>>>(
      (const T*)dy, (const T*)x, (const float*)coefs, (T*)dx, M, C);
  return (int)cudaGetLastError();
}

// Runs the launch expression in __VA_ARGS__ with T and V bound for dtype
// (0 f32, 1 bf16) and vec (0: one element a thread, 1: one 16-byte load).
#define PTT_BN_DISPATCH(dtype, vec, ...)                                  \
  do {                                                                    \
    if ((dtype) == 0 && (vec)) {                                          \
      using T = float;                                                    \
      constexpr int V = 4;                                                \
      return __VA_ARGS__;                                                 \
    }                                                                     \
    if ((dtype) == 0) {                                                   \
      using T = float;                                                    \
      constexpr int V = 1;                                                \
      return __VA_ARGS__;                                                 \
    }                                                                     \
    if (vec) {                                                            \
      using T = __nv_bfloat16;                                            \
      constexpr int V = 8;                                                \
      return __VA_ARGS__;                                                 \
    }                                                                     \
    using T = __nv_bfloat16;                                              \
    constexpr int V = 1;                                                  \
    return __VA_ARGS__;                                                   \
  } while (0)

}  // namespace

// Writes sum x and sum x^2 over rows, f32 [C] each.
extern "C" int ptt_bn_stats(const void* x, void* partial, void* sum,
                            void* sumsq, long long M, int C, int tx,
                            long long rows_per_block, int nblk, int vec,
                            int dtype, void* stream) {
  if (M == 0 || C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  PTT_BN_DISPATCH(dtype, vec,
                  launch_reduce<T, V>(false, x, nullptr, partial, sum, sumsq,
                                      M, C, tx, rows_per_block, nblk, s));
}

// y = x*a + b, a and b [C] in x's dtype.
extern "C" int ptt_bn_scale_shift(const void* x, const void* a, const void* b,
                                  void* y, long long M, int C, int tx,
                                  int nblk, int vec, int dtype, void* stream) {
  if (M == 0 || C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  PTT_BN_DISPATCH(dtype, vec,
                  launch_scale_shift<T, V>(x, a, b, y, M, C, tx, nblk, s));
}

// Writes sum dy and sum dy*x over rows, f32 [C] each.
extern "C" int ptt_bn_bwd_reduce(const void* dy, const void* x, void* partial,
                                 void* sum_dy, void* sum_dyx, long long M,
                                 int C, int tx, long long rows_per_block,
                                 int nblk, int vec, int dtype, void* stream) {
  if (M == 0 || C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  PTT_BN_DISPATCH(dtype, vec,
                  launch_reduce<T, V>(true, dy, x, partial, sum_dy, sum_dyx,
                                      M, C, tx, rows_per_block, nblk, s));
}

// dx = dy*coefs[0] + x*coefs[1] + coefs[2], coefs f32 [3, C].
extern "C" int ptt_bn_dx(const void* dy, const void* x, const void* coefs,
                         void* dx, long long M, int C, int tx, int nblk,
                         int vec, int dtype, void* stream) {
  if (M == 0 || C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  PTT_BN_DISPATCH(dtype, vec,
                  launch_dx<T, V>(dy, x, coefs, dx, M, C, tx, nblk, s));
}
