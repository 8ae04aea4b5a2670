// Fused batch-norm kernels for Hopper (sm_90a), over the channels-last
// [M, C] view of an activation (M = B*H*W rows, C channels contiguous).
//
// Replaces paddle_tpu/kernels/fused_bn.py:
//   _stats_kernel       -> bn_stats_kernel        (sum x, sum x^2)
//   _scale_shift_kernel -> bn_scale_shift_kernel  (y = x*a + b)
//   _bwd_reduce_kernel  -> bn_bwd_reduce_kernel   (sum dy, sum dy*x)
//   _dx_kernel          -> bn_dx_kernel           (dy*A + x*B + C)
//
// Bound on the H100: device-memory bytes.  Each kernel reads its [M, C]
// inputs once (stats one, scale_shift and bwd_reduce two counting the
// output, dx three) and does two or three operations an element, far below
// the ~20 f32 operations a byte at which the card's CUDA cores would be the
// limit.
//
// The elementwise kernels: a block of 256 threads is (tx, ty) with tx
// threads across the channels, each owning V consecutive channels (one
// 16-byte load: 8 bf16 or 4 f32; V = 1 where C or an address does not allow
// it), and ty threads down the rows; the grid splits rows (blockIdx.x) and
// channel tiles (blockIdx.y).  They keep the plain versions' rounding:
// scale_shift rounds to T after the product and after the sum, as two T
// operations do; dx computes in f32 with separately rounded products and
// sums, then rounds once to T.
//
// The two reductions are one launch each.  The TPU kernels carry their sums
// across a sequential grid in one output block; that cannot exist across
// 132 parallel SMs.  Here a block sweeps its rows of one channel tile, the
// tile 128 bytes of a row wide (tx = 8 threads of one 16-byte vector; 32
// channels on the V = 1 route), so that a tile's fold is small and the
// tiles fold in parallel on as many SMs; the grid is one wave of four
// blocks an SM.  The block adds its rows in f32 registers (four rows in
// flight a thread), then across the warp's rows by shuffles and across its
// 8 warps in shared memory, in a fixed order, and writes one f32 partial row
// a quantity.  One thread fences and takes a ticket from its group's
// counter; the block that takes a group's last ticket sums the group's
// partial rows in a fixed order (16-byte loads past L1 on the vector route),
// then takes a ticket from the tile's counter, whose last holder sums the
// groups' rows into the two [C] outputs.  Up to 64 row blocks a tile form
// one group (one level); more form about sqrt(blocks) groups, so that
// neither level's last block reads many rows.  Each counter goes back to 0.
// No float atomics, no second launch, no fill: two calls give the same
// bits.  The ragged row edge is masked in the kernel, where the TPU wrapper
// zero-padded (a copy of the activation).

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

constexpr int kWarps = kThreads / 32;
constexpr int kMaxWidth = 32 * kMaxVec;   // channels in a reduction tile, at most

// Dynamic shared memory of a reduction block: the warps' sums (2 x kWarps
// x the tile's width), then the fold's (kThreads x 4), and the ticket flag.
constexpr int kReduceFloats =
    2 * kWarps * kMaxWidth > kThreads * 4 ? 2 * kWarps * kMaxWidth : kThreads * 4;
constexpr size_t kReduceSmem = sizeof(float) * kReduceFloats + 16;

// dst[q * dst_q + c] = sum over r < nrows of src[(q * src_q + r) * C + c],
// q = 0, 1, for the tile's `width` channels from c_base.  The block's
// threads split (q, group of F channels) pairs by G = kThreads / pairs sets
// of rows (r = g, g + G, ...); each adds its set in order, then the G sums
// add in g order: a fixed order.  F = 4 reads 16 bytes a load (C % 4 == 0).
// src was written by other blocks of the grid: loads go past L1.
template <int F>
__device__ void fold_rows(const float* __restrict__ src, long long src_q,
                          int nrows, float* __restrict__ dst, long long dst_q,
                          int C, int c_base, int width, float* red) {
  const int per_q = width / F, pairs = 2 * per_q, G = kThreads / pairs;
  const int k = threadIdx.x % pairs, g = threadIdx.x / pairs;
  const int q = k / per_q, c = c_base + (k % per_q) * F;
  float acc[F];
#pragma unroll
  for (int i = 0; i < F; ++i) acc[i] = 0.f;
  if (c < C) {
    const float* col = src + q * src_q * C + c;
#pragma unroll 8
    for (int r = g; r < nrows; r += G) {
      if constexpr (F == 4) {
        const float4 v = PTT_LDCG(reinterpret_cast<const float4*>(col + (long long)r * C));
        acc[0] += v.x;
        acc[1] += v.y;
        acc[2] += v.z;
        acc[3] += v.w;
      } else {
        acc[0] += PTT_LDCG(col + (long long)r * C);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < F; ++i) red[threadIdx.x * F + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < pairs && c < C) {
#pragma unroll
    for (int i = 0; i < F; ++i) {
      float t = 0.f;
      for (int j = 0; j < G; ++j) t += red[(j * pairs + threadIdx.x) * F + i];
      dst[q * dst_q + c + i] = t;
    }
  }
}

// Column sums over rows of two quantities, one launch:
//   kTwo == false: out[0] = sum a, out[1] = sum a*a  (statistics; b unused)
//   kTwo == true:  out[0] = sum a, out[1] = sum a*b  (backward reduce; a = dy,
//                                                     b = x)
// Block (blockIdx.x, blockIdx.y) takes rows [blockIdx.x * rows_per_block, +
// rows_per_block) of channel tile blockIdx.y (TX * V channels); thread
// (ty, tx) = (threadIdx.x / TX, threadIdx.x % TX), TX a power of two <= 32.
// Scratch, rewritten by every call: partial [2][gridDim.x][C] (a row a
// block) and gpart [2][ngroups][C] (a row a group of `group` blocks) f32.
// counters: [gridDim.y][ngroups + 1], 0 before the call and 0 after it.
// The last block of a group to finish folds the group's rows into gpart;
// the last group of a tile to finish folds the groups' rows into out.  One
// group (group >= gridDim.x) folds straight into out.
template <typename T, int V, bool kTwo>
__device__ __forceinline__ void reduce_rows(const T* __restrict__ a,
                                            const T* __restrict__ b,
                                            float* __restrict__ partial,
                                            float* __restrict__ gpart,
                                            unsigned* __restrict__ counters,
                                            float* __restrict__ out,
                                            long long M, int C, int TX,
                                            long long rows_per_block,
                                            int group) {
  extern __shared__ uint4 bn_smem[];
  float* red = reinterpret_cast<float*>(bn_smem);
  int* flag = reinterpret_cast<int*>(red + kReduceFloats);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = tid % TX, ty = tid / TX, TY = kThreads / TX;
  const int width = TX * V;
  const int c_base = blockIdx.y * width;
  const int c0 = c_base + tx * V;
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
  // the warp's rows: lanes TX apart hold the same channels
  for (int o = TX; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
      q[i] += __shfl_xor_sync(0xffffffffu, q[i], o);
    }
  }
  if (lane < TX) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[warp * width + tx * V + i] = s[i];
      red[(kWarps + warp) * width + tx * V + i] = q[i];
    }
  }
  __syncthreads();
  // the block's warps, in order: one partial row a quantity
  const int nblk = gridDim.x;
  for (int k = tid; k < 2 * width; k += kThreads) {
    const int which = k / width, col = k % width;
    if (c_base + col < C) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += red[(which * kWarps + w) * width + col];
      partial[((long long)which * nblk + blockIdx.x) * C + c_base + col] = t;
    }
  }
  const int ngroups = (nblk + group - 1) / group, g = blockIdx.x / group;
  const int g0 = g * group, gn = min(group, nblk - g0);
  unsigned* done = counters + (long long)blockIdx.y * (ngroups + 1);
  // the block's writes, ordered by the barrier, then made visible to the
  // grid by one thread's fence before its ticket
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    *flag = atomicAdd(done + g, 1u) == (unsigned)gn - 1;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  constexpr int F = V > 1 ? 4 : 1;
  if (ngroups == 1) {
    fold_rows<F>(partial, nblk, nblk, out, C, C, c_base, width, red);
    if (tid == 0) done[0] = 0u;
    return;
  }
  fold_rows<F>(partial + (long long)g0 * C, nblk, gn, gpart + (long long)g * C,
               (long long)ngroups * C, C, c_base, width, red);
  __syncthreads();
  if (tid == 0) {
    done[g] = 0u;
    __threadfence();
    *flag = atomicAdd(done + ngroups, 1u) == (unsigned)ngroups - 1;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  fold_rows<F>(gpart, ngroups, ngroups, out, C, C, c_base, width, red);
  if (tid == 0) done[ngroups] = 0u;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 4)
bn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                float* __restrict__ gpart, unsigned* __restrict__ counters,
                float* __restrict__ out, long long M, int C, int TX,
                long long rows_per_block, int group) {
  reduce_rows<T, V, false>(x, nullptr, partial, gpart, counters, out, M, C, TX,
                           rows_per_block, group);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 4)
bn_bwd_reduce_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                     float* __restrict__ partial, float* __restrict__ gpart,
                     unsigned* __restrict__ counters, float* __restrict__ out,
                     long long M, int C, int TX, long long rows_per_block,
                     int group) {
  reduce_rows<T, V, true>(dy, x, partial, gpart, counters, out, M, C, TX,
                          rows_per_block, group);
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

#ifndef PTT_HOST_EMULATION  // a host build (tests/cuda_emu) takes the kernels alone

// grid of an elementwise [M, C] pass: (row blocks, channel tiles of tx*V
// channels)
template <int V>
dim3 tiles(int C, int tx, int nblk) {
  const int nv = C / V;
  return dim3(nblk, (nv + tx - 1) / tx);
}

template <typename T, int V>
int launch_reduce(bool two, const void* a, const void* b, void* scratch,
                  void* counters, void* out, long long M, int C, int tx,
                  long long rows_per_block, int nblk, int group,
                  cudaStream_t s) {
  const int width = tx * V;
  const dim3 grid(nblk, (C + width - 1) / width);
  float* part = (float*)scratch;
  float* gpart = part + 2LL * nblk * C;
  if (two)
    bn_bwd_reduce_kernel<T, V><<<grid, kThreads, kReduceSmem, s>>>(
        (const T*)a, (const T*)b, part, gpart, (unsigned*)counters,
        (float*)out, M, C, tx, rows_per_block, group);
  else
    bn_stats_kernel<T, V><<<grid, kThreads, kReduceSmem, s>>>(
        (const T*)a, part, gpart, (unsigned*)counters, (float*)out, M, C, tx,
        rows_per_block, group);
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

#endif  // PTT_HOST_EMULATION

}  // namespace

#ifndef PTT_HOST_EMULATION

// The two reductions: x (or dy and x) [M, C] (dtype 0 f32, 1 bf16) -> out
// [2, C] f32: sum x and sum x^2 (or sum dy and sum dy*x).  tx threads a
// channel tile (a power of two, at most 32), each one 16-byte vector of
// channels (vec = 1) or one channel; nblk row blocks of rows_per_block rows,
// folded in groups of `group`.  Scratch: f32 [2 * (nblk + ngroups) * C],
// ngroups = ceil(nblk / group), rewritten by the call.  counters: uint32 [tiles * (ngroups + 1)], 0 before
// the call and 0 after it; calls that share scratch and counters run on one
// stream.
extern "C" int ptt_bn_stats(const void* x, void* scratch, void* counters,
                            void* out, long long M, int C, int tx,
                            long long rows_per_block, int nblk, int group,
                            int vec, int dtype, void* stream) {
  if (M == 0 || C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  PTT_BN_DISPATCH(dtype, vec,
                  launch_reduce<T, V>(false, x, nullptr, scratch, counters,
                                      out, M, C, tx, rows_per_block, nblk,
                                      group, s));
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

extern "C" int ptt_bn_bwd_reduce(const void* dy, const void* x, void* scratch,
                                 void* counters, void* out, long long M, int C,
                                 int tx, long long rows_per_block, int nblk,
                                 int group, int vec, int dtype, void* stream) {
  if (M == 0 || C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  PTT_BN_DISPATCH(dtype, vec,
                  launch_reduce<T, V>(true, dy, x, scratch, counters, out, M,
                                      C, tx, rows_per_block, nblk, group, s));
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

#endif  // PTT_HOST_EMULATION
