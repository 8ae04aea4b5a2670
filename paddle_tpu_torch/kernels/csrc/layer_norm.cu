// Fused LayerNorm forward and backward for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/layer_norm.py:_fwd_kernel and :_bwd_kernel.
//
// Bound on the H100: device-memory bytes.  At the BERT-base main path
// (x [B*512, 768] bf16) the forward moves x in and y out (~4 bytes an
// element) and the backward moves x and dy in and dx out (~6 bytes an
// element); the arithmetic is a few operations an element, far below the
// 295 operations a byte at which the card turns compute-bound.
//
// Design: one warp per row, eight rows to a block, so a row's mean and
// variance are warp shuffles with no shared-memory round trip and no block
// barrier.
//
// The backward is one launch of a persistent grid (blocks an SM from CUDA's
// occupancy query).  Vector route (ln_bwd_vec_kernel): a lane reads its
// columns of x and dy once, in 16-byte loads, and writes dx in 16-byte
// stores; the lane's columns of dscale and dbias stay in f32 registers over
// all the rows its warp takes, and the block adds its eight warps' sums once,
// at the end.  The TPU kernel's sequential-grid accumulator cannot exist
// across 132 parallel SMs: each block writes its f32 partial row and the
// last blocks to finish fold the rows in a fixed order (ln_fold, two levels
// of done-counters), so there is no second launch, no fill, no float atomic,
// and two calls give the same bits.  Where E or an address does not allow
// 16-byte vectors the scalar route (ln_bwd_scalar_kernel) does the same
// work element by element with its sums in shared memory.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ y,
              float* __restrict__ mu_out, float* __restrict__ rstd_out,
              long long N, int E, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= N) return;
  const T* xr = x + row * E;
  float s = 0.f;
  for (int c = lane; c < E; c += 32) s += ptt::to_f(xr[c]);
  const float mu = ptt::warp_sum(s) / E;
  // centred second pass, as the TPU kernel: no E[x^2] - mu^2 cancellation
  float v = 0.f;
  for (int c = lane; c < E; c += 32) {
    const float d = ptt::to_f(xr[c]) - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(ptt::warp_sum(v) / E + eps);
  T* yr = y + row * E;
  for (int c = lane; c < E; c += 32)
    yr[c] = ptt::from_f<T>((ptt::to_f(xr[c]) - mu) * rstd * scale[c] + bias[c]);
  if (lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

// The cross-block fold of the backward's per-block partial sums [nblk, 2E]
// (dscale then dbias): each block, once its row is written, fences and takes
// a ticket from its group's counter; the last of a group of kGroup blocks
// sums the group's rows in block order into gpart[group], then takes a
// ticket from the final counter, whose last holder sums the groups' rows in
// group order into out[2E].  Fixed orders, no float atomics, and every
// counter is back at 0 when the call ends.  The two levels keep the serial
// tail short: the last block alone reads ~nblk / kGroup rows, not nblk.
constexpr int kGroup = 16;

// dst[c] = sum over r < rows of src[r * cols + c], in row order, 16-byte
// loads where the rows allow
__device__ void ln_sum_rows(const float* __restrict__ src, int rows, int cols,
                            float* __restrict__ dst) {
  if ((cols & 3) == 0) {
    for (int c = threadIdx.x * 4; c < cols; c += blockDim.x * 4) {
      float4 acc = PTT_LDCG(reinterpret_cast<const float4*>(src + c));
      for (int r = 1; r < rows; ++r) {
        const float4 v = PTT_LDCG(reinterpret_cast<const float4*>(src + (long long)r * cols + c));
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      *reinterpret_cast<float4*>(dst + c) = acc;
    }
  } else {
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      float acc = PTT_LDCG(src + c);
      for (int r = 1; r < rows; ++r) acc += PTT_LDCG(src + (long long)r * cols + c);
      dst[c] = acc;
    }
  }
}

__device__ void ln_fold(const float* __restrict__ partial, float* __restrict__ gpart,
                        float* __restrict__ out, unsigned* __restrict__ done, int E2,
                        int* flag) {
  const int nblk = gridDim.x, g = blockIdx.x / kGroup;
  const int ngroups = (nblk + kGroup - 1) / kGroup;
  const int g0 = g * kGroup, gn = min(kGroup, nblk - g0);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(done + g, 1u) == (unsigned)gn - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  ln_sum_rows(partial + (long long)g0 * E2, gn, E2, gpart + (long long)g * E2);
  if (threadIdx.x == 0) done[g] = 0u;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(done + ngroups, 1u) == (unsigned)ngroups - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  ln_sum_rows(gpart, ngroups, E2, out);
  if (threadIdx.x == 0) done[ngroups] = 0u;
}

// dx = rstd * (g - mean(g) - xhat * mean(g * xhat)), g = dy * scale, per
// row; out[0:E] = sum over rows of dy * xhat (dscale), out[E:2E] = sum of dy
// (dbias).  Vector route: E = NV * 32 * (16 / sizeof(T)); a warp takes a row
// at a time, each lane NV 16-byte vectors of x and dy, read once; the lane's
// columns of dscale and dbias stay in registers over all the warp's rows.
// Rows go to the grid's warps round-robin (one persistent grid).
template <typename T, int NV>
__global__ void __launch_bounds__(kWarps * 32)
ln_bwd_vec_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const T* __restrict__ dy, const float* __restrict__ mu,
                  const float* __restrict__ rstd, T* __restrict__ dx,
                  float* __restrict__ partial, float* __restrict__ gpart,
                  float* __restrict__ out, unsigned* __restrict__ done, long long N,
                  int E) {
  constexpr int kV = ptt::Vec16<T>::n;
  extern __shared__ uint4 ln_smem[];
  float* red = reinterpret_cast<float*>(ln_smem);          // [2E]
  int* flag = reinterpret_cast<int*>(red + 2 * E);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float ds[NV][kV], db[NV][kV];
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int e = 0; e < kV; ++e) ds[k][e] = db[k][e] = 0.f;

  const long long stride = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < N; row += stride) {
    const T* xr = x + row * E;
    const T* dyr = dy + row * E;
    float xh[NV][kV], g[NV][kV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      ptt::load16(xr + (k * 32 + lane) * kV, xh[k]);
      ptt::load16(dyr + (k * 32 + lane) * kV, g[k]);
    }
    const float m = mu[row], rs = rstd[row];
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float sc[kV];
#pragma unroll
      for (int e = 0; e < kV; e += 4) {
        const float4 v = *reinterpret_cast<const float4*>(scale + (k * 32 + lane) * kV + e);
        sc[e] = v.x;
        sc[e + 1] = v.y;
        sc[e + 2] = v.z;
        sc[e + 3] = v.w;
      }
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        const float d = g[k][e];
        xh[k][e] = (xh[k][e] - m) * rs;
        ds[k][e] += d * xh[k][e];
        db[k][e] += d;
        g[k][e] = d * sc[e];
        sg += g[k][e];
        sgx += g[k][e] * xh[k][e];
      }
    }
    const float c1 = ptt::warp_sum(sg) / E;
    const float c2 = ptt::warp_sum(sgx) / E;
    T* dxr = dx + row * E;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float o[kV];
#pragma unroll
      for (int e = 0; e < kV; ++e) o[e] = rs * (g[k][e] - c1 - xh[k][e] * c2);
      ptt::store16(dxr + (k * 32 + lane) * kV, o);
    }
  }
  // the block's sums: the warps' registers added in warp order
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          const int c = (k * 32 + lane) * kV + e;
          red[c] = w ? red[c] + ds[k][e] : ds[k][e];
          red[E + c] = w ? red[E + c] + db[k][e] : db[k][e];
        }
    }
    __syncthreads();
  }
  float* prow = partial + (long long)blockIdx.x * 2 * E;
  for (int c = threadIdx.x * 4; c < 2 * E; c += blockDim.x * 4)
    *reinterpret_cast<float4*>(prow + c) = *reinterpret_cast<const float4*>(red + c);
  ln_fold(partial, gpart, out, done, 2 * E, flag);
}

// The scalar route, for any E (and for inputs not 16-byte aligned): the same
// work a warp a row, 2-byte or 4-byte loads, x and dy read twice (the
// second time from L1), the lane's sums in its warp's row of shared memory.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
ln_bwd_scalar_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const T* __restrict__ dy, const float* __restrict__ mu,
                     const float* __restrict__ rstd, T* __restrict__ dx,
                     float* __restrict__ partial, float* __restrict__ gpart,
                     float* __restrict__ out, unsigned* __restrict__ done,
                     long long N, int E) {
  extern __shared__ uint4 ln_smem[];
  float* acc = reinterpret_cast<float*>(ln_smem);          // [kWarps][2E]
  int* flag = reinterpret_cast<int*>(acc + kWarps * 2 * E);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* my_ds = acc + warp * 2 * E;
  float* my_db = my_ds + E;
  for (int c = lane; c < E; c += 32) my_ds[c] = my_db[c] = 0.f;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < N; row += stride) {
    const T* xr = x + row * E;
    const T* dyr = dy + row * E;
    const float m = mu[row], rs = rstd[row];
    float sg = 0.f, sgx = 0.f;
    for (int c = lane; c < E; c += 32) {
      const float g = ptt::to_f(dyr[c]) * scale[c];
      sg += g;
      sgx += g * ((ptt::to_f(xr[c]) - m) * rs);
    }
    const float c1 = ptt::warp_sum(sg) / E;
    const float c2 = ptt::warp_sum(sgx) / E;
    T* dxr = dx + row * E;
    for (int c = lane; c < E; c += 32) {
      const float d = ptt::to_f(dyr[c]);
      const float xhat = (ptt::to_f(xr[c]) - m) * rs;
      dxr[c] = ptt::from_f<T>(rs * (d * scale[c] - c1 - xhat * c2));
      my_ds[c] += d * xhat;
      my_db[c] += d;
    }
  }
  __syncthreads();
  float* prow = partial + (long long)blockIdx.x * 2 * E;
  for (int c = threadIdx.x; c < 2 * E; c += blockDim.x) {
    float s = acc[c];
    for (int w = 1; w < kWarps; ++w) s += acc[w * 2 * E + c];
    prow[c] = s;
  }
  ln_fold(partial, gpart, out, done, 2 * E, flag);
}

#ifndef PTT_HOST_EMULATION  // a host build (tests/cuda_emu) takes the kernels alone

template <typename T>
int launch_fwd(const void* x, const void* scale, const void* bias, void* y,
               void* mu, void* rstd, long long N, int E, float eps,
               cudaStream_t s) {
  const unsigned grid = (unsigned)((N + kWarps - 1) / kWarps);
  ln_fwd_kernel<T><<<grid, kWarps * 32, 0, s>>>(
      (const T*)x, (const float*)scale, (const float*)bias, (T*)y,
      (float*)mu, (float*)rstd, N, E, eps);
  return (int)cudaGetLastError();
}

template <typename T>
using BwdKernel = void (*)(const T*, const float*, const T*, const float*,
                           const float*, T*, float*, float*, float*, unsigned*,
                           long long, int);

// the vector route holds a lane's NV * (16 / sizeof(T)) columns of x, dy
// and both sums in registers: at most 32 columns a lane (E <= 1024)
template <typename T, int NV>
BwdKernel<T> vec_kernel() {
  if constexpr (NV * ptt::Vec16<T>::n <= 32) return ln_bwd_vec_kernel<T, NV>;
  else return nullptr;
}

// route 1: the vector kernel for this E, or null where E does not fit it
template <typename T>
BwdKernel<T> bwd_kernel(int E, int route) {
  if (!route) return ln_bwd_scalar_kernel<T>;
  constexpr int per = 32 * ptt::Vec16<T>::n;
  if (E % per) return nullptr;
  switch (E / per) {
    case 1: return vec_kernel<T, 1>();
    case 2: return vec_kernel<T, 2>();
    case 3: return vec_kernel<T, 3>();
    case 4: return vec_kernel<T, 4>();
    case 5: return vec_kernel<T, 5>();
    case 6: return vec_kernel<T, 6>();
    case 7: return vec_kernel<T, 7>();
    case 8: return vec_kernel<T, 8>();
    default: return nullptr;
  }
}

size_t bwd_smem(int E, int route) {
  return sizeof(float) * 2 * (size_t)E * (route ? 1 : kWarps) + 16;
}

template <typename T>
int prepare_bwd(BwdKernel<T> k, size_t smem) {
  if (!k) return (int)cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename T>
int launch_bwd(const void* x, const void* scale, const void* dy, const void* mu,
               const void* rstd, void* dx, void* scratch, void* out, void* done,
               long long N, int E, int nblk, int route, cudaStream_t s) {
  const BwdKernel<T> k = bwd_kernel<T>(E, route);
  const size_t smem = bwd_smem(E, route);
  const int status = prepare_bwd<T>(k, smem);
  if (status) return status;
  float* partial = (float*)scratch;
  k<<<nblk, kWarps * 32, smem, s>>>(
      (const T*)x, (const float*)scale, (const T*)dy, (const float*)mu,
      (const float*)rstd, (T*)dx, partial, partial + (long long)nblk * 2 * E,
      (float*)out, (unsigned*)done, N, E);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_blocks_per_sm(int E, int route) {
  const BwdKernel<T> k = bwd_kernel<T>(E, route);
  const size_t smem = bwd_smem(E, route);
  const int status = prepare_bwd<T>(k, smem);
  if (status) return -status;
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, kWarps * 32, smem);
  return e == cudaSuccess ? n : -(int)e;
}

#endif  // PTT_HOST_EMULATION

}  // namespace

#ifndef PTT_HOST_EMULATION

extern "C" int ptt_layer_norm_fwd(const void* x, const void* scale,
                                  const void* bias, void* y, void* mu,
                                  void* rstd, long long N, int E, float eps,
                                  int dtype, void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_fwd<float>(x, scale, bias, y, mu, rstd, N, E, eps, s);
  return launch_fwd<__nv_bfloat16>(x, scale, bias, y, mu, rstd, N, E, eps, s);
}

// x, dy, dx [N, E] (dtype 0 f32, 1 bf16), scale [E] f32, mu and rstd [N]
// f32 -> dx, out [2, E] f32 (dscale, dbias).  route 1: the vector kernel
// (E a multiple of 32 * 16 / sizeof(T), at most 1024; x, dy, dx and scale
// 16-byte aligned), 0: the scalar kernel.  nblk blocks, a persistent grid.
// Scratch: f32 [(nblk + ceil(nblk / 16)) * 2E].  done: ceil(nblk / 16) + 1
// uint32 counters, 0 before the call and 0 after it; calls that share
// scratch and counters run on one stream.
extern "C" int ptt_layer_norm_bwd(const void* x, const void* scale,
                                  const void* dy, const void* mu,
                                  const void* rstd, void* dx, void* scratch,
                                  void* out, void* done, long long N, int E,
                                  int nblk, int dtype, int route, void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd<float>(x, scale, dy, mu, rstd, dx, scratch, out, done, N,
                             E, nblk, route, s);
  return launch_bwd<__nv_bfloat16>(x, scale, dy, mu, rstd, dx, scratch, out,
                                   done, N, E, nblk, route, s);
}

// resident backward blocks an SM (CUDA's occupancy query); negative: the
// route does not take this E
extern "C" int ptt_layer_norm_bwd_blocks_per_sm(int E, int dtype, int route) {
  return dtype == 0 ? bwd_blocks_per_sm<float>(E, route)
                    : bwd_blocks_per_sm<__nv_bfloat16>(E, route);
}

#endif  // PTT_HOST_EMULATION
