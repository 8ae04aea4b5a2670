// Shared device helpers for the port's kernels (float32 and bfloat16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// a load of what another block of the grid wrote, past the SM's L1
#ifndef PTT_HOST_EMULATION
#define PTT_LDCG(p) __ldcg(p)
#else
#define PTT_LDCG(p) (*(p))
#endif

namespace ptt {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
// round to nearest even, as a JAX astype(bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the reference's casts of p and ds to the input
// dtype before they feed a product
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// 16 bytes of T: four f32 or eight bf16 values, unpacked to f32 and back
template <typename T> struct Vec16 { static constexpr int n = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&f)[Vec16<T>::n]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < Vec16<T>::n; ++j) f[j] = to_f(h[j]);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float (&f)[Vec16<T>::n]) {
  uint4 u;
  T* h = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int j = 0; j < Vec16<T>::n; ++j) h[j] = from_f<T>(f[j]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace ptt
