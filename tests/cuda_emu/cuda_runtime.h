// Stand-in for the CUDA runtime header in a host build of the port's
// kernel sources (see mma.cuh here).  A block runs as one std::thread per
// CUDA thread; __syncthreads and __syncwarp are std::barriers; blocks of a
// grid run one after another, so __shared__ storage is plain static storage.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __shared__

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint4 {
  unsigned x, y, z, w;
};
struct float2 {
  float x, y;
};

typedef int cudaError_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
typedef void* cudaStream_t;

namespace emu {
struct Idx {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local Idx thread_idx, block_idx;
inline std::barrier<>* block_bar;
inline std::barrier<>* warp_bar[32];
inline char* smem_base;  // the running kernel's dynamic shared memory

// runs f() once per thread of every block of `grid`, blocks in order
template <class F>
void launch(dim3 grid, int threads, void* smem, F f) {
  smem_base = static_cast<char*>(smem);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::barrier<> block(threads);
      std::vector<std::unique_ptr<std::barrier<>>> warps;
      for (int w = 0; w < threads / 32; ++w) {
        warps.emplace_back(new std::barrier<>(32));
        warp_bar[w] = warps.back().get();
      }
      block_bar = &block;
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([&, t] {
          thread_idx.x = t;
          block_idx.x = bx;
          block_idx.y = by;
          f();
        });
      for (auto& t : ts) t.join();
    }
}
inline int warp() { return thread_idx.x >> 5; }
inline int lane() { return thread_idx.x & 31; }
inline void warp_sync() { warp_bar[warp()]->arrive_and_wait(); }
}  // namespace emu

#define threadIdx emu::thread_idx
#define blockIdx emu::block_idx

inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline void __syncwarp() { emu::warp_sync(); }

inline float __shfl_xor_sync(unsigned, float v, int mask) {
  static float slots[32][32];
  slots[emu::warp()][emu::lane()] = v;
  emu::warp_sync();
  const float r = slots[emu::warp()][emu::lane() ^ mask];
  emu::warp_sync();
  return r;
}

inline uint32_t __cvta_generic_to_shared(const void* p) {
  return static_cast<uint32_t>(static_cast<const char*>(p) - emu::smem_base);
}
