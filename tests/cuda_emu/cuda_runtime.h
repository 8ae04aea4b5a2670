// Stand-in for the CUDA runtime header in a host build of the port's
// kernel sources (see mma.cuh here).  A block runs as one std::thread per
// CUDA thread; __syncthreads and __syncwarp are std::barriers; blocks of a
// grid run one after another, so __shared__ storage is plain static storage
// and a kernel's last block to take a ticket (atomicAdd) is the grid's last.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
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
struct alignas(16) float4 {
  float x, y, z, w;
};

inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }

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
inline dim3 grid_dim, block_dim;

// runs f() once per thread of every block of `grid`, one block after
// another: in order, or in reverse if PTT_EMU_ORDER is "reverse", or in a
// fixed shuffled order if it is "shuffle".  One std::thread per CUDA
// thread, each taking every block in turn, with a block-wide barrier
// between blocks.
template <class F>
void launch(dim3 grid, int threads, void* smem, F f) {
  smem_base = static_cast<char*>(smem);
  grid_dim = grid;
  block_dim = dim3(threads);
  std::barrier<> block(threads);
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  for (int w = 0; w < threads / 32; ++w) {
    warps.emplace_back(new std::barrier<>(32));
    warp_bar[w] = warps.back().get();
  }
  block_bar = &block;
  const unsigned nb = grid.x * grid.y;
  std::vector<unsigned> order(nb);
  for (unsigned i = 0; i < nb; ++i) order[i] = i;
  const char* mode = std::getenv("PTT_EMU_ORDER");
  if (mode && std::string(mode) == "reverse") std::reverse(order.begin(), order.end());
  if (mode && std::string(mode) == "shuffle") {
    uint64_t x = 0x9e3779b97f4a7c15ull;   // a fixed Fisher-Yates
    for (unsigned i = nb; i > 1; --i) {
      x = x * 6364136223846793005ull + 1442695040888963407ull;
      std::swap(order[i - 1], order[(x >> 33) % i]);
    }
  }
  std::vector<std::thread> ts;
  for (int t = 0; t < threads; ++t)
    ts.emplace_back([&, t] {
      thread_idx.x = t;
      for (unsigned i = 0; i < nb; ++i) {
        const unsigned b = order[i];
        block_idx.x = b % grid.x;
        block_idx.y = b / grid.x;
        f();
        block.arrive_and_wait();
      }
    });
  for (auto& t : ts) t.join();
}
inline int warp() { return thread_idx.x >> 5; }
inline int lane() { return thread_idx.x & 31; }
inline void warp_sync() { warp_bar[warp()]->arrive_and_wait(); }
}  // namespace emu

#define threadIdx emu::thread_idx
#define blockIdx emu::block_idx
#define gridDim emu::grid_dim
#define blockDim emu::block_dim

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

namespace emu {
// a warp's lanes exchange values through these slots between two barriers
inline uint64_t shfl_slots[32][32];
template <class T>
T shfl_from(T v, int src_lane) {
  static_assert(sizeof(T) <= 8, "shuffle of a value wider than 8 bytes");
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  shfl_slots[warp()][lane()] = bits;
  warp_sync();
  bits = shfl_slots[warp()][src_lane];
  warp_sync();
  T r;
  std::memcpy(&r, &bits, sizeof(T));
  return r;
}
}  // namespace emu

// int, int64 and float shuffles, as the CUDA intrinsics: a lane past the
// warp's end reads its own value
template <class T>
inline T __shfl_down_sync(unsigned, T v, int delta) {
  const int src = emu::lane() + delta;
  return emu::shfl_from(v, src < 32 ? src : emu::lane());
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src_lane) {
  return emu::shfl_from(v, src_lane & 31);
}

inline unsigned __ballot_sync(unsigned, int pred) {
  emu::shfl_slots[emu::warp()][emu::lane()] = pred != 0;
  emu::warp_sync();
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= static_cast<unsigned>(emu::shfl_slots[emu::warp()][l]) << l;
  emu::warp_sync();
  return m;
}
inline bool __any_sync(unsigned mask, int pred) { return __ballot_sync(mask, pred) != 0; }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }

inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }

inline uint32_t __cvta_generic_to_shared(const void* p) {
  return static_cast<uint32_t>(static_cast<const char*>(p) - emu::smem_base);
}
