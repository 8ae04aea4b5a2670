// Stand-in for the CUDA runtime header in a host build of the port's
// kernel sources (see mma.cuh here).  A block runs as one fiber per CUDA
// thread, all on the calling OS thread (ucontext): a fiber runs until it
// waits at a barrier (__syncthreads, __syncwarp, a shuffle's exchange),
// then the scheduler resumes the runnable fiber of lowest thread index (of
// highest index in every second block), so a warp runs as far as its
// barriers let it before the next warp starts, and a __syncthreads missing
// between one warp's writes and another's reads shows.  Blocks of a grid
// run one after another, so __shared__ storage is plain static storage and
// a kernel's last block to take a ticket (atomicAdd) is the grid's last.
// One OS thread, with no system call at a barrier but the context switch's
// signal-mask call, keeps a run's time near its CPU time however loaded
// the machine is.
#pragma once
#include <algorithm>
#include <atomic>
#include <cstdio>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <string>
#include <vector>

#include <ucontext.h>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
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
// the running fiber's thread index and its block's index
inline Idx thread_idx, block_idx;
inline char* smem_base;  // the running kernel's dynamic shared memory
inline dim3 grid_dim, block_dim;

struct Barrier {
  int n = 0, count = 0;
  unsigned gen = 0;  // raised each time all n have arrived
};
inline Barrier block_bar, warp_bar[32];
inline bool released;  // a barrier opened since the scheduler last looked

struct Fiber {
  ucontext_t ctx;
  const Barrier* wait = nullptr;  // the barrier it waits at, or none
  unsigned gen = 0;               // that barrier's generation when it arrived
  bool done = false;
};
constexpr size_t kStack = 256 * 1024;
inline ucontext_t scheduler;
inline std::vector<Fiber> fibers;
inline std::vector<std::unique_ptr<char[]>> stacks;
inline const std::function<void()>* body;

// The last of a barrier's n to arrive goes on; the others give the OS
// thread back to the scheduler until the barrier's generation moves.
inline void arrive_and_wait(Barrier& b) {
  if (++b.count == b.n) {
    b.count = 0;
    ++b.gen;
    released = true;
    return;
  }
  Fiber& f = fibers[thread_idx.x];
  f.wait = &b;
  f.gen = b.gen;
  swapcontext(&f.ctx, &scheduler);
}

inline void fiber_main() {
  (*body)();
  fibers[thread_idx.x].done = true;  // returns to the scheduler (uc_link)
}

// runs f() once per thread of every block of `grid`, one block after
// another: in order, or in reverse if PTT_EMU_ORDER is "reverse", or in a
// fixed shuffled order if it is "shuffle".  Within a block, the scheduler
// always resumes the first runnable fiber in its preferred order (thread
// index up in even positions of the block order, down in odd ones) until
// every one has returned.
template <class F>
void launch(dim3 grid, int threads, void* smem, F f) {
  smem_base = static_cast<char*>(smem);
  grid_dim = grid;
  block_dim = dim3(threads);
  block_bar = Barrier{threads};
  for (auto& w : warp_bar) w = Barrier{32};
  fibers.assign(threads, Fiber{});
  while (stacks.size() < static_cast<size_t>(threads)) stacks.emplace_back(new char[kStack]);
  const std::function<void()> run = f;
  body = &run;
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
  for (unsigned i = 0; i < nb; ++i) {
    block_idx.x = order[i] % grid.x;
    block_idx.y = order[i] / grid.x;
    for (int t = 0; t < threads; ++t) {
      Fiber& fb = fibers[t];
      fb = Fiber{};
      getcontext(&fb.ctx);
      fb.ctx.uc_stack.ss_sp = stacks[t].get();
      fb.ctx.uc_stack.ss_size = kStack;
      fb.ctx.uc_link = &scheduler;
      makecontext(&fb.ctx, fiber_main, 0);
    }
    const int step = i % 2 ? -1 : 1, first = step > 0 ? 0 : threads - 1;
    released = false;
    // fibers before t in the preferred order wait, unless a barrier opened
    for (int left = threads, t = first, idle = 0; left > 0;) {
      Fiber& fb = fibers[t];
      if (!fb.done && !(fb.wait && fb.wait->gen == fb.gen)) {
        fb.wait = nullptr;
        thread_idx.x = t;
        swapcontext(&scheduler, &fb.ctx);
        left -= fb.done;
        idle = 0;
        if (released) {
          released = false;
          t = first;
          continue;
        }
      } else if (++idle > threads) {
        std::fprintf(stderr, "emulated block %u: every thread waits at a barrier\n", order[i]);
        std::abort();
      }
      t += step;
      if (t < 0 || t >= threads) t = first;
    }
  }
}
inline int warp() { return thread_idx.x >> 5; }
inline int lane() { return thread_idx.x & 31; }
inline void warp_sync() { arrive_and_wait(warp_bar[warp()]); }
}  // namespace emu

#define threadIdx emu::thread_idx
#define blockIdx emu::block_idx
#define gridDim emu::grid_dim
#define blockDim emu::block_dim

inline void __syncthreads() { emu::arrive_and_wait(emu::block_bar); }
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
