// Host stand-in for paddle_tpu_torch/kernels/csrc/mma.cuh, with PTX's
// semantics, so that the tensor-core kernels' fragment indexing, masks and
// cp.async ordering can be run on a CPU:
// - cp.async copies are queued per CUDA thread and land only at the
//   cp.async.wait_group that covers their group (a read before the wait
//   sees stale shared memory, as on the card);
// - ldmatrix and mma.sync exchange their lanes' operands through per-warp
//   slots between two warp barriers, then each lane takes its own fragment
//   (layouts in the real header's comment); products are summed in f32.
#pragma once
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "cuda_bf16.h"
#include "cuda_runtime.h"

namespace ptt {

inline uint32_t smem_addr(const void* p) { return __cvta_generic_to_shared(p); }

struct PendingCopy {
  uint32_t dst;
  const void* src;
  int bytes;  // 0: zero-fill
  int size;
  int group;
};
// each CUDA thread's queue and open group, by thread index
inline std::vector<PendingCopy> pending_of[1024];
inline int open_group_of[1024];

inline void cp_async(uint32_t dst, const void* src, int size, bool valid) {
  if (dst % size) std::abort();
  pending_of[threadIdx.x].push_back({dst, src, valid ? size : 0, size, open_group_of[threadIdx.x]});
}
inline void cp_async16(uint32_t dst, const void* src, bool valid) { cp_async(dst, src, 16, valid); }
inline void cp_async4(uint32_t dst, const void* src, bool valid) { cp_async(dst, src, 4, valid); }
inline void cp_async_commit() { ++open_group_of[threadIdx.x]; }
template <int N>
inline void cp_async_wait() {
  std::vector<PendingCopy>& pending = pending_of[threadIdx.x];
  std::vector<PendingCopy> later;
  for (const PendingCopy& c : pending) {
    if (c.group < open_group_of[threadIdx.x] - N) {
      if (c.bytes) std::memcpy(emu::smem_base + c.dst, c.src, c.bytes);
      else std::memset(emu::smem_base + c.dst, 0, c.size);
    } else {
      later.push_back(c);
    }
  }
  pending.swap(later);
}

struct WarpSlots {
  uint32_t addr[32];
  uint32_t a[32][4];
  uint32_t b[32][2];
};
inline WarpSlots slots[32];

inline uint16_t ld16(uint32_t addr) {
  uint16_t v;
  std::memcpy(&v, emu::smem_base + addr, 2);
  return v;
}

// lanes 8i..8i+7 give the row addresses of matrix i; plain: lane holds
// M[g][2t..2t+1]; trans: M[2t][g] and M[2t+1][g]
inline void ldmatrix(uint32_t (&r)[4], uint32_t addr, bool trans) {
  WarpSlots& s = slots[emu::warp()];
  const int l = emu::lane(), g = l >> 2, t = l & 3;
  if (addr % 16) std::abort();
  s.addr[l] = addr;
  emu::warp_sync();
  for (int i = 0; i < 4; ++i) {
    const uint16_t lo = trans ? ld16(s.addr[8 * i + 2 * t] + 2 * g) : ld16(s.addr[8 * i + g] + 4 * t);
    const uint16_t hi =
        trans ? ld16(s.addr[8 * i + 2 * t + 1] + 2 * g) : ld16(s.addr[8 * i + g] + 4 * t + 2);
    r[i] = static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
  }
  emu::warp_sync();
}
inline void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) { ldmatrix(r, addr, false); }
inline void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) { ldmatrix(r, addr, true); }

inline float half_of(uint32_t reg, int hi) {
  return __bfloat162float({static_cast<uint16_t>(hi ? reg >> 16 : reg & 0xffffu)});
}

// d += A (16 x 16) . B (16 x 8): a0 = A[g][2t..], a1 = A[g+8][2t..],
// a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]; b0 = B[2t..][g], b1 = B[2t+8..][g];
// d0, d1 = D[g][2t..], d2, d3 = D[g+8][2t..]
inline void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  WarpSlots& s = slots[emu::warp()];
  const int l = emu::lane(), g = l >> 2, t = l & 3;
  for (int i = 0; i < 4; ++i) s.a[l][i] = a[i];
  s.b[l][0] = b0;
  s.b[l][1] = b1;
  emu::warp_sync();
  float A[16][16], B[16][8];
  for (int ln = 0; ln < 32; ++ln) {
    const int G = ln >> 2, T = ln & 3;
    for (int h = 0; h < 2; ++h) {
      A[G][2 * T + h] = half_of(s.a[ln][0], h);
      A[G + 8][2 * T + h] = half_of(s.a[ln][1], h);
      A[G][2 * T + 8 + h] = half_of(s.a[ln][2], h);
      A[G + 8][2 * T + 8 + h] = half_of(s.a[ln][3], h);
      B[2 * T + h][G] = half_of(s.b[ln][0], h);
      B[2 * T + 8 + h][G] = half_of(s.b[ln][1], h);
    }
  }
  emu::warp_sync();
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float acc = d[e];
    for (int k = 0; k < 16; ++k) acc += A[row][k] * B[k][col];
    d[e] = acc;
  }
}

inline uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return static_cast<uint32_t>(v.x.bits) | (static_cast<uint32_t>(v.y.bits) << 16);
}

inline float exp2_approx(float x) {
  const float y = std::exp2(x);
  return std::fpclassify(y) == FP_SUBNORMAL ? 0.f : y;  // .ftz
}

template <int CH>
inline uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(row * CH + (chunk ^ (row & 7))) * 16;
}

}  // namespace ptt
