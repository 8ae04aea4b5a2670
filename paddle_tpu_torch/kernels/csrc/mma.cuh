// Tensor-core building blocks for the port's bf16 kernels (sm_80+ PTX that
// Hopper runs): 16- and 4-byte cp.async copies with zero-fill, ldmatrix (plain and
// transposed), mma.sync m16n8k16 with bf16 operands and f32 accumulators,
// and an XOR swizzle for [rows][chunks] tiles in shared memory.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16 x 16 (row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                          a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B 16 x 8 (k x n):      b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C 16 x 8 (f32):        c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// ldmatrix.x4 gives register i the 8 x 8 matrix whose row addresses lanes
// 8i..8i+7 supply: plain, lane holds M[g][2t..2t+1]; with .trans, lane
// holds M[2t][g] and M[2t+1][g].  So a tile stored [rows][contraction]
// feeds A (or B, for a product against its rows' transpose) through the
// plain form, and a tile stored [contraction][columns] feeds B (or A, for
// its transpose) through .trans.  Shared-memory operands are 32-bit
// shared-window byte addresses (smem_addr), which hold fewer registers than
// generic pointers.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>

namespace ptt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; when !valid the
// destination is filled with zeros and src is not read (src-size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes (one f32) from global to shared memory, asynchronously, with the
// same zero-fill: for per-row statistics whose rows need not be 16-byte
// aligned
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a . b on the tensor cores: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to nearest-even bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (flushes a subnormal result to 0: such
// a softmax weight is below f32's resolution of the row sum anyway)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of 16-byte chunk `chunk` of row `row` in a tile of CH chunks
// a row, the chunk index XORed with row % 8: the eight rows that one
// ldmatrix matrix reads (or one chunk column of a cp.async) then fall on
// eight different bank groups
template <int CH>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * CH + (chunk ^ (row & 7))) * 16;
}

}  // namespace ptt
