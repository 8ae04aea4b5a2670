// Sorted segment sum for Hopper (sm_90a): the deduplicated sparse-row merge.
//
// Replaces paddle_tpu/kernels/segment_update.py:_segsum_kernel and the
// gather of sorted values in its wrapper (dedup_segment_sum).  Input: ids
// sorted by a stable sort (keys [N]) with the sort's permutation (order [N],
// int64) and the values in their original order ([N, D], f32 or bf16).
// Output: each run of equal ids gets its f32 total, cast to the values'
// dtype, at the run's FIRST sorted position and zeros everywhere else;
// out_rows holds the id at first positions and `height` elsewhere.
//
// Bound on the H100: device-memory bytes.  One pass reads the keys, the
// permutation and the values (gathered rows of D elements) once and writes
// the [N, D] output and the row ids once, with one add an element: far
// below the CUDA cores' rate.
//
// Design (deterministic, no atomics):
// - segsum_tile_kernel: one block per tile of 256 sorted positions, one
//   thread a position.  Each thread reads values[order[i]] itself, so the
//   sorted copy of the values is never written.  A reverse segmented scan
//   (warp shuffles, then the eight warps' head sums through shared memory)
//   gives every position the sum of its run from there to the tile's end;
//   at a run's first position that is the run's in-tile total.  Runs that
//   lie inside the tile are written at once.  The run crossing the tile's
//   head (it started in an earlier tile) leaves its in-tile sum in
//   partial[tile]; the run crossing the tile's tail whose first position is
//   in this tile leaves its in-tile sum in own[tile] and its first position
//   in spill[tile].
// - segsum_fixup_kernel: one block per tile that owns such a spilling run.
//   It finds the run's last position by binary search over the sorted keys,
//   sums partial[] of the tiles the run covers with 512 threads (columns x
//   a fixed stride of tiles, then a fixed-order fold), adds own[tile] and
//   writes the total once.  One id repeated N times is thus N / 256 tile
//   sums read by one block, not a serial walk over N positions.
// - The TPU kernel instead takes per-run suffix sums with a [bn, bn] mask
//   matmul and carries the run crossing a block edge through a reverse
//   sequential grid; neither the matmul nor the sequential grid exists here.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTile = 256;          // sorted positions per tile (= threads)
constexpr int kWarps = kTile / 32;
constexpr int kChunk = 16;          // value columns held in registers at once
constexpr int kFixX = 32, kFixY = 16;   // fix-up block: columns x tile stride

template <typename T, typename K>
__global__ void __launch_bounds__(kTile)
segsum_tile_kernel(const K* __restrict__ keys, const long long* __restrict__ order,
                   const T* __restrict__ values, T* __restrict__ out,
                   K* __restrict__ out_rows, float* __restrict__ partial,
                   float* __restrict__ own, int* __restrict__ spill,
                   long long N, int D, K height) {
  __shared__ float head_sum[kWarps][kChunk];
  __shared__ K head_key[kWarps];
  __shared__ int head_valid[kWarps];
  __shared__ int spill_pos;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t0 = (long long)blockIdx.x * kTile;
  const long long i = t0 + threadIdx.x;
  const bool valid = i < N;
  const K key = valid ? keys[i] : K(0);
  const bool first = valid && (i == 0 || keys[i - 1] != key);
  const long long src = valid ? order[i] : 0;

  // the tile's last position, and whether its run goes on past the tile
  const long long last = min(t0 + kTile, N) - 1;
  const K last_key = keys[last];
  const bool spills = last + 1 < N && keys[last + 1] == last_key;
  // this thread's position starts the run that spills: its owner
  const bool owner = first && spills && key == last_key;

  // the key of this warp's last lane, for "my run reaches the warp's end"
  const K wlast_key = __shfl_sync(0xffffffffu, key, 31);
  const bool wlast_valid = __shfl_sync(0xffffffffu, (int)valid, 31);
  const bool reaches_end = valid && wlast_valid && key == wlast_key;

  if (threadIdx.x == 0) spill_pos = -1;
  if (lane == 0) {
    head_key[warp] = key;
    head_valid[warp] = valid;
  }
  __syncthreads();
  if (owner) spill_pos = (int)(i - t0);
  if (valid) out_rows[i] = first ? key : height;

  for (int c0 = 0; c0 < D; c0 += kChunk) {
    float s[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      s[k] = (valid && c0 + k < D) ? ptt::to_f(values[src * D + c0 + k]) : 0.f;
    // reverse segmented inclusive scan within the warp: after the step
    // with offset o, s holds the sum over [lane, lane + 2o) of this run
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const K kf = __shfl_down_sync(0xffffffffu, key, o);
      const int vf = __shfl_down_sync(0xffffffffu, (int)valid, o);
      const bool same = lane + o < 32 && vf && valid && kf == key;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const float x = __shfl_down_sync(0xffffffffu, s[k], o);
        if (same) s[k] += x;
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) head_sum[warp][k] = s[k];
    }
    __syncthreads();
    // a run reaching this warp's end goes on into the following warps
    // whose first lane has its key (contiguous, since the keys are sorted)
    if (reaches_end) {
      for (int w = warp + 1; w < kWarps && head_valid[w] && head_key[w] == key; ++w) {
#pragma unroll
        for (int k = 0; k < kChunk; ++k) s[k] += head_sum[w][k];
      }
    }
    if (valid) {
      float* dst = owner ? own + (long long)blockIdx.x * D : nullptr;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (c0 + k >= D) break;
        if (owner)
          dst[c0 + k] = s[k];
        else
          out[i * D + c0 + k] = ptt::from_f<T>(first ? s[k] : 0.f);
      }
      // the run crossing the tile's head: its in-tile sum for the fix-up
      if (threadIdx.x == 0 && !first) {
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
          if (c0 + k < D) partial[(long long)blockIdx.x * D + c0 + k] = s[k];
      }
    }
    __syncthreads();   // head_sum is rewritten by the next chunk
  }
  if (threadIdx.x == 0) spill[blockIdx.x] = spill_pos;
}

template <typename T, typename K>
__global__ void __launch_bounds__(kFixX * kFixY)
segsum_fixup_kernel(const K* __restrict__ keys, const float* __restrict__ partial,
                    const float* __restrict__ own, const int* __restrict__ spill,
                    T* __restrict__ out, long long N, int D) {
  __shared__ long long end_tile;
  __shared__ float red[kFixY][kFixX];
  const int tile = blockIdx.x;
  const int p = spill[tile];
  if (p < 0) return;                  // no run starts here and goes on
  const long long t0 = (long long)tile * kTile;
  const long long pos = t0 + p;
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    // last position with this key: upper bound over the sorted keys
    const K key = keys[pos];
    long long lo = min(t0 + kTile, N), hi = N;   // keys[lo] == key (spills)
    while (hi - lo > 1) {
      const long long mid = lo + (hi - lo) / 2;
      if (keys[mid] == key) lo = mid; else hi = mid;
    }
    end_tile = lo / kTile;
  }
  __syncthreads();
  const long long e = end_tile;
  for (int c0 = 0; c0 < D; c0 += kFixX) {
    const int c = c0 + threadIdx.x;
    float acc = 0.f;
    if (c < D)
      for (long long t = tile + 1 + threadIdx.y; t <= e; t += kFixY)
        acc += partial[t * D + c];
    red[threadIdx.y][threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.y == 0 && c < D) {
      float tot = own[(long long)tile * D + c];
#pragma unroll
      for (int y = 0; y < kFixY; ++y) tot += red[y][threadIdx.x];
      out[pos * D + c] = ptt::from_f<T>(tot);
    }
    __syncthreads();
  }
}

template <typename T, typename K>
int launch(const void* keys, const void* order, const void* values, void* out,
           void* out_rows, void* partial, void* own, void* spill, long long N,
           int D, long long height, cudaStream_t s) {
  const long long tiles = (N + kTile - 1) / kTile;
  segsum_tile_kernel<T, K><<<(unsigned)tiles, kTile, 0, s>>>(
      (const K*)keys, (const long long*)order, (const T*)values, (T*)out,
      (K*)out_rows, (float*)partial, (float*)own, (int*)spill, N, D, (K)height);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  segsum_fixup_kernel<T, K><<<(unsigned)tiles, dim3(kFixX, kFixY), 0, s>>>(
      (const K*)keys, (const float*)partial, (const float*)own,
      (const int*)spill, (T*)out, N, D);
  return (int)cudaGetLastError();
}

}  // namespace

// keys [N] sorted (int32 if key64 == 0, else int64), order [N] int64,
// values [N, D] (dtype 0 f32, 1 bf16) -> out [N, D], out_rows [N] (keys'
// type).  Scratch: partial and own f32 [tiles, D], spill int32 [tiles],
// tiles = ceil(N / 256).
extern "C" int ptt_segment_sum(const void* keys, const void* order,
                               const void* values, void* out, void* out_rows,
                               void* partial, void* own, void* spill,
                               long long N, int D, long long height,
                               int key64, int dtype, void* stream) {
  if (N == 0 || D == 0) return 0;
  if ((N + kTile - 1) / kTile > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return key64 ? launch<float, long long>(keys, order, values, out, out_rows, partial,
                                            own, spill, N, D, height, s)
                 : launch<float, int>(keys, order, values, out, out_rows, partial, own,
                                      spill, N, D, height, s);
  return key64 ? launch<__nv_bfloat16, long long>(keys, order, values, out, out_rows,
                                                  partial, own, spill, N, D, height, s)
               : launch<__nv_bfloat16, int>(keys, order, values, out, out_rows, partial,
                                            own, spill, N, D, height, s);
}
