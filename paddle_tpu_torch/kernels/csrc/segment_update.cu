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
// Design: one launch, one block per tile of 256 sorted positions (and per
// chunk of 32 columns of wider rows), deterministic, no float atomics.
// - Staged gather.  The block loads its 256 `order` entries into shared
//   memory, then gathers the flat [256 x D] tile of values with consecutive
//   threads on consecutive elements of each source row, so a warp's load
//   touches two or three rows instead of 32.  Rows wider than kCols values
//   are split into chunks of kCols columns, one block for each tile and
//   chunk (blockIdx.y), so the tile stays within 38 KB of shared memory for
//   any D and each chunk has its own scan, store and fold.
// - A reverse segmented scan over exactly D columns, on the shared tile:
//   each thread owns one sorted position; per column, five warp shuffles
//   (the run tests of each step are taken once from the keys), then the
//   eight warps' head sums through shared memory.  At a run's first
//   position that gives the run's in-tile total.
// - Coalesced output.  A tile's output rows [256, D] are one contiguous
//   span, zeros included: it goes out of shared memory in 16-byte stores
//   (256 * D * sizeof(T) is a multiple of 16); a chunk of wider rows goes
//   out row by row, consecutive threads on consecutive values.
// - Runs crossing tile edges.  The run crossing a tile's head leaves its
//   in-tile sum in partial[tile] (zeros if none); the run whose first
//   position is in the tile and which goes on past its tail leaves its
//   in-tile sum in own[tile] and its position in spill[tile].  Each such
//   run has a counter (runs[owner tile]); every tile of the run fences and
//   adds to it once its pieces are written, so the run's last tile to
//   finish sees the counter complete and adds own + the partials, with all
//   its threads, in a fixed order, then resets the counter to 0 for the
//   next call.  The typical run crosses one edge and is added by the later
//   of its two tiles, with no serial tail; a tile finds the owner of its
//   head run in one probe of the keys (a 32-way search for longer runs).  The
//   order of a run's sum depends only on its length and D, so two calls
//   give the same bits; one id repeated N times is N / 256 partials summed
//   by 256 threads, not a serial walk.
// - The TPU kernel instead takes per-run suffix sums with a [bn, bn] mask
//   matmul and carries the run crossing a block edge through a reverse
//   sequential grid; neither the matmul nor the sequential grid exists here.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTile = 256;          // sorted positions per block (= threads)
constexpr int kWarps = kTile / 32;
constexpr int kCols = 32;           // columns a block takes (its chunk of D)
constexpr unsigned kRunTotal = 0x80000000u;   // a run's counter when all its tiles are in

// dynamic shared memory, for a chunk of Dc = min(D, kCols) columns: the
// value tile [kTile * Dc] f32 (the fold's kTile-float scratch afterwards),
// the warps' head sums [kWarps * Dc] f32, the order entries [kTile] int64,
// the warps' head keys and valid bits, and two flags.  Offsets in 4-byte
// words; at most 38 KB.
__host__ __device__ inline int seg_src_word(int Dc) {
  return (kTile * Dc + kWarps * Dc + 1) & ~1;   // int64-aligned
}
template <typename K>
__host__ __device__ inline size_t seg_smem_bytes(int D) {
  const int Dc = D < kCols ? D : kCols;
  return 4 * (size_t)seg_src_word(Dc) + 8 * kTile + sizeof(K) * kWarps +
         4 * kWarps + 8;
}

// The owner tile of the run that crosses tile t's head (key k): the last
// tile j <= t - 1 where the run has not begun before j's first position.
// The whole warp searches: one probe when the run began in tile t - 1 (the
// usual case), else rounds of 32 probes, each cutting the range 32-fold.
template <typename K>
__device__ int owner_of(const K* __restrict__ keys, int t, K k, int lane) {
  auto starts_by = [&](int j) {
    return j == 0 || keys[(long long)j * kTile - 1] != k;
  };
  if (starts_by(t - 1)) return t - 1;
  int lo = 0, hi = t - 2;             // starts_by(lo); the owner is in [lo, hi]
  while (lo < hi) {
    const int p = lo + 1 + (int)((long long)(hi - lo) * lane / 32);   // in (lo, hi]
    const unsigned m = __ballot_sync(0xffffffffu, starts_by(p));
    const int last = m ? 31 - __clz(m) : -1;   // the probes hold up to this lane
    const int next = __shfl_sync(0xffffffffu, p, last + 1 < 32 ? last + 1 : 31);
    if (last >= 0) lo = __shfl_sync(0xffffffffu, p, last);
    if (last + 1 < 32) hi = next - 1;
  }
  return lo;
}

// The run owned by tile o covers tiles o .. e: write own[o] + partial[o+1]
// + ... + partial[e] at its first position, for the dc columns that
// partial, own and out point at (rows D apart).  All threads: a fixed
// chunk of every (kTile / dc)-th tile to each thread, then the chunks in
// order, so the bits depend only on (e - o, dc).  `red` holds kTile floats.
template <typename T>
__device__ void fold_run(int o, int e, const float* __restrict__ partial,
                         const float* __restrict__ own, const int* __restrict__ spill,
                         T* __restrict__ out, int D, int dc, float* __restrict__ red) {
  const int tid = threadIdx.x;
  const int chunks = kTile / dc, j = tid / dc, c = tid - j * dc;
  float acc = 0.f;
  if (j < chunks) {
#pragma unroll 8
    for (int t = o + 1 + j; t <= e; t += chunks) acc += PTT_LDCG(partial + (long long)t * D + c);
  }
  red[tid] = acc;
  __syncthreads();
  if (tid < dc) {
    float tot = PTT_LDCG(own + (long long)o * D + tid);
    for (int jj = 0; jj < chunks; ++jj) tot += red[jj * dc + tid];
    const long long pos = (long long)o * kTile + PTT_LDCG(spill + o);
    out[pos * D + tid] = ptt::from_f<T>(tot);
  }
  __syncthreads();
}

template <typename T, typename K>
__global__ void __launch_bounds__(kTile)
segsum_kernel(const K* __restrict__ keys, const long long* __restrict__ order,
              const T* __restrict__ values, T* __restrict__ out,
              K* __restrict__ out_rows, float* __restrict__ partial,
              float* __restrict__ own, int* __restrict__ spill,
              unsigned* __restrict__ runs, int* __restrict__ run_end, long long N,
              int D, K height) {
  extern __shared__ uint4 seg_smem[];
  // this block's columns: chunk blockIdx.y of D, with its own counters
  // and bookkeeping rows
  const int Dc = min(D, kCols), c0 = blockIdx.y * Dc, dc = min(Dc, D - c0);
  runs += (long long)blockIdx.y * gridDim.x;
  spill += (long long)blockIdx.y * gridDim.x;
  run_end += (long long)blockIdx.y * gridDim.x;
  float* tile = reinterpret_cast<float*>(seg_smem);
  float* hsum = tile + kTile * dc;
  long long* src = reinterpret_cast<long long*>(tile + seg_src_word(dc));
  K* hkey = reinterpret_cast<K*>(src + kTile);
  int* hvalid = reinterpret_cast<int*>(hkey + kWarps);
  int* flag = hvalid + kWarps;      // [0] owner's position, [1] head run's owner

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = (long long)blockIdx.x * kTile;
  const int n = (int)min((long long)kTile, N - t0);
  const long long i = t0 + tid;
  const bool valid = tid < n;
  const K key = valid ? keys[i] : K(0);
  const bool first = valid && (i == 0 || keys[i - 1] != key);
  const long long last = t0 + n - 1;
  const K last_key = keys[last];
  const bool spills = last + 1 < N && keys[last + 1] == last_key;
  // this position starts the run that goes on past the tile: its owner
  const bool owner = first && spills && key == last_key;

  // the scan's run tests: bit s is set where the lane 2^s below is in this
  // lane's run (sorted keys: equal keys are contiguous)
  unsigned same = 0;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int o = 1 << s;
    const K kf = __shfl_down_sync(0xffffffffu, key, o);
    const int vf = __shfl_down_sync(0xffffffffu, (int)valid, o);
    if (lane + o < 32 && vf && valid && kf == key) same |= 1u << s;
  }
  const K wlast_key = __shfl_sync(0xffffffffu, key, 31);
  const int wlast_valid = __shfl_sync(0xffffffffu, (int)valid, 31);
  const bool reaches_end = valid && wlast_valid && key == wlast_key;

  if (valid) src[tid] = order[i];
  if (lane == 0) {
    hkey[warp] = key;
    hvalid[warp] = valid;
  }
  if (tid == 0) flag[0] = -1;
  __syncthreads();
  if (owner) flag[0] = tid;
  if (valid && blockIdx.y == 0) out_rows[i] = first ? key : height;

  // staged gather of the tile's rows, in the sorted order
#pragma unroll 4
  for (int e = tid; e < n * dc; e += kTile) {
    const int p = e / dc;
    tile[e] = ptt::to_f(values[src[p] * D + c0 + (e - p * dc)]);
  }
  __syncthreads();

  // reverse segmented scan within each warp, column by column
  // (a warp whose keys are all distinct has nothing to add)
  float* row = tile + tid * dc;
  if (__any_sync(0xffffffffu, same != 0)) {
    for (int c = 0; c < dc; ++c) {
      float s = valid ? row[c] : 0.f;
#pragma unroll
      for (int st = 0; st < 5; ++st) {
        const float x = __shfl_down_sync(0xffffffffu, s, 1 << st);
        if (same >> st & 1) s += x;
      }
      if (valid) row[c] = s;
      if (lane == 0) hsum[warp * dc + c] = s;
    }
  } else if (lane == 0) {
    for (int c = 0; c < dc; ++c) hsum[warp * dc + c] = valid ? row[c] : 0.f;
  }
  __syncthreads();
  // a run reaching its warp's end goes on into the following warps whose
  // first lane has its key
  int w_end = warp + 1;
  if (reaches_end)
    while (w_end < kWarps && hvalid[w_end] && hkey[w_end] == key) ++w_end;
  const bool head_run = tid == 0 && !first;
  // a run that starts here and ends in this warp already has its total
  const bool done_here = first && !owner && w_end == warp + 1 && tid != 0;
  for (int c = 0; c < dc && !done_here; ++c) {
    float s = valid ? row[c] : 0.f;
    for (int w = warp + 1; w < w_end; ++w) s += hsum[w * dc + c];
    if (owner) own[(long long)blockIdx.x * D + c0 + c] = s;
    if (tid == 0) partial[(long long)blockIdx.x * D + c0 + c] = head_run ? s : 0.f;
    if (valid) row[c] = (first && !owner) ? s : 0.f;
  }
  __syncthreads();

  // the tile's output rows: one contiguous span, or the chunk's columns
  // row by row
  if (dc == D) {
    constexpr int kV = ptt::Vec16<T>::n;
    T* dst = out + t0 * D;
    const int L = n * D, nv = L / kV;
    for (int v = tid; v < nv; v += kTile) {
      float f[kV];
#pragma unroll
      for (int e = 0; e < kV; ++e) f[e] = tile[v * kV + e];
      ptt::store16(dst + v * kV, f);
    }
    for (int e = nv * kV + tid; e < L; e += kTile) dst[e] = ptt::from_f<T>(tile[e]);
  } else {
    for (int e = tid; e < n * dc; e += kTile) {
      const int p = e / dc;
      out[(t0 + p) * D + c0 + (e - p * dc)] = ptt::from_f<T>(tile[e]);
    }
  }
  // The runs that cross this tile's edges.  Each run crossing an edge has
  // a counter, runs[o] for its owner tile o, and the run's tiles o .. e
  // each add to it once they have written their pieces: e adds
  // kRunTotal - (e - o), every other tile 1.  The tile that brings it to
  // kRunTotal is the run's last to finish; it adds the run up and resets
  // the counter.  spill[t]: the owner's position, -1, or -2 where the
  // tile's head run goes on past the tile.
  const int t = blockIdx.x;
  if (warp == 0) {
    const K k0 = __shfl_sync(0xffffffffu, key, 0);
    const int o = __shfl_sync(0xffffffffu, (int)head_run, 0)
                      ? owner_of(keys, t, k0, lane) : -1;   // the head run's owner
    if (tid == 0) {
      const bool through = head_run && key == last_key;   // one run, all the tile
      spill[t] = through && spills ? -2 : flag[0];
      flag[1] = o;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int fold = 0;
    const int o = flag[1];
    const bool through = head_run && key == last_key;
    if (o >= 0) {
      const bool end = !(through && spills);
      if (end) run_end[o] = t;
      __threadfence();
      const unsigned inc = end ? kRunTotal - (unsigned)(t - o) : 1u;
      if (atomicAdd(runs + o, inc) + inc == kRunTotal) fold |= 1;
    }
    if (flag[0] >= 0 && atomicAdd(runs + t, 1u) + 1u == kRunTotal) fold |= 2;
    flag[0] = fold;
  }
  __syncthreads();
  const int fold = flag[0];
  if (fold) {
    __threadfence();
    if (fold & 1) {                   // the head run, owned by flag[1]
      const int o = flag[1];
      const int e = PTT_LDCG(run_end + o);
      fold_run<T>(o, e, partial + c0, own + c0, spill, out + c0, D, dc, tile);
      if (tid == 0) runs[o] = 0u;
    }
    if (fold & 2) {                   // the run this tile owns
      const int e = PTT_LDCG(run_end + t);
      fold_run<T>(t, e, partial + c0, own + c0, spill, out + c0, D, dc, tile);
      if (tid == 0) runs[t] = 0u;
    }
  }
}

#ifndef PTT_HOST_EMULATION  // a host build (tests/cuda_emu) takes the kernels alone

template <typename T, typename K>
int launch(const void* keys, const void* order, const void* values, void* out,
           void* out_rows, void* scratch, void* runs, long long N, int D,
           long long height, cudaStream_t s) {
  const long long tiles = (N + kTile - 1) / kTile;
  const int chunks = (D + kCols - 1) / kCols;
  float* partial = (float*)scratch;
  float* own = partial + tiles * D;
  int* spill = (int*)(own + tiles * D);
  int* run_end = spill + tiles * chunks;
  segsum_kernel<T, K><<<dim3((unsigned)tiles, chunks), kTile,
                        seg_smem_bytes<K>(D), s>>>(
      (const K*)keys, (const long long*)order, (const T*)values, (T*)out,
      (K*)out_rows, partial, own, spill, (unsigned*)runs, run_end, N, D, (K)height);
  return (int)cudaGetLastError();
}

#endif  // PTT_HOST_EMULATION

}  // namespace

#ifndef PTT_HOST_EMULATION

// keys [N] sorted (int32 if key64 == 0, else int64), order [N] int64,
// values [N, D] (dtype 0 f32, 1 bf16; any D) -> out [N, D], out_rows [N]
// (keys' type).  Scratch: f32 [2 * tiles * D + 2 * tiles * chunks], tiles =
// ceil(N / 256), chunks = ceil(D / 32) (partial, own, then spill and
// run_end as int32).  runs: uint32 [tiles * chunks] run counters, 0 before
// the call and 0 after it; calls that share scratch and counters run on
// one stream.
extern "C" int ptt_segment_sum(const void* keys, const void* order,
                               const void* values, void* out, void* out_rows,
                               void* scratch, void* runs, long long N, int D,
                               long long height, int key64, int dtype,
                               void* stream) {
  if (N == 0 || D == 0) return 0;
  if ((N + kTile - 1) / kTile > 0x7fffffffLL || (D + kCols - 1) / kCols > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return key64 ? launch<float, long long>(keys, order, values, out, out_rows,
                                            scratch, runs, N, D, height, s)
                 : launch<float, int>(keys, order, values, out, out_rows, scratch,
                                      runs, N, D, height, s);
  return key64 ? launch<__nv_bfloat16, long long>(keys, order, values, out,
                                                  out_rows, scratch, runs, N, D,
                                                  height, s)
               : launch<__nv_bfloat16, int>(keys, order, values, out, out_rows,
                                            scratch, runs, N, D, height, s);
}

#endif  // PTT_HOST_EMULATION
