// The segment-sum kernel of csrc/segment_update.cu, built for the host
// against the stand-in headers in this directory and run on one input:
//
//   seg_emu DIR N D dtype key64 height calls
//
// DIR holds keys.bin (sorted ids, int32 or int64 if key64), order.bin (the
// sort's permutation, int64) and values.bin ([N, D] f32, or bf16 bits if
// dtype is 1).  The kernel runs `calls` times on the same inputs; the i-th
// call writes out<i>.bin and rows<i>.bin, and done.bin holds the run
// counters, or-ed together, after the last call (0: all were reset).  Outputs start as NaN (values) and -7
// (rows), so an element no call wrote shows.
#include <cstdio>
#include <cstdlib>
#include <string>

#include "segment_update.cu"

namespace {
// the kernel's dynamic shared memory at its widest chunk (seg_smem_bytes)
alignas(16) uint4 seg_smem[(4 * (kTile * kCols + kWarps * kCols + 2) + 8 * kTile + 128) / 16];

template <class T>
std::vector<T> load(const std::string& path, size_t n) {
  std::vector<T> out(n);
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f || std::fread(out.data(), sizeof(T), n, f) != n) {
    std::fprintf(stderr, "cannot read %zu values from %s\n", n, path.c_str());
    std::exit(2);
  }
  std::fclose(f);
  return out;
}

template <class T>
void save(const std::string& path, const std::vector<T>& v) {
  FILE* f = std::fopen(path.c_str(), "wb");
  if (!f || std::fwrite(v.data(), sizeof(T), v.size(), f) != v.size()) std::exit(2);
  std::fclose(f);
}

template <class T, class K>
void run(const std::string& dir, long long N, int D, long long height, int calls) {
  const auto keys = load<K>(dir + "/keys.bin", N);
  const auto order = load<long long>(dir + "/order.bin", N);
  const auto values = load<T>(dir + "/values.bin", (size_t)N * D);
  const long long tiles = (N + kTile - 1) / kTile;
  const int chunks = (D + kCols - 1) / kCols;
  std::vector<float> scratch(2 * tiles * D + 2 * tiles * chunks, std::nanf(""));
  std::vector<unsigned> runs(tiles * chunks, 0u);
  for (int c = 0; c < calls; ++c) {
    std::vector<T> out((size_t)N * D);
    std::memset(out.data(), 0xff, out.size() * sizeof(T));   // NaN in f32 and bf16
    std::vector<K> rows(N, K(-7));
    float* partial = scratch.data();
    float* own = partial + tiles * D;
    int* spill = reinterpret_cast<int*>(own + tiles * D);
    emu::launch(dim3((unsigned)tiles, chunks), kTile, seg_smem, [&] {
      segsum_kernel<T, K>(keys.data(), order.data(), values.data(), out.data(),
                               rows.data(), partial, own, spill, runs.data(),
                               spill + tiles * chunks, N, D, (K)height);
    });
    save(dir + "/out" + std::to_string(c) + ".bin", out);
    save(dir + "/rows" + std::to_string(c) + ".bin", rows);
  }
  unsigned left = 0;
  for (unsigned r : runs) left |= r;
  save(dir + "/done.bin", std::vector<unsigned>{left});
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 8) {
    std::fprintf(stderr, "usage: seg_emu DIR N D dtype key64 height calls\n");
    return 2;
  }
  const std::string dir = argv[1];
  const long long N = std::atoll(argv[2]), height = std::atoll(argv[6]);
  const int D = std::atoi(argv[3]), dtype = std::atoi(argv[4]), key64 = std::atoi(argv[5]),
            calls = std::atoi(argv[7]);
  if (dtype == 0) {
    if (key64) run<float, long long>(dir, N, D, height, calls);
    else run<float, int>(dir, N, D, height, calls);
  } else {
    if (key64) run<__nv_bfloat16, long long>(dir, N, D, height, calls);
    else run<__nv_bfloat16, int>(dir, N, D, height, calls);
  }
  return 0;
}
