// The batch-norm reductions of csrc/fused_bn.cu (bn_stats_kernel and
// bn_bwd_reduce_kernel), built for the host against the stand-in headers in
// this directory and run on one input:
//
//   bn_emu DIR M C dtype vec tx nblk rows_per_block group two calls
//
// DIR holds a.bin, and b.bin if two is 1 ([M, C] f32, or bf16 bits if dtype
// is 1).  two 0 runs bn_stats_kernel on a (x), 1 bn_bwd_reduce_kernel on a
// (dy) and b (x); vec 1 takes the 16-byte route (V = 16 / sizeof(T)), 0 one
// channel a thread; the grid is nblk row blocks of rows_per_block rows by
// the channel tiles of tx * V channels, the blocks folded in groups of
// `group` (one level if group >= nblk).  The kernel runs `calls` times on
// the same inputs and workspace; the i-th call writes out<i>.bin ([2, C]
// f32), and done.bin holds the counters, summed, after the last call.
// Outputs and the scratch rows start as NaN, so an element no call wrote,
// or a scratch row read before it was written, shows.
#include <cstdio>
#include <cstdlib>
#include <string>

#include "fused_bn.cu"

namespace {
alignas(16) uint4 bn_smem[(kReduceSmem + 15) / 16];

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

template <class T, int V>
void run(const std::string& dir, long long M, int C, int tx, int nblk, long long rows,
         int group, bool two, int calls) {
  const auto a = load<T>(dir + "/a.bin", (size_t)M * C);
  const auto b = two ? load<T>(dir + "/b.bin", (size_t)M * C) : std::vector<T>();
  const int width = tx * V, tiles = (C + width - 1) / width;
  const int ngroups = (nblk + group - 1) / group;
  std::vector<float> scratch((size_t)2 * (nblk + ngroups) * C, std::nanf(""));
  float* partial = scratch.data();
  float* gpart = partial + (size_t)2 * nblk * C;
  std::vector<unsigned> counters((size_t)tiles * (ngroups + 1), 0u);
  for (int c = 0; c < calls; ++c) {
    std::vector<float> out((size_t)2 * C, std::nanf(""));
    emu::launch(dim3(nblk, tiles), kThreads, bn_smem, [&] {
      if (two)
        bn_bwd_reduce_kernel<T, V>(a.data(), b.data(), partial, gpart, counters.data(),
                                   out.data(), M, C, tx, rows, group);
      else
        bn_stats_kernel<T, V>(a.data(), partial, gpart, counters.data(), out.data(), M, C,
                              tx, rows, group);
    });
    save(dir + "/out" + std::to_string(c) + ".bin", out);
  }
  unsigned left = 0;
  for (unsigned d : counters) left += d;
  save(dir + "/done.bin", std::vector<unsigned>{left});
}
}  // namespace

int main(int argc, char** argv) {
  if (argc != 12) {
    std::fprintf(stderr, "usage: bn_emu DIR M C dtype vec tx nblk rows_per_block group two calls\n");
    return 2;
  }
  const std::string dir = argv[1];
  const long long M = std::atoll(argv[2]), rows = std::atoll(argv[8]);
  const int C = std::atoi(argv[3]), dtype = std::atoi(argv[4]), vec = std::atoi(argv[5]),
            tx = std::atoi(argv[6]), nblk = std::atoi(argv[7]), group = std::atoi(argv[9]),
            calls = std::atoi(argv[11]);
  const bool two = std::atoi(argv[10]) != 0;
  if (dtype == 0 && vec) run<float, 4>(dir, M, C, tx, nblk, rows, group, two, calls);
  else if (dtype == 0) run<float, 1>(dir, M, C, tx, nblk, rows, group, two, calls);
  else if (vec) run<__nv_bfloat16, 8>(dir, M, C, tx, nblk, rows, group, two, calls);
  else run<__nv_bfloat16, 1>(dir, M, C, tx, nblk, rows, group, two, calls);
  return 0;
}
