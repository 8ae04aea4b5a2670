// The LayerNorm backward kernels of csrc/layer_norm.cu, built for the host
// against the stand-in headers in this directory and run on one input:
//
//   ln_emu DIR N E dtype route nblk calls
//
// DIR holds x.bin and dy.bin ([N, E] f32, or bf16 bits if dtype is 1) and
// scale.bin [E], mu.bin [N], rstd.bin [N] (f32).  route 1 runs
// ln_bwd_vec_kernel (E a multiple of 32 * 16 / sizeof(T), at most 1024),
// 0 ln_bwd_scalar_kernel, on a grid of nblk blocks, `calls` times; the i-th
// call writes dx<i>.bin and out<i>.bin ([2, E] f32: dscale, dbias), and
// done.bin holds the sum of the done-counters after the last call.
// Outputs start as NaN, so an element no call wrote shows.
#include <cstdio>
#include <cstdlib>
#include <string>

#include "layer_norm.cu"

namespace {
constexpr int kMaxE = 1024;
alignas(16) uint4 ln_smem[(4 * 2 * kMaxE * kWarps + 16) / 16];

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

template <class T, int NV>
void launch(bool vec, dim3 grid, const T* x, const float* scale, const T* dy,
            const float* mu, const float* rstd, T* dx, float* partial, float* gpart,
            float* out, unsigned* done, long long N, int E) {
  emu::launch(grid, kWarps * 32, ln_smem, [&] {
    if constexpr (NV * ptt::Vec16<T>::n <= 32) {
      if (vec) {
        ln_bwd_vec_kernel<T, NV>(x, scale, dy, mu, rstd, dx, partial, gpart, out, done, N, E);
        return;
      }
    }
    ln_bwd_scalar_kernel<T>(x, scale, dy, mu, rstd, dx, partial, gpart, out, done, N, E);
  });
}

template <class T>
void run(const std::string& dir, long long N, int E, int route, int nblk, int calls) {
  const auto x = load<T>(dir + "/x.bin", (size_t)N * E);
  const auto dy = load<T>(dir + "/dy.bin", (size_t)N * E);
  const auto scale = load<float>(dir + "/scale.bin", E);
  const auto mu = load<float>(dir + "/mu.bin", N);
  const auto rstd = load<float>(dir + "/rstd.bin", N);
  const int ngroups = (nblk + kGroup - 1) / kGroup;
  std::vector<float> scratch((size_t)(nblk + ngroups) * 2 * E, std::nanf(""));
  std::vector<unsigned> done(ngroups + 1, 0u);
  const int nv = route ? E / (32 * ptt::Vec16<T>::n) : 0;
  for (int c = 0; c < calls; ++c) {
    std::vector<T> dx((size_t)N * E);
    std::memset(dx.data(), 0xff, dx.size() * sizeof(T));   // NaN in f32 and bf16
    std::vector<float> out(2 * E, std::nanf(""));
    auto go = [&](auto k) {
      launch<T, decltype(k)::value>(route != 0, dim3(nblk), x.data(), scale.data(), dy.data(),
                                    mu.data(), rstd.data(), dx.data(), scratch.data(),
                                    scratch.data() + (size_t)nblk * 2 * E, out.data(),
                                    done.data(), N, E);
    };
    switch (nv) {
      case 1: go(std::integral_constant<int, 1>()); break;
      case 2: go(std::integral_constant<int, 2>()); break;
      case 3: go(std::integral_constant<int, 3>()); break;
      case 4: go(std::integral_constant<int, 4>()); break;
      case 6: go(std::integral_constant<int, 6>()); break;
      case 8: go(std::integral_constant<int, 8>()); break;
      default: go(std::integral_constant<int, 0>()); break;   // scalar
    }
    save(dir + "/dx" + std::to_string(c) + ".bin", dx);
    save(dir + "/out" + std::to_string(c) + ".bin", out);
  }
  unsigned left = 0;
  for (unsigned d : done) left += d;
  save(dir + "/done.bin", std::vector<unsigned>{left});
}
}  // namespace

int main(int argc, char** argv) {
  if (argc != 8) {
    std::fprintf(stderr, "usage: ln_emu DIR N E dtype route nblk calls\n");
    return 2;
  }
  const std::string dir = argv[1];
  const long long N = std::atoll(argv[2]);
  const int E = std::atoi(argv[3]), dtype = std::atoi(argv[4]), route = std::atoi(argv[5]),
            nblk = std::atoi(argv[6]), calls = std::atoi(argv[7]);
  if (E > kMaxE) return 2;
  if (dtype == 0) run<float>(dir, N, E, route, nblk, calls);
  else run<__nv_bfloat16>(dir, N, E, route, nblk, calls);
  return 0;
}
