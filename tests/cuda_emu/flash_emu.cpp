// The tensor-core flash kernels of csrc/flash_attention.cu, built for the
// host against the stand-in headers in this directory and run on one set of
// inputs:
//
//   flash_emu DIR B H Sq Sk D scale causal
//
// DIR holds q, k, v, do (bf16 [B, S, H*D]) and lse, delta (f32 [B, H, Sq])
// as raw .bin files.  Writes o.bin and lse_out.bin (flash_fwd_mma_kernel)
// and dq.bin, dk.bin, dv.bin (flash_bwd_{dkv,dq}_mma_kernel on the given
// lse and delta).  Outputs start as NaN, so a value no kernel wrote shows.
#include <cstdio>
#include <cstdlib>
#include <string>
#include <type_traits>

#include "flash_attention.cu"

namespace {
constexpr int kMaxDP = 128;
alignas(16) uint4 fwd_mma_smem[(kBQ + 4 * kBK) * kMaxDP * 2 / 16];
alignas(16) uint4 dkv_mma_smem[(6 * kBQ * kMaxDP * 2 + 4 * kBQ * 4) / 16];
alignas(16) uint4 dq_mma_smem[6 * kBQ * kMaxDP * 2 / 16];

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
}  // namespace

int main(int argc, char** argv) {
  if (argc != 9) {
    std::fprintf(stderr, "usage: flash_emu DIR B H Sq Sk D scale causal\n");
    return 2;
  }
  using bf16 = __nv_bfloat16;
  const std::string dir = argv[1];
  const int B = std::atoi(argv[2]), H = std::atoi(argv[3]), Sq = std::atoi(argv[4]),
            Sk = std::atoi(argv[5]), D = std::atoi(argv[6]), causal = std::atoi(argv[8]);
  const float scale = std::strtof(argv[7], nullptr);
  const size_t nq = (size_t)B * Sq * H * D, nk = (size_t)B * Sk * H * D, ns = (size_t)B * H * Sq;
  const auto q = load<bf16>(dir + "/q.bin", nq), k = load<bf16>(dir + "/k.bin", nk),
             v = load<bf16>(dir + "/v.bin", nk), dout = load<bf16>(dir + "/do.bin", nq);
  const auto lse = load<float>(dir + "/lse.bin", ns), delta = load<float>(dir + "/delta.bin", ns);
  const bf16 nan16{0x7fc0};
  std::vector<bf16> o(nq, nan16), dq(nq, nan16), dk(nk, nan16), dv(nk, nan16);
  std::vector<float> lse_out(ns, std::nanf(""));

  auto run = [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    emu::launch(dim3((Sq + kBQ - 1) / kBQ, B * H), kMmaWarps * 32, fwd_mma_smem, [&] {
      flash_fwd_mma_kernel<DP>(q.data(), k.data(), v.data(), o.data(), lse_out.data(), H, Sq,
                               Sk, D, scale * kLog2e, causal);
    });
    emu::launch(dim3((Sk + kBK - 1) / kBK, B * H), kMmaWarps * 32, dkv_mma_smem, [&] {
      flash_bwd_dkv_mma_kernel<DP>(q.data(), k.data(), v.data(), dout.data(), lse.data(),
                                   delta.data(), dk.data(), dv.data(), H, Sq, Sk, D, scale,
                                   causal);
    });
    emu::launch(dim3((Sq + kBQ - 1) / kBQ, B * H), kMmaWarps * 32, dq_mma_smem, [&] {
      flash_bwd_dq_mma_kernel<DP>(q.data(), k.data(), v.data(), dout.data(), lse.data(),
                                  delta.data(), dq.data(), H, Sq, Sk, D, scale, causal);
    });
  };
  if (D <= 64) run(std::integral_constant<int, 64>());
  else run(std::integral_constant<int, 128>());

  save(dir + "/o.bin", o);
  save(dir + "/lse_out.bin", lse_out);
  save(dir + "/dq.bin", dq);
  save(dir + "/dk.bin", dk);
  save(dir + "/dv.bin", dv);
  return 0;
}
