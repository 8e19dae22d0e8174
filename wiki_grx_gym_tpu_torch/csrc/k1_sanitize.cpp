// A stand-alone host program that runs K1 (csrc/decimation.cu) on one packed
// input in a process without PyTorch, for compute-sanitizer
// (scripts/sanitize_k1.py builds it against K1's library and runs it).
//
//   k1_sanitize <constants.bin> <input.bin> <n> <c_out>
//
// constants.bin holds the ModelConst bytes (sim/cuda_step.py:_make_constants),
// input.bin the (C_in, n) float32 input, component-major. The program sets
// the constants, launches the team kernel (k1_launch) and the one-thread
// kernel (k1_launch_thread) on the same input into outputs filled with
// different bytes (a lane either kernel leaves unwritten then differs), and
// compares the two (c_out, n) outputs bit for bit. It exits 0 only if every
// CUDA call succeeded and no output bit differs.

#include <cuda_runtime.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
int k1_const_size();
int k1_set_constants(const void* host, int nbytes, void* stream);
int k1_launch(const float* in, float* out, int n, void* stream);
int k1_launch_thread(const float* in, float* out, int n, void* stream);
}

#define CHECK(x)                                                          \
  do {                                                                    \
    const int e_ = (int)(x);                                              \
    if (e_ != 0) {                                                        \
      std::fprintf(stderr, "k1_sanitize: %s failed: CUDA error %d\n", #x, e_); \
      return 1;                                                           \
    }                                                                     \
  } while (0)

static bool read_file(const char* path, std::vector<char>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  out.resize((size_t)std::ftell(f));
  std::fseek(f, 0, SEEK_SET);
  const bool ok = std::fread(out.data(), 1, out.size(), f) == out.size();
  std::fclose(f);
  return ok;
}

int main(int argc, char** argv) {
  if (argc != 5) {
    std::fprintf(stderr, "usage: k1_sanitize <constants.bin> <input.bin> <n> <c_out>\n");
    return 2;
  }
  std::vector<char> constants, input;
  if (!read_file(argv[1], constants) || !read_file(argv[2], input)) {
    std::fprintf(stderr, "k1_sanitize: cannot read %s or %s\n", argv[1], argv[2]);
    return 2;
  }
  const int n = std::atoi(argv[3]), c_out = std::atoi(argv[4]);
  if (n <= 0 || c_out <= 0 || input.size() % (4 * (size_t)n) != 0 ||
      (int)constants.size() != k1_const_size()) {
    std::fprintf(stderr, "k1_sanitize: bad sizes (n %d, c_out %d, input %zu B, constants %zu B, kernel %d B)\n",
                 n, c_out, input.size(), constants.size(), k1_const_size());
    return 2;
  }
  const size_t out_bytes = (size_t)c_out * n * 4;
  float *d_in, *d_team, *d_thread;
  CHECK(cudaMalloc(&d_in, input.size()));
  CHECK(cudaMalloc(&d_team, out_bytes));
  CHECK(cudaMalloc(&d_thread, out_bytes));
  CHECK(cudaMemcpy(d_in, input.data(), input.size(), cudaMemcpyHostToDevice));
  CHECK(cudaMemset(d_team, 0xff, out_bytes));
  CHECK(cudaMemset(d_thread, 0x00, out_bytes));
  CHECK(k1_set_constants(constants.data(), (int)constants.size(), nullptr));
  CHECK(k1_launch(d_in, d_team, n, nullptr));
  CHECK(k1_launch_thread(d_in, d_thread, n, nullptr));
  CHECK(cudaDeviceSynchronize());
  std::vector<unsigned> team(out_bytes / 4), thread(out_bytes / 4);
  CHECK(cudaMemcpy(team.data(), d_team, out_bytes, cudaMemcpyDeviceToHost));
  CHECK(cudaMemcpy(thread.data(), d_thread, out_bytes, cudaMemcpyDeviceToHost));
  size_t differ = 0;
  for (size_t i = 0; i < team.size(); ++i) differ += team[i] != thread[i];
  CHECK(cudaFree(d_in));
  CHECK(cudaFree(d_team));
  CHECK(cudaFree(d_thread));
  std::printf("k1_sanitize: %d envs, %d x %d output lanes, %zu differ between the team and the one-thread kernel\n",
              n, c_out, n, differ);
  return differ == 0 ? 0 : 1;
}
