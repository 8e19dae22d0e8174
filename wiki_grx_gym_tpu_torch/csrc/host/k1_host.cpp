// K1's kernels (csrc/decimation.cu) compiled for the host CPU with the
// built-ins of csrc/host/cuda_runtime.h, behind the same C interface
// (k1_const_size, k1_set_constants, k1_launch, k1_launch_thread), so that
// csrc/k1_sanitize.cpp runs on it unchanged. The team kernel runs block by
// block, each GPU thread of a block a std::thread; the one-thread kernel
// runs env by env on the caller's thread. tests/test_torch_decimation_race.py
// builds it with -fsanitize=thread, for one program's sizes, terrain mode,
// fold and team shape (the -D flags of sim/cuda_step.py:size_defines, e.g.
// -DK1_NB=11 ... -DK1_TERRAIN=2 -DK1_FOLD=0 -DK1_TEAM_T=16 -DK1_TEAM_E=8;
// tests/test_torch_terrain_race.py for the trimesh program, whose ground
// lanes come in the packed input like every other input):
//
//   g++ -std=c++17 -O1 -g -fsanitize=thread -ffp-contract=off -pthread <-D flags> \
//       -I csrc/host csrc/host/k1_host.cpp csrc/k1_sanitize.cpp -o k1_host
#define K1_KERNELS_ONLY

// the dynamic shared memory of the block that runs: declared before the
// kernels so that the team kernel's `extern __shared__` names this variable
// of the same unnamed namespace
namespace k1 {
namespace {
extern unsigned char k1_smem[];
}  // namespace
}  // namespace k1

#include "../decimation.cu"

namespace k1 {
namespace {
alignas(16) unsigned char k1_smem[team_smem_bytes<Sz, TEAM_E>()];
}  // namespace
}  // namespace k1

extern "C" {

int k1_const_size() { return (int)sizeof(k1::ModelConst<k1::Sz>); }

int k1_set_constants(const void* host, int nbytes, void*) {
  if (nbytes != k1_const_size()) return cudaErrorInvalidValue;
  std::memcpy(&k1::c_model, host, nbytes);
  std::memcpy(&k1::g_model, host, nbytes);
  return cudaSuccess;
}

int k1_launch(const float* in, float* out, int n, void*) {
  using namespace k1;
  // one block at a time: they share k1_smem
  cuda_host::launch((n + TEAM_E - 1) / TEAM_E, TEAM_T * TEAM_E, 0, false,
                    [=] { decimation_team_kernel<Sz, TEAM_T, TEAM_E>(&g_model, in, out, n); });
  return cudaSuccess;
}

int k1_launch_thread(const float* in, float* out, int n, void*) {
  using namespace k1;
  blockDim.x = THREADS;
  for (int e = 0; e < n; ++e) {
    blockIdx.x = e / THREADS;
    threadIdx.x = e % THREADS;
    decimation_kernel<Sz>(in, out, n);
  }
  return cudaSuccess;
}

}  // extern "C"
