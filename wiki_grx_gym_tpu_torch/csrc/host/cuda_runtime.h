// The CUDA built-ins and runtime calls that the port's kernels use, for a
// host C++ compiler: csrc/host/k1_host.cpp builds csrc/decimation.cu's
// kernels with it (tests/test_torch_decimation_race.py runs the result),
// csrc/host/k3_host.cpp those of csrc/ppo_update.cu
// (tests/test_torch_k3_host.py).
//
// cuda_host::launch runs a grid: each GPU thread a std::thread, one block at
// a time, or every block's threads at once (a cooperative launch: then
// cooperative_groups::this_grid().sync(), csrc/host/cooperative_groups.h, is
// a barrier over all of them). __syncthreads is a barrier over the calling
// block's threads and __syncwarp(mask) one over the mask's lanes of the
// calling warp: a lane outside the mask, or a barrier some thread never
// reaches, aborts. __shfl_sync exchanges values through a barrier of its own
// that ThreadSanitizer is told to ignore, so it orders no memory, as on the
// card. Each block has its own shared memory (cuda_host::block_smem). Device
// memory is host memory. Built with -fsanitize=thread, ThreadSanitizer then
// reports every pair of accesses to the same shared or global memory, one of
// them a write, that no barrier orders: a missing __syncwarp, __syncthreads
// or grid barrier.
#pragma once

#include <math.h>

#include <chrono>
#include <condition_variable>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <type_traits>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

// ThreadSanitizer's dynamic annotations (weak: absent in a build without it)
extern "C" {
void AnnotateIgnoreSyncBegin(const char* file, int line) __attribute__((weak));
void AnnotateIgnoreSyncEnd(const char* file, int line) __attribute__((weak));
void AnnotateIgnoreReadsBegin(const char* file, int line) __attribute__((weak));
void AnnotateIgnoreReadsEnd(const char* file, int line) __attribute__((weak));
void AnnotateIgnoreWritesBegin(const char* file, int line) __attribute__((weak));
void AnnotateIgnoreWritesEnd(const char* file, int line) __attribute__((weak));
}

namespace cuda_host {

[[noreturn]] inline void die(const char* what, unsigned mask) {
  std::fprintf(stderr, "cuda_host: %s (block %u, thread %u, mask 0x%08x)\n", what, blockIdx.x, threadIdx.x, mask);
  std::abort();
}

class Barrier {
 public:
  explicit Barrier(int n) : n_(n) {}
  void wait(unsigned mask) {
    std::unique_lock<std::mutex> lock(m_);
    const unsigned long gen = gen_;
    if (++arrived_ == n_) {
      arrived_ = 0;
      ++gen_;
      cv_.notify_all();
      return;
    }
    if (!cv_.wait_for(lock, std::chrono::seconds(120), [&] { return gen_ != gen; }))
      die("a barrier that some thread never reached", mask);
  }

 private:
  std::mutex m_;
  std::condition_variable cv_;
  int n_, arrived_ = 0;
  unsigned long gen_ = 0;
};

struct Exchange {
  explicit Exchange(int n) : bar(n) {}
  Barrier bar;
  unsigned char slot[32][8];
};

// One block's barriers and shared memory.
struct Block {
  Block(int threads, size_t smem_bytes)
      : all(threads), smem((smem_bytes + sizeof(std::max_align_t) - 1) / sizeof(std::max_align_t)) {}
  Barrier all;
  std::mutex m;
  std::map<std::pair<unsigned, unsigned>, std::unique_ptr<Barrier>> warp;    // (warp, mask)
  std::map<std::pair<unsigned, unsigned>, std::unique_ptr<Exchange>> shfl;  // (warp, mask)
  std::vector<std::max_align_t> smem;
};

// the calling GPU thread's block, and the grid barrier of a cooperative launch
inline thread_local Block* t_block = nullptr;
inline thread_local Barrier* t_grid = nullptr;

// The calling block's shared memory as a T (one T a block).
template <class T>
T& block_smem() {
  static_assert(std::is_trivially_destructible<T>::value, "plain data");
  if (!t_block || t_block->smem.size() * sizeof(std::max_align_t) < sizeof(T)) die("shared memory too small", 0);
  return *reinterpret_cast<T*>(t_block->smem.data());
}

// Runs body() as a grid of nblocks blocks of `threads` GPU threads, each
// block with smem_bytes of shared memory. cooperative: every block's threads
// run at once and may meet at the grid barrier; otherwise one block runs at a
// time.
template <class F>
void launch(unsigned nblocks, unsigned threads, size_t smem_bytes, bool cooperative, F body) {
  std::vector<std::unique_ptr<Block>> blocks;
  for (unsigned b = 0; b < nblocks; ++b) blocks.emplace_back(new Block((int)threads, smem_bytes));
  Barrier grid((int)(nblocks * threads));
  auto run = [&](unsigned b0, unsigned b1) {
    std::vector<std::thread> pool;
    for (unsigned b = b0; b < b1; ++b)
      for (unsigned t = 0; t < threads; ++t)
        pool.emplace_back([&, b, t] {
          threadIdx.x = t;
          blockIdx.x = b;
          blockDim.x = threads;
          gridDim.x = nblocks;
          t_block = blocks[b].get();
          t_grid = cooperative ? &grid : nullptr;
          body();
        });
    for (auto& th : pool) th.join();
  };
  if (cooperative) {
    run(0, nblocks);
  } else {
    for (unsigned b = 0; b < nblocks; ++b) run(b, b + 1);
  }
}

inline void grid_sync() {
  if (!t_grid) die("a grid barrier outside a cooperative launch", 0);
  t_grid->wait(~0u);
}

// The caller's accesses and synchronisation inside its lifetime are hidden
// from ThreadSanitizer.
struct Unseen {
  Unseen() {
    if (AnnotateIgnoreSyncBegin) {
      AnnotateIgnoreSyncBegin(__FILE__, __LINE__);
      AnnotateIgnoreReadsBegin(__FILE__, __LINE__);
      AnnotateIgnoreWritesBegin(__FILE__, __LINE__);
    }
  }
  ~Unseen() {
    if (AnnotateIgnoreSyncEnd) {
      AnnotateIgnoreWritesEnd(__FILE__, __LINE__);
      AnnotateIgnoreReadsEnd(__FILE__, __LINE__);
      AnnotateIgnoreSyncEnd(__FILE__, __LINE__);
    }
  }
};

// The barrier or exchange of the calling warp's lanes in `mask`, made at
// first use; the lookup orders nothing between the lanes.
template <class M>
auto& of_mask(M& table, unsigned mask) {
  if (!((mask >> (threadIdx.x % 32)) & 1u)) die("a lane calls a warp operation outside its mask", mask);
  Unseen unseen;
  std::lock_guard<std::mutex> lock(t_block->m);
  auto& slot = table[{threadIdx.x / 32, mask}];
  if (!slot) slot.reset(new std::decay_t<decltype(*slot)>(__builtin_popcount(mask)));
  return *slot;
}

}  // namespace cuda_host

inline void __syncthreads() { cuda_host::t_block->all.wait(~0u); }

inline void __syncwarp(unsigned mask = 0xffffffffu) { cuda_host::of_mask(cuda_host::t_block->warp, mask).wait(mask); }

template <class V>
inline V __shfl_sync(unsigned mask, V v, int src, int width = 32) {
  static_assert(sizeof(V) <= 8, "one slot a lane");
  cuda_host::Exchange& x = cuda_host::of_mask(cuda_host::t_block->shfl, mask);
  const int lane = threadIdx.x % 32, from = (lane & ~(width - 1)) | (src & (width - 1));
  if (!((mask >> from) & 1u)) cuda_host::die("a shuffle reads a lane outside its mask", mask);
  cuda_host::Unseen unseen;   // the exchange orders no other memory
  std::memcpy(x.slot[lane], &v, sizeof(V));
  x.bar.wait(mask);
  V r;
  std::memcpy(&r, x.slot[from], sizeof(V));
  x.bar.wait(mask);
  return r;
}

inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}

// the runtime calls of csrc/k1_sanitize.cpp; device memory is host memory
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorMemoryAllocation = 2 };
enum cudaMemcpyKind { cudaMemcpyHostToDevice = 1, cudaMemcpyDeviceToHost = 2 };
template <class T>
inline cudaError_t cudaMalloc(T** p, size_t n) {
  *p = static_cast<T*>(std::malloc(n));
  return *p ? cudaSuccess : cudaErrorMemoryAllocation;
}
inline cudaError_t cudaFree(void* p) {
  std::free(p);
  return cudaSuccess;
}
inline cudaError_t cudaMemcpy(void* dst, const void* src, size_t n, cudaMemcpyKind) {
  std::memcpy(dst, src, n);
  return cudaSuccess;
}
inline cudaError_t cudaMemset(void* p, int v, size_t n) {
  std::memset(p, v, n);
  return cudaSuccess;
}
inline cudaError_t cudaDeviceSynchronize() { return cudaSuccess; }
