// The CUDA built-ins and runtime calls that csrc/decimation.cu's kernels and
// csrc/k1_sanitize.cpp use, for a host C++ compiler (csrc/host/k1_host.cpp
// builds them with it; tests/test_torch_decimation_race.py runs the result).
//
// Each GPU thread of a block becomes a std::thread. __syncthreads is a
// barrier over the block's threads and __syncwarp(mask) one over the mask's
// lanes of the calling warp: a lane outside the mask, or a barrier some lane
// of the mask never reaches, aborts. __shfl_sync exchanges values through a
// barrier of its own that ThreadSanitizer is told to ignore, so it orders no
// memory, as on the card. Device memory is host memory. Built with
// -fsanitize=thread, ThreadSanitizer then reports every pair of accesses to
// the same shared or global memory, one of them a write, that no barrier
// orders: a missing __syncwarp or __syncthreads.
#pragma once

#include <math.h>

#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <type_traits>
#include <utility>

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
inline thread_local dim3 threadIdx, blockIdx, blockDim;

// ThreadSanitizer's dynamic annotations (weak: absent in a build without it)
extern "C" {
void AnnotateIgnoreSyncBegin(const char* file, int line) __attribute__((weak));
void AnnotateIgnoreSyncEnd(const char* file, int line) __attribute__((weak));
void AnnotateIgnoreReadsBegin(const char* file, int line) __attribute__((weak));
void AnnotateIgnoreReadsEnd(const char* file, int line) __attribute__((weak));
void AnnotateIgnoreWritesBegin(const char* file, int line) __attribute__((weak));
void AnnotateIgnoreWritesEnd(const char* file, int line) __attribute__((weak));
}

namespace k1_host {

[[noreturn]] inline void die(const char* what, unsigned mask) {
  std::fprintf(stderr, "k1_host: %s (block %u, thread %u, mask 0x%08x)\n", what, blockIdx.x, threadIdx.x, mask);
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

// The barriers of the block that runs (one block runs at a time).
struct Block {
  std::unique_ptr<Barrier> all;
  std::mutex m;
  std::map<std::pair<unsigned, unsigned>, std::unique_ptr<Barrier>> warp;    // (warp, mask)
  std::map<std::pair<unsigned, unsigned>, std::unique_ptr<Exchange>> shfl;  // (warp, mask)
  void reset(int threads) {
    all = std::make_unique<Barrier>(threads);
    warp.clear();
    shfl.clear();
  }
};
inline Block g_block;

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
  std::lock_guard<std::mutex> lock(g_block.m);
  auto& slot = table[{threadIdx.x / 32, mask}];
  if (!slot) slot.reset(new std::decay_t<decltype(*slot)>(__builtin_popcount(mask)));
  return *slot;
}

}  // namespace k1_host

inline void __syncthreads() { k1_host::g_block.all->wait(~0u); }

inline void __syncwarp(unsigned mask = 0xffffffffu) { k1_host::of_mask(k1_host::g_block.warp, mask).wait(mask); }

template <class V>
inline V __shfl_sync(unsigned mask, V v, int src, int width = 32) {
  static_assert(sizeof(V) <= 8, "one slot a lane");
  k1_host::Exchange& x = k1_host::of_mask(k1_host::g_block.shfl, mask);
  const int lane = threadIdx.x % 32, from = (lane & ~(width - 1)) | (src & (width - 1));
  if (!((mask >> from) & 1u)) k1_host::die("a shuffle reads a lane outside its mask", mask);
  k1_host::Unseen unseen;   // the exchange orders no other memory
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
