// The mark of a span (wiki_grx_gym_tpu_torch/learn/spans.py): one thread
// writes the device's %globaltimer (nanoseconds) into one slot of a static
// int64 buffer. Launched inside the capture of the collection's CUDA
// graph, it becomes a kernel node whose every replay writes its slot
// again; after the replay one copy brings every slot to the host.
//
// It replaces no TPU kernel. A one-thread kernel node cost ~0.85 us of
// device time a mark in a graph of small kernels on an H100, against
// ~4.1 us for a timing event recorded into the graph, and its slots are
// read in one copy, where each event needs its own elapsed-time call.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(unsigned long long* slot) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    *slot = t;
}

}  // namespace

// Launches the mark on ``stream``: ``slot`` is the address of one int64 on
// the device. Returns the launch's cudaError_t.
extern "C" int stamp(void* slot, void* stream) {
    stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<unsigned long long*>(slot));
    return static_cast<int>(cudaGetLastError());
}
