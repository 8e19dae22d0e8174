// cooperative_groups' grid barrier for the host build of the port's kernels
// (csrc/host/cuda_runtime.h): this_grid().sync() waits for every thread of
// a cooperative cuda_host::launch, and aborts in any other launch.
#pragma once

#include "cuda_runtime.h"

namespace cooperative_groups {

struct grid_group {
  void sync() const { cuda_host::grid_sync(); }
};

inline grid_group this_grid() { return {}; }

}  // namespace cooperative_groups
