// An empty kernel: the practical floor of one launch, which chip_smoke.py
// times beside the narrow rows of the fleet kernels (a launch of a few
// microseconds sits far above their sub-microsecond byte bounds).  Nothing
// on the port's paths launches it.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// `blocks` blocks of `threads` threads of the empty kernel on `stream`;
// returns the launch's cudaError_t.
extern "C" int launch_floor(int blocks, int threads, void* stream) {
  if (blocks < 1 || threads < 1) return static_cast<int>(cudaErrorInvalidValue);
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
