// K0, the capability probe for Hopper (sm_90a): out = x * 2 on one tile.
//
// Replaces: bifrost_tpu/ops/pallas_kernels.py:available (pl.pallas_call
// at :40), the trivial kernel the JAX package runs once to learn that its
// kernels compile and run on the current backend.  Here it answers the
// same question for the port's CUDA kernels: this library was built by
// nvcc for sm_90a, loads, launches on the current stream and computes.
//
// Bound on the H100: launch latency.  The tile is (8, 128) float32,
// 4 KB in and 4 KB out, some 2.4 ns of HBM time: what a call costs is the
// launch and the synchronisation the caller does to read the answer.
//
// Design: one block of 256 threads, a grid-stride loop over the elements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
probe_kernel(const float* __restrict__ x, float* __restrict__ out, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) out[i] = x[i] * 2.f;
}

}  // namespace

extern "C" {

// x, out: n contiguous float32.  Returns a cudaError_t value; 0 on success.
int bf_probe(const void* x, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  probe_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, n);
  return (int)cudaGetLastError();
}

const char* bf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
