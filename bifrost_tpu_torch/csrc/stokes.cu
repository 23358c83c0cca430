// Stokes detect for Hopper (sm_90a): dual-pol voltages given as four
// re/im planes -> I = xx + yy, Q = xx - yy, U = 2 Re(x conj(y)),
// V = -2 Im(x conj(y)).
//
// Replaces: bifrost_tpu/ops/pallas_kernels.py:stokes_detect
// (pl.pallas_call at :86), the per-stage Stokes kernel of
// DetectStage (bifrost_tpu/stages.py:260-266).
//
// Bound on the H100: memory.  32 B per (t, f): four f32 reads and four
// f32 writes, 2.15 GB at T = 16384, F = 4096: 0.64 ms at 3.35 TB/s.  The
// ten flops per (t, f) are nothing beside that.
//
// Design: one thread per (t, f) computes the four outputs and writes
// them together; threads of a warp take neighbouring f, so every store
// row is coalesced.  The planes come with a row stride and an element
// stride (in floats, shared by all four), which lets DetectStage pass
// the four planes of torch.view_as_real of the (T, 2, F) complex64 FFT
// output without a copy: the interleaved re/im loads of neighbouring
// threads share their cache lines.  The arithmetic uses explicitly
// rounded multiplies and adds (no FMA contraction), so the result is
// bit-identical to the plain PyTorch version's separate ops.  Offsets
// are 64-bit; the grid walks rows in steps of gridDim.y.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
stokes_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
              const float* __restrict__ yr, const float* __restrict__ yi,
              float* __restrict__ out, int64_t ntime, int64_t nfreq,
              int64_t row_stride, int64_t elem_stride) {
  const int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= nfreq) return;
  for (int64_t t = blockIdx.y; t < ntime; t += gridDim.y) {
    const int64_t i = t * row_stride + f * elem_stride;
    const float ar = __ldg(xr + i), ai = __ldg(xi + i);
    const float br = __ldg(yr + i), bi = __ldg(yi + i);
    const float xx = __fadd_rn(__fmul_rn(ar, ar), __fmul_rn(ai, ai));
    const float yy = __fadd_rn(__fmul_rn(br, br), __fmul_rn(bi, bi));
    const float xyr = __fadd_rn(__fmul_rn(ar, br), __fmul_rn(ai, bi));
    const float xyi = __fsub_rn(__fmul_rn(ai, br), __fmul_rn(ar, bi));
    float* o = out + t * 4 * nfreq + f;
    o[0] = __fadd_rn(xx, yy);
    o[nfreq] = __fsub_rn(xx, yy);
    o[2 * nfreq] = 2.f * xyr;
    o[3 * nfreq] = -2.f * xyi;
  }
}

}  // namespace

extern "C" {

// xr, xi, yr, yi: (ntime, nfreq) float32 planes sharing row_stride and
// elem_stride (in elements).  out: (ntime, 4, nfreq) float32, contiguous.
// Returns a cudaError_t value; 0 on success.
int bf_stokes_detect(const void* xr, const void* xi, const void* yr,
                     const void* yi, void* out, long long ntime,
                     long long nfreq, long long row_stride,
                     long long elem_stride, void* stream) {
  if (ntime <= 0 || nfreq <= 0) return 0;
  const long long gx = (nfreq + kThreads - 1) / kThreads;
  const long long gy = ntime < 65535 ? ntime : 65535;
  stokes_kernel<<<dim3((unsigned)gx, (unsigned)gy), kThreads, 0,
                  (cudaStream_t)stream>>>(
      (const float*)xr, (const float*)xi, (const float*)yr,
      (const float*)yi, (float*)out, ntime, nfreq, row_stride, elem_stride);
  return (int)cudaGetLastError();
}

const char* bf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
