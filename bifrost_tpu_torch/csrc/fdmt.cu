// K3, one FDMT merge step for Hopper (sm_90a):
//
//   out[b, s, d, t] = lo[t] + (0 <= t + sgn*d1 < T ? hi[t + sgn*d1] : 0)
//     lo = state[b, 2s, d1[s, d], :]
//     hi = state[b, min(2s + 1, nchan_cur - 1), d2[s, d], :]
//
// and out[b, s, d, t] = lo[t] for a passthrough subband s (the odd last
// subband of a step, carried to the next level unmerged).
//
// Replaces: bifrost_tpu/ops/pallas_kernels.py:fdmt_step (defined at :394,
// pl.pallas_call at :459), the step kernel of the Pallas core of
// bifrost_tpu/ops/fdmt.py (reference CUDA kernel: src/fdmt.cu:53-96).
//
// Bound on the H100: memory.  A step reads its input state and writes its
// output once: at the full-width plan (4096 channels, 12 steps, 18354
// frames per span) some 6.2 GB per span, 1.9 ms at 3.35 TB/s.  There is
// one float32 add per output element; the arithmetic is nothing beside
// the bytes.
//
// Design: one block per (output row (s, d), tile of 1024 frames, batch
// entry).  The block reads its row's d1, d2 and passthrough flag once (a
// broadcast load), then its 256 threads stream lo and the shifted hi along
// time, four frames each, neighbouring threads on neighbouring frames, so
// every load and store of a warp is coalesced; the hi stream is offset by
// sgn*d1 and so unaligned, and frames whose shifted index falls outside
// [0, T) add zero.  Rows of one subband are neighbouring blocks, so the
// lo and hi rows they share are read while still in L2.  The TPU kernel's
// VMEM residency of a subband's rows and its per-row lane roll do not
// carry over.  The add is __fadd_rn (no contraction), one per element, so
// the result is bit-identical to the plain PyTorch version and to the
// torch gather core.  The delay tables live in device memory, put there
// once per plan by the caller; a step of any table size runs here (the
// JAX core sends steps whose tables exceed its SMEM budget to the XLA
// gather).  Offsets are 64-bit: batch x rows x T passes 2^31 in large
// plans.  The grid walks time tiles in steps of gridDim.y and batch
// entries in steps of gridDim.z.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;

__global__ void __launch_bounds__(kThreads)
fdmt_step_kernel(const float* __restrict__ state, float* __restrict__ out,
                 const int* __restrict__ d1, const int* __restrict__ d2,
                 const int* __restrict__ passthrough, int64_t batch,
                 int nchan_cur, int nd_cur, int nout, int nd_out, int64_t T,
                 int sgn) {
  const int64_t row = blockIdx.x;           // s * nd_out + d
  const int s = (int)(row / nd_out);
  const int d1v = d1[row];
  const int d2v = d2[row];
  const bool pass = passthrough[s] != 0;
  const int hs = min(2 * s + 1, nchan_cur - 1);
  const int64_t shift = (int64_t)sgn * d1v;
  for (int64_t b = blockIdx.z; b < batch; b += gridDim.z) {
    const float* lo =
        state + ((b * nchan_cur + 2 * s) * (int64_t)nd_cur + d1v) * T;
    const float* hi = state + ((b * nchan_cur + hs) * (int64_t)nd_cur + d2v) * T;
    float* o = out + (b * nout * (int64_t)nd_out + row) * T;
    for (int64_t t0 = (int64_t)blockIdx.y * kTile; t0 < T;
         t0 += (int64_t)gridDim.y * kTile) {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int64_t t = t0 + k * kThreads + threadIdx.x;
        if (t < T) {
          float v = lo[t];
          if (!pass) {
            const int64_t ts = t + shift;
            v = __fadd_rn(v, (ts >= 0 && ts < T) ? hi[ts] : 0.f);
          }
          o[t] = v;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// state: (batch, nchan_cur, nd_cur, T) float32, contiguous.
// d1, d2: (nout, nd_out) int32; passthrough: (nout,) int32; all on the card.
// out: (batch, nout, nd_out, T) float32, contiguous.  sgn: +1 or -1.
// Returns a cudaError_t value; 0 on success.
int bf_fdmt_step(const void* state, void* out, const void* d1,
                 const void* d2, const void* passthrough, long long batch,
                 int nchan_cur, int nd_cur, int nout, int nd_out,
                 long long T, int sgn, void* stream) {
  if (batch <= 0 || T <= 0 || nout <= 0 || nd_out <= 0) return 0;
  const long long nrow = (long long)nout * nd_out;
  const long long ntile = (T + kTile - 1) / kTile;
  const dim3 grid((unsigned)nrow, (unsigned)(ntile < 65535 ? ntile : 65535),
                  (unsigned)(batch < 65535 ? batch : 65535));
  fdmt_step_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)state, (float*)out, (const int*)d1, (const int*)d2,
      (const int*)passthrough, batch, nchan_cur, nd_cur, nout, nd_out, T,
      sgn);
  return (int)cudaGetLastError();
}

const char* bf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
