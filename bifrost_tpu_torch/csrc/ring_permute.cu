// K9, one hop of the correlator's corner turn for Hopper (sm_90a):
//
//   dst[r] <- src[r]   for r = 0 .. nranks-1, nbytes each,
//
// where the caller passes as src[r] the block of ring rank i and as dst[r]
// the buffer of rank (i+1) mod D, so every rank's whole block lands on its
// right neighbour in one launch.
//
// Replaces: bifrost_tpu/ops/pallas_kernels.py:ring_permute (defined at
// :471, pl.pallas_call at :504), the Pallas remote-DMA hop that
// bifrost_tpu/parallel/corner_turn.py:45-48 (_pallas_shift) composes D-1
// times into the time-sharded -> channel-sharded corner turn.  It computes
// what the TPU kernel computes, the whole block on the neighbour; it does
// not copy the TPU kernel's DMA-semaphore handshake.
//
// Bound on the H100: memory.  A hop reads every block once and writes it
// once: at the corner turn of the mesh correlator (4 ranks of (64, 1024,
// 256, 2, 2) int8) 2 x 268 MB, 0.16 ms at 3.35 TB/s.  There is no
// arithmetic.
//
// Design: the grid is (byte tiles, rank): blockIdx.y picks the rank's
// source and destination pointer; blockIdx.x and the thread pick four
// 16-byte vectors, one in each quarter of the block's bytes, where both
// pointers are 16-byte aligned (four loads in flight before the four
// stores), with neighbouring threads on neighbouring vectors so every
// warp access is coalesced; the bytes past the last whole vector go one
// byte per thread.
// A pair of pointers that is not aligned goes one byte per thread
// throughout.  The kernel copies bytes, so it takes any dtype.  The D
// source and D destination pointers reach the kernel as two arrays of its
// parameter block (constant memory on the card), up to kMaxRanks per
// launch, so a hop copies no pointer table to the card before it runs.  A
// destination on another card is written through peer access, which the
// caller enables (bf_enable_peer) before the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;
constexpr int kMaxRanks = 64;

struct RankPtrs {
  const char* src[kMaxRanks];
  char* dst[kMaxRanks];
};

__global__ void __launch_bounds__(kThreads)
ring_permute_kernel(const RankPtrs ptrs, long long nbytes) {
  const char* __restrict__ s = ptrs.src[blockIdx.y];
  char* __restrict__ d = ptrs.dst[blockIdx.y];
  const long long stride = (long long)gridDim.x * kThreads;
  long long tail0 = 0;
  if ((((uintptr_t)s | (uintptr_t)d) & 15) == 0) {
    const int4* __restrict__ s4 = reinterpret_cast<const int4*>(s);
    int4* __restrict__ d4 = reinterpret_cast<int4*>(d);
    const long long nvec = nbytes >> 4;
    long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    for (; i + (kVecPerThread - 1) * stride < nvec;
         i += kVecPerThread * stride) {
      int4 v[kVecPerThread];
#pragma unroll
      for (int k = 0; k < kVecPerThread; ++k) v[k] = s4[i + k * stride];
#pragma unroll
      for (int k = 0; k < kVecPerThread; ++k) d4[i + k * stride] = v[k];
    }
    for (; i < nvec; i += stride) d4[i] = s4[i];
    tail0 = nvec << 4;
  }
  for (long long b = tail0 + (long long)blockIdx.x * kThreads + threadIdx.x;
       b < nbytes; b += stride)
    d[b] = s[b];
}

}  // namespace

extern "C" {

// src, dst: host arrays of nranks device pointers (block r of src goes to
// dst[r]), each block nbytes long; 1 <= nranks <= kMaxRanks (64).
// Launches on `stream`, which belongs to the current device.  Returns a
// cudaError_t value; 0 on success.
int bf_ring_permute(const unsigned long long* src,
                    const unsigned long long* dst, int nranks,
                    long long nbytes, void* stream) {
  if (nranks < 1 || nranks > kMaxRanks) return (int)cudaErrorInvalidValue;
  if (nbytes <= 0) return 0;
  RankPtrs p;
  for (int r = 0; r < nranks; ++r) {
    p.src[r] = reinterpret_cast<const char*>(src[r]);
    p.dst[r] = reinterpret_cast<char*>(dst[r]);
  }
  // one round of four vectors per thread covers the block
  const long long per_block = (long long)kThreads * kVecPerThread * 16;
  const long long nx = (nbytes + per_block - 1) / per_block;
  if (nx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nx, (unsigned)nranks);
  ring_permute_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p, nbytes);
  return (int)cudaGetLastError();
}

// Let `device` read and write the memory of `peer`
// (cudaDeviceEnablePeerAccess in `device`'s context); an access already
// enabled is no error.
// Returns cudaErrorPeerAccessUnsupported where the pair has no peer path.
int bf_enable_peer(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int prev = 0;
  err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // that call left its error as the last error
    err = cudaSuccess;
  }
  cudaSetDevice(prev);
  return (int)err;
}

const char* bf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
