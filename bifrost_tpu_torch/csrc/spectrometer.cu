// Fused spectrometer for Hopper (sm_90a): ci8 dual-pol voltages ->
// nfft-point c2c FFT -> Stokes I, Q, U, V -> sum of rfactor adjacent
// frequency bins, in natural frequency order, in one kernel.
//
// Replaces: bifrost_tpu/ops/spectrometer.py:fused_spectrometer
// (pl.pallas_call at :341, kernel body _kernel at :168).  That kernel
// computes the FFT as a 4-step factorization on the MXU (Karatsuba, bf16
// hi/lo passes, a Bailey transpose), all shaped around Mosaic.  This one
// computes the same function and nothing of that shape carries over.
//
// Bound on the H100: memory.  Per complex sample the kernel reads 2 B of
// ci8 and writes 16 B / rfactor of Stokes (4 B at rfactor 4), 537 MB per
// 16384 x 2 x 4096 gulp: 0.16 ms at 3.35 TB/s.  The work, 5 N log2 N
// flop per FFT, is 8.05 GFLOP per gulp: 0.12 ms at the 67 TFLOP/s FP32
// rate outside the tensor cores.
//
// Two kernels, one thread block per time row, picked by nfft alone:
//
// spectrometer_radix16<L>, nfft = 2^L from 256 to 8192, the main path.
// A Stockham autosort FFT: nfft is factored into radix-16 passes and at
// most one last pass of radix 2, 4 or 8 (256 = 16.16, 512 = 16.16.2, ...,
// 4096 = 16.16.16, 8192 = 16.16.16.2), so input and output stay in
// natural order and nothing is scattered bit-reversed.  In each pass a
// thread holds 16 complex values of one pol in registers (16 / R
// butterflies of R points in the last pass), applies the pass's twiddles
// and runs the 16-point DFT unrolled as two radix-4 layers with the
// internal W16 factors as constants; then pol 1 the same way.  The first
// pass unpacks straight from the ci8 row in global memory (consecutive
// threads read consecutive samples); the last writes natural order for
// the Stokes epilogue.  At nfft 4096 a row makes 3 shared-memory writes
// and 3 reads, not the 13 of twelve radix-2 stages.  The exchanges are
// padded, i + (i >> 4) (one float2 in 16): Stockham's writes at a
// stride of 16 float2 between threads and the reads at a stride of
// nfft / 16 then take the two wavefronts that a warp's 8-byte accesses
// need and no more (68 KB a block at nfft 4096).  Twiddles come from a
// table of W_n^k, k < n, built in float64 on the host: the 1e-5 gate of
// the float64 oracle needs that accuracy, which __sincosf would lose.
// The block is nfft / 16 threads (256 at nfft 4096), each one butterfly
// of each pol a pass, at up to 128 registers a thread: two blocks share
// an SM at nfft 4096 (three, at 80 registers, spill and ran slower:
// chip_k1_variants.py times both).  A pass that is not the last reads
// all of a pol before it writes any of it (one buffer, a barrier
// between).
//
// spectrometer_kernel, nfft 4 to 128: the in-place radix-2
// Cooley-Tukey kernel (decimation in time, bit-reversed load), which is
// a handful of stages at these sizes; no spectrometer of the repository
// runs them.
//
// Stokes and the rfactor sum are formed in registers and each output
// row (4, nfft / rfactor) is written once.  No intermediate touches
// device memory, so both kernels move exactly the bytes of the bound.
// Offsets into the gulp are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

__global__ void __launch_bounds__(kThreads)
spectrometer_kernel(const uint32_t* __restrict__ volt,    // (T, 2, n) ci8 pairs
                    const float2* __restrict__ twiddle,   // (n / 2)
                    float* __restrict__ out,              // (T, 4, n / rfactor)
                    int log2n, int rfactor) {
  extern __shared__ float2 sm[];                          // [2][n], pol-major
  const int n = 1 << log2n;
  const int half = n >> 1;
  const int64_t t = blockIdx.x;

  // Load: a row holds 2 n samples in n 32-bit words; each word is two
  // consecutive samples of one pol, each a little-endian int16 whose
  // low byte is re and high byte im.
  const uint32_t* row = volt + t * (int64_t)n;
  for (int w = threadIdx.x; w < n; w += blockDim.x) {
    const uint32_t v = __ldg(row + w);
    const int s = 2 * w;
    const int pol = s >> log2n;
    const int k = s & (n - 1);
    const unsigned r0 = __brev((unsigned)k) >> (32 - log2n);
    const unsigned r1 = __brev((unsigned)(k + 1)) >> (32 - log2n);
    sm[pol * n + r0] = make_float2((float)(int8_t)(v & 0xffu),
                                   (float)(int8_t)((v >> 8) & 0xffu));
    sm[pol * n + r1] = make_float2((float)(int8_t)((v >> 16) & 0xffu),
                                   (float)(int8_t)(v >> 24));
  }
  __syncthreads();

  // Radix-2 DIT stages: span 2m, twiddle W_{2m}^j = twiddle[j n / 2m].
  for (int s = 0; s < log2n; ++s) {
    const int m = 1 << s;
    const int tw_shift = log2n - 1 - s;
    for (int b = threadIdx.x; b < n; b += blockDim.x) {
      const int pol = b >> (log2n - 1);
      const int bb = b & (half - 1);
      const int j = bb & (m - 1);
      const int i0 = pol * n + ((bb - j) << 1) + j;
      const int i1 = i0 + m;
      const float2 a = sm[i0];
      const float2 c = cmul(__ldg(twiddle + (j << tw_shift)), sm[i1]);
      sm[i0] = make_float2(a.x + c.x, a.y + c.y);
      sm[i1] = make_float2(a.x - c.x, a.y - c.y);
    }
    __syncthreads();
  }

  // Stokes of x = pol 0, y = pol 1, summed over rfactor adjacent bins.
  const int nout = n / rfactor;
  float* orow = out + t * 4 * (int64_t)nout;
  for (int g = threadIdx.x; g < nout; g += blockDim.x) {
    float si = 0.f, sq = 0.f, su = 0.f, sv = 0.f;
    for (int q = 0; q < rfactor; ++q) {
      const int k = g * rfactor + q;
      const float2 x = sm[k];
      const float2 y = sm[n + k];
      const float xx = fmaf(x.x, x.x, x.y * x.y);
      const float yy = fmaf(y.x, y.x, y.y * y.y);
      const float xyr = fmaf(x.x, y.x, x.y * y.y);     // Re(x conj(y))
      const float xyi = fmaf(x.y, y.x, -x.x * y.y);    // Im(x conj(y))
      si += xx + yy;
      sq += xx - yy;
      su += 2.f * xyr;
      sv -= 2.f * xyi;
    }
    orow[g] = si;
    orow[nout + g] = sq;
    orow[2 * nout + g] = su;
    orow[3 * nout + g] = sv;
  }
}

// ---------------------------------------------------------------------------
// The radix-16 Stockham kernel, nfft = 2^L, L = 8 .. 13
// ---------------------------------------------------------------------------

template <int L>
struct Radix16 {
  static constexpr int kN = 1 << L;
  static constexpr int kThreads = kN / 16;       // one butterfly a pol a pass
  static constexpr int kPadded = kN + kN / 16;   // float2 a pol, padded
  static constexpr int kFull = L / 4;            // radix-16 passes
  static constexpr int kLast = 1 << (L % 4);     // last pass's radix; 1: none
  // at most 128 registers a thread (none spilled): two blocks of 256
  // threads an SM at nfft 4096 (a block of 16 threads counts as a warp)
  static constexpr int kMinBlocks = 512 / (kThreads < 32 ? 32 : kThreads);
  static constexpr size_t kSmem = 2 * kPadded * sizeof(float2);
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 mul_mi(float2 a) {   // -i a
  return make_float2(a.y, -a.x);
}

__device__ __forceinline__ float2 unpack_ci8(uint16_t w) {
  return make_float2((float)(int8_t)(w & 0xffu), (float)(int8_t)(w >> 8));
}

// W16^k = exp(-2 pi i k / 16)
constexpr float kC16 = 0.92387953251128674f;   // cos(pi / 8)
constexpr float kS16 = 0.38268343236508978f;   // sin(pi / 8)
constexpr float kH = 0.70710678118654752f;     // sqrt(1 / 2)

// 4-point DFT of (a, b, c, d) in place, outputs in order
__device__ __forceinline__ void dft4(float2& a, float2& b, float2& c,
                                     float2& d) {
  const float2 t0 = cadd(a, c), t1 = csub(a, c);
  const float2 t2 = cadd(b, d), t3 = mul_mi(csub(b, d));
  a = cadd(t0, t2);
  c = csub(t0, t2);
  b = cadd(t1, t3);
  d = csub(t1, t3);
}

// R-point DFT of v[0 .. R) in place.  Output m is left in v[slot<R>(m)].
template <int R>
__device__ __forceinline__ int slot(int m) {
  return R == 16 ? 4 * (m & 3) + (m >> 2)
                 : (R == 8 ? 2 * (m & 3) + (m >> 2) : m);
}

template <int R>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 16) {
    // v[4 n1 + n2]: DFT4 over n1, W16^(n2 k1), DFT4 over n2
#pragma unroll
    for (int i = 0; i < 4; ++i) dft4(v[i], v[4 + i], v[8 + i], v[12 + i]);
    v[5] = cmul(v[5], make_float2(kC16, -kS16));     // W16^1
    v[6] = cmul(v[6], make_float2(kH, -kH));         // W16^2
    v[7] = cmul(v[7], make_float2(kS16, -kC16));     // W16^3
    v[9] = cmul(v[9], make_float2(kH, -kH));         // W16^2
    v[10] = mul_mi(v[10]);                           // W16^4
    v[11] = cmul(v[11], make_float2(-kH, -kH));      // W16^6
    v[13] = cmul(v[13], make_float2(kS16, -kC16));   // W16^3
    v[14] = cmul(v[14], make_float2(-kH, -kH));      // W16^6
    v[15] = cmul(v[15], make_float2(-kC16, kS16));   // W16^9
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dft4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else if constexpr (R == 8) {
    // even and odd halves, W8^k, then 2-point butterflies
    dft4(v[0], v[2], v[4], v[6]);
    dft4(v[1], v[3], v[5], v[7]);
    v[3] = cmul(v[3], make_float2(kH, -kH));         // W8^1
    v[5] = mul_mi(v[5]);                             // W8^2
    v[7] = cmul(v[7], make_float2(-kH, -kH));        // W8^3
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = v[2 * i], b = v[2 * i + 1];
      v[2 * i] = cadd(a, b);
      v[2 * i + 1] = csub(a, b);
    }
  } else if constexpr (R == 4) {
    dft4(v[0], v[1], v[2], v[3]);
  } else {
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
  }
}

// One pass of radix R and stride NS over both pols.  Thread t runs the
// 16 / R butterflies j = t + g n / 16 of each pol.  Butterfly j reads
// x[j + r n / R], r < R, multiplies it by W_{NS R}^{r k} =
// twiddle[r k n / (NS R)] with k = j mod NS, and writes output m to
// (j - k) R + k + m NS.  The first pass reads the ci8 row (NS = 1, no
// twiddles); the last (NS R = n) writes where it read, so no thread
// needs another's values and it runs without a barrier between.
template <int L, int R, int NS, bool kFirst>
__device__ __forceinline__ void pass(const uint16_t* __restrict__ row,
                                     const float2* __restrict__ twiddle,
                                     float2* sm, int t) {
  constexpr int n = 1 << L, nb = n / 16, G = 16 / R;
  constexpr int P = Radix16<L>::kPadded;
  constexpr bool kInPlace = NS * R == n;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    float2 v[16];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = t + g * nb;
      const int k = j & (NS - 1);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int src = j + r * (n / R);
        float2 x;
        if constexpr (kFirst) {
          x = unpack_ci8(__ldg(row + p * n + src));
        } else {
          x = sm[p * P + pad(src)];
          if (r > 0) x = cmul(x, __ldg(twiddle + r * k * (n / (NS * R))));
        }
        v[g * R + r] = x;
      }
      dft<R>(v + g * R);
    }
    if constexpr (!kFirst && !kInPlace) __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = t + g * nb;
      const int k = j & (NS - 1);
      const int dst = (j - k) * R + k;
#pragma unroll
      for (int m = 0; m < R; ++m)
        sm[p * P + pad(dst + m * NS)] = v[g * R + slot<R>(m)];
    }
  }
}

template <int L>
__global__ void __launch_bounds__(Radix16<L>::kThreads,
                                  Radix16<L>::kMinBlocks)
spectrometer_radix16(const uint16_t* __restrict__ volt,  // (T, 2, n) ci8
                     const float2* __restrict__ twiddle, // (n)
                     float* __restrict__ out,            // (T, 4, n / rf)
                     int rfactor) {
  using K = Radix16<L>;
  extern __shared__ float2 sm[];                 // [2][kPadded], pol-major
  const int t = threadIdx.x;
  const int64_t tr = blockIdx.x;
  const uint16_t* row = volt + tr * 2 * (int64_t)K::kN;

  pass<L, 16, 1, true>(row, twiddle, sm, t);
  __syncthreads();
  pass<L, 16, 16, false>(row, twiddle, sm, t);
  __syncthreads();
  if constexpr (K::kFull == 3) {
    pass<L, 16, 256, false>(row, twiddle, sm, t);
    __syncthreads();
  }
  if constexpr (K::kLast > 1) {
    pass<L, K::kLast, (1 << (4 * K::kFull)), false>(row, twiddle, sm, t);
    __syncthreads();
  }

  // Stokes of x = pol 0, y = pol 1, summed over rfactor adjacent bins.
  const int nout = K::kN / rfactor;
  float* orow = out + tr * 4 * (int64_t)nout;
  for (int g = t; g < nout; g += K::kThreads) {
    float si = 0.f, sq = 0.f, su = 0.f, sv = 0.f;
    for (int q = 0; q < rfactor; ++q) {
      const int k = pad(g * rfactor + q);
      const float2 x = sm[k];
      const float2 y = sm[K::kPadded + k];
      const float xx = fmaf(x.x, x.x, x.y * x.y);
      const float yy = fmaf(y.x, y.x, y.y * y.y);
      const float xyr = fmaf(x.x, y.x, x.y * y.y);     // Re(x conj(y))
      const float xyi = fmaf(x.y, y.x, -x.x * y.y);    // Im(x conj(y))
      si += xx + yy;
      sq += xx - yy;
      su += 2.f * xyr;
      sv -= 2.f * xyi;
    }
    orow[g] = si;
    orow[nout + g] = sq;
    orow[2 * nout + g] = su;
    orow[3 * nout + g] = sv;
  }
}

template <int L>
int launch_radix16(const void* volt, const void* twiddle, void* out,
                   long long ntime, int rfactor, cudaStream_t stream) {
  using K = Radix16<L>;
  cudaError_t err = cudaFuncSetAttribute(
      spectrometer_radix16<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)K::kSmem);
  if (err != cudaSuccess) return (int)err;
  if (ntime <= 0) return 0;
  spectrometer_radix16<L><<<dim3((unsigned)ntime), K::kThreads, K::kSmem,
                            stream>>>(
      (const uint16_t*)volt, (const float2*)twiddle, (float*)out, rfactor);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// volt: (ntime, 2, 2^log2n, 2) int8, contiguous, 4-byte aligned.
// twiddle: (2^log2n) float2, exp(-2 pi i k / 2^log2n) (the radix-2
// kernel reads the first half).
// out: (ntime, 4, 2^log2n / rfactor) float32, contiguous.
// radix16: 1 launches the radix-16 Stockham kernel (log2n 8 to 13), 0
// the radix-2 kernel (log2n 2 to 13).
// Returns a cudaError_t value; 0 on success.
int bf_spectrometer(const void* volt, const void* twiddle, void* out,
                    long long ntime, int log2n, int rfactor, int radix16,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (radix16) {
    switch (log2n) {
      case 8: return launch_radix16<8>(volt, twiddle, out, ntime, rfactor, s);
      case 9: return launch_radix16<9>(volt, twiddle, out, ntime, rfactor, s);
      case 10: return launch_radix16<10>(volt, twiddle, out, ntime, rfactor, s);
      case 11: return launch_radix16<11>(volt, twiddle, out, ntime, rfactor, s);
      case 12: return launch_radix16<12>(volt, twiddle, out, ntime, rfactor, s);
      case 13: return launch_radix16<13>(volt, twiddle, out, ntime, rfactor, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const size_t smem = 2 * ((size_t)1 << log2n) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      spectrometer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (ntime <= 0) return 0;
  spectrometer_kernel<<<dim3((unsigned)ntime), kThreads, smem, s>>>(
      (const uint32_t*)volt, (const float2*)twiddle, (float*)out, log2n,
      rfactor);
  return (int)cudaGetLastError();
}

const char* bf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
