// OFDM IFFT with the composed carrier gather, for Hopper (sm_90a).
//
// Replaces dabmod_tpu/ops/ofdm_kernel.py::build_ofdm_backend with
// enable_cfr=False and carrier_map set (the Pallas kernel of the TPU
// package's main path, :265-274 with the gather at :331-344, 353-358).
// For every OFDM symbol it computes
//
//   td[s, n] = sum_k bins[s, k] * exp(+2*pi*i*k*n/N)        (FFTW_BACKWARD)
//   bins[s, k] = sym[s, gather[k]], with sym[s, C] = 0
//
// on (re, im) float32 planes: carrier-order symbols [B*S, C] in, natural
// time order [B*S, N] out, N in {256, 512, 1024, 2048}.  `gather` composes
// the carrier->bin placement with the deferred frequency-interleave
// permutation (the modulator's _bin_src_pre) and sends the empty bins (DC
// and the guard band) to the zero slot C after the carriers.
//
// What bounds it on the H100: device memory.  At TM I with batch_tf=24
// (B*S = 1848 symbols) it must read 1848 x 1536 x 8 B = 22.7 MB of carriers
// and write 1848 x 2048 x 8 B = 30.3 MB of time samples: 53.0 MB, 15.8 us
// at 3.35 TB/s.  The arithmetic is 5 N log2(N) = 112,640 flop per symbol,
// 0.21 GFLOP in all, 3.1 us at the 67 TFLOP/s fp32 (non-tensor) peak.
//
// What held the earlier design back (one block per symbol on radix-2
// stages: 0.0958 ms, 16.5 % of the bound, a warm L2 no faster), and what
// this one does about each cause:
//   1. Eleven radix-2 stages, each a round trip through shared memory and a
//      block barrier with 4 butterflies a thread: latency-bound.  Now the
//      register-resident core of fft_core.cuh: each thread holds 16 points,
//      radix-16 butterflies in registers, two exchanges through shared
//      memory (one at N = 256) and five barriers a block in all.
//   2. The gather scattered bins to bit-reversed slots, 32-way bank
//      conflicts on every warp store.  Now each thread gathers its own 16
//      bins (t + TS*m) straight from the carrier buffer into registers, in
//      natural order (Stockham passes: no bit reversal), and the exchanges
//      are padded to be conflict-free, each access a per-thread base plus
//      an immediate offset.
//   3. A twiddle load per butterfly through L1.  Now 30 table reads a thread
//      per transform (__ldg, coalesced; the table stays in L1) and the
//      radix-16 internals are constants.
//   4. Occupancy.  128 threads a block carry 2048/N symbols, each symbol's
//      carriers loaded by its own threads; 17 KB of static shared memory a
//      block (the carrier buffer aliases the exchange buffer) and 56
//      registers a thread, so 9 blocks an SM (registers); capping the
//      registers for more blocks spills and runs slower.
// The carriers come in with 16-byte loads, the samples go out as
// coalesced 4-byte stores of one m across the warp.  All arithmetic is
// fp32 (no tensor cores).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_core.cuh"

namespace {

using dabmod::kBlockThreads;
using dabmod::kPoints;

template <int LOG2N>
__global__ void __launch_bounds__(kBlockThreads)
ofdm_ifft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 const int32_t* __restrict__ gather,
                 const float2* __restrict__ twiddle,
                 float* __restrict__ yr, float* __restrict__ yi,
                 long long n_symbols, int n_carriers) {
  using Core = dabmod::FftCore<LOG2N>;
  // the carriers, then (from the transform's first barrier) the exchange
  static_assert(Core::kCarrierFloats <= Core::kExchangeFloats);
  __shared__ __align__(16) float smem[Core::kExchangeFloats];

  const int ls = threadIdx.x / Core::TS;
  const int t = threadIdx.x % Core::TS;
  const long long sym = static_cast<long long>(blockIdx.x) * Core::SPB + ls;

  // 1. each symbol's carriers into shared memory, by its own threads
  float* cr = smem + ls * Core::kCarrierStride;
  float* ci = cr + Core::SPB * Core::kCarrierStride;
  dabmod::load_carriers<Core::TS>(xr, xi, cr, ci, sym, n_symbols,
                                  n_carriers, t);
  __syncthreads();

  // 2. this thread's bins t + TS*m, straight into registers
  float2 v[kPoints];
#pragma unroll
  for (int m = 0; m < kPoints; ++m) {
    const int g = __ldg(&gather[t + Core::TS * m]);
    v[m] = make_float2(cr[g], ci[g]);
  }

  // 3. the transform (its first barrier frees the carrier buffer)
  Core::inverse(v, smem, ls, t, twiddle);

  // 4. natural-order samples t + TS*m, coalesced across the warp
  if (sym < n_symbols) {
    float* qr = yr + sym * Core::N + t;
    float* qi = yi + sym * Core::N + t;
#pragma unroll
    for (int m = 0; m < kPoints; ++m) {
      qr[Core::TS * m] = v[m].x;
      qi[Core::TS * m] = v[m].y;
    }
  }
}

template <int LOG2N>
int launch(const void* xr, const void* xi, const void* gather,
           const void* twiddle, void* yr, void* yi, long long n_symbols,
           int n_carriers, cudaStream_t stream) {
  constexpr int spb = dabmod::FftCore<LOG2N>::SPB;
  const long long blocks = (n_symbols + spb - 1) / spb;
  ofdm_ifft_kernel<LOG2N><<<static_cast<unsigned>(blocks), kBlockThreads, 0,
                            stream>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const int32_t*>(gather),
      static_cast<const float2*>(twiddle), static_cast<float*>(yr),
      static_cast<float*>(yi), n_symbols, n_carriers);
  return static_cast<int>(cudaGetLastError());
}

template <int LOG2N>
int shape(int* out) {
  out[0] = kBlockThreads;
  out[1] = dabmod::FftCore<LOG2N>::SPB;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], ofdm_ifft_kernel<LOG2N>, kBlockThreads, 0));
}

}  // namespace

// Launch on `stream` (a cudaStream_t).  The caller checks every argument:
// n_symbols >= 1, 1 <= n_carriers <= 3/4 of 2^log2n, 8 <= log2n <= 11,
// every gather entry in [0, n_carriers], the twiddle table of
// ofdm_kernel.make_table, all buffers on the current device.  Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for another log2n.
extern "C" int dabmod_ofdm_ifft(const void* xr, const void* xi,
                                const void* gather, const void* twiddle,
                                void* yr, void* yi, long long n_symbols,
                                int n_carriers, int log2n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log2n) {
    case 8: return launch<8>(xr, xi, gather, twiddle, yr, yi, n_symbols, n_carriers, s);
    case 9: return launch<9>(xr, xi, gather, twiddle, yr, yi, n_symbols, n_carriers, s);
    case 10: return launch<10>(xr, xi, gather, twiddle, yr, yi, n_symbols, n_carriers, s);
    case 11: return launch<11>(xr, xi, gather, twiddle, yr, yi, n_symbols, n_carriers, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch shape of the instance for 2^log2n on the current device:
// out[0] threads a block, out[1] symbols a block, out[2] resident blocks an
// SM by the CUDA runtime's occupancy calculator (no dynamic shared memory,
// as launched).  Returns the CUDA error code (0 = success), or
// cudaErrorInvalidValue for another log2n.
extern "C" int dabmod_ofdm_ifft_shape(int log2n, int* out) {
  switch (log2n) {
    case 8: return shape<8>(out);
    case 9: return shape<9>(out);
    case 10: return shape<10>(out);
    case 11: return shape<11>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
